"""The port's ``memory_optimization_transpiler`` against the JAX
package's on the CPU: on the GPT, ResNet-18 and stacked-LSTM training
programs, at three budgets and both levels, the same grad ops are marked
for rematerialization and the same count returned, and the projected
peak (before and after) and the liveness profile are equal to the byte.
Then the checked pass under ``PADDLE_TPU_VERIFY=1`` and the package
exports."""

import os
import sys

import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import memory_optimization_transpiler as jmot
from paddle_tpu.analysis import contracts as jcontracts
from paddle_tpu_torch import memory_optimization_transpiler as tmot
from paddle_tpu_torch.analysis import contracts as tcontracts
from paddle_tpu_torch.analysis.verifier import VerificationError

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_analysis import PROGRAMS  # noqa: E402


@pytest.fixture(autouse=True)
def _fresh_port(monkeypatch):
    tfluid.reset()
    monkeypatch.delenv("PADDLE_TPU_VERIFY", raising=False)
    yield


def _lstm(f):
    f.reset()
    words = f.layers.sequence_data(name="words", shape=[1], dtype="int64",
                                   max_len=16)
    label = f.layers.data(name="label", shape=[1], dtype="int64")
    emb = f.layers.sequence_embedding(words, size=[200, 32],
                                      dtype="float32")
    from importlib import import_module

    nets = import_module(f.__name__ + ".models.image_models")
    logits = nets.stacked_lstm_net(emb, hidden_dim=32, stacked_num=2,
                                   class_dim=2)
    loss = f.layers.mean(f.layers.softmax_with_cross_entropy(logits, label))
    f.optimizer.Adam(learning_rate=0.002).minimize(loss)
    return f.default_main_program()


def _build(name):
    """Fresh (jax program, port program): the pass mutates them."""
    if name == "lstm_train":
        return _lstm(jfluid), _lstm(tfluid)
    jb, tb = PROGRAMS[name]
    return jb()[1], tb()[1]


def _marked(program):
    return [i for i, op in enumerate(program.global_block().ops)
            if op.attrs.get("__remat__")]


NAMES = ["gpt_train", "resnet18_train", "lstm_train"]
BS = 8


@pytest.mark.parametrize("name", NAMES)
def test_projection_and_liveness_equal_jax(name):
    jp, tp = _build(name)
    assert tmot.projected_peak_bytes(tp, BS) == \
        jmot.projected_peak_bytes(jp, BS)
    assert tmot.analyze_liveness(tp.global_block(), BS) == \
        jmot.analyze_liveness(jp.global_block(), BS)


@pytest.mark.parametrize("level", [0, 1])
@pytest.mark.parametrize("budget", ["roomy", "tight", "starved"])
@pytest.mark.parametrize("name", NAMES)
def test_memory_optimize_marks_as_jax(name, budget, level):
    jp, tp = _build(name)
    proj = jmot.projected_peak_bytes(jp, BS)
    hbm = {"roomy": 1 << 40,
           # the persistent state plus half the activation peak, over the
           # pass's 90% headroom
           "tight": int((proj["persistent_bytes"]
                         + proj["activation_peak_bytes"] // 2) / 0.9),
           "starved": 1 << 10}[budget]
    n_j = jmot.memory_optimize(jp, level=level, batch_size=BS,
                               hbm_bytes=hbm)
    n_t = tmot.memory_optimize(tp, level=level, batch_size=BS,
                               hbm_bytes=hbm)
    assert n_t == n_j
    assert _marked(tp) == _marked(jp)
    assert tmot.projected_peak_bytes(tp, BS, honor_remat=True) == \
        jmot.projected_peak_bytes(jp, BS, honor_remat=True)
    if budget == "roomy" and level == 0:
        assert n_t == 0
    if level == 1:
        assert n_t == sum(op.type == "generic_grad"
                          for op in tp.global_block().ops)


def test_default_budget_without_a_card(monkeypatch):
    """No card in this process: $PADDLE_TPU_HBM_BYTES, then 16 GiB."""
    jp, tp = _build("gpt_train")
    monkeypatch.setenv("PADDLE_TPU_HBM_BYTES", str(1 << 10))
    assert tmot.memory_optimize(tp, batch_size=BS) == \
        jmot.memory_optimize(jp, batch_size=BS) > 0
    jp, tp = _build("gpt_train")
    monkeypatch.delenv("PADDLE_TPU_HBM_BYTES")
    assert tmot.memory_optimize(tp, batch_size=BS) == 0


def test_checked_pass_under_verify(monkeypatch):
    jp, tp = _build("gpt_train")
    proj = tmot.projected_peak_bytes(tp, BS)
    hbm = int((proj["persistent_bytes"]
               + proj["activation_peak_bytes"] // 2) / 0.9)
    rep, jrep = {}, {}
    n = tcontracts.checked_memory_optimize(tp, batch_size=BS,
                                           hbm_bytes=hbm, report=rep)
    jcontracts.checked_memory_optimize(jp, batch_size=BS, hbm_bytes=hbm,
                                       report=jrep)
    assert n > 0 and rep == jrep
    assert rep["peak_after"] < rep["peak_before"]
    # the env gate routes the plain entry point through the contract
    jp, tp = _build("gpt_train")
    monkeypatch.setenv("PADDLE_TPU_VERIFY", "1")
    v0 = tp._version
    assert tmot.memory_optimize(tp, batch_size=BS, hbm_bytes=hbm) == n
    assert tp._version == v0 + 1


def test_peak_contract_refuses_a_useless_marking():
    """PTV017: ops marked, projected peak unmoved."""
    jp, tp = _build("gpt_train")
    before = tcontracts.planner_peak_bytes(tp, BS)
    after, findings = tcontracts.quantified_peak_reduction(before, tp, BS,
                                                           marked=3)
    assert after == before and [f.rule for f in findings] == ["PTV017"]
    assert tcontracts.liveness_diff(
        tcontracts.liveness_snapshot(tp, BS), tp, BS) == []
    with pytest.raises(VerificationError):
        raise VerificationError("x", findings)


def test_package_exports_and_release_memory():
    assert tfluid.memory_optimize is tmot.memory_optimize
    p = tfluid.Program()
    assert tfluid.release_memory(p) is p
