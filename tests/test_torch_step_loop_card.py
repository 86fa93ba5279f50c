"""The captured step loop on the card (``framework/step_loop.py``): a CUDA
graph has no CPU mode, so every test here skips without a CUDA device
(decided in a fixture).  On the chip machine, which has no JAX, run
``python -m pytest --noconftest tests/test_torch_step_loop_card.py``.
This file imports nothing of JAX; ``tests/test_torch_step_loop.py`` holds
the CPU side, the graph's body included."""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as fluid
from paddle_tpu_torch.framework import step_loop
from paddle_tpu_torch.ops import registry

K = 4


@pytest.fixture(autouse=True)
def _fresh():
    fluid.reset()
    yield


@pytest.fixture
def cuda_device():
    """The card, decided at test time; tests that need it skip here."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph has no CPU mode")
    return torch.device("cuda", 0)


def _mlp():
    x = fluid.layers.data(name="x", shape=[16])
    y = fluid.layers.data(name="y", shape=[1], dtype="int64")
    h = fluid.layers.fc(input=x, size=32, act="relu")
    logits = fluid.layers.fc(input=h, size=4)
    cost = fluid.layers.mean(
        fluid.layers.softmax_with_cross_entropy(logits, y))
    fluid.optimizer.Momentum(learning_rate=0.01, momentum=0.9).minimize(cost)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(fluid.default_startup_program())
    return cost, fluid.default_main_program(), exe


def _feeds(seed=0, k=K):
    rng = np.random.RandomState(seed)
    return {"x": rng.randn(k, 4, 16).astype(np.float32),
            "y": rng.randint(0, 4, (k, 4, 1)).astype(np.int64)}


def _state(main):
    return {n: fluid.global_scope().find(n).clone()
            for n, v in main.global_block().vars.items() if v.persistable}


def _eager(main, loss, feeds, state):
    """K run() calls from `state` in a scope of their own."""
    scope = fluid.Scope()
    for n, t in state.items():
        scope.set(n, t.clone())
    exe = fluid.Executor(fluid.CUDAPlace(0))
    losses = [exe.run(main, feed={n: v[i] for n, v in feeds.items()},
                      fetch_list=[loss], scope=scope)[0] for i in range(K)]
    return np.stack(losses), scope


@pytest.mark.parametrize("fetch_every", ["all", "last"])
def test_capture_and_replay_equal_eager_steps(cuda_device, fetch_every):
    """Dispatch 1 runs eagerly, 2 captures and replays, 3 replays: each
    equals K eager steps from the same state to the bit, and the scope's
    entries are the graph's static buffers."""
    loss, main, exe = _mlp()
    for d in range(3):
        feeds = _feeds(seed=d)
        start = _state(main)
        want, scope = _eager(main, loss, feeds, start)
        got = exe.run(main, feed=feeds, fetch_list=[loss],
                      steps_per_dispatch=K, fetch_every=fetch_every)[0]
        np.testing.assert_array_equal(
            got, want if fetch_every == "all" else want[-1])
        for n in start:
            assert torch.equal(fluid.global_scope().find(n),
                               scope.find(n)), n
    (entry,) = exe._loops.values()
    loop = entry.loop
    assert loop.graph is not None
    for n, buf in loop.state.items():
        assert fluid.global_scope().find(n) is buf
    exe.close()
    assert not exe._loops


def test_replay_takes_card_tensor_feeds_and_replaced_state(cuda_device):
    """A feed already on the card is copied in; a scope entry an eager
    run() replaced is copied into the static buffer before the replay."""
    loss, main, exe = _mlp()
    for d in range(2):  # eager, then capture
        exe.run(main, feed=_feeds(seed=d), fetch_list=[loss],
                steps_per_dispatch=K)
    exe.run(main, feed={n: v[0] for n, v in _feeds(seed=7).items()},
            fetch_list=[loss])
    feeds = _feeds(seed=3)
    want, scope = _eager(main, loss, feeds, _state(main))
    on_card = {n: torch.as_tensor(v, device=cuda_device)
               for n, v in feeds.items()}
    got = exe.run(main, feed=on_card, fetch_list=[loss],
                  steps_per_dispatch=K, return_numpy=False)[0]
    assert got.device.type == "cuda"
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    w = main.global_block().all_parameters()[0].name
    assert torch.equal(fluid.global_scope().find(w), scope.find(w))


def test_two_scopes_alternate_each_on_its_own_state(cuda_device):
    """One executor and program dispatch against two scopes in turn (an
    eager dispatch, a capture, two replays each): each scope equals K
    eager steps of its own to the bit, every time, and the two loops
    share no state buffer."""
    loss, main, exe = _mlp()
    scopes = [fluid.global_scope(), fluid.Scope()]
    for n, t in _state(main).items():  # the second starts on a copy
        scopes[1].set(n, t)
    for d in range(4):
        for j, scope in enumerate(scopes):
            feeds = _feeds(seed=10 * j + d)
            start = {n: scope.find(n).clone() for n in _state(main)}
            want, twin = _eager(main, loss, feeds, start)
            got = exe.run(main, feed=feeds, fetch_list=[loss], scope=scope,
                          steps_per_dispatch=K)[0]
            np.testing.assert_array_equal(got, want)
            for n in start:
                assert torch.equal(scope.find(n), twin.find(n)), (j, d, n)
    loops = [entry.loop for entry in exe._loops.values()]
    assert len(loops) == 2 and None not in loops
    ptrs = [{t.untyped_storage().data_ptr() for t in loop.state.values()}
            for loop in loops]
    assert not ptrs[0] & ptrs[1]
    exe.close()


def test_device_feeder_blocks_on_the_card(cuda_device):
    loss, main, exe = _mlp()
    feeder = fluid.DataFeeder(["x", "y"], place=fluid.CUDAPlace(0))

    def reader():
        rng = np.random.RandomState(0)
        for _ in range(2 * K):
            yield [(rng.randn(16).astype(np.float32),
                    [int(rng.randint(0, 4))]) for _ in range(4)]

    start = _state(main)
    got = []
    for block in fluid.DeviceFeeder(feeder, reader, steps=K):
        assert block["x"].device.type == "cuda"
        got.append(exe.run(main, feed=block, fetch_list=[loss],
                           steps_per_dispatch=K)[0])
    mbs = list(reader())
    for n, t in start.items():
        fluid.global_scope().set(n, t.clone())
    ref = fluid.Executor(fluid.CUDAPlace(0))
    want = [ref.run(main, feed=feeder.feed_stacked(mbs[i:i + K]),
                    fetch_list=[loss], steps_per_dispatch=K)[0]
            for i in (0, K)]
    np.testing.assert_array_equal(np.stack(got), np.stack(want))


def test_capture_error_names_the_op_and_is_not_retried(cuda_device,
                                                       monkeypatch):
    """An op that syncs with the host breaks the capture: the error names
    it, and the next dispatch raises again instead of running eagerly."""
    loss, main, exe = _mlp()
    info = registry.get_op_info("mean")
    emit = info.emit

    def syncing(ctx, ins, attrs):
        out = emit(ctx, ins, attrs)
        float(out["Out"][0].sum())  # a host sync
        return out

    monkeypatch.setattr(info, "emit", syncing)
    exe.run(main, feed=_feeds(), fetch_list=[loss], steps_per_dispatch=K)
    for _ in range(2):
        with pytest.raises(step_loop.StepLoopError, match="'mean'"):
            exe.run(main, feed=_feeds(), fetch_list=[loss],
                    steps_per_dispatch=K)


def test_embedding_backward_is_the_same_bits_every_run(cuda_device):
    """``lookup_table``'s grad adds each row's cotangents in one order
    (``index_put_`` with ``accumulate``, sorted by row), so 8,192 bf16
    tokens into 512 rows, many to a row, give the same dW every run: what
    lets a replay of the bf16 GPT equal its eager steps to the bit."""
    info = registry.get_op_info("lookup_table")
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    w = torch.randn(512, 64, device=cuda_device, generator=gen).bfloat16()
    ids = torch.randint(0, 512, (8, 1024, 1), device=cuda_device,
                        generator=gen)
    ct = torch.randn(8, 1024, 64, device=cuda_device,
                     generator=gen).bfloat16()
    ctx = registry.EmitContext(cuda_device, is_test=False)
    attrs = {"__fwd_type__": "lookup_table",
             "__fwd_attrs__": {"padding_idx": -1},
             "__fwd_input_slots__": ["Ids", "W"],
             "__fwd_output_slots__": ["Out"], "__wanted__": {("W", 0)}}
    out = info.emit(ctx, {"W": [w], "Ids": [ids]}, {"padding_idx": -1})
    grad = registry.get_op_info("generic_grad").emit
    runs = [grad(ctx, {"W": [w], "Ids": [ids], "Out": out["Out"],
                       "Out@GRAD": [ct]}, attrs)["W@GRAD"][0]
            for _ in range(5)]
    for dw in runs[1:]:
        assert torch.equal(dw, runs[0])
    # against the float64 sum: each of a row's n bf16 additions rounds by
    # at most 2^-9 of a partial sum, itself at most the row's sum of |ct|
    flat_ids, rows = ids.reshape(-1), ct.reshape(-1, 64).double()
    want = torch.zeros(512, 64, dtype=torch.float64,
                       device=cuda_device).index_add_(0, flat_ids, rows)
    mag = torch.zeros_like(want).index_add_(0, flat_ids, rows.abs())
    n = torch.bincount(flat_ids, minlength=512).double()[:, None]
    assert bool(((runs[0].double() - want).abs()
                 <= n * mag * 2.0 ** -9).all())


def test_remat_gpt_replays_to_the_eager_steps_bits(cuda_device):
    """A remat GPT (each layer a ``recompute`` segment, no dropout) rides
    the captured loop: the first dispatch (eager), the second (capture and
    replay) and a third (replay) each equal K eager steps from the same
    state to the bit."""
    from paddle_tpu_torch.models import transformer

    loss = transformer.build_lm_train_program(
        seq_len=64, vocab_size=128, dim=64, n_layers=2, n_heads=2,
        dtype="float32", learning_rate=1e-3, remat=True)
    main = fluid.default_main_program()
    assert step_loop.safety_report(main)["safe"]
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(fluid.default_startup_program())
    for d in range(3):
        rng = np.random.RandomState(d)
        toks = rng.randint(0, 128, (K, 2, 64, 1)).astype(np.int64)
        feeds = {"tokens": toks, "targets": np.roll(toks, -1, axis=2)}
        start = _state(main)
        want, scope = _eager(main, loss, feeds, start)
        got = exe.run(main, feed=feeds, fetch_list=[loss],
                      steps_per_dispatch=K)[0]
        np.testing.assert_array_equal(got, want)
        for n in start:
            assert torch.equal(fluid.global_scope().find(n),
                               scope.find(n)), (d, n)
    (entry,) = exe._loops.values()
    assert entry.loop is not None and entry.loop.graph is not None
    exe.close()
