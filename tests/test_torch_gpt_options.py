"""The GPT trained the way LM users train it, at a small size, against the
JAX package on the CPU: ``decoder_lm`` + ``lm_loss`` (vocab 64, dim 32, 2
layers, 4 heads, 16 tokens, f32) with ``Adam(learning_rate=
polynomial_decay(3e-4, 1000, 3e-5), regularization=L2Decay(1e-4),
global_clip_norm=1.0)``, built through the public API in both packages
alike (``build_lm_train_program`` keeps its constant-rate Adam).

From the JAX startup's values carried in by name, 3 steps on the same
batches: the programs op for op, the losses within 1e-5 relative, the
fetched learning rate equal to the schedule's closed form in f32 (the
``scale`` op rounds its product and its sum each) and within one
rounding of JAX's (XLA fuses the two into one FMA), and every
persistable (parameters, moments, beta powers, the global step) within
1e-5 by norm (the norm of the difference over the tensor's, the measure
``chip_smoke.py``'s ``distance`` takes: a bias that starts at 0 moves by
Adam steps of lr size, where one element's 1e-8 difference would be 2e-5
of the largest |value|).  The clip scale
brings every gradient below the norm 1 and the decay adds 1e-4 of each
weight, so even a token row the batch never reads gets the same
deterministic gradient in both packages.
"""

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.models import transformer as jtransformer
from paddle_tpu_torch.models import transformer as ttransformer

V, D, L, NH, T, BS = 64, 32, 2, 4, 16, 2
LR, DECAY_STEPS, END_LR = 3e-4, 1000, 3e-5
TOL = 1e-5


@pytest.fixture(autouse=True)
def _fresh_port():
    tfluid.reset()
    yield


def options_lm(fluid, transformer, dtype="float32"):
    """The options GPT; returns (loss, learning-rate var)."""
    tokens = fluid.layers.data("tokens", shape=[T, 1], dtype="int64")
    targets = fluid.layers.data("targets", shape=[T, 1], dtype="int64")
    logits = transformer.decoder_lm(tokens, V, D, L, NH, max_len=T,
                                    dtype=dtype)
    loss = transformer.lm_loss(logits, targets, dtype=dtype)
    lr = fluid.learning_rate_decay.polynomial_decay(
        LR, decay_steps=DECAY_STEPS, end_learning_rate=END_LR)
    fluid.optimizer.Adam(
        learning_rate=lr, regularization=fluid.regularizer.L2Decay(1e-4),
        global_clip_norm=1.0).minimize(loss)
    return loss, lr


def schedule_f32(step):
    """polynomial_decay's ops in f32, each rounded: clip, scale (a product
    and a sum), pow 1, scale."""
    f = np.float32
    frac = f(min(step, DECAY_STEPS)) * f(-1.0 / DECAY_STEPS) + f(1.0)
    return float(frac * f(LR - END_LR) + f(END_LR))


def _batch(seed):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, V, (BS, T, 1)).astype(np.int64)
    return {"tokens": toks, "targets": np.roll(toks, -1, axis=1)}


def _desc(program):
    return [(op.type, op.inputs, op.outputs, op.attrs)
            for op in program.global_block().ops]


def test_options_gpt_three_steps_match_jax():
    jfluid.reset()
    jloss, jlr = options_lm(jfluid, jtransformer)
    jmain = jfluid.default_main_program()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jfluid.default_startup_program())
    names = [n for n, v in jmain.global_block().vars.items()
             if v.persistable]
    tloss, tlr = options_lm(tfluid, ttransformer)
    tmain = tfluid.default_main_program()
    assert _desc(tmain) == _desc(jmain)
    types = [op.type for op in tmain.global_block().ops]
    n_params = len(tmain.global_block().all_parameters())
    assert types.count("squared_l2_norm") == n_params
    assert types.count("adam") == n_params
    tfluid.load_persistables(
        tmain, {n: jfluid.global_scope().find_np(n) for n in names})
    texe = tfluid.Executor(tfluid.CPUPlace())
    jl, tl = [], []
    for step in range(1, 4):
        feed = _batch(step)
        jo = jexe.run(jmain, feed=feed, fetch_list=[jloss, jlr])
        to = texe.run(tmain, feed=feed, fetch_list=[tloss, tlr])
        jl.append(float(np.asarray(jo[0])[0]))
        tl.append(float(to[0][0]))
        assert float(to[1][0]) == schedule_f32(step)
        np.testing.assert_allclose(float(to[1][0]),
                                   float(np.asarray(jo[1])[0]), rtol=2e-7)
    np.testing.assert_allclose(tl, jl, rtol=TOL)
    worst = {}
    for n in names:
        j = jfluid.global_scope().find_np(n)
        t = tfluid.global_scope().find_np(n)
        assert t.dtype == j.dtype and t.shape == j.shape, n
        j = j.astype(np.float64)
        worst[n] = float(np.linalg.norm(t - j)
                         / max(float(np.linalg.norm(j)), 1e-30))
    bad = {n: e for n, e in worst.items() if e > TOL}
    assert not bad, bad
    assert tfluid.global_scope().find_np("global_step_0")[0] == 3


def test_options_gpt_bf16_step_keeps_dtypes():
    """bf16: the clipped gradients are f32 (bf16 times the f32 scale), the
    parameters stay bf16 and the moments f32 through Adam, as in JAX."""
    loss, lr = options_lm(tfluid, ttransformer, dtype="bfloat16")
    main = tfluid.default_main_program()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(tfluid.default_startup_program())
    block = main.global_block()
    clip_names = [op.outputs["Out"][0] for op in block.ops
                  if op.type == "elementwise_mul"
                  and op.outputs["Out"][0].endswith("_clip_0")]
    out = exe.run(main, feed=_batch(0),
                  fetch_list=[loss, lr] + clip_names[:2],
                  return_numpy=False)
    assert np.isfinite(out[0].float().numpy()).all()
    assert all(t.dtype.is_floating_point and str(t.dtype) == "torch.float32"
               for t in out[2:])
    scope = tfluid.global_scope()
    for p in block.all_parameters():
        assert str(scope.find(p.name).dtype) == "torch.bfloat16", p.name
    for v in block.vars.values():
        if v.accumulator_for:
            assert str(scope.find(v.name).dtype) == "torch.float32", v.name
