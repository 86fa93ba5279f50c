"""The port's generation against the JAX package on the CPU.

- (a) ``DecoderLM.generate`` / ``beam_generate`` (ops ``gpt_decode``,
  ``gpt_beam_decode``) from the JAX startup's parameters: greedy ids and
  beam ids equal, beam scores within 1e-5, eos padding, the bf16 tower,
  the prefill against the JAX dense prefill, the generation program's
  desc op for op, the layer's checks, and sampling by its properties
  (``jax.random.categorical``'s draws cannot be reproduced in torch):
  ``top_k=1`` is greedy, every token lies in the top-k of the tower's
  logits at its position, the same (seed, step) replays and another step
  draws differently;
- (b) the attention NMT: ``Seq2SeqAttention.generate`` (op
  ``beam_search_generate``) against the JAX package's, and
  ``generate_composable`` (``While`` + ``attention_gru_cell`` + the beam
  ops) against it too — the JAX package's own ``generate_composable``
  fails to build (``layers.topk`` on a shape-None var), so its
  ``generate`` is the reference for both; the encoder's K9 wrapper runs
  twice a call.

Sizes: vocab 50, dim 32, 2 layers, 2 heads (the JAX tests' sizes).  The
prefill takes K1's plain version here (the card runs K1; ``chip_smoke.py``
holds it to that version at P 64 and 37); the JAX package takes its dense
branch on the CPU, the same function.  Tolerances are stated at each
check: f32 logits and scores 1e-5; ids exactly."""

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.models import seq2seq as jseq2seq
from paddle_tpu.models import transformer as jtransformer
from paddle_tpu.ops import transformer_ops as jtf_ops
from paddle_tpu_torch.framework import step_loop
from paddle_tpu_torch.models import seq2seq as tseq2seq
from paddle_tpu_torch.models import transformer as ttransformer
from paddle_tpu_torch.ops import sequence_ops as t_seq_ops
from paddle_tpu_torch.ops import transformer_ops as ttf_ops

V, D, L, NH = 50, 32, 2, 2


@pytest.fixture(autouse=True)
def _fresh_port():
    tfluid.reset()
    jfluid.reset()
    yield


def _build(fl, mod, P, G, dtype="float32", gen=None):
    """The tower in the main program and `gen(lm, prompt)` in a program
    of its own; returns (lm, tower logits, generation program, gen's
    outputs)."""
    lm = mod.DecoderLM(V, D, L, NH, max_len=P + G, dtype=dtype)
    tokens = fl.layers.data("tokens", shape=[P + G, 1], dtype="int64")
    logits = lm.logits(tokens)
    gen_prog = fl.Program()
    with fl.program_guard(gen_prog):
        prompt = fl.layers.data("prompt", shape=[P, 1], dtype="int64")
        outs = gen(lm, prompt)
    return lm, logits, gen_prog, outs


def _both(P, G, gen, dtype="float32", B=3, seed=5):
    """Build in both packages, run the JAX startup, carry its parameters
    into the port, and run both generation programs on one prompt."""
    jlm, _, jprog, jouts = _build(jfluid, jtransformer, P, G, dtype, gen)
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jfluid.default_startup_program())
    arrays = [np.asarray(jfluid.global_scope().find_np(p.name), np.float32)
              for p in jlm._params]
    tlm, tlogits, tprog, touts = _build(tfluid, ttransformer, P, G, dtype,
                                        gen)
    tlm.load_params(arrays, tfluid.global_scope())
    texe = tfluid.Executor(tfluid.CPUPlace())
    pr = np.random.RandomState(seed).randint(0, V, (B, P, 1)).astype(
        np.int64)
    jres = [np.asarray(v) for v in jexe.run(jprog, feed={"prompt": pr},
                                            fetch_list=list(jouts))]
    tres = texe.run(tprog, feed={"prompt": pr}, fetch_list=list(touts))
    return jres, tres, pr, (tlm, tlogits, tprog, touts, texe)


# -- (a) the GPT --------------------------------------------------------------


@pytest.mark.parametrize("P,G,eos", [(6, 8, -1), (6, 8, 3), (37, 5, -1)])
def test_greedy_ids_match_jax(P, G, eos):
    jres, tres, _, _ = _both(P, G, lambda lm, p: [
        lm.generate(p, max_gen=G, eos_id=eos)])
    assert tres[0].dtype == np.int64 and tres[0].shape == (3, G)
    np.testing.assert_array_equal(tres[0], jres[0])


def test_generate_eos_padding_as_jax():
    """Everything after an emitted eos is eos; ids equal the JAX
    package's (the JAX test's shape: V 20 would not hold the same
    parameters, so eos is the most frequent greedy token here)."""
    jres, tres, _, _ = _both(4, 10, lambda lm, p: [
        lm.generate(p, max_gen=10)], B=4, seed=0)
    eos = int(np.bincount(jres[0].ravel()).argmax())
    jres, tres, _, _ = _both(4, 10, lambda lm, p: [
        lm.generate(p, max_gen=10, eos_id=eos)], B=4, seed=0)
    np.testing.assert_array_equal(tres[0], jres[0])
    hit = 0
    for row in tres[0]:
        where = np.where(row == eos)[0]
        if where.size:
            hit += 1
            assert (row[where[0]:] == eos).all(), row
    assert hit


@pytest.mark.parametrize("eos", [-1, 3])
def test_beam_ids_and_scores_match_jax(eos):
    """Ids equal, scores within 1e-5 (f32 sums of G log-softmax terms in
    two frameworks)."""
    K, G = 4, 8
    jres, tres, _, _ = _both(6, G, lambda lm, p: list(lm.beam_generate(
        p, max_gen=G, beam_size=K, eos_id=eos)))
    assert tres[0].dtype == np.int64 and tres[0].shape == (3, K, G)
    assert tres[1].dtype == np.float32 and tres[1].shape == (3, K)
    np.testing.assert_array_equal(tres[0], jres[0])
    np.testing.assert_allclose(tres[1], jres[1], rtol=1e-5, atol=1e-5)
    if eos >= 0:
        for row in tres[0].reshape(-1, G):
            where = np.where(row == eos)[0]
            if where.size:
                assert (row[where[0]:] == eos).all(), row


def _seq_logprob(lg, P, seq):
    """Sum of the per-step log-probs of `seq` [B, G] under tower logits
    `lg` [B, P+G, V], in float64."""
    z = lg.astype(np.float64)
    z = z - z.max(-1, keepdims=True)
    lp = z - np.log(np.exp(z).sum(-1, keepdims=True))
    B, G = seq.shape
    return sum(lp[np.arange(B), P + t - 1, seq[:, t]] for t in range(G))


def test_beam_beats_greedy_and_its_scores_are_the_towers():
    """The JAX test's properties on the port: K 1 equals greedy, lanes are
    sorted, lane 0's tower log-prob is at least greedy's (1e-4) and equals
    its reported score (1e-3, the JAX test's bound), and each greedy token
    is the tower's best at its position within 1e-4 (teacher forcing)."""
    P, G, K = 5, 6, 4
    _, tres, pr, (tlm, tlogits, _, _, texe) = _both(
        P, G, lambda lm, p: [lm.generate(p, max_gen=G),
                             *lm.beam_generate(p, max_gen=G, beam_size=K),
                             lm.beam_generate(p, max_gen=G, beam_size=1)[0]],
        seed=7)
    g, bids, bsc, b1 = tres
    np.testing.assert_array_equal(b1[:, 0], g)
    assert (np.diff(bsc, axis=1) <= 1e-5).all()

    def tower(seq):
        full = np.concatenate([pr, seq[:, :, None]], axis=1)
        return texe.run(feed={"tokens": full}, fetch_list=[tlogits])[0]

    lg = tower(g)
    for t in range(G):
        step = lg[:, P + t - 1]
        assert (step[np.arange(3), g[:, t]] >= step.max(-1) - 1e-4).all()
    greedy_lp = _seq_logprob(lg, P, g)
    lane0_lp = _seq_logprob(tower(bids[:, 0]), P, bids[:, 0])
    np.testing.assert_allclose(lane0_lp, bsc[:, 0], atol=1e-3)
    assert (lane0_lp >= greedy_lp - 1e-4).all()


def test_bf16_tower_generates_as_jax():
    """A bf16 tower: compute in bf16, head in f32.  Greedy ids and the
    best beam's ids equal the JAX package's, its score within 0.15 (XLA
    and torch round bf16 activations at different points: a log-prob per
    step differs by up to ~1e-2, summed over 8 steps).  The second lane
    is not held: at that rounding it parts from JAX's at a near tie in
    this case.  Shapes, range, finite."""
    K, G = 2, 8
    jres, tres, _, _ = _both(6, G, lambda lm, p: [
        lm.generate(p, max_gen=G),
        *lm.beam_generate(p, max_gen=G, beam_size=K)], dtype="bfloat16")
    g, bi, bs = tres
    assert g.shape == (3, G) and bi.shape == (3, K, G)
    assert ((0 <= g) & (g < V)).all() and np.isfinite(bs).all()
    np.testing.assert_array_equal(g, jres[0])
    np.testing.assert_array_equal(bi[:, 0], jres[1][:, 0])
    np.testing.assert_allclose(bs[:, 0], jres[2][:, 0], atol=0.15)


def _lm_ins(rng, P, G):
    mk = lambda *shape: (rng.randn(*shape) * 0.1).astype(np.float32)  # noqa
    ins = {"Emb": [mk(V, D)], "Pos": [mk(P + G, D)],
           "LnfS": [mk(D) + 1.0], "LnfB": [mk(D)], "WHead": [mk(D, V)]}
    for slot in ("Ln1S", "Ln1B", "Ln2S", "Ln2B"):
        ins[slot] = [mk(D) + (1.0 if slot.endswith("S") else 0.0)
                     for _ in range(L)]
    for slot in ("WQ", "WK", "WV", "WO"):
        ins[slot] = [mk(D, D) for _ in range(L)]
    ins["W1"] = [mk(D, 4 * D) for _ in range(L)]
    ins["B1"] = [mk(4 * D) for _ in range(L)]
    ins["W2"] = [mk(4 * D, D) for _ in range(L)]
    ins["B2"] = [mk(D) for _ in range(L)]
    return ins


@pytest.mark.parametrize("P", [37, 128])
def test_prefill_matches_jax_dense_prefill(P, monkeypatch):
    """``_lm_fns.prefill`` through K1's wrapper (its plain version on the
    CPU) against the JAX dense prefill: logits within 1e-5, caches within
    1e-6, and the wrapper called once a layer."""
    import jax.numpy as jnp

    G = 4
    ins = _lm_ins(np.random.RandomState(0), P, G)
    toks = np.random.RandomState(1).randint(0, V, (2, P))
    jl, jk, jv = jtf_ops._lm_fns(
        {s: [jnp.asarray(a) for a in v] for s, v in ins.items()}, NH,
        1e-5).prefill(jnp.asarray(toks, jnp.int32), P + G)
    calls = []
    real = ttf_ops.flash_attention

    def counting(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(ttf_ops, "flash_attention", counting)
    tl, tk, tv = ttf_ops._lm_fns(
        {s: [torch.from_numpy(a) for a in v] for s, v in ins.items()}, NH,
        1e-5).prefill(torch.from_numpy(toks), P + G)
    assert calls == [(2, NH, P, D // NH)] * L
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-6)


def test_generation_program_desc_matches_jax():
    def gen(lm, p):
        return [lm.generate(p, max_gen=4, eos_id=2, temperature=0.5,
                            top_k=7),
                *lm.beam_generate(p, max_gen=4, beam_size=3, eos_id=2)]

    _, _, jprog, _ = _build(jfluid, jtransformer, 6, 4, gen=gen)
    _, _, tprog, _ = _build(tfluid, ttransformer, 6, 4, gen=gen)

    def desc(p):
        return [(op.type, op.inputs, op.outputs, op.attrs)
                for op in p.global_block().ops]

    assert desc(tprog) == desc(jprog)
    assert [o[0] for o in desc(tprog)] == ["gpt_decode", "gpt_beam_decode"]


def test_generate_checks_its_arguments():
    lm = ttransformer.DecoderLM(V, D, L, NH, max_len=10)
    p = tfluid.layers.data("prompt", shape=[6, 1], dtype="int64")
    with pytest.raises(RuntimeError, match="logits"):
        lm.generate(p, max_gen=2)
    lm.logits(tfluid.layers.data("tokens", shape=[10, 1], dtype="int64"))
    with pytest.raises(ValueError, match="top_k=51"):
        lm.generate(p, max_gen=2, temperature=1.0, top_k=V + 1)
    with pytest.raises(ValueError, match="beam_size=0"):
        lm.beam_generate(p, max_gen=2, beam_size=0)
    with pytest.raises(ValueError, match="beam_size=51"):
        lm.beam_generate(p, max_gen=2, beam_size=V + 1)
    with pytest.raises(ValueError, match="max_len=10"):
        lm.generate(p, max_gen=5)
    with pytest.raises(ValueError, match="max_len=10"):
        lm.beam_generate(p, max_gen=5, beam_size=2)
    lm.generate(p, max_gen=4)  # 6 + 4 fits


def test_sampling_properties():
    """temperature 0.8 with top_k 5, and temperature 1.5 with top_k 1:
    the latter equals greedy; each sampled token's tower logit is within
    1e-4 of the 5th largest or above; a run pinned to one step replays
    bit for bit, another step draws differently, and sampling leaves the
    greedy path somewhere; the op declares its draws, so a generation
    block stays off the captured step loop."""
    P, G, B = 4, 6, 4
    _, tres, pr, (_, tlogits, tprog, touts, texe) = _both(
        P, G, lambda lm, p: [
            lm.generate(p, max_gen=G),
            lm.generate(p, max_gen=G, temperature=0.8, top_k=5),
            lm.generate(p, max_gen=G, temperature=1.5, top_k=1)],
        B=B, seed=2)

    def run(step):
        return texe.run(tprog, feed={"prompt": pr}, fetch_list=list(touts),
                        rng_step=step)

    g, s7, k1 = run(7)
    np.testing.assert_array_equal(k1, g)
    np.testing.assert_array_equal(run(7)[1], s7)
    assert (run(8)[1] != s7).any()
    assert (s7 != g).any()
    full = np.concatenate([pr, s7[:, :, None]], axis=1)
    lg = texe.run(feed={"tokens": full}, fetch_list=[tlogits])[0]
    for t in range(G):
        step = lg[:, P + t - 1]
        fifth = np.sort(step, axis=-1)[:, -5]
        assert (step[np.arange(B), s7[:, t]] >= fifth - 1e-4).all(), t
    report = step_loop.safety_report(tprog)
    assert not report["safe"] and "gpt_decode" in report["reasons"][0]


# -- (b) the attention NMT ----------------------------------------------------

NV, NW, NK, NL = 40, 16, 4, 7


def _nmt(fl, mod, which):
    model = mod.Seq2SeqAttention(NV, NV, emb_dim=NW, hidden=NW, attn=NW)
    src = fl.layers.sequence_data("src", shape=[1], dtype="int64",
                                  max_len=8)
    return getattr(model, which)(src, beam_size=NK, max_len=NL)


def _nmt_jax():
    """The JAX package's ``generate`` from its startup, the output layer
    scaled by 8 in both packages so that beams part by clear margins."""
    jouts = _nmt(jfluid, jseq2seq, "generate")
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jfluid.default_startup_program())
    scope = jfluid.global_scope()
    names = [n for n, v in jfluid.default_main_program().global_block()
             .vars.items() if v.persistable]
    arrays = {n: np.asarray(scope.find_np(n)) for n in names}
    arrays["s2s.dec_w_out"] = arrays["s2s.dec_w_out"] * 8
    scope.set("s2s.dec_w_out", arrays["s2s.dec_w_out"])
    rng = np.random.RandomState(3)
    seqs = [rng.randint(2, NV, (n, 1)).astype(np.int64)
            for n in (3, 8, 5, 1)]
    jres = [np.asarray(v) for v in jexe.run(
        feed={"src": jfluid.lod.LoDTensor.from_sequences(seqs)},
        fetch_list=list(jouts))]
    return jres, arrays, seqs


def _nmt_port(which, arrays, seqs, monkeypatch):
    touts = _nmt(tfluid, tseq2seq, which)
    tfluid.load_persistables(tfluid.default_main_program(), arrays)
    calls = []
    real = t_seq_ops.gru_forward

    def counting(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(t_seq_ops, "gru_forward", counting)
    tres = tfluid.Executor(tfluid.CPUPlace()).run(
        feed={"src": tfluid.lod.LoDTensor.from_sequences(seqs)},
        fetch_list=list(touts))
    assert len(calls) == 2  # the encoder's two directions: K9 twice
    return tres


def test_nmt_generate_matches_jax(monkeypatch):
    """Ids [B,K,L] int32 and lengths exactly, scores within 1e-5."""
    jres, arrays, seqs = _nmt_jax()
    ids, scores, lengths = _nmt_port("generate", arrays, seqs, monkeypatch)
    assert ids.dtype == lengths.dtype == np.int32
    assert ids.shape == (4, NK, NL) and scores.shape == (4, NK)
    np.testing.assert_array_equal(ids, jres[0])
    np.testing.assert_array_equal(lengths, jres[2])
    np.testing.assert_allclose(scores, jres[1], rtol=1e-5, atol=1e-5)
    assert (lengths < NL).any()  # some hypothesis finished


def test_nmt_generate_composable_matches_jax_generate(monkeypatch):
    """The While-composed loop gives the fused op's ids and scores (within
    1e-5); its lengths stop before the first eos, where the fused op's
    count it."""
    jres, arrays, seqs = _nmt_jax()
    ids, scores, lengths = _nmt_port("generate_composable", arrays, seqs,
                                     monkeypatch)
    assert ids.dtype == np.int64 and lengths.dtype == np.int32
    np.testing.assert_array_equal(ids, jres[0])
    np.testing.assert_allclose(scores, jres[1], rtol=1e-5, atol=1e-5)
    has_eos = (jres[0] == 1).any(-1)
    np.testing.assert_array_equal(lengths, jres[2] - has_eos)
    assert has_eos.any()


def test_nmt_generation_program_desc_matches_jax():
    _nmt(jfluid, jseq2seq, "generate")
    _nmt(tfluid, tseq2seq, "generate")

    def desc(fl):
        return [(op.type, op.inputs, op.outputs, op.attrs)
                for op in fl.default_main_program().global_block().ops]

    assert desc(tfluid) == desc(jfluid)
    assert desc(tfluid)[-1][0] == "beam_search_generate"
