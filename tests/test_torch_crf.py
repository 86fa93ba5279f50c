"""The CRF ops (``ops/crf_ops.py``) and ``chunk_eval`` of the port,
held to the JAX package on the CPU, one-op programs from numpy seeds.

- ``linear_chain_crf``: LogLikelihood and Alpha within 1e-5 of the JAX
  emitter's (f32; a float64 input stays float64), at ragged lengths that
  include 1 and T and at T = 1; in float64 its desc-level gradient in
  Emission and Transition equals ``jax.grad`` (1e-12) and central
  differences of the port's forward (1e-6), and the negative
  log-likelihood equals log Z − the gold score by enumeration of every
  path (1e-10).
- ``crf_decoding``: the Viterbi path equal to JAX's, element for element,
  zeros past each length (at T = 1, where the JAX emitter fails, to
  enumeration alone); on ties (equal emissions, a zero transition)
  the lowest state wins as ``jnp.argmax`` picks it; without ties it is
  the best path by enumeration.
- ``chunk_eval`` under ``plain``, ``IOB``, ``IOE`` and ``IOBES``: the
  three counts exactly JAX's, precision, recall and F1 within 1e-6, and a
  hand-counted IOB case; a [B, T] path against a [B, T, 1] label (the
  book's pair, which the JAX emitter refuses) counts as against [B, T]."""

import itertools

import numpy as np
import pytest

import paddle_tpu as jfluid  # noqa: F401  (registers the JAX emitters)
import paddle_tpu_torch as tfluid
from paddle_tpu.ops import registry as jreg
from paddle_tpu_torch.ops import registry as treg
from test_torch_op_grad import _check_outputs, _run_port
from test_torch_sequence_ops import desc_grads_hold

FWD_TOL = 1e-5


@pytest.fixture(autouse=True)
def _fresh_port():
    tfluid.reset()
    yield


def _crf_ins(B, T, C, lengths, seed, dtype=np.float32):
    rng = np.random.RandomState(seed)
    return {"Emission": [rng.uniform(-2, 2, (B, T, C)).astype(dtype)],
            "Transition": [rng.uniform(-1, 1, (C + 2, C)).astype(dtype)],
            "Label": [rng.randint(0, C, (B, T, 1)).astype(np.int64)],
            "Length": [np.array(lengths, np.int32)]}


CRF_CASES = {
    "ragged": (4, 6, 5, [6, 1, 3, 6]),
    "one_step": (3, 1, 4, [1, 1, 1]),
    "short": (2, 3, 3, [2, 3]),
}


def test_registry_holds_the_crf_ops_as_jax_does():
    for op in ("linear_chain_crf", "crf_decoding", "chunk_eval"):
        ti, ji = treg.get_op_info(op), jreg.get_op_info(op)
        assert (ti.grad is None) == (ji.grad is None), op
        assert ti.non_diff_inputs == ji.non_diff_inputs, op
        assert ti.non_diff_outputs == ji.non_diff_outputs, op


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", sorted(CRF_CASES))
def test_linear_chain_crf_matches_jax(case, dtype):
    ins = _crf_ins(*CRF_CASES[case], seed=1, dtype=np.dtype(dtype))
    outs = _check_outputs("linear_chain_crf", ins, {}, tol=FWD_TOL)
    assert str(outs["LogLikelihood"].dtype) == f"torch.{dtype}"


def _brute_nll(em, trans, lab, L):
    """log Z − score(label) of one row by enumerating its C^L paths."""
    start, end, tr = trans[0], trans[1], trans[2:]

    def score(p):
        s = start[p[0]] + em[0, p[0]] + end[p[-1]]
        return s + sum(tr[p[t - 1], p[t]] + em[t, p[t]] for t in range(1, L))

    all_s = [score(p) for p in itertools.product(range(em.shape[1]),
                                                 repeat=L)]
    m = max(all_s)
    return m + np.log(np.sum(np.exp(np.array(all_s) - m))) \
        - score(lab[:L]), all_s


@pytest.mark.parametrize("case", ["ragged", "short"])
def test_linear_chain_crf_gradient_matches_jax_and_central_differences(case):
    B, T, C, lengths = CRF_CASES[case]
    if case == "ragged":  # keep the central differences few
        B, T, C, lengths = 3, 4, 3, [4, 1, 2]
    ins = _crf_ins(B, T, C, lengths, seed=2, dtype=np.float64)
    desc_grads_hold("linear_chain_crf", ins, {}, ("Emission", "Transition"),
                    "LogLikelihood", case)


def test_linear_chain_crf_is_the_enumerated_likelihood():
    ins = _crf_ins(3, 4, 3, [4, 1, 3], seed=3, dtype=np.float64)
    got = _run_port("linear_chain_crf", ins, {}, ["LogLikelihood"])
    nll = got["LogLikelihood"].numpy()[:, 0]
    em, trans = ins["Emission"][0], ins["Transition"][0]
    lab, L = ins["Label"][0][..., 0], ins["Length"][0]
    for b in range(3):
        want, _ = _brute_nll(em[b], trans, lab[b], L[b])
        assert abs(nll[b] - want) <= 1e-10, (b, nll[b], want)


def _decode(ins, jax_too=True):
    if jax_too:
        outs = _check_outputs("crf_decoding", ins, {})
    else:
        outs = _run_port("crf_decoding", ins, {}, ["ViterbiPath"])
    return outs["ViterbiPath"].numpy()


@pytest.mark.parametrize("case", sorted(CRF_CASES))
def test_crf_decoding_matches_jax_and_enumeration(case):
    """At T = 1 the JAX emitter cannot trace its empty backtrack scan
    (it indexes a [0, B, C] array of back-pointers; ROADMAP.md Queue C),
    so that case is held to enumeration alone."""
    B, T, C, lengths = CRF_CASES[case]
    ins = _crf_ins(B, T, C, lengths, seed=4)
    del ins["Label"]
    path = _decode(ins, jax_too=T > 1)
    assert path.dtype == np.int32
    em, trans = ins["Emission"][0].astype(np.float64), \
        ins["Transition"][0].astype(np.float64)
    for b, L in enumerate(lengths):
        assert (path[b, L:] == 0).all()
        if C ** L > 5000:
            continue
        _, scores = _brute_nll(em[b], trans, np.zeros(T, int), L)
        best = list(itertools.product(range(C), repeat=L))[
            int(np.argmax(scores))]
        assert tuple(path[b, :L]) == best, (b, path[b], best)


def test_crf_decoding_breaks_ties_to_the_lowest_state():
    """States 1 and 3 tie at every step under a zero transition: both
    packages take state 1; a row where all states tie takes state 0."""
    B, T, C = 3, 5, 4
    em = np.random.RandomState(5).uniform(-1, 0, (B, T, C)).astype(
        np.float32)
    em[0, :, 1] = em[0, :, 3] = 0.5
    em[1] = 0.0
    em[2, :, 2] = em[2, :, 0] = 0.75
    ins = {"Emission": [em],
           "Transition": [np.zeros((C + 2, C), np.float32)],
           "Length": [np.array([5, 3, 1], np.int32)]}
    path = _decode(ins)
    np.testing.assert_array_equal(path, [[1] * 5, [0] * 5, [0] * 5])


# -- chunk_eval ---------------------------------------------------------------

_NUM_TAG = {"plain": 1, "IOB": 2, "IOE": 2, "IOBES": 4}


def _chunk_ins(scheme, seed, B=6, T=9, ncls=3, flip=0.3, length=True):
    rng = np.random.RandomState(seed)
    top = ncls * _NUM_TAG[scheme]  # tags from here on are outside
    lab = rng.randint(0, top + 1, (B, T, 1)).astype(np.int64)
    inf = np.where(rng.rand(B, T, 1) < flip,
                   rng.randint(0, top + 1, (B, T, 1)), lab).astype(np.int64)
    ins = {"Inference": [inf], "Label": [lab]}
    if length:
        ins["Length"] = [np.array([T, 1, 4, T, 7, 2][:B], np.int32)]
    return ins, {"num_chunk_types": ncls, "chunk_scheme": scheme}


@pytest.mark.parametrize("scheme", sorted(_NUM_TAG))
@pytest.mark.parametrize("seed", [0, 1])
def test_chunk_eval_matches_jax(scheme, seed):
    ins, attrs = _chunk_ins(scheme, seed)
    outs = _check_outputs("chunk_eval", ins, attrs, tol=1e-6)
    assert int(outs["NumCorrectChunks"][0]) > 0


def test_chunk_eval_without_lengths_matches_jax():
    ins, attrs = _chunk_ins("IOB", 2, length=False)
    _check_outputs("chunk_eval", ins, attrs, tol=1e-6)


def test_chunk_eval_counts_an_iob_sentence_by_hand():
    """Types A=0, B=1 (tags B-A 0, I-A 1, B-B 2, I-B 3, O 4).  Label
    chunks: A[0,1], B[3,3], A[5,6]; inferred: A[0,1], B[3,4], A[5,6]:
    2 of 3 correct."""
    lab = np.array([[0, 1, 4, 2, 4, 0, 1]], np.int64)
    inf = np.array([[0, 1, 4, 2, 3, 0, 1]], np.int64)
    outs = _run_port("chunk_eval", {"Inference": [inf], "Label": [lab],
                                    "Length": [np.array([7], np.int32)]},
                     {"num_chunk_types": 2, "chunk_scheme": "IOB"},
                     ["NumInferChunks", "NumLabelChunks",
                      "NumCorrectChunks", "F1-Score"])
    assert [int(outs[k][0]) for k in ("NumInferChunks", "NumLabelChunks",
                                      "NumCorrectChunks")] == [3, 3, 2]
    assert abs(float(outs["F1-Score"][0]) - 2 / 3) < 1e-6


def test_chunk_eval_takes_a_path_against_a_column_label():
    ins, attrs = _chunk_ins("IOBES", 3)
    slots = ["NumInferChunks", "NumLabelChunks", "NumCorrectChunks"]
    want = _run_port("chunk_eval", ins, attrs, slots)
    ins["Inference"] = [ins["Inference"][0][..., 0]]
    got = _run_port("chunk_eval", ins, attrs, slots)
    for s in slots:
        assert int(got[s][0]) == int(want[s][0]), s
