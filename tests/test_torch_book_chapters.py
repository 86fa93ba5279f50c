"""The book chapters that read the ported dataset modules
(``models/book_chapters.py``), on the CPU against the JAX package, at
narrow widths and a small vocabulary: understand_sentiment on ``imdb``
(path A's stacked LSTM), machine_translation on ``wmt14`` (path B's
attention NMT), recommender_system on ``movielens``, word2vec on
``imikolov``, and RankNet (``rank_cost``) and LambdaRank
(``lambda_cost``) on ``mq2007``.

For each: the same code builds the same desc in both packages
(``to_json`` letter for letter); each package's reader, ``reader.batch``
and ``DataFeeder`` make the same feeds; the JAX startup's values carried
into the port by name (``load_persistables``), three optimizer steps on
those feeds give per-step losses within 1e-5 relative and every
persistable within 1e-5 of its largest |value|, or within 1e-4 for the
two Adam chapters (ROADMAP "Adam's amplification": an Adam step turns
1e-7 differences in tiny gradients into 1e-5 of a weight).  The
rankers' output bias has a zero gradient (a pair's or a list's score
differences cancel it) but for rounding, so its values are rounding noise:
both packages' stay under 1e-5."""

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.dataset import common as jcommon
from paddle_tpu_torch.dataset import common as tcommon
from paddle_tpu_torch.models.book_chapters import CHAPTERS, batches

STEPS = 3
NOISE = {"rank_net": ("rank_out.b",), "lambda_rank": ("rank_out.b",)}


@pytest.fixture(autouse=True)
def _synthetic_home(tmp_path, monkeypatch):
    for common in (tcommon, jcommon):
        monkeypatch.setattr(common, "DATA_HOME", str(tmp_path))
    tfluid.reset()
    jfluid.reset()
    yield


def _rel(t, j):
    j = np.asarray(j, np.float64)
    return float(np.abs(np.asarray(t, np.float64) - j).max()
                 / max(float(np.abs(j).max()), 1e-30))


def _persistable(program):
    return [n for n, v in program.global_block().vars.items()
            if v.persistable]


@pytest.mark.parametrize("name", sorted(CHAPTERS))
def test_chapter_trains_as_in_jax(name):
    ch = CHAPTERS[name]
    tol = 1e-4 if ch.adam else 1e-5
    jloss, jvars = ch.build(jfluid, **ch.small)
    jmain = jfluid.default_main_program()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jfluid.default_startup_program())
    names = _persistable(jmain)
    state = {n: np.array(jfluid.global_scope().find_np(n)) for n in names}
    jfeeds = batches(jfluid, ch, jvars, STEPS, **ch.small)

    tloss, tvars = ch.build(tfluid, **ch.small)
    tmain = tfluid.default_main_program()
    assert tmain.to_json() == jmain.to_json()
    tfeeds = batches(tfluid, ch, tvars, STEPS, **ch.small)
    for tf, jf in zip(tfeeds, jfeeds):
        assert sorted(tf) == sorted(jf)
        for k in jf:
            assert tf[k].dtype == np.asarray(jf[k]).dtype, (name, k)
            np.testing.assert_array_equal(tf[k], jf[k], err_msg=k)
    assert tcommon.data_mode(ch.dataset) == "synthetic"

    tfluid.load_persistables(tmain, state)
    texe = tfluid.Executor(tfluid.CPUPlace())
    jl = [float(np.asarray(jexe.run(jmain, feed=f, fetch_list=[jloss])[0])
                .reshape(-1)[0]) for f in jfeeds]
    tl = [float(texe.run(tmain, feed=f, fetch_list=[tloss])[0]
                .reshape(-1)[0]) for f in tfeeds]
    assert np.isfinite(tl).all()
    np.testing.assert_allclose(tl, jl, rtol=tol)
    for n in names:
        t = tfluid.global_scope().find_np(n)
        j = jfluid.global_scope().find_np(n)
        if n in NOISE.get(name, ()):
            assert np.abs(t).max() < 1e-5 and np.abs(j).max() < 1e-5, n
            continue
        assert _rel(t, j) <= tol, (name, n, _rel(t, j))


def test_each_chapter_reads_its_dataset():
    assert {c.dataset for c in CHAPTERS.values()} == {
        "imdb", "wmt14", "movielens", "imikolov", "mq2007"}
    for ch in CHAPTERS.values():
        assert ch.full["bs"] >= ch.small["bs"]
