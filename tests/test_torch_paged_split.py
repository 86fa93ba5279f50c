"""The split-KV schedule of the paged attention kernels K2
(``csrc/paged_attention.cu``) and K3 (``csrc/paged_attention_mq.cu``),
emulated in numpy on the CPU.

The kernels run only on a card (``test_torch_kernels.py`` holds them
against their plain versions there).  What is checked here is how they
cut the work, in float64, with the constants read from the CUDA sources:

- which pages each (slot, head, split) block takes, from ``maxp``,
  ``PAGES_PER_SPLIT``, ``ctx_lens`` and ``q_starts``: the live splits
  partition exactly the pages the rows need, a split wholly past them is
  empty, and no row at or past the needed keys is ever read (the emulation
  runs on pools whose unseen slots are poisoned);
- each block's walk: K2's four warps taking the split's pages round-robin,
  8 keys a pass, each warp's running max, normalizer and accumulator, the
  warps merged; K3's rows in m-tiles of 16 and its 16-key units dealt to
  ``warps / m-tiles`` key groups (four warps, eight for f32 blocks of two
  or more m-tiles), every (row, key) pair masked by position, the key
  groups merged;
- each split's partial (m in log2 units, l, acc) and the combine, which
  skips a split with m = -inf;

and the result is held to a float64 transcription of the plain versions'
dense formula at 1e-12, and to ``paged_attention_ref`` and
``paged_attention_mq_ref`` themselves at f32's 1e-5 (the plain versions
take their scores in f32, so they hold float64 inputs only that far).  A
bf16 emulation rounds P to bf16 against its split's running max, as the
kernels do, and stays within 2e-2 of max |value| of the plain version in
bf16.  ``PYTHONPATH=. python3 tests/test_torch_paged_split.py`` prints
each bf16 case's distance beside the distance of the same rounding
against one running max over the whole walk (the Pallas kernels' order).
"""

import os
import re

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.cuda_kernels import paged_attention as t_pa

CSRC = os.path.join(os.path.dirname(os.path.abspath(t_pa.__file__)), "csrc")
PPS = t_pa.PAGES_PER_SPLIT
MQ_ROWS = t_pa.MQ_ROWS
K2_WARPS = 4   # paged_attention.cu kWarps
# paged_attention_mq.cu kWarps, kWarpsWideF32
K3_WARPS, K3_WARPS_WIDE_F32 = 4, 8
K2_PASS = 8    # keys a K2 pass: one a quad of lanes
UNIT = 16      # paged_attention_mq.cu kUnit: keys a K3 unit
LOG2E = 1.0 / np.log(2.0)


def cdiv(a, b):
    return -(-a // b)


def _const(fname, name):
    with open(os.path.join(CSRC, fname)) as f:
        src = f.read()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def test_constants_mirror_the_cuda_sources():
    assert _const("paged_split.cuh", "kPagesPerSplit") == PPS
    assert _const("paged_attention_mq.cu", "kMqRows") == MQ_ROWS
    assert _const("paged_attention.cu", "kWarps") == K2_WARPS
    assert _const("paged_attention_mq.cu", "kWarps") == K3_WARPS
    assert _const("paged_attention_mq.cu", "kWarpsWideF32") \
        == K3_WARPS_WIDE_F32
    assert _const("paged_attention_mq.cu", "kUnit") == UNIT
    assert t_pa.n_splits(64) == 8 and t_pa.n_splits(8) == 1 \
        and t_pa.n_splits(9) == 2


def exact(p):
    return p


def bf16(x):
    """Round to bf16 as the kernels do (f32, then round to nearest even)."""
    return torch.from_numpy(np.asarray(x, np.float32)).to(
        torch.bfloat16).double().numpy()


# -- the schedule -------------------------------------------------------------

def split_pages(kv_end, ps, s):
    """The pages block `s` walks, or None for a split wholly past the keys
    its rows need (keys < kv_end)."""
    n_pages = cdiv(kv_end, ps)
    p0 = s * PPS
    if p0 >= n_pages:
        return None
    return range(p0, min(p0 + PPS, n_pages))


def mq_shape(C, f32):
    """(m-tiles, key groups) of a K3 block: rows padded to 16, 3 m-tiles
    taken as 4; four warps, eight for f32 blocks of 2 or more m-tiles."""
    rows = min(C, MQ_ROWS)
    mt = 1 if rows <= 16 else 2 if rows <= 32 else 4
    nw = K3_WARPS_WIDE_F32 if f32 and mt > 1 else K3_WARPS
    return mt, nw // mt


def combine(parts):
    """Merge one row's split partials (m2, l, acc); m2 = -inf weighs
    nothing and its acc is not read."""
    big = max(m for m, _, _ in parts)
    norm, num = 0.0, 0.0
    for m, l_, acc in parts:
        if m == -np.inf:
            continue
        w = 2.0 ** (m - big)
        norm += l_ * w
        num = num + acc * w
    return num / norm


def merge(states, c):
    """The block's partial from its warps' or key groups' (m, l, acc),
    m in raw score units: (m * c, l, acc), or (-inf, 0, 0)."""
    big = max(m for m, _, _ in states)
    if big == -np.inf:
        return -np.inf, 0.0, 0.0
    norm, num = 0.0, 0.0
    for m, l_, acc in states:
        if m == -np.inf:
            continue
        w = 2.0 ** ((m - big) * c)
        norm += l_ * w
        num = num + acc * w
    return big * c, norm, num


def online(m, l_, acc, sc, v, c, rnd):
    """One online-softmax step over the scores `sc` [..., keys] (-inf
    where masked) and their value rows `v` [keys, dh]."""
    mx = sc.max(axis=-1)
    m_new = np.maximum(m, mx)
    m_use = np.where(m_new == -np.inf, 0.0, m_new)
    corr = 2.0 ** ((m - m_use) * c)
    p = 2.0 ** (sc * c - (m_use * c)[..., None])
    l_ = l_ * corr + p.sum(axis=-1)
    acc = acc * corr[..., None] + rnd(p) @ v
    return m_new, l_, acc


def k2_block(q, kp, vp, table, ctx, ps, maxp, s, c, rnd, reads):
    """Block (slot, head, split s) of K2 for one head: q [dh], pools [P,
    ps, dh].  Records each (page, row) it reads in `reads`."""
    kv_end = min(ctx, maxp * ps)
    pages = split_pages(kv_end, ps, s)
    if pages is None:
        return -np.inf, 0.0, None
    states = []
    for w in range(K2_WARPS):
        m, l_, acc = -np.inf, 0.0, np.zeros(q.shape[-1])
        for j in pages[w::K2_WARPS]:
            valid = min(ps, kv_end - j * ps)
            reads.update((int(table[j]), t) for t in range(valid))
            k, v = kp[table[j], :valid], vp[table[j], :valid]
            for t0 in range(0, valid, K2_PASS):
                m, l_, acc = online(m, l_, acc, k[t0:t0 + K2_PASS] @ q,
                                    v[t0:t0 + K2_PASS], c, rnd)
        states.append((m, l_, acc))
    return merge(states, c)


def emulate_k2(q, kp, vp, pt, cl, scale=None, rnd=exact, reads=None):
    """K2 on numpy arrays q [N, nh, dh], pools [P, nh, ps, dh]."""
    N, nh, dh = q.shape
    ps, maxp = kp.shape[2], pt.shape[1]
    c = (scale if scale is not None else dh ** -0.5) * LOG2E
    reads = set() if reads is None else reads
    out = np.zeros((N, nh, dh))
    for n in range(N):
        for h in range(nh):
            parts = [k2_block(q[n, h], kp[:, h], vp[:, h], pt[n], int(cl[n]),
                              ps, maxp, s, c, rnd, reads)
                     for s in range(t_pa.n_splits(maxp))]
            out[n, h] = rnd(combine(parts))
    return out


def k3_block(q, kp, vp, table, ctx, start, c_lo, ps, maxp, s, c, C, rnd,
             reads, f32):
    """Block (slot, head, split s, row tile at c_lo) of K3 for one head:
    q [rows, dh], with the f32 or the bf16 block shape.  Returns the rows'
    partials."""
    rows = q.shape[0]
    mt, kg = mq_shape(C, f32)
    kv_lim = min(ctx, maxp * ps)
    kv_end = min(kv_lim, start + c_lo + rows)
    pages = split_pages(kv_end, ps, s)
    if pages is None:
        return [(-np.inf, 0.0, None)] * rows
    upp = cdiv(ps, UNIT)
    qpos = start + c_lo + np.arange(rows)
    groups = [(np.full(rows, -np.inf), np.zeros(rows),
               np.zeros((rows, q.shape[1]))) for _ in range(kg)]
    for ui in range(len(pages) * upp):
        j = pages[0] + ui // upp
        kpos0 = j * ps + (ui % upp) * UNIT
        valid = min(min(kv_end, (j + 1) * ps) - kpos0, UNIT)
        if valid <= 0:
            continue
        off = kpos0 - j * ps
        reads.update((int(table[j]), off + t) for t in range(valid))
        k = kp[table[j], off:off + valid]
        v = vp[table[j], off:off + valid]
        kpos = kpos0 + np.arange(valid)
        sc = np.where(kpos[None, :] <= qpos[:, None], q @ k.T, -np.inf)
        groups[ui % kg] = online(*groups[ui % kg], sc, v, c, rnd)
    return [merge([(g[0][r], g[1][r], g[2][r]) for g in groups], c)
            for r in range(rows)]


def emulate_k3(q, kp, vp, pt, cl, q0, scale=None, rnd=exact, reads=None,
               f32=True):
    """K3 on numpy arrays q [N, nh, C, dh], pools [P, nh, ps, dh], with the
    f32 or the bf16 block shape."""
    N, nh, C, dh = q.shape
    ps, maxp = kp.shape[2], pt.shape[1]
    c = (scale if scale is not None else dh ** -0.5) * LOG2E
    reads = set() if reads is None else reads
    out = np.zeros(q.shape)
    for n in range(N):
        for h in range(nh):
            for c_lo in range(0, C, MQ_ROWS):
                rq = q[n, h, c_lo:c_lo + MQ_ROWS]
                parts = [k3_block(rq, kp[:, h], vp[:, h], pt[n],
                                  int(cl[n]), int(q0[n]), c_lo, ps, maxp, s,
                                  c, C, rnd, reads, f32)
                         for s in range(t_pa.n_splits(maxp))]
                for r in range(rq.shape[0]):
                    out[n, h, c_lo + r] = rnd(combine([p[r] for p in parts]))
    return out


def oracle_mq(q, kp, vp, pt, cl, q0, scale=None):
    """The plain versions' dense formula in float64: gather the table,
    mask key p for row c unless p <= q0 + c and p < ctx, softmax."""
    N, nh, C, dh = q.shape
    ps, maxp = kp.shape[2], pt.shape[1]
    s = scale if scale is not None else dh ** -0.5

    def dense(pages):
        return pages[pt].transpose(0, 2, 1, 3, 4).reshape(N, nh, maxp * ps,
                                                          dh)
    sc = np.einsum("nhcd,nhkd->nhck", q, dense(kp)) * s
    kpos = np.arange(maxp * ps)
    qpos = q0[:, None] + np.arange(C)
    vis = (kpos[None, None] <= qpos[:, :, None]) \
        & (kpos[None, None] < cl[:, None, None])
    sc = np.where(vis[:, None], sc, -np.inf)
    p = np.exp(sc - sc.max(axis=-1, keepdims=True))
    return np.einsum("nhck,nhkd->nhcd", p / p.sum(axis=-1, keepdims=True),
                     dense(vp))


def oracle_k2(q, kp, vp, pt, cl):
    """K2's contract is K3's with one row at position ctx - 1."""
    return oracle_mq(q[:, :, None], kp, vp, pt, cl, cl - 1)[:, :, 0]


# -- cases --------------------------------------------------------------------

def _table(rng, lens, ps, maxp, P):
    """A table of distinct pages for each slot's first ceil(len / ps)
    entries (null past them; an all-null row for len 0)."""
    pt = np.zeros((len(lens), maxp), np.int32)
    perm = iter(rng.permutation(np.arange(1, P)))
    for n, L in enumerate(lens):
        for j in range(min(cdiv(L, ps), maxp)):
            pt[n, j] = next(perm)
    return pt


def _poison(kp, vp, pt, needed, ps):
    """Pools with every slot outside each slot's first `needed` keys set
    to 1e9 (what the kernels must never read)."""
    keep = np.zeros((kp.shape[0], ps), bool)
    for n, L in enumerate(needed):
        for j in range(min(cdiv(L, ps), pt.shape[1])):
            keep[pt[n, j], :min(ps, L - j * ps)] = True
    mask = ~keep[:, None, :, None]
    return np.where(mask, 1e9, kp), np.where(mask, 1e9, vp)


# K2: (maxp, ps, ctx_lens).  ctx 1 on an all-null row; ctx = maxp * ps;
# ctx past maxp * ps (clamped); a ctx ending on a split boundary (split 1
# wholly past it); one ending inside split 1 (split 2 wholly past it);
# the serving decode shape; one slot at ctx 1024 alone.
K2_CASES = {
    "small": (20, 4, [1, 80, 95, 32, 33, 5]),
    "decode": (64, 16, [1, 17, 1024, 300, 64, 999, 5, 512]),
    "long_alone": (64, 16, [1024]),
}


def _k2_case(name, seed=0, nh=2, dh=8):
    maxp, ps, ctx = K2_CASES[name]
    rng = np.random.RandomState(seed)
    P = len(ctx) * maxp + 1
    pt = _table(rng, ctx, ps, maxp, P)
    pt[0] = 0 if ctx[0] == 1 else pt[0]  # the idle slot reads the null page
    q = rng.randn(len(ctx), nh, dh)
    kp, vp = rng.randn(P, nh, ps, dh), rng.randn(P, nh, ps, dh)
    cl = np.array(ctx, np.int32)
    kn, vn = _poison(kp, vp, pt, [min(L, maxp * ps) for L in ctx], ps)
    return q, kp, vp, kn, vn, pt, cl


@pytest.mark.parametrize("name", sorted(K2_CASES))
def test_k2_splits_partition_the_needed_pages(name):
    maxp, ps, ctx = K2_CASES[name]
    S = t_pa.n_splits(maxp)
    for L in ctx:
        kv_end = min(L, maxp * ps)
        taken = [split_pages(kv_end, ps, s) for s in range(S)]
        live = [list(p) for p in taken if p is not None]
        assert taken[0] is not None  # split 0 holds key 0
        assert sum(live, []) == list(range(cdiv(kv_end, ps)))
        assert all(len(p) <= PPS for p in live)
        # the live splits come first; the rest are wholly past the keys
        assert all(p is None for p in taken[len(live):])


@pytest.mark.parametrize("name", sorted(K2_CASES))
def test_emulated_k2_matches_the_plain_version(name):
    q, kp, vp, kn, vn, pt, cl = _k2_case(name)
    reads = set()
    got = emulate_k2(q, kn, vn, pt, cl, reads=reads)
    assert np.isfinite(got).all()
    # every slot read is one the slot's context sees: none is poisoned
    assert all(kn[p, 0, t, 0] != 1e9 for p, t in reads)
    want = oracle_k2(q, kp, vp, pt, cl)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    ref = t_pa.paged_attention_ref(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in
          (q, kn, vn, pt, cl))).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


# K3: (maxp, ps, C, lanes of (q_start, chunk rows)); ctx = max(q_start +
# rows, 1) as the chunk op passes it.  An idle lane (all-null row); a chunk
# across the split boundary at key PPS * ps, whose first rows see no key of
# the later split; a chunk from position 0; a chunk whose ctx passes
# maxp * ps (clamped); rows past a lane's chunk; the serving mixed and
# verify shapes.
MQ_CASES = {
    "c1": (20, 4, 1, [(0, 1), (30, 1), (79, 1), (0, 0), (85, 1)]),
    "c5": (20, 4, 5, [(30, 5), (0, 3), (0, 0), (77, 5), (12, 2)]),
    "c32": (20, 4, 32, [(20, 32), (0, 32), (0, 0), (60, 25)]),
    "c64": (20, 4, 64, [(0, 64), (5, 40), (0, 0), (31, 64)]),
    "c70": (20, 4, 70, [(0, 70), (10, 66), (0, 0)]),
    "mixed": (64, 16, 32, [(576, 20), (200, 32), (0, 0), (990, 32)]),
    "verify": (64, 16, 5, [(1, 5), (14, 5), (1019, 5), (300, 3), (64, 5),
                           (999, 1), (5, 2), (0, 0)]),
}


def _mq_case(name, seed=0, nh=2, dh=8):
    maxp, ps, C, lanes = MQ_CASES[name]
    rng = np.random.RandomState(seed)
    q0 = np.array([s for s, _ in lanes], np.int32)
    cl = np.array([max(s + r, 1) for s, r in lanes], np.int32)
    needed = [min(int(L), s + C, maxp * ps) for L, (s, _) in zip(cl, lanes)]
    P = len(lanes) * maxp + 1
    pt = _table(rng, [L if r else 0 for L, (_, r) in zip(cl, lanes)], ps,
                maxp, P)
    q = rng.randn(len(lanes), nh, C, dh)
    kp, vp = rng.randn(P, nh, ps, dh), rng.randn(P, nh, ps, dh)
    kn, vn = _poison(kp, vp, pt, needed, ps)
    return q, kp, vp, kn, vn, pt, cl, q0


def test_mq_cases_cover_the_awkward_schedules():
    """The K3 cases hold what they claim: a split with no visible key for
    some rows, a split wholly past a lane's keys, a chunk across a split
    boundary, ctx past maxp * ps, an idle lane, C 1, 5, 32, 64 and a second
    row tile."""
    seen = set()
    for name, (maxp, ps, C, lanes) in MQ_CASES.items():
        seen.add(("C", C))
        for s_, r in lanes:
            ctx = max(s_ + r, 1)
            kv_end = min(ctx, s_ + C, maxp * ps)
            bound = PPS * ps
            if r == 0:
                seen.add("idle")
            if ctx > maxp * ps:
                seen.add("ctx_past_table")
            if s_ < bound < min(ctx, s_ + C):
                seen.add("chunk_across_split")
                seen.add("rows_without_key_in_split")
            if split_pages(kv_end, ps, 1) is None and maxp > PPS:
                seen.add("split_past_ctx")
        if C > MQ_ROWS:
            seen.add("row_tiles")
    assert {("C", 1), ("C", 5), ("C", 32), ("C", 64), "idle",
            "ctx_past_table", "chunk_across_split",
            "rows_without_key_in_split", "split_past_ctx",
            "row_tiles"} <= seen


@pytest.mark.parametrize("f32", [True, False])
@pytest.mark.parametrize("name", sorted(MQ_CASES))
def test_emulated_k3_matches_the_plain_version(name, f32):
    """Both block shapes, the f32 one (8 warps at 2+ m-tiles) and the
    bf16 one, in float64."""
    q, kp, vp, kn, vn, pt, cl, q0 = _mq_case(name)
    reads = set()
    got = emulate_k3(q, kn, vn, pt, cl, q0, reads=reads, f32=f32)
    assert np.isfinite(got).all()
    assert all(kn[p, 0, t, 0] != 1e9 for p, t in reads)
    want = oracle_mq(q, kp, vp, pt, cl, q0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    ref = t_pa.paged_attention_mq_ref(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in
          (q, kn, vn, pt, cl, q0))).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_emulated_k3_single_row_is_the_k2_walk():
    """C = 1 at q_start = ctx - 1 (K3's unit walk) equals K2's (its warp
    walk) on the same pools: two schedules of one function."""
    q, kp, vp, kn, vn, pt, cl = _k2_case("small")
    mq = emulate_k3(q[:, :, None], kn, vn, pt, cl, cl - 1)[:, :, 0]
    np.testing.assert_allclose(mq, emulate_k2(q, kn, vn, pt, cl), rtol=0,
                               atol=1e-12)


# -- bf16: P rounded against the split's running max ------------------------

def _bf16_case(kind, name):
    """Inputs rounded to bf16, the emulation with P and the output rounded
    to bf16, the plain version in bf16 on the same inputs, and the same
    rounding against one running max over the whole walk (what the Pallas
    kernels round against): (emulated, whole_walk, plain) as float64."""
    if kind == "k2":
        q, _, _, kn, vn, pt, cl = _k2_case(name, dh=16)
        q, kn, vn = bf16(q), bf16(kn), bf16(vn)
        got = emulate_k2(q, kn, vn, pt, cl, rnd=bf16)
        whole = emulate_whole_walk(q[:, :, None], kn, vn, pt, cl, cl - 1)
        whole = whole[:, :, 0]
        args = (q, kn, vn, pt, cl)
        plain = t_pa.paged_attention_ref
    else:
        q, _, _, kn, vn, pt, cl, q0 = _mq_case(name, dh=16)
        q, kn, vn = bf16(q), bf16(kn), bf16(vn)
        got = emulate_k3(q, kn, vn, pt, cl, q0, rnd=bf16, f32=False)
        whole = emulate_whole_walk(q, kn, vn, pt, cl, q0)
        args = (q, kn, vn, pt, cl, q0)
        plain = t_pa.paged_attention_mq_ref
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    t[:3] = [a.to(torch.bfloat16) for a in t[:3]]
    return got, whole, plain(*t).double().numpy()


def emulate_whole_walk(q, kp, vp, pt, cl, q0):
    """One running max over the slot's whole walk, page by page, P rounded
    to bf16 against it (the Pallas bodies' order)."""
    N, nh, C, dh = q.shape
    ps, maxp = kp.shape[2], pt.shape[1]
    c = dh ** -0.5 * LOG2E
    out = np.zeros(q.shape)
    for n in range(N):
        kv_lim = min(int(cl[n]), maxp * ps)
        qpos = int(q0[n]) + np.arange(C)
        for h in range(nh):
            st = (np.full(C, -np.inf), np.zeros(C), np.zeros((C, dh)))
            for j in range(cdiv(kv_lim, ps)):
                valid = min(ps, kv_lim - j * ps)
                k = kp[pt[n, j], h, :valid]
                kpos = j * ps + np.arange(valid)
                sc = np.where(kpos[None] <= qpos[:, None], q[n, h] @ k.T,
                              -np.inf)
                st = online(*st, sc, vp[pt[n, j], h, :valid], c, bf16)
            out[n, h] = bf16(st[2] / st[1][:, None])
    return out


def _dist(a, ref):
    return np.abs(a - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("kind,name", [("k2", "decode"), ("k2", "small"),
                                       ("k3", "mixed"), ("k3", "verify"),
                                       ("k3", "c32")])
def test_bf16_rounding_against_the_split_max(kind, name):
    got, whole, plain = _bf16_case(kind, name)
    assert np.isfinite(got).all()
    assert _dist(got, plain) <= 2e-2
    assert _dist(whole, plain) <= 2e-2


if __name__ == "__main__":
    for kind, name in [("k2", "decode"), ("k2", "small"), ("k3", "mixed"),
                       ("k3", "verify"), ("k3", "c32")]:
        got, whole, plain = _bf16_case(kind, name)
        print(f"{kind} {name}: split-max rounding {_dist(got, plain):.3e}, "
              f"whole-walk rounding {_dist(whole, plain):.3e} of max "
              f"|value| from the plain version in bf16")
