"""The arithmetic of the persistent GRU kernels K9 and K10
(``paddle_tpu_torch/ops/cuda_kernels/csrc/gru_persistent.cuh``), on the
CPU.  No kernel runs here (they run only on a card, where
``tests/test_torch_kernels.py -k on_card`` and ``chip_smoke.py`` hold them
to their plain versions); what is checked is what their design rests on:

- (a) each loop product's operand is a row the kernels write, bit for
  bit: round(h_{t-1}) is ``hs[:, t-1]`` (``h0`` at t = 0); the forward's
  candidate operand is round(r ⊙ h) from the f32 carry, the scratch row
  the forward writes; the backward's candidate operand is round(r ⊙
  h_{t-1}) of the prologue; round(da_c) is ``dx[:, t, 2H:]`` and round(dg)
  ``dx[:, t, :2H]``;
- (b) a numpy emulation of the kernels' partition (batch groups of 16
  rows by slices of 16 hidden columns, each block's product split over 8
  warps by 128-byte k chunks, the bf16 products exact and summed in f32 a
  16-deep step at a time, the f32 ones one FMA after another; the
  forward's two products a step around the scratch row; the backward's
  two-phase prologue, its dh carry kept by the column's owner, and dh's
  update half taken in the first barrier's product beside drh) gives the
  plain versions' and the JAX Pallas kernels' results (interpret mode);
- (c) a model of the group counter (two arrivals a block a step, and the
  backward prologue's barrier of a grid row) under random block
  schedules, with a grid row a batch group and with grid rows that run
  several groups in turn: no block reads a row before all of its
  producers have published it, none writes a row another block may still
  read, and every schedule finishes; a barrier one arrival early is
  caught;
- (d) the lane maps of the warp products at the GRU's tile widths: the
  bf16 tiles through the ldmatrix and mma.sync fragment maps of
  ``test_torch_flash_mma.py``, and the f32 tiles' lane ownership.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas_kernels import gru as jgru
from paddle_tpu_torch.ops.cuda_kernels import gru as t_gru
from test_torch_flash_mma import (G, LANES, TQ, a_col16, a_row, b_col16,
                                  b_row, bt_col16, bt_row, c_to_matrix,
                                  ldmatrix_x4_b16, mma_m16n8k16_bf16)

# the kernels' partition (persistent.cuh, gru_persistent.cuh)
ROWS = COLS = 16
WARPS = 8
KC = {"float32": 32, "bfloat16": 64}  # k of a 128-byte staged chunk
E = {"float32": 4, "bfloat16": 8}     # elements of 16 bytes
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
# (B, T, H, lengths): two batch groups (the second partial) by three
# slices (the last partial), with a row of length 0; the plain tests'
# awkward shape; a width whose first backward product gives all 8 warps
# k chunks
SHAPES = {
    "b19_h40": (19, 5, 40, [5, 0, 3, 5, 1, 4, 5, 2, 5, 5, 3, 0, 5, 4, 1, 5,
                            2, 5, 3]),
    "b3_h20": (3, 5, 20, [5, 0, 3]),
    "b17_h136": (17, 3, 136, [3, 1, 3, 2, 0, 3, 3, 1, 2, 3, 3, 3, 1, 2, 3,
                              0, 3]),
}


@pytest.fixture(autouse=True)
def _fresh_port():
    import paddle_tpu_torch

    paddle_tpu_torch.reset()
    yield


def _round(x, dtype):
    """float32 values rounded to `dtype`, kept as float32."""
    x = np.ascontiguousarray(x, np.float32)
    if dtype == "float32":
        return x
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def _inputs(shape, dtype, seed=0):
    B, T, H, lengths = SHAPES[shape]
    rng = np.random.RandomState(seed)

    def f(*s, scale=1.0):
        return _round(rng.randn(*s) * scale, dtype)

    return {"x": f(B, T, 3 * H, scale=0.3), "h0": f(B, H, scale=0.2),
            "w": f(H, 3 * H, scale=0.1),
            "lengths": np.asarray(lengths, np.int32), "dhs": f(B, T, H)}


def _t(a, dtype):
    t = torch.from_numpy(np.asarray(a))
    return t.to(TORCH_DT[dtype]) if t.is_floating_point() else t


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


# -- (a) the exchanged rows are the products' operands, bit for bit ---------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_product_operands_are_the_written_rows_bit_for_bit(shape, dtype,
                                                           monkeypatch):
    a = _inputs(shape, dtype)
    B, T, H, _ = SHAPES[shape]
    dt = TORCH_DT[dtype]
    x, h0, w, lengths = [_t(a[k], dtype) for k in ("x", "h0", "w",
                                                    "lengths")]
    seen = []
    real_dot = t_gru._dot

    def recording_dot(p, q):
        seen.append(p.clone())
        return real_dot(p, q)

    monkeypatch.setattr(t_gru, "_dot", recording_dot)
    hs, _ = t_gru.gru_forward_ref(x, h0, w, lengths)
    assert len(seen) == 2 * T
    # the forward, replayed along the recorded operands: the gates'
    # operand is the row hs[:, t-1], the candidate's is round(r ⊙ h) of
    # the f32 carry, as the kernel writes it to its scratch row
    carry = h0.float()
    mask = (torch.arange(T)[None, :] < lengths[:, None]).float()
    for t in range(T):
        op_g, op_c = seen[2 * t], seen[2 * t + 1]
        assert op_g.dtype == op_c.dtype == dt
        assert torch.equal(op_g, h0 if t == 0 else hs[:, t - 1]), t
        g = x[:, t, :2 * H].float() + real_dot(op_g, w[:, :2 * H])
        u, r = torch.sigmoid(g[:, :H]), torch.sigmoid(g[:, H:])
        assert torch.equal(op_c, (r * carry).to(dt)), t
        c = torch.tanh(x[:, t, 2 * H:].float() + real_dot(op_c, w[:, 2 * H:]))
        m = mask[:, t, None]
        carry = m * (u * carry + (1.0 - u) * c) + (1.0 - m) * carry
        assert torch.equal(hs[:, t], carry.to(dt)), t
    seen.clear()
    dx, _, _ = t_gru.gru_backward_ref(x, h0, w, lengths, hs,
                                      _t(a["dhs"], dtype))
    # per step, in order: the gates' and the candidate's (the prologue's
    # two products), drh's and dh's
    assert len(seen) == 4 * T
    for i, t in enumerate(reversed(range(T))):
        op_g, op_c, op_drh, op_dh = seen[4 * i:4 * i + 4]
        hp = h0 if t == 0 else hs[:, t - 1]
        assert torch.equal(op_g, hp), t
        g = x[:, t, :2 * H].float() + real_dot(op_g, w[:, :2 * H])
        r = torch.sigmoid(g[:, H:])
        assert torch.equal(op_c, (r * hp.float()).to(dt)), t
        assert op_drh.dtype == op_dh.dtype == dt
        assert torch.equal(op_drh, dx[:, t, 2 * H:]), t
        assert torch.equal(op_dh, dx[:, t, :2 * H]), t


# -- (b) the kernels' partition, emulated ------------------------------------

def _n_chunks(K, dtype):
    return -(-K // KC[dtype])


def _warp_chunks(n):
    """Warp w's chunks [s0, s1) of a run of n."""
    return [(w * n // WARPS, (w + 1) * n // WARPS) for w in range(WARPS)]


def _chain(a, b, k0, k1, dtype):
    """One warp's sums over k in [k0, k1) of a [R, K] by b [K, N], both
    holding values of `dtype`: f32 one FMA after another (the product is
    exact in float64, the sum rounded once to f32), bf16 a 16-deep
    mma.sync step at a time (16 exact products, added to the f32
    accumulator)."""
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    k1 = min(k1, a.shape[1])
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    step = 1 if dtype == "float32" else 16
    for k in range(k0, k1, step):
        e = min(k + step, k1)
        acc = (acc + a64[:, k:e] @ b64[k:e]).astype(np.float32)
    return acc


def _split_product(a, b, dtype):
    """A block's product split over the warps by k chunks, the warps'
    partial tiles then summed in order in f32 (the kernels' red[])."""
    kc = KC[dtype]
    out = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for s0, s1 in _warp_chunks(_n_chunks(a.shape[1], dtype)):
        out = out + _chain(a, b, s0 * kc, s1 * kc, dtype)
    return out


def first_product_chunks(K, dtype):
    """The backward's first product: the chunks of the candidate operand,
    then those of the update operand, split over the warps as one run of
    2 ceil(K / kc); warp w's [(c0, c1), (u0, u1)] chunk ranges."""
    n = _n_chunks(K, dtype)
    return [((min(s0, n), min(s1, n)), (max(s0, n) - n, max(s1, n) - n))
            for s0, s1 in _warp_chunks(2 * n)]


def _split_pair(a_c, b_c, a_u, b_u, dtype):
    """drh and dh's update part: each warp's chunks of each operand into a
    tile of its own, each kind's tiles summed over the warps in order."""
    kc = KC[dtype]
    drh = np.zeros((a_c.shape[0], b_c.shape[1]), np.float32)
    dhu = np.zeros_like(drh)
    for (c0, c1), (u0, u1) in first_product_chunks(a_c.shape[1], dtype):
        drh = drh + _chain(a_c, b_c, c0 * kc, c1 * kc, dtype)
        dhu = dhu + _chain(a_u, b_u, u0 * kc, u1 * kc, dtype)
    return drh, dhu


def _sigmoid(x):
    return np.float32(1) / (np.float32(1) + np.exp(-x))


def _blocks(B, H):
    """(rows, hidden columns) of each block of the grid."""
    for b0 in range(0, B, ROWS):
        rows = np.arange(b0, min(b0 + ROWS, B))
        for j0 in range(0, H, COLS):
            yield rows, np.arange(j0, min(j0 + COLS, H))


def emulate_forward(a, dtype):
    """K9 block by block: step t's gates from the rows hs[:, t-1] (h0 at
    t = 0), the owner's round(r h) from its f32 carry into the scratch
    row, the group's barrier, the candidate from the scratch rows, the
    carry kept by the (row, column) owner.  Returns (hs, hT, scratch)."""
    x, h0, w = (a[k] for k in ("x", "h0", "w"))
    B, T, H3 = x.shape
    H = H3 // 3
    hc = h0.copy()  # the f32 carry of every owner
    hs = np.zeros((B, T, H), np.float32)
    rhs = np.zeros_like(hs)
    u_all = np.zeros((B, H), np.float32)
    for t in range(T):
        prev = h0 if t == 0 else hs[:, t - 1]
        for rows, js in _blocks(B, H):
            cols = np.concatenate([js, H + js])
            g = _split_product(prev[rows], w[:, cols], dtype) \
                + x[rows, t][:, cols]
            u, r = _sigmoid(g[:, :len(js)]), _sigmoid(g[:, len(js):])
            u_all[np.ix_(rows, js)] = u
            rhs[np.ix_(rows, [t], js)] = _round(
                r * hc[np.ix_(rows, js)], dtype)[:, None]
        # the group's barrier: every block has written rhs[:, t]
        for rows, js in _blocks(B, H):
            gc = _split_product(rhs[rows, t], w[:, 2 * H + js], dtype) \
                + x[rows, t][:, 2 * H + js]
            u, h = u_all[np.ix_(rows, js)], hc[np.ix_(rows, js)]
            live = (t < a["lengths"][rows])[:, None]
            hc[np.ix_(rows, js)] = np.where(
                live, u * h + (1 - u) * np.tanh(gc), h)
            hs[np.ix_(rows, [t], js)] = _round(hc[np.ix_(rows, js)],
                                               dtype)[:, None]
    return hs, _round(hc, dtype), rhs


def emulate_backward(a, hs, dtype):
    """K10 block by block: the prologue's gate pre-activations and r
    h_{t-1} of every step (a warp a step, over all of k), the grid row's
    barrier, the candidate's pre-activations from round(r h_{t-1}); then
    in reverse time the owners' dg_u and da_c, the first barrier, drh and
    dh's update part in one run of chunks, the owners' dg_r, the second
    barrier, dh's reset part; dW from the f32 gradients after the loop."""
    x, h0, w = (a[k] for k in ("x", "h0", "w"))
    B, T, H3 = x.shape
    H = H3 // 3
    prev = np.concatenate([h0[:, None], hs[:, :-1]], 1)
    pre = np.zeros((B, T, H3), np.float32)
    rh_all = np.zeros((B, T, H), np.float32)
    for rows, js in _blocks(B, H):
        cols = np.concatenate([js, H + js])
        for t in range(T):
            g = _chain(prev[rows, t], w[:, cols], 0, H, dtype) \
                + x[rows, t][:, cols]
            pre[np.ix_(rows, [t], cols)] = g[:, None]
            rh_all[np.ix_(rows, [t], js)] = (
                _sigmoid(g[:, len(js):]) * prev[rows, t][:, js])[:, None]
    rh_op = _round(rh_all, dtype)
    for rows, js in _blocks(B, H):
        for t in range(T):
            pre[np.ix_(rows, [t], 2 * H + js)] = (
                _chain(rh_op[rows, t], w[:, 2 * H + js], 0, H, dtype)
                + x[rows, t][:, 2 * H + js])[:, None]
    dh = np.zeros((B, H), np.float32)
    carry = np.zeros_like(dh)
    dg32 = np.zeros((B, T, H3), np.float32)
    dx = np.zeros_like(dg32)
    for t in reversed(range(T)):
        dh_acc = a["dhs"][:, t] + dh
        m = (t < a["lengths"]).astype(np.float32)[:, None]
        for rows, js in _blocks(B, H):
            ix = np.ix_(rows, js)
            u = _sigmoid(pre[rows, t][:, js])
            c = np.tanh(pre[rows, t][:, 2 * H + js])
            hp, mr, acc = prev[rows, t][:, js], m[rows], dh_acc[ix]
            dh_raw = mr * acc
            dg32[np.ix_(rows, [t], js)] = (
                dh_raw * (hp - c) * u * (1 - u))[:, None]
            dg32[np.ix_(rows, [t], 2 * H + js)] = (
                dh_raw * (1 - u) * (1 - c * c))[:, None]
            carry[ix] = (1 - mr) * acc + dh_raw * u
        dx[:, t, :H] = _round(dg32[:, t, :H], dtype)
        dx[:, t, 2 * H:] = _round(dg32[:, t, 2 * H:], dtype)
        # the first barrier: every block has written dg_u and da_c
        for rows, js in _blocks(B, H):
            ix = np.ix_(rows, js)
            drh, dhu = _split_pair(dx[rows, t, 2 * H:], w[js, 2 * H:].T,
                                   dx[rows, t, :H], w[js, :H].T, dtype)
            r = _sigmoid(pre[rows, t][:, H + js])
            dg32[np.ix_(rows, [t], H + js)] = (
                drh * prev[rows, t][:, js] * r * (1 - r))[:, None]
            carry[ix] = carry[ix] + drh * r
            carry[ix] = carry[ix] + dhu
        dx[:, t, H:2 * H] = _round(dg32[:, t, H:2 * H], dtype)
        # the second barrier: every block has written dg_r
        for rows, js in _blocks(B, H):
            ix = np.ix_(rows, js)
            dh[ix] = carry[ix] + _split_product(
                dx[rows, t, H:2 * H], w[js, H:2 * H].T, dtype)
    rows_prev = prev.reshape(B * T, H).astype(np.float64)
    d = dg32.reshape(B * T, H3).astype(np.float64)
    dw = np.concatenate([rows_prev.T @ d[:, :2 * H],
                         rh_all.reshape(B * T, H).astype(np.float64).T
                         @ d[:, 2 * H:]], 1).astype(np.float32)
    return dx, _round(dh, dtype), _round(dw, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_emulated_partition_matches_plain_and_pallas(shape, dtype):
    a = _inputs(shape, dtype, seed=3)
    args = [_t(a[k], dtype) for k in ("x", "h0", "w", "lengths")]
    jargs = [jnp.asarray(a[k], JAX_DT[dtype]) for k in ("x", "h0", "w")]
    jlen = jnp.asarray(a["lengths"])
    hs, hT, _ = emulate_forward(a, dtype)
    plain = t_gru.gru_forward_ref(*args)
    jax_out = jgru.gru_forward(*jargs, jlen, interpret=True)
    for name, g, p, j in zip(("hs", "hT"), (hs, hT), plain, jax_out):
        assert _rel(g, _np(p)) <= TOL[dtype], name
        assert _rel(g, np.asarray(j, np.float32)) <= TOL[dtype], name
    # the backward from the plain forward's saved states, as the kernel
    saved = _np(plain[0])
    got_g = emulate_backward(a, saved, dtype)
    plain_g = t_gru.gru_backward_ref(*args, plain[0], _t(a["dhs"], dtype))
    jax_g = jgru.gru_backward(*jargs, jlen, jnp.asarray(saved, JAX_DT[dtype]),
                              jnp.asarray(a["dhs"], JAX_DT[dtype]),
                              interpret=True)
    for name, g, p, j in zip(("dx", "dh0", "dw"), got_g, plain_g, jax_g):
        assert _rel(g, _np(p)) <= TOL[dtype], name
        assert _rel(g, np.asarray(j, np.float32)) <= TOL[dtype], name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H", [20, 136, 512, 520])
def test_first_backward_product_takes_every_chunk_once(H, dtype):
    """The run of 2 ceil(H / kc) chunks the warps split: each candidate
    chunk and each update chunk goes to exactly one warp, in order, so
    drh and dh's update part each sum every k once."""
    n = _n_chunks(H, dtype)
    c_seen, u_seen = [], []
    for (c0, c1), (u0, u1) in first_product_chunks(H, dtype):
        c_seen += range(c0, c1)
        u_seen += range(u0, u1)
    assert c_seen == list(range(n)) and u_seen == list(range(n))


# -- (c) the group barrier under random schedules ----------------------------

class Rows:
    """A group's rows of one buffer ([T] steps by `slices` column slices):
    who wrote each cell (and what), and which blocks have read each step."""

    def __init__(self, T, slices):
        self.state = [[None] * slices for _ in range(T)]
        self.readers = [set() for _ in range(T)]
        self.faults = []

    def write(self, blk, t, what):
        if self.readers[t] - {blk}:
            self.faults.append(f"block {blk} wrote step {t} after blocks "
                               f"{sorted(self.readers[t])} read it")
        self.state[t][blk] = what

    def read(self, blk, t, want):
        if any(s != want for s in self.state[t]):
            self.faults.append(f"block {blk} read step {t} as "
                               f"{self.state[t]}, want all {want!r}")
        self.readers[t].add(blk)


def forward_block(blk, T, groups):
    """K9's program order for one block, as the operations that touch a
    group: for each of its batch groups in turn, step t waits for 2t
    arrivals a block, reads hs[:, t-1], writes its scratch row rhs[:, t],
    arrives, waits for 2t + 1, reads rhs[:, t], writes hs[:, t], arrives.
    `groups`: [(group, {"hs": Rows, "rhs": Rows})]."""
    for g, buf in groups:
        for t in range(T):
            if t > 0:
                yield ("wait", g, 2 * t)
                buf["hs"].read(blk, t - 1, "h")
            buf["rhs"].write(blk, t, "rh")
            yield ("arrive", g)
            yield ("wait", g, 2 * t + 1)
            buf["rhs"].read(blk, t, "rh")
            buf["hs"].write(blk, t, "h")
            yield ("arrive", g)


def backward_block(blk, T, y, groups, alias):
    """K10's: the prologue (i) of all its groups (r h_{t-1} into rh_all;
    the f32 gate pre-activations in dx itself when `alias`, the f32
    case), the grid row's barrier, the prologue (ii) (reads rh_all; the
    candidate's pre-activation); then for each group in turn, in reverse
    time, dg_u and da_c into dx, arrive, wait, read them, dg_r into dx,
    arrive, wait, read it.  `groups`: [(group, {"rh": Rows, "uc": Rows,
    "r": Rows})] (dx's update and candidate columns, its reset columns)."""
    for g, buf in groups:
        for t in range(T):
            buf["rh"].write(blk, t, "rh")
            if alias:
                buf["uc"].write(blk, t, "pre")
                buf["r"].write(blk, t, "pre")
            yield ("step",)
    yield ("arrive", ("row", y))
    yield ("wait", ("row", y), 1)
    for g, buf in groups:
        for t in range(T):
            buf["rh"].read(blk, t, "rh")
            if alias:
                buf["uc"].write(blk, t, "pre")
            yield ("step",)
    for g, buf in groups:
        for i, t in enumerate(reversed(range(T))):
            buf["uc"].write(blk, t, "dg")
            yield ("arrive", g)
            yield ("wait", g, 2 * i + 1)
            buf["uc"].read(blk, t, "dg")
            buf["r"].write(blk, t, "dg")
            yield ("arrive", g)
            yield ("wait", g, 2 * i + 2)
            buf["r"].read(blk, t, "dg")


def run_schedule(programs, slices, rng, early=0):
    """Run the blocks' programs, picking a random runnable block each
    tick; a block waiting for k arrivals a block on counter `key` runs
    once that counter reaches the kernels' target slices * k (less
    `early`, to break the barrier on purpose).  Returns False on a
    deadlock."""
    counter = {}
    pending = {i: (p, next(p, None)) for i, p in enumerate(programs)}
    while pending:
        runnable = [i for i, (_, op) in pending.items()
                    if op is None or op[0] != "wait"
                    or counter.get(op[1], 0) >= slices * op[2] - early]
        if not runnable:
            return False
        i = rng.choice(runnable)
        prog, op = pending[i]
        if op is None:
            del pending[i]
            continue
        if op[0] == "arrive":
            counter[op[1]] = counter.get(op[1], 0) + 1
        pending[i] = (prog, next(prog, None))
    return True


def grid_programs(kind, T, slices, groups, grid_rows):
    """The programs of a (slices, grid_rows) grid over `groups` batch
    groups, grid row y serving groups y, y + grid_rows, ... as the kernels
    do; and every group's Rows."""
    names = ("hs", "rhs") if kind == "forward" else ("rh", "uc", "r")
    bufs = [{n: Rows(T, slices) for n in names} for _ in range(groups)]
    programs = []
    for y in range(grid_rows):
        for blk in range(slices):
            mine = [(g, bufs[g]) for g in range(y, groups, grid_rows)]
            programs.append(
                forward_block(blk, T, mine) if kind == "forward"
                else backward_block(blk, T, y, mine,
                                    kind == "backward_f32"))
    return programs, [r for b in bufs for r in b.values()]


# (slices, T, groups, grid rows): path B's 32 column slices a group, one
# grid row a group; and more groups than grid rows, each row running its
# groups one after another
GRIDS = {"one_row_a_group": (32, 5, 1, 1), "rows_loop_groups": (8, 4, 5, 2)}


@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("kind", ["forward", "backward_bf16",
                                  "backward_f32"])
def test_group_barrier_orders_every_random_schedule(kind, grid):
    slices, T, groups, grid_rows = GRIDS[grid]
    rng = random.Random(kind + grid)
    for _ in range(200):
        programs, rows = grid_programs(kind, T, slices, groups, grid_rows)
        assert run_schedule(programs, slices, rng)
        for r in rows:
            assert not r.faults, r.faults[:3]


@pytest.mark.parametrize("kind", ["forward", "backward_bf16"])
def test_group_barrier_model_catches_an_early_reader(kind):
    """The model has teeth: a barrier that opens one arrival early lets
    some schedule read a row before its last producer published it."""
    rng = random.Random(kind)
    caught = False
    for _ in range(200):
        programs, rows = grid_programs(kind, 3, 4, 1, 1)
        run_schedule(programs, 4, rng, early=1)
        caught |= any(r.faults for r in rows)
    assert caught


# -- (d) the warp products' lane maps ----------------------------------------

@pytest.mark.parametrize("tile", ["gates", "candidate"])
def test_bf16_gate_tile_fragment_maps(tile):
    """GateTile<bf16, N> at the GRU's widths: a warp's 16 rows by N = 32
    (u and r) or 16 (the candidate, from column 32) columns of the [k][48
    gate columns] W tile (row stride 56, 112 bytes), over a 64-deep
    staged chunk, lane by lane: A through ldmatrix (a_row, a_col), W
    through ldmatrix.trans (bt_row, bt_col), two n-tiles an x4; each()
    names every sum's (row, column) once, and the tile is A W exactly."""
    N, off = (32, 0) if tile == "gates" else (16, 32)
    rng = np.random.RandomState(2)
    LDA, LDW = 72, 48 + E["bfloat16"]
    a = rng.randint(-4, 5, (16, 64)).astype(np.float64)
    wsl = rng.randint(-4, 5, (64, 48)).astype(np.float64)
    a_s, w_s = np.zeros(16 * LDA), np.zeros(64 * LDW)
    a_s.reshape(-1, LDA)[:, :64] = a
    w_s.reshape(-1, LDW)[:, :48] = wsl
    acc = np.zeros((N // 8, 32, 4))
    for ks in range(4):
        af = ldmatrix_x4_b16(a_s, LDA, a_row(LANES),
                             8 * a_col16(LANES) + 16 * ks)
        for p in range(N // 16):
            bf = ldmatrix_x4_b16(w_s, LDW, ks * 16 + bt_row(LANES),
                                 off + 16 * p + 8 * bt_col16(LANES),
                                 trans=True)
            acc[2 * p] += mma_m16n8k16_bf16(af, bf[:, 0:2])
            acc[2 * p + 1] += mma_m16n8k16_bf16(af, bf[:, 2:4])
    np.testing.assert_array_equal(c_to_matrix(acc, N // 8),
                                  a @ wsl[:, off:off + N])
    seen = np.zeros((16, N), int)
    for n in range(N // 8):
        for i in range(4):
            seen[G + 8 * (i >> 1), n * 8 + 2 * TQ + (i & 1)] += 1
    assert (seen == 1).all()
    # the eight 16-byte rows of an ldmatrix fall in distinct bank groups,
    # and every row and the candidate's offset are 16-byte aligned
    assert len({(r * LDW * 2 // 16) % 8 for r in range(8)}) == 8
    assert LDW * 2 % 16 == 0 and off * 2 % 16 == 0


@pytest.mark.parametrize("gate", [0, 1, 2])
def test_bf16_dh_tile_fragment_maps_over_padded_gates(gate):
    """DhTile<bf16> over the loop's W rows (16 x ld, gate g's columns at g
    Hp, Hp = H padded to 64-wide chunks, ld = 3 Hp + 8): a chunk of a
    16-row gradient operand (zero past H) times W's 16 rows of the
    slice, read as B through plain ldmatrix (b_row, b_col); the tile is
    dg W[j, gate columns]ᵀ exactly, over the u (dh's update half), r
    (its reset half) and candidate (drh) ranges alike."""
    rng = np.random.RandomState(3 + gate)
    H, Hp = 40, 64
    LDA, LD = 72, 3 * Hp + E["bfloat16"]
    dg = rng.randint(-4, 5, (16, H)).astype(np.float64)
    wr = rng.randint(-4, 5, (16, 3 * H)).astype(np.float64)
    a_s = np.zeros(16 * LDA)
    a_s.reshape(-1, LDA)[:, :H] = dg
    w_s = np.zeros(16 * LD)
    for g in range(3):
        w_s.reshape(-1, LD)[:, g * Hp:g * Hp + H] = wr[:, g * H:(g + 1) * H]
    acc = np.zeros((2, 32, 4))
    for ks in range(4):
        af = ldmatrix_x4_b16(a_s, LDA, a_row(LANES),
                             8 * a_col16(LANES) + 16 * ks)
        bf = ldmatrix_x4_b16(w_s, LD, b_row(LANES),
                             gate * Hp + 8 * b_col16(LANES) + 16 * ks)
        acc[0] += mma_m16n8k16_bf16(af, bf[:, 0:2])
        acc[1] += mma_m16n8k16_bf16(af, bf[:, 2:4])
    np.testing.assert_array_equal(c_to_matrix(acc, 2),
                                  dg @ wr[:, gate * H:(gate + 1) * H].T)
    assert LD * 2 % 128 == 16  # the eight rows fall in distinct banks


@pytest.mark.parametrize("tile,ncol", [("gates", 32), ("candidate", 16),
                                       ("dh", 16)])
def test_f32_tile_lanes_own_each_sum_once(tile, ncol):
    """GateTile<float, 32> (lane: rows lr + 4 i, columns 4 lc + q),
    GateTile<float, 16> (rows lr + 4 i, columns 2 lc + q) and DhTile<float>
    (rows lr + 4 i, columns lc + 8 c), lr = lane / 8, lc = lane % 8: every
    (row, column) of the warp's tile has one owner, and the float4 or
    float2 loads a lane makes give it exactly the operands of its sums;
    the W rows (stride 52 floats, the candidate at column 32) keep those
    loads aligned, and the four staged rows (144 bytes apart) and the
    eight W rows of the dh tile (ld = 3 Hp + 4 floats) that one load
    instruction reads fall in distinct banks."""
    rng = np.random.RandomState(4)
    a = rng.randint(-4, 5, (16, 32)).astype(np.float64)
    b = rng.randint(-4, 5, (32, ncol)).astype(np.float64)
    out = np.full((16, ncol), np.nan)
    for lane in range(32):
        lr, lc = lane >> 3, lane & 7
        if tile == "gates":
            cols = [4 * lc + q for q in range(4)]
        elif tile == "candidate":
            cols = [2 * lc + q for q in range(2)]
        else:
            cols = [lc + 8 * c for c in range(2)]
        for r in (lr + 4 * i for i in range(4)):
            for c in cols:
                assert np.isnan(out[r, c])
                out[r, c] = sum(a[r, k] * b[k, c] for k in range(32))
    np.testing.assert_array_equal(out, a @ b)
    LDW, LDA = 48 + E["float32"], KC["float32"] + E["float32"]
    assert LDW * 4 % 16 == 0 and 32 * 4 % 16 == 0

    def banks(word):  # the 4 banks of a 16-byte load at word offset
        return {(word + q) % 32 for q in range(4)}

    for i in range(4):  # lanes lr = 0..3 read rows lr + 4 i of A
        seen = [banks((lr + 4 * i) * LDA) for lr in range(4)]
        assert len(set().union(*seen)) == 16
    for H in (20, 136, 512):
        ld = 3 * -(-H // 32) * 32 + E["float32"]
        for c in range(2):  # lanes lc = 0..7 read W rows lc + 8 c
            seen = [banks((lc + 8 * c) * ld) for lc in range(8)]
            assert len(set().union(*seen)) == 32


if __name__ == "__main__":
    # the emulation's distance (max |error| over max |value|) from the
    # plain versions, by shape, dtype and output
    for shape in sorted(SHAPES):
        for dtype in ("float32", "bfloat16"):
            a = _inputs(shape, dtype, seed=3)
            args = [_t(a[k], dtype) for k in ("x", "h0", "w", "lengths")]
            plain = t_gru.gru_forward_ref(*args)
            plain_g = t_gru.gru_backward_ref(*args, plain[0],
                                             _t(a["dhs"], dtype))
            got = emulate_forward(a, dtype)[:2] + emulate_backward(
                a, _np(plain[0]), dtype)
            names = ("hs", "hT", "dx", "dh0", "dw")
            print(shape, dtype, {n: float(f"{_rel(g, _np(p)):.3g}")
                                 for n, g, p in zip(names, got,
                                                    plain + plain_g)})
