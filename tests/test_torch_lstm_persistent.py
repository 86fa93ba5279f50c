"""The arithmetic of the persistent LSTM kernels K7 and K8
(``paddle_tpu_torch/ops/cuda_kernels/csrc/lstm_persistent.cuh``), on the
CPU.  No kernel runs here (they run only on a card, where
``tests/test_torch_kernels.py -k on_card`` and ``chip_smoke.py`` hold them
to their plain versions); what is checked is what their design rests on:

- (a) the product's operand of step t, round(h_{t-1}) in the weight's
  type, is bit for bit the saved ``hs[:, t-1]`` (``h0`` at t = 0), and the
  operand of the backward's dh product, round(dg_t), is bit for bit
  ``dx[:, t]``: the kernels exchange state through those rows;
- (b) a numpy emulation of the kernels' partition (batch groups of 16
  rows by slices of 16 hidden columns, each block's product split over 8
  warps by 128-byte k chunks, the bf16 products exact and summed in f32 a
  16-deep step at a time, the f32 ones one FMA after another; the
  backward's gate pre-activations from a prologue, its dh carry kept by
  the column's owner; the bf16 dW as h (hi + lo) over 32-row steps) gives
  the plain versions' and the JAX Pallas kernels' results (interpret mode);
- (c) a model of the group barrier (a monotonic counter a group, one
  arrival a block a step) under random block schedules, with a grid row a
  batch group and with grid rows that run several groups in turn: no
  block reads an ``hs`` or ``dx`` row before all of its group's producers
  have published it, none writes a row another block may still read, and
  every schedule finishes;
- (d) the lane maps of the warp products: the bf16 tiles through the
  ldmatrix and mma.sync fragment maps of ``test_torch_flash_mma.py``, the
  f32 tiles' lane ownership, and the dW's split operand.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas_kernels import lstm as jlstm
from paddle_tpu_torch.ops.cuda_kernels import lstm as t_lstm
from test_torch_flash_mma import (G, LANES, TQ, a_col16, a_row, b_col16,
                                  b_row, bt_col16, bt_row, c_to_matrix,
                                  ldmatrix_x4_b16, mma_m16n8k16_bf16)

# the kernels' partition (lstm_persistent.cuh)
ROWS = COLS = 16
WARPS = 8
KC = {"float32": 32, "bfloat16": 64}  # k of a 128-byte staged chunk
DW_STEP_ROWS = 32
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
# (B, T, H, lengths): two batch groups (the second partial) by three
# slices (the last partial), with a row of length 0; the plain tests'
# awkward shape; a width where all 8 warps hold k chunks
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

    return {"x": f(B, T, 4 * H, scale=0.3), "h0": f(B, H, scale=0.2),
            "c0": f(B, H, scale=0.2), "w": f(H, 4 * H, scale=0.1),
            "lengths": np.asarray(lengths, np.int32),
            "dhs": f(B, T, H), "dcs": f(B, T, H)}


def _t(a, dtype):
    t = torch.from_numpy(np.asarray(a))
    return t.to(TORCH_DT[dtype]) if t.is_floating_point() else t


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


# -- (a) the exchange rows are the products' operands, bit for bit ----------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_product_operands_are_the_saved_rows_bit_for_bit(shape, dtype,
                                                         monkeypatch):
    a = _inputs(shape, dtype)
    B, T, H, _ = SHAPES[shape]
    args = [_t(a[k], dtype) for k in ("x", "h0", "c0", "w", "lengths")]
    seen = []
    real_dot = t_lstm._dot

    def recording_dot(x, y):
        seen.append((x.clone(), tuple(y.shape)))
        return real_dot(x, y)

    monkeypatch.setattr(t_lstm, "_dot", recording_dot)
    hs, cs, _, _ = t_lstm.lstm_forward_ref(*args)
    assert len(seen) == T
    for t, (op, _) in enumerate(seen):
        want = args[1] if t == 0 else hs[:, t - 1]
        assert op.dtype == TORCH_DT[dtype]
        assert torch.equal(op, want), t
    seen.clear()
    dx, _, _, _ = t_lstm.lstm_backward_ref(*args, hs, cs,
                                           _t(a["dhs"], dtype),
                                           _t(a["dcs"], dtype))
    gates = [op for op, s in seen if s == (H, 4 * H)]
    dh_ops = [op for op, s in seen if s == (4 * H, H)]
    assert len(gates) == len(dh_ops) == T
    for i, t in enumerate(reversed(range(T))):
        want = args[1] if t == 0 else hs[:, t - 1]
        assert torch.equal(gates[i], want), t
        assert dh_ops[i].dtype == TORCH_DT[dtype]
        assert torch.equal(dh_ops[i], dx[:, t]), t


# -- (b) the kernels' partition, emulated ------------------------------------

def _warp_chunks(K, kc):
    """Warp w's k chunks [s0, s1) of the ceil(K / kc) a step has."""
    n = -(-K // kc)
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
    partial tiles then summed in order in f32 (the kernel's red[])."""
    kc = KC[dtype]
    out = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for s0, s1 in _warp_chunks(a.shape[1], kc):
        out = out + _chain(a, b, s0 * kc, s1 * kc, dtype)
    return out


def _sigmoid(x):
    return np.float32(1) / (np.float32(1) + np.exp(-x))


def _blocks(B, H):
    """(rows, hidden columns, gate columns) of each block of the grid."""
    for b0 in range(0, B, ROWS):
        rows = np.arange(b0, min(b0 + ROWS, B))
        for j0 in range(0, H, COLS):
            js = np.arange(j0, min(j0 + COLS, H))
            yield rows, js, np.concatenate([g * H + js for g in range(4)])


def emulate_forward(a, dtype):
    """K7 block by block: step t's operand is read from hs[:, t-1] (h0 at
    t = 0), the carry stays with the (row, column) owner."""
    x, h0, c0, w = (a[k] for k in ("x", "h0", "c0", "w"))
    B, T, H4 = x.shape
    H = H4 // 4
    hc, cc = h0.copy(), c0.copy()  # the f32 carry of every owner
    hs = np.zeros((B, T, H), np.float32)
    cs = np.zeros_like(hs)
    for t in range(T):
        prev = h0 if t == 0 else hs[:, t - 1]
        for rows, js, cols in _blocks(B, H):
            g = _split_product(prev[rows], w[:, cols], dtype) \
                + x[rows, t][:, cols]
            g = g.reshape(len(rows), 4, len(js))
            i, f = _sigmoid(g[:, 0]), _sigmoid(g[:, 1])
            u, o = np.tanh(g[:, 2]), _sigmoid(g[:, 3])
            live = (t < a["lengths"][rows])[:, None]
            c_new = f * cc[np.ix_(rows, js)] + i * u
            h_new = o * np.tanh(c_new)
            cc[np.ix_(rows, js)] = np.where(live, c_new, cc[np.ix_(rows, js)])
            hc[np.ix_(rows, js)] = np.where(live, h_new, hc[np.ix_(rows, js)])
            hs[np.ix_(rows, [t], js)] = _round(hc[np.ix_(rows, js)],
                                               dtype)[:, None]
            cs[np.ix_(rows, [t], js)] = _round(cc[np.ix_(rows, js)],
                                               dtype)[:, None]
    return hs, cs, _round(hc, dtype), _round(cc, dtype)


def emulate_dw_bf16(prev, dg):
    """The bf16 dW: rows r of h_{t-1} against dg = hi + lo, 32 rows a
    step, each step's products from zero, added to the sums in f32."""
    hi = _round(dg, "bfloat16")
    lo = _round(dg - hi, "bfloat16")
    acc = np.zeros((prev.shape[1], dg.shape[1]), np.float32)
    for r in range(0, prev.shape[0], DW_STEP_ROWS):
        p = prev[r:r + DW_STEP_ROWS].astype(np.float64)
        part = p.T @ hi[r:r + DW_STEP_ROWS] + p.T @ lo[r:r + DW_STEP_ROWS]
        acc = (acc + part.astype(np.float32)).astype(np.float32)
    return _round(acc, "bfloat16")


def emulate_backward(a, hs, cs, dtype):
    """K8 block by block: a prologue of the gate pre-activations of every
    step, then in reverse time the gate gradients of the block's own
    columns (dx = round(dg)), the group's barrier, and the dh product
    over every gate column of dx[:, t] for the block's own columns."""
    x, h0, c0, w = (a[k] for k in ("x", "h0", "c0", "w"))
    B, T, H4 = x.shape
    H = H4 // 4
    prev = np.concatenate([h0[:, None], hs[:, :-1]], 1)
    c_prev = np.concatenate([c0[:, None], cs[:, :-1]], 1)
    pre = np.zeros((B, T, H4), np.float32)
    for rows, js, cols in _blocks(B, H):
        for t in range(T):  # a warp a step, over all of k
            pre[np.ix_(rows, [t], cols)] = (
                _chain(prev[rows, t], w[:, cols], 0, H, dtype)
                + x[rows, t][:, cols])[:, None]
    dh = np.zeros((B, H), np.float32)
    dc = np.zeros_like(dh)
    dg32 = np.zeros((B, T, H4), np.float32)
    dx = np.zeros_like(dg32)
    for t in reversed(range(T)):
        dh_acc = a["dhs"][:, t] + dh
        m = (t < a["lengths"]).astype(np.float32)[:, None]
        for rows, js, cols in _blocks(B, H):
            g = pre[rows, t][:, cols].reshape(len(rows), 4, len(js))
            i, f = _sigmoid(g[:, 0]), _sigmoid(g[:, 1])
            u, o = np.tanh(g[:, 2]), _sigmoid(g[:, 3])
            cp = c_prev[np.ix_(rows, [t], js)][:, 0]
            tc = np.tanh(f * cp + i * u)
            mr = m[rows]
            dc_acc = a["dcs"][np.ix_(rows, [t], js)][:, 0] + dc[np.ix_(rows, js)]
            dh_raw = mr * dh_acc[np.ix_(rows, js)]
            dc_raw = mr * dc_acc + dh_raw * o * (1 - tc * tc)
            dg = np.concatenate([dc_raw * u * i * (1 - i),
                                 dc_raw * cp * f * (1 - f),
                                 dc_raw * i * (1 - u * u),
                                 dh_raw * tc * o * (1 - o)], 1)
            dg32[np.ix_(rows, [t], cols)] = dg[:, None]
            dc[np.ix_(rows, js)] = (1 - mr) * dc_acc + dc_raw * f
        dx[:, t] = _round(dg32[:, t], dtype)
        # the group's barrier: every block has written dx[:, t]
        for rows, js, cols in _blocks(B, H):
            prod = _split_product(dx[rows, t], w[js].T, dtype)
            dh[np.ix_(rows, js)] = (1 - m[rows]) * dh_acc[np.ix_(rows, js)] \
                + prod
    rows_prev = prev.reshape(B * T, H)
    if dtype == "float32":
        dw = (rows_prev.astype(np.float64).T
              @ dg32.reshape(B * T, H4)).astype(np.float32)
    else:
        dw = emulate_dw_bf16(rows_prev, dg32.reshape(B * T, H4))
    return dx, _round(dh, dtype), _round(dc, dtype), dw


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_emulated_partition_matches_plain_and_pallas(shape, dtype):
    a = _inputs(shape, dtype, seed=3)
    args = [_t(a[k], dtype) for k in ("x", "h0", "c0", "w", "lengths")]
    jargs = [jnp.asarray(a[k], JAX_DT[dtype]) for k in ("x", "h0", "c0",
                                                        "w")]
    jlen = jnp.asarray(a["lengths"])
    got = emulate_forward(a, dtype)
    plain = t_lstm.lstm_forward_ref(*args)
    jax_out = jlstm.lstm_forward(*jargs, jlen, interpret=True)
    for name, g, p, j in zip(("hs", "cs", "hT", "cT"), got, plain, jax_out):
        assert _rel(g, _np(p)) <= TOL[dtype], name
        assert _rel(g, np.asarray(j, np.float32)) <= TOL[dtype], name
    # the backward from the plain forward's saved states, as the kernel
    hs, cs = _np(plain[0]), _np(plain[1])
    got_g = emulate_backward(a, hs, cs, dtype)
    plain_g = t_lstm.lstm_backward_ref(*args, plain[0], plain[1],
                                       _t(a["dhs"], dtype),
                                       _t(a["dcs"], dtype))
    jax_g = jlstm.lstm_backward(
        *jargs, jlen, jnp.asarray(hs, JAX_DT[dtype]),
        jnp.asarray(cs, JAX_DT[dtype]), jnp.asarray(a["dhs"], JAX_DT[dtype]),
        jnp.asarray(a["dcs"], JAX_DT[dtype]), interpret=True)
    for name, g, p, j in zip(("dx", "dh0", "dc0", "dw"), got_g, plain_g,
                             jax_g):
        assert _rel(g, _np(p)) <= TOL[dtype], name
        assert _rel(g, np.asarray(j, np.float32)) <= TOL[dtype], name


def test_bf16_dw_split_keeps_f32_accuracy():
    """dg = hi + lo in bf16 keeps dg to 2^-17 of its size, so the split dW
    lies within 2^-15 of the float64 product, far inside the bf16 rounding
    of the result (2^-9); hi alone would not.  (On the card the split dW's
    bf16 result lies as far from float64 as the CUDA-core product's:
    ``tools/time_lstm.py``.)"""
    rng = np.random.RandomState(1)
    prev = _round(rng.randn(96, 24), "bfloat16")
    dg = (rng.randn(96, 48) * np.exp(rng.randn(96, 48))).astype(np.float32)
    hi = _round(dg, "bfloat16")
    lo = _round(dg - hi, "bfloat16")
    assert np.all(np.abs(dg - hi - lo) <= 2.0 ** -16 * np.abs(dg))
    want = prev.astype(np.float64).T @ dg.astype(np.float64)
    split = prev.astype(np.float64).T @ (hi.astype(np.float64) + lo)
    assert _rel(split, want) <= 2.0 ** -15
    assert _rel(prev.astype(np.float64).T @ hi, want) > 1e-4
    assert _rel(emulate_dw_bf16(prev, dg), want) <= 2.0 ** -8


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
    """K7's program order for one block, as the operations that touch a
    group: for each of its batch groups in turn, wait, read hs[:, t-1],
    write hs[:, t], arrive.  `groups`: [(group, its Rows)]."""
    for g, rows in groups:
        for t in range(T):
            if t > 0:
                yield ("wait", g, t)
                rows.read(blk, t - 1, "h")
            rows.write(blk, t, "h")
            yield ("arrive", g)


def backward_block(blk, T, groups, alias):
    """K8's: the prologue's gate pre-activations of all its groups (in dx
    itself when `alias`, the f32 case), then for each group in turn, in
    reverse time, dg into dx[:, t], arrive, wait, read dx[:, t]."""
    if alias:
        for g, rows in groups:
            for t in range(T):
                rows.write(blk, t, "pre")
                yield ("step",)
    for g, rows in groups:
        for t in reversed(range(T)):
            rows.write(blk, t, "dg")
            yield ("arrive", g)
            yield ("wait", g, T - t)
            rows.read(blk, t, "dg")


def run_schedule(programs, slices, rng, early=0):
    """Run the blocks' programs, picking a random runnable block each
    tick; a block waiting for k steps of group g runs once g's counter
    reaches the kernel's target slices * k (less `early`, to break the
    barrier on purpose).  Returns False on a deadlock."""
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
    rows = [Rows(T, slices) for _ in range(groups)]
    programs = []
    for y in range(grid_rows):
        for blk in range(slices):
            mine = [(g, rows[g]) for g in range(y, groups, grid_rows)]
            programs.append(
                forward_block(blk, T, mine) if kind == "forward"
                else backward_block(blk, T, mine, kind == "backward_f32"))
    return programs, rows


# (slices, T, groups, grid rows): path A's 32 column slices a group, one
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


def test_group_barrier_model_catches_an_early_reader():
    """The model has teeth: a barrier that opens one arrival early lets
    some schedule read a row before its last producer published it."""
    rng = random.Random(0)
    caught = False
    for _ in range(200):
        programs, rows = grid_programs("forward", 3, 4, 1, 1)
        assert run_schedule(programs, 4, rng, early=1)
        caught |= any(r.faults for r in rows)
    assert caught


# -- (d) the warp products' lane maps ----------------------------------------

def test_bf16_gate_tile_fragment_maps():
    """GateTile<bf16>: one warp's 16 rows by a 64-column W slice over a
    64-deep staged chunk, lane by lane: A through ldmatrix (a_row,
    a_col), W from its [k][gate column] tile through ldmatrix.trans
    (bt_row, bt_col), two n-tiles an x4; each() names every sum's (row,
    column) once, and the tile is A W exactly."""
    rng = np.random.RandomState(2)
    LDA = LDW = 72
    a = rng.randint(-4, 5, (16, 64)).astype(np.float64)
    wsl = rng.randint(-4, 5, (64, 64)).astype(np.float64)
    a_s, w_s = np.zeros(16 * LDA), np.zeros(64 * LDW)
    a_s.reshape(-1, LDA)[:, :64] = a
    w_s.reshape(-1, LDW)[:, :64] = wsl
    acc = np.zeros((8, 32, 4))
    for ks in range(4):
        af = ldmatrix_x4_b16(a_s, LDA, a_row(LANES),
                             8 * a_col16(LANES) + 16 * ks)
        for p in range(4):
            bf = ldmatrix_x4_b16(w_s, LDW, ks * 16 + bt_row(LANES),
                                 16 * p + 8 * bt_col16(LANES), trans=True)
            acc[2 * p] += mma_m16n8k16_bf16(af, bf[:, 0:2])
            acc[2 * p + 1] += mma_m16n8k16_bf16(af, bf[:, 2:4])
    np.testing.assert_array_equal(c_to_matrix(acc, 8), a @ wsl)
    # each(): (g + 8 (i >> 1), n * 8 + 2 t + (i & 1)) covers the tile once
    seen = np.zeros((16, 64), int)
    for n in range(8):
        for i in range(4):
            seen[G + 8 * (i >> 1), n * 8 + 2 * TQ + (i & 1)] += 1
    assert (seen == 1).all()


def test_bf16_dh_tile_fragment_maps():
    """DhTile<bf16>: 16 rows of round(dg) by W's 16 rows of the slice,
    read as B from the [j][gate column] tile through plain ldmatrix
    (b_row, b_col): the tile is dg W_rowsᵀ exactly."""
    rng = np.random.RandomState(3)
    LDA, LDR = 72, 2 * 64 + 8
    dg = rng.randint(-4, 5, (16, 128)).astype(np.float64)
    wr = rng.randint(-4, 5, (16, 128)).astype(np.float64)
    a_s = np.zeros(16 * LDR)
    a_s.reshape(-1, LDR)[:, :128] = dg
    w_s = np.zeros(16 * LDR)
    w_s.reshape(-1, LDR)[:, :128] = wr
    acc = np.zeros((2, 32, 4))
    for ks in range(8):
        af = ldmatrix_x4_b16(a_s, LDR, a_row(LANES),
                             8 * a_col16(LANES) + 16 * ks)
        bf = ldmatrix_x4_b16(w_s, LDR, b_row(LANES),
                             8 * b_col16(LANES) + 16 * ks)
        acc[0] += mma_m16n8k16_bf16(af, bf[:, 0:2])
        acc[1] += mma_m16n8k16_bf16(af, bf[:, 2:4])
    np.testing.assert_array_equal(c_to_matrix(acc, 2), dg @ wr.T)
    assert LDA * 2 % 128 == 16 and LDR * 2 % 128 == 16  # distinct banks


@pytest.mark.parametrize("tile", ["gates", "dh"])
def test_f32_tile_lanes_own_each_sum_once(tile):
    """GateTile<float, 64> (lane: rows lr + 4 i, columns 4 lc + q and 32 +
    4 lc + q) and DhTile<float> (rows lr + 4 i, columns lc + 8 c), lr =
    lane / 8, lc = lane % 8: every (row, column) of the warp's tile has
    one owner, and the float4 loads a lane makes give it exactly the
    operands of its sums."""
    rng = np.random.RandomState(4)
    ncol = 64 if tile == "gates" else 16
    a = rng.randint(-4, 5, (16, 32)).astype(np.float64)
    b = rng.randint(-4, 5, (32, ncol)).astype(np.float64)
    out = np.full((16, ncol), np.nan)
    for lane in range(32):
        lr, lc = lane >> 3, lane & 7
        rows = [lr + 4 * i for i in range(4)]
        if tile == "gates":
            cols = [4 * lc + q for q in range(4)] + \
                   [32 + 4 * lc + q for q in range(4)]
        else:
            cols = [lc, lc + 8]
        for r in rows:
            for c in cols:
                assert np.isnan(out[r, c])
                out[r, c] = sum(a[r, k] * b[k, c] for k in range(32))
    np.testing.assert_array_equal(out, a @ b)


if __name__ == "__main__":
    # the emulation's distance (max |error| over max |value|) from the
    # plain versions, by shape, dtype and output
    for shape in sorted(SHAPES):
        for dtype in ("float32", "bfloat16"):
            a = _inputs(shape, dtype, seed=3)
            args = [_t(a[k], dtype) for k in ("x", "h0", "c0", "w",
                                              "lengths")]
            plain = t_lstm.lstm_forward_ref(*args)
            plain_g = t_lstm.lstm_backward_ref(*args, plain[0], plain[1],
                                               _t(a["dhs"], dtype),
                                               _t(a["dcs"], dtype))
            got = emulate_forward(a, dtype) + emulate_backward(
                a, _np(plain[0]), _np(plain[1]), dtype)
            names = ("hs", "cs", "hT", "cT", "dx", "dh0", "dc0", "dw")
            print(shape, dtype, {n: float(f"{_rel(g, _np(p)):.3g}")
                                 for n, g, p in zip(names, got,
                                                    plain + plain_g)})
