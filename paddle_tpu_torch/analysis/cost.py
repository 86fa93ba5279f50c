"""Static FLOPs / roofline cost model over Program descs — the port of
``paddle_tpu/analysis/cost.py``.

Rolls per-op FLOPs and memory-byte estimates into a roofline report:
total FLOPs, memory traffic, arithmetic intensity, and a predicted step
time for a given chip spec — the analytic prior the replica router
places requests by (``serving/router.py``) and a tuner would rank
candidates with.

Per-op metadata comes from the op registry: an op module registers an
analytic formula beside its emitter (`register_cost` — matmul, conv,
attention, the paged serving ops, lstm, gru, lookup_table, the generic
grad), and everything else gets the shape-driven default — one FLOP per
output element and bytes = inputs read + outputs written.  The byte
model gives NO fusion credit, so it is an upper bound on memory
traffic.

Predicted step time is the roofline ceiling
    t = max(t_compute, t_memory),  t_compute = Σ flops_d / peak_d,
    t_memory = bytes / bw
i.e. perfect overlap at peak throughput — a lower bound on real step
time.

The chip table is the port's own: ``h100-sxm`` (the card the port runs
on) and ``cpu-host`` (a placeholder the CPU tests share with the JAX
package, so both packages predict alike under one spec).  With
measured correction factors in the calibration store
(``observability/calibration.py``) for the chip, `program_cost` adds
``calibrated_step_time_s`` beside the raw roofline.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

from ..ops.registry import ShapeDtype, has_op, get_op_info
from . import memory as _mem

# Per-chip peaks: dense bf16 FLOP/s, memory GB/s and GiB.
# h100-sxm: NVIDIA's H100 SXM5 data sheet, dense (no sparsity), for the
# NVIDIA H100 80GB HBM3 at its 700 W limit: 989 TFLOP/s bf16/fp16,
# 495 TFLOP/s TF32, 67 TFLOP/s fp32 and fp64 (tensor cores), 3.35 TB/s
# of HBM3, 80 GB; links for the sharding analyzer's comm pricing
# (analysis/sharding.py): NVLink 4 at 900 GB/s both directions, so 450
# GB/s one way, as the one-way ICI rate; one ConnectX-7 NDR port (400
# Gb/s, 50 GB/s) a GPU across nodes as the DCN rate.  cpu-host: the JAX
# package's placeholder for CPU runs of the same programs (plumbing
# tests, not evidence), links included.
CHIP_SPECS: Dict[str, dict] = {
    "h100-sxm": {"flops_bf16": 989e12, "hbm_gbps": 3350.0,
                 "hbm_gib": 80e9 / 2**30,
                 "ici_gbps": 450.0, "dcn_gbps": 50.0,
                 # relative to bf16.  The port's f32 bodies (flash, paged
                 # multi-query, fused BatchNorm) run 3xTF32: three TF32
                 # products per f32 product, so f32 is priced at a third
                 # of the TF32 rate; f64 at the tensor cores' fp64 rate
                 "dtype_rate": {"bfloat16": 1.0, "float16": 1.0,
                                "float32": 495e12 / 3 / 989e12,
                                "float64": 67e12 / 989e12}},
    "cpu-host": {"flops_bf16": 0.2e12, "hbm_gbps": 40.0, "hbm_gib": 16,
                 "ici_gbps": 10.0, "dcn_gbps": 1.0,
                 # the JAX package's rates relative to bf16
                 "dtype_rate": {"bfloat16": 1.0, "float16": 1.0,
                                "float32": 0.5, "float64": 0.0625}},
}

# Per-DISPATCH host overhead floor (seconds): what one Executor.run pays
# beyond the device step itself.  h100-sxm: a replayed one-op step plus
# its fetch sync, measured by chip_smoke.py's dispatch_overhead_s on an
# NVIDIA H100 80GB HBM3 at 700 W: 120.3, 83.6 and 126.1 µs in three
# runs, the floor taken (PERF.md); cpu-host: the JAX package's
# placeholder.
DEFAULT_DISPATCH_OVERHEAD_S: Dict[str, float] = {
    "h100-sxm": 8.36e-5,
    "cpu-host": 1.5e-4,
}


def chip_spec(name: Optional[str] = None) -> dict:
    """Spec by name, defaulting to $PADDLE_TPU_CHIP then h100-sxm."""
    name = name or os.environ.get("PADDLE_TPU_CHIP", "h100-sxm")
    if name not in CHIP_SPECS:
        raise ValueError(
            f"unknown chip {name!r} (have: {sorted(CHIP_SPECS)})")
    return {"chip": name, **CHIP_SPECS[name]}


def detect_chip(default: str = "h100-sxm") -> str:
    """Map the CUDA card's name onto a spec name: "cpu-host" without a
    card, `default` for a card the table does not know."""
    import torch

    if not torch.cuda.is_available():
        return "cpu-host"
    if "H100" in torch.cuda.get_device_name(0):
        return "h100-sxm"
    return default


def dtype_rate(spec: dict, dtype: str) -> float:
    """`dtype`'s FLOP rate relative to bf16 on `spec`'s chip."""
    return spec["dtype_rate"][dtype]


# ---------------------------------------------------------------------------
# per-op shapes and cost

_FREE_TYPES = ("feed", "fetch", "reshape", "squeeze", "unsqueeze",
               "shape", "lod_reset")


def _shape_dtype(block, name, batch_size):
    if not name:
        return None
    v = block._find_var_recursive(name)
    if v is None or v.shape is None:
        return None
    return ShapeDtype(_mem.bind_shape(v.shape, batch_size),
                      v.dtype or "float32")


def _op_shapes(block, op, batch_size):
    ins = {s: [_shape_dtype(block, n, batch_size) for n in names]
           for s, names in op.inputs.items()}
    outs = {s: [_shape_dtype(block, n, batch_size) for n in names]
            for s, names in op.outputs.items()}
    return ins, outs


def op_cost(block, op, batch_size: int = 64) -> dict:
    """{"flops", "bytes", "collective_bytes", "dtype", "modeled"} for one
    op.  `modeled` False means shapes were missing and the op contributed
    nothing (callers surface the count — silent holes would make a
    too-cheap program look fast)."""
    if op.type in _FREE_TYPES:
        return {"flops": 0, "bytes": 0, "collective_bytes": 0,
                "dtype": None, "modeled": True}
    ins, outs = _op_shapes(block, op, batch_size)

    # generic byte model: every distinct input read once + outputs written
    read = 0
    seen = set()
    for slot, names in op.inputs.items():
        for n, sd in zip(names, ins[slot]):
            if n and n not in seen and sd is not None:
                seen.add(n)
                read += sd.size * _mem.dtype_bytes(sd.dtype)
    written = 0
    out_elems = 0
    dtype = None
    known_out = False
    for slot, names in op.outputs.items():
        for n, sd in zip(names, outs[slot]):
            if n and sd is not None:
                known_out = True
                written += sd.size * _mem.dtype_bytes(sd.dtype)
                out_elems += sd.size
                if dtype is None and str(sd.dtype).startswith(
                        ("float", "bfloat")):
                    dtype = sd.dtype
    if dtype is None:
        for slot in ins.values():
            for sd in slot:
                if sd is not None and str(sd.dtype).startswith(
                        ("float", "bfloat")):
                    dtype = sd.dtype
                    break

    flops = out_elems
    bytes_ = read + written
    collective = 0
    modeled = known_out or not op.output_names()
    info = get_op_info(op.type) if has_op(op.type) else None
    if info is not None and info.cost is not None:
        try:
            got = info.cost(ins, outs, op.attrs) or {}
        except (TypeError, ValueError, IndexError, KeyError,
                AttributeError):
            got = {}
        if "flops" in got:
            flops = int(got["flops"])
            modeled = True
        if "bytes" in got:
            bytes_ = int(got["bytes"])
        if "collective_bytes" in got:
            collective = int(got["collective_bytes"])
    return {"flops": int(flops), "bytes": int(bytes_),
            "collective_bytes": int(collective), "dtype": dtype,
            "modeled": bool(modeled)}


# ---------------------------------------------------------------------------
# program roll-up


def _calibration_factors(chip: str, calibration) -> dict:
    """The chip's stored correction factors, or {} when the calibrated
    layer is off (False, or None with $PADDLE_TPU_CALIBRATION=0) or
    nothing has been learned yet.  `calibration` may also be a
    ``CalibrationStore``, read instead of the default one."""
    if calibration is False:
        return {}
    from ..observability import calibration as _calib

    if calibration is None or calibration is True:
        if calibration is None and not _calib.calibration_enabled():
            return {}
        return _calib.default_store().factors(chip)
    return calibration.factors(chip)


def program_cost(program, batch_size: int = 64, block_id: int = 0,
                 chip: Optional[str] = None, calibration=None) -> dict:
    """Roofline report for one block: totals, a per-op-type table (by
    FLOPs, descending), arithmetic intensity, and the predicted step
    time/MFU ceiling for `chip` (see module docstring for the model).

    `calibration`: None defers to $PADDLE_TPU_CALIBRATION (default on),
    True reads the default store regardless, False is the raw model
    alone, and a ``CalibrationStore`` is read in place of the default.
    When factors exist for this chip the report ADDS
    ``calibrated_step_time_s`` (per-op roofline times priced through the
    measured per-(op type, dtype) affine corrections — ``factor * t_op +
    overhead_s`` — summed) beside the raw model; the raw keys never
    change."""
    block = program.blocks[block_id]
    spec = chip_spec(chip)
    peak = spec["flops_bf16"]
    bw = spec["hbm_gbps"] * 1e9
    factors = _calibration_factors(spec["chip"], calibration)
    by_type: Dict[str, dict] = {}
    flops_by_dtype: Dict[str, int] = {}
    tot_flops = tot_bytes = tot_coll = 0
    per_op_time = cal_time = overhead_total = 0.0
    applied = 0
    unmodeled = 0
    for op in block.ops:
        c = op_cost(block, op, batch_size)
        if not c["modeled"]:
            unmodeled += 1
        e = by_type.setdefault(op.type,
                               {"count": 0, "flops": 0, "bytes": 0})
        e["count"] += 1
        e["flops"] += c["flops"]
        e["bytes"] += c["bytes"]
        tot_flops += c["flops"]
        tot_bytes += c["bytes"]
        tot_coll += c["collective_bytes"]
        dt = c["dtype"] or "float32"
        flops_by_dtype[dt] = flops_by_dtype.get(dt, 0) + c["flops"]
        # per-op roofline time (max of the op's own compute/memory
        # legs): Σ over ops is the no-overlap-across-ops variant the
        # calibration factors scale; the headline below keeps the
        # perfect-overlap max-of-sums model
        rate = peak * dtype_rate(spec, dt)
        t_op = max(c["flops"] / rate if rate else 0.0,
                   c["bytes"] / bw if bw else 0.0)
        per_op_time += t_op
        if factors:
            from ..observability import calibration as _calib

            ent = factors.get(_calib.factor_key(op.type, dt))
            if ent:
                # affine: the fitted overhead_s charges the per-op
                # dispatch floor a ratio cannot see (calibration.py)
                overhead_total += float(ent.get("overhead_s") or 0.0)
                cal_time += (float(ent["factor"]) * t_op
                             + float(ent.get("overhead_s") or 0.0))
                applied += 1
            else:
                cal_time += t_op

    t_compute = sum(f / (peak * dtype_rate(spec, dt))
                    for dt, f in flops_by_dtype.items() if f)
    t_memory = tot_bytes / bw if bw else 0.0
    step = max(t_compute, t_memory)
    report = {
        "batch_size": int(batch_size),
        "block_id": int(block_id),
        "chip": spec["chip"],
        "total_flops": int(tot_flops),
        "hbm_bytes": int(tot_bytes),
        "collective_bytes": int(tot_coll),
        "arithmetic_intensity": (tot_flops / tot_bytes) if tot_bytes else 0.0,
        "machine_balance": peak / bw if bw else 0.0,
        "flops_by_dtype": flops_by_dtype,
        "predicted_step_time_s": step,
        "predicted_bound": ("compute" if t_compute >= t_memory
                            else "memory"),
        "compute_time_s": t_compute,
        "memory_time_s": t_memory,
        # MFU the roofline permits at this intensity (1.0 when
        # compute-bound): measured_mfu / this ratio = tuner headroom
        "mfu_ceiling": (t_compute / step) if step else 0.0,
        "unmodeled_ops": int(unmodeled),
        "per_op_time_s": per_op_time,
        "by_type": dict(sorted(by_type.items(),
                               key=lambda kv: -kv[1]["flops"])),
    }
    if factors and applied:
        report["calibrated_step_time_s"] = cal_time
        report["calibration"] = {"chip": spec["chip"],
                                 "factors_applied": int(applied),
                                 "factors_known": len(factors),
                                 # the per-dispatch share of the affine
                                 # fits: what one fused K-step loop pays
                                 # ONCE instead of K times (step_loop_cost)
                                 "overhead_s_total": overhead_total}
    return report


def roofline_with_comm(report: dict, comm: dict,
                       devices: int = 1) -> dict:
    """Fold a communication report (`analysis.sharding.comm_report`)
    into a `program_cost` roofline: predicted step time becomes
    max(compute, HBM, comm) and the bound may now be "comm".  Returns a
    NEW dict (the pure-compute report stays valid for single-chip
    consumers).

    `program_cost` is sharding-unaware (whole batch on one device)
    while the comm report's times are per-device — pass `devices` (the
    mesh size) to put compute/memory on the same per-device footing
    (perfect-split assumption, i.e. the roofline stays a lower bound).
    ``analysis.sharding.comm_report`` produces one; the router folds
    one in when given it."""
    devices = max(int(devices), 1)
    out = dict(report)
    t_compute = report["compute_time_s"] / devices
    t_memory = report["memory_time_s"] / devices
    t_comm = float(comm.get("comm_time_s", 0.0))
    step = max(t_compute, t_memory, t_comm)
    bounds = [("compute", t_compute), ("memory", t_memory),
              ("comm", t_comm)]
    out["devices"] = devices
    out["compute_time_s"] = t_compute
    out["memory_time_s"] = t_memory
    out["comm_time_s"] = t_comm
    out["collective_bytes"] = int(report.get("collective_bytes", 0)
                                  or comm.get("collective_bytes", 0))
    out["predicted_step_time_s"] = step
    out["predicted_bound"] = max(bounds, key=lambda kv: kv[1])[0]
    out["mfu_ceiling"] = (t_compute / step) if step else 0.0
    out["comm_per_kind"] = comm.get("per_kind", {})
    return out


def step_loop_cost(program, k: int, batch_size: int = 64,
                   block_id: int = 0, chip: Optional[str] = None,
                   calibration=None,
                   overhead_s: Optional[float] = None) -> dict:
    """Price a fused K-step dispatch (framework/step_loop.py) against K
    sequential dispatches of the same program:

        fused      = K * step + 1 * overhead_s
        sequential = K * (step + overhead_s)

    `step` is the pure device step (`program_cost`, `calibration` as
    there: calibrated when the store has factors for this chip, with the
    affine intercepts REMOVED, since they are the per-dispatch share
    being amortized); `overhead_s` is the per-dispatch host floor
    (explicit arg > calibration intercept sum >
    DEFAULT_DISPATCH_OVERHEAD_S for the chip).  The predicted speedup
    `sequential / fused` is the rankable quantity a K sweep is held
    against."""
    if int(k) < 1:
        raise ValueError(f"steps_per_dispatch k={k} must be >= 1")
    k = int(k)
    rep = program_cost(program, batch_size, block_id, chip, calibration)
    cal = rep.get("calibration") or {}
    if overhead_s is None:
        overhead_s = cal.get("overhead_s_total")
    if not overhead_s:
        overhead_s = DEFAULT_DISPATCH_OVERHEAD_S[rep["chip"]]
    overhead_s = float(overhead_s)
    if "calibrated_step_time_s" in rep:
        step = max(rep["calibrated_step_time_s"]
                   - float(cal.get("overhead_s_total") or 0.0), 0.0)
        step_source = "calibrated"
    else:
        step = rep["predicted_step_time_s"]
        step_source = "roofline"
    fused = k * step + overhead_s
    sequential = k * (step + overhead_s)
    return {
        "analysis": "step_loop_cost",
        "chip": rep["chip"],
        "batch_size": int(batch_size),
        "k": k,
        "step_time_s": step,
        "step_source": step_source,
        "overhead_s": overhead_s,
        "fused_time_s": fused,
        "sequential_time_s": sequential,
        "predicted_speedup": (sequential / fused) if fused else 1.0,
        "steps_per_s_fused": (k / fused) if fused else 0.0,
        "steps_per_s_sequential": (k / sequential) if sequential else 0.0,
        # overhead left per step after amortization — the diminishing
        # return that caps useful K
        "amortized_overhead_s": overhead_s / k,
    }


def render(report: dict, top: int = 8) -> str:
    def eng(x, unit):
        for scale, pre in ((1e12, "T"), (1e9, "G"), (1e6, "M"), (1e3, "k")):
            if x >= scale:
                return f"{x / scale:.2f} {pre}{unit}"
        return f"{x:.0f} {unit}"

    r = report
    lines = [
        f"roofline (static, batch={r['batch_size']}, chip={r['chip']})",
        f"  FLOPs              {eng(r['total_flops'], 'FLOP')}",
        f"  HBM traffic        {eng(r['hbm_bytes'], 'B')} (upper bound,"
        f" no fusion credit)",
        f"  arithmetic intens. {r['arithmetic_intensity']:.1f} FLOP/B"
        f" (machine balance {r['machine_balance']:.1f})",
        f"  predicted step     {r['predicted_step_time_s'] * 1e3:.3f} ms"
        f" ({r['predicted_bound']}-bound,"
        f" MFU ceiling {r['mfu_ceiling'] * 100:.0f}%)",
    ]
    if r["collective_bytes"]:
        lines.append(f"  collective traffic {eng(r['collective_bytes'], 'B')}")
    if r["unmodeled_ops"]:
        lines.append(f"  WARNING: {r['unmodeled_ops']} op(s) without "
                     f"static shapes contributed nothing")
    lines.append("  top op types by FLOPs:")
    for t, e in list(r["by_type"].items())[:top]:
        if not e["flops"]:
            break
        lines.append(f"    {t:<28} x{e['count']:<4} "
                     f"{eng(e['flops'], 'FLOP'):>12}  "
                     f"{eng(e['bytes'], 'B'):>10}")
    return "\n".join(lines)
