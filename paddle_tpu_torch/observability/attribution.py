"""Per-op device-time attribution: profile -> ProgramDesc — the port of
``paddle_tpu/observability/attribution.py``.

Three pieces, one table:

  * **identity threading** — :func:`op_scope` is the package's one mint
    of per-op profiler ranges.  The executor runs each op inside
    ``record_function("pdop__<type>__u<uid>")`` when attribution is on,
    so every kernel a profile records traces back to the desc op whose
    range launched it.  Off by default: then the scope is a shared no-op
    context and the walk pays one attribute check per op.
  * **capture** — :func:`capture_profile` runs steps under
    ``torch.profiler`` and sums, per op range, the device time of the
    kernels (and copies and sets) launched inside it.  On the card a
    trace with no op-named device time raises: there is no fall-back to
    the host oracle, which would hide the device.  Device time launched
    outside every op's range is kept as the table's unattributed row.
    :func:`attribute_cpu` is the segment-timed walk: it runs the block
    one op at a time in :func:`schedule` order and times each op — with
    CUDA events on the card (device time on the stream), with the host
    clock on the CPU (wall time, as the JAX package's oracle does).
  * **join** — both paths produce the same per-op table: measured time
    joined against ``analysis/cost.py``'s per-op FLOPs/bytes prediction
    for the chip (``h100-sxm`` on the card, ``cpu-host`` on the CPU),
    published as ``op_pred_vs_measured{op_type=...}`` /
    ``op_measured_time_share`` gauges and a bench-schema artifact row.
    The table is also what feeds the calibration store
    (``observability/calibration.py``).
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import re
from statistics import median
from typing import Dict, List, Optional

from .metrics import REGISTRY, artifact_metric, monotime

# ---------------------------------------------------------------------------
# identity threading: the one per-op range mint

_ENV_FLAG = "PADDLE_TPU_OP_ATTRIBUTION"
_SCOPE_FMT = "pdop__{type}__u{uid}"
_SCOPE_RE = re.compile(r"pdop__([A-Za-z0-9_]+)__u(\d+)")

# the row device time launched outside every op's range goes to
UNATTRIBUTED = "(unattributed)"

# None -> defer to the env gate; True/False -> explicit enable()/disable()
_override: Optional[bool] = None

# one shared no-op context for the disabled path (reentrant + reusable)
_NOOP_SCOPE = contextlib.nullcontext()

# gauge handles resolved once (families survive REGISTRY.reset())
_G_PVM = REGISTRY.gauge(
    "op_pred_vs_measured",
    "per-op-type predicted/measured time ratio from the attribution "
    "table (1.0 = the static model prices this op type perfectly)")
_G_SHARE = REGISTRY.gauge(
    "op_measured_time_share",
    "per-op-type share of measured step time from the attribution table")
_G_COVERAGE = REGISTRY.gauge(
    "op_attribution_coverage",
    "fraction of measured step time attributed to named desc ops")


def enabled() -> bool:
    """Is op-identity threading on?  Explicit enable()/disable() wins;
    otherwise the $PADDLE_TPU_OP_ATTRIBUTION gate (default off)."""
    if _override is not None:
        return _override
    return os.environ.get(_ENV_FLAG, "0") not in ("", "0", "false")


def enable():
    global _override
    _override = True


def disable():
    global _override
    _override = False


def reset():
    """Back to the env-gated default (the ``reset()`` hook)."""
    global _override
    _override = None


def scope_name(op) -> str:
    """The per-op range name: type + desc uid (core.py's per-program
    monotonic ``__uid__``)."""
    return _SCOPE_FMT.format(type=op.type,
                             uid=int(op.attrs.get("__uid__", 0)))


def op_scope(op):
    """Context manager wrapping one op's run in a ``torch.profiler``
    range carrying its desc identity.  A shared no-op when attribution
    is off, so the executor calls it unconditionally."""
    if not enabled():
        return _NOOP_SCOPE
    from torch.profiler import record_function

    return record_function(scope_name(op))


def parse_scope(text: str):
    """(op_type, uid) from any string carrying a scope name, else None.
    Greedy type match + the terminal ``__u<digits>`` keeps op types with
    underscores (elementwise_add) unambiguous."""
    m = _SCOPE_RE.search(text or "")
    if not m:
        return None
    return m.group(1), int(m.group(2))


# ---------------------------------------------------------------------------
# the schedule: hazard-respecting topological order from the dataflow pass


def schedule(block) -> List[int]:
    """Deterministic topological order over the block's ops that the
    segment walk times one op at a time.

    Edges: RAW from ``dataflow.dependency_graph`` plus, per name, every
    earlier textual access (read or write) before a later write — the
    orderings the executor's textual order guarantees, the
    scope-read-then-optimizer-write training idiom included.  Ties break
    on lowest op index, so the schedule is reproducible run to run."""
    import heapq

    from ..analysis import dataflow as _df

    n = len(block.ops)
    preds = _df.dependency_graph(block)
    succ: List[set] = [set() for _ in range(n)]
    indeg = [0] * n

    def edge(i, j):
        if i != j and j not in succ[i]:
            succ[i].add(j)
            indeg[j] += 1

    for j, ps in enumerate(preds):
        for i in ps:
            edge(i, j)
    defs, uses = _df.def_use(block)
    for name, dlist in defs.items():
        accesses = sorted(set(dlist) | set(uses.get(name, [])))
        for j in dlist:
            for i in accesses:
                if i < j:
                    edge(i, j)
    heap = [i for i in range(n) if indeg[i] == 0]
    heapq.heapify(heap)
    out: List[int] = []
    while heap:
        i = heapq.heappop(heap)
        out.append(i)
        for j in sorted(succ[i]):
            indeg[j] -= 1
            if indeg[j] == 0:
                heapq.heappush(heap, j)
    if len(out) != n:  # unreachable (textual order is acyclic); be safe
        return list(range(n))
    return out


# ---------------------------------------------------------------------------
# the segment walk


_NOOP_TYPES = ("feed", "fetch")


def _seed_state(block, feeds, scope):
    """State values for every name the block reads or updates, from
    `scope` (the global scope by default)."""
    from ..analysis.dataflow import state_classes
    from ..framework.scope import global_scope

    scope = scope if scope is not None else global_scope()
    ext, rw, _ = state_classes(block, list(feeds))
    state = {}
    for name in list(ext) + list(rw):
        v = scope.find(name)
        if v is None:
            raise RuntimeError(
                f"attribution: variable {name!r} not initialized in "
                f"scope — run the startup program first")
        state[name] = v
    return state


def attribute_cpu(program, feed, *, scope=None, state=None, block_id=0,
                  repeats=3, batch_size=64, chip=None, rng_seed=0,
                  place=None) -> dict:
    """The segment-timed walk: run every op of the block (no dead-op
    pruning), one at a time in :func:`schedule` order, `repeats` times
    over copies of the same start state, and take each op's median.

    On a CUDA place each op is bracketed by CUDA events and the table's
    `mode` is ``"cuda-events"``: device time on the stream between the
    op's first and last launch, host gaps the stream waited through
    included (the walk queues ahead of the card wherever ops are large).
    On a CPU place the host clock times each op (``"cpu-oracle"``, per-op
    dispatch overhead included by design, as in the JAX package).
    `place=None` is the card (``default_place()``)."""
    import torch

    from ..framework.executor import Executor
    from ..framework.place import default_place
    from ..ops.registry import EmitContext

    place = place if place is not None else default_place()
    exe = Executor(place)
    dev = exe.device
    on_card = dev.type == "cuda"
    block = program.blocks[block_id]
    if state is None:
        state = _seed_state(block, feed, scope)
    base_env = {}
    for n, v in feed.items():
        base_env.update(exe._feed_tensor(block, n, v))
    for n, v in state.items():
        t = v if isinstance(v, torch.Tensor) else torch.as_tensor(v)
        base_env[n] = t.to(dev)
    is_test = not any(op.type.endswith("_grad") for op in block.ops)
    order = [i for i in schedule(block)
             if block.ops[i].type not in _NOOP_TYPES]
    n_ops = len(block.ops)
    per_op: List[List[float]] = [[] for _ in range(n_ops)]
    walls: List[float] = []
    for _ in range(max(1, int(repeats))):
        # ops may update their inputs in place: every walk starts from
        # its own copy, and the caller's scope is never touched
        env = {n: t.clone() for n, t in base_env.items()}
        ctx = EmitContext(dev, is_test=is_test, program=program,
                          step=int(rng_seed), constants=exe._constants)
        ctx.lower_block = lambda idx, sub_env, _ctx=ctx: \
            exe._lower_block(_ctx, idx, sub_env)
        with torch.no_grad():
            if on_card:
                torch.cuda.synchronize(dev)
                marks = []
                w0 = torch.cuda.Event(enable_timing=True)
                w0.record()
                for i in order:
                    e0 = torch.cuda.Event(enable_timing=True)
                    e1 = torch.cuda.Event(enable_timing=True)
                    e0.record()
                    exe._run_op(block.ops[i], env, ctx)
                    e1.record()
                    marks.append((i, e0, e1))
                w1 = torch.cuda.Event(enable_timing=True)
                w1.record()
                torch.cuda.synchronize(dev)
                for i, e0, e1 in marks:
                    per_op[i].append(e0.elapsed_time(e1) * 1e-3)
                walls.append(w0.elapsed_time(w1) * 1e-3)
            else:
                t_wall = monotime()
                for i in order:
                    t0 = monotime()
                    exe._run_op(block.ops[i], env, ctx)
                    per_op[i].append(monotime() - t0)
                walls.append(monotime() - t_wall)
    exe.close()
    measured = [median(ts) if ts else None for ts in per_op]
    return build_table(block, measured, median(walls),
                       batch_size=batch_size, chip=chip,
                       mode="cuda-events" if on_card else "cpu-oracle",
                       repeats=int(repeats))


# ---------------------------------------------------------------------------
# profiler capture path

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def capture_profile(step_fn, out_dir, steps=3, place=None) -> dict:
    """Run ``step_fn(i)`` for `steps` iterations under ``torch.profiler``
    with op-identity threading forced on, write the Chrome trace into
    `out_dir`, and sum it back into per-op times.

    On the card (`place` a CUDA place, or None with a card present) each
    op's time is the device time of the kernels, copies and sets its
    range launched; a launch inside no op's range counts as
    unattributed.  A trace with no op-named device time raises — the
    device path never falls back to the host oracle.  On a CPU place
    each op's time is its range's wall time.

    Returns ``{"trace_dir", "trace_file", "mode", "by_scope",
    "kernels_by_scope", "device_total_s", "unattributed_s",
    "unattributed_kernels", "steps"}`` with ``by_scope`` {(op_type, uid):
    seconds over all the steps}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    on_card = (place.device.type == "cuda" if place is not None
               else torch.cuda.is_available())
    os.makedirs(out_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if on_card:
        acts.append(ProfilerActivity.CUDA)
    prev = _override
    enable()
    try:
        with profile(activities=acts) as prof:
            for i in range(max(1, int(steps))):
                step_fn(i)
            if on_card:
                torch.cuda.synchronize()
    finally:
        globals()["_override"] = prev
    trace_file = os.path.join(out_dir, "trace.json")
    prof.export_chrome_trace(trace_file)
    with open(trace_file) as f:
        events = json.load(f).get("traceEvents") or []
    parsed = parse_trace_events(events, device=on_card)
    if on_card and not any(parsed["by_scope"].values()):
        raise RuntimeError(
            f"capture_profile: the trace {trace_file} holds "
            f"{parsed['device_total_s'] * 1e3:.3f} ms of device time and "
            f"none of it inside an op's range — the profiler saw no "
            f"kernels (another CUPTI user?) or the executor opened no "
            f"op ranges")
    return {"trace_dir": out_dir, "trace_file": trace_file,
            "mode": "profile" if on_card else "profile-cpu",
            "steps": max(1, int(steps)), **parsed}


def _outer_ranges(events):
    """[(start_us, end_us, (op_type, uid))] of the outermost op ranges
    (host-side annotations), sorted by start: a nested block's op ranges
    fall inside their control-flow op's and are attributed to it."""
    rngs = []
    for e in events:
        if not isinstance(e, dict) or e.get("ph") != "X":
            continue
        if str(e.get("cat", "")).startswith("gpu"):
            continue  # the device-side copy of an annotation
        hit = parse_scope(str(e.get("name", "")))
        if hit is None:
            continue
        ts = float(e.get("ts", 0.0))
        rngs.append((ts, ts + float(e.get("dur", 0.0)), hit))
    rngs.sort(key=lambda r: (r[0], -r[1]))
    outer = []
    for r in rngs:
        if outer and r[0] >= outer[-1][0] and r[1] <= outer[-1][1]:
            continue
        outer.append(r)
    return outer


def parse_trace_events(events, device: bool = True) -> dict:
    """Sum a ``torch.profiler`` Chrome trace's events into per-op times
    (see :func:`capture_profile`).  A device event is matched to its
    launch through the trace's ``correlation`` id (else to the host event
    its ``External id`` names) and attributed to the op range whose
    interval holds the launch — on whichever thread the launch ran
    (autograd's device thread runs a backward's launches while the
    walking thread waits inside the grad op's range)."""
    outer = _outer_ranges(events)
    starts = [r[0] for r in outer]
    by_scope: Dict[tuple, float] = {r[2]: 0.0 for r in outer}
    kernels: Dict[tuple, Dict[str, float]] = {}
    unattributed: Dict[str, float] = {}
    total = 0.0
    if not device:
        for s, e, hit in outer:
            by_scope[hit] += (e - s) * 1e-6
        return {"by_scope": by_scope, "kernels_by_scope": {},
                "device_total_s": 0.0, "unattributed_s": 0.0,
                "unattributed_kernels": {}}
    launch_ts: Dict[int, float] = {}
    # a device event with no traced launch falls back to the host event
    # its "External id" names (the op or range that issued it)
    external_ts: Dict[int, float] = {}
    for e in events:
        if not isinstance(e, dict) or not isinstance(e.get("args"), dict):
            continue
        args = e["args"]
        if e.get("cat") in _LAUNCH_CATS and "correlation" in args:
            launch_ts[int(args["correlation"])] = float(e["ts"])
        elif (e.get("ph") == "X" and "External id" in args
              and e.get("cat") not in _DEVICE_CATS
              and not str(e.get("cat", "")).startswith("gpu")):
            external_ts.setdefault(int(args["External id"]),
                                   float(e["ts"]))
    for e in events:
        if not isinstance(e, dict) or e.get("cat") not in _DEVICE_CATS \
                or e.get("ph") != "X":
            continue
        secs = float(e.get("dur", 0.0)) * 1e-6
        total += secs
        name = str(e.get("name", ""))
        args = e.get("args") or {}
        corr = args.get("correlation")
        ts = launch_ts.get(int(corr)) if corr is not None else None
        if ts is None and "External id" in args:
            ts = external_ts.get(int(args["External id"]))
        hit = None
        if ts is not None:
            k = bisect.bisect_right(starts, ts) - 1
            if k >= 0 and outer[k][0] <= ts <= outer[k][1]:
                hit = outer[k][2]
        if hit is None:
            unattributed[name] = unattributed.get(name, 0.0) + secs
            continue
        by_scope[hit] += secs
        per = kernels.setdefault(hit, {})
        per[name] = per.get(name, 0.0) + secs
    return {"by_scope": by_scope, "kernels_by_scope": kernels,
            "device_total_s": total,
            "unattributed_s": sum(unattributed.values()),
            "unattributed_kernels": unattributed}


def table_from_scopes(block, by_scope, *, batch_size=64, chip=None,
                      unattributed_s=0.0, mode="profile") -> dict:
    """The profile path's half of "both produce the same table": map
    per-scope durations back onto desc op indices via (op type, uid) and
    join predictions exactly like the segment walk.  The type is part of
    the key because a grad op carries its forward op's uid (the JAX
    package keys by uid alone and folds the two into one row).
    `unattributed_s` becomes the table's unattributed row."""
    by_key = {(op.type, int(op.attrs.get("__uid__", -1))): i
              for i, op in enumerate(block.ops)}
    measured: List[Optional[float]] = [None] * len(block.ops)
    for key, secs in (by_scope or {}).items():
        i = by_key.get(key)
        if i is not None:
            measured[i] = (measured[i] or 0.0) + secs
    total = (sum(m for m in measured if m) or 0.0) + float(unattributed_s)
    return build_table(block, measured, total, batch_size=batch_size,
                       chip=chip, mode=mode, unattributed_s=unattributed_s)


# ---------------------------------------------------------------------------
# the join: measured segments x static per-op cost


def build_table(block, measured, total_s, *, batch_size=64, chip=None,
                mode="cpu-oracle", unattributed_s=0.0, **meta) -> dict:
    """Join measured per-op seconds (index-aligned with block.ops; None
    = no measurement) against ``cost.op_cost`` predictions into the
    canonical attribution table both capture paths return.  A positive
    `unattributed_s` is appended as a row of its own (index -1, op type
    ``UNATTRIBUTED``), counted in ``total_s`` and never in ``by_type``."""
    from ..analysis import cost as _cost

    spec = _cost.chip_spec(chip or _cost.detect_chip())
    peak, bw = spec["flops_bf16"], spec["hbm_gbps"] * 1e9
    rates = spec["dtype_rate"]
    rows: List[dict] = []
    pred_total = 0.0
    for i, op in enumerate(block.ops):
        m = measured[i] if i < len(measured) else None
        if m is None:
            continue
        c = _cost.op_cost(block, op, batch_size)
        dt = c["dtype"] or "float32"
        rate = peak * rates.get(dt, rates["float32"])
        pred = max(c["flops"] / rate if rate else 0.0,
                   c["bytes"] / bw if bw else 0.0)
        pred_total += pred
        rows.append({"index": i, "op_type": op.type,
                     "uid": int(op.attrs.get("__uid__", -1)),
                     "dtype": dt, "measured_s": float(m),
                     "pred_time_s": pred, "pred_flops": c["flops"],
                     "pred_bytes": c["bytes"]})
    attributed = sum(r["measured_s"] for r in rows)
    total_s = float(total_s) or attributed
    by_type: Dict[str, dict] = {}
    for r in rows:
        r["measured_share"] = (r["measured_s"] / total_s
                               if total_s else 0.0)
        r["pred_share"] = (r["pred_time_s"] / pred_total
                           if pred_total else 0.0)
        e = by_type.setdefault(
            r["op_type"],
            {"count": 0, "measured_s": 0.0, "pred_time_s": 0.0,
             "dtype": r["dtype"]})
        e["count"] += 1
        e["measured_s"] += r["measured_s"]
        e["pred_time_s"] += r["pred_time_s"]
    for e in by_type.values():
        e["measured_share"] = (e["measured_s"] / total_s
                               if total_s else 0.0)
        e["pred_share"] = (e["pred_time_s"] / pred_total
                           if pred_total else 0.0)
        e["pred_vs_measured"] = (e["pred_time_s"] / e["measured_s"]
                                 if e["measured_s"] else 0.0)
    by_type = dict(sorted(by_type.items(),
                          key=lambda kv: -kv[1]["measured_s"]))
    top = next(iter(by_type), "")
    n_ops = len(rows)
    if unattributed_s:
        u = float(unattributed_s)
        rows.append({"index": -1, "op_type": UNATTRIBUTED, "uid": -1,
                     "dtype": None, "measured_s": u, "pred_time_s": 0.0,
                     "pred_flops": 0, "pred_bytes": 0,
                     "measured_share": u / total_s if total_s else 0.0,
                     "pred_share": 0.0})
    return {"mode": mode, "chip": spec["chip"],
            "batch_size": int(batch_size), "total_s": total_s,
            "attributed_s": attributed,
            "coverage": attributed / total_s if total_s else 0.0,
            "n_ops": n_ops, "pred_total_s": pred_total,
            "top_op": top, "rows": rows, "by_type": by_type,
            "unattributed_s": float(unattributed_s or 0.0), **meta}


def publish(table, program: str):
    """Materialize a table as registry gauges."""
    for t, e in table["by_type"].items():
        _G_PVM.set(e["pred_vs_measured"], op_type=t, program=program)
        _G_SHARE.set(e["measured_share"], op_type=t, program=program)
    _G_COVERAGE.set(table["coverage"], program=program)


def artifact_row(table, program: str) -> dict:
    """One bench-schema row for a table: headline = coverage, with the
    per-type breakdown and a compact per-op table attached."""
    compact = [{"op_type": r["op_type"], "uid": r["uid"],
                "measured_us": round(r["measured_s"] * 1e6, 3),
                "share": round(r["measured_share"], 4),
                "pred_share": round(r["pred_share"], 4)}
               for r in table["rows"]]
    by_type = {t: {"count": e["count"],
                   "share": round(e["measured_share"], 4),
                   "pred_share": round(e["pred_share"], 4),
                   "pred_vs_measured": round(e["pred_vs_measured"], 6)}
               for t, e in table["by_type"].items()}
    return artifact_metric(
        f"op_attribution_{program}", round(table["coverage"], 4),
        "fraction of measured step time attributed to named desc ops",
        mode=table["mode"], chip=table["chip"], n_ops=table["n_ops"],
        total_ms=round(table["total_s"] * 1e3, 4),
        top_op=table["top_op"], by_type=by_type, op_table=compact)
