"""The `paddle` command-line tool of the port, the port of every
subcommand of ``paddle_tpu/cli.py`` (reference
paddle/scripts/submit_local.sh.in: `paddle train|pserver|version|
merge_model|dump_config`).

Usage: python -m paddle_tpu_torch <subcommand> [args]

  version               — package, torch and CUDA report, and the cards
  dump_config DIR|FILE  — text dump of a saved model / __model__ file
                          (the desc library's, protobuf's DebugString)
  stats DIR|FILE        — one JSON line of program stats (desc library)
  merge_model DIR OUT   — bundle a saved inference model into one file
  validate DIR|FILE     — structural check via the desc library; exit 1
                          with its diagnostics on stderr when refused
  show_pb DIR|FILE      — human-readable dump of blocks/ops/vars
  train --script S      — run a training script with the package on path
  train --config C      — the reference trainer flow (`paddle train
                          --config=conf.py [--job=time]`): run a v1 config
                          that declares its data sources, a topology
                          ending in outputs(cost) and settings(), then
                          train it (`--job train`) or time it (`--job
                          time`); `--place cpu` runs it on the CPU, the
                          default `cuda` on the card
  lint DIR|FILE         — static program verifier (analysis/verifier.py):
                          PTV rule findings report; exit 1 on errors
  analyze DIR|FILE      — static cost & memory analyzer (analysis/cost.py,
                          analysis/memory.py): FLOPs, memory traffic and
                          peak, arithmetic intensity, predicted step time
                          for a chip spec; --json for one machine line.
                          --sharding adds the sharding/communication
                          analysis (analysis/sharding.py) over --axes;
                          with no MODEL it analyzes the 11 parallelism
                          modes and exits 1 on any PTV018/PTV019 finding
  diff A [B]            — translation validation (analysis/
                          equivalence.py): canonicalize both programs and
                          prove/refute semantic equivalence (structural →
                          abstract → differential tiers, the last on
                          --place); exit 1 when NOT equivalent.  With one
                          argument: the program must prove equivalent to
                          its own canonical form, and canonicalization
                          must be idempotent through a serialize round
                          trip
  metrics MODEL         — run a saved model N steps under the telemetry
                          layer (predicted-vs-measured accounting, the
                          tracer) and print the registry: Prometheus text,
                          or --json for the snapshot
  trace MODEL           — the same run; write its Chrome/Perfetto trace
  attribute MODEL       — per-op time attribution table (a standing
                          program or a saved model): the segment walk,
                          --profile a torch.profiler capture,
                          --update-calibration feeds the calibration store
  tune WORKLOAD|DIR     — the autotuner: price the space, measure the
                          predicted top-k, persist the winner (a second
                          run is a cache hit); --mock measures nothing,
                          --smoke runs the loop end to end in a throwaway
                          store
  pserver               — a parameter server (distributed/pserver.py) on
                          --host/--port for --num-trainers, checkpointing
                          to --checkpoint-dir every --checkpoint-period s
  master                — the task-dispatch master (distributed/
                          master.py): leases with --task-timeout,
                          --failure-max, a --snapshot file for restart
                          recovery, opt-in --telemetry-port
  cluster_train ...     — one-command multi-host launch (distributed/
                          cluster_launch.py): trainers with the
                          PADDLE_TRAINER_ID/PADDLE_TRAINERS/
                          PADDLE_COORDINATOR env contract, optional
                          pservers, ssh for remote hosts

The subcommands that run programs take ``--place cuda|cpu`` (default: the
card).

DIR|FILE is a saved model directory (``__model__`` or ``program.json``)
or a program file (JSON or ProgramDesc bytes) that either package wrote;
``dump_config``, ``stats``, ``validate`` and ``show_pb`` read a
directory's ``__model__`` or a ProgramDesc file.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

# the JAX package's subcommands this port lacks, with the ROADMAP.md
# Queue A item that holds each: none since Queue A item 12
UNPORTED: dict = {}


def cmd_version(args) -> int:
    import torch

    import paddle_tpu_torch

    print(f"paddle_tpu_torch {paddle_tpu_torch.__version__}")
    print(f"torch {torch.__version__} (cuda {torch.version.cuda})")
    if torch.cuda.is_available():
        names = [torch.cuda.get_device_name(i)
                 for i in range(torch.cuda.device_count())]
        print("devices:", ", ".join(names))
    else:
        print("devices: no CUDA device")
    return 0


def _place(name):
    from .framework.place import CPUPlace, CUDAPlace

    return CPUPlace() if name == "cpu" else CUDAPlace(0)


def cmd_train(args) -> int:
    import runpy

    if args.script:
        sys.argv = [args.script] + args.script_args
        runpy.run_path(args.script, run_name="__main__")
        return 0

    # an empty --config_args clears a previous run's values (they are
    # module-global)
    from .trainer.config_parser import set_config_args

    set_config_args(args.config_args or "")
    runpy.run_path(args.config, run_name="__config__")
    from .v1 import V1Trainer
    from .v1.layers import declared_outputs

    outs = declared_outputs()
    if not outs:
        print("config did not call outputs(cost)", file=sys.stderr)
        return 1
    trainer = V1Trainer(outs[0], batch_size=args.batch_size or None,
                        place=_place(args.place))
    if args.job == "time":
        ms, last_loss = trainer.time(args.time_batches)
        print(json.dumps({"job": "time", "ms_per_batch": round(ms, 3),
                          "batch_size": trainer.batch_size,
                          # strict JSON: NaN/Inf are not valid tokens
                          "last_loss": last_loss
                          if math.isfinite(last_loss) else None}))
        return 0
    if args.save_dir:
        # reference --save_dir layout: persistables under pass-%05d/
        from . import io as fluid_io

        losses = []
        for p in range(args.num_passes):
            losses += trainer.train(num_passes=1, start_pass=p)
            d = os.path.join(args.save_dir, f"pass-{p:05d}")
            os.makedirs(d, exist_ok=True)
            fluid_io.save_persistables(trainer.exe, d)
            print(f"saved pass {p} -> {d}")
    else:
        losses = trainer.train(num_passes=args.num_passes)
    for i, l in enumerate(losses):
        print(f"Pass {i}: cost={l:.6f}")
    return 0


def _model_bytes(path: str) -> bytes:
    """A model dir's ``__model__`` or a raw ProgramDesc file's bytes."""
    if os.path.isdir(path):
        path = os.path.join(path, "__model__")
    with open(path, "rb") as f:
        return f.read()


def cmd_dump_config(args) -> int:
    # one implementation for the CLI and paddle.utils.dump_config
    from .utils.dump_config import dump_config

    dump_config(args.model)
    return 0


def cmd_stats(args) -> int:
    from .native import program_desc

    print(program_desc.stats(_model_bytes(args.model)))
    return 0


def cmd_validate(args) -> int:
    from .native import program_desc

    ok, diag = program_desc.validate(_model_bytes(args.model))
    if ok:
        print("OK")
        return 0
    print(diag, file=sys.stderr)
    return 1


def cmd_show_pb(args) -> int:
    from .utils import show_pb

    show_pb.dump_program(_model_bytes(args.model))
    return 0


def cmd_merge_model(args) -> int:
    from . import io

    print(io.merge_model(args.model_dir, args.out))
    return 0


def _load_program_any(path):
    """(program, feed_names, fetch_names) from a saved-model dir or a raw
    program file.  Dirs go through io.load_program_desc (``__model__``
    preferred, ``program.json`` fallback, truncation guard); raw files
    are sniffed: JSON vs proto."""
    from . import io as fluid_io
    from .framework.core import Program

    if os.path.isdir(path):
        return fluid_io.load_program_desc(path)
    with open(path, "rb") as f:
        data = f.read()
    if data[:1] == b"{":
        program = Program.from_json(data.decode())
        if not any(b.ops for b in program.blocks):
            # an empty program must never lint "OK: 0 findings"
            raise ValueError(f"{path} holds an empty program — "
                             f"truncated save?")
        return program, None, None
    return fluid_io.parse_program_bytes(data, path), None, None


def cmd_lint(args) -> int:
    from .analysis import verify_program

    program, feed, fetch = _load_program_any(args.model)
    suppress = set()
    for s in args.suppress or []:
        suppress.update(p.strip() for p in s.split(",") if p.strip())
    report = verify_program(
        program, feed_names=feed, fetch_names=fetch,
        batch_size=args.batch_size, suppress=suppress,
        check_shapes=not args.no_shapes)
    print(report.render())
    if report.errors or (args.strict and report.warnings):
        return 1
    return 0


def _parse_axes(spec: str):
    """"dp=4,mp=2" -> {"dp": 4, "mp": 2}; raises ValueError with a
    usage-worthy message on malformed input (caller turns it into
    exit code 2, not a traceback)."""
    out = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        name, eq, size = part.partition("=")
        if not eq or not name.strip() or not size.strip().isdigit():
            raise ValueError(
                f"--axes entry {part!r} is not NAME=SIZE (e.g. "
                f"dp=4,mp=2)")
        out[name.strip()] = int(size)
    return out


def _sharding_reports(args):
    """`analyze --sharding` without a model: run the sharding analyzer
    over the built-in parallelism-mode catalog (exit 1 on any
    PTV018/PTV019 finding).  Desc-only: the mesh's positions are CPU
    placeholders and nothing runs."""
    from .analysis import cost as acost
    from .analysis import sharding as ash
    from .parallel import modes as pmodes

    names = [args.mode] if args.mode else list(pmodes.MODE_NAMES)
    rc = 0
    for name in names:
        mode, program, loss_name = pmodes.build_mode(name)
        mesh, plan, provenance = pmodes.mode_plan(mode, program)
        findings, ana = ash.sharding_findings(
            program, plan, batch_size=args.batch_size,
            provenance=provenance, mesh=mesh)
        comm = ash.comm_report(ana, chip=args.chip)
        gate = [f for f in findings if f.rule in ("PTV018", "PTV019")]
        if gate:
            rc = 1
        # per-mode scaling-efficiency projection over the mode's
        # primary (largest) mesh axis
        cost_rep = acost.program_cost(program,
                                      batch_size=args.batch_size,
                                      chip=args.chip)
        axis = max(mode.mesh_axes, key=mode.mesh_axes.get)
        curve = ash.scaling_curve(ana, cost_rep, axis=axis,
                                  sizes=(1, 2, 4, 8, 16, 64),
                                  chip=args.chip)
        if args.json:
            print(json.dumps({
                "mode": name, "mesh": dict(mode.mesh_axes),
                "findings": [f.format() for f in findings],
                "gate_failed": bool(gate),
                "per_kind": comm["per_kind"],
                "comm_time_s": comm["comm_time_s"],
                "scaling_axis": axis,
                "scaling_curve": [
                    {"n": p["n"],
                     "efficiency": round(p["efficiency"], 4)}
                    for p in curve]}))
            continue
        print(f"== mode {name} (mesh {dict(mode.mesh_axes)})")
        for f in findings:
            print("  " + f.format())
        if not findings:
            print(f"  OK: no findings "
                  f"({len(ana.collectives)} collectives classified)")
        print("  " + ash.render_comm(comm).replace("\n", "\n  "))
        eff = "  ".join(f"{p['n']}x{p['efficiency'] * 100:.0f}%"
                        for p in curve)
        print(f"  scaling over {axis!r} (strong, n x eff): {eff}")
    return rc


def cmd_analyze(args) -> int:
    from .analysis import cost as acost
    from .analysis import memory as amem

    if args.model is None:
        if not args.sharding:
            print("analyze: MODEL required unless --sharding runs the "
                  "built-in parallelism-mode catalog", file=sys.stderr)
            return 2
        return _sharding_reports(args)

    program, feed, fetch = _load_program_any(args.model)
    cost_rep = acost.program_cost(program, batch_size=args.batch_size,
                                  chip=args.chip)
    mem_rep = amem.peak_estimate(program, batch_size=args.batch_size,
                                 infer_shapes=not args.no_shapes)
    shard_rep = comm = None
    if args.sharding:
        from .analysis import sharding as ash
        from .framework.place import CPUPlace
        from .parallel import modes as pmodes
        from .parallel.parallel_executor import ParallelExecutor

        try:
            axes = _parse_axes(args.axes) or {"dp": 8}
        except ValueError as e:
            print(f"analyze: {e}", file=sys.stderr)
            return 2
        n_devices = 1
        for s in axes.values():
            n_devices *= s
        pe = ParallelExecutor(axes=axes, devices=pmodes.
                              ensure_virtual_devices(max(1, n_devices),
                                                     CPUPlace()))
        provenance = {}
        plan = pe.static_plan(program, provenance=provenance)
        findings, ana = ash.sharding_findings(
            program, plan, batch_size=args.batch_size,
            provenance=provenance, mesh=pe.mesh)
        comm = ash.comm_report(ana, chip=args.chip)
        cost_rep = acost.roofline_with_comm(cost_rep, comm,
                                            devices=n_devices)
        shard_rep = {"axes": axes,
                     "findings": [f.format() for f in findings],
                     "per_kind": comm["per_kind"],
                     "comm_time_s": comm["comm_time_s"]}
    if args.json:
        rec = {"model": args.model, "cost": cost_rep, "memory": mem_rep}
        if shard_rep is not None:
            rec["sharding"] = shard_rep
        print(json.dumps(rec))
    else:
        print(acost.render(cost_rep))
        print(amem.render(mem_rep))
        if shard_rep is not None:
            from .analysis import sharding as ash

            print(ash.render_comm(comm))
            for f in shard_rep["findings"]:
                print(f)
    return 0


def _load_scope_for(path):
    """Scope of saved values when `path` is a saved-model dir (the
    persistables.json manifest), else None — the differential oracle
    then seeds missing state deterministically by name."""
    if not os.path.isdir(path):
        return None
    manifest = os.path.join(path, "persistables.json")
    if not os.path.exists(manifest):
        return None
    from . import io as fluid_io
    from .framework.scope import Scope

    with open(manifest) as f:
        names = json.load(f)
    scope = Scope()
    fluid_io.load_vars(path, names, scope)  # the one saved-model loader
    return scope


def cmd_diff(args) -> int:
    from .analysis import equivalence as eqv
    from .framework.core import Program

    prog_a, feed_a, fetch_a = _load_program_any(args.prog_a)
    execute = "never" if args.no_exec else "auto"

    if args.prog_b is None:
        # self-check: prove the program equivalent to its own canonical
        # form, and canonicalization idempotent through a JSON round
        # trip.  A bare program dump carries no meta: derive the
        # interface FIRST, so the canonical form and the proof agree on
        # it (deriving sinks after canonicalization would chase names
        # the alpha-renaming already replaced)
        if fetch_a is None:
            fetch_a = eqv.sink_outputs(prog_a.global_block())
        if feed_a is None:
            feed_a = [v.name for v in prog_a.global_block().vars.values()
                      if v.is_data]
        canon, info = eqv.canonicalize(prog_a, fetch_a, feed_a)
        canon_rt = Program.from_json(canon.to_json())
        canon2, _ = eqv.canonicalize(canon_rt, fetch_a, feed_a)
        idem = not eqv.semantic_diff(canon, canon2)
        proof = eqv.prove_equivalent(prog_a, canon, feed_names=feed_a,
                                     fetch_names=fetch_a,
                                     batch_size=args.batch_size,
                                     execute="never")
        ok = proof.equivalent and idem
        if args.json:
            print(json.dumps({
                "mode": "self_check", "model": args.prog_a,
                "equivalent": bool(proof.equivalent),
                "idempotent": bool(idem), "tier": proof.tier,
                "ops": len(canon.global_block().ops),
                "dead_removed": info.dead_removed,
                "renamed": info.renamed,
                "duplicates": len(info.duplicates)}))
        else:
            print(f"self-check {args.prog_a}: "
                  f"{'OK' if ok else 'FAILED'} "
                  f"(canonical ops {len(canon.global_block().ops)}, "
                  f"dead removed {info.dead_removed}, renamed "
                  f"{info.renamed}, duplicates {len(info.duplicates)}, "
                  f"idempotent {idem})")
            if not proof.equivalent:
                print(proof.render())
        return 0 if ok else 1

    prog_b, feed_b, fetch_b = _load_program_any(args.prog_b)
    feed = feed_a if feed_a is not None else feed_b
    fetch = fetch_a if fetch_a is not None else fetch_b
    scope_a = _load_scope_for(args.prog_a)
    scope_b = _load_scope_for(args.prog_b)
    # one side with values, one bare program (dir vs its program.json):
    # share the scope — seeding only the bare side with synthetic
    # weights would fabricate a divergence between identical programs
    if scope_a is None:
        scope_a = scope_b
    elif scope_b is None:
        scope_b = scope_a
    if scope_a is not None and not args.no_exec:
        # saved VALUES are part of a model: two desc-identical dirs with
        # different weights must diff, so the oracle always runs
        execute = "always"
    proof = eqv.prove_equivalent(
        prog_a, prog_b, feed_names=feed, fetch_names=fetch,
        batch_size=args.batch_size, scope_before=scope_a,
        scope_after=scope_b, execute=execute, rtol=args.rtol,
        atol=args.atol, place=_place(args.place))
    if args.json:
        print(json.dumps({
            "a": args.prog_a, "b": args.prog_b,
            "equivalent": bool(proof.equivalent), "tier": proof.tier,
            "findings": [f.format() for f in proof.findings],
            "diff": proof.diff.render() if proof.diff else None,
            "detail": proof.detail}))
    else:
        print(proof.render())
    return 0 if proof.equivalent else 1


def seed_missing_state(program, feeds, scope, block_id: int = 0):
    """Seed every name the block reads from the scope that `scope` does
    not hold, deterministically by name (the differential oracle's
    idiom): a saved dir carries its persistables, anything else gets
    synthetic values."""
    from .analysis import equivalence as eqv
    from .analysis.dataflow import state_classes

    block = program.blocks[block_id]
    ext, rw, _ = state_classes(block, list(feeds))
    for name in list(ext) + list(rw):
        if scope.find(name) is not None:
            continue
        dv = block._find_var_recursive(name)
        if dv is not None and dv.shape is not None:
            scope.set(name, eqv._seed_array(
                name, eqv._bind(dv.shape, 1), dv.dtype or "float32", 0))


def _telemetry_run(args):
    """Shared runner for the `metrics` and `trace` subcommands: load a
    saved model, attach predicted-vs-measured accounting, drive N
    executor steps on deterministic synthetic feeds with the tracer
    enabled, and record the measured peak (on the card).  Returns the
    observability module, whose registry/tracer/accounting now hold the
    run."""
    from . import observability as obs
    from .analysis import cost as acost
    from .analysis import equivalence as eqv
    from .framework.executor import Executor
    from .framework.scope import Scope

    program, feed, fetch = _load_program_any(args.model)
    block = program.global_block()
    if fetch is None:
        fetch = eqv.sink_outputs(block)
    if feed is None:
        feed = [v.name for v in block.vars.values() if v.is_data]
    place = _place(args.place)
    obs.enable_tracing()
    label = os.path.basename(os.path.normpath(args.model)) or "model"
    obs.accounting.track(
        program, label, batch_size=args.batch_size,
        chip="cpu-host" if args.place == "cpu" else acost.detect_chip())
    feeds = eqv.build_feeds(program, feed, batch_size=args.batch_size)
    scope = _load_scope_for(args.model) or Scope()
    seed_missing_state(program, feeds, scope)
    exe = Executor(place)
    for i in range(max(1, args.steps)):
        with obs.span("telemetry.step", step=i):
            exe.run(program, feed=dict(feeds), fetch_list=list(fetch),
                    scope=scope, rng_step=i)
    obs.accounting.record_measured_peak(program, exe, feed=dict(feeds),
                                        fetch_list=list(fetch),
                                        scope=scope)
    return obs


def cmd_metrics(args) -> int:
    """Run a saved model under the telemetry layer and print the
    registry state: Prometheus text by default, --json for the snapshot
    (with the predicted-vs-measured report attached)."""
    obs = _telemetry_run(args)
    if args.trace_out:
        obs.TRACER.export(args.trace_out)
        print(f"# trace written to {args.trace_out}", file=sys.stderr)
    if args.json:
        body = obs.REGISTRY.snapshot()
        body["pred_vs_measured"] = obs.accounting.report()
        print(json.dumps(body))
    else:
        print(obs.REGISTRY.render_prometheus(), end="")
    return 0


def cmd_trace(args) -> int:
    """Run a saved model under the tracer and write the Chrome/Perfetto
    trace-event JSON (open it at https://ui.perfetto.dev)."""
    obs = _telemetry_run(args)
    out = args.out or (os.path.basename(os.path.normpath(args.model))
                       + ".trace.json")
    obs.TRACER.export(out)
    problems = obs.validate_chrome_trace(obs.TRACER.to_chrome())
    n = len(obs.TRACER.events())
    print(f"{out}: {n} events"
          + (f"; SCHEMA PROBLEMS: {problems}" if problems else ""))
    return 1 if problems else 0


def cmd_attribute(args) -> int:
    """`attribute MODEL` — the per-op time attribution table.  MODEL is a
    standing program (fit_a_line|recognize_digits|small_lm|lstm,
    models/standing.py) or a saved-model dir/file.

    Runs the segment walk on --place (CUDA events on the card, the host
    clock on the CPU; observability/attribution.py), joins measured
    per-op time against the static cost model, publishes the
    op_pred_vs_measured gauges, and emits ONE bench-schema artifact
    line.  --profile also captures a torch.profiler trace of executor
    steps with the op ranges on and attributes its device time (on the
    card a trace without op-named device time fails the command);
    --update-calibration feeds the table into the calibration store the
    autotune prior consumes."""
    import paddle_tpu_torch as fluid

    from . import observability as obs
    from .analysis import cost as acost
    from .analysis import equivalence as eqv
    from .framework.executor import Executor
    from .framework.scope import Scope
    from .models.standing import get_builder

    if args.calibration_root:
        os.environ["PADDLE_TPU_CALIBRATION_CACHE"] = os.path.abspath(
            args.calibration_root)
    place = _place(args.place)
    chip = args.chip or ("cpu-host" if args.place == "cpu"
                         else acost.detect_chip())
    builder = get_builder(args.model)
    if builder is not None:
        label = args.model
        fluid.reset()
        feed, fetch, bs = builder()
        program = fluid.default_main_program()
        scope = Scope()
        Executor(place).run(fluid.default_startup_program(), scope=scope)
    else:
        program, feed_names, fetch = _load_program_any(args.model)
        block = program.global_block()
        if fetch is None:
            fetch = eqv.sink_outputs(block)
        if feed_names is None:
            feed_names = [v.name for v in block.vars.values()
                          if v.is_data]
        label = (os.path.basename(os.path.normpath(args.model))
                 or "model").replace("-", "_").replace(".", "_")
        bs = args.batch_size
        feed = eqv.build_feeds(program, feed_names, batch_size=bs)
        scope = _load_scope_for(args.model) or Scope()
        seed_missing_state(program, feed, scope)

    table = obs.attribution.attribute_cpu(
        program, feed, scope=scope, batch_size=bs,
        repeats=args.repeats, chip=chip, place=place)
    obs.attribution.publish(table, label)
    row = obs.attribution.artifact_row(table, label)

    if args.profile:
        pexe = Executor(place)

        def step(i):
            pexe.run(program, feed=dict(feed), fetch_list=list(fetch),
                     scope=scope, rng_step=i)

        # one step outside the capture: a saved model's weights move to
        # the card on the first run, outside every op's range
        step(0)
        cap = obs.attribution.capture_profile(step, args.profile,
                                              steps=args.steps,
                                              place=place)
        row["profile_trace"] = cap["trace_file"]
        ptab = obs.attribution.table_from_scopes(
            program.global_block(), cap["by_scope"], batch_size=bs,
            chip=chip, unattributed_s=cap["unattributed_s"],
            mode=cap["mode"])
        row["profile_coverage"] = round(ptab["coverage"], 4)
        row["profile_table"] = obs.attribution.artifact_row(
            ptab, label)["by_type"]

    if args.update_calibration:
        entry = obs.calibration.default_store().record_attribution(table)
        row["calibration_updated"] = bool(entry)

    if args.smoke:
        # the attribution gate: >=80% of measured step time attributed
        # to named desc ops, every row carries a uid, the families exist
        assert table["coverage"] >= 0.8, \
            f"attribution coverage {table['coverage']:.3f} < 0.8"
        assert table["n_ops"] > 0 and table["by_type"], table["n_ops"]
        assert all(r["uid"] >= 0 for r in table["rows"]), \
            "desc op without a __uid__ in the attribution table"
        snapshot = obs.REGISTRY.snapshot()
        sp = obs.validate_snapshot(snapshot)
        assert not sp, f"snapshot schema: {sp}"
        for fam in ("op_pred_vs_measured", "op_measured_time_share",
                    "op_attribution_coverage"):
            assert fam in snapshot["families"], f"missing family {fam}"
        print(f"# attribution smoke OK ({label}: {table['n_ops']} ops, "
              f"coverage {table['coverage']:.3f}, top "
              f"{table['top_op']})", file=sys.stderr)

    line = json.dumps(row)
    if not args.json:
        print(f"attribution {label} ({table['mode']}, chip "
              f"{table['chip']}): {table['n_ops']} ops, "
              f"{table['total_s'] * 1e3:.3f} ms/walk, coverage "
              f"{table['coverage']:.3f}", file=sys.stderr)
        for t, e in list(table["by_type"].items())[:args.top]:
            print(f"  {t:<28} x{e['count']:<4} "
                  f"{e['measured_share'] * 100:6.2f}% measured  "
                  f"{e['pred_share'] * 100:6.2f}% predicted  "
                  f"pred/meas {e['pred_vs_measured']:.2e}",
                  file=sys.stderr)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


def cmd_tune(args) -> int:
    """`tune WORKLOAD` — the autotuner's search loop.  WORKLOAD is a
    registered name (gpt_small, bn_conv, paged_decode, spec_decode,
    lstm, mlp_depth, step_loop) or a saved-model dir.  Winners persist in
    the autotune store; a second run is a cache hit (no re-measurement)
    unless --force."""
    if args.store:
        # the store location binds for the WHOLE process (knob
        # resolution during trials reads default_store)
        os.environ["PADDLE_TPU_AUTOTUNE_CACHE"] = os.path.abspath(
            args.store)
    elif args.mock and not args.smoke \
            and "PADDLE_TPU_AUTOTUNE_CACHE" not in os.environ:
        # mock winners are digest-hash noise: persisting them into the
        # real default store would configure later runs with them
        import tempfile

        tmp = tempfile.mkdtemp(prefix="paddle_tune_mock_")
        os.environ["PADDLE_TPU_AUTOTUNE_CACHE"] = tmp
        print(f"# --mock: winners land in throwaway store {tmp} "
              f"(pass --store to keep them)", file=sys.stderr)
    from . import autotune
    from .autotune import measure as at_measure
    from .autotune import workloads as at_workloads

    if args.smoke:
        return _tune_smoke(args)

    wl = at_workloads.get_workload(args.workload, place=_place(args.place))
    measurer = (at_measure.MockMeasurer() if args.mock
                else at_measure.TimedMeasurer(warmup=args.warmup,
                                              iters=args.iters,
                                              repeats=args.repeats))
    rep = autotune.tune(wl, measurer=measurer, top_k=args.top_k,
                        chip=args.chip, force=args.force,
                        measure_all=args.measure_all)
    if args.json:
        print(json.dumps(rep))
        return 0
    return _render_tune(rep)


def _render_tune(rep) -> int:
    from .autotune import store as at_store

    if rep.get("cache_hit"):
        e = rep["entry"]
        print(f"tune {rep['workload']}: winner loaded from store "
              f"(cache hit, no re-measurement)")
        print(f"  params   {rep['winner']}")
        print(f"  measured {e.get('measured_s', 0) * 1e3:.3f} ms/step "
              f"(tuned {e.get('created_utc', '?')}; --force re-measures)")
        return 0
    print(f"tune {rep['workload']}: space {rep['space_size']}, "
          f"{rep['n_feasible']} feasible, {rep['n_rejected']} rejected "
          f"by the analyzers before any trial")
    for t in rep["trials"]:
        mark = "*" if t["digest"] == rep["winner_row"]["digest"] else " "
        print(f" {mark} {t['digest']}  pred "
              f"{t['predicted_step_s'] * 1e3:9.4f} ms  measured "
              f"{t['best_s'] * 1e3:9.4f}/{t['median_s'] * 1e3:.4f} ms "
              f"(best/median)  {t['params']}")
    base = rep.get("default_row")
    win = rep["winner_row"]
    if base:
        speedup = base["best_s"] / win["best_s"] if win["best_s"] else 0
        print(f"  winner vs default: {speedup:.3f}x "
              f"({base['best_s'] * 1e3:.4f} -> "
              f"{win['best_s'] * 1e3:.4f} ms)")
    print(f"  prior rank of measured winner: {rep['rank_of_winner']} "
          f"(in top-k: {rep['in_top_k']})")
    print(f"  persisted -> {at_store.default_store().root}")
    return 0


def _tune_smoke(args) -> int:
    """Fast gate: the workload's space with the mock measurer in a
    private store — asserts the prior/measure/store/cache-hit loop end
    to end without running a trial."""
    import tempfile

    from . import autotune
    from .autotune import integration as at_int
    from .autotune import workloads as at_workloads
    from .autotune.measure import MockMeasurer

    place = _place(args.place)
    prev = os.environ.get("PADDLE_TPU_AUTOTUNE_CACHE")
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["PADDLE_TPU_AUTOTUNE_CACHE"] = tmp
        try:
            at_int.reset()
            wl = at_workloads.get_workload(args.workload, place=place)
            m = MockMeasurer()
            rep = autotune.tune(wl, measurer=m, top_k=3)
            assert not rep["cache_hit"] and rep["winner"], rep
            assert m.measured, "mock measurer never ran"
            assert rep["default_row"] is not None, \
                "baseline candidate was not measured"
            # the winner is measured-best by construction: >= default
            assert rep["winner_row"]["best_s"] <= \
                rep["default_row"]["best_s"] + 1e-12
            # second run: the persisted winner comes back with NO
            # measurement
            m2 = MockMeasurer()
            rep2 = autotune.tune(
                at_workloads.get_workload(args.workload, place=place),
                measurer=m2)
            assert rep2["cache_hit"] and not m2.measured, rep2
            assert rep2["winner"] == rep["winner"]
            # memory-infeasible candidates are rejected BEFORE any
            # trial: under a 1 MiB budget everything is infeasible
            if getattr(wl, "kind", "") == "program":
                m3 = MockMeasurer()
                try:
                    autotune.tune(
                        at_workloads.get_workload(args.workload,
                                                  place=place),
                        measurer=m3, force=True, hbm_bytes=1 << 20)
                    raise AssertionError("1MiB-budget tune did not "
                                         "reject")
                except RuntimeError:
                    pass
                assert not m3.measured, \
                    "infeasible candidates were measured"
        finally:
            if prev is None:
                os.environ.pop("PADDLE_TPU_AUTOTUNE_CACHE", None)
            else:
                os.environ["PADDLE_TPU_AUTOTUNE_CACHE"] = prev
            at_int.reset()
        print(f"# autotune smoke OK ({args.workload}: "
              f"{len(m.measured)} mock trials, winner "
              f"{rep['winner']}, cache-hit verified)", file=sys.stderr)
    return 0


def cmd_pserver(args) -> int:
    from .distributed import pserver

    pserver.serve_forever(host=args.host, port=args.port,
                          num_trainers=args.num_trainers,
                          checkpoint_dir=args.checkpoint_dir,
                          checkpoint_period_s=args.checkpoint_period)
    return 0


def cmd_master(args) -> int:
    from .distributed.master import MasterServer, MasterService

    svc = MasterService(timeout_s=args.task_timeout,
                        failure_max=args.failure_max,
                        snapshot_path=args.snapshot)
    srv = MasterServer(svc, host=args.host, port=args.port).start()
    if args.telemetry_port is not None:
        from .observability.httpd import serve_http

        tele = serve_http(args.telemetry_port)
        print(f"telemetry on http://127.0.0.1:{tele.port}/metrics "
              f"(+ /metrics.json, /trace)", flush=True)
    print(f"master serving on {srv.addr[0]}:{srv.addr[1]}", flush=True)
    try:
        srv._thread.join()
    except KeyboardInterrupt:
        srv.stop()
    return 0


def main(argv=None) -> int:
    real_argv = sys.argv[1:] if argv is None else list(argv)
    # `cluster_train ...` — one-command multi-host launch (reference
    # paddle/scripts/cluster_train/paddle.py).  Dispatched BEFORE
    # argparse: the launcher owns its whole argv
    if real_argv[:1] == ["cluster_train"]:
        from .distributed.cluster_launch import main as launch_main

        return launch_main(real_argv[1:])

    parser = argparse.ArgumentParser(prog="paddle", description=__doc__,
                                     formatter_class=argparse.
                                     RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="cmd", required=True)
    sub.add_parser("version").set_defaults(fn=cmd_version)

    p = sub.add_parser("train")
    g = p.add_mutually_exclusive_group(required=True)
    g.add_argument("--script", help="run a python training script")
    g.add_argument("--config",
                   help="v1 config (data sources + topology + settings)")
    p.add_argument("--job", choices=["train", "time"], default="train")
    p.add_argument("--num-passes", type=int, default=1)
    p.add_argument("--batch-size", type=int, default=0)
    p.add_argument("--time-batches", type=int, default=5)
    p.add_argument("--config_args", "--config-args", default="",
                   help="a=1,b=x values config scripts read via "
                        "get_config_arg (reference --config_args)")
    p.add_argument("--save-dir", "--save_dir", default=None,
                   help="save persistables per pass under "
                        "SAVE_DIR/pass-%%05d (reference --save_dir)")
    p.add_argument("--place", choices=["cuda", "cpu"], default="cuda",
                   help="where the config runs (default: the card)")
    p.add_argument("script_args", nargs=argparse.REMAINDER)
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("lint")
    p.add_argument("model", help="saved model dir, __model__ file, or "
                                 "program.json")
    p.add_argument("--batch-size", type=int, default=2,
                   help="value binding -1 feed dims during abstract eval")
    p.add_argument("--suppress", action="append", default=[],
                   help="comma-separated PTV rule ids to silence")
    p.add_argument("--strict", action="store_true",
                   help="exit 1 on warnings too, not just errors")
    p.add_argument("--no-shapes", action="store_true",
                   help="skip abstract shape/dtype eval (PTV006)")
    p.set_defaults(fn=cmd_lint)

    p = sub.add_parser("analyze")
    p.add_argument("model", nargs="?", default=None,
                   help="saved model dir, __model__ file, or "
                        "program.json; omit with --sharding to run the "
                        "built-in parallelism-mode catalog")
    p.add_argument("--batch-size", type=int, default=64,
                   help="value binding -1 feed dims in the cost/peak model")
    p.add_argument("--chip", default=None,
                   help="chip spec for the roofline prediction "
                        "(default $PADDLE_TPU_CHIP or h100-sxm)")
    p.add_argument("--json", action="store_true",
                   help="one JSON line instead of the human tables")
    p.add_argument("--no-shapes", action="store_true",
                   help="skip the abstract-eval shape oracle (desc-only "
                        "speed; -1 dims bind to --batch-size)")
    p.add_argument("--sharding", action="store_true",
                   help="sharding-propagation & communication analysis "
                        "(analysis/sharding.py): with MODEL, shard it "
                        "over --axes and add the comm-aware roofline; "
                        "without MODEL, analyze the 11 parallelism "
                        "modes and exit 1 on any PTV018/PTV019 finding")
    p.add_argument("--mode", default=None,
                   help="restrict the catalog run to one mode name")
    p.add_argument("--axes", default="",
                   help="mesh axes for --sharding on a saved model, "
                        "e.g. dp=4,mp=2 (default dp=8)")
    p.set_defaults(fn=cmd_analyze)

    p = sub.add_parser("diff")
    p.add_argument("prog_a", help="saved model dir, __model__ file, or "
                                  "program.json")
    p.add_argument("prog_b", nargs="?", default=None,
                   help="second program; omit for self-check mode "
                        "(program vs its own canonical form)")
    p.add_argument("--batch-size", type=int, default=2,
                   help="binds -1 feed dims for the abstract and "
                        "differential tiers")
    p.add_argument("--no-exec", action="store_true",
                   help="desc-only: a structural mismatch is final "
                        "(skip the differential oracle)")
    p.add_argument("--rtol", type=float, default=1e-4,
                   help="differential-tier relative tolerance")
    p.add_argument("--atol", type=float, default=1e-6,
                   help="differential-tier absolute tolerance")
    p.add_argument("--json", action="store_true",
                   help="one JSON line instead of the human report")
    p.add_argument("--place", choices=["cuda", "cpu"], default="cuda",
                   help="where the differential tier runs (default: the "
                        "card)")
    p.set_defaults(fn=cmd_diff)

    place_kw = dict(choices=["cuda", "cpu"], default="cuda",
                    help="where the program runs (default: the card)")
    p = sub.add_parser("metrics")
    p.add_argument("model", help="saved model dir, __model__ file, or "
                                 "program.json")
    p.add_argument("--steps", type=int, default=5,
                   help="executor steps to drive (the first builds)")
    p.add_argument("--batch-size", type=int, default=2,
                   help="binds -1 feed dims of the synthetic feeds")
    p.add_argument("--json", action="store_true",
                   help="registry snapshot JSON (+ pred_vs_measured "
                        "report) instead of Prometheus text")
    p.add_argument("--trace-out", default=None,
                   help="also write the step trace JSON here")
    p.add_argument("--place", **place_kw)
    p.set_defaults(fn=cmd_metrics)

    p = sub.add_parser("trace")
    p.add_argument("model", help="saved model dir, __model__ file, or "
                                 "program.json")
    p.add_argument("--steps", type=int, default=5,
                   help="executor steps to drive (the first builds)")
    p.add_argument("--batch-size", type=int, default=2,
                   help="binds -1 feed dims of the synthetic feeds")
    p.add_argument("--out", default=None,
                   help="trace path (default MODEL.trace.json)")
    p.add_argument("--place", **place_kw)
    p.set_defaults(fn=cmd_trace)

    p = sub.add_parser("attribute")
    p.add_argument("model",
                   help="standing program (fit_a_line|recognize_digits|"
                        "small_lm|lstm) or a saved-model dir/file")
    p.add_argument("--repeats", type=int, default=3,
                   help="segment walks per op (median is reported)")
    p.add_argument("--steps", type=int, default=3,
                   help="executor steps under --profile")
    p.add_argument("--batch-size", type=int, default=2,
                   help="binds -1 feed dims of saved models")
    p.add_argument("--chip", default=None,
                   help="chip spec for the predicted column (default: "
                        "h100-sxm on the card, cpu-host on the CPU)")
    p.add_argument("--top", type=int, default=8,
                   help="op types shown in the human table")
    p.add_argument("--profile", default=None,
                   help="also capture a torch.profiler trace of executor "
                        "steps into this dir and attribute its device "
                        "time by op")
    p.add_argument("--update-calibration", action="store_true",
                   help="feed the table into the calibration store "
                        "(observability/calibration.py)")
    p.add_argument("--calibration-root", default=None,
                   help="calibration store dir (default "
                        "$PADDLE_TPU_CALIBRATION_CACHE or the package's "
                        "_cache/calibration)")
    p.add_argument("--json", action="store_true",
                   help="suppress the human table (artifact line only)")
    p.add_argument("--out", default=None,
                   help="also write the artifact line to FILE")
    p.add_argument("--smoke", action="store_true",
                   help="gate: coverage/schema asserts")
    p.add_argument("--place", **place_kw)
    p.set_defaults(fn=cmd_attribute)

    p = sub.add_parser("tune")
    p.add_argument("workload",
                   help="registered workload (gpt_small|bn_conv|"
                        "paged_decode|spec_decode|lstm|mlp_depth|"
                        "step_loop) or a saved-model dir")
    p.add_argument("--top-k", type=int, default=5,
                   help="how many predicted-best candidates to measure "
                        "(the prior gate)")
    p.add_argument("--chip", default=None,
                   help="chip spec for the prior (default: "
                        "$PADDLE_TPU_CHIP, else the detected card)")
    p.add_argument("--store", default=None,
                   help="winner-store dir (default "
                        "$PADDLE_TPU_AUTOTUNE_CACHE or the package's "
                        "_cache/autotune)")
    p.add_argument("--force", action="store_true",
                   help="re-measure even when the store has a winner")
    p.add_argument("--measure-all", action="store_true",
                   help="measure every feasible candidate, not just "
                        "top-k")
    p.add_argument("--mock", action="store_true",
                   help="deterministic mock measurer (runs nothing)")
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--json", action="store_true")
    p.add_argument("--smoke", action="store_true",
                   help="gate: the mock tune in a throwaway store, "
                        "asserting the rank/measure/persist/cache-hit "
                        "loop")
    p.add_argument("--place", **place_kw)
    p.set_defaults(fn=cmd_tune)

    for name, fn in (("dump_config", cmd_dump_config), ("stats", cmd_stats),
                     ("validate", cmd_validate), ("show_pb", cmd_show_pb)):
        p = sub.add_parser(name)
        p.add_argument("model", help="saved model dir or __model__ file")
        p.set_defaults(fn=fn)

    p = sub.add_parser("merge_model")
    p.add_argument("model_dir")
    p.add_argument("out")
    p.set_defaults(fn=cmd_merge_model)

    p = sub.add_parser("pserver")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=7164)
    p.add_argument("--num-trainers", type=int, default=1)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-period", type=float, default=600.0)
    p.set_defaults(fn=cmd_pserver)

    p = sub.add_parser("master")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--task-timeout", type=float, default=60.0)
    p.add_argument("--failure-max", type=int, default=3)
    p.add_argument("--snapshot", default=None,
                   help="task-queue snapshot file (restart recovery)")
    p.add_argument("--telemetry-port", type=int, default=None,
                   help="opt-in localhost /metrics + /trace endpoint "
                        "(0 = any free port)")
    p.set_defaults(fn=cmd_master)

    sub.add_parser(
        "cluster_train",
        help="launch a multi-host job (see distributed/cluster_launch.py)")

    args = parser.parse_args(real_argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
