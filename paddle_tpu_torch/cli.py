"""The `paddle` command-line tool of the port: ``version``, ``train``,
``lint``, ``analyze`` and ``diff``, the port of those subcommands of
``paddle_tpu/cli.py`` (reference paddle/scripts/submit_local.sh.in:
`paddle train|version`).

Usage: python -m paddle_tpu_torch <subcommand> [args]

  version               — package, torch and CUDA report, and the cards
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
                          for a chip spec; --json for one machine line
                          (--sharding exits 2: Queue A item 11)
  diff A [B]            — translation validation (analysis/
                          equivalence.py): canonicalize both programs and
                          prove/refute semantic equivalence (structural →
                          abstract → differential tiers, the last on
                          --place); exit 1 when NOT equivalent.  With one
                          argument: the program must prove equivalent to
                          its own canonical form, and canonicalization
                          must be idempotent through a serialize round
                          trip

DIR|FILE is a saved model directory (``__model__`` or ``program.json``)
or a program file (JSON or ProgramDesc bytes) that either package wrote.

The JAX package's other subcommands (dump_config, stats, validate,
show_pb, merge_model, metrics, trace, attribute, tune, pserver, master,
cluster_train) are not ported: each exits non-zero and names the
ROADMAP.md queue item that holds it (Queue A items 9-12).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

# the JAX package's subcommands this port lacks, with the ROADMAP.md
# Queue A item that holds each
UNPORTED = {
    "dump_config": 12, "stats": 12, "validate": 12, "show_pb": 12,
    "merge_model": 12, "metrics": 9,
    "trace": 9, "attribute": 9, "tune": 10, "pserver": 11, "master": 11,
    "cluster_train": 11,
}


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


def cmd_analyze(args) -> int:
    from .analysis import cost as acost
    from .analysis import memory as amem

    if args.sharding:
        print("analyze --sharding: analysis/sharding.py and the "
              "parallelism modes are not ported (ROADMAP.md Queue A item "
              "11)", file=sys.stderr)
        return 2
    if args.model is None:
        print("analyze: MODEL required", file=sys.stderr)
        return 2
    program, _, _ = _load_program_any(args.model)
    cost_rep = acost.program_cost(program, batch_size=args.batch_size,
                                  chip=args.chip)
    mem_rep = amem.peak_estimate(program, batch_size=args.batch_size,
                                 infer_shapes=not args.no_shapes)
    if args.json:
        print(json.dumps({"model": args.model, "cost": cost_rep,
                          "memory": mem_rep}))
    else:
        print(acost.render(cost_rep))
        print(amem.render(mem_rep))
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


def main(argv=None) -> int:
    real_argv = sys.argv[1:] if argv is None else list(argv)
    if real_argv and real_argv[0] in UNPORTED:
        print(f"paddle_tpu_torch: subcommand {real_argv[0]!r} is not ported "
              f"(ROADMAP.md Queue A item {UNPORTED[real_argv[0]]}; the port "
              f"has 'train', 'version', 'lint', 'analyze' and 'diff')",
              file=sys.stderr)
        return 2

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
                        "program.json")
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
                   help="not ported (ROADMAP.md Queue A item 11): exits 2")
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

    args = parser.parse_args(real_argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
