"""The `paddle` command-line tool of the port: ``version`` and ``train``,
the port of those two subcommands of ``paddle_tpu/cli.py`` (reference
paddle/scripts/submit_local.sh.in: `paddle train|version`).

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

The JAX package's other subcommands (dump_config, stats, validate,
show_pb, merge_model, lint, analyze, diff, metrics, trace, attribute,
tune, pserver, master, cluster_train) are not ported: each exits non-zero
and names the ROADMAP.md queue item that holds it (Queue A items 8-12).
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
    "merge_model": 12, "lint": 8, "analyze": 8, "diff": 8, "metrics": 9,
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


def main(argv=None) -> int:
    real_argv = sys.argv[1:] if argv is None else list(argv)
    if real_argv and real_argv[0] in UNPORTED:
        print(f"paddle_tpu_torch: subcommand {real_argv[0]!r} is not ported "
              f"(ROADMAP.md Queue A item {UNPORTED[real_argv[0]]}; the port "
              f"has 'train' and 'version')", file=sys.stderr)
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

    args = parser.parse_args(real_argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
