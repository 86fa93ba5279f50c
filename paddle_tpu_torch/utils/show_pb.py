"""Print a serialized model config, the port of
``paddle_tpu/utils/show_pb.py`` (reference python/paddle/utils/
show_pb.py — dumped the ModelConfig protobuf).  Here the interchange
format is the Program protobuf (framework/framework.proto), so this dumps
a `__model__` file or any serialize_program() blob."""

from __future__ import annotations

import sys

__all__ = ["dump_program", "main"]


def dump_program(path_or_bytes, out=None):
    """Human-readable dump: blocks, ops with slot bindings, var metadata."""
    from ..framework import proto_io

    out = out or sys.stdout
    blob = path_or_bytes
    if isinstance(blob, str):
        with open(blob, "rb") as f:
            blob = f.read()
    prog = proto_io.parse_program(blob)
    for block in prog.blocks:
        print(f"block {block.idx} (parent {block.parent_idx}):", file=out)
        for name, v in sorted(block.vars.items()):
            kind = type(v).__name__
            print(f"  var {name} [{kind}] shape={v.shape} "
                  f"dtype={v.dtype}", file=out)
        for op in block.ops:
            ins = {k: v for k, v in op.inputs.items() if v}
            outs = {k: v for k, v in op.outputs.items() if v}
            print(f"  op {op.type} {ins} -> {outs}", file=out)
    return prog


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print("usage: python -m paddle_tpu_torch.utils.show_pb <__model__ file>",
              file=sys.stderr)
        return 1
    dump_program(argv[0])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
