"""paddle.utils.dump_config (reference utils/dump_config.py), the port of
``paddle_tpu/utils/dump_config.py``: the text dump of a saved model, the
one implementation behind this module and `paddle dump_config`."""

from __future__ import annotations

import json
import os
import sys


def dump_config(path, out=None):
    """Text dump of a saved model: a dir with ``__model__`` or a raw proto
    file (the desc library's ``text_dump``, protobuf's C++ DebugString;
    the JAX package falls back to Python's text format when its library
    is missing, the port has no fallback), or a dir saved with
    ``program.json`` only.

    out: None prints to stdout; a path writes the file.  The text is
    always returned."""
    model = os.path.join(path, "__model__") if os.path.isdir(path) else path
    if os.path.exists(model):
        with open(model, "rb") as f:
            data = f.read()
        from ..native import program_desc

        txt = program_desc.text_dump(data)
    elif os.path.isdir(path) and os.path.exists(
            os.path.join(path, "program.json")):
        with open(os.path.join(path, "program.json")) as f:
            txt = json.dumps(json.load(f), indent=1)
    else:
        raise FileNotFoundError(
            f"no __model__ or program.json under {path!r}")
    if out is None:
        sys.stdout.write(txt)
    else:
        with open(out, "w") as f:
            f.write(txt)
    return txt
