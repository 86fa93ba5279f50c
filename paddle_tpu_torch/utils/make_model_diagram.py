"""paddle.utils.make_model_diagram (reference utils/make_model_diagram
.py), the port of ``paddle_tpu/utils/make_model_diagram.py``: graphviz dot
of a model graph, backed by net_drawer (whose draw_graph/save_graph are
re-exported so the old module-alias surface keeps working)."""

from __future__ import annotations

from ..net_drawer import draw_graph, save_graph  # noqa: F401


def _load_program(path):
    """A saved-model dir or proto file -> Program (the reference tool
    takes a config path)."""
    import os

    from ..framework import proto_io

    model = os.path.join(path, "__model__") if os.path.isdir(path) else path
    with open(model, "rb") as f:
        return proto_io.parse_program(f.read())


def make_diagram(program_or_path=None, out_file=None, **kw):
    """Dot text for a Program (default main program) or a saved-model
    path, optionally written to out_file via net_drawer.save_graph.
    Extra kwargs (block_id, ...) forward to draw_graph."""
    prog = program_or_path
    if isinstance(prog, (str, bytes)):
        prog = _load_program(prog)
    if out_file:
        path = save_graph(out_file, prog, **kw)
        with open(path) as f:
            return f.read()
    return draw_graph(prog, **kw)
