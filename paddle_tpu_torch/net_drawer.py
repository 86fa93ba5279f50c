"""Program graph visualization, the port of ``paddle_tpu/net_drawer.py``
(reference fluid/net_drawer.py + v2/plot/graphviz): a Graphviz dot
description of one block's ops and variables.  Pure text; rendering is
the user's ``dot`` call."""

from __future__ import annotations

from typing import Optional

from .framework.core import Program, default_main_program


def _esc(s: str) -> str:
    return s.replace('"', '\\"')


def draw_graph(program: Optional[Program] = None, block_id: int = 0,
               title: str = "program") -> str:
    """Return a dot-language digraph for one block: op nodes (boxes) wired
    through their input/output variable nodes (ellipses)."""
    program = program or default_main_program()
    block = program.blocks[block_id]
    lines = [f'digraph "{_esc(title)}" {{', "  rankdir=TB;"]
    var_nodes = set()

    def var_node(name):
        vid = f'var_{_esc(name)}'
        if name not in var_nodes:
            var_nodes.add(name)
            v = block._find_var_recursive(name)
            shape = getattr(v, "shape", None) if v is not None else None
            label = _esc(name if shape is None else f"{name}\\n{list(shape)}")
            style = "style=filled,fillcolor=lightgrey" if (
                v is not None and getattr(v, "persistable", False)) else ""
            lines.append(f'  "{vid}" [label="{label}",shape=ellipse,{style}];')
        return vid

    for i, op in enumerate(block.ops):
        oid = f"op_{i}"
        lines.append(
            f'  "{oid}" [label="{_esc(op.type)}",shape=box,'
            f'style=filled,fillcolor=lightblue];')
        for names in op.inputs.values():
            for n in names:
                if n:
                    lines.append(f'  "{var_node(n)}" -> "{oid}";')
        for names in op.outputs.values():
            for n in names:
                if n:
                    lines.append(f'  "{oid}" -> "{var_node(n)}";')
    lines.append("}")
    return "\n".join(lines)


def save_graph(path: str, program: Optional[Program] = None,
               block_id: int = 0) -> str:
    dot = draw_graph(program, block_id)
    with open(path, "w") as f:
        f.write(dot)
    return path
