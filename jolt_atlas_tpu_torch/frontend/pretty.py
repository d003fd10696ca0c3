"""Tabled computation-graph dump.

Reference: atlas-onnx-tracer/src/utils/pretty_print.rs:80-116 (tabled graph
summary used by `inspect_ops` and example CLIs).
"""

from __future__ import annotations

from .graph import Model
from . import ops as OPS


def format_graph(model: Model) -> str:
    g = model.graph
    rows = []
    for node in g.sorted_nodes():
        op = node.operator
        extra = ""
        if isinstance(op, OPS.Einsum):
            extra = op.equation
        elif isinstance(op, OPS.Constant):
            extra = "const"
        elif isinstance(op, (OPS.GatherSmall, OPS.GatherLarge)):
            extra = f"dict={op.dict_len}"
        elif isinstance(op, OPS.Clamp):
            extra = f"C={op.max_spread}"
        rows.append((node.idx, op.name, node.inputs,
                     "x".join(map(str, node.output_dims)), extra))
    w_in = max((len(str(r[2])) for r in rows), default=6)
    lines = [f"{'idx':>4} {'op':<18} {'inputs':<{w_in}} {'dims':<14} note",
             "-" * (44 + w_in)]
    for idx, name, ins, dims, extra in rows:
        mark = ""
        if idx in g.inputs:
            mark = " (input)"
        if idx in g.outputs:
            mark = " (output)"
        lines.append(f"{idx:>4} {name:<18} {str(ins):<{w_in}} {dims:<14} "
                     f"{extra}{mark}")
    return "\n".join(lines)


def print_graph(model: Model) -> None:
    print(format_graph(model))
