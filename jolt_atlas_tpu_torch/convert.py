"""Carry a model and an SRS across from the reference package as plain
values, so both packages prove the same statement.

Nothing here imports jolt_atlas_tpu: ``describe_model`` reads any Model of
the same structure by duck typing and returns plain Python values and numpy
arrays, and the two builders take only those.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .commitment.kzg import KZGSRS, LazyPoints
from .curve.fq import FQ2
from .curve.points import G2
from .frontend import ops as OPS
from .frontend.graph import ComputationGraph, ComputationNode, Model


def describe_model(model) -> dict:
    """Model (of either package) -> nodes, operator parameters and numpy
    constant tensors as plain values."""
    g = model.graph
    nodes = []
    for node in g.sorted_nodes():
        op = node.operator
        entry = {"idx": node.idx, "op": type(op).__name__,
                 "inputs": list(node.inputs),
                 "output_dims": tuple(node.output_dims)}
        if entry["op"] == "Constant":
            entry["array"] = np.array(op.array, dtype=np.int32)
        else:
            entry["params"] = {f.name: getattr(op, f.name)
                               for f in dataclasses.fields(op)}
        nodes.append(entry)
    return {"nodes": nodes, "inputs": list(g.inputs),
            "outputs": list(g.outputs), "scale": model.scale,
            "original_input_dims": [tuple(d) for d in g.original_input_dims],
            "original_output_dims": [tuple(d)
                                     for d in g.original_output_dims]}


def model_from_reference(desc: dict) -> Model:
    """Rebuild a ``describe_model`` description with the port's classes."""
    nodes = {}
    for e in desc["nodes"]:
        if e["op"] == "Constant":
            op = OPS.Constant.from_array(e["array"])
        else:
            op = getattr(OPS, e["op"])(**e["params"])
        nodes[e["idx"]] = ComputationNode(e["idx"], op, list(e["inputs"]),
                                          tuple(e["output_dims"]))
    graph = ComputationGraph(
        nodes=nodes, inputs=list(desc["inputs"]),
        outputs=list(desc["outputs"]),
        original_input_dims=list(desc["original_input_dims"]),
        original_output_dims=list(desc["original_output_dims"]))
    return Model(graph, scale=desc["scale"])


def _g2(coords) -> G2:
    """(x.a, x.b, y.a, y.b) ints -> G2 (None -> identity)."""
    if coords is None:
        return G2.identity()
    xa, xb, ya, yb = (int(v) for v in coords)
    return G2(FQ2(xa, xb), FQ2(ya, yb))


def srs_from_arrays(g1_limbs: np.ndarray, g2, beta_g2,
                    g2_powers=None) -> KZGSRS:
    """KZG SRS from the G1 powers as an (n, 8) u64 array (canonical affine
    x then y, 4 little-endian limbs each; all zero = infinity) and the G2
    points as (x.a, x.b, y.a, y.b) int tuples."""
    raw = np.ascontiguousarray(g1_limbs, dtype=np.uint64).tobytes()
    return KZGSRS(LazyPoints(raw), _g2(g2), _g2(beta_g2), raw_points=raw,
                  g2_powers=None if g2_powers is None
                  else [_g2(p) for p in g2_powers])
