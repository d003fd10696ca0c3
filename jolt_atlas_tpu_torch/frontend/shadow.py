"""Shadow trace: run the quantized graph in lockstep with an ideal f64 graph.

Reference: atlas-onnx-tracer/src/model/shadow_trace.rs — per-node drift
metrics (cosine similarity, relative MSE, max/mean abs error, RMS) for
quantization debugging.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import ops as OPS
from .graph import Model
from .quantize import dequantize, scale_to_multiplier


@dataclass
class NodeMetrics:
    node_idx: int
    op: str
    cosine_similarity: float
    relative_mse: float
    max_abs_err: float
    mean_abs_err: float
    rms: float


def _f64_node(op, ins, scale):
    S = scale_to_multiplier(scale)
    if isinstance(op, OPS.Add):
        return ins[0] + ins[1]
    if isinstance(op, OPS.Sub):
        return ins[0] - ins[1]
    if isinstance(op, (OPS.Mul,)):
        out = ins[0]
        for x in ins[1:]:
            out = out * x
        return out
    if isinstance(op, OPS.Square):
        return ins[0] ** 2
    if isinstance(op, OPS.Cube):
        return ins[0] ** 3
    if isinstance(op, OPS.Einsum):
        return np.einsum(op.equation, *ins)
    if isinstance(op, OPS.ReLU):
        return np.maximum(ins[0], 0)
    if isinstance(op, OPS.Neg):
        return -ins[0]
    if isinstance(op, OPS.Identity):
        return ins[0]
    if isinstance(op, OPS.Reshape):
        return ins[0].reshape(tuple(op.shape))
    if isinstance(op, OPS.Broadcast):
        return np.broadcast_to(ins[0], tuple(op.shape)).copy()
    if isinstance(op, OPS.MoveAxis):
        return np.moveaxis(ins[0], op.source, op.destination)
    if isinstance(op, OPS.Slice):
        sl = [slice(None)] * ins[0].ndim
        sl[op.axis] = slice(op.start, op.end)
        return ins[0][tuple(sl)]
    if isinstance(op, OPS.Concat):
        ax = op.axis if op.axis >= 0 else op.axis + ins[0].ndim
        return np.concatenate(ins, axis=ax)
    if isinstance(op, (OPS.GatherSmall, OPS.GatherLarge)):
        return np.take(ins[0], ins[1].astype(np.int64), axis=0)
    if isinstance(op, OPS.Sum):
        return np.sum(ins[0], axis=tuple(op.axes), keepdims=True)
    if isinstance(op, OPS.MeanOfSquares):
        return np.mean(ins[0] ** 2, axis=tuple(op.axes), keepdims=True)
    if isinstance(op, OPS.Rsqrt):
        return np.where(ins[0] > 0, 1.0 / np.sqrt(np.maximum(ins[0], 1e-30)), 0.0)
    if isinstance(op, OPS.SoftmaxLastAxis):
        e = np.exp(ins[0] - ins[0].max(axis=-1, keepdims=True))
        return e / e.sum(axis=-1, keepdims=True)
    if isinstance(op, OPS.Tanh):
        return np.tanh(ins[0])
    if isinstance(op, OPS.Sigmoid):
        return 1.0 / (1.0 + np.exp(-ins[0]))
    if isinstance(op, OPS.Erf):
        from .nonlinearities import erf_f64
        return erf_f64(ins[0])
    if isinstance(op, OPS.Sin):
        return np.sin(ins[0])
    if isinstance(op, OPS.Cos):
        return np.cos(ins[0])
    if isinstance(op, OPS.ScalarConstDiv):
        return ins[0] / op.divisor
    if isinstance(op, OPS.Div):
        return ins[0] / ins[1]
    if isinstance(op, OPS.Iff):
        return np.where(ins[0] != 0, ins[1], ins[2])
    raise NotImplementedError(f"shadow: {op.name}")


def f64_forward(model: Model, inputs) -> list[np.ndarray]:
    """Ideal float64 execution of the quantized graph (same topology, real
    arithmetic). Index-typed inputs (gather indices) pass through as-is;
    other int inputs are treated as already-quantized and dequantized.
    Used to validate graph construction independent of quantization."""
    scale = model.scale
    q_outputs = model.execute_graph(inputs)
    f_outputs = {}
    for inp_idx, x in zip(model.graph.inputs, inputs):
        arr = np.asarray(x)
        f_outputs[inp_idx] = (dequantize(arr, scale)
                              if arr.dtype != np.float64 else arr)
    for node in model.graph.sorted_nodes():
        op = node.operator
        if isinstance(op, OPS.Input):
            continue
        if isinstance(op, OPS.Constant):
            f_outputs[node.idx] = dequantize(op.array, scale)
            continue
        if isinstance(op, (OPS.GatherSmall, OPS.GatherLarge)):
            ins = [f_outputs[node.inputs[0]],
                   np.asarray(q_outputs[node.inputs[1]])]
        else:
            ins = [f_outputs[i] for i in node.inputs]
        f_outputs[node.idx] = _f64_node(op, ins, scale)
    return [np.asarray(f_outputs[o], dtype=np.float64)
            for o in model.graph.outputs]


def shadow_trace(model: Model, inputs) -> list[NodeMetrics]:
    """Quantized vs ideal-f64 execution; returns per-node drift metrics."""
    scale = model.scale
    q_outputs = model.execute_graph(inputs)
    f_outputs = {}
    for inp_idx, x in zip(model.graph.inputs, inputs):
        arr = np.asarray(x)
        f_outputs[inp_idx] = (dequantize(arr, scale)
                              if arr.dtype != np.float64 else arr)
    metrics = []
    for node in model.graph.sorted_nodes():
        op = node.operator
        if isinstance(op, OPS.Input):
            continue
        if isinstance(op, OPS.Constant):
            f_outputs[node.idx] = dequantize(op.array, scale)
            continue
        if isinstance(op, (OPS.GatherSmall, OPS.GatherLarge)):
            ins = [f_outputs[node.inputs[0]],
                   np.asarray(q_outputs[node.inputs[1]])]
        else:
            ins = [f_outputs[i] for i in node.inputs]
        f_out = _f64_node(op, ins, scale)
        f_outputs[node.idx] = f_out
        q = dequantize(q_outputs[node.idx], scale).reshape(-1)
        f = np.asarray(f_out, dtype=np.float64).reshape(-1)
        err = q - f
        denom = float(np.linalg.norm(q) * np.linalg.norm(f))
        cos = float(np.dot(q, f) / denom) if denom > 0 else 1.0
        fvar = float(np.mean(f * f))
        metrics.append(NodeMetrics(
            node_idx=node.idx,
            op=op.name,
            cosine_similarity=cos,
            relative_mse=float(np.mean(err * err) / fvar) if fvar > 0 else 0.0,
            max_abs_err=float(np.abs(err).max()) if err.size else 0.0,
            mean_abs_err=float(np.abs(err).mean()) if err.size else 0.0,
            rms=float(np.sqrt(np.mean(err * err))),
        ))
    return metrics


def print_shadow_report(metrics: list[NodeMetrics]) -> str:
    lines = [f"{'node':>5} {'op':<18} {'cos':>8} {'relMSE':>10} "
             f"{'maxerr':>10} {'meanerr':>10}"]
    for m in metrics:
        lines.append(f"{m.node_idx:>5} {m.op:<18} {m.cosine_similarity:>8.4f} "
                     f"{m.relative_mse:>10.2e} {m.max_abs_err:>10.4f} "
                     f"{m.mean_abs_err:>10.4f}")
    return "\n".join(lines)
