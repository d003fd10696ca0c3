"""Computation graph, executor, and trace.

Reference: atlas-onnx-tracer/src/model/{mod,execute,trace}.rs. The graph is
an idx-ordered map of ComputationNodes (idx order IS topological order); the
executor walks nodes in order calling each operator's quantized kernel; the
trace captures every node's output tensor — the witness source for the proof
system (model/trace.rs:11-110).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from . import ops as OPS


@dataclass
class ComputationNode:
    idx: int
    operator: OPS.Op
    inputs: list[int]
    output_dims: tuple

    @property
    def num_output_elements(self) -> int:
        n = 1
        for d in self.output_dims:
            n *= d
        return n

    def padded_output_len(self) -> int:
        return _next_pow2(self.num_output_elements)


def _next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


@dataclass
class ComputationGraph:
    nodes: dict[int, ComputationNode] = field(default_factory=dict)
    inputs: list[int] = field(default_factory=list)
    outputs: list[int] = field(default_factory=list)
    original_input_dims: list[tuple] = field(default_factory=list)
    original_output_dims: list[tuple] = field(default_factory=list)

    def sorted_nodes(self) -> list[ComputationNode]:
        return [self.nodes[i] for i in sorted(self.nodes)]

    def max_T(self) -> int:
        """Largest padded node-output length (drives SRS sizing)."""
        return max(n.padded_output_len() for n in self.nodes.values())

    def max_num_vars(self) -> int:
        return max(self.node_committed_poly_num_vars(n) for n in self.nodes.values())

    def node_committed_poly_num_vars(self, node: ComputationNode) -> int:
        """Upper bound on log2-size of the largest committed polynomial for a
        node (reference model/mod.rs:263-328). Default: the one-hot RaD
        polynomials have K_CHUNK * T coefficients. Inputs/constants commit
        nothing (they are public), so giant embedding tables do not inflate
        the SRS; GatherSmall commits the (V, T_idx) one-hot, GatherLarge only
        4-bit chunks."""
        from ..config import LOG_K_CHUNK
        from . import ops as OPS
        op = node.operator
        if isinstance(op, (OPS.Input, OPS.Constant)):
            return 0
        if isinstance(op, (OPS.GatherSmall, OPS.GatherLarge)):
            t_idx = (self.nodes[node.inputs[1]].padded_output_len()
                     .bit_length() - 1)
            if isinstance(op, OPS.GatherSmall):
                V = self.nodes[node.inputs[0]].output_dims[0]
                return max(1, V - 1).bit_length() + t_idx
            return LOG_K_CHUNK + t_idx
        t_vars = node.padded_output_len().bit_length() - 1
        return t_vars + LOG_K_CHUNK


class Trace:
    """All per-node output tensors from one forward execution."""

    def __init__(self, node_outputs: dict[int, np.ndarray], graph: "ComputationGraph"):
        self.node_outputs = node_outputs
        self.graph = graph

    def output(self, idx: int) -> np.ndarray:
        return self.node_outputs[idx]

    def model_outputs(self) -> list[np.ndarray]:
        return [self.node_outputs[i] for i in self.graph.outputs]


class Model:
    """A loaded (or built) quantized model: graph + scale metadata."""

    def __init__(self, graph: ComputationGraph, scale: int = 8):
        self.graph = graph
        self.scale = scale

    def execute_graph(self, inputs: list[np.ndarray]) -> dict[int, np.ndarray]:
        node_outputs: dict[int, np.ndarray] = {}
        for inp_idx, tensor in zip(self.graph.inputs, inputs):
            want = tuple(self.graph.nodes[inp_idx].output_dims)
            t = np.asarray(tensor, dtype=np.int32)
            if tuple(t.shape) != want:
                t = _pad_to_dims(t, want)
            node_outputs[inp_idx] = t
        for node in self.graph.sorted_nodes():
            if isinstance(node.operator, OPS.Input):
                continue
            ins = [node_outputs[i] for i in node.inputs]
            out = node.operator.f(ins)
            assert tuple(out.shape) == tuple(node.output_dims), (
                f"node {node.idx} {node.operator.name}: produced {out.shape}, "
                f"declared {node.output_dims}"
            )
            node_outputs[node.idx] = out
        return node_outputs

    def forward(self, inputs: list[np.ndarray]) -> list[np.ndarray]:
        outs = self.execute_graph(inputs)
        result = []
        for k, idx in enumerate(self.graph.outputs):
            t = outs[idx]
            if k < len(self.graph.original_output_dims):
                orig = tuple(self.graph.original_output_dims[k])
                if orig and orig != tuple(t.shape):
                    t = _crop_to_dims(t, orig)
            result.append(t)
        return result

    def trace(self, inputs: list[np.ndarray]) -> Trace:
        return Trace(self.execute_graph(inputs), self.graph)


def _pad_to_dims(t: np.ndarray, dims: tuple) -> np.ndarray:
    pad = [(0, want - have) for have, want in zip(t.shape, dims)]
    return np.pad(t, pad, mode="constant")


def _crop_to_dims(t: np.ndarray, dims: tuple) -> np.ndarray:
    slices = tuple(slice(0, d) for d in dims)
    return np.ascontiguousarray(t[slices])
