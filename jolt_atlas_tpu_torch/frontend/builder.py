"""ModelBuilder: programmatic graph construction DSL.

Reference: atlas-onnx-tracer/src/model/test.rs:28-513. Every op method
allocates a node, wires inputs, and returns the node index ("wire").
Used by every per-op unit test and small-model fixture.
"""

from __future__ import annotations

import numpy as np

from ..config import DEFAULT_SCALE
from . import ops as OPS
from .graph import ComputationGraph, ComputationNode, Model


class ModelBuilder:
    def __init__(self, scale: int = DEFAULT_SCALE):
        self.nodes: dict[int, ComputationNode] = {}
        self.inputs: list[int] = []
        self.outputs: list[int] = []
        self.next_id = 0
        self.scale = scale

    # -- plumbing ----------------------------------------------------------
    def _alloc(self) -> int:
        i = self.next_id
        self.next_id += 1
        return i

    def _insert(self, op: OPS.Op, inputs: list[int], dims) -> int:
        idx = self._alloc()
        self.nodes[idx] = ComputationNode(idx, op, list(inputs), tuple(dims))
        return idx

    def dims(self, wire: int) -> tuple:
        return tuple(self.nodes[wire].output_dims)

    # -- sources -----------------------------------------------------------
    def input(self, dims) -> int:
        idx = self._insert(OPS.Input(), [], dims)
        self.inputs.append(idx)
        return idx

    def constant(self, tensor) -> int:
        arr = np.asarray(tensor, dtype=np.int32)
        return self._insert(OPS.Constant.from_array(arr), [], arr.shape)

    # -- elementwise -------------------------------------------------------
    def identity(self, a) -> int:
        return self._insert(OPS.Identity(), [a], self.dims(a))

    def relu(self, a) -> int:
        return self._insert(OPS.ReLU(), [a], self.dims(a))

    def neg(self, a) -> int:
        return self._insert(OPS.Neg(), [a], self.dims(a))

    def add(self, a, b) -> int:
        return self._insert(OPS.Add(), [a, b], self.dims(a))

    def sub(self, a, b) -> int:
        return self._insert(OPS.Sub(), [a, b], self.dims(a))

    def mul(self, a, b, scale=None) -> int:
        s = self.scale if scale is None else scale
        return self._insert(OPS.Mul(scale=s), [a, b], self.dims(a))

    def square(self, a, scale=None) -> int:
        s = self.scale if scale is None else scale
        return self._insert(OPS.Square(scale=s), [a], self.dims(a))

    def cube(self, a, scale=None) -> int:
        s = self.scale if scale is None else scale
        return self._insert(OPS.Cube(scale=s), [a], self.dims(a))

    def div(self, a, b, scale: int | None = None) -> int:
        s = self.scale if scale is None else scale
        return self._insert(OPS.Div(scale=s), [a, b], self.dims(a))

    def scalar_const_div(self, a, divisor: int) -> int:
        return self._insert(OPS.ScalarConstDiv(divisor=divisor), [a], self.dims(a))

    def iff(self, mask, a, b) -> int:
        return self._insert(OPS.Iff(), [mask, a, b], self.dims(a))

    def and_(self, a, b) -> int:
        return self._insert(OPS.And(), [a, b], self.dims(a))

    # -- activations -------------------------------------------------------
    def _teleport_tau(self, s: int) -> int:
        # tau = 2 at the reference scale 8, scaling with 2^scale
        # (reference handlers/activation.rs:17-41)
        assert s >= 8, "neural-teleport activations require scale >= 8"
        return 2 << (s - 8)

    def sigmoid(self, a, scale=None, tau=None, log_table=16) -> int:
        s = self.scale if scale is None else scale
        t = self._teleport_tau(s) if tau is None else tau
        return self._insert(OPS.Sigmoid(scale=s, tau=t, log_table=log_table),
                            [a], self.dims(a))

    def tanh(self, a, scale=None, tau=None, log_table=16) -> int:
        s = self.scale if scale is None else scale
        t = self._teleport_tau(s) if tau is None else tau
        return self._insert(OPS.Tanh(scale=s, tau=t, log_table=log_table),
                            [a], self.dims(a))

    def erf(self, a, scale=None, tau=None, log_table=16) -> int:
        s = self.scale if scale is None else scale
        t = self._teleport_tau(s) if tau is None else tau
        return self._insert(OPS.Erf(scale=s, tau=t, log_table=log_table),
                            [a], self.dims(a))

    def sin(self, a, scale=8) -> int:
        return self._insert(OPS.Sin(scale=scale), [a], self.dims(a))

    def cos(self, a, scale=8) -> int:
        return self._insert(OPS.Cos(scale=scale), [a], self.dims(a))

    def rsqrt(self, a, scale=None) -> int:
        s = self.scale if scale is None else scale
        return self._insert(OPS.Rsqrt(scale=s), [a], self.dims(a))

    def softmax_last_axis(self, a, scale=None) -> int:
        s = self.scale if scale is None else scale
        return self._insert(OPS.SoftmaxLastAxis(scale=s), [a], self.dims(a))

    def clamp(self, a, axes: int, max_spread: int) -> int:
        return self._insert(OPS.Clamp(axes=axes, max_spread=max_spread),
                            [a], self.dims(a))

    # -- structure ---------------------------------------------------------
    def einsum(self, equation: str, operands: list[int], scale=None) -> int:
        s = self.scale if scale is None else scale
        for w in operands:
            for d in self.dims(w):
                if d & (d - 1):
                    raise ValueError(
                        f"einsum operand dims {self.dims(w)} must all be "
                        "powers of two — zero-pad the tensor (the ONNX "
                        "loader does this automatically; with ModelBuilder "
                        "pad constants/inputs yourself)")
        out_dims = _einsum_output_dims(equation, [self.dims(w) for w in operands])
        return self._insert(OPS.Einsum(equation=equation, scale=s), operands, out_dims)

    def matmul(self, a, b, scale=None) -> int:
        return self.einsum("mk,kn->mn", [a, b], scale)

    def reshape(self, a, shape) -> int:
        return self._insert(OPS.Reshape(shape=tuple(shape)), [a], shape)

    def broadcast(self, a, shape) -> int:
        return self._insert(OPS.Broadcast(shape=tuple(shape)), [a], shape)

    def move_axis(self, a, source: int, destination: int) -> int:
        dims = list(self.dims(a))
        d = dims.pop(source)
        dims.insert(destination, d)
        return self._insert(OPS.MoveAxis(source=source, destination=destination),
                            [a], dims)

    def concat(self, operands: list[int], axis: int) -> int:
        dims = list(self.dims(operands[0]))
        ax = axis if axis >= 0 else axis + len(dims)
        dims[ax] = sum(self.dims(w)[ax] for w in operands)
        return self._insert(OPS.Concat(axis=axis), operands, dims)

    def slice(self, a, axis: int, start: int, end: int) -> int:
        dims = list(self.dims(a))
        dims[axis] = end - start
        return self._insert(OPS.Slice(axis=axis, start=start, end=end), [a], dims)

    def gather(self, dict_wire, indices_wire, axis: int = 0) -> int:
        ddims = self.dims(dict_wire)
        dict_len = ddims[0]
        vp = 1
        while vp < dict_len:
            vp *= 2
        if vp != dict_len:
            # the one-hot read-address protocol needs a pow2 dictionary
            # height; zero-pad constants (reference pads via RunArgs, same
            # as our ONNX loader, atlas-onnx-tracer/src/graph/mod.rs padding)
            node = self.nodes[dict_wire]
            if not isinstance(node.operator, OPS.Constant):
                raise ValueError(
                    f"gather dictionary height {dict_len} must be a power of "
                    "two (non-constant dictionaries are not auto-padded)")
            arr = node.operator.array
            padded = np.zeros((vp,) + arr.shape[1:], dtype=arr.dtype)
            padded[:dict_len] = arr
            dict_wire = self.constant(padded)
            ddims = self.dims(dict_wire)
            dict_len = vp
        idims = self.dims(indices_wire)
        out_dims = tuple(idims) + tuple(ddims[1:])
        from ..config import GATHER_SMALL_MAX
        op_cls = (OPS.GatherSmall if dict_len <= GATHER_SMALL_MAX
                  else OPS.GatherLarge)
        return self._insert(op_cls(axis=axis, dict_len=dict_len),
                            [dict_wire, indices_wire], out_dims)

    def sum(self, a, axes) -> int:
        dims = list(self.dims(a))
        for ax in axes:
            dims[ax] = 1
        return self._insert(OPS.Sum(axes=tuple(axes)), [a], dims)

    def mean_of_squares(self, a, axes, scale=None) -> int:
        s = self.scale if scale is None else scale
        dims = list(self.dims(a))
        count = 1
        for ax in axes:
            count *= dims[ax]
            dims[ax] = 1
        return self._insert(
            OPS.MeanOfSquares(axes=tuple(axes), scale=s, count=count,
                              padded_count=count),
            [a], dims)

    # -- finalize ----------------------------------------------------------
    def output(self, wire: int) -> None:
        self.outputs.append(wire)

    def build(self) -> Model:
        graph = ComputationGraph(
            nodes=dict(self.nodes),
            inputs=list(self.inputs),
            outputs=list(self.outputs),
            original_input_dims=[tuple(self.nodes[i].output_dims) for i in self.inputs],
            original_output_dims=[tuple(self.nodes[i].output_dims) for i in self.outputs],
        )
        return Model(graph, scale=self.scale)


def _einsum_output_dims(equation: str, in_dims: list[tuple]) -> tuple:
    lhs, rhs = equation.replace(" ", "").split("->")
    terms = lhs.split(",")
    sizes: dict[str, int] = {}
    for term, dims in zip(terms, in_dims):
        assert len(term) == len(dims), f"einsum {equation}: rank mismatch"
        for ch, d in zip(term, dims):
            if ch in sizes:
                assert sizes[ch] == d, f"einsum {equation}: dim mismatch for {ch}"
            else:
                sizes[ch] = d
    return tuple(sizes[ch] for ch in rhs)
