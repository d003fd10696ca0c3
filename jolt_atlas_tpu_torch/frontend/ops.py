"""The 33 quantized graph operators.

Reference: atlas-onnx-tracer/src/ops/ (Operator enum, ops/mod.rs:121-157).
Each operator implements `f(inputs: list[np.int32 array]) -> np.int32 array`
with the exact fused i64-accumulate / Euclidean-floor-rebase / saturate
semantics of the reference (ops/mod.rs:187-311), plus the re-execution
helpers the proof layer uses to recover pre-clamp intermediates and
remainders without storing them in the trace.

Tensors are plain numpy int32 arrays; i64 accumulations use numpy int64
(exact for all reachable magnitudes).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from . import nonlinearities as nl
from .quantize import scale_to_multiplier

I32_MAX = 2**31 - 1
I32_MIN = -(2**31)
FOUR_PI_APPROX = 3217  # model/mod.rs:499 (4*pi at scale 8)


# ---------------------------------------------------------------------------
# shared fused-rescale kernels (ops/mod.rs:187-311)
# ---------------------------------------------------------------------------

def clamp_to_i32(t: np.ndarray) -> np.ndarray:
    return np.clip(t, I32_MIN, I32_MAX).astype(np.int32)


def floor_rebase_i64(acc: np.ndarray, bits: int) -> np.ndarray:
    """Euclidean floor-divide i64 accumulation by 2^bits (pre-clamp)."""
    return np.floor_divide(acc, np.int64(1) << np.int64(bits))


def rebase_remainder_i32(acc: np.ndarray, bits: int) -> np.ndarray:
    """R = acc mod 2^bits in [0, 2^bits)."""
    return np.mod(acc, np.int64(1) << np.int64(bits)).astype(np.int32)


def floor_rebase_clamp_i32(acc: np.ndarray, bits: int) -> np.ndarray:
    return clamp_to_i32(floor_rebase_i64(acc, bits))


def sat_accumulate_pair(lhs: np.ndarray, rhs: np.ndarray, combine) -> np.ndarray:
    """Broadcast, combine in i64 — the pre-saturation intermediate."""
    return combine(lhs.astype(np.int64), rhs.astype(np.int64))


def sat_binop(inputs, combine) -> np.ndarray:
    out = inputs[0]
    for rhs in inputs[1:]:
        out = clamp_to_i32(sat_accumulate_pair(out, rhs, combine))
    return out


def einsum_acc_i64(equation: str, inputs) -> np.ndarray:
    """Raw i64 einsum accumulation (exact).

    Guarded against silent i64 wraparound: the reference compiles with
    overflow-checks even in release (Cargo.toml:112) because integer
    overflow is a soundness bug class; numpy wraps silently, so we bound
    |acc| <= K * max|a| * max|b| < 2^62 up front and fail loudly.
    """
    arrs = [np.asarray(x, dtype=np.int64) for x in inputs]
    if len(arrs) == 2:
        # conservative: |acc| <= max|a| * max|b| * (largest operand size)
        bound = (int(np.abs(arrs[0]).max(initial=0))
                 * int(np.abs(arrs[1]).max(initial=0))
                 * max(a.size for a in arrs))
        if bound >= 1 << 62:
            raise OverflowError(
                "einsum i64 accumulation may overflow (operand magnitudes "
                "too large for the quantization contract)")
    return np.einsum(equation, *arrs, dtype=np.int64)


# ---------------------------------------------------------------------------
# operator definitions
# ---------------------------------------------------------------------------

class Op:
    """Base operator; subclasses define f()."""

    def f(self, inputs: list[np.ndarray]) -> np.ndarray:
        raise NotImplementedError

    def requires_shape_equality(self) -> bool:
        return False

    @property
    def name(self) -> str:
        return type(self).__name__


@dataclass(frozen=True)
class Add(Op):
    def f(self, inputs):
        return sat_binop(inputs, lambda a, b: a + b)

    def requires_shape_equality(self):
        return True


@dataclass(frozen=True)
class Sub(Op):
    def f(self, inputs):
        return sat_binop(inputs, lambda a, b: a - b)

    def requires_shape_equality(self):
        return True


@dataclass(frozen=True)
class Broadcast(Op):
    shape: tuple

    def f(self, inputs):
        return np.ascontiguousarray(
            np.broadcast_to(inputs[0], tuple(self.shape))
        ).astype(np.int32)


@dataclass(frozen=True)
class And(Op):
    def f(self, inputs):
        return ((inputs[0] != 0) & (inputs[1] != 0)).astype(np.int32)

    def requires_shape_equality(self):
        return True


@dataclass(frozen=True)
class Clamp(Op):
    axes: int
    max_spread: int

    def f(self, inputs):
        return nl.clamp_axes(inputs[0], self.axes, self.max_spread)


@dataclass(frozen=True)
class Concat(Op):
    axis: int

    def f(self, inputs):
        rank = inputs[0].ndim
        axis = self.axis if self.axis >= 0 else self.axis + rank
        return np.concatenate(inputs, axis=axis).astype(np.int32)


@dataclass(frozen=True)
class Constant(Op):
    value: tuple  # flattened data, kept hashable
    dims: tuple

    @classmethod
    def from_array(cls, arr: np.ndarray) -> "Constant":
        arr = np.asarray(arr, dtype=np.int32)
        return cls(value=tuple(int(x) for x in arr.ravel()), dims=tuple(arr.shape))

    @property
    def array(self) -> np.ndarray:
        # cached: rebuilding from the hashable int tuple costs ~120 ms at
        # vocab scale (2^26 entries) and the verifier touches constants
        # once per consumer claim
        a = getattr(self, "_arr_cache", None)
        if a is None:
            a = np.array(self.value, dtype=np.int32).reshape(self.dims)
            object.__setattr__(self, "_arr_cache", a)
        return a

    def f(self, inputs):
        return self.array


@dataclass(frozen=True)
class Cos(Op):
    scale: int

    def f(self, inputs):
        rem = nl.const_rem(inputs[0], FOUR_PI_APPROX)
        return nl.cos(rem, scale_to_multiplier(self.scale))


@dataclass(frozen=True)
class Sin(Op):
    scale: int

    def f(self, inputs):
        rem = nl.const_rem(inputs[0], FOUR_PI_APPROX)
        return nl.sin(rem, scale_to_multiplier(self.scale))


@dataclass(frozen=True)
class Cube(Op):
    scale: int

    def rebase_bits(self) -> int:
        return 2 * self.scale

    def f(self, inputs):
        a = inputs[0].astype(np.int64)
        if a.size and int(np.abs(a).max()) >= 1 << 21:
            # |a|^3 wraps i64 beyond 2^63 (and the 48-bit satclamp chunk
            # range far earlier) — fail loudly instead of silently wrapping
            raise OverflowError("Cube operand exceeds the i64 cube contract "
                                "(|x| must be < 2^21)")
        if self.scale == 0:
            return (a ** 3).astype(np.int32)
        return floor_rebase_clamp_i32(a * a * a, self.rebase_bits())


@dataclass(frozen=True)
class Div(Op):
    # fixed-point requantizing division: out_hat = floor(a_hat * 2^scale
    # / b_hat), i.e. real out = a / b at the model scale (the reference's
    # requantizing nonlinearities::div kernel, tensor/ops.rs). scale=0
    # gives plain integer division of the raw values.
    scale: int = 0

    def f(self, inputs):
        a = inputs[0].astype(np.int64) << np.int64(self.scale)
        b = inputs[1].astype(np.int64)
        q = np.floor_divide(a, b)
        assert (np.abs(q) < (1 << 31)).all(), \
            "Div quotient exceeds i32 (divisor too small for the scale)"
        return q.astype(np.int32)

    def requires_shape_equality(self):
        return True


@dataclass(frozen=True)
class Einsum(Op):
    equation: str
    scale: int

    def f(self, inputs):
        acc = einsum_acc_i64(self.equation, inputs)
        return clamp_to_i32(floor_rebase_i64(acc, self.scale))

    def intermediate_and_remainder(self, inputs):
        acc = einsum_acc_i64(self.equation, inputs)
        return (floor_rebase_i64(acc, self.scale),
                rebase_remainder_i32(acc, self.scale))


@dataclass(frozen=True)
class Erf(Op):
    scale: int
    tau: int
    log_table: int

    def f(self, inputs):
        x = nl.const_div(inputs[0], float(self.tau))
        tele = (x.astype(np.int64) * self.tau).astype(np.int32)
        return nl.erffunc(tele, scale_to_multiplier(self.scale))


@dataclass(frozen=True)
class GatherSmall(Op):
    axis: int
    dict_len: int

    def f(self, inputs):
        assert self.axis == 0
        data, idx = inputs
        return np.take(data, idx.astype(np.int64), axis=0).astype(np.int32)


@dataclass(frozen=True)
class GatherLarge(Op):
    axis: int
    dict_len: int

    def f(self, inputs):
        assert self.axis == 0
        data, idx = inputs
        return np.take(data, idx.astype(np.int64), axis=0).astype(np.int32)


@dataclass(frozen=True)
class Identity(Op):
    def f(self, inputs):
        return inputs[0]


@dataclass(frozen=True)
class Iff(Op):
    def f(self, inputs):
        mask, a, b = inputs
        return np.where(mask != 0, a, b).astype(np.int32)

    def requires_shape_equality(self):
        return True


@dataclass(frozen=True)
class Input(Op):
    def f(self, inputs):
        raise RuntimeError("Input nodes are fed externally")


@dataclass(frozen=True)
class IsNan(Op):
    out_dims: tuple

    def f(self, inputs):
        return np.zeros(tuple(self.out_dims), dtype=np.int32)


@dataclass(frozen=True)
class MeanOfSquares(Op):
    axes: tuple
    scale: int
    count: int
    padded_count: int

    def divisor(self) -> int:
        return (1 << self.scale) * self.count

    def acc_i64(self, x: np.ndarray) -> np.ndarray:
        a = x.astype(np.int64)
        return np.sum(a * a, axis=tuple(self.axes), keepdims=True)

    def intermediate_and_remainder(self, x):
        acc = self.acc_i64(x)
        d = self.divisor()
        return np.floor_divide(acc, d), np.mod(acc, d).astype(np.int32)

    def f(self, inputs):
        q, _ = self.intermediate_and_remainder(inputs[0])
        return clamp_to_i32(q)


@dataclass(frozen=True)
class MoveAxis(Op):
    source: int
    destination: int

    def f(self, inputs):
        return np.ascontiguousarray(
            np.moveaxis(inputs[0], self.source, self.destination)
        ).astype(np.int32)


@dataclass(frozen=True)
class Mul(Op):
    scale: int

    def f(self, inputs):
        if self.scale == 0:
            out = inputs[0].astype(np.int64)
            for x in inputs[1:]:
                out = out * x.astype(np.int64)
            return out.astype(np.int32)  # raw product path (pre-divided operand)
        acc = inputs[0].astype(np.int64)
        for x in inputs[1:]:
            acc = acc * x.astype(np.int64)
        return floor_rebase_clamp_i32(acc, self.scale)

    def intermediate_and_remainder(self, inputs):
        acc = inputs[0].astype(np.int64)
        for x in inputs[1:]:
            acc = acc * x.astype(np.int64)
        return (floor_rebase_i64(acc, self.scale),
                rebase_remainder_i32(acc, self.scale))

    def requires_shape_equality(self):
        return True


@dataclass(frozen=True)
class Neg(Op):
    def f(self, inputs):
        return (-inputs[0].astype(np.int64)).astype(np.int32)


@dataclass(frozen=True)
class ReLU(Op):
    def f(self, inputs):
        return nl.leakyrelu(inputs[0], 0.0)


@dataclass(frozen=True)
class Reshape(Op):
    shape: tuple

    def f(self, inputs):
        return inputs[0].reshape(tuple(self.shape))


@dataclass(frozen=True)
class Rsqrt(Op):
    scale: int

    def f(self, inputs):
        return nl.rsqrt(inputs[0], self.scale)


@dataclass(frozen=True)
class ScalarConstDiv(Op):
    divisor: int

    def f(self, inputs):
        return np.floor_divide(inputs[0].astype(np.int64), self.divisor).astype(np.int32)

    def adjusted_remainder(self, x):
        return np.mod(x.astype(np.int64), self.divisor).astype(np.int32)


@dataclass(frozen=True)
class Sigmoid(Op):
    scale: int
    tau: int
    log_table: int

    def f(self, inputs):
        x = nl.const_div(inputs[0], float(self.tau))
        tele = (x.astype(np.int64) * self.tau).astype(np.int32)
        return nl.sigmoid(tele, scale_to_multiplier(self.scale))


@dataclass(frozen=True)
class Slice(Op):
    axis: int
    start: int
    end: int

    def f(self, inputs):
        data = inputs[0]
        sl = [slice(None)] * data.ndim
        sl[self.axis] = slice(self.start, self.end)
        return np.ascontiguousarray(data[tuple(sl)]).astype(np.int32)


@dataclass(frozen=True)
class SoftmaxLastAxis(Op):
    scale: int

    def f(self, inputs):
        from .softmax import softmax_last_axis_decomposed
        out, _ = softmax_last_axis_decomposed(inputs[0], int(scale_to_multiplier(self.scale)))
        return out

    def requires_shape_equality(self):
        return True


@dataclass(frozen=True)
class Square(Op):
    scale: int

    def f(self, inputs):
        if self.scale == 0:
            return (inputs[0].astype(np.int64) ** 2).astype(np.int32)
        a = inputs[0].astype(np.int64)
        return floor_rebase_clamp_i32(a * a, self.scale)

    def intermediate_and_remainder(self, inputs):
        a = inputs[0].astype(np.int64)
        return (floor_rebase_i64(a * a, self.scale),
                rebase_remainder_i32(a * a, self.scale))


@dataclass(frozen=True)
class Sum(Op):
    axes: tuple

    def acc_i64(self, x):
        return np.sum(x.astype(np.int64), axis=tuple(self.axes), keepdims=True)

    def f(self, inputs):
        return clamp_to_i32(self.acc_i64(inputs[0]))


@dataclass(frozen=True)
class Tanh(Op):
    scale: int
    tau: int
    log_table: int

    def f(self, inputs):
        lower = -(1 << (self.log_table - 1))
        upper = (1 << (self.log_table - 1)) - 1
        x = nl.const_div(inputs[0], float(self.tau))
        tele = (x.astype(np.int64) * self.tau).astype(np.int32)
        clamped = np.clip(tele, lower, upper).astype(np.int32)
        return nl.tanh(clamped, scale_to_multiplier(self.scale))


ALL_OPERATORS = [
    Add, Broadcast, And, Clamp, Concat, Constant, Cos, Cube, Div, Einsum,
    Erf, GatherSmall, GatherLarge, Identity, Iff, Input, IsNan,
    MeanOfSquares, MoveAxis, Mul, Neg, ReLU, Reshape, Rsqrt, ScalarConstDiv,
    Sigmoid, Sin, Slice, SoftmaxLastAxis, Square, Sub, Sum, Tanh,
]
