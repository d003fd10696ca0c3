"""Quantized nonlinearity kernels (f64-roundtrip semantics).

Reference: atlas-onnx-tracer/src/tensor/ops.rs `nonlinearities` module.
Every kernel dequantizes by the scale multiplier, applies the f64 function,
re-quantizes with round-half-away-from-zero (Rust f64::round), exactly
matching the reference's table-generation semantics so lookup tables agree
entry-for-entry.
"""

from __future__ import annotations

import numpy as np


def _round_i32(x: np.ndarray) -> np.ndarray:
    """Rust `f64::round` (half away from zero), cast to i32 (values fit)."""
    return np.where(x >= 0, np.floor(x + 0.5), np.ceil(x - 0.5)).astype(np.int64).astype(np.int32)


def sigmoid(a: np.ndarray, s: float) -> np.ndarray:
    k = a.astype(np.float64) / s
    return _round_i32(s / (1.0 + np.exp(-k)))


def tanh(a: np.ndarray, s: float) -> np.ndarray:
    k = a.astype(np.float64) / s
    return _round_i32(s * np.tanh(k))


def sin(a: np.ndarray, s: float) -> np.ndarray:
    k = a.astype(np.float64) / s
    return _round_i32(s * np.sin(k))


def cos(a: np.ndarray, s: float) -> np.ndarray:
    k = a.astype(np.float64) / s
    return _round_i32(s * np.cos(k))


# -- erf via the same 28-coefficient Chebyshev erfc series the reference uses
# (tensor/ops.rs:3717-3800; a Numerical-Recipes-style erfccheb) so quantized
# outputs & lookup tables are entry-for-entry identical.
_ERF_COF = np.array([
    -1.3026537197817094, 6.419_697_923_564_902e-1, 1.9476473204185836e-2,
    -9.561_514_786_808_63e-3, -9.46595344482036e-4, 3.66839497852761e-4,
    4.2523324806907e-5, -2.0278578112534e-5, -1.624290004647e-6,
    1.303655835580e-6, 1.5626441722e-8, -8.5238095915e-8, 6.529054439e-9,
    5.059343495e-9, -9.91364156e-10, -2.27365122e-10, 9.6467911e-11,
    2.394038e-12, -6.886027e-12, 8.94487e-13, 3.13092e-13, -1.12708e-13,
    3.81e-16, 7.106e-15, -1.523e-15, -9.4e-17, 1.21e-16, -2.8e-17,
])


def _erfccheb(z: np.ndarray) -> np.ndarray:
    d = np.zeros_like(z)
    dd = np.zeros_like(z)
    t = 2.0 / (2.0 + z)
    ty = 4.0 * t - 2.0
    for j in range(len(_ERF_COF) - 2, 0, -1):
        tmp = d.copy()
        d = ty * d - dd + _ERF_COF[j]
        dd = tmp
    return t * np.exp(-z * z + 0.5 * (_ERF_COF[0] + ty * d) - dd)


def erf_f64(x: np.ndarray) -> np.ndarray:
    pos = 1.0 - _erfccheb(np.maximum(x, 0.0))
    neg = _erfccheb(np.maximum(-x, 0.0)) - 1.0
    return np.where(x >= 0, pos, neg)


def erffunc(a: np.ndarray, s: float) -> np.ndarray:
    k = a.astype(np.float64) / s
    return _round_i32(s * erf_f64(k))


def leakyrelu(a: np.ndarray, slope: float = 0.0) -> np.ndarray:
    pos = a.astype(np.float64)
    neg = slope * a.astype(np.float64)
    return _round_i32(np.where(a < 0, neg, pos))


def relu(a: np.ndarray) -> np.ndarray:
    return np.maximum(a, 0).astype(np.int32)


def const_div(a: np.ndarray, denom: float) -> np.ndarray:
    """Euclidean (floor) division by int(denom) (tensor/ops.rs:3933-3946)."""
    d = int(denom)
    return np.floor_divide(a.astype(np.int64), d).astype(np.int32)


def const_rem(a: np.ndarray, denom: int) -> np.ndarray:
    """Euclidean remainder in [0, denom) for denom > 0 (ops.rs:3963-3972)."""
    return np.mod(a.astype(np.int64), denom).astype(np.int32)


def recip(a: np.ndarray, scale: float) -> np.ndarray:
    denom = 1.0 / (a.astype(np.float64) + np.finfo(np.float64).eps)
    return _round_i32(scale * denom)


def rsqrt(a: np.ndarray, scale: int) -> np.ndarray:
    """out = isqrt(S^3 / x) for x > 0 else 0 (ops/rsqrt.rs)."""
    s_cubed = 1 << (3 * scale)
    a64 = a.astype(np.int64)
    out = np.zeros(a.shape, dtype=np.int32)
    flat_a, flat_o = a64.ravel(), out.ravel()
    for i in range(flat_a.size):
        v = int(flat_a[i])
        if v > 0:
            flat_o[i] = math_isqrt(s_cubed // v)
    return out


def math_isqrt(v: int) -> int:
    import math
    return math.isqrt(v)


def clamp_axes(a: np.ndarray, axis: int, max_spread: int) -> np.ndarray:
    """Clamp each last-axis slice to [max - max_spread, ...] (ops.rs:3222).

    For rank-1 tensors the whole tensor is one slice; for rank>1 the max is
    taken along the last axis per leading coordinate (the reference iterates
    the cartesian product of all leading dims).
    """
    if a.ndim == 1:
        mx = int(a.max()) if a.size else 0
        return np.maximum(a, mx - max_spread).astype(np.int32)
    mx = a.max(axis=-1, keepdims=True)
    return np.maximum(a, mx - max_spread).astype(np.int32)
