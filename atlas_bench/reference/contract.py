"""The quantization contract's integer operations, in plain NumPy.

Written from the contract, not from the program: every value is an int32
at a fixed-point scale of 2^s; a product accumulates exactly in int64, is
floor-divided by 2^s and saturated to int32; a sum saturates; a constant
divisor floors; tanh, rsqrt and softmax are the contract's integer
definitions (below). ``lost`` > 0 is the control's precision: a product
keeps that many fractional bits fewer (its last ``lost`` bits cleared).
The architectures' forwards (``reference/<name>.py``) are built of these.
"""

from __future__ import annotations

import math

import numpy as np

I32_MIN, I32_MAX = -(2 ** 31), 2 ** 31 - 1


def round_half_away(v: np.ndarray) -> np.ndarray:
    return np.where(v >= 0, np.floor(v + 0.5), np.ceil(v - 0.5))


def sat(x: np.ndarray) -> np.ndarray:
    return np.clip(x, I32_MIN, I32_MAX).astype(np.int64)


def add(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return sat(np.asarray(a, dtype=np.int64) + b)


def sub(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return sat(np.asarray(a, dtype=np.int64) - b)


def rescale(acc: np.ndarray, s: int, lost: int = 0) -> np.ndarray:
    """floor(acc / 2^s), saturated; with ``lost`` bits, the result keeps
    only s - lost fractional bits (its last ``lost`` bits cleared)."""
    return sat(np.floor_divide(acc, 1 << (s + lost)) << lost)


def mul(a: np.ndarray, b: np.ndarray, s: int, lost: int = 0):
    """An elementwise product at scale s."""
    return rescale(np.asarray(a, dtype=np.int64) * b, s, lost)


def cube(a: np.ndarray, s: int, lost: int = 0) -> np.ndarray:
    """a^3 at scale s: floor(a^3 / 2^(2s))."""
    a = np.asarray(a, dtype=np.int64)
    if np.abs(a).max(initial=0) >= 1 << 21:
        raise OverflowError("a cube's operand beyond 2^21")
    return rescale(a * a * a, 2 * s, lost)


def matmul(a: np.ndarray, b: np.ndarray, s: int, lost: int = 0):
    return rescale(np.einsum("...mk,...kn->...mn", a, b, dtype=np.int64),
                   s, lost)


def row_sum(x: np.ndarray) -> np.ndarray:
    """The saturated sum over the last axis, kept as an axis of 1."""
    return sat(np.asarray(x, dtype=np.int64).sum(axis=-1, keepdims=True))


def mean_of_squares(x: np.ndarray, s: int) -> np.ndarray:
    """floor(sum x^2 / (2^s n)) over the last axis of n, saturated."""
    x = np.asarray(x, dtype=np.int64)
    return sat(np.floor_divide((x * x).sum(axis=-1, keepdims=True),
                               (1 << s) * x.shape[-1]))


def rsqrt(v: np.ndarray, s: int) -> np.ndarray:
    """isqrt(2^(3s) // v) for v > 0, else 0."""
    num = 1 << (3 * s)
    return np.array([math.isqrt(num // int(x)) if x > 0 else 0
                     for x in v.ravel()], dtype=np.int64).reshape(v.shape)


def tanh(x: np.ndarray, s: int) -> np.ndarray:
    """The teleported tanh: x floored to a multiple of tau = 2^(s-7),
    clamped to 16 bits, then round(2^s tanh(x / 2^s))."""
    tau = 2 << (s - 8)
    t = np.clip(np.floor_divide(x, tau) * tau, -(1 << 15), (1 << 15) - 1)
    return round_half_away(float(2 ** s) * np.tanh(t / float(2 ** s))
                           ).astype(np.int64)


def exp_tables(S: int) -> tuple[np.ndarray, np.ndarray, int]:
    """exp(-z / S) at scale S as two tables, z = hi * B + lo: hi[h] =
    round(S exp(-h B / S)), lo[l] = round(S exp(-l / S)), B the power of
    two nearest the square root of the range that matters (exp(-z/S) S
    under 1/2)."""
    needed = int(math.ceil(S * math.log(2.0 * S))) + 2
    logb = int(math.ceil(math.log2(needed) / 2.0))
    B = 1 << logb
    h = np.arange(needed // B + 2, dtype=np.float64)
    lo = np.arange(B, dtype=np.float64)
    hi_t = np.maximum(round_half_away(S * np.exp(-(h * B) / S)), 0)
    lo_t = np.maximum(round_half_away(S * np.exp(-lo / S)), 0)
    return hi_t.astype(np.int64), lo_t.astype(np.int64), B


def softmax(x: np.ndarray, s: int) -> np.ndarray:
    """Integer softmax over the last axis at scale S = 2^s: z = max - x
    capped at the tables' range, e = hi[z // B] lo[z % B] // S, then
    floor(e * floor(S^2 / sum e) / S)."""
    S = 1 << s
    hi_t, lo_t, B = exp_tables(S)
    z = np.minimum(x.max(axis=-1, keepdims=True) - x, len(hi_t) * B - 1)
    e = hi_t[z // B] * lo_t[z % B] // S
    inv = (S * S) // e.sum(axis=-1, keepdims=True)
    return e * inv // S
