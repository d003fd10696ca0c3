"""Fixed-point quantization: f32/f64 -> i32 with power-of-two scale.

Reference: atlas-onnx-tracer/src/utils/quantize.rs. Values are stored as
round(x * 2^scale) in i32; extreme negatives (attention masks) clamp to a
scale-indexed sentinel that keeps masked softmax weights exactly zero
(quantize.rs:94-140).
"""

from __future__ import annotations

import math

import numpy as np

I32_MAX = 2**31 - 1
I32_MIN = -(2**31)


def scale_to_multiplier(scale: int) -> float:
    return float(2.0**scale)


def mask_sentinel_magnitude(scale: int) -> float:
    """ceil((scale + 1) * ln2) + 1 — the extreme-negative mask sentinel."""
    return math.ceil((scale + 1.0) * math.log(2.0)) + 1.0


def quantize_float(x: float, scale: int) -> int:
    mult = scale_to_multiplier(scale)
    max_value = round(I32_MAX / mult)
    if x < -max_value:
        if x < -1e6:
            clamped = -mask_sentinel_magnitude(scale)
        else:
            raise ValueError(f"sig bit truncation: {x} out of range at scale {scale}")
    elif x > max_value:
        if x > 1e6:
            clamped = max_value / 2.0
        else:
            raise ValueError(f"sig bit truncation: {x} out of range at scale {scale}")
    else:
        clamped = x
    scaled = int(_round_half_away(clamped * mult))
    # zero-preservation hack shared with the reference (quantize.rs:188-195)
    if scaled == 0 and x != 0.0:
        return 1 if x > 0.0 else -1
    return scaled


def _round_half_away(v: float) -> float:
    """Rust f64::round semantics: round half away from zero."""
    return math.floor(v + 0.5) if v >= 0 else math.ceil(v - 0.5)


def quantize_tensor(arr, scale: int) -> np.ndarray:
    """``quantize_float`` of every element, as numpy array operations (the
    same float64 steps, so the same integers; a vocabulary-scale weight
    matrix has ~10^8 elements). Raises as quantize_float does at the first
    element it refuses."""
    a = np.asarray(arr, dtype=np.float64)
    x = a.ravel()
    mult = scale_to_multiplier(scale)
    max_value = round(I32_MAX / mult)
    low, high = x < -max_value, x > max_value
    bad = np.isnan(x) | (low & ~(x < -1e6)) | (high & ~(x > 1e6))
    if bad.any():
        quantize_float(float(x[np.argmax(bad)]), scale)  # raises
    clamped = np.where(low, -mask_sentinel_magnitude(scale),
                       np.where(high, max_value / 2.0, x))
    v = clamped * mult
    r = np.where(v >= 0, np.floor(v + 0.5), np.ceil(v - 0.5))
    if ((r < I32_MIN) | (r > I32_MAX)).any():
        raise OverflowError(f"quantized value out of int32 at scale {scale}")
    r = np.where((r == 0) & (x != 0.0), np.where(x > 0.0, 1.0, -1.0), r)
    return r.astype(np.int32).reshape(a.shape)


def dequantize(arr, scale: int) -> np.ndarray:
    return np.asarray(arr, dtype=np.float64) / scale_to_multiplier(scale)
