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
    a = np.asarray(arr, dtype=np.float64)
    out = np.empty(a.shape, dtype=np.int32)
    flat_in, flat_out = a.ravel(), out.ravel()
    for i in range(flat_in.size):
        flat_out[i] = quantize_float(float(flat_in[i]), scale)
    return out


def dequantize(arr, scale: int) -> np.ndarray:
    return np.asarray(arr, dtype=np.float64) / scale_to_multiplier(scale)
