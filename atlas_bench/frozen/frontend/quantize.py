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


def _round_half_away(v: float) -> float:
    """Rust f64::round semantics: round half away from zero."""
    return math.floor(v + 0.5) if v >= 0 else math.ceil(v - 0.5)


