"""Decomposed-LUT quantized softmax with full witness trace.

Reference: atlas-onnx-tracer/src/ops/softmax.rs. Per last-axis slice:
  z = max - x  (>= 0), clamped to z_bound-1 (sat_diff = overflow),
  digit split z_c = z_hi*B + z_lo, two-level exp LUT:
  exp_q = floor(LUT_hi[z_hi]*LUT_lo[z_lo]/S), r_exp = product - exp_q*S,
  exp_sum = sum exp_q, inv_sum = floor(S^2/exp_sum),
  softmax_q = floor(exp_q*inv_sum/S), R = exp_q*inv_sum - softmax_q*S.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np


@dataclass
class ExpLutDecomposed:
    lut_hi: np.ndarray  # i32
    lut_lo: np.ndarray  # i32
    base: int
    log2_base: int


@dataclass
class SoftmaxTrace:
    scale: int
    x: np.ndarray          # flat [F*N] i32 logits
    max_k: np.ndarray      # [F]
    argmax_k: np.ndarray   # [F]
    exp_q: np.ndarray      # flat
    exp_sum_q: np.ndarray  # [F]
    inv_sum: np.ndarray    # [F]
    R: np.ndarray          # flat, in [0, S)
    lut: ExpLutDecomposed
    z_hi: np.ndarray
    z_lo: np.ndarray
    exp_hi: np.ndarray
    exp_lo: np.ndarray
    r_exp: np.ndarray      # in [0, S)
    sat_diff: np.ndarray   # >= 0


def _round_half_away(v: np.ndarray) -> np.ndarray:
    return np.where(v >= 0, np.floor(v + 0.5), np.ceil(v - 0.5))


def generate_exp_lut_decomposed(scale: int) -> ExpLutDecomposed:
    """Sub-tables: LUT_hi[h] = round(S*exp(-h*B/S)), LUT_lo[l] = round(S*exp(-l/S)).

    B is the power of two nearest sqrt of the active range (softmax.rs:238+).
    """
    sf = float(scale)
    needed = int(math.ceil(sf * math.log(2.0 * sf))) + 2
    log2_b = int(math.ceil(math.log2(needed) / 2.0))
    base = 1 << log2_b
    hi_size = needed // base + 2
    h = np.arange(hi_size, dtype=np.float64)
    lut_hi = np.maximum(_round_half_away(sf * np.exp(-(h * base) / sf)), 0.0).astype(np.int32)
    l = np.arange(base, dtype=np.float64)
    lut_lo = np.maximum(_round_half_away(sf * np.exp(-l / sf)), 0.0).astype(np.int32)
    return ExpLutDecomposed(lut_hi, lut_lo, base, log2_b)


def softmax_last_axis_decomposed(a: np.ndarray, scale: int):
    """Returns (output i32 tensor, SoftmaxTrace). `scale` is S = 2^log_scale."""
    dims = a.shape
    last = dims[-1]
    flat = a.reshape(-1, last).astype(np.int64)
    s = int(scale)
    s_sq = s * s

    decomp = generate_exp_lut_decomposed(s)
    z_bound = int(len(decomp.lut_hi) * decomp.base)

    max_k = flat.max(axis=1)
    argmax_k = flat.argmax(axis=1)
    z = max_k[:, None] - flat  # >= 0
    z_c = np.minimum(z, z_bound - 1)
    sat_diff = (z - z_c).astype(np.int32)
    z_hi = (z_c >> decomp.log2_base).astype(np.int64)
    z_lo = (z_c & (decomp.base - 1)).astype(np.int64)
    exp_hi = decomp.lut_hi[z_hi].astype(np.int64)
    exp_lo = decomp.lut_lo[z_lo].astype(np.int64)
    product = exp_hi * exp_lo
    exp_q = product // s  # nonneg product, trunc == floor
    r_exp = (product - exp_q * s).astype(np.int32)
    exp_sum_q = exp_q.sum(axis=1)
    inv_sum = s_sq // exp_sum_q
    prod2 = exp_q * inv_sum[:, None]
    softmax_q = prod2 // s
    R = (prod2 - softmax_q * s).astype(np.int32)

    out = softmax_q.astype(np.int32).reshape(dims)
    trace = SoftmaxTrace(
        scale=s,
        x=a.reshape(-1).astype(np.int32),
        max_k=max_k.astype(np.int32),
        argmax_k=argmax_k.astype(np.int64),
        exp_q=exp_q.reshape(-1).astype(np.int32),
        exp_sum_q=exp_sum_q.astype(np.int32),
        inv_sum=inv_sum.astype(np.int32),
        R=R.reshape(-1),
        lut=decomp,
        z_hi=z_hi.reshape(-1).astype(np.int32),
        z_lo=z_lo.reshape(-1).astype(np.int32),
        exp_hi=exp_hi.reshape(-1).astype(np.int32),
        exp_lo=exp_lo.reshape(-1).astype(np.int32),
        r_exp=r_exp.reshape(-1),
        sat_diff=sat_diff.reshape(-1),
    )
    return out, trace
