"""Multi-scalar multiplication (Pippenger) with dtype-specialized windows.

Mirrors the role of the reference's small-scalar MSM dispatch
(joltworks/src/msm/mod.rs:20-333): witness polynomials carry u16/i32/one-hot
data, so the bucket window count adapts to the actual scalar bit-width
instead of always paying for 254-bit scalars.

Host implementation (Python ints over Jacobian tuples). The TPU-sharded
bucket-accumulation variant is tracked as a Pallas milestone (BASELINE.md:
"MSM points/s/chip").
"""

from __future__ import annotations

import numpy as np

from ..field.constants import FR_MODULUS
from .points import (
    G1,
    JINF,
    jacobian_add,
    jacobian_add_affine,
    jacobian_double,
    jacobian_to_affine,
)


def _scalar_bits(scalars: list[int]) -> int:
    m = max((abs(s) for s in scalars), default=0)
    return max(m.bit_length(), 1)


def msm(bases: list[G1], scalars) -> G1:
    """sum_i scalars[i] * bases[i].

    `scalars` may be a numpy integer array (any dtype) or list of ints;
    negative scalars are folded as r - |s|. Dispatches to the native C++
    Pippenger engine (curve/native.py) when available; the pure-Python
    window method below is the portable fallback and correctness oracle.
    """
    if isinstance(scalars, np.ndarray):
        scalars = [int(s) for s in scalars]
    if len(bases) >= 32:
        from .native import msm_native
        result = msm_native(bases, scalars)
        if result is not None:
            return result
    n = min(len(bases), len(scalars))
    scalars = [s % FR_MODULUS for s in scalars[:n]]
    bases = bases[:n]
    nz = [(s, b) for s, b in zip(scalars, bases) if s != 0 and not b.infinity]
    if not nz:
        return G1.identity()
    scalars = [s for s, _ in nz]
    bases = [b for _, b in nz]

    bits = _scalar_bits(scalars)
    c = _window_size(len(scalars), bits)
    num_windows = (bits + c - 1) // c
    mask = (1 << c) - 1

    window_sums = []
    for w in range(num_windows):
        shift = w * c
        buckets = [JINF] * ((1 << c) - 1)
        for s, b in zip(scalars, bases):
            digit = (s >> shift) & mask
            if digit:
                buckets[digit - 1] = jacobian_add_affine(buckets[digit - 1], b)
        # running-sum bucket reduction
        running = JINF
        acc = JINF
        for bucket in reversed(buckets):
            running = jacobian_add(running, bucket)
            acc = jacobian_add(acc, running)
        window_sums.append(acc)

    total = window_sums[-1]
    for wsum in reversed(window_sums[:-1]):
        for _ in range(c):
            total = jacobian_double(total)
        total = jacobian_add(total, wsum)
    return jacobian_to_affine(total)


def _window_size(n: int, bits: int) -> int:
    if bits <= 8:
        return bits
    # ~ln(n) heuristic, capped for memory
    c = max(2, int(np.log2(max(n, 2))) - 2)
    return min(c, 16, bits)
