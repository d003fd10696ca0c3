"""Vectorized Fr arrays: native limb path + host object-int fallback.

Two interchangeable representations of a vector of Fr elements:

  * native (production): FrArray — (n, 4) uint64 Montgomery limbs operated
    on by the C++ kernels in csrc/frvec.cpp (field/frvec.py). This is the
    protocol layer's workhorse, playing the role of arkworks' Fr vectors in
    the reference (joltworks/src/poly/multilinear_polynomial.rs:22-35).
  * host fallback: numpy object arrays of canonical Python ints (mod r).
    Zero build dependency; used when no C++ toolchain is available, and as
    the correctness oracle in tests.

The v* functions below dispatch on representation, so protocol code is
agnostic. Hot paths use the native FrArray kernels (field/frvec.py); the
object-int form here is the fallback + test oracle. Device offload lives
in tpu/ (reduction, msm) and parallel/ (mesh engines), not in this module.
"""

from __future__ import annotations

import numpy as np

from .constants import FR_MODULUS
from .scalar import Fr
from . import frvec
from .frvec import FrArray

R = FR_MODULUS


def native_available() -> bool:
    return frvec.available()


def from_ints(xs):
    """Any int iterable / numpy int array -> canonical field vector."""
    a = np.asarray(xs)
    if a.dtype != object and frvec.available():
        return FrArray.from_i64(a)
    if a.dtype == object:
        if frvec.available():
            return FrArray.from_object(a)
        return np.array([int(x) % R for x in a.ravel()],
                        dtype=object).reshape(a.shape)
    out = np.empty(a.shape, dtype=object)
    flat_in = a.ravel()
    flat_out = out.ravel()
    for i in range(flat_in.size):
        flat_out[i] = int(flat_in[i]) % R
    return out


def from_fr(elems):
    if frvec.available():
        return FrArray.from_fr_list(list(elems))
    return np.array([e.v for e in elems], dtype=object)


def to_fr(arr) -> list[Fr]:
    if isinstance(arr, FrArray):
        return arr.to_fr_list()
    return [Fr(int(x)) for x in np.asarray(arr).ravel()]


def as_object(arr) -> np.ndarray:
    """Canonical-int object array view of either representation."""
    if isinstance(arr, FrArray):
        return arr.to_object()
    return arr


def as_native(arr):
    """Promote an object array to FrArray when the native path is on."""
    if isinstance(arr, FrArray) or not frvec.available():
        return arr
    return FrArray.from_object(arr)


def elem(arr, i: int) -> Fr:
    if isinstance(arr, FrArray):
        return arr.item(i)
    return Fr(int(arr[i]))


def zeros(n: int):
    if frvec.available():
        return FrArray.zeros(n)
    return np.zeros(n, dtype=object)


def ones(n: int):
    if frvec.available():
        return FrArray.full(n, Fr.one())
    return np.ones(n, dtype=object)


def full(n: int, x: Fr):
    if frvec.available():
        return FrArray.full(n, x)
    return np.full(n, x.v, dtype=object)


def _pair(a, b):
    """Coerce a mixed (FrArray, object) pair to a common representation."""
    fa, fb = isinstance(a, FrArray), isinstance(b, FrArray)
    if fa and not fb:
        return a, FrArray.from_object(b)
    if fb and not fa:
        return FrArray.from_object(a), b
    return a, b


def vadd(a, b):
    a, b = _pair(a, b)
    if isinstance(a, FrArray):
        return a.add(b)
    return (a + b) % R


def vsub(a, b):
    a, b = _pair(a, b)
    if isinstance(a, FrArray):
        return a.sub(b)
    return (a - b) % R


def vmul(a, b):
    a, b = _pair(a, b)
    if isinstance(a, FrArray):
        return a.mul(b)
    return (a * b) % R


def vscale(a, s: Fr):
    if isinstance(a, FrArray):
        return a.scale(s)
    return (a * s.v) % R


def vsum(a) -> Fr:
    if isinstance(a, FrArray):
        return a.sum()
    return Fr(int(np.sum(a)) % R)


def vdot(a, b) -> Fr:
    a, b = _pair(a, b)
    if isinstance(a, FrArray):
        return a.dot(b)
    return Fr(int(np.sum((a * b) % R)) % R)


def vinv(a):
    """Batch inversion (Montgomery's trick)."""
    if isinstance(a, FrArray):
        flat = [int(x) for x in a.to_object()]
    else:
        flat = [int(x) for x in np.asarray(a).ravel()]
    n = len(flat)
    prefix = [0] * n
    acc = 1
    for i, x in enumerate(flat):
        if x == 0:
            raise ZeroDivisionError("vinv: zero element")
        prefix[i] = acc
        acc = acc * x % R
    inv = pow(acc, -1, R)
    out = [0] * n
    for i in range(n - 1, -1, -1):
        out[i] = inv * prefix[i] % R
        inv = inv * flat[i] % R
    if isinstance(a, FrArray):
        return FrArray.from_object(out)
    res = np.array(out, dtype=object)
    return res.reshape(np.asarray(a).shape)
