"""Eq polynomial tables (big-endian index order, r[0] = MSB).

Mirrors reference joltworks/src/poly/eq_poly.rs:62-101: evals(r)[i] =
prod_j (b_j ? r[j] : 1 - r[j]) where b_0 is the most-significant bit of i.
"""

from __future__ import annotations

import numpy as np

from ..field import vec
from ..field.scalar import Fr


# Built eq tables are memoized by point: the IOP opens every instance of a
# node at the same r_cycle, so the same table is requested dozens of times
# (profiling: 940 eq_evals calls / ~10 s per prove before the cache).
# Cache hits share the underlying buffer: every consumer is read-only —
# the fused sumcheck engines copy-on-first-bind, and MLPoly.bind writes a
# fresh array.
_CACHE: dict[tuple, object] = {}
_CACHE_ELEMS = 0
_MAX_CACHE_ELEMS = 1 << 22      # ~128 MB of (n,4) u64 rows
_MAX_CACHED_VARS = 14           # larger tables are one-offs (opening groups)


def _build_eq(r: list[Fr]):
    if vec.native_available():
        from ..field import frvec
        return frvec.eq_expand(r)  # single C call (frv_eq_expand)
    table = vec.full(1, Fr.one())
    for rj in r:  # r[0] first; each new variable becomes the LSB (interleave)
        hi = vec.vscale(table, rj)
        lo = vec.vsub(table, hi)  # table * (1 - r_j)
        if isinstance(table, np.ndarray):
            out = np.empty(2 * len(table), dtype=object)
        else:
            from ..field.frvec import FrArray
            out = FrArray.zeros(2 * len(table))
        out[0::2] = lo
        out[1::2] = hi
        table = out
    return table


def eq_evals(r: list[Fr], scale: Fr | None = None):
    """Table of eq(r, x) for all x in {0,1}^n (FrArray on the native path,
    object-int array on the fallback). Returns a fresh (caller-owned) array."""
    global _CACHE_ELEMS
    from ..field.frvec import FrArray
    if not vec.native_available():
        table = _build_eq(r)
        return table if scale is None else vec.vscale(table, scale)
    key = tuple(x.v for x in r)
    base = _CACHE.get(key)
    if base is None:
        built = _build_eq(r)
        if len(r) <= _MAX_CACHED_VARS:
            if _CACHE_ELEMS + len(built) > _MAX_CACHE_ELEMS:
                _CACHE.clear()
                _CACHE_ELEMS = 0
            _CACHE[key] = built
            _CACHE_ELEMS += len(built)
        return built if scale is None else built.scale(scale)
    if scale is not None:
        return base.scale(scale)  # scale copies
    return FrArray(base.d)  # shared buffer; consumers are read-only


def eq_eval_scalar(x: list[Fr], y: list[Fr]) -> Fr:
    """eq(x, y) = prod_i (x_i y_i + (1-x_i)(1-y_i))."""
    assert len(x) == len(y)
    acc = Fr.one()
    one = Fr.one()
    for xi, yi in zip(x, y):
        acc = acc * (xi * yi + (one - xi) * (one - yi))
    return acc
