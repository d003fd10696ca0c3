"""ctypes bindings for the native C++ MSM engine (csrc/msm.cpp).

The library is built from the repo's csrc/msm.cpp at first use into the
port's git-ignored build directory (device/build.py); the committed
csrc/*.so are never loaded.

PreparedBases caches the Montgomery-encoded point buffer so repeated MSMs
over the same bases (= every witness commitment against the SRS powers) skip
all per-call point conversion — the same strategy as the reference's
arkworks `batch_normalize` + fixed-base reuse (joltworks/src/msm/mod.rs).
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..field.constants import FR_MODULUS
from .points import G1

_LIB = None
_TRIED = False

# FR_MODULUS as 4 little-endian u64 limbs (for vectorized negative folding)
_R_LIMBS = [(FR_MODULUS >> (64 * i)) & ((1 << 64) - 1) for i in range(4)]


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    from ..device import build
    so = build.host_library("msm")  # raises when the build fails
    try:
        lib = ctypes.CDLL(so)
        lib.msm_g1.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_char_p]
        lib.msm_g1.restype = None
        lib.msm_prep_points.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p]
        lib.msm_prep_points.restype = None
        lib.msm_g1_pre.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_char_p]
        lib.msm_g1_pre.restype = None
        lib.g1_scalar_muls.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p]
        lib.g1_scalar_muls.restype = None
        lib.msm_g1_pre_batch.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_char_p]
        lib.msm_g1_pre_batch.restype = None
        lib.msm_g1_pre_onehot_batch.argtypes = [
            ctypes.c_char_p, np.ctypeslib.ndpointer(np.int64, flags="C"),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_char_p]
        lib.msm_g1_pre_onehot_batch.restype = None
        lib.bn_pairing_product.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64,
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p]
        lib.bn_pairing_product.restype = None
        lib.msm_set_threads.argtypes = [ctypes.c_int]
        lib.msm_set_threads.restype = None
        lib.msm_digit_grid.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int64]
        lib.msm_digit_grid.restype = ctypes.c_int64
        lib.g2_scalar_mul.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_char_p]
        lib.g2_scalar_mul.restype = None
        _LIB = lib
    except (OSError, AttributeError):
        _LIB = None
    return _LIB


def available() -> bool:
    return _load() is not None


def pack_points(bases: list[G1]) -> bytes:
    """Canonical 64B/point LE buffer (infinity = all-zero)."""
    pts = bytearray(64 * len(bases))
    for i, b in enumerate(bases):
        if not b.infinity:
            pts[i * 64: i * 64 + 32] = b.x.to_bytes(32, "little")
            pts[i * 64 + 32: i * 64 + 64] = b.y.to_bytes(32, "little")
    return bytes(pts)


def pack_scalars(scalars) -> bytes:
    """n*32B LE scalar buffer, negatives folded mod r.

    numpy integer arrays are packed vectorized (the common witness case);
    anything else falls back to per-element int conversion.
    """
    if isinstance(scalars, np.ndarray) and scalars.dtype.kind in "iu":
        vals = scalars.astype(np.int64, copy=False).ravel()
        n = vals.size
        limbs = np.zeros((n, 4), dtype=np.uint64)
        pos = vals >= 0
        limbs[pos, 0] = vals[pos].astype(np.uint64)
        if not pos.all():
            neg = ~pos
            mag = (-vals[neg]).astype(np.uint64)
            # r - |s|: |s| < 2^63 < r_limb0-carry headroom (r0 > 2^62), so
            # only limb 0 borrows against r0 when |s| > r0 — never happens
            # since r0 = 0x43E1F593F0000001 > 2^62 > |s|.
            limbs[neg, 0] = np.uint64(_R_LIMBS[0]) - mag
            limbs[neg, 1] = np.uint64(_R_LIMBS[1])
            limbs[neg, 2] = np.uint64(_R_LIMBS[2])
            limbs[neg, 3] = np.uint64(_R_LIMBS[3])
        return limbs.tobytes()
    out = bytearray(32 * len(scalars))
    for i, s in enumerate(scalars):
        v = int(s) % FR_MODULUS
        out[i * 32: i * 32 + 32] = v.to_bytes(32, "little")
    return bytes(out)


class PreparedBases:
    """Montgomery-encoded point buffer reusable across MSM calls.

    `raw` (canonical 64B/point bytes) skips the Python packing loop when the
    caller already has the wire form (e.g. native SRS generation)."""

    def __init__(self, bases: list[G1] | None, raw: bytes | None = None):
        lib = _load()
        if lib is None:
            raise RuntimeError("native MSM library unavailable")
        if raw is None:
            raw = pack_points(bases)
        self.n = len(raw) // 64
        self.buf = ctypes.create_string_buffer(64 * self.n)
        lib.msm_prep_points(raw, self.n, self.buf)

    def msm(self, scalars, n: int | None = None, c: int = 0) -> G1:
        """MSM of scalars against the first len(scalars) prepared bases."""
        count = len(scalars) if n is None else n
        count = min(count, self.n)
        if count == 0:
            return G1.identity()
        return self.msm_packed(pack_scalars(scalars[:count]), count, c)

    def msm_packed_at(self, offset: int, scalar_bytes: bytes,
                      count: int, c: int = 0) -> G1:
        """MSM against bases[offset : offset+count] — the streaming-commit
        primitive (each chunk lands on its own base window)."""
        lib = _load()
        count = min(count, self.n - offset)
        if count <= 0:
            return G1.identity()
        out_buf = ctypes.create_string_buffer(64)
        inf_buf = ctypes.create_string_buffer(1)
        base_ptr = ctypes.cast(ctypes.byref(self.buf, offset * 64),
                               ctypes.c_char_p)
        lib.msm_g1_pre(base_ptr, scalar_bytes, count, c, out_buf, inf_buf)
        return _decode_point(out_buf, inf_buf)

    def msm_batch(self, scalar_arrays: list) -> list[G1]:
        """Independent MSMs against shared bases, OpenMP across MSMs."""
        return self.msm_batch_packed([pack_scalars(s) for s in scalar_arrays])

    def msm_onehot_batch(self, index_arrays: list[np.ndarray]) -> list[G1]:
        """Batch of one-hot subset-sum MSMs (indices of the 1-entries)."""
        lib = _load()
        offsets = [0]
        for a in index_arrays:
            offsets.append(offsets[-1] + len(a))
        idx = np.ascontiguousarray(
            np.concatenate([np.asarray(a, dtype=np.int64)
                            for a in index_arrays])
            if index_arrays else np.empty(0, dtype=np.int64))
        k = len(index_arrays)
        offs = (ctypes.c_int64 * (k + 1))(*offsets)
        out = ctypes.create_string_buffer(65 * k)
        lib.msm_g1_pre_onehot_batch(self.buf, idx, offs, k, out)
        pts = []
        raw = out.raw
        for i in range(k):
            base = i * 65
            if raw[base + 64]:
                pts.append(G1.identity())
            else:
                x = int.from_bytes(raw[base: base + 32], "little")
                y = int.from_bytes(raw[base + 32: base + 64], "little")
                pts.append(G1(x, y))
        return pts

    def msm_batch_packed(self, packed: list[bytes]) -> list[G1]:
        """Like msm_batch but scalars already in 32B-LE wire form."""
        lib = _load()
        offsets = [0]
        for b in packed:
            offsets.append(offsets[-1] + len(b) // 32)
        k = len(packed)
        offs = (ctypes.c_int64 * (k + 1))(*offsets)
        out = ctypes.create_string_buffer(65 * k)
        lib.msm_g1_pre_batch(self.buf, b"".join(packed), offs, k, out)
        pts = []
        raw = out.raw
        for i in range(k):
            base = i * 65
            if raw[base + 64]:
                pts.append(G1.identity())
            else:
                x = int.from_bytes(raw[base: base + 32], "little")
                y = int.from_bytes(raw[base + 32: base + 64], "little")
                pts.append(G1(x, y))
        return pts

    def msm_packed(self, scalar_bytes: bytes, count: int, c: int = 0) -> G1:
        """MSM where scalars are already in the 32B-LE wire format (e.g.
        FrArray.canonical().tobytes())."""
        lib = _load()
        count = min(count, self.n)
        if count == 0:
            return G1.identity()
        out_buf = ctypes.create_string_buffer(64)
        inf_buf = ctypes.create_string_buffer(1)
        lib.msm_g1_pre(self.buf, scalar_bytes, count, c, out_buf, inf_buf)
        return _decode_point(out_buf, inf_buf)


def _decode_point(out_buf, inf_buf) -> G1:
    if inf_buf.raw[0]:
        return G1.identity()
    x = int.from_bytes(out_buf.raw[:32], "little")
    y = int.from_bytes(out_buf.raw[32:64], "little")
    return G1(x, y)


def scalar_muls_native_raw(base: G1, scalars: list[int]) -> bytes | None:
    """Raw canonical 64B/point buffer of [s * base for s in scalars]."""
    lib = _load()
    if lib is None or base.infinity:
        return None
    n = len(scalars)
    b = base.x.to_bytes(32, "little") + base.y.to_bytes(32, "little")
    scs = pack_scalars(scalars)
    out = ctypes.create_string_buffer(64 * n)
    lib.g1_scalar_muls(b, scs, n, out)
    return out.raw


def msm_native(bases: list[G1], scalars, c: int = 0) -> G1 | None:
    """Native Pippenger MSM; returns None if the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    n = min(len(bases), len(scalars) if hasattr(scalars, "__len__") else 0)
    if n == 0:
        return G1.identity()
    pts = pack_points(bases[:n])
    scs = pack_scalars(scalars[:n])
    out_buf = ctypes.create_string_buffer(64)
    inf_buf = ctypes.create_string_buffer(1)
    lib.msm_g1(pts, scs, n, c, out_buf, inf_buf)
    return _decode_point(out_buf, inf_buf)


def g2_scalar_mul_native(q, k: int):
    """k * q for a G2 point via the native engine (None if unavailable).
    Verifier-side [Z_S(tau)]_2 assembly for the Shplonk batch opening."""
    from .points import G2
    from .fq import FQ2
    lib = _load()
    if lib is None:
        return None
    if q.infinity:
        return G2.identity()
    pt = (q.x.a.to_bytes(32, "little") + q.x.b.to_bytes(32, "little")
          + q.y.a.to_bytes(32, "little") + q.y.b.to_bytes(32, "little"))
    sc = (int(k) % FR_MODULUS).to_bytes(32, "little")
    out = ctypes.create_string_buffer(128)
    inf = ctypes.create_string_buffer(1)
    lib.g2_scalar_mul(pt, sc, out, inf)
    if inf.raw[0]:
        return G2.identity()
    raw = out.raw
    return G2(FQ2(int.from_bytes(raw[:32], "little"),
                  int.from_bytes(raw[32:64], "little")),
              FQ2(int.from_bytes(raw[64:96], "little"),
                  int.from_bytes(raw[96:128], "little")))
