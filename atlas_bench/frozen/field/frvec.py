"""Native Fr vector arrays: (n, 4) uint64 Montgomery limbs + C++ kernels.

The library is built from the repo's csrc/frvec.cpp at first use into the
port's git-ignored build directory (device/build.py).

The host-side production representation of field-element vectors used by the
protocol layer (sumcheck round evaluation, binding, eq tables, RLC). Plays
the role of arkworks' `Vec<ark_bn254::Fr>` in the reference (joltworks uses
ark Montgomery backend throughout, e.g. subprotocols/sumcheck.rs). Falls
back to None when the C++ library (csrc/frvec.cpp) is unavailable — callers
then stay on the object-int path in field/vec.py.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from .constants import FR_MODULUS
from .scalar import Fr

_LIB = None
_TRIED = False
_U64 = np.ctypeslib.ndpointer(dtype=np.uint64, flags="C_CONTIGUOUS")
_I64 = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")


_MALLOC_TUNED = False


def _tune_malloc() -> None:
    """Keep large allocations on the reusable heap (glibc mallopt).

    The prover allocates/frees MB-scale limb arrays constantly; glibc's
    default 128 KB mmap threshold turns every one into mmap/munmap, so each
    touch faults fresh zero pages (~30-70 MB/s on this hypervisor vs GB/s
    for warm pages — profiled 19.7 s of a 23 s opening phase inside
    ndarray.copy). Raising M_MMAP_THRESHOLD and disabling trim keeps pages
    warm across the whole prove."""
    global _MALLOC_TUNED
    if _MALLOC_TUNED:
        return
    _MALLOC_TUNED = True
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        M_TRIM_THRESHOLD, M_MMAP_THRESHOLD = -1, -3
        libc.mallopt(M_MMAP_THRESHOLD, 1 << 30)
        libc.mallopt(M_TRIM_THRESHOLD, 1 << 30)
    except OSError:
        pass


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    _tune_malloc()
    from ..device import build
    so = build.host_library("frvec")  # raises when the build fails
    # GOMP worker threads spin-wait after each kernel call by default,
    # starving the interleaved single-threaded numpy/Python work on this
    # 4-core box (profiled: ndarray.copy at ~170 MB/s vs 2-4 GB/s clean).
    # Must be set before libgomp loads.
    os.environ.setdefault("OMP_WAIT_POLICY", "PASSIVE")
    try:
        lib = ctypes.CDLL(so)
        vp = ctypes.c_void_p
        # hot kernels take raw pointers (arr.ctypes.data ints): ndpointer's
        # per-call from_param validation was a measured ~3 s/prove
        for name, args in [
            ("frv_from_i64", [_I64, _U64, ctypes.c_int64]),
            ("frv_encode", [_U64, _U64, ctypes.c_int64]),
            ("frv_decode", [vp, vp, ctypes.c_int64]),
            ("frv_mul", [vp, vp, vp, ctypes.c_int64]),
            ("frv_add", [vp, vp, vp, ctypes.c_int64]),
            ("frv_sub", [vp, vp, vp, ctypes.c_int64]),
            ("frv_scale", [vp, vp, vp, ctypes.c_int64]),
            ("frv_axpy", [vp, vp, vp, vp, ctypes.c_int64]),
            ("frv_sum", [_U64, ctypes.c_int64, _U64]),
            ("frv_dot", [_U64, _U64, ctypes.c_int64, _U64]),
            ("frv_dot3", [_U64, _U64, _U64, ctypes.c_int64, _U64]),
            ("frv_bind", [vp, vp, vp, vp, ctypes.c_int64]),
            ("frv_eval_ladder", [_U64, _U64, ctypes.c_int64, ctypes.c_int,
                                 _U64]),
            ("frv_scatter_add", [_U64, _I64, ctypes.c_int64, _U64,
                                 ctypes.c_int64]),
            ("frv_scatter_const_ranges", [_U64, _I64, ctypes.c_int64, _I64,
                                          _U64, ctypes.c_int64,
                                          ctypes.c_int]),
            ("frv_zero", [ctypes.c_void_p, ctypes.c_int64]),
            ("frv_i64_mat_vec", [_I64, _U64, ctypes.c_int64, ctypes.c_int64,
                                 _U64]),
            ("frv_syndiv", [_U64, _U64, ctypes.c_int64, _U64]),
            ("frv_syndiv_rev", [_U64, _U64, ctypes.c_int64, _U64]),
            ("frv_horner", [_U64, _U64, ctypes.c_int64, _U64]),
            ("frv_terms_round", [_U64, ctypes.c_int64, ctypes.c_int64,
                                 ctypes.c_int, _U64, _I64, _I64,
                                 ctypes.c_int64, _U64]),
            ("frv_bind_rows", [_U64, ctypes.c_int64, ctypes.c_int64, _U64,
                               _U64]),
        ]:
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = None
        pp = ctypes.POINTER(ctypes.POINTER(ctypes.c_uint64))
        ppi = ctypes.POINTER(ctypes.POINTER(ctypes.c_int64))
        for name, args in [
            ("frv_terms_round_p", [pp, ctypes.c_int64, ctypes.c_int64,
                                   ctypes.c_int, vp, vp, vp,
                                   ctypes.c_int64, vp, vp,
                                   ctypes.c_int64, vp]),
            ("frv_bind_rows_p", [pp, ctypes.c_int64, ctypes.c_int64, vp]),
            ("frv_eq_expand", [vp, ctypes.c_int64, vp, vp, vp]),
            ("frv_gruen_round_p", [pp, ctypes.c_int64, ctypes.c_int64,
                                   ctypes.c_int, vp, vp, vp,
                                   ctypes.c_int64, vp, vp,
                                   ctypes.c_int64, vp, ctypes.c_int64,
                                   ctypes.c_int, vp, ctypes.c_int, vp]),
            ("frv_gruen_round_bind_p", [pp, ctypes.c_int64, ctypes.c_int64,
                                        vp, pp, ctypes.c_int, vp, vp, vp,
                                        ctypes.c_int64, vp, vp,
                                        ctypes.c_int64, vp, ctypes.c_int64,
                                        ctypes.c_int, vp, ctypes.c_int,
                                        vp]),
            ("frv_gruen_round0_i64", [ppi, ctypes.c_int64, ctypes.c_int64,
                                      ctypes.c_int, vp, vp, vp,
                                      ctypes.c_int64, vp, ctypes.c_int64,
                                      ctypes.c_int, vp, ctypes.c_int,
                                      vp]),
            ("frv_gruen_round0_i64fr", [ppi, ctypes.c_int64, ctypes.c_int64,
                                        ctypes.c_int, vp, vp, vp,
                                        ctypes.c_int64, vp, ctypes.c_int64,
                                        ctypes.c_int, vp, ctypes.c_int,
                                        vp]),
            ("frv_bind_rows_i64", [ppi, ctypes.c_int64, ctypes.c_int64,
                                   vp, pp]),
            ("frv_scatter_cycles", [vp, ctypes.c_int64, ppi,
                                    ctypes.c_int64, vp]),
            ("frv_inv", [vp, vp, ctypes.c_int64]),
            ("frv_inv_canon", [vp, vp, ctypes.c_int64]),
            ("frv_onehot_qev", [ppi, ctypes.c_int64, ctypes.c_int64,
                                vp, ctypes.c_int64, vp, ctypes.c_int64,
                                ctypes.c_int, vp, ctypes.c_int,
                                ctypes.c_int, ctypes.c_int, vp, vp]),
            ("frv_matvec_small", [vp, vp, ctypes.c_int64, vp]),
            ("frv_i64_dot", [vp, vp, ctypes.c_int64, vp]),
            ("frv_i64_dot2", [vp, ctypes.c_int64, ctypes.c_int64, vp, vp,
                              vp]),
            ("frv_eval_from_hint", [vp, ctypes.c_int64, vp, vp, vp]),
            ("frv_gruen1_fleet", [vp, vp, vp, vp, ctypes.c_int64, vp,
                                  vp, vp, vp, vp, vp, vp]),
            ("frv_pair_fleet", [vp, vp, vp, vp, ctypes.c_int64, vp, vp]),
            ("frv_axpy_multi", [vp, vp, vp, vp, ctypes.c_int64]),
            ("frv_horner_multi", [vp, vp, ctypes.c_int64, vp, vp]),
            ("frv_unipoly_hint_interp", [vp, ctypes.c_int64, vp, vp, vp]),
            ("frv_gruen_assemble", [vp, ctypes.c_int64, vp, vp, vp, vp,
                                    vp, vp, vp, vp]),
        ]:
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = None
        _LIB = lib
    except (OSError, AttributeError):
        _LIB = None
    return _LIB


def available() -> bool:
    return _load() is not None


def _c(a: np.ndarray) -> np.ndarray:
    """Contiguity guard for views handed to the C kernels."""
    return np.ascontiguousarray(a)


def _fr_limbs(x: Fr) -> np.ndarray:
    """Single Fr -> (1,4) canonical limbs -> Montgomery."""
    out = np.frombuffer(x.v.to_bytes(32, "little"),
                        dtype=np.uint64).reshape(1, 4)
    enc = np.empty_like(out)
    _load().frv_encode(out, enc, 1)
    return enc


_R1_LIMBS = None
_SMALL_TABLE = None


def _r1_limbs() -> np.ndarray:
    """Montgomery form of 1 (R mod r) as a (1,4) u64 row."""
    global _R1_LIMBS
    if _R1_LIMBS is None:
        one = np.array([[1, 0, 0, 0]], dtype=np.uint64)
        enc = np.empty_like(one)
        _load().frv_encode(one, enc, 1)
        _R1_LIMBS = enc
    return _R1_LIMBS


def _small_table(n: int) -> np.ndarray:
    """Montgomery forms of 0..n-1 (grown on demand, power-of-two sized)."""
    global _SMALL_TABLE
    if _SMALL_TABLE is None or len(_SMALL_TABLE) < n:
        size = 256
        while size < n:
            size *= 2
        vals = np.arange(size, dtype=np.int64)
        out = np.empty((size, 4), dtype=np.uint64)
        _load().frv_from_i64(vals, out, size)
        _SMALL_TABLE = out
    return _SMALL_TABLE


_SCALAR_CACHE: dict[int, tuple[np.ndarray, int]] = {}  # v -> (limb row, addr)
# arrays evicted from the caches survive one eviction generation here: a
# raw address taken inside a call expression stays valid even if a second
# cache lookup in the SAME expression triggers an eviction (the next
# eviction needs 2^16 fresh inserts — impossible within one expression)
_EVICT_STASH: list = []


def _evict_scalar_cache() -> None:
    """Drop the oldest half (insertion order). A wholesale clear() threw
    away every hot entry (round challenges, batching coefficients) ~10
    times per prove once the per-round claim/scalar seeding pushed the
    population past the old 4096 cap."""
    global _EVICT_STASH
    keys = list(_SCALAR_CACHE.keys())[: len(_SCALAR_CACHE) // 2]
    _EVICT_STASH = [_SCALAR_CACHE.pop(k) for k in keys]


def _fr_limbs_cached(x: Fr) -> np.ndarray:
    got = _SCALAR_CACHE.get(x.v)
    if got is None:
        if len(_SCALAR_CACHE) > (1 << 17):
            _evict_scalar_cache()
        arr = _fr_limbs(x)
        got = _SCALAR_CACHE[x.v] = (arr, arr.ctypes.data)
    return got[0]


def _fr_addr_cached(x: Fr) -> int:
    """Raw data address of the cached Montgomery limb row of x — the
    ~1 us ndarray.ctypes property construction per access made address
    recomputation a top-5 prover cost (350k accesses per bench prove)."""
    got = _SCALAR_CACHE.get(x.v)
    if got is None:
        if len(_SCALAR_CACHE) > (1 << 17):
            _evict_scalar_cache()
        arr = _fr_limbs(x)
        got = _SCALAR_CACHE[x.v] = (arr, arr.ctypes.data)
    return got[1]


_ADDR_MEMO: dict[int, tuple] = {}  # id(arr) -> (arr, addr); arr kept alive


def _np_addr(a: np.ndarray) -> int:
    """Memoized data address of a long-lived C-contiguous array (eq weight
    tables, encoding buffers). The memo holds a reference, so the id can
    never be reused while the entry lives."""
    global _EVICT_STASH
    e = _ADDR_MEMO.get(id(a))
    if e is None:
        if not a.flags.c_contiguous:
            a = np.ascontiguousarray(a)
        if len(_ADDR_MEMO) > 8192:
            _EVICT_STASH = list(_ADDR_MEMO.values())
            _ADDR_MEMO.clear()
        e = (a, a.ctypes.data)
        _ADDR_MEMO[id(a)] = e
    return e[1]


class FrArray:
    """1-D vector of Fr elements in Montgomery limb form, shape (n, 4)."""

    __slots__ = ("d", "_a")

    def __init__(self, d: np.ndarray):
        self.d = d
        self._a = None

    def addr(self) -> int:
        """Cached raw data address (normalizing self.d to C-contiguous
        first). `d` is only ever assigned in __init__, so the address is
        stable for the array's lifetime."""
        a = self._a
        if a is None:
            d = self.d
            if not d.flags.c_contiguous:
                d = self.d = np.ascontiguousarray(d)
            a = self._a = d.ctypes.data
        return a

    # -- constructors ------------------------------------------------------
    @classmethod
    def zeros(cls, n: int) -> "FrArray":
        # large buffers: parallel page-touch memset (csrc frv_zero) —
        # np.zeros' calloc degrades to a serial memset once the allocator
        # starts recycling dirty arena pages (~1.5 s/prove at bench scale)
        if n >= (1 << 14):
            lib = _load()
            if lib is not None:
                d = np.empty((n, 4), dtype=np.uint64)
                lib.frv_zero(d.ctypes.data, 4 * n)
                return cls(d)
        return cls(np.zeros((n, 4), dtype=np.uint64))

    @classmethod
    def from_i64(cls, ints) -> "FrArray":
        a = np.ascontiguousarray(np.asarray(ints).ravel(), dtype=np.int64)
        if a.size:
            lo = int(a.min())
            hi = int(a.max())
            if lo >= 0 and hi < (1 << 16):
                # small nonneg values (chunk nibbles, one-hots, LUT outputs):
                # gather from a cached Montgomery table — numpy memory speed
                # instead of a mont_mul per element
                return cls(np.ascontiguousarray(_small_table(hi + 1)[a]))
        out = np.empty((a.size, 4), dtype=np.uint64)
        _load().frv_from_i64(a, out, a.size)
        return cls(out)

    @classmethod
    def from_object(cls, obj) -> "FrArray":
        """Object array / iterable of canonical Python ints -> Montgomery."""
        flat = np.asarray(obj, dtype=object).ravel()
        n = flat.size
        raw = np.frombuffer(
            b"".join(int(x).to_bytes(32, "little") for x in flat),
            dtype=np.uint64).reshape(n, 4).copy()
        out = np.empty((n, 4), dtype=np.uint64)
        _load().frv_encode(raw, out, n)
        return cls(out)

    @classmethod
    def from_fr_list(cls, elems) -> "FrArray":
        return cls.from_object([e.v for e in elems])

    @classmethod
    def full(cls, n: int, x: Fr) -> "FrArray":
        return cls(np.broadcast_to(_fr_limbs_cached(x), (n, 4)).copy())

    # -- conversion out ----------------------------------------------------
    def to_object(self) -> np.ndarray:
        d = _c(self.d)
        n = len(d)
        can = np.empty((n, 4), dtype=np.uint64)
        _load().frv_decode(d.ctypes.data, can.ctypes.data, n)
        b = can.tobytes()
        out = np.empty(n, dtype=object)
        for i in range(n):
            out[i] = int.from_bytes(b[32 * i: 32 * i + 32], "little")
        return out

    def to_fr_list(self) -> list[Fr]:
        return [Fr(int(x)) for x in self.to_object()]

    def canonical(self) -> np.ndarray:
        """(n, 4) u64 canonical (non-Montgomery) limbs — the 32B/elem LE
        scalar wire format shared with the MSM engine."""
        d = _c(self.d)
        can = np.empty_like(d)
        _load().frv_decode(d.ctypes.data, can.ctypes.data, len(d))
        return can

    def item(self, i: int) -> Fr:
        can = np.empty((1, 4), dtype=np.uint64)
        _load().frv_decode(self.addr() + 32 * i, can.ctypes.data, 1)
        return Fr(int.from_bytes(can.tobytes(), "little"))

    # -- container protocol ------------------------------------------------
    def __len__(self) -> int:
        return len(self.d)

    def __iter__(self):
        return iter(self.to_fr_list())

    def copy(self) -> "FrArray":
        return FrArray(self.d.copy())

    def reshape(self, *shape) -> "FrArray":
        assert np.prod(shape) == len(self.d) or -1 in shape
        return self  # logical 1-D; reshape is a no-op for flat callers

    def __getitem__(self, idx) -> "FrArray":
        if isinstance(idx, (int, np.integer)):
            return self.item(int(idx))
        return FrArray(self.d[idx])

    def __setitem__(self, idx, value) -> None:
        if isinstance(value, FrArray):
            self.d[idx] = value.d
        elif isinstance(value, Fr):
            self.d[idx] = _fr_limbs_cached(value)[0]
        else:
            raise TypeError(f"FrArray setitem: {type(value)}")

    # -- arithmetic --------------------------------------------------------
    def _bin(self, other, op) -> "FrArray":
        n = len(self.d)
        assert n == len(other.d), (n, len(other.d))
        out = np.empty((n, 4), dtype=np.uint64)
        op(self.addr(), other.addr(), out.ctypes.data, n)
        return FrArray(out)

    def add(self, other) -> "FrArray":
        return self._bin(other, _load().frv_add)

    def sub(self, other) -> "FrArray":
        return self._bin(other, _load().frv_sub)

    def mul(self, other) -> "FrArray":
        return self._bin(other, _load().frv_mul)

    def scale(self, s: Fr) -> "FrArray":
        n = len(self.d)
        out = np.empty((n, 4), dtype=np.uint64)
        _load().frv_scale(self.addr(), _fr_addr_cached(s),
                          out.ctypes.data, n)
        return FrArray(out)

    def axpy_inplace(self, s: Fr, b: "FrArray", n: int | None = None) -> None:
        """self[:n] += s * b[:n] in one fused pass (RLC accumulation)."""
        count = len(b) if n is None else n
        ap = self.addr()
        _load().frv_axpy(ap, _fr_addr_cached(s), b.addr(), ap, count)

    def sum(self) -> Fr:
        a = _c(self.d)
        out = np.zeros((1, 4), dtype=np.uint64)
        _load().frv_sum(a, len(a), out)
        return FrArray(out).item(0)

    def dot(self, other) -> Fr:
        a, b = _c(self.d), _c(other.d)
        assert len(a) == len(b)
        out = np.zeros((1, 4), dtype=np.uint64)
        _load().frv_dot(a, b, len(a), out)
        return FrArray(out).item(0)

    def bind_halves(self, lo_hi_split: int, r: Fr,
                    interleaved: bool) -> "FrArray":
        """out = lo + r*(hi - lo) with (lo,hi) = halves or even/odd pairs."""
        if interleaved:
            lo, hi = _c(self.d[0::2]), _c(self.d[1::2])
        else:
            lo, hi = _c(self.d[:lo_hi_split]), _c(self.d[lo_hi_split:])
        out = np.empty_like(lo)
        _load().frv_bind(lo.ctypes.data, hi.ctypes.data,
                         _fr_addr_cached(r),
                         out.ctypes.data, len(lo))
        return FrArray(out)

    def eval_ladder(self, degree: int, interleaved: bool) -> list["FrArray"]:
        """[P(0), P(2), ..., P(degree)] per pair — the sumcheck round evals."""
        n = len(self.d)
        if interleaved:
            lo, hi = _c(self.d[0::2]), _c(self.d[1::2])
        else:
            lo, hi = _c(self.d[: n // 2]), _c(self.d[n // 2:])
        half = len(lo)
        nevals = max(1, degree)  # P(0) plus P(2)..P(degree)
        outs = np.empty((nevals, half, 4), dtype=np.uint64)
        _load().frv_eval_ladder(lo, hi, half, nevals, outs)
        return [FrArray(outs[t]) for t in range(nevals)]


_R2_LIMBS = None


_DUMMY_U64 = np.zeros((1, 4), dtype=np.uint64)
_DUMMY_ADDR = _DUMMY_U64.ctypes.data


def eq_expand(r: list[Fr], scale: Fr | None = None) -> FrArray:
    """eq(r, x) table over {0,1}^len(r) in one C call (r[0] = MSB)."""
    m = len(r)
    rl = np.ascontiguousarray(np.concatenate(
        [_fr_limbs_cached(x) for x in r])) if m else _DUMMY_U64
    sc = _fr_limbs_cached(scale) if scale is not None else _r1_limbs()
    out = np.empty((1 << m, 4), dtype=np.uint64)
    scratch = np.empty((max(1, 1 << (m - 1)) if m else 1, 4),
                       dtype=np.uint64)
    _load().frv_eq_expand(rl.ctypes.data, m, _c(sc).ctypes.data,
                          out.ctypes.data, scratch.ctypes.data)
    return FrArray(out)


def scatter_add(vals: FrArray, idx: np.ndarray, K: int) -> FrArray:
    """out[k] = sum_{j: idx[j]=k} vals[j] (compute_G accumulation)."""
    out = FrArray.zeros(K)
    ii = np.ascontiguousarray(np.asarray(idx).ravel(), dtype=np.int64)
    _load().frv_scatter_add(_c(vals.d), ii, len(ii), out.d, K)
    return out


def fr_inverse(x) -> "Fr | None":
    """Native Fermat inversion (csrc frv_inv) of one Fr scalar; None when
    the native library is unavailable (caller falls back to pow(v,-1,r)).
    Stays on raw byte buffers — no FrArray/cache detours — so the whole
    call is encode + 254-square Fermat + decode (~12 us vs pow's 22 us)."""
    lib = _load()
    if lib is None:
        return None
    buf = np.frombuffer(x.v.to_bytes(32, "little"), dtype=np.uint64)
    out = np.empty(4, dtype=np.uint64)
    lib.frv_inv_canon(buf.ctypes.data, out.ctypes.data, 1)
    return Fr(int.from_bytes(out.tobytes(), "little"))


def horner(coeffs: FrArray, u: Fr) -> Fr:
    """sum_i coeffs[i] * u^i."""
    out = np.zeros((1, 4), dtype=np.uint64)
    _load().frv_horner(_c(coeffs.d), _fr_limbs_cached(u), len(coeffs), out)
    return FrArray(out).item(0)


def matvec_small(m_limbs: np.ndarray, x: "FrArray") -> "FrArray":
    """out = M @ x for a small n x n Montgomery limb matrix ((n*n, 4))."""
    n = len(x)
    assert len(m_limbs) == n * n
    out = np.empty((n, 4), dtype=np.uint64)
    _load().frv_matvec_small(_c(m_limbs).ctypes.data, _c(x.d).ctypes.data,
                             n, out.ctypes.data)
    return FrArray(out)


def unipoly_hint_interp(evals: "FrArray", hint: Fr,
                        vinv_limbs: np.ndarray) -> "FrArray":
    """UniPoly coefficients from the eval ladder [P(0), P(2), ..., P(d)]
    plus the round-claim hint (P(1) = hint - P(0)); one fused C call
    (mirrors UniPoly::from_evals of joltworks/src/poly/unipoly.rs)."""
    nev = len(evals)
    assert len(vinv_limbs) == (nev + 1) * (nev + 1)
    out = np.empty((nev + 1, 4), dtype=np.uint64)
    _load().frv_unipoly_hint_interp(evals.addr(), nev,
                                    _fr_addr_cached(hint),
                                    _np_addr(vinv_limbs),
                                    out.ctypes.data)
    return FrArray(out)


def horner_fr(coeffs: "FrArray", u: Fr) -> Fr:
    """sum_i coeffs[i] * u^i on Montgomery limb coefficients."""
    out = np.zeros((1, 4), dtype=np.uint64)
    _load().frv_horner(_c(coeffs.d), _fr_limbs_cached(u), len(coeffs), out)
    return FrArray(out).item(0)


def mul_seed_cache(a: Fr, b: Fr) -> Fr:
    """a * b where the product's Montgomery limb row is derived from the
    factors' cached rows with one 1-element C multiply and seeded into the
    scalar cache (avoids the ~10x costlier to_bytes+encode when the
    product is next used as a kernel argument)."""
    prod = a * b
    if prod.v not in _SCALAR_CACHE:
        pa, pb = _fr_addr_cached(a), _fr_addr_cached(b)
        out = np.empty((1, 4), dtype=np.uint64)
        oa = out.ctypes.data
        _load().frv_mul(pa, pb, oa, 1)
        if len(_SCALAR_CACHE) > (1 << 17):
            _evict_scalar_cache()
        _SCALAR_CACHE[prod.v] = (out, oa)
    return prod


def i64_dot(ints: np.ndarray, x: "FrArray") -> Fr:
    """sum_i ints[i] * x[i] — one single-limb Montgomery multiply per
    nonzero term (frv_i64_dot); the integer-MLE evaluation hot path."""
    v = np.ascontiguousarray(np.asarray(ints).ravel(), dtype=np.int64)
    assert len(v) == len(x)
    out = np.empty((1, 4), dtype=np.uint64)
    _load().frv_i64_dot(v.ctypes.data, _c(x.d).ctypes.data, len(v),
                        out.ctypes.data)
    return FrArray(out).item(0)


def i64_dot_factored(ints: np.ndarray, r_hi, r_lo) -> Fr:
    """Integer MLE evaluation at the point (r_hi ++ r_lo) via the factored
    eq product eq_hi^T (V eq_lo) — two 2^(m/2) eq tables instead of one
    2^m table (frv_i64_dot2)."""
    v = np.ascontiguousarray(np.asarray(ints).ravel(), dtype=np.int64)
    R, C = 1 << len(r_hi), 1 << len(r_lo)
    assert len(v) == R * C
    hi = eq_expand(list(r_hi))
    lo = eq_expand(list(r_lo))
    out = np.empty((1, 4), dtype=np.uint64)
    _load().frv_i64_dot2(v.ctypes.data, R, C, _c(hi.d).ctypes.data,
                         _c(lo.d).ctypes.data, out.ctypes.data)
    return FrArray(out).item(0)
