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


def _encode_terms_cse(terms, P: int, maxa: int):
    """Encode weighted product terms for the fused C kernels, with CSE:
    factor-prefix subproducts shared by >= 2 terms become aux products
    evaluated once per (pair, eval) — e.g. the satclamp overflow-indicator
    chains appearing in ~10 terms each.

    Returns (coeffs (T,4) Montgomery, offsets, fidx, T, aux_offsets,
    aux_fidx, A); aux slots index rows P..P+A-1."""
    from collections import Counter
    cnt = Counter()
    for _, factors in terms:
        if len(factors) >= 3:
            cnt[tuple(factors[:-1])] += 1
        if len(factors) >= 2:
            cnt[tuple(factors)] += 1
    aux: dict[tuple, int] = {}
    for pref, k in cnt.items():
        if k >= 2 and len(pref) >= 2 and len(aux) < maxa:
            aux[pref] = P + len(aux)
    new_terms = []
    for c, factors in terms:
        tf = tuple(factors)
        if tf in aux:
            new_terms.append((c, [aux[tf]]))
        elif len(factors) >= 3 and tf[:-1] in aux:
            new_terms.append((c, [aux[tf[:-1]], factors[-1]]))
        else:
            new_terms.append((c, list(factors)))
    aux_offs = [0]
    aux_fidx: list[int] = []
    for pref in aux:  # insertion order == slot order
        aux_fidx.extend(pref)
        aux_offs.append(len(aux_fidx))
    coeffs = np.ascontiguousarray(
        np.concatenate([_fr_limbs_cached(c) for c, _ in new_terms]))
    offs = [0]
    fidx: list[int] = []
    for _, factors in new_terms:
        fidx.extend(factors)
        offs.append(len(fidx))
    return (coeffs, np.asarray(offs, dtype=np.int64),
            np.asarray(fidx if fidx else [0], dtype=np.int64),
            len(new_terms),
            np.asarray(aux_offs, dtype=np.int64),
            np.asarray(aux_fidx if aux_fidx else [0], dtype=np.int64),
            len(aux))


class FusedInstance:
    """A sumcheck instance's rows (eq + polys) + weighted product terms,
    evaluated and bound with one C call per round (HighToLow binding).

    terms: list of (Fr coeff, [row indices]); rows: list of FrArray, equal
    lengths. The round message returns the ladder sums [P(0), P(2), ...,
    P(d)] for degree d.
    """

    MAXE = 20
    MAXP = 96  # matches the csrc kernel stack cap (frvec.cpp MAXP)
    MAXA = 16

    def __init__(self, rows: list[FrArray], terms):
        assert len(rows) <= self.MAXP, len(rows)
        n = len(rows[0])
        for rw in rows:
            assert len(rw) == n
        self.n = n
        self.P = len(rows)
        # zero-copy rows; the first bind writes into fresh half-size buffers
        # (copy-on-first-bind), so callers' arrays are never mutated.
        self._rows = [_c(rw.d) for rw in rows]
        self._addrs = [rw.ctypes.data for rw in self._rows]
        self._ptrs = None  # built lazily from _addrs (see ptrs())
        self._rows_shared = True
        (self.coeffs, self.offsets, self.fidx, self.T, self.aux_offsets,
         self.aux_fidx, self.A) = _encode_terms_cse(terms, self.P, self.MAXA)
        self._pending_bind = None  # shared-challenge bind fused by the fleet
        self._preset_q = None      # fleet-precomputed [q(0), q(2)]
        # chunk-table read-check shape: two rows, one coefficient-1 product
        # term — eligible for the per-round frv_pair_fleet batching
        self._pair1 = (self.P == 2 and self.T == 1 and self.A == 0
                       and int(self.offsets[1] - self.offsets[0]) == 2
                       and int(self.fidx[0]) == 0 and int(self.fidx[1]) == 1
                       and bool((self.coeffs[0] == _r1_limbs()[0]).all()))

    def ptrs(self):
        if self._ptrs is None:
            u64p = ctypes.POINTER(ctypes.c_uint64)
            p = (u64p * self.P)()
            pv = ctypes.cast(p, ctypes.POINTER(ctypes.c_uint64))
            for i, a in enumerate(self._addrs):
                pv[i] = a
            self._ptrs = p
        return self._ptrs

    def _flush_pending(self) -> None:
        r = self._pending_bind
        if r is not None:
            self._pending_bind = None
            self._bind_now(r)

    def round_points(self, degree: int) -> list[Fr]:
        if self._preset_q is not None:
            # fleet-precomputed ladder (sumcheck._pair_fleet): the pending
            # bind was already applied by the fleet kernel
            r = self._preset_q
            self._preset_q = None
            return r
        self._flush_pending()
        nevals = max(1, degree)
        assert nevals <= self.MAXE
        out = np.zeros((nevals, 4), dtype=np.uint64)
        _load().frv_terms_round_p(self.ptrs(), self.P, self.n, nevals,
                                  self.coeffs.ctypes.data,
                                  self.offsets.ctypes.data,
                                  self.fidx.ctypes.data,
                                  self.T, self.aux_offsets.ctypes.data,
                                  self.aux_fidx.ctypes.data,
                                  self.A, out.ctypes.data)
        return FrArray(out)

    def bind(self, r: Fr) -> None:
        if self._pair1 and self._pending_bind is None and self.n >= 4:
            # defer: the fleet (or the next round_points flush) applies it
            self._pending_bind = r
            return
        self._flush_pending()
        self._bind_now(r)

    def _bind_now(self, r: Fr) -> None:
        if self._rows_shared:
            half = self.n // 2
            lib = _load()
            rl = _fr_addr_cached(r)
            outs = []
            addrs = []
            for a in self._addrs:
                o = np.empty((half, 4), dtype=np.uint64)
                oa = o.ctypes.data
                lib.frv_bind(a, a + half * 32, rl, oa, half)
                outs.append(o)
                addrs.append(oa)
            self._rows = outs
            self._addrs = addrs
            self._ptrs = None
            self._rows_shared = False
            self.n = half
            return
        _load().frv_bind_rows_p(self.ptrs(), self.P, self.n,
                                _fr_addr_cached(r))
        self.n //= 2

    def row_value(self, p: int) -> Fr:
        self._flush_pending()
        assert self.n == 1
        return FrArray(self._rows[p][:1]).item(0)

    def row_array(self, p: int) -> FrArray:
        self._flush_pending()
        return FrArray(self._rows[p][: self.n].copy())


def _fr_signed(x: Fr):
    """Recover a small signed integer from an Fr, or None."""
    v = x.v
    if v < (1 << 62):
        return v
    w = FR_MODULUS - v
    if w < (1 << 62):
        return -w
    return None


_R2_LIMBS = None


def _r2_limbs() -> np.ndarray:
    """Montgomery form of R (i.e. R^2 mod r) as a (1,4) u64 row."""
    global _R2_LIMBS
    if _R2_LIMBS is None:
        _R2_LIMBS = _fr_limbs(Fr(pow(2, 256, FR_MODULUS)))
    return _R2_LIMBS


_DUMMY_U64 = np.zeros((1, 4), dtype=np.uint64)
_DUMMY_ADDR = _DUMMY_U64.ctypes.data


class GruenInstance:
    """Sumcheck instance rows + product terms with the eq factor handled as
    a Gruen/Dao-Thaler split weight (reference
    joltworks/src/poly/split_eq_poly.rs:67): the per-round message kernel
    receives tiny whi/wlo weight tables instead of a materialized eq row,
    so the eq factor costs O(sqrt n) table rebuilds total instead of a row
    mul per pair per eval plus binding.

    Rows may start as *small integers* (witness values, chunk nibbles,
    one-hot indicators); round 0 then runs in exact signed 128-bit integer
    arithmetic with zero-skip (frv_gruen_round0_i64[fr]) — the dominant
    round at half the total work — and the first challenge binding converts
    to Montgomery rows (frv_bind_rows_i64).

    Weight-table args per round come from poly.spliteq.SplitEq.
    """

    MAXE = 20
    MAXP = 96  # matches the csrc kernel stack cap (frvec.cpp MAXP)
    MAXA = 16

    def __init__(self, rows: list, terms, max_degree: int):
        # rows: FrArray | np.int64 1-D array entries, equal lengths
        assert len(rows) <= self.MAXP, len(rows)
        self.P = len(rows)
        self.terms = [(c, list(f)) for c, f in terms]
        int_rows: list[np.ndarray | None] = []
        for rw in rows:
            if isinstance(rw, FrArray):
                int_rows.append(None)
            else:
                int_rows.append(np.ascontiguousarray(
                    np.asarray(rw).ravel(), dtype=np.int64))
        self.n = (len(rows[0]) if int_rows[0] is None
                  else len(int_rows[0]))
        for i, rw in enumerate(rows):
            ln = len(rw) if int_rows[i] is None else len(int_rows[i])
            assert ln == self.n
        self._int_mode = all(ir is not None for ir in int_rows)
        if self._int_mode and self.n > 1:
            self._irows = int_rows
            self._iptrs = (ctypes.POINTER(ctypes.c_int64) * self.P)(
                *[rw.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
                  for rw in self._irows])
            self._setup_int_encoding(max_degree)
            self._rows = None
        else:
            self._int_mode = False
            self._set_field_rows([
                rows[i] if ir is None else FrArray.from_i64(ir)
                for i, ir in enumerate(int_rows)])
        self._field_enc = None
        self._enc_a = None
        self._pending_bind = None  # lazily-fused field bind (see bind())
        self._preset_q = None      # fleet-precomputed round evals

    # -- integer round-0 path ---------------------------------------------
    def _setup_int_encoding(self, max_degree: int) -> None:
        # static overflow bound: with row magnitudes M, the extension at
        # eval t is |e(t)| <= (2t-1)M; verify rows fit i64 and the summed
        # per-pair term magnitude fits well under 2^126.
        nevals = max(1, max_degree)
        growth = 2 * nevals - 1
        bounds = []
        for rw in self._irows:
            m = int(max(1, np.max(np.abs(rw)))) if len(rw) else 1
            bounds.append(m * growth)
        self._int_ok = all(b < (1 << 62) for b in bounds)
        coeffs_int = []
        total = 0
        for c, factors in self.terms:
            ci = _fr_signed(c)
            coeffs_int.append(ci)
            prod = 1
            for f in factors:
                prod *= bounds[f]
            if prod >= (1 << 124):  # i128 overflow in either int kernel
                self._int_ok = False
            if ci is not None:
                total += abs(ci) * prod
        if not self._int_ok:
            return
        if all(ci is not None for ci in coeffs_int) and total < (1 << 124):
            self._int_kind = "i64"
            self._icoeffs = np.asarray(coeffs_int, dtype=np.int64)
        else:
            self._int_kind = "i64fr"
            rows4 = np.ascontiguousarray(np.concatenate(
                [_fr_limbs_cached(c) for c, _ in self.terms]))
            out = np.empty_like(rows4)
            _load().frv_scale(rows4.ctypes.data, _r2_limbs().ctypes.data,
                              out.ctypes.data, len(rows4))
            self._icoeffs = out  # R2-prescaled Montgomery coefficients
        offs = [0]
        fidx: list[int] = []
        for _, factors in self.terms:
            fidx.extend(factors)
            offs.append(len(fidx))
        self._ioffsets = np.asarray(offs, dtype=np.int64)
        self._ifidx = np.asarray(fidx if fidx else [0], dtype=np.int64)

    def _set_field_rows(self, rows: list[FrArray]) -> None:
        self._rows = [_c(rw.d) for rw in rows]
        self._ptrs = (ctypes.POINTER(ctypes.c_uint64) * self.P)(
            *[rw.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))
              for rw in self._rows])
        self._irows = None
        # copy-on-first-bind: the caller's arrays are only READ until the
        # first challenge; the first bind writes into fresh half-size
        # buffers, so callers never need defensive copies.
        self._rows_shared = True

    def _field_encoding(self):
        if self._field_enc is None:
            self._field_enc = _encode_terms_cse(self.terms, self.P, self.MAXA)
        return self._field_enc

    def _enc_addrs(self):
        """(coeffs_addr, offsets_addr, fidx_addr, T, aux_offs_addr,
        aux_fidx_addr, A) — raw addresses cached once per instance."""
        e = self._enc_a
        if e is None:
            coeffs, offsets, fidx, T, aux_offs, aux_fidx, A = \
                self._field_encoding()
            e = self._enc_a = (coeffs.ctypes.data, offsets.ctypes.data,
                               fidx.ctypes.data, T, aux_offs.ctypes.data,
                               aux_fidx.ctypes.data, A)
        return e

    def _promote(self) -> None:
        """Integer rows -> Montgomery rows without binding (mixed fallback)."""
        self._set_field_rows([FrArray.from_i64(rw) for rw in self._irows])
        self._int_mode = False

    def _flush_pending(self) -> None:
        """Materialize a deferred bind through the plain bind kernel (for
        consumers that read rows without another round: row_value, final
        binds, device-resume fetches)."""
        r = self._pending_bind
        if r is None:
            return
        self._pending_bind = None
        self.bind(r)

    # -- round message -----------------------------------------------------
    def round_points(self, nevals: int, whi, whi_shift: int, wlo,
                     log_wlo: int) -> list[Fr]:
        """[q(0), q(2), ..., q(nevals)] where q is the weighted term sum
        (the eq factor's current-variable line is NOT included — the caller
        assembles s(X) = eq_scalar * l(X) * q(X))."""
        if self._preset_q is not None:
            # fleet-precomputed single-row q(0) (sumcheck._gruen_fleet):
            # the bind was already applied by the fleet kernel
            r = self._preset_q
            self._preset_q = None
            return r
        assert nevals <= self.MAXE
        whi_addr = _np_addr(whi) if whi is not None else _DUMMY_ADDR
        whi_n = len(whi) if whi is not None else 1
        wlo_addr = _np_addr(wlo) if wlo is not None else _DUMMY_ADDR
        out = np.zeros((nevals, 4), dtype=np.uint64)
        if self._pending_bind is not None:
            # fused bind + eval: one streaming pass binds the previous
            # challenge into fresh half-size buffers AND accumulates this
            # round's weighted message evals
            r = self._pending_bind
            self._pending_bind = None
            half = self.n // 2
            ca, oa, fa, T, aoa, afa, A = self._enc_addrs()
            buf = np.empty((self.P, half, 4), dtype=np.uint64)
            base = buf.ctypes.data
            stride = half * 32
            u64p = ctypes.POINTER(ctypes.c_uint64)
            optrs = (u64p * self.P)()
            pv = ctypes.cast(optrs, ctypes.POINTER(ctypes.c_uint64))
            for p in range(self.P):
                pv[p] = base + p * stride
            _load().frv_gruen_round_bind_p(
                self._ptrs, self.P, self.n,
                _fr_addr_cached(r), optrs, nevals,
                ca, oa, fa, T, aoa, afa, A,
                whi_addr, whi_n, whi_shift, wlo_addr,
                log_wlo, out.ctypes.data)
            self._rows = list(buf)
            self._ptrs = optrs
            self._rows_shared = False
            self.n = half
            return FrArray(out)
        if self._int_mode:
            if not self._int_ok:
                self._promote()
            else:
                fn = (_load().frv_gruen_round0_i64 if self._int_kind == "i64"
                      else _load().frv_gruen_round0_i64fr)
                fn(self._iptrs, self.P, self.n, nevals,
                   self._icoeffs.ctypes.data, self._ioffsets.ctypes.data,
                   self._ifidx.ctypes.data, len(self.terms),
                   whi_addr, whi_n, whi_shift, wlo_addr,
                   log_wlo, out.ctypes.data)
                return FrArray(out)
        ca, oa, fa, T, aoa, afa, A = self._enc_addrs()
        _load().frv_gruen_round_p(self._ptrs, self.P, self.n, nevals,
                                  ca, oa, fa, T, aoa, afa, A,
                                  whi_addr, whi_n, whi_shift,
                                  wlo_addr, log_wlo,
                                  out.ctypes.data)
        return FrArray(out)

    # -- binding -----------------------------------------------------------
    def bind(self, r: Fr) -> None:
        if not self._int_mode and self.n >= 4:
            # defer: the next round_points fuses this bind into its eval
            # pass (csrc frv_gruen_round_bind_p) — the standalone bind
            # passes were ~51% of the engine's time (SCALING.md round 3)
            assert self._pending_bind is None
            self._pending_bind = r
            return
        self._flush_pending()
        if self._int_mode:
            half = self.n // 2
            outs = [np.empty((half, 4), dtype=np.uint64)
                    for _ in range(self.P)]
            optrs = (ctypes.POINTER(ctypes.c_uint64) * self.P)(
                *[o.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))
                  for o in outs])
            _load().frv_bind_rows_i64(self._iptrs, self.P, self.n,
                                      _fr_addr_cached(r), optrs)
            self._rows = outs
            self._ptrs = optrs
            self._irows = None
            self._int_mode = False
            self._rows_shared = False
            self.n = half
            return
        if self._rows_shared:
            # first field bind: write into fresh half-size buffers instead
            # of mutating the caller's arrays
            half = self.n // 2
            lib = _load()
            rl = _fr_addr_cached(r)
            outs = []
            for rw in self._rows:
                o = np.empty((half, 4), dtype=np.uint64)
                d = rw.ctypes.data
                lib.frv_bind(d, d + half * 32, rl, o.ctypes.data, half)
                outs.append(o)
            self._rows = outs
            self._ptrs = (ctypes.POINTER(ctypes.c_uint64) * self.P)(
                *[o.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))
                  for o in outs])
            self._rows_shared = False
            self.n = half
            return
        _load().frv_bind_rows_p(self._ptrs, self.P, self.n,
                                _fr_addr_cached(r))
        self.n //= 2

    def row_value(self, p: int) -> Fr:
        self._flush_pending()
        assert self.n == 1
        if self._int_mode:
            return Fr(int(self._irows[p][0]))
        return FrArray(self._rows[p][:1]).item(0)

    def row_array(self, p: int) -> FrArray:
        self._flush_pending()
        if self._int_mode:
            return FrArray.from_i64(self._irows[p][: self.n])
        return FrArray(self._rows[p][: self.n].copy())


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


def scatter_const_ranges(acc: FrArray, gammas: list, idx_list: list,
                         init: bool = False) -> None:
    """acc[idx_list[j][t]] += gammas[j] for every member j (batched
    one-hot RLC accumulation for the opening-reduction prepare,
    poly/opening.py). Equal-length members (the normal case: a group
    shares its opening point, hence its cycle count T, and one-hot
    members carry exactly one position per cycle with position ≡ cycle
    mod T) take the collision-free cycle-partitioned single pass
    (frv_scatter_cycles); mixed lengths fall back to the
    range-partitioned scan kernel. ``init=True`` lets the scan kernel
    fuse the accumulator zero-fill into its thread partitions (acc may be
    freshly allocated, uninitialized)."""
    if not idx_list:
        if init:
            _load().frv_zero(acc.addr(), 4 * len(acc))
        return
    gl = np.ascontiguousarray(np.concatenate(
        [_fr_limbs_cached(g) for g in gammas]))
    parts = [np.ascontiguousarray(np.asarray(ix).ravel(), dtype=np.int64)
             for ix in idx_list]
    T = len(parts[0])
    if (T & (T - 1)) == 0 and all(len(p) == T for p in parts) and all(
            bool(((p & (T - 1)) == np.arange(T, dtype=np.int64)).all())
            for p in parts):
        iptrs = (ctypes.POINTER(ctypes.c_int64) * len(parts))(
            *[p.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
              for p in parts])
        if init:
            _load().frv_zero(acc.addr(), 4 * len(acc))
        _load().frv_scatter_cycles(gl.ctypes.data, len(parts), iptrs, T,
                                   acc.d.ctypes.data)
        return
    offs = np.zeros(len(parts) + 1, dtype=np.int64)
    np.cumsum([len(p) for p in parts], out=offs[1:])
    idx = np.ascontiguousarray(np.concatenate(parts), dtype=np.int64)
    _load().frv_scatter_const_ranges(gl, offs, len(parts), idx, acc.d,
                                     len(acc), 1 if init else 0)


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


def inv_batch(xs: "FrArray") -> "FrArray":
    """Montgomery-batched inversion of a limb vector (zeros map to zero)."""
    out = np.empty_like(xs.d)
    _load().frv_inv(_c(xs.d).ctypes.data, out.ctypes.data, len(xs))
    return FrArray(out)


def onehot_qev(idx_list: list, U: FrArray, whi, whi_shift: int, wlo,
               log_wlo: int, low_bits: int, logT: int,
               gammas: list) -> tuple:
    """Sparse Booleanity address-round message evals [q(0), q(2)] in one
    fused C pass over the (D, T) chunk-index arrays (onehot.py
    BooleanityProver phase 1). whi/wlo are the split-eq weight tables
    (Montgomery limb arrays or None), U the per-value bound-prefix
    weights, gammas the chunk batching coefficients."""
    D = len(idx_list)
    assert D >= 1
    T = len(idx_list[0])
    K = len(U)
    # chunk tables are K_CHUNK-sized; GatherSmall ra families go up to
    # 2^16 dictionary rows (the C kernel's G buffer is (D, K) Fr4 per
    # thread: 8 MB at the 2^16 cap)
    assert K <= (1 << 16), K
    iptrs = (ctypes.POINTER(ctypes.c_int64) * D)(
        *[ix.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
          for ix in idx_list])
    whi_a = _c(whi) if whi is not None else _DUMMY_U64
    whi_n = len(whi_a) if whi is not None else 1
    wlo_a = _c(wlo) if wlo is not None else _DUMMY_U64
    gl = np.ascontiguousarray(np.concatenate(
        [_fr_limbs_cached(g) for g in gammas]))
    out = np.zeros((2, 4), dtype=np.uint64)
    _load().frv_onehot_qev(iptrs, D, T, _c(U.d).ctypes.data, K,
                           whi_a.ctypes.data, whi_n, whi_shift,
                           wlo_a.ctypes.data, log_wlo, low_bits, logT,
                           gl.ctypes.data, out.ctypes.data)
    fa = FrArray(out)
    return fa.item(0), fa.item(1)


def syndiv(coeffs: FrArray, u: Fr) -> FrArray:
    """Quotient of (f(X) - f(u)) / (X - u) for the KZG opening witness.

    The C kernel stores ascending (descending stores fall off the write-
    combining cliff past L2); the single numpy flip restores coefficient
    order at memory bandwidth."""
    n = len(coeffs)
    q = np.empty((n - 1, 4), dtype=np.uint64)
    _load().frv_syndiv_rev(_c(coeffs.d), _fr_limbs_cached(u), n, q)
    return FrArray(np.ascontiguousarray(q[::-1]))


def horner(coeffs: FrArray, u: Fr) -> Fr:
    """sum_i coeffs[i] * u^i."""
    out = np.zeros((1, 4), dtype=np.uint64)
    _load().frv_horner(_c(coeffs.d), _fr_limbs_cached(u), len(coeffs), out)
    return FrArray(out).item(0)


def i64_mat_vec(m: np.ndarray, x: FrArray) -> FrArray:
    """out[k] = sum_e m[k, e] * x[e] — bind an integer matrix against a
    field vector (dictionary/eq binding for GatherLarge)."""
    mm = np.ascontiguousarray(m, dtype=np.int64)
    V, E = mm.shape
    assert len(x) == E
    out = np.empty((V, 4), dtype=np.uint64)
    _load().frv_i64_mat_vec(mm.reshape(-1), _c(x.d), V, E, out)
    return FrArray(out)


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


def gruen_assemble(qev: "FrArray", claim: Fr, es: Fr, es_inv: Fr, l0: Fr,
                   l1: Fr, l1_inv: Fr, vinv_limbs: np.ndarray) -> "FrArray":
    """s(X) = es * l(X) * q(X) coefficients from the Gruen product evals
    [q(0), q(2), ..., q(d)] in one C call (sumcheck.py _gruen_assemble)."""
    nq = len(qev)
    assert len(vinv_limbs) == (nq + 1) * (nq + 1)
    out = np.empty((nq + 2, 4), dtype=np.uint64)
    # bind every cached limb row to a local BEFORE taking .ctypes.data:
    # a later _fr_limbs_cached lookup may evict the cache (its only
    # reference), freeing rows whose raw pointers were already taken
    # the eviction stash (see _evict_scalar_cache) keeps every row alive
    # through this call even if a lookup below triggers an eviction
    _load().frv_gruen_assemble(
        qev.addr(), nq, _fr_addr_cached(claim), _fr_addr_cached(es),
        _fr_addr_cached(es_inv), _fr_addr_cached(l0), _fr_addr_cached(l1),
        _fr_addr_cached(l1_inv), _np_addr(vinv_limbs), out.ctypes.data)
    return FrArray(out)


def horner_fr(coeffs: "FrArray", u: Fr) -> Fr:
    """sum_i coeffs[i] * u^i on Montgomery limb coefficients."""
    out = np.zeros((1, 4), dtype=np.uint64)
    _load().frv_horner(_c(coeffs.d), _fr_limbs_cached(u), len(coeffs), out)
    return FrArray(out).item(0)


class RoundBatch:
    """One batched-sumcheck round's instance messages: pointer/length
    tables built once, shared by the accumulate (frv_axpy_multi) and
    challenge-evaluation (frv_horner_multi) calls — two C calls per round
    total, regardless of instance count."""

    __slots__ = ("arrs", "K", "_ptrs", "_lens", "_pa", "_la")

    def __init__(self, arrs: list["FrArray"]):
        self.arrs = arrs  # keeps every message's limb buffer alive
        self.K = len(arrs)
        self._ptrs = np.fromiter((a.addr() for a in arrs),
                                 dtype=np.uintp, count=self.K)
        self._lens = np.fromiter((len(a.d) for a in arrs),
                                 dtype=np.int64, count=self.K)
        self._pa = self._ptrs.ctypes.data
        self._la = self._lens.ctypes.data

    def maxlen(self) -> int:
        return int(self._lens.max()) if self.K else 0

    def accumulate(self, acc: "FrArray", scalars: list) -> None:
        """acc[:len(p_i)] += scalars[i] * p_i for every message."""
        # bind cached rows to a local list before taking raw pointers
        # (cache eviction frees rows whose pointers were already taken)
        rows = [_fr_limbs_cached(s) for s in scalars]
        sl = np.concatenate(rows) if rows else _DUMMY_U64
        _load().frv_axpy_multi(acc.addr(), self._pa, self._la,
                               sl.ctypes.data, self.K)

    def horner(self, r: Fr) -> list[Fr]:
        """[p_i(r)] in one C call; results are batch-decoded and their
        limb rows seeded into the scalar cache (each claim immediately
        returns as the hint of the next round's message)."""
        K = self.K
        out = np.empty((K, 4), dtype=np.uint64)
        _load().frv_horner_multi(self._pa, self._la, K,
                                 _fr_addr_cached(r),
                                 out.ctypes.data)
        can = np.empty_like(out)
        _load().frv_decode(out.ctypes.data, can.ctypes.data, K)
        b = can.tobytes()
        res = []
        cache = _SCALAR_CACHE
        for i in range(K):
            f = Fr(int.from_bytes(b[32 * i: 32 * i + 32], "little"))
            if f.v not in cache:
                row = np.ascontiguousarray(out[i: i + 1])
                cache[f.v] = (row, row.ctypes.data)
            res.append(f)
        return res


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


def gruen1_fleet(cands, c_prev) -> None:
    """One C call for ALL single-row degree-2 Gruen instances of a
    batched-sumcheck round (frv_gruen1_fleet): binds the shared previous
    challenge where pending and computes each instance's q(0), presetting
    it for the instance's next round_points call. `cands` is a list of
    (GruenInstance, (whi, whi_shift, wlo, log_wlo)) pairs."""
    K = len(cands)
    rows_p = np.empty(K, dtype=np.uintp)
    outs_p = np.empty(K, dtype=np.uintp)
    whis_p = np.empty(K, dtype=np.uintp)
    wlos_p = np.empty(K, dtype=np.uintp)
    ns = np.empty(K, dtype=np.int64)
    binds = np.empty(K, dtype=np.int64)
    whi_ns = np.empty(K, dtype=np.int64)
    shifts = np.empty(K, dtype=np.int64)
    logls = np.empty(K, dtype=np.int64)
    keep = []  # buffers that must outlive the call
    new_rows = []
    u64p = ctypes.POINTER(ctypes.c_uint64)
    for k, (g, (whi, shift, wlo, log_wlo)) in enumerate(cands):
        row = g._rows[0]
        rows_p[k] = row.ctypes.data
        if g._pending_bind is not None:
            half = g.n // 2
            ob = np.empty((half, 4), dtype=np.uint64)
            outs_p[k] = ob.ctypes.data
            binds[k] = 1
            new_rows.append(ob)
        else:
            outs_p[k] = _DUMMY_ADDR
            binds[k] = 0
            new_rows.append(None)
        ns[k] = g.n
        whis_p[k] = _np_addr(whi) if whi is not None else _DUMMY_ADDR
        whi_ns[k] = len(whi) if whi is not None else 1
        shifts[k] = shift
        wlos_p[k] = _np_addr(wlo) if wlo is not None else _DUMMY_ADDR
        logls[k] = log_wlo
        keep.append(row)
    out = np.empty((K, 4), dtype=np.uint64)
    _load().frv_gruen1_fleet(rows_p.ctypes.data, outs_p.ctypes.data,
                             ns.ctypes.data,
                             binds.ctypes.data, K,
                             _fr_addr_cached(c_prev),
                             whis_p.ctypes.data, whi_ns.ctypes.data,
                             shifts.ctypes.data,
                             wlos_p.ctypes.data, logls.ctypes.data,
                             out.ctypes.data)
    for k, (g, _) in enumerate(cands):
        if binds[k]:
            ob = new_rows[k]
            g._pending_bind = None
            g._rows = [ob]
            p1 = (u64p * 1)()
            ctypes.cast(p1, ctypes.POINTER(ctypes.c_uint64))[0] = \
                outs_p[k]
            g._ptrs = p1
            g._rows_shared = False
            g.n //= 2
        g._preset_q = FrArray(np.ascontiguousarray(out[k:k + 1]))


def pair_fleet(cands, c_prev: Fr) -> None:
    """One C call (frv_pair_fleet) for ALL two-row coefficient-1 product
    instances of a batched-sumcheck round (the per-node chunk-table read
    checks: ~2,400 tiny 4-round instances per bench prove). Binds the
    SHARED previous challenge where pending and presets each instance's
    [q(0), q(2)] ladder for its next round_points call."""
    M = len(cands)
    rows_p = np.empty(2 * M, dtype=np.uintp)
    outs_p = np.empty(2 * M, dtype=np.uintp)
    ns = np.empty(M, dtype=np.int64)
    binds = np.empty(M, dtype=np.int64)
    newbufs: list = []
    for k, f in enumerate(cands):
        a = f._addrs
        rows_p[2 * k] = a[0]
        rows_p[2 * k + 1] = a[1]
        ns[k] = f.n
        if f._pending_bind is not None:
            half = f.n // 2
            buf = np.empty((2, half, 4), dtype=np.uint64)
            ba = buf.ctypes.data
            outs_p[2 * k] = ba
            outs_p[2 * k + 1] = ba + half * 32
            binds[k] = 1
            newbufs.append((buf, ba, ba + half * 32))
        else:
            outs_p[2 * k] = _DUMMY_ADDR
            outs_p[2 * k + 1] = _DUMMY_ADDR
            binds[k] = 0
            newbufs.append(None)
    out = np.empty((M, 2, 4), dtype=np.uint64)
    _load().frv_pair_fleet(rows_p.ctypes.data, outs_p.ctypes.data,
                           ns.ctypes.data, binds.ctypes.data, M,
                           _fr_addr_cached(c_prev), out.ctypes.data)
    for k, f in enumerate(cands):
        nb = newbufs[k]
        if nb is not None:
            buf, a0, a1 = nb
            f._pending_bind = None
            f._rows = [buf[0], buf[1]]
            f._addrs = [a0, a1]
            f._ptrs = None
            f._rows_shared = False
            f.n //= 2
        f._preset_q = FrArray(out[k])


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
