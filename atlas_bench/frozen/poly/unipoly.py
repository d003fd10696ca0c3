"""Univariate round polynomials for sumcheck.

Mirrors reference joltworks/src/poly/unipoly.rs: a UniPoly is stored as
coefficients; the prover sends a *compressed* form that omits the linear
term (the verifier recovers it from the round claim via
linear = claim - 2*c0 - c2 - ... ), and transcript absorption wraps the
compressed coefficients in UniPoly_begin/UniPoly_end marker messages
(unipoly.rs:504-557).

Coefficients live in one of two interchangeable backings:
  - a list of Python `Fr` (verifier paths, deserialized proofs), or
  - an `FrArray` of Montgomery limb rows (prover hot path) — the round
    loops then run interpolation / scale-accumulate / Horner evaluation /
    transcript byte framing as single C calls (csrc/frvec.cpp
    frv_unipoly_hint_interp / frv_axpy / frv_horner) instead of per-
    coefficient bigint arithmetic.
Conversion is lazy and cached; protocol bytes are identical either way.
"""

from __future__ import annotations

import numpy as np

from ..field import frvec
from ..field.frvec import FrArray
from ..field.scalar import Fr, batch_inverse


_VINV_CACHE: dict[int, list[list[Fr]]] = {}
_VINV_LIMBS_CACHE: dict[int, "object"] = {}


def _vinv(n: int) -> list[list[Fr]]:
    """Inverse of the (n x n) Vandermonde matrix V_ij = i^j over Fr,
    computed once per degree (coeffs = Vinv @ evals; interpolation then
    costs n^2 field muls instead of a Gaussian elimination per call)."""
    got = _VINV_CACHE.get(n)
    if got is not None:
        return got
    mat = [[Fr(pow(i, j)) for j in range(n)] for i in range(n)]
    inv = [[Fr.one() if i == j else Fr.zero() for j in range(n)]
           for i in range(n)]
    for col in range(n):
        piv = next(r for r in range(col, n) if not mat[r][col].is_zero())
        mat[col], mat[piv] = mat[piv], mat[col]
        inv[col], inv[piv] = inv[piv], inv[col]
        s = mat[col][col].inverse()
        mat[col] = [x * s for x in mat[col]]
        inv[col] = [x * s for x in inv[col]]
        for r in range(n):
            if r != col and not mat[r][col].is_zero():
                f = mat[r][col]
                mat[r] = [x - f * y for x, y in zip(mat[r], mat[col])]
                inv[r] = [x - f * y for x, y in zip(inv[r], inv[col])]
    _VINV_CACHE[n] = inv
    return inv


def vinv_limbs(n: int):
    """Flattened (n*n, 4) Montgomery limb form of _vinv(n) for the C
    interpolation kernels."""
    got = _VINV_LIMBS_CACHE.get(n)
    if got is None:
        flat = [x for row in _vinv(n) for x in row]
        got = _VINV_LIMBS_CACHE[n] = FrArray.from_fr_list(flat).d
    return got


_NODES_VINV_CACHE: dict[tuple, list[list[Fr]]] = {}


def interpolate_at_nodes(nodes: list[int], evals: list[Fr]) -> list[Fr]:
    """Coefficients of the unique polynomial through
    (nodes[i], evals[i]) for an arbitrary (small) integer node grid —
    used by the degenerate-eq-line sumcheck fallback, where the standard
    {0..d} grid is missing the point 1."""
    key = tuple(nodes)
    vinv = _NODES_VINV_CACHE.get(key)
    if vinv is None:
        n = len(nodes)
        mat = [[Fr(pow(x, j)) for j in range(n)] for x in nodes]
        inv = [[Fr.one() if i == j else Fr.zero() for j in range(n)]
               for i in range(n)]
        for col in range(n):
            piv = next(r for r in range(col, n)
                       if not mat[r][col].is_zero())
            mat[col], mat[piv] = mat[piv], mat[col]
            inv[col], inv[piv] = inv[piv], inv[col]
            s = mat[col][col].inverse()
            mat[col] = [x * s for x in mat[col]]
            inv[col] = [x * s for x in inv[col]]
            for r in range(n):
                if r != col and not mat[r][col].is_zero():
                    f = mat[r][col]
                    mat[r] = [x - f * y for x, y in zip(mat[r], mat[col])]
                    inv[r] = [x - f * y for x, y in zip(inv[r], inv[col])]
        vinv = _NODES_VINV_CACHE[key] = inv
    out = []
    for row in vinv:
        acc = Fr.zero()
        for x, e in zip(row, evals):
            if not x.is_zero():
                acc = acc + x * e
        out.append(acc)
    return out


def _interpolate_at_0_to_d(evals: list[Fr]) -> list[Fr]:
    """Lagrange interpolation through points (0, e0), ..., (d, ed) -> coeffs."""
    n = len(evals)
    vinv = _vinv(n)
    out = []
    for row in vinv:
        acc = row[0] * evals[0]
        for x, e in zip(row[1:], evals[1:]):
            if not x.is_zero():
                acc = acc + x * e
        out.append(acc)
    return out


class UniPoly:
    __slots__ = ("_coeffs", "_arr")

    def __init__(self, coeffs=None, arr=None):
        self._coeffs = list(coeffs) if coeffs is not None else None
        self._arr = arr
        assert self._coeffs is not None or self._arr is not None

    @property
    def coeffs(self) -> list[Fr]:
        if self._coeffs is None:
            self._coeffs = self._arr.to_fr_list()
        return self._coeffs

    def ncoeffs(self) -> int:
        if self._coeffs is not None:
            return len(self._coeffs)
        return len(self._arr)

    def arr(self):
        """FrArray limb backing (converting and caching if list-backed).
        Small coefficient lists convert through the scalar limb cache —
        constant round polys (claim * 2^k) are seeded there by _mul_pow2,
        so the common case is a cache-hit concat, not an encode pass."""
        if self._arr is None:
            c = self._coeffs
            if len(c) <= 4:
                rows = [frvec._fr_limbs_cached(x) for x in c]
                self._arr = FrArray(
                    np.concatenate(rows) if rows
                    else np.empty((0, 4), dtype=np.uint64))
            else:
                self._arr = FrArray.from_fr_list(c)
        return self._arr

    @classmethod
    def from_evals(cls, evals) -> "UniPoly":
        """Interpolate from evaluations at 0, 1, ..., d. `evals` may be a
        list of Fr or an FrArray (native interpolation)."""
        if not isinstance(evals, list):
            if frvec.available():
                n = len(evals)
                arr = frvec.matvec_small(vinv_limbs(n), evals)
                return cls(arr=arr)
            evals = evals.to_fr_list()
        return cls(_interpolate_at_0_to_d(evals))

    @classmethod
    def from_evals_and_hint(cls, hint: Fr, evals) -> "UniPoly":
        """evals = [P(0), P(2), P(3), ..., P(d)]; P(1) = hint - P(0)."""
        if not isinstance(evals, list):
            if frvec.available():
                arr = frvec.unipoly_hint_interp(evals, hint,
                                                vinv_limbs(len(evals) + 1))
                return cls(arr=arr)
            evals = evals.to_fr_list()
        full = [evals[0], hint - evals[0]] + list(evals[1:])
        return cls.from_evals(full)

    def degree(self) -> int:
        return self.ncoeffs() - 1

    def evaluate(self, x: Fr) -> Fr:
        if self._coeffs is None:
            return frvec.horner_fr(self._arr, x)
        acc = Fr.zero()
        for c in reversed(self._coeffs):
            acc = acc * x + c
        return acc

    def __add__(self, other: "UniPoly") -> "UniPoly":
        if self._coeffs is None or other._coeffs is None:
            a, b = self.arr(), other.arr()
            if len(a) < len(b):
                a, b = b, a
            out = FrArray(a.d.copy())
            out.axpy_inplace(Fr.one(), b)
            return UniPoly(arr=out)
        n = max(len(self._coeffs), len(other._coeffs))
        a = self._coeffs + [Fr.zero()] * (n - len(self._coeffs))
        b = other._coeffs + [Fr.zero()] * (n - len(other._coeffs))
        return UniPoly([x + y for x, y in zip(a, b)])

    def scale(self, k: Fr) -> "UniPoly":
        if self._coeffs is None:
            return UniPoly(arr=self._arr.scale(k))
        return UniPoly([c * k for c in self._coeffs])

    def compress(self) -> "CompressedUniPoly":
        if self._coeffs is None and self.ncoeffs() >= 2:
            d = self._arr.d
            return CompressedUniPoly(
                arr=FrArray(np.ascontiguousarray(
                    np.concatenate([d[0:1], d[2:]]))))
        c = self.coeffs
        if len(c) < 2:
            return CompressedUniPoly(list(c))
        return CompressedUniPoly([c[0]] + c[2:])


class CompressedUniPoly:
    """Round poly with the linear term omitted (recovered from the claim)."""

    __slots__ = ("_coeffs", "_arr")

    def __init__(self, coeffs_except_linear_term=None, arr=None):
        self._coeffs = (list(coeffs_except_linear_term)
                        if coeffs_except_linear_term is not None else None)
        self._arr = arr
        assert self._coeffs is not None or self._arr is not None

    @property
    def coeffs_except_linear_term(self) -> list[Fr]:
        if self._coeffs is None:
            self._coeffs = self._arr.to_fr_list()
        return self._coeffs

    def degree(self) -> int:
        if self._coeffs is not None:
            return len(self._coeffs)
        return len(self._arr)

    def _linear_term(self, hint: Fr) -> Fr:
        c = self.coeffs_except_linear_term
        lin = hint - c[0] - c[0]
        for x in c[1:]:
            lin = lin - x
        return lin

    def decompress(self, hint: Fr) -> UniPoly:
        c = self.coeffs_except_linear_term
        return UniPoly([c[0], self._linear_term(hint)] + c[1:])

    def eval_from_hint(self, hint: Fr, x: Fr) -> Fr:
        if self._coeffs is None:
            # limb path (deserialized proofs): full poly =
            # c0 + lin*X + X^2 * (c2 + c3 X + ...) with
            # lin = hint - 2 c0 - sum(c2..)
            a = self._arr
            c0 = a.item(0)
            lin = hint - c0 - c0
            if len(a) > 1:
                tail = FrArray(a.d[1:])
                lin = lin - tail.sum()
                return c0 + lin * x + x * x * frvec.horner_fr(tail, x)
            return c0 + lin * x
        return self.decompress(hint).evaluate(x)

    def append_to_transcript(self, transcript) -> None:
        # one absorb for the whole message (framing byte + coefficient
        # bytes): ~8 sumcheck-round hash updates collapse to 1 — measured
        # ~0.1 s/verify of hashlib call overhead on the bench model
        if self._coeffs is None:
            # canonical (LE-limb) rows -> big-endian 32-byte words in one
            # vectorized pass; byte-identical to Fr.to_bytes_be per coeff
            can = self._arr.canonical()
            transcript.append_bytes(
                b"UniPoly\x01" + can[:, ::-1].byteswap().tobytes())
            return
        transcript.append_bytes(
            b"UniPoly\x01"
            + b"".join(c.to_bytes_be() for c in self._coeffs))

    def serialize(self) -> bytes:
        if self._coeffs is None:
            can = self._arr.canonical()
            return len(can).to_bytes(8, "little") + can.tobytes()
        out = len(self._coeffs).to_bytes(8, "little")
        for c in self._coeffs:
            out += c.to_bytes_le()
        return out

    @classmethod
    def deserialize(cls, data: bytes, offset: int = 0):
        n = int.from_bytes(data[offset:offset + 8], "little")
        offset += 8
        blob = data[offset:offset + 32 * n]
        offset += 32 * n
        if n and frvec.available():
            # straight to Montgomery limb rows (one C call) — the
            # verifier's re-absorb and eval_from_hint run limb-native.
            # Out-of-range bytes reduce mod r exactly like
            # Fr.from_bytes_le, so transcript bytes are unchanged.
            raw = np.frombuffer(blob, dtype=np.uint64).reshape(n, 4).copy()
            enc = np.empty_like(raw)
            frvec._load().frv_encode(raw, enc, n)
            return cls(arr=frvec.FrArray(enc)), offset
        coeffs = [Fr.from_bytes_le(blob[i * 32:(i + 1) * 32])
                  for i in range(n)]
        return cls(coeffs), offset
