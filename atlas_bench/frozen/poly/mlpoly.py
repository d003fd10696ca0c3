"""Multilinear polynomials over the boolean hypercube.

Mirrors the reference's MultilinearPolynomial enum
(joltworks/src/poly/multilinear_polynomial.rs:22-35): coefficients start as
*small integers* (the witness data: i32/i64/u16/bool) held in numpy int
arrays, and are lazily promoted to field vectors on the first challenge
binding — the reference's CompactPolynomial lazy conversion.

Field vectors use the native Montgomery-limb FrArray (field/frvec.py)
with an object-int fallback (field/vec.py); accelerator offload happens in
the engines that consume MLPolys (tpu/reduction.py, parallel/shardedrows.py),
not inside this container.

Index convention is big-endian (index bit 0 = MSB = variable 0), matching
EqPolynomial::evals (eq_poly.rs:62-92). Binding supports both orders
(multilinear_polynomial.rs:421-447):
  - HighToLow: pairs (i, i + n/2), binds the MSB variable first.
  - LowToHigh: pairs (2i, 2i+1), binds the LSB variable first.
"""

from __future__ import annotations

import enum

import numpy as np

from ..field import vec
from ..field.scalar import Fr
from .eq import eq_evals


class BindingOrder(enum.Enum):
    HighToLow = "high_to_low"
    LowToHigh = "low_to_high"


class MLPoly:
    """A multilinear polynomial given by its 2^n hypercube evaluations."""

    def __init__(self, ints=None, fvec=None, onehot_indices=None,
                 length=None):
        if ints is not None:
            ints = np.asarray(ints)
            assert ints.ndim == 1
            n = len(ints)
            assert n & (n - 1) == 0 and n > 0, "length must be a power of two"
            self.ints = ints
            self.fvec = None
            self._len = n
        elif fvec is not None:
            self.ints = None
            self.fvec = vec.as_native(fvec)
            self._len = len(fvec)
        else:
            # lazy one-hot: only the 1-positions are stored; the dense
            # K*T array (the LM-head cliff at vocab scale: 2^24 entries
            # per chunk) is never materialized unless a consumer
            # explicitly asks (to_ints/to_field)
            assert onehot_indices is not None and length is not None
            assert length & (length - 1) == 0 and length > 0
            self.ints = None
            self.fvec = None
            self._len = length
        # sparse descriptor: flat positions of the 1-entries (one-hot ra
        # polys) — lets the opening RLC scatter gamma instead of axpy-ing
        # the whole dense vector
        self.onehot_indices = onehot_indices

    # -- basics ------------------------------------------------------------
    def __len__(self) -> int:
        return self._len

    @property
    def num_vars(self) -> int:
        return self._len.bit_length() - 1

    @classmethod
    def from_fr_list(cls, elems: list[Fr]) -> "MLPoly":
        return cls(fvec=vec.from_fr(elems))

    def clone(self) -> "MLPoly":
        if self.ints is not None:
            return MLPoly(ints=self.ints.copy())
        return MLPoly(fvec=self.fvec.copy())

    def to_ints(self) -> np.ndarray:
        """Dense integer coefficients (materializes lazy one-hots)."""
        if self.ints is None and self.fvec is None:
            arr = np.zeros(self._len, dtype=np.int64)
            arr[self.onehot_indices] = 1
            self.ints = arr
        return self.ints

    def to_field(self):
        """Field vector of the coefficients (FrArray on the native path)."""
        if self.fvec is None:
            if self.ints is None and self.onehot_indices is not None:
                from ..field import frvec
                if frvec.available():
                    d = np.zeros((self._len, 4), dtype=np.uint64)
                    d[self.onehot_indices] = frvec._r1_limbs()[0]
                    self.fvec = frvec.FrArray(d)
                    return self.fvec
                self.to_ints()
            self.fvec = vec.from_ints(self.ints)
        return self.fvec

    def is_small(self) -> bool:
        return self.ints is not None

    # -- binding -----------------------------------------------------------
    def bind(self, r: Fr, order: BindingOrder) -> None:
        """Bind one variable: c'(x) = c(0,x) + r * (c(1,x) - c(0,x))."""
        arr = self.to_field()
        n = len(arr)
        assert n > 1
        from ..field.frvec import FrArray
        if isinstance(arr, FrArray):
            self.fvec = arr.bind_halves(
                n // 2, r, interleaved=(order == BindingOrder.LowToHigh))
        else:
            if order == BindingOrder.HighToLow:
                lo, hi = arr[: n // 2], arr[n // 2 :]
            else:
                lo, hi = arr[0::2], arr[1::2]
            self.fvec = vec.vadd(lo, vec.vscale(vec.vsub(hi, lo), r))
        self.ints = None
        self._len = n // 2

    def final_claim(self) -> Fr:
        assert self._len == 1
        if self.fvec is not None:
            return vec.elem(self.fvec, 0)
        return Fr(int(self.ints[0]))

    def get_coeff(self, i: int) -> Fr:
        if self.fvec is not None:
            return vec.elem(self.fvec, i)
        return Fr(int(self.ints[i]))

    # -- evaluation --------------------------------------------------------
    def evaluate(self, r: list[Fr]) -> Fr:
        """Evaluate at r (big-endian: r[0] is the MSB variable)."""
        assert len(r) == self.num_vars
        if not r:
            return self.final_claim()
        if self.ints is not None:
            # integer fast path: one single-limb Montgomery multiply per
            # nonzero coefficient, skipping the full i64 -> Montgomery
            # conversion of the coefficients entirely. Past 2^16 points
            # the eq table factors into hi/lo halves (frv_i64_dot2) so a
            # 2^26-coefficient GPT-2 constant needs two 2^13 tables, not
            # one 2 GB table.
            from ..field import frvec
            if frvec.available():
                if len(r) > 8:
                    # the factored form wins as soon as the full table's
                    # n fr_muls dominate the two sqrt-n tables plus n
                    # single-limb muls (~2^8); identical field values, so
                    # proof bytes are unchanged. Measured: 109 full-table
                    # evaluates were the verifier's top cost (0.63s of a
                    # contended 1.5s bench verify profile).
                    h = len(r) // 2
                    return frvec.i64_dot_factored(self.ints, r[:h], r[h:])
                return frvec.i64_dot(self.ints, frvec.eq_expand(r))
        eq = eq_evals(r)
        return vec.vdot(eq, self.to_field())

    def evaluate_lowtohigh(self, r: list[Fr]) -> Fr:
        """Evaluate where r is in LowToHigh binding order (LSB first)."""
        return self.evaluate(list(reversed(r)))

    # -- sumcheck round messages -------------------------------------------
    def sumcheck_evals(self, degree: int, order: BindingOrder):
        """Per-pair univariate evaluations [P(0), P(2), ..., P(degree)].

        Returns a list of object arrays of length n/2 (reference
        multilinear_polynomial.rs:421-459 sumcheck_evals_array: P(1) is
        omitted, recovered by the verifier from the round claim).
        """
        arr = self.to_field()
        n = len(arr)
        from ..field.frvec import FrArray
        if isinstance(arr, FrArray):
            return arr.eval_ladder(
                degree, interleaved=(order == BindingOrder.LowToHigh))
        if order == BindingOrder.HighToLow:
            lo, hi = arr[: n // 2], arr[n // 2 :]
        else:
            lo, hi = arr[0::2], arr[1::2]
        out = [lo]
        if degree >= 2:
            m = vec.vsub(hi, lo)
            cur = vec.vadd(hi, m)  # P(2)
            out.append(cur)
            for _ in range(3, degree + 1):
                cur = vec.vadd(cur, m)
                out.append(cur)
        return out
