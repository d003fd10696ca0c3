"""Reusable concrete sumcheck instances.

Reference: the concrete instance pattern of
joltworks/src/subprotocols/sumcheck_prover.rs:10 /
sumcheck_verifier.rs:6 implementors; ProductSumcheck is the building
block used by einsum contraction and test harnesses.

ProductSumcheck proves claims of the form  claim = sum_x prod_k P_k(x)
over the boolean hypercube — the building block used by einsum contraction
sumchecks, eq-weighted execution checks, and tests.
"""

from __future__ import annotations

from ..field import vec
from ..field.scalar import Fr
from ..poly.mlpoly import BindingOrder, MLPoly
from ..poly.unipoly import UniPoly
from .sumcheck import (RowsInstance, SumcheckInstanceProver,
                       SumcheckInstanceVerifier)


class ProductSumcheckProver(RowsInstance, SumcheckInstanceProver):
    """Proves sum_x prod_k polys[k](x) = input claim; degree = len(polys)."""

    def __init__(self, polys: list[MLPoly], claim: Fr,
                 order: BindingOrder = BindingOrder.HighToLow):
        assert polys
        n = len(polys[0])
        assert all(len(p) == n for p in polys)
        self.polys = polys
        self.claim = claim
        self.order = order
        self._rounds = polys[0].num_vars
        if order == BindingOrder.HighToLow:
            self.setup_rows(polys, [(Fr.one(), list(range(len(polys))))],
                            max(len(polys), 1))
        else:
            self._rows_fused = None  # LowToHigh: legacy path only

    def num_rounds(self) -> int:
        return self._rounds

    def degree(self) -> int:
        return max(len(self.polys), 1)

    def input_claim(self, accumulator) -> Fr:
        return self.claim

    def compute_message(self, round: int, previous_claim: Fr) -> UniPoly:
        if self._rows_fused is not None:
            return self.rows_message(previous_claim)
        d = self.degree()
        evals_per_poly = [p.sumcheck_evals(d, self.order) for p in self.polys]
        points: list[Fr] = []
        for t in range(len(evals_per_poly[0])):  # [P(0), P(2), ..., P(d)]
            prod = evals_per_poly[0][t]
            for k in range(1, len(self.polys)):
                prod = vec.vmul(prod, evals_per_poly[k][t])
            points.append(vec.vsum(prod))
        return UniPoly.from_evals_and_hint(previous_claim, points)

    def ingest_challenge(self, r: Fr, round: int) -> None:
        if self._rows_fused is not None:
            self._rows_fused.bind(r)
            return
        for p in self.polys:
            p.bind(r, self.order)

    def final_poly_claims(self) -> list[Fr]:
        if self._rows_fused is not None:
            return [self._rows_fused.row_value(i)
                    for i in range(len(self.polys))]
        return [p.final_claim() for p in self.polys]


class ProductSumcheckVerifier(SumcheckInstanceVerifier):
    """Oracle-style verifier: evaluates the factor MLEs itself.

    Used in tests and wherever the verifier has the factor polynomials in
    the clear (e.g. public constants); protocol ops instead route the final
    claims through the opening accumulator.
    """

    def __init__(self, polys: list[MLPoly], claim: Fr,
                 order: BindingOrder = BindingOrder.HighToLow):
        self.polys = [p.clone() for p in polys]
        self.claim = claim
        self.order = order
        self._rounds = polys[0].num_vars

    def num_rounds(self) -> int:
        return self._rounds

    def degree(self) -> int:
        return max(len(self.polys), 1)

    def input_claim(self, accumulator) -> Fr:
        return self.claim

    def expected_output_claim(self, accumulator, r: list[Fr]) -> Fr:
        # LowToHigh binding visits variables LSB-first, so the evaluation
        # point in big-endian variable order is reversed(r).
        point = list(r) if self.order == BindingOrder.HighToLow else list(reversed(r))
        acc = Fr.one()
        for p in self.polys:
            acc = acc * p.clone().evaluate(point)
        return acc
