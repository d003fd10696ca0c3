"""Opening accumulation and the batched opening reduction.

Mirrors reference joltworks/src/poly/opening_proof.rs +
subprotocols/opening_reduction.rs: every polynomial-opening claim made during
the IOP is collected; committed-poly claims are *grouped by opening point*
and gamma-RLC'd, one degree-2 reduction sumcheck instance per distinct point
proving  sum_j gamma^j claim_j = sum_x eq(point, x) * (sum_j gamma^j P_j)(x);
all group instances are batched into ONE BatchedSumcheck ending at a common
challenge point r_sumcheck; the per-group evaluations G_g(r_sumcheck) are
delta-RLC'd into a single joint polynomial opened once with HyperKZG (the
verifier folds the same RLC over the commitments homomorphically).

Design deviation from the reference (documented): the reference keys
reduction instances by CommittedPoly (one PCS-verified point per polynomial,
later appends overwrite earlier ones — opening_proof.rs:309,369). We keep
every OpeningId claim alive and RLC all of them into the reduction, so every
claim is PCS-bound (strictly sound; the gamma coefficients are drawn after
all claims are in the transcript).
"""

from __future__ import annotations

import numpy as np

from ..field import vec
from ..field.scalar import Fr
from ..ids import CommittedPoly, OpeningId, VirtualPoly
from .eq import eq_evals, eq_eval_scalar
from .mlpoly import BindingOrder, MLPoly
from .unipoly import UniPoly
from ..subprotocols.sumcheck import BatchedSumcheck, SumcheckInstanceVerifier

OPENING_SUMCHECK_DEGREE = 2


class _PendingOpening:
    """One committed-poly claim awaiting the batched reduction."""

    def __init__(self, opening_id: OpeningId, poly_id: CommittedPoly,
                 point: list[Fr], claim: Fr):
        self.opening_id = opening_id
        self.poly_id = poly_id
        self.point = point
        self.claim = claim


def _group_by_point(pending: list[_PendingOpening]):
    """Group pending openings by exact opening point, preserving the order of
    first occurrence (deterministic on both sides: derived from the sorted
    OpeningId order and points both parties know)."""
    groups: dict[tuple, list[tuple[int, _PendingOpening]]] = {}
    order: list[tuple] = []
    for j, p in enumerate(pending):
        key = tuple(x.v for x in p.point)
        if key not in groups:
            groups[key] = []
            order.append(key)
        groups[key].append((j, p))
    return [groups[k] for k in order]


class _GroupReductionVerifier(SumcheckInstanceVerifier):
    def __init__(self, members, gamma_powers: list[Fr]):
        self.members = members
        self.point = members[0][1].point
        claim = Fr.zero()
        for j, p in members:
            claim = claim + gamma_powers[j] * p.claim
        self.claim = claim
        self.sumcheck_claim: Fr | None = None  # G(r'), from the proof

    def num_rounds(self) -> int:
        return len(self.point)

    def degree(self) -> int:
        return OPENING_SUMCHECK_DEGREE

    def input_claim(self, accumulator) -> Fr:
        return self.claim

    def expected_output_claim(self, accumulator, r: list[Fr]) -> Fr:
        return eq_eval_scalar(self.point, r) * self.sumcheck_claim


class VerifierOpeningAccumulator:
    def __init__(self, proof_claims: dict[OpeningId, Fr]):
        self.proof_claims = proof_claims
        self.openings: dict[OpeningId, tuple[list[Fr], Fr]] = {}
        self.pending: dict[OpeningId, _PendingOpening] = {}
        self.by_virtual: dict = {}

    def claim_of(self, opening_id: OpeningId) -> Fr:
        return self.proof_claims[opening_id]

    def append_committed(self, transcript, opening_id: OpeningId,
                         point: list[Fr]) -> None:
        assert not opening_id.is_virtual
        claim = self.proof_claims[opening_id]
        transcript.append_scalar(claim)
        self.openings[opening_id] = (list(point), claim)
        self.pending[opening_id] = _PendingOpening(
            opening_id, opening_id.poly, list(point), claim)

    def append_virtual(self, transcript, opening_id: OpeningId,
                       point: list[Fr]) -> None:
        assert opening_id.is_virtual
        claim = self.proof_claims[opening_id]
        transcript.append_scalar(claim)
        if opening_id not in self.openings:
            self.by_virtual.setdefault(opening_id.poly, []).append(opening_id)
        self.openings[opening_id] = (list(point), claim)

    def get_opening(self, opening_id: OpeningId) -> tuple[list[Fr], Fr]:
        return self.openings[opening_id]

    @property
    def reductions(self):
        return self.pending

    def sorted_pending(self) -> list[_PendingOpening]:
        return [self.pending[k] for k in sorted(self.pending, key=OpeningId.sort_key)]

    def verify_batch_opening(self, proof, group_claims: list[Fr], transcript):
        """Verifies the point-grouped batched reduction sumcheck; returns
        (r_sumcheck, joint_claim, commit_coeffs) where commit_coeffs aligns
        with sorted_pending() order: coeff_j = gamma^j * delta^{group(j)},
        so the joint commitment is sum_j coeff_j * C_{poly(j)}."""
        pending = self.sorted_pending()
        gamma_powers = transcript.challenge_scalar_powers(len(pending))
        grouped = _group_by_point(pending)
        instances = [_GroupReductionVerifier(m, gamma_powers) for m in grouped]
        if len(group_claims) != len(instances):
            raise ValueError("reduced claim count mismatch")
        for inst, c in zip(instances, group_claims):
            inst.sumcheck_claim = c
        r_sumcheck = BatchedSumcheck.verify(proof, instances, self, transcript)
        transcript.append_scalars(group_claims)
        delta_powers = transcript.challenge_scalar_powers(len(group_claims))
        max_rounds = len(r_sumcheck)
        # joint claim: shorter groups embed at the low indices of the joint
        # polynomial, contributing a prod(1-r) prefix factor (reference
        # opening_proof.rs:1016-1036)
        one = Fr.one()
        joint_claim = Fr.zero()
        for delta, claim, inst in zip(delta_powers, group_claims, instances):
            prefix = one
            for r in r_sumcheck[: max_rounds - inst.num_rounds()]:
                prefix = prefix * (one - r)
            joint_claim = joint_claim + delta * claim * prefix
        commit_coeffs = [Fr.zero()] * len(pending)
        for delta, members in zip(delta_powers, grouped):
            for j, _p in members:
                commit_coeffs[j] = gamma_powers[j] * delta
        return r_sumcheck, joint_claim, commit_coeffs

    def verify_batch_opening_zk(self, proof, zk_open, transcript, gens,
                                srs, commitments_fn):
        """Verifier side of prove_batch_opening_zk: runs the hidden-final
        reduction sumcheck against the proof's E_g commitments, rebuilds
        the joint commitment homomorphically, and checks the masked
        HyperKZG opening. Raises on failure."""
        from ..subprotocols.sumcheck import SumcheckError
        from ..subprotocols.zk_opening import ZkJointOpening
        from ..subprotocols.zk_sumcheck import ZkBatchedSumcheck
        pending = self.sorted_pending()
        gamma_powers = transcript.challenge_scalar_powers(len(pending))
        grouped = _group_by_point(pending)
        instances = [_GroupReductionVerifier(m, gamma_powers)
                     for m in grouped]
        if len(zk_open.e_g) != len(instances):
            raise SumcheckError("hidden group-claim count mismatch")
        mu_fn = lambda inst, r_slice: eq_eval_scalar(inst.point, r_slice)
        r_sumcheck = ZkBatchedSumcheck.verify(
            proof, instances, gens, self, transcript,
            hidden_final=(zk_open.e_g, mu_fn))
        delta_powers = transcript.challenge_scalar_powers(len(instances))
        max_rounds = len(r_sumcheck)
        one = Fr.one()
        nus = []
        for delta, inst in zip(delta_powers, instances):
            prefix = one
            for r in r_sumcheck[: max_rounds - inst.num_rounds()]:
                prefix = prefix * (one - r)
            nus.append(delta * prefix)
        commit_coeffs = [Fr.zero()] * len(pending)
        for delta, members in zip(delta_powers, grouped):
            for j, _p in members:
                commit_coeffs[j] = gamma_powers[j] * delta
        from ..curve.msm import msm as _msm
        bases = commitments_fn()
        joint_c = _msm(bases, [c.v for c in commit_coeffs])
        if not ZkJointOpening.verify(srs, gens, joint_c, list(r_sumcheck),
                                     nus, zk_open, transcript):
            raise SumcheckError("zk joint opening failed")
        return r_sumcheck
