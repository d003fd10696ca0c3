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
from ..utils import profiling
from ..subprotocols.sumcheck import (
    BatchedSumcheck,
    RowsInstance,
    SumcheckInstanceProver,
    SumcheckInstanceVerifier,
)

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


class _GroupReductionProver(RowsInstance, SumcheckInstanceProver):
    """Proves sum_j gamma^j claim_j = sum_x eq(point, x) * G(x) where
    G = sum_j gamma^j P_j over the members sharing this opening point.

    The eq factor rides the Gruen split-eq weight schedule (RowsInstance
    eq_r) — the dominant cost of the old design was building, multiplying
    and binding a 2^n-entry eq table per group (1.5 GB live at bench
    scale); the split weight needs O(sqrt n) table entries total."""

    BOUND_COUNTER = None  # its rows are the reduction's, not the IOP's

    def __init__(self, members, gamma_powers: list[Fr]):
        self.members = members            # [(global_idx, _PendingOpening)]
        self.point = members[0][1].point
        claim = Fr.zero()
        for j, p in members:
            claim = claim + gamma_powers[j] * p.claim
        self.claim = claim
        self.gamma_powers = gamma_powers
        self.rlc_fvec = None              # kept for the joint materialization

    def prepare(self, poly_map):
        from ..field import frvec
        from ..field.frvec import FrArray
        n = 1 << len(self.point)
        native = vec.native_available()
        acc = None if native else vec.zeros(n)
        oh_gammas, oh_idx = [], []  # batched one-hot RLC accumulation
        for j, p in self.members:
            src_poly = poly_map[p.poly_id]
            if (native
                    and getattr(src_poly, "onehot_indices", None) is not None
                    and src_poly.fvec is None):
                oh_gammas.append(self.gamma_powers[j])
                oh_idx.append(src_poly.onehot_indices)
                continue
            f = src_poly.to_field()
            if native and isinstance(f, FrArray):
                if acc is None and len(f) == n:
                    # seed from the first full-length member: skips the
                    # n-element zero fill (was ~0.9 s/prove of page zeroing
                    # across the 151 bench groups)
                    acc = f.scale(self.gamma_powers[j])
                    continue
                if acc is None:
                    acc = vec.zeros(n)
                acc.axpy_inplace(self.gamma_powers[j], f)
                continue
            if acc is None:
                acc = vec.zeros(n)
            contrib = vec.vscale(f, self.gamma_powers[j])
            if len(f) < n:
                acc[: len(f)] = vec.vadd(acc[: len(f)], contrib)
            else:
                acc = vec.vadd(acc, contrib)
        init = False
        if acc is None:
            if native and oh_idx:
                # all-one-hot group: the scatter kernel fuses the zero
                # fill into its thread partitions (init=1), skipping a
                # separate n-element memset pass
                import numpy as np
                acc = FrArray(np.empty((n, 4), dtype=np.uint64))
                init = True
            else:
                acc = vec.zeros(n)
        if oh_idx:
            # one parallel range-partitioned pass over all members
            # (csrc frv_scatter_const_ranges): adds the constant gamma_j at
            # every one-hot position, no T-length value arrays materialized
            frvec.scatter_const_ranges(acc, oh_gammas, oh_idx, init=init)
        self.rlc_fvec = acc

    def setup_sumcheck(self):
        # no copy: the sumcheck engine copies-on-first-bind (and the device
        # fleet uploads a copy), so rlc_fvec stays intact for the joint
        # materialization after the reduction
        self.setup_rows([MLPoly(fvec=self.rlc_fvec)], [(Fr.one(), [0])],
                        OPENING_SUMCHECK_DEGREE, eq_r=self.point)

    def resume_from_device(self, rows, local_round: int, se) -> None:
        """Install mid-sumcheck state fetched from the device rounds
        (device/reduction.py): partially-bound rows + a SplitEq whose scalar
        has been replayed through the consumed challenges."""
        from ..field.frvec import GruenInstance
        self._rows_deg = OPENING_SUMCHECK_DEGREE
        self._rows_fused = None
        self._eq_offset = 0
        self._gruen = GruenInstance([rows], [(Fr.one(), [0])],
                                    OPENING_SUMCHECK_DEGREE)
        self._se = se
        self._rows_round = local_round
        self._rows_terms = [(Fr.one(), [0])]
        self._mlrows = []

    def num_rounds(self) -> int:
        return len(self.point)

    def degree(self) -> int:
        return OPENING_SUMCHECK_DEGREE

    def input_claim(self, accumulator) -> Fr:
        return self.claim

    def compute_message(self, round: int, previous_claim: Fr) -> UniPoly:
        return self.rows_message(previous_claim)

    def ingest_challenge(self, r: Fr, round: int) -> None:
        self.rows_bind(r)

    def final_poly_claim(self) -> Fr:
        return self.row_final(0)


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


class ProverOpeningAccumulator:
    def __init__(self):
        self.openings: dict[OpeningId, tuple[list[Fr], Fr]] = {}
        self.pending: dict[OpeningId, _PendingOpening] = {}
        # virtual-poly -> [OpeningId] index (collect_node_claims was a
        # measured O(nodes x openings) scan on both prover and verifier)
        self.by_virtual: dict = {}

    # -- appends (absorb claim into transcript, like the reference) --------
    def append_committed(self, transcript, opening_id: OpeningId,
                         point: list[Fr], claim: Fr) -> None:
        assert not opening_id.is_virtual
        transcript.append_scalar(claim)
        self.openings[opening_id] = (list(point), claim)
        self.pending[opening_id] = _PendingOpening(
            opening_id, opening_id.poly, list(point), claim)

    def append_virtual(self, transcript, opening_id: OpeningId,
                       point: list[Fr], claim: Fr) -> None:
        assert opening_id.is_virtual
        transcript.append_scalar(claim)
        if opening_id not in self.openings:
            self.by_virtual.setdefault(opening_id.poly, []).append(opening_id)
        self.openings[opening_id] = (list(point), claim)

    def get_opening(self, opening_id: OpeningId) -> tuple[list[Fr], Fr]:
        return self.openings[opening_id]

    def take_claims(self) -> dict[OpeningId, Fr]:
        """Claims only (points dropped) — goes into the serialized proof."""
        return {k: v[1] for k, v in self.openings.items()}

    @property
    def reductions(self):
        return self.pending

    def sorted_pending(self) -> list[_PendingOpening]:
        return [self.pending[k] for k in sorted(self.pending, key=OpeningId.sort_key)]

    # -- batch opening reduction ------------------------------------------
    def prove_batch_opening(self, poly_map, transcript, device=None,
                            gate=None):
        """Runs the point-grouped batched reduction sumcheck; returns
        (sumcheck_proof, r_sumcheck, group_claims, joint_fvec) where
        joint_fvec (length 2^max_rounds) is the delta-RLC of the group RLC
        polynomials, ready for the single HyperKZG opening. ``device`` and
        ``gate`` (device/reduction.py) decide whether its rounds run on the
        card; the proof bytes are the same either way."""
        pending = self.sorted_pending()
        gamma_powers = transcript.challenge_scalar_powers(len(pending))
        instances = [_GroupReductionProver(m, gamma_powers)
                     for m in _group_by_point(pending)]
        with profiling.span("reduction_prepare"):  # the groups' RLCs
            for inst in instances:
                inst.prepare(poly_map)
        # zk mode keeps the host path: the device engines produce cleartext
        # round messages; BatchedSumcheck.prove dispatches to the
        # Pedersen-committed zk variant itself. Otherwise the mesh-sharded
        # engine when a mesh scope is active (parallel/shardedreduction.py),
        # then the single-device one (device/reduction.py), then the host.
        from ..device import reduction, telemetry
        from ..parallel import shardedreduction
        from ..subprotocols.sumcheck import zk_mode
        res = None
        with profiling.span("reduction_rounds"):
            if zk_mode.gens() is None:
                if shardedreduction.active_mesh() is not None:
                    res = shardedreduction.try_prove(instances, self,
                                                     transcript)
                if res is None:
                    res = reduction.try_prove(instances, self, transcript,
                                              device, gate)
            else:
                telemetry.decide("reduction", "zk")
            if res is None:
                for inst in instances:
                    inst.setup_sumcheck()
                res = BatchedSumcheck.prove(instances, self, transcript)
        proof, r_sumcheck = res
        group_claims = [inst.final_poly_claim() for inst in instances]
        transcript.append_scalars(group_claims)
        delta_powers = transcript.challenge_scalar_powers(len(group_claims))
        from ..field.frvec import FrArray
        max_len = 1 << len(r_sumcheck)
        with profiling.span("reduction_prepare"):  # the joint vector
            joint = vec.zeros(max_len)
            for delta, inst in zip(delta_powers, instances):
                if isinstance(joint, FrArray) and isinstance(inst.rlc_fvec,
                                                             FrArray):
                    joint.axpy_inplace(delta, inst.rlc_fvec)
                    continue
                contrib = vec.vscale(inst.rlc_fvec, delta)
                n = len(contrib)
                joint[:n] = vec.vadd(joint[:n], contrib)
            if not isinstance(joint, FrArray):
                joint = vec.to_fr(joint)
        return proof, r_sumcheck, group_claims, joint

    def prove_batch_opening_zk(self, poly_map, transcript, gens, srs,
                               dev=None, gate=None):
        """Hidden-claim batched opening (zk pipeline): the group claims
        stay Pedersen-committed (ZkBatchedSumcheck hidden-final mode) and
        the joint polynomial opens through the masked HyperKZG protocol
        (subprotocols/zk_opening.py). ``dev`` and ``gate``: the prover's
        MSM engine and gate, for that protocol's public HyperKZG opening.
        Returns (zk_sumcheck_proof, zk_joint_opening_proof)."""
        from ..device import telemetry
        from ..subprotocols.zk_opening import ZkJointOpening
        from ..subprotocols.zk_sumcheck import ZkBatchedSumcheck
        # the zk reduction commits its round messages: host path
        telemetry.decide("reduction", "zk")
        pending = self.sorted_pending()
        gamma_powers = transcript.challenge_scalar_powers(len(pending))
        instances = [_GroupReductionProver(m, gamma_powers)
                     for m in _group_by_point(pending)]
        with profiling.span("reduction_prepare"):  # the groups' RLCs
            for inst in instances:
                inst.prepare(poly_map)
        mu_fn = lambda inst, r_slice: eq_eval_scalar(inst.point, r_slice)
        with profiling.span("reduction_rounds"):
            for inst in instances:
                inst.setup_sumcheck()
            proof, r_sumcheck, hidden = ZkBatchedSumcheck.prove(
                instances, gens, self, transcript, hidden_final=mu_fn)
        g_vals, g_blinds, e_g = hidden
        delta_powers = transcript.challenge_scalar_powers(len(instances))
        from ..field.frvec import FrArray
        max_rounds = len(r_sumcheck)
        max_len = 1 << max_rounds
        one = Fr.one()
        nus = []
        with profiling.span("reduction_prepare"):  # the joint vector
            joint = vec.zeros(max_len)
            for delta, inst in zip(delta_powers, instances):
                prefix = one
                for r in r_sumcheck[: max_rounds - inst.num_rounds()]:
                    prefix = prefix * (one - r)
                nus.append(delta * prefix)
                if isinstance(joint, FrArray) and isinstance(inst.rlc_fvec,
                                                             FrArray):
                    joint.axpy_inplace(delta, inst.rlc_fvec)
                    continue
                contrib = vec.vscale(inst.rlc_fvec, delta)
                nn = len(contrib)
                joint[:nn] = vec.vadd(joint[:nn], contrib)
            if not isinstance(joint, FrArray):
                joint = vec.to_fr(joint)
        zk_open = ZkJointOpening.open(srs, gens, joint, list(r_sumcheck),
                                      nus, g_vals, g_blinds, e_g,
                                      transcript, dev, gate)
        return proof, zk_open


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
