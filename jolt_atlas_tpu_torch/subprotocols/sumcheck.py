"""Sumcheck engine: single and front-loaded batched prove/verify.

Protocol flow mirrors reference joltworks/src/subprotocols/sumcheck.rs:
  - Sumcheck::prove (sumcheck.rs:561-600): absorb input claim, then per
    round: compute univariate message, absorb compressed poly, draw 125-bit
    optimized challenge, evaluate message at challenge -> next claim, bind.
  - BatchedSumcheck::prove (sumcheck.rs:29-185): absorb each instance's
    input claim, draw one batching coefficient per instance, scale claims by
    2^(max_rounds - rounds) (front-loading), instances join once
    remaining_rounds <= their num_rounds; instances that haven't joined
    contribute constant polys equal to claim * 2^(remaining-rounds-1).
  - SumcheckInstanceProof::verify (sumcheck.rs:655-700): degree-bound check,
    re-absorb, challenge, eval_from_hint chain.

Instances implement the SumcheckInstanceProver/Verifier interfaces
(subprotocols/sumcheck_prover.rs:10, sumcheck_verifier.rs:6).
"""

from __future__ import annotations

import functools
from abc import ABC, abstractmethod

from ..device import onehot as donehot
from ..device import telemetry
from ..field import frvec, vec
from ..field.scalar import Fr
from ..poly.mlpoly import BindingOrder
from ..poly.spliteq import inv_cached
from ..poly.unipoly import (CompressedUniPoly, UniPoly,
                            interpolate_at_nodes, vinv_limbs)
from ..utils import profiling


class SumcheckError(Exception):
    pass


class SumcheckInstanceProver(ABC):
    @abstractmethod
    def num_rounds(self) -> int: ...

    @abstractmethod
    def degree(self) -> int: ...

    @abstractmethod
    def input_claim(self, accumulator) -> Fr: ...

    @abstractmethod
    def compute_message(self, round: int, previous_claim: Fr) -> UniPoly: ...

    @abstractmethod
    def ingest_challenge(self, r: Fr, round: int) -> None: ...

    def ensure_host(self) -> None:
        """Build what the host path's messages read, where the instance
        builds it only on demand (the one-hot read checks); else nothing."""

    def finalize(self) -> None:
        pass

    def cache_openings(self, accumulator, transcript, r: list[Fr]) -> None:
        pass


class RowsInstance:
    """Mixin engine for product-terms instances:
        points[t] = sum_j [eq weight] * sum_terms coeff * prod rows[i](t, j)

    Rows are MLPolys of equal length; `terms` is [(Fr coeff, [row indices])].

    When ``eq_r`` is given, the eq factor is NOT a row: on the native path
    it becomes a Gruen split-eq weight schedule (poly/spliteq.py +
    frvec.GruenInstance — integer round-0 kernels, O(sqrt n) weight tables,
    one fewer eval point on eq rounds); ``degree`` stays the TOTAL degree
    including the eq factor, and row indices refer to the product rows
    only. ``eq_pre`` leading / ``eq_post`` trailing plain variables select
    the suffix-eq / prefix-eq layout (see SplitEq docstring). The
    object-int fallback materializes the tiled eq row instead — the round
    messages are bit-identical either way.

    Without ``eq_r``: the fused native kernel (FusedInstance) or the
    generic vec loop, as before. Covers AddressReadCheck/Booleanity/
    ReadRaf/RaVirtualization/Eq-LtPair/CycleExecution/contraction
    instances — the per-instance classes keep only their claim logic and
    opening bookkeeping.

    ``BOUND_COUNTER``: the telemetry counter of the row elements (P x n a
    round) that a host split-eq engine binds, None for a class outside
    the IOP; the card's engine counts its own (device/rows.py).
    """

    BOUND_COUNTER = "iop_rows_bound_host"

    def setup_rows(self, mlpolys: list, terms, degree: int,
                   eq_r: list[Fr] | None = None, eq_pre: int = 0,
                   eq_post: int = 0) -> None:
        self._rows_deg = degree
        self._rows_fused = None
        self._gruen = None
        self._se = None
        self._rows_round = 0
        self._eq_offset = 0
        native = vec.native_available()
        if eq_r is not None and native and mlpolys:
            if (len(mlpolys) <= frvec.GruenInstance.MAXP
                    and max(1, degree) <= frvec.GruenInstance.MAXE):
                from ..device import rows as drows
                from ..parallel import shardedrows
                from ..poly.spliteq import SplitEq
                rows = [p.ints if p.is_small() else p.to_field()
                        for p in mlpolys]
                # the head rounds on the mesh's shards while a mesh scope is
                # active (parallel/shardedrows.py), else on the card while
                # the prover's IOP scope is (device/rows.py), else on the
                # host; byte-identical messages
                self._gruen = (shardedrows.try_setup(rows, terms, degree)
                               or drows.try_setup(rows, terms, degree)
                               or frvec.GruenInstance(rows, terms, degree))
                self._se = SplitEq(eq_r, pre_vars=eq_pre, post_vars=eq_post)
                self._rows_terms = terms
                self._mlrows = mlpolys
                return
        if eq_r is not None:
            # fallback: materialize the tiled eq row as row 0
            import numpy as np
            from ..poly.eq import eq_evals
            from ..poly.mlpoly import MLPoly
            eq_t = vec.as_object(eq_evals(eq_r))
            if eq_pre:
                eq_t = np.tile(eq_t, 1 << eq_pre)
            if eq_post:
                eq_t = np.repeat(eq_t, 1 << eq_post)
            mlpolys = [MLPoly(fvec=eq_t)] + list(mlpolys)
            terms = [(c, [0] + [i + 1 for i in f]) for c, f in terms]
            self._eq_offset = 1
        self._rows_terms = terms
        self._mlrows = mlpolys
        if native:
            rows = [p.to_field() for p in mlpolys]
            if (len(rows) <= frvec.FusedInstance.MAXP
                    and max(1, degree) <= frvec.FusedInstance.MAXE
                    and all(isinstance(x, frvec.FrArray) for x in rows)):
                self._rows_fused = frvec.FusedInstance(rows, terms)

    def rows_message(self, previous_claim: Fr) -> UniPoly:
        d = self._rows_deg
        if self._gruen is not None:
            return self._gruen_message(previous_claim)
        if self._rows_fused is not None:
            return UniPoly.from_evals_and_hint(
                previous_claim, self._rows_fused.round_points(d))
        evs = [p.sumcheck_evals(d, BindingOrder.HighToLow)
               for p in self._mlrows]
        half = len(self._mlrows[0]) // 2
        points = []
        for t in range(max(1, d)):
            acc = None
            for coeff, idxs in self._rows_terms:
                if idxs:
                    prod = None
                    for i in idxs:
                        prod = (evs[i][t] if prod is None
                                else vec.vmul(prod, evs[i][t]))
                    term = vec.vscale(prod, coeff)
                else:
                    term = vec.full(half, coeff)
                acc = term if acc is None else vec.vadd(acc, term)
            points.append(vec.vsum(acc))
        return UniPoly.from_evals_and_hint(previous_claim, points)

    def _gruen_message(self, previous_claim: Fr) -> UniPoly:
        """Assemble s(X) from the weighted product evals (see SplitEq)."""
        se = self._se
        rnd = self._rows_round
        d = self._rows_deg
        whi, whi_shift, wlo, log_wlo = se.tables(rnd)
        lin = se.l_linear(rnd)
        es = se.scalar
        one = Fr.one()
        if lin is None:
            # weight constant w.r.t. the current variable: s(X) = es * q(X)
            pts = self._gruen.round_points(max(1, d), whi, whi_shift, wlo,
                                           log_wlo)
            if es.v != one.v:
                pts = (pts.scale(es) if not isinstance(pts, list)
                       else [es * p for p in pts])
            return UniPoly.from_evals_and_hint(previous_claim, pts)
        dq = max(1, d - 1)
        l0, l1 = lin
        if l1.is_zero():
            # degenerate eq line (point coordinate r_i == 0 -> l(X) =
            # l0 (1 - X)): the round claim es*l0*q(0) carries no q(1)
            # information, so the hint recovery divides by zero. Fetch
            # one extra eval instead and interpolate q on the grid
            # {0, 2, ..., dq+1}. Arises structurally (e.g. a Slice at
            # row 0 fixes leading point coordinates to 0), not from
            # transcript randomness.
            qev = self._gruen.round_points(dq + 1, whi, whi_shift, wlo,
                                           log_wlo)
            return self._gruen_assemble_nohint(qev, dq)
        qev = self._gruen.round_points(dq, whi, whi_shift, wlo, log_wlo)
        return self._gruen_assemble(previous_claim, qev)

    def _gruen_assemble_nohint(self, qev, dq: int) -> UniPoly:
        """s(X) = es * l(X) * q(X) with q interpolated from evals on the
        skip-1 grid {0, 2, 3, ..., dq+1} (degenerate-line fallback)."""
        se = self._se
        es = se.scalar
        l0, l1 = se.l_linear(self._rows_round)
        if not isinstance(qev, list):
            qev = qev.to_fr_list()
        nodes = [0] + list(range(2, dq + 2))
        q = interpolate_at_nodes(nodes, qev)
        b = l1 - l0
        s = [Fr.zero()] * (len(q) + 1)
        for i, c in enumerate(q):
            s[i] = s[i] + l0 * c
            s[i + 1] = s[i + 1] + b * c
        if not es.is_one():
            s = [es * x for x in s]
        return UniPoly(s)

    def _gruen_assemble(self, previous_claim: Fr, qev) -> UniPoly:
        """s(X) = es * l(X) * q(X) from q's evals [q(0), q(2), ...] — the
        shared tail of every Gruen-weighted round message (the caller may
        compute qev by any engine: dense rows, device fleet, or the sparse
        one-hot schedule in onehot.BooleanityProver). Limb-array qev takes
        the one-call native path (csrc frv_gruen_assemble)."""
        se = self._se
        es = se.scalar
        one = Fr.one()
        l0, l1 = se.l_linear(self._rows_round)
        if not isinstance(qev, list):
            arr = frvec.gruen_assemble(
                qev, previous_claim, es, se.scalar_inv, l0, l1,
                inv_cached(l1), vinv_limbs(len(qev) + 1))
            return UniPoly(arr=arr)
        q0 = qev[0]
        # claim = es * (l(0) q(0) + l(1) q(1))  =>  recover q(1)
        q1 = (previous_claim * se.scalar_inv - l0 * q0) * inv_cached(l1)
        q = UniPoly.from_evals([q0, q1] + list(qev[1:]))
        # s(X) = es * l(X) * q(X); l(X) = l0 + X (l1 - l0)
        b = l1 - l0
        s = [Fr.zero()] * (len(q.coeffs) + 1)
        for i, c in enumerate(q.coeffs):
            s[i] = s[i] + l0 * c
            s[i + 1] = s[i + 1] + b * c
        if es.v != one.v:
            s = [es * x for x in s]
        return UniPoly(s)

    def rows_bind(self, r: Fr) -> None:
        if self._gruen is not None:
            g = self._gruen
            if self.BOUND_COUNTER and type(g) is frvec.GruenInstance:
                telemetry.tally(self.BOUND_COUNTER, g.P * g.n)
            g.bind(r)
            self._se.note_challenge(r, self._rows_round)
            self._rows_round += 1
            return
        if self._rows_fused is not None:
            self._rows_fused.bind(r)
            return
        for p in self._mlrows:
            p.bind(r, BindingOrder.HighToLow)

    def row_final(self, i: int) -> Fr:
        if self._gruen is not None:
            return self._gruen.row_value(i)
        if self._rows_fused is not None:
            return self._rows_fused.row_value(i + self._eq_offset)
        return self._mlrows[i + self._eq_offset].final_claim()


class SumcheckInstanceVerifier(ABC):
    @abstractmethod
    def num_rounds(self) -> int: ...

    @abstractmethod
    def degree(self) -> int: ...

    @abstractmethod
    def input_claim(self, accumulator) -> Fr: ...

    @abstractmethod
    def expected_output_claim(self, accumulator, r: list[Fr]) -> Fr: ...

    def cache_openings(self, accumulator, transcript, r: list[Fr]) -> None:
        pass


class SumcheckInstanceProof:
    """The per-round compressed univariate polynomials."""

    def __init__(self, compressed_polys: list[CompressedUniPoly]):
        self.compressed_polys = compressed_polys

    def verify(self, claim: Fr, num_rounds: int, degree_bound: int, transcript):
        """Replays the rounds; returns (final_claim, challenges)."""
        if len(self.compressed_polys) != num_rounds:
            raise SumcheckError(
                f"expected {num_rounds} round polys, got {len(self.compressed_polys)}"
            )
        r: list[Fr] = []
        if (frvec.available()
                and all(p._coeffs is None for p in self.compressed_polys)):
            # limb-native round chain: the running claim stays a Montgomery
            # limb row across the whole chain (one frv_eval_from_hint call
            # per round), decoded to Fr once at the end
            import numpy as np
            lib = frvec._load()
            # own both ping-pong buffers (the cached limb row must never
            # be a kernel output)
            e_l = frvec._fr_limbs_cached(claim).copy()
            buf = np.empty((1, 4), dtype=np.uint64)
            for poly in self.compressed_polys:
                if poly.degree() > degree_bound:
                    raise SumcheckError(
                        f"round poly degree {poly.degree()} > "
                        f"bound {degree_bound}")
                poly.append_to_transcript(transcript)
                r_i = transcript.challenge_scalar_optimized()
                r.append(r_i)
                arr = poly._arr
                lib.frv_eval_from_hint(
                    arr.d.ctypes.data, len(arr), e_l.ctypes.data,
                    frvec._fr_addr_cached(r_i),
                    buf.ctypes.data)
                e_l, buf = buf, e_l
            return frvec.FrArray(e_l).item(0), r
        e = claim
        for poly in self.compressed_polys:
            if poly.degree() > degree_bound:
                raise SumcheckError(
                    f"round poly degree {poly.degree()} > bound {degree_bound}"
                )
            poly.append_to_transcript(transcript)
            r_i = transcript.challenge_scalar_optimized()
            r.append(r_i)
            e = poly.eval_from_hint(e, r_i)
        return e, r

    def serialize(self) -> bytes:
        out = len(self.compressed_polys).to_bytes(8, "little")
        for p in self.compressed_polys:
            out += p.serialize()
        return out

    @classmethod
    def deserialize(cls, data: bytes, offset: int = 0):
        n = int.from_bytes(data[offset:offset + 8], "little")
        offset += 8
        polys = []
        for _ in range(n):
            p, offset = CompressedUniPoly.deserialize(data, offset)
            polys.append(p)
        return cls(polys), offset


def _gruen_fleet(instances, remaining: int) -> None:
    """Precompute ALL single-row degree-2 Gruen round messages of this
    batched round in one C call (frv_gruen1_fleet) — the dominant call
    shape (the ~150 opening-reduction groups each previously launched
    their own bind+eval kernel per round). Byte-identical messages: the
    kernel replicates the P==1 fast-path block regrouping exactly."""
    if not frvec.available():
        return
    cands = []
    c_prev = None
    for inst in instances:
        if remaining > inst.num_rounds():
            continue
        g = getattr(inst, "_gruen", None)
        if (not isinstance(g, frvec.GruenInstance) or g.P != 1 or g._int_mode
                or g._preset_q is not None
                or getattr(inst, "_rows_deg", 0) != 2):
            continue
        # the fleet kernel computes plain sum(row * w): require the exact
        # single coeff-1 single-factor term shape (the opening-reduction
        # groups); anything else keeps its own kernel call, which applies
        # coefficients and constant terms
        if (len(g.terms) != 1 or g.terms[0][1] != [0]
                or not g.terms[0][0].is_one()):
            continue
        se = inst._se
        rnd = inst._rows_round
        lin = se.l_linear(rnd)
        if lin is None or lin[1].is_zero():
            continue
        if g._pending_bind is not None:
            c_prev = g._pending_bind
        cands.append((g, se.tables(rnd)))
    if len(cands) < 2:
        return
    frvec.gruen1_fleet(cands, c_prev if c_prev is not None else Fr.zero())


def _pair_fleet(instances, remaining: int) -> None:
    """Precompute ALL two-row product-term round messages of this batched
    round in one C call (frv_pair_fleet) — the per-node chunk-table read
    checks are ~2,400 tiny 4-round FusedInstances per bench prove whose
    per-instance kernel launches were pure dispatch overhead."""
    if not frvec.available():
        return
    cands = []
    c_prev = None
    for inst in instances:
        if remaining > inst.num_rounds():
            continue
        f = getattr(inst, "_rows_fused", None)
        if (f is None or not f._pair1 or f._preset_q is not None
                or getattr(inst, "_rows_deg", 0) != 2
                or getattr(inst, "_eq_offset", 0)):
            continue
        if f.n > 8192 or f.n < 2:
            continue
        if f._pending_bind is not None:
            c_prev = f._pending_bind
        cands.append(f)
    if len(cands) < 2:
        return
    frvec.pair_fleet(cands, c_prev if c_prev is not None else Fr.zero())


class _RoundCtx:
    """Per-round batching context: limb-native (2 C calls/round via
    frvec.RoundBatch — the accumulate and the challenge evaluation) when
    the C library is up, per-poly Python Fr arithmetic otherwise.
    Mirrors the round loop of reference sumcheck.rs:119-131."""

    __slots__ = ("polys", "rb")

    def __init__(self, polys: list[UniPoly]):
        self.polys = polys
        self.rb = (frvec.RoundBatch([p.arr() for p in polys])
                   if frvec.available() else None)

    def batched(self, coeffs: list[Fr]) -> UniPoly:
        if self.rb is not None:
            acc = frvec.FrArray.zeros(self.rb.maxlen())
            self.rb.accumulate(acc, coeffs)
            return UniPoly(arr=acc)
        batched = UniPoly([])
        for poly, coeff in zip(self.polys, coeffs):
            batched = batched + poly.scale(coeff)
        return batched

    def claims(self, r: Fr) -> list[Fr]:
        if self.rb is not None:
            return self.rb.horner(r)
        return [p.evaluate(r) for p in self.polys]


_POW2_FR: dict[int, Fr] = {}


def _mul_pow2(x: Fr, k: int) -> Fr:
    if not k:
        return x
    f = _POW2_FR.get(k)
    if f is None:
        f = _POW2_FR[k] = Fr(1 << k)
    if frvec.available():
        # derive the product's limb row from the factors' cached rows (it
        # is used as a kernel argument in the same round)
        return frvec.mul_seed_cache(x, f)
    return x * f


class zk_mode:
    """Context manager activating the zero-knowledge pipeline: while
    active, every Sumcheck/BatchedSumcheck prove and verify (and the
    eval reductions, via the prover/verifier) routes to the Pedersen-
    committed zk variants (zk_sumcheck.py). Mirrors the role of the
    reference's prove_zk/verify_zk plumbing (zk.rs:2081,2947)."""

    _gens = None

    def __init__(self, gens):
        self.gens = gens

    def __enter__(self):
        self._prev = zk_mode._gens
        zk_mode._gens = self.gens
        return self.gens

    def __exit__(self, *exc):
        zk_mode._gens = self._prev
        return False

    @staticmethod
    def gens():
        return zk_mode._gens


def _spanned(prove):
    """``prove`` (its first argument an instance or a list of them) in a
    ``sumcheck:<kind>`` span, the kind being the instances' classes."""
    @functools.wraps(prove)
    def call(instances, *args, **kwargs):
        if not profiling.enabled():
            return prove(instances, *args, **kwargs)
        kinds = sorted({type(i).__name__ for i in (
            instances if isinstance(instances, list) else [instances])})
        with profiling.span("sumcheck:" + "+".join(kinds)):
            return prove(instances, *args, **kwargs)
    return call


class Sumcheck:
    @staticmethod
    @_spanned
    def prove(instance: SumcheckInstanceProver, accumulator, transcript):
        gens = zk_mode.gens()
        if gens is not None:
            from .zk_sumcheck import ZkSumcheck
            proof, r, _final = ZkSumcheck.prove(instance, gens, accumulator,
                                                transcript)
            return proof, r
        num_rounds = instance.num_rounds()
        input_claim = instance.input_claim(accumulator)
        transcript.append_scalar(input_claim)
        previous_claim = input_claim
        r_sumcheck: list[Fr] = []
        compressed: list[CompressedUniPoly] = []
        for rnd in range(num_rounds):
            poly = instance.compute_message(rnd, previous_claim)
            cp = poly.compress()
            cp.append_to_transcript(transcript)
            r_j = transcript.challenge_scalar_optimized()
            r_sumcheck.append(r_j)
            previous_claim = poly.evaluate(r_j)
            instance.ingest_challenge(r_j, rnd)
            compressed.append(cp)
        instance.finalize()
        instance.cache_openings(accumulator, transcript, r_sumcheck)
        return SumcheckInstanceProof(compressed), r_sumcheck

    @staticmethod
    def verify(proof: SumcheckInstanceProof, instance: SumcheckInstanceVerifier,
               accumulator, transcript):
        gens = zk_mode.gens()
        if gens is not None:
            from .zk_sumcheck import ZkSumcheck, ZkSumcheckProof
            if not isinstance(proof, ZkSumcheckProof):
                raise SumcheckError("zk verify: expected a zk proof")
            r, _final = ZkSumcheck.verify(proof, instance, gens, accumulator,
                                          transcript)
            return r
        if not isinstance(proof, SumcheckInstanceProof):
            raise SumcheckError("plain verify: unexpected proof type")
        input_claim = instance.input_claim(accumulator)
        transcript.append_scalar(input_claim)
        final_claim, r = proof.verify(
            input_claim, instance.num_rounds(), instance.degree(), transcript
        )
        instance.cache_openings(accumulator, transcript, r)
        expected = instance.expected_output_claim(accumulator, r)
        if final_claim != expected:
            raise SumcheckError("sumcheck output claim mismatch")
        return r


class BatchedSumcheck:
    @staticmethod
    @_spanned
    def prove(instances: list[SumcheckInstanceProver], accumulator, transcript):
        # a node's one-hot read checks go to the card's engine while its
        # scope is entered (device/onehot.py), which declines what it does
        # not take
        got = donehot.try_prove(instances, accumulator, transcript)
        if got is not None:
            return got
        for inst in instances:
            inst.ensure_host()
        gens = zk_mode.gens()
        if gens is not None:
            from .zk_sumcheck import ZkBatchedSumcheck
            return ZkBatchedSumcheck.prove(instances, gens, accumulator,
                                           transcript)
        max_rounds = max(i.num_rounds() for i in instances)
        for inst in instances:
            transcript.append_scalar(inst.input_claim(accumulator))
        coeffs = transcript.challenge_vector(len(instances))

        individual_claims = [
            _mul_pow2(inst.input_claim(accumulator), max_rounds - inst.num_rounds())
            for inst in instances
        ]

        telemetry.tally("sumcheck_batched_rounds", max_rounds)
        r_sumcheck: list[Fr] = []
        compressed: list[CompressedUniPoly] = []
        for rnd in range(max_rounds):
            remaining = max_rounds - rnd
            _gruen_fleet(instances, remaining)
            _pair_fleet(instances, remaining)
            polys = []
            for inst, prev in zip(instances, individual_claims):
                nr = inst.num_rounds()
                if remaining > nr:
                    # not joined yet: constant poly = claim * 2^(remaining-nr-1)
                    scaled = _mul_pow2(
                        inst.input_claim(accumulator), remaining - nr - 1
                    )
                    polys.append(UniPoly([scaled]))
                else:
                    offset = max_rounds - nr
                    polys.append(inst.compute_message(rnd - offset, prev))

            ctx = _RoundCtx(polys)
            cp = ctx.batched(coeffs).compress()
            cp.append_to_transcript(transcript)
            r_j = transcript.challenge_scalar_optimized()
            r_sumcheck.append(r_j)
            individual_claims = ctx.claims(r_j)
            for inst in instances:
                if remaining <= inst.num_rounds():
                    offset = max_rounds - inst.num_rounds()
                    inst.ingest_challenge(r_j, rnd - offset)
            compressed.append(cp)

        for inst in instances:
            inst.finalize()
        for inst in instances:
            r_slice = r_sumcheck[max_rounds - inst.num_rounds():]
            inst.cache_openings(accumulator, transcript, r_slice)
        return SumcheckInstanceProof(compressed), r_sumcheck

    @staticmethod
    @_spanned
    def prove_tail(instances, claims, coeffs, individual_claims, compressed,
                   r_sumcheck, accumulator, transcript, start_round: int,
                   max_rounds: int):
        """Finish a batched sumcheck whose first `start_round` rounds ran on
        an accelerator engine (tpu/reduction.py, parallel/shardedreduction.py).

        `claims` are the raw input claims (pre pow2-scaling), `compressed` /
        `r_sumcheck` already hold the head-round messages/challenges, and
        `individual_claims` are each instance's running claim entering round
        `start_round`. Instances still mid-flight must have been resumed
        (resume_from_device) or freshly set up; proof bytes are identical to
        a full BatchedSumcheck.prove run."""
        telemetry.tally("sumcheck_batched_rounds", max_rounds - start_round)
        for rnd in range(start_round, max_rounds):
            remaining = max_rounds - rnd
            _gruen_fleet(instances, remaining)
            _pair_fleet(instances, remaining)
            polys = []
            for k, (inst, prev) in enumerate(zip(instances, individual_claims)):
                nr = inst.num_rounds()
                if remaining > nr:
                    polys.append(UniPoly([_mul_pow2(claims[k],
                                                    remaining - nr - 1)]))
                else:
                    offset = max_rounds - nr
                    polys.append(inst.compute_message(rnd - offset, prev))
            ctx = _RoundCtx(polys)
            cp = ctx.batched(coeffs).compress()
            cp.append_to_transcript(transcript)
            r_j = transcript.challenge_scalar_optimized()
            r_sumcheck.append(r_j)
            individual_claims = ctx.claims(r_j)
            for inst in instances:
                if remaining <= inst.num_rounds():
                    offset = max_rounds - inst.num_rounds()
                    inst.ingest_challenge(r_j, rnd - offset)
            compressed.append(cp)

        for inst in instances:
            inst.finalize()
        for inst in instances:
            r_slice = r_sumcheck[max_rounds - inst.num_rounds():]
            inst.cache_openings(accumulator, transcript, r_slice)
        return SumcheckInstanceProof(compressed), r_sumcheck

    @staticmethod
    def verify(proof: SumcheckInstanceProof,
               instances: list[SumcheckInstanceVerifier], accumulator, transcript):
        gens = zk_mode.gens()
        if gens is not None:
            from .zk_sumcheck import ZkBatchedSumcheck, ZkSumcheckProof
            if not isinstance(proof, ZkSumcheckProof):
                raise SumcheckError("zk verify: expected a zk proof")
            return ZkBatchedSumcheck.verify(proof, instances, gens,
                                            accumulator, transcript)
        max_degree = max(i.degree() for i in instances)
        max_rounds = max(i.num_rounds() for i in instances)
        for inst in instances:
            transcript.append_scalar(inst.input_claim(accumulator))
        coeffs = transcript.challenge_vector(len(instances))

        claim = Fr.zero()
        for inst, coeff in zip(instances, coeffs):
            claim = claim + _mul_pow2(
                inst.input_claim(accumulator), max_rounds - inst.num_rounds()
            ) * coeff

        if not isinstance(proof, SumcheckInstanceProof):
            raise SumcheckError("plain verify: unexpected proof type")
        output_claim, r_sumcheck = proof.verify(claim, max_rounds, max_degree,
                                                transcript)

        expected = Fr.zero()
        slices: dict[int, list[Fr]] = {}  # shared per length: downstream
        # memos key challenge points by identity (onehot._point_key)
        for inst, coeff in zip(instances, coeffs):
            nr = inst.num_rounds()
            r_slice = slices.get(nr)
            if r_slice is None:
                r_slice = slices[nr] = r_sumcheck[max_rounds - nr:]
            inst.cache_openings(accumulator, transcript, r_slice)
            expected = expected + inst.expected_output_claim(accumulator, r_slice) * coeff

        if output_claim != expected:
            raise SumcheckError("batched sumcheck output claim mismatch")
        return r_sumcheck
