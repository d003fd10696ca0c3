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

from abc import ABC, abstractmethod

from ..field import frvec, vec
from ..field.scalar import Fr
from ..poly.mlpoly import BindingOrder
from ..poly.spliteq import inv_cached
from ..poly.unipoly import (CompressedUniPoly, UniPoly,
                            interpolate_at_nodes, vinv_limbs)


class SumcheckError(Exception):
    pass


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


class Sumcheck:

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
