"""Commitment-scheme interface + the HyperKZG implementation of it.

Reference: joltworks/src/poly/commitment/commitment_scheme.rs:11-160 —
`CommitmentScheme` (setup_prover / setup_verifier / commit / batch_commit /
combine_commitments / prove / verify) is the seam that lets the proof
pipeline swap HyperKZG for Dory or other PCSs. The orchestrators currently
call HyperKZG directly for speed; this module provides the formal trait and
the HyperKZG adapter so alternate schemes (a Dory port is planned) slot in
without touching the pipeline.
"""

from __future__ import annotations

from abc import ABC, abstractmethod

from ..curve.points import G1
from ..field.scalar import Fr
from .hyperkzg import HyperKZG, HyperKZGProof
from .kzg import KZGSRS


class CommitmentScheme(ABC):
    """Multilinear PCS over BN254 Fr."""

    @abstractmethod
    def setup_prover(self, max_num_vars: int):
        """Prover setup (SRS / generators) for polys up to 2^max_num_vars."""

    @abstractmethod
    def setup_verifier(self, prover_setup):
        """Derive the (small) verifier key from the prover setup."""

    @abstractmethod
    def commit(self, setup, coeffs) -> G1:
        ...

    @abstractmethod
    def batch_commit(self, setup, polys: list) -> list[G1]:
        ...

    def combine_commitments(self, commitments: list[G1],
                            coeffs: list[Fr]) -> G1:
        """Homomorphic RLC of commitments (additive group)."""
        from ..curve.msm import msm
        return msm(commitments, [c.v for c in coeffs])

    @abstractmethod
    def prove(self, setup, coeffs, point: list[Fr], transcript):
        """Opening proof for the multilinear evaluation at `point`."""

    @abstractmethod
    def verify(self, vk, commitment: G1, point: list[Fr], claim: Fr,
               proof, transcript) -> bool:
        ...


class HyperKZGScheme(CommitmentScheme):
    """Default scheme (reference hyperkzg/mod.rs), seed-derived test SRS."""

    def __init__(self, seed: bytes = b"jolt-atlas-tpu-srs"):
        self.seed = seed

    def setup_prover(self, max_num_vars: int) -> KZGSRS:
        return KZGSRS.setup(1 << max_num_vars, seed=self.seed)

    def setup_verifier(self, srs: KZGSRS):
        # verifier needs only (g1, g2, beta_g2); keep the SRS handle
        return srs

    def commit(self, srs: KZGSRS, coeffs) -> G1:
        return HyperKZG.commit(srs, coeffs)

    def batch_commit(self, srs: KZGSRS, polys: list) -> list[G1]:
        prep = srs.prepared_bases()
        if prep is not None:
            return prep.msm_batch([p for p in polys])
        return [self.commit(srs, p) for p in polys]

    def prove(self, srs: KZGSRS, coeffs, point: list[Fr],
              transcript) -> HyperKZGProof:
        return HyperKZG.open(srs, coeffs, point, transcript)

    def verify(self, srs: KZGSRS, commitment: G1, point: list[Fr], claim: Fr,
               proof: HyperKZGProof, transcript) -> bool:
        return HyperKZG.verify(srs, commitment, point, claim, proof,
                               transcript)


class StreamingCommitter:
    """Two-tier chunked commitment (reference StreamingCommitmentScheme,
    joltworks/src/poly/commitment/commitment_scheme.rs:133): coefficients
    stream through `process()` in order, each chunk is committed against
    its own SRS base window, and partial commitments combine additively —
    so a witness larger than host memory never needs to be resident.

        sc = StreamingCommitter(srs)
        for chunk in produce_witness_chunks():   # np int arrays / FrArray
            sc.process(chunk)
        commitment = sc.finalize()               # == one-shot kzg_commit
    """

    def __init__(self, srs: KZGSRS):
        self.srs = srs
        self._prep = srs.prepared_bases()
        self._off = 0
        self._acc = G1.identity()
        self._tail = []  # python fallback when the native engine is absent

    def process(self, chunk) -> None:
        import numpy as np
        from ..curve.native import pack_scalars
        from ..field.frvec import FrArray
        if isinstance(chunk, FrArray):
            packed, count = chunk.canonical().tobytes(), len(chunk)
        elif isinstance(chunk, np.ndarray):
            packed, count = pack_scalars(chunk), chunk.size
        else:
            packed, count = pack_scalars(list(chunk)), len(list(chunk))
        if count == 0:
            return
        if self._prep is not None:
            part = self._prep.msm_packed_at(self._off, packed, count)
            self._acc = self._acc + part
        else:
            self._tail.append((self._off, packed, count))
        self._off += count

    def finalize(self) -> G1:
        if self._tail:
            from ..curve.msm import msm
            from ..field.constants import FR_MODULUS
            for off, packed, count in self._tail:
                scalars = [int.from_bytes(packed[i * 32:(i + 1) * 32],
                                          "little") % FR_MODULUS
                           for i in range(count)]
                self._acc = self._acc + msm(
                    self.srs.g1_powers[off: off + count], scalars)
            self._tail = []
        return self._acc
