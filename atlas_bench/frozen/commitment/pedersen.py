"""Vector Pedersen commitments (blinded) for ZK sumcheck rounds.

Reference: joltworks/src/poly/commitment/pedersen.rs — commitments
C = sum_i m_i * G_i + r * H with message generators G_i taken from the
HyperKZG SRS G1 powers and a hash-derived blinding generator H (reference
hyperkzg/mod.rs:115-140 pedersen_generators; preprocessing.rs:115-123).
Used by the BlindFold ZK layer's committed round polynomials.
"""

from __future__ import annotations

import hashlib
import secrets

from ..curve.msm import msm
from ..curve.points import G1, g1_generator
from ..field.constants import FR_MODULUS
from ..field.scalar import Fr


class PedersenGenerators:
    """message_generators[i] = G_i; blinding_generator = H."""

    def __init__(self, message_generators: list[G1], blinding_generator: G1):
        assert message_generators, "need at least one generator"
        self.message_generators = message_generators
        self.blinding_generator = blinding_generator

    @classmethod
    def from_srs(cls, srs, count: int,
                 seed: bytes = b"jolt-atlas-tpu-pedersen-h") -> "PedersenGenerators":
        """Message generators from the SRS G1 powers; H derived by hashing
        (discrete log of H w.r.t. the G_i unknown)."""
        from .dory import hash_to_g1
        gens = list(srs.g1_powers[:count])
        if len(gens) < count:
            # extend with hash-to-curve points beyond the SRS length
            # (hash-DERIVED scalars would have public discrete logs and
            # break binding)
            for i in range(len(gens), count):
                gens.append(hash_to_g1(seed + b"-msg", i))
        h = hash_to_g1(seed + b"-blind", 0)
        out = cls(gens, h)
        out._seed = seed
        return out

    def ensure(self, count: int) -> None:
        """Deterministically extend the generator vector (hash-to-curve),
        so prover and verifier stay in agreement for any message width."""
        from .dory import hash_to_g1
        seed = getattr(self, "_seed", b"jolt-atlas-tpu-pedersen-h")
        while len(self.message_generators) < count:
            i = len(self.message_generators)
            self.message_generators.append(hash_to_g1(seed + b"-msg", i))

    def commit(self, coeffs: list[Fr], blinding: Fr) -> G1:
        n = len(coeffs)
        if n > len(self.message_generators):
            self.ensure(n)
        bases = self.message_generators[:n] + [self.blinding_generator]
        scalars = [c.v for c in coeffs] + [blinding.v]
        return msm(bases, scalars)

    def commit_chunked(self, values: list[Fr]) -> list[tuple[G1, Fr]]:
        """Commit in generator-width chunks, fresh random blinding each."""
        w = len(self.message_generators)
        out = []
        for i in range(0, len(values), w):
            blinding = Fr(secrets.randbelow(FR_MODULUS))
            out.append((self.commit(values[i:i + w], blinding), blinding))
        return out

    def verify(self, commitment: G1, coeffs: list[Fr], blinding: Fr) -> bool:
        got = self.commit(coeffs, blinding)
        return (got.infinity == commitment.infinity
                and got.x == commitment.x and got.y == commitment.y)
