"""Univariate KZG over BN254.

Mirrors reference joltworks/src/poly/commitment/hyperkzg/kzg.rs: an SRS of
G1 powers (tau^i * G1) plus [G2, tau * G2]; commitment = MSM of coefficients
with the G1 powers; opening witness = commit of the synthetic-division
quotient by (X - u).

SRS generation here is seed-derived (tau from a seeded transcript squeeze) —
test-grade, like the reference's rng-based SRS::setup; production deployments
load a ceremony SRS via save/load (hyperkzg/mod.rs:60-100).
"""

from __future__ import annotations

import hashlib

import numpy as np

from ..field.constants import FR_MODULUS
from ..field.scalar import Fr
from ..curve.msm import msm
from ..curve.points import G1, G2, g1_generator, g2_generator


class LazyPoints:
    """List-like view over a raw canonical 64B/point buffer, decoding G1
    objects on demand — a 2^24-power SRS stays ~1 GB of bytes instead of
    ~2.5 GB of boxed points (only small prefixes are ever materialized:
    verifier bases, Pedersen generators, the g1 generator)."""

    __slots__ = ("raw", "_n")

    def __init__(self, raw: bytes):
        self.raw = raw
        self._n = len(raw) // 64

    def __len__(self) -> int:
        return self._n

    def _one(self, i: int) -> G1:
        if i < 0:
            i += self._n
        if not 0 <= i < self._n:
            raise IndexError("LazyPoints index out of range")
        x = int.from_bytes(self.raw[i * 64: i * 64 + 32], "little")
        y = int.from_bytes(self.raw[i * 64 + 32: i * 64 + 64], "little")
        return G1.identity() if x == 0 and y == 0 else G1(x, y)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return [self._one(i) for i in range(*idx.indices(self._n))]
        return self._one(idx)

    def __iter__(self):
        return (self._one(i) for i in range(self._n))

    def __eq__(self, other):
        if isinstance(other, LazyPoints):
            return self.raw == other.raw
        try:
            if len(other) != self._n:
                return False
            return all(a.infinity == b.infinity
                       and (a.infinity or (a.x == b.x and a.y == b.y))
                       for a, b in zip(self, other))
        except (TypeError, AttributeError):
            return NotImplemented


class KZGSRS:
    """g1_powers[i] = tau^i * G1; g2 = G2; beta_g2 = tau * G2.

    g2_powers = [tau^2 * G2, tau^3 * G2] supports the Shplonk-style
    single-witness batch opening (hyperkzg.py open): the verifier
    assembles [Z_S(tau)]_2 for the cubic vanishing polynomial of the
    three opening points. Revealing two more G2 powers of tau is the
    standard extended-power KZG setup (binding under the corresponding
    q-type assumption). None on legacy serialized SRS files."""

    def __init__(self, g1_powers: list[G1], g2: G2, beta_g2: G2,
                 raw_points: bytes | None = None,
                 g2_powers: list[G2] | None = None):
        self.g1_powers = g1_powers
        self.g2 = g2
        self.beta_g2 = beta_g2
        self.g2_powers = g2_powers
        self._raw_points = raw_points
        self._prepared = None
        self._prepared_failed = False

    def prepared_bases(self):
        """Native Montgomery-encoded base buffer, built once and reused by
        every commitment/opening MSM (None when the native lib is absent)."""
        if self._prepared is None and not self._prepared_failed:
            from ..curve import native
            if native.available():
                self._prepared = native.PreparedBases(
                    self.g1_powers, raw=self._raw_points)
            else:
                self._prepared_failed = True
        return self._prepared


    @classmethod
    def setup(cls, max_degree: int, seed: bytes = b"jolt-atlas-tpu-srs") -> "KZGSRS":
        tau = int.from_bytes(hashlib.blake2b(seed, digest_size=32).digest(),
                             "little") % FR_MODULUS
        g = g1_generator()
        scalars = []
        acc = 1
        for _ in range(max_degree + 1):
            scalars.append(acc)
            acc = acc * tau % FR_MODULUS
        from ..curve.native import scalar_muls_native_raw
        raw = scalar_muls_native_raw(g, scalars)
        if raw is not None:
            powers = LazyPoints(raw)
        else:
            powers = [g * s for s in scalars]
        h = g2_generator()
        bh = h * tau
        return cls(powers, h, bh, raw_points=raw,
                   g2_powers=[bh * tau, bh * (tau * tau % FR_MODULUS)])

    def max_degree(self) -> int:
        return len(self.g1_powers) - 1

    def serialize(self) -> bytes:
        out = len(self.g1_powers).to_bytes(8, "little")
        if self._raw_points is not None:
            out += self._raw_points
        else:
            for p in self.g1_powers:
                out += p.serialize()
        out += self.g2.serialize() + self.beta_g2.serialize()
        if self.g2_powers is not None:
            for p in self.g2_powers:
                out += p.serialize()
        return out

    @classmethod
    def deserialize(cls, data: bytes) -> "KZGSRS":
        n = int.from_bytes(data[:8], "little")
        off = 8
        raw = bytes(data[off: off + 64 * n])
        off += 64 * n
        g2 = G2.deserialize(data[off:off + 128])
        beta = G2.deserialize(data[off + 128:off + 256])
        off += 256
        g2p = None
        if len(data) >= off + 256:  # extended-power file (round 4+)
            g2p = [G2.deserialize(data[off:off + 128]),
                   G2.deserialize(data[off + 128:off + 256])]
        return cls(LazyPoints(raw), g2, beta, raw_points=raw, g2_powers=g2p)

    def save(self, path: str) -> None:
        """Persist a ceremony/generated SRS (reference hyperkzg/mod.rs:60-100
        save/load)."""
        with open(path, "wb") as f:
            f.write(self.serialize())

    @classmethod
    def load(cls, path: str) -> "KZGSRS":
        with open(path, "rb") as f:
            return cls.deserialize(f.read())

    def trim(self, max_degree: int) -> "KZGSRS":
        """Prefix SRS for a smaller circuit (reference SRS::trim)."""
        assert max_degree + 1 <= len(self.g1_powers)
        raw = (self._raw_points[: 64 * (max_degree + 1)]
               if self._raw_points is not None else None)
        return KZGSRS(self.g1_powers[: max_degree + 1], self.g2, self.beta_g2,
                      raw_points=raw, g2_powers=self.g2_powers)


def kzg_commit(srs: KZGSRS, coeffs) -> G1:
    """Commit to a coefficient vector (FrArray, list of Fr, or int array)."""
    from ..field.frvec import FrArray
    prep = srs.prepared_bases()
    if prep is not None:
        if isinstance(coeffs, FrArray):
            return prep.msm_packed(coeffs.canonical().tobytes(), len(coeffs))
        if isinstance(coeffs, np.ndarray) and coeffs.dtype.kind in "iu":
            return prep.msm(coeffs)  # vectorized packing, no Fr boxing
        scalars = [c.v if isinstance(c, Fr) else int(c) for c in coeffs]
        return prep.msm(scalars)
    if isinstance(coeffs, FrArray):
        coeffs = coeffs.to_fr_list()
    scalars = [c.v if isinstance(c, Fr) else int(c) for c in coeffs]
    return msm(srs.g1_powers[: len(scalars)], scalars)


def eval_as_univariate(coeffs, u: Fr) -> Fr:
    """Horner evaluation treating MLE evals as univariate coefficients."""
    from ..field import frvec
    from ..field.frvec import FrArray
    if isinstance(coeffs, FrArray):
        return frvec.horner(coeffs, u)
    acc = 0
    uv = u.v
    for c in reversed(coeffs):
        acc = (acc * uv + c.v) % FR_MODULUS
    return Fr(acc)
