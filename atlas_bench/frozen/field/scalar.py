"""Scalar (Python-int) BN254 Fr element.

This is the host-side reference implementation used for transcript logic,
verifier math, and as the correctness oracle for the vectorized JAX backend.
Semantics mirror joltworks/src/field/mod.rs (JoltField) + arkworks ark_bn254.

Values are stored in canonical (non-Montgomery) form as Python ints in [0, r).
Serialization matches arkworks `serialize_uncompressed`: 32 bytes little-endian
of the canonical value.
"""

from __future__ import annotations

from .constants import CHALLENGE_MASK_125, FR_MODULUS, TWO_NEG_128

R = FR_MODULUS


class Fr:
    """BN254 scalar-field element (canonical Python-int representation)."""

    __slots__ = ("v",)

    def __init__(self, v: int = 0):
        self.v = v % R

    # -- constructors ------------------------------------------------------
    @classmethod
    def zero(cls) -> "Fr":
        return cls(0)

    @classmethod
    def one(cls) -> "Fr":
        return cls(1)

    @classmethod
    def from_i64(cls, x: int) -> "Fr":
        return cls(x % R)

    @classmethod
    def from_bytes_le(cls, b: bytes) -> "Fr":
        return cls(int.from_bytes(b, "little"))

    @classmethod
    def from_bytes_be(cls, b: bytes) -> "Fr":
        return cls(int.from_bytes(b, "big"))

    @classmethod
    def from_u128_challenge(cls, val: int) -> "Fr":
        """The 125-bit optimized transcript challenge.

        Masks to 125 bits and interprets the masked value as Montgomery limbs
        shifted by 128 bits, i.e. canonical value = v * 2^-128 mod r
        (reference mont_ark_u128.rs:62-84, from_bigint_unchecked).
        """
        v = val & CHALLENGE_MASK_125
        return cls((v * TWO_NEG_128) % R)

    # -- serialization -----------------------------------------------------
    def to_bytes_le(self) -> bytes:
        return self.v.to_bytes(32, "little")

    def to_bytes_be(self) -> bytes:
        return self.v.to_bytes(32, "big")

    # -- arithmetic --------------------------------------------------------
    def __add__(self, o: "Fr") -> "Fr":
        return Fr(self.v + o.v)

    def __sub__(self, o: "Fr") -> "Fr":
        return Fr(self.v - o.v)

    def __neg__(self) -> "Fr":
        return Fr(-self.v)

    def __mul__(self, o) -> "Fr":
        if isinstance(o, Fr):
            return Fr(self.v * o.v)
        return Fr(self.v * int(o))

    __rmul__ = __mul__

    def __pow__(self, e: int) -> "Fr":
        return Fr(pow(self.v, e, R))

    def inverse(self) -> "Fr":
        if self.v == 0:
            raise ZeroDivisionError("inverse of zero field element")
        # native Fermat inversion is ~4x faster than CPython's
        # extended-Euclid bigint pow(v, -1, r) (22 us -> ~6 us)
        from . import frvec
        got = frvec.fr_inverse(self)
        if got is not None:
            return got
        return Fr(pow(self.v, -1, R))

    def __eq__(self, o) -> bool:
        return isinstance(o, Fr) and self.v == o.v

    def __hash__(self) -> int:
        return hash(self.v)

    def __int__(self) -> int:
        return self.v

    def is_zero(self) -> bool:
        return self.v == 0

    def is_one(self) -> bool:
        return self.v == 1

    def __repr__(self) -> str:
        return f"Fr({self.v})"


def batch_inverse(elems: list[Fr]) -> list[Fr]:
    """Montgomery batch inversion: one modular inverse for N elements."""
    n = len(elems)
    if n == 0:
        return []
    prefix = [0] * n
    acc = 1
    for i, e in enumerate(elems):
        if e.v == 0:
            raise ZeroDivisionError("batch_inverse: zero element")
        prefix[i] = acc
        acc = (acc * e.v) % R
    inv = pow(acc, -1, R)
    out = [None] * n
    for i in range(n - 1, -1, -1):
        out[i] = Fr(inv * prefix[i])
        inv = (inv * elems[i].v) % R
    return out
