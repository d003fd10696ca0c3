"""BN254 G1 and G2 points.

G1: y^2 = x^3 + 3 over Fq, generator (1, 2).
G2: y^2 = x^3 + 3/(9+u) over Fq2 (the sextic twist), standard generator.

Affine representation with `None`-free explicit infinity flag; hot-path
Jacobian arithmetic lives as plain int-tuple helpers used by the MSM
(curve/msm.py). Transcript encoding is big-endian x||y, matching the
reference's append_point (joltworks/src/transcripts/blake2b.rs:166-187).
"""

from __future__ import annotations

from ..field.constants import FQ_MODULUS as Q, FR_MODULUS
from .fq import FQ2

G1_B = 3
G2_B = FQ2(3, 0) * FQ2(9, 1).inverse()


class G1:
    """Affine BN254 G1 point (int coordinates mod q)."""

    __slots__ = ("x", "y", "infinity")

    def __init__(self, x: int, y: int, infinity: bool = False):
        self.x = x % Q
        self.y = y % Q
        self.infinity = infinity

    @classmethod
    def identity(cls) -> "G1":
        return cls(0, 0, True)

    def is_zero(self) -> bool:
        return self.infinity

    def is_on_curve(self) -> bool:
        if self.infinity:
            return True
        return (self.y * self.y - self.x**3 - G1_B) % Q == 0

    def __eq__(self, o) -> bool:
        if not isinstance(o, G1):
            return False
        if self.infinity or o.infinity:
            return self.infinity == o.infinity
        return self.x == o.x and self.y == o.y

    def __hash__(self):
        return hash((self.x, self.y, self.infinity))

    def __neg__(self) -> "G1":
        if self.infinity:
            return self
        return G1(self.x, -self.y)

    def __add__(self, o: "G1") -> "G1":
        if self.infinity:
            return o
        if o.infinity:
            return self
        if self.x == o.x:
            if (self.y + o.y) % Q == 0:
                return G1.identity()
            m = 3 * self.x * self.x * pow(2 * self.y, -1, Q) % Q
        else:
            m = (o.y - self.y) * pow(o.x - self.x, -1, Q) % Q
        x3 = (m * m - self.x - o.x) % Q
        y3 = (m * (self.x - x3) - self.y) % Q
        return G1(x3, y3)

    def __sub__(self, o: "G1") -> "G1":
        return self + (-o)

    def __mul__(self, k: int) -> "G1":
        k = int(k) % FR_MODULUS
        return jacobian_to_affine(jacobian_scalar_mul(affine_to_jacobian(self), k))

    __rmul__ = __mul__

    def to_transcript_bytes(self) -> bytes:
        return self.x.to_bytes(32, "big") + self.y.to_bytes(32, "big")

    def serialize(self) -> bytes:
        """arkworks-style uncompressed: x LE 32 || y LE 32 (infinity flagged)."""
        if self.infinity:
            return b"\x00" * 63 + b"\x40"
        return self.x.to_bytes(32, "little") + self.y.to_bytes(32, "little")

    @classmethod
    def deserialize(cls, data: bytes) -> "G1":
        if data[63] & 0x40:
            return cls.identity()
        return cls(int.from_bytes(data[:32], "little"),
                   int.from_bytes(data[32:64], "little"))

    def __repr__(self):
        return "G1(inf)" if self.infinity else f"G1({self.x}, {self.y})"


class G2:
    """Affine BN254 G2 point (FQ2 coordinates on the sextic twist)."""

    __slots__ = ("x", "y", "infinity")

    def __init__(self, x: FQ2, y: FQ2, infinity: bool = False):
        self.x = x
        self.y = y
        self.infinity = infinity

    @classmethod
    def identity(cls) -> "G2":
        return cls(FQ2.zero(), FQ2.zero(), True)

    def is_zero(self) -> bool:
        return self.infinity

    def is_on_curve(self) -> bool:
        if self.infinity:
            return True
        return self.y * self.y == self.x * self.x * self.x + G2_B

    def __eq__(self, o) -> bool:
        if not isinstance(o, G2):
            return False
        if self.infinity or o.infinity:
            return self.infinity == o.infinity
        return self.x == o.x and self.y == o.y

    def __neg__(self) -> "G2":
        if self.infinity:
            return self
        return G2(self.x, -self.y)

    def __add__(self, o: "G2") -> "G2":
        if self.infinity:
            return o
        if o.infinity:
            return self
        if self.x == o.x:
            if (self.y + o.y).is_zero():
                return G2.identity()
            m = (3 * (self.x * self.x)) * (2 * self.y).inverse()
        else:
            m = (o.y - self.y) * (o.x - self.x).inverse()
        x3 = m * m - self.x - o.x
        y3 = m * (self.x - x3) - self.y
        return G2(x3, y3)

    def __sub__(self, o: "G2") -> "G2":
        return self + (-o)

    def __mul__(self, k: int) -> "G2":
        k = int(k) % FR_MODULUS
        result = G2.identity()
        addend = self
        while k:
            if k & 1:
                result = result + addend
            addend = addend + addend
            k >>= 1
        return result

    __rmul__ = __mul__

    def to_transcript_bytes(self) -> bytes:
        return (self.x.a.to_bytes(32, "big") + self.x.b.to_bytes(32, "big")
                + self.y.a.to_bytes(32, "big") + self.y.b.to_bytes(32, "big"))

    def serialize(self) -> bytes:
        if self.infinity:
            return b"\x00" * 127 + b"\x40"
        return (self.x.a.to_bytes(32, "little") + self.x.b.to_bytes(32, "little")
                + self.y.a.to_bytes(32, "little") + self.y.b.to_bytes(32, "little"))

    @classmethod
    def deserialize(cls, data: bytes) -> "G2":
        if data[127] & 0x40:
            return cls.identity()
        return cls(
            FQ2(int.from_bytes(data[:32], "little"),
                int.from_bytes(data[32:64], "little")),
            FQ2(int.from_bytes(data[64:96], "little"),
                int.from_bytes(data[96:128], "little")),
        )

    def __repr__(self):
        return "G2(inf)" if self.infinity else f"G2({self.x}, {self.y})"


def g1_generator() -> G1:
    return G1(1, 2)


def g2_generator() -> G2:
    return G2(
        FQ2(
            10857046999023057135944570762232829481370756359578518086990519993285655852781,
            11559732032986387107991004021392285783925812861821192530917403151452391805634,
        ),
        FQ2(
            8495653923123431417604973247489272438418190587263600148770280649306958101930,
            4082367875863433681332203403145435568316851327593401208105741076214120093531,
        ),
    )


# ---------------------------------------------------------------------------
# Jacobian int-tuple arithmetic (used by the MSM hot path; no class overhead)
# ---------------------------------------------------------------------------

JINF = (0, 1, 0)  # Z=0 encodes infinity


def affine_to_jacobian(p: G1):
    if p.infinity:
        return JINF
    return (p.x, p.y, 1)


def jacobian_to_affine(j) -> G1:
    X, Y, Z = j
    if Z == 0:
        return G1.identity()
    zinv = pow(Z, -1, Q)
    z2 = zinv * zinv % Q
    return G1(X * z2 % Q, Y * z2 % Q * zinv % Q)


def jacobian_double(j):
    X, Y, Z = j
    if Z == 0 or Y == 0:
        return JINF if Y == 0 else j
    A = X * X % Q
    B = Y * Y % Q
    C = B * B % Q
    D = 2 * ((X + B) * (X + B) - A - C) % Q
    E = 3 * A % Q
    F = E * E % Q
    X3 = (F - 2 * D) % Q
    Y3 = (E * (D - X3) - 8 * C) % Q
    Z3 = 2 * Y * Z % Q
    return (X3, Y3, Z3)


def jacobian_add(j1, j2):
    X1, Y1, Z1 = j1
    X2, Y2, Z2 = j2
    if Z1 == 0:
        return j2
    if Z2 == 0:
        return j1
    Z1Z1 = Z1 * Z1 % Q
    Z2Z2 = Z2 * Z2 % Q
    U1 = X1 * Z2Z2 % Q
    U2 = X2 * Z1Z1 % Q
    S1 = Y1 * Z2 * Z2Z2 % Q
    S2 = Y2 * Z1 * Z1Z1 % Q
    if U1 == U2:
        if S1 != S2:
            return JINF
        return jacobian_double(j1)
    H = (U2 - U1) % Q
    I = 4 * H * H % Q
    J = H * I % Q
    r = 2 * (S2 - S1) % Q
    V = U1 * I % Q
    X3 = (r * r - J - 2 * V) % Q
    Y3 = (r * (V - X3) - 2 * S1 * J) % Q
    Z3 = 2 * H * Z1 * Z2 % Q
    return (X3, Y3, Z3)


def jacobian_add_affine(j, p: G1):
    """Mixed addition j + affine point (Z2 = 1), the MSM workhorse."""
    if p.infinity:
        return j
    X1, Y1, Z1 = j
    if Z1 == 0:
        return (p.x, p.y, 1)
    Z1Z1 = Z1 * Z1 % Q
    U2 = p.x * Z1Z1 % Q
    S2 = p.y * Z1 * Z1Z1 % Q
    if X1 == U2:
        if Y1 != S2:
            return JINF
        return jacobian_double(j)
    H = (U2 - X1) % Q
    HH = H * H % Q
    I = 4 * HH % Q
    J = H * I % Q
    r = 2 * (S2 - Y1) % Q
    V = X1 * I % Q
    X3 = (r * r - J - 2 * V) % Q
    Y3 = (r * (V - X3) - 2 * Y1 * J) % Q
    Z3 = (Z1 + H) * (Z1 + H) % Q
    Z3 = (Z3 - Z1Z1 - HH) % Q
    return (X3, Y3, Z3)


def jacobian_scalar_mul(j, k: int):
    result = JINF
    addend = j
    while k:
        if k & 1:
            result = jacobian_add(result, addend)
        addend = jacobian_double(addend)
        k >>= 1
    return result
