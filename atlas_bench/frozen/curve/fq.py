"""BN254 base-field tower: Fq, Fq2 = Fq[u]/(u^2+1), Fq12 = Fq[w]/(w^12-18w^6+82).

Reference: the BN254 base-field tower the reference consumes through
arkworks (ark-bn254; used by joltworks/src/curve.rs Bn254Curve). Fq2 as
Fq[u]/(u^2+1); Fq12 as a degree-12 extension with modulus w^12 - 18 w^6
+ 82 (the standard BN254 tower flattened to one polynomial quotient).

Standard textbook construction (the same tower arkworks/py_ecc use for
alt_bn128). Python-int arithmetic — this layer backs the verifier-side
pairing checks and SRS generation, which are not prover-hot.
"""

from __future__ import annotations

from ..field.constants import FQ_MODULUS as Q


class FQ2:
    """a + b*u with u^2 = -1."""

    __slots__ = ("a", "b")

    def __init__(self, a: int, b: int = 0):
        self.a = a % Q
        self.b = b % Q

    @classmethod
    def one(cls):
        return cls(1, 0)

    @classmethod
    def zero(cls):
        return cls(0, 0)

    def __add__(self, o):
        return FQ2(self.a + o.a, self.b + o.b)

    def __sub__(self, o):
        return FQ2(self.a - o.a, self.b - o.b)

    def __neg__(self):
        return FQ2(-self.a, -self.b)

    def __mul__(self, o):
        if isinstance(o, int):
            return FQ2(self.a * o, self.b * o)
        # (a+bu)(c+du) = ac - bd + (ad+bc)u
        return FQ2(self.a * o.a - self.b * o.b, self.a * o.b + self.b * o.a)

    __rmul__ = __mul__

    def square(self):
        return self * self

    def inverse(self):
        # 1/(a+bu) = (a-bu)/(a^2+b^2)
        inv = pow(self.a * self.a + self.b * self.b, -1, Q)
        return FQ2(self.a * inv, (-self.b) * inv)

    def conjugate(self):
        return FQ2(self.a, -self.b)

    def __pow__(self, e: int):
        result = FQ2.one()
        base = self
        while e > 0:
            if e & 1:
                result = result * base
            base = base * base
            e >>= 1
        return result

    def __eq__(self, o):
        return isinstance(o, FQ2) and self.a == o.a and self.b == o.b

    def __hash__(self):
        return hash((self.a, self.b))

    def is_zero(self):
        return self.a == 0 and self.b == 0

    def __repr__(self):
        return f"FQ2({self.a}, {self.b})"


# FQ12 as a degree-12 polynomial extension of Fq with modulus w^12 - 18w^6 + 82
# (the minimal polynomial of w where w^6 = 9 + u, u^2 = -1).
_FQ12_MOD = [82, 0, 0, 0, 0, 0, -18, 0, 0, 0, 0, 0]  # low-degree coeffs of w^12


class FQ12:
    __slots__ = ("c",)

    def __init__(self, coeffs):
        assert len(coeffs) == 12
        self.c = [x % Q for x in coeffs]

    @classmethod
    def one(cls):
        return cls([1] + [0] * 11)

    @classmethod
    def zero(cls):
        return cls([0] * 12)

    def __add__(self, o):
        return FQ12([x + y for x, y in zip(self.c, o.c)])

    def __sub__(self, o):
        return FQ12([x - y for x, y in zip(self.c, o.c)])

    def __neg__(self):
        return FQ12([-x for x in self.c])

    def __mul__(self, o):
        if isinstance(o, int):
            return FQ12([x * o for x in self.c])
        t = [0] * 23
        a, b = self.c, o.c
        for i in range(12):
            ai = a[i]
            if ai:
                for j in range(12):
                    t[i + j] += ai * b[j]
        # reduce degrees 22..12 using w^12 = 18w^6 - 82
        for d in range(22, 11, -1):
            v = t[d]
            if v:
                t[d] = 0
                t[d - 6] += 18 * v
                t[d - 12] -= 82 * v
        return FQ12(t[:12])

    __rmul__ = __mul__

    def __pow__(self, e: int):
        result = FQ12.one()
        base = self
        while e > 0:
            if e & 1:
                result = result * base
            base = base * base
            e >>= 1
        return result

    def inverse(self):
        # extended Euclid over Fq[x] against the modulus poly 82 - 18w^6 + w^12
        lm, hm = [1] + [0] * 12, [0] * 13
        low = list(self.c) + [0]
        high = [82, 0, 0, 0, 0, 0, (-18) % Q, 0, 0, 0, 0, 0, 1]
        while _deg(low):
            r = _poly_div(high, low)
            r += [0] * (13 - len(r))
            nm, new = list(hm), list(high)
            for i in range(13):
                for j in range(13 - i):
                    nm[i + j] -= lm[i] * r[j]
                    new[i + j] -= low[i] * r[j]
            nm = [x % Q for x in nm]
            new = [x % Q for x in new]
            lm, low, hm, high = nm, new, lm, low
        inv_c0 = pow(low[0], -1, Q)
        return FQ12([x * inv_c0 % Q for x in lm[:12]])

    def __eq__(self, o):
        return isinstance(o, FQ12) and self.c == o.c

    def is_one(self):
        return self.c[0] == 1 and all(x == 0 for x in self.c[1:])

    def __repr__(self):
        return f"FQ12({self.c})"


def _deg(p):
    d = len(p) - 1
    while d and p[d] == 0:
        d -= 1
    return d


def _poly_div(a, b):
    """Polynomial floor-division a // b over Fq (leading coeff inverted)."""
    dega, degb = _deg(a), _deg(b)
    temp = list(a)
    out = [0] * (dega - degb + 1)
    inv_lead = pow(b[degb], -1, Q)
    for i in range(dega - degb, -1, -1):
        out[i] = temp[degb + i] * inv_lead % Q
        for j in range(degb + 1):
            temp[i + j] -= out[i] * b[j]
        temp = [x % Q for x in temp]
    return out
