"""Optimal-ate pairing on BN254.

Reference: optimal ate pairing as consumed by the reference's HyperKZG
pairing check (joltworks/src/poly/commitment/hyperkzg/mod.rs:451-514 via
ark-ec). Miller loop over 6x+2, two Frobenius line corrections, final
exponentiation (p^12-1)/r.

Textbook implementation (same construction as py_ecc / arkworks use for
alt_bn128): G2 points are lifted from the sextic twist E'(Fq2) into E(Fq12)
("untwisting"), the Miller loop runs over the 6x+2 ate loop count with
generic line functions, followed by the two Frobenius correction steps and
the final exponentiation (q^12 - 1)/r.

Verifier-side only (HyperKZG pairing checks) — not prover-hot, so Python-int
arithmetic is fine; the prover-side MSMs are the TPU path.
"""

from __future__ import annotations

from ..field.constants import BN_X, FQ_MODULUS as Q, FR_MODULUS
from .fq import FQ2, FQ12
from .points import G1, G2

ATE_LOOP_COUNT = 6 * BN_X + 2  # 29793968203157093288
# Miller loop starts with R = Q (consuming the MSB), so iterate the rest.
_LOG_ATE = ATE_LOOP_COUNT.bit_length() - 2

# w in FQ12 (w^6 = 9 + u)
_W = FQ12([0, 1] + [0] * 10)
_W2 = _W * _W
_W3 = _W2 * _W


def _fq2_to_fq12(e: FQ2) -> FQ12:
    """Embed a + b*u into FQ12 using u = w^6 - 9."""
    c = [0] * 12
    c[0] = (e.a - 9 * e.b) % Q
    c[6] = e.b
    return FQ12(c)


def twist(p: G2):
    """Lift a twist point (x, y) in E'(Fq2) to (x*w^2, y*w^3) in E(Fq12)."""
    if p.infinity:
        return None
    return (_fq2_to_fq12(p.x) * _W2, _fq2_to_fq12(p.y) * _W3)


def _g1_to_fq12(p: G1):
    if p.infinity:
        return None
    return (FQ12([p.x] + [0] * 11), FQ12([p.y] + [0] * 11))


def _line(p1, p2, t):
    """Line through p1, p2 (FQ12 points) evaluated at t."""
    x1, y1 = p1
    x2, y2 = p2
    xt, yt = t
    if x1 != x2:
        m = (y2 - y1) * (x2 - x1).inverse()
        return m * (xt - x1) - (yt - y1)
    if y1 == y2:
        m = (3 * (x1 * x1)) * (2 * y1).inverse()
        return m * (xt - x1) - (yt - y1)
    return xt - x1


def _double(p):
    x, y = p
    m = (3 * (x * x)) * (2 * y).inverse()
    nx = m * m - 2 * x
    ny = m * (x - nx) - y
    return (nx, ny)


def _add(p1, p2):
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2 and y1 == y2:
        return _double(p1)
    m = (y2 - y1) * (x2 - x1).inverse()
    nx = m * m - x1 - x2
    ny = m * (x1 - nx) - y1
    return (nx, ny)


def miller_loop(q_tw, p_12) -> FQ12:
    if q_tw is None or p_12 is None:
        return FQ12.one()
    r = q_tw
    f = FQ12.one()
    for i in range(_LOG_ATE, -1, -1):
        f = f * f * _line(r, r, p_12)
        r = _double(r)
        if ATE_LOOP_COUNT & (1 << i):
            f = f * _line(r, q_tw, p_12)
            r = _add(r, q_tw)
    # Frobenius correction steps: Q1 = pi_q(Q), Q2 = -pi_q^2(Q)
    q1 = (q_tw[0] ** Q, q_tw[1] ** Q)
    nq2 = ((q1[0] ** Q), -(q1[1] ** Q))
    f = f * _line(r, q1, p_12)
    r = _add(r, q1)
    f = f * _line(r, nq2, p_12)
    return f


_FINAL_EXP = (Q**12 - 1) // FR_MODULUS


def pairing(p: G1, q: G2) -> FQ12:
    """e(P, Q) in the target group (full pairing incl. final exponentiation)."""
    if p.is_zero() or q.is_zero():
        return FQ12.one()
    assert p.is_on_curve() and q.is_on_curve()
    return miller_loop(twist(q), _g1_to_fq12(p)) ** _FINAL_EXP


def _pairing_product_native(pairs):
    """csrc pairing engine (csrc/msm.cpp bn_pairing_product): same flat
    Fq12 construction, cross-checked coefficient-exact against this
    module. None when the native lib is unavailable."""
    from . import native
    lib = native._load()
    if lib is None or not hasattr(lib, "bn_pairing_product"):
        return None
    import ctypes
    g1b = b"".join(
        b"\x00" * 64 if p.is_zero()
        else p.x.to_bytes(32, "little") + p.y.to_bytes(32, "little")
        for p, _ in pairs)
    g2b = b"".join(
        b"\x00" * 128 if q.is_zero()
        else (q.x.a.to_bytes(32, "little") + q.x.b.to_bytes(32, "little")
              + q.y.a.to_bytes(32, "little") + q.y.b.to_bytes(32, "little"))
        for _, q in pairs)
    out = ctypes.create_string_buffer(12 * 32)
    lib.bn_pairing_product(g1b, g2b, len(pairs), _FINAL_EXP_BYTES,
                           len(_FINAL_EXP_BYTES), out)
    return [int.from_bytes(out.raw[i * 32:(i + 1) * 32], "little")
            for i in range(12)]


_FINAL_EXP_BYTES = _FINAL_EXP.to_bytes((_FINAL_EXP.bit_length() + 7) // 8,
                                       "little")


def pairing_check(pairs) -> bool:
    """prod e(Pi, Qi) == 1, with one shared final exponentiation."""
    pairs = list(pairs)
    res = _pairing_product_native(pairs)
    if res is not None:
        return res[0] == 1 and all(c == 0 for c in res[1:])
    acc = FQ12.one()
    for p, q in pairs:
        if p.is_zero() or q.is_zero():
            continue
        acc = acc * miller_loop(twist(q), _g1_to_fq12(p))
    return (acc ** _FINAL_EXP).is_one()
