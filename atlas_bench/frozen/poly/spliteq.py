"""Gruen/Dao-Thaler split-eq weight schedule for sumcheck instances.

Mirrors the role of the reference's GruenSplitEqPolynomial
(joltworks/src/poly/split_eq_poly.rs:67): an instance of the form

    s_i(X) = [prod_{k<i} l_k(c_k)] * l_i(X) * q_i(X),
    q_i(X) = sum_j w_i(j) * P(X, j),   w_i(j) = eq(r_eq[i+1:], j)

never materializes the eq row. Instead the per-round pair weight w_i
factors as whi[j >> shift] * wlo[j & mask] over two small tables that are
rebuilt with O(sqrt n) total work, and the current variable's contribution
is the *linear* polynomial l_i(X) = (1 - r_i) + X (2 r_i - 1) applied when
assembling the round message — dropping both the per-pair eq multiply and
one whole evaluation point (q has degree deg-1).

Two layouts are supported, both with HighToLow (MSB-first) binding:

  * suffix-eq (``pre_vars`` leading plain variables): domain x =
    (plain, eq); the eq point covers the LAST len(r_eq) variables. Plain
    rounds come first; the weight is constant w.r.t. the current variable
    there (no l factor; the full split eq table is the weight). Used by
    cycle-execution (pre=0), Booleanity (pre=0, eq over address||cycle),
    EqPair (pre=4 chunk vars), LtPair (pre=8).
  * prefix-eq (``post_vars`` trailing plain variables): domain x =
    (eq, plain) — einsum shared-output weights broadcast along contraction
    variables (np.repeat layout). Eq rounds come first; after they are
    exhausted the weight is the accumulated scalar only.
"""

from __future__ import annotations

from ..field.scalar import Fr

_INV_CACHE: dict[int, Fr] = {}


def inv_cached(x: Fr) -> Fr:
    """Memoized field inverse — round challenges and eq coordinates repeat
    across the dozens of instances sharing each opening point."""
    got = _INV_CACHE.get(x.v)
    if got is None:
        if len(_INV_CACHE) > 8192:
            _INV_CACHE.clear()
        got = x.inverse()
        _INV_CACHE[x.v] = got
    return got


