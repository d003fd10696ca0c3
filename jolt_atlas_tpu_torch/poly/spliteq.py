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


class SplitEq:
    def __init__(self, r_eq: list[Fr], pre_vars: int = 0, post_vars: int = 0):
        assert not (pre_vars and post_vars)
        self.r = list(r_eq)
        self.m = len(self.r)
        self.pre = pre_vars
        self.post = post_vars
        self.scalar = Fr.one()
        self.scalar_inv = Fr.one()
        # suffix-eq split point: the last `tail` eq vars keep a fixed table
        self.tail = self.m // 2 if not post_vars else 0
        self._wlo_base = None
        self._whi_prefix = None
        self._cache_round = None
        self._cache_tables = None

    # -- table construction ------------------------------------------------
    _EQ_TABLE_MEMO: dict = {}

    @staticmethod
    def _eq_table(point: list[Fr]):
        """(2^len, 4) Montgomery eq table (native path only), memoized by
        the point value — the dozens of instances sharing each opening
        point rebuild identical per-round tables otherwise."""
        from ..field import frvec
        key = tuple(x.v for x in point)
        memo = SplitEq._EQ_TABLE_MEMO
        got = memo.get(key)
        if got is None:
            if len(memo) > 4096:
                # drop the oldest half — a wholesale clear() threw away
                # every hot per-round table (~4k rebuilds per bench prove)
                for k in list(memo.keys())[: len(memo) // 2]:
                    del memo[k]
            got = memo[key] = frvec.eq_expand(point).d
        return got

    def _wlo(self):
        if self._wlo_base is None:
            self._wlo_base = self._eq_table(self.r[self.m - self.tail:])
        return self._wlo_base

    def tables(self, rnd: int):
        """(whi, whi_shift, wlo, log_wlo) for this round's kernel call.
        whi/wlo are (k,4) u64 arrays or None."""
        if self._cache_round == rnd:
            return self._cache_tables
        if self.post:
            if rnd < self.m:
                rem = self.r[rnd + 1:]
                whi = self._eq_table(rem) if rem else None
                out = (whi, self.post, None, -1)
            else:
                out = (None, 0, None, -1)
        else:
            if rnd < self.pre:
                # plain rounds: full eq table as split weight, constant
                # w.r.t. the current variable
                if self.m == 0:
                    out = (None, 0, None, -1)
                elif self.tail == 0:  # m == 1
                    out = (None, 0, self._eq_table(self.r), self.m)
                else:
                    if self._whi_prefix is None and self.m > self.tail:
                        self._whi_prefix = self._eq_table(
                            self.r[: self.m - self.tail])
                    return self._memo(rnd, (self._whi_prefix, self.tail,
                                            self._wlo(), self.tail))
            else:
                idx = rnd - self.pre
                rem = self.m - idx - 1  # suffix eq vars after the current one
                if rem > self.tail:
                    whi = self._eq_table(self.r[idx + 1: self.m - self.tail])
                    out = (whi, self.tail, self._wlo(), self.tail)
                elif rem == self.tail and self.tail > 0:
                    out = (None, 0, self._wlo(), self.tail)
                elif rem > 0:
                    out = (None, 0, self._eq_table(self.r[idx + 1:]), rem)
                else:
                    out = (None, 0, None, -1)
        return self._memo(rnd, out)

    def _memo(self, rnd, out):
        self._cache_round = rnd
        self._cache_tables = out
        return out

    # -- current-variable line --------------------------------------------
    def l_linear(self, rnd: int):
        """(l(0), l(1)) of the current variable's eq line, or None when the
        weight does not involve the current variable (plain rounds)."""
        if self.post:
            idx = rnd
        else:
            idx = rnd - self.pre
        if 0 <= idx < self.m:
            ri = self.r[idx]
            return (Fr.one() - ri, ri)
        return None

    def note_challenge(self, c: Fr, rnd: int) -> None:
        lin = self.l_linear(rnd)
        if lin is not None:
            l0, l1 = lin
            val = l0 + c * (l1 - l0)
            # seed the products\' Montgomery limb rows into the scalar
            # cache (they feed the gruen_assemble kernel next round — a
            # plain Fr multiply would cost a limb-encode miss there)
            from ..field import frvec
            if frvec.available():
                self.scalar = frvec.mul_seed_cache(self.scalar, val)
                self.scalar_inv = frvec.mul_seed_cache(self.scalar_inv,
                                                       inv_cached(val))
            else:
                self.scalar = self.scalar * val
                self.scalar_inv = self.scalar_inv * inv_cached(val)
        self._cache_round = None
        self._cache_tables = None
