"""Dory-style transparent multilinear PCS (AFGHO matrix commitment +
inner-pairing-product opening).

Plays the role of the reference's Dory adapter
(joltworks/src/poly/commitment/dory/mod.rs:59, wrapping the external
`dory-pcs` crate). Construction implemented here:

  * **Commitment** (Dory §5 / AFGHO): the coefficient vector is laid out
    as an r x c matrix M (row-major, MSB variables select the row). Row
    commitments V_i = <M_i, Γ1> in G1; the published commitment is the
    inner pairing product C = Σ_i e(V_i, Γ2_i) in GT. Transparent setup:
    Γ1/Γ2 are hash-to-curve points (no trusted scalar exists).
  * **Fixed column width** (reference dory/mod.rs fixed-column trick):
    every polynomial in a proof shares the same Γ1 columns and Γ2 row
    prefix, so commitments of different sizes combine homomorphically in
    GT — the joint RLC the batch opening needs is Π C_k^{δ_k}.
  * **Opening** at point x with v = L^T M R (L = eq over row variables,
    R = eq over column variables): the prover reveals a G1 commitment
    U = <u, Γ1> to the folded row u = M^T L, then runs two GIPA-style
    recursions: (1) a pairing-IPA proving consistency of U with C under
    L (folding V against Γ2 with GT cross terms), (2) a G1-IPA proving
    v = <u, R> under U. Proof size O(log n) GT + G1 elements.

  Verifier cost (round 5): the verifier never folds bases. The column
  argument's final base is <s, Γ1> with the structured IPA scalars
  s_j = Π βinv_k^{bit_k(j)} — O(c) field muls plus ONE batch-affine
  native MSM, O(1) group ops per round (playing the role of Dory's Δ/χ
  precomputed verifier, reference dory/mod.rs:59); the row argument is
  O(1) outright because the fixed-column layout caps rows at 2^4. The
  pairing products ride the native engine (csrc bn_pairing_product).
  Soundness is the standard GIPA/AFGHO argument under SXDH; binding
  requires no trusted setup at all, unlike HyperKZG's tau.
"""

from __future__ import annotations

import hashlib

from ..curve.fq import FQ2, FQ12, Q
from ..curve.msm import msm
from ..curve.pairing import _FINAL_EXP, _g1_to_fq12, miller_loop, twist
from ..curve.points import G1, G2, G2_B
from ..field.constants import FR_MODULUS
from ..field.scalar import Fr
from ..poly.eq import eq_evals

# BN254 G2 cofactor: #E'(Fq2) = (q - 1 + t)(q + 1 - t) with r = q + 1 - t,
# so h2 = q - 1 + t = 2q - r.
_G2_COFACTOR = 2 * Q - FR_MODULUS


def _hash_fq(tag: bytes, i: int, j: int) -> int:
    return int.from_bytes(
        hashlib.blake2b(tag + i.to_bytes(8, "little") + j.to_bytes(8, "little"),
                        digest_size=32).digest(), "little") % Q


def hash_to_g1(tag: bytes, i: int) -> G1:
    """Try-and-increment: x from the hash counter, y = sqrt(x^3 + 3).
    G1 has cofactor 1, so any curve point is in the prime-order group;
    no party knows a discrete log between two such points."""
    for ctr in range(1000):
        x = _hash_fq(tag, i, ctr)
        rhs = (x * x * x + 3) % Q
        y = pow(rhs, (Q + 1) // 4, Q)  # q ≡ 3 (mod 4)
        if y * y % Q == rhs:
            return G1(x, min(y, Q - y))
    raise RuntimeError("hash_to_g1 failed")


def _fq2_sqrt(a: FQ2):
    """Square root in Fq2 for q ≡ 3 (mod 4) (complex method), or None."""
    if a.is_zero():
        return FQ2.zero()
    a1 = a ** ((Q - 3) // 4)
    x0 = a1 * a
    alpha = a1 * x0                      # a^((q-1)/2)
    if alpha == FQ2(Q - 1, 0):
        x = FQ2(0, 1) * x0               # sqrt(-1) = u
    else:
        b = (FQ2.one() + alpha) ** ((Q - 1) // 2)
        x = b * x0
    return x if x * x == a else None


def _g2_mul_raw(p: G2, k: int) -> G2:
    """Scalar multiplication WITHOUT the mod-r reduction of G2.__mul__ —
    required for cofactor clearing, where the scalar exceeds r and the
    input point is not yet in the r-order subgroup."""
    result = G2.identity()
    addend = p
    while k:
        if k & 1:
            result = result + addend
        addend = addend + addend
        k >>= 1
    return result


def hash_to_g2(tag: bytes, i: int) -> G2:
    """Try-and-increment on the sextic twist + cofactor clearing."""
    for ctr in range(1000):
        x = FQ2(_hash_fq(tag + b"-a", i, ctr), _hash_fq(tag + b"-b", i, ctr))
        y = _fq2_sqrt(x * x * x + G2_B)
        if y is None:
            continue
        p = _g2_mul_raw(G2(x, y), _G2_COFACTOR)
        if not p.is_zero():
            return p
    raise RuntimeError("hash_to_g2 failed")


def multi_pairing(pairs) -> FQ12:
    """Π e(P_i, Q_i) with a single shared final exponentiation (native
    pairing engine when available — csrc bn_pairing_product — else the
    pure-Python Miller loop)."""
    pairs = [(p, q) for p, q in pairs if not (p.is_zero() or q.is_zero())]
    if pairs:
        from ..curve.pairing import _pairing_product_native
        c = _pairing_product_native(pairs)
        if c is not None:
            return FQ12(c)
    acc = FQ12.one()
    for p, q in pairs:
        acc = acc * miller_loop(twist(q), _g1_to_fq12(p))
    return acc ** _FINAL_EXP


def gt_bytes(e: FQ12) -> bytes:
    return b"".join(x.to_bytes(32, "big") for x in e.c)


def _gt_pow(e: FQ12, k: int) -> FQ12:
    return e ** (k % FR_MODULUS)


class DorySetup:
    """Transparent generators. `log_cols` fixes the shared column width;
    rows extend on demand (kept small — the pairing count per commit is
    the row count)."""

    def __init__(self, log_cols: int, log_rows: int,
                 seed: bytes = b"jolt-atlas-tpu-dory"):
        self.log_cols = log_cols
        self.log_rows = log_rows
        self.seed = seed
        self.g1_bases = [hash_to_g1(seed + b"-g1", i)
                         for i in range(1 << log_cols)]
        self.g2_bases = [hash_to_g2(seed + b"-g2", i)
                         for i in range(1 << log_rows)]

    @classmethod
    def for_num_vars(cls, max_num_vars: int, max_log_rows: int = 4,
                     seed: bytes = b"jolt-atlas-tpu-dory") -> "DorySetup":
        """Column-heavy split: G1 MSM work is cheap (native kernels) while
        each row costs a pairing, so cap rows at 2^max_log_rows."""
        log_rows = min(max_log_rows, max_num_vars // 2)
        return cls(max_num_vars - log_rows, log_rows, seed)

    def split(self, num_vars: int) -> tuple[int, int]:
        """(log_rows, log_cols) for a 2^num_vars polynomial: fixed column
        width when it fits, single row otherwise."""
        if num_vars <= self.log_cols:
            return 0, num_vars
        return num_vars - self.log_cols, self.log_cols


class DoryCommitment:
    __slots__ = ("gt", "num_vars")

    def __init__(self, gt: FQ12, num_vars: int):
        self.gt = gt
        self.num_vars = num_vars

    def is_zero(self) -> bool:
        return False  # GT element: always absorb the full encoding

    def to_transcript_bytes(self) -> bytes:
        return gt_bytes(self.gt)

    def serialize(self) -> bytes:
        return self.num_vars.to_bytes(8, "little") + b"".join(
            x.to_bytes(32, "little") for x in self.gt.c)

    @classmethod
    def deserialize(cls, data: bytes):
        nv = int.from_bytes(data[:8], "little")
        c = [int.from_bytes(data[8 + 32 * i: 40 + 32 * i], "little")
             for i in range(12)]
        return cls(FQ12(c), nv)

    def __eq__(self, o):
        return (isinstance(o, DoryCommitment) and self.gt.c == o.gt.c
                and self.num_vars == o.num_vars)


class DoryProof:
    """Opening proof: U plus the two IPA transcripts."""

    def __init__(self, u_commit: G1, pair_rounds, vec_rounds,
                 v_final: G1, u_final: Fr):
        self.u_commit = u_commit
        self.pair_rounds = pair_rounds   # [(C_L, C_R, U_L, U_R)] GT,GT,G1,G1
        self.vec_rounds = vec_rounds     # [(U_L, U_R, v_L, v_R)] G1,G1,Fr,Fr
        self.v_final = v_final           # final row-commitment point
        self.u_final = u_final           # final folded coefficient

    def serialize(self) -> bytes:
        from ..serde import _W
        w = _W()
        w.point(self.u_commit)
        w.u64(len(self.pair_rounds))
        for cl, cr, ul, ur in self.pair_rounds:
            w.raw(b"".join(x.to_bytes(32, "little") for x in cl.c))
            w.raw(b"".join(x.to_bytes(32, "little") for x in cr.c))
            w.point(ul)
            w.point(ur)
        w.u64(len(self.vec_rounds))
        for ul, ur, vl, vr in self.vec_rounds:
            w.point(ul)
            w.point(ur)
            w.fr(vl)
            w.fr(vr)
        w.point(self.v_final)
        w.fr(self.u_final)
        return w.out()

    @classmethod
    def deserialize(cls, data: bytes, offset: int = 0):
        from ..serde import _R
        r = _R(data)
        r.o = offset
        u_commit = r.point()

        def gt():
            return FQ12([int.from_bytes(r.raw(32), "little")
                         for _ in range(12)])

        pair_rounds = []
        for _ in range(r.u64()):
            pair_rounds.append((gt(), gt(), r.point(), r.point()))
        vec_rounds = []
        for _ in range(r.u64()):
            vec_rounds.append((r.point(), r.point(), r.fr(), r.fr()))
        v_final = r.point()
        u_final = r.fr()
        return cls(u_commit, pair_rounds, vec_rounds, v_final, u_final), r.o


def _rows(coeffs, setup: DorySetup):
    """Row-major matrix of Python-int coefficients, padded to 2^nv."""
    vals = [int(x) for x in coeffs]
    n = len(vals)
    nv = max((n - 1).bit_length(), 0)
    if n < (1 << nv):
        vals = vals + [0] * ((1 << nv) - n)
    log_r, log_c = setup.split(nv)
    c = 1 << log_c
    return [vals[i * c:(i + 1) * c] for i in range(1 << log_r)], nv


class DoryPC:
    @staticmethod
    def commit(setup: DorySetup, coeffs) -> DoryCommitment:
        rows, nv = _rows(coeffs, setup)
        pairs = []
        for i, row in enumerate(rows):
            vi = msm(setup.g1_bases[: len(row)], row)
            pairs.append((vi, setup.g2_bases[i]))
        return DoryCommitment(multi_pairing(pairs), nv)

    @staticmethod
    def open(setup: DorySetup, coeffs, point: list[Fr],
             transcript) -> DoryProof:
        """Opening proof for v = P(point). MLE convention matches
        MLPoly.evaluate (MSB-first: the first point coordinates select
        the row)."""
        rows, nv = _rows(coeffs, setup)
        assert len(point) == nv, "point arity mismatch"
        log_r, log_c = setup.split(nv)
        L = [x.v for x in eq_evals(point[:log_r])]
        R = [x.v for x in eq_evals(point[log_r:])]
        ncols = 1 << log_c

        # u = M^T L
        u = [0] * ncols
        for li, row in zip(L, rows):
            if li == 0:
                continue
            for j, mij in enumerate(row):
                if mij:
                    u[j] = (u[j] + li * mij) % FR_MODULUS
        u_commit = msm(setup.g1_bases[:ncols], u)
        transcript.append_point(u_commit)

        # --- pairing-IPA: U consistent with C under L ---
        V = [msm(setup.g1_bases[: len(row)], row) for row in rows]
        g2b = list(setup.g2_bases[: len(rows)])
        Lf = list(L)
        pair_rounds = []
        while len(V) > 1:
            h = len(V) // 2
            Va, Vb = V[:h], V[h:]
            Ga, Gb = g2b[:h], g2b[h:]
            La, Lb = Lf[:h], Lf[h:]
            cl = multi_pairing(list(zip(Va, Gb)))
            cr = multi_pairing(list(zip(Vb, Ga)))
            ul = msm(Va, Lb)
            ur = msm(Vb, La)
            transcript.append_bytes(gt_bytes(cl))
            transcript.append_bytes(gt_bytes(cr))
            transcript.append_point(ul)
            transcript.append_point(ur)
            alpha = transcript.challenge_scalar()
            ainv = alpha.inverse()
            V = [va + vb * alpha.v for va, vb in zip(Va, Vb)]
            g2b = [ga + gb * ainv.v for ga, gb in zip(Ga, Gb)]
            Lf = [(la + ainv.v * lb) % FR_MODULUS for la, lb in zip(La, Lb)]
            pair_rounds.append((cl, cr, ul, ur))
        v_final = V[0]

        # --- G1-IPA: v = <u, R> under U ---
        g1b = list(setup.g1_bases[:ncols])
        Rf = list(R)
        uf = list(u)
        vec_rounds = []
        while len(uf) > 1:
            h = len(uf) // 2
            ua, ub = uf[:h], uf[h:]
            ga, gb = g1b[:h], g1b[h:]
            ra, rb = Rf[:h], Rf[h:]
            ul = msm(gb, ua)
            ur = msm(ga, ub)
            vl = Fr(sum(x * y for x, y in zip(ua, rb)) % FR_MODULUS)
            vr = Fr(sum(x * y for x, y in zip(ub, ra)) % FR_MODULUS)
            transcript.append_point(ul)
            transcript.append_point(ur)
            transcript.append_scalar(vl)
            transcript.append_scalar(vr)
            beta = transcript.challenge_scalar()
            binv = beta.inverse()
            uf = [(a + beta.v * b) % FR_MODULUS for a, b in zip(ua, ub)]
            g1b = [a + b * binv.v for a, b in zip(ga, gb)]
            Rf = [(a + binv.v * b) % FR_MODULUS for a, b in zip(ra, rb)]
            vec_rounds.append((ul, ur, vl, vr))
        return DoryProof(u_commit, pair_rounds, vec_rounds, v_final,
                         Fr(uf[0]))

    @staticmethod
    def verify(setup: DorySetup, commitment: DoryCommitment,
               point: list[Fr], claim: Fr, proof: DoryProof,
               transcript) -> bool:
        nv = len(point)
        log_r, log_c = setup.split(nv)
        if commitment.num_vars != nv:
            return False
        L = [x.v for x in eq_evals(point[:log_r])]
        R = [x.v for x in eq_evals(point[log_r:])]
        transcript.append_point(proof.u_commit)

        # --- pairing-IPA fold (verifier folds Γ2 itself; see module doc) ---
        if len(proof.pair_rounds) != log_r:
            return False
        C = commitment.gt
        U = proof.u_commit
        g2b = list(setup.g2_bases[: 1 << log_r])
        Lf = list(L)
        for cl, cr, ul, ur in proof.pair_rounds:
            transcript.append_bytes(gt_bytes(cl))
            transcript.append_bytes(gt_bytes(cr))
            transcript.append_point(ul)
            transcript.append_point(ur)
            alpha = transcript.challenge_scalar()
            ainv = alpha.inverse()
            C = C * _gt_pow(cl, ainv.v) * _gt_pow(cr, alpha.v)
            U = U + ul * ainv.v + ur * alpha.v
            h = len(g2b) // 2
            g2b = [ga + gb * ainv.v for ga, gb in zip(g2b[:h], g2b[h:])]
            Lf = [(la + ainv.v * lb) % FR_MODULUS
                  for la, lb in zip(Lf[:h], Lf[h:])]
        # C binds V; check the final row point against both relations
        if multi_pairing([(proof.v_final, g2b[0])]).c != C.c:
            return False
        if proof.v_final * Lf[0] != U:
            return False

        # --- G1-IPA check for v = <u, R> ---
        # The verifier never folds the Γ1 bases (the round-3/4 partial:
        # per-round folding was O(c) serial group operations — Hyrax-scale).
        # Folding halves as a + βinv·b means the final base/weight are
        #   Γ1* = <s, Γ1>,  R* = <s, R>,  s_j = Π_{k: bit_k(j)=1} βinv_k
        # (bit k = the k-th fold's half selector, MSB first). s is built
        # with O(c) field muls by the doubling construction and Γ1* by ONE
        # batch-affine native MSM — per-round group work is O(1), matching
        # the role of Dory's Δ/χ precomputed-verifier trick
        # (reference joltworks/src/poly/commitment/dory/mod.rs:59) for the
        # column argument; the row argument is O(1) outright (the fixed-
        # column layout caps rows at 2^4).
        if len(proof.vec_rounds) != log_c:
            return False
        Uv = proof.u_commit
        vv = claim
        binvs = []
        for ul, ur, vl, vr in proof.vec_rounds:
            transcript.append_point(ul)
            transcript.append_point(ur)
            transcript.append_scalar(vl)
            transcript.append_scalar(vr)
            beta = transcript.challenge_scalar()
            binv = beta.inverse()
            Uv = Uv + ul * binv.v + ur * beta.v
            vv = vv + binv * vl + beta * vr
            binvs.append(binv.v)
        # doubling construction, MSB-first fold order: round k's βinv
        # weights original-index bit (log_c - k), so the LAST round's
        # factor lands on the LSB — iterate in reverse
        s = [1]
        for b in reversed(binvs):
            s = s + [x * b % FR_MODULUS for x in s]
        rstar = 0
        for sj, rj in zip(s, R):
            rstar = (rstar + sj * rj) % FR_MODULUS
        uf = proof.u_final.v
        gstar_uf = msm(setup.g1_bases[: 1 << log_c],
                       [sj * uf % FR_MODULUS for sj in s])
        if gstar_uf != Uv:
            return False
        if Fr(uf * rstar % FR_MODULUS) != vv:
            return False
        return True


class DoryScheme:
    """CommitmentScheme-shaped adapter (commitment/scheme.py seam)."""

    def __init__(self, seed: bytes = b"jolt-atlas-tpu-dory"):
        self.seed = seed

    def setup_prover(self, max_num_vars: int) -> DorySetup:
        return DorySetup.for_num_vars(max_num_vars, seed=self.seed)

    def setup_verifier(self, setup: DorySetup) -> DorySetup:
        return setup

    def commit(self, setup: DorySetup, coeffs) -> DoryCommitment:
        return DoryPC.commit(setup, coeffs)

    def batch_commit(self, setup: DorySetup, polys) -> list[DoryCommitment]:
        return [DoryPC.commit(setup, p) for p in polys]

    def combine_commitments(self, commitments, coeffs) -> DoryCommitment:
        """GT-side RLC (fixed column width makes sizes compatible)."""
        acc = FQ12.one()
        nv = 0
        for com, coeff in zip(commitments, coeffs):
            acc = acc * _gt_pow(com.gt, coeff.v)
            nv = max(nv, com.num_vars)
        return DoryCommitment(acc, nv)

    def prove(self, setup, coeffs, point, transcript) -> DoryProof:
        return DoryPC.open(setup, coeffs, point, transcript)

    def verify(self, setup, commitment, point, claim, proof,
               transcript) -> bool:
        return DoryPC.verify(setup, commitment, point, claim, proof,
                             transcript)
