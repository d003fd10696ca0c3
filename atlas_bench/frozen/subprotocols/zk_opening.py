"""Zero-knowledge joint opening: hidden reduced claims + masked HyperKZG.

Closes the zk pipeline's final gap (the reference hides round polynomials
AND claims via BlindFold: Pedersen + Nova folding + Spartan,
joltworks/src/subprotocols/blindfold/mod.rs:1-7,
jolt-atlas-core/src/onnx_proof/zk.rs:2081): with this module the group
reduced claims, the joint evaluation, and every value that would determine
them are never serialized in the clear. The construction keeps the
sigma-protocol design of zk_sumcheck.py (documented deviation) instead of
folding an R1CS:

  1. The group claims g_i are Pedersen-committed (E_g); the batched
     reduction sumcheck's final-claim check becomes a sigma relation over
     the committed g_i (ZkBatchedSumcheck hidden-final mode).
  2. The joint polynomial J is never opened directly. The prover samples a
     uniformly random mask polynomial M, commits C_M, receives rho, and
     runs the standard PUBLIC HyperKZG opening on K = J + rho*M against
     the homomorphic commitment C_K = C_J + rho*C_M. Everything public in
     that opening (fold evals, y_K = K(r)) is uniformly masked by M.
  3. The linkage y_joint = y_K - rho*M(r): m = M(r) is bound to C_M by a
     committed-evaluation HyperKZG opening of M — fold commitments and the
     Shplonk witness W_M are public (group elements of a random poly), the
     v-matrix and m stay Pedersen-committed, and the verifier's fold-chain
     relations plus the claim linkage sum(nu_i g_i) + rho*m = y_K are
     proven by one combined sigma protocol. The BDFG20 pairing check binds
     through a prover-supplied D = [r_interp(tau)]_1 whose exponents are
     proven consistent with the committed v-matrix by a generalized
     Schnorr over the SRS bases (group relation, same challenge).

  ZK caveat (documented): D and W_M expose group elements whose exponents
  derive from the random mask M — hiding is computational (DLOG), unlike
  the information-theoretic hiding of the Pedersen commitments; and the
  per-node cached opening claims stay public exactly as in the reference's
  zk pipeline (zk.rs:96-105).
"""

from __future__ import annotations

from ..curve.msm import msm
from ..curve.points import G1
from ..field.scalar import Fr
from .sumcheck import SumcheckError
from .zk_sumcheck import _rand_fr


class ZkJointOpeningProof:
    """Serialized pieces of the hidden joint opening (serde tag 3)."""

    def __init__(self, e_g, c_mask, hk_k, y_k, c_folds, e_v, e_m, w_m, d,
                 a_ped, v_scalar, a_d, z, zb):
        self.e_g = e_g          # group-claim Pedersen commitments
        self.c_mask = c_mask    # C_M
        self.hk_k = hk_k        # public HyperKZG proof for K = J + rho*M
        self.y_k = y_k          # public (uniform) masked evaluation
        self.c_folds = c_folds  # M's fold commitments (ell-1)
        self.e_v = e_v          # 3 Pedersen vector commits (v-matrix rows)
        self.e_m = e_m          # Pedersen commit of m = M(r)
        self.w_m = w_m          # M's Shplonk witness
        self.d = d              # [r_interp(tau)]_1 for M's batch check
        self.a_ped = a_ped      # sigma masks (per witness commitment)
        self.v_scalar = v_scalar
        self.a_d = a_d          # sigma mask for the group relation
        self.z = z              # responses
        self.zb = zb            # blind responses

    def serialize(self) -> bytes:
        from ..serde import _W
        w = _W()
        for group in (self.e_g, [self.c_mask], self.c_folds, self.e_v,
                      [self.e_m, self.w_m, self.d, self.a_d], self.a_ped):
            w.u64(len(group))
            for p in group:
                w.point(p)
        w.raw(self.hk_k.serialize())
        w.fr(self.y_k)
        w.fr(self.v_scalar)
        w.u64(len(self.z))
        for zv in self.z:
            w.u64(len(zv))
            for x in zv:
                w.fr(x)
        w.u64(len(self.zb))
        for x in self.zb:
            w.fr(x)
        return w.out()

    @classmethod
    def deserialize(cls, data: bytes, offset: int = 0):
        from ..commitment.hyperkzg import HyperKZGProof
        from ..serde import _R
        r = _R(data)
        r.o = offset
        # groups: e_g, [c_mask], c_folds, e_v, [e_m, w_m, d, a_d], a_ped
        groups = []
        for _ in range(6):
            groups.append([r.point() for _ in range(r.u64())])
        e_g, cml, c_folds, e_v, quad, a_ped = groups
        hk, r.o = HyperKZGProof.deserialize(r.d, r.o)
        y_k = r.fr()
        v_scalar = r.fr()
        z = []
        for _ in range(r.u64()):
            z.append([r.fr() for _ in range(r.u64())])
        zb = [r.fr() for _ in range(r.u64())]
        if len(cml) != 1 or len(quad) != 4 or len(e_v) != 3:
            raise ValueError("ZkJointOpeningProof: malformed group sizes")
        return cls(e_g, cml[0], hk, y_k, c_folds, e_v, e_m=quad[0],
                   w_m=quad[1], d=quad[2], a_ped=a_ped, v_scalar=v_scalar,
                   a_d=quad[3], z=z, zb=zb), r.o


def _lagrange_coeffs(u):
    """Coefficient rows lam[k][i]: r_interp(X) = sum_k (sum_i lam[k][i]
    B(u_i)) X^k for the 3-point interpolation on u."""
    lam = [[Fr.zero()] * 3 for _ in range(3)]
    for i in range(3):
        ua, ub = u[(i + 1) % 3], u[(i + 2) % 3]
        denom = (u[i] - ua) * (u[i] - ub)
        s = denom.inverse()
        lam[0][i] = s * (ua * ub)
        lam[1][i] = Fr.zero() - s * (ua + ub)
        lam[2][i] = s
    return lam


class ZkJointOpening:

    @staticmethod
    def verify(srs, gens, joint_c, point, nus, proof: ZkJointOpeningProof,
               transcript) -> bool:
        from ..commitment.hyperkzg import HyperKZG
        ell = len(point)
        transcript.append_point(proof.c_mask)
        rho = transcript.challenge_scalar()
        transcript.append_scalar(proof.y_k)
        c_k = joint_c + proof.c_mask * rho.v
        if not HyperKZG.verify(srs, c_k, list(point), proof.y_k,
                               proof.hk_k, transcript):
            return False

        if len(proof.c_folds) != ell - 1 or len(proof.e_v) != 3:
            return False
        transcript.append_points(proof.c_folds)
        r_h = transcript.challenge_scalar()
        if r_h.is_zero():
            return False
        u = [r_h, Fr.zero() - r_h, r_h * r_h]
        transcript.append_points(proof.e_v + [proof.e_m])
        q_powers = transcript.challenge_scalar_powers(ell)
        transcript.append_points([proof.w_m, proof.d])

        # pairing: e(C_B_M - D, g2) == e(W_M, [Z_S(tau)]_2)
        folds_c = [proof.c_mask] + list(proof.c_folds)
        c_b = msm(folds_c, [q.v for q in q_powers])
        lhs = c_b + (-proof.d)
        e2 = u[0] + u[1] + u[2]
        e1 = u[0] * u[1] + u[0] * u[2] + u[1] * u[2]
        e0 = u[0] * u[1] * u[2]
        if srs.g2_powers is None:
            return False
        from ..curve.native import g2_scalar_mul_native

        def g2mul(p, s: Fr):
            r = g2_scalar_mul_native(p, s.v)
            return r if r is not None else p * s.v

        z_t2 = (srs.g2_powers[1] - g2mul(srs.g2_powers[0], e2)
                + g2mul(srs.beta_g2, e1) - g2mul(srs.g2, e0))
        from ..curve.pairing import pairing_check
        if not pairing_check([(lhs, srs.g2), (-proof.w_m, z_t2)]):
            return False

        # combined sigma over committed (v rows, m, g)
        alphas, target, lmat = _relations(
            ell, point, rho, proof.y_k, nus, u, q_powers, transcript)
        commits = list(proof.e_v) + [proof.e_m] + list(proof.e_g)
        widths = [ell, ell, ell, 1] + [1] * len(proof.e_g)
        if (len(proof.z) != len(commits) or len(proof.zb) != len(commits)
                or len(proof.a_ped) != len(commits)):
            return False
        for zv, wdt in zip(proof.z, widths):
            if len(zv) != wdt:
                return False
        for p in proof.a_ped:
            transcript.append_point(p)
        transcript.append_scalar(proof.v_scalar)
        transcript.append_point(proof.a_d)
        chi = transcript.challenge_scalar()
        for zv, zbv, a_c, c_c in zip(proof.z, proof.zb, proof.a_ped,
                                     commits):
            lhs_p = gens.commit(zv, zbv)
            rhs_p = a_c + c_c * chi.v
            if not (lhs_p.infinity == rhs_p.infinity
                    and (lhs_p.infinity or (lhs_p.x == rhs_p.x
                                            and lhs_p.y == rhs_p.y))):
                return False
        flat_z = [x for zv in proof.z for x in zv]
        acc = Fr.zero()
        for a, x in zip(alphas, flat_z):
            acc = acc + a * x
        if acc != proof.v_scalar + chi * target:
            return False
        lz = [sum((row[j] * flat_z[j] for j in range(len(row))), Fr.zero())
              for row in lmat]
        h_bases = [srs.g1_powers[0], srs.g1_powers[1], srs.g1_powers[2]]
        lhs_g = msm(h_bases, [c.v for c in lz])
        rhs_g = proof.a_d + proof.d * chi.v
        if not (lhs_g.infinity == rhs_g.infinity
                and (lhs_g.infinity or (lhs_g.x == rhs_g.x
                                        and lhs_g.y == rhs_g.y))):
            return False
        return True


def _relations(ell, point, rho, y_k, nus, u, q_powers, transcript):
    """(alphas, target, lmat) over the flat witness
    (v0 (ell), v1 (ell), v2 (ell), m, g_0..g_{ng-1}):

      - fold chain (ell relations): 2 r_h Y[i+1] = r_h (1 - x_i)
        (v0_i + v1_i) + x_i (v0_i - v1_i), Y = v2 ++ [m],
        x_i = point[ell-1-i]  (mirrors HyperKZG.verify's consistency loop)
      - linkage: sum_i nu_i g_i + rho m = y_k
      - group relation (lmat, 3 x W): D = sum_k (lmat_k . w) [tau^k]_1
        with exponents c_k = sum_i lam[k][i] sum_j q^j v[i][j]

    Scalar relations are RLC-aggregated by a fresh transcript challenge;
    the group relation shares the sigma challenge but not the RLC."""
    lam = _lagrange_coeffs(u)
    r_h = u[0]
    ng = len(nus)
    W = 3 * ell + 1 + ng
    m_at = 3 * ell
    g_at = 3 * ell + 1
    r_agg = transcript.challenge_scalar()
    alphas = [Fr.zero()] * W
    target = Fr.zero()
    rj = Fr.one()
    one = Fr.one()
    two = Fr(2)
    for i in range(ell):
        x = point[ell - 1 - i]
        y_idx = (2 * ell + i + 1) if i + 1 < ell else m_at
        alphas[y_idx] = alphas[y_idx] + rj * (two * r_h)
        a0 = r_h * (one - x) + x     # coefficient of v0_i (ypos)
        a1 = r_h * (one - x) - x     # coefficient of v1_i (yneg)
        alphas[i] = alphas[i] - rj * a0
        alphas[ell + i] = alphas[ell + i] - rj * a1
        rj = rj * r_agg
    # linkage: sum nu_i g_i + rho m = y_k
    alphas[m_at] = alphas[m_at] + rj * rho
    for i, nu in enumerate(nus):
        alphas[g_at + i] = alphas[g_at + i] + rj * nu
    target = target + rj * y_k
    # group relation rows
    lmat = []
    for k in range(3):
        row = [Fr.zero()] * W
        for i in range(3):
            li = lam[k][i]
            for j in range(ell):
                row[i * ell + j] = li * q_powers[j]
        lmat.append(row)
    return alphas, target, lmat
