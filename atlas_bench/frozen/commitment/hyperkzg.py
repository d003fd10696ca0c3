"""HyperKZG: multilinear PCS via the Gemini univariate transform + KZG.

Protocol mirror of reference joltworks/src/poly/commitment/hyperkzg/mod.rs
(itself a port of Nova's hyperkzg), with a Shplonk/BDFG20 single-witness
batch opening replacing the reference's three per-point KZG witnesses:

open(poly, point):                                     (mod.rs:400-448)
  1. Fold chain: P_0 = poly; P_{i+1}[j] =
     point[ell-1-i] * (P_i[2j+1] - P_i[2j]) + P_i[2j]   (ell-1 polys)
  2. Commit P_1..P_{ell-1}; absorb commitments; r = challenge_scalar.
  3. u = [r, -r, r^2]; evaluate every P_i as a univariate at each u_j
     (v matrix, absorbed); q = challenge powers; B = sum q^i P_i;
     ONE Shplonk witness W = [(B - r_interp)/Z_S] with
     Z_S = (X-u_0)(X-u_1)(X-u_2) via three synthetic divisions; absorb W.

verify(C, point, y, proof):                            (mod.rs:451-514)
  - re-derive r/q challenges, check the fold consistency relation
      2 r Y[i+1] = r (1 - x_{ell-1-i}) (ypos_i + yneg_i)
                   + x_{ell-1-i} (ypos_i - yneg_i)
    with Y = v[2] ++ [y], then the BDFG20 batch pairing check
      e(C_B - [r_interp(tau)]_1, g2) == e(W, [Z_S(tau)]_2)
    with r_interp the degree-2 interpolation of B on {u_0, u_1, u_2}
    (_kzg_verify_batch; [Z_S(tau)]_2 from the extended G2 powers).
"""

from __future__ import annotations

from ..field.constants import FR_MODULUS
from ..field.scalar import Fr
from ..curve.msm import msm
from ..curve.points import G1
from .kzg import KZGSRS, eval_as_univariate, kzg_commit


class HyperKZGProof:
    def __init__(self, com: list[G1], w: list[G1], v: list[list[Fr]]):
        self.com = com  # ell - 1 fold commitments
        self.w = w      # 3 KZG witnesses
        self.v = v      # 3 x ell evaluation matrix

    def serialize(self) -> bytes:
        out = len(self.com).to_bytes(8, "little")
        for p in self.com:
            out += p.serialize()
        for p in self.w:
            out += p.serialize()
        out += len(self.v[0]).to_bytes(8, "little") if self.v else (0).to_bytes(8, "little")
        for row in self.v:
            for x in row:
                out += x.to_bytes_le()
        return out

    # wire format (round 4+): ncom u64 | ncom G1 | 1 Shplonk witness G1 |
    # ell u64 | 3*ell Fr. Pre-round-4 blobs carried 3 witnesses; their
    # extra witness bytes would misparse as a huge ell, so deserialize
    # bounds ell instead of failing deep in Fr parsing.
    MAX_ELL = 64  # 2^64-coefficient polynomials are far beyond any model

    @classmethod
    def deserialize(cls, data: bytes, offset: int = 0):
        ncom = int.from_bytes(data[offset:offset + 8], "little")
        offset += 8
        if ncom > cls.MAX_ELL:
            raise ValueError(f"HyperKZGProof: implausible fold count {ncom} "
                             "(pre-Shplonk proof blob?)")
        com = []
        for _ in range(ncom):
            com.append(G1.deserialize(data[offset:offset + 64]))
            offset += 64
        w = []
        for _ in range(1):
            w.append(G1.deserialize(data[offset:offset + 64]))
            offset += 64
        ell = int.from_bytes(data[offset:offset + 8], "little")
        offset += 8
        if ell > cls.MAX_ELL:
            raise ValueError(f"HyperKZGProof: implausible ell {ell} "
                             "(pre-Shplonk proof blob?)")
        v = []
        for _ in range(3):
            row = []
            for _ in range(ell):
                row.append(Fr.from_bytes_le(data[offset:offset + 32]))
                offset += 32
            v.append(row)
        return cls(com, w, v), offset


class HyperKZG:
    @staticmethod
    def commit(srs: KZGSRS, coeffs) -> G1:
        return kzg_commit(srs, coeffs)


    @staticmethod
    def verify(srs: KZGSRS, commitment: G1, point: list[Fr], claimed_eval: Fr,
               proof: HyperKZGProof, transcript) -> bool:
        ell = len(point)
        com = list(proof.com)
        transcript.append_points(com)
        r = transcript.challenge_scalar()
        if r.is_zero() or commitment.is_zero():
            return False
        com.insert(0, commitment)
        u = [r, Fr.zero() - r, r * r]

        v = proof.v
        if len(v) != 3 or any(len(row) != ell for row in v):
            return False
        ypos, yneg = v[0], v[1]
        Y = list(v[2]) + [claimed_eval]

        two = Fr(2)
        one = Fr.one()
        for i in range(ell):
            x = point[ell - i - 1]
            lhs = two * r * Y[i + 1]
            rhs = r * (one - x) * (ypos[i] + yneg[i]) + x * (ypos[i] - yneg[i])
            if lhs != rhs:
                return False

        return HyperKZG._kzg_verify_batch(srs, com, proof.w, u, v, transcript)

    @staticmethod
    def _kzg_verify_batch(srs: KZGSRS, C: list[G1], W: list[G1], u: list[Fr],
                          v: list[list[Fr]], transcript) -> bool:
        """BDFG20 batch check of the single Shplonk witness: with
        r(X) interpolating (u_i, B(u_i)) and Z_S the vanishing cubic,
        e(C_B - [r(tau)]_1, g2) == e(W, [Z_S(tau)]_2)."""
        k = len(C)
        flat = [x for row in v for x in row]
        transcript.append_scalars(flat)
        q_powers = transcript.challenge_scalar_powers(k)
        transcript.append_points(W)

        if len(W) != 1 or len(u) != 3 or srs.g2_powers is None:
            return False
        if u[0] == u[1] or u[0] == u[2] or u[1] == u[2]:
            return False

        # B(u_i) = sum_j q^j v[i][j]
        B_u = []
        for row in v:
            acc = Fr.zero()
            for a, b in zip(row, q_powers):
                acc = acc + a * b
            B_u.append(acc)

        # r(X) = sum_i B(u_i) prod_{j!=i} (X - u_j)/(u_i - u_j), ascending
        c_interp = [Fr.zero(), Fr.zero(), Fr.zero()]
        for i in range(3):
            ua, ub = u[(i + 1) % 3], u[(i + 2) % 3]
            denom = (u[i] - ua) * (u[i] - ub)  # nonzero: u checked distinct
            s = B_u[i] * denom.inverse()
            # (X - ua)(X - ub) = X^2 - (ua+ub) X + ua ub
            c_interp[0] = c_interp[0] + s * (ua * ub)
            c_interp[1] = c_interp[1] - s * (ua + ub)
            c_interp[2] = c_interp[2] + s

        # C_B - [r(tau)]_1 in one MSM
        bases = C + [srs.g1_powers[0], srs.g1_powers[1], srs.g1_powers[2]]
        scalars = [q.v for q in q_powers] + [
            (Fr.zero() - c_interp[0]).v,
            (Fr.zero() - c_interp[1]).v,
            (Fr.zero() - c_interp[2]).v,
        ]
        L = msm(bases, scalars)

        # [Z_S(tau)]_2 = tau^3 g2 - e2 tau^2 g2 + e1 tau g2 - e0 g2
        e2 = u[0] + u[1] + u[2]
        e1 = u[0] * u[1] + u[0] * u[2] + u[1] * u[2]
        e0 = u[0] * u[1] * u[2]
        from ..curve.native import g2_scalar_mul_native

        def g2mul(p, s: Fr):
            r = g2_scalar_mul_native(p, s.v)
            return r if r is not None else p * s.v

        z_t2 = (srs.g2_powers[1] - g2mul(srs.g2_powers[0], e2)
                + g2mul(srs.beta_g2, e1) - g2mul(srs.g2, e0))

        from ..curve.pairing import pairing_check
        return pairing_check([(L, srs.g2), (-W[0], z_t2)])
