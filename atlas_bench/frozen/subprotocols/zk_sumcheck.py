"""Zero-knowledge sumcheck: Pedersen-committed round polynomials.

Plays the role of the reference's `BatchedSumcheck::prove_zk` /
`ZkSumcheckProof` (joltworks/src/subprotocols/sumcheck.rs:270-549): round
polynomials are never revealed — the prover sends Pedersen commitments to
their coefficient vectors, and proves the verifier's per-round algebraic
checks in zero knowledge.

Construction (documented deviation from the reference, which encodes the
checks as a folded R1CS + Spartan proof — BlindFold): the checks are LINEAR
in the committed data, so a single Schnorr-style sigma protocol suffices:

  witness  w = (coeffs_0, ..., coeffs_{n-1}, e_0, ..., e_{n-2})
  where e_i = g_i(r_i) (the running claim chain), committed per-round.

  relations (public constants c = input claim, e_{n-1} = final claim):
    R_i: g_i(0) + g_i(1) - e_{i-1} = 0        (e_{-1} = c)
    S_i: g_i(r_i) - e_i = 0                    (S_{n-1}: public e_{n-1})

  The verifier draws rho and checks the rho-RLC of all relations via a
  standard sigma proof of opening knowledge: prover sends masked
  commitments U_j and v = <alpha, u>; challenge chi; responses
  z_j = u_j + chi*w_j, z_bj = s_j + chi*b_j; verifier checks
  Ped(z_j; z_bj) = U_j + chi*C_j and <alpha, z> = v + chi*t.

Zero-knowledge: responses are one-time-pad masked by u. The final claim
e_{n-1} (the polynomial oracle evaluation) is public here — end-to-end ZK
additionally needs a hiding PCS for the oracle itself (BlindFold + Spartan,
planned; Pedersen layer in commitment/pedersen.py is the groundwork).
"""

from __future__ import annotations

import secrets

from ..commitment.pedersen import PedersenGenerators
from ..curve.points import G1
from ..field.constants import FR_MODULUS
from ..field.scalar import Fr
from .sumcheck import SumcheckError


def _rand_fr() -> Fr:
    return Fr(secrets.randbelow(FR_MODULUS))


class ZkSumcheckProof:
    def __init__(self, round_commitments: list[G1], e_commitments: list[G1],
                 masked_commitments: list[G1], v: Fr,
                 responses: list[list[Fr]], blind_responses: list[Fr]):
        self.round_commitments = round_commitments   # C_i = Ped(coeffs_i)
        self.e_commitments = e_commitments           # E_i = Ped([e_i])
        self.masked_commitments = masked_commitments  # U_j (sigma round 1)
        self.v = v                                   # <alpha, u>
        self.responses = responses                   # z_j vectors
        self.blind_responses = blind_responses       # z_bj scalars

    def serialize(self) -> bytes:
        from ..serde import _W
        w = _W()
        for group in (self.round_commitments, self.e_commitments,
                      self.masked_commitments):
            w.u64(len(group))
            for p in group:
                w.point(p)
        w.fr(self.v)
        w.u64(len(self.responses))
        for z in self.responses:
            w.u64(len(z))
            for x in z:
                w.fr(x)
        w.u64(len(self.blind_responses))
        for x in self.blind_responses:
            w.fr(x)
        return w.out()

    @classmethod
    def deserialize(cls, data: bytes, offset: int = 0):
        from ..serde import _R
        r = _R(data)
        r.o = offset
        groups = []
        for _ in range(3):
            groups.append([r.point() for _ in range(r.u64())])
        v = r.fr()
        responses = []
        for _ in range(r.u64()):
            responses.append([r.fr() for _ in range(r.u64())])
        blind = [r.fr() for _ in range(r.u64())]
        return cls(groups[0], groups[1], groups[2], v, responses, blind), r.o


class ZkSumcheck:
    """prove/verify a single instance with hidden round polynomials."""


    @staticmethod
    def verify(proof: ZkSumcheckProof, instance, gens: PedersenGenerators,
               accumulator, transcript):
        num_rounds = instance.num_rounds()
        degree = instance.degree()
        input_claim = instance.input_claim(accumulator)
        transcript.append_scalar(input_claim)
        if (len(proof.round_commitments) != num_rounds
                or len(proof.e_commitments) != num_rounds - 1):
            raise SumcheckError("zk sumcheck shape mismatch")
        r_sumcheck: list[Fr] = []
        for rnd in range(num_rounds):
            transcript.append_point(proof.round_commitments[rnd])
            r_sumcheck.append(transcript.challenge_scalar_optimized())
            if rnd < num_rounds - 1:
                transcript.append_point(proof.e_commitments[rnd])

        # final (public) claim: the oracle value the verifier derives from
        # the cached openings — the S_{n-1} relation then binds the hidden
        # g_{n-1}(r_{n-1}) to it (same transcript order as the prover:
        # cache_openings, then append the claim)
        final_claim = _peek_final_claim(instance, accumulator, transcript,
                                        r_sumcheck)

        rho = transcript.challenge_scalar()
        alphas, target = _aggregate_relations(
            num_rounds, degree, r_sumcheck, input_claim, final_claim, rho)

        for m in proof.masked_commitments:
            transcript.append_point(m)
        transcript.append_scalar(proof.v)
        chi = transcript.challenge_scalar()

        all_cs = proof.round_commitments + proof.e_commitments
        if len(proof.responses) != len(all_cs):
            raise SumcheckError("zk sumcheck response count mismatch")
        width = degree + 1
        for z in proof.responses[:num_rounds]:
            if len(z) != width:
                raise SumcheckError("zk sumcheck response width mismatch")
        for z in proof.responses[num_rounds:]:
            if len(z) != 1:
                raise SumcheckError("zk sumcheck response width mismatch")
        for z, zb, u_com, c_com in zip(proof.responses,
                                       proof.blind_responses,
                                       proof.masked_commitments, all_cs):
            lhs = gens.commit(z, zb)
            rhs = u_com + c_com * chi.v
            if not (lhs.infinity == rhs.infinity and lhs.x == rhs.x
                    and lhs.y == rhs.y):
                raise SumcheckError("zk sumcheck commitment check failed")
        flat_z = [x for z in proof.responses for x in z]
        acc = Fr.zero()
        for a, x in zip(alphas, flat_z):
            acc = acc + a * x
        if acc != proof.v + chi * target:
            raise SumcheckError("zk sumcheck linear relation failed")
        return r_sumcheck, final_claim


def sigma_prove(gens: PedersenGenerators, transcript, w_vecs, w_blinds,
                alphas):
    """Schnorr-style proof of knowledge of openings (w_j, b_j) of already
    transcript-absorbed Pedersen commitments C_j satisfying the public
    linear relation <alphas, flat(w)> = target. Returns the proof pieces;
    the target itself is public and implied by the relation setup."""
    u_vecs = [[_rand_fr() for _ in vec] for vec in w_vecs]
    s_blinds = [_rand_fr() for _ in w_vecs]
    masked = [gens.commit(u, s) for u, s in zip(u_vecs, s_blinds)]
    v = Fr.zero()
    flat_u = [x for u in u_vecs for x in u]
    for a, x in zip(alphas, flat_u):
        v = v + a * x
    for m in masked:
        transcript.append_point(m)
    transcript.append_scalar(v)
    chi = transcript.challenge_scalar()
    responses = [[u + chi * w for u, w in zip(uv, wv)]
                 for uv, wv in zip(u_vecs, w_vecs)]
    blind_responses = [s + chi * b for s, b in zip(s_blinds, w_blinds)]
    return masked, v, responses, blind_responses


def sigma_verify(gens: PedersenGenerators, transcript, commitments, widths,
                 alphas, target, masked, v, responses, blind_responses):
    """Verifier side of sigma_prove; raises SumcheckError on failure."""
    if len(responses) != len(commitments) or \
            len(blind_responses) != len(commitments) or \
            len(masked) != len(commitments):
        raise SumcheckError("sigma proof shape mismatch")
    for z, width in zip(responses, widths):
        if len(z) != width:
            raise SumcheckError("sigma response width mismatch")
    for m in masked:
        transcript.append_point(m)
    transcript.append_scalar(v)
    chi = transcript.challenge_scalar()
    for z, zb, u_com, c_com in zip(responses, blind_responses, masked,
                                   commitments):
        lhs = gens.commit(z, zb)
        rhs = u_com + c_com * chi.v
        if not (lhs.infinity == rhs.infinity and lhs.x == rhs.x
                and lhs.y == rhs.y):
            raise SumcheckError("sigma commitment check failed")
    acc = Fr.zero()
    flat_z = [x for z in responses for x in z]
    for a, x in zip(alphas, flat_z):
        acc = acc + a * x
    if acc != v + chi * target:
        raise SumcheckError("sigma linear relation failed")


class ZkBatchedSumcheck:
    """Front-loaded batched sumcheck with hidden round polynomials.

    Mirrors BatchedSumcheck.prove/verify (subprotocols/sumcheck.py) —
    same pow2 claim scaling and join schedule — but every batched round
    polynomial is Pedersen-committed instead of sent in the clear, and
    the round-check chain is proven by the sigma protocol above (the
    relations are those of _aggregate_relations applied to the batched
    polynomial). The per-instance input claims and cached opening claims
    stay public, exactly like the reference's zk pipeline leaves its
    final aggregate scalars public (zk.rs:96-105); what is hidden is the
    round-message algebra, which is where witness data concentrates.
    """


    @staticmethod
    def verify(proof: ZkSumcheckProof, instances, gens: PedersenGenerators,
               accumulator, transcript, hidden_final=None):
        """hidden_final (optional): (E_g commitments, mu_fn) — see
        prove(). The instances' expected_output_claim is never computed;
        the final check rides the sigma relation over E_g instead."""
        from .sumcheck import _mul_pow2
        max_rounds = max(i.num_rounds() for i in instances)
        max_degree = max(i.degree() for i in instances)
        width = max_degree + 1
        for inst in instances:
            transcript.append_scalar(inst.input_claim(accumulator))
        coeffs = transcript.challenge_vector(len(instances))
        input_claim = Fr.zero()
        for c, inst in zip(coeffs, instances):
            input_claim = input_claim + c * _mul_pow2(
                inst.input_claim(accumulator),
                max_rounds - inst.num_rounds())

        if (len(proof.round_commitments) != max_rounds
                or len(proof.e_commitments) != max(0, max_rounds - 1)):
            raise SumcheckError("zk batched sumcheck shape mismatch")
        r_sumcheck: list[Fr] = []
        for rnd in range(max_rounds):
            transcript.append_point(proof.round_commitments[rnd])
            r_sumcheck.append(transcript.challenge_scalar_optimized())
            if rnd < max_rounds - 1:
                transcript.append_point(proof.e_commitments[rnd])

        if hidden_final is not None:
            e_g, mu_fn = hidden_final
            if len(e_g) != len(instances):
                raise SumcheckError("hidden-final commitment count mismatch")
            for inst in instances:
                r_slice = r_sumcheck[max_rounds - inst.num_rounds():]
                inst.cache_openings(accumulator, transcript, r_slice)
            for c in e_g:
                transcript.append_point(c)
            rho = transcript.challenge_scalar()
            alphas, target = _aggregate_relations(
                max_rounds, max_degree, r_sumcheck, input_claim,
                Fr.zero(), rho)
            rho_last = rho
            for _ in range(2 * max_rounds - 2):
                rho_last = rho_last * rho
            for inst, c in zip(instances, coeffs):
                r_slice = r_sumcheck[max_rounds - inst.num_rounds():]
                mu = mu_fn(inst, r_slice)
                alphas.append(Fr.zero() - rho_last * c * mu)
            widths = ([width] * max_rounds + [1] * len(proof.e_commitments)
                      + [1] * len(e_g))
            sigma_verify(gens, transcript,
                         proof.round_commitments + proof.e_commitments
                         + list(e_g), widths,
                         alphas, target, proof.masked_commitments, proof.v,
                         proof.responses, proof.blind_responses)
            return r_sumcheck
        expected = Fr.zero()
        for inst, coeff in zip(instances, coeffs):
            r_slice = r_sumcheck[max_rounds - inst.num_rounds():]
            inst.cache_openings(accumulator, transcript, r_slice)
            expected = expected + coeff * inst.expected_output_claim(
                accumulator, r_slice)
        transcript.append_scalar(expected)

        rho = transcript.challenge_scalar()
        alphas, target = _aggregate_relations(
            max_rounds, max_degree, r_sumcheck, input_claim, expected, rho)
        widths = [width] * max_rounds + [1] * len(proof.e_commitments)
        sigma_verify(gens, transcript,
                     proof.round_commitments + proof.e_commitments, widths,
                     alphas, target, proof.masked_commitments, proof.v,
                     proof.responses, proof.blind_responses)
        return r_sumcheck


def _peek_final_claim(instance, accumulator, transcript, r_sumcheck) -> Fr:
    """Verifier-side final claim: the oracle evaluation the instance
    derives from its cached openings (mirrors prover order: the prover
    appends the same value before cache_openings, computed from its own
    polynomials)."""
    # run cache_openings on a throwaway transcript copy is NOT possible
    # (appends must land in the real transcript). Order on both sides:
    #   ... rounds ... -> cache_openings -> append(final) -> rho
    instance.cache_openings(accumulator, transcript, r_sumcheck)
    final = instance.expected_output_claim(accumulator, r_sumcheck)
    transcript.append_scalar(final)
    return final


def _aggregate_relations(num_rounds: int, degree: int, r_sumcheck,
                         input_claim: Fr, final_claim: Fr, rho: Fr):
    """alpha (flat over [coeffs_0..coeffs_{n-1}, e_0..e_{n-2}]) and target t
    such that the relations hold iff <alpha, w> = t (whp over rho)."""
    width = degree + 1
    n = num_rounds
    alphas = [Fr.zero()] * (n * width + max(0, n - 1))
    target = Fr.zero()
    rho_j = Fr.one()
    # R_i: g_i(0) + g_i(1) = e_{i-1}; g(0)+g(1) = 2*c0 + c1 + ... + cd
    for i in range(n):
        for k in range(width):
            w = Fr(2) if k == 0 else Fr.one()
            alphas[i * width + k] = alphas[i * width + k] + rho_j * w
        if i == 0:
            target = target + rho_j * input_claim
        else:
            ei = n * width + (i - 1)
            alphas[ei] = alphas[ei] - rho_j
        rho_j = rho_j * rho
    # S_i: g_i(r_i) = e_i  (S_{n-1} against the public final claim)
    for i in range(n):
        p = Fr.one()
        for k in range(width):
            alphas[i * width + k] = alphas[i * width + k] + rho_j * p
            p = p * r_sumcheck[i]
        if i < n - 1:
            ei = n * width + i
            alphas[ei] = alphas[ei] - rho_j
        else:
            target = target + rho_j * final_claim
        rho_j = rho_j * rho
    return alphas, target
