"""Evaluation reduction: N opening claims on one MLE -> 1 claim.

Reference: joltworks/src/subprotocols/evaluation_reduction.rs (PAZK line/
curve-restriction): for claims P(x_i) = v_i, i = 0..N-1, the prover sends the
univariate h(t) = P(l(t)) where l is the coordinate-wise degree-(N-1) curve
with l(i) = x_i. The verifier checks h(i) = v_i, draws x*, and both reduce to
the single claim P(l(x*)) = h(x*). Run per node to merge all consumer claims
on its output MLE before the node's own execution sumcheck
(jolt-atlas-core ops/eval_reduction.rs:15-66).
"""

from __future__ import annotations

from ..field.scalar import Fr, batch_inverse
from ..poly.mlpoly import MLPoly
from ..poly.unipoly import UniPoly, _interpolate_at_0_to_d


class EvalReductionProof:
    def __init__(self, h: UniPoly):
        self.h = h


def _curve_points(points: list[list[Fr]], t: Fr) -> list[Fr]:
    """Evaluate the coordinate-wise Lagrange curve l(t), l(i) = points[i]."""
    n = len(points)
    if n == 1:
        return list(points[0])
    # Lagrange basis at t over nodes 0..n-1
    nodes = [Fr(i) for i in range(n)]
    basis = []
    for i in range(n):
        num = Fr.one()
        den = Fr.one()
        for j in range(n):
            if j != i:
                num = num * (t - nodes[j])
                den = den * (nodes[i] - nodes[j])
        basis.append(num * den.inverse())
    dim = len(points[0])
    out = []
    for c in range(dim):
        acc = Fr.zero()
        for i in range(n):
            acc = acc + basis[i] * points[i][c]
        out.append(acc)
    return out


def prove_eval_reduction(poly: MLPoly, points: list[list[Fr]],
                         claims: list[Fr], transcript):
    """Returns (proof, new_point, new_claim). Requires >= 2 claims."""
    n = len(points)
    assert n >= 2
    nv = poly.num_vars
    deg_h = nv * (n - 1)
    # evaluate h at 0..deg_h and interpolate
    evals = []
    for e in range(deg_h + 1):
        pt = _curve_points(points, Fr(e))
        evals.append(poly.clone().evaluate(pt))
    h = UniPoly(_interpolate_at_0_to_d(evals))
    # absorb h, draw x*
    transcript.append_scalars(h.coeffs)
    x_star = transcript.challenge_scalar_optimized()
    new_point = _curve_points(points, x_star)
    new_claim = h.evaluate(x_star)
    return EvalReductionProof(h), new_point, new_claim


def verify_eval_reduction(proof: EvalReductionProof, points: list[list[Fr]],
                          claims: list[Fr], num_vars: int, transcript):
    """Returns (new_point, new_claim) or raises."""
    n = len(points)
    assert n >= 2
    if proof.h.degree() > num_vars * (n - 1):
        raise ValueError("eval reduction: h degree too large")
    for i, v in enumerate(claims):
        if proof.h.evaluate(Fr(i)) != v:
            raise ValueError(f"eval reduction: h({i}) != claim")
    transcript.append_scalars(proof.h.coeffs)
    x_star = transcript.challenge_scalar_optimized()
    return _curve_points(points, x_star), proof.h.evaluate(x_star)


# ---------------------------------------------------------------------------
# zero-knowledge variant: h committed, checks proven by a sigma protocol
# ---------------------------------------------------------------------------

class ZkEvalReductionProof:
    """Pedersen commitment to h's coefficients plus the sigma proof of the
    rho-RLC of the linear checks {h(i) = v_i} ∪ {h(x*) = new_claim}.
    Mirrors the reference zk pipeline's Pedersen-committed eval-reduction h
    polynomials (zk.rs eval_reduction_h_commitments)."""

    def __init__(self, commitment, new_claim: Fr, masked, v: Fr,
                 response: list[Fr], blind_response: Fr):
        self.commitment = commitment
        self.new_claim = new_claim
        self.masked = masked
        self.v = v
        self.response = response
        self.blind_response = blind_response

    def serialize(self) -> bytes:
        from ..serde import _W
        w = _W()
        w.point(self.commitment)
        w.fr(self.new_claim)
        w.point(self.masked)
        w.fr(self.v)
        w.u64(len(self.response))
        for x in self.response:
            w.fr(x)
        w.fr(self.blind_response)
        return w.out()

    @classmethod
    def deserialize(cls, data: bytes, offset: int = 0):
        from ..serde import _R
        r = _R(data)
        r.o = offset
        com = r.point()
        new_claim = r.fr()
        masked = r.point()
        v = r.fr()
        resp = [r.fr() for _ in range(r.u64())]
        blind = r.fr()
        return cls(com, new_claim, masked, v, resp, blind), r.o


def _eval_reduction_relation(width: int, claims: list[Fr], x_star: Fr,
                             new_claim: Fr, rho: Fr):
    """rho-RLC of the checks h(i)=v_i (i < n) and h(x*)=new_claim into a
    single public linear relation <alphas, coeffs> = target."""
    alphas = [Fr.zero()] * width
    target = Fr.zero()
    rho_j = Fr.one()
    for i, vi in enumerate(claims):
        p = Fr.one()
        xi = Fr(i)
        for k in range(width):
            alphas[k] = alphas[k] + rho_j * p
            p = p * xi
        target = target + rho_j * vi
        rho_j = rho_j * rho
    p = Fr.one()
    for k in range(width):
        alphas[k] = alphas[k] + rho_j * p
        p = p * x_star
    target = target + rho_j * new_claim
    return alphas, target


def prove_eval_reduction_zk(poly: MLPoly, points: list[list[Fr]],
                            claims: list[Fr], transcript, gens):
    """ZK variant of prove_eval_reduction: h is Pedersen-committed; the
    verifier's checks are proven via one sigma proof. Only the reduced
    claim h(x*) is revealed (it feeds the downstream public claim chain)."""
    from .zk_sumcheck import _rand_fr, sigma_prove
    n = len(points)
    assert n >= 2
    nv = poly.num_vars
    deg_h = nv * (n - 1)
    evals = []
    for e in range(deg_h + 1):
        pt = _curve_points(points, Fr(e))
        evals.append(poly.clone().evaluate(pt))
    h = UniPoly(_interpolate_at_0_to_d(evals))
    coeffs = list(h.coeffs) + [Fr.zero()] * (deg_h + 1 - len(h.coeffs))
    b = _rand_fr()
    com = gens.commit(coeffs, b)
    transcript.append_point(com)
    x_star = transcript.challenge_scalar_optimized()
    new_point = _curve_points(points, x_star)
    new_claim = h.evaluate(x_star)
    transcript.append_scalar(new_claim)
    rho = transcript.challenge_scalar()
    alphas, _t = _eval_reduction_relation(len(coeffs), claims, x_star,
                                          new_claim, rho)
    masked, v, responses, blind_responses = sigma_prove(
        gens, transcript, [coeffs], [b], alphas)
    proof = ZkEvalReductionProof(com, new_claim, masked[0], v, responses[0],
                                 blind_responses[0])
    return proof, new_point, new_claim


def verify_eval_reduction_zk(proof: ZkEvalReductionProof,
                             points: list[list[Fr]], claims: list[Fr],
                             num_vars: int, transcript, gens):
    from .zk_sumcheck import sigma_verify
    n = len(points)
    assert n >= 2
    width = len(proof.response)
    if width > num_vars * (n - 1) + 1:
        raise ValueError("zk eval reduction: h degree too large")
    transcript.append_point(proof.commitment)
    x_star = transcript.challenge_scalar_optimized()
    transcript.append_scalar(proof.new_claim)
    rho = transcript.challenge_scalar()
    alphas, target = _eval_reduction_relation(width, claims, x_star,
                                              proof.new_claim, rho)
    sigma_verify(gens, transcript, [proof.commitment], [width], alphas,
                 target, [proof.masked], proof.v, [proof.response],
                 [proof.blind_response])
    return _curve_points(points, x_star), proof.new_claim
