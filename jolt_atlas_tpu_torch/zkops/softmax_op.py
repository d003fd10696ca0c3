"""SoftmaxLastAxis: the 4-stage softmax protocol in its own module.

Mirrors the reference's per-op module layout (ops/softmax_last_axis/,
3,131 LoC across mod.rs + stage files): recip-mult + exp-sum +
decomposed-exp lookups + sat-diff complementary slackness, with per-slice
aux advice (max_k, argmax_k, exp_sum_q, inv_sum) bound into the
transcript. Shared machinery (registry, chunk framework, opening ids)
comes from zkops.ops, which imports this module last to register the
handlers — zkops/ops.py had grown past 3k lines with every op inline
(round-4 advisory)."""

from __future__ import annotations

import numpy as np

from ..field.scalar import Fr
from ..frontend import ops as FOPS
from ..ids import CommittedPoly, OpeningId, SumcheckId, VirtualPoly
from ..poly.mlpoly import MLPoly
from ..subprotocols import onehot
from ..subprotocols.sumcheck import (RowsInstance, SumcheckInstanceProver,
                                     SumcheckInstanceVerifier)
from . import framework
from .ops import *  # noqa: F401,F403 — shared helpers (registered last)
from .ops import _derived_specs, _ra_claim_id, _register

# SoftmaxLastAxis — the 4-stage softmax protocol (reference
# ops/softmax_last_axis/, 3,131 LoC): recip-mult + exp-sum + decomposed-exp
# lookups + sat-diff complementary slackness, with per-slice aux advice
# (max_k, argmax_k, exp_sum_q, inv_sum) bound into the transcript.
# ---------------------------------------------------------------------------

def _softmax_layout(scale_pow: int):
    from ..frontend.softmax import generate_exp_lut_decomposed
    S = 1 << scale_pow
    lut = generate_exp_lut_decomposed(S)
    # pad the sub-table address spaces to full 16-ary chunks so the one-hot
    # chunk decomposition, address checks, and ra-virtualization all share
    # 4-bit slices
    chi = max(1, ((len(lut.lut_hi) - 1).bit_length() + 3) // 4)
    clo = max(1, ((lut.base - 1).bit_length() + 3) // 4)
    khi, klo = 16 ** chi, 16 ** clo
    cR = max(1, scale_pow // 4)
    return {
        "lut": lut, "S": S, "khi": khi, "klo": klo,
        # sat_diff = z - clamp(z) with z = max - x spanning the full i32
        # input range, so it needs 8 nibbles (z < 2^32); 4 overflowed for
        # attention scores beyond +/-2^16 (deep/wide transformer blocks)
        "chi": chi, "clo": clo, "cR": cR, "csd": 8,
        "zbound": len(lut.lut_hi) * lut.base,
        "tab_hi": np.concatenate([lut.lut_hi,
                                  np.zeros(khi - len(lut.lut_hi), np.int32)]),
        "tab_lo": np.concatenate([lut.lut_lo,
                                  np.zeros(klo - len(lut.lut_lo), np.int32)]),
    }


def _softmax_expq_id(node_idx, tag):
    return OpeningId.committed(
        CommittedPoly.make("SoftmaxExpQDense", node_idx),
        SumcheckId.make("NodeExecution", node_idx, tag))


def _softmax_terms(g: list[Fr], L: dict, scale_pow: int):
    """Terms + chunk specs for the softmax cycle execution sumcheck."""
    S = L["S"]
    B = L["lut"].base
    inv_s = Fr(S).inverse()
    zh_spec, zl_spec, sd_spec, r_spec, re_spec = {}, {}, {}, {}, {}
    for d in range(L["chi"]):
        zh_spec[f"zh{d}"] = (d, "identity")
    for d in range(L["clo"]):
        zl_spec[f"zl{d}"] = (d, "identity")
    for d in range(L["csd"]):
        sd_spec[f"sd{d}"] = (d, "identity")
    for d in range(L["cR"]):
        r_spec[f"R{d}"] = (d, "identity")
    for d in range(L["cR"]):
        re_spec[f"re{d}"] = (d, "identity")
    # z_lo < base is REQUIRED for decomposition uniqueness (the lo table's
    # zero padding is not the exp formula continuation); z_hi may roam over
    # the padded space since tab_hi's zero padding IS the decayed formula.
    base = L["lut"].base
    if base < L["klo"]:
        zl_spec["zlltc"] = (L["clo"] - 1, ("ltc", base // (16 ** (L["clo"] - 1))))

    def recon(prefix, C):
        return [(Fr(1 << (4 * d)), [f"{prefix}{d}"]) for d in range(C)]

    terms = []
    # out = (expq * invb - R_recon) / S
    terms.append((inv_s, ["expq", "invb"]))
    for c, f in recon("R", L["cR"]):
        terms.append((Fr.zero() - inv_s * c, f))
    # g0: maxb - x - B*zhi - zlo - satdiff = 0
    terms.append((g[0], ["maxb"]))
    terms.append((Fr.zero() - g[0], ["x"]))
    for c, f in recon("zh", L["chi"]):
        terms.append((Fr.zero() - g[0] * Fr(B) * c, f))
    for c, f in recon("zl", L["clo"]):
        terms.append((Fr.zero() - g[0] * c, f))
    for c, f in recon("sd", L["csd"]):
        terms.append((Fr.zero() - g[0] * c, f))
    # g1: ehi*elo - S*expq - rexp_recon = 0
    terms.append((g[1], ["ehi", "elo"]))
    terms.append((Fr.zero() - g[1] * Fr(S), ["expq"]))
    for c, f in recon("re", L["cR"]):
        terms.append((Fr.zero() - g[1] * c, f))
    # g2: satdiff * (zbound-1 - B*zhi - zlo) = 0
    for d1 in range(L["csd"]):
        c1 = 1 << (4 * d1)
        terms.append((g[2] * Fr(c1 * (L["zbound"] - 1)), [f"sd{d1}"]))
        for d2 in range(L["chi"]):
            terms.append((Fr.zero() - g[2] * Fr(c1 * B * (1 << (4 * d2))),
                          [f"sd{d1}", f"zh{d2}"]))
        for d2 in range(L["clo"]):
            terms.append((Fr.zero() - g[2] * Fr(c1 * (1 << (4 * d2))),
                          [f"sd{d1}", f"zl{d2}"]))
    # g3/g4: top-chunk ltc indicators sum to 1
    if "zhltc" in zh_spec:
        terms.append((g[3], ["zhltc"]))
    if "zlltc" in zl_spec:
        terms.append((g[4], ["zlltc"]))
    has = ("zhltc" in zh_spec, "zlltc" in zl_spec)
    return terms, (zh_spec, zl_spec, sd_spec, r_spec, re_spec), has


class ExpSumProver(RowsInstance, SumcheckInstanceProver):
    """exp_sum_pub(r_k) = sum_n expq(r_k, n); final expq committed opening."""

    def __init__(self, node_idx, expq_bound: MLPoly, claim, r_k):
        self.node_idx = node_idx
        self.claim = claim
        self.r_k = r_k
        self._rounds = expq_bound.num_vars
        self.setup_rows([expq_bound], [(Fr.one(), [0])], 1)

    def num_rounds(self):
        return self._rounds

    def degree(self):
        return 1

    def input_claim(self, accumulator):
        return self.claim

    def compute_message(self, round, previous_claim):
        return self.rows_message(previous_claim)

    def ingest_challenge(self, r, round):
        self.rows_bind(r)

    def cache_openings(self, accumulator, transcript, r):
        accumulator.append_committed(
            transcript, _softmax_expq_id(self.node_idx, "sum"),
            list(self.r_k) + list(r), self.row_final(0))


class ExpSumVerifier(SumcheckInstanceVerifier):
    def __init__(self, node_idx, rounds, claim, r_k):
        self.node_idx = node_idx
        self._rounds = rounds
        self.claim = claim
        self.r_k = r_k

    def num_rounds(self):
        return self._rounds

    def degree(self):
        return 1

    def input_claim(self, accumulator):
        return self.claim

    def cache_openings(self, accumulator, transcript, r):
        accumulator.append_committed(
            transcript, _softmax_expq_id(self.node_idx, "sum"),
            list(self.r_k) + list(r))

    def expected_output_claim(self, accumulator, r):
        return accumulator.claim_of(_softmax_expq_id(self.node_idx, "sum"))


class MaxCheckProver(RowsInstance, SumcheckInstanceProver):
    """max_pub(r_k) = sum_j eq(r_k, k(j)) * argind(j) * x(j)."""

    def __init__(self, node_idx, P: MLPoly, x: MLPoly, claim, slot, producer):
        self.node_idx = node_idx
        self.claim = claim
        self.slot = slot
        self.producer = producer
        self._rounds = x.num_vars
        self.setup_rows([P, x], [(Fr.one(), [0, 1])], 2)

    def num_rounds(self):
        return self._rounds

    def degree(self):
        return 2

    def input_claim(self, accumulator):
        return self.claim

    def compute_message(self, round, previous_claim):
        return self.rows_message(previous_claim)

    def ingest_challenge(self, r, round):
        self.rows_bind(r)

    def cache_openings(self, accumulator, transcript, r):
        accumulator.append_virtual(
            transcript, input_opening_id(self.node_idx, self.slot, self.producer),
            list(r), self.row_final(1))


class MaxCheckVerifier(SumcheckInstanceVerifier):
    def __init__(self, node_idx, rounds, claim, slot, producer, P_pub: np.ndarray):
        self.node_idx = node_idx
        self._rounds = rounds
        self.claim = claim
        self.slot = slot
        self.producer = producer
        self.P_pub = P_pub  # object array of P values (public)

    def num_rounds(self):
        return self._rounds

    def degree(self):
        return 2

    def input_claim(self, accumulator):
        return self.claim

    def cache_openings(self, accumulator, transcript, r):
        accumulator.append_virtual(
            transcript, input_opening_id(self.node_idx, self.slot, self.producer),
            list(r))

    def expected_output_claim(self, accumulator, r):
        x_claim = accumulator.get_opening(
            input_opening_id(self.node_idx, self.slot, self.producer))[1]
        p_eval = MLPoly(fvec=self.P_pub.copy()).evaluate(list(r))
        return p_eval * x_claim


def _expsum_bound(exp_q, F_n: int, N: int, r_k):
    """bound[n] = sum_k exp_q[k, n] * eq(r_k, k), natively when possible
    (the object-int einsum was ~0.1 s/prove at bench scale)."""
    from ..field import frvec, vec as _vec
    eq_k = eq_evals(r_k)
    if isinstance(eq_k, frvec.FrArray):
        m = np.ascontiguousarray(
            exp_q.astype(np.int64).reshape(F_n, N).T)
        return frvec.i64_mat_vec(m, eq_k)
    eq_o = _vec.as_object(eq_k)
    eobj = exp_q.astype(object).reshape(F_n, N) % _vec.R
    return np.einsum("kn,k->n", eobj, eq_o) % _vec.R


def _argmax_ppub(argmax_k, F_n: int, N: int, r_k2):
    """P_pub[k*N + n] = eq(r_k2, k) * [n == argmax_k[k]] — built by
    scattering Montgomery eq rows at the one-hot positions instead of an
    object-int broadcast over the full (F_n, N) grid."""
    from ..field import frvec, vec as _vec
    eq_k2 = eq_evals(r_k2)
    am = np.asarray(argmax_k, dtype=np.int64)
    if isinstance(eq_k2, frvec.FrArray):
        d = np.zeros((F_n * N, 4), dtype=np.uint64)
        d[np.arange(F_n, dtype=np.int64) * N + am] = eq_k2.d
        return frvec.FrArray(d)
    argind = np.zeros((F_n, N), dtype=np.int64)
    argind[np.arange(F_n), am] = 1
    eq_o = _vec.as_object(eq_k2)
    return ((argind.astype(object) * eq_o[:, None]) % _vec.R).reshape(-1)


def _softmax_fams(node_idx, L, chunk_cache):
    def mk(tag):
        return lambda d: CommittedPoly.make(tag, node_idx, d)
    return [
        ("SoftmaxZHiRaD", mk("SoftmaxZHiRaD"), L["chi"]),
        ("SoftmaxZLoRaD", mk("SoftmaxZLoRaD"), L["clo"]),
        ("SoftmaxSatDiffRaD", mk("SoftmaxSatDiffRaD"), L["csd"]),
        ("SoftmaxRemainderRaD", mk("SoftmaxRemainderRaD"), L["cR"]),
        ("SoftmaxExpRemainderRaD", mk("SoftmaxExpRemainderRaD"), L["cR"]),
    ]


def _prove_softmax(node, ctx, r, out_claim):
    from ..frontend.softmax import softmax_last_axis_decomposed
    op = node.operator
    L = _softmax_layout(op.scale)
    S, B = L["S"], L["lut"].base
    x_arr = ctx.trace.node_outputs[node.inputs[0]]
    F_n, N = int(np.prod(x_arr.shape[:-1])), x_arr.shape[-1]
    _, tr = softmax_last_axis_decomposed(x_arr, S)

    # bind aux advice into the transcript (reference TODO #218 aux vectors)
    aux = {"max_k": tr.max_k, "argmax_k": tr.argmax_k.astype(np.int32),
           "exp_sum_q": tr.exp_sum_q, "inv_sum": tr.inv_sum}
    for name in ("max_k", "argmax_k", "exp_sum_q", "inv_sum"):
        ctx.transcript.append_bytes(np.asarray(aux[name], dtype="<i4").tobytes())
        ctx.aux[(node.idx, name)] = np.asarray(aux[name], dtype=np.int32)

    g = ctx.transcript.challenge_vector(5)
    ga_hi, ga_lo = ctx.transcript.challenge_vector(2)
    terms, specs5, has_ltc = _softmax_terms(g, L, op.scale)
    zh_spec, zl_spec, sd_spec, r_spec, re_spec = specs5

    polys = {}
    specs = []
    for (tag, _, C), spec in zip(_softmax_fams(node.idx, L, None),
                                 [zh_spec, zl_spec, sd_spec, r_spec, re_spec]):
        ch = ctx.chunks[(node.idx, tag)]
        p2, s2 = build_derived_polys(node.idx, spec, ch)
        polys.update(p2)
        specs.extend(s2)
    polys["x"] = MLPoly(ints=padded_flat(x_arr).astype(np.int64))
    specs.append(("x", input_opening_id(node.idx, 0, node.inputs[0])))
    polys["expq"] = MLPoly(ints=tr.exp_q.astype(np.int64))
    specs.append(("expq", _softmax_expq_id(node.idx, "exec")))
    polys["ehi"] = MLPoly(ints=tr.exp_hi.astype(np.int64))
    specs.append(("ehi", OpeningId.virtual(
        VirtualPoly.make("SoftmaxExpHi", node.idx),
        SumcheckId.make("NodeExecution", node.idx))))
    polys["elo"] = MLPoly(ints=tr.exp_lo.astype(np.int64))
    specs.append(("elo", OpeningId.virtual(
        VirtualPoly.make("SoftmaxExpLo", node.idx),
        SumcheckId.make("NodeExecution", node.idx))))
    # public broadcasts (verifier evaluates their MLEs itself)
    invb = np.repeat(tr.inv_sum.astype(np.int64), N)
    maxb = np.repeat(tr.max_k.astype(np.int64), N)
    polys["invb"] = MLPoly(ints=invb)
    polys["maxb"] = MLPoly(ints=maxb)

    claim = out_claim
    if has_ltc[0]:
        claim = claim + g[3]
    if has_ltc[1]:
        claim = claim + g[4]
    inst = CycleExecutionProver(polys, terms, list(r), claim, specs)
    proof, r_sc = Sumcheck.prove(inst, ctx.accumulator, ctx.transcript)
    ctx.proofs[(node.idx, "Execution")] = proof
    r_sc = list(r_sc)

    # exp lookups: rv = ehi claim; raf = zhi value from chunk recon claims
    def chunk_val_claim(spec, prefix, C):
        acc = Fr.zero()
        for d in range(C):
            acc = acc + Fr(1 << (4 * d)) * ctx.accumulator.get_opening(
                FW.derived_claim_id(node.idx, f"{prefix}{d}"))[1]
        return acc

    ehi_claim = ctx.accumulator.get_opening(OpeningId.virtual(
        VirtualPoly.make("SoftmaxExpHi", node.idx),
        SumcheckId.make("NodeExecution", node.idx)))[1]
    elo_claim = ctx.accumulator.get_opening(OpeningId.virtual(
        VirtualPoly.make("SoftmaxExpLo", node.idx),
        SumcheckId.make("NodeExecution", node.idx)))[1]
    zhi_claim = chunk_val_claim(zh_spec, "zh", L["chi"])
    zlo_claim = chunk_val_claim(zl_spec, "zl", L["clo"])
    rr_hi = onehot.ReadRafProver(
        _ra_claim_id(node.idx, "SoftmaxZHiRa"), L["tab_hi"],
        tr.z_hi.astype(np.int64), ga_hi, ehi_claim + ga_hi * zhi_claim, r_sc)
    rr_lo = onehot.ReadRafProver(
        _ra_claim_id(node.idx, "SoftmaxZLoRa"), L["tab_lo"],
        tr.z_lo.astype(np.int64), ga_lo, elo_claim + ga_lo * zlo_claim, r_sc)
    rproof, _ = BatchedSumcheck.prove([rr_hi, rr_lo], ctx.accumulator,
                                      ctx.transcript)
    ctx.proofs[(node.idx, "ExpLookups")] = rproof

    # ra virtualizations
    for tag, ra_tag, C, chunks_key in [
            ("SoftmaxZHiRaD", "SoftmaxZHiRa", L["chi"], "SoftmaxZHiRaD"),
            ("SoftmaxZLoRaD", "SoftmaxZLoRa", L["clo"], "SoftmaxZLoRaD")]:
        ra_pt, ra_claim = ctx.accumulator.get_opening(
            _ra_claim_id(node.idx, ra_tag))
        nv_addr = len(ra_pt) - len(r_sc)
        rv = onehot.RaVirtualizationProver(
            (lambda t: lambda d: CommittedPoly.make(t, node.idx, d))(tag), C,
            ctx.chunks[(node.idx, chunks_key)], ra_pt[:nv_addr],
            ra_pt[nv_addr:], ra_claim, SumcheckId.make("RaVirtualization"))
        vproof, _ = Sumcheck.prove(rv, ctx.accumulator, ctx.transcript)
        ctx.proofs[(node.idx, f"RaVirtual_{tag}")] = vproof

    # exp_sum: expsum_pub(r_k) = sum_n expq
    log_f = F_n.bit_length() - 1
    log_n = N.bit_length() - 1
    r_k = ctx.transcript.challenge_vector_optimized(log_f)
    expsum_claim = MLPoly(ints=tr.exp_sum_q.astype(np.int64)).evaluate(r_k)
    bound = _expsum_bound(tr.exp_q, F_n, N, r_k)
    es = ExpSumProver(node.idx, MLPoly(fvec=bound), expsum_claim, list(r_k))
    esproof, _ = Sumcheck.prove(es, ctx.accumulator, ctx.transcript)
    ctx.proofs[(node.idx, "ExpSum")] = esproof

    # max check: max_pub(r_k2) = sum_j eq(r_k2,k) argind x
    r_k2 = ctx.transcript.challenge_vector_optimized(log_f)
    max_claim = MLPoly(ints=tr.max_k.astype(np.int64)).evaluate(r_k2)
    P_pub = _argmax_ppub(tr.argmax_k, F_n, N, r_k2)
    mc = MaxCheckProver(node.idx, MLPoly(fvec=P_pub),
                        MLPoly(ints=padded_flat(x_arr).astype(np.int64)),
                        max_claim, 2, node.inputs[0])
    mcproof, _ = Sumcheck.prove(mc, ctx.accumulator, ctx.transcript)
    ctx.proofs[(node.idx, "MaxCheck")] = mcproof

    # ra checks for all chunk families
    fams = []
    for (tag, fn, C), spec in zip(_softmax_fams(node.idx, L, None),
                                  [zh_spec, zl_spec, sd_spec, r_spec, re_spec]):
        fams.append((ChunkFamily(fn, C, ctx.chunks[(node.idx, tag)]), spec))
    ra_inst = build_ra_checks_provers(node.idx, fams, r_sc,
                                      ctx.accumulator, ctx.transcript)
    ra_proof, _ = BatchedSumcheck.prove(ra_inst, ctx.accumulator, ctx.transcript)
    ctx.proofs[(node.idx, "RaChecks")] = ra_proof


def _verify_softmax(node, ctx, r, out_claim):
    op = node.operator
    L = _softmax_layout(op.scale)
    S = L["S"]
    in_dims = tuple(ctx.node(node.inputs[0]).output_dims)
    F_n, N = int(np.prod(in_dims[:-1])), in_dims[-1]

    aux = {n: ctx.aux[(node.idx, n)]
           for n in ("max_k", "argmax_k", "exp_sum_q", "inv_sum")}
    for name in ("max_k", "argmax_k", "exp_sum_q", "inv_sum"):
        arr = np.asarray(aux[name], dtype=np.int32)
        if arr.shape != (F_n,):
            raise VerificationError("softmax aux shape mismatch")
        ctx.transcript.append_bytes(arr.astype("<i4").tobytes())
    # per-slice integer identities on the public advice
    s_sq = S * S
    for k in range(F_n):
        sm = int(aux["exp_sum_q"][k])
        iv = int(aux["inv_sum"][k])
        if sm <= 0 or iv != s_sq // sm:
            raise VerificationError("softmax inv_sum identity fails")
        if not (0 <= int(aux["argmax_k"][k]) < N):
            raise VerificationError("softmax argmax out of range")

    g = ctx.transcript.challenge_vector(5)
    ga_hi, ga_lo = ctx.transcript.challenge_vector(2)
    terms, specs5, has_ltc = _softmax_terms(g, L, op.scale)
    zh_spec, zl_spec, sd_spec, r_spec, re_spec = specs5
    specs = []
    for spec in [zh_spec, zl_spec, sd_spec, r_spec, re_spec]:
        _, s2 = _derived_specs(node.idx, spec)
        specs.extend(s2)
    specs.append(("x", input_opening_id(node.idx, 0, node.inputs[0])))
    specs.append(("expq", _softmax_expq_id(node.idx, "exec")))
    specs.append(("ehi", OpeningId.virtual(
        VirtualPoly.make("SoftmaxExpHi", node.idx),
        SumcheckId.make("NodeExecution", node.idx))))
    specs.append(("elo", OpeningId.virtual(
        VirtualPoly.make("SoftmaxExpLo", node.idx),
        SumcheckId.make("NodeExecution", node.idx))))
    invb = np.repeat(aux["inv_sum"].astype(np.int64), N)
    maxb = np.repeat(aux["max_k"].astype(np.int64), N)
    public_evals = {
        "invb": lambda rr: MLPoly(ints=invb).evaluate(rr),
        "maxb": lambda rr: MLPoly(ints=maxb).evaluate(rr),
    }
    claim = out_claim
    if has_ltc[0]:
        claim = claim + g[3]
    if has_ltc[1]:
        claim = claim + g[4]
    inst = CycleExecutionVerifier(terms, list(r), claim, specs,
                                  public_evals=public_evals)
    r_sc = list(Sumcheck.verify(ctx.proofs[(node.idx, "Execution")], inst,
                                ctx.accumulator, ctx.transcript))

    def chunk_val_claim(prefix, C):
        acc = Fr.zero()
        for d in range(C):
            acc = acc + Fr(1 << (4 * d)) * ctx.accumulator.get_opening(
                FW.derived_claim_id(node.idx, f"{prefix}{d}"))[1]
        return acc

    ehi_claim = ctx.accumulator.get_opening(OpeningId.virtual(
        VirtualPoly.make("SoftmaxExpHi", node.idx),
        SumcheckId.make("NodeExecution", node.idx)))[1]
    elo_claim = ctx.accumulator.get_opening(OpeningId.virtual(
        VirtualPoly.make("SoftmaxExpLo", node.idx),
        SumcheckId.make("NodeExecution", node.idx)))[1]
    zhi_claim = chunk_val_claim("zh", L["chi"])
    zlo_claim = chunk_val_claim("zl", L["clo"])
    rr_hi = onehot.ReadRafVerifier(
        _ra_claim_id(node.idx, "SoftmaxZHiRa"), L["tab_hi"], ga_hi,
        ehi_claim + ga_hi * zhi_claim, r_sc)
    rr_lo = onehot.ReadRafVerifier(
        _ra_claim_id(node.idx, "SoftmaxZLoRa"), L["tab_lo"], ga_lo,
        elo_claim + ga_lo * zlo_claim, r_sc)
    BatchedSumcheck.verify(ctx.proofs[(node.idx, "ExpLookups")], [rr_hi, rr_lo],
                           ctx.accumulator, ctx.transcript)

    for tag, ra_tag, C in [("SoftmaxZHiRaD", "SoftmaxZHiRa", L["chi"]),
                           ("SoftmaxZLoRaD", "SoftmaxZLoRa", L["clo"])]:
        ra_pt, ra_claim = ctx.accumulator.get_opening(
            _ra_claim_id(node.idx, ra_tag))
        nv_addr = len(ra_pt) - len(r_sc)
        rv = onehot.RaVirtualizationVerifier(
            (lambda t: lambda d: CommittedPoly.make(t, node.idx, d))(tag), C,
            ra_pt[:nv_addr], ra_pt[nv_addr:], ra_claim,
            SumcheckId.make("RaVirtualization"))
        Sumcheck.verify(ctx.proofs[(node.idx, f"RaVirtual_{tag}")], rv,
                        ctx.accumulator, ctx.transcript)

    log_f = F_n.bit_length() - 1
    log_n = N.bit_length() - 1
    r_k = ctx.transcript.challenge_vector_optimized(log_f)
    expsum_claim = MLPoly(ints=aux["exp_sum_q"].astype(np.int64)).evaluate(r_k)
    es = ExpSumVerifier(node.idx, log_n, expsum_claim, list(r_k))
    Sumcheck.verify(ctx.proofs[(node.idx, "ExpSum")], es,
                    ctx.accumulator, ctx.transcript)

    r_k2 = ctx.transcript.challenge_vector_optimized(log_f)
    max_claim = MLPoly(ints=aux["max_k"].astype(np.int64)).evaluate(r_k2)
    P_pub = _argmax_ppub(aux["argmax_k"].astype(np.int64), F_n, N, r_k2)
    mc = MaxCheckVerifier(node.idx, log_f + log_n, max_claim, 2,
                          node.inputs[0], P_pub)
    Sumcheck.verify(ctx.proofs[(node.idx, "MaxCheck")], mc,
                    ctx.accumulator, ctx.transcript)

    fams = []
    for (tag, fn, C), spec in zip(_softmax_fams(node.idx, L, None),
                                  [zh_spec, zl_spec, sd_spec, r_spec, re_spec]):
        fams.append((ChunkFamily(fn, C, None), spec))
    ra_inst = build_ra_checks_verifiers(node.idx, fams, r_sc,
                                        ctx.accumulator, ctx.transcript)
    BatchedSumcheck.verify(ctx.proofs[(node.idx, "RaChecks")], ra_inst,
                           ctx.accumulator, ctx.transcript)


_register([FOPS.SoftmaxLastAxis], _prove_softmax, _verify_softmax)

