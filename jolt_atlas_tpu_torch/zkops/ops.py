"""Per-operator prove/verify implementations.

Reference: jolt-atlas-core/src/onnx_proof/ops/ (OperatorProofTrait +
dispatch_operator!). Each operator consumes its node's reduced output claim
(r, out_claim) and produces:
  * an Execution cycle sumcheck binding outputs/inputs/chunk-derived values,
  * a RaChecks batched sumcheck (booleanity + hamming + address reads),
  * op-specific extra sumchecks (EinsumMatmul contraction),
with all committed-poly claims flowing into the opening accumulator.

Shape ops (Identity/Reshape/Broadcast/MoveAxis/Slice/Concat) are pure claim
plumbing: the output claim is re-expressed as claims on input MLEs at mapped
points (reference ops/{reshape,broadcast,...}.rs).
"""

from __future__ import annotations

import numpy as np

from ..device import bind as dbind
from ..device import telemetry
from ..field import vec
from ..field.frvec import FrArray
from ..field.scalar import Fr
from ..frontend import ops as FOPS
from ..ids import CommittedPoly, OpeningId, SumcheckId, VirtualPoly
from ..poly.eq import eq_evals
from ..poly.mlpoly import BindingOrder, MLPoly
from ..poly.unipoly import UniPoly
from ..subprotocols import onehot
from ..subprotocols.sumcheck import (
    BatchedSumcheck,
    RowsInstance,
    Sumcheck,
    SumcheckInstanceProver,
    SumcheckInstanceVerifier,
)
from ..utils import profiling
from . import framework as FW
from .framework import (
    ADD_SAT_CHUNKS,
    MUL_SAT_CHUNKS,
    ChunkFamily,
    CycleExecutionProver,
    CycleExecutionVerifier,
    build_derived_polys,
    build_ra_checks_provers,
    build_ra_checks_verifiers,
    recon_terms,
    sat_clamp_terms,
    unsigned_recon_terms,
)


class VerificationError(Exception):
    pass


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def input_opening_id(consumer_idx: int, slot: int, producer_idx: int) -> OpeningId:
    return OpeningId.virtual(
        VirtualPoly.make("NodeOutput", producer_idx),
        SumcheckId.make("NodeExecution", consumer_idx, slot),
    )


def acc_opening_id(node_idx: int) -> OpeningId:
    return OpeningId.virtual(
        VirtualPoly.make("ClampAcc", node_idx),
        SumcheckId.make("NodeExecution", node_idx),
    )


def padded_flat(arr: np.ndarray) -> np.ndarray:
    flat = np.asarray(arr).reshape(-1)
    n = len(flat)
    p = 1 if n <= 1 else 1 << (n - 1).bit_length()
    if p != n:
        flat = np.concatenate([flat, np.zeros(p - n, dtype=flat.dtype)])
    return flat


def to_unsigned(x: np.ndarray, bits: int) -> np.ndarray:
    """Two's-complement encode into [0, 2^bits)."""
    mask = np.uint64((1 << bits) - 1) if bits < 64 else np.uint64(0xFFFFFFFFFFFFFFFF)
    return (x.astype(np.int64).astype(np.uint64)) & mask


def axis_var_groups(dims: tuple) -> list[int]:
    """Per-axis variable counts; every padded dim must be a power of two."""
    groups = []
    for d in dims:
        assert d & (d - 1) == 0, f"dim {d} not a power of two"
        groups.append(d.bit_length() - 1)
    return groups


def split_point(r: list[Fr], groups: list[int]) -> list[list[Fr]]:
    out = []
    i = 0
    for g in groups:
        out.append(r[i:i + g])
        i += g
    assert i == len(r)
    return out


# ---------------------------------------------------------------------------
# witness generation (committed chunk polys per op)
# ---------------------------------------------------------------------------

def node_witness(node, model, trace):
    """Returns (poly_map additions, chunk_cache additions) for one node."""
    op = node.operator
    polys: dict[CommittedPoly, MLPoly] = {}
    chunks: dict[tuple, np.ndarray] = {}

    def fam(tag, arr_u, C):
        cvals = onehot.chunk_values(arr_u, C)
        chunks[(node.idx, tag)] = cvals
        for d in range(C):
            polys[CommittedPoly.make(tag, node.idx, d)] = onehot.one_hot_lazy(cvals[d])

    if isinstance(op, FOPS.ReLU):
        x = padded_flat(trace.node_outputs[node.inputs[0]])
        fam("NodeOutputRaD", to_unsigned(x, 32), 8)
    elif isinstance(op, (FOPS.Add, FOPS.Sub)):
        a = padded_flat(trace.node_outputs[node.inputs[0]]).astype(np.int64)
        b = padded_flat(trace.node_outputs[node.inputs[1]]).astype(np.int64)
        acc = a + b if isinstance(op, FOPS.Add) else a - b
        fam("ClampRaD", to_unsigned(acc, 4 * ADD_SAT_CHUNKS), ADD_SAT_CHUNKS)
    elif isinstance(op, (FOPS.Mul, FOPS.Square, FOPS.Einsum)):
        s = op.scale
        assert s % 4 == 0, "scale must be a multiple of 4 for chunked remainders"
        if isinstance(op, FOPS.Einsum):
            ins = [trace.node_outputs[i] for i in node.inputs]
            acc = FOPS.einsum_acc_i64(op.equation, ins)
        elif isinstance(op, FOPS.Square):
            a = trace.node_outputs[node.inputs[0]].astype(np.int64)
            acc = a * a
        else:
            acc = trace.node_outputs[node.inputs[0]].astype(np.int64)
            for i in node.inputs[1:]:
                acc = acc * trace.node_outputs[i].astype(np.int64)
        acc = padded_flat(acc)
        q = np.floor_divide(acc, np.int64(1) << np.int64(s))
        rem = np.mod(acc, np.int64(1) << np.int64(s))
        fam("ClampRaD", to_unsigned(q, 4 * MUL_SAT_CHUNKS), MUL_SAT_CHUNKS)
        fam("RescaleRemainderRaD", rem.astype(np.uint64), s // 4)
    elif isinstance(op, FOPS.Sum):
        x = trace.node_outputs[node.inputs[0]]
        acc = padded_flat(np.sum(x.astype(np.int64), axis=tuple(op.axes),
                                 keepdims=True))
        fam("ClampRaD", to_unsigned(acc, 4 * MUL_SAT_CHUNKS), MUL_SAT_CHUNKS)
    elif isinstance(op, (FOPS.GatherSmall, FOPS.GatherLarge)):
        idx = padded_flat(trace.node_outputs[node.inputs[1]]).astype(np.int64)
        V = trace.node_outputs[node.inputs[0]].shape[0]
        if isinstance(op, FOPS.GatherLarge):
            D = _gather_large_chunks(V)
            fam("GatherRaD", idx.astype(np.uint64), D)
        else:
            polys[CommittedPoly.make("GatherRa", node.idx)] = \
                onehot.one_hot_lazy(idx, K=V)
    elif isinstance(op, FOPS.ScalarConstDiv):
        x = padded_flat(trace.node_outputs[node.inputs[0]]).astype(np.int64)
        rem = np.mod(x, op.divisor)
        fam("ScalarConstDivNodeRemainder", rem.astype(np.uint64),
            _scdiv_chunks(op.divisor))
    elif isinstance(op, FOPS.Clamp):
        x = trace.node_outputs[node.inputs[0]]
        _, x2, F_n, N, max_k, argmax_k, b, u, z = _clamp_pieces(op, x)
        fam("ClampSpreadRaD", u.reshape(-1).astype(np.uint64), 8)
        fam("ClampMaxDiffRaD", z.reshape(-1).astype(np.uint64), 8)
        polys[CommittedPoly.make("ClampIndicator", node.idx)] = \
            MLPoly(ints=b.reshape(-1))
    elif isinstance(op, (FOPS.Tanh, FOPS.Erf, FOPS.Sigmoid)):
        fam_tag, _ = _ACT_FAMILY[type(op)]
        x = padded_flat(trace.node_outputs[node.inputs[0]]).astype(np.int64)
        q = np.floor_divide(x, op.tau)
        assert (np.abs(q) < (1 << 15)).all(), "teleport quotient exceeds i16"
        u = np.mod(q, 1 << 16)
        rem = x - q * op.tau
        fam(fam_tag, u.astype(np.uint64), 4)
        C_rem, _ = _teleport_rem_chunks(op)
        fam("TeleportRangeCheckRaD", rem.astype(np.uint64), C_rem)
    elif isinstance(op, (FOPS.Sin, FOPS.Cos)):
        fam_tag, _ = _TRIG_FAMILY[type(op)]
        x = padded_flat(trace.node_outputs[node.inputs[0]]).astype(np.int64)
        rem = np.mod(x, FOPS.FOUR_PI_APPROX)
        q = (x - rem) // FOPS.FOUR_PI_APPROX
        fam(fam_tag, rem.astype(np.uint64), 3)
        polys[CommittedPoly.make("TeleportNodeQuotient", node.idx)] = \
            MLPoly(ints=q)
    elif isinstance(op, FOPS.Rsqrt):
        import math
        x = padded_flat(trace.node_outputs[node.inputs[0]]).astype(np.int64)
        S3 = np.int64(1 << (3 * op.scale))
        pos = x > 0
        Q = np.where(pos, S3 // np.maximum(x, 1), 0)
        Y = np.where(pos, np.array([math.isqrt(int(q)) for q in Q],
                                   dtype=np.int64), 0)
        r1 = np.where(pos, S3 - Q * np.maximum(x, 1), 0)
        r2 = np.where(pos, Q - Y * Y, 0)
        B = np.where(pos, 2 * Y + 1, 1)
        cvals = np.concatenate([
            onehot.chunk_values(to_unsigned(x, 32), 8),
            onehot.chunk_values(r1.astype(np.uint64), 8),
            onehot.chunk_values(r2.astype(np.uint64), 5),
            onehot.chunk_values(B.astype(np.uint64), 5)], axis=0)
        chunks[(node.idx, "SqrtRangeCheckRaD")] = cvals
        for d in range(_RSQ_NCHUNKS):
            polys[CommittedPoly.make("SqrtRangeCheckRaD", node.idx, d)] = \
                onehot.one_hot_lazy(cvals[d])
        polys[CommittedPoly.make("RsqrtQuotient", node.idx, 0)] = MLPoly(ints=Q)
        polys[CommittedPoly.make("RsqrtQuotient", node.idx, 1)] = MLPoly(ints=Y)
        polys[CommittedPoly.make("RsqrtQuotient", node.idx, 2)] = \
            MLPoly(ints=pos.astype(np.int64))
    elif isinstance(op, FOPS.SoftmaxLastAxis):
        from ..frontend.softmax import softmax_last_axis_decomposed
        from .softmax_op import _softmax_layout
        L = _softmax_layout(op.scale)
        x = trace.node_outputs[node.inputs[0]]
        _, tr = softmax_last_axis_decomposed(x, L["S"])
        fam("SoftmaxZHiRaD", tr.z_hi.astype(np.uint64), L["chi"])
        fam("SoftmaxZLoRaD", tr.z_lo.astype(np.uint64), L["clo"])
        fam("SoftmaxSatDiffRaD", tr.sat_diff.astype(np.uint64), L["csd"])
        fam("SoftmaxRemainderRaD", tr.R.astype(np.uint64), L["cR"])
        fam("SoftmaxExpRemainderRaD", tr.r_exp.astype(np.uint64), L["cR"])
        polys[CommittedPoly.make("SoftmaxExpQDense", node.idx)] = \
            MLPoly(ints=tr.exp_q.astype(np.int64))
    elif isinstance(op, FOPS.MeanOfSquares):
        x = trace.node_outputs[node.inputs[0]]
        acc = padded_flat(op.acc_i64(x))
        D = op.divisor()
        qv = np.floor_divide(acc, D)
        rem = np.mod(acc, D)
        fam("ClampRaD", to_unsigned(qv, 4 * MUL_SAT_CHUNKS), MUL_SAT_CHUNKS)
        fam("MeanOfSquaresRangeCheckRaD", rem.astype(np.uint64),
            _mos_rem_chunks(op))
    elif isinstance(op, FOPS.Div):
        x = padded_flat(trace.node_outputs[node.inputs[0]]).astype(np.int64)
        y = padded_flat(trace.node_outputs[node.inputs[1]]).astype(np.int64)
        assert (y > 0).all(), "Div proof requires positive divisors"
        xs = x << np.int64(op.scale)   # requantizing numerator
        q = np.floor_divide(xs, y)
        rem = xs - q * y
        both = np.concatenate([to_unsigned(rem, 32), to_unsigned(y, 32)])
        cvals = np.concatenate([
            onehot.chunk_values(to_unsigned(rem, 32), 8),
            onehot.chunk_values(to_unsigned(y, 32), 8)], axis=0)
        chunks[(node.idx, "DivRangeCheckRaD")] = cvals
        for d in range(16):
            polys[CommittedPoly.make("DivRangeCheckRaD", node.idx, d)] = \
                onehot.one_hot_lazy(cvals[d])
        polys[CommittedPoly.make("DivNodeQuotient", node.idx)] = MLPoly(ints=q)
    elif isinstance(op, FOPS.Cube):
        a = padded_flat(trace.node_outputs[node.inputs[0]]).astype(np.int64)
        assert (np.abs(a) < (1 << 20)).all(), "cube operand too large for i64"
        acc = a * a * a
        bits = 2 * op.scale
        qv = np.floor_divide(acc, np.int64(1) << np.int64(bits))
        rem = np.mod(acc, np.int64(1) << np.int64(bits))
        fam("ClampRaD", to_unsigned(qv, 4 * MUL_SAT_CHUNKS), MUL_SAT_CHUNKS)
        fam("RescaleRemainderRaD", rem.astype(np.uint64), bits // 4)
    return polys, chunks


def node_committed_polys(node) -> list[CommittedPoly]:
    op = node.operator
    out = []
    if isinstance(op, FOPS.ReLU):
        out += [CommittedPoly.make("NodeOutputRaD", node.idx, d) for d in range(8)]
    elif isinstance(op, (FOPS.Add, FOPS.Sub)):
        out += [CommittedPoly.make("ClampRaD", node.idx, d)
                for d in range(ADD_SAT_CHUNKS)]
    elif isinstance(op, (FOPS.Mul, FOPS.Square, FOPS.Einsum)):
        out += [CommittedPoly.make("ClampRaD", node.idx, d)
                for d in range(MUL_SAT_CHUNKS)]
        out += [CommittedPoly.make("RescaleRemainderRaD", node.idx, d)
                for d in range(op.scale // 4)]
    return out


# ---------------------------------------------------------------------------
# einsum contraction sumcheck — generic two-operand contraction engine
# (reference ops/einsum/dot.rs + the 7 layout families, ops/einsum/*.rs)
# ---------------------------------------------------------------------------

class EinsumLayout:
    """Static index bookkeeping for a two-operand contraction equation.

    Sumcheck domain = `shared` chars (in the output AND both operands, e.g.
    batch dims — they must stay inside the sum, weighted by eq) followed by
    `contract` chars (in both operands but not the output):
        acc(r) = sum_{shared,contract} eq(r_shared, .) * A_bound * B_bound
    A_bound partially evaluates A at its *exclusive* out chars.
    """

    def __init__(self, equation: str, in_dims: list[tuple], out_dims: tuple):
        lhs, rhs = equation.replace(" ", "").split("->")
        self.terms = lhs.split(",")
        assert len(self.terms) == 2, "einsum proofs support two operands"
        self.out_chars = list(rhs)
        seen = []
        for term in self.terms:
            for ch in term:
                if ch not in rhs and ch not in seen:
                    seen.append(ch)
        self.contract_chars = seen
        for ch in self.contract_chars:
            assert all(ch in t for t in self.terms), \
                f"contraction char {ch} must appear in both operands"
        assert all(len(set(t)) == len(t) for t in self.terms), \
            "einsum proofs support operands without a repeated char"
        self.shared_chars = [ch for ch in rhs
                             if all(ch in t for t in self.terms)]
        self.domain_chars = self.shared_chars + self.contract_chars
        self.sizes = {}
        for term, dims in zip(self.terms, in_dims):
            for ch, d in zip(term, dims):
                assert self.sizes.setdefault(ch, d) == d
        for ch, d in zip(rhs, out_dims):
            assert self.sizes.setdefault(ch, d) == d

    def char_vars(self, ch) -> int:
        return self.sizes[ch].bit_length() - 1

    def domain_vars(self) -> int:
        return sum(self.char_vars(c) for c in self.domain_chars)

    def degree(self) -> int:
        return 3 if self.shared_chars else 2

    def split_out_point(self, r: list[Fr]) -> dict:
        groups = {}
        i = 0
        for ch in self.out_chars:
            v = self.char_vars(ch)
            groups[ch] = r[i:i + v]
            i += v
        assert i == len(r)
        return groups

    def split_domain_point(self, r_c: list[Fr]) -> dict:
        groups = {}
        i = 0
        for ch in self.domain_chars:
            v = self.char_vars(ch)
            groups[ch] = r_c[i:i + v]
            i += v
        return groups

    def operand_point(self, term: str, out_groups: dict, c_groups: dict):
        pt = []
        for ch in term:
            pt.extend(c_groups[ch] if ch in c_groups else out_groups[ch])
        return pt

    def exclusive_chars(self, term: str) -> list[str]:
        other = self.terms[1] if term == self.terms[0] else self.terms[0]
        return [ch for ch in term if ch in self.out_chars and ch not in other]

    def operand_axes(self, term: str) -> tuple[list[str], list[str]]:
        """(the term's domain chars in canonical domain order, its exclusive
        out chars in term order): the axes a bound operand keeps and those
        it is bound at."""
        excl = self.exclusive_chars(term)
        return ([ch for ch in self.domain_chars if ch in term],
                [ch for ch in term if ch in excl])

    def operand_layout(self, term: str, out_groups: dict) -> tuple:
        """(perm, K, E, points, kept): the bind of ``term``'s operand at its
        exclusive out chars (device/bind.py ``bind_operand``): its axes in
        the order perm, the kept chars' K values by the exclusive chars' E,
        against the eq table of their points concatenated."""
        kept, excl = self.operand_axes(term)
        perm = tuple(term.index(ch) for ch in kept + excl)
        K, E = (int(np.prod([self.sizes[ch] for ch in chars],
                            dtype=np.int64)) for chars in (kept, excl))
        return perm, K, E, [x for ch in excl for x in out_groups[ch]], kept

    def broadcast_bound(self, bound, kept: list[str]):
        """A bound operand's K values (an FrArray or an object array, its
        kept chars' axes flattened) broadcast along the domain chars
        missing from its term (the operand is constant along them),
        flattened in canonical domain order."""
        native = isinstance(bound, FrArray)
        flat = bound.d if native else np.asarray(bound)
        trail = flat.shape[1:]
        view = flat.reshape(tuple(self.sizes[ch] for ch in kept) + trail)
        for ax, ch in enumerate(self.domain_chars):
            if ch not in kept:
                view = np.expand_dims(view, ax)
        full_shape = tuple(self.sizes[ch] for ch in self.domain_chars)
        view = np.broadcast_to(view, full_shape + trail)
        out = np.ascontiguousarray(view).reshape((-1,) + trail)
        return FrArray(out) if native else out

    def eq_shared_poly(self, out_groups: dict) -> MLPoly | None:
        if not self.shared_chars:
            return None
        r_shared = []
        for ch in self.shared_chars:
            r_shared.extend(out_groups[ch])
        eq = vec.as_object(eq_evals(r_shared))
        n_contract = 1
        for ch in self.contract_chars:
            n_contract *= self.sizes[ch]
        full = np.repeat(eq, n_contract)
        return MLPoly(fvec=full)


class EinsumContractionProver(RowsInstance, SumcheckInstanceProver):
    def __init__(self, node, layout: EinsumLayout, bounds: list[MLPoly],
                 claim: Fr, out_groups: dict, producers: list[int]):
        self.node = node
        self.layout = layout
        eq_shared = layout.eq_shared_poly(out_groups)
        self.claim = claim
        self.out_groups = out_groups
        self.producers = producers
        self._rounds = layout.domain_vars()
        rows = list(bounds) + ([eq_shared] if eq_shared is not None else [])
        self.setup_rows(rows, [(Fr.one(), list(range(len(rows))))],
                        layout.degree())

    def num_rounds(self):
        return self._rounds

    def degree(self):
        return self.layout.degree()

    def input_claim(self, accumulator):
        return self.claim

    def compute_message(self, round, previous_claim):
        return self.rows_message(previous_claim)

    def ingest_challenge(self, r, round):
        self.rows_bind(r)

    def cache_openings(self, accumulator, transcript, r):
        c_groups = self.layout.split_domain_point(list(r))
        for slot, (term, prod) in enumerate(
                zip(self.layout.terms, self.producers)):
            pt = self.layout.operand_point(term, self.out_groups, c_groups)
            accumulator.append_virtual(
                transcript, input_opening_id(self.node.idx, slot, prod),
                pt, self.row_final(slot))


class EinsumContractionVerifier(SumcheckInstanceVerifier):
    def __init__(self, node, layout: EinsumLayout, claim: Fr,
                 out_groups: dict, producers: list[int]):
        self.node = node
        self.layout = layout
        self.claim = claim
        self.out_groups = out_groups
        self.producers = producers

    def num_rounds(self):
        return self.layout.domain_vars()

    def degree(self):
        return self.layout.degree()

    def input_claim(self, accumulator):
        return self.claim

    def cache_openings(self, accumulator, transcript, r):
        c_groups = self.layout.split_domain_point(list(r))
        for slot, (term, prod) in enumerate(
                zip(self.layout.terms, self.producers)):
            pt = self.layout.operand_point(term, self.out_groups, c_groups)
            accumulator.append_virtual(
                transcript, input_opening_id(self.node.idx, slot, prod), pt)

    def expected_output_claim(self, accumulator, r):
        acc = Fr.one()
        for slot, prod in enumerate(self.producers):
            acc = acc * accumulator.get_opening(
                input_opening_id(self.node.idx, slot, prod))[1]
        if self.layout.shared_chars:
            c_groups = self.layout.split_domain_point(list(r))
            r_shared = []
            pt_shared = []
            for ch in self.layout.shared_chars:
                r_shared.extend(self.out_groups[ch])
                pt_shared.extend(c_groups[ch])
            from ..poly.eq import eq_eval_scalar
            acc = acc * eq_eval_scalar(r_shared, pt_shared)
        return acc


# ---------------------------------------------------------------------------
# operator prove / verify dispatch
# ---------------------------------------------------------------------------

_PROVERS = {}
_VERIFIERS = {}


def _register(op_types, prove_fn, verify_fn):
    for t in op_types:
        _PROVERS[t] = prove_fn
        _VERIFIERS[t] = verify_fn


def prove_node(node, ctx):
    op = node.operator
    if isinstance(op, (FOPS.Input, FOPS.Constant)):
        return  # claims checked directly against public MLEs by the verifier
    r, out_claim = ctx.reduced[node.idx]
    fn = _PROVERS.get(type(op))
    if fn is None:
        raise NotImplementedError(f"prove: {op.name}")
    fn(node, ctx, r, out_claim)


def verify_node(node, ctx):
    op = node.operator
    if isinstance(op, (FOPS.Input, FOPS.Constant)):
        return
    r, out_claim = ctx.reduced[node.idx]
    fn = _VERIFIERS.get(type(op))
    if fn is None:
        raise NotImplementedError(f"verify: {op.name}")
    fn(node, ctx, r, out_claim)


# -- claim plumbing ops ------------------------------------------------------

def _prove_passthrough(node, ctx, r, out_claim):
    # flattened padded data is identical (requires equal padded lengths)
    src = node.inputs[0]
    assert ctx.padded_len(src) == ctx.padded_len(node.idx), \
        "reshape with different padded lengths not yet supported"
    ctx.accumulator.append_virtual(
        ctx.transcript, input_opening_id(node.idx, 0, src), r, out_claim)


def _verify_passthrough(node, ctx, r, out_claim):
    src = node.inputs[0]
    oid = input_opening_id(node.idx, 0, src)
    ctx.accumulator.append_virtual(ctx.transcript, oid, r)
    if ctx.accumulator.get_opening(oid)[1] != out_claim:
        raise VerificationError(f"passthrough claim mismatch at node {node.idx}")


def _broadcast_point(node, ctx, r):
    in_dims = tuple(ctx.node(node.inputs[0]).output_dims)
    out_dims = tuple(node.output_dims)
    out_groups = axis_var_groups(out_dims)
    parts = split_point(r, out_groups)
    # align right: trailing axes of out map to axes of in
    offset = len(out_dims) - len(in_dims)
    pt = []
    for i, d in enumerate(in_dims):
        if d == out_dims[offset + i]:
            pt.extend(parts[offset + i])
        else:
            assert d == 1, "broadcast with non-unit mismatched dim"
    return pt


def _prove_broadcast(node, ctx, r, out_claim):
    pt = _broadcast_point(node, ctx, r)
    ctx.accumulator.append_virtual(
        ctx.transcript, input_opening_id(node.idx, 0, node.inputs[0]), pt,
        out_claim)


def _verify_broadcast(node, ctx, r, out_claim):
    pt = _broadcast_point(node, ctx, r)
    oid = input_opening_id(node.idx, 0, node.inputs[0])
    ctx.accumulator.append_virtual(ctx.transcript, oid, pt)
    if ctx.accumulator.get_opening(oid)[1] != out_claim:
        raise VerificationError(f"broadcast claim mismatch at node {node.idx}")


def _moveaxis_point(node, ctx, r):
    op = node.operator
    in_dims = tuple(ctx.node(node.inputs[0]).output_dims)
    out_groups = axis_var_groups(tuple(node.output_dims))
    parts = split_point(r, out_groups)
    # out axes are in axes with `source` moved to `destination`; invert
    order = list(range(len(in_dims)))
    d = order.pop(op.source)
    order.insert(op.destination, d)
    # parts[i] corresponds to in-axis order[i]; input point in axis order:
    pt_parts = [None] * len(in_dims)
    for i, ax in enumerate(order):
        pt_parts[ax] = parts[i]
    return [c for g in pt_parts for c in g]


def _prove_moveaxis(node, ctx, r, out_claim):
    pt = _moveaxis_point(node, ctx, r)
    ctx.accumulator.append_virtual(
        ctx.transcript, input_opening_id(node.idx, 0, node.inputs[0]), pt,
        out_claim)


def _verify_moveaxis(node, ctx, r, out_claim):
    pt = _moveaxis_point(node, ctx, r)
    oid = input_opening_id(node.idx, 0, node.inputs[0])
    ctx.accumulator.append_virtual(ctx.transcript, oid, pt)
    if ctx.accumulator.get_opening(oid)[1] != out_claim:
        raise VerificationError(f"moveaxis claim mismatch at node {node.idx}")


def _slice_point(node, ctx, r):
    op = node.operator
    in_dims = tuple(ctx.node(node.inputs[0]).output_dims)
    out_dims = tuple(node.output_dims)
    length = op.end - op.start
    assert length & (length - 1) == 0 and op.start % length == 0, \
        "only aligned power-of-two slices supported"
    out_groups = axis_var_groups(out_dims)
    parts = split_point(r, out_groups)
    pt = []
    for ax, d in enumerate(in_dims):
        if ax == op.axis:
            extra = (d.bit_length() - 1) - (out_dims[ax].bit_length() - 1)
            block = op.start // length
            bits = [Fr((block >> (extra - 1 - i)) & 1) for i in range(extra)]
            pt.extend(bits + parts[ax])
        else:
            pt.extend(parts[ax])
    return pt


def _prove_slice(node, ctx, r, out_claim):
    pt = _slice_point(node, ctx, r)
    ctx.accumulator.append_virtual(
        ctx.transcript, input_opening_id(node.idx, 0, node.inputs[0]), pt,
        out_claim)


def _verify_slice(node, ctx, r, out_claim):
    pt = _slice_point(node, ctx, r)
    oid = input_opening_id(node.idx, 0, node.inputs[0])
    ctx.accumulator.append_virtual(ctx.transcript, oid, pt)
    if ctx.accumulator.get_opening(oid)[1] != out_claim:
        raise VerificationError(f"slice claim mismatch at node {node.idx}")


def _prove_neg(node, ctx, r, out_claim):
    ctx.accumulator.append_virtual(
        ctx.transcript, input_opening_id(node.idx, 0, node.inputs[0]), r,
        Fr.zero() - out_claim)


def _verify_neg(node, ctx, r, out_claim):
    oid = input_opening_id(node.idx, 0, node.inputs[0])
    ctx.accumulator.append_virtual(ctx.transcript, oid, r)
    if ctx.accumulator.get_opening(oid)[1] != (Fr.zero() - out_claim):
        raise VerificationError(f"neg claim mismatch at node {node.idx}")


# -- ReLU --------------------------------------------------------------------

def _relu_terms(gamma: Fr):
    terms = []
    spec = {}
    for d in range(8):
        spec[f"cv{d}"] = (d, "identity")
        terms.append((Fr(1 << (4 * d)), ["cnhi7", f"cv{d}"]))
    spec["chi7"] = (7, "msb")
    spec["cnhi7"] = (7, "notmsb")
    # gamma * (x - recon):  recon = sum 2^{4d} v_d - 2^32 hi7
    terms.append((gamma, ["x"]))
    for d in range(8):
        terms.append((Fr.zero() - gamma * Fr(1 << (4 * d)), [f"cv{d}"]))
    terms.append((gamma * Fr(1 << 32), ["chi7"]))
    return terms, spec


def _prove_relu(node, ctx, r, out_claim):
    gamma = ctx.transcript.challenge_scalar()
    terms, spec = _relu_terms(gamma)
    chunks = ctx.chunks[(node.idx, "NodeOutputRaD")]
    polys, specs = build_derived_polys(node.idx, spec, chunks)
    x = padded_flat(ctx.trace.node_outputs[node.inputs[0]])
    polys["x"] = MLPoly(ints=x.astype(np.int64))
    specs.append(("x", input_opening_id(node.idx, 0, node.inputs[0])))
    inst = CycleExecutionProver(polys, terms, r, out_claim, specs)
    proof, r_sc = Sumcheck.prove(inst, ctx.accumulator, ctx.transcript)
    ctx.proofs[(node.idx, "Execution")] = proof
    fam = ChunkFamily(lambda d: CommittedPoly.make("NodeOutputRaD", node.idx, d),
                      8, chunks)
    ra_inst = build_ra_checks_provers(node.idx, [(fam, spec)], list(r_sc),
                                      ctx.accumulator, ctx.transcript)
    ra_proof, _ = BatchedSumcheck.prove(ra_inst, ctx.accumulator, ctx.transcript)
    ctx.proofs[(node.idx, "RaChecks")] = ra_proof


def _verify_relu(node, ctx, r, out_claim):
    gamma = ctx.transcript.challenge_scalar()
    terms, spec = _relu_terms(gamma)
    _, specs = _derived_specs(node.idx, spec)
    specs.append(("x", input_opening_id(node.idx, 0, node.inputs[0])))
    inst = CycleExecutionVerifier(terms, r, out_claim, specs)
    r_sc = Sumcheck.verify(ctx.proofs[(node.idx, "Execution")], inst,
                           ctx.accumulator, ctx.transcript)
    fam = ChunkFamily(lambda d: CommittedPoly.make("NodeOutputRaD", node.idx, d),
                      8, None)
    ra_inst = build_ra_checks_verifiers(node.idx, [(fam, spec)], list(r_sc),
                                        ctx.accumulator, ctx.transcript)
    BatchedSumcheck.verify(ctx.proofs[(node.idx, "RaChecks")], ra_inst,
                           ctx.accumulator, ctx.transcript)


def _derived_specs(node_idx, spec):
    specs = [(name, FW.derived_claim_id(node_idx, name)) for name in sorted(spec)]
    return None, specs


# -- Add / Sub ---------------------------------------------------------------

def _addsub_terms(gamma: Fr, sign: int):
    C = ADD_SAT_CHUNKS
    terms, spec = sat_clamp_terms(C, "c")
    # gamma * (a +- b - recon)
    terms.append((gamma, ["a"]))
    terms.append((gamma * Fr(sign), ["b"]))
    for coeff, factors in recon_terms(C, "c"):
        terms.append((Fr.zero() - gamma * coeff, factors))
    return terms, spec


def _prove_addsub(node, ctx, r, out_claim):
    sign = 1 if isinstance(node.operator, FOPS.Add) else -1
    gamma = ctx.transcript.challenge_scalar()
    terms, spec = _addsub_terms(gamma, sign)
    chunks = ctx.chunks[(node.idx, "ClampRaD")]
    polys, specs = build_derived_polys(node.idx, spec, chunks)
    a = padded_flat(ctx.trace.node_outputs[node.inputs[0]])
    b = padded_flat(ctx.trace.node_outputs[node.inputs[1]])
    polys["a"] = MLPoly(ints=a.astype(np.int64))
    polys["b"] = MLPoly(ints=b.astype(np.int64))
    specs.append(("a", input_opening_id(node.idx, 0, node.inputs[0])))
    specs.append(("b", input_opening_id(node.idx, 1, node.inputs[1])))
    inst = CycleExecutionProver(polys, terms, r, out_claim, specs)
    proof, r_sc = Sumcheck.prove(inst, ctx.accumulator, ctx.transcript)
    ctx.proofs[(node.idx, "Execution")] = proof
    fam = ChunkFamily(lambda d: CommittedPoly.make("ClampRaD", node.idx, d),
                      ADD_SAT_CHUNKS, chunks)
    ra_inst = build_ra_checks_provers(node.idx, [(fam, spec)], list(r_sc),
                                      ctx.accumulator, ctx.transcript)
    ra_proof, _ = BatchedSumcheck.prove(ra_inst, ctx.accumulator, ctx.transcript)
    ctx.proofs[(node.idx, "RaChecks")] = ra_proof


def _verify_addsub(node, ctx, r, out_claim):
    sign = 1 if isinstance(node.operator, FOPS.Add) else -1
    gamma = ctx.transcript.challenge_scalar()
    terms, spec = _addsub_terms(gamma, sign)
    _, specs = _derived_specs(node.idx, spec)
    specs.append(("a", input_opening_id(node.idx, 0, node.inputs[0])))
    specs.append(("b", input_opening_id(node.idx, 1, node.inputs[1])))
    inst = CycleExecutionVerifier(terms, r, out_claim, specs)
    r_sc = Sumcheck.verify(ctx.proofs[(node.idx, "Execution")], inst,
                           ctx.accumulator, ctx.transcript)
    fam = ChunkFamily(lambda d: CommittedPoly.make("ClampRaD", node.idx, d),
                      ADD_SAT_CHUNKS, None)
    ra_inst = build_ra_checks_verifiers(node.idx, [(fam, spec)], list(r_sc),
                                        ctx.accumulator, ctx.transcript)
    BatchedSumcheck.verify(ctx.proofs[(node.idx, "RaChecks")], ra_inst,
                           ctx.accumulator, ctx.transcript)


# -- Mul / Square (fused rescale, elementwise) ------------------------------

def _mul_terms(gamma: Fr, scale: int, square: bool):
    C = MUL_SAT_CHUNKS
    terms, spec = sat_clamp_terms(C, "c")
    rspec_chunks = scale // 4
    _, rspec = {}, {}
    for d in range(rspec_chunks):
        rspec[f"rv{d}"] = (d, "identity")
    # gamma * (a*b - 2^S * recon_q - recon_R)
    terms.append((gamma, ["a", "a"] if square else ["a", "b"]))
    for coeff, factors in recon_terms(C, "c", scale=1 << scale):
        terms.append((Fr.zero() - gamma * coeff, factors))
    for coeff, factors in unsigned_recon_terms(rspec_chunks, "r"):
        terms.append((Fr.zero() - gamma * coeff, factors))
    return terms, spec, rspec


def _prove_mul(node, ctx, r, out_claim):
    op = node.operator
    square = isinstance(op, FOPS.Square)
    gamma = ctx.transcript.challenge_scalar()
    terms, spec, rspec = _mul_terms(gamma, op.scale, square)
    qchunks = ctx.chunks[(node.idx, "ClampRaD")]
    rchunks = ctx.chunks[(node.idx, "RescaleRemainderRaD")]
    polys, specs = build_derived_polys(node.idx, spec, qchunks)
    rpolys, rspecs = build_derived_polys(node.idx, rspec, rchunks)
    polys.update(rpolys)
    specs.extend(rspecs)
    a = padded_flat(ctx.trace.node_outputs[node.inputs[0]])
    polys["a"] = MLPoly(ints=a.astype(np.int64))
    specs.append(("a", input_opening_id(node.idx, 0, node.inputs[0])))
    if not square:
        b = padded_flat(ctx.trace.node_outputs[node.inputs[1]])
        polys["b"] = MLPoly(ints=b.astype(np.int64))
        specs.append(("b", input_opening_id(node.idx, 1, node.inputs[1])))
    inst = CycleExecutionProver(polys, terms, r, out_claim, specs)
    proof, r_sc = Sumcheck.prove(inst, ctx.accumulator, ctx.transcript)
    ctx.proofs[(node.idx, "Execution")] = proof
    fams = [
        (ChunkFamily(lambda d: CommittedPoly.make("ClampRaD", node.idx, d),
                     MUL_SAT_CHUNKS, qchunks), spec),
        (ChunkFamily(lambda d: CommittedPoly.make("RescaleRemainderRaD", node.idx, d),
                     op.scale // 4, rchunks), rspec),
    ]
    ra_inst = build_ra_checks_provers(node.idx, fams, list(r_sc),
                                      ctx.accumulator, ctx.transcript)
    ra_proof, _ = BatchedSumcheck.prove(ra_inst, ctx.accumulator, ctx.transcript)
    ctx.proofs[(node.idx, "RaChecks")] = ra_proof


def _verify_mul(node, ctx, r, out_claim):
    op = node.operator
    square = isinstance(op, FOPS.Square)
    gamma = ctx.transcript.challenge_scalar()
    terms, spec, rspec = _mul_terms(gamma, op.scale, square)
    _, specs = _derived_specs(node.idx, spec)
    _, rspecs = _derived_specs(node.idx, rspec)
    specs.extend(rspecs)
    specs.append(("a", input_opening_id(node.idx, 0, node.inputs[0])))
    if not square:
        specs.append(("b", input_opening_id(node.idx, 1, node.inputs[1])))
    inst = CycleExecutionVerifier(terms, r, out_claim, specs)
    r_sc = Sumcheck.verify(ctx.proofs[(node.idx, "Execution")], inst,
                           ctx.accumulator, ctx.transcript)
    fams = [
        (ChunkFamily(lambda d: CommittedPoly.make("ClampRaD", node.idx, d),
                     MUL_SAT_CHUNKS, None), spec),
        (ChunkFamily(lambda d: CommittedPoly.make("RescaleRemainderRaD", node.idx, d),
                     op.scale // 4, None), rspec),
    ]
    ra_inst = build_ra_checks_verifiers(node.idx, fams, list(r_sc),
                                        ctx.accumulator, ctx.transcript)
    BatchedSumcheck.verify(ctx.proofs[(node.idx, "RaChecks")], ra_inst,
                           ctx.accumulator, ctx.transcript)


# -- Einsum (mk,kn->mn) ------------------------------------------------------

def _einsum_terms(gamma: Fr, scale: int):
    C = MUL_SAT_CHUNKS
    terms, spec = sat_clamp_terms(C, "c")
    rspec = {}
    for d in range(scale // 4):
        rspec[f"rv{d}"] = (d, "identity")
    terms.append((gamma, ["acc"]))
    for coeff, factors in recon_terms(C, "c", scale=1 << scale):
        terms.append((Fr.zero() - gamma * coeff, factors))
    for coeff, factors in unsigned_recon_terms(scale // 4, "r"):
        terms.append((Fr.zero() - gamma * coeff, factors))
    return terms, spec, rspec


def _prove_einsum(node, ctx, r, out_claim):
    op = node.operator
    gamma = ctx.transcript.challenge_scalar()
    terms, spec, rspec = _einsum_terms(gamma, op.scale)
    qchunks = ctx.chunks[(node.idx, "ClampRaD")]
    rchunks = ctx.chunks[(node.idx, "RescaleRemainderRaD")]
    polys, specs = build_derived_polys(node.idx, spec, qchunks)
    rpolys, rspecs = build_derived_polys(node.idx, rspec, rchunks)
    polys.update(rpolys)
    specs.extend(rspecs)
    a_in = ctx.trace.node_outputs[node.inputs[0]]
    b_in = ctx.trace.node_outputs[node.inputs[1]]
    acc = padded_flat(FOPS.einsum_acc_i64(op.equation, [a_in, b_in]))
    polys["acc"] = MLPoly(ints=acc)
    specs.append(("acc", acc_opening_id(node.idx)))
    inst = CycleExecutionProver(polys, terms, r, out_claim, specs)
    proof, r_sc = Sumcheck.prove(inst, ctx.accumulator, ctx.transcript)
    ctx.proofs[(node.idx, "Execution")] = proof

    fams = [
        (ChunkFamily(lambda d: CommittedPoly.make("ClampRaD", node.idx, d),
                     MUL_SAT_CHUNKS, qchunks), spec),
        (ChunkFamily(lambda d: CommittedPoly.make("RescaleRemainderRaD", node.idx, d),
                     op.scale // 4, rchunks), rspec),
    ]
    ra_inst = build_ra_checks_provers(node.idx, fams, list(r_sc),
                                      ctx.accumulator, ctx.transcript)
    ra_proof, _ = BatchedSumcheck.prove(ra_inst, ctx.accumulator, ctx.transcript)
    ctx.proofs[(node.idx, "RaChecks")] = ra_proof

    # contraction: acc(r_sc) = sum_{contract} prod operands
    in_dims = [tuple(ctx.node(i).output_dims) for i in node.inputs]
    layout = EinsumLayout(op.equation, in_dims, tuple(node.output_dims))
    out_groups = layout.split_out_point(list(r_sc))
    acc_claim = ctx.accumulator.get_opening(acc_opening_id(node.idx))[1]
    bounds = []
    for i, term in zip(node.inputs, layout.terms):
        arr = ctx.trace.node_outputs[i]
        perm, K, E, points, kept = layout.operand_layout(term, out_groups)
        with profiling.span("einsum_bind"):
            bound = dbind.bind_operand(arr, perm, K, E, points,
                                       _resident(ctx, i))
            bounds.append(MLPoly(fvec=layout.broadcast_bound(bound, kept)))
        telemetry.tally("einsum_bind_elements", arr.size)
    cinst = EinsumContractionProver(node, layout, bounds, acc_claim,
                                    out_groups, list(node.inputs))
    cproof, _ = Sumcheck.prove(cinst, ctx.accumulator, ctx.transcript)
    ctx.proofs[(node.idx, "EinsumMatmul")] = cproof


def _verify_einsum(node, ctx, r, out_claim):
    op = node.operator
    gamma = ctx.transcript.challenge_scalar()
    terms, spec, rspec = _einsum_terms(gamma, op.scale)
    _, specs = _derived_specs(node.idx, spec)
    _, rspecs = _derived_specs(node.idx, rspec)
    specs.extend(rspecs)
    specs.append(("acc", acc_opening_id(node.idx)))
    inst = CycleExecutionVerifier(terms, r, out_claim, specs)
    r_sc = Sumcheck.verify(ctx.proofs[(node.idx, "Execution")], inst,
                           ctx.accumulator, ctx.transcript)
    fams = [
        (ChunkFamily(lambda d: CommittedPoly.make("ClampRaD", node.idx, d),
                     MUL_SAT_CHUNKS, None), spec),
        (ChunkFamily(lambda d: CommittedPoly.make("RescaleRemainderRaD", node.idx, d),
                     op.scale // 4, None), rspec),
    ]
    ra_inst = build_ra_checks_verifiers(node.idx, fams, list(r_sc),
                                        ctx.accumulator, ctx.transcript)
    BatchedSumcheck.verify(ctx.proofs[(node.idx, "RaChecks")], ra_inst,
                           ctx.accumulator, ctx.transcript)

    in_dims = [tuple(ctx.node(i).output_dims) for i in node.inputs]
    layout = EinsumLayout(op.equation, in_dims, tuple(node.output_dims))
    out_groups = layout.split_out_point(list(r_sc))
    acc_claim = ctx.accumulator.get_opening(acc_opening_id(node.idx))[1]
    cinst = EinsumContractionVerifier(node, layout, acc_claim, out_groups,
                                      list(node.inputs))
    Sumcheck.verify(ctx.proofs[(node.idx, "EinsumMatmul")], cinst,
                    ctx.accumulator, ctx.transcript)


# ---------------------------------------------------------------------------
# Sum (axis reduction with saturation; reference ops/sum + SumReduction)
# ---------------------------------------------------------------------------

class SumAxisContractionProver(RowsInstance, SumcheckInstanceProver):
    """claim = sum over summed-axis vars of in(kept at r', summed free)."""

    def __init__(self, node, bound: MLPoly, claim: Fr, in_axes_info, producer):
        self.node = node
        self.claim = claim
        self.in_axes_info = in_axes_info  # list of (is_summed, r_group or var count)
        self.producer = producer
        self._rounds = bound.num_vars
        self.setup_rows([bound], [(Fr.one(), [0])], 1)

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
        pt = _sum_input_point(self.in_axes_info, list(r))
        accumulator.append_virtual(
            transcript, input_opening_id(self.node.idx, 0, self.producer),
            pt, self.row_final(0))


class SumAxisContractionVerifier(SumcheckInstanceVerifier):
    def __init__(self, node, rounds: int, claim: Fr, in_axes_info, producer):
        self.node = node
        self._rounds = rounds
        self.claim = claim
        self.in_axes_info = in_axes_info
        self.producer = producer

    def num_rounds(self):
        return self._rounds

    def degree(self):
        return 1

    def input_claim(self, accumulator):
        return self.claim

    def cache_openings(self, accumulator, transcript, r):
        pt = _sum_input_point(self.in_axes_info, list(r))
        accumulator.append_virtual(
            transcript, input_opening_id(self.node.idx, 0, self.producer), pt)

    def expected_output_claim(self, accumulator, r):
        return accumulator.get_opening(
            input_opening_id(self.node.idx, 0, self.producer))[1]


def _sum_input_point(in_axes_info, r_c):
    pt = []
    i = 0
    for is_summed, payload in in_axes_info:
        if is_summed:
            pt.extend(r_c[i:i + payload])
            i += payload
        else:
            pt.extend(payload)
    assert i == len(r_c)
    return pt


def _sum_terms(gamma: Fr):
    C = MUL_SAT_CHUNKS
    terms, spec = sat_clamp_terms(C, "c")
    terms.append((gamma, ["acc"]))
    for coeff, factors in recon_terms(C, "c"):
        terms.append((Fr.zero() - gamma * coeff, factors))
    return terms, spec


def _sum_axes_setup(node, ctx, r_sc):
    op = node.operator
    in_dims = tuple(ctx.node(node.inputs[0]).output_dims)
    out_groups = split_point(list(r_sc), axis_var_groups(tuple(node.output_dims)))
    info = []
    for ax, d in enumerate(in_dims):
        if ax in op.axes:
            info.append((True, d.bit_length() - 1))
        else:
            info.append((False, out_groups[ax]))
    rounds = sum(p for s, p in info if s)
    return info, rounds, out_groups


def _sum_bound(x: np.ndarray, info):
    """Sum's input bound at the r groups of its kept axes, its summed axes
    flattened in order: the one operand bind (device/bind.py) of x laid
    out (summed, kept)."""
    summed = [ax for ax, (s, _) in enumerate(info) if s]
    kept = [ax for ax, (s, _) in enumerate(info) if not s]
    K, E = (int(np.prod([x.shape[ax] for ax in axes], dtype=np.int64))
            for axes in (summed, kept))
    return dbind.bind_operand(x, tuple(summed + kept), K, E,
                              [p for ax in kept for p in info[ax][1]])


def _prove_sum(node, ctx, r, out_claim):
    op = node.operator
    gamma = ctx.transcript.challenge_scalar()
    terms, spec = _sum_terms(gamma)
    chunks = ctx.chunks[(node.idx, "ClampRaD")]
    polys, specs = build_derived_polys(node.idx, spec, chunks)
    x = ctx.trace.node_outputs[node.inputs[0]]
    acc = padded_flat(np.sum(x.astype(np.int64), axis=tuple(op.axes),
                             keepdims=True))
    polys["acc"] = MLPoly(ints=acc)
    specs.append(("acc", acc_opening_id(node.idx)))
    inst = CycleExecutionProver(polys, terms, r, out_claim, specs)
    proof, r_sc = Sumcheck.prove(inst, ctx.accumulator, ctx.transcript)
    ctx.proofs[(node.idx, "Execution")] = proof
    fam = ChunkFamily(lambda d: CommittedPoly.make("ClampRaD", node.idx, d),
                      MUL_SAT_CHUNKS, chunks)
    ra_inst = build_ra_checks_provers(node.idx, [(fam, spec)], list(r_sc),
                                      ctx.accumulator, ctx.transcript)
    ra_proof, _ = BatchedSumcheck.prove(ra_inst, ctx.accumulator, ctx.transcript)
    ctx.proofs[(node.idx, "RaChecks")] = ra_proof

    info, rounds, out_groups = _sum_axes_setup(node, ctx, r_sc)
    acc_claim = ctx.accumulator.get_opening(acc_opening_id(node.idx))[1]
    cinst = SumAxisContractionProver(node, MLPoly(fvec=_sum_bound(x, info)),
                                     acc_claim, info, node.inputs[0])
    cproof, _ = Sumcheck.prove(cinst, ctx.accumulator, ctx.transcript)
    ctx.proofs[(node.idx, "SumReduction")] = cproof


def _verify_sum(node, ctx, r, out_claim):
    gamma = ctx.transcript.challenge_scalar()
    terms, spec = _sum_terms(gamma)
    _, specs = _derived_specs(node.idx, spec)
    specs.append(("acc", acc_opening_id(node.idx)))
    inst = CycleExecutionVerifier(terms, r, out_claim, specs)
    r_sc = Sumcheck.verify(ctx.proofs[(node.idx, "Execution")], inst,
                           ctx.accumulator, ctx.transcript)
    fam = ChunkFamily(lambda d: CommittedPoly.make("ClampRaD", node.idx, d),
                      MUL_SAT_CHUNKS, None)
    ra_inst = build_ra_checks_verifiers(node.idx, [(fam, spec)], list(r_sc),
                                        ctx.accumulator, ctx.transcript)
    BatchedSumcheck.verify(ctx.proofs[(node.idx, "RaChecks")], ra_inst,
                           ctx.accumulator, ctx.transcript)
    info, rounds, _ = _sum_axes_setup(node, ctx, r_sc)
    acc_claim = ctx.accumulator.get_opening(acc_opening_id(node.idx))[1]
    cinst = SumAxisContractionVerifier(node, rounds, acc_claim, info,
                                       node.inputs[0])
    Sumcheck.verify(ctx.proofs[(node.idx, "SumReduction")], cinst,
                    ctx.accumulator, ctx.transcript)


# ---------------------------------------------------------------------------
# Gather (small dictionaries; reference ops/gather/small.rs)
# ---------------------------------------------------------------------------

class GatherReadRafProver(RowsInstance, SumcheckInstanceProver):
    """out(r) + gamma*idx(r_i) = sum_v G(v) * (dict(v, r_e) + gamma*ident(v))."""

    def __init__(self, node, G: MLPoly, val: MLPoly, dict_bound: MLPoly,
                 claim: Fr, r_i: list[Fr], r_e: list[Fr], dict_producer: int):
        self.node = node
        self.claim = claim
        self.r_i, self.r_e = r_i, r_e
        self.dict_producer = dict_producer
        self._rounds = G.num_vars
        # row 2 (the eq_e-bound dictionary) is outside the terms: it rides
        # the shared binding so its final value is dict(r_v, r_e)
        self.setup_rows([G, val, dict_bound], [(Fr.one(), [0, 1])], 2)

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
        r_v = list(r)
        accumulator.append_committed(
            transcript,
            OpeningId.committed(CommittedPoly.make("GatherRa", self.node.idx),
                               SumcheckId.make("Raf")),
            r_v + self.r_i, self.row_final(0))
        accumulator.append_virtual(
            transcript, input_opening_id(self.node.idx, 0, self.dict_producer),
            r_v + self.r_e, self.row_final(2))


class GatherReadRafVerifier(SumcheckInstanceVerifier):
    def __init__(self, node, log_v: int, gamma: Fr, claim: Fr,
                 r_i, r_e, dict_producer):
        self.node = node
        self.log_v = log_v
        self.gamma = gamma
        self.claim = claim
        self.r_i, self.r_e = r_i, r_e
        self.dict_producer = dict_producer

    def num_rounds(self):
        return self.log_v

    def degree(self):
        return 2

    def input_claim(self, accumulator):
        return self.claim

    def cache_openings(self, accumulator, transcript, r):
        r_v = list(r)
        accumulator.append_committed(
            transcript,
            OpeningId.committed(CommittedPoly.make("GatherRa", self.node.idx),
                               SumcheckId.make("Raf")),
            r_v + self.r_i)
        accumulator.append_virtual(
            transcript, input_opening_id(self.node.idx, 0, self.dict_producer),
            r_v + self.r_e)

    def expected_output_claim(self, accumulator, r):
        ra_claim = accumulator.claim_of(
            OpeningId.committed(CommittedPoly.make("GatherRa", self.node.idx),
                               SumcheckId.make("Raf")))
        dict_claim = accumulator.get_opening(
            input_opening_id(self.node.idx, 0, self.dict_producer))[1]
        ident = Fr.zero()
        for i, ri in enumerate(r):
            ident = ident + ri * Fr(1 << (len(r) - 1 - i))
        return ra_claim * (dict_claim + self.gamma * ident)


def _gather_large_chunks(V: int) -> int:
    return (max(V - 1, 1).bit_length() + 3) // 4


def _gather_large_ra_id(node_idx):
    return OpeningId.virtual(VirtualPoly.make("GatherLargeRa", node_idx),
                             SumcheckId.make("Raf"))


class GatherLargeReadRafProver(GatherReadRafProver):
    """Vocab-scale gather read-raf: the full ra claim is virtual, later
    proven by RaVirtualization over committed 4-bit GatherRaD chunks
    (reference ops/gather/large.rs h-indices decomposition).

    The dictionary is zero-padded from V (pow2) rows to 16^D for the chunk
    address space; its opening is rescaled onto the ORIGINAL constant MLE:
    padded(r_v, r_e) = prod_{extra high vars}(1 - r) * orig(r_v[extra:], r_e).
    """

    def __init__(self, node, G, val, dict_bound, claim, r_i, r_e,
                 dict_producer, extra_vars: int):
        super().__init__(node, G, val, dict_bound, claim, r_i, r_e,
                         dict_producer)
        self.extra_vars = extra_vars

    def cache_openings(self, accumulator, transcript, r):
        r_v = list(r)
        accumulator.append_virtual(
            transcript, _gather_large_ra_id(self.node.idx),
            r_v + self.r_i, self.row_final(0))
        one = Fr.one()
        prefix = one
        for ri in r_v[: self.extra_vars]:
            prefix = prefix * (one - ri)
        accumulator.append_virtual(
            transcript, input_opening_id(self.node.idx, 0, self.dict_producer),
            r_v[self.extra_vars:] + self.r_e,
            self.row_final(2) * prefix.inverse())


class GatherLargeReadRafVerifier(GatherReadRafVerifier):
    def __init__(self, node, log_v, gamma, claim, r_i, r_e, dict_producer,
                 extra_vars: int):
        super().__init__(node, log_v, gamma, claim, r_i, r_e, dict_producer)
        self.extra_vars = extra_vars

    def cache_openings(self, accumulator, transcript, r):
        r_v = list(r)
        accumulator.append_virtual(
            transcript, _gather_large_ra_id(self.node.idx), r_v + self.r_i)
        accumulator.append_virtual(
            transcript, input_opening_id(self.node.idx, 0, self.dict_producer),
            r_v[self.extra_vars:] + self.r_e)

    def expected_output_claim(self, accumulator, r):
        ra_claim = accumulator.get_opening(
            _gather_large_ra_id(self.node.idx))[1]
        dict_claim = accumulator.get_opening(
            input_opening_id(self.node.idx, 0, self.dict_producer))[1]
        one = Fr.one()
        prefix = one
        for ri in list(r)[: self.extra_vars]:
            prefix = prefix * (one - ri)
        ident = Fr.zero()
        for i, ri in enumerate(r):
            ident = ident + ri * Fr(1 << (len(r) - 1 - i))
        return ra_claim * (prefix * dict_claim + self.gamma * ident)


def _resident(ctx, i: int):
    """i where node i is a constant (its operand binds stay on the card,
    device/bind.py), else None."""
    return i if isinstance(ctx.node(i).operator, FOPS.Constant) else None


def _dict_bound(dict_in: np.ndarray, r_e, rows: int, resident=None):
    """Gather's dictionary, each of its V rows bound at r_e over its
    entries by the one operand bind (device/bind.py), zero-extended to
    ``rows`` values."""
    V = dict_in.shape[0]
    E = dict_in.size // V
    bound = dbind.bind_operand(dict_in.reshape(V, E), (0, 1), V, E, r_e,
                               resident)
    if rows == V:
        return bound
    out = vec.zeros(rows)
    out[:V] = bound
    return out


def _prove_gather_large(node, ctx, r, out_claim):
    dict_in = ctx.trace.node_outputs[node.inputs[0]]
    idx_in = padded_flat(ctx.trace.node_outputs[node.inputs[1]]).astype(np.int64)
    V = dict_in.shape[0]
    D = _gather_large_chunks(V)
    Vp = 16 ** D
    n = len(idx_in)
    log_n = n.bit_length() - 1
    r_i, r_e = list(r)[:log_n], list(r)[log_n:]
    gamma = ctx.transcript.challenge_scalar()
    idx_claim = MLPoly(ints=idx_in).evaluate(r_i)
    ctx.accumulator.append_virtual(
        ctx.transcript, input_opening_id(node.idx, 1, node.inputs[1]), r_i,
        idx_claim)
    claim = out_claim + gamma * idx_claim

    eq_i = eq_evals(r_i)
    G = onehot.compute_G(idx_in, eq_i, K=Vp)
    dict_bound = _dict_bound(dict_in, r_e, Vp,
                             _resident(ctx, node.inputs[0]))
    identf = vec.from_ints(np.arange(Vp, dtype=np.int64))
    val = vec.vadd(dict_bound, vec.vscale(identf, gamma))

    log_v = max(V - 1, 1).bit_length()
    inst = GatherLargeReadRafProver(
        node, MLPoly(fvec=G.copy()), MLPoly(fvec=val),
        MLPoly(fvec=dict_bound.copy()), claim, r_i, r_e, node.inputs[0],
        extra_vars=4 * D - log_v)
    proof, _ = Sumcheck.prove(inst, ctx.accumulator, ctx.transcript)
    ctx.proofs[(node.idx, "Execution")] = proof

    # virtual full-ra -> committed chunk product
    ra_pt, ra_claim = ctx.accumulator.get_opening(_gather_large_ra_id(node.idx))
    r_v, r_cyc = ra_pt[: 4 * D], ra_pt[4 * D:]
    gchunks = ctx.chunks[(node.idx, "GatherRaD")]
    rv = onehot.RaVirtualizationProver(
        lambda d: CommittedPoly.make("GatherRaD", node.idx, d), D, gchunks,
        r_v, r_cyc, ra_claim, SumcheckId.make("RaVirtualization"))
    vproof, _ = Sumcheck.prove(rv, ctx.accumulator, ctx.transcript)
    ctx.proofs[(node.idx, "RaVirtual")] = vproof

    fams = [(ChunkFamily(lambda d: CommittedPoly.make("GatherRaD", node.idx, d),
                         D, gchunks), {})]
    ra_inst = build_ra_checks_provers(node.idx, fams, r_i,
                                      ctx.accumulator, ctx.transcript)
    ra_proof, _ = BatchedSumcheck.prove(ra_inst, ctx.accumulator, ctx.transcript)
    ctx.proofs[(node.idx, "RaChecks")] = ra_proof


def _verify_gather_large(node, ctx, r, out_claim):
    V = tuple(ctx.node(node.inputs[0]).output_dims)[0]
    D = _gather_large_chunks(V)
    n = ctx.padded_len(node.inputs[1])
    log_n = n.bit_length() - 1
    r_i, r_e = list(r)[:log_n], list(r)[log_n:]
    gamma = ctx.transcript.challenge_scalar()
    oid_idx = input_opening_id(node.idx, 1, node.inputs[1])
    ctx.accumulator.append_virtual(ctx.transcript, oid_idx, r_i)
    idx_claim = ctx.accumulator.get_opening(oid_idx)[1]
    claim = out_claim + gamma * idx_claim
    log_v = max(V - 1, 1).bit_length()
    inst = GatherLargeReadRafVerifier(node, 4 * D, gamma, claim, r_i, r_e,
                                      node.inputs[0],
                                      extra_vars=4 * D - log_v)
    Sumcheck.verify(ctx.proofs[(node.idx, "Execution")], inst,
                    ctx.accumulator, ctx.transcript)

    ra_pt, ra_claim = ctx.accumulator.get_opening(_gather_large_ra_id(node.idx))
    r_v, r_cyc = ra_pt[: 4 * D], ra_pt[4 * D:]
    rvv = onehot.RaVirtualizationVerifier(
        lambda d: CommittedPoly.make("GatherRaD", node.idx, d), D,
        r_v, r_cyc, ra_claim, SumcheckId.make("RaVirtualization"))
    Sumcheck.verify(ctx.proofs[(node.idx, "RaVirtual")], rvv,
                    ctx.accumulator, ctx.transcript)

    fams = [(ChunkFamily(lambda d: CommittedPoly.make("GatherRaD", node.idx, d),
                         D, None), {})]
    ra_inst = build_ra_checks_verifiers(node.idx, fams, r_i,
                                        ctx.accumulator, ctx.transcript)
    BatchedSumcheck.verify(ctx.proofs[(node.idx, "RaChecks")], ra_inst,
                           ctx.accumulator, ctx.transcript)


def _prove_gather(node, ctx, r, out_claim):
    if isinstance(node.operator, FOPS.GatherLarge):
        return _prove_gather_large(node, ctx, r, out_claim)
    dict_in = ctx.trace.node_outputs[node.inputs[0]]
    idx_in = padded_flat(ctx.trace.node_outputs[node.inputs[1]])
    V = dict_in.shape[0]
    n = len(idx_in)
    log_n = n.bit_length() - 1
    r_i, r_e = list(r)[:log_n], list(r)[log_n:]
    gamma = ctx.transcript.challenge_scalar()
    # idx opening at r_i
    idx_claim = MLPoly(ints=idx_in.astype(np.int64)).evaluate(r_i)
    ctx.accumulator.append_virtual(
        ctx.transcript, input_opening_id(node.idx, 1, node.inputs[1]), r_i,
        idx_claim)
    claim = out_claim + gamma * idx_claim

    eq_i = eq_evals(r_i)
    G = onehot.compute_G(idx_in.astype(np.int64), eq_i, K=V)
    dict_bound = _dict_bound(dict_in, r_e, V,
                             _resident(ctx, node.inputs[0]))
    val = vec.vadd(dict_bound, vec.vscale(
        vec.from_ints(np.arange(V, dtype=np.int64)), gamma))

    inst = GatherReadRafProver(node, MLPoly(fvec=G.copy()),
                               MLPoly(fvec=val),
                               MLPoly(fvec=dict_bound.copy()), claim,
                               r_i, r_e, node.inputs[0])
    proof, r_sc = Sumcheck.prove(inst, ctx.accumulator, ctx.transcript)
    ctx.proofs[(node.idx, "Execution")] = proof

    # one-hot validity for GatherRa: hamming + booleanity over (V, n)
    idx64 = idx_in.astype(np.int64)
    gammas = ctx.transcript.challenge_vector(1)
    log_vn = (V.bit_length() - 1) + (len(idx64).bit_length() - 1)
    r_b = ctx.transcript.challenge_vector_optimized(log_vn)
    pid = CommittedPoly.make("GatherRa", node.idx)
    booleanity = onehot.BooleanityProver([pid], [idx64], V, r_b, gammas)
    reads = onehot.CycleReads(booleanity.idx, r_i, V, G={0: G})
    instances = [booleanity,
                 onehot.AddressReadCheckProver(
                     pid, SumcheckId.make("HammingWeight"), ("onesN", V),
                     reads, 0, Fr.one(), appends_opening=True)]
    ra_proof, _ = BatchedSumcheck.prove(instances, ctx.accumulator,
                                        ctx.transcript)
    ctx.proofs[(node.idx, "RaChecks")] = ra_proof


def _verify_gather(node, ctx, r, out_claim):
    if isinstance(node.operator, FOPS.GatherLarge):
        return _verify_gather_large(node, ctx, r, out_claim)
    dict_dims = tuple(ctx.node(node.inputs[0]).output_dims)
    V = dict_dims[0]
    n = ctx.padded_len(node.inputs[1])
    log_n = n.bit_length() - 1
    r_i, r_e = list(r)[:log_n], list(r)[log_n:]
    gamma = ctx.transcript.challenge_scalar()
    oid_idx = input_opening_id(node.idx, 1, node.inputs[1])
    ctx.accumulator.append_virtual(ctx.transcript, oid_idx, r_i)
    idx_claim = ctx.accumulator.get_opening(oid_idx)[1]
    claim = out_claim + gamma * idx_claim
    inst = GatherReadRafVerifier(node, V.bit_length() - 1, gamma, claim,
                                 r_i, r_e, node.inputs[0])
    r_sc = Sumcheck.verify(ctx.proofs[(node.idx, "Execution")], inst,
                           ctx.accumulator, ctx.transcript)
    gammas = ctx.transcript.challenge_vector(1)
    log_vn = (V.bit_length() - 1) + log_n
    r_b = ctx.transcript.challenge_vector_optimized(log_vn)
    pid = CommittedPoly.make("GatherRa", node.idx)
    instances = [onehot.BooleanityVerifier([pid], r_b, gammas),
                 onehot.AddressReadCheckVerifier(
                     pid, SumcheckId.make("HammingWeight"), ("onesN", V),
                     r_i, Fr.one(), appends_opening=True)]
    BatchedSumcheck.verify(ctx.proofs[(node.idx, "RaChecks")], instances,
                           ctx.accumulator, ctx.transcript)


# ---------------------------------------------------------------------------
# ScalarConstDiv (advice remainder + LT-const range check;
# reference ops/scalar_const_div.rs)
# ---------------------------------------------------------------------------

def _scdiv_chunks(divisor: int) -> int:
    # Sized so the constant D itself fits in C nibbles (D < 16^C): the
    # LT-const decomposition needs D's chunks, not just rem's (rem < D).
    # E.g. D=16 needs 2 chunks even though rem fits in one.
    return max(1, (divisor.bit_length() + 3) // 4)


def _scdiv_terms(gamma: Fr, divisor: int):
    C = _scdiv_chunks(divisor)
    inv_d = Fr(divisor).inverse()
    # out = (x - rem) / D
    terms = [(inv_d, ["x"])]
    spec = {}
    for d in range(C):
        spec[f"sv{d}"] = (d, "identity")
        terms.append((Fr.zero() - inv_d * Fr(1 << (4 * d)), [f"sv{d}"]))
    # gamma * (LT(rem, D) - 1) = 0
    lt_terms, lt_spec = FW.lt_const_terms(C, "s", divisor)
    spec.update({k: v for k, v in lt_spec.items()})
    for coeff, factors in lt_terms:
        terms.append((gamma * coeff, factors))
    terms.append((Fr.zero() - gamma, []))
    return terms, spec


def _prove_scdiv(node, ctx, r, out_claim):
    op = node.operator
    gamma = ctx.transcript.challenge_scalar()
    terms, spec = _scdiv_terms(gamma, op.divisor)
    chunks = ctx.chunks[(node.idx, "ScalarConstDivNodeRemainder")]
    polys, specs = build_derived_polys(node.idx, spec, chunks)
    x = padded_flat(ctx.trace.node_outputs[node.inputs[0]])
    polys["x"] = MLPoly(ints=x.astype(np.int64))
    specs.append(("x", input_opening_id(node.idx, 0, node.inputs[0])))
    inst = CycleExecutionProver(polys, terms, r, out_claim, specs)
    proof, r_sc = Sumcheck.prove(inst, ctx.accumulator, ctx.transcript)
    ctx.proofs[(node.idx, "Execution")] = proof
    fam = ChunkFamily(
        lambda d: CommittedPoly.make("ScalarConstDivNodeRemainder", node.idx, d),
        _scdiv_chunks(op.divisor), chunks)
    ra_inst = build_ra_checks_provers(node.idx, [(fam, spec)], list(r_sc),
                                      ctx.accumulator, ctx.transcript)
    ra_proof, _ = BatchedSumcheck.prove(ra_inst, ctx.accumulator, ctx.transcript)
    ctx.proofs[(node.idx, "RaChecks")] = ra_proof


def _verify_scdiv(node, ctx, r, out_claim):
    op = node.operator
    gamma = ctx.transcript.challenge_scalar()
    terms, spec = _scdiv_terms(gamma, op.divisor)
    _, specs = _derived_specs(node.idx, spec)
    specs.append(("x", input_opening_id(node.idx, 0, node.inputs[0])))
    inst = CycleExecutionVerifier(terms, r, out_claim, specs)
    r_sc = Sumcheck.verify(ctx.proofs[(node.idx, "Execution")], inst,
                           ctx.accumulator, ctx.transcript)
    fam = ChunkFamily(
        lambda d: CommittedPoly.make("ScalarConstDivNodeRemainder", node.idx, d),
        _scdiv_chunks(op.divisor), None)
    ra_inst = build_ra_checks_verifiers(node.idx, [(fam, spec)], list(r_sc),
                                        ctx.accumulator, ctx.transcript)
    BatchedSumcheck.verify(ctx.proofs[(node.idx, "RaChecks")], ra_inst,
                           ctx.accumulator, ctx.transcript)


# ---------------------------------------------------------------------------
# Concat (aligned power-of-two parts), Iff/And (boolean), IsNan
# ---------------------------------------------------------------------------

def _concat_parts(node, ctx, r):
    op = node.operator
    out_dims = tuple(node.output_dims)
    rank = len(out_dims)
    axis = op.axis if op.axis >= 0 else op.axis + rank
    groups = split_point(list(r), axis_var_groups(out_dims))
    nparts = len(node.inputs)
    assert nparts & (nparts - 1) == 0, "concat parts must be a power of two"
    k = nparts.bit_length() - 1
    sel = groups[axis][:k]
    rest_axis = groups[axis][k:]
    points = []
    weights = []
    one = Fr.one()
    for p, src in enumerate(node.inputs):
        w = one
        for i, c in enumerate(sel):
            bit = (p >> (k - 1 - i)) & 1
            w = w * (c if bit else one - c)
        pt = []
        for ax in range(rank):
            if ax == axis:
                pt.extend(rest_axis)
            else:
                pt.extend(groups[ax])
        points.append(pt)
        weights.append(w)
        in_dims = tuple(ctx.node(src).output_dims)
        assert in_dims[axis] == out_dims[axis] // nparts, \
            "concat requires equal power-of-two parts"
    return points, weights


def _prove_concat(node, ctx, r, out_claim):
    points, weights = _concat_parts(node, ctx, r)
    for slot, (src, pt) in enumerate(zip(node.inputs, points)):
        flat = padded_flat(ctx.trace.node_outputs[src])
        claim = MLPoly(ints=flat.astype(np.int64)).evaluate(pt)
        ctx.accumulator.append_virtual(
            ctx.transcript, input_opening_id(node.idx, slot, src), pt, claim)


def _verify_concat(node, ctx, r, out_claim):
    points, weights = _concat_parts(node, ctx, r)
    total = Fr.zero()
    for slot, (src, pt, w) in enumerate(zip(node.inputs, points, weights)):
        oid = input_opening_id(node.idx, slot, src)
        ctx.accumulator.append_virtual(ctx.transcript, oid, pt)
        total = total + w * ctx.accumulator.get_opening(oid)[1]
    if total != out_claim:
        raise VerificationError(f"concat claim mismatch at node {node.idx}")


def _iff_terms(gamma: Fr):
    # out = m*a + b - m*b ; mask booleanity gamma*(m^2 - m)
    return [
        (Fr.one(), ["m", "a"]),
        (Fr.one(), ["b"]),
        (Fr.zero() - Fr.one(), ["m", "b"]),
        (gamma, ["m", "m"]),
        (Fr.zero() - gamma, ["m"]),
    ]


def _prove_iff(node, ctx, r, out_claim):
    gamma = ctx.transcript.challenge_scalar()
    m = padded_flat(ctx.trace.node_outputs[node.inputs[0]])
    a = padded_flat(ctx.trace.node_outputs[node.inputs[1]])
    b = padded_flat(ctx.trace.node_outputs[node.inputs[2]])
    assert set(np.unique(m)) <= {0, 1}, "Iff requires a boolean mask"
    polys = {"m": MLPoly(ints=m.astype(np.int64)),
             "a": MLPoly(ints=a.astype(np.int64)),
             "b": MLPoly(ints=b.astype(np.int64))}
    specs = [(nm, input_opening_id(node.idx, i, node.inputs[i]))
             for i, nm in enumerate(["m", "a", "b"])]
    inst = CycleExecutionProver(polys, _iff_terms(gamma), r, out_claim, specs)
    proof, _ = Sumcheck.prove(inst, ctx.accumulator, ctx.transcript)
    ctx.proofs[(node.idx, "Execution")] = proof


def _verify_iff(node, ctx, r, out_claim):
    gamma = ctx.transcript.challenge_scalar()
    specs = [(nm, input_opening_id(node.idx, i, node.inputs[i]))
             for i, nm in enumerate(["m", "a", "b"])]
    inst = CycleExecutionVerifier(_iff_terms(gamma), r, out_claim, specs)
    Sumcheck.verify(ctx.proofs[(node.idx, "Execution")], inst,
                    ctx.accumulator, ctx.transcript)


def _and_terms(gamma: Fr):
    # boolean inputs: out = a*b; booleanity of both
    return [
        (Fr.one(), ["a", "b"]),
        (gamma, ["a", "a"]), (Fr.zero() - gamma, ["a"]),
        (gamma * gamma, ["b", "b"]), (Fr.zero() - gamma * gamma, ["b"]),
    ]


def _prove_and(node, ctx, r, out_claim):
    gamma = ctx.transcript.challenge_scalar()
    a = padded_flat(ctx.trace.node_outputs[node.inputs[0]])
    b = padded_flat(ctx.trace.node_outputs[node.inputs[1]])
    assert set(np.unique(a)) <= {0, 1} and set(np.unique(b)) <= {0, 1}, \
        "And proof requires boolean operands"
    polys = {"a": MLPoly(ints=a.astype(np.int64)),
             "b": MLPoly(ints=b.astype(np.int64))}
    specs = [(nm, input_opening_id(node.idx, i, node.inputs[i]))
             for i, nm in enumerate(["a", "b"])]
    inst = CycleExecutionProver(polys, _and_terms(gamma), r, out_claim, specs)
    proof, _ = Sumcheck.prove(inst, ctx.accumulator, ctx.transcript)
    ctx.proofs[(node.idx, "Execution")] = proof


def _verify_and(node, ctx, r, out_claim):
    gamma = ctx.transcript.challenge_scalar()
    specs = [(nm, input_opening_id(node.idx, i, node.inputs[i]))
             for i, nm in enumerate(["a", "b"])]
    inst = CycleExecutionVerifier(_and_terms(gamma), r, out_claim, specs)
    Sumcheck.verify(ctx.proofs[(node.idx, "Execution")], inst,
                    ctx.accumulator, ctx.transcript)


def _prove_isnan(node, ctx, r, out_claim):
    pass  # output is identically zero; checked by the verifier


def _verify_isnan(node, ctx, r, out_claim):
    if not out_claim.is_zero():
        raise VerificationError(f"isnan claim nonzero at node {node.idx}")


# ---------------------------------------------------------------------------
# dispatch registration
# ---------------------------------------------------------------------------

_register([FOPS.Identity, FOPS.Reshape], _prove_passthrough, _verify_passthrough)
_register([FOPS.Broadcast], _prove_broadcast, _verify_broadcast)
_register([FOPS.MoveAxis], _prove_moveaxis, _verify_moveaxis)
_register([FOPS.Slice], _prove_slice, _verify_slice)
_register([FOPS.Neg], _prove_neg, _verify_neg)
_register([FOPS.ReLU], _prove_relu, _verify_relu)
_register([FOPS.Add, FOPS.Sub], _prove_addsub, _verify_addsub)
_register([FOPS.Mul, FOPS.Square], _prove_mul, _verify_mul)
_register([FOPS.Einsum], _prove_einsum, _verify_einsum)
_register([FOPS.Sum], _prove_sum, _verify_sum)
_register([FOPS.GatherSmall, FOPS.GatherLarge], _prove_gather, _verify_gather)
_register([FOPS.ScalarConstDiv], _prove_scdiv, _verify_scdiv)
_register([FOPS.Concat], _prove_concat, _verify_concat)
_register([FOPS.Iff], _prove_iff, _verify_iff)
_register([FOPS.And], _prove_and, _verify_and)
_register([FOPS.IsNan], _prove_isnan, _verify_isnan)


# ---------------------------------------------------------------------------
# Neural-teleport activations: Tanh / Erf / Sigmoid (reference
# ops/neural_teleport/): divide by tau, look the i16 quotient up in a 2^16
# activation table via full-table read-raf + ra-virtualization, range-check
# the remainder.
# ---------------------------------------------------------------------------

_ACT_FAMILY = {FOPS.Tanh: ("TanhRaD", "TanhRa"),
               FOPS.Erf: ("ErfRaD", "ErfRa"),
               FOPS.Sigmoid: ("SigmoidRaD", "SigmoidRa")}


def _teleport_table(op) -> np.ndarray:
    from ..frontend import nonlinearities as nl
    from ..frontend.quantize import scale_to_multiplier
    S = scale_to_multiplier(op.scale)
    i = np.arange(1 << 16, dtype=np.int64)
    q = np.where(i >= (1 << 15), i - (1 << 16), i)
    tele = (q * op.tau).astype(np.int64)
    if isinstance(op, FOPS.Tanh):
        lo, hi = -(1 << (op.log_table - 1)), (1 << (op.log_table - 1)) - 1
        return nl.tanh(np.clip(tele, lo, hi).astype(np.int32), S)
    if isinstance(op, FOPS.Erf):
        return nl.erffunc(np.clip(tele, -(2**31), 2**31 - 1).astype(np.int32), S)
    return nl.sigmoid(np.clip(tele, -(2**31), 2**31 - 1).astype(np.int32), S)


def _teleport_rem_chunks(op) -> tuple[int, int]:
    """(num chunks, partial-top bits) for the remainder < tau = 2^(s-7)."""
    nbits = max(op.scale - 7, 1)
    C = max(1, (nbits + 3) // 4)
    return C, nbits % 4


def _u_claim_id(node_idx: int) -> OpeningId:
    return OpeningId.virtual(VirtualPoly.make("TeleportQuotient", node_idx),
                             SumcheckId.make("NodeExecution", node_idx))


def _ra_claim_id(node_idx: int, ra_tag: str) -> OpeningId:
    return OpeningId.virtual(VirtualPoly.make(ra_tag, node_idx),
                             SumcheckId.make("Raf"))


def _teleport_terms(g1: Fr, g2: Fr, g3: Fr, op):
    C_rem, partial = _teleport_rem_chunks(op)
    spec = {}
    for d in range(4):
        spec[f"uv{d}"] = (d, "identity")
    spec["uhi3"] = (3, "msb")
    terms = []
    # g1 * u16recon
    for d in range(4):
        terms.append((g1 * Fr(1 << (4 * d)), [f"uv{d}"]))
    # g2 * (tau*(u16recon - 2^16 uhi3) + remRecon)
    for d in range(4):
        terms.append((g2 * Fr(op.tau * (1 << (4 * d))), [f"uv{d}"]))
    terms.append((Fr.zero() - g2 * Fr(op.tau * (1 << 16)), ["uhi3"]))
    rspec = {}
    for d in range(C_rem):
        rspec[f"rv{d}"] = (d, "identity")
        terms.append((g2 * Fr(1 << (4 * d)), [f"rv{d}"]))
    if partial:
        rspec["rltc"] = (C_rem - 1, ("ltc", 1 << partial))
        terms.append((g3, ["rltc"]))
    return terms, spec, rspec, bool(partial)


def _prove_teleport_act(node, ctx, r, out_claim):
    op = node.operator
    fam_tag, ra_tag = _ACT_FAMILY[type(op)]
    x = padded_flat(ctx.trace.node_outputs[node.inputs[0]]).astype(np.int64)
    q = np.floor_divide(x, op.tau)
    assert (np.abs(q) < (1 << 15)).all(), "teleport quotient exceeds i16"
    u = np.mod(q, 1 << 16)
    ga = ctx.transcript.challenge_scalar()
    g1, g2, g3 = ctx.transcript.challenge_vector(3)
    u_claim = MLPoly(ints=u).evaluate(list(r))
    ctx.accumulator.append_virtual(ctx.transcript, _u_claim_id(node.idx),
                                   list(r), u_claim)
    x_claim = MLPoly(ints=x).evaluate(list(r))
    ctx.accumulator.append_virtual(
        ctx.transcript, input_opening_id(node.idx, 0, node.inputs[0]),
        list(r), x_claim)

    table = _teleport_table(op)
    rr = onehot.ReadRafProver(_ra_claim_id(node.idx, ra_tag), table, u,
                              ga, out_claim + ga * u_claim, list(r))
    terms, spec, rspec, has_ltc = _teleport_terms(g1, g2, g3, op)
    uchunks = ctx.chunks[(node.idx, fam_tag)]
    rchunks = ctx.chunks[(node.idx, "TeleportRangeCheckRaD")]
    polys, specs = build_derived_polys(node.idx, spec, uchunks)
    rpolys, rspecs = build_derived_polys(node.idx, rspec, rchunks)
    polys.update(rpolys)
    specs.extend(rspecs)
    cyc_claim = g1 * u_claim + g2 * x_claim + (g3 if has_ltc else Fr.zero())
    cyc = CycleExecutionProver(polys, terms, list(r), cyc_claim, specs)
    proof, r_batch = BatchedSumcheck.prove([rr, cyc], ctx.accumulator,
                                           ctx.transcript)
    ctx.proofs[(node.idx, "Execution")] = proof
    r_sc = list(r_batch)[-len(r):] if r else []

    # ra virtualization: ra claim at (r_k(16), r)
    ra_pt, ra_claim = ctx.accumulator.get_opening(_ra_claim_id(node.idx, ra_tag))
    r_addr, r_cyc = ra_pt[:16], ra_pt[16:]
    rv = onehot.RaVirtualizationProver(
        lambda d: CommittedPoly.make(fam_tag, node.idx, d), 4, uchunks,
        r_addr, r_cyc, ra_claim, SumcheckId.make("RaVirtualization"))
    vproof, _ = Sumcheck.prove(rv, ctx.accumulator, ctx.transcript)
    ctx.proofs[(node.idx, "RaVirtual")] = vproof

    C_rem, _ = _teleport_rem_chunks(op)
    fams = [
        (ChunkFamily(lambda d: CommittedPoly.make(fam_tag, node.idx, d),
                     4, uchunks), spec),
        (ChunkFamily(lambda d: CommittedPoly.make("TeleportRangeCheckRaD",
                                                  node.idx, d),
                     C_rem, rchunks), rspec),
    ]
    ra_inst = build_ra_checks_provers(node.idx, fams, r_sc,
                                      ctx.accumulator, ctx.transcript)
    ra_proof, _ = BatchedSumcheck.prove(ra_inst, ctx.accumulator, ctx.transcript)
    ctx.proofs[(node.idx, "RaChecks")] = ra_proof


def _verify_teleport_act(node, ctx, r, out_claim):
    op = node.operator
    fam_tag, ra_tag = _ACT_FAMILY[type(op)]
    ga = ctx.transcript.challenge_scalar()
    g1, g2, g3 = ctx.transcript.challenge_vector(3)
    ctx.accumulator.append_virtual(ctx.transcript, _u_claim_id(node.idx), list(r))
    u_claim = ctx.accumulator.get_opening(_u_claim_id(node.idx))[1]
    oid_x = input_opening_id(node.idx, 0, node.inputs[0])
    ctx.accumulator.append_virtual(ctx.transcript, oid_x, list(r))
    x_claim = ctx.accumulator.get_opening(oid_x)[1]

    table = _teleport_table(op)
    rr = onehot.ReadRafVerifier(_ra_claim_id(node.idx, ra_tag), table, ga,
                                out_claim + ga * u_claim, list(r))
    terms, spec, rspec, has_ltc = _teleport_terms(g1, g2, g3, op)
    _, specs = _derived_specs(node.idx, spec)
    _, rspecs = _derived_specs(node.idx, rspec)
    specs.extend(rspecs)
    cyc_claim = g1 * u_claim + g2 * x_claim + (g3 if has_ltc else Fr.zero())
    cyc = CycleExecutionVerifier(terms, list(r), cyc_claim, specs)
    BatchedSumcheck.verify(ctx.proofs[(node.idx, "Execution")], [rr, cyc],
                           ctx.accumulator, ctx.transcript)
    ra_pt, ra_claim = ctx.accumulator.get_opening(_ra_claim_id(node.idx, ra_tag))
    r_addr, r_cyc = ra_pt[:16], ra_pt[16:]
    rv = onehot.RaVirtualizationVerifier(
        lambda d: CommittedPoly.make(fam_tag, node.idx, d), 4,
        r_addr, r_cyc, ra_claim, SumcheckId.make("RaVirtualization"))
    Sumcheck.verify(ctx.proofs[(node.idx, "RaVirtual")], rv,
                    ctx.accumulator, ctx.transcript)
    C_rem, _ = _teleport_rem_chunks(op)
    # r_sc = tail of the Execution batch challenges = cycle point of cyc
    # (recover from any derived-claim opening point)
    any_name = sorted(spec)[0]
    r_sc = ctx.accumulator.get_opening(
        FW.derived_claim_id(node.idx, any_name))[0]
    fams = [
        (ChunkFamily(lambda d: CommittedPoly.make(fam_tag, node.idx, d),
                     4, None), spec),
        (ChunkFamily(lambda d: CommittedPoly.make("TeleportRangeCheckRaD",
                                                  node.idx, d),
                     C_rem, None), rspec),
    ]
    ra_inst = build_ra_checks_verifiers(node.idx, fams, list(r_sc),
                                        ctx.accumulator, ctx.transcript)
    BatchedSumcheck.verify(ctx.proofs[(node.idx, "RaChecks")], ra_inst,
                           ctx.accumulator, ctx.transcript)


# ---------------------------------------------------------------------------
# Sin / Cos: periodicity teleport (x mod 4*pi approx), lookup of the
# remainder in a 4096-entry trig table (reference neural_teleport/{sin,cos}.rs)
# ---------------------------------------------------------------------------

_TRIG_FAMILY = {FOPS.Sin: ("SinRaD", "SinRa"), FOPS.Cos: ("CosRaD", "CosRa")}
_TRIG_K = 4096  # padded table for remainders mod FOUR_PI_APPROX = 3217


def _trig_table(op) -> np.ndarray:
    from ..frontend import nonlinearities as nl
    from ..frontend.quantize import scale_to_multiplier
    S = scale_to_multiplier(op.scale)
    i = np.arange(_TRIG_K, dtype=np.int32)
    return nl.sin(i, S) if isinstance(op, FOPS.Sin) else nl.cos(i, S)


def _trig_terms(g1: Fr, g2: Fr, g3: Fr):
    spec = {}
    terms = []
    for d in range(3):
        spec[f"rv{d}"] = (d, "identity")
        terms.append(((g1 + g2) * Fr(1 << (4 * d)), [f"rv{d}"]))
    terms.append((g2 * Fr(FOPS.FOUR_PI_APPROX), ["q"]))
    lt_terms, lt_spec = FW.lt_const_terms(3, "L", FOPS.FOUR_PI_APPROX)
    spec.update(lt_spec)
    for coeff, factors in lt_terms:
        terms.append((g3 * coeff, factors))
    return terms, spec


def _prove_trig(node, ctx, r, out_claim):
    op = node.operator
    fam_tag, ra_tag = _TRIG_FAMILY[type(op)]
    x = padded_flat(ctx.trace.node_outputs[node.inputs[0]]).astype(np.int64)
    rem = np.mod(x, FOPS.FOUR_PI_APPROX)
    q = (x - rem) // FOPS.FOUR_PI_APPROX
    ga = ctx.transcript.challenge_scalar()
    g1, g2, g3 = ctx.transcript.challenge_vector(3)
    u_claim = MLPoly(ints=rem).evaluate(list(r))
    ctx.accumulator.append_virtual(ctx.transcript, _u_claim_id(node.idx),
                                   list(r), u_claim)
    x_claim = MLPoly(ints=x).evaluate(list(r))
    ctx.accumulator.append_virtual(
        ctx.transcript, input_opening_id(node.idx, 0, node.inputs[0]),
        list(r), x_claim)
    table = _trig_table(op)
    rr = onehot.ReadRafProver(_ra_claim_id(node.idx, ra_tag), table, rem,
                              ga, out_claim + ga * u_claim, list(r))
    terms, spec = _trig_terms(g1, g2, g3)
    rchunks = ctx.chunks[(node.idx, fam_tag)]
    polys, specs = build_derived_polys(node.idx, spec, rchunks)
    polys["q"] = MLPoly(ints=q)
    specs.append(("q", OpeningId.committed(
        CommittedPoly.make("TeleportNodeQuotient", node.idx),
        SumcheckId.make("NodeExecution", node.idx))))
    cyc_claim = g1 * u_claim + g2 * x_claim + g3
    cyc = CycleExecutionProver(polys, terms, list(r), cyc_claim, specs)
    proof, r_batch = BatchedSumcheck.prove([rr, cyc], ctx.accumulator,
                                           ctx.transcript)
    ctx.proofs[(node.idx, "Execution")] = proof
    r_sc = list(r_batch)[-len(r):] if r else []

    ra_pt, ra_claim = ctx.accumulator.get_opening(_ra_claim_id(node.idx, ra_tag))
    r_addr, r_cyc = ra_pt[:12], ra_pt[12:]
    rv = onehot.RaVirtualizationProver(
        lambda d: CommittedPoly.make(fam_tag, node.idx, d), 3, rchunks,
        r_addr, r_cyc, ra_claim, SumcheckId.make("RaVirtualization"))
    vproof, _ = Sumcheck.prove(rv, ctx.accumulator, ctx.transcript)
    ctx.proofs[(node.idx, "RaVirtual")] = vproof

    fams = [(ChunkFamily(lambda d: CommittedPoly.make(fam_tag, node.idx, d),
                         3, rchunks), spec)]
    ra_inst = build_ra_checks_provers(node.idx, fams, r_sc,
                                      ctx.accumulator, ctx.transcript)
    ra_proof, _ = BatchedSumcheck.prove(ra_inst, ctx.accumulator, ctx.transcript)
    ctx.proofs[(node.idx, "RaChecks")] = ra_proof


def _verify_trig(node, ctx, r, out_claim):
    op = node.operator
    fam_tag, ra_tag = _TRIG_FAMILY[type(op)]
    ga = ctx.transcript.challenge_scalar()
    g1, g2, g3 = ctx.transcript.challenge_vector(3)
    ctx.accumulator.append_virtual(ctx.transcript, _u_claim_id(node.idx), list(r))
    u_claim = ctx.accumulator.get_opening(_u_claim_id(node.idx))[1]
    oid_x = input_opening_id(node.idx, 0, node.inputs[0])
    ctx.accumulator.append_virtual(ctx.transcript, oid_x, list(r))
    x_claim = ctx.accumulator.get_opening(oid_x)[1]
    table = _trig_table(op)
    rr = onehot.ReadRafVerifier(_ra_claim_id(node.idx, ra_tag), table, ga,
                                out_claim + ga * u_claim, list(r))
    terms, spec = _trig_terms(g1, g2, g3)
    _, specs = _derived_specs(node.idx, spec)
    specs.append(("q", OpeningId.committed(
        CommittedPoly.make("TeleportNodeQuotient", node.idx),
        SumcheckId.make("NodeExecution", node.idx))))
    cyc_claim = g1 * u_claim + g2 * x_claim + g3
    cyc = CycleExecutionVerifier(terms, list(r), cyc_claim, specs)
    BatchedSumcheck.verify(ctx.proofs[(node.idx, "Execution")], [rr, cyc],
                           ctx.accumulator, ctx.transcript)
    ra_pt, ra_claim = ctx.accumulator.get_opening(_ra_claim_id(node.idx, ra_tag))
    r_addr, r_cyc = ra_pt[:12], ra_pt[12:]
    rv = onehot.RaVirtualizationVerifier(
        lambda d: CommittedPoly.make(fam_tag, node.idx, d), 3,
        r_addr, r_cyc, ra_claim, SumcheckId.make("RaVirtualization"))
    Sumcheck.verify(ctx.proofs[(node.idx, "RaVirtual")], rv,
                    ctx.accumulator, ctx.transcript)
    any_name = sorted(spec)[0]
    r_sc = ctx.accumulator.get_opening(
        FW.derived_claim_id(node.idx, any_name))[0]
    fams = [(ChunkFamily(lambda d: CommittedPoly.make(fam_tag, node.idx, d),
                         3, None), spec)]
    ra_inst = build_ra_checks_verifiers(node.idx, fams, list(r_sc),
                                        ctx.accumulator, ctx.transcript)
    BatchedSumcheck.verify(ctx.proofs[(node.idx, "RaChecks")], ra_inst,
                           ctx.accumulator, ctx.transcript)


_register([FOPS.Tanh, FOPS.Erf, FOPS.Sigmoid],
          _prove_teleport_act, _verify_teleport_act)
_register([FOPS.Sin, FOPS.Cos], _prove_trig, _verify_trig)


# ---------------------------------------------------------------------------
# Clamp (last-axis spread clamp: out = max(x, max_slice - C); reference
# ops/clamp.rs is a TODO passthrough that forwards the operand claim without
# proving the relation — this implementation proves it fully: committed 0/1
# side indicator b, range-checked side distance u and dominance z = max - x,
# plus a MaxCheck binding the public per-slice max advice to the input)
# ---------------------------------------------------------------------------

def _clamp_pieces(op, x):
    C = int(op.max_spread)
    flat = padded_flat(x).astype(np.int64)
    if x.ndim == 1:
        x2 = flat.reshape(1, -1)
    else:
        N = x.shape[-1]
        assert N & (N - 1) == 0, "Clamp proof needs pow2 last axis"
        x2 = flat.reshape(-1, N)
    F_n, N = x2.shape
    max_k = x2.max(axis=1)
    argmax_k = x2.argmax(axis=1)
    thr = max_k[:, None] - C
    b = (x2 >= thr).astype(np.int64)
    u = np.where(b == 1, x2 - thr, thr - x2 - 1)
    z = max_k[:, None] - x2
    return C, x2, F_n, N, max_k, argmax_k, b, u, z


def _clamp_terms(g: list[Fr], C: int, cu: int = 8, cz: int = 8):
    """out = b*x + (1-b)*(m-C);  g0*(x - m + C - (2b-1)u - b + 1) = 0;
    g1*(m - x - z) = 0;  g2*(b^2 - b) = 0."""
    uspec = {f"u{d}": (d, "identity") for d in range(cu)}
    zspec = {f"z{d}": (d, "identity") for d in range(cz)}
    one = Fr.one()
    g0, g1, g2 = g
    terms = [
        (one, ["b", "x"]), (one, ["m"]), (Fr.zero() - Fr(C), []),
        (Fr.zero() - one, ["b", "m"]), (Fr(C), ["b"]),
        (g0, ["x"]), (Fr.zero() - g0, ["m"]), (g0 * Fr(C + 1), []),
        (Fr.zero() - g0, ["b"]),
        (g1, ["m"]), (Fr.zero() - g1, ["x"]),
        (g2, ["b", "b"]), (Fr.zero() - g2, ["b"]),
    ]
    for d in range(cu):
        c = Fr(1 << (4 * d))
        terms.append((g0 * c, [f"u{d}"]))
        terms.append((Fr.zero() - g0 * Fr(2) * c, ["b", f"u{d}"]))
    for d in range(cz):
        terms.append((Fr.zero() - g1 * Fr(1 << (4 * d)), [f"z{d}"]))
    return terms, uspec, zspec


def _clamp_b_id(node_idx):
    return OpeningId.committed(
        CommittedPoly.make("ClampIndicator", node_idx),
        SumcheckId.make("NodeExecution", node_idx))


def _prove_clamp(node, ctx, r, out_claim):
    op = node.operator
    x_arr = ctx.trace.node_outputs[node.inputs[0]]
    C, x2, F_n, N, max_k, argmax_k, b, u, z = _clamp_pieces(op, x_arr)
    for name, arr in (("clamp_max_k", max_k), ("clamp_argmax_k", argmax_k)):
        ctx.transcript.append_bytes(np.asarray(arr, dtype="<i4").tobytes())
        ctx.aux[(node.idx, name)] = np.asarray(arr, dtype=np.int32)
    g = ctx.transcript.challenge_vector(3)
    terms, uspec, zspec = _clamp_terms(g, C)
    uchunks = ctx.chunks[(node.idx, "ClampSpreadRaD")]
    zchunks = ctx.chunks[(node.idx, "ClampMaxDiffRaD")]
    polys, specs = build_derived_polys(node.idx, uspec, uchunks)
    zp, zs = build_derived_polys(node.idx, zspec, zchunks)
    polys.update(zp)
    specs.extend(zs)
    polys["x"] = MLPoly(ints=x2.reshape(-1))
    specs.append(("x", input_opening_id(node.idx, 0, node.inputs[0])))
    polys["b"] = MLPoly(ints=b.reshape(-1))
    specs.append(("b", _clamp_b_id(node.idx)))
    polys["m"] = MLPoly(ints=np.repeat(max_k, N))  # public broadcast advice
    inst = CycleExecutionProver(polys, terms, r, out_claim, specs)
    proof, r_sc = Sumcheck.prove(inst, ctx.accumulator, ctx.transcript)
    ctx.proofs[(node.idx, "Execution")] = proof

    fams = [
        (ChunkFamily(lambda d: CommittedPoly.make("ClampSpreadRaD", node.idx, d),
                     8, uchunks), uspec),
        (ChunkFamily(lambda d: CommittedPoly.make("ClampMaxDiffRaD", node.idx, d),
                     8, zchunks), zspec),
    ]
    ra_inst = build_ra_checks_provers(node.idx, fams, list(r_sc),
                                      ctx.accumulator, ctx.transcript)
    ra_proof, _ = BatchedSumcheck.prove(ra_inst, ctx.accumulator, ctx.transcript)
    ctx.proofs[(node.idx, "RaChecks")] = ra_proof

    # bind the public max advice to the input: max(r_k2) = sum eq*argind*x
    log_f = F_n.bit_length() - 1
    r_k2 = ctx.transcript.challenge_vector_optimized(log_f)
    max_claim = MLPoly(ints=max_k).evaluate(list(r_k2))
    argind = np.zeros((F_n, N), dtype=np.int64)
    argind[np.arange(F_n), argmax_k] = 1
    eq_k2 = vec.as_object(eq_evals(list(r_k2)))
    P_pub = (argind.astype(object) * eq_k2[:, None]) % vec.R
    from .softmax_op import MaxCheckProver
    mc = MaxCheckProver(node.idx, MLPoly(fvec=P_pub.reshape(-1)),
                        MLPoly(ints=x2.reshape(-1)), max_claim, 1,
                        node.inputs[0])
    mcproof, _ = Sumcheck.prove(mc, ctx.accumulator, ctx.transcript)
    ctx.proofs[(node.idx, "MaxCheck")] = mcproof


def _verify_clamp(node, ctx, r, out_claim):
    op = node.operator
    in_dims = tuple(ctx.node(node.inputs[0]).output_dims)
    N = in_dims[-1] if len(in_dims) > 1 else ctx.padded_len(node.inputs[0])
    F_n = max(1, int(np.prod(in_dims[:-1]))) if len(in_dims) > 1 else 1
    C = int(op.max_spread)
    max_k = np.asarray(ctx.aux[(node.idx, "clamp_max_k")], dtype=np.int32)
    argmax_k = np.asarray(ctx.aux[(node.idx, "clamp_argmax_k")], dtype=np.int32)
    if max_k.shape != (F_n,) or argmax_k.shape != (F_n,):
        raise VerificationError("clamp aux shape mismatch")
    if not ((argmax_k >= 0) & (argmax_k < N)).all():
        raise VerificationError("clamp argmax out of range")
    for name, arr in (("clamp_max_k", max_k), ("clamp_argmax_k", argmax_k)):
        ctx.transcript.append_bytes(arr.astype("<i4").tobytes())
    g = ctx.transcript.challenge_vector(3)
    terms, uspec, zspec = _clamp_terms(g, C)
    _, specs = _derived_specs(node.idx, uspec)
    _, zs = _derived_specs(node.idx, zspec)
    specs.extend(zs)
    specs.append(("x", input_opening_id(node.idx, 0, node.inputs[0])))
    specs.append(("b", _clamp_b_id(node.idx)))
    maxb = np.repeat(max_k.astype(np.int64), N)
    public_evals = {"m": lambda rr: MLPoly(ints=maxb).evaluate(rr)}
    inst = CycleExecutionVerifier(terms, list(r), out_claim, specs,
                                  public_evals=public_evals)
    r_sc = Sumcheck.verify(ctx.proofs[(node.idx, "Execution")], inst,
                           ctx.accumulator, ctx.transcript)
    fams = [
        (ChunkFamily(lambda d: CommittedPoly.make("ClampSpreadRaD", node.idx, d),
                     8, None), uspec),
        (ChunkFamily(lambda d: CommittedPoly.make("ClampMaxDiffRaD", node.idx, d),
                     8, None), zspec),
    ]
    ra_inst = build_ra_checks_verifiers(node.idx, fams, list(r_sc),
                                        ctx.accumulator, ctx.transcript)
    BatchedSumcheck.verify(ctx.proofs[(node.idx, "RaChecks")], ra_inst,
                           ctx.accumulator, ctx.transcript)

    log_f = F_n.bit_length() - 1
    r_k2 = ctx.transcript.challenge_vector_optimized(log_f)
    max_claim = MLPoly(ints=max_k.astype(np.int64)).evaluate(list(r_k2))
    argind = np.zeros((F_n, N), dtype=np.int64)
    argind[np.arange(F_n), argmax_k] = 1
    eq_k2 = vec.as_object(eq_evals(list(r_k2)))
    P_pub = (argind.astype(object) * eq_k2[:, None]) % vec.R
    from .softmax_op import MaxCheckVerifier
    mcv = MaxCheckVerifier(node.idx, (F_n * N).bit_length() - 1, max_claim,
                           1, node.inputs[0], P_pub.reshape(-1))
    Sumcheck.verify(ctx.proofs[(node.idx, "MaxCheck")], mcv,
                    ctx.accumulator, ctx.transcript)


_register([FOPS.Clamp], _prove_clamp, _verify_clamp)


# ---------------------------------------------------------------------------
# MeanOfSquares (fused sum-of-squares + divide by N*2^S; reference
# ops/mean_of_squares.rs) and Cube
# ---------------------------------------------------------------------------

class MoSAxisContractionProver(RowsInstance, SumcheckInstanceProver):
    """acc(r') = sum_{full input domain} W(j) * x(j)^2, where W is the eq
    weight over the kept axes broadcast along the summed axes (kept axes
    must stay inside the nonlinear sum)."""

    def __init__(self, node, W: MLPoly, x: MLPoly, claim: Fr, in_axes_info,
                 producer):
        self.node = node
        self.claim = claim
        self.in_axes_info = in_axes_info
        self.producer = producer
        self._rounds = x.num_vars
        self.setup_rows([W, x], [(Fr.one(), [0, 1, 1])], 3)

    def num_rounds(self):
        return self._rounds

    def degree(self):
        return 3

    def input_claim(self, accumulator):
        return self.claim

    def compute_message(self, round, previous_claim):
        return self.rows_message(previous_claim)

    def ingest_challenge(self, r, round):
        self.rows_bind(r)

    def cache_openings(self, accumulator, transcript, r):
        accumulator.append_virtual(
            transcript, input_opening_id(self.node.idx, 0, self.producer),
            list(r), self.row_final(1))


class MoSAxisContractionVerifier(SumcheckInstanceVerifier):
    def __init__(self, node, rounds, claim, in_axes_info, producer):
        self.node = node
        self._rounds = rounds
        self.claim = claim
        self.in_axes_info = in_axes_info
        self.producer = producer

    def num_rounds(self):
        return self._rounds

    def degree(self):
        return 3

    def input_claim(self, accumulator):
        return self.claim

    def cache_openings(self, accumulator, transcript, r):
        accumulator.append_virtual(
            transcript, input_opening_id(self.node.idx, 0, self.producer),
            list(r))

    def expected_output_claim(self, accumulator, r):
        from ..poly.eq import eq_eval_scalar
        c = accumulator.get_opening(
            input_opening_id(self.node.idx, 0, self.producer))[1]
        # W MLE at r = prod over kept axes eq(r_group, r_slice)
        w = Fr.one()
        i = 0
        for is_summed, payload in self.in_axes_info:
            if is_summed:
                i += payload
            else:
                nv = len(payload)
                w = w * eq_eval_scalar(payload, list(r)[i:i + nv])
                i += nv
        return w * c * c


def _mos_rem_chunks(op) -> int:
    # Like _scdiv_chunks: C must make the divisor D representable (D < 16^C)
    # for the LT-const check, so power-of-16 divisors get an extra chunk.
    bits = op.divisor().bit_length()
    return max(1, (bits + 3) // 4)


def _mos_terms(g1: Fr, g2: Fr, op):
    C = MUL_SAT_CHUNKS
    D = op.divisor()
    terms, spec = sat_clamp_terms(C, "c")
    C_rem = _mos_rem_chunks(op)
    rspec = {}
    # g1 * (acc - q_recon*D - rem_recon)
    terms.append((g1, ["acc"]))
    for coeff, factors in recon_terms(C, "c", scale=D):
        terms.append((Fr.zero() - g1 * coeff, factors))
    for d in range(C_rem):
        rspec[f"rv{d}"] = (d, "identity")
        terms.append((Fr.zero() - g1 * Fr(1 << (4 * d)), [f"rv{d}"]))
    # g2 * (LT(rem, D) - 1)
    lt_terms, lt_spec = FW.lt_const_terms(C_rem, "L", D)
    rspec.update(lt_spec)
    for coeff, factors in lt_terms:
        terms.append((g2 * coeff, factors))
    terms.append((Fr.zero() - g2, []))
    return terms, spec, rspec


def _prove_mos(node, ctx, r, out_claim):
    op = node.operator
    g1, g2 = ctx.transcript.challenge_vector(2)
    terms, spec, rspec = _mos_terms(g1, g2, op)
    qchunks = ctx.chunks[(node.idx, "ClampRaD")]
    rchunks = ctx.chunks[(node.idx, "MeanOfSquaresRangeCheckRaD")]
    polys, specs = build_derived_polys(node.idx, spec, qchunks)
    rpolys, rspecs = build_derived_polys(node.idx, rspec, rchunks)
    polys.update(rpolys)
    specs.extend(rspecs)
    x = ctx.trace.node_outputs[node.inputs[0]]
    acc = padded_flat(op.acc_i64(x))
    polys["acc"] = MLPoly(ints=acc)
    specs.append(("acc", acc_opening_id(node.idx)))
    inst = CycleExecutionProver(polys, terms, r, out_claim, specs)
    proof, r_sc = Sumcheck.prove(inst, ctx.accumulator, ctx.transcript)
    ctx.proofs[(node.idx, "Execution")] = proof
    fams = [
        (ChunkFamily(lambda d: CommittedPoly.make("ClampRaD", node.idx, d),
                     MUL_SAT_CHUNKS, qchunks), spec),
        (ChunkFamily(lambda d: CommittedPoly.make("MeanOfSquaresRangeCheckRaD",
                                                  node.idx, d),
                     _mos_rem_chunks(op), rchunks), rspec),
    ]
    ra_inst = build_ra_checks_provers(node.idx, fams, list(r_sc),
                                      ctx.accumulator, ctx.transcript)
    ra_proof, _ = BatchedSumcheck.prove(ra_inst, ctx.accumulator, ctx.transcript)
    ctx.proofs[(node.idx, "RaChecks")] = ra_proof

    # acc(r_sc) = sum of squares over axes
    op_axes = FOPS.Sum(axes=op.axes)
    node_like = node
    info, rounds, _ = _sum_axes_setup_generic(node, ctx, r_sc, op.axes)
    acc_claim = ctx.accumulator.get_opening(acc_opening_id(node.idx))[1]
    # W = eq over kept axes, ones over summed axes, in input axis order
    w_axes = []
    for is_summed, payload in info:
        if is_summed:
            w_axes.append(np.ones(1 << payload, dtype=object))
        else:
            w_axes.append(vec.as_object(eq_evals(payload)))
    W = w_axes[0]
    for ax_v in w_axes[1:]:
        W = np.multiply.outer(W, ax_v) % vec.R
    cinst = MoSAxisContractionProver(
        node, MLPoly(fvec=W.reshape(-1)),
        MLPoly(ints=padded_flat(x).astype(np.int64)), acc_claim, info,
        node.inputs[0])
    cproof, _ = Sumcheck.prove(cinst, ctx.accumulator, ctx.transcript)
    ctx.proofs[(node.idx, "SumReduction")] = cproof


def _sum_axes_setup_generic(node, ctx, r_sc, axes):
    in_dims = tuple(ctx.node(node.inputs[0]).output_dims)
    out_groups = split_point(list(r_sc), axis_var_groups(tuple(node.output_dims)))
    info = []
    for ax, d in enumerate(in_dims):
        if ax in axes:
            info.append((True, d.bit_length() - 1))
        else:
            info.append((False, out_groups[ax]))
    rounds = sum(p for s_, p in info if s_)
    return info, rounds, out_groups


def _verify_mos(node, ctx, r, out_claim):
    op = node.operator
    g1, g2 = ctx.transcript.challenge_vector(2)
    terms, spec, rspec = _mos_terms(g1, g2, op)
    _, specs = _derived_specs(node.idx, spec)
    _, rspecs = _derived_specs(node.idx, rspec)
    specs.extend(rspecs)
    specs.append(("acc", acc_opening_id(node.idx)))
    inst = CycleExecutionVerifier(terms, r, out_claim, specs)
    r_sc = Sumcheck.verify(ctx.proofs[(node.idx, "Execution")], inst,
                           ctx.accumulator, ctx.transcript)
    fams = [
        (ChunkFamily(lambda d: CommittedPoly.make("ClampRaD", node.idx, d),
                     MUL_SAT_CHUNKS, None), spec),
        (ChunkFamily(lambda d: CommittedPoly.make("MeanOfSquaresRangeCheckRaD",
                                                  node.idx, d),
                     _mos_rem_chunks(op), None), rspec),
    ]
    ra_inst = build_ra_checks_verifiers(node.idx, fams, list(r_sc),
                                        ctx.accumulator, ctx.transcript)
    BatchedSumcheck.verify(ctx.proofs[(node.idx, "RaChecks")], ra_inst,
                           ctx.accumulator, ctx.transcript)
    info, rounds, _ = _sum_axes_setup_generic(node, ctx, r_sc, node.operator.axes)
    acc_claim = ctx.accumulator.get_opening(acc_opening_id(node.idx))[1]
    full_rounds = ctx.padded_len(node.inputs[0]).bit_length() - 1
    cinst = MoSAxisContractionVerifier(node, full_rounds, acc_claim, info,
                                       node.inputs[0])
    Sumcheck.verify(ctx.proofs[(node.idx, "SumReduction")], cinst,
                    ctx.accumulator, ctx.transcript)


def _cube_terms(gamma: Fr, scale: int):
    C = MUL_SAT_CHUNKS
    bits = 2 * scale
    terms, spec = sat_clamp_terms(C, "c")
    rspec = {}
    for d in range(bits // 4):
        rspec[f"rv{d}"] = (d, "identity")
    terms.append((gamma, ["a", "a", "a"]))
    for coeff, factors in recon_terms(C, "c", scale=1 << bits):
        terms.append((Fr.zero() - gamma * coeff, factors))
    for coeff, factors in unsigned_recon_terms(bits // 4, "r"):
        terms.append((Fr.zero() - gamma * coeff, factors))
    return terms, spec, rspec


def _prove_cube(node, ctx, r, out_claim):
    op = node.operator
    gamma = ctx.transcript.challenge_scalar()
    terms, spec, rspec = _cube_terms(gamma, op.scale)
    qchunks = ctx.chunks[(node.idx, "ClampRaD")]
    rchunks = ctx.chunks[(node.idx, "RescaleRemainderRaD")]
    polys, specs = build_derived_polys(node.idx, spec, qchunks)
    rpolys, rspecs = build_derived_polys(node.idx, rspec, rchunks)
    polys.update(rpolys)
    specs.extend(rspecs)
    a = padded_flat(ctx.trace.node_outputs[node.inputs[0]])
    polys["a"] = MLPoly(ints=a.astype(np.int64))
    specs.append(("a", input_opening_id(node.idx, 0, node.inputs[0])))
    inst = CycleExecutionProver(polys, terms, r, out_claim, specs)
    proof, r_sc = Sumcheck.prove(inst, ctx.accumulator, ctx.transcript)
    ctx.proofs[(node.idx, "Execution")] = proof
    fams = [
        (ChunkFamily(lambda d: CommittedPoly.make("ClampRaD", node.idx, d),
                     MUL_SAT_CHUNKS, qchunks), spec),
        (ChunkFamily(lambda d: CommittedPoly.make("RescaleRemainderRaD",
                                                  node.idx, d),
                     (2 * op.scale) // 4, rchunks), rspec),
    ]
    ra_inst = build_ra_checks_provers(node.idx, fams, list(r_sc),
                                      ctx.accumulator, ctx.transcript)
    ra_proof, _ = BatchedSumcheck.prove(ra_inst, ctx.accumulator, ctx.transcript)
    ctx.proofs[(node.idx, "RaChecks")] = ra_proof


def _verify_cube(node, ctx, r, out_claim):
    op = node.operator
    gamma = ctx.transcript.challenge_scalar()
    terms, spec, rspec = _cube_terms(gamma, op.scale)
    _, specs = _derived_specs(node.idx, spec)
    _, rspecs = _derived_specs(node.idx, rspec)
    specs.extend(rspecs)
    specs.append(("a", input_opening_id(node.idx, 0, node.inputs[0])))
    inst = CycleExecutionVerifier(terms, r, out_claim, specs)
    r_sc = Sumcheck.verify(ctx.proofs[(node.idx, "Execution")], inst,
                           ctx.accumulator, ctx.transcript)
    fams = [
        (ChunkFamily(lambda d: CommittedPoly.make("ClampRaD", node.idx, d),
                     MUL_SAT_CHUNKS, None), spec),
        (ChunkFamily(lambda d: CommittedPoly.make("RescaleRemainderRaD",
                                                  node.idx, d),
                     (2 * op.scale) // 4, None), rspec),
    ]
    ra_inst = build_ra_checks_verifiers(node.idx, fams, list(r_sc),
                                        ctx.accumulator, ctx.transcript)
    BatchedSumcheck.verify(ctx.proofs[(node.idx, "RaChecks")], ra_inst,
                           ctx.accumulator, ctx.transcript)


_register([FOPS.MeanOfSquares], _prove_mos, _verify_mos)
_register([FOPS.Cube], _prove_cube, _verify_cube)


# ---------------------------------------------------------------------------
# Div (variable divisor; reference ops/div.rs): committed quotient advice +
# variable-vs-variable R < y comparison via pairwise chunk indicators
# ---------------------------------------------------------------------------

def _div_q_id(node_idx: int, tag: str) -> OpeningId:
    return OpeningId.committed(CommittedPoly.make("DivNodeQuotient", node_idx),
                               SumcheckId.make("NodeExecution", node_idx, tag))


def _div_terms(g: list[Fr]):
    spec = {}
    terms = []
    # g0: x-binding: Q*y + rem_recon
    terms.append((g[0], ["Q", "y"]))
    for d in range(8):
        spec[f"rv{d}"] = (d, "identity")
        terms.append((g[0] * Fr(1 << (4 * d)), [f"rv{d}"]))
    # g1: y-binding: y - y_recon
    terms.append((g[1], ["y"]))
    for d in range(8):
        spec[f"yv{d}"] = (8 + d, "identity")
        terms.append((Fr.zero() - g[1] * Fr(1 << (4 * d)), [f"yv{d}"]))
    # g2: LT combo - 1
    for d in range(8):
        factors = [f"ev{l}" for l in range(d + 1, 8)] + [f"lv{d}"]
        terms.append((g[2], factors))
    terms.append((Fr.zero() - g[2], []))
    # g3: y nonzero: prod yz_d = 0
    for d in range(8):
        spec[f"yz{d}"] = (8 + d, "eq0")
    terms.append((g[3], [f"yz{d}" for d in range(8)]))
    # g4: y >= 0: yhi7 = 0
    spec["yhi7"] = (15, "msb")
    terms.append((g[4], ["yhi7"]))
    return terms, spec


def _prove_div(node, ctx, r, out_claim):
    g = ctx.transcript.challenge_vector(5)
    x = padded_flat(ctx.trace.node_outputs[node.inputs[0]]).astype(np.int64)
    y = padded_flat(ctx.trace.node_outputs[node.inputs[1]]).astype(np.int64)
    xs = x << np.int64(node.operator.scale)
    q = np.floor_divide(xs, np.maximum(y, 1))
    rem = xs - q * np.maximum(y, 1)
    chunks = ctx.chunks[(node.idx, "DivRangeCheckRaD")]
    rem_chunks, y_chunks = chunks[:8], chunks[8:]
    eqv = (rem_chunks == y_chunks).astype(np.int64)
    ltv = (rem_chunks < y_chunks).astype(np.int64)

    x_claim = MLPoly(ints=x).evaluate(list(r))
    ctx.accumulator.append_virtual(
        ctx.transcript, input_opening_id(node.idx, 0, node.inputs[0]),
        list(r), x_claim)
    ctx.accumulator.append_committed(ctx.transcript, _div_q_id(node.idx, "r"),
                                     list(r), out_claim)
    terms, spec = _div_terms(g)
    polys, specs = build_derived_polys(node.idx, spec, chunks)
    polys["Q"] = MLPoly(ints=q)
    polys["y"] = MLPoly(ints=y)
    for d in range(8):
        polys[f"ev{d}"] = MLPoly(ints=eqv[d])
        polys[f"lv{d}"] = MLPoly(ints=ltv[d])
        specs.append((f"ev{d}", FW.derived_claim_id(node.idx, f"ev{d}")))
        specs.append((f"lv{d}", FW.derived_claim_id(node.idx, f"lv{d}")))
    specs.append(("Q", _div_q_id(node.idx, "rsc")))
    specs.append(("y", input_opening_id(node.idx, 1, node.inputs[1])))
    # x-binding relation proves Q*y + rem == x_hat * 2^scale
    claim = g[0] * x_claim * Fr(1 << node.operator.scale)
    inst = CycleExecutionProver(polys, terms, list(r), claim, specs)
    proof, r_sc = Sumcheck.prove(inst, ctx.accumulator, ctx.transcript)
    ctx.proofs[(node.idx, "Execution")] = proof

    fam = ChunkFamily(lambda d: CommittedPoly.make("DivRangeCheckRaD", node.idx, d),
                      16, chunks)
    ra_inst = build_ra_checks_provers(node.idx, [(fam, spec)], list(r_sc),
                                      ctx.accumulator, ctx.transcript)
    sid_pair = SumcheckId.make("Raf", "pair")
    for d in range(8):
        ec = ctx.accumulator.get_opening(FW.derived_claim_id(node.idx, f"ev{d}"))[1]
        lc = ctx.accumulator.get_opening(FW.derived_claim_id(node.idx, f"lv{d}"))[1]
        pa = CommittedPoly.make("DivRangeCheckRaD", node.idx, d)
        pb = CommittedPoly.make("DivRangeCheckRaD", node.idx, 8 + d)
        ra_inst.append(onehot.EqPairCheckProver(
            pa, pb, SumcheckId.make("Raf", "eqp", d), rem_chunks[d], y_chunks[d],
            list(r_sc), ec))
        ra_inst.append(onehot.LtPairCheckProver(
            pa, pb, SumcheckId.make("Raf", "ltp", d), rem_chunks[d], y_chunks[d],
            list(r_sc), lc))
    ra_proof, _ = BatchedSumcheck.prove(ra_inst, ctx.accumulator, ctx.transcript)
    ctx.proofs[(node.idx, "RaChecks")] = ra_proof


def _verify_div(node, ctx, r, out_claim):
    g = ctx.transcript.challenge_vector(5)
    oid_x = input_opening_id(node.idx, 0, node.inputs[0])
    ctx.accumulator.append_virtual(ctx.transcript, oid_x, list(r))
    x_claim = ctx.accumulator.get_opening(oid_x)[1]
    ctx.accumulator.append_committed(ctx.transcript, _div_q_id(node.idx, "r"),
                                     list(r))
    if ctx.accumulator.get_opening(_div_q_id(node.idx, "r"))[1] != out_claim:
        raise VerificationError(f"div quotient != output at node {node.idx}")
    terms, spec = _div_terms(g)
    _, specs = _derived_specs(node.idx, spec)
    for d in range(8):
        specs.append((f"ev{d}", FW.derived_claim_id(node.idx, f"ev{d}")))
        specs.append((f"lv{d}", FW.derived_claim_id(node.idx, f"lv{d}")))
    specs.append(("Q", _div_q_id(node.idx, "rsc")))
    specs.append(("y", input_opening_id(node.idx, 1, node.inputs[1])))
    claim = g[0] * x_claim * Fr(1 << node.operator.scale)
    inst = CycleExecutionVerifier(terms, list(r), claim, specs)
    r_sc = Sumcheck.verify(ctx.proofs[(node.idx, "Execution")], inst,
                           ctx.accumulator, ctx.transcript)
    fam = ChunkFamily(lambda d: CommittedPoly.make("DivRangeCheckRaD", node.idx, d),
                      16, None)
    ra_inst = build_ra_checks_verifiers(node.idx, [(fam, spec)], list(r_sc),
                                        ctx.accumulator, ctx.transcript)
    log_t = len(r_sc)
    for d in range(8):
        ec = ctx.accumulator.get_opening(FW.derived_claim_id(node.idx, f"ev{d}"))[1]
        lc = ctx.accumulator.get_opening(FW.derived_claim_id(node.idx, f"lv{d}"))[1]
        pa = CommittedPoly.make("DivRangeCheckRaD", node.idx, d)
        pb = CommittedPoly.make("DivRangeCheckRaD", node.idx, 8 + d)
        ra_inst.append(onehot.EqPairCheckVerifier(
            pa, pb, SumcheckId.make("Raf", "eqp", d), log_t, list(r_sc), ec))
        ra_inst.append(onehot.LtPairCheckVerifier(
            pa, pb, SumcheckId.make("Raf", "ltp", d), log_t, list(r_sc), lc))
    BatchedSumcheck.verify(ctx.proofs[(node.idx, "RaChecks")], ra_inst,
                           ctx.accumulator, ctx.transcript)


_register([FOPS.Div], _prove_div, _verify_div)


# ---------------------------------------------------------------------------
# SoftmaxLastAxis: 4-stage protocol lives in its own module
# (zkops/softmax_op.py, registered on import at the bottom of this file)

# ---------------------------------------------------------------------------
# Rsqrt (reference ops/rsqrt.rs): committed quotient Q = floor(S^3/x) and
# integer square root y with two variable-operand range checks, gated by a
# committed x>0 indicator so nonpositive lanes output 0.
# Chunk family layout (SqrtRangeCheckRaD): x: d 0..8, r1: 8..16,
# r2: 16..21, B=2y+1: 21..26.
# ---------------------------------------------------------------------------

_RSQ_X0, _RSQ_R1, _RSQ_R2, _RSQ_B = 0, 8, 16, 21
_RSQ_NCHUNKS = 26


def _rsqrt_dense_id(node_idx, which, tag):
    return OpeningId.committed(
        CommittedPoly.make("RsqrtQuotient", node_idx, which),
        SumcheckId.make("NodeExecution", node_idx, tag))


def _rsqrt_terms(g: list[Fr], scale_pow: int):
    S3 = 1 << (3 * scale_pow)
    spec = {}
    for d in range(8):
        spec[f"xv{d}"] = (_RSQ_X0 + d, "identity")
        spec[f"xz{d}"] = (_RSQ_X0 + d, "eq0")
    spec["xhi7"] = (_RSQ_X0 + 7, "msb")
    for d in range(8):
        spec[f"r1v{d}"] = (_RSQ_R1 + d, "identity")
    for d in range(5):
        spec[f"r2v{d}"] = (_RSQ_R2 + d, "identity")
        spec[f"Bv{d}"] = (_RSQ_B + d, "identity")

    one = Fr.one()
    terms = [(one, ["P", "Y"])]  # out = P * Y
    # g0: x - x_recon (signed, 8 chunks)
    terms.append((g[0], ["x"]))
    for d in range(8):
        terms.append((Fr.zero() - g[0] * Fr(1 << (4 * d)), [f"xv{d}"]))
    terms.append((g[0] * Fr(1 << 32), ["xhi7"]))
    # g1: P^2 - P
    terms.append((g[1], ["P", "P"]))
    terms.append((Fr.zero() - g[1], ["P"]))
    # g2: P * xhi7
    terms.append((g[2], ["P", "xhi7"]))
    # g3: P * prod xz_d
    terms.append((g[3], ["P"] + [f"xz{d}" for d in range(8)]))
    # g4: (1-P)(1-xhi7)(1 - prod xz) = 0  (P=0 implies NOT x>0)
    zx = [f"xz{d}" for d in range(8)]
    terms.append((g[4], []))
    terms.append((Fr.zero() - g[4], ["P"]))
    terms.append((Fr.zero() - g[4], ["xhi7"]))
    terms.append((g[4], ["P", "xhi7"]))
    terms.append((Fr.zero() - g[4], zx))
    terms.append((g[4], ["P"] + zx))
    terms.append((g[4], ["xhi7"] + zx))
    terms.append((Fr.zero() - g[4], ["P", "xhi7"] + zx))
    # g5: P*(S^3 - Q*x - r1_recon)
    terms.append((g[5] * Fr(S3), ["P"]))
    terms.append((Fr.zero() - g[5], ["P", "Q", "x"]))
    for d in range(8):
        terms.append((Fr.zero() - g[5] * Fr(1 << (4 * d)), ["P", f"r1v{d}"]))
    # g6: P*(Q - Y^2 - r2_recon)
    terms.append((g[6], ["P", "Q"]))
    terms.append((Fr.zero() - g[6], ["P", "Y", "Y"]))
    for d in range(5):
        terms.append((Fr.zero() - g[6] * Fr(1 << (4 * d)), ["P", f"r2v{d}"]))
    # g7: P*(2Y + 1 - B_recon)
    terms.append((g[7] * Fr(2), ["P", "Y"]))
    terms.append((g[7], ["P"]))
    for d in range(5):
        terms.append((Fr.zero() - g[7] * Fr(1 << (4 * d)), ["P", f"Bv{d}"]))
    # g8: P*(LT(r1, x) - 1); g9: P*(LT(r2, B) - 1)
    for d in range(8):
        factors = ["P"] + [f"e1_{l}" for l in range(d + 1, 8)] + [f"l1_{d}"]
        terms.append((g[8], factors))
    terms.append((Fr.zero() - g[8], ["P"]))
    for d in range(5):
        factors = ["P"] + [f"e2_{l}" for l in range(d + 1, 5)] + [f"l2_{d}"]
        terms.append((g[9], factors))
    terms.append((Fr.zero() - g[9], ["P"]))
    return terms, spec


def _prove_rsqrt(node, ctx, r, out_claim):
    op = node.operator
    g = ctx.transcript.challenge_vector(10)
    x = padded_flat(ctx.trace.node_outputs[node.inputs[0]]).astype(np.int64)
    S3 = np.int64(1 << (3 * op.scale))
    pos = x > 0
    Q = np.where(pos, S3 // np.maximum(x, 1), 0)
    Y = np.where(pos, np.array([math_isqrt(int(q)) for q in Q], dtype=np.int64), 0)
    r1 = np.where(pos, S3 - Q * np.maximum(x, 1), 0)
    r2 = np.where(pos, Q - Y * Y, 0)
    B = np.where(pos, 2 * Y + 1, 1)
    chunks = ctx.chunks[(node.idx, "SqrtRangeCheckRaD")]

    terms, spec = _rsqrt_terms(g, op.scale)
    polys, specs = build_derived_polys(node.idx, spec, chunks)
    polys["x"] = MLPoly(ints=x)
    specs.append(("x", input_opening_id(node.idx, 0, node.inputs[0])))
    polys["Q"] = MLPoly(ints=Q)
    specs.append(("Q", _rsqrt_dense_id(node.idx, 0, "rsc")))
    polys["Y"] = MLPoly(ints=Y)
    specs.append(("Y", _rsqrt_dense_id(node.idx, 1, "rsc")))
    polys["P"] = MLPoly(ints=pos.astype(np.int64))
    specs.append(("P", _rsqrt_dense_id(node.idx, 2, "rsc")))
    r1c, xc = chunks[_RSQ_R1:_RSQ_R1 + 8], chunks[_RSQ_X0:_RSQ_X0 + 8]
    r2c, Bc = chunks[_RSQ_R2:_RSQ_R2 + 5], chunks[_RSQ_B:_RSQ_B + 5]
    for d in range(8):
        polys[f"e1_{d}"] = MLPoly(ints=(r1c[d] == xc[d]).astype(np.int64))
        polys[f"l1_{d}"] = MLPoly(ints=(r1c[d] < xc[d]).astype(np.int64))
        specs.append((f"e1_{d}", FW.derived_claim_id(node.idx, f"e1_{d}")))
        specs.append((f"l1_{d}", FW.derived_claim_id(node.idx, f"l1_{d}")))
    for d in range(5):
        polys[f"e2_{d}"] = MLPoly(ints=(r2c[d] == Bc[d]).astype(np.int64))
        polys[f"l2_{d}"] = MLPoly(ints=(r2c[d] < Bc[d]).astype(np.int64))
        specs.append((f"e2_{d}", FW.derived_claim_id(node.idx, f"e2_{d}")))
        specs.append((f"l2_{d}", FW.derived_claim_id(node.idx, f"l2_{d}")))
    claim = out_claim  # every gated relation sums to zero
    inst = CycleExecutionProver(polys, terms, list(r), claim, specs)
    proof, r_sc = Sumcheck.prove(inst, ctx.accumulator, ctx.transcript)
    ctx.proofs[(node.idx, "Execution")] = proof

    fam = ChunkFamily(lambda d: CommittedPoly.make("SqrtRangeCheckRaD", node.idx, d),
                      _RSQ_NCHUNKS, chunks)
    ra_inst = build_ra_checks_provers(node.idx, [(fam, spec)], list(r_sc),
                                      ctx.accumulator, ctx.transcript)
    for d in range(8):
        ec = ctx.accumulator.get_opening(FW.derived_claim_id(node.idx, f"e1_{d}"))[1]
        lc = ctx.accumulator.get_opening(FW.derived_claim_id(node.idx, f"l1_{d}"))[1]
        pa = CommittedPoly.make("SqrtRangeCheckRaD", node.idx, _RSQ_R1 + d)
        pb = CommittedPoly.make("SqrtRangeCheckRaD", node.idx, _RSQ_X0 + d)
        ra_inst.append(onehot.EqPairCheckProver(
            pa, pb, SumcheckId.make("Raf", "e1", d), r1c[d], xc[d],
            list(r_sc), ec))
        ra_inst.append(onehot.LtPairCheckProver(
            pa, pb, SumcheckId.make("Raf", "l1", d), r1c[d], xc[d],
            list(r_sc), lc))
    for d in range(5):
        ec = ctx.accumulator.get_opening(FW.derived_claim_id(node.idx, f"e2_{d}"))[1]
        lc = ctx.accumulator.get_opening(FW.derived_claim_id(node.idx, f"l2_{d}"))[1]
        pa = CommittedPoly.make("SqrtRangeCheckRaD", node.idx, _RSQ_R2 + d)
        pb = CommittedPoly.make("SqrtRangeCheckRaD", node.idx, _RSQ_B + d)
        ra_inst.append(onehot.EqPairCheckProver(
            pa, pb, SumcheckId.make("Raf", "e2", d), r2c[d], Bc[d],
            list(r_sc), ec))
        ra_inst.append(onehot.LtPairCheckProver(
            pa, pb, SumcheckId.make("Raf", "l2", d), r2c[d], Bc[d],
            list(r_sc), lc))
    ra_proof, _ = BatchedSumcheck.prove(ra_inst, ctx.accumulator, ctx.transcript)
    ctx.proofs[(node.idx, "RaChecks")] = ra_proof


def _verify_rsqrt(node, ctx, r, out_claim):
    op = node.operator
    g = ctx.transcript.challenge_vector(10)
    terms, spec = _rsqrt_terms(g, op.scale)
    _, specs = _derived_specs(node.idx, spec)
    specs.append(("x", input_opening_id(node.idx, 0, node.inputs[0])))
    specs.append(("Q", _rsqrt_dense_id(node.idx, 0, "rsc")))
    specs.append(("Y", _rsqrt_dense_id(node.idx, 1, "rsc")))
    specs.append(("P", _rsqrt_dense_id(node.idx, 2, "rsc")))
    for d in range(8):
        specs.append((f"e1_{d}", FW.derived_claim_id(node.idx, f"e1_{d}")))
        specs.append((f"l1_{d}", FW.derived_claim_id(node.idx, f"l1_{d}")))
    for d in range(5):
        specs.append((f"e2_{d}", FW.derived_claim_id(node.idx, f"e2_{d}")))
        specs.append((f"l2_{d}", FW.derived_claim_id(node.idx, f"l2_{d}")))
    claim = out_claim
    inst = CycleExecutionVerifier(terms, list(r), claim, specs)
    r_sc = Sumcheck.verify(ctx.proofs[(node.idx, "Execution")], inst,
                           ctx.accumulator, ctx.transcript)
    fam = ChunkFamily(lambda d: CommittedPoly.make("SqrtRangeCheckRaD", node.idx, d),
                      _RSQ_NCHUNKS, None)
    ra_inst = build_ra_checks_verifiers(node.idx, [(fam, spec)], list(r_sc),
                                        ctx.accumulator, ctx.transcript)
    log_t = len(r_sc)
    for d in range(8):
        ec = ctx.accumulator.get_opening(FW.derived_claim_id(node.idx, f"e1_{d}"))[1]
        lc = ctx.accumulator.get_opening(FW.derived_claim_id(node.idx, f"l1_{d}"))[1]
        pa = CommittedPoly.make("SqrtRangeCheckRaD", node.idx, _RSQ_R1 + d)
        pb = CommittedPoly.make("SqrtRangeCheckRaD", node.idx, _RSQ_X0 + d)
        ra_inst.append(onehot.EqPairCheckVerifier(
            pa, pb, SumcheckId.make("Raf", "e1", d), log_t, list(r_sc), ec))
        ra_inst.append(onehot.LtPairCheckVerifier(
            pa, pb, SumcheckId.make("Raf", "l1", d), log_t, list(r_sc), lc))
    for d in range(5):
        ec = ctx.accumulator.get_opening(FW.derived_claim_id(node.idx, f"e2_{d}"))[1]
        lc = ctx.accumulator.get_opening(FW.derived_claim_id(node.idx, f"l2_{d}"))[1]
        pa = CommittedPoly.make("SqrtRangeCheckRaD", node.idx, _RSQ_R2 + d)
        pb = CommittedPoly.make("SqrtRangeCheckRaD", node.idx, _RSQ_B + d)
        ra_inst.append(onehot.EqPairCheckVerifier(
            pa, pb, SumcheckId.make("Raf", "e2", d), log_t, list(r_sc), ec))
        ra_inst.append(onehot.LtPairCheckVerifier(
            pa, pb, SumcheckId.make("Raf", "l2", d), log_t, list(r_sc), lc))
    BatchedSumcheck.verify(ctx.proofs[(node.idx, "RaChecks")], ra_inst,
                           ctx.accumulator, ctx.transcript)


from ..frontend.nonlinearities import math_isqrt  # noqa: E402

_register([FOPS.Rsqrt], _prove_rsqrt, _verify_rsqrt)

# registered last: the softmax module pulls its shared helpers from here
from . import softmax_op  # noqa: E402,F401
