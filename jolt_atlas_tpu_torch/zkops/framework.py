"""Shared operator-proof framework.

Each operator node is proven with (cf. reference jolt-atlas-core ops/):

 1. A *cycle execution sumcheck* over the node's T-sized output domain:
        input_claim = sum_j eq(r, j) * F(named polys at j)
    where F is an op-specific multilinear combination ("terms": sum of
    scaled products) over named cycle polynomials — the node inputs and
    chunk-derived virtual polynomials. Ends at r'; every named poly's final
    claim is appended (inputs as NodeOutput openings consumed by producer
    nodes; chunk-derived values as virtual openings).

 2. An *RaChecks batch* (BatchedSumcheck): booleanity over all the node's
    one-hot chunk polys + per-chunk hamming-weight + one AddressReadCheck
    per derived claim, tying the derived claims to the committed ra_d polys
    (see subprotocols/onehot.py). This is the dense TPU re-formulation of
    the reference's Shout read-raf + prefix-suffix lookups
    (joltworks/src/subprotocols/{shout,ps_shout}.rs): instead of evaluating
    a 2^64-entry table MLE via prefix-suffix decomposition, the table's
    semantics (saturating clamp / ReLU / range bound) are expressed as a
    low-degree combination of tiny per-chunk indicator tables.

Saturation algebra (SatClampTable equivalent, lookup_tables/sat_clamp.rs):
with C 4-bit chunks of u = acc mod 2^{4C} (sign chunk C-1, i32 boundary in
chunk 7):
    in_range_pos = prod_{8<=d<C} [chunk_d = 0] * [chunk_7 < 8]
    in_range_neg = prod_{8<=d<C} [chunk_d = 15] * [chunk_7 >= 8]
    satclamp(acc) = in_range * (u32 - 2^32 * bit31)
                  + (2^31 - 1) * pos_overflow - 2^31 * neg_overflow.
The chunk count C is sized to the operand range (9 for Add/Sub's 33-bit
accumulations, 12 by default for fused-rescale quotients) rather than the
reference's fixed 64 bits — a range-sized, completeness-equivalent choice.
"""

from __future__ import annotations

import numpy as np

from ..config import LOG_K_CHUNK
from ..field import vec
from ..field.scalar import Fr
from ..ids import CommittedPoly, OpeningId, SumcheckId, VirtualPoly
from ..poly.eq import eq_evals, eq_eval_scalar
from ..poly.mlpoly import BindingOrder, MLPoly
from ..poly.unipoly import UniPoly
from ..subprotocols.sumcheck import (
    RowsInstance,
    SumcheckInstanceProver,
    SumcheckInstanceVerifier,
)
from ..subprotocols import onehot

# Chunk counts (range-sized satclamp decompositions)
ADD_SAT_CHUNKS = 9    # |a +- b| < 2^33 fits 36-bit two's complement
MUL_SAT_CHUNKS = 12   # fused-rescale quotients; 48-bit two's complement


# ---------------------------------------------------------------------------
# term algebra
# ---------------------------------------------------------------------------

def sat_clamp_terms(C: int, p: str, coeff_scale: int = 1):
    """Terms computing satclamp from chunk-derived polys named with prefix p.

    Derived names used: {p}v{d} (identity), {p}hi7/{p}nhi7, {p}hi{C-1},
    {p}nhi{C-1}, {p}z{d}/{p}f{d} for 8<=d<C. Returns (terms, derived_spec)
    where derived_spec maps name -> (chunk_index, table_name).
    """
    a_pos = [f"{p}z{d}" for d in range(8, C)] + [f"{p}nhi7"]
    a_neg = [f"{p}f{d}" for d in range(8, C)] + [f"{p}hi7"]
    terms = []
    for d in range(8):
        terms.append((Fr(coeff_scale * (1 << (4 * d))), a_pos + [f"{p}v{d}"]))
        terms.append((Fr(coeff_scale * (1 << (4 * d))), a_neg + [f"{p}v{d}"]))
    terms.append((Fr(-coeff_scale * (1 << 31)), a_neg))       # -2^32 + 2^31
    terms.append((Fr(coeff_scale * ((1 << 31) - 1)), [f"{p}nhi{C - 1}"]))
    terms.append((Fr(-coeff_scale * ((1 << 31) - 1)), a_pos))
    terms.append((Fr(-coeff_scale * (1 << 31)), [f"{p}hi{C - 1}"]))

    spec = {}
    for d in range(C):
        spec[f"{p}v{d}"] = (d, "identity")
    spec[f"{p}hi7"] = (7, "msb")
    spec[f"{p}nhi7"] = (7, "notmsb")
    if C - 1 != 7:
        spec[f"{p}hi{C - 1}"] = (C - 1, "msb")
    spec[f"{p}nhi{C - 1}"] = (C - 1, "notmsb")
    for d in range(8, C):
        spec[f"{p}z{d}"] = (d, "eq0")
        spec[f"{p}f{d}"] = (d, "eq15")
    return terms, spec


def recon_terms(C: int, p: str, scale: int = 1):
    """Terms for the signed reconstruction: scale * (sum 2^{4d} v_d - 2^{4C} hi)."""
    terms = [(Fr(scale * (1 << (4 * d))), [f"{p}v{d}"]) for d in range(C)]
    terms.append((Fr(-scale * (1 << (4 * C))), [f"{p}hi{C - 1}"]))
    return terms


def unsigned_recon_terms(C: int, p: str, scale: int = 1):
    """scale * sum 2^{4d} v_d  (for nonnegative operands, e.g. remainders)."""
    return [(Fr(scale * (1 << (4 * d))), [f"{p}v{d}"]) for d in range(C)]


def lt_const_terms(C: int, p: str, const: int):
    """Terms for the MSB-first comparison indicator LT(value, const) over C
    4-bit chunks (the chunked analogue of the reference's UnsignedLessThan
    prefix-suffix table, lookup_tables/unsigned_less_than.rs):
        LT = sum_i ( prod_{l>i} [chunk_l == const_l] ) * [chunk_i < const_i].
    Returns (terms, derived_spec)."""
    if const >= 16 ** C:
        raise ValueError(f"lt_const_terms: const {const} needs more than "
                         f"{C} nibbles (the decomposition would silently "
                         f"truncate it and the LT relation would be wrong)")
    dch = [(const >> (4 * l)) & 0xF for l in range(C)]
    terms = []
    spec = {}
    for i in range(C):
        factors = [f"{p}eqc{l}" for l in range(i + 1, C)] + [f"{p}ltc{i}"]
        terms.append((Fr.one(), factors))
        spec[f"{p}ltc{i}"] = (i, ("ltc", dch[i]))
    for l in range(1, C):
        spec[f"{p}eqc{l}"] = (l, ("eqc", dch[l]))
    return terms, spec


def eval_clamp_reference(acc: np.ndarray) -> np.ndarray:
    return np.clip(acc, -(2**31), 2**31 - 1).astype(np.int64)


# ---------------------------------------------------------------------------
# cycle execution sumcheck
# ---------------------------------------------------------------------------

class CycleExecutionProver(RowsInstance, SumcheckInstanceProver):
    """input_claim = sum_j eq(r, j) * sum_terms coeff * prod(named polys).

    eq(r) rides the Gruen split-eq weight schedule (RowsInstance eq_r);
    the named witness/derived polys stay small integers through the
    round-0 kernels."""

    def __init__(self, named_polys: dict[str, MLPoly], terms, r: list[Fr],
                 input_claim: Fr, opening_specs: list[tuple[str, OpeningId]]):
        self.polys = named_polys
        self.terms = terms
        self.r = r
        self.claim = input_claim
        self.opening_specs = opening_specs
        self._deg = 1 + max(len(f) for _, f in terms)
        self._rounds = len(r)
        names = list(named_polys)
        self._row_idx = {n: i for i, n in enumerate(names)}
        fterms = [(c, [self._row_idx[f] for f in factors])
                  for c, factors in terms]
        self.setup_rows([named_polys[n] for n in names], fterms, self._deg,
                        eq_r=r)

    def num_rounds(self) -> int:
        return self._rounds

    def degree(self) -> int:
        return self._deg

    def input_claim(self, accumulator) -> Fr:
        return self.claim

    def compute_message(self, round: int, previous_claim: Fr) -> UniPoly:
        return self.rows_message(previous_claim)

    def ingest_challenge(self, r_j: Fr, round: int) -> None:
        self.rows_bind(r_j)

    def _final(self, name: str) -> Fr:
        return self.row_final(self._row_idx[name])

    def final_claims(self) -> dict[str, Fr]:
        return {n: self._final(n) for n in self.polys}

    def cache_openings(self, accumulator, transcript, r: list[Fr]) -> None:
        for name, oid in self.opening_specs:
            if oid.is_virtual:
                accumulator.append_virtual(transcript, oid, list(r),
                                           self._final(name))
            else:  # dense committed advice polynomial opened directly
                accumulator.append_committed(transcript, oid, list(r),
                                             self._final(name))


class CycleExecutionVerifier(SumcheckInstanceVerifier):
    def __init__(self, terms, r: list[Fr], input_claim: Fr,
                 opening_specs: list[tuple[str, OpeningId]],
                 public_evals: dict | None = None):
        self.terms = terms
        self.r = r
        self.claim = input_claim
        self.opening_specs = opening_specs
        self.public_evals = public_evals or {}
        self._deg = 1 + max(len(f) for _, f in terms)

    def num_rounds(self) -> int:
        return len(self.r)

    def degree(self) -> int:
        return self._deg

    def input_claim(self, accumulator) -> Fr:
        return self.claim

    def cache_openings(self, accumulator, transcript, r: list[Fr]) -> None:
        for _, oid in self.opening_specs:
            if oid.is_virtual:
                accumulator.append_virtual(transcript, oid, list(r))
            else:
                accumulator.append_committed(transcript, oid, list(r))

    def expected_output_claim(self, accumulator, r: list[Fr]) -> Fr:
        claims = {name: accumulator.get_opening(oid)[1]
                  for name, oid in self.opening_specs}
        for name, fn in self.public_evals.items():
            claims[name] = fn(list(r))  # public polynomial: verifier evaluates
        acc = Fr.zero()
        for coeff, factors in self.terms:
            prod = coeff  # empty factor list = constant term
            for name in factors:
                prod = prod * claims[name]
            acc = acc + prod
        return eq_eval_scalar(self.r, list(r)) * acc


# ---------------------------------------------------------------------------
# RaChecks batch construction (booleanity + hamming + address read checks)
# ---------------------------------------------------------------------------

class ChunkFamily:
    """A family of committed one-hot chunk polys for one node.

    poly_id_fn(d) -> CommittedPoly; chunks: (C, T) int array of chunk values.
    """

    def __init__(self, poly_id_fn, num_chunks: int, chunks: np.ndarray | None):
        self.poly_id_fn = poly_id_fn
        self.num_chunks = num_chunks
        self.chunks = chunks

    def poly_ids(self) -> list[CommittedPoly]:
        return [self.poly_id_fn(d) for d in range(self.num_chunks)]


def derived_claim_id(node_idx: int, name: str) -> OpeningId:
    return OpeningId.virtual(
        VirtualPoly.make("ClampRa", node_idx, name),
        SumcheckId.make("NodeExecution", node_idx),
    )


def build_ra_checks_provers(node_idx: int, families: list[tuple[ChunkFamily, dict]],
                            r_cycle: list[Fr], accumulator, transcript):
    """families: [(family, derived_spec name->(chunk_d, table))]. Returns the
    instance list for one BatchedSumcheck. Transcript draws: booleanity
    gammas + r_b (address||cycle)."""
    log_t = len(r_cycle)
    all_ids = []
    all_idx = []
    for fam, _ in families:
        for d in range(fam.num_chunks):
            all_ids.append(fam.poly_id_fn(d))
            # chunk-value arrays only: the sparse two-phase Booleanity
            # prover never materializes the (K, T) one-hot rows
            all_idx.append(fam.chunks[d])
    gammas = transcript.challenge_vector(len(all_ids))
    r_b = transcript.challenge_vector_optimized(LOG_K_CHUNK + log_t)
    instances = [onehot.BooleanityProver(all_ids, all_idx, onehot.K_CHUNK,
                                         r_b, gammas)]

    eq_cycle = eq_evals(r_cycle)
    for fam, spec in families:
        G = [onehot.compute_G(fam.chunks[d], eq_cycle)
             for d in range(fam.num_chunks)]
        # hamming weight (claim 1) — designated opening appender per chunk
        for d in range(fam.num_chunks):
            instances.append(onehot.AddressReadCheckProver(
                fam.poly_id_fn(d), SumcheckId.make("Raf"), "one", G[d],
                r_cycle, Fr.one(), appends_opening=True))
        # derived-value read checks
        for name in sorted(spec):
            d, table = spec[name]
            claim = accumulator.get_opening(derived_claim_id(node_idx, name))[1]
            instances.append(onehot.AddressReadCheckProver(
                fam.poly_id_fn(d), SumcheckId.make("Raf"), table, G[d],
                r_cycle, claim, appends_opening=False))
    return instances


def build_ra_checks_verifiers(node_idx: int, families: list[tuple[ChunkFamily, dict]],
                              r_cycle: list[Fr], accumulator, transcript):
    log_t = len(r_cycle)
    all_ids = []
    for fam, _ in families:
        all_ids.extend(fam.poly_ids())
    gammas = transcript.challenge_vector(len(all_ids))
    r_b = transcript.challenge_vector_optimized(LOG_K_CHUNK + log_t)
    instances = [onehot.BooleanityVerifier(all_ids, r_b, gammas)]
    for fam, spec in families:
        for d in range(fam.num_chunks):
            instances.append(onehot.AddressReadCheckVerifier(
                fam.poly_id_fn(d), SumcheckId.make("Raf"), "one",
                r_cycle, Fr.one(), appends_opening=True))
        for name in sorted(spec):
            d, table = spec[name]
            claim = accumulator.get_opening(derived_claim_id(node_idx, name))[1]
            instances.append(onehot.AddressReadCheckVerifier(
                fam.poly_id_fn(d), SumcheckId.make("Raf"), table,
                r_cycle, claim, appends_opening=False))
    return instances


def build_derived_polys(node_idx: int, spec: dict, chunks: np.ndarray):
    """Named MLPolys + opening specs for chunk-derived cycle polynomials."""
    polys = {}
    specs = []
    for name in sorted(spec):
        d, table = spec[name]
        polys[name] = MLPoly(ints=onehot.derived_cycle_array(table, chunks[d]))
        specs.append((name, derived_claim_id(node_idx, name)))
    return polys, specs
