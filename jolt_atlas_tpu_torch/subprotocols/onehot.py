"""One-hot chunk decomposition machinery (Twist/Shout-style, TPU-first).

A lookup operand (u32 / u64 / remainder) is decomposed into 16-ary chunks
(LOG_K_CHUNK = 4, common/src/consts.rs). For each chunk d the prover commits
a one-hot polynomial ra_d over (K_CHUNK, T): ra_d[k, j] = 1 iff chunk_d of
operand j equals k (reference OneHotPolynomial,
joltworks/src/poly/one_hot_polynomial.rs:22-62).

Validity + read checks (reference shout.rs:399-474 one-hot checks,
re-formulated for dense TPU execution — see module docstring of zkops/):

  * AddressReadCheck: claim = sum_k g(k) * ra_d(k, r_cycle) for a tiny
    16-entry table g (identity / msb / eq-0 / eq-15 / const-1 = hamming
    weight). Degree-2, LOG_K_CHUNK rounds. Plays the role of the reference's
    read-raf + HammingWeight instances.
  * Booleanity: 0 = sum_{k,j} eq(r_b, (k,j)) * sum_d gamma_d (ra_d^2 - ra_d).
    Degree-3, LOG_K_CHUNK + log T rounds (reference booleanity.rs:37).

Chunk order: d = 0 is the LEAST significant 4 bits.
"""

from __future__ import annotations

import numpy as np

from ..config import K_CHUNK, LOG_K_CHUNK
from ..field import vec
from ..field.scalar import Fr
from ..ids import CommittedPoly, OpeningId, SumcheckId
from ..poly.eq import eq_evals, eq_eval_scalar
from ..poly.mlpoly import BindingOrder, MLPoly
from ..poly.unipoly import UniPoly
from .sumcheck import (RowsInstance, SumcheckInstanceProver,
                       SumcheckInstanceVerifier)


# ---------------------------------------------------------------------------
# chunking + tiny tables
# ---------------------------------------------------------------------------

def chunk_values(operands: np.ndarray, num_chunks: int) -> np.ndarray:
    """(T,) unsigned int array -> (num_chunks, T) of 4-bit chunk values."""
    ops = operands.astype(np.uint64)
    out = np.empty((num_chunks, len(ops)), dtype=np.int64)
    for d in range(num_chunks):
        out[d] = ((ops >> np.uint64(4 * d)) & np.uint64(0xF)).astype(np.int64)
    return out


def one_hot_poly(chunks_d: np.ndarray, K: int = K_CHUNK) -> MLPoly:
    """(T,) chunk values -> flattened (K * T) one-hot MLPoly.

    Layout is address-major: index = k * T + j (big-endian: the address
    variables come first, then the cycle variables).
    """
    T = len(chunks_d)
    arr = np.zeros((K, T), dtype=np.int64)
    arr[chunks_d, np.arange(T)] = 1
    flat_idx = np.asarray(chunks_d, dtype=np.int64) * T + np.arange(T)
    return MLPoly(ints=arr.reshape(-1), onehot_indices=flat_idx)


def one_hot_lazy(chunks_d: np.ndarray, K: int = K_CHUNK) -> MLPoly:
    """One-hot MLPoly carrying only the 1-positions — the committed witness
    form (sparse subset-sum commit + scatter opening RLC). The dense K*T
    array is never built unless a consumer calls to_ints()/to_field()."""
    T = len(chunks_d)
    flat_idx = np.asarray(chunks_d, dtype=np.int64) * T + np.arange(T)
    return MLPoly(onehot_indices=flat_idx, length=K * T)


def one_hot_fvec(chunks_d: np.ndarray, K: int = K_CHUNK) -> MLPoly:
    """Field-vector one-hot built by scattering Montgomery(1) rows — avoids
    materializing and converting the K*T int array (the prover-side fast
    path for Booleanity clones and similar read-only uses)."""
    from ..field import frvec, vec
    if not vec.native_available():
        return one_hot_poly(chunks_d, K)
    T = len(chunks_d)
    d = np.zeros((K * T, 4), dtype=np.uint64)
    flat_idx = np.asarray(chunks_d, dtype=np.int64) * T + np.arange(T)
    d[flat_idx] = frvec._r1_limbs()[0]
    return MLPoly(fvec=frvec.FrArray(d))


# tiny 16-entry tables (as int vectors); MLE evaluation via MLPoly
TABLE_IDENTITY = np.arange(K_CHUNK, dtype=np.int64)
TABLE_ONE = np.ones(K_CHUNK, dtype=np.int64)
TABLE_MSB = (np.arange(K_CHUNK) >= 8).astype(np.int64)
TABLE_NOTMSB = (np.arange(K_CHUNK) < 8).astype(np.int64)
TABLE_EQ0 = (np.arange(K_CHUNK) == 0).astype(np.int64)
TABLE_EQ15 = (np.arange(K_CHUNK) == 15).astype(np.int64)

TABLES = {
    "identity": TABLE_IDENTITY,
    "one": TABLE_ONE,
    "msb": TABLE_MSB,
    "notmsb": TABLE_NOTMSB,
    "eq0": TABLE_EQ0,
    "eq15": TABLE_EQ15,
}


def table_vec(spec) -> np.ndarray:
    """Resolve a table spec to its K_CHUNK-entry vector.

    Spec forms: a name from TABLES; ("ltc", b) = [k < b] indicator;
    ("eqc", b) = [k == b]; ("lut", values_tuple) = custom entries
    (zero-padded to K_CHUNK) — used for tiny decomposed-exp sub-tables.
    """
    if isinstance(spec, str):
        return TABLES[spec]
    kind = spec[0]
    if kind == "ltc":
        return (np.arange(K_CHUNK) < spec[1]).astype(np.int64)
    if kind == "eqc":
        return (np.arange(K_CHUNK) == spec[1]).astype(np.int64)
    if kind == "lut":
        n = K_CHUNK
        vals = np.asarray(spec[1], dtype=np.int64)
        while n < len(vals):
            n *= 2
        v = np.zeros(n, dtype=np.int64)
        v[: len(vals)] = vals
        return v
    if kind == "onesN":
        return np.ones(spec[1], dtype=np.int64)
    if kind == "identN":
        return np.arange(spec[1], dtype=np.int64)
    raise ValueError(f"unknown table spec {spec}")


def derived_cycle_array(table_spec, chunks_d: np.ndarray) -> np.ndarray:
    """g(chunk_d(j)) per cycle j — the derived virtual cycle polynomial."""
    return table_vec(table_spec)[chunks_d]


def compute_G(chunks_d: np.ndarray, eq_cycle, K: int = K_CHUNK) -> np.ndarray:
    """G[k] = sum_{j: chunk_d(j)=k} eq_cycle[j]  (object-int field array).

    The cycle-bound chunk polynomial ra_d(k, r_cycle) (reference
    compute_ra_evals, shout.rs:532+).
    """
    from ..field import frvec
    if isinstance(eq_cycle, frvec.FrArray):
        return frvec.scatter_add(eq_cycle, np.asarray(chunks_d), K)
    eq_obj = vec.as_object(eq_cycle)
    G = np.zeros(K, dtype=object)
    for j, k in enumerate(chunks_d):
        G[int(k)] = (G[int(k)] + eq_obj[j]) % vec.R
    return vec.as_native(G)


# ---------------------------------------------------------------------------
# AddressReadCheck sumcheck (degree 2, LOG_K_CHUNK rounds)
# ---------------------------------------------------------------------------

class CycleReads:
    """The cycle-bound chunk rows of a batch's read checks: over D chunk-index
    rows (``idx``, the Booleanity's) and one cycle point ``r_cycle``,
    G_d[k] = sum_{j: idx[d][j] = k} eq(r_cycle)[j] (``compute_G``), built at
    the first ``G(d)`` and shared by the read checks of row d. ``G`` may
    seed rows already built ({d: G_d})."""

    def __init__(self, idx: list, r_cycle: list[Fr], K: int = K_CHUNK,
                 G: dict | None = None):
        self.idx = idx
        self.r_cycle = r_cycle
        self.K = K
        self._eq = None
        self._G = dict(G or {})

    def G(self, d: int):
        if d not in self._G:
            if self._eq is None:
                self._eq = eq_evals(self.r_cycle)
            self._G[d] = compute_G(self.idx[d], self._eq, self.K)
        return self._G[d]


class _HostOnDemand:
    """A prover whose host engine (``_build_host``: the rows, split-eq and
    tables that RowsInstance reads) is built by ``ensure_host``, which the
    host path calls before its first message (BatchedSumcheck.prove). The
    card's read-check engine (device/onehot.py) reads only the inputs and
    never builds it; it hands the final row values over in ``_finals``."""

    _finals = None
    _host_built = False

    def ensure_host(self) -> None:
        if not self._host_built:
            self._host_built = True
            self._build_host()

    def row_final(self, i: int) -> Fr:
        if self._finals is not None:
            return self._finals[i]
        return super().row_final(i)


class AddressReadCheckProver(_HostOnDemand, RowsInstance,
                             SumcheckInstanceProver):
    """Proves claim = sum_k g(k) * ra_d(k, r_cycle), ra_d(k, r_cycle) being
    ``reads.G(d)``.

    Final: the bound value ra_d((r_addr, r_cycle)) is appended as a committed
    opening (only when `appends_opening` — one designated instance per chunk).
    """

    def __init__(self, poly_id: CommittedPoly, sumcheck_id: SumcheckId,
                 table_spec, reads: CycleReads, d: int, claim: Fr,
                 appends_opening: bool):
        self.poly_id = poly_id
        self.sumcheck_id = sumcheck_id
        self.table_spec = table_spec
        self.reads = reads
        self.d = d
        self.r_cycle = reads.r_cycle
        self.claim = claim
        self.appends_opening = appends_opening
        self._rounds = len(table_vec(table_spec)).bit_length() - 1

    def _build_host(self) -> None:
        # G is shared across this chunk's read-check instances; safe without
        # a copy — the fused engine copies-on-first-bind
        self.setup_rows([MLPoly(ints=table_vec(self.table_spec)),
                         MLPoly(fvec=self.reads.G(self.d))],
                        [(Fr.one(), [0, 1])], 2)

    def num_rounds(self) -> int:
        return self._rounds

    def degree(self) -> int:
        return 2

    def input_claim(self, accumulator) -> Fr:
        return self.claim

    def compute_message(self, round: int, previous_claim: Fr) -> UniPoly:
        return self.rows_message(previous_claim)

    def ingest_challenge(self, r: Fr, round: int) -> None:
        self.rows_bind(r)

    def cache_openings(self, accumulator, transcript, r: list[Fr]) -> None:
        if self.appends_opening:
            point = list(r) + list(self.r_cycle)
            accumulator.append_committed(
                transcript, OpeningId.committed(self.poly_id, self.sumcheck_id),
                point, self.row_final(1))


_TEVAL_CACHE: dict = {}
_RKEY_MEMO: dict = {}  # id(r) -> (r, tuple) — r kept alive, id stable


def _point_key(r) -> tuple:
    """Identity-memoized value tuple of a challenge point: the same r
    list is passed by hundreds of read-check instances per batched
    sumcheck, and rebuilding the tuple was the verifier's top remaining
    cost (11.6k rebuilds / 0.15 s per bench verify)."""
    e = _RKEY_MEMO.get(id(r))
    if e is not None and e[0] is r:
        return e[1]
    if len(_RKEY_MEMO) > 2048:
        _RKEY_MEMO.clear()
    t = tuple(x.v for x in r)
    _RKEY_MEMO[id(r)] = (r, t)
    return t


def _table_mle_eval(spec, r) -> Fr:
    """Memoized K_CHUNK-table MLE evaluation: instances batched into one
    sumcheck share the verifier challenge r, so the same (spec, r) pair
    recurs hundreds of times per verify (measured ~0.2 s of redundant
    16-entry evaluates on the bench model)."""
    key = (spec, _point_key(r))
    got = _TEVAL_CACHE.get(key)
    if got is None:
        if len(_TEVAL_CACHE) > 8192:
            _TEVAL_CACHE.clear()
        got = MLPoly(ints=table_vec(spec)).evaluate(list(r))
        _TEVAL_CACHE[key] = got
    return got


class AddressReadCheckVerifier(SumcheckInstanceVerifier):
    def __init__(self, poly_id: CommittedPoly, sumcheck_id: SumcheckId,
                 table_spec, r_cycle: list[Fr], claim: Fr,
                 appends_opening: bool):
        self.poly_id = poly_id
        self.sumcheck_id = sumcheck_id
        self.table_spec = table_spec
        self.r_cycle = r_cycle
        self.claim = claim
        self.appends_opening = appends_opening

    def num_rounds(self) -> int:
        return len(table_vec(self.table_spec)).bit_length() - 1

    def degree(self) -> int:
        return 2

    def input_claim(self, accumulator) -> Fr:
        return self.claim

    def expected_output_claim(self, accumulator, r: list[Fr]) -> Fr:
        g_eval = _table_mle_eval(self.table_spec, r)
        ra_claim = accumulator.claim_of(
            OpeningId.committed(self.poly_id, self.sumcheck_id))
        return g_eval * ra_claim

    def cache_openings(self, accumulator, transcript, r: list[Fr]) -> None:
        if self.appends_opening:
            point = list(r) + list(self.r_cycle)
            accumulator.append_committed(
                transcript, OpeningId.committed(self.poly_id, self.sumcheck_id),
                point)


# ---------------------------------------------------------------------------
# Booleanity sumcheck (degree 3, LOG_K_CHUNK + log T rounds)
# ---------------------------------------------------------------------------

class BooleanityProver(_HostOnDemand, RowsInstance,
                       SumcheckInstanceProver):
    """0 = sum_{k,j} eq(r_b, (k,j)) * sum_d gamma_d * (ra_d^2 - ra_d).

    Sparse two-phase schedule (byte-identical messages to binding the dense
    (K, T) one-hot rows — it computes the same polynomial's round evals):

    Phase 1 (log K address rounds): the partially-bound one-hot is
        ra_d(k_rest, j) = U[c_d(j)] * [k_rest == low_bits(c_d(j))],
    where U[c] = prod over bound bits of the challenge line — exactly one
    nonzero per (d, j), so q(t) needs only a (K,) bucket sum of the split-eq
    pair weights by chunk value (one scatter_add per chunk per round) and
    16 table values. O(T) per round instead of O(K*T) — the reference's
    sparse Shout booleanity (joltworks/src/subprotocols/shout.rs) recast
    onto the Gruen weight schedule.

    Phase 2 (log T cycle rounds): the bound row is the dense T-vector
    U[c_d(j)] (a K-entry table gather), handed to the standard fused
    GruenInstance engine.

    The dense K*T rows are never materialized: callers pass the chunk-value
    index arrays. Falls back to dense rows without the native library. The
    host engine is built by ``ensure_host`` (``_HostOnDemand``), counting
    the batch's D x T one-hot elements as ``iop_rachecks_host``.
    """

    def __init__(self, poly_ids: list[CommittedPoly], index_arrays: list,
                 K: int, r_b: list[Fr], gammas: list[Fr]):
        self.poly_ids = poly_ids
        self.r_b = r_b
        self.gammas = gammas
        self._rounds = len(r_b)
        self.K = K
        self.logK = K.bit_length() - 1
        assert K & (K - 1) == 0 and self.logK >= 1
        self.idx = [np.ascontiguousarray(a, dtype=np.int64)
                    for a in index_arrays]
        self.T = 1 << (len(r_b) - self.logK)

    def _build_host(self) -> None:
        from ..device import telemetry
        from ..field import vec
        telemetry.tally("iop_rachecks_host", len(self.idx) * self.T)
        terms = []
        for d, gamma in enumerate(self.gammas):
            terms.append((gamma, [d, d]))
            terms.append((Fr.zero() - gamma, [d]))
        self._terms = terms
        if not vec.native_available():
            # object-int fallback: materialize dense rows (tests / no .so)
            ras = [one_hot_poly(a, K=self.K) for a in self.idx]
            self.setup_rows(ras, terms, 3, eq_r=self.r_b)
            self._sparse = False
            return
        self._sparse = True
        from ..poly.spliteq import SplitEq
        from ..field.frvec import FrArray
        self._se = SplitEq(self.r_b)
        self._U = FrArray.full(self.K, Fr.one())  # bound prefix weight
        self._rows_round = 0
        self._rows_deg = 3
        self._rows_fused = None
        self._gruen = None
        self._eq_offset = 0
        self._rows_terms = terms
        self._mlrows = []

    # -- phase 1: sparse address rounds -------------------------------------
    def _phase1_qev(self) -> list[Fr]:
        # one fused C pass over the (D, T) chunk indices: per (d, j) the
        # split-eq pair weight is bucketed by chunk value, then buckets
        # combine with U/U^2 and the current address bit (frv_onehot_qev).
        # Per-value math: x(t) = U[c] * (b ? t : 1-t), b = bit of c, so
        # t=0: b=0 -> x^2-x = U^2-U; b=1 -> 0
        # t=2: b=0 -> U^2+U;         b=1 -> 4U^2-2U
        from ..field import frvec
        rnd = self._rows_round
        whi, shift, wlo, log_wlo = self._se.tables(rnd)
        low_bits = self.logK - rnd - 1
        logT = self.T.bit_length() - 1
        q0, q2 = frvec.onehot_qev(self.idx, self._U, whi, shift, wlo,
                                  log_wlo, low_bits, logT, self.gammas)
        return [q0, q2]

    def _phase1_bind(self, r: Fr) -> None:
        from ..field import frvec
        from ..field.frvec import FrArray
        rnd = self._rows_round
        low_bits = self.logK - rnd - 1
        b = ((np.arange(self.K) >> low_bits) & 1).astype(bool)
        # U[c] *= (b ? r : 1 - r)   (Montgomery limb rows)
        mul = np.where(b[:, None], frvec._fr_limbs_cached(r)[0],
                       frvec._fr_limbs_cached(Fr.one() - r)[0])
        self._U = self._U.mul(FrArray(np.ascontiguousarray(
            mul.astype(np.uint64))))
        self._se.note_challenge(r, rnd)
        self._rows_round += 1
        if self._rows_round == self.logK:
            # phase boundary: materialize the dense T-rows U[c_d(j)] and
            # hand the cycle rounds to the fused Gruen engine
            from ..field.frvec import GruenInstance
            U_d = np.asarray(self._U.d)
            rows = [FrArray(np.ascontiguousarray(U_d[c])) for c in self.idx]
            self._gruen = GruenInstance(rows, self._terms, 3)
            self.idx = None

    def num_rounds(self) -> int:
        return self._rounds

    def degree(self) -> int:
        return 3

    def input_claim(self, accumulator) -> Fr:
        return Fr.zero()

    def compute_message(self, round: int, previous_claim: Fr) -> UniPoly:
        if self._sparse and self._rows_round < self.logK:
            return self._gruen_assemble(previous_claim, self._phase1_qev())
        return self.rows_message(previous_claim)

    def ingest_challenge(self, r: Fr, round: int) -> None:
        if self._sparse and self._rows_round < self.logK:
            self._phase1_bind(r)
            return
        self.rows_bind(r)

    def cache_openings(self, accumulator, transcript, r: list[Fr]) -> None:
        for d, pid in enumerate(self.poly_ids):
            accumulator.append_committed(
                transcript,
                OpeningId.committed(pid, SumcheckId.make("Booleanity")),
                list(r), self.row_final(d))


class BooleanityVerifier(SumcheckInstanceVerifier):
    def __init__(self, poly_ids: list[CommittedPoly], r_b: list[Fr],
                 gammas: list[Fr]):
        self.poly_ids = poly_ids
        self.r_b = r_b
        self.gammas = gammas

    def num_rounds(self) -> int:
        return len(self.r_b)

    def degree(self) -> int:
        return 3

    def input_claim(self, accumulator) -> Fr:
        return Fr.zero()

    def expected_output_claim(self, accumulator, r: list[Fr]) -> Fr:
        eq_eval = eq_eval_scalar(self.r_b, list(r))
        acc = Fr.zero()
        for pid, gamma in zip(self.poly_ids, self.gammas):
            c = accumulator.claim_of(
                OpeningId.committed(pid, SumcheckId.make("Booleanity")))
            acc = acc + gamma * (c * c - c)
        return eq_eval * acc

    def cache_openings(self, accumulator, transcript, r: list[Fr]) -> None:
        for pid in self.poly_ids:
            accumulator.append_committed(
                transcript,
                OpeningId.committed(pid, SumcheckId.make("Booleanity")),
                list(r))


# ---------------------------------------------------------------------------
# Full-table read-raf + ra-virtualization (reference shout.rs read_raf +
# ra_virtual.rs): lookups into materialized tables up to 2^16 entries whose
# one-hot read-address polynomial is committed as 4-bit chunks.
# ---------------------------------------------------------------------------

class ReadRafProver(RowsInstance, SumcheckInstanceProver):
    """rv_claim + gamma*raf_claim = sum_k G(k) * (Val(k) + gamma*k).

    G(k) = sum_j eq(r_cycle, j) [index_j = k]. Final: virtual full-ra claim
    at (r_address, r_cycle) (reference shout.rs:46-333).
    """

    def __init__(self, ra_opening_id: OpeningId, table: np.ndarray,
                 indices: np.ndarray, gamma: Fr, claim: Fr, r_cycle: list[Fr]):
        K = len(table)
        assert K & (K - 1) == 0
        self.ra_opening_id = ra_opening_id
        self.gamma = gamma
        self.claim = claim
        self.r_cycle = r_cycle
        eq_cycle = eq_evals(r_cycle)
        G = MLPoly(fvec=compute_G(indices.astype(np.int64), eq_cycle, K=K))
        # val[k] = table[k] + gamma * k, built natively (the object-int
        # round trip was ~0.3 s/prove across the four 2^16 teleport tables)
        tbl = vec.from_ints(table.astype(np.int64))
        from ..field import frvec
        if isinstance(tbl, frvec.FrArray):
            ident_f = frvec.FrArray.from_i64(np.arange(K, dtype=np.int64))
            val = tbl.add(ident_f.scale(gamma))
        else:
            ident = np.arange(K, dtype=object)
            val = (vec.as_object(tbl) + gamma.v * ident) % vec.R
        self._rounds = K.bit_length() - 1
        self.setup_rows([G, MLPoly(fvec=val)], [(Fr.one(), [0, 1])], 2)

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
            transcript, self.ra_opening_id, list(r) + list(self.r_cycle),
            self.row_final(0))


class ReadRafVerifier(SumcheckInstanceVerifier):
    def __init__(self, ra_opening_id: OpeningId, table: np.ndarray,
                 gamma: Fr, claim: Fr, r_cycle: list[Fr]):
        self.ra_opening_id = ra_opening_id
        self.table = table
        self.gamma = gamma
        self.claim = claim
        self.r_cycle = r_cycle
        self._rounds = len(table).bit_length() - 1

    def num_rounds(self):
        return self._rounds

    def degree(self):
        return 2

    def input_claim(self, accumulator):
        return self.claim

    def cache_openings(self, accumulator, transcript, r):
        accumulator.append_virtual(
            transcript, self.ra_opening_id, list(r) + list(self.r_cycle))

    def expected_output_claim(self, accumulator, r):
        ra_claim = accumulator.get_opening(self.ra_opening_id)[1]
        val_claim = MLPoly(ints=self.table.astype(np.int64)).evaluate(list(r))
        ident = Fr.zero()
        for i, ri in enumerate(r):
            ident = ident + ri * Fr(1 << (len(r) - 1 - i))
        return ra_claim * (val_claim + self.gamma * ident)


class RaVirtualizationProver(RowsInstance, SumcheckInstanceProver):
    """ra(r_address, r_cycle) = sum_j eq(r_cycle, j) prod_d ra_d(chunk slice, j).

    ra_d pre-bound at its 4-bit slice of r_address (chunk d = bits
    [4d, 4d+4), i.e. r_address slice [nv-4(d+1) : nv-4d] big-endian).
    Final: committed chunk openings at (r_addr_d, r_cycle')
    (reference ra_virtual.rs:105-185).
    """

    def __init__(self, poly_id_fn, num_chunks: int, chunks: np.ndarray,
                 r_address: list[Fr], r_cycle: list[Fr], claim: Fr,
                 sumcheck_id: SumcheckId):
        self.poly_id_fn = poly_id_fn
        self.num_chunks = num_chunks
        self.claim = claim
        self.sumcheck_id = sumcheck_id
        nv = len(r_address)
        self.r_addr_slices = []
        rows = []
        for d in range(num_chunks):
            sl = r_address[nv - 4 * (d + 1): nv - 4 * d]
            self.r_addr_slices.append(sl)
            eq_d = eq_evals(sl)
            rows.append(MLPoly(fvec=eq_d[chunks[d]]))
        self._rounds = len(r_cycle)
        self.setup_rows(rows, [(Fr.one(), list(range(num_chunks)))],
                        num_chunks + 1, eq_r=r_cycle)

    def num_rounds(self):
        return self._rounds

    def degree(self):
        return self.num_chunks + 1

    def input_claim(self, accumulator):
        return self.claim

    def compute_message(self, round, previous_claim):
        return self.rows_message(previous_claim)

    def ingest_challenge(self, r, round):
        self.rows_bind(r)

    def cache_openings(self, accumulator, transcript, r):
        for d in range(self.num_chunks):
            accumulator.append_committed(
                transcript,
                OpeningId.committed(self.poly_id_fn(d), self.sumcheck_id),
                list(self.r_addr_slices[d]) + list(r),
                self.row_final(d))


class RaVirtualizationVerifier(SumcheckInstanceVerifier):
    def __init__(self, poly_id_fn, num_chunks: int, r_address: list[Fr],
                 r_cycle: list[Fr], claim: Fr, sumcheck_id: SumcheckId):
        self.poly_id_fn = poly_id_fn
        self.num_chunks = num_chunks
        self.r_address = r_address
        self.r_cycle = r_cycle
        self.claim = claim
        self.sumcheck_id = sumcheck_id

    def num_rounds(self):
        return len(self.r_cycle)

    def degree(self):
        return self.num_chunks + 1

    def input_claim(self, accumulator):
        return self.claim

    def _slices(self):
        nv = len(self.r_address)
        return [self.r_address[nv - 4 * (d + 1): nv - 4 * d]
                for d in range(self.num_chunks)]

    def cache_openings(self, accumulator, transcript, r):
        for d, sl in enumerate(self._slices()):
            accumulator.append_committed(
                transcript,
                OpeningId.committed(self.poly_id_fn(d), self.sumcheck_id),
                list(sl) + list(r))

    def expected_output_claim(self, accumulator, r):
        acc = eq_eval_scalar(self.r_cycle, list(r))
        for d in range(self.num_chunks):
            acc = acc * accumulator.claim_of(
                OpeningId.committed(self.poly_id_fn(d), self.sumcheck_id))
        return acc


# ---------------------------------------------------------------------------
# Pairwise chunk-indicator checks for variable-vs-variable comparisons
# (the chunked analogue of the reference's binary prefix-suffix shout,
# ps_shout/binary.rs: "R < divisor" checks with interleaved operands).
#
#   EqPair:  claim = sum_{k,j}    eq(r',j) * ra_a(k,j) * ra_b(k,j)
#   LtPair:  claim = sum_{k,k',j} LT16(k,k') * eq(r',j) * ra_a(k,j) * ra_b(k',j)
#
# verifying the materialized indicator polys [a_d == b_d], [a_d < b_d].
# ---------------------------------------------------------------------------

LT16 = (np.arange(K_CHUNK)[:, None] < np.arange(K_CHUNK)[None, :]).astype(np.int64)


class EqPairCheckProver(RowsInstance, SumcheckInstanceProver):
    def __init__(self, pid_a: CommittedPoly, pid_b: CommittedPoly,
                 sid: SumcheckId, chunks_a, chunks_b, r_cycle, claim: Fr):
        T = len(chunks_a)
        self.pid_a, self.pid_b, self.sid = pid_a, pid_b, sid
        self.claim = claim
        # eq(r_cycle) = split weight over the trailing cycle vars; the 4
        # chunk-address vars are plain (eq_pre) rounds.
        ra = one_hot_poly(chunks_a)
        rb = one_hot_poly(chunks_b)
        self.r_cycle = r_cycle
        self._rounds = ra.num_vars
        self.setup_rows([ra, rb], [(Fr.one(), [0, 1])], 3,
                        eq_r=r_cycle, eq_pre=LOG_K_CHUNK)

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
        accumulator.append_committed(
            transcript, OpeningId.committed(self.pid_a, self.sid), list(r),
            self.row_final(0))
        accumulator.append_committed(
            transcript, OpeningId.committed(self.pid_b, self.sid), list(r),
            self.row_final(1))


class EqPairCheckVerifier(SumcheckInstanceVerifier):
    def __init__(self, pid_a, pid_b, sid, log_t: int, r_cycle, claim: Fr):
        self.pid_a, self.pid_b, self.sid = pid_a, pid_b, sid
        self.log_t = log_t
        self.r_cycle = r_cycle
        self.claim = claim

    def num_rounds(self):
        return LOG_K_CHUNK + self.log_t

    def degree(self):
        return 3

    def input_claim(self, accumulator):
        return self.claim

    def cache_openings(self, accumulator, transcript, r):
        accumulator.append_committed(
            transcript, OpeningId.committed(self.pid_a, self.sid), list(r))
        accumulator.append_committed(
            transcript, OpeningId.committed(self.pid_b, self.sid), list(r))

    def expected_output_claim(self, accumulator, r):
        a = accumulator.claim_of(OpeningId.committed(self.pid_a, self.sid))
        b = accumulator.claim_of(OpeningId.committed(self.pid_b, self.sid))
        eqv = eq_eval_scalar(self.r_cycle, list(r)[LOG_K_CHUNK:])
        return eqv * a * b


class LtPairCheckProver(RowsInstance, SumcheckInstanceProver):
    def __init__(self, pid_a: CommittedPoly, pid_b: CommittedPoly,
                 sid: SumcheckId, chunks_a, chunks_b, r_cycle, claim: Fr):
        T = len(chunks_a)
        self.pid_a, self.pid_b, self.sid = pid_a, pid_b, sid
        self.claim = claim
        self.r_cycle = r_cycle
        # domain (k, k', j): weight = LT16(k,k') as an integer row times a
        # split-eq weight over j (the 8 address vars are plain rounds)
        lt_row = np.ascontiguousarray(np.broadcast_to(
            LT16[:, :, None], (K_CHUNK, K_CHUNK, T))).reshape(-1)
        # lifted one-hots: A(k,k',j) = ra_a(k,j); B(k,k',j) = ra_b(k',j)
        oa = np.zeros((K_CHUNK, T), dtype=np.int64)
        oa[chunks_a, np.arange(T)] = 1
        ob = np.zeros((K_CHUNK, T), dtype=np.int64)
        ob[chunks_b, np.arange(T)] = 1
        A = np.broadcast_to(oa[:, None, :], (K_CHUNK, K_CHUNK, T))
        B = np.broadcast_to(ob[None, :, :], (K_CHUNK, K_CHUNK, T))
        lt = MLPoly(ints=lt_row)
        ra = MLPoly(ints=np.ascontiguousarray(A).reshape(-1))
        rb = MLPoly(ints=np.ascontiguousarray(B).reshape(-1))
        self._rounds = ra.num_vars
        self.setup_rows([lt, ra, rb], [(Fr.one(), [0, 1, 2])], 3,
                        eq_r=r_cycle, eq_pre=2 * LOG_K_CHUNK)

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
        r_k = list(r)[:LOG_K_CHUNK]
        r_k2 = list(r)[LOG_K_CHUNK:2 * LOG_K_CHUNK]
        r_j = list(r)[2 * LOG_K_CHUNK:]
        # lifted polys are constant along the other index, so their fully
        # bound values ARE ra_a(r_k, r_j) / ra_b(r_k2, r_j)
        accumulator.append_committed(
            transcript, OpeningId.committed(self.pid_a, self.sid),
            r_k + r_j, self.row_final(1))
        accumulator.append_committed(
            transcript, OpeningId.committed(self.pid_b, self.sid),
            r_k2 + r_j, self.row_final(2))


class LtPairCheckVerifier(SumcheckInstanceVerifier):
    def __init__(self, pid_a, pid_b, sid, log_t: int, r_cycle, claim: Fr):
        self.pid_a, self.pid_b, self.sid = pid_a, pid_b, sid
        self.log_t = log_t
        self.r_cycle = r_cycle
        self.claim = claim

    def num_rounds(self):
        return 2 * LOG_K_CHUNK + self.log_t

    def degree(self):
        return 3

    def input_claim(self, accumulator):
        return self.claim

    def cache_openings(self, accumulator, transcript, r):
        r_k = list(r)[:LOG_K_CHUNK]
        r_k2 = list(r)[LOG_K_CHUNK:2 * LOG_K_CHUNK]
        r_j = list(r)[2 * LOG_K_CHUNK:]
        accumulator.append_committed(
            transcript, OpeningId.committed(self.pid_a, self.sid), r_k + r_j)
        accumulator.append_committed(
            transcript, OpeningId.committed(self.pid_b, self.sid), r_k2 + r_j)

    def expected_output_claim(self, accumulator, r):
        a = accumulator.claim_of(OpeningId.committed(self.pid_a, self.sid))
        b = accumulator.claim_of(OpeningId.committed(self.pid_b, self.sid))
        r_k = list(r)[:LOG_K_CHUNK]
        r_k2 = list(r)[LOG_K_CHUNK:2 * LOG_K_CHUNK]
        r_j = list(r)[2 * LOG_K_CHUNK:]
        lt_eval = MLPoly(ints=LT16.reshape(-1)).evaluate(r_k + r_k2)
        return lt_eval * eq_eval_scalar(self.r_cycle, r_j) * a * b
