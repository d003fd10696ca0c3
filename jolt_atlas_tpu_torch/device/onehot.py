"""The IOP's one-hot read checks on the card: a node's batched sumcheck of
one Booleanity and its AddressReadChecks (subprotocols/onehot.py), proved
by one device engine for the whole batch, with plain versions, kernel
wrappers and the engine's entry point ``try_prove``.

Every lookup node (Add, Sub, Mul, Einsum, ReLU, Gather, the LayerNorm row
statistics, ...) ends its proof with such a batch
(zkops/framework.py:build_ra_checks_provers; Gather's pair in zkops/ops.py):
a Booleanity over D chunk-index rows of T cycles (log K + log T rounds,
degree 3) and tens of read checks of K-entry tables (log K rounds, degree
2), each instance tiny. The host proves them instance by instance and round
by round; here one launch a round does every instance and one fetch brings
the batched polynomial back (csrc/onehot.cu):

- set-up, one staged upload: the chunk rows as bytes (int32 where K >
  256), the challenges r_b and r_cycle, 1 / r_b, the gammas, the batching
  coefficients, the read checks' claims (canonical), the K-entry tables of
  every table kind in the batch (once each) and the read checks' (table,
  row) map; then ``prepare`` (the scalars into Montgomery form and every eq
  table from the challenges) and ``buckets`` (G_d, the read checks'
  cycle-bound rows, and H_d, the Booleanity's address-round weights, both
  bucket sums of an eq table by chunk value);
- each round, ``round_``: one launch binds every row, U and claim at the
  previous challenge and forms the round's batched polynomial; its four
  coefficients come back in one fetch into pinned memory. The host
  compresses the polynomial, appends it to its transcript and draws the
  challenge, as BatchedSumcheck.prove does: the transcript stays the
  host's, so the engine runs under any transcript (BLAKE2b, Keccak);
- the close: the same launch at round M binds at the last challenge and
  fetches the D row values and the D G values once; cache_openings runs on
  the host in the batch's order.

The proof bytes equal the host path's: each instance's polynomial is the
field polynomial the host computes (the claims feed the same hints: p(1) =
claim - p(0) for a read check, es q(1) = (claim - l0 es q(0)) / l1 for the
Booleanity).

Which batches it takes (``decline``): under its ``Scope`` (the prover
enters it around its IOP loop, AtlasProver._iop_engines), a batch of one
Booleanity and read checks of its rows, with no zero coordinate of r_b
(the Gruen line's hint has no inverse there). Each decline is counted with its reason in the scope, which
records them in telemetry.decisions["rachecks:declined"] on exit; the host
path runs those. Counters: ``iop_rachecks_card`` (the engine's D x T a
batch; the host path counts ``iop_rachecks_host``) and
``iop_rows_bound_card`` (the Booleanity's cycle-round binds, P x n each,
as DeviceGruen's). Spans, inside the batch's ``sumcheck:`` span:
rachecks_upload, rachecks_rounds, rachecks_fetch.

Each wrapper dispatches on its tensors' device: CUDA tensors launch the
kernel, CPU tensors run the plain version, with no fallback from one to the
other. Field elements are (n, 4) int64 rows of Montgomery limbs
(device/field.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..field.constants import FR_MODULUS
from ..field.scalar import Fr, batch_inverse
from ..utils.profiling import span
from . import telemetry
from .field import (FR, NLIMBS, _carry, from_planes, int_to_limbs64,
                    to_planes)
from .reduction import mont_rows

MAX_VARS = 64      # r_b's most coordinates (csrc/onehot.cu OH_MAX_VARS)
THREADS = 256      # a block (OH_THREADS)
BYTE_K = 256       # chunk values up to this go up as bytes, wider as int32
_MASK64 = (1 << 64) - 1
_R2_LIMBS = int_to_limbs64(pow(2, 512, FR_MODULUS))  # R^2 mod r, raw
_INV2 = (FR_MODULUS + 1) // 2

# the workspace layout's fields, csrc/onehot.cu OhLay's order
FIELDS = ("M", "logK", "K", "logT", "T", "D", "N", "S", "wide",
          "r2", "stage", "TB", "rcmap", "mv", "l0", "eqC", "E", "A", "GB",
          "H", "U", "es", "sB", "Cc", "rcc", "rcp", "B", "partials", "out")


# ---------------------------------------------------------------------------
# the scope
# ---------------------------------------------------------------------------

class Scope(telemetry.EngineScope):
    """While entered, BatchedSumcheck.prove offers its read-check batches to
    ``try_prove`` (telemetry.EngineScope: decisions["rachecks"] and
    ["rachecks:declined"], the engine's one-hot elements the
    ``iop_rachecks_card`` counter)."""

    ENGINE, COUNTER = "rachecks", "iop_rachecks_card"
    ITEMS, ELEMENTS = "batches", "one-hot elements"


# ---------------------------------------------------------------------------
# the workspace
# ---------------------------------------------------------------------------

def booleanity_blocks(lay: "Layout", rnd: int) -> int:
    """The Booleanity's blocks in round rnd (csrc oh_booleanity_blocks):
    one in an address round, a thread a (row, pair) in a cycle round, a
    thread a row at the close."""
    if rnd < lay.logK:
        return 1
    ci = rnd - lay.logK
    work = lay.D * (lay.T >> (ci + 1)) if ci < lay.logT else lay.D
    return -(-work // THREADS)


class Layout:
    """A batch's workspace, rows of one field element ((n, 4) int64): the
    staged head first (R^2 raw, the canonical scalars, the tables, the read
    checks' (table, row) map), then what the kernels write. ``mv``: the
    scalars in Montgomery form, in the staged order (``scalars``)."""

    def __init__(self, K: int, T: int, D: int, N: int, S: int):
        self.K, self.T, self.D, self.N, self.S = K, T, D, N, S
        self.logK = K.bit_length() - 1
        self.logT = T.bit_length() - 1
        self.M = self.logK + self.logT
        self.wide = int(K > BYTE_K)
        self.ns = 2 * self.M + self.logT + D + 2 * N + 2
        o = 0

        def take(n: int) -> int:
            nonlocal o
            o += n
            return o - n
        self.r2 = take(1)
        self.stage = take(self.ns)
        self.TB = take(S * K)
        self.rcmap = take(N)
        self.head = o
        self.mv = take(self.ns)
        self.l0 = take(self.M)
        self.eqC = take(T)
        self.E = take(2 * T - 1)
        self.A = take(K - 1)
        self.GB = take(D * K)
        self.H = take(D * K)
        self.U = take(2 * K)
        self.es = take(1)
        self.sB = take(4)
        self.Cc = take(1)
        self.rcc = take(N)
        self.rcp = take(3 * N)
        self.B = take(2 * D * (T // 2))
        self.blocks = max(booleanity_blocks(self, rnd)
                          for rnd in range(self.M + 1))
        self.partials = take(4 * (self.blocks + 1))
        self.out = take(max(4, 2 * D))
        self.rows = o

    def fields(self) -> np.ndarray:
        return np.asarray([getattr(self, f) for f in FIELDS], dtype=np.int64)

    def scalars(self) -> dict:
        """Offsets of the scalars in mv (csrc oh_scalars)."""
        rb = self.mv
        rc = rb + self.M
        inv = rc + self.logT
        gam = inv + self.M
        coef = gam + self.D
        claim0 = coef + 1 + self.N
        return {"rb": rb, "rc": rc, "inv": inv, "gam": gam, "coef": coef,
                "claim0": claim0, "inv2": claim0 + self.N}


_TABLES: dict = {}


def table_rows(spec, K: int) -> np.ndarray:
    """A table kind's K entries as Montgomery rows, made once a process."""
    from ..subprotocols.onehot import table_vec
    key = (repr(spec), K)
    got = _TABLES.get(key)
    if got is None:
        got = _TABLES[key] = mont_rows(int(v) for v in table_vec(spec))
    return got


def _canonical(values) -> np.ndarray:
    """Fr values or canonical ints -> (n, 4) int64 rows of their limbs."""
    raw = b"".join((v.v if isinstance(v, Fr) else int(v)).to_bytes(
        32, "little") for v in values)
    return np.frombuffer(raw, dtype="<i8").reshape(-1, 4)


class Batch:
    """One batch's workspace on ``device``: ``ws`` ((rows, 4) int64) and
    ``idx`` (the (D, T) chunk indices, flat: uint8, or int32 where wide),
    one buffer filled by one upload of the indices and the layout's head.
    The kernels write every other row before they read it."""

    def __init__(self, idx_rows: np.ndarray, K: int, r_b, r_cycle, gammas,
                 coeffs, claims, specs: list, rcmap: list, device):
        D, T = idx_rows.shape
        N = len(rcmap)
        self.lay = lay = Layout(K, T, D, N, len(specs))
        self.fields = lay.fields()
        self.device = torch.device(device)
        idx = idx_rows.astype(np.int32 if lay.wide else np.uint8)
        nidx = idx.nbytes
        off = -(-nidx // 32) * 32
        head = np.zeros((lay.head, 4), dtype=np.int64)
        head[lay.r2] = _R2_LIMBS
        head[lay.stage:lay.stage + lay.ns] = _canonical(
            list(r_b) + list(r_cycle)
            + batch_inverse(list(r_b)) + list(gammas)
            + list(coeffs) + list(claims) + [_INV2])
        for s, spec in enumerate(specs):
            head[lay.TB + s * K:lay.TB + (s + 1) * K] = table_rows(spec, K)
        if N:
            head[lay.rcmap:lay.rcmap + N, :2] = np.asarray(rcmap)
        staged = np.zeros(off + head.nbytes, dtype=np.uint8)
        staged[:nidx] = idx.reshape(-1).view(np.uint8)
        staged[off:] = head.reshape(-1).view(np.uint8)
        make = torch.zeros if self.device.type == "cpu" else torch.empty
        buf = make(off + lay.rows * 32, dtype=torch.uint8, device=self.device)
        buf[:len(staged)].copy_(torch.from_numpy(staged))  # the one upload
        self.ws = buf[off:].view(torch.int64).view(lay.rows, 4)
        self.idx = buf[:nidx].view(torch.int32 if lay.wide else torch.uint8)
        _check(self)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _one(device) -> torch.Tensor:
    return torch.tensor(FR.MONT_ONE_LIMBS, dtype=torch.int64,
                        device=device)[:, None]


def _raw(value: int, device) -> torch.Tensor:
    """(16, 1) planes of a raw (not Montgomery) value."""
    return to_planes(torch.tensor([int_to_limbs64(value)], dtype=torch.int64,
                                  device=device))


def _ld(ws, off: int, n: int) -> torch.Tensor:
    return to_planes(ws[off:off + n])


def _st(ws, off: int, planes: torch.Tensor) -> None:
    ws[off:off + planes.shape[1]] = from_planes(planes)


def _canon(x: torch.Tensor) -> torch.Tensor:
    return FR.mul(x, _raw(1, x.device))


def _bind(lo, hi, r) -> torch.Tensor:
    return FR.add(lo, FR.mul(FR.sub(hi, lo), r))


def _dbl(x) -> torch.Tensor:
    return FR.add(x, x)


def _sum(x) -> torch.Tensor:
    """(16, n) -> (16, 1): the sum of the n values."""
    return FR.sum(x[:, None, :])


def eq_plain(c1, c0, nv: int) -> torch.Tensor:
    """(16, 2^nv): eq(c, x) for every x, x's top bit taking c[0]; c1 the
    challenges' planes, c0 one minus them."""
    size = 1 << nv
    x = torch.arange(size, device=c1.device)
    p = _one(c1.device).expand(NLIMBS, size).contiguous()
    for i in range(nv):
        bit = ((x >> (nv - 1 - i)) & 1).bool()[None, :]
        p = FR.mul(p, torch.where(bit, c1[:, i:i + 1], c0[:, i:i + 1]))
    return p


def prepare_plain(ws, lay: Layout) -> None:
    """onehot_prepare_kernel's function."""
    M, logK, logT, T, K = lay.M, lay.logK, lay.logT, lay.T, lay.K
    one = _one(ws.device)
    mv = FR.mul(_ld(ws, lay.stage, lay.ns), _ld(ws, lay.r2, 1))
    _st(ws, lay.mv, mv)
    rb, rc = mv[:, :M], mv[:, M:M + logT]
    rb0 = FR.sub(one, rb)
    _st(ws, lay.l0, rb0)
    _st(ws, lay.eqC, eq_plain(rc, FR.sub(one, rc), logT))
    off = 0
    for s in range(logK, M + 1):
        tab = eq_plain(rb[:, s:], rb0[:, s:], M - s)
        _st(ws, lay.E + off, tab)
        off += tab.shape[1]
    off = 0
    for lv in range(logK):
        tab = eq_plain(rb[:, lv + 1:logK], rb0[:, lv + 1:logK],
                       logK - lv - 1)
        _st(ws, lay.A + off, tab)
        off += tab.shape[1]
    _st(ws, lay.U, one.expand(NLIMBS, K))
    _st(ws, lay.es, one)


def _reduce_sums(acc: torch.Tensor) -> torch.Tensor:
    """(16, m) planes, each the integer sum of fewer than 2^47 canonical
    16-bit planes -> (16, m) canonical: the sums' values mod r, split as
    lo + hi 2^256 (lo < 2^256 < 6r, hi < 2^64) and reduced as lo mod r +
    hi (2^256 mod r)."""
    m = acc.shape[1]
    t = torch.zeros((NLIMBS + 4, m), dtype=torch.int64, device=acc.device)
    t[:NLIMBS] = acc
    _carry(t)
    lo = torch.zeros((NLIMBS + 1, m), dtype=torch.int64, device=acc.device)
    lo[:NLIMBS] = t[:NLIMBS]
    for _ in range(5):  # lo - k r for the k that leaves it below r
        lo[:NLIMBS] = FR.cond_sub_p(lo)
        lo[NLIMBS] = 0
    hi = torch.zeros((NLIMBS, m), dtype=torch.int64, device=acc.device)
    hi[:4] = t[NLIMBS:]
    # Montgomery: hi R^2 / R = hi 2^256 mod r
    return FR.add(lo[:NLIMBS], FR.mul(hi, _raw(pow(2, 512, FR_MODULUS),
                                               acc.device)))


def buckets_plain(ws, lay: Layout, idx) -> None:
    """onehot_buckets_kernel's function: GB[d K + k] and H[d K + k], the
    sums of eq(r_cycle)[j] and E_logK[j] over the j with chunk d equal to
    k (each row's planes summed by chunk value as integers, then reduced
    mod r: the Montgomery form of a sum is the sum of the forms)."""
    D, T, K = lay.D, lay.T, lay.K
    ix = idx.reshape(D, T).to(torch.int64)
    for src, dst in ((lay.eqC, lay.GB), (lay.E, lay.H)):
        vals = _ld(ws, src, T)
        acc = torch.zeros((NLIMBS, D * K), dtype=torch.int64,
                          device=ws.device)
        for d in range(D):
            acc[:, d * K:(d + 1) * K].index_add_(1, ix[d], vals)
        _st(ws, dst, _reduce_sums(acc))


def _words_planes(words, device) -> torch.Tensor:
    v = sum(int(w) << (64 * i) for i, w in enumerate(words))
    return _raw(v, device)


def round_plain(ws, lay: Layout, idx, rnd: int, words) -> None:
    """onehot_round_kernel's function: round rnd (M: the close) at the
    previous challenge (canonical words, least significant first); writes
    the state and ``out`` as the kernel does."""
    M, logK, K, logT, T, D, N, S = (lay.M, lay.logK, lay.K, lay.logT, lay.T,
                                    lay.D, lay.N, lay.S)
    dev = ws.device
    sc = lay.scalars()
    one = _one(dev)
    zero = torch.zeros((NLIMBS, 1), dtype=torch.int64, device=dev)
    r = r0 = None
    if rnd > 0:
        r = FR.mul(_words_planes(words, dev), _ld(ws, lay.r2, 1))
        r0 = FR.sub(one, r)
    ix = idx.reshape(D, T).to(torch.int64)
    gam = _ld(ws, sc["gam"], D)

    def u_at(c) -> torch.Tensor:  # U in round rnd <= logK at values c
        c = c.reshape(-1)
        if rnd == 0:
            return to_planes(ws[lay.U + c])
        u = to_planes(ws[lay.U + ((rnd - 1) & 1) * K + c])
        bit = ((c >> (logK - rnd)) & 1).bool()[None, :]
        return FR.mul(u, torch.where(bit, r, r0))

    def u_final(c) -> torch.Tensor:
        return to_planes(ws[lay.U + (logK & 1) * K + c.reshape(-1)])

    # -- the Booleanity
    q0 = q2 = None
    if rnd < logK:
        low = logK - rnd - 1
        k = torch.arange(K, device=dev)
        u = u_at(k).repeat(1, D)
        a = to_planes(ws[lay.A + K - (K >> rnd) + (k & ((1 << low) - 1))])
        g = FR.mul(_ld(ws, lay.H, D * K), a.repeat(1, D))
        gu = FR.mul(g, u)
        gu2 = FR.mul(gu, u)
        bit = ((k >> low) & 1).bool().repeat(D)[None, :]
        v0 = torch.where(bit, zero, FR.sub(gu2, gu))
        v2 = torch.where(bit, FR.sub(_dbl(_dbl(gu2)), _dbl(gu)),
                         FR.add(gu2, gu))
        gk = gam.repeat_interleave(K, 1)
        q0, q2 = _sum(FR.mul(gk, v0)), _sum(FR.mul(gk, v2))
    else:
        ci, rs = rnd - logK, T >> 1
        n = T >> ci
        Bv = ws[lay.B:lay.B + 2 * D * rs].view(2, D, rs, 4)
        if ci < logT:
            half = n >> 1
            if ci == 0:
                lo, hi = u_at(ix[:, :half]), u_at(ix[:, half:n])
            else:
                if ci == 1:
                    lo = _bind(u_final(ix[:, :half]),
                               u_final(ix[:, rs:rs + half]), r)
                    hi = _bind(u_final(ix[:, half:n]),
                               u_final(ix[:, rs + half:rs + n]), r)
                else:
                    P = Bv[(ci - 1) & 1]
                    flat = lambda t: to_planes(t.reshape(-1, 4))
                    lo = _bind(flat(P[:, :half]), flat(P[:, n:n + half]), r)
                    hi = _bind(flat(P[:, half:n]),
                               flat(P[:, n + half:2 * n]), r)
                Q = Bv[ci & 1]
                Q[:, :half] = from_planes(lo).view(D, half, 4)
                Q[:, half:n] = from_planes(hi).view(D, half, 4)
            w = _ld(ws, lay.E + 2 * T - n, half).repeat(1, D)
            gw = FR.mul(gam.repeat_interleave(half, 1), w)
            e2 = FR.sub(_dbl(hi), lo)
            q0 = _sum(FR.mul(gw, FR.sub(FR.mul(lo, lo), lo)))
            q2 = _sum(FR.mul(gw, FR.sub(FR.mul(e2, e2), e2)))
        else:  # the close
            if ci == 1:
                v = _bind(u_final(ix[:, 0]), u_final(ix[:, 1]), r)
            else:
                P = Bv[(ci - 1) & 1]
                v = _bind(to_planes(P[:, 0]), to_planes(P[:, 1]), r)
            _st(ws, lay.out, _canon(v))

    # -- the read checks
    part = None
    if N:
        jr = M - logK
        if rnd < jr:
            if rnd == 0:
                cc = _sum(FR.mul(_ld(ws, sc["coef"] + 1, N),
                                 _ld(ws, sc["claim0"], N)))
                _st(ws, lay.Cc, cc)
            else:
                cc = _ld(ws, lay.Cc, 1)
            for _ in range(jr - rnd - 1):
                cc = _dbl(cc)
            part = [cc, zero, zero]
        else:
            lv = rnd - jr
            TB = ws[lay.TB:lay.TB + S * K].view(S, K, 4)
            GB = ws[lay.GB:lay.GB + D * K].view(D, K, 4)
            if lv >= 1:
                h2 = K >> lv
                for X, rows in ((TB, S), (GB, D)):
                    if rows:
                        X[:, :h2] = from_planes(_bind(
                            to_planes(X[:, :h2].reshape(-1, 4)),
                            to_planes(X[:, h2:2 * h2].reshape(-1, 4)),
                            r)).view(rows, h2, 4)
                c = ws[lay.rcp:lay.rcp + 3 * N].view(N, 3, 4)
                c0, c1, c2 = (to_planes(c[:, k]) for k in range(3))
                _st(ws, lay.rcc, FR.add(c0, FR.mul(r, FR.add(
                    c1, FR.mul(r, c2)))))
            else:
                ws[lay.rcc:lay.rcc + N] = ws[sc["claim0"]:sc["claim0"] + N]
            if lv < logK:
                half = K >> (lv + 1)
                mp = ws[lay.rcmap:lay.rcmap + N]
                s_i, d_i = mp[:, 0], mp[:, 1]
                flat = lambda t: to_planes(t.reshape(-1, 4))
                tl, th = flat(TB[s_i, :half]), flat(TB[s_i, half:2 * half])
                gl, gh = flat(GB[d_i, :half]), flat(GB[d_i, half:2 * half])
                p0 = FR.sum(FR.mul(tl, gl).reshape(NLIMBS, N, half))
                p2 = FR.sum(FR.mul(FR.sub(_dbl(th), tl), FR.sub(
                    _dbl(gh), gl)).reshape(NLIMBS, N, half))
                p1 = FR.sub(_ld(ws, lay.rcc, N), p0)
                c2 = FR.mul(FR.add(FR.sub(p2, _dbl(p1)), p0),
                            _ld(ws, sc["inv2"], 1))
                c1 = FR.sub(FR.sub(p1, p0), c2)
                ws[lay.rcp:lay.rcp + 3 * N] = torch.stack(
                    [from_planes(p0), from_planes(c1), from_planes(c2)],
                    1).reshape(-1, 4)
                cf = _ld(ws, sc["coef"] + 1, N)
                part = [_sum(FR.mul(cf, x)) for x in (p0, c1, c2)]
            else:  # the close
                _st(ws, lay.out + D, _canon(to_planes(GB[:, 0])))

    # -- the batched polynomial
    if rnd < M:
        es, claim = _ld(ws, lay.es, 1), zero
        if rnd > 0:
            pl0 = _ld(ws, lay.l0 + rnd - 1, 1)
            pl1 = _ld(ws, sc["rb"] + rnd - 1, 1)
            es = FR.mul(es, FR.add(pl0, FR.mul(r, FR.sub(pl1, pl0))))
            _st(ws, lay.es, es)
            sB = _ld(ws, lay.sB, 4)
            claim = sB[:, 3:4]
            for k in (2, 1, 0):
                claim = FR.add(sB[:, k:k + 1], FR.mul(r, claim))
        l0 = _ld(ws, lay.l0 + rnd, 1)
        l1 = _ld(ws, sc["rb"] + rnd, 1)
        e0, e2 = FR.mul(es, q0), FR.mul(es, q2)
        e1 = FR.mul(FR.sub(claim, FR.mul(l0, e0)), _ld(ws, sc["inv"] + rnd, 1))
        E2 = FR.mul(FR.add(FR.sub(e2, _dbl(e1)), e0), _ld(ws, sc["inv2"], 1))
        E1 = FR.sub(FR.sub(e1, e0), E2)
        b = FR.sub(l1, l0)
        s = torch.cat([FR.mul(l0, e0), FR.add(FR.mul(l0, E1), FR.mul(b, e0)),
                       FR.add(FR.mul(l0, E2), FR.mul(b, E1)), FR.mul(b, E2)],
                      1)
        _st(ws, lay.sB, s)
        o = FR.mul(_ld(ws, sc["coef"], 1), s)
        if part is not None:
            o = FR.add(o, torch.cat(part + [zero], 1))
        _st(ws, lay.out, _canon(o))
        if 1 <= rnd <= logK:
            _st(ws, lay.U + (rnd & 1) * K, u_at(torch.arange(K, device=dev)))


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def round_case(lay: Layout, rnd: int) -> int:
    """The branch shape of a round launch: 0 an address round, 1 the
    gathered first cycle round, 2 the gathered and bound second, 3 a later
    cycle round, 4 the close. Its launches are recorded at (wide, case):
    the chunk indices' type changes the gathers of cases 1, 2 and 4."""
    if rnd < lay.logK:
        return 0
    ci = rnd - lay.logK
    return 4 if ci == lay.logT else min(ci + 1, 3)


def _check(b: Batch) -> None:
    lay, ws, idx = b.lay, b.ws, b.idx
    if ws.dtype != torch.int64 or ws.shape != (lay.rows, 4) or (
            not ws.is_contiguous() or ws.data_ptr() % 16):
        raise ValueError(f"onehot: a contiguous, 16-byte aligned int64 "
                         f"workspace of ({lay.rows}, 4) expected, got "
                         f"{ws.dtype} {tuple(ws.shape)}")
    want = torch.int32 if lay.wide else torch.uint8
    if idx.dtype != want or idx.numel() != lay.D * lay.T or (
            idx.device != ws.device or not idx.is_contiguous()):
        raise ValueError(f"onehot: {lay.D} x {lay.T} chunk indices of "
                         f"{want} on {ws.device} expected")
    if ws.device.type not in ("cpu", "cuda"):
        raise ValueError(f"onehot: no kernel for device {ws.device}")
    if lay.M > MAX_VARS or lay.logT < 1:
        raise ValueError(f"onehot: 1 <= log T and M <= {MAX_VARS}")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def prepare(b: Batch) -> None:
    """The set-up's first launch (its plain version on CPU tensors)."""
    if b.ws.device.type == "cpu":
        return prepare_plain(b.ws, b.lay)
    from . import build
    with torch.cuda.device(b.device):
        rc = build.cuda_library().jolt_onehot_prepare(
            b.ws.data_ptr(), b.fields.ctypes.data, _stream(b.device))
    if rc != 0:
        raise RuntimeError(f"onehot_prepare kernel launch failed: CUDA "
                           f"error {rc}")
    telemetry.launch("onehot_prepare", 0)


def buckets(b: Batch) -> None:
    """The set-up's second launch, GB and H (its plain version on CPU
    tensors)."""
    if b.ws.device.type == "cpu":
        return buckets_plain(b.ws, b.lay, b.idx)
    from . import build
    with torch.cuda.device(b.device):
        rc = build.cuda_library().jolt_onehot_buckets(
            b.ws.data_ptr(), b.fields.ctypes.data, b.idx.data_ptr(),
            _stream(b.device))
    if rc != 0:
        raise RuntimeError(f"onehot_buckets kernel launch failed: CUDA "
                           f"error {rc}")
    telemetry.launch("onehot_buckets", b.lay.wide)


_CARDS: dict = {}


def _card(device, rows: int) -> tuple:
    """(the round kernel's ticket counter, a pinned (rows, 4) int64 fetch
    buffer and its numpy view) of a CUDA device, grown to ``rows``."""
    k = device.index if device.index is not None else \
        torch.cuda.current_device()
    got = _CARDS.get(k)
    if got is None or got[1].shape[0] < rows:
        counter = got[0] if got else torch.zeros(
            1, dtype=torch.int32, device=torch.device("cuda", k))
        pinned = torch.empty((max(rows, 64), 4), dtype=torch.int64,
                             pin_memory=True)
        got = _CARDS[k] = (counter, pinned, pinned.numpy())
    return got


def round_(b: Batch, rnd: int, r: Fr | None, nout: int,
           fetch: bool = True) -> np.ndarray | None:
    """Round rnd (M: the close) at the previous challenge r: the kernel on
    CUDA tensors, its plain version on CPU ones. With ``fetch``, the
    round's ``nout`` out rows (canonical limbs) come back: on the card the
    launch, a copy into pinned memory and the stream's synchronisation are
    one call. The batch's tensors were checked when it was made."""
    lay = b.lay
    if not 0 <= rnd <= lay.M or (rnd > 0) != (r is not None):
        raise ValueError(f"onehot round {rnd} of {lay.M}: a challenge "
                         f"after round 0 only")
    v = 0 if r is None else r.v
    words = [(v >> (64 * i)) & _MASK64 for i in range(4)]
    if b.ws.device.type == "cpu":
        round_plain(b.ws, lay, b.idx, rnd, words)
        return (b.ws[lay.out:lay.out + nout].numpy().copy() if fetch
                else None)
    from . import build
    counter, pinned, view = _card(b.device, nout)
    with torch.cuda.device(b.device):
        rc = build.cuda_library().jolt_onehot_round(
            b.ws.data_ptr(), b.fields.ctypes.data, b.idx.data_ptr(), rnd,
            *words, counter.data_ptr(), pinned.data_ptr() if fetch else None,
            nout, _stream(b.device))
    if rc != 0:
        raise RuntimeError(f"onehot_round kernel failed: CUDA error {rc}")
    telemetry.launch("onehot_round", (lay.wide, round_case(lay, rnd)))
    return view[:nout].copy() if fetch else None


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _fr_rows(rows: np.ndarray) -> list[Fr]:
    blob = np.ascontiguousarray(rows).tobytes()
    return [Fr(int.from_bytes(blob[32 * i:32 * i + 32], "little"))
            for i in range(len(rows))]


def decline(instances) -> tuple:
    """(why the engine does not take this batch or None, the Booleanity,
    the read checks). Asked only of a batch that holds a Booleanity or a
    read check."""
    from ..subprotocols.onehot import (AddressReadCheckProver,
                                       BooleanityProver, table_vec)
    bs = [i for i in instances if type(i) is BooleanityProver]
    rcs = [i for i in instances if type(i) is AddressReadCheckProver]
    if len(bs) + len(rcs) != len(instances):
        return "mixed batch", None, None
    if len(bs) != 1:
        return "not one Booleanity", None, None
    b = bs[0]
    D, T, K = len(b.idx), b.T, b.K
    if D < 1 or T < 2 or b.num_rounds() > MAX_VARS:
        return (f"no chunk rows, T < 2 or more than {MAX_VARS} rounds",
                None, None)
    if any(x.is_zero() for x in b.r_b):
        return "zero coordinate of r_b", None, None
    for rc in rcs:
        if (len(rc.reads.idx) != D or any(
                x is not y for x, y in zip(rc.reads.idx, b.idx))
                or rc.reads is not rcs[0].reads
                or len(rc.r_cycle) != b.num_rounds() - b.logK
                or not 0 <= rc.d < D):
            return "read checks over other rows", None, None
        if len(table_vec(rc.table_spec)) != K:
            return "a table of another size", None, None
    return None, b, rcs


def try_prove(instances, accumulator, transcript):
    """The batch's BatchedSumcheck with its rounds on the scope's device:
    (proof, r_sumcheck), byte-identical to the host path, or None (no
    scope; not a read-check batch; or declined, the reason counted in the
    scope: the caller runs the host path)."""
    from ..subprotocols.onehot import AddressReadCheckProver, BooleanityProver
    from ..subprotocols.sumcheck import SumcheckInstanceProof
    from ..poly.unipoly import CompressedUniPoly
    sc = Scope.entered
    if sc is None or not any(isinstance(i, (BooleanityProver,
                                            AddressReadCheckProver))
                             for i in instances):
        return None
    sc.offered += 1
    why, b, rcs = decline(instances)
    idx_rows = None
    if why is None:
        idx_rows = np.stack(b.idx)
        if int(idx_rows.min()) < 0 or int(idx_rows.max()) >= b.K:
            why = "chunk values out of range"
    if why is not None:
        sc.decline(why)
        return None
    D, T, K, M = len(b.idx), b.T, b.K, b.num_rounds()
    sc.engaged += 1
    # the protocol prefix, as BatchedSumcheck.prove
    claims = [inst.input_claim(accumulator) for inst in instances]
    for c in claims:
        transcript.append_scalar(c)
    coeffs = transcript.challenge_vector(len(instances))
    telemetry.tally("sumcheck_batched_rounds", M)
    k_b = instances.index(b)
    pos = {id(rc): k for k, rc in enumerate(instances)}
    kinds: dict = {}  # the batch's table kinds, once each
    for rc in rcs:
        kinds.setdefault(repr(rc.table_spec), rc.table_spec)
    keys = list(kinds)
    rcmap = [(keys.index(repr(rc.table_spec)), rc.d) for rc in rcs]
    with span("rachecks_upload"):
        batch = Batch(idx_rows, K, b.r_b, rcs[0].r_cycle if rcs else
                      [Fr.zero()] * (M - b.logK), b.gammas,
                      [coeffs[k_b]] + [coeffs[pos[id(rc)]] for rc in rcs],
                      [rc.claim for rc in rcs], list(kinds.values()), rcmap,
                      sc.device)
        prepare(batch)
        buckets(batch)
    r_sumcheck: list[Fr] = []
    compressed: list = []
    r = None
    with span("rachecks_rounds"):
        for rnd in range(M):
            c = _fr_rows(round_(batch, rnd, r, 4))
            cp = CompressedUniPoly([c[0], c[2], c[3]])
            cp.append_to_transcript(transcript)
            r = transcript.challenge_scalar_optimized()
            r_sumcheck.append(r)
            compressed.append(cp)
    with span("rachecks_fetch"):
        fin = _fr_rows(round_(batch, M, r, 2 * D))
    telemetry.count("rachecks", M + 3)
    telemetry.tally("iop_rachecks_card", D * T)
    telemetry.tally("iop_rows_bound_card",
                    D * sum(T >> ci for ci in range(b.num_rounds() - b.logK)))
    b._finals = fin[:D]
    for rc in rcs:
        rc._finals = [None, fin[D + rc.d]]
    for inst in instances:
        inst.finalize()
    for inst in instances:
        inst.cache_openings(accumulator, transcript,
                            r_sumcheck[M - inst.num_rounds():])
    return SumcheckInstanceProof(compressed), r_sumcheck


# ---------------------------------------------------------------------------
# inputs for holding the kernels against their plain versions
# ---------------------------------------------------------------------------

SPEC_KINDS = ("identity", "one", "msb", "eq0", ("ltc", 11),
              ("lut", (3, -1, 7, 0, 250, 9)), ("onesN", 16))


def random_batch(K: int, D: int, T: int, N: int, gen: np.random.Generator,
                 device) -> Batch:
    """A batch of D rows of T chunk values below K, N read checks over
    random rows and table kinds (``SPEC_KINDS`` that have K entries; every
    one of them where N allows), random challenges, gammas, coefficients
    and claims."""
    from ..subprotocols.onehot import table_vec
    logK, logT = K.bit_length() - 1, T.bit_length() - 1
    rand = lambda: Fr(int.from_bytes(gen.bytes(32), "little") % FR_MODULUS)
    kinds = [s for s in SPEC_KINDS if len(table_vec(s)) == K] or [
        ("onesN", K)]
    used = kinds[:min(N, len(kinds))]
    rcmap = [(i % len(used), int(gen.integers(0, D))) for i in range(N)]
    idx = gen.integers(0, K, size=(D, T)).astype(np.int64)
    idx[0, :2] = (0, K - 1)
    return Batch(idx, K, [rand() for _ in range(logK + logT)],
                 [rand() for _ in range(logT)], [rand() for _ in range(D)],
                 [rand() for _ in range(N + 1)], [rand() for _ in range(N)],
                 used, rcmap, device)
