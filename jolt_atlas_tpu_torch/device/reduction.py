"""The batched opening reduction on the card: plain versions, kernel
wrappers and the engine's entry point ``try_prove``.

Counterpart of jolt_atlas_tpu/tpu/reduction.py. The opening reduction
(poly/opening.py) is one BatchedSumcheck over ~10^2 degree-2 instances, one
per opening point, whose polynomials total tens of millions of Fr elements
(17.9 M for the bench nanoGPT). Each instance k is a row of 2^nr_k elements
bound high-to-low with a Gruen split-eq weight (poly/spliteq.py); it joins
the batch at round max_rounds - nr_k. The engine runs every round on the
card with no host synchronisation and one fetch at the end:

- the protocol prefix on the host: the input claims, then the batching
  coefficients (``challenge_vector``);
- the whole schedule planned on the host: every round's eq weight tables
  (they depend on the opening points only, never on a challenge), its lane
  scalars l0, l1, 1/l1 and the constant term of the lanes not yet joined,
  uploaded in one copy; meanwhile a thread uploads every instance's row
  (the init buffer, the one large copy);
- per round three kernels (csrc/reduction.cu): kernel 4 ``bind`` binds the
  continuing lanes at the previous challenge and brings in the joining
  ones; kernel 5 ``q0`` sums each lane's q(0) terms (lazily reduced
  sums of products, the lane's blocks folded on the card) into one q(0) a
  lane; kernel 6 ``tail`` forms the batched round message, runs the
  Fiat-Shamir step on the card (csrc/blake2b.cuh) and advances each lane's
  claim and eq scalar at the new challenge; then one last bind;
- one fetch: every round message and challenge, the transcript state, the
  lanes' claims and eq scalars and the bound rows. The host transcript
  replays the messages; its state and challenges must equal the card's, or
  ``try_prove`` raises. The instances resume on the host
  (``resume_from_device``) and ``BatchedSumcheck.prove_tail`` finishes the
  last ``tail_rounds`` rounds. The proof bytes equal the host path's.
  The card's transcript step is BLAKE2b's, so under any other transcript
  (``KeccakTranscript``) the engine declines and the host path runs.

Lanes are the joined instances in join order, padded to a power of two.
At round r the joined lanes are 0 .. J_r - 1 and every one holds 2^(max_rounds
- r) elements (an instance joins when its size is the batch's), so the
working buffer is J_r equal segments and a thread finds its lane by a
shift: no per-element index arrays (the reference uploads four a round, up
to 2^24 entries each at the bench).

Each wrapper dispatches on its tensors' device: CUDA tensors launch the
kernel, CPU tensors run the plain version, with no fallback from one to the
other. Field elements are (n, 4) int64 tensors of Montgomery limbs, R =
2^256 (device/field.py), which is ``FrArray.d`` as it is.

The reference's switches (JOLT_ATLAS_TPU_REDUCTION, _TAIL_ROUNDS,
_REDUCTION_MIN) are one argument, the gate (``ReductionGate``, ``forced``),
given to ``AtlasProver(reduction_gate=)``. Its relay workarounds (the
backend-init timeout, the 1-D upload, the link probes) have no counterpart.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..field.constants import FR_MODULUS, FR_R, FR_R_INV
from ..field.scalar import Fr
from ..transcripts.blake2b import Blake2bTranscript
from ..utils.profiling import span
from . import blake2b, telemetry
from .field import FR, NLIMBS, from_planes, int_to_limbs64, to_planes

Q0_THREADS = 256       # csrc/reduction.cu
Q0_PER_THREAD = 16     # terms a thread of kernel 5 sums
TAIL_MAX_LANES = 4096  # kernel 6's one block (csrc/reduction.cu)
SIZE_FLOOR = 1 << 21   # the reference's floor (tpu/reduction.py:328)
ABSENT_SHIFT = 62      # j >> 62 = 0: a lane without a whi table
_TWO384 = pow(2, 384, FR_MODULUS)          # raw: times 2^-128 in Montgomery
_FRAME = blake2b.i64(int.from_bytes(b"UniPoly\x01", "little"))
_MASK125_HI = (1 << 61) - 1                # bits 64..124 of the challenge


class ReductionGate:
    """When the engine runs: on a CUDA device once the joined rows total
    SIZE_FLOOR elements, or, ``forced``, on any device (the plain versions
    on a CPU one) at any size; the last ``tail_rounds`` rounds stay on the
    host."""

    def __init__(self, tail_rounds: int = 0, forced: bool = False):
        self.tail_rounds = tail_rounds
        self.forced = forced


def forced(tail_rounds: int = 0) -> ReductionGate:
    """A gate that runs the engine on any device at any size, leaving
    ``tail_rounds`` rounds to the host."""
    return ReductionGate(tail_rounds, True)


# ---------------------------------------------------------------------------
# host conversions
# ---------------------------------------------------------------------------

def mont_rows(values) -> np.ndarray:
    """Fr values (or canonical ints) -> (n, 4) int64 Montgomery limbs."""
    raw = b"".join(((v.v if isinstance(v, Fr) else int(v)) * FR_R
                    % FR_MODULUS).to_bytes(32, "little") for v in values)
    return np.frombuffer(raw, dtype="<i8").astype(np.int64).reshape(-1, 4)


def fr_of_row(row) -> Fr:
    """One (4,) Montgomery limb row (any int dtype) -> Fr."""
    v = int.from_bytes(np.asarray(row).astype("<u8").tobytes(), "little")
    return Fr(v * FR_R_INV)


def _planes(t: torch.Tensor) -> torch.Tensor:
    return to_planes(t.reshape(-1, 4))


def _const(value: int, device) -> torch.Tensor:
    """(16, 1) planes of a raw (not Montgomery) constant."""
    return to_planes(torch.tensor([int_to_limbs64(value)], dtype=torch.int64,
                                  device=device))


def _bswap64(x: torch.Tensor) -> torch.Tensor:
    out = torch.zeros_like(x)
    for k in range(8):
        out |= ((x >> (8 * k)) & 0xFF) << (56 - 8 * k)
    return out


# ---------------------------------------------------------------------------
# kernel 4: bind
# ---------------------------------------------------------------------------

def bind_plain(buf, init, c, init_off, j_prev: int, lanes: int,
               lg: int) -> torch.Tensor:
    """``lanes`` segments of 2^lg: lane s < j_prev is lo + c (hi - lo) of
    its segment of 2^(lg + 1) in buf, a later lane is its rows of init
    from init_off[s]. The reference's where(is_new, init[init_pos], lo +
    c (hi - lo))."""
    size = 1 << lg
    out = torch.empty((lanes << lg, 4), dtype=torch.int64, device=init.device)
    if j_prev:
        old = buf[:j_prev << (lg + 1)].reshape(j_prev, 2, size, 4)
        lo, hi = _planes(old[:, 0]), _planes(old[:, 1])
        out[:j_prev << lg] = from_planes(
            FR.add(lo, FR.mul(FR.sub(hi, lo), _planes(c))))
    if lanes > j_prev:
        idx = (init_off[j_prev:lanes, None]
               + torch.arange(size, device=init.device)).reshape(-1)
        out[j_prev << lg:] = init[idx]
    return out


def _check(what: str, t: torch.Tensor, device, rows=None) -> None:
    """Raise unless t is an int64 tensor on ``device`` (of ``rows`` rows of
    4 limbs if given) that a kernel can read as it is: contiguous and
    16-byte aligned (the kernels load an element as two 16-byte words)."""
    if t.dtype != torch.int64 or t.device != device or (
            rows is not None and t.shape != (rows, 4)) or (
            device.type == "cuda" and (not t.is_contiguous()
                                       or t.data_ptr() % 16)):
        raise ValueError(f"{what}: a contiguous, 16-byte aligned int64 "
                         f"tensor on {device}"
                         + ("" if rows is None else f" of shape ({rows}, 4)")
                         + f" expected; got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")


def bind(buf, init, c, init_off, j_prev: int, lanes: int,
         lg: int) -> torch.Tensor:
    """Kernel 4 on CUDA tensors, its plain version on CPU ones."""
    device = init.device
    _check("bind buf", buf, device)
    _check("bind init", init, device)
    _check("bind c", c, device, 1)
    if init_off.dtype != torch.int64 or init_off.device != device or (
            init_off.shape[0] < lanes or not init_off.is_contiguous()):
        raise ValueError("init_off: contiguous int64 tensor of a row a lane "
                         "expected")
    if not 0 <= j_prev <= lanes or buf.shape[0] < j_prev << (lg + 1):
        raise ValueError(f"bind: {j_prev} continuing lanes of 2^{lg + 1} "
                         f"do not fit {tuple(buf.shape)}")
    if device.type == "cpu":
        return bind_plain(buf, init, c, init_off, j_prev, lanes, lg)
    if device.type != "cuda":
        raise ValueError(f"bind: no kernel for device {device}")
    from . import build
    n_out = lanes << lg
    out = torch.empty((n_out, 4), dtype=torch.int64, device=device)
    if n_out:
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = build.cuda_library().jolt_reduction_bind(
                buf.data_ptr(), init.data_ptr(), c.data_ptr(),
                init_off.data_ptr(), out.data_ptr(), j_prev, n_out, lg,
                stream)
        if rc != 0:
            raise RuntimeError(f"reduction_bind kernel launch failed: CUDA "
                               f"error {rc}")
        telemetry.launch("reduction_bind", bind_case(j_prev, lanes))
    return out


def bind_case(j_prev: int, lanes: int) -> tuple:
    """The branch shape of a bind launch: (some lanes continue, some join)."""
    return (int(j_prev > 0), int(lanes > j_prev))


# ---------------------------------------------------------------------------
# kernel 5: q(0)
# ---------------------------------------------------------------------------

def q0_blocks(lg: int) -> int:
    """Blocks (partials) a lane of 2^lg elements takes in kernel 5."""
    return -(-(1 << (lg - 1)) // (Q0_THREADS * Q0_PER_THREAD))


def q0_plain(buf, tab, lanep, lanes: int, lg: int) -> torch.Tensor:
    """q(0) = sum_j whi[j >> shift] wlo[j & mask] lo[j] over each lane's
    lower half: (lanes, 4), the reference's per-lane lazy limb sums
    reduced mod r."""
    half = 1 << (lg - 1)
    device = buf.device
    j = torch.arange(half, dtype=torch.int64, device=device)
    lp = lanep[:lanes]
    whi = lp[:, 0:1] + (j >> lp[:, 1:2])
    wlo = lp[:, 2:3] + (j & lp[:, 3:4])
    lo = buf[:lanes << lg].reshape(lanes, 2, half, 4)[:, 0]
    w = FR.mul(_planes(tab[whi.reshape(-1)]), _planes(tab[wlo.reshape(-1)]))
    p = FR.mul(w, _planes(lo)).reshape(NLIMBS, lanes, half)
    return from_planes(FR.sum(p))


_COUNTERS: dict = {}


def _counters(device, lanes: int) -> torch.Tensor:
    """Kernel 5's per-lane ticket counters on a CUDA device, made at its
    first launch and grown to ``lanes``: u32, zero between launches (each
    lane's last block resets its own). Launches that share them run on one
    stream."""
    k = device.index if device.index is not None else \
        torch.cuda.current_device()
    if k not in _COUNTERS or _COUNTERS[k].shape[0] < lanes:
        _COUNTERS[k] = torch.zeros(max(lanes, TAIL_MAX_LANES),
                                   dtype=torch.int32,
                                   device=torch.device("cuda", k))
    return _COUNTERS[k]


def q0(buf, tab, lanep, lanes: int, lg: int) -> torch.Tensor:
    """Kernel 5 on CUDA tensors, its plain version on CPU ones: each lane's
    q(0), (lanes, 4)."""
    device = buf.device
    _check("q0 buf", buf, device)
    _check("q0 tab", tab, device)
    if lanep.dtype != torch.int64 or lanep.device != device or (
            lanep.shape[0] < lanes or lanep.shape[1:] != (4,)
            or not lanep.is_contiguous()):
        raise ValueError("lanep: contiguous int64 (lanes, 4) tensor "
                         "expected")
    if lg < 1 or buf.shape[0] < lanes << lg:
        raise ValueError(f"q0: {lanes} lanes of 2^{lg} do not fit "
                         f"{tuple(buf.shape)}")
    if device.type == "cpu":
        return q0_plain(buf, tab, lanep, lanes, lg)
    if device.type != "cuda":
        raise ValueError(f"q0: no kernel for device {device}")
    from . import build
    bpl = q0_blocks(lg)
    out = torch.empty((lanes, 4), dtype=torch.int64, device=device)
    if lanes:
        part = torch.empty((lanes * bpl if bpl > 1 else 0, 4),
                           dtype=torch.int64, device=device)
        counters = _counters(device, lanes)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = build.cuda_library().jolt_reduction_q0(
                buf.data_ptr(), tab.data_ptr(), lanep.data_ptr(),
                part.data_ptr(), counters.data_ptr(), out.data_ptr(), lanes,
                lg, bpl, stream)
        if rc != 0:
            raise RuntimeError(f"reduction_q0 kernel launch failed: CUDA "
                               f"error {rc}")
        telemetry.launch("reduction_q0", q0_case(lg))
    return out


def q0_case(lg: int) -> int:
    """The shape class of a q0 launch: a lane in one block or in several."""
    return int(q0_blocks(lg) == 1)


# ---------------------------------------------------------------------------
# kernel 6: the round's message, transcript step and challenge
# ---------------------------------------------------------------------------

def tail_plain(q0s, joined: int, Q, es, qinit, coeff, l0, l1, inv_l1,
               const_b0, state) -> tuple:
    """(Q', es', state', c, msg): lanes < joined take their q(0) from q0s
    and q(1) = (Q - l0 q0) / l1; b0 = sum coeff es l0 q0 +
    const_b0 and b2 = sum coeff es (l1 - l0)(q1 - q0) over them (msg); the
    transcript absorbs "UniPoly\\x01" || b0 || b2 and squeezes the
    challenge c (125 bits, times 2^-128); each joined lane's Q becomes
    q(c) and its es es * l(c); the other lanes' Q is qinit."""
    device = Q.device
    J = joined
    Qn, esn = qinit.clone(), es.clone()
    zero = torch.zeros((NLIMBS, 1), dtype=torch.int64, device=device)
    if J:
        q0v = _planes(q0s[:J])
        lz, l1z = _planes(l0[:J]), _planes(l1[:J])
        esz = _planes(es[:J])
        l0q0 = FR.mul(lz, q0v)
        q1 = FR.mul(FR.sub(_planes(Q[:J]), l0q0), _planes(inv_l1[:J]))
        dq = FR.sub(q1, q0v)
        dl = FR.sub(l1z, lz)
        cf = _planes(coeff[:J])
        s0 = FR.mul(cf, FR.mul(esz, l0q0))
        s2 = FR.mul(cf, FR.mul(esz, FR.mul(dl, dq)))
        b0 = FR.sum(s0.reshape(NLIMBS, 1, J))
        b2 = FR.sum(s2.reshape(NLIMBS, 1, J))
    else:
        b0, b2 = zero, zero
    b0 = FR.add(b0, _planes(const_b0))
    msg = from_planes(torch.cat([b0, b2], 1))
    canon = from_planes(FR.mul(torch.cat([b0, b2], 1), _const(1, device)))
    payload = torch.cat([torch.full((1,), _FRAME, dtype=torch.int64,
                                    device=device),
                         _bswap64(canon[0].flip(0)),
                         _bswap64(canon[1].flip(0))])[None, :]
    n = state[4:5]
    st = blake2b.transcript_absorb_long_plain(state[None, :4], n, payload)
    st = blake2b.transcript_squeeze_plain(st, n + 1)
    new_state = torch.cat([st[0], n + 2])
    raw = torch.cat([st[0, :1], st[0, 1:2] & _MASK125_HI,
                     st.new_zeros(2)])[None, :]
    c_pl = FR.mul(_planes(raw), _const(_TWO384, device))
    c = from_planes(c_pl)
    if J:
        Qn[:J] = from_planes(FR.add(q0v, FR.mul(dq, c_pl)))
        esn[:J] = from_planes(FR.mul(esz, FR.add(lz, FR.mul(dl, c_pl))))
    return Qn, esn, new_state, c, msg


def tail(q0s, joined: int, Q, es, qinit, coeff, l0, l1, inv_l1, const_b0,
         state, c_out, msg_out) -> None:
    """Kernel 6 on CUDA tensors, its plain version on CPU ones: q0s holds
    a q(0) a joined lane (kernel 5's output). Q, es and state (5: four
    transcript words, then n_rounds) advance in place; c_out (1, 4) takes
    the challenge, msg_out (2, 4) b0 and b2."""
    device = Q.device
    lanes = Q.shape[0]
    for what, t, rows in (("q0s", q0s, None), ("Q", Q, lanes),
                          ("es", es, lanes), ("qinit", qinit, lanes),
                          ("coeff", coeff, lanes), ("l0", l0, lanes),
                          ("l1", l1, lanes), ("inv_l1", inv_l1, lanes),
                          ("const_b0", const_b0, 1), ("c_out", c_out, 1),
                          ("msg_out", msg_out, 2)):
        _check(f"tail {what}", t, device, rows)
    if state.dtype != torch.int64 or state.shape != (5,) or (
            state.device != device):
        raise ValueError("tail state: int64 (5,) tensor expected")
    if not 0 <= joined <= lanes <= TAIL_MAX_LANES or (
            q0s.shape[0] < joined):
        raise ValueError(f"tail: {joined} joined of {lanes} lanes (at most "
                         f"{TAIL_MAX_LANES}), {q0s.shape[0]} q(0) rows")
    if device.type == "cpu":
        outs = tail_plain(q0s, joined, Q, es, qinit, coeff, l0, l1, inv_l1,
                          const_b0, state)
        for dst, src in zip((Q, es, state, c_out, msg_out), outs):
            dst.copy_(src)
        return
    if device.type != "cuda":
        raise ValueError(f"tail: no kernel for device {device}")
    from . import build
    if not state.is_contiguous():
        raise ValueError("tail state: contiguous tensor expected")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = build.cuda_library().jolt_reduction_tail(
            q0s.data_ptr(), joined, lanes, Q.data_ptr(),
            es.data_ptr(), qinit.data_ptr(), coeff.data_ptr(), l0.data_ptr(),
            l1.data_ptr(), inv_l1.data_ptr(), const_b0.data_ptr(),
            state.data_ptr(), c_out.data_ptr(), msg_out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"reduction_tail kernel launch failed: CUDA "
                           f"error {rc}")
    telemetry.launch("reduction_tail", lanes)


# ---------------------------------------------------------------------------
# the schedule
# ---------------------------------------------------------------------------

def _pow2(x: int) -> int:
    return 1 << max(x - 1, 0).bit_length() if x > 1 else 1


class Plan:
    """The host side of one engine run: lanes, per-round weight tables and
    lane scalars, packed for one upload.

    rounds[r] = (joined, lg, (tab0, tab1), (lanep0, lanep1), scal0): the
    joined lane count, the log2 segment size, the row range of this
    round's weight table in ``elems`` and of its lane parameters in
    ``ints``, and the first row in ``elems`` of its scalars (l0, l1 and
    1/l1, a row a lane each, then const_b0)."""

    def __init__(self, instances, head, claims, coeffs, max_rounds: int,
                 r_dev: int):
        from ..poly.spliteq import SplitEq, inv_cached
        from ..subprotocols.sumcheck import _mul_pow2
        self.max_rounds = max_rounds
        self.r_dev = r_dev
        self.offs = {k: max_rounds - instances[k].num_rounds() for k in head}
        self.order = lane_order(instances, head, max_rounds)
        self.I = len(self.order)
        self.lanes = max(_pow2(self.I), 2)
        self.init_off = np.zeros(self.lanes, dtype=np.int64)
        self.init_off[:self.I] = np.cumsum(
            [0] + [len(instances[k].rlc_fvec) for k in self.order])[:-1]
        one = Fr.one()
        pad = [Fr.zero()] * (self.lanes - self.I)
        self.coeff = mont_rows([coeffs[k] for k in self.order] + pad)
        self.qinit = mont_rows([claims[k] for k in self.order] + pad)
        ses = [SplitEq(instances[k].point) for k in self.order]
        one_row = mont_rows([one])
        elems, ints, nelem, nint = [], [], 0, 0
        self.rounds = []
        for r in range(r_dev):
            joined = sum(1 for k in self.order if self.offs[k] <= r)
            tabs, lanep = [one_row], np.zeros((joined, 4), dtype=np.int64)
            rows = 1
            for s in range(joined):
                lr = r - self.offs[self.order[s]]
                whi, shift, wlo, log_wlo = ses[s].tables(lr)
                lanep[s] = (0, ABSENT_SHIFT, 0, 0)
                if whi is not None:
                    lanep[s, :2] = (rows, shift)
                    tabs.append(np.asarray(whi).view(np.int64).reshape(-1, 4))
                    rows += len(tabs[-1])
                if wlo is not None:
                    lanep[s, 2:] = (rows, (1 << log_wlo) - 1)
                    tabs.append(np.asarray(wlo).view(np.int64).reshape(-1, 4))
                    rows += len(tabs[-1])
            l0s, l1s, invs = [], [], []
            for s in range(self.lanes):
                if s < joined:
                    l0, l1 = ses[s].l_linear(r - self.offs[self.order[s]])
                    l0s.append(l0)
                    l1s.append(l1)
                    invs.append(inv_cached(l1))
                else:
                    l0s.append(one)
                    l1s.append(one)
                    invs.append(one)
            cb0 = Fr.zero()
            for k, inst in enumerate(instances):
                nr = inst.num_rounds()
                if max_rounds - nr > r:
                    cb0 = cb0 + coeffs[k] * _mul_pow2(
                        claims[k], max_rounds - r - nr - 1)
            scal = mont_rows(l0s + l1s + invs + [cb0])
            tab = np.concatenate(tabs)
            self.rounds.append((joined, max_rounds - r,
                                (nelem, nelem + len(tab)), (nint,
                                                            nint + joined),
                                nelem + len(tab)))
            elems += [tab, scal]
            nelem += len(tab) + len(scal)
            ints.append(lanep)
            nint += joined
        self.elems = np.concatenate(elems)
        self.ints = np.concatenate(ints) if ints else np.zeros((0, 4),
                                                               np.int64)
        self.final_lg = max_rounds - r_dev


def lane_order(instances, head, max_rounds: int) -> list:
    """The head instances in join order (by the round they join, then by
    index): lane s is instance order[s]."""
    return sorted(head, key=lambda k: (max_rounds - instances[k].num_rounds(),
                                       k))


def upload_rows(rows, device) -> torch.Tensor:
    """The init buffer: every lane's rows ((n, 4) u64 arrays, lane order)
    one after another on ``device``. Pageable copies: on an H100 host they
    beat pinned staging and registering the pages (PERF.md)."""
    init = torch.empty((sum(len(d) for d in rows), 4), dtype=torch.int64,
                       device=device)
    o = 0
    for d in rows:
        init[o:o + len(d)].copy_(torch.from_numpy(
            np.ascontiguousarray(d).view(np.int64)))
        o += len(d)
    return init


def run_rounds(plan: Plan, init, state_words, n_rounds: int, device):
    """Queue every device round of ``plan`` on ``device`` and fetch the
    result once: (msgs (r_dev, 2, 4), challenges (r_dev, 4), state (5,),
    Q (lanes, 4), es (lanes, 4), bound rows (J * 2^final_lg, 4)), int64
    numpy arrays. ``init`` is the init buffer (``upload_rows``)."""
    L, r_dev = plan.lanes, plan.r_dev
    i64 = dict(dtype=torch.int64, device=device)
    with span("reduction_upload"):
        elems = torch.from_numpy(plan.elems).to(device)
        ints = torch.from_numpy(plan.ints).to(device)
        init_off = torch.from_numpy(plan.init_off).to(device)
        qinit = torch.from_numpy(plan.qinit).to(device)
        coeff = torch.from_numpy(plan.coeff).to(device)
        es = torch.from_numpy(mont_rows([Fr.one()] * L)).to(device)
        state = torch.tensor(list(state_words) + [n_rounds], **i64)
    with span("reduction_launch"):
        Q = qinit.clone()
        msgs = torch.empty((r_dev, 2, 4), **i64)
        cs = torch.zeros((r_dev + 1, 4), **i64)  # row 0: round 0's unused c
        buf = torch.empty((0, 4), **i64)
        j_prev = 0
        for r, (joined, lg, (t0, t1), (p0, p1), sc) in enumerate(
                plan.rounds):
            telemetry.count("reduction", 3)  # bind + q0 + tail
            buf = bind(buf, init, cs[r:r + 1], init_off, j_prev, joined, lg)
            q = q0(buf, elems[t0:t1], ints[p0:p1], joined, lg)
            tail(q, joined, Q, es, qinit, coeff,
                 elems[sc:sc + L], elems[sc + L:sc + 2 * L],
                 elems[sc + 2 * L:sc + 3 * L],
                 elems[sc + 3 * L:sc + 3 * L + 1], state, cs[r + 1:r + 2],
                 msgs[r])
            j_prev = joined
        telemetry.count("reduction", 1)  # final bind
        buf = bind(buf, init, cs[r_dev:], init_off, j_prev, j_prev,
                   plan.final_lg)
    with span("reduction_fetch"):  # waits for the card
        flat = torch.cat([msgs.reshape(-1), cs[1:].reshape(-1), state,
                          Q.reshape(-1), es.reshape(-1), buf.reshape(-1)])
        flat = flat.cpu().numpy()  # the one device -> host fetch
    out, o = [], 0
    for shape in ((r_dev, 2, 4), (r_dev, 4), (5,), (L, 4), (L, 4),
                  (j_prev << plan.final_lg, 4)):
        n = int(np.prod(shape))
        out.append(flat[o:o + n].reshape(shape))
        o += n
    return tuple(out)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def try_prove(instances, accumulator, transcript, device=None, gate=None):
    """The opening reduction's BatchedSumcheck with its rounds on
    ``device``: (proof, r_sumcheck), byte-identical to the host path, or
    None when the gate declines (the caller then runs the host path; the
    reason is in telemetry.decisions["reduction"]). The instances must not
    have had setup_sumcheck(); this sets them up (resumed from the device,
    or on the host). Raises if the device transcript disagrees with the
    host's replay."""
    from ..field.frvec import FrArray
    gate = ReductionGate() if gate is None else gate
    device = torch.device("cpu" if device is None else device)
    if device.type != "cuda" and not gate.forced:
        telemetry.decide("reduction", f"host path (device={device.type})")
        return None
    max_rounds = max(i.num_rounds() for i in instances)
    r_dev = max_rounds - gate.tail_rounds
    if r_dev < 2:
        telemetry.decide("reduction", f"too few rounds ({max_rounds}, "
                         f"{gate.tail_rounds} on the host)")
        return None
    head = [k for k, inst in enumerate(instances)
            if max_rounds - inst.num_rounds() < r_dev]
    if not all(isinstance(instances[k].rlc_fvec, FrArray)
               and len(instances[k].rlc_fvec) == 1 << instances[k].num_rounds()
               for k in head):
        telemetry.decide("reduction", "rows not FrArray of 2^rounds")
        return None
    total = sum(len(instances[k].rlc_fvec) for k in head)
    if total < SIZE_FLOOR and not gate.forced:
        telemetry.decide("reduction", f"below size floor ({total} elems)")
        return None
    if len(head) > TAIL_MAX_LANES:
        telemetry.decide("reduction", f"{len(head)} lanes > "
                         f"{TAIL_MAX_LANES}")
        return None
    # the card's transcript step is BLAKE2b; KeccakTranscript subclasses
    # Blake2bTranscript and differs only in HASH
    if getattr(type(transcript), "HASH", None) is not Blake2bTranscript.HASH:
        telemetry.decide("reduction", "transcript not BLAKE2b")
        return None

    telemetry.decide("reduction", f"ENGAGED ({total} elems, {len(head)} "
                     f"lanes, {r_dev} rounds)")
    # the rows' upload (the one large copy) runs in a thread while the host
    # plans; the copies release the interpreter lock
    order = lane_order(instances, head, max_rounds)
    with ThreadPoolExecutor(1) as ex:
        upload = ex.submit(upload_rows,
                           [instances[k].rlc_fvec.d for k in order], device)
        # ---- protocol prefix (host transcript, as BatchedSumcheck.prove)
        claims = [inst.input_claim(accumulator) for inst in instances]
        for c in claims:
            transcript.append_scalar(c)
        coeffs = transcript.challenge_vector(len(instances))
        with span("reduction_plan"):
            plan = Plan(instances, head, claims, coeffs, max_rounds, r_dev)
        with span("reduction_upload_wait"):
            init = upload.result()
    msgs, cs, state, Q, es, bound = run_rounds(
        plan, init, blake2b.bytes_to_words(transcript.state),
        transcript.n_rounds, device)
    del init

    with span("reduction_replay"):
        r_sumcheck, compressed = replay(transcript, msgs, cs, state)

    # ---- resume the instances on the host for the tail rounds
    with span("reduction_resume"):
        return _resume(instances, accumulator, transcript, plan, claims,
                       coeffs, bound, Q, es, r_sumcheck, compressed)


def replay(transcript, msgs, cs, state) -> tuple:
    """Absorb the card's round messages into the host transcript and draw
    its challenges: (r_sumcheck, compressed polys). Raises unless the
    host's state, round count and challenges equal the card's."""
    from ..poly.unipoly import CompressedUniPoly
    r_sumcheck: list[Fr] = []
    compressed: list[CompressedUniPoly] = []
    for r in range(len(msgs)):
        cp = CompressedUniPoly([fr_of_row(msgs[r, 0]), fr_of_row(msgs[r, 1])])
        cp.append_to_transcript(transcript)
        r_sumcheck.append(transcript.challenge_scalar_optimized())
        compressed.append(cp)
    if (transcript.state != blake2b.words_to_bytes(state[:4])
            or transcript.n_rounds != state[4]
            or any(fr_of_row(c) != x for c, x in zip(cs, r_sumcheck))):
        raise RuntimeError(
            "device transcript diverged from the host replay: the card's "
            "Fiat-Shamir state or challenges differ from the host's")
    return r_sumcheck, compressed


def _resume(instances, accumulator, transcript, plan, claims, coeffs, bound,
            Q, es, r_sumcheck, compressed):
    """Hand the device rounds' state to the instances and finish the
    batched sumcheck on the host (BatchedSumcheck.prove_tail)."""
    from ..field.frvec import FrArray
    from ..poly.spliteq import SplitEq
    from ..subprotocols.sumcheck import BatchedSumcheck, _mul_pow2
    max_rounds, r_dev = plan.max_rounds, plan.r_dev
    fsz = 1 << plan.final_lg
    lane_of = {k: s for s, k in enumerate(plan.order)}
    individual_claims: list[Fr] = []
    for k, inst in enumerate(instances):
        nr = inst.num_rounds()
        if k in lane_of:
            s = lane_of[k]
            rows = FrArray(np.ascontiguousarray(
                bound[s * fsz:(s + 1) * fsz]).view(np.uint64))
            se = SplitEq(inst.point)
            local = r_dev - plan.offs[k]
            for lr in range(local):
                se.note_challenge(r_sumcheck[plan.offs[k] + lr], lr)
            inst.resume_from_device(rows, local, se)
            individual_claims.append(fr_of_row(es[s]) * fr_of_row(Q[s]))
        else:
            if nr > 0:
                inst.setup_sumcheck()
            individual_claims.append(
                _mul_pow2(claims[k], max_rounds - r_dev - nr)
                if max_rounds - r_dev - nr >= 0 else claims[k])
    return BatchedSumcheck.prove_tail(
        instances, claims, coeffs, individual_claims, compressed,
        r_sumcheck, accumulator, transcript, r_dev, max_rounds)


# ---------------------------------------------------------------------------
# inputs for holding the kernels against their plain versions
# ---------------------------------------------------------------------------

def random_rows(n: int, gen: np.random.Generator, device) -> torch.Tensor:
    """(n, 4) int64 Montgomery limbs of n random Fr elements below 2^253,
    the first few the edges 0, 1, r - 1, r - 2 and R mod r."""
    d = gen.integers(0, 1 << 64, size=(n, 4), dtype=np.uint64).view(np.int64)
    d[:, 3] &= (1 << 61) - 1
    edges = mont_rows([0, 1, FR_MODULUS - 1, FR_MODULUS - 2, FR_R])
    m = min(n, len(edges))
    d[:m] = edges[:m]
    return torch.from_numpy(d).to(device)


def random_round(device, gen: np.random.Generator, j_prev: int, lanes: int,
                 lg: int, table: int = 64) -> dict:
    """Inputs of one round's bind and q0 at (j_prev, lanes, 2^lg): the old
    buffer, an init buffer holding the joining lanes at scattered offsets,
    a random challenge, and a weight table (row 0 Montgomery one) with its
    lane parameters. Lane s has, by s % 6: a split-eq pair (whi rows of
    2^k, wlo of 2^k entries), no whi table, no wlo table (weight one),
    neither, a random shift and wlo size, the finest whi rows with the
    largest wlo."""
    size, half = 1 << lg, 1 << (lg - 1)
    init_off = np.zeros(lanes, dtype=np.int64)
    init_off[j_prev:] = np.arange(lanes - j_prev) * (size + 3) + 5
    logt = table.bit_length() - 1
    fine = max(lg - 1 - logt, 0)      # the finest whi rows the table holds
    widest = min(lg - 1, logt)        # log2 of the largest wlo table
    rand = lambda a, b: int(gen.integers(a, max(a, b) + 1))
    lanep = np.zeros((lanes, 4), dtype=np.int64)
    for s in range(lanes):
        lanep[s] = (0, ABSENT_SHIFT, 0, 0)
        kind = s % 6
        shift = {0: rand(fine, widest), 2: rand(fine, lg), 4: rand(fine, lg),
                 5: fine}.get(kind)
        log_wlo = {0: min(shift or 0, widest), 1: rand(0, widest),
                   4: rand(0, widest), 5: widest}.get(kind)
        if shift is not None:
            n = max(half >> shift, 1)
            lanep[s, :2] = (1 + rand(0, table - n), shift)
        if log_wlo is not None:
            n = 1 << log_wlo
            lanep[s, 2:] = (1 + rand(0, table - n), n - 1)
    tab = random_rows(table + 1, gen, device)
    tab[0] = torch.from_numpy(mont_rows([1])[0])
    n_init = int(init_off[-1]) + size + 7 if lanes > j_prev else 1
    return {"buf": random_rows(j_prev << (lg + 1), gen, device),
            "init": random_rows(n_init, gen, device),
            "init_off": torch.from_numpy(init_off).to(device),
            "c": random_rows(6, gen, device)[5:],
            "tab": tab, "lanep": torch.from_numpy(lanep).to(device)}


def random_tail(device, gen: np.random.Generator, lanes: int,
                joined: int) -> dict:
    """Inputs of one tail launch: random q(0)s, claims, eq scalars and
    coefficients; lane 0 has l1 = 0 (1/l1 given as 0), lane 1 has l0 = 0;
    lanes past ``joined`` are unjoined, the padding lanes have coefficient
    and claim 0."""
    rows = lambda n: random_rows(n, gen, device)
    l1 = rows(lanes)
    l0 = rows(lanes)
    inv = rows(lanes)
    zero = torch.zeros(4, dtype=torch.int64, device=device)
    l1[0], inv[0] = zero, zero
    if lanes > 1:
        l0[1] = zero
    coeff, qinit = rows(lanes), rows(lanes)
    pad = max(joined, (lanes * 3) // 4)
    coeff[pad:] = 0
    qinit[pad:] = 0
    words = gen.integers(-(1 << 63), (1 << 63) - 1, size=4, dtype=np.int64)
    return {"q0s": rows(max(joined, 1)), "Q": rows(lanes),
            "es": rows(lanes), "qinit": qinit, "coeff": coeff, "l0": l0,
            "l1": l1, "inv_l1": inv, "const_b0": rows(1),
            "state": torch.tensor(
                list(words) + [int(gen.integers(0, 1 << 31))],
                dtype=torch.int64, device=device)}
