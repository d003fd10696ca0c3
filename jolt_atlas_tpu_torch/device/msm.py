"""Device Pippenger MSM: signed digit lanes, bucket accumulation, and the
bucket combine with the window fold, on tensors.

Counterpart of jolt_atlas_tpu/tpu/msm.py, with its structure redesigned
for the card:

- Scalars (canonical, 32 bytes little-endian) are recoded into W windows
  of signed c-bit digits, d in [-2^(c-1), 2^(c-1)] (``signed_digits``: a
  digit above 2^(c-1) is taken as d - 2^c, carrying one into the next
  window; the top window takes the last carry and stays nonnegative).
  Each (window, |d|) pair is a *lane*, 2^(c-1) a window: digit 0 and the
  entries of a base at infinity are dropped, the top window, which has
  only 254 - (W-1)c bits of entropy, is round-robined over S sub-lanes by
  local point index, and a stable sort orders the (lane, point) entries
  by lane, points ascending within a lane (CSR: lane starts plus absolute
  base indices, bit 31 of an index set where the digit is negative). The
  reference scatters its unsigned digits into a (rows, W * 2^c) grid
  instead.
- ``bucket_accumulate`` (kernel 2, csrc/msm.cu) adds each lane's bases,
  affine and negated where the digit is, into its bucket with the
  complete mixed add, in equal runs of entries per thread.
- ``bucket_combine`` (kernel 3, csrc/combine.cu) folds the top window's
  sub-lanes, computes sum_b b * S_b per (MSM, window) and folds the
  windows, sum_w 2^(c w) R_w, for all MSMs of one window size in one
  call: one projective point an MSM.
- ``affine_points`` brings those points back to the host as affine G1.

Each MSM of a batch takes its own window, ``_pick_c(count)``, unless one
is forced. The reference's TPU grid refuses scalars whose deepest lane
passes max(64, 32 x the mean) (tpu/msm.py:_host_grid_rows); kernel 2 has no
grid and takes any depth, so no MSM is refused here. ``finish`` records
each MSM's deepest lane beside its mean in telemetry, so a run shows the
skew the card carries. ``DeviceBases.start`` returns as soon as the
kernels are queued; ``finish`` is the only synchronisation, so the host can
work meanwhile (device/split.py).

On a CUDA device the kernels run; on the CPU their plain versions do.
"""

from __future__ import annotations

import numpy as np
import torch

from . import curve, field, telemetry
from .curve import (pm_add_plain, pp_add_plain, pp_double_plain,
                    pp_identity)


_NBITS = 254
SIGN_BIT = 1 << 31  # an entry's point id has it where its digit is negative


def _pick_c(n: int) -> int:
    """Window size by MSM size: total adds ~ n*W + pad; lane count
    2^(c-1) * W bounds padding waste at small n."""
    if n <= (1 << 16):
        return 12
    if n <= (1 << 18):
        return 14
    return 16


def window_shape(c: int) -> tuple[int, int, int]:
    """(W windows, B = 2^(c-1) lanes a window, S top-window sub-lanes a
    bucket). The top window's digit, its 254 - (W-1)c bits plus a carry,
    reaches 2^topbits, which must fit B: c >= 3."""
    W = (_NBITS + c - 1) // c
    topbits = _NBITS - (W - 1) * c
    if c < 3 or topbits >= c:
        raise ValueError(f"window c={c}: its top digit does not fit "
                         "2^(c-1) lanes")
    B = 1 << (c - 1)
    return W, B, B >> topbits


def scalars_tensor(raw: bytes, count: int, device) -> torch.Tensor:
    """Packed 32-byte LE scalars -> (count, 4) int64 u64-limb tensor."""
    arr = np.frombuffer(raw, dtype=np.int64, count=count * 4)
    return torch.from_numpy(arr.reshape(count, 4).copy()).to(device)


def signed_digits(sc: torch.Tensor, c: int) -> torch.Tensor:
    """(n, 4) int64 canonical scalar limbs -> (W, n) int64 signed digits,
    sum_w d_w 2^(c w) = the scalar: window w's c bits plus the carry, less
    2^c (carrying one on) where that passes 2^(c-1); the top window keeps
    its value, at most 2^topbits."""
    W, _, _ = window_shape(c)
    half, carry, out = 1 << (c - 1), None, []
    for w in range(W):
        limb, off = divmod(w * c, 64)
        # int64 shifts are arithmetic: mask right after shifting
        d = (sc[:, limb] >> off) & ((1 << min(c, 64 - off)) - 1)
        if off + c > 64 and limb + 1 < 4:
            hi = sc[:, limb + 1] & ((1 << (off + c - 64)) - 1)
            d = d | (hi << (64 - off))
        if carry is not None:
            d = d + carry
        if w < W - 1:
            carry = (d > half).to(torch.int64)
            d = d - (carry << c)
        out.append(d)
    return torch.stack(out)


def digit_lanes(sc: torch.Tensor, c: int, offset: int = 0,
                inf: torch.Tensor | None = None) -> tuple:
    """(n, 4) int64 canonical scalar limbs -> the MSM's (lane, point)
    entries sorted by lane, as three int32 tensors on sc's device:
    ``lane`` (W * n,), ``pts`` (W * n,) the ABSOLUTE point indices
    offset + i, ascending within a lane, with SIGN_BIT set where the digit
    is negative, and ``starts`` (L + 1,), lane l's entries being
    [starts[l], starts[l + 1]). Window w's digit d goes to lane w * B + |d|
    - 1 (``signed_digits``); the top window's to (W - 1) * B + (d - 1) * S
    + i mod S, round-robined over S sub-lanes by LOCAL index i. Entries of
    digit 0, and of a base at infinity (``inf``, a bool per base of the
    set, indexed by absolute point), carry lane L and sort last: starts[L]
    counts the others. Nothing is read back to the host."""
    device = sc.device
    n = sc.shape[0]
    W, B, S = window_shape(c)
    L = W * B
    idx = torch.arange(n, dtype=torch.int64, device=device)
    digits = signed_digits(sc, c)
    mag = digits.abs()
    lane = torch.arange(W, dtype=torch.int64, device=device)[:, None] * B \
        + mag - 1
    if S > 1:
        lane[W - 1] = (W - 1) * B + (mag[W - 1] - 1) * S + idx % S
    keep = digits != 0
    if inf is not None:
        keep &= ~inf[offset:offset + n]
    lane_f = torch.where(keep, lane, L).reshape(-1)  # (W*n,) window-major
    # scatter_add, not bincount: bincount reads its maximum back to the
    # host, a synchronisation
    counts = torch.zeros(L + 1, dtype=torch.int64, device=device)
    counts.scatter_add_(0, lane_f, torch.ones_like(lane_f))
    starts = torch.zeros(L + 1, dtype=torch.int64, device=device)
    starts[1:] = torch.cumsum(counts[:L], 0)
    lane_s, order = torch.sort(lane_f, stable=True)
    # the point of each sorted entry, SIGN_BIT in int32's sign
    pts = order % n + offset - (digits.reshape(-1)[order] < 0).to(
        torch.int64) * SIGN_BIT
    return (lane_s.to(torch.int32), pts.to(torch.int32),
            starts.to(torch.int32))


# ---------------------------------------------------------------------------
# kernel 2: bucket accumulation
# ---------------------------------------------------------------------------

ACCUM_RUN = 16   # entries per thread of kernel 2's level 0
ACCUM_JOIN = 16  # partials per thread of each of its later levels


def accumulate_levels(n_entries: int, run: int = ACCUM_RUN,
                      join: int = ACCUM_JOIN) -> list[int]:
    """[P_1, ..., P_{K+1}] of kernel 2 on ``n_entries`` entries: level
    k's positions P_k (P_1 the runs of level 0, P_{k+1} = ceil(P_k /
    join)) for its K levels after the runs, launched while more than one
    position is left (level 1 always: it also writes the empty lanes), and
    the partials the last one leaves. The head and tail scratch hold their
    sum in rows; a call launches K levels, and the runs when P_1 > 0."""
    P = [-(-n_entries // run)]
    while True:
        P.append(-(-P[-1] // join))
        if P[-1] < 2:
            return P


def _set_points(dst, index, src) -> None:
    for d, v in zip(dst, src):
        d[index] = v


def _entry_bases(bases, ids):
    """The affine bases (x, +-y) of entries with signed point ids (int64,
    SIGN_BIT in the sign): y negated where the id is negative."""
    pid = ids & (SIGN_BIT - 1)
    x, y = (b[pid] for b in bases)
    return x, torch.where((ids < 0).unsqueeze(-1), curve.neg_y(y), y)


def bucket_accumulate_plain(bases, lanes, run: int = ACCUM_RUN,
                            join: int = ACCUM_JOIN):
    """Plain version of kernel 2, with the kernel's partition and order of
    adds, so the two are bit-equal. Level 0: the entries [starts[0],
    starts[L]) are cut into runs of ``run``; within a run, consecutive
    entries of one lane are added in order by the complete mixed add
    (``pm_add_plain``), the first one taken as it is, (x : +-y : 1); a
    lane inside the run is finished, the run's first lane leaves a head
    partial when it began earlier, its last lane a tail when it goes on.
    Level k >= 1: level k - 1's head partials, in chunks of ``join``, by
    the same rule; a lane finished at level k is its tails of levels 0 ..
    k - 1 (one a level) plus the chunk's sum, added in that order. Empty
    lanes are the identity."""
    lane, pts, starts = (t.to(torch.int64) for t in lanes)
    L = starts.shape[0] - 1
    device = lane.device
    out = list(pp_identity(L, device))
    E = int(starts[L])
    if E == 0:
        return tuple(out)
    nruns = -(-E // run)
    e0 = torch.arange(nruns, dtype=torch.int64, device=device) * run
    e1 = torch.clamp(e0 + run, max=E)
    head = pp_identity(nruns, device)
    tail = pp_identity(nruns, device)
    one = torch.tensor(field.MONT_ONE_64, dtype=torch.int64,
                       device=device).expand(nruns, 4)
    acc = None
    for i in range(run):                       # level 0: every run at once
        e = e0 + i
        live = e < e1
        ec = torch.where(live, e, 0)
        ln = lane[ec]
        B = _entry_bases(bases, pts[ec])
        first = B + (one,)
        if acc is None:
            acc = first
        else:
            new = ln != lane[torch.clamp(ec - 1, min=0)]
            acc = _where(live, _where(new, first, pm_add_plain(acc, B)), acc)
        end = live & ((ec == e1 - 1) | (lane[torch.clamp(ec + 1, max=E - 1)]
                                         != ln))
        is_head = end & (starts[ln] < e0)
        is_tail = end & ~is_head & (starts[ln + 1] > e1)
        whole = end & ~is_head & ~is_tail
        _set_points(head, is_head, tuple(a[is_head] for a in acc))
        _set_points(tail, is_tail, tuple(a[is_tail] for a in acc))
        _set_points(out, ln[whole], tuple(a[whole] for a in acc))
    tails, V, P, span = [tail], head, nruns, run
    s = starts[:L] // run + 1                  # each lane's positions at
    e = (starts[1:] - 1).clamp(min=-1) // run + 1  # level 1: [s, e)
    k = 1
    while P >= 2 and bool((e > s).any()):      # level k: a lane has heads
        nch = -(-P // join)
        c0 = torch.arange(nch, dtype=torch.int64, device=device) * join
        c1 = torch.clamp(c0 + join, max=P)
        cur = torch.full((nch,), -1, dtype=torch.int64, device=device)
        have = torch.zeros(nch, dtype=torch.bool, device=device)
        acc = pp_identity(nch, device)
        nhead, ntail = pp_identity(nch, device), pp_identity(nch, device)
        for i in range(join + 1):
            p = c0 + i
            valid = p < c1
            pc = torch.where(valid, p, 0)
            lp = torch.where(valid, lane[pc * span], -1)
            change = lp != cur
            fl = change & have                 # flush lane cur's sum
            if bool(fl.any()):
                lc = torch.where(fl, cur, 0)
                is_head = fl & (s[lc] < c0)
                is_tail = fl & ~is_head & (e[lc] > c1)
                whole = fl & ~is_head & ~is_tail
                _set_points(nhead, is_head, tuple(a[is_head] for a in acc))
                _set_points(ntail, is_tail, tuple(a[is_tail] for a in acc))
                w = lc[whole]
                a = starts[w] // run
                tot = tuple(t[a] for t in tails[0])
                for lvl in range(1, k):
                    a = (a + 1) // join
                    tot = pp_add_plain(tot, tuple(t[a] for t in tails[lvl]))
                _set_points(out, w, pp_add_plain(
                    tot, tuple(x[whole] for x in acc)))
            cur = torch.where(change, lp, cur)
            have = have & ~change
            lc = torch.where(lp >= 0, lp, 0)
            live = valid & (s[lc] <= p) & (p < e[lc])
            v = tuple(x[pc] for x in V)
            acc = _where(live, _where(have, pp_add_plain(acc, v), v), acc)
            have = have | live
        tails.append(ntail)
        V, P, span, k = nhead, nch, span * join, k + 1
        s, e = s // join + 1, (e - 1).clamp(min=-1) // join + 1
    return tuple(out)


def _check_lanes(lanes, device) -> int:
    """The lane count L of digit lanes (lane, pts, starts) on ``device``."""
    lane, pts, starts = lanes
    for t in lanes:
        if t.dtype != torch.int32 or t.dim() != 1 or t.device != device:
            raise ValueError("digit lanes must be 1-D int32 tensors on "
                             f"{device}")
    if pts.shape != lane.shape or starts.shape[0] < 1:
        raise ValueError("lane and pts must have one length; starts L + 1")
    return starts.shape[0] - 1


def bucket_accumulate(bases, lanes, out=None, run: int = ACCUM_RUN):
    """Affine (x, y) bases (N, 4), every base an entry refers to finite,
    and an MSM's digit lanes (``digit_lanes``) -> the L bucket sums (X, Y,
    Z) (L, 4) each, written into ``out`` when given (three contiguous (L,
    4) int64 tensors, e.g. one MSM's rows of a batch's stack). CUDA
    tensors run kernel 2 (the runs, then its levels:
    ``accumulate_levels``), CPU tensors its plain version."""
    device = lanes[0].device
    if len(bases) != 2 or bases[0].dim() != 2:
        raise ValueError("bases must be (x, y), two (N, 4) int64 tensors")
    curve.check_points(bases, device)
    L = _check_lanes(lanes, device)
    if run <= 0:
        raise ValueError("run must be positive")
    if out is not None:
        curve.check_points(out, device)
        if out[0].shape != (L, 4) or not all(
                t.is_contiguous() and t.data_ptr() % 16 == 0 for t in out):
            raise ValueError("out must be contiguous, 16-byte aligned "
                             f"(L, 4) tensors, L={L}")
    if device.type == "cpu":
        got = bucket_accumulate_plain(bases, lanes, run)
        if out is None:
            return got
        for o, g in zip(out, got):
            o.copy_(g)
        return tuple(out)
    if device.type != "cuda":
        raise ValueError(f"bucket_accumulate: no kernel for device {device}")
    lanes = tuple(t.contiguous() for t in lanes)
    outs = list(out) if out is not None else [
        torch.empty((L, 4), dtype=torch.int64, device=device)
        for _ in range(3)]
    accumulate_launch(bases, lanes, outs, accumulate_scratch(lanes, run),
                      run)
    return tuple(outs)


# runs a lane on average from which level 1 is chunked: on an H100 kernel
# 2 on 2^21 - 3 scalars at c = 16 (just under 4 runs a lane) is ~24%
# faster chunked than a thread a position; on 2^20 (2 runs) the two are
# within the noise (scripts/msm_kernels_bench.py --plans, PERF.md)
ACCUM_CHUNK_RUNS = 3


def accumulate_class(lanes, run: int = ACCUM_RUN) -> tuple[int, int]:
    """Kernel 2's launch class on digit lanes, as telemetry records it: (L
    lanes, 1 when its level 1 takes a thread a chunk, the lanes averaging
    ACCUM_CHUNK_RUNS runs or more so that their heads fill the chunks, else
    0, a thread a position)."""
    L = lanes[2].shape[0] - 1
    return L, int(lanes[0].shape[0] >= ACCUM_CHUNK_RUNS * run * L)


def accumulate_scratch(lanes, run: int = ACCUM_RUN) -> list:
    """Kernel 2's head and tail partials of every level for digit lanes
    ``lanes``: six (P_1 + ... + P_{K+1}, 4) int64 tensors on their device
    (``accumulate_levels``)."""
    rows = sum(accumulate_levels(lanes[0].shape[0], run))
    return [torch.empty((max(rows, 1), 4), dtype=torch.int64,
                        device=lanes[0].device) for _ in range(6)]


def accumulate_launch(bases, lanes, outs, parts, run: int = ACCUM_RUN,
                      stages: int = 3) -> None:
    """Queue kernel 2 on CUDA tensors that ``bucket_accumulate`` checks:
    its runs (``stages`` 1), its levels (2) or both (3), the partials in
    ``parts`` (``accumulate_scratch``), the buckets into ``outs``. The
    levels read the partials the runs left and write other rows, so a
    levels-only launch after the runs can be repeated (chip_smoke.py times
    the join so)."""
    from . import build
    device = lanes[0].device
    L, chunked = accumulate_class(lanes, run)
    if not L:
        return
    bx, by = (curve._flat(b) for b in bases)
    n_entries = lanes[0].shape[0]
    levels = accumulate_levels(n_entries, run)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = build.cuda_library().jolt_bucket_accumulate(
            bx.data_ptr(), by.data_ptr(),
            *(lanes[i].data_ptr() for i in (1, 0, 2)), n_entries, L, run,
            ACCUM_JOIN, chunked, stages,
            *(t.data_ptr() for t in parts), *(t.data_ptr() for t in outs),
            stream)
    if rc != 0:
        raise RuntimeError("bucket_accumulate kernel launch failed: "
                           f"CUDA error {rc}")
    launched = len(levels) - 1 if stages & 2 else 0
    for _ in range(launched + bool(stages & 1 and levels[0])):
        telemetry.launch("bucket_accumulate", (L, chunked))


# ---------------------------------------------------------------------------
# kernel 3: bucket combine
# ---------------------------------------------------------------------------

COMBINE_MAX_THREADS = 128
COMBINE_MIN_CHUNK = 8  # lanes a thread keeps at least, where G > 1
# From window c = 16 on, kernel 3 runs 64-thread blocks and fills one wave
# of the card: its resident threads an SM are 384 (3 blocks of 128 at its
# __launch_bounds__; 6 of 64)
COMBINE_WIDE_C = 16
COMBINE_WIDE_THREADS = 64
COMBINE_SM_THREADS = 384


def combine_threads(c: int) -> int:
    """Threads per block T of kernel 3: a power of two, at most 128, at
    most half the lanes of a window; 64 from window COMBINE_WIDE_C on."""
    if c >= COMBINE_WIDE_C:
        return COMBINE_WIDE_THREADS
    return min(COMBINE_MAX_THREADS, window_shape(c)[1] >> 1)


def combine_groups(k: int, c: int, sms: int) -> int:
    """Blocks G per (MSM, window) of kernel 3 for k MSMs at window c on a
    card of ``sms`` SMs, a power of two. Below COMBINE_WIDE_C: doubled from
    1 while the launch has fewer than two blocks per SM and each thread
    would still keep at least COMBINE_MIN_CHUNK lanes. From it on: the
    largest power of two that one wave of the card holds
    (COMBINE_SM_THREADS an SM), each thread keeping COMBINE_MIN_CHUNK lanes
    at least. G and the thread count fix the partition of the lanes and so
    the order of the adds, which the plain version follows."""
    W, B, _ = window_shape(c)
    T = combine_threads(c)
    if c >= COMBINE_WIDE_C:
        G = sms * COMBINE_SM_THREADS // T // (k * W)
        G = min(G, B // (T * COMBINE_MIN_CHUNK), COMBINE_MAX_THREADS)
        return 1 << max(G, 1).bit_length() - 1
    G = 1
    while k * W * G < 2 * sms and B // (2 * G * T) >= COMBINE_MIN_CHUNK:
        G *= 2
    return G


def combine_chunk(c: int, groups: int) -> int:
    """Lanes a thread of kernel 3 walks: B / (G T), at least 1 (csrc/
    combine.cu jolt_bucket_combine)."""
    span = groups * combine_threads(c)
    B = window_shape(c)[1]
    return B // span if span < B else 1


def _where(mask, P, Q):
    """Points of P where mask, of Q elsewhere (mask over the leading axes)."""
    m = mask.unsqueeze(-1)
    return tuple(torch.where(m, p, q) for p, q in zip(P, Q))


def _identity_like(P):
    shape = P[0].shape
    return tuple(t.reshape(shape) for t in pp_identity(
        P[0].numel() // 4, P[0].device))


def _combine_tail(A, Z, q: int, S: torch.Tensor):
    """csrc/combine.cu combine_tail over the second-last axis (the n
    threads of a block) of points (k, W, g, n, 4), S (W,) the sub-lanes of
    each window: suffix sums Zs of Z by Hillis-Steele, then halving trees
    of A and of E_t = Zs_t where t >= 1 and t q = 0 mod S, and thread 0's
    log2 max(1, q / S) doublings of E and add. -> (A, Z) of thread 0, (k,
    W, g, 4) each."""
    n = Z[0].shape[-2]
    device = Z[0].device
    t = torch.arange(n, dtype=torch.int64, device=device)
    d = 1
    while d < n:
        o = tuple(torch.roll(z, -d, dims=-2) for z in Z)  # o_t = Z_{t+d}
        Z = _where(t + d < n, pp_add_plain(Z, o), Z)
        d <<= 1
    Sw = S.reshape(1, -1, 1, 1)
    E = _where((t >= 1) & ((t * q) % Sw == 0), Z, _identity_like(Z))
    s = n >> 1
    while s:
        A, E = (tuple(torch.cat([a, p[..., s:, :]], dim=-2)
                      for a, p in zip(pp_add_plain(
                          tuple(p[..., :s, :] for p in P),
                          tuple(p[..., s:2 * s, :] for p in P)), P))
                for P in (A, E))
        s >>= 1
    A, E, Z = (tuple(p[..., 0, :] for p in P) for P in (A, E, Z))
    steps = torch.tensor([max(q // s, 1).bit_length() - 1
                          for s in S.tolist()], device=device)
    steps = steps.reshape(1, -1, 1)
    for i in range(int(steps.max())):
        E = _where(steps > i, pp_double_plain(E), E)
    return pp_add_plain(A, E), Z


def _fold(R, c: int):
    """csrc/combine.cu bucket_combine_fold: window sums (k, W, 4) x 3 ->
    sum_w 2^(c w) R_w (k, 4) x 3: window w doubled c w times, then a
    halving tree over the power of two n >= W of them (the identity past
    W)."""
    k, W = R[0].shape[:2]
    n = 1 << (W - 1).bit_length()
    pad = tuple(t.reshape(k, n - W, 4) for t in pp_identity(
        k * (n - W), R[0].device))
    out = tuple(torch.cat([r, p], dim=1) for r, p in zip(R, pad))
    w = torch.arange(n, dtype=torch.int64, device=R[0].device)
    for i in range(c * (W - 1)):
        out = _where((i < c * w) & (w < W), pp_double_plain(out), out)
    s = n >> 1
    while s:
        out = tuple(torch.cat([a, p[:, s:]], dim=1) for a, p in zip(
            pp_add_plain(tuple(p[:, :s] for p in out),
                         tuple(p[:, s:2 * s] for p in out)), out))
        s >>= 1
    return tuple(p[:, 0] for p in out)


def bucket_combine_plain(acc, c: int, groups: int = 1):
    """Plain version of kernel 3, with the kernel's own order of adds, so
    the two are bit-equal: one (MSM, window) is G blocks of T "threads",
    thread u walking its lanes [u q, u q + q) (q = ``combine_chunk``) from
    high to low with a running sum and a weighted sum from its lowest
    bucket, the first of each taken as it is; each block's threads and
    then each window's blocks combined by ``_combine_tail``, the window
    sum being P + Z; then the windows folded (``_fold``)."""
    k = acc[0].shape[0]
    W, B, s_top = window_shape(c)
    device = acc[0].device
    T, G = combine_threads(c), groups
    q = combine_chunk(c, G)
    S = torch.ones(W, dtype=torch.int64, device=device)
    S[-1] = s_top
    u = torch.arange(G * T, dtype=torch.int64, device=device)
    lo = torch.clamp(u * q, max=B)
    hi = torch.clamp(lo + q, max=B)
    wlo = lo // S[:, None]                         # (W, G T)
    win = torch.arange(W, dtype=torch.int64, device=device)[:, None] * B
    shape = (k, W, G * T, 4)
    run = wsum = tuple(t.reshape(shape) for t in pp_identity(
        k * W * G * T, device))
    has_run = torch.zeros(G * T, dtype=torch.bool, device=device)
    has_sum = torch.zeros((W, G * T), dtype=torch.bool, device=device)
    for i in range(q):
        j = hi - 1 - i
        live = j >= lo
        jc = torch.where(live, j, 0)
        lane = (win + jc).reshape(-1)
        P = tuple(a.index_select(1, lane).reshape(shape) for a in acc)
        run = _where(live, _where(has_run, pp_add_plain(run, P), P), run)
        has_run = has_run | live
        hit = live & (jc % S[:, None] == 0) & (jc // S[:, None] > wlo)
        wsum = _where(hit, _where(has_sum, pp_add_plain(wsum, run), run),
                      wsum)
        has_sum = has_sum | hit
    blocks = (k, W, G, T, 4)
    P, Z = _combine_tail(tuple(a.reshape(blocks) for a in wsum),
                         tuple(r.reshape(blocks) for r in run), q, S)
    if G > 1:
        P, Z = _combine_tail(tuple(p.unsqueeze(2) for p in P),
                             tuple(z.unsqueeze(2) for z in Z), T * q, S)
        P, Z = (tuple(p[:, :, 0] for p in X) for X in (P, Z))
    else:
        P, Z = (tuple(p[:, :, 0] for p in X) for X in (P, Z))
    # the fold's chain of c (W - 1) dependent doublings of a few points
    # runs on the CPU, where a small tensor op costs less than a launch on
    # the card (the same canonical limbs either way)
    R = tuple(r.cpu() for r in pp_add_plain(P, Z))
    return tuple(o.to(device).contiguous() for o in _fold(R, c))


def bucket_combine(acc, c: int, groups: int = 0):
    """Bucket sums (k, W * 2^(c-1), 4) x 3, the top window still spread
    over its sub-lanes, as ``bucket_accumulate`` leaves them -> each MSM's
    sum_w 2^(c w) sum_b b S_{w, b}, (k, 4) x 3 projective. ``groups``:
    blocks per (MSM, window), 0 for ``combine_groups`` on a card (1 on the
    CPU). CUDA tensors run kernel 3 (the walk, the blocks' combine when G
    > 1, and the fold: two or three launches for the batch), CPU tensors
    its plain version."""
    device = acc[0].device
    curve.check_points(acc, device)
    W, B, s_top = window_shape(c)
    if acc[0].dim() != 3 or acc[0].shape[1] != W * B:
        raise ValueError(f"bucket sums must be (k, {W * B}, 4) for c={c}; "
                         f"got {tuple(acc[0].shape)}")
    if groups & (groups - 1) or groups > COMBINE_MAX_THREADS:
        raise ValueError(f"groups must be a power of two <= "
                         f"{COMBINE_MAX_THREADS}; got {groups}")
    k = acc[0].shape[0]
    if device.type == "cpu":
        return bucket_combine_plain(acc, c, groups or 1)
    if device.type != "cuda":
        raise ValueError(f"bucket_combine: no kernel for device {device}")
    from . import build
    G = groups or combine_groups(
        k, c, torch.cuda.get_device_properties(device).multi_processor_count)
    ins = [curve._flat(a) for a in acc]
    outs = [torch.empty((k, 4), dtype=torch.int64, device=device)
            for _ in range(3)]
    parts = [torch.empty((max(k * W * G, 1), 4), dtype=torch.int64,
                         device=device) for _ in range(6)]
    sums = [torch.empty((k * W if G > 1 else 1, 4), dtype=torch.int64,
                        device=device) for _ in range(3)]
    if k:
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = build.cuda_library().jolt_bucket_combine(
                *(t.data_ptr() for t in ins), k, c, W, s_top,
                combine_threads(c), G, *(t.data_ptr() for t in parts),
                *(t.data_ptr() for t in sums),
                *(t.data_ptr() for t in outs), stream)
        if rc != 0:
            raise RuntimeError("bucket_combine kernel launch failed: "
                               f"CUDA error {rc}")
        for _ in range(3 if G > 1 else 2):
            telemetry.launch("bucket_combine", (W * B, G))
    return tuple(outs)


def affine_points(R) -> list:
    """Each MSM's projective sum (k, 4) x 3, as ``bucket_combine`` leaves
    it -> the k MSMs' affine G1 (waits for the device): one inversion an
    MSM, on the host."""
    return curve.tensors_to_points(tuple(t.cpu() for t in R))


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

class DeviceBases:
    """Device-resident cache of MSM bases.

    Built from the host engine's prepared buffer (csrc/msm.cpp
    msm_prep_points: interleaved Montgomery affine x, y as u64 x 4; x = y = 0
    encodes infinity), so the Montgomery conversion is never repeated. The
    bases stay affine on the device, ``bases`` = (x, y), 64 bytes a base,
    beside ``inf``, the mask of the bases at infinity, whose entries
    ``digit_lanes`` drops. The full base set stays resident; an MSM over
    bases [offset, offset + count) references it by absolute index.

    ``c`` forces the window size for every MSM (0: each MSM at its own
    window, ``_pick_c(count)``); the tests use it to keep the plain
    versions small.
    """

    def __init__(self, prep_raw: bytes, n: int, device, c: int = 0):
        if n >= SIGN_BIT:
            raise ValueError(f"{n} bases: a point id must leave bit 31 free")
        self.device = torch.device(device)
        self.n = n
        self.c = c
        limbs = np.frombuffer(prep_raw, dtype=np.uint64,
                              count=n * 8).reshape(n, 8)
        inf = torch.from_numpy((limbs == 0).all(axis=1))
        xy = torch.from_numpy(limbs.view(np.int64).copy())
        self.bases = tuple(t.contiguous().to(self.device)
                           for t in (xy[:, :4], xy[:, 4:]))
        self.inf = inf.to(self.device)

    def projective(self, n: int | None = None) -> tuple:
        """The first n bases (all by default) as projective (X, Y, Z), Z =
        1 and the identity (0 : 1 : 0) at infinity: the operands of the
        complete add's own tests and calibration (kernel 1)."""
        x, y = (b[:n] for b in self.bases)
        inf = self.inf[:n].unsqueeze(-1)
        one = torch.tensor(field.MONT_ONE_64, dtype=torch.int64,
                           device=self.device).expand_as(x)
        return (x.clone(), torch.where(inf, one, y),
                torch.where(inf, torch.zeros_like(x), one))

    def _check(self, packed: list[bytes], counts: list[int],
               offsets: list[int]) -> None:
        for raw, count, off in zip(packed, counts, offsets):
            if off < 0 or off + count > self.n or len(raw) < 32 * count:
                raise ValueError(f"MSM over bases [{off}, {off + count}) "
                                 f"with {len(raw) // 32} scalars: this "
                                 f"engine holds {self.n} bases")

    def _windows(self, counts) -> list[int]:
        """Each MSM's window: the forced one, else ``_pick_c(count)``."""
        return [self.c or _pick_c(n) for n in counts]

    def _launch(self, packed, counts, offsets, cs, site: str):
        """Queue the batch: upload every MSM's scalars first (a copy from
        pageable host memory may wait for the stream's earlier work), then
        per window size its MSMs' digit lanes and kernel 2 into their rows
        of one (k_c, L_c, 4) stack, and kernel 3 once for the stack. Nothing
        after the uploads waits for the device; each MSM's deepest lane and
        entry count stay on the device until ``finish``."""
        scalars = [scalars_tensor(raw, count, self.device)
                   for raw, count in zip(packed, counts)]
        by_c: dict[int, list[int]] = {}
        for i, c in enumerate(cs):
            by_c.setdefault(c, []).append(i)
        parts, depth = [], []
        for c, idx in by_c.items():
            W, B, _ = window_shape(c)
            acc = tuple(torch.empty((len(idx), W * B, 4), dtype=torch.int64,
                                    device=self.device) for _ in range(3))
            for j, i in enumerate(idx):
                lanes = digit_lanes(scalars[i], c, offsets[i], self.inf)
                starts = lanes[2]
                depth.append((counts[i], W * B, torch.stack([
                    (starts[1:] - starts[:-1]).max(), starts[-1]])))
                bucket_accumulate(self.bases, lanes,
                                  out=tuple(a[j] for a in acc))
                telemetry.count(site)
            parts.append((bucket_combine(acc, c), idx, c))
            telemetry.count(site)
        return (parts, len(packed), site, depth)

    def start(self, packed: list[bytes], counts: list[int],
              offsets: list[int] | None = None, site: str = "msm"):
        """Queue a batch of MSMs (canonical 32-byte LE scalars against
        base ranges [offset, offset + count)) and return without waiting
        for the device; pair with ``finish()``. One accumulation per MSM,
        then one combine per window size."""
        offsets = offsets or [0] * len(packed)
        self._check(packed, counts, offsets)
        return self._launch(packed, counts, offsets, self._windows(counts),
                            site)

    def finish(self, handle) -> list:
        """Collect a ``start()`` batch (waits for the device): list of
        affine G1 (``affine_points``). Records each MSM's deepest lane
        (entries) beside the mean over its lanes (``telemetry.lane_depth``)."""
        parts, k, site, depth = handle
        out: list = [None] * k
        for R, idx, _ in parts:
            for i, pt in zip(idx, affine_points(R)):
                out[i] = pt
        if depth:
            got = torch.stack([d for _, _, d in depth]).tolist()
            for (n, lanes, _), (deepest, entries) in zip(depth, got):
                telemetry.lane_depth(site, n, deepest, entries / lanes)
        return out

    def msm_batch_packed(self, packed: list[bytes], counts: list[int],
                         offsets: list[int] | None = None,
                         site: str = "msm") -> list:
        return self.finish(self.start(packed, counts, offsets, site))

    def msm_packed(self, scalar_bytes: bytes, count: int, offset: int = 0,
                   site: str = "msm"):
        return self.msm_batch_packed([scalar_bytes], [count], [offset],
                                     site)[0]


def host_fill(pts: list, host_batch) -> list:
    """Fill the MSMs that the gate routed to the host (None) with
    ``host_batch(indices)``, the host engine's points for those indices."""
    miss = [i for i, pt in enumerate(pts) if pt is None]
    if miss:
        for i, pt in zip(miss, host_batch(miss)):
            pts[i] = pt
    return pts
