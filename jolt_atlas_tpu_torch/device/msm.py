"""Device Pippenger MSM: digit grid, bucket accumulation and bucket
combine on tensors.

Counterpart of jolt_atlas_tpu/tpu/msm.py, with the same structure:

- Scalars (canonical, 32 bytes little-endian) are cut into W windows of
  c bits; each (window, bucket) pair is a *lane*. The digit grid is built
  on the device: digit 0 is dropped, the top window, which has only
  254 - (W-1)c bits of entropy, is round-robined over S = 2^c / 2^topbits
  sub-lanes by local point index, and a stable sort feeds a scatter into a
  (rows, W * 2^c) grid of absolute base indices (-1 = empty slot).
- ``bucket_accumulate`` (kernel 2, csrc/msm.cu) adds each lane's column of
  bases into its bucket.
- ``bucket_combine`` (kernel 3, csrc/combine.cu) folds the top window's
  sub-lanes and computes sum_b b * S_b per (MSM, window), for all MSMs of
  a call in one launch.
- The window sums come back to the host, where a Horner loop in Python
  point arithmetic gives the affine result.

A host counting pass (csrc ``msm_digit_grid``, the same digit semantics)
sizes the grid's row budget first and raises ``_GridSkewError`` on
pathologically skewed scalars, before any device work; ``try_msm_batch``
refuses such MSMs one by one and ``host_fill`` gives them to the host
engine. ``DeviceBases.start`` returns as soon as the kernels are queued;
``finish`` is the only synchronisation, so the host can work meanwhile
(device/split.py).

On a CUDA device the kernels run; on the CPU their plain versions do.
"""

from __future__ import annotations

import numpy as np
import torch

from . import curve, field, telemetry
from .curve import pp_add_plain, pp_identity


class _GridSkewError(RuntimeError):
    """Raised when a digit grid would be pathologically deep (non-uniform
    scalar distribution); callers fall back to the host Pippenger."""

    def __init__(self, depth: int, lanes: int):
        super().__init__(f"grid depth {depth} over {lanes} lanes")


_NBITS = 254


def _pick_c(n: int) -> int:
    """Window size by MSM size: total adds ~ n*W + pad; lane count 2^c * W
    bounds padding waste at small n."""
    if n <= (1 << 16):
        return 12
    if n <= (1 << 18):
        return 14
    return 16


def window_shape(c: int) -> tuple[int, int, int]:
    """(W windows, B = 2^c buckets per window, S top-window sub-lanes)."""
    W = (_NBITS + c - 1) // c
    B = 1 << c
    topbits = _NBITS - (W - 1) * c
    return W, B, B >> topbits


def grid_rows_for(n: int, c: int) -> int:
    """Static row budget for the on-device grid: ~2x the expected lane
    occupancy plus slack covers the Poisson max over W*2^c lanes for
    uniform scalars; the host pre-count gives the true depth, and a budget
    below it is doubled, so no point is ever dropped."""
    avg = max(1, n >> c)
    return -(-(2 * avg + 32) // 16) * 16


def _host_grid_rows(raw: bytes, n: int, c: int) -> int:
    """Row budget the grid needs (16-multiple), or -1 for pathologically
    skewed scalars: the csrc counting pass, with the same digit semantics
    as ``digit_grid``."""
    from ..curve import native
    return int(native._load().msm_digit_grid(raw, n, c, _NBITS, None, 0))


def rows_for(raw: bytes, count: int, c: int) -> int:
    """The grid rows for one MSM: the static budget, doubled until it holds
    the true depth. Raises _GridSkewError on skewed scalars."""
    need = _host_grid_rows(raw, count, c)
    if need < 0:
        W, B, _ = window_shape(c)
        raise _GridSkewError(-1, W * B)
    rows = grid_rows_for(count, c)
    while rows < need:
        rows *= 2
    return rows


def scalars_tensor(raw: bytes, count: int, device) -> torch.Tensor:
    """Packed 32-byte LE scalars -> (count, 4) int64 u64-limb tensor."""
    arr = np.frombuffer(raw, dtype=np.int64, count=count * 4)
    return torch.from_numpy(arr.reshape(count, 4).copy()).to(device)


def digit_grid(sc: torch.Tensor, c: int, rows: int,
               offset: int = 0) -> torch.Tensor:
    """(n, 4) int64 canonical scalar limbs -> (rows, L) int32 grid of
    ABSOLUTE point indices offset + i, built with tensor ops on sc's device.

    Same semantics as the reference's host builder (tpu/msm.py:_grid) and
    device builder (tpu/msm.py:_grid_on_device): digit 0 dropped, the top
    window round-robined over S sub-lanes by LOCAL index, slots in
    ascending point order within each lane. ``rows`` must cover the
    deepest lane (``rows_for``)."""
    device = sc.device
    n = sc.shape[0]
    W, B, S = window_shape(c)
    L = W * B
    idx = torch.arange(n, dtype=torch.int64, device=device)
    lanes = []
    for w in range(W):
        limb, off = divmod(w * c, 64)
        # int64 shifts are arithmetic: mask right after shifting
        d = (sc[:, limb] >> off) & ((1 << min(c, 64 - off)) - 1)
        if off + c > 64 and limb + 1 < 4:
            hi = sc[:, limb + 1] & ((1 << (off + c - 64)) - 1)
            d = d | (hi << (64 - off))
        if w == W - 1 and S > 1:
            lane = (W - 1) * B + d * S + idx % S
        else:
            lane = w * B + d
        lanes.append(torch.where(d != 0, lane, L))
    lane_f = torch.cat(lanes)                 # (W*n,) window-major
    pt_f = idx.repeat(W)
    # scatter_add, not bincount: bincount reads its maximum back to the
    # host, a synchronisation
    counts = torch.zeros(L + 1, dtype=torch.int64, device=device)
    counts.scatter_add_(0, lane_f, torch.ones_like(lane_f))
    starts = torch.zeros(L + 1, dtype=torch.int64, device=device)
    starts[1:] = torch.cumsum(counts[:L], 0)
    lane_s, order = torch.sort(lane_f, stable=True)
    pt_s = pt_f[order]
    slot = torch.arange(W * n, dtype=torch.int64, device=device) \
        - starts[lane_s]
    valid = (lane_s < L) & (slot < rows)
    flat = torch.where(valid, slot * L + lane_s, rows * L)
    grid = torch.full((rows * L + 1,), -1, dtype=torch.int32, device=device)
    grid[flat] = (pt_s + offset).to(torch.int32)
    return grid[:rows * L].view(rows, L)


# ---------------------------------------------------------------------------
# kernel 2: bucket accumulation
# ---------------------------------------------------------------------------

def bucket_accumulate_plain(bases, grid: torch.Tensor):
    """Plain version of kernel 2: for each grid row in order, add the
    row's bases into the lanes whose slot is filled (-1 = empty: the lane
    is left as it is). Starts from the identity."""
    rows, L = grid.shape
    acc = list(pp_identity(L, grid.device))
    for r in range(rows):
        row = grid[r]
        lanes = torch.nonzero(row >= 0).squeeze(1)
        if lanes.numel() == 0:
            continue
        gi = row[lanes].to(torch.int64)
        s = pp_add_plain(tuple(a[lanes] for a in acc),
                         tuple(b[gi] for b in bases))
        for a, v in zip(acc, s):
            a[lanes] = v
    return tuple(acc)


def bucket_accumulate(bases, grid: torch.Tensor, out=None):
    """(X, Y, Z) bases (N, 4) and a (rows, L) int32 index grid -> the L
    bucket sums (L, 4) each, written into ``out`` when given (three
    contiguous (L, 4) int64 tensors, e.g. one MSM's rows of a batch's
    stack). CUDA tensors run kernel 2, CPU tensors its plain version."""
    device = grid.device
    curve.check_points(bases, device)
    if grid.dtype != torch.int32 or grid.dim() != 2:
        raise ValueError("grid must be a 2-D int32 tensor")
    rows, L = grid.shape
    if out is not None:
        curve.check_points(out, device)
        if out[0].shape != (L, 4) or not all(
                t.is_contiguous() and t.data_ptr() % 16 == 0 for t in out):
            raise ValueError("out must be contiguous, 16-byte aligned "
                             f"(L, 4) tensors, L={L}")
    if device.type == "cpu":
        got = bucket_accumulate_plain(bases, grid)
        if out is None:
            return got
        for o, g in zip(out, got):
            o.copy_(g)
        return tuple(out)
    if device.type != "cuda":
        raise ValueError(f"bucket_accumulate: no kernel for device {device}")
    from . import build
    grid = grid.contiguous()
    bx, by, bz = (curve._flat(b) for b in bases)
    outs = list(out) if out is not None else [
        torch.empty((L, 4), dtype=torch.int64, device=device)
        for _ in range(3)]
    if L:
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = build.cuda_library().jolt_bucket_accumulate(
                bx.data_ptr(), by.data_ptr(), bz.data_ptr(), grid.data_ptr(),
                rows, L, *(t.data_ptr() for t in outs), stream)
        if rc != 0:
            raise RuntimeError("bucket_accumulate kernel launch failed: "
                               f"CUDA error {rc}")
        telemetry.launch("bucket_accumulate", L)
    return tuple(outs)


# ---------------------------------------------------------------------------
# kernel 3: bucket combine
# ---------------------------------------------------------------------------

COMBINE_MAX_THREADS = 256


def combine_threads(c: int) -> int:
    """Threads per (MSM, window) of kernel 3: a power of two, at most 256,
    at most half the buckets. It fixes the partition of the buckets and so
    the order of the adds, which the plain version follows."""
    return min(COMBINE_MAX_THREADS, (1 << c) >> 1)


def _combine_ranges(c: int, device):
    """Per (window, thread): the bucket range [lo, hi) the thread walks,
    the window's sub-lanes per bucket S (lane j has weight j // S), and the
    range's lowest weight wlo (0 for an empty range)."""
    W, B, s_top = window_shape(c)
    T = combine_threads(c)
    S = torch.ones((W, 1), dtype=torch.int64, device=device)
    S[-1] = s_top
    chunk = (B - S + T - 1) // T
    t = torch.arange(T, dtype=torch.int64, device=device)
    hi = torch.clamp(S + (t + 1) * chunk, max=B)
    lo = torch.minimum(S + t * chunk, hi)
    wlo = torch.where(lo < hi, lo // S, 0)
    return lo, hi, S, wlo, int(chunk.max())


def _where(mask, P, Q):
    """Points of P where mask, of Q elsewhere (mask over the leading axes)."""
    m = mask.unsqueeze(-1)
    return tuple(torch.where(m, p, q) for p, q in zip(P, Q))


def bucket_combine_plain(acc, c: int):
    """Plain version of kernel 3, with the kernel's own order of adds, so
    the two are bit-equal: one (MSM, window) is a row of T "threads", each
    walking its bucket range from high to low with a running sum and a
    weighted sum, multiplying in its lowest weight by double-and-add; the T
    partials are then added by halving, as the kernel's shared-memory
    tree does."""
    k = acc[0].shape[0]
    W, B, _ = window_shape(c)
    device = acc[0].device
    lo, hi, S, wlo, steps = _combine_ranges(c, device)
    T = lo.shape[1]
    win = torch.arange(W, dtype=torch.int64, device=device)[:, None] * B
    shape = (k, W, T, 4)

    def ident():
        return tuple(t.reshape(shape) for t in pp_identity(k * W * T, device))

    run, wsum = ident(), ident()
    for i in range(steps):
        j = hi - 1 - i
        live = j >= lo
        jc = torch.where(live, j, 0)
        lane = (win + jc).reshape(-1)
        P = tuple(a.index_select(1, lane).reshape(shape) for a in acc)
        run = _where(live, pp_add_plain(run, P), run)
        hit = live & (jc % S == 0) & (jc // S > lo // S)
        wsum = _where(hit, pp_add_plain(wsum, run), wsum)
    R = ident()
    started = torch.zeros_like(wlo, dtype=torch.bool)
    for bit in reversed(range(c)):
        R = _where(started, pp_add_plain(R, R), R)
        b = ((wlo >> bit) & 1) == 1
        R = _where(b & started, pp_add_plain(R, run), _where(b, run, R))
        started = started | b
    P = _where(started, pp_add_plain(wsum, R), wsum)
    s = T >> 1
    while s:
        top = pp_add_plain(tuple(p[:, :, :s] for p in P),
                           tuple(p[:, :, s:2 * s] for p in P))
        P = tuple(torch.cat([a, p[:, :, s:]], dim=2) for a, p in zip(top, P))
        s >>= 1
    return tuple(p[:, :, 0].contiguous() for p in P)


def bucket_combine(acc, c: int):
    """Bucket sums (k, W * 2^c, 4) x 3, the top window still spread over
    its sub-lanes, as ``bucket_accumulate`` leaves them -> window sums
    (k, W, 4) x 3, sum_b b * S_b per (MSM, window); digit 0 is dropped.
    CUDA tensors run kernel 3 (one launch for the whole batch), CPU tensors
    its plain version."""
    device = acc[0].device
    curve.check_points(acc, device)
    W, B, s_top = window_shape(c)
    if acc[0].dim() != 3 or acc[0].shape[1] != W * B:
        raise ValueError(f"bucket sums must be (k, {W * B}, 4) for c={c}; "
                         f"got {tuple(acc[0].shape)}")
    if device.type == "cpu":
        return bucket_combine_plain(acc, c)
    if device.type != "cuda":
        raise ValueError(f"bucket_combine: no kernel for device {device}")
    from . import build
    k = acc[0].shape[0]
    ins = [curve._flat(a) for a in acc]
    outs = [torch.empty((k, W, 4), dtype=torch.int64, device=device)
            for _ in range(3)]
    if k:
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = build.cuda_library().jolt_bucket_combine(
                *(t.data_ptr() for t in ins), k, c, W, s_top,
                combine_threads(c), *(t.data_ptr() for t in outs), stream)
        if rc != 0:
            raise RuntimeError("bucket_combine kernel launch failed: "
                               f"CUDA error {rc}")
        telemetry.launch("bucket_combine", W * B)
    return tuple(outs)


def _combine_windows(window_points: list, c: int):
    """Host Horner over the window sums (list of G1, lowest window first)
    -> affine G1."""
    from ..curve.points import (jacobian_add_affine, jacobian_double,
                                jacobian_to_affine, JINF)
    total = JINF
    for p in reversed(window_points):
        for _ in range(c):
            total = jacobian_double(total)
        total = jacobian_add_affine(total, p)
    return jacobian_to_affine(total)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

class DeviceBases:
    """Device-resident cache of MSM bases.

    Built from the host engine's prepared buffer (csrc/msm.cpp
    msm_prep_points: interleaved Montgomery affine x, y as u64 x 4; x = y = 0
    encodes infinity, uploaded as (0 : 1 : 0)), so the Montgomery conversion
    is never repeated. The full base set stays resident; an MSM over
    bases [offset, offset + count) references it by absolute index.

    ``c`` forces the window size for every MSM (0: chosen per batch by
    its largest MSM); the tests use it to keep the plain versions small.
    """

    def __init__(self, prep_raw: bytes, n: int, device, c: int = 0):
        self.device = torch.device(device)
        self.n = n
        self.c = c
        limbs = np.frombuffer(prep_raw, dtype=np.uint64,
                              count=n * 8).reshape(n, 8)
        inf = torch.from_numpy((limbs == 0).all(axis=1))
        xy = torch.from_numpy(limbs.view(np.int64).copy())
        X = xy[:, :4].contiguous()
        Y = xy[:, 4:].contiguous()
        Z = torch.zeros_like(X)
        one = torch.tensor(field.MONT_ONE_64, dtype=torch.int64)
        Z[~inf] = one
        Y[inf] = one
        self.bases = tuple(t.to(self.device) for t in (X, Y, Z))

    def _check(self, packed: list[bytes], counts: list[int],
               offsets: list[int]) -> None:
        for raw, count, off in zip(packed, counts, offsets):
            if off < 0 or off + count > self.n or len(raw) < 32 * count:
                raise ValueError(f"MSM over bases [{off}, {off + count}) "
                                 f"with {len(raw) // 32} scalars: this "
                                 f"engine holds {self.n} bases")

    def _launch(self, packed, counts, offsets, rows, c: int, site: str):
        """Queue the batch: upload every MSM's scalars first (a copy from
        pageable host memory may wait for the stream's earlier work), then
        per MSM its digit grid and kernel 2 into its rows of one (k, L, 4)
        stack, then kernel 3 once. Nothing after the uploads waits for the
        device."""
        W, B, _ = window_shape(c)
        k = len(packed)
        scalars = [scalars_tensor(raw, count, self.device)
                   for raw, count in zip(packed, counts)]
        acc = tuple(torch.empty((k, W * B, 4), dtype=torch.int64,
                                device=self.device) for _ in range(3))
        for i, (sc, off, r) in enumerate(zip(scalars, offsets, rows)):
            bucket_accumulate(self.bases, digit_grid(sc, c, r, off),
                              out=tuple(a[i] for a in acc))
            telemetry.count(site)
        R = bucket_combine(acc, c)
        telemetry.count(site)
        return (R, k, c)

    def start(self, packed: list[bytes], counts: list[int],
              offsets: list[int] | None = None, site: str = "msm"):
        """Queue a batch of MSMs (canonical 32-byte LE scalars against
        base ranges [offset, offset + count)) and return without waiting
        for the device; pair with ``finish()``. One accumulation per MSM,
        then one combine for the batch. Raises _GridSkewError before any
        device work if a grid would be skewed."""
        c = self.c or _pick_c(max(counts))
        offsets = offsets or [0] * len(packed)
        self._check(packed, counts, offsets)
        rows = [rows_for(raw, count, c) for raw, count in zip(packed, counts)]
        return self._launch(packed, counts, offsets, rows, c, site)

    def finish(self, handle) -> list:
        """Collect a ``start()`` batch (waits for the device): list of
        affine G1, the window sums combined by a host Horner loop."""
        R, k, c = handle
        host = tuple(t.cpu() for t in R)
        return [_combine_windows(curve.tensors_to_points(
            tuple(t[i] for t in host)), c) for i in range(k)]

    def msm_batch_packed(self, packed: list[bytes], counts: list[int],
                         offsets: list[int] | None = None,
                         site: str = "msm") -> list:
        return self.finish(self.start(packed, counts, offsets, site))

    def try_msm_batch(self, packed: list[bytes], counts: list[int],
                      site: str) -> list:
        """``msm_batch_packed`` MSM by MSM: the affine point of each, or
        None for each MSM whose digit grid would be skewed; the caller takes
        the host engine for those (``host_fill``). The rest run as one
        device batch, counted as dispatches of ``msm:<site>``;
        ``msm_skew_fallback:<site>`` counts each refusal."""
        c = self.c or _pick_c(max(counts))
        self._check(packed, counts, [0] * len(packed))
        out: list = [None] * len(packed)
        keep, rows = [], []
        for i, (raw, count) in enumerate(zip(packed, counts)):
            try:
                rows.append(rows_for(raw, count, c))
                keep.append(i)
            except _GridSkewError:
                telemetry.count("msm_skew_fallback:" + site)
        if keep:
            pts = self.finish(self._launch(
                [packed[i] for i in keep], [counts[i] for i in keep],
                [0] * len(keep), rows, c, "msm:" + site))
            for i, pt in zip(keep, pts):
                out[i] = pt
        return out

    def msm_packed(self, scalar_bytes: bytes, count: int, offset: int = 0,
                   site: str = "msm"):
        return self.msm_batch_packed([scalar_bytes], [count], [offset],
                                     site)[0]


def host_fill(pts: list, host_batch) -> list:
    """Fill the MSMs that ``try_msm_batch`` left to the host (None) with
    ``host_batch(indices)``, the host engine's points for those indices."""
    miss = [i for i, pt in enumerate(pts) if pt is None]
    if miss:
        for i, pt in zip(miss, host_batch(miss)):
            pts[i] = pt
    return pts
