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
  bases into its bucket. The top window's S sub-lanes are folded with
  log2(S) halving ``pp_add`` launches.
- The bucket combine sum_b b * S_b writes b = h * 2^ch + l and reduces the
  buckets along each half by loops of ``pp_add`` launches, batched over all
  MSMs of a call (batch padded to a power of two).
- The window sums come back to the host, where a Horner loop in Python
  point arithmetic gives the affine result.

A host counting pass (csrc ``msm_digit_grid``, the same digit semantics)
sizes the grid's row budget first and raises ``_GridSkewError`` on
pathologically skewed scalars, before any device work; ``try_msm_batch``
refuses such MSMs one by one and ``host_fill`` gives them to the host
engine.

On a CUDA device the two kernels run; on the CPU their plain versions do.
"""

from __future__ import annotations

import numpy as np
import torch

from . import curve, field, telemetry
from .curve import pp_add, pp_add_plain, pp_identity


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
    counts = torch.bincount(lane_f, minlength=L + 1)
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


def bucket_accumulate(bases, grid: torch.Tensor):
    """(X, Y, Z) bases (N, 4) and a (rows, L) int32 index grid -> the L
    bucket sums (L, 4) each. CUDA tensors run kernel 2, CPU tensors its
    plain version."""
    device = grid.device
    curve.check_points(bases, device)
    if grid.dtype != torch.int32 or grid.dim() != 2:
        raise ValueError("grid must be a 2-D int32 tensor")
    if device.type == "cpu":
        return bucket_accumulate_plain(bases, grid)
    if device.type != "cuda":
        raise ValueError(f"bucket_accumulate: no kernel for device {device}")
    from . import build
    rows, L = grid.shape
    grid = grid.contiguous()
    bx, by, bz = (curve._flat(b) for b in bases)
    outs = [torch.empty((L, 4), dtype=torch.int64, device=device)
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
        telemetry.launch("bucket_accumulate")
    return tuple(outs)


# ---------------------------------------------------------------------------
# top-window fold and bucket combine: loops of pp_add launches
# ---------------------------------------------------------------------------

def fold_top(acc, c: int):
    """Fold the top window's S sub-lanes of each bucket by halving adds;
    the top window's lanes then hold its 2^topbits buckets, identity after."""
    W, B, S = window_shape(c)
    if S == 1:
        return acc
    base = (W - 1) * B
    top = tuple(p[base:].reshape(B // S, S, 4) for p in acc)
    s = S
    while s > 1:
        s //= 2
        top = pp_add(tuple(t[:, :s] for t in top),
                     tuple(t[:, s:2 * s] for t in top))
    ident = pp_identity(B - B // S, acc[0].device)
    return tuple(torch.cat([p[:base], t.reshape(B // S, 4), i1])
                 for p, t, i1 in zip(acc, top, ident))


def _reduce0(P):
    """Sum a point batch over its leading axis by R-1 pp_add launches."""
    acc = tuple(p[0] for p in P)
    for j in range(1, P[0].shape[0]):
        acc = pp_add(acc, tuple(p[j] for p in P))
    return acc


def _weighted(P):
    """sum_b b * P[b] over the leading axis, by running suffix sums."""
    R = P[0].shape[0]
    shape = P[0].shape[1:]
    n = int(np.prod(shape[:-1]))
    zero = tuple(t.reshape(shape) for t in pp_identity(n, P[0].device))
    S, T = zero, zero
    for j in range(R - 1):
        T = pp_add(T, tuple(p[R - 1 - j] for p in P))
        S = pp_add(S, T)
    return S


def combine(acc, c: int):
    """Bucket sums (k, L, 4) x 3 -> window sums (k, W, 4) x 3.

    sum_b b*S_b with b = h*Gl + l splits into Gl * sum_h h*U_h +
    sum_l l*V_l, U_h = sum_l S_{h,l}, V_l = sum_h S_{h,l}: two plain
    reductions and two running-sum weighted reductions, O(sqrt B) batched
    launches instead of O(B) sequential adds."""
    W, _, _ = window_shape(c)
    k = acc[0].shape[0]
    ch = c // 2
    Gh, Gl = 1 << (c - ch), 1 << ch
    S = tuple(p.reshape(k, W, Gh, Gl, 4) for p in acc)
    U = _reduce0(tuple(p.movedim(3, 0) for p in S))     # (k, W, Gh, 4)
    V = _reduce0(tuple(p.movedim(2, 0) for p in S))     # (k, W, Gl, 4)
    Wh = _weighted(tuple(p.movedim(2, 0) for p in U))   # (k, W, 4)
    Wl = _weighted(tuple(p.movedim(2, 0) for p in V))   # (k, W, 4)
    for _ in range(ch):  # Gl is a power of two: ch doublings
        Wh = pp_add(Wh, Wh)
    return pp_add(Wh, Wl)


def _pow2_pad(x: int) -> int:
    return 1 << max(x - 1, 1).bit_length()


def combine_batch(accs: list, c: int):
    """Stack the bucket sums of k MSMs, pad the batch to a power of two
    with identity lanes, and combine: window sums (k_pad, W, 4) x 3."""
    W, B, _ = window_shape(c)
    device = accs[0][0].device
    accs = list(accs)
    k = len(accs)
    while len(accs) < _pow2_pad(k):
        accs.append(pp_identity(W * B, device))
    return combine(tuple(torch.stack([a[i] for a in accs])
                         for i in range(3)), c)


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
        accs = []
        for raw, count, off, r in zip(packed, counts, offsets, rows):
            grid = digit_grid(scalars_tensor(raw, count, self.device), c, r,
                              off)
            accs.append(fold_top(bucket_accumulate(self.bases, grid), c))
            telemetry.count(site)
        R = combine_batch(accs, c)
        telemetry.count(site)
        return (R, len(accs), c)

    def start(self, packed: list[bytes], counts: list[int],
              offsets: list[int] | None = None, site: str = "msm"):
        """Enqueue a batch of MSMs (canonical 32-byte LE scalars against
        base ranges [offset, offset + count)); pair with ``finish()``.
        One accumulation per MSM, then one batched combine. Raises
        _GridSkewError before any device work if a grid would be skewed."""
        c = self.c or _pick_c(max(counts))
        offsets = offsets or [0] * len(packed)
        self._check(packed, counts, offsets)
        rows = [rows_for(raw, count, c) for raw, count in zip(packed, counts)]
        return self._launch(packed, counts, offsets, rows, c, site)

    def finish(self, handle) -> list:
        """Collect a ``start()`` batch: list of affine G1 (host)."""
        R, k, c = handle
        host = tuple(t[:k].cpu() for t in R)
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
