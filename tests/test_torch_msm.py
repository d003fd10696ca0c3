"""The port's device MSM (jolt_atlas_tpu_torch/device/msm.py) on the CPU,
where its kernels run as their plain PyTorch versions, against the
reference's host engine (csrc msm via KZGSRS.prepared_bases) and the
reference's pure-Python Pippenger.

The cases are those of tests/test_tpu_msm.py: a forced c = 4 window, random
254-bit, 24-byte and 16-bit scalars, all-zero scalars, a single base, r-1
and a nonzero base offset; and the skewed scalars that the reference's TPU
grid refuses (a lane deeper than max(64, 32 x the mean): all-equal,
commit-like small values, a fold-like long constant run), which the port
takes on the device. The on-device digit lanes are also held against the
reference's numpy grid builder tpu/msm.py:_grid, and the plain versions of
kernels 2 and 3 against big-int oracles at several partitions. Every
comparison is exact (equal affine points, equal grids).
"""

import numpy as np
import pytest
import torch

from jolt_atlas_tpu.commitment.kzg import KZGSRS as RefSRS
from jolt_atlas_tpu.curve import native as ref_native
from jolt_atlas_tpu.curve.msm import msm as python_msm
from jolt_atlas_tpu.curve.native import pack_scalars
from jolt_atlas_tpu.field.constants import FR_MODULUS
from jolt_atlas_tpu.tpu import msm as tmsm
from jolt_atlas_tpu_torch.device import curve, gate, msm as dmsm, split
from jolt_atlas_tpu_torch.device import telemetry
from test_torch_srs import port_srs, reference_native

# the suite runs in several worker processes at once: a small intra-op
# pool keeps this file from starving its neighbours' timed tests
torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def _host_engines():
    """The reference's csrc engine loaded in this worker before a fixture
    here builds a reference SRS (test_torch_srs.reference_native), and the
    csrc host engines' OpenMP threads capped at 2 while this file runs
    (the reference's wall-clock tests share the machine)."""
    reference_native()
    split.set_host_threads(2)
    yield
    split.set_host_threads(None)

N = 512
C = 4  # 64 windows x 16 buckets: small for the plain versions


@pytest.fixture(scope="module")
def setup():
    ref = RefSRS.setup(N - 1)
    srs = port_srs(ref)
    return ref, ref.prepared_bases(), srs.device_bases(
        "cpu", gate.forced("device"), c=C)


def _case(name):
    rng = np.random.default_rng(0x715)
    big = int.from_bytes(rng.bytes(32), "little") % FR_MODULUS
    return {
        "random254": [int.from_bytes(rng.bytes(32), "little") % FR_MODULUS
                      for _ in range(N)],
        "bytes24": [int.from_bytes(rng.bytes(24), "little")
                    for _ in range(N)],
        "bits16": [int(x) for x in rng.integers(0, 1 << 16, size=N)],
        "zeros": [0] * N,
        "single": [1] + [0] * (N - 1),
        "r_minus_1": [FR_MODULUS - 1] * 8,
        # skewed, as the reference's grid counts it (_skewed below)
        "all_equal": [FR_MODULUS - 3] * N,
        # a commit's quantized witness: small values, mostly 0 and 1
        "small_commit": [int(x) for x in np.minimum(
            rng.geometric(0.6, size=N) - 1, 255)],
        # a HyperKZG fold of a one-hot polynomial: a long constant run
        # inside random values
        "fold_run": ([int.from_bytes(rng.bytes(32), "little") % FR_MODULUS
                      for _ in range(N // 8)] + [big] * (N * 3 // 4)
                     + [int.from_bytes(rng.bytes(32), "little") % FR_MODULUS
                        for _ in range(N - N // 8 - N * 3 // 4)]),
    }[name]


SKEWED = ("all_equal", "small_commit", "fold_run")


def _skewed(packed: bytes, n: int, c: int) -> bool:
    """Whether the reference's TPU grid refuses these scalars at window c:
    its host count (tpu/msm.py:_host_grid_rows) finds a lane deeper than
    max(64, 32 x the mean)."""
    return tmsm._host_grid_rows(packed, n, c) < 0


@pytest.mark.parametrize("name", ["random254", "bytes24", "bits16", "zeros",
                                  "single", "r_minus_1", "all_equal",
                                  "small_commit", "fold_run"])
def test_device_msm_matches_host(setup, name):
    """The device MSM (plain versions) against the reference's host engine;
    the skewed cases at the adaptive window, where the reference's grid
    refuses them."""
    ref, prep, dev = setup
    scalars = _case(name)
    packed = pack_scalars(scalars)
    if name in SKEWED:
        dev = port_srs(ref).device_bases("cpu", gate.forced("device"))
        assert _skewed(packed, len(scalars), dmsm._pick_c(len(scalars)))
    got = dev.msm_packed(packed, len(scalars))
    want = prep.msm_packed(packed, len(scalars))
    assert (got.infinity, got.x, got.y) == (want.infinity, want.x, want.y)


def test_device_msm_matches_python_oracle(setup, monkeypatch):
    ref, _, dev = setup
    scalars = _case("random254")[:128]
    got = dev.msm_packed(pack_scalars(scalars), len(scalars))
    # the reference's pure-Python Pippenger: native engine switched off
    monkeypatch.setattr(ref_native, "_LIB", None)
    monkeypatch.setattr(ref_native, "_TRIED", True)
    want = python_msm(ref.g1_powers[:len(scalars)], scalars)
    assert (got.x, got.y) == (want.x, want.y)


def test_batch_with_base_offset(setup):
    _, prep, dev = setup
    scalars = _case("random254")
    a, b = pack_scalars(scalars[:200]), pack_scalars(scalars[200:300])
    got = dev.msm_batch_packed([a, b], [200, 100], offsets=[0, 37])
    want = [prep.msm_packed(a, 200), prep.msm_packed_at(37, b, 100)]
    assert [(g.x, g.y) for g in got] == [(w.x, w.y) for w in want]


def _oracle_msm(ref, scalars, monkeypatch):
    """The reference's pure-Python Pippenger (its native engine switched
    off) over the first len(scalars) SRS powers."""
    with monkeypatch.context() as m:
        m.setattr(ref_native, "_LIB", None)
        m.setattr(ref_native, "_TRIED", True)
        return python_msm(ref.g1_powers[:len(scalars)], scalars)


def test_deep_lane_doubles_rows_and_drops_nothing(setup):
    """Every scalar has digit 1 in window 0: that lane holds all n points,
    far above the mean and the reference's static grid budget. No entry is
    dropped, and telemetry records the lane's depth beside the mean."""
    _, prep, dev = setup
    n = 160
    rng = np.random.default_rng(5)
    scalars = [int.from_bytes(rng.bytes(31), "little") << 4 | 1
               for _ in range(n)]
    packed = pack_scalars(scalars)
    assert n > tmsm.grid_rows_for(n, C)
    telemetry.reset()
    got = dev.msm_packed(packed, n, site="deep")
    want = prep.msm_packed(packed, n)
    assert (got.x, got.y) == (want.x, want.y)
    [(points, deepest, mean)] = telemetry.snapshot()["msm_depth"]["deep"]
    assert points == n and deepest == n and 0 < mean < n / 8


def test_skewed_scalars_are_refused(setup, monkeypatch):
    """All-equal scalars at the adaptive window collapse every window into
    one bucket, which the reference's grid refuses; the port's device MSM
    takes them (no refusal, nothing left to the host): its point equals the
    reference's host engine's and the big-int oracle's, and telemetry
    records the lane depth it carried."""
    ref, prep, _ = setup
    scalars = [FR_MODULUS - 3] * N
    equal = pack_scalars(scalars)
    c = dmsm._pick_c(N)
    assert _skewed(equal, N, c)
    adaptive = port_srs(ref).device_bases("cpu", gate.forced("device"))
    telemetry.reset()
    [got] = adaptive.msm_batch_packed([equal], [N], site="msm:commit")
    want = prep.msm_packed(equal, N)
    assert (got.infinity, got.x, got.y) == (want.infinity, want.x, want.y)
    oracle = _oracle_msm(ref, scalars, monkeypatch)
    assert (got.x, got.y) == (oracle.x, oracle.y)
    tele = telemetry.snapshot()
    assert tele["dispatches"] == {"msm:commit": 2}
    [(n, deepest, mean)] = tele["msm_depth"]["msm:commit"]
    assert n == N and deepest == N and deepest > max(64, 32 * mean)


def test_skew_refusal_is_per_msm(setup, monkeypatch):
    """A batch of a random, a skewed and a random MSM runs as one device
    batch (the skewed one refused by the reference's grid): every point
    equals the reference's host engine's and the big-int oracle's; no
    refusal is counted, and each MSM's lane depth is recorded."""
    ref, prep, dev = setup
    good_sc = _case("random254")[:64]
    good = pack_scalars(good_sc)
    ones = pack_scalars([1] * N)  # N points in one lane at c = 4: skewed
    assert _skewed(ones, N, C) and not _skewed(good, 64, C)
    telemetry.reset()
    pts = dev.msm_batch_packed([good, ones, good], [64, N, 64],
                               site="msm:commit")
    want = prep.msm_batch_packed([good, ones, good])
    assert [(p.x, p.y) for p in pts] == [(w.x, w.y) for w in want]
    for pt, sc in ((pts[0], good_sc), (pts[1], [1] * N)):
        oracle = _oracle_msm(ref, sc, monkeypatch)
        assert (pt.x, pt.y) == (oracle.x, oracle.y)
    tele = telemetry.snapshot()
    assert tele["dispatches"] == {"msm:commit": 4}
    depth = tele["msm_depth"]["msm:commit"]
    assert [d[0] for d in depth] == [64, N, 64] and depth[1][1] == N


def test_base_range_is_checked(setup):
    _, _, dev = setup
    packed = pack_scalars(_case("random254")[:8])
    with pytest.raises(ValueError):
        dev.msm_batch_packed([packed], [8], offsets=[N - 4])
    with pytest.raises(ValueError):
        dev.msm_packed(packed, 9)


def _grid_from_lanes(lanes, rows):
    """The reference's (rows, L) grid layout of digit lanes: entry e of
    lane l in row e - starts[l], -1 for an empty slot."""
    lane, pts, starts = (t.numpy().astype(np.int64) for t in lanes)
    L = len(starts) - 1
    E = starts[L]
    grid = np.full((rows, L), -1, dtype=np.int32)
    grid[np.arange(E) - starts[lane[:E]], lane[:E]] = pts[:E]
    assert (lane[E:] == L).all()  # the dropped digit-0 entries sort last
    return grid


@pytest.mark.parametrize("c", [4, 6, 12])
@pytest.mark.parametrize("kind", ["random254", "bits16"])
def test_digit_grid_matches_reference(c, kind):
    scalars = _case(kind)
    packed = pack_scalars(scalars)
    sc = np.frombuffer(packed, dtype=np.uint64).reshape(-1, 4)
    want = tmsm._grid(tmsm._digits(sc, c), c)
    sct = dmsm.scalars_tensor(packed, len(scalars), "cpu")
    got = _grid_from_lanes(dmsm.digit_lanes(sct, c), want.shape[0])
    assert np.array_equal(got, want)
    shifted = _grid_from_lanes(dmsm.digit_lanes(sct, c, offset=7),
                               want.shape[0])
    assert np.array_equal(shifted, np.where(want >= 0, want + 7, -1))


def _accum_bases(kind):
    """The bases of an accumulate case: the SRS's own, or 64 points with
    repeats (doublings inside a lane) and the point at infinity."""
    from jolt_atlas_tpu_torch.curve.points import G1, g1_generator
    if kind != "dups":
        return None
    g = g1_generator()
    pts = [g * (1 + i % 5) for i in range(64)]
    pts[3] = pts[10] = G1.identity()
    return curve.points_to_tensors(pts, "cpu")


def _accum_scalars(kind, n):
    rng = np.random.default_rng(0xacc)
    if kind == "deep":  # digit 1 in window 0 for all: one lane of n entries
        return [int.from_bytes(rng.bytes(31), "little") << 4 | 1
                for _ in range(n)]
    if kind == "zeros":
        return [0] * n
    if kind == "skew":  # 5/6 of the points in one lane of window 0
        return [1] * (n * 5 // 6) + [
            int.from_bytes(rng.bytes(32), "little") % FR_MODULUS
            for _ in range(n - n * 5 // 6)]
    return [int.from_bytes(rng.bytes(32), "little") % FR_MODULUS
            for _ in range(n)]


def _grid_oracle(bases, packed, n):
    """The bucket sums of the reference's host grid (tpu/msm.py:_grid) at
    window C, in big-int points; for scalars its grid refuses as skewed,
    its digits (tpu/msm.py:_digits) summed into their lanes by the same
    rule (the top window round-robined over S sub-lanes)."""
    from jolt_atlas_tpu_torch.curve.points import G1
    base_pts = _affine(bases)
    sc = np.frombuffer(packed, dtype=np.uint64).reshape(-1, 4)
    digits = tmsm._digits(sc, C)
    W, B, S = dmsm.window_shape(C)
    try:
        cols = [col[col >= 0] for col in tmsm._grid(digits, C).T]
    except tmsm._GridSkewError:
        cols = [[] for _ in range(W * B)]
        for w in range(W):
            for i, d in enumerate(digits[w]):
                if d:
                    top = w == W - 1 and S > 1
                    cols[w * B + (d * S + i % S if top else d)].append(i)
    want = []
    for col in cols:
        total = G1.identity()
        for i in col:
            total = total + base_pts[i]
        want.append(total)
    return want


@pytest.mark.parametrize("kind,n,run", [("random254", 200, 5),
                                        ("deep", 160, 4),
                                        ("zeros", 64, 16),
                                        ("dups", 64, 3),
                                        ("random254", 100, 1),
                                        ("skew", 480, 4),
                                        ("skew", 480, 2)])
def test_accumulate_plain_matches_grid_oracle(setup, kind, n, run):
    """Kernel 2's plain version at a run length against the bucket sums of
    the reference's host grid (tpu/msm.py:_grid) in big-int points: lanes
    cut by runs (a deep lane across many), a run length that does not
    divide the entry count, empty lanes, all-zero scalars, repeated bases,
    the point at infinity, and a lane over 32 x the mean (which the
    reference's grid refuses) cut across runs and two levels of joins."""
    _, _, dev = setup
    bases = _accum_bases(kind) or dev.bases
    packed = pack_scalars(_accum_scalars(kind, n))
    lanes = dmsm.digit_lanes(dmsm.scalars_tensor(packed, n, "cpu"), C)
    E = int(lanes[2][-1])
    depth = int((lanes[2][1:] - lanes[2][:-1]).max())
    if kind == "deep":
        assert depth >= 3 * run and E % run  # spans >= 3 runs, ragged end
    if kind == "skew":
        assert depth > 32 * E / (lanes[2].shape[0] - 1)
        assert depth > run * dmsm.ACCUM_JOIN  # its heads reach level 2
    got = _affine(dmsm.bucket_accumulate_plain(bases, lanes, run))
    assert got == _grid_oracle(bases, packed, n)
    assert got == _affine(dmsm.bucket_accumulate(bases, lanes, run=run))


@pytest.mark.parametrize("run,join", [(1, 2), (2, 3), (3, 5), (1, 16)])
def test_accumulate_levels_match_grid_oracle(setup, run, join):
    """Kernel 2's plain version with its later levels at other chunk
    widths: a lane over 32 x the mean through three or more levels of
    joins, against the reference's grid in big-int points."""
    _, _, dev = setup
    n = 300
    packed = pack_scalars(_accum_scalars("skew", n))
    lanes = dmsm.digit_lanes(dmsm.scalars_tensor(packed, n, "cpu"), C)
    assert len(dmsm.accumulate_levels(lanes[0].shape[0], run, join)) >= 4
    got = _affine(dmsm.bucket_accumulate_plain(dev.bases, lanes, run, join))
    assert got == _grid_oracle(dev.bases, packed, n)


def test_accumulate_levels_plan():
    """The positions of kernel 2's levels, which size its scratch and count
    its launches: P_1 runs, then ceil(P / join) while more than one is
    left; level 1 always."""
    assert dmsm.accumulate_levels(1 << 28) == [1 << 24, 1 << 20, 1 << 16,
                                              1 << 12, 1 << 8, 16, 1]
    assert dmsm.accumulate_levels(0) == [0, 0]
    assert dmsm.accumulate_levels(5) == [1, 1]
    assert dmsm.accumulate_levels(33, 16) == [3, 1]
    assert dmsm.accumulate_levels(100, 1, 2) == [100, 50, 25, 13, 7, 4, 2, 1]


@pytest.mark.parametrize("n,run,chunked", [
    ((1 << 24) - 3, 16, 1),    # the flagship's witness
    (1 << 23, 16, 1),          # its largest fold
    (1 << 20, 4, 1),           # chip_smoke.py's hold of that class
    (1 << 21, 16, 0),          # the GPT-2-style slice's witness
    ((1 << 22) - 1, 16, 0)])   # just under 4 runs a lane
def test_accumulate_class_follows_level1_rule(n, run, chunked):
    """Kernel 2's launch class, as telemetry records it: (L, 1) where the
    lanes average 4 runs or more, so level 1 takes a thread a chunk; the
    entries are W x n whatever the scalars (digit 0 included)."""
    c = dmsm._pick_c(n)
    W, B, _ = dmsm.window_shape(c)
    one = torch.zeros(1, dtype=torch.int32)
    lanes = (one.expand(W * n),) * 2 + (one.expand(W * B + 1),)
    assert dmsm.accumulate_class(lanes, run) == (W * B, chunked)


def test_window_and_budget_rules_match_reference():
    for n in (1, 2, 100, 1 << 12, 1 << 16, (1 << 16) + 1, 1 << 18,
              (1 << 18) + 1, 1 << 21, 1 << 24):
        assert dmsm._pick_c(n) == tmsm._pick_c(n)
    for c in (4, 6, 12, 14, 16):
        W, B, S = dmsm.window_shape(c)
        assert (W, B) == ((tmsm._NBITS + c - 1) // c, 1 << c)
        assert S == B >> (tmsm._NBITS - (W - 1) * c)


# ---------------------------------------------------------------------------
# kernel 3: bucket combine (its plain version here; the kernel on the card in
# tests/test_torch_cuda.py)
# ---------------------------------------------------------------------------

def _loop_combine(acc, c):
    """The combine of the port's first slice, kept as a reference: fold
    the top window's sub-lanes by halving adds, then sum_b b * S_b as
    Gl * sum_h h * U_h + sum_l l * V_l (b = h * Gl + l) by loops of adds,
    the order of tpu/msm.py:_combine_kernel."""
    add = curve.pp_add_plain
    k = acc[0].shape[0]
    W, B, S = dmsm.window_shape(c)
    base = (W - 1) * B
    top = tuple(p[:, base:].reshape(k, B // S, S, 4) for p in acc)
    s = S
    while s > 1:
        s //= 2
        top = add(tuple(t[:, :, :s] for t in top),
                  tuple(t[:, :, s:2 * s] for t in top))
    ident = curve.pp_identity(k * (B - B // S), "cpu")
    acc = tuple(torch.cat([p[:, :base], t.reshape(k, B // S, 4),
                           i.reshape(k, B - B // S, 4)], dim=1)
                for p, t, i in zip(acc, top, ident))

    def reduce0(P):
        out = tuple(p[0] for p in P)
        for j in range(1, P[0].shape[0]):
            out = add(out, tuple(p[j] for p in P))
        return out

    def weighted(P):
        R, shape = P[0].shape[0], P[0].shape[1:]
        zero = tuple(t.reshape(shape) for t in curve.pp_identity(
            int(np.prod(shape[:-1])), "cpu"))
        wsum, run = zero, zero
        for j in range(R - 1):
            run = add(run, tuple(p[R - 1 - j] for p in P))
            wsum = add(wsum, run)
        return wsum

    ch = c // 2
    Gh, Gl = 1 << (c - ch), 1 << ch
    Sp = tuple(p.reshape(k, W, Gh, Gl, 4) for p in acc)
    U = reduce0(tuple(p.movedim(3, 0) for p in Sp))
    V = reduce0(tuple(p.movedim(2, 0) for p in Sp))
    Wh = weighted(tuple(p.movedim(2, 0) for p in U))
    Wl = weighted(tuple(p.movedim(2, 0) for p in V))
    for _ in range(ch):
        Wh = add(Wh, Wh)
    return add(Wh, Wl)


def _affine(P):
    return curve.tensors_to_points(tuple(t.reshape(-1, 4) for t in P))


def _bucket_sums(dev, k, c, seed):
    """(k, L, 4) x 3 bucket sums: projective sums of two random bases, a
    fifth of the lanes the identity, and in window 0 of every MSM the add's
    edge cases within one thread's range (lanes 1 and 2): A + A, and in
    window 1 A + (-A)."""
    W, B, _ = dmsm.window_shape(c)
    L = W * B
    rng = np.random.default_rng(seed)
    idx = [torch.from_numpy(rng.integers(0, N, size=k * L)) for _ in range(2)]
    acc = curve.pp_add_plain(*(tuple(b[i] for b in dev.bases) for i in idx))
    acc = tuple(t.reshape(k, L, 4).clone() for t in acc)
    ident = torch.from_numpy(rng.random((k, L)) < 0.2)
    one = curve.pp_identity(1, "cpu")
    for a, o in zip(acc, one):
        a[ident] = o[0]
    Pe, Qe = curve.edge_case_pairs("cpu")  # Pe[0] = A, Qe[1] = -A
    for a, p, q in zip(acc, Pe, Qe):
        a[:, 1] = p[0]
        a[:, 2] = p[0]
        a[:, B + 1] = q[1]
        a[:, B + 2] = p[0]
    return acc


def _oracle(acc, c):
    """sum_b b * S_b per (MSM, window) in big-int point arithmetic, the top
    window's sub-lanes summed into their bucket."""
    from jolt_atlas_tpu_torch.curve.points import G1
    k = acc[0].shape[0]
    W, B, S = dmsm.window_shape(c)
    pts = _affine(acc)
    out = []
    for m in range(k):
        for w in range(W):
            s = S if w == W - 1 else 1
            total = G1.identity()
            for j in range(s, B):
                total = total + pts[(m * W + w) * B + j] * (j // s)
            out.append(total)
    return out


@pytest.mark.parametrize("k,c", [(1, 4), (3, 5), (17, 4)])
def test_bucket_combine_plain_matches_oracle_and_loop(setup, k, c):
    _, _, dev = setup
    acc = _bucket_sums(dev, k, c, seed=k * 100 + c)
    got = dmsm.bucket_combine_plain(acc, c)
    W, _, _ = dmsm.window_shape(c)
    assert got[0].shape == (k, W, 4)  # no padding of the batch
    pts = _affine(got)
    assert pts == _affine(_loop_combine(acc, c))
    assert pts == _oracle(acc, c)


@pytest.fixture(scope="module")
def group_case(setup):
    """One MSM's bucket sums at c = 6 and their oracle window sums."""
    c = 6
    acc = _bucket_sums(setup[2], 1, c, seed=606)
    return c, acc, _oracle(acc, c)


@pytest.mark.parametrize("groups", [1, 2, 4, 8])
def test_bucket_combine_plain_groups_match(group_case, groups):
    """Kernel 3's plain version with each (MSM, window) split over G
    blocks (at G = 8 most threads get an empty range): the oracle's window
    sums as affine points, for every G, so every G equals G = 1."""
    c, acc, want = group_case
    assert _affine(dmsm.bucket_combine_plain(acc, c, groups)) == want


def test_combine_groups_rule():
    """Blocks per window on a 132-SM card at the prove's combine shapes:
    one MSM at c = 14 fills 16 blocks a window (8 buckets a thread), at
    c = 12 4 (8 a thread); a batch of 16 or 17 MSMs needs no split. From
    c = 16 on, 64-thread blocks fill one wave of the card (384 threads an
    SM): one MSM at c = 16 49 blocks a window (more than the 32 of the
    doubling rule), the flagship's 5 folds at c = 16 9, one MSM at c = 18
    52."""
    assert dmsm.combine_groups(1, 14, 132) == 16
    assert dmsm.combine_groups(1, 12, 132) == 4
    assert dmsm.combine_groups(16, 12, 132) == 1
    assert dmsm.combine_groups(17, 14, 132) == 1
    for k, c in ((1, 14), (1, 12), (3, 14), (1, 4)):
        G = dmsm.combine_groups(k, c, 132)
        _, B, _ = dmsm.window_shape(c)
        assert G == 1 or B // (G * dmsm.combine_threads(c)) >= 8
    assert dmsm.combine_threads(16) == dmsm.combine_threads(18) == 64
    assert dmsm.combine_groups(1, 16, 132) == 49
    assert dmsm.combine_groups(5, 16, 132) == 9
    assert dmsm.combine_groups(1, 18, 132) == 52
    for k, c in ((1, 16), (5, 16), (2, 16), (1, 18), (40, 16)):
        W, B, _ = dmsm.window_shape(c)
        G, T = dmsm.combine_groups(k, c, 132), dmsm.combine_threads(c)
        assert G == 1 or k * W * G * T <= 132 * dmsm.COMBINE_SM_THREADS
        assert B // (G * T) >= dmsm.COMBINE_MIN_CHUNK


def _sparse_bucket_sums(dev, k, c, seed):
    """(k, L, 4) x 3 bucket sums at a wide window, the identity but for 96
    lanes an MSM (sums of two random bases), among them the top window's,
    two neighbouring lanes and the add's edge cases in window 0; and the
    indices of the lanes that are not the identity."""
    W, B, _ = dmsm.window_shape(c)
    L = W * B
    rng = np.random.default_rng(seed)
    acc = tuple(t.reshape(k, L, 4).clone()
                for t in curve.pp_identity(k * L, "cpu"))
    hot = np.unique(np.concatenate([
        rng.integers(B, L, size=80), rng.integers((W - 1) * B, L, size=12),
        [1, 2, 3, 4]]))
    idx = [torch.from_numpy(rng.integers(0, N, size=(k, len(hot))))
           for _ in range(2)]
    vals = curve.pp_add_plain(*(tuple(b[i] for b in dev.bases)
                                for i in idx))
    for a, v in zip(acc, vals):
        a[:, hot] = v
    Pe, Qe = curve.edge_case_pairs("cpu")  # Pe[0] = A, Qe[1] = -A
    for a, p, q in zip(acc, Pe, Qe):
        a[:, 1] = p[0]
        a[:, 2] = p[0]
        a[:, 3] = q[1]
    return acc, hot


@pytest.mark.parametrize("k,c", [(1, 16)])
def test_bucket_combine_plain_wide_window_matches_oracle(setup, k, c):
    """Kernel 3's plain version at the card's plan for c >= 16 (64 threads
    a block, the one-wave G: 49 blocks a window) against sum_b b * S_b in
    big-int points, on sparse bucket sums (the oracle walks only the lanes
    that are not the identity). ~1 min: the plain version adds all 2^20
    lanes."""
    from jolt_atlas_tpu_torch.curve.points import G1
    _, _, dev = setup
    acc, hot = _sparse_bucket_sums(dev, k, c, seed=16 * k + c)
    G = dmsm.combine_groups(k, c, 132)
    got = _affine(dmsm.bucket_combine_plain(acc, c, G))
    W, B, S = dmsm.window_shape(c)
    want = []
    for m in range(k):
        pts = _affine(tuple(a[m, hot] for a in acc))
        win = [G1.identity()] * W
        for lane, pt in zip(hot.tolist(), pts):
            w, j = divmod(lane, B)
            win[w] = win[w] + pt * (j // (S if w == W - 1 else 1))
        want += win
    assert got == want


def test_batch_runs_each_msm_at_its_window(setup, monkeypatch):
    """A batch of mixed sizes (500, 37 and 2 points) with no forced window:
    each MSM at its own window (a small-window rule stands in for _pick_c
    so that the plain versions stay small), one combine per window size,
    every point equal to the host MSM's."""
    ref, prep, _ = setup
    monkeypatch.setattr(dmsm, "_pick_c", lambda n: 5 if n > 64 else 4)
    engine = port_srs(ref).device_bases("cpu", gate.forced("device"))
    sc = _case("random254")
    packed = [pack_scalars(sc[:500]), pack_scalars(sc[100:137]),
              pack_scalars(sc[7:9])]
    calls = []
    combine = dmsm.bucket_combine

    def spy(acc, c, groups=0):
        calls.append((acc[0].shape[0], c))
        return combine(acc, c, groups)

    monkeypatch.setattr(dmsm, "bucket_combine", spy)
    got = engine.msm_batch_packed(packed, [500, 37, 2])
    want = prep.msm_batch_packed(packed)
    assert [(p.x, p.y) for p in got] == [(p.x, p.y) for p in want]
    assert calls == [(1, 5), (2, 4)]


def test_bucket_combine_wrapper_and_identity(setup):
    """On CPU tensors the wrapper is the plain version, launches nothing,
    and checks the shape; all-identity buckets give identity windows."""
    W, B, _ = dmsm.window_shape(C)
    ident = tuple(t.reshape(2, W * B, 4)
                  for t in curve.pp_identity(2 * W * B, "cpu"))
    telemetry.reset()
    got = dmsm.bucket_combine(ident, C)
    assert all(p.infinity for p in _affine(got))
    assert telemetry.launches() == {}
    with pytest.raises(ValueError):
        dmsm.bucket_combine(tuple(t[:, :-1] for t in ident), C)


def test_telemetry_keeps_launch_lanes():
    """Each recorded launch keeps its lane count, per kernel, until reset."""
    telemetry.reset()
    for lanes in (90112, 311296, 90112):
        telemetry.launch("bucket_combine", lanes)
    telemetry.launch("pp_add", 1 << 17)
    snap = telemetry.snapshot()
    assert snap["launches"] == {"bucket_combine": 3, "pp_add": 1}
    assert snap["lanes"] == {"bucket_combine": [90112, 311296],
                             "pp_add": [1 << 17]}
    telemetry.reset()
    assert telemetry.snapshot()["lanes"] == {}
