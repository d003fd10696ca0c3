"""The port's device MSM (jolt_atlas_tpu_torch/device/msm.py) on the CPU,
where its kernels run as their plain PyTorch versions, against the
reference's host engine (csrc msm via KZGSRS.prepared_bases) and the
reference's pure-Python Pippenger.

The cases are those of tests/test_tpu_msm.py: a forced c = 4 window, random
254-bit, 24-byte and 16-bit scalars, all-zero scalars, a single base, r-1,
a nonzero base offset and skew rejection. The on-device digit lanes are
also held against the reference's numpy grid builder tpu/msm.py:_grid, and
the plain versions of kernels 2 and 3 against big-int oracles at several
partitions. Every comparison is exact (equal affine points, equal grids).
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
from jolt_atlas_tpu_torch import convert
from jolt_atlas_tpu_torch.device import curve, gate, msm as dmsm, split
from jolt_atlas_tpu_torch.device import telemetry

# the suite runs in several worker processes at once: a small intra-op
# pool keeps this file from starving its neighbours' timed tests
torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def _few_host_threads():
    """The csrc host engines' OpenMP threads capped likewise while this
    file runs (the reference's wall-clock tests share the machine)."""
    split.set_host_threads(2)
    yield
    split.set_host_threads(None)

N = 512
C = 4  # 64 windows x 16 buckets: small for the plain versions


def _g2(p):
    return (p.x.a, p.x.b, p.y.a, p.y.b)


def port_srs(ref):
    limbs = np.frombuffer(ref._raw_points, dtype=np.uint64).reshape(-1, 8)
    return convert.srs_from_arrays(limbs, _g2(ref.g2), _g2(ref.beta_g2),
                                   [_g2(p) for p in ref.g2_powers])


@pytest.fixture(scope="module")
def setup():
    ref = RefSRS.setup(N - 1)
    srs = port_srs(ref)
    return ref, ref.prepared_bases(), srs.device_bases(
        "cpu", gate.forced("device"), c=C)


def _case(name):
    rng = np.random.default_rng(0x715)
    return {
        "random254": [int.from_bytes(rng.bytes(32), "little") % FR_MODULUS
                      for _ in range(N)],
        "bytes24": [int.from_bytes(rng.bytes(24), "little")
                    for _ in range(N)],
        "bits16": [int(x) for x in rng.integers(0, 1 << 16, size=N)],
        "zeros": [0] * N,
        "single": [1] + [0] * (N - 1),
        "r_minus_1": [FR_MODULUS - 1] * 8,
    }[name]


@pytest.mark.parametrize("name", ["random254", "bytes24", "bits16", "zeros",
                                  "single", "r_minus_1"])
def test_device_msm_matches_host(setup, name):
    ref, prep, dev = setup
    scalars = _case(name)
    packed = pack_scalars(scalars)
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


def test_deep_lane_doubles_rows_and_drops_nothing(setup):
    """Every scalar has digit 1 in window 0: that lane holds all n points,
    far above the static budget, but below the skew cap. The budget must
    double until it holds them."""
    _, prep, dev = setup
    n = 160
    rng = np.random.default_rng(5)
    scalars = [int.from_bytes(rng.bytes(31), "little") << 4 | 1
               for _ in range(n)]
    packed = pack_scalars(scalars)
    assert dmsm.rows_for(packed, n, C) >= n > dmsm.grid_rows_for(n, C)
    got = dev.msm_packed(packed, n)
    want = prep.msm_packed(packed, n)
    assert (got.x, got.y) == (want.x, want.y)


def test_skewed_scalars_are_refused(setup):
    """All-equal scalars at the adaptive window collapse every window into
    one bucket: refused by the host count before any device work."""
    ref, _, _ = setup
    equal = pack_scalars([FR_MODULUS - 3] * N)
    adaptive = port_srs(ref).device_bases("cpu", gate.forced("device"))
    with pytest.raises(dmsm._GridSkewError):
        adaptive.msm_batch_packed([equal], [N])
    # the callers' form: None (take the host engine), refusal counted
    telemetry.reset()
    assert adaptive.try_msm_batch([equal], [N], "commit") == [None]
    assert telemetry.snapshot()["dispatches"] == {
        "msm_skew_fallback:commit": 1}


def test_skew_refusal_is_per_msm(setup):
    """In a batch, only the skewed MSM is left to the host: the others run
    on the device, and host_fill completes the batch."""
    _, prep, dev = setup
    good = pack_scalars(_case("random254")[:64])
    ones = pack_scalars([1] * N)  # N points in one lane at c = 4: skewed
    telemetry.reset()
    pts = dev.try_msm_batch([good, ones, good], [64, N, 64], "commit")
    want = prep.msm_packed(good, 64)
    assert pts[1] is None
    assert [(p.x, p.y) for p in (pts[0], pts[2])] == [(want.x, want.y)] * 2
    assert telemetry.snapshot()["dispatches"] == {
        "msm_skew_fallback:commit": 1, "msm:commit": 3}
    filled = dmsm.host_fill(pts, lambda ix: [prep.msm_packed(ones, N)
                                             for _ in ix])
    host = prep.msm_packed(ones, N)
    assert (filled[1].x, filled[1].y) == (host.x, host.y)


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
    return [int.from_bytes(rng.bytes(32), "little") % FR_MODULUS
            for _ in range(n)]


@pytest.mark.parametrize("kind,n,run", [("random254", 200, 5),
                                        ("deep", 160, 4),
                                        ("zeros", 64, 16),
                                        ("dups", 64, 3),
                                        ("random254", 100, 1)])
def test_accumulate_plain_matches_grid_oracle(setup, kind, n, run):
    """Kernel 2's plain version at a run length against the bucket sums of
    the reference's host grid (tpu/msm.py:_grid) in big-int points: lanes
    cut by runs (a deep lane across many), a run length that does not
    divide the entry count, empty lanes, all-zero scalars, repeated bases
    and the point at infinity."""
    from jolt_atlas_tpu_torch.curve.points import G1
    _, _, dev = setup
    bases = _accum_bases(kind) or dev.bases
    base_pts = _affine(bases)
    packed = pack_scalars(_accum_scalars(kind, n))
    sc = np.frombuffer(packed, dtype=np.uint64).reshape(-1, 4)
    grid = tmsm._grid(tmsm._digits(sc, C), C)
    lanes = dmsm.digit_lanes(dmsm.scalars_tensor(packed, n, "cpu"), C)
    E = int(lanes[2][-1])
    if kind == "deep":
        depth = (lanes[2][1:] - lanes[2][:-1]).max()
        assert depth >= 3 * run and E % run  # spans >= 3 runs, ragged end
    got = _affine(dmsm.bucket_accumulate_plain(bases, lanes, run))
    want = []
    for col in grid.T:
        total = G1.identity()
        for i in col[col >= 0]:
            total = total + base_pts[i]
        want.append(total)
    assert got == want
    assert got == _affine(dmsm.bucket_accumulate(bases, lanes, run=run))


def test_window_and_budget_rules_match_reference():
    for n in (1, 2, 100, 1 << 12, 1 << 16, (1 << 16) + 1, 1 << 18,
              (1 << 18) + 1):
        assert dmsm._pick_c(n) == tmsm._pick_c(n)
        for c in (4, 8, 12, 14, 16):
            assert dmsm.grid_rows_for(n, c) == tmsm.grid_rows_for(n, c)
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
    c = 12 4 (8 a thread); a batch of 16 or 17 MSMs needs no split."""
    assert dmsm.combine_groups(1, 14, 132) == 16
    assert dmsm.combine_groups(1, 12, 132) == 4
    assert dmsm.combine_groups(16, 12, 132) == 1
    assert dmsm.combine_groups(17, 14, 132) == 1
    for k, c in ((1, 14), (1, 12), (3, 14), (1, 4)):
        G = dmsm.combine_groups(k, c, 132)
        _, B, _ = dmsm.window_shape(c)
        assert G == 1 or B // (G * dmsm.combine_threads(c)) >= 8


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
