"""The port's device MSM (jolt_atlas_tpu_torch/device/msm.py) on the CPU,
where its kernels run as their plain PyTorch versions, against the
reference's host engine (csrc msm via KZGSRS.prepared_bases) and the
reference's pure-Python Pippenger.

The cases are those of tests/test_tpu_msm.py: a forced c = 4 window, random
254-bit, 24-byte and 16-bit scalars, all-zero scalars, a single base, r-1,
a nonzero base offset and skew rejection. The on-device digit grid is also
held against the reference's numpy builder tpu/msm.py:_grid. Every
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
from jolt_atlas_tpu_torch import convert
from jolt_atlas_tpu_torch.device import msm as dmsm, telemetry

# the suite runs in several worker processes at once: a small intra-op
# pool keeps this file from starving its neighbours' timed tests
torch.set_num_threads(2)

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
    return ref, ref.prepared_bases(), srs.device_bases("cpu", c=C)


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
    adaptive = port_srs(ref).device_bases("cpu")
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


@pytest.mark.parametrize("c", [4, 6, 12])
@pytest.mark.parametrize("kind", ["random254", "bits16"])
def test_digit_grid_matches_reference(c, kind):
    scalars = _case(kind)
    packed = pack_scalars(scalars)
    sc = np.frombuffer(packed, dtype=np.uint64).reshape(-1, 4)
    want = tmsm._grid(tmsm._digits(sc, c), c)
    sct = dmsm.scalars_tensor(packed, len(scalars), "cpu")
    got = dmsm.digit_grid(sct, c, want.shape[0])
    assert np.array_equal(got.numpy(), want)
    shifted = dmsm.digit_grid(sct, c, want.shape[0], offset=7)
    assert np.array_equal(shifted.numpy(), np.where(want >= 0, want + 7, -1))


def test_window_and_budget_rules_match_reference():
    for n in (1, 2, 100, 1 << 12, 1 << 16, (1 << 16) + 1, 1 << 18,
              (1 << 18) + 1):
        assert dmsm._pick_c(n) == tmsm._pick_c(n)
        for c in (4, 8, 12, 14, 16):
            assert dmsm.grid_rows_for(n, c) == tmsm.grid_rows_for(n, c)
    assert dmsm._pow2_pad(17) == tmsm._pow2_pad(17) == 32
