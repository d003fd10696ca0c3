"""The port's CUDA kernels against their plain PyTorch versions, on the card.

This file imports only numpy, torch and the port (no JAX, no reference), so
it also runs on a GPU machine that has no JAX, without the suite's
conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Without a CUDA device every test skips. Tolerance: exact (bit-equal limbs,
equal affine points). A forced gate (device/gate.py) picks each MSM path.
"""

import numpy as np
import pytest
import torch

from jolt_atlas_tpu_torch.commitment.kzg import KZGSRS
from jolt_atlas_tpu_torch.curve.native import pack_scalars
from jolt_atlas_tpu_torch.device import curve, gate, split
from jolt_atlas_tpu_torch.device import msm as dmsm, telemetry
from jolt_atlas_tpu_torch.field.constants import FR_MODULUS

pytestmark = pytest.mark.cuda

N = 2048


@pytest.fixture(scope="module")
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def srs(gpu):
    return KZGSRS.setup(N - 1)


def _equal(got, want):
    torch.cuda.synchronize()
    return all(torch.equal(g, w) for g, w in zip(got, want))


def test_pp_add_kernel_matches_plain(gpu, srs):
    bases = srs.device_bases(gpu, gate.forced("device")).bases
    rng = np.random.default_rng(11)
    i1, i2 = (torch.from_numpy(rng.integers(0, N, size=4096)).to(gpu)
              for _ in range(2))
    P = tuple(b[i1] for b in bases)
    Q = tuple(b[i2] for b in bases)
    before = telemetry.launches().get("pp_add", 0)
    R = curve.pp_add(P, Q)
    assert _equal(R, curve.pp_add_plain(P, Q))
    S = tuple(t.roll(1, 0) for t in R)  # projective inputs (Z != 1)
    assert _equal(curve.pp_add(R, S), curve.pp_add_plain(R, S))
    assert _equal(curve.pp_add(R, R), curve.pp_add_plain(R, R))
    Pe, Qe = curve.edge_case_pairs(gpu)
    assert _equal(curve.pp_add(Pe, Qe), curve.pp_add_plain(Pe, Qe))
    assert telemetry.launches()["pp_add"] - before == 4


def _sms(gpu):
    return torch.cuda.get_device_properties(gpu).multi_processor_count


@pytest.mark.parametrize("c,run", [(6, 16), (6, 5), (12, 16), (12, 3)])
def test_bucket_kernel_matches_plain(gpu, srs, c, run):
    """Kernel 2 against its plain version at a run length: lanes cut by
    runs, empty lanes, and a run that does not divide the entry count."""
    bases = srs.device_bases(gpu, gate.forced("device")).bases
    rng = np.random.default_rng(12)
    packed = pack_scalars([int.from_bytes(rng.bytes(32), "little")
                           % FR_MODULUS for _ in range(N)])
    lanes = dmsm.digit_lanes(dmsm.scalars_tensor(packed, N, gpu), c)
    starts = lanes[2]
    assert bool((starts[1:] == starts[:-1]).any())  # empty lanes
    before = telemetry.launches().get("bucket_accumulate", 0)
    got = dmsm.bucket_accumulate(bases, lanes, run=run)
    assert telemetry.launches()["bucket_accumulate"] - before == 2
    assert _equal(got, dmsm.bucket_accumulate_plain(bases, lanes, run))


@pytest.mark.parametrize("kind", ["random254", "bits16"])
def test_device_msm_matches_host_on_gpu(gpu, srs, kind):
    rng = np.random.default_rng(13)
    if kind == "random254":
        scalars = [int.from_bytes(rng.bytes(32), "little") % FR_MODULUS
                   for _ in range(N)]
        c = 0  # the adaptive window
    else:
        scalars = [int(x) for x in rng.integers(0, 1 << 16, size=N)]
        c = 8  # divides 16: a window straddling bit 16 would be skewed
    packed = pack_scalars(scalars)
    want = srs.prepared_bases().msm_packed(packed, N)
    before = telemetry.launches()
    got = srs.device_bases(gpu, gate.forced("device"), c=c).msm_packed(
        packed, N)
    assert (got.infinity, got.x, got.y) == (want.infinity, want.x, want.y)
    G = dmsm.combine_groups(1, c or dmsm._pick_c(N), _sms(gpu))
    for k, n in (("bucket_accumulate", 2),
                 ("bucket_combine", 2 if G > 1 else 1)):
        assert telemetry.launches()[k] - before.get(k, 0) == n


@pytest.mark.parametrize("k,c", [(3, 6), (1, 12), (2, 14), (1, 14),
                                 (16, 12)])
def test_combine_kernel_matches_plain(gpu, srs, k, c):
    """Kernel 3 against its plain version at the blocks per window the
    card's rule gives (G = 16 for one MSM at c = 14): projective bucket
    sums, a fifth of them the identity, and the add's edge cases (doubling,
    P + (-P), coordinates near p) in the first lanes of every MSM."""
    bases = srs.device_bases(gpu, gate.forced("device")).bases
    W, B, _ = dmsm.window_shape(c)
    L = W * B
    rng = np.random.default_rng(14)
    i1, i2 = (torch.from_numpy(rng.integers(0, N, size=k * L)).to(gpu)
              for _ in range(2))
    acc = curve.pp_add(tuple(b[i1] for b in bases),
                       tuple(b[i2] for b in bases))
    acc = tuple(t.reshape(k, L, 4).clone() for t in acc)
    ident = torch.from_numpy(rng.random((k, L)) < 0.2).to(gpu)
    for a, o in zip(acc, curve.pp_identity(1, gpu)):
        a[ident] = o[0]
    Pe, Qe = curve.edge_case_pairs(gpu)
    m = Pe[0].shape[0]
    for a, p, q in zip(acc, Pe, Qe):
        a[:, 1:1 + m] = p
        a[:, B + 1:B + 1 + m] = q
    G = dmsm.combine_groups(k, c, _sms(gpu))
    before = telemetry.launches().get("bucket_combine", 0)
    got = dmsm.bucket_combine(acc, c)
    assert telemetry.launches()["bucket_combine"] - before == (
        2 if G > 1 else 1)
    assert (L, G) in telemetry.snapshot()["lanes"]["bucket_combine"]
    assert got[0].shape == (k, W, 4)
    assert _equal(got, dmsm.bucket_combine_plain(acc, c, G))


def test_split_msm_matches_host_on_gpu(gpu, srs):
    rng = np.random.default_rng(15)
    packed = pack_scalars([int.from_bytes(rng.bytes(32), "little")
                           % FR_MODULUS for _ in range(N)])
    prep = srs.prepared_bases()
    dev = srs.device_bases(gpu, gate.forced("split"))
    want = prep.msm_packed(packed, N)
    for n_dev in (N // 2, N // 8, N):
        got = split.msm_packed_split(dev, prep, packed, N, n_dev, "test")
        assert (got.infinity, got.x, got.y) == (want.infinity, want.x, want.y)
    folds = [packed[:32 * 1000], packed[32 * 1000:32 * 1500], packed[:64]]
    got = split.msm_batch_split_first(dev, prep, folds, [1000, 500, 2], 512,
                                      "test")
    assert got == prep.msm_batch_packed(folds)
