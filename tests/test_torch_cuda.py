"""The port's CUDA kernels against their plain PyTorch versions, on the card.

This file imports only numpy, torch and the port (no JAX, no reference), so
it also runs on a GPU machine that has no JAX, without the suite's
conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Without a CUDA device every test skips. Tolerance: exact (bit-equal limbs,
equal affine points).
"""

import numpy as np
import pytest
import torch

from jolt_atlas_tpu_torch.commitment.kzg import KZGSRS
from jolt_atlas_tpu_torch.curve.native import pack_scalars
from jolt_atlas_tpu_torch.device import curve
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
    bases = srs.device_bases(gpu).bases
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


def test_bucket_kernel_matches_plain(gpu, srs):
    bases = srs.device_bases(gpu).bases
    rng = np.random.default_rng(12)
    packed = pack_scalars([int.from_bytes(rng.bytes(32), "little")
                           % FR_MODULUS for _ in range(N)])
    c = 6
    grid = dmsm.digit_grid(dmsm.scalars_tensor(packed, N, gpu), c,
                           dmsm.rows_for(packed, N, c))
    assert bool((grid < 0).any())  # empty slots are exercised
    assert _equal(dmsm.bucket_accumulate(bases, grid),
                  dmsm.bucket_accumulate_plain(bases, grid))


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
    before = telemetry.launches().get("bucket_accumulate", 0)
    got = srs.device_bases(gpu, c=c).msm_packed(packed, N)
    assert (got.infinity, got.x, got.y) == (want.infinity, want.x, want.y)
    assert telemetry.launches()["bucket_accumulate"] - before == 1
