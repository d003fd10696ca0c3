"""The port's host+device MSM split (jolt_atlas_tpu_torch/device/split.py)
on the CPU, where the device's kernels run as their plain versions, against
the host csrc MSM and the reference's pure-Python Pippenger; and the
BENCH_SMALL nanoGPT proved with a forced "split" gate and a forced "host"
gate, whose proof bytes must equal the reference package's.

Every comparison is exact (equal affine points, equal bytes).
"""

import os

import numpy as np
import pytest
import torch

from examples.nanogpt_style import build_model as ref_build_nanogpt
from jolt_atlas_tpu import serde as ref_serde
from jolt_atlas_tpu.commitment.kzg import KZGSRS as RefSRS
from jolt_atlas_tpu.curve import native as ref_native
from jolt_atlas_tpu.curve.msm import msm as python_msm
from jolt_atlas_tpu.curve.native import pack_scalars
from jolt_atlas_tpu.field.constants import FR_MODULUS
from jolt_atlas_tpu.preprocessing import AtlasPreprocessing as RefPP
from jolt_atlas_tpu.prover import AtlasProver as RefProver
from jolt_atlas_tpu.verifier import AtlasVerifier as RefVerifier
from jolt_atlas_tpu_torch import convert, serde
from jolt_atlas_tpu_torch.curve import native
from jolt_atlas_tpu_torch.device import gate, split, telemetry
from jolt_atlas_tpu_torch.preprocessing import AtlasPreprocessing
from jolt_atlas_tpu_torch.prover import AtlasProver
from jolt_atlas_tpu_torch.verifier import AtlasVerifier

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
C = 4  # small window: the plain versions stay quick


def _g2(p):
    return (p.x.a, p.x.b, p.y.a, p.y.b)


def _port_srs(ref):
    limbs = np.frombuffer(ref._raw_points, dtype=np.uint64).reshape(-1, 8)
    return convert.srs_from_arrays(limbs, _g2(ref.g2), _g2(ref.beta_g2),
                                   [_g2(p) for p in ref.g2_powers])


@pytest.fixture(scope="module")
def setup():
    ref = RefSRS.setup(N - 1)
    srs = _port_srs(ref)
    dev = srs.device_bases("cpu", gate.forced("device"), c=C)
    return ref, srs.prepared_bases(), dev


def _scalars(n, seed=0x5717):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % FR_MODULUS
            for _ in range(n)]


def _xy(p):
    return (p.infinity, p.x, p.y)


@pytest.mark.parametrize("n_dev", [256, 1, 300], ids=["half", "one", "k0"])
def test_split_msm_matches_host(setup, n_dev):
    """The device takes bases [300 - n_dev, 300), a nonzero offset unless
    it takes everything (k = 0: no host prefix)."""
    _, prep, dev = setup
    packed = pack_scalars(_scalars(300))
    got = split.msm_packed_split(dev, prep, packed, 300, n_dev, "test")
    assert _xy(got) == _xy(prep.msm_packed(packed, 300))


def test_split_msm_matches_python_oracle(setup, monkeypatch):
    ref, prep, dev = setup
    scalars = _scalars(96)
    got = split.msm_packed_split(dev, prep, pack_scalars(scalars), 96, 32,
                                 "test")
    monkeypatch.setattr(ref_native, "_LIB", None)
    monkeypatch.setattr(ref_native, "_TRIED", True)
    want = python_msm(ref.g1_powers[:96], scalars)
    assert (got.x, got.y) == (want.x, want.y)


def test_skewed_suffix_falls_back_to_host(setup, monkeypatch):
    """A suffix of equal scalars, which the reference's TPU grid refuses as
    skewed, runs on the device all the same: the split's point, and the
    routed call's, equal the reference's host engine's and the big-int
    oracle's; nothing is refused or left to the host, and the suffix's
    deepest lane is recorded."""
    from jolt_atlas_tpu.tpu import msm as tmsm
    ref, prep, dev = setup
    scalars = _scalars(256) + [1] * 256
    packed = pack_scalars(scalars)
    assert tmsm._host_grid_rows(packed[32 * 256:], 256, C) < 0
    want = prep.msm_packed(packed, N)
    telemetry.reset()
    got = split.msm_packed_split(dev, prep, packed, N, 256, "test")
    assert _xy(got) == _xy(want)
    tele = telemetry.snapshot()
    assert tele["dispatches"] == {"msm:test": 2}
    assert tele["msm_depth"]["msm:test"][0][:2] == [256, 256]
    got = split.msm_batch_routed(dev, gate.forced("split"), prep, [packed],
                                 [N], "test")
    assert _xy(got[0]) == _xy(want)
    monkeypatch.setattr(ref_native, "_LIB", None)
    monkeypatch.setattr(ref_native, "_TRIED", True)
    oracle = python_msm(ref.g1_powers[:N], scalars)
    assert (got[0].x, got[0].y) == (oracle.x, oracle.y)


def test_host_threads_set_and_restored(setup, monkeypatch):
    """While the suffix runs, the host engine gets ncpu - 1 OpenMP threads,
    and all of them back after the prefix."""
    _, prep, dev = setup
    calls = []
    monkeypatch.setattr(split, "_HOST_THREADS", None)  # all CPUs: 8
    monkeypatch.setattr(os, "cpu_count", lambda: 8)
    monkeypatch.setattr(native._load(), "msm_set_threads", calls.append)
    packed = pack_scalars(_scalars(300))
    split.msm_packed_split(dev, prep, packed, 300, 128, "test")
    assert calls == [7, 8]
    calls.clear()
    split.msm_packed_split(dev, prep, packed, 300, 300, "test")  # k = 0
    assert calls == []


def test_batch_split_first_matches_host(setup):
    """A fold-like batch (300, 128, 2 points): the first MSM's suffix on
    the device, the rest of the batch on the host meanwhile."""
    _, prep, dev = setup
    sc = _scalars(430)
    packed = [pack_scalars(sc[:300]), pack_scalars(sc[300:428]),
              pack_scalars(sc[428:])]
    want = prep.msm_batch_packed(packed)
    telemetry.reset()
    for n_dev in (128, 300, 0):
        got = split.msm_batch_split_first(dev, prep, packed, [300, 128, 2],
                                          n_dev, "fold")
        assert [_xy(p) for p in got] == [_xy(p) for p in want]
    assert telemetry.snapshot()["dispatches"]["msm:fold"] == 4


@pytest.mark.parametrize("route", ["device", "split", "host"])
def test_routed_batch_matches_host(setup, route):
    _, prep, dev = setup
    sc = _scalars(366)
    packed = [pack_scalars(sc[:300]), pack_scalars(sc[300:364]),
              pack_scalars(sc[364:])]
    telemetry.reset()
    got = split.msm_batch_routed(dev, gate.forced(route), prep, packed,
                                 [300, 64, 2], "commit")
    want = prep.msm_batch_packed(packed)
    assert [_xy(p) for p in got] == [_xy(p) for p in want]
    d = telemetry.snapshot()["dispatches"]
    assert d[f"msm_route_{route}:commit"] == 3
    # device: 3 accumulations + 1 combine; split: 3 x (1 + 1); host: none
    assert d.get("msm:commit", 0) == {"device": 4, "split": 6, "host": 0}[
        route]


# ---------------------------------------------------------------------------
# the BENCH_SMALL prove on each forced path
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bench_small():
    """bench.py's BENCH_SMALL workload: vocab 32, seq 8, d16, 1 block,
    1 head, weights and tokens from default_rng(1234); the reference's
    proof bytes and the port's preprocessing on the same SRS."""
    rng = np.random.default_rng(1234)
    model = ref_build_nanogpt(32, 8, 16, 1, 8, rng, heads=1)
    toks = rng.integers(0, 32, size=8).astype(np.int32)
    ref_pp = RefPP.preprocess(model)
    ref_proof, _ = RefProver(ref_pp).prove([toks])
    srs = ref_pp.srs
    limbs = np.frombuffer(srs._raw_points, dtype=np.uint64).reshape(-1, 8)
    port_srs = convert.srs_from_arrays(limbs, _g2(srs.g2), _g2(srs.beta_g2),
                                       [_g2(p) for p in srs.g2_powers])
    pp = AtlasPreprocessing(
        convert.model_from_reference(convert.describe_model(model)),
        port_srs)
    return ref_pp, ref_serde.serialize_proof(ref_proof), pp, toks


@pytest.mark.parametrize("route", ["split", "host"])
def test_forced_path_prove_bytes_equal_reference(bench_small, route):
    ref_pp, ref_bytes, pp, toks = bench_small
    telemetry.reset()
    proof, io = AtlasProver(pp, device=torch.device("cpu"), msm_window=6,
                            msm_gate=gate.forced(route)).prove([toks])
    tele = telemetry.snapshot()
    blob = serde.serialize_proof(proof)
    assert blob == ref_bytes
    assert AtlasVerifier(pp).verify(proof, io)
    ref_io = tuple([np.asarray(t) for t in part] for part in io)
    assert RefVerifier(ref_pp).verify(ref_serde.deserialize_proof(blob),
                                      ref_io)
    d = tele["dispatches"]
    if route == "split":
        assert tele["decisions"]["msm"].startswith("ENGAGED")
        assert tele["decisions"]["msm:hyperkzg_fold"].startswith("split")
        assert d["msm:hyperkzg_fold"] == 2  # P_1's suffix: 1 + combine
        assert d["msm:hyperkzg_witness"] == 2
        assert d["msm_route_split:commit"] > 0
    else:
        assert tele["decisions"]["msm"].startswith("declined")
        assert not any(k.startswith("msm") for k in d)
