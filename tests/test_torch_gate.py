"""The port's MSM gate (jolt_atlas_tpu_torch/device/gate.py) against the
reference's (jolt_atlas_tpu/tpu/linkcal.py): the same fabricated
calibrations and thresholds give the same decisions.

The reference reads its calibration from a JSON file under
JOLT_ATLAS_JAX_CACHE and its thresholds from module constants, which the
test patches, as tests/test_tpu_msm.py does. Every full-device decision,
split share and reason string is equal, except where the port's size floor
declines a small MSM that the reference would give the device alone; those
cases are listed in SIZE_FLOOR_CASES.
"""

import json
import os
import time

import pytest
import torch

from jolt_atlas_tpu.tpu import linkcal
from jolt_atlas_tpu_torch.device import gate

HOST = 1e6  # host points/s in every fabricated calibration

# name -> (device pts/s at 2^18, at 2^16, base set-up seconds per point);
# equal rates at both sizes fit no fixed cost, a slower 2^16 fits one
CALS = {
    "faster": (5e6, 5e6, 0.0),
    "faster_fixed": (5e6, 2.5e6, 0.0),
    "faster_setup": (5e6, 5e6, 1e-6),
    "equal": (1e6, 1e6, 0.0),
    "equal_fixed": (1e6, 0.6e6, 1e-6),
    "slower": (2e5, 2e5, 0.0),
    "slower_fixed": (2e5, 1e5, 0.0),
    "no_device": (0.0, 0.0, 0.0),
}

# (floor, min device share, max device share, least saving in seconds)
THRESHOLDS = {
    "port": (gate.SPLIT_FLOOR, gate.SPLIT_MIN_DEV, gate.SPLIT_MAX_DEV,
             gate.SPLIT_MIN_SAVE_S),
    "relay": (1 << 19, 1 << 15, 1 << 18, 0.5),
    "open": (64, 64, 1 << 18, -1.0),
}

SIZES = [64, 1 << 10, 16384, (1 << 17), (1 << 18) - 3, 1 << 18, 1 << 19,
         (1 << 20) - 7, 1 << 20]

# faster_fixed fits fixed = 17.5 ms and a slope of 7.5M pts/s: the device
# alone loses to the 1M pts/s host below ~20,200 points
SIZE_FLOOR_CASES = {("faster_fixed", 64), ("faster_fixed", 1 << 10),
                    ("faster_fixed", 16384)}


def _cal(name):
    p18, p16, sppt = CALS[name]
    return {"backend": "gpu", "up_MBps": 1e4, "down_MBps": 1e4,
            "round_64k_s": 0.001, "pallas_adds_per_s": 3e7,
            "host_msm_pps": HOST, "dev_msm_pps": p18, "dev_msm_pps_16": p16,
            "dev_base_setup_sppt": sppt, "ts": time.time()}


@pytest.fixture
def reference(tmp_path, monkeypatch):
    """A function that installs one calibration and one set of thresholds
    in the reference's linkcal."""
    monkeypatch.setenv("JOLT_ATLAS_JAX_CACHE", str(tmp_path))

    def install(cal, thresholds):
        (tmp_path / "link_calibration.json").write_text(json.dumps(cal))
        monkeypatch.setattr(linkcal, "_CACHED", None)
        for attr, v in zip(("_SPLIT_FLOOR", "_SPLIT_MIN_DEV",
                            "_SPLIT_MAX_DEV", "_SPLIT_MIN_SAVE_S"),
                           thresholds):
            monkeypatch.setattr(linkcal, attr, v)
    return install


@pytest.mark.parametrize("tname", sorted(THRESHOLDS))
def test_decisions_equal_reference(reference, tname):
    floor_cases = set()
    for name in CALS:
        cal = _cal(name)
        reference(cal, THRESHOLDS[tname])
        g = gate.MsmGate(cal, *THRESHOLDS[tname])
        for n in SIZES:
            want = linkcal.cached_msm_decision(n)
            got = g.engage(n)
            if got != want:
                assert want[0] and not got[0]
                assert got[1].startswith(want[1] + "; below the size floor")
                floor_cases.add((name, n))
            for setup in (0, 1 << 18):
                assert g.split_plan(n, setup) == \
                    linkcal.msm_split_plan(n, setup), (name, n, setup)
    assert floor_cases == SIZE_FLOOR_CASES


def test_size_floor_reduces_to_reference_without_fixed_cost():
    """With no fitted fixed cost, the device alone is decided by the rate
    margin only, at every size."""
    for name in ("faster", "equal", "slower"):
        g = gate.MsmGate(_cal(name))
        assert g.fit()[0] == 0.0
        for n in SIZES:
            assert g.engage(n) == linkcal._model_msm(n, _cal(name))


def test_choose_orders_device_split_host():
    open_ = THRESHOLDS["open"]
    for name in CALS:
        g = gate.MsmGate(_cal(name), *open_)
        for n in SIZES:
            route, n_dev, _ = g.choose(n)
            if g.engage(n)[0]:
                assert (route, n_dev) == ("device", n)
            elif g.split_plan(n)[0]:
                assert (route, n_dev) == ("split", g.split_plan(n)[0])
                assert n_dev & (n_dev - 1) == 0 and 0 < n_dev < n
            else:
                assert (route, n_dev) == ("host", 0)


def _cal3(p16, p18, p21, host=HOST):
    """A calibration measured at the three sizes (points/s each)."""
    return {"host_msm_pps": host, "dev_msm_pps_16": p16, "dev_msm_pps": p18,
            "dev_msm_pps_21": p21, "dev_base_setup_sppt": 0.0}


def test_fit_from_three_sizes():
    """With the 2^21 rate measured, sizes up to 2^18 keep the line through
    2^16 and 2^18 (the reference's two-size fit, so its decisions do not
    move) and larger sizes take the line through 2^18 and 2^21, which goes
    on beyond it."""
    t = {16: 0.010, 18: 0.020, 21: 0.090}  # seconds at 2^16, 2^18, 2^21
    g = gate.MsmGate(_cal3(*((1 << e) / t[e] for e in (16, 18, 21))))
    two = gate.MsmGate({k: v for k, v in g.cal.items()
                        if k != "dev_msm_pps_21"})
    for n in (64, 1 << 16, 3 << 16, 1 << 18):
        assert g.fit(n) == pytest.approx(two.fit(n))
        assert g.dev_time(n) == two.dev_time(n)
    for n in ((1 << 18) + 1, 1 << 20, 1 << 21, 1 << 24):
        fixed, rate = g.fit(n)
        assert rate == pytest.approx(((1 << 21) - (1 << 18)) / 0.070)
        assert fixed == pytest.approx(0.090 - (1 << 21) / rate)
        assert g.dev_time(n)[0] == pytest.approx(fixed + n / rate)
    for e in (16, 18, 21):  # through every measured point
        assert g.dev_time(1 << e)[0] == pytest.approx(t[e])


@pytest.mark.parametrize("name,routes", [
    # a card ~25x the host at 2^21 (as an H100 beside an 8-CPU host):
    # every flagship size on the device alone
    ("fast", ["device"] * 4),
    # a card that only keeps up at 2^18: the rate margin fails, and a
    # large MSM splits with a share the 2^21 line prices
    ("even", ["split"] * 4),
    # no device rate: the host
    ("none", ["host"] * 4)])
def test_routes_at_flagship_sizes(name, routes):
    """The gate's route for each MSM size of GPT-2 at its padded 125M
    shape (2^21 .. 2^24 points: the fold batch's largest folds and the
    2^24 witness) from synthetic three-size calibrations, with the port's
    thresholds; a split's share is a power of two up to SPLIT_MAX_DEV."""
    cal = {"fast": _cal3(2e6, 5e6, 2.5e7),
           "even": _cal3(0.9e6, 1e6, 1.1e6),
           "none": _cal3(0.0, 0.0, 0.0)}[name]
    g = gate.MsmGate(cal)
    sizes = [(1 << 21) - 3, 1 << 22, 1 << 23, (1 << 24) - 3]
    got = [g.choose(n) for n in sizes]
    assert [r for r, _, _ in got] == routes
    for n, (route, n_dev, _) in zip(sizes, got):
        if route == "split":
            assert n_dev & (n_dev - 1) == 0 and n_dev <= gate.SPLIT_MAX_DEV
            assert n_dev == 1 << (n.bit_length() - 2)  # even rates: half


@pytest.mark.parametrize("route", ["device", "split", "host"])
def test_forced_gates(route):
    g = gate.forced(route)
    for n in [2, 3, 64, 16384, (1 << 18) - 3, 1 << 20]:
        got, n_dev, _ = g.choose(n)
        assert got == route
        if route == "split":
            assert n_dev == 1 << (n.bit_length() - 2)
    assert g.wants_bases(1 << 18, resident=False)[0] == (route != "host")


def test_cpu_device_has_no_rates():
    g = gate.for_device("cpu")
    assert g.choose(1 << 18)[0] == "host"
    assert not g.wants_bases(1 << 18, resident=False)[0]


@pytest.fixture
def fake_card(tmp_path, monkeypatch):
    """for_device on a stand-in CUDA device: the measurement (counted in
    the returned list), the file name and the process cache are stand-ins."""
    calls = []

    def fake_measure(device):
        calls.append(device)
        return _cal("faster") | {"dev_msm_pps_21": 5e6}  # all three sizes

    path = tmp_path / "cal.json"
    monkeypatch.setattr(gate, "measure", fake_measure)
    monkeypatch.setattr(gate, "cal_path", lambda device: str(path))
    monkeypatch.setattr(gate, "_GATES", {})
    return calls, path


def test_calibration_is_measured_once_and_persisted(fake_card):
    """for_device measures a CUDA device's calibration at first use, writes
    it as JSON, keeps the gate for the process, and a new process reads the
    file back instead of measuring."""
    calls, path = fake_card
    first = gate.for_device(torch.device("cuda"))
    second = gate.for_device(torch.device("cuda"))
    assert len(calls) == 1 and os.path.exists(path)
    assert second is first
    gate._GATES.clear()  # as in a new process
    third = gate.for_device(torch.device("cuda"))
    assert len(calls) == 1
    assert first.cal == third.cal == json.loads(path.read_text())
    assert third.choose(1 << 18)[0] == "device"


def test_remeasure_replaces_the_calibration(fake_card):
    calls, path = fake_card
    first = gate.for_device(torch.device("cuda"))
    path.write_text(json.dumps({"dev_msm_pps": 1.0}))  # a stale file
    again = gate.for_device(torch.device("cuda"), remeasure=True)
    assert len(calls) == 2 and again is not first
    assert json.loads(path.read_text()) == again.cal != first.cal  # new ts
    assert gate.for_device(torch.device("cuda")) is again


def test_calibration_file_names_the_build(monkeypatch):
    """The calibration file carries the digests of the kernels' and the
    host MSM's sources, so a changed kernel is measured again."""
    from jolt_atlas_tpu_torch.device import build
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(build, "cuda_tag", lambda: "k" * 16)
    first = gate.cal_path("cuda")
    assert os.path.dirname(first) == build.BUILD_DIR
    assert os.path.basename(first).startswith("msm_gate-NVIDIA-H100-80GB-HBM3-")
    assert "k" * 16 in first and build.host_tag("msm") in first
    monkeypatch.setattr(build, "cuda_tag", lambda: "j" * 16)
    assert gate.cal_path("cuda") != first
