"""Measured gate for the device MSM engine: which MSMs go to the GPU, which
are split between the GPU and the host, and which stay on the host.

Counterpart of the MSM half of jolt_atlas_tpu/tpu/linkcal.py. The card's
own rates are measured once (``measure``) and kept as JSON in the port's
git-ignored build directory, keyed by the GPU's name, the host's CPU count
and the digests of the kernels' and the host MSM's sources, so changed
kernels are measured again: the chain of complete adds of kernel 1, the
host csrc Pippenger at 2^18 points, and the whole device MSM
(``DeviceBases``, packed scalar bytes to affine point) at 2^16, 2^18 and
2^21 points, fitted as fixed + n / rate between each two neighbouring
sizes (the last line beyond 2^21). ``MsmGate`` turns a calibration into
decisions:

- ``engage(n)``: the device alone, when its measured rate beats the host's
  by the reference's margin (1.25x) and, where the fit has a fixed cost,
  when fixed + n / rate beats n / host_rate at this n (the size floor: a
  64-point MSM stays on the host);
- ``split_plan(n)``: the power-of-two device suffix that makes both
  engines finish first, as tpu/linkcal.py:msm_split_plan;
- ``choose(n)``: "device", "split" or "host", in that order.

A gate built from given rates forces a route (``forced``); the tests and
chip_smoke.py drive each path that way. The reference's relayed-link
probe (up/down bandwidth, round latency, expiry) describes a TPU behind a
relay and is not ported: the reduction and rows engines bring their own
measured gates when they are ported.
"""

from __future__ import annotations

import json
import os
import re
import time

import numpy as np
import torch

from . import build
from .curve import pp_add
from .msm import DeviceBases

# The reference's margin for the device alone (tpu/linkcal.py:_model_msm).
FULL_MARGIN = 1.25
# Split thresholds, with the roles of tpu/linkcal.py:363-372; the values
# come from an NVIDIA H100 80GB HBM3 beside an 8-CPU host (PERF.md):
# a 2^15 device share saved nothing there, the fitted fixed cost (4.6 ms)
# equals the linear cost of ~2^16 points, the calibration measures sizes
# up to 2^21, whose line the largest opening (2^24 points, GPT-2 at its
# padded 125M shape) extends 8x, and the host MSM at 2^18 varied by ~22 ms
# within one run.
SPLIT_MIN_DEV = 1 << 16          # smallest device share worth its launches
SPLIT_FLOOR = 2 * SPLIT_MIN_DEV  # smallest MSM worth splitting
SPLIT_MAX_DEV = 1 << 24          # largest share: the largest opening's
SPLIT_MIN_SAVE_S = 0.025         # least saving that is not host noise
# the device MSM's measured sizes and their calibration keys (points/s)
CAL_SIZES = (1 << 16, 1 << 18, 1 << 21)
CAL_KEYS = ("dev_msm_pps_16", "dev_msm_pps", "dev_msm_pps_21")


class MsmGate:
    """Decisions of the device MSM engine from one calibration (the dict
    that ``measure`` returns; an empty one sends everything to the host)
    and the split thresholds."""

    def __init__(self, cal: dict, split_floor: int = SPLIT_FLOOR,
                 split_min_dev: int = SPLIT_MIN_DEV,
                 split_max_dev: int = SPLIT_MAX_DEV,
                 split_min_save_s: float = SPLIT_MIN_SAVE_S):
        self.cal = dict(cal)
        self.split_floor = split_floor
        self.split_min_dev = split_min_dev
        self.split_max_dev = split_max_dev
        self.split_min_save_s = split_min_save_s

    def fit(self, n: int = 1 << 18):
        """(fixed seconds, points/s) of dev_time(n) = fixed + n / rate on
        the line through the two neighbouring measured sizes that hold n
        (the first two below them, the last two beyond; with 2^16 and 2^18
        alone, tpu/linkcal.py:_dev_time_model), or None without a measured
        device rate at 2^18."""
        if not self.cal.get("dev_msm_pps", 0.0):
            return None
        pts = [(m, m / self.cal[k]) for m, k in zip(CAL_SIZES, CAL_KEYS)
               if self.cal.get(k, 0.0)]
        if len(pts) == 1:
            return 0.0, self.cal["dev_msm_pps"]
        i = 1
        while i < len(pts) - 1 and n > pts[i][0]:
            i += 1
        (a, ta), (b, tb) = pts[i - 1], pts[i]
        rate = (b - a) / max(tb - ta, 1e-3)
        return max(tb - b / rate, 0.0), rate

    def dev_time(self, n: int):
        """(seconds, description) of one n-point device MSM by the fit."""
        fit = self.fit(n)
        if fit is None:
            return None, "no measured device MSM rate"
        fixed, rate = fit
        return fixed + n / rate, f"fixed {fixed:.2f}s + n/{rate / 1e3:.0f}k"

    def engage(self, n: int) -> tuple[bool, str]:
        """Whether an n-point MSM goes to the device alone, and why."""
        dev_pps = self.cal.get("dev_msm_pps", 0.0)
        host_pps = self.cal.get("host_msm_pps", 0.0)
        if not dev_pps:
            return False, "no measured device MSM rate"
        if not host_pps:
            return True, "no host MSM engine"
        msg = (f"measured device {dev_pps / 1e3:.0f}k pts/s vs host "
               f"{host_pps / 1e3:.0f}k pts/s at n=2^18 "
               f"(n=2^{n.bit_length() - 1})")
        if not dev_pps > FULL_MARGIN * host_pps:
            return False, msg
        fixed, rate = self.fit(n)
        if fixed > 0 and fixed + n / rate >= n / host_pps:
            return False, (f"{msg}; below the size floor: device "
                           f"{fixed + n / rate:.6f}s >= host "
                           f"{n / host_pps:.6f}s at n={n}")
        return True, msg

    def split_plan(self, n: int, setup_points: int = 0) -> tuple[int, str]:
        """(n_dev, reason): the power-of-two device suffix of an n-point
        MSM whose predicted finish, both engines running at once, is
        soonest, or 0 for the host alone. ``setup_points`` bases still to
        upload are charged, amortised over three split MSMs."""
        host_pps = self.cal.get("host_msm_pps", 0.0)
        if not host_pps:
            return 0, "missing host engine rate"
        if n < max(self.split_floor, 2):
            return 0, f"below split floor (n=2^{n.bit_length() - 1})"
        host_only = n / host_pps
        best_nd, best_t = 0, host_only
        nd = min(1 << (n.bit_length() - 2), self.split_max_dev)
        why = ""
        while nd >= self.split_min_dev:
            dev_t, desc = self.dev_time(nd)
            if dev_t is None:
                return 0, desc
            t = max((n - nd) / host_pps, dev_t)
            if t < best_t:
                best_nd, best_t, why = nd, t, desc
            nd >>= 1
        need = self.split_min_save_s
        sppt = self.cal.get("dev_base_setup_sppt", 0.0)
        if setup_points and sppt:
            need = need + setup_points * sppt / 3.0
        if best_nd == 0 or host_only - best_t < need:
            return 0, (f"split saves {host_only - best_t:.3f}s < "
                       f"{need:.2f}s floor (incl. base-residency "
                       f"amortization) [{why or 'device model'}]")
        return best_nd, (f"split n_dev=2^{best_nd.bit_length() - 1} of "
                         f"2^{n.bit_length() - 1} [device {why}, host "
                         f"{host_pps / 1e3:.0f}k pts/s; "
                         f"saves ~{host_only - best_t:.2f}s]")

    def choose(self, n: int) -> tuple[str, int, str]:
        """(route, device points, reason) for one n-point MSM: "device"
        (all n), "split" (a power-of-two suffix) or "host" (0)."""
        ok, why = self.engage(n)
        if ok:
            return "device", n, why
        n_dev, swhy = self.split_plan(n)
        if n_dev:
            return "split", n_dev, swhy
        return "host", 0, f"{why}; {swhy}"

    def wants_bases(self, n: int, resident: bool) -> tuple[bool, str]:
        """Whether bases for n-point MSMs are worth uploading: the device
        alone or a split pays at n (commitment/kzg.py:134-157 of the
        reference)."""
        ok, why = self.engage(n)
        n_dev, swhy = self.split_plan(n, setup_points=0 if resident else n)
        return ok or n_dev > 0, why if ok else f"{why}; {swhy}"


def forced(route: str) -> MsmGate:
    """A gate whose given rates and thresholds force one route for every
    MSM of two points or more: "device" (a device far faster than the
    host, no fixed cost), "split" (equal rates: half of each MSM, rounded
    down to a power of two, on the device) or "host" (no device rate)."""
    if route == "device":
        return MsmGate({k: 1e15 for k in CAL_KEYS} | {"host_msm_pps": 1.0})
    if route == "split":
        return MsmGate({k: 1e6 for k in CAL_KEYS} | {"host_msm_pps": 1e6},
                       split_floor=2, split_min_dev=1,
                       split_max_dev=1 << 62, split_min_save_s=-1.0)
    if route == "host":
        return MsmGate({})
    raise ValueError(f"unknown MSM route {route!r}")


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------

def random_scalars(n: int, seed: int) -> bytes:
    """n uniform scalars below 2^253 (< r), 32 bytes LE each."""
    rng = np.random.default_rng(seed)
    limbs = np.frombuffer(rng.bytes(32 * n), dtype=np.uint64).reshape(n, 4)
    limbs = limbs.copy()
    limbs[:, 3] &= np.uint64((1 << 61) - 1)
    return limbs.tobytes()


def _measure_pp_adds(bases) -> float:
    """Complete adds per second of kernel 1: a chain of 16 launches on
    2^17 lanes, timed with CUDA events after one warm chain
    (tpu/linkcal.py:_measure_pallas_adds)."""
    n, iters = 1 << 17, 16
    P = tuple(b[:n] for b in bases)

    def chain():
        Q = P
        for _ in range(iters):
            Q = pp_add(Q, Q)
        return Q

    chain()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    chain()
    b.record()
    torch.cuda.synchronize()
    return iters * n / max(a.elapsed_time(b) / 1e3, 1e-9)


def _points_per_s(msm, raw: bytes, n: int) -> float:
    """n over the median seconds of three timed runs of msm(raw, n), after
    one warm-up run."""
    msm(raw, n)
    secs = []
    for _ in range(3):
        t0 = time.perf_counter()
        msm(raw, n)
        secs.append(time.perf_counter() - t0)
    return n / max(float(np.median(secs)), 1e-9)


def _measure_host_msm(prep, n: int = 1 << 18) -> float:
    """Host csrc Pippenger points per second at n (tpu/linkcal.py:
    _measure_host_msm)."""
    return _points_per_s(prep.msm_packed, random_scalars(n, 11), n)


def _measure_device_msm(engine, n: int) -> float:
    """Device MSM points per second at n, packed scalar bytes to affine
    point on the host (tpu/linkcal.py:_measure_device_msm; ``finish``
    synchronises)."""
    return _points_per_s(engine.msm_packed, random_scalars(n, 13), n)


def measure(device) -> dict:
    """Measure the calibration of a CUDA device against this host, on the
    2^18-point seed SRS (its bases repeated 8 times at 2^21: the kernels'
    time does not depend on the points). Raises where a kernel does not
    build or run."""
    from ..preprocessing import cached_srs
    device = torch.device(device)
    prep = cached_srs(18).prepared_bases()
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    engine = DeviceBases(prep.buf.raw, prep.n, device)
    torch.cuda.synchronize(device)
    cal = {"gpu": torch.cuda.get_device_name(device),
           "ncpu": os.cpu_count(), "ts": time.time(),
           "dev_base_setup_sppt": (time.perf_counter() - t0) / prep.n}
    cal["pp_add_adds_per_s"] = _measure_pp_adds(engine.projective(1 << 17))
    cal["host_msm_pps"] = _measure_host_msm(prep)
    # a device whose adds are hopeless gets no MSM rate (host only)
    ok = cal["pp_add_adds_per_s"] > 1e6
    for n, key in zip(CAL_SIZES, CAL_KEYS):
        if n > prep.n:
            engine = DeviceBases(prep.buf.raw * -(-n // prep.n),
                                 -(-n // prep.n) * prep.n, device)
        cal[key] = _measure_device_msm(engine, n) if ok else 0.0
    return cal


def cal_path(device) -> str:
    """The calibration file of this GPU (by name), host (CPU count) and
    build of the kernels and the host MSM (by their source digests)."""
    name = re.sub(r"[^A-Za-z0-9]+", "-",
                  torch.cuda.get_device_name(device)).strip("-")
    return os.path.join(build.BUILD_DIR, (
        f"msm_gate-{name}-{os.cpu_count()}cpu-{build.cuda_tag()}-"
        f"{build.host_tag('msm')}.json"))


_GATES: dict[str, MsmGate] = {}  # calibration file -> its gate


def for_device(device, remeasure: bool = False) -> MsmGate:
    """The gate of ``device``: its persisted calibration, measured and
    saved at first use (or anew with ``remeasure``), then kept for the
    process. A device other than CUDA has no measured rates, so every MSM
    stays on the host."""
    device = torch.device(device)
    if device.type != "cuda":
        return MsmGate({})
    path = cal_path(device)
    if path in _GATES and not remeasure:
        return _GATES[path]
    with build._locked("msm_gate"):
        cal = None
        if not remeasure:
            try:
                with open(path) as f:
                    cal = json.load(f)
            except (OSError, ValueError):
                pass
        if not isinstance(cal, dict) or not all(k in cal for k in CAL_KEYS):
            cal = measure(device)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(cal, f)
            os.replace(tmp, path)
    _GATES[path] = MsmGate(cal)
    return _GATES[path]
