"""Host+device MSM: the GPU takes a power-of-two suffix of the points while
the host Pippenger runs the prefix at the same time, and one point add
joins the two sums. Also the per-MSM routing of a batch by the gate.

Counterpart of jolt_atlas_tpu/tpu/splitmsm.py. ``DeviceBases.start``
returns as soon as the suffix's kernels are queued, so the host prefix
(csrc ``msm_g1_pre``, which releases the interpreter lock) overlaps them;
``finish`` waits for the device. While device work is in flight the host
engine runs on ncpu - 1 OpenMP threads, one core staying free to feed the
device, and is given all of them back afterwards. The share comes from the
measured gate (device/gate.py); the callers pass it in.
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass

from . import telemetry
from .msm import DeviceBases, host_fill


@dataclass
class SplitState:
    """A queued device suffix: its engine, its ``start`` handle and the
    host prefix length k."""
    dev: DeviceBases
    handle: tuple
    k: int


def start_split(dev: DeviceBases, packed: bytes, count: int, n_dev: int,
                site: str) -> SplitState:
    """Queue the device's share, bases [count - n_dev, count), of one MSM
    and return without waiting for it."""
    k = count - n_dev
    handle = dev.start([packed[32 * k:32 * count]], [n_dev], offsets=[k],
                       site="msm:" + site)
    return SplitState(dev, handle, k)


def finish_split(state: SplitState, host_prefix_pt):
    """The device suffix's point plus the host prefix's (None: no prefix)."""
    dev_pt = state.dev.finish(state.handle)[0]
    return dev_pt if host_prefix_pt is None else host_prefix_pt + dev_pt


_HOST_THREADS: int | None = None  # None: all CPUs


def base_threads() -> int:
    """The host engines' OpenMP threads outside a split."""
    return _HOST_THREADS or os.cpu_count() or 1


def set_host_threads(n: int | None) -> None:
    """Run the host engines on n OpenMP threads from now on (None: all
    CPUs). The count is the calling thread's, so it caps the csrc MSM and,
    through the same OpenMP runtime, csrc frvec's loops."""
    global _HOST_THREADS
    from ..curve import native
    _HOST_THREADS = n
    native._load().msm_set_threads(base_threads())


@contextlib.contextmanager
def host_threads(n: int):
    """Run the host Pippenger on n OpenMP threads inside the block, on
    ``base_threads()`` after it."""
    from ..curve import native
    lib = native._load()
    lib.msm_set_threads(n)
    try:
        yield
    finally:
        lib.msm_set_threads(base_threads())


def spare_threads() -> int:
    """Host MSM threads while device work is in flight: all but one."""
    return max(1, base_threads() - 1)


def msm_packed_split(dev: DeviceBases, prep, packed: bytes, count: int,
                     n_dev: int, site: str):
    """One MSM of ``count`` canonical 32-byte LE scalars over bases
    [0, count), the last n_dev on the device and the prefix on the host at
    the same time. The affine point."""
    st = start_split(dev, packed, count, n_dev, site)
    host_pt = None
    if st.k:
        with host_threads(spare_threads()):
            host_pt = prep.msm_packed(packed[:32 * st.k], st.k)
    return finish_split(st, host_pt)


def msm_batch_split_first(dev: DeviceBases, prep, packed: list[bytes],
                          counts: list[int], n_dev: int, site: str) -> list:
    """A host batch whose first MSM gives its n_dev-point suffix to the
    device: the suffix is queued first, so it overlaps the host's work on
    the first MSM's prefix and on every other MSM (commitment/hyperkzg.py:
    130-146 of the reference). The affine points, in order."""
    if not n_dev:
        return prep.msm_batch_packed(packed)
    st = start_split(dev, packed[0], counts[0], n_dev, site)
    host_work = ([packed[0][:32 * st.k]] if st.k else []) + packed[1:]
    host = []
    if host_work:
        with host_threads(spare_threads()):
            host = prep.msm_batch_packed(host_work)
    if not st.k:
        return [finish_split(st, None)] + host
    return [finish_split(st, host[0])] + host[1:]


def msm_fold_batch(dev: DeviceBases | None, gate, prep,
                   packed: list[bytes], counts: list[int], site: str) -> list:
    """A batch of MSMs (bases [0, count)), largest first: on the device as
    one batch when the gate gives the device the batch's total size (one
    device batch pays the device's fixed cost once), else with the first
    MSM's device share queued first if the gate splits it
    (``msm_batch_split_first``), else on the host. The affine points."""
    if dev is None:
        return prep.msm_batch_packed(packed)
    whole, why = gate.engage(sum(counts))
    n_dev = 0
    if not whole:
        n_dev, why = gate.split_plan(counts[0])
    route = "device" if whole else "split" if n_dev else "host"
    telemetry.decide("msm:" + site, f"{route}: {why}")
    if whole:
        return dev.msm_batch_packed(packed, counts, site="msm:" + site)
    return msm_batch_split_first(dev, prep, packed, counts, n_dev, site)


def msm_batch_routed(dev: DeviceBases | None, gate, prep,
                     packed: list[bytes], counts: list[int],
                     site: str) -> list:
    """Each MSM of a batch (bases [0, count)) by the gate's route: the
    "device" ones as one device batch, the "split" ones one by one, the
    rest as one host batch (``host_fill``). With no device engine, all on
    the host. The affine points, in order."""
    pts: list = [None] * len(packed)
    if dev is not None:
        routes = [gate.choose(n) for n in counts]
        for (route, _, why), n in zip(routes, counts):
            telemetry.decide("msm:" + site, f"{route} (n={n}): {why}")
            telemetry.count(f"msm_route_{route}:{site}")
        on_dev = [i for i, r in enumerate(routes) if r[0] == "device"]
        if on_dev:
            got = dev.msm_batch_packed([packed[i] for i in on_dev],
                                       [counts[i] for i in on_dev],
                                       site="msm:" + site)
            for i, pt in zip(on_dev, got):
                pts[i] = pt
        for i, (route, n_dev, _) in enumerate(routes):
            if route == "split":
                pts[i] = msm_packed_split(dev, prep, packed[i], counts[i],
                                          n_dev, site)
    return host_fill(pts, lambda ix: prep.msm_batch_packed(
        [packed[i] for i in ix]))
