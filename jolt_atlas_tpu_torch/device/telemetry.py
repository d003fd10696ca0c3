"""Device-path telemetry: which engines engaged, why the others declined,
how many device dispatches each issued, and how many times each CUDA
kernel was launched, and at which widths.

Counterpart of jolt_atlas_tpu/tpu/telemetry.py. ``launches`` is new: each
kernel wrapper adds one where it launches its kernel (and nowhere else),
so a run can show that its main path really went through the kernels.
``lanes`` keeps the shapes each kernel was launched at (its lane count,
or for kernel 3 the lane count and blocks per window: what fixes its
partition; for kernel 7 its rows, points, terms, weight layout and launch
plan), so a run can check that each one was held against the plain
version. The plain PyTorch versions count nothing. ``lane_depth`` keeps
each device MSM's deepest digit lane beside its mean, the skew that kernel
2 carries (the reference's TPU grid refuses a lane deeper than max(64, 32
x the mean)). ``tally`` counts the host's side of the work beside the
dispatches: the calls into the host field engine (``host_field_calls``,
field/frvec.py), the IOP's batched sumcheck rounds, the row elements the
IOP's Gruen instances bind on the card and on the host; utils/profiling
keeps each counter's change across a proof. ``EngineScope`` is the scope
an IOP engine's entry point takes its work under (device/rows.py,
device/onehot.py, device/bind.py, parallel/shardedreduction.py), which
records the engine's decisions here.
"""

from __future__ import annotations

import torch

_COUNTS: dict[str, int] = {}
_DECISIONS: dict[str, str] = {}
_LAUNCHES: dict[str, int] = {}
_LANES: dict[str, set] = {}
_DEPTHS: dict[str, list] = {}
_COUNTERS: dict[str, int] = {}


def count(engine: str, n: int = 1) -> None:
    """Record n device dispatches issued by an engine."""
    _COUNTS[engine] = _COUNTS.get(engine, 0) + n


def tally(counter: str, n: int = 1) -> None:
    """Add n to one of the host's work counters."""
    _COUNTERS[counter] = _COUNTERS.get(counter, 0) + n


def counted(counter: str, fn):
    """``fn``, each call adding one to ``counter``."""
    counts = _COUNTERS  # reset() clears it in place

    def call(*args):
        counts[counter] = counts.get(counter, 0) + 1
        return fn(*args)
    return call


def counters() -> dict[str, int]:
    return dict(_COUNTERS)


def decide(engine: str, decision: str) -> None:
    """Record the most recent engage/decline decision for an engine."""
    _DECISIONS[engine] = decision


def launch(kernel: str, lanes) -> None:
    """Record one launch of a CUDA kernel at shape ``lanes`` (an int or a
    tuple of ints; called by its wrapper only)."""
    _LAUNCHES[kernel] = _LAUNCHES.get(kernel, 0) + 1
    _LANES.setdefault(kernel, set()).add(
        tuple(lanes) if isinstance(lanes, tuple) else int(lanes))


def lane_depth(site: str, n: int, deepest: int, mean: float) -> None:
    """Record one device MSM of n points at ``site``: its deepest lane
    (entries) and the mean entries a lane."""
    _DEPTHS.setdefault(site, []).append([int(n), int(deepest), float(mean)])


def launches() -> dict[str, int]:
    return dict(_LAUNCHES)


def snapshot() -> dict:
    """{"dispatches": {engine: n}, "decisions": {engine: reason},
    "launches": {kernel: n}, "lanes": {kernel: sorted launch shapes},
    "msm_depth": {site: [[points, deepest lane, mean lane], ...]},
    "counters": {counter: n}}."""
    return {"dispatches": dict(_COUNTS), "decisions": dict(_DECISIONS),
            "launches": dict(_LAUNCHES),
            "lanes": {k: sorted(v) for k, v in _LANES.items()},
            "msm_depth": {k: [list(r) for r in v]
                          for k, v in _DEPTHS.items()},
            "counters": dict(_COUNTERS)}


def reset() -> None:
    """Zero the dispatch, launch and work counts and forget the decisions,
    the launch widths and the MSMs' lane depths."""
    _COUNTS.clear()
    _COUNTERS.clear()
    _DEPTHS.clear()
    _LAUNCHES.clear()
    _LANES.clear()
    _DECISIONS.clear()


class EngineScope:
    """While entered, an IOP engine's entry point offers it work from the
    host path (AtlasProver._iop_engines decides which scopes a proof
    enters). Counts the work offered, engaged and declined (by reason); on
    exit records decisions[ENGINE], with the engine's elements (the
    counter COUNTER) and dispatches (DISPATCHES, by default ENGINE) while
    it was entered, and, for the declines, decisions[ENGINE +
    ":declined"]. A subclass names ENGINE, COUNTER and its summary's ITEMS
    and ELEMENTS; ``entered`` is its entered scope."""

    ENGINE = COUNTER = ITEMS = ELEMENTS = ""
    DISPATCHES = None
    entered = None

    def __init__(self, device):
        self.device = torch.device(device)
        self.offered = self.engaged = 0
        self.declined: dict[str, int] = {}

    def _work(self) -> tuple:
        """(the engine's elements, its dispatches) so far."""
        return (_COUNTERS.get(self.COUNTER, 0),
                _COUNTS.get(self.DISPATCHES or self.ENGINE, 0))

    def __enter__(self):
        cls = type(self)
        self._prev, cls.entered = cls.entered, self
        self._start = self._work()
        return self

    def __exit__(self, *exc):
        type(self).entered = self._prev
        decide(self.ENGINE, self.summary())
        if self.declined:
            decide(self.ENGINE + ":declined", ", ".join(
                f"{why}: {k}" for why, k in sorted(self.declined.items())))
        return False

    def decline(self, why: str) -> None:
        self.declined[why] = self.declined.get(why, 0) + 1

    def summary(self) -> str:
        if self.engaged:
            elements, calls = (b - a for a, b in zip(self._start,
                                                     self._work()))
            return (f"ENGAGED ({self.engaged} of {self.offered} "
                    f"{self.ITEMS}, {elements} {self.ELEMENTS}, {calls} "
                    f"dispatches)")
        return f"none engaged ({self.offered} {self.ITEMS} offered)"
