"""Device-path telemetry: which engines engaged, why the others declined,
how many device dispatches each issued, and how many times each CUDA
kernel was launched.

Counterpart of jolt_atlas_tpu/tpu/telemetry.py. ``launches`` is new: each
kernel wrapper adds one where it launches its kernel (and nowhere else),
so a run can show that its main path really went through the kernels.
The plain PyTorch versions count nothing.
"""

from __future__ import annotations

_COUNTS: dict[str, int] = {}
_DECISIONS: dict[str, str] = {}
_LAUNCHES: dict[str, int] = {}


def count(engine: str, n: int = 1) -> None:
    """Record n device dispatches issued by an engine."""
    _COUNTS[engine] = _COUNTS.get(engine, 0) + n


def decide(engine: str, decision: str) -> None:
    """Record the most recent engage/decline decision for an engine."""
    _DECISIONS[engine] = decision


def launch(kernel: str) -> None:
    """Record one launch of a CUDA kernel (called by its wrapper only)."""
    _LAUNCHES[kernel] = _LAUNCHES.get(kernel, 0) + 1


def launches() -> dict[str, int]:
    return dict(_LAUNCHES)


def snapshot() -> dict:
    """{"dispatches": {engine: n}, "decisions": {engine: reason},
    "launches": {kernel: n}}."""
    return {"dispatches": dict(_COUNTS), "decisions": dict(_DECISIONS),
            "launches": dict(_LAUNCHES)}


def reset_counts() -> None:
    """Zero the dispatch and launch counts; decisions stay."""
    _COUNTS.clear()
    _LAUNCHES.clear()


def reset() -> None:
    reset_counts()
    _DECISIONS.clear()
