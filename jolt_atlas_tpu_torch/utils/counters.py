"""Field-operation counters (perf accounting harness).

Reference: joltworks/src/field/tracked_ark.rs (TrackedFr) +
utils/counters.rs — a wrapper field type incrementing global counters on
every add/mul/inverse, opt-in so the production path pays nothing.
"""

from __future__ import annotations

from ..field.scalar import Fr

_COUNTS = {"add": 0, "sub": 0, "mul": 0, "inverse": 0}


def read() -> dict:
    return dict(_COUNTS)


def reset() -> None:
    for k in _COUNTS:
        _COUNTS[k] = 0


def report() -> str:
    total = sum(_COUNTS.values())
    lines = [f"{'op':<10} {'count':>14}"]
    for k, v in _COUNTS.items():
        lines.append(f"{k:<10} {v:>14,}")
    lines.append(f"{'total':<10} {total:>14,}")
    return "\n".join(lines)


class TrackedFr(Fr):
    """Drop-in Fr that counts operations (results stay TrackedFr)."""

    __slots__ = ()

    def __add__(self, o):
        _COUNTS["add"] += 1
        return TrackedFr(super().__add__(o).v)

    def __sub__(self, o):
        _COUNTS["sub"] += 1
        return TrackedFr(super().__sub__(o).v)

    def __mul__(self, o):
        _COUNTS["mul"] += 1
        return TrackedFr(super().__mul__(o).v)

    def inverse(self):
        _COUNTS["inverse"] += 1
        return TrackedFr(super().inverse().v)
