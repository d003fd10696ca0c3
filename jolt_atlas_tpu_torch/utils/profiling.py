"""Phase tracing / profiling.

Reference: common/src/utils/logging.rs (span timings via --trace-terminal)
and joltworks/src/utils/profiling.rs (labeled memory spans). Spans nest; a
report dumps per-phase wall time and peak RSS delta. Enable with
JOLT_ATLAS_TRACE=1 or `enable()`.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager

_ENABLED = os.environ.get("JOLT_ATLAS_TRACE", "") not in ("", "0")
# JOLT_ATLAS_TRACE=2 additionally streams each span to stderr as it closes
# (long proves under a timeout would otherwise lose the report entirely)
_STREAM = os.environ.get("JOLT_ATLAS_TRACE", "") == "2"
_EVENTS: list[tuple[str, float, int]] = []
_DEPTH = 0


def enable(on: bool = True) -> None:
    global _ENABLED
    _ENABLED = on


def enabled() -> bool:
    return _ENABLED


def events() -> list[tuple[str, float, int]]:
    """The closed spans since the last reset(), in closing order: (name
    indented two spaces a nesting level, wall seconds, RSS delta in KB)."""
    return list(_EVENTS)


def _rss_kb() -> int:
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    return int(line.split()[1])
    except OSError:
        pass
    return 0


@contextmanager
def span(name: str):
    """Timed (and RSS-tracked) phase span; nests."""
    global _DEPTH
    if not _ENABLED:
        yield
        return
    depth = _DEPTH
    _DEPTH += 1
    t0 = time.time()
    m0 = _rss_kb()
    try:
        yield
    finally:
        _DEPTH = depth
        dt = time.time() - t0
        _EVENTS.append(("  " * depth + name, dt, _rss_kb() - m0))
        if _STREAM:
            import sys
            print(f"[trace] {'  ' * depth}{name}: {dt:.2f}s "
                  f"(rss {_rss_kb() // 1024} MB)", file=sys.stderr,
                  flush=True)


def report() -> str:
    lines = [f"{'phase':<48} {'wall_s':>9} {'dRSS_MB':>9}"]
    for name, dt, dm in _EVENTS:
        lines.append(f"{name:<48} {dt:>9.3f} {dm / 1024:>9.1f}")
    return "\n".join(lines)


def reset() -> None:
    _EVENTS.clear()
