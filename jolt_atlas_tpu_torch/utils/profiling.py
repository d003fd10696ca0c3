"""Spans: the program's timed phases, as records kept in memory.

Reference: common/src/utils/logging.rs (span timings via --trace-terminal).
A span is ``with span(name):``; spans nest, on the thread that proves.
While enabled (``enable()``, or JOLT_ATLAS_TRACE=1), each closed span is a
``Record``: its name, its id and its parent's, its depth, its start and
end on ``time.perf_counter_ns()``, the process's CPU time over it
(``time.process_time_ns()``: every thread's, so CPU over wall is the cores
it kept busy) and the proof it belongs to. ``proof()`` (entered by
``AtlasProver.prove``) numbers a proof, gives its spans that number and
keeps them, with the change of each telemetry counter across the proof,
among the last ``KEEP`` proofs (``proofs()``). While a torch.profiler
records, each span also opens ``record_function("jolt:" + name)``, so that
the spans sit on the device trace's clock beside the kernels and copies
they launched. Disabled, a span costs one flag test.

``events()`` and ``report()`` read the records since the last ``reset()``.
"""

from __future__ import annotations

import collections
import itertools
import os
import sys
import time
from contextlib import contextmanager
from typing import NamedTuple

import torch.autograd.profiler as _torch_profiler

_ENABLED = os.environ.get("JOLT_ATLAS_TRACE", "") not in ("", "0")
# JOLT_ATLAS_TRACE=2 additionally streams each span to stderr as it closes
# (long proves under a timeout would otherwise lose the report entirely)
_STREAM = os.environ.get("JOLT_ATLAS_TRACE", "") == "2"
KEEP = 32  # proofs kept for proofs()
ANNOTATION = "jolt:"  # the prefix of the spans' profiler annotations


class Record(NamedTuple):
    name: str
    id: int
    parent: int      # the enclosing span's id, -1 at the top
    depth: int
    start_ns: int    # time.perf_counter_ns()
    end_ns: int
    cpu_ns: int      # the process's CPU time over the span
    proof: int       # the proof's sequence number, 0 outside a proof


class Proof(NamedTuple):
    seq: int
    records: list    # its spans, in closing order
    counters: dict   # telemetry counter -> its change across the proof


_RECORDS: list[Record] = []
_OPEN: list[int] = []  # the open spans' ids, innermost last
_IDS = itertools.count()
_SEQS = itertools.count(1)
_PROOF = 0
_PROOFS: collections.deque = collections.deque(maxlen=KEEP)


def enable(on: bool = True) -> None:
    global _ENABLED
    _ENABLED = on


def enabled() -> bool:
    return _ENABLED


class span:
    """A timed span; nests."""

    __slots__ = ("name", "_open")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        if not _ENABLED:
            self._open = None
            return self
        mark = None
        if _torch_profiler._is_profiler_enabled:
            mark = _torch_profiler.record_function(ANNOTATION + self.name)
            mark.__enter__()
        sid = next(_IDS)
        parent = _OPEN[-1] if _OPEN else -1
        _OPEN.append(sid)
        self._open = (sid, parent, mark, time.process_time_ns(),
                      time.perf_counter_ns())
        return self

    def __exit__(self, *exc) -> bool:
        if self._open is None:
            return False
        t1 = time.perf_counter_ns()
        c1 = time.process_time_ns()
        sid, parent, mark, c0, t0 = self._open
        _OPEN.pop()
        rec = Record(self.name, sid, parent, len(_OPEN), t0, t1, c1 - c0,
                     _PROOF)
        _RECORDS.append(rec)
        if mark is not None:
            mark.__exit__(None, None, None)
        if _STREAM:
            print(f"[trace] {'  ' * rec.depth}{self.name}: "
                  f"{(t1 - t0) * 1e-9:.2f}s ({(c1 - c0) * 1e-9:.2f} cpu s)",
                  file=sys.stderr, flush=True)
        return False


@contextmanager
def proof():
    """One proof: its spans share a new sequence number, and on a normal
    exit its records and the telemetry counters' changes join
    ``proofs()``. Inside another proof it adds nothing."""
    global _PROOF
    if not _ENABLED or _PROOF:
        yield
        return
    from ..device import telemetry
    _PROOF = seq = next(_SEQS)
    start = len(_RECORDS)
    before = telemetry.counters()
    try:
        yield
    finally:
        _PROOF = 0
    after = telemetry.counters()
    _PROOFS.append(Proof(
        seq, [r for r in _RECORDS[min(start, len(_RECORDS)):]
              if r.proof == seq],
        {k: v - before.get(k, 0) for k, v in after.items()
         if v != before.get(k, 0)}))


def proofs() -> list[Proof]:
    """The last ``KEEP`` proofs made while enabled, oldest first."""
    return list(_PROOFS)


def events() -> list[tuple[str, float, float]]:
    """The closed spans since the last reset(), in closing order: (name
    indented two spaces a nesting level, wall seconds, CPU seconds)."""
    return [("  " * r.depth + r.name, (r.end_ns - r.start_ns) * 1e-9,
             r.cpu_ns * 1e-9) for r in _RECORDS]


def key(name: str) -> str:
    """A span's name in a path: a node's span by its operator
    ("node[12] Einsum" -> "Einsum"), any other as it is."""
    if name.startswith("node["):
        return name.split("] ", 1)[-1]
    return name


def tree(recs: list[Record]) -> list[tuple]:
    """``recs`` by path (the keys from the outermost span down), each path
    after its parent and siblings in the order they first opened: (path,
    calls, wall ns, self ns, CPU ns), self being the wall time outside the
    span's children."""
    by_id = {r.id: r for r in recs}
    paths: dict[int, tuple] = {}

    def path(r: Record) -> tuple:
        p = paths.get(r.id)
        if p is None:
            up = by_id.get(r.parent)
            p = paths[r.id] = ((path(up) if up is not None else ())
                               + (key(r.name),))
        return p

    rows: dict[tuple, list] = {}
    for r in sorted(recs, key=lambda r: r.start_ns):
        row = rows.setdefault(path(r), [0, 0, 0, 0])
        wall = r.end_ns - r.start_ns
        row[0] += 1
        row[1] += wall
        row[2] += wall
        row[3] += r.cpu_ns
        up = by_id.get(r.parent)
        if up is not None:
            rows[path(up)][2] -= wall
    rank = {p: i for i, p in enumerate(rows)}
    order = sorted(rows, key=lambda p: [rank[p[:i + 1]]
                                        for i in range(len(p))])
    return [(p, *rows[p]) for p in order]


def report() -> str:
    """The records since the last reset() as a tree by path, node spans
    by operator: calls, wall, self and CPU seconds, and cores (CPU over
    wall)."""
    lines = [f"{'span':<52} {'calls':>6} {'wall_s':>9} {'self_s':>9} "
             f"{'cpu_s':>9} {'cores':>6}"]
    for p, calls, wall, own, cpu in tree(_RECORDS):
        name = "  " * (len(p) - 1) + p[-1]
        lines.append(f"{name:<52} {calls:>6} {wall * 1e-9:>9.3f} "
                     f"{own * 1e-9:>9.3f} {cpu * 1e-9:>9.3f} "
                     f"{cpu / wall if wall else 0.0:>6.2f}")
    return "\n".join(lines)


def reset() -> None:
    """Forget the records since the last reset (not the kept proofs)."""
    _RECORDS.clear()
