"""The program's own spans and counters over the traced window, and the
device trace split by the program's spans.

``window(r)`` gives the per-layer readers what the program recorded of the
window's proofs (utils/profiling.py in the port: each proof's span records
and the change of each telemetry counter across it), as means a proof:

- ``spans``: path -> [wall s, CPU s, calls], a path being the span names
  from the outermost down joined by "/", a node's span by its operator
  ("iop/Einsum/sumcheck:EinsumContractionProver");
- ``counters``: counter -> its change a proof.

It takes them from the reading where the harness has put them there, and
otherwise from the program's last ``r["proofs"]`` proofs, the window's
(the program records none after the window). It is None where the program
keeps no such records.

``by_span(path)`` splits a traced window's Chrome trace by the program's
spans, which the program marks on the trace while a profiler records
(``jolt:<name>`` annotations): device seconds by the span open at each
operation's launch, idle seconds by the span open at each gap's middle.
"""

from __future__ import annotations

import bisect
import json

from atlas_bench import trace

ANNOTATION = "jolt:"
NO_SPAN = "no span"  # outside every program span: between proofs, or not
                     # in a span inside one


def key(name: str) -> str:
    """A span's name in a path: a node's span by its operator."""
    if name.startswith("node["):
        return name.split("] ", 1)[-1]
    return name


def _paths(records: list) -> dict:
    """id -> path of each record (each with .name, .id, .parent)."""
    by_id = {r.id: r for r in records}
    out: dict = {}

    def path(r) -> str:
        p = out.get(r.id)
        if p is None:
            up = by_id.get(r.parent)
            p = key(r.name) if up is None else f"{path(up)}/{key(r.name)}"
            out[r.id] = p
        return p

    for r in records:
        path(r)
    return out


def from_program(n: int) -> dict | None:
    """``spans`` and ``counters`` of the program's last ``n`` proofs, means
    a proof; None where the program keeps no proofs."""
    try:
        from jolt_atlas_tpu_torch.utils import profiling
    except ImportError:
        return None
    kept = getattr(profiling, "proofs", None)
    proofs = kept()[-n:] if kept is not None and n else []
    if not proofs:
        return None
    spans: dict = {}
    counters: dict = {}
    for p in proofs:
        paths = _paths(p.records)
        for r in p.records:
            row = spans.setdefault(paths[r.id], [0.0, 0.0, 0])
            row[0] += (r.end_ns - r.start_ns) * 1e-9
            row[1] += r.cpu_ns * 1e-9
            row[2] += 1
        for k, v in p.counters.items():
            counters[k] = counters.get(k, 0) + v
    m = len(proofs)
    return {"spans": {k: [wall / m, cpu / m, calls / m]
                      for k, (wall, cpu, calls) in spans.items()},
            "counters": {k: v / m for k, v in counters.items()}}


def window(r: dict) -> dict | None:
    """{"spans", "counters"} of the window's proofs (see the module), or
    None."""
    if "spans" in r and "counters" in r:
        return {"spans": r["spans"], "counters": r["counters"]}
    return from_program(r.get("proofs") or 0)


def seconds(w: dict | None, top: str, prefix: str) -> float | None:
    """Wall seconds a proof of the spans under ``top`` named ``prefix``...
    and under no other such span; None where there is none."""
    if w is None:
        return None
    total, found = 0.0, False
    for path, (wall, _, _) in w["spans"].items():
        parts = path.split("/")
        if parts[0] != top or len(parts) < 2:
            continue
        hits = [i for i, p in enumerate(parts[1:]) if p.startswith(prefix)]
        if hits and hits[0] == len(parts) - 2:
            total += wall
            found = True
    return total if found else None


def by_span(path: str) -> dict:
    """The Chrome trace at ``path`` split by the program's spans:
    ``device_by_span`` (device seconds by the path of the spans open at
    each operation's launch) and ``idle_by_span`` (the window's idle
    seconds by the path of the spans open at the gap's middle), each path
    as ``window`` names it, ``NO_SPAN`` where none is open; the largest
    first."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    marks = [e for e in events if e.get("cat") == "user_annotation"]
    win = [e for e in marks if e["name"] == trace.MARK_WINDOW]
    if not win:
        raise RuntimeError("the trace holds no window mark")
    w0, w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    spans = _Nested([e for e in marks if e["name"].startswith(ANNOTATION)])
    launches = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in trace.LAUNCH_CATS
                and "correlation" in e.get("args", {})}
    device = [e for e in events if e.get("cat") in trace.DEVICE_CATS
              and w0 <= e["ts"] < w1]
    dev: dict = {}
    for e in device:
        t = launches.get(e.get("args", {}).get("correlation"))
        name = spans.at(t) if t is not None else None
        name = NO_SPAN if name is None else name
        dev[name] = dev.get(name, 0.0) + e["dur"] * 1e-6
    busy = trace._merge([(e["ts"], min(e["ts"] + e["dur"], w1))
                         for e in device])
    idle: dict = {}
    edge = w0
    for a, b in busy + [[w1, w1]]:
        if a > edge:
            name = spans.at((a + edge) / 2) or NO_SPAN
            idle[name] = idle.get(name, 0.0) + (a - edge) * 1e-6
        edge = max(edge, b)

    def ranked(d: dict) -> dict:
        return dict(sorted(d.items(), key=lambda kv: -kv[1]))

    return {"device_by_span": ranked(dev), "idle_by_span": ranked(idle)}


class _Nested:
    """Host intervals that nest (the program's spans on one thread), for
    the path of the innermost one open at a time."""

    def __init__(self, events: list[dict]):
        items = sorted(((e["ts"], -e["dur"], e["ts"] + e["dur"],
                         key(e["name"][len(ANNOTATION):])) for e in events))
        self.starts = [a for a, _, _, _ in items]
        self.ends = [b for _, _, b, _ in items]
        self.parent: list[int] = []
        self.path: list[str] = []
        stack: list[int] = []
        for i, (a, _, b, name) in enumerate(items):
            while stack and self.ends[stack[-1]] <= a:
                stack.pop()
            up = stack[-1] if stack else -1
            self.parent.append(up)
            self.path.append(name if up < 0 else f"{self.path[up]}/{name}")
            stack.append(i)

    def at(self, t: float) -> str | None:
        """The path of the innermost interval that holds t, or None."""
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and not t < self.ends[i]:
            i = self.parent[i]
        return self.path[i] if i >= 0 else None
