"""The traced window: torch.profiler over it, and its reduction.

The harness marks the window, every top-level phase of a proof and every
call into the device MSM engine with ``record_function`` from its own
files (``MARK_WINDOW``, ``MARK_SPAN + name``, ``MARK_MSM``). The reduction
reads the profiler's Chrome trace:

- ``busy_s``: the union of every device operation's interval (kernels,
  copies, sets) inside the window;
- ``msm_device_s``: the device time of every operation launched while a
  call into the MSM engine was open on the host, and the points each such
  call was handed;
- ``device_ops``: device seconds by operation name;
- ``idle``: the window's idle seconds by what the host was doing then,
  the phase open at the gap's middle ("iop/Einsum": the operator whose
  node the IOP was proving).
"""

from __future__ import annotations

import bisect
import contextlib
import json

import torch

MARK_WINDOW = "atlas_bench.window"
MARK_SPAN = "atlas_bench.span:"
MARK_MSM = "atlas_bench.msm"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
OUTSIDE = "between proofs"


@contextlib.contextmanager
def profiled(path: str):
    """torch.profiler over the block, its Chrome trace written to
    ``path`` when the block ends."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(path)


def _merge(intervals: list[tuple[float, float]]) -> list[list[float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class _Disjoint:
    """Host intervals that do not overlap, for lookups by time."""

    def __init__(self, events: list[dict]):
        self.items = sorted((e["ts"], e["ts"] + e["dur"], e["name"])
                            for e in events)
        self.starts = [a for a, _, _ in self.items]

    def at(self, t: float) -> str | None:
        """The name of the interval that holds t, or None."""
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and t < self.items[i][1]:
            return self.items[i][2]
        return None


def _phase(phases: _Disjoint, nodes: _Disjoint, t: float) -> str:
    top = phases.at(t)
    if top is None:
        return OUTSIDE
    top = top[len(MARK_SPAN):]
    node = nodes.at(t)
    if node is not None:
        return f"{top}/{node.split('] ', 1)[-1]}"
    return top


def reduce(path: str, msm_points: list[int]) -> dict:
    """The numbers of the trace at ``path``. ``msm_points``: the points
    handed to each MSM engine call, in call order (kept beside the
    trace's marks, which carry no arguments)."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    window = [e for e in events if e.get("name") == MARK_WINDOW
              and e.get("cat") == "user_annotation"]
    if not window:
        raise RuntimeError("the trace holds no window mark")
    w0 = window[0]["ts"]
    w1 = w0 + window[0]["dur"]
    annotations = [e for e in events if e.get("cat") == "user_annotation"]
    spans = [e for e in annotations if e["name"].startswith(MARK_SPAN)]
    nodes = _Disjoint([e for e in spans
                       if e["name"].startswith(MARK_SPAN + "node[")])
    phases = _Disjoint([e for e in spans
                        if not e["name"].startswith(MARK_SPAN + "node[")])
    msm = _Disjoint([e for e in annotations if e["name"] == MARK_MSM])
    launches = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in LAUNCH_CATS
                and "correlation" in e.get("args", {})}
    device = [e for e in events if e.get("cat") in DEVICE_CATS
              and w0 <= e["ts"] < w1]

    ops: dict[str, float] = {}
    msm_us = 0.0
    for e in device:
        ops[e["name"]] = ops.get(e["name"], 0.0) + e["dur"]
        launched = launches.get(e.get("args", {}).get("correlation"))
        if launched is not None and msm.at(launched) is not None:
            msm_us += e["dur"]

    busy = _merge([(e["ts"], min(e["ts"] + e["dur"], w1)) for e in device])
    idle: dict[str, float] = {}
    edge = w0
    for a, b in busy + [[w1, w1]]:
        if a > edge:
            name = _phase(phases, nodes, (a + edge) / 2)
            idle[name] = idle.get(name, 0.0) + (a - edge)
        edge = max(edge, b)

    def top(d: dict) -> list:
        return [[k, v * 1e-6] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:10]]

    return {"window_s": (w1 - w0) * 1e-6,
            "busy_s": sum(b - a for a, b in busy) * 1e-6,
            "msm_device_s": msm_us * 1e-6,
            "msm_calls": len(msm.items),
            "msm_points": list(msm_points),
            "device_ops": top(ops),
            "idle": top(idle)}
