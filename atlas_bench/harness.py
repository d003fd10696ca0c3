"""One run of one cell: set-up, the window of proofs back to back, the
check against the reference, the metrics.

Set-up (timed as ``setup_s``, from the process's start): the port's
import, the seed's weights and the model (the configuration's builder),
``AtlasPreprocessing`` under the mix's commitment, ``AtlasProver`` with
its default gates and host threads, the bases' upload to the card and
the mix's warm-up proofs, each verified by the program's verifier. The
window: proofs in a closed loop, one client, each on fresh tokens and
ended by a synchronize, then serialised (the proof object is dropped, as
a service sends its bytes on); a proof starts only while the window's
time is not up, and the one in flight at the end completes and counts. Each proof's top-level phases (the program's
``utils/profiling`` spans, on in every run) go to standard error. Then
the program's verifier times the client's side (``verify_s``, reported
where BENCHMARK.json lists it for the cell), the program's state is
freed, and the reference judges every proof (``correct.py``).

With ``traced`` the window runs under torch.profiler (``trace.py``): the
harness marks each top-level phase of a proof (the program's
``utils/profiling`` spans) and each call into the device MSM engine, and
the per-layer metrics (``metrics/``) read those marks, the spans and the
work counts (``work.py``).
"""

from __future__ import annotations

import contextlib
import gc
import os
import sys
import tempfile
import time
import traceback

import torch

from . import cells, correct, inputs, trace, traffic, work

def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def marks(msm_points: list):
    """Mark the program's top-level phases and its device MSM engine's
    entry calls for the profiler; each engine call's point counts go to
    ``msm_points``."""
    from jolt_atlas_tpu_torch import prover as port_prover
    from jolt_atlas_tpu_torch.device import msm as port_msm
    rf = torch.profiler.record_function
    span, start, finish = (port_prover.span, port_msm.DeviceBases.start,
                           port_msm.DeviceBases.finish)

    @contextlib.contextmanager
    def marked_span(name):
        with span(name), rf(trace.MARK_SPAN + name):
            yield

    def marked_start(self, packed, counts, *args, **kwargs):
        msm_points.extend(counts)
        with rf(trace.MARK_MSM):
            return start(self, packed, counts, *args, **kwargs)

    def marked_finish(self, handle):
        with rf(trace.MARK_MSM):
            return finish(self, handle)

    port_prover.span = marked_span
    port_msm.DeviceBases.start = marked_start
    port_msm.DeviceBases.finish = marked_finish
    try:
        yield
    finally:
        port_prover.span = span
        port_msm.DeviceBases.start = start
        port_msm.DeviceBases.finish = finish


def _phases(events) -> dict:
    """The top-level spans of one proof: name -> seconds."""
    return {n: w for n, w, _ in events if not n.startswith(" ")}


def run(cell: cells.Cell, seed: int, seconds: float, traced: bool,
        device: torch.device, t0: float) -> dict:
    """One run; the result line's fields (``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device``, on a traced run ``breakdown``,
    and ``checks`` last)."""
    from jolt_atlas_tpu_torch import serde, transcripts
    from jolt_atlas_tpu_torch.frontend.builder import ModelBuilder
    from jolt_atlas_tpu_torch.preprocessing import AtlasPreprocessing
    from jolt_atlas_tpu_torch.prover import AtlasProver
    from jolt_atlas_tpu_torch.utils import profiling
    from jolt_atlas_tpu_torch.verifier import AtlasVerifier

    cfg, mix, builder = cell.config, cell.traffic, cell.builder
    requests = traffic.Requests(mix, *builder.request(cfg), seed)
    factory = getattr(transcripts,
                      f"{mix['transcript'].capitalize()}Transcript")
    weights = builder.weights(cfg, inputs.normals(
        builder.weight_shapes(cfg), seed, device))
    model = builder.build(ModelBuilder, cfg, weights)
    pp = AtlasPreprocessing.preprocess(model, pcs=mix["pcs"])
    prover = AtlasProver(pp, transcript_factory=factory, device=device)
    prove = getattr(prover, mix["entry"])
    if prover.uses_msm_engine and device.type == "cuda":
        pp.srs.device_bases(device, prover.msm_gate, c=prover.msm_window)
    verifier = AtlasVerifier(pp, factory)
    verify = getattr(verifier, traffic.verify_entry(mix))
    attempted = failed = 0

    def verified(blob: bytes, io) -> bool:
        if verify(serde.deserialize_proof(blob), io):
            return True
        print(f"the program's verifier rejected a proof: "
              f"{getattr(verifier, 'last_error', None)!r}", file=sys.stderr)
        return False

    profiling.enable()
    for _ in range(int(mix["warmup_proofs"])):
        proof, io = prove([requests.warmup()])
        failed += not verified(serde.serialize_proof(proof), io)
    _sync(device)
    setup_s = time.time() - t0
    print(f"set-up {setup_s:.3f} s", file=sys.stderr)

    served, times, phases, msm_points = [], [], [], []
    trace_path = None
    with contextlib.ExitStack() as stack:
        if traced:
            fd, trace_path = tempfile.mkstemp(suffix=".json")
            os.close(fd)
            stack.enter_context(trace.profiled(trace_path))
            stack.enter_context(marks(msm_points))
            stack.enter_context(torch.profiler.record_function(
                trace.MARK_WINDOW))
        w0 = time.perf_counter()
        while time.perf_counter() - w0 < seconds:
            toks = requests.next()
            attempted += 1
            profiling.reset()
            t = time.perf_counter()
            try:
                proof, io = prove([toks])
                _sync(device)
            except Exception:  # a request that is not proved fails
                traceback.print_exc()
                failed += 1
                continue
            times.append(time.perf_counter() - t)
            # the service sends the proof's bytes on and keeps nothing
            served.append((toks, io, serde.serialize_proof(proof)))
            del proof
            phases.append(_phases(profiling.events()))
            print(f"proof {len(times)}: {times[-1]:.3f} s " + " ".join(
                f"{n}={v:.3f}" for n, v in phases[-1].items()),
                file=sys.stderr)
        window_s = time.perf_counter() - w0
    profiling.enable(False)
    peak_bytes = (torch.cuda.max_memory_allocated(device)
                  if device.type == "cuda" else 0)

    verify_times = []
    for _, io, blob in served:
        t = time.perf_counter()
        failed += not verified(blob, io)
        verify_times.append(time.perf_counter() - t)
    print("verify s: " + " ".join(f"{v:.3f}" for v in verify_times),
          file=sys.stderr)
    del verifier, verify, verified, prover, prove, pp, model
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    checks, shapes = correct.judge(cell, weights, served)
    ok = bool(served) and failed == 0 and correct.within(checks)
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": kind, "count": 1, "memory_peak_bytes": int(peak_bytes)}
    prove_s = sum(times) / len(times) if times else None
    out = {"correct": ok, "attempted": attempted, "failed": failed}
    if not traced:
        values = {"prove_s": prove_s,
                  "verify_s": (sum(verify_times) / len(verify_times)
                               if verify_times else None),
                  "setup_s": setup_s}
        wanted = cell.end_to_end
    else:
        reduced = trace.reduce(trace_path, msm_points)
        os.remove(trace_path)
        dev["busy_s"] = reduced["busy_s"]
        dev["window_s"] = reduced["window_s"]
        names = {n for p in phases for n in p}
        reading = {
            "proofs": len(times), "prove_s": prove_s,
            "phases": {n: sum(p.get(n, 0.0) for p in phases) / len(phases)
                       for n in names} if phases else {},
            "trace": reduced,
            "imads_per_proof": work.proof_imads(shapes) if shapes else None,
            "peak": work.peak(kind)}
        values = {m["name"]: cells.reader(m["name"])(reading)
                  for m in cell.per_layer}
        wanted = cell.per_layer
        out["breakdown"] = {"device_ops": reduced["device_ops"],
                            "idle_gaps": reduced["idle"]}
    out["metrics"] = {m["name"]: {"value": values[m["name"]],
                                  "unit": m["unit"]}
                      for m in wanted if values.get(m["name"]) is not None}
    out["device"] = dev
    out["window_s"] = window_s
    out["checks"] = {k: {"value": v, "limit": correct.LIMITS[k]}
                     for k, v in checks.items()}
    return out
