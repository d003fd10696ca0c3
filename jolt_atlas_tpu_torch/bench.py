"""The port's benchmark entry: prints ONE JSON line with the headline metric.

Counterpart of the repo's bench.py, which drives the reference and stays
its own. The workload is the same: the nanoGPT-class LM of the reference
benchmark model's shape (4 blocks, 4 heads, d64, seq 64, vocab 65, scale
2^8), its weights and tokens drawn from default_rng(1234) as bench.py
draws them, built by models.build_nanogpt; BENCH_SMALL=1 gives bench.py's
smoke shape (1 block, 1 head, d16, seq 8, vocab 32).

    python -m jolt_atlas_tpu_torch.bench [--device cpu]

It proves on the card unless ``--device cpu`` asks for the host path, and
raises when there is no card and no ``--device cpu``. The line has
bench.py's keys: ``metric``, ``value`` (the least wall seconds of 3 proves,
1 at BENCH_SMALL, each ended by a synchronize on the card), ``unit``,
``vs_baseline`` (the Rust reference's published 2.288 s on an M3 over
``value``), ``setup_s`` (AtlasPreprocessing.preprocess), ``verify_s``,
``proof_bytes``, ``phases`` (the fastest prove's top-level spans) and
``device`` (its telemetry: dispatches, decisions, kernel launches); at the
full shape ``msm_pts_per_s``, a 2^18-point MSM of random 254-bit scalars
on the engine the prover uses (the device MSM on the card, the host csrc
MSM on the CPU). Beside them: ``bases_s``, the prover's gate and the
bases' upload to the card (set-up, outside every timed prove), and
``card``, the card's name and power limit as nvidia-smi gives them (null
on the host). Every other line the prove prints goes to stderr.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

NANOGPT_BASELINE_S = 2.288
MSM_POINTS = 1 << 18


def card() -> str | None:
    """nvidia-smi's name and power limit of the card, or None."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            check=True, capture_output=True, text=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return None


def msm_pts_per_s(srs, device: torch.device, n: int = MSM_POINTS) -> float:
    """Points a second of one n-point MSM of random 254-bit scalars over
    ``srs``'s bases on the prover's engine: the device MSM (forced, after
    a warm-up call at this size) on the card, the host csrc MSM on the
    CPU."""
    from .curve.native import pack_scalars
    from .device import gate
    from .field.constants import FR_MODULUS
    rng = np.random.default_rng(7)
    packed = pack_scalars([int.from_bytes(rng.bytes(32), "little")
                           % FR_MODULUS for _ in range(n)])
    if device.type == "cuda":
        engine = srs.device_bases(device, gate.forced("device"))
        engine.msm_packed(packed, n)
        torch.cuda.synchronize(device)
    else:
        engine = srs.prepared_bases()
    t0 = time.perf_counter()
    engine.msm_packed(packed, n)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return n / (time.perf_counter() - t0)


def run(device_name: str, small: bool) -> dict:
    """Build, preprocess, prove (the least of 3, or 1 when ``small``),
    verify and serialise the bench workload on ``device_name``; the JSON
    line's fields."""
    from . import models
    from .device import telemetry
    from .examples.nanogpt_style import check_device
    from .preprocessing import AtlasPreprocessing
    from .prover import AtlasProver
    from .serde import serialize_proof
    from .utils import profiling
    from .verifier import AtlasVerifier

    device = check_device(device_name)
    vocab, seq, dim, blocks, heads = ((32, 8, 16, 1, 1) if small
                                      else (65, 64, 64, 4, 4))
    rng = np.random.default_rng(1234)
    model = models.build_nanogpt(vocab, seq, dim, blocks, 8, rng,
                                 heads=heads)
    toks = rng.integers(0, vocab, size=seq).astype(np.int32)

    t0 = time.time()
    pp = AtlasPreprocessing.preprocess(model)
    setup_s = time.time() - t0
    t0 = time.time()
    prover = AtlasProver(pp, device=device)
    if prover.uses_msm_engine and device.type == "cuda":
        pp.srs.device_bases(device, prover.msm_gate, c=prover.msm_window)
        torch.cuda.synchronize(device)
    bases_s = time.time() - t0

    prove_s, phases, tele = float("inf"), {}, {}
    was = profiling.enabled()
    for _ in range(1 if small else 3):
        profiling.enable()
        profiling.reset()
        telemetry.reset()
        t0 = time.time()
        proof, io = prover.prove([toks])
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.time() - t0
        if dt < prove_s:
            prove_s, tele = dt, telemetry.snapshot()
            phases = {name: wall for name, wall, _ in profiling.events()
                      if not name.startswith(" ")}  # top-level spans only
    profiling.enable(was)
    t0 = time.time()
    ok = AtlasVerifier(pp).verify(proof, io)
    verify_s = time.time() - t0
    assert ok, "bench proof failed verification"

    out = {
        "metric": ("nanogpt_smoke_prove_wall_s" if small
                   else "nanogpt_4l_d64_s64_prove_wall_s"),
        "value": prove_s,
        "unit": "s",
        "vs_baseline": NANOGPT_BASELINE_S / prove_s,
        "setup_s": setup_s,
        "bases_s": bases_s,
        "verify_s": verify_s,
        "proof_bytes": len(serialize_proof(proof)),
        "phases": phases,
    }
    if not small:
        out["msm_pts_per_s"] = msm_pts_per_s(pp.srs, device)
    out["device"] = tele
    out["card"] = card() if device.type == "cuda" else None
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default: the card) or cpu (the host "
                         "path)")
    args = ap.parse_args(argv)
    small = os.environ.get("BENCH_SMALL", "") not in ("", "0")
    with contextlib.redirect_stdout(sys.stderr):
        out = run(args.device, small)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
