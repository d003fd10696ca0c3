"""Where the opening reduction's engine pays, on one GPU.

    python3 scripts/reduction_sweep.py        # from the repo root

Proves the bench nanoGPT (4 blocks, 4 heads, d64, seq 64, vocab 65, random
weights from seed 1234) once on the host path, keeping what its opening
reduction starts from, then:

- uploads the instances' rows (the engine's init buffer) three ways, in
  turns: pageable copies (device/reduction.py:upload_rows, the engine's
  way), one pinned staging buffer, and the rows' own pages registered with
  cudaHostRegister; the three buffers must be equal;
- runs the engine (forced onto the card) and the host BatchedSumcheck on
  the instances of at most 10, 13, 14 and 16 rounds and on all of them,
  engine, host, host, engine at each size, with equal messages,
  challenges, transcript state and final claims: the crossover that
  places the engine's size floor (device/reduction.py:SIZE_FLOOR).

Prints the card's name and power limit (nvidia-smi), then one JSON line.
Exits non-zero without a CUDA device. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def upload_modes(dev, rows, reps: int = 2) -> dict:
    """Milliseconds of each upload of ``rows`` ((n, 4) u64 arrays), ``reps``
    times a mode, in turns, and the gigabytes moved."""
    from jolt_atlas_tpu_torch.device import reduction as dred
    total = sum(len(d) for d in rows)
    cudart = torch.cuda.cudart()

    def staged():
        host = torch.empty((total, 4), dtype=torch.int64, pin_memory=True)
        o = 0
        for d in rows:
            host.numpy()[o:o + len(d)] = d.view(np.int64)
            o += len(d)
        return host.to(dev, non_blocking=True)

    def registered():
        init = torch.empty((total, 4), dtype=torch.int64, device=dev)
        o = 0
        for d in rows:
            cudart.cudaHostRegister(d.ctypes.data, d.nbytes, 0)
            init[o:o + len(d)].copy_(torch.from_numpy(d.view(np.int64)),
                                     non_blocking=True)
            o += len(d)
        torch.cuda.synchronize()
        for d in rows:
            cudart.cudaHostUnregister(d.ctypes.data)
        return init

    modes = {"pageable": lambda: dred.upload_rows(rows, dev),
             "pinned_staging": staged, "registered": registered}
    out = {k: [] for k in modes}
    want = None
    for _ in range(reps):
        for name, fn in modes.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = fn()
            torch.cuda.synchronize()
            out[name].append((time.perf_counter() - t0) * 1e3)
            if want is None:
                want = got
            elif not torch.equal(got, want):
                raise AssertionError(f"rows uploaded by {name} differ")
            del got
    out["GB"] = total * 32 / 1e9
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("reduction_sweep: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from jolt_atlas_tpu_torch import models
    from jolt_atlas_tpu_torch.preprocessing import AtlasPreprocessing
    from jolt_atlas_tpu_torch.prover import AtlasProver
    dev = torch.device("cuda")
    print(cs.card_line(), flush=True)
    rng = np.random.default_rng(1234)
    model = models.build_nanogpt(65, 64, 64, 4, 8, rng, heads=4)
    toks = rng.integers(0, 65, size=64).astype(np.int32)
    pp = AtlasPreprocessing.preprocess(model)
    cap: dict = {}
    with cs.capture_reduction(cap):
        AtlasProver(pp, device="cpu").prove([toks])
    insts, _ = cs.reduction_instances(cap)
    nrs = [i.num_rounds() for i in insts]
    report = {"rows_upload_ms": upload_modes(
        dev, [i.rlc_fvec.d for i in insts])}
    del insts
    for top in (10, 13, 14, 16, None):
        runs = {"engine": [], "host": []}
        for which in ("engine", "host", "host", "engine"):
            runs[which].append(cs._reduction_run(cap, dev, which == "engine",
                                                 top))
        first = runs["host"][0][1:5]
        if any(got[1:5] != first for rs in runs.values() for got in rs):
            raise AssertionError(f"reduction (instances of <= {top} rounds)"
                                 " differs between the engine and the host")
        sub = [n for n in nrs if top is None or n <= top]
        report["all" if top is None else f"nr<={top}"] = {
            "instances": len(sub), "elements": sum(1 << n for n in sub),
            "engine_ms": [g[0] for g in runs["engine"]],
            "host_ms": [g[0] for g in runs["host"]]}
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
