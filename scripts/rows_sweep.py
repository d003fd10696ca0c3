"""Where the IOP rows engine pays, on one GPU, and the IOP's census.

    python3 scripts/rows_sweep.py        # from the repo root

Proves the bench nanoGPT (4 blocks, 4 heads, d64, seq 64, vocab 65, random
weights from seed 1234) once on the host path, keeping every Gruen rows
instance its IOP sets up (chip_smoke.capture_rows), then, each instance's
rounds run alone with every round message and final row value held equal
between the engine and the host GruenInstance:

- census: the instances by class (P rows, degree, terms, most factors):
  count, sizes, how many the default gate takes, and the host's ms for all
  rounds and for the first two, beside the IOP span of the host-path
  prove;
- floor: the engine (forced, 2 head rounds) against the host at each row
  length n, engine, host, host, engine: where the card stops losing
  (device/rows.py:MIN_N);
- gates: every instance under each of seven gates (the host alone; 2
  head rounds from 256 elements, the reference's, and from 2,048; every
  round down to the floor, at floors of 256, 2,048 and 4,096 elements;
  the default, device/rows.py:RowsGate(), which also declines instances
  of little work; an instance a gate declines runs on the host), six
  passes each in turns, forward then backward: the median and quartiles
  that place the default gate.

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


def sums(runs: list, key: str = "ms") -> list:
    """The total of ``key`` over the instances of each pass."""
    return [sum(r[key] for r in ps) for ps in runs]


def sweep(dev, dims=(65, 64, 64, 4, 4)) -> dict:
    """The report (see the module docstring) for the nanoGPT of ``dims``
    (vocab, seq, d, blocks, heads) with the engine on ``dev``."""
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from jolt_atlas_tpu_torch import models
    from jolt_atlas_tpu_torch.device import rows as drows
    from jolt_atlas_tpu_torch.preprocessing import AtlasPreprocessing
    from jolt_atlas_tpu_torch.prover import AtlasProver
    from jolt_atlas_tpu_torch.utils import profiling
    vocab, seq, dim, blocks, heads = dims
    rng = np.random.default_rng(1234)
    model = models.build_nanogpt(vocab, seq, dim, blocks, 8, rng,
                                 heads=heads)
    toks = rng.integers(0, vocab, size=seq).astype(np.int32)
    pp = AtlasPreprocessing.preprocess(model)
    AtlasProver(pp, device="cpu").prove([toks])  # warm-up
    cap: list = []
    profiling.enable()
    profiling.reset()
    t0 = time.perf_counter()
    with cs.capture_rows(cap):
        AtlasProver(pp, device="cpu").prove([toks])
    report = {"host_prove_s": time.perf_counter() - t0,
              "host_iop_s": next(w for name, w, _ in profiling.events()
                                 if name == "iop")}
    default = drows.RowsGate()

    # -- census: every instance on the host, two passes
    host = [[cs.rows_run(i) for i in cap] for _ in range(2)]
    census = {}
    for k, inst in enumerate(cap):
        row = census.setdefault(str(cs.rows_class(inst)), {
            "count": 0, "n": [], "eligible": 0, "host_ms": 0.0,
            "host_first2_ms": 0.0})
        row["count"] += 1
        row["eligible"] += cs.rows_eligible(inst, default)
        if cs.rows_n(inst) not in row["n"]:
            row["n"].append(cs.rows_n(inst))
        row["host_ms"] += sum(p[k]["ms"] for p in host) / 2
        row["host_first2_ms"] += sum(p[k]["head_ms"] for p in host) / 2
    report["census"] = {"instances": len(cap), "host_ms": sums(host),
                        "host_first2_ms": sums(host, "head_ms"),
                        "by_class": census}

    # -- floor: the engine (2 head rounds) against the host at each n
    floor = {}
    for n in sorted({cs.rows_n(i) for i in cap}):
        insts = [i for i in cap if cs.rows_n(i) == n
                 and len(i["rows"]) <= drows.MAX_P and n >= 2]
        if not insts:
            continue
        runs = cs.rows_passes(insts, dev, drows.forced(min_n=2))
        floor[n] = {"instances": len(insts),
                    "classes": sorted({str(cs.rows_class(i))
                                       for i in insts}),
                    "engine_ms": sums(runs["engine"]),
                    "host_ms": sums(runs["host"]),
                    "host_first2_ms": sums(runs["host"], "head_ms")}
    report["floor"] = floor

    # -- gates: the whole population under each gate (an instance the gate
    # declines runs on the host), against the host alone, in turns
    def down_to(floor):
        """Every round whose rows hold at least ``floor`` elements."""
        return lambda n: drows.RowsGate(
            n.bit_length() - floor.bit_length() + 1, floor, min_work=0)

    gates = {"host": None, "2 rounds, n >= 256": lambda n: drows.RowsGate(
        2, 256, min_work=0), "2 rounds, n >= 2048": lambda n: drows.RowsGate(
        2, 2048, min_work=0), "down to 256, n >= 256": down_to(256),
        "down to 2048, n >= 2048": down_to(2048),
        "down to 4096, n >= 4096": down_to(4096),
        "default": lambda n: default}
    order = (list(gates) + list(gates)[::-1]) * 3
    passes = {name: [] for name in gates}
    for name in order:
        g = gates[name]
        passes[name].append([cs.rows_run(i, dev, g(cs.rows_n(i))) if g
                             else cs.rows_run(i) for i in cap])
    want = [(r["msgs"], r["finals"]) for r in passes["host"][0]]
    variants = {}
    for name, ps_list in passes.items():
        for ps in ps_list:
            if [(r["msgs"], r["finals"]) for r in ps] != want:
                raise AssertionError(f"gate {name!r} differs from the host")
        ms = sums(ps_list)
        variants[name] = {
            "engaged": sum(r["engaged"] for r in ps_list[0]),
            "ms": ms, "median_ms": float(np.median(ms)),
            "quartiles_ms": [float(q) for q in np.percentile(ms, [25, 75])],
            **{s: [sum(r["steps"].get(s, 0.0) for r in ps)
                   for ps in ps_list] for s in cs.ROWS_STEPS}}
    report["gates"] = variants
    return report


def main() -> int:
    if not torch.cuda.is_available():
        print("rows_sweep: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    print(cs.card_line(), flush=True)
    print(json.dumps(sweep(torch.device("cuda"))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
