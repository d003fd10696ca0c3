"""The read-check engine (device/onehot.py) against the host path on one
GPU, a batch of each class the benchmark's nanoGPT cell proves.

    python3 scripts/rachecks_bench.py [--passes 5] [--seed 1234]
                                      [--out chiprun_out/rachecks_bench.json]

Builds the cell's model (atlas_bench's nanogpt-4l-d64, weights from
``--seed``) and proves it once on the host path, recording the inputs of
every read-check batch (a BatchedSumcheck of one Booleanity and its
AddressReadChecks; the batches that hold other instances too, Rsqrt's,
stay on the host path and are left out). A class is (D chunk rows, T
cycles); the first batch of each is kept. Then, for each class, in turns
host, card, card, host, each turn ``--passes`` proofs of the batch from
fresh instances and a fresh transcript: wall ms on the host clock, each
proof ending in torch.cuda.synchronize(), the card's proof bytes,
challenges and openings held equal to the host's (an error otherwise).
Then one card proof of each class under torch.profiler: each kernel's
device ms (onehot_prepare, onehot_buckets, onehot_round) and the engine's
spans (rachecks_upload, rachecks_rounds, rachecks_fetch), ms. The census
weighs the medians by the batches a proof holds of each class. Last, the
kernels of a few classes (``KERNEL_CLASSES``, random batches) timed by
CUDA events beside their plain versions on the card, with the rounds'
IMAD bound (``kernels``).

Prints the card's name and power limit (nvidia-smi), then one JSON line,
also written to ``--out``. Exits non-zero without a CUDA device. Imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def capture(seed: int) -> dict:
    """{(D, T): [the recipe of each read-check batch of that class]} of one
    host-path prove of the cell's model. A recipe holds the instances'
    inputs in batch order."""
    sys.path.insert(0, ROOT)
    from atlas_bench import cells, inputs
    from jolt_atlas_tpu_torch.device import onehot as donehot
    from jolt_atlas_tpu_torch.frontend.builder import ModelBuilder
    from jolt_atlas_tpu_torch.preprocessing import AtlasPreprocessing
    from jolt_atlas_tpu_torch.prover import AtlasProver
    from jolt_atlas_tpu_torch.subprotocols.onehot import (
        AddressReadCheckProver, BooleanityProver)
    cell = cells.find(ROOT, "nanogpt-4l-d64.closed-blake2b")
    cfg, builder = cell.config, cell.builder
    weights = builder.weights(cfg, inputs.normals(
        builder.weight_shapes(cfg), seed, torch.device("cpu")))
    model = builder.build(ModelBuilder, cfg, weights)
    vocab, seq = builder.request(cfg)
    toks = np.random.default_rng(seed).integers(0, vocab, size=seq).astype(
        np.int32)
    pp = AtlasPreprocessing.preprocess(model, pcs="hyperkzg")
    found: dict = {}
    real = donehot.try_prove

    def record(instances, accumulator, transcript):
        if all(type(i) in (BooleanityProver, AddressReadCheckProver)
               for i in instances):
            rec = []
            for i in instances:
                if type(i) is BooleanityProver:
                    rec.append(("b", list(i.poly_ids),
                                [a.copy() for a in i.idx], i.K, list(i.r_b),
                                list(i.gammas)))
                else:
                    rec.append(("rc", i.poly_id, i.sumcheck_id, i.table_spec,
                                i.d, i.claim, i.appends_opening,
                                list(i.r_cycle)))
            b = next(r for r in rec if r[0] == "b")
            found.setdefault((len(b[2]), len(b[2][0])), []).append(rec)
        return real(instances, accumulator, transcript)
    donehot.try_prove = record
    try:
        AtlasProver(pp, device="cpu").prove([toks])
    finally:
        donehot.try_prove = real
    return found


def instances(rec) -> list:
    """Fresh instances of a recipe."""
    from jolt_atlas_tpu_torch.subprotocols import onehot
    b = next(onehot.BooleanityProver(*r[1:]) for r in rec if r[0] == "b")
    reads = None
    out = []
    for r in rec:
        if r[0] == "b":
            out.append(b)
            continue
        if reads is None:
            reads = onehot.CycleReads(b.idx, r[7], b.K)
        out.append(onehot.AddressReadCheckProver(
            r[1], r[2], r[3], reads, r[4], r[5], r[6]))
    return out


def prove(rec, dev) -> tuple:
    """(wall ms, (proof bytes, challenges, openings)) of one batched
    sumcheck of the recipe: on the card's engine (``dev``) or, None, on
    the host path."""
    from jolt_atlas_tpu_torch.device import onehot as donehot
    from jolt_atlas_tpu_torch.poly.opening import ProverOpeningAccumulator
    from jolt_atlas_tpu_torch.subprotocols.sumcheck import BatchedSumcheck
    from jolt_atlas_tpu_torch.transcripts import Blake2bTranscript
    t = Blake2bTranscript(b"rachecks bench")
    acc = ProverOpeningAccumulator()
    insts = instances(rec)
    sc = donehot.Scope(dev) if dev is not None else None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with sc or contextlib.nullcontext():
        proof, r = BatchedSumcheck.prove(insts, acc, t)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    if dev is not None and sc.engaged != 1:
        raise AssertionError(f"the engine declined: {sc.declined}")
    return ms, (proof.serialize(), [x.v for x in r],
                {k: ([x.v for x in p], c.v)
                 for k, (p, c) in acc.openings.items()})


def traced(rec, dev) -> dict:
    """Device ms of each onehot kernel and the engine's span ms of one card
    proof of the recipe."""
    from jolt_atlas_tpu_torch.utils import profiling
    from torch.profiler import ProfilerActivity, profile
    profiling.enable()
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prove(rec, dev)
    spans: dict = {}
    for name, wall, _ in profiling.events():
        name = name.strip()
        if name.startswith("rachecks_"):
            spans[name] = spans.get(name, 0.0) + wall * 1e3
    profiling.enable(False)
    kernels: dict = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None)
        if t is None:
            t = e.cuda_time_total
        for k in ("onehot_prepare", "onehot_buckets", "onehot_round"):
            if k in e.key and t:
                kernels[k] = kernels.get(k, 0.0) + t / 1e3
    return {"kernels_ms": kernels, "spans_ms": spans,
            "device_ms": sum(kernels.values())}


# (K, D, T, read checks) for the kernels against their plain versions: the
# cell's most common large class, its largest, two of its T = 64 classes
# (the LayerNorm statistics) and Gather's
KERNEL_CLASSES = [(16, 14, 16384, 40), (16, 16, 16384, 44), (16, 26, 64, 61),
                  (16, 9, 64, 24), (128, 1, 64, 1)]


def kernels(dev, reps: int = 5) -> dict:
    """Each class's set-up and round launches timed by CUDA events (the
    least of ``reps`` sequences, the round launches summed), beside the
    plain versions run on the same card's tensors (the least of two), and
    the IMAD bound of
    the rounds (7 Montgomery products a (row, pair) of a cycle round, 5 a
    (row, value) of an address round, 264 IMAD each, at the card's
    16.73 T/s)."""
    from jolt_atlas_tpu_torch.device import onehot as O
    from jolt_atlas_tpu_torch.field.constants import FR_MODULUS
    from jolt_atlas_tpu_torch.field.scalar import Fr
    out = {}
    for K, D, T, N in KERNEL_CLASSES:
        gen = np.random.default_rng(K + D + T)
        rs = [None] + [Fr(int.from_bytes(gen.bytes(32), "little")
                          % FR_MODULUS) for _ in range(64)]
        row = {}
        for kind in ("kernel", "plain"):
            best = None
            for _ in range(reps if kind == "kernel" else 2):
                b = O.random_batch(K, D, T, N, gen, dev)
                lay = b.lay
                ev = [torch.cuda.Event(enable_timing=True)
                      for _ in range(lay.M + 4)]
                torch.cuda.synchronize()
                ev[0].record()
                if kind == "kernel":
                    O.prepare(b)
                    ev[1].record()
                    O.buckets(b)
                    ev[2].record()
                    for rnd in range(lay.M + 1):
                        O.round_(b, rnd, rs[rnd], 4, fetch=False)
                        ev[3 + rnd].record()
                else:
                    O.prepare_plain(b.ws, lay)
                    ev[1].record()
                    O.buckets_plain(b.ws, lay, b.idx)
                    ev[2].record()
                    for rnd in range(lay.M + 1):
                        w = [0] * 4 if rs[rnd] is None else [
                            (rs[rnd].v >> (64 * i)) & ((1 << 64) - 1)
                            for i in range(4)]
                        O.round_plain(b.ws, lay, b.idx, rnd, w)
                        ev[3 + rnd].record()
                torch.cuda.synchronize()
                t = [ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2]),
                     sum(ev[2 + k].elapsed_time(ev[3 + k])
                         for k in range(lay.M + 1)),
                     max(ev[2 + k].elapsed_time(ev[3 + k])
                         for k in range(lay.M + 1))]
                best = t if best is None else [min(a, c)
                                               for a, c in zip(best, t)]
            row[kind] = dict(zip(("prepare_ms", "buckets_ms", "rounds_ms",
                                  "largest_round_ms"), best))
        imads = 264 * (5 * D * K * (K.bit_length() - 1) + 7 * D * (T - 1))
        row["rounds_bound_ms"] = imads / 16.73e12 * 1e3
        row["launches"] = 2 + (K.bit_length() - 1) + (T.bit_length() - 1) + 1
        out[f"K{K}_D{D}_T{T}"] = row
    return out


def bench(dev, passes: int, seed: int) -> dict:
    found = capture(seed)
    out = {"classes": {}}
    for (D, T), recs in sorted(found.items(), key=lambda kv: -kv[0][1]):
        rec = recs[0]
        prove(rec, dev)  # the build and the first launch out of the way
        runs = {"host": [], "card": []}
        want = None
        for side in ("host", "card", "card", "host"):
            for _ in range(passes):
                ms, got = prove(rec, dev if side == "card" else None)
                want = got if want is None else want
                if got != want:
                    raise AssertionError(f"class {(D, T)}: the {side} "
                                         f"proof differs")
                runs[side].append(ms)
        row = {"batches": len(recs), "read_checks": len(rec) - 1,
               **{f"{s}_ms": v for s, v in runs.items()},
               **{f"{s}_median_ms": float(np.median(v))
                  for s, v in runs.items()}}
        row.update(traced(rec, dev))
        out["classes"][f"D{D}_T{T}"] = row
    cls = out["classes"].values()
    out["proof_host_ms"] = sum(c["batches"] * c["host_median_ms"]
                               for c in cls)
    out["proof_card_ms"] = sum(c["batches"] * c["card_median_ms"]
                               for c in cls)
    out["batches"] = sum(c["batches"] for c in cls)
    out["kernels"] = kernels(dev)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--passes", type=int, default=5)
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "rachecks_bench.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("rachecks_bench: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    report = {"card": cs.card_line(),
              **bench(torch.device("cuda"), args.passes, args.seed)}
    print(report["card"], flush=True)
    line = json.dumps(report)
    print(line, flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
