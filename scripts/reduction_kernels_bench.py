"""Kernels 5 and 6 (device/reduction.py: q0, tail; csrc/reduction.cu)
alone on one GPU.

    python3 scripts/reduction_kernels_bench.py [--root DIR] [--inputs FILE]
                                               [--stages]

Inputs: the opening reduction of the bench nanoGPT (chip_smoke.py's prove
phase: 4 blocks, 4 heads, d64, seq 64, vocab 65, seed 1234), captured from
one host-path prove: the split-eq tables of its largest round (round 2)
and of round 0 (dred.Plan, chip_smoke.bench_round_weights), lane rows
made from seed 7, and kernel 6's inputs at the bench's 256 lanes with 175
joined (random_tail, seed 8). ``--inputs FILE`` keeps them (torch.save) on
first use and reads them after, so two checkouts time the same inputs.

Times, from torch.profiler's device durations (chip_smoke.device_ms and
kernels_ms, 20 calls): q0 at round 2, the tail at 256 lanes and the pair
q0 + tail at round 0, each held bit-equal to its plain version. ``--root
DIR`` takes the port's package from another checkout (a parent unpacked
with ``git archive``); a package whose tail still takes per-block
partials (kernel 5 before its lane fold) gets those of its own q0.
``--stages`` builds kernel 6 with a clock64 stamp at each of its stages
(thread 0; csrc/reduction.cu TAIL_STAMP) and prints the cycles of each,
medians of 20 launches. Prints the card's name and power limit, then one
JSON line. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import inspect
import json
import os
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIMS = (65, 64, 64, 4, 4)  # vocab, seq, d, blocks, heads: the bench's
STAGES = ("lane loads and lane terms", "b0 and b2 block sums",
          "canonical b0 and b2", "long absorb and squeeze", "challenge",
          "lane updates")
_STAMPS = r"""
#include <cuda_runtime.h>
__device__ unsigned long long jolt_stamps[8];
#define TAIL_STAMP(k) \
  if (threadIdx.x == 0) jolt_stamps[k] = (unsigned long long)clock64();
#include "reduction.cu"
extern "C" int jolt_tail_stamps(void* host) {
  return (int)cudaMemcpyFromSymbol(host, jolt_stamps, sizeof(jolt_stamps));
}
"""


def chip_smoke():
    """This checkout's chip_smoke.py (its timers and bounds), loaded by
    path so that --root's own copy is not taken instead."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def capture(cs, dev) -> dict:
    """The round tables and tail inputs (module docstring), on the CPU."""
    from jolt_atlas_tpu_torch import models
    from jolt_atlas_tpu_torch.device import reduction as dred
    from jolt_atlas_tpu_torch.preprocessing import AtlasPreprocessing
    from jolt_atlas_tpu_torch.prover import AtlasProver
    vocab, seq, dim, blocks, heads = DIMS
    rng = np.random.default_rng(1234)
    model = models.build_nanogpt(vocab, seq, dim, blocks, 8, rng,
                                 heads=heads)
    toks = rng.integers(0, vocab, size=seq).astype(np.int32)
    cap: dict = {}
    with cs.capture_reduction(cap):
        AtlasProver(AtlasPreprocessing.preprocess(model),
                    device="cpu").prove([toks])
    insts, _ = cs.reduction_instances(cap)
    nrs = [i.num_rounds() for i in insts]
    r, _, lanes, lg = cs.largest_round(nrs)
    out = {"nrs": nrs}
    for key, rnd, n, size in (("big", r, lanes, lg),
                              ("r0", 0, nrs.count(max(nrs)), max(nrs))):
        tab, lanep = cs.bench_round_weights(insts, rnd, "cpu")
        out[key] = {"round": rnd, "lanes": n, "lg": size, "tab": tab,
                    "lanep": lanep}
    L = max(1 << (len(nrs) - 1).bit_length(), 2)
    out["tail"] = {"L": L, "J": len(nrs), **dred.random_tail(
        "cpu", np.random.default_rng(8), L, len(nrs))}
    return out


def rows(n: int, seed: int, dev) -> torch.Tensor:
    """n random Fr elements below 2^253 as (n, 4) Montgomery limbs."""
    d = np.random.default_rng(seed).integers(0, 1 << 64, size=(n, 4),
                                             dtype=np.uint64).view(np.int64)
    d[:, 3] &= (1 << 61) - 1
    return torch.from_numpy(d).to(dev)


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--inputs", default=None)
    ap.add_argument("--stages", action="store_true")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("reduction_kernels_bench: no CUDA device", file=sys.stderr)
        return 1
    cs = chip_smoke()
    sys.path.insert(0, os.path.abspath(a.root))
    from jolt_atlas_tpu_torch.device import build, telemetry
    from jolt_atlas_tpu_torch.device import reduction as dred
    dev = torch.device("cuda")
    if a.inputs and os.path.exists(a.inputs):
        inp = torch.load(a.inputs)
    else:
        inp = capture(cs, dev)
        if a.inputs:
            torch.save(inp, a.inputs)
    partials = "partials" in inspect.signature(dred.tail).parameters
    out = {"root": os.path.abspath(a.root), "api": "partials" if partials
           else "one q(0) a lane", "instances": len(inp["nrs"])}

    def q0_args(key: str, seed: int) -> tuple:
        r = inp[key]
        buf = rows(r["lanes"] << r["lg"], seed, dev)
        return (buf, r["tab"].to(dev), r["lanep"].to(dev), r["lanes"],
                r["lg"])

    # -- kernel 5 at the largest round
    qa = q0_args("big", 7)
    ms, call, got = cs.device_ms(lambda: dred.q0(*qa), 20, "reduction_q0")
    if not torch.equal(got, dred.q0_plain(*qa)):
        raise AssertionError("kernel 5 differs from its plain version")
    out["q0"] = {"shape": f"round {inp['big']['round']}: {qa[3]} lanes of "
                 f"2^{qa[4]}", "ms": ms, "call_ms": call}
    # -- kernel 6 at the bench's lanes
    t = {k: v.to(dev) if torch.is_tensor(v) else v
         for k, v in inp["tail"].items()}
    J, L = t["J"], t["L"]
    c = torch.empty((1, 4), dtype=torch.int64, device=dev)
    msg = torch.empty((2, 4), dtype=torch.int64, device=dev)
    rest = (t["Q"], t["es"], t["qinit"], t["coeff"], t["l0"], t["l1"],
            t["inv_l1"], t["const_b0"])
    if partials:  # the parent's kernel 6 adds its lanes' block partials
        bpl = dred.q0_blocks(max(inp["nrs"]))
        lead = (rows(J * bpl, 9, dev), bpl, J)
    else:
        lead = (t["q0s"], J)
    state = t["state"].clone()
    ms, call, _ = cs.device_ms(
        lambda: dred.tail(*lead, *rest, state, c, msg), 20, "reduction_tail")
    st = t["state"].clone()
    want = dred.tail_plain(*lead, *(x.clone() for x in rest), st)
    got = (rest[0].clone(), rest[1].clone(), t["state"].clone(), c.clone(),
           msg.clone())
    dred.tail(*lead, got[0], got[1], *rest[2:], got[2], got[3], got[4])
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError("kernel 6 differs from its plain version")
    out["tail"] = {"shape": f"{L} lanes, {J} joined"
                   + (f", {lead[1]} partials a lane" if partials else ""),
                   "ms": ms, "call_ms": call}
    # -- the pair at round 0
    pa = q0_args("r0", 10)
    J0 = pa[3]

    def pair():
        q = dred.q0(*pa)
        lead0 = (q, dred.q0_blocks(pa[4]), J0) if partials else (q, J0)
        dred.tail(*lead0, *rest, state, c, msg)
    before = dict(telemetry.launches())
    out["pair_round0"] = {
        "shape": f"round 0: {J0} lanes of 2^{pa[4]}; tail over {L} lanes",
        "ms": cs.kernels_ms(pair, ("reduction_q0", "reduction_tail"), 20),
        "call_ms": cs.cuda_ms(pair, 20)[0],
        "launches": {k: v - before.get(k, 0)
                     for k, v in telemetry.launches().items()}}

    if a.stages:  # kernel 6 with a clock64 stamp at each stage
        from jolt_atlas_tpu_torch.device import kernel_report
        with tempfile.TemporaryDirectory() as tmp:
            lib = kernel_report.probe_library(_STAMPS, build.CUDA_SRC, tmp)
            f = lib.jolt_reduction_tail
            f.argtypes = build.SIGNATURES["jolt_reduction_tail"]
            stamps = (ctypes.c_ulonglong * 8)()
            runs = []
            args = [x.clone() for x in rest] + [t["state"].clone(), c, msg]
            for _ in range(21):
                rc = f(lead[0].data_ptr(), J, L,
                       *(x.data_ptr() for x in args),
                       torch.cuda.current_stream().cuda_stream)
                torch.cuda.synchronize()
                if rc or lib.jolt_tail_stamps(stamps):
                    raise RuntimeError("stamped tail launch failed")
                runs.append([stamps[k + 1] - stamps[k] for k in range(6)])
            med = np.median(np.array(runs[1:]), axis=0)
        out["tail_stages_cycles"] = dict(zip(STAGES, med.tolist()))
        out["tail_stages_total_cycles"] = float(med.sum())
    print(cs.card_line())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
