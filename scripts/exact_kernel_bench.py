"""Kernel 9 (torchexec.exact_matmul; csrc/exact.cu) alone on one GPU.

    python3 scripts/exact_kernel_bench.py [--root DIR] [--expect FILE]
                                          [--phases]

At chip_smoke.py's two timed shapes (EXACT_TIMED: a GPT-2 sized product,
1024 x 768 x 3072, and a GPT-2 MLP product at seq 16, 16 x 1024 x 4096),
i32 operands in a scale-2^12 range from fixed seeds, shift 12: device ms
after an L2 flush (chip_smoke.device_ms, 10 calls, every launch of a call
counted: a split depth's finish too), beside both bounds
(chip_smoke.exact_bounds: the 16 int8 limb products at the tensor-core
rate or the bytes, and 2 IMAD a product). Each result is held bit-equal to
the plain version, or, with ``--expect FILE``, to the SHA-256 digests that
file keeps (written by the first run from the plain version), so that
two checkouts are held to the same numbers.

``--root DIR`` takes the port's package from another checkout (a parent
unpacked with ``git archive``), so that two versions are compared within
one call: run this, parent, this, parent. ``--phases`` (this checkout's
exact.cu only) also builds it with its phase counters
(-DJOLT_EXACT_PHASES) and gives, at each shape, each warp's cycles by
phase, the mean over an SM's warps of each role (the copy warpgroup's
and the compute warpgroups'), from 5 calls. Prints ptxas's registers,
stack and spills of the checkout's kernel 9 kernels, the count of
tensor-core instructions in their SASS (TENSOR_OPCODES), the card's name
and power limit, then one JSON line. Exits non-zero without a CUDA
device.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib.util
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tensor-core opcodes, as this checkout's kernel_report.TENSOR_OPCODES (a
# parent's kernel_report may have none)
TENSOR_OPCODES = ("IMMA", "HMMA", "IGMMA", "HGMMA", "QGMMA", "BGMMA")


def chip_smoke():
    """This checkout's chip_smoke.py (its timers and bounds), loaded by
    path so that --root's own copy is not taken instead."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def digest(t) -> str:
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()
                          ).hexdigest()[:16]


def tensor_instructions(build, kernel_report) -> dict:
    """{kernel: (SASS instructions, tensor-core instructions)} of the
    kernels of the checkout's csrc/exact.cu."""
    nvcc = build.nvcc_path()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    with tempfile.TemporaryDirectory() as tmp:
        cubin = os.path.join(tmp, "exact.cubin")
        subprocess.run([nvcc, *kernel_report.ARCH, "-I", build.CUDA_SRC,
                        "-cubin", os.path.join(build.CUDA_SRC, "exact.cu"),
                        "-o", cubin], check=True, capture_output=True)
        text = subprocess.run([cuobjdump, "-sass", cubin], check=True,
                              capture_output=True, text=True).stdout
    opcode = lambda i: i.split()[1 if i.startswith("@") else 0]
    return {k: (len(v), sum(opcode(i).startswith(TENSOR_OPCODES)
                            for i in v))
            for k, v in kernel_report.sass_functions(text).items()}


# csrc/exact.cu's phase counters (JOLT_EXACT_PHASES): slot -> name
PHASES = {0: "copy_tiles", 1: "copy_wait_free", 2: "copy_issue",
          3: "copy_last_waits", 8: "compute_wait_words",
          9: "compute_wgmma_and_split", 10: "compute_slice_barrier",
          11: "compute_wgmma_wait", 12: "compute_frags_and_loop",
          13: "compute_epilogue"}


# exact.cu built with its phase counters, and a reader: the counters into
# host (16 uint64), then zeroed
PHASES_PROBE = r"""
#define JOLT_EXACT_PHASES
#include "exact.cu"
extern "C" int jolt_exact_phases(void* host) {
  static const unsigned long long zero[16] = {0};
  cudaError_t e = cudaMemcpyFromSymbol(host, jolt::jolt_exact_phase_cycles,
                                       sizeof(zero));
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(jolt::jolt_exact_phase_cycles, zero, sizeof(zero));
  return (int)e;
}
"""


def phases(torchexec, build, kernel_report, x, y) -> dict:
    """Cycles by phase of kernel 9 on x @ y (shift 12), built with its
    phase counters: the mean over an SM's warps of each role, a call."""
    B, M, K = x.shape
    N = y.shape[2]
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    tile, splits, kchunk = torchexec.exact_plan(B, M, K, N, sms)
    bm, bn = torchexec.EXACT_TILES[tile][:2]
    blocks = min(B * -(-M // bm) * -(-N // bn) * splits, sms)
    compute_warps = 4 if tile else 8
    out = torch.empty((B, M, N), dtype=torch.int32, device=x.device)
    ws = torch.empty((max(splits, 2) * 7 * B * M * N,), dtype=torch.int32,
                     device=x.device)
    with tempfile.TemporaryDirectory() as tmp:
        lib = kernel_report.probe_library(PHASES_PROBE, build.CUDA_SRC, tmp)
        f = lib.jolt_exact_matmul
        f.argtypes = build.SIGNATURES["jolt_exact_matmul"]
        counts = (ctypes.c_ulonglong * 16)()

        def run():
            if f(x.data_ptr(), y.data_ptr(), out.data_ptr(), ws.data_ptr(),
                 B, M, K, N, *x.stride(), *y.stride(), 12, 0, tile, splits,
                 kchunk, torch.cuda.current_stream().cuda_stream):
                raise RuntimeError("exact_matmul (phases build) failed")
        run()
        torch.cuda.synchronize()
        lib.jolt_exact_phases(counts)
        reps = 5
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
        if lib.jolt_exact_phases(counts):
            raise RuntimeError("reading the phase counters failed")
    if not torch.equal(out, torchexec.exact_matmul_plain(x, y, 12)):
        raise AssertionError("the phases build differs from the plain "
                             "version")
    return {name: counts[i] / (blocks * (4 if i < 8 else compute_warps)
                               * reps)
            for i, name in PHASES.items()}


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--expect", default=None)
    ap.add_argument("--phases", action="store_true")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("exact_kernel_bench: no CUDA device", file=sys.stderr)
        return 1
    cs = chip_smoke()
    sys.path.insert(0, os.path.abspath(a.root))
    from jolt_atlas_tpu_torch import torchexec
    from jolt_atlas_tpu_torch.device import build, kernel_report
    dev = torch.device("cuda")
    imad = cs.imad_peak()
    expect = {}
    if a.expect and os.path.exists(a.expect):
        with open(a.expect) as f:
            expect = json.load(f)
    out = {"root": os.path.abspath(a.root), "shapes": []}
    for i, (M, K, N) in enumerate(cs.EXACT_TIMED):
        gen = np.random.default_rng(1010 + i)
        x = torch.from_numpy(gen.integers(-2**14, 2**14, size=(1, M, K),
                                          dtype=np.int32)).to(dev)
        y = torch.from_numpy(gen.integers(-2**14, 2**14, size=(1, K, N),
                                          dtype=np.int32)).to(dev)
        ms, call, got = cs.device_ms(
            lambda: torchexec.exact_matmul(x, y, 12), 10, "exact_matmul",
            cold=True)
        key = f"{M}x{K}x{N}"
        if key not in expect:
            expect[key] = digest(torchexec.exact_matmul_plain(x, y, 12))
        if digest(got) != expect[key]:
            raise AssertionError(f"{key}: the kernel differs from its plain "
                                 "version")
        b = cs.exact_bounds(1, M, K, N, imad)
        out["shapes"].append({
            "shape": key, "ms": ms, "call_ms": call, **b,
            "share": b["bound_ms"] / ms,
            "share_imad": b["bound_imad_ms"] / ms})
        if a.phases:
            out["shapes"][-1]["phase_cycles"] = phases(
                torchexec, build, kernel_report, x, y)
    if a.expect:
        with open(a.expect, "w") as f:
            json.dump(expect, f)
    ptx = kernel_report.parse_ptxas(build.ptxas_report())
    sass = tensor_instructions(build, kernel_report)
    out["kernels"] = {k: {**v, "sass_instructions": sass.get(k, (0, 0))[0],
                          "sass_tensor": sass.get(k, (0, 0))[1]}
                      for k, v in ptx.items() if "exact" in k}
    for k, r in out["kernels"].items():
        print(f"ptxas -v {k}: {json.dumps(r)}")
    print(cs.card_line())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
