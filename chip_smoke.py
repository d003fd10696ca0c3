"""Chip smoke run of the PyTorch/CUDA port (jolt_atlas_tpu_torch) on one GPU.

    python3 chip_smoke.py            # every phase, from the repo root

Phases, in order; each prints one line and raises on failure, so the
script exits non-zero when any phase fails:

  1. device   a CUDA device is present; its name and power limit
  2. build    the CUDA kernels (sm_90a, one nvcc per source, in parallel)
              and the host C++ engines, from source; ptxas's registers,
              spills and shared memory per kernel, the SASS of one fq_mul
              (device/kernel_report.py), kernel 7's registers and shared
              memory by launch plan, kernels 1-8 and the BLAKE2b test
              kernel held to their recorded SASS digests (KEPT_SASS)
              under the nvcc that recorded them, no spill in kernels 1-3,
              8 and 9, and no stack frame for kernel 6 and the BLAKE2b
              test kernel
  3. pp_add   kernel 1 against its plain PyTorch version on the card: 2^16
              random pairs plus doubling, P + (-P), the identity on either
              side and coordinates near p; bit-equal, timed at the gate's
              2^17 lanes
  4. bucket   kernel 2 (its runs of mixed adds on affine bases, then its
              levels of joins) against its plain version on the signed
              digit lanes of 4096 scalars at c = 6 (runs of 1, 5, 16 and
              64 entries), on a lane of the mixed add's edge cases (A, -A,
              B, B, -B, A, A), and on those of a 2^16-point (c = 12), a
              2^17-point and a 2^18 - 3 point (c = 14) MSM; bit-equal,
              each of the latter timed beside the old design's bound and
              its own (2^17 also at runs of 8 and 32 entries)
  5. combine  kernel 3 (the walk, the blocks' combine, the window fold)
              against its plain version on the real bucket sums of phase
              4 (k = 1 at c = 12 and 14), at the fold batch's two
              launches (1 MSM at c = 14, 16 at c = 12) and at 17 MSMs at
              c = 14, with identity buckets and the add's edge cases;
              bit-equal, each timed beside both bounds, its device ms
              split by its kernels
  6. msm      the device MSM against the host csrc MSM at n = 2^17: random
              254-bit scalars (adaptive window) and 16-bit scalars (at c =
              8, and at the adaptive window, where the reference's grid
              refuses them as skewed: their deepest lane printed); affine
              points equal; the stage breakdown of one MSM at 2^17 and at
              2^18 - 3 (upload, digit lanes, kernel 2, kernel 3 with the
              fold, the affine conversion)
  7. gate     the MSM gate measures this card and host (the calibration
              path: pp_add chain, host MSM, device MSM at 2^16 and 2^18)
              and persists it; its plan for every MSM size of the bench
  8. split    2^18 - 3 random scalars on the device alone, the host alone,
              and split at device shares 2^15, 2^16, 2^17: all equal the
              host point; medians of 3, alternated
  9. prove    the bench nanoGPT (4 blocks, 4 heads, d64, seq 64, vocab 65,
              random weights from seed 1234) proved by AtlasProver(pp)
              with no device argument (the card, on the gate's routes,
              the IOP's head rounds and the opening reduction's rounds on
              the card), with a forced split and on the host
              (device="cpu"); the rows and reduction engines must engage
              on the first two; proof bytes equal; the port's verifier
              accepts it and rejects a flipped commitment
 10. trace    one more gate-path prove under torch.profiler (the device's
              idle share, kernels 2-8's device ms and launches, the
              busiest kernels; kernel 7 launched once a device round), and
              one split MSM whose host prefix must overlap its device
              kernels.
 11. reduction  kernels 4-6 (the opening reduction's bind, q0 and tail)
              and the BLAKE2b test kernel against their plain versions at
              small shapes and the edges (late joiners, l1 = 0, padding
              lanes, every weight layout of kernel 5, kernel 5's lazy sum
              at its worst case of every factor's limbs r - 1 and at every
              factor r - 1, a lane of 2^21 elements for its lane fold),
              bit-equal, and the test kernel against hashlib; kernels 4
              and 5 timed at the largest round of the bench's reduction
              (kernel 5 on that round's own weight tables, bound by its
              bytes and its lazy sums' IMAD, a Montgomery product a term
              beside it), kernel 6 at its lanes (bound by its bytes and
              products, and beside it by the latency of its round: the
              dependent chain of tail_round's SASS times the measured
              integer latency), kernels 5
              and 6 as a pair at the bench's round 0; the engine against
              the host BatchedSumcheck on the bench's own instances, in
              turns: messages, challenges, transcript state and final
              claims equal.
 12. rows     kernel 7 (the IOP rows engine's points) against its plain
              version at P = 1, 2, 27 and 96 rows (and 27 rows with the
              bench class's grouped terms) and 1, 2, 6 and 20 points on
              every weight layout, and kernel 4 in the rows layout,
              bit-equal; kernel 7 timed on the bench's largest class
              beside its bound, and at neighbouring launch plans; the
              engine against the host
              GruenInstance on the bench's own instances (captured from
              the host-path prove), in turns: every round message and
              final row value equal, the engine's ms split into
              conversion, upload, device rounds, handoff fetch and host
              rounds; kernel 7 held against its plain version at every
              shape class those instances launch it at.
 12b. onehot  the read-check engine's kernels (onehot_prepare,
              onehot_buckets, onehot_round; csrc/onehot.cu) against their
              plain versions on the card, launch by launch, on a random
              batch of each of ONEHOT_CLASSES (the cell's largest class, D
              16 and T 16,384, its T = 64 LayerNorm class, Gather's K 128,
              int32 indices at K 512, and K 1024 at T = 2), the workspace
              copied before each launch and the plain version run on the
              copy;
              the bench prove once more with every class it launches held
              on its own inputs, its bytes phase 9's; each kernel timed at
              the largest class beside its bound (onehot_work) and its
              plain version's ms.
 12c. bind    the einsum bind kernel (einsum_bind; csrc/bind.cu) against
              its plain version on the card at gpt2-1l's shapes (its
              weights 1,024 x 4,096 and 4,096 x 1,024, the tied head's
              1,024 x 8,192, their activations, attention's 16 x 16 x 64
              with the exclusive axis in the middle, laid out by the
              engine), at int32 and int64 extremes and at E = 1; the bench
              prove once more with every class it launches held, its bytes
              phase 9's; each weight shape timed after an L2 flush beside
              its bound (its bytes, or 16 IMADs an element) and its plain
              version's ms.
 13. mesh     the bench prove under mesh_scope over 8 shards of the card
              (parallel/), in one process and over a 1-rank NCCL group:
              bytes equal the gate path's, the verifier accepts, the mesh
              reduction and the mesh rows engine engage (their instances,
              rounds and kernel 4, 5, 7 and 8 launches printed, the phase
              seconds beside the gate path's); kernels 4, 5 and 7 held
              against their plain versions at the first launch of every
              shape class the mesh path makes; the sharded product round at
              2^20 elements over 8 shards against the CPU plain path and
              Python integers; BENCH_SMALL's nanoGPT under KeccakTranscript
              over 8 shards of the card, bytes equal to the host path's
              Keccak prove, the Keccak verifier accepting and the BLAKE2b
              verifier rejecting it; dryrun_multichip(8).
 14. exact    kernel 9 (csrc/exact.cu) bit-equal to its plain version at
              the example MLP's products, the one-block transformer's and
              the bench's attention products (batched), K = 4096 with every
              operand at 2^31 - 1, at -2^31, mixed and random, its tile
              edges (M, N in 1, 15, 16, 17, 63, 64, 65, 129 at K = 1, 31,
              32, 33, 4096), a batch at a split depth, in both modes at
              shifts 0, 1, 7, 8, 12, 16 and 24, the wrapping mode at K =
              16,384 at the extremes, and through the einsum lowering
              (strided operands); its SASS holds tensor-core instructions;
              timed at 1024 x 768 x 3072 and 16 x 1024 x 4096 after an L2
              flush beside its bound (16 int8 limb products at the
              tensor-core rate, or its bytes) and the 2-IMAD bound, and
              beside 16 torch._int_mm limb products with b row-major and
              column-major; entry() on the card against the CPU forward.
 15. models   the model entry points on the card, each against the host
              path (device="cpu"): the GPT-2-style slice (GPT-2 cut to 2
              blocks, 4 heads, d128, seq 16, vocab 8192, scale 2^12; its
              SRS of 2^21 points, like the bench's 2^18, is phase 16's
              2^24 trimmed; its folds of 2^20 - 2^18 points, skewed, on
              the card) through examples/nanogpt_style's
              run: bytes equal, verified, a flipped commitment rejected,
              each path's phase and setup seconds, every engine decision,
              the gate's route for each MSM size of the prove and its
              largest MSM on the device and the host in turns; qwen_slice
              from the committed ONNX (examples/qwen_style); prove_zk on
              BENCH_SMALL's shape and tests/test_zk_pipeline.py's relu MLP
              under one seeded blinding stream, the MSM and rows engines
              forced (the masked opening's MSMs dispatched to the card,
              the reduction on the host: "zk"); tests/test_dory.py's e2e
              model with pcs="dory", the reduction and rows engines forced;
              the bench nanoGPT under KeccakTranscript with the default
              gates (the reduction declines: "transcript not BLAKE2b").
              Kernels 2-7 and the read-check engine's are held bit-equal
              to their plain versions at
              the first launch of every shape class and MSM size these
              paths make (hold_kernels): the GPT-2-style slice in a run
              before its counted one, the other paths in their counted
              run (their card seconds then hold the plain versions').
 16. flagship GPT-2 at the reference's padded 125M shape (examples/
              gpt2_style.py --full: dim 1024, 16 heads, vocab 50257 padded
              to 65536, seq 16, scale 2^12) cut to FLAGSHIP_BLOCKS blocks
              (printed; its opening is 2^24 points at any depth), its SRS
              of 2^24 points made before phase 3 into a temporary
              directory out of the checkout: proved on the card with the
              default gates through nanogpt_style.run, counted, kernels
              3-7 and the read-check engine's held after it at every
              class it launched (the first launch of each copied; its
              Gather, vocab 50257 > GATHER_SMALL_MAX, checks 4-bit chunks:
              no int32 class); verified,
              a flipped commitment and a flipped byte rejected, the
              reduction ENGAGED, hyperkzg_open's fold batch and witness on
              the card; the largest fold's and the witness's MSMs on the
              card equal to the host engine's; kernel 2 held at the class
              of its flagship launches (c = 16, level 1 a thread a chunk,
              a lane over 32 x the mean) on 2^20 of the largest fold's
              scalars; kernels 2 and 3 timed on the witness's and the
              largest fold's scalars and at the largest combine (CUDA
              events; kernel 2's runs and join also launched apart,
              kernels 2 + 3 on the witness at c = 16 and 18 in turns);
              set-up (the
              SRS, the bases' upload), prove, phases, verify, proof bytes,
              peak memory, the gate's routes and every MSM's deepest lane
              printed.
 17. bench    the port's bench entry (python -m jolt_atlas_tpu_torch.bench)
              once, in a subprocess, at the full bench shape on the card:
              its JSON line printed; it exits 0 (its proof verified), the
              proof is 764,841 bytes and the MSM, reduction and rows
              engines engaged in its fastest prove.

Each timed kernel shape is printed beside its bound: the larger of the
bytes it must move over the HBM rate and its 32-bit multiplies over the
card's IMAD peak (``bound``); kernels 2 and 3 count the work of their
own design (``bound_ms``) and, beside it, the work the design before their
redesign needed for the same MSMs (``bound_prev_design_ms``, as the
earlier rows counted); kernel 9's, its int8 limb products
over the tensor cores' int8 rate (``exact_bounds``). Kernel times are the profiler's device
durations (``device_ms``); the wrapper's call time, host work included,
is printed beside them.

Each path (gate calibration, split, the two device proves, the three mesh
proves, the forward, phase 15's proves, phase 16's counted prove) runs
with the launch counts set to 0 just before it and read just after; the
kernels JSON sums them, and gives the traced prove's own launches, a mesh
prove's, phase 15's (``launches_models``) and phase 16's
(``launches_flagship``). Each phase prints its seconds. Every shape a
path launched a kernel at (its lane count; for kernel 2 also its level
1's mapping; for kernel 3 also its blocks per window; for kernels 4 and 5
their branch class; for the read-check engine's buckets whether its
indices are int32, for its round that and the round's branch class; for
kernel 7 its rows,
points, terms, weight layout and launch plan; for kernel 9 its mode and
whether it is batched) must be one that phases 3-5 and 11-16 held
against the plain version, or the run fails. The
second line from the end is that JSON, the last line {"ok": true,
"device": {...}}. Imports nothing of JAX or jolt_atlas_tpu.
"""

from __future__ import annotations

import contextlib
import copy
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def cuda_ms(fn, reps: int, warmup: bool = True):
    """(mean device milliseconds of fn() over reps runs (CUDA events),
    the last run's result)."""
    if warmup:
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        out = fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps, out


def _profiler_pad() -> None:
    """A short device activity and a pause, so that the launches traced
    between two pads lie inside the profiler's window (its first and last
    activities can go unrecorded)."""
    torch.ones(1, device="cuda").add_(1)
    torch.cuda.synchronize()
    time.sleep(0.005)


L2_BYTES = 50 * 2 ** 20  # H100's L2 cache


def l2_flush(dev) -> None:
    """Write twice the L2's bytes, so that the next kernel finds neither
    its inputs nor its output's lines in the cache."""
    if getattr(l2_flush, "buf", None) is None:
        l2_flush.buf = torch.empty(2 * L2_BYTES // 4, dtype=torch.int32,
                                   device=dev)
    l2_flush.buf.fill_(1)


def device_ms(fn, reps: int, kernel: str, counted: str | None = None,
              cold: bool = False):
    """(mean device milliseconds a call of fn() spends in the CUDA kernels
    whose name holds ``kernel``, from torch.profiler's kernel durations;
    mean milliseconds a call on CUDA events around the loop, the wrapper's
    call time, host work included; the last call's result). A kernel
    shorter than its wrapper's host cost shows only in the first. The
    launches are the wrappers' own count (telemetry name ``counted``,
    ``kernel`` by default). A trace that missed some is taken again, twice
    at most; if the last still misses some, a call's device time is the
    mean duration of the launches it holds times the launches a call.
    ``cold``: the traced calls each follow an L2 flush (``l2_flush``), so
    a kernel bound by its bytes reads and writes device memory and not
    lines a previous call left in the cache (the call time stays back to
    back)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from jolt_atlas_tpu_torch.device import telemetry
    name = counted or kernel
    call, out = cuda_ms(fn, reps)
    for _ in range(3):
        before = telemetry.launches().get(name, 0)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _profiler_pad()
            for _ in range(reps):
                if cold:
                    l2_flush(torch.device("cuda"))
                out = fn()
            _profiler_pad()
        launched = telemetry.launches().get(name, 0) - before
        hits = [e.time_range.elapsed_us() for e in prof.events()
                if e.device_type == DeviceType.CUDA and kernel in e.name]
        if len(hits) == launched:
            break
    if not hits or launched < reps:
        raise AssertionError(f"the profiler saw {len(hits)} of {launched} "
                             f"launches of {kernel} in {reps} calls")
    return sum(hits) / len(hits) * launched / 1e3 / reps, call, out


def all_device_ms(fn, reps: int) -> float:
    """Mean device milliseconds a call of fn() spends in all the CUDA
    kernels and copies it launches (torch ops included), from
    torch.profiler's durations. The trace is padded by spin kernels
    (``torch.cuda._sleep``), which are left out by their name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def pad():
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(0.005)

    fn()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        pad()
        for _ in range(reps):
            fn()
        pad()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA and "spin" not in e.name)
    return us / 1e3 / reps


def max_abs_err(got, want) -> float:
    return max(float((g - w).abs().max()) if g.numel() else 0.0
               for g, w in zip(got, want))


def require_equal(what: str, got, want) -> float:
    err = max_abs_err(got, want)
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"{what}: kernel differs from its plain "
                             f"version (max abs limb difference {err})")
    return err


def checked(results, kernel: str, lanes) -> None:
    """Note that ``kernel`` was held bit-equal to its plain version at a
    launch of shape ``lanes`` (as its wrapper records it in telemetry)."""
    results.setdefault("checked_lanes", {}).setdefault(kernel, set()).add(
        lanes)


# The least time the card could take (bound_ms): the larger of the bytes the
# function must move (each input read once, each output written once) over
# the HBM rate and its 32-bit integer multiplies over the IMAD peak. Kernels
# 1-3 are counted in complete projective adds: six Montgomery products of
# 264 32-bit multiplies and three sums of two products reduced once (8
# steps of two product rows, m and a reduction row: 392), as csrc/fq.cuh
# pp_add_dev forms them; 12 Montgomery products an add stand beside it
# (bound_montgomery_ms). Kernels 2 and 3 count what their design does as
# bound_ms: mixed adds (five products and three sums, pm_add_dev) on
# 64-byte bases, 2^(c-1) lanes a window, the blocks' offsets and the
# fold's doublings (six products and a sum, pp_double_dev); beside it
# bound_prev_design_ms keeps the complete adds of the design before their
# redesign (unsigned digits, 2^c lanes a window, 96-byte bases, the window
# fold on the host), so that shares compare with the earlier rows.
# Kernels 4-6 count Fr Montgomery products,
# 264 multiplies each; the BLAKE2b step counts its 32-bit integer
# operations (3-input adds, xors, funnel shifts) at the same rate. Hopper issues 64
# IMADs per clock per SM (CUDA C Programming Guide, arithmetic instruction
# throughput, compute capability 9.0), at the card's maximum SM clock
# (nvidia-smi).
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 peak (NVIDIA datasheet)
IMADS_PER_MUL = 264
IMADS_PER_SUM2 = 8 * (16 + 16 + 1 + 16)
IMADS_PER_ADD = 6 * IMADS_PER_MUL + 3 * IMADS_PER_SUM2
IMADS_PER_ADD_MONTGOMERY = 12 * IMADS_PER_MUL
IMADS_PER_MIXED = 5 * IMADS_PER_MUL + 3 * IMADS_PER_SUM2
IMADS_PER_DOUBLE = 6 * IMADS_PER_MUL + IMADS_PER_SUM2
# kernel 8's two CIOS steps over |v|'s 32-bit words (csrc/rows.cu
# fr_from_u64): a row of |v|_i C (16 IMAD), m = t0 N0 (1) and a row of m r
# (16) each
IMADS_PER_I64 = 2 * (16 + 1 + 16)
POINT_BYTES = 3 * 32
AFFINE_BYTES = 2 * 32  # kernel 2's bases since its redesign
FR_BYTES = 32
# one BLAKE2b compression: 12 rounds x 8 mixes x (4 u64 adds, two of them
# 3-input, + 4 xors + 3 rotates; the rotate by 32 swaps halves), each two
# 32-bit operations
B2_OPS_PER_COMPRESS = 12 * 8 * 11 * 2


def imad_peak() -> float:
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], check=True, capture_output=True,
        text=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return 64 * sms * mhz * 1e6


def bound(adds: int, nbytes: int, peak: float,
          imads_per: int = IMADS_PER_ADD) -> tuple:
    """(bound ms, "operations" or "bytes") of ``adds`` operations (complete
    adds unless ``imads_per`` says otherwise) that must move ``nbytes``."""
    ops_ms = adds * imads_per / peak * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms,
                                                               "bytes")


def msm_bound(results, design: tuple, prev: tuple, ms: float) -> tuple:
    """(record, line) of kernels 2 and 3's bounds: ``design`` the (32-bit
    multiplies, bytes) of their own design (bound_ms), ``prev`` the
    (complete adds, bytes) of the design before their redesign on the
    same MSMs (bound_prev_design_ms)."""
    b, by = bound(design[0], design[1], results["imad_peak"], 1)
    pb, pby = bound(prev[0], prev[1], results["imad_peak"])
    return ({"bound_ms": b, "bound_by": by, "share": b / ms,
             "bound_prev_design_ms": pb, "bound_prev_design_by": pby,
             "share_prev_design": pb / ms},
            f"bound {b:.4f} ms ({by}), share {b / ms:.3f}; the previous "
            f"design's bound {pb:.4f} ms ({pby}), share {pb / ms:.3f}")


def timed(results, kernel: str, shape: str, ms: float, adds: int,
          nbytes: int, imads_per: int = IMADS_PER_ADD,
          call_ms: float | None = None, design: tuple | None = None) -> str:
    """Record one timed shape of a kernel (device ms, and the wrapper's
    call ms: device_ms) beside its bound; its line. Kernels 2 and 3 give
    their design's (32-bit multiplies, bytes) as ``design`` and the
    previous design's complete adds and bytes as ``adds``, ``nbytes``
    (``msm_bound``)."""
    rec = {"shape": shape, "ms": ms, "call_ms": call_ms, "adds": adds}
    line = (f"{shape}: kernel {ms:.4f} ms on the device (a call "
            f"{call_ms:.4f} ms), ")
    if design is not None:
        more, text = msm_bound(results, design, (adds, nbytes), ms)
        rec.update(more)
        line += text
    else:
        b, by = bound(adds, nbytes, results["imad_peak"], imads_per)
        rec.update(bound_ms=b, bound_by=by, share=b / ms)
        line += f"bound {b:.4f} ms ({by}), share {b / ms:.3f}"
    if imads_per == IMADS_PER_ADD and design is None:
        # complete adds: 12 products an add beside it
        mb = bound(adds, nbytes, results["imad_peak"],
                   IMADS_PER_ADD_MONTGOMERY)[0]
        rec.update(bound_montgomery_ms=mb, share_montgomery=mb / ms)
        line += f" (12 products an add: bound {mb:.4f} ms, {mb / ms:.3f})"
    results.setdefault("timed", {}).setdefault(kernel, []).append(rec)
    return line


# The SASS digests (kernel_report.sass) of kernels 1-8 and the BLAKE2b test
# kernel, built with this nvcc (the chip machine's CUDA 12.9): kernels 1
# and 4-8 and the test kernel as the redesigns of kernels 9, 2 and 3 left
# them (kernels 4-7 and the test kernel recorded before the redesign of
# kernels 8 and 1, kernels 1 and 8 after it); kernels 2 and 3 as their
# redesign made them
KEPT_SASS = ("cuda_12.9.r12.9/compiler.36037853_0", {
    "pp_add_kernel": "6a280bd3dc5ad72a",
    "bucket_accumulate_runs": "c067fba3b45482e7",
    "bucket_accumulate_level": "43c21499459cd102",
    "bucket_combine_kernel": "f72cd1aa5ef2ef78",
    "bucket_combine_groups": "f1ff5eb3b537b76b",
    "bucket_combine_fold": "19bede60e811e872",
    "reduction_bind_kernel": "be07dc0fe3190249",
    "reduction_q0_kernel": "59f78d9c794c347c",
    "reduction_tail_kernel": "97fffe30758e5bfa",
    "blake2b_transcript_kernel": "2d8d11720d9f7a88",
    "rows_points_kernel": "e031ea250e180281",
    "rows_from_i64_kernel": "dcfca6686674e244"})
# kernels that must keep their message words and state in registers
NO_STACK = ("reduction_tail_kernel", "blake2b_transcript_kernel")
# kernel 9's kernels: its two tiles and the split depth's finish
EXACT_KERNELS = ("exact_matmul_wide", "exact_matmul_narrow",
                 "exact_matmul_finish")
# kernels 1-3 (the complete add and its users), 8 and 9: no spill
NO_SPILL = ("pp_add_kernel", "bucket_accumulate_runs",
            "bucket_accumulate_level", "bucket_combine_kernel",
            "bucket_combine_groups", "bucket_combine_fold",
            "rows_from_i64_kernel") + EXACT_KERNELS


# ---------------------------------------------------------------------------

def phase_build() -> None:
    from concurrent.futures import ThreadPoolExecutor
    from jolt_atlas_tpu_torch.device import build
    t0 = time.time()
    with ThreadPoolExecutor(3) as ex:
        jobs = [ex.submit(build.host_library, "msm"),
                ex.submit(build.host_library, "frvec"),
                ex.submit(build.cuda_library_path)]
        for job in jobs:
            job.result()  # re-raises a failed build
    build.cuda_library()
    say("build", f"CUDA kernels and host engines built in "
        f"{time.time() - t0:.3f} s")
    from jolt_atlas_tpu_torch.device import kernel_report
    for name, r in sorted(kernel_report.parse_ptxas(
            build.ptxas_report()).items()):
        say("build", f"ptxas -v {name}: {r['registers']} registers, "
            f"{r['stack']} bytes stack frame, spill stores/loads "
            f"{r['spill_stores']}/{r['spill_loads']} bytes, "
            f"{r['smem']} bytes smem")
    say("build", "one fq_mul in SASS (cuobjdump): " + json.dumps(
        kernel_report.fq_mul_sass(build.CUDA_SRC)))
    from jolt_atlas_tpu_torch.device import rows as drows
    r = kernel_report.parse_ptxas(build.ptxas_report())["rows_points_kernel"]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    S = drows.DEFAULT_MAX_SLICES
    bench = drows.points_plan(27, 1 << 14, 6, S, sms)["smem"]
    say("build", f"kernel 7 (rows_points_kernel): {r['registers']} "
        f"registers, {r['smem']} bytes static smem; dynamic smem by its "
        f"launch plan: bench class (27 rows, {S} slices, n = 16,384, 6 "
        f"points) {bench} bytes, "
        f"96 rows at 20 points and 16 slices "
        f"{drows.points_plan(96, 64, 20, 16, sms, group=20)['smem']} bytes")
    ptx = kernel_report.parse_ptxas(build.ptxas_report())
    framed = {k: ptx[k]["stack"] for k in NO_STACK if ptx[k]["stack"]}
    if framed:
        raise AssertionError(f"stack frames (bytes) in {framed}")
    spilled = {k: (ptx[k]["spill_stores"], ptx[k]["spill_loads"])
               for k in NO_SPILL
               if ptx[k]["spill_stores"] or ptx[k]["spill_loads"]}
    if spilled:
        raise AssertionError(f"spills (store, load bytes) in {spilled}")
    toolkit = subprocess.run([build.nvcc_path(), "--version"], check=True,
                             capture_output=True,
                             text=True).stdout.split()[-1]
    if toolkit != KEPT_SASS[0]:
        say("build", f"nvcc {toolkit}: SASS digests not compared (recorded "
            f"with {KEPT_SASS[0]})")
        return
    sass = kernel_report.sass(build.CUDA_SRC)
    say("build", "SASS digests of the kernels not recorded in KEPT_SASS: "
        + json.dumps({k: v["digest"] for k, v in sorted(sass.items())
                      if k not in KEPT_SASS[1]}))
    moved = sorted(k for k, d in KEPT_SASS[1].items()
                   if sass.get(k, {}).get("digest") != d)
    if moved:
        raise AssertionError(f"SASS of {moved} differs from the recorded "
                             f"digests: {sass}")
    say("build", f"SASS of the {len(KEPT_SASS[1])} kernels of kernels 1-8 "
        f"and the BLAKE2b test kernel equal to the recorded digests (nvcc "
        f"{toolkit}); no stack frame in {', '.join(NO_STACK)}; no spill in "
        f"{', '.join(NO_SPILL)}")


def phase_pp_add(dev, bases, results) -> None:
    from jolt_atlas_tpu_torch.device import curve
    gen = torch.Generator(device="cpu").manual_seed(2024)
    n = 1 << 16
    i1 = torch.randint(0, bases[0].shape[0], (n,), generator=gen).to(dev)
    i2 = torch.randint(0, bases[0].shape[0], (n,), generator=gen).to(dev)
    P = tuple(b[i1] for b in bases)
    Q = tuple(b[i2] for b in bases)
    R1 = curve.pp_add(P, Q)                 # affine inputs (Z = 1)
    err = require_equal("pp_add", R1, curve.pp_add_plain(P, Q))
    R2 = curve.pp_add(R1, tuple(t.roll(1, 0) for t in R1))  # projective
    err = max(err, require_equal(
        "pp_add (projective inputs)", R2,
        curve.pp_add_plain(R1, tuple(t.roll(1, 0) for t in R1))))
    R3 = curve.pp_add(R1, R1)               # doubling of projective points
    err = max(err, require_equal("pp_add (doubling)", R3,
                                 curve.pp_add_plain(R1, R1)))
    Pe, Qe = curve.edge_case_pairs(dev)
    err = max(err, require_equal("pp_add (edge cases)", curve.pp_add(Pe, Qe),
                                 curve.pp_add_plain(Pe, Qe)))
    # the shape of the gate's calibration chain (2^17 lanes)
    m = 1 << 17
    X = tuple(t.repeat(2, 1)[:m] for t in R1)
    Y = tuple(t.roll(3, 0) for t in X)
    ms, call_ms, got = device_ms(lambda: curve.pp_add(X, Y), 20, "pp_add")
    plain_ms, want = cuda_ms(lambda: curve.pp_add_plain(X, Y), 1,
                             warmup=False)
    err = max(err, require_equal(f"pp_add ({m} lanes)", got, want))
    for lanes in (n, Pe[0].shape[0], m):
        checked(results, "pp_add", lanes)
    line = timed(results, "pp_add", f"{m} lanes", ms, m, m * 3 * POINT_BYTES,
                 call_ms=call_ms)
    results["pp_add"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         **results["timed"]["pp_add"][-1]}
    say("pp_add", f"bit-equal to the plain version on {n} random pairs, "
        f"their projective sums and doublings, {Pe[0].shape[0]} edge "
        f"cases and the {m} timed lanes; {line}; plain {plain_ms:.3f} ms")


def old_shape(c: int) -> tuple:
    """(W, 2^c lanes a window, top sub-lanes) of the unsigned digits of
    kernels 2 and 3 before their redesign."""
    W = (254 + c - 1) // c
    return W, 1 << c, (1 << c) >> (254 - (W - 1) * c)


def old_lane_work(lanes, c: int) -> tuple:
    """(entries, nonempty lanes) of the unsigned digits that the design
    before the redesign gave the same scalars: the signed digits read back
    from the lanes (point i = id - the least id), recomposed into unsigned
    c-bit windows."""
    from jolt_atlas_tpu_torch.device import msm as dmsm
    lane, pts, starts = (t.long() for t in lanes)
    E = int(starts[-1])
    W, B, S = dmsm.window_shape(c)
    lane, pts = lane[:E], pts[:E]
    pid = pts & (dmsm.SIGN_BIT - 1)
    i = pid - pid.min()
    n = int(i.max()) + 1
    w, j = lane // B, lane % B
    mag = torch.where(w == W - 1, j // S + 1, j + 1)
    d = torch.zeros((W, n), dtype=torch.int64, device=lane.device)
    d[w, i] = torch.where(pts < 0, -mag, mag)
    _, Bo, So = old_shape(c)
    idx = torch.arange(n, dtype=torch.int64, device=lane.device)
    carry, found = 0, []
    for ww in range(W):
        v = d[ww] + carry
        u = torch.remainder(v, Bo)
        carry = (v - u) >> c
        ln = ww * Bo + (u * So + idx % So if ww == W - 1 and So > 1 else u)
        found.append(ln[u != 0])
    found = torch.cat(found)
    return found.numel(), int(torch.unique(found).numel())


def accumulate_work(lanes, n: int, c: int) -> tuple:
    """((complete adds, bytes) of the design before the redesign on these
    scalars: a lane of d entries takes d - 1 adds, 96-byte bases; (32-bit
    multiplies, bytes) kernel 2 needs now: a mixed add an entry after the
    first of its lane, 64-byte bases). The entries and lane starts are
    read once, each base once, each bucket written once."""
    lane, _, starts = lanes
    L = starts.shape[0] - 1
    E = int(starts[L])
    nonempty = int((starts[1:] > starts[:-1]).sum())
    E_old, nonempty_old = old_lane_work(lanes, c)
    W, Bo, _ = old_shape(c)
    old = (E_old - nonempty_old, 8 * W * n + 4 * (W * Bo + 1)
           + n * POINT_BYTES + W * Bo * POINT_BYTES)
    design = ((E - nonempty) * IMADS_PER_MIXED, 8 * lane.shape[0]
              + 4 * (L + 1) + n * AFFINE_BYTES + L * POINT_BYTES)
    return old, design


def phase_bucket(dev, bases, results,
                 sizes=(1 << 16, 1 << 17, (1 << 18) - 3)) -> dict:
    """Kernel 2 (affine bases) against its plain version on the signed
    digit lanes of 4096 scalars at c = 6 with several run lengths, on a
    lane of the mixed add's edge cases, then on those of one MSM of each
    size in ``sizes`` at the window the device MSM picks for it (c = 12
    and 14: every window the driven paths use), each timed beside both
    bounds, and at 2^17 points also timed at runs of 8 and 32. Returns
    {c: the kernel's bucket sums} of the first MSM at each window."""
    from jolt_atlas_tpu_torch.device import msm as dmsm
    from jolt_atlas_tpu_torch.device.gate import random_scalars
    n, c = 4096, 6
    raw = random_scalars(n, 77)
    lanes = dmsm.digit_lanes(dmsm.scalars_tensor(raw, n, dev), c)
    err = 0.0
    main = 1 << 17 if 1 << 17 in sizes else sizes[-1]  # the kernels JSON's
    for run in (1, 5, dmsm.ACCUM_RUN, 64):
        err = max(err, require_equal(
            f"bucket_accumulate (c=6, run={run})",
            dmsm.bucket_accumulate(bases, lanes, run=run),
            dmsm.bucket_accumulate_plain(bases, lanes, run)))
        checked(results, "bucket_accumulate",
                dmsm.accumulate_class(lanes, run))
    # one lane A, -A (the identity), B, B (a doubling), -B, A, A
    sign = dmsm.SIGN_BIT
    edge = (torch.zeros(7, dtype=torch.int32, device=dev),
            torch.tensor([5, 5 - sign, 7, 7, 7 - sign, 5, 5],
                         dtype=torch.int32, device=dev),
            torch.tensor([0, 7], dtype=torch.int32, device=dev))
    for run in (1, 2, 3, 7):
        err = max(err, require_equal(
            f"bucket_accumulate (the mixed add's edges, run={run})",
            dmsm.bucket_accumulate(bases, edge, run=run),
            dmsm.bucket_accumulate_plain(bases, edge, run)))
        checked(results, "bucket_accumulate",
                dmsm.accumulate_class(edge, run))
    sums, shapes = {}, []
    for i, n in enumerate(sizes):
        c = dmsm._pick_c(n)
        raw = random_scalars(n, 78 + i)
        lanes = dmsm.digit_lanes(dmsm.scalars_tensor(raw, n, dev), c)
        ms, call_ms, got = device_ms(
            lambda: dmsm.bucket_accumulate(bases, lanes), 5,
            "bucket_accumulate")
        plain_ms, want = cuda_ms(
            lambda: dmsm.bucket_accumulate_plain(bases, lanes), 1,
            warmup=False)
        L = lanes[2].shape[0] - 1
        err = max(err, require_equal(
            f"bucket_accumulate (n={n}, c={c}, {L} lanes)", got, want))
        checked(results, "bucket_accumulate", dmsm.accumulate_class(lanes))
        sums.setdefault(c, got)
        (adds, nbytes), design = accumulate_work(lanes, n, c)
        shapes.append(timed(results, "bucket_accumulate",
                            f"n={n} c={c}", ms, adds, nbytes,
                            call_ms=call_ms, design=design)
                      + f", plain {plain_ms:.1f} ms")
        if n == main:
            results["bucket_accumulate"] = {
                "ms": ms, "plain_ms": plain_ms,
                **results["timed"]["bucket_accumulate"][-1]}
            for run in (8, 32):  # the run length against its neighbours
                rms, _, got = device_ms(lambda: dmsm.bucket_accumulate(
                    bases, lanes, run=run), 5, "bucket_accumulate")
                err = max(err, require_equal(
                    f"bucket_accumulate (n={n}, run={run})", got,
                    dmsm.bucket_accumulate_plain(bases, lanes, run)))
                shapes.append(f"run {run}: kernel {rms:.4f} ms")
    results["bucket_accumulate"]["max_abs_err"] = err
    say("bucket", f"bit-equal to the plain version on 4096 scalars at c=6 "
        f"(runs of 1, 5, {dmsm.ACCUM_RUN} and 64 entries), on the mixed "
        f"add's edges and at every timed shape, runs of {dmsm.ACCUM_RUN}; "
        + "; ".join(shapes))
    return sums


def combine_work(k: int, c: int) -> tuple:
    """(complete adds, bytes) the design before the redesign needed for k
    MSMs at window c: 2^c lanes a window, a running add per lane of
    weight >= 1 and a weighted add per weight; the bucket sums read once,
    the window sums written once."""
    W, B, S = old_shape(c)
    adds = k * (2 * (W - 1) * (B - 1) + (B - S) + (B // S - 1))
    return adds, k * W * (B + 1) * POINT_BYTES


def _tail_ops(n: int, q: int, S: int) -> tuple:
    """(adds, doublings) of csrc/combine.cu combine_tail over n threads:
    the suffix sums, two halving trees, thread 0's doublings and add."""
    scan = sum(n - d for d in (1 << i for i in range(n.bit_length() - 1)))
    return scan + 2 * (n - 1) + 1, max(q // S, 1).bit_length() - 1


def combine_design(k: int, c: int, G: int) -> tuple:
    """(32-bit multiplies, bytes) kernel 3 needs now for k MSMs at window
    c and G blocks a window: 2^(c-1) lanes a window, each thread's walk
    (a running add a lane and a weighted add a bucket start above its
    first, the first of each a copy), the blocks' and the groups' tails
    and the fold's doublings and adds; the bucket sums read once, one
    point an MSM written."""
    from jolt_atlas_tpu_torch.device import msm as dmsm
    W, B, s_top = dmsm.window_shape(c)
    T = dmsm.combine_threads(c)
    q = dmsm.combine_chunk(c, G)
    adds = dbls = 0
    for w in range(W):
        S = s_top if w == W - 1 else 1
        for u in range(G * T):
            lo, hi = min(u * q, B), min(u * q + q, B)
            if hi > lo:
                hits = len([j for j in range(lo, hi)
                            if j % S == 0 and j // S > lo // S])
                adds += hi - lo - 1 + max(hits - 1, 0)
        a, d = _tail_ops(T, q, S)
        adds, dbls = adds + G * a, dbls + G * d
        if G > 1:
            a, d = _tail_ops(G, T * q, S)
            adds, dbls = adds + a + 1, dbls + d
        else:
            adds += 1  # P + Z, in the fold
    adds, dbls = k * (adds + W - 1), k * (dbls + (W - 1) * c)
    return (adds * IMADS_PER_ADD + dbls * IMADS_PER_DOUBLE,
            k * W * B * POINT_BYTES + k * POINT_BYTES)


def random_bucket_sums(dev, bases, k: int, c: int, seed: int):
    """(k, W * 2^(c-1), 4) x 3 projective bucket sums: sums of two random
    bases (``bases`` projective), a fifth of them the identity (as empty
    lanes leave them), and the add's edge cases in windows 0 and 1."""
    from jolt_atlas_tpu_torch.device import curve, msm as dmsm
    W, B, _ = dmsm.window_shape(c)
    L = W * B
    gen = torch.Generator(device="cpu").manual_seed(seed)
    i1, i2 = (torch.randint(0, bases[0].shape[0], (k * L,), generator=gen)
              .to(dev) for _ in range(2))
    acc = curve.pp_add(tuple(b[i1] for b in bases),
                       tuple(b[i2] for b in bases))
    acc = tuple(t.reshape(k, L, 4).clone() for t in acc)
    ident = (torch.rand((k, L), generator=gen) < 0.2).to(dev)
    for a, o in zip(acc, curve.pp_identity(1, dev)):
        a[ident] = o[0]
    Pe, Qe = curve.edge_case_pairs(dev)
    m = Pe[0].shape[0]
    for a, p, q in zip(acc, Pe, Qe):
        a[:, 1:1 + m] = p
        a[:, B + 1:B + 1 + m] = q
    return acc


COMBINE_KERNELS = ("bucket_combine_kernel", "bucket_combine_groups",
                   "bucket_combine_fold")


def combine_split_ms(acc, c: int, G: int, reps: int = 3) -> dict:
    """Device ms of one kernel 3 call by its kernels (the walk, the
    blocks' combine, the fold), torch.profiler's durations: each kernel's
    mean over the launches the trace holds (once a call; a trace that
    missed some is taken again, twice at most)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from jolt_atlas_tpu_torch.device import msm as dmsm
    names = [k for k in COMBINE_KERNELS if G > 1 or "groups" not in k]
    dmsm.bucket_combine(acc, c, G)
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _profiler_pad()
            for _ in range(reps):
                dmsm.bucket_combine(acc, c, G)
            _profiler_pad()
        hits = {k: [e.time_range.elapsed_us() for e in prof.events()
                    if e.device_type == DeviceType.CUDA and k in e.name]
                for k in names}
        if all(len(v) == reps for v in hits.values()):
            break
    if not all(hits.values()):
        raise AssertionError(f"the profiler saw no launch of a kernel of "
                             f"kernel 3: {hits}")
    return {k: sum(v) / len(v) / 1e3 for k, v in hits.items()}


def phase_combine(dev, bases, results, sums: dict,
                  shapes=((1, 14), (16, 12), (17, 14))) -> None:
    """Kernel 3 and its fold against its plain version, each timed beside
    both bounds and split by its kernels, at the blocks per window the
    card's rule gives: one MSM's real bucket sums at each window of
    ``sums`` (phase_bucket's: k = 1 at c = 12 and 14), and random sums
    with identity buckets and the add's edge cases at each (k, c) of
    ``shapes``: the fold batch's two launches (one MSM at c = 14, 16 at
    c = 12) and 17 MSMs at c = 14, the fold batch at one window.
    ``bases`` projective."""
    from jolt_atlas_tpu_torch.device import msm as dmsm
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    err, lines = 0.0, []
    fold = {"ms": 0.0, "call": 0.0, "plain": 0.0, "adds": 0, "bytes": 0,
            "imads": 0, "dbytes": 0}
    cases = [(f"k=1 c={cc} real sums", tuple(a.unsqueeze(0) for a in acc),
              cc) for cc, acc in sorted(sums.items())]
    cases += [(f"k={k} c={c}", random_bucket_sums(dev, bases, k, c, 2025 + k),
               c) for k, c in shapes]
    for name, acc, c in cases:
        k = acc[0].shape[0]
        G = dmsm.combine_groups(k, c, sms)
        ms, call_ms, got = device_ms(
            lambda: dmsm.bucket_combine(acc, c, G), 5, "bucket_combine")
        plain_ms, want = cuda_ms(
            lambda: dmsm.bucket_combine_plain(acc, c, G), 1, warmup=False)
        err = max(err, require_equal(f"bucket_combine ({name}, G={G})", got,
                                     want))
        checked(results, "bucket_combine", (acc[0].shape[1], G))
        adds, nbytes = combine_work(k, c)
        design = combine_design(k, c, G)
        split = combine_split_ms(acc, c, G)
        lines.append(timed(results, "bucket_combine", f"{name} G={G}", ms,
                           adds, nbytes, call_ms=call_ms, design=design)
                     + f", plain {plain_ms:.1f} ms; by kernel " + ", ".join(
                         f"{n} {v:.4f}" for n, v in split.items()))
        results["timed"]["bucket_combine"][-1]["by_kernel_ms"] = split
        if name in ("k=1 c=14", "k=16 c=12"):  # the fold batch's launches
            for key, v in (("ms", ms), ("call", call_ms),
                           ("plain", plain_ms), ("adds", adds),
                           ("bytes", nbytes), ("imads", design[0]),
                           ("dbytes", design[1])):
                fold[key] += v
        del acc
    more, text = msm_bound(results, (fold["imads"], fold["dbytes"]),
                           (fold["adds"], fold["bytes"]), fold["ms"])
    results["bucket_combine"] = {
        "max_abs_err": err, "ms": fold["ms"], "call_ms": fold["call"],
        "plain_ms": fold["plain"],
        "shape": "fold batch: k=1 c=14 + k=16 c=12", **more}
    say("combine", f"bit-equal to the plain version at every shape; "
        + "; ".join(lines) + f"; fold batch in all: kernel "
        f"{fold['ms']:.4f} ms, " + text)


def _msm_stages(engine, raw: bytes, n: int) -> dict:
    """Milliseconds (host clock, synchronised after each stage) of the
    stages of one device MSM at the adaptive window: the scalars' upload,
    the signed digit lanes, kernel 2, kernel 3 with its window fold, and
    the affine conversion on the host; and the kernel launches of its
    combine. The caller keeps the minimum of a few runs: the host-side
    stages share a busy host."""
    from jolt_atlas_tpu_torch.device import msm as dmsm, telemetry
    c = dmsm._pick_c(n)
    out = {}
    t = time.perf_counter()

    def lap(name):
        nonlocal t
        torch.cuda.synchronize()
        now = time.perf_counter()
        out[name] = (now - t) * 1e3
        t = now

    sc = dmsm.scalars_tensor(raw, n, engine.device)
    lap("upload")
    lanes = dmsm.digit_lanes(sc, c, 0, engine.inf)
    lap("digit_lanes")
    acc = dmsm.bucket_accumulate(engine.bases, lanes)
    lap("bucket_accumulate")
    before = telemetry.launches()
    R = dmsm.bucket_combine(tuple(a.unsqueeze(0) for a in acc), c)
    lap("bucket_combine_and_fold")
    after = telemetry.launches()
    out["combine_launches"] = sum(after.values()) - sum(before.values())
    dmsm.affine_points(R)
    lap("affine")
    return out


def phase_msm(dev, srs, n: int = 1 << 17) -> None:
    from jolt_atlas_tpu_torch.device import gate, msm as dmsm, telemetry
    from jolt_atlas_tpu_torch.curve.native import pack_scalars
    from jolt_atlas_tpu_torch.field.constants import FR_MODULUS
    prep = srs.prepared_bases()
    rng = np.random.default_rng(1717)
    vals = [int.from_bytes(rng.bytes(32), "little") % FR_MODULUS
            for _ in range(n)]
    full = pack_scalars(vals)
    small = pack_scalars(rng.integers(0, 1 << 16, size=n))
    out = []
    # 16-bit scalars at c = 8 (every window's digits uniform) and at the
    # adaptive window, where the reference's grid refuses them as skewed
    # (a window straddling bit 16)
    for name, raw, c in (("254-bit", full, 0), ("16-bit", small, 8),
                         ("16-bit", small, 0)):
        engine = srs.device_bases(dev, gate.forced("device"), c=c)
        engine.msm_packed(raw, n)  # warm-up
        host_ms, dev_ms = [], []
        for _ in range(3):  # host and device in turns; finish() syncs
            t0 = time.perf_counter()
            want = prep.msm_packed(raw, n)
            t1 = time.perf_counter()
            got = engine.msm_packed(raw, n)
            t2 = time.perf_counter()
            if got != want:
                raise AssertionError(f"device MSM ({name}) differs from host")
            host_ms.append((t1 - t0) * 1e3)
            dev_ms.append((t2 - t1) * 1e3)
        out.append(f"{name} (c={c or dmsm._pick_c(n)}), median of 3: device "
                   f"{np.median(dev_ms):.3f} ms, host "
                   f"{np.median(host_ms):.3f} ms")
    engine = srs.device_bases(dev, gate.forced("device"))
    for m in (n, (1 << 18) - 3):
        raw = full if m == n else pack_scalars(
            [int.from_bytes(rng.bytes(32), "little") % FR_MODULUS
             for _ in range(m)])
        runs = [_msm_stages(engine, raw, m) for _ in range(3)]
        stages = {k: min(r[k] for r in runs) for k in runs[0]}
        out.append(f"stages at n={m} (min of 3, ms) " + ", ".join(
            f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in stages.items()))
    telemetry.reset()
    srs.device_bases(dev, gate.forced("device")).msm_packed(small, n,
                                                           site="16-bit")
    [(_, deepest, mean)] = telemetry.snapshot()["msm_depth"]["16-bit"]
    out.append(f"16-bit at the adaptive window on the card: deepest lane "
               f"{deepest} entries, mean {mean:.3f}")
    say("msm", f"n={n} equal to the host MSM; " + "; ".join(out))


def counted(results, required, fn):
    """Run one path of the port with the dispatch and launch counts set to
    0 and the decisions cleared just before it; read them just after, add
    the launches to the run's totals (results["launches"]) and their lane
    counts to results["lanes"], and fail if a kernel of the path was not
    launched. Returns (fn's result, the path's telemetry snapshot)."""
    from jolt_atlas_tpu_torch.device import telemetry
    telemetry.reset()
    out = fn()
    tele = telemetry.snapshot()
    for k in required:
        if not tele["launches"].get(k):
            raise AssertionError(f"kernel {k} not launched by its path: "
                                 f"{tele}")
    total = results.setdefault("launches", {})
    for k, v in tele["launches"].items():
        total[k] = total.get(k, 0) + v
    for k, v in tele["lanes"].items():
        results.setdefault("lanes", {}).setdefault(k, set()).update(v)
    return out, tele


def require_checked(results) -> None:
    """Fail unless every lane count at which a path launched a kernel is
    one at which the kernel was held against its plain version."""
    for k, lanes in results["lanes"].items():
        missed = lanes - results["checked_lanes"].get(k, set())
        if missed:
            raise AssertionError(
                f"{k} was launched by a path at {sorted(missed)} lanes, "
                f"where it was not held against its plain version "
                f"(checked: {sorted(results['checked_lanes'].get(k, []))})")


def bench_msm_sizes() -> list:
    """(site, points) of every MSM of the bench prove: 12 commits of 64
    and 4 of 16,384 points, the 17 folds 2^17 ... 2, the witness."""
    return ([("commit", 64), ("commit", 16384)]
            + [("fold", 1 << e) for e in range(17, 0, -1)]
            + [("witness", (1 << 18) - 3)])


def phase_gate(dev, results) -> None:
    """The calibration path: the gate measures this card and host and
    persists the result, which the prove phase then loads."""
    from jolt_atlas_tpu_torch.device import gate
    path = gate.cal_path(dev)
    t0 = time.time()
    g, tele = counted(results, ("pp_add", "bucket_accumulate",
                                "bucket_combine"),
                      lambda: gate.for_device(dev, remeasure=True))
    cal_s = time.time() - t0
    if not os.path.exists(path):
        raise AssertionError("the calibration was not persisted")
    fixed, rate = g.fit()
    plan = {f"{site} {n}": list(g.choose(n)[:2])
            for site, n in bench_msm_sizes()}
    folds = sum(1 << e for e in range(1, 18))
    say("gate", json.dumps({
        "calibration_s": cal_s, "pp_add_adds_per_s": g.cal[
            "pp_add_adds_per_s"],
        "host_msm_pps_2e18": g.cal["host_msm_pps"],
        "dev_msm_pps_2e16": g.cal["dev_msm_pps_16"],
        "dev_msm_pps_2e18": g.cal["dev_msm_pps"],
        "dev_msm_pps_2e21": g.cal["dev_msm_pps_21"],
        "dev_base_setup_s_per_pt": g.cal["dev_base_setup_sppt"],
        "fit_fixed_s": fixed, "fit_rate_pps": rate,
        "fit_above_2e18": list(g.fit(1 << 21)),
        "plan_flagship": {f"2^{e}": list(g.choose(1 << e)[:2])
                          for e in (21, 22, 23, 24)},
        "plan_route_ndev": plan,
        "fold_batch_on_device": g.engage(folds)[0],
        "why_64": g.choose(64)[2],
        "why_witness": g.choose((1 << 18) - 3)[2],
        "launches": tele["launches"]}))


def phase_split(dev, srs, results, n: int = (1 << 18) - 3,
                shares=(15, 16, 17)) -> None:
    """One MSM of the witness's size on the device alone, the host alone
    and split at each power-of-two share 2^15 .. 2^17, in turns."""
    from jolt_atlas_tpu_torch.device import gate, split
    from jolt_atlas_tpu_torch.device.gate import random_scalars
    prep = srs.prepared_bases()
    engine = srs.device_bases(dev, gate.forced("device"))
    raw = random_scalars(n, 1818)
    want = prep.msm_packed(raw, n)

    def run(n_dev):
        if n_dev == 0:
            return prep.msm_packed(raw, n)
        if n_dev == n:
            return engine.msm_packed(raw, n)
        return split.msm_packed_split(engine, prep, raw, n, n_dev, "split")

    configs = [("host", 0), ("device", n)] + [
        (f"split 2^{e}", 1 << e) for e in shares]
    for _, n_dev in configs:
        run(n_dev)  # warm-up

    def path():
        ms = {name: [] for name, _ in configs}
        for rep in range(3):
            for name, n_dev in (configs if rep % 2 == 0 else configs[::-1]):
                t0 = time.perf_counter()
                got = run(n_dev)
                ms[name].append((time.perf_counter() - t0) * 1e3)
                if got != want:
                    raise AssertionError(f"{name} MSM differs from the host")
        return ms

    ms, _ = counted(results, ("bucket_accumulate", "bucket_combine"), path)
    say("split", f"n={n}, every route equal to the host point; medians of "
        "3, alternated (ms): " + json.dumps(
            {k: float(np.median(v)) for k, v in ms.items()})
        + "; all runs: " + json.dumps(ms))


def trace_prove(prove) -> dict:
    """One prove under torch.profiler, CUDA activity only. The device's
    idle share is one minus the union of the device activity intervals
    over the prove's wall time (host clock, ending in a synchronise); also
    the device milliseconds and count of the busiest kernels by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prove()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans, per = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        ms, k = per.get(e.name, (0.0, 0))
        per[e.name] = (ms + e.time_range.elapsed_us() / 1e3, k + 1)
    if not spans:
        raise AssertionError("the profiler recorded no device activity")
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    top = sorted(per.items(), key=lambda kv: -kv[1][0])[:8]
    kernels = {}
    for kernel in ("bucket_accumulate", "bucket_combine") + REDUCTION + ROWS:
        hit = [v for name, v in per.items() if kernel in name]
        kernels[kernel] = {"ms": sum(ms for ms, _ in hit),
                           "n": sum(k for _, k in hit)}
    return {"wall_s": wall_us / 1e6, "device_busy_s": busy / 1e6,
            "idle_share": 1 - busy / wall_us, "kernels": kernels,
            "busiest": {name[:72]: {"ms": ms, "n": k}
                        for name, (ms, k) in top}}


def trace_split(dev, srs, n: int = (1 << 18) - 3,
                n_dev: int = 1 << 16) -> dict:
    """The steps of split.msm_packed_split, with CUDA events around the
    device suffix: its work must still be queued when start_split returns
    and done when the host prefix ends, i.e. the two ran at the same
    time."""
    from jolt_atlas_tpu_torch.device import gate, split
    from jolt_atlas_tpu_torch.device.gate import random_scalars
    prep = srs.prepared_bases()
    engine = srs.device_bases(dev, gate.forced("device"))
    raw = random_scalars(n, 1819)
    want = prep.msm_packed(raw, n)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a.record()
    st = split.start_split(engine, raw, n, n_dev, "trace")
    b.record()
    pending = not b.query()
    t1 = time.perf_counter()
    with split.host_threads(split.spare_threads()):
        host = prep.msm_packed(raw[:32 * st.k], st.k)
    done = b.query()
    t2 = time.perf_counter()
    got = split.finish_split(st, host)
    t3 = time.perf_counter()
    if got != want:
        raise AssertionError("traced split MSM differs from the host")
    out = {"n": n, "n_dev": n_dev, "start_ms": (t1 - t0) * 1e3,
           "host_prefix_ms": (t2 - t1) * 1e3,
           "finish_ms": (t3 - t2) * 1e3,
           "device_suffix_ms": a.elapsed_time(b),
           "device_pending_at_return": pending,
           "device_done_by_host_end": done}
    if not (pending and done):
        raise AssertionError(f"host prefix did not overlap the device: {out}")
    return out


REDUCTION = ("reduction_bind", "reduction_q0", "reduction_tail")
ROWS = ("rows_points", "rows_from_i64")
# the read-check engine's kernels (device/onehot.py, csrc/onehot.cu)
ONEHOT = ("onehot_prepare", "onehot_buckets", "onehot_round")
# the einsum bind engine's kernel (device/bind.py, csrc/bind.cu)
BIND = ("einsum_bind",)


@contextlib.contextmanager
def capture_reduction(store: dict):
    """Keep what the opening reduction of the proves inside starts from:
    the accumulator, the polynomials and a copy of the transcript."""
    from jolt_atlas_tpu_torch.poly.opening import ProverOpeningAccumulator
    real = ProverOpeningAccumulator.prove_batch_opening

    def keep(acc, poly_map, transcript, *args, **kw):
        store.update(acc=acc, poly_map=poly_map,
                     transcript=copy.deepcopy(transcript))
        return real(acc, poly_map, transcript, *args, **kw)

    ProverOpeningAccumulator.prove_batch_opening = keep
    try:
        yield store
    finally:
        ProverOpeningAccumulator.prove_batch_opening = real


def phase_prove(dev, srs, results, dims=(65, 64, 64, 4, 4)) -> tuple:
    """The bench prove on the gate, split and host paths; returns what its
    opening reduction starts from (capture_reduction) for phase 11 and its
    IOP's Gruen rows instances (capture_rows) for phase 12."""
    from jolt_atlas_tpu_torch import models, serde
    from jolt_atlas_tpu_torch.curve.points import g1_generator
    from jolt_atlas_tpu_torch.device import gate
    from jolt_atlas_tpu_torch.preprocessing import AtlasPreprocessing
    from jolt_atlas_tpu_torch.prover import AtlasProver
    from jolt_atlas_tpu_torch.utils import profiling
    from jolt_atlas_tpu_torch.verifier import AtlasVerifier
    vocab, seq, dim, blocks, heads = dims
    rng = np.random.default_rng(1234)
    model = models.build_nanogpt(vocab, seq, dim, blocks, 8, rng,
                                 heads=heads)
    toks = rng.integers(0, vocab, size=seq).astype(np.int32)
    t0 = time.time()
    pp = AtlasPreprocessing.preprocess(model)
    setup_s = time.time() - t0
    # base upload by the measured gate: set-up, outside the prove
    pp.srs.device_bases(dev)
    torch.cuda.synchronize()

    def prove(**how):
        profiling.enable()
        profiling.reset()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        proof, io = AtlasProver(pp, **how).prove([toks])
        torch.cuda.synchronize()
        wall = time.time() - t0
        phases = {name: round(w, 6) for name, w, _ in profiling.events()
                  if not name.startswith(" ")}
        phases.update({name.strip(): round(w, 6)
                       for name, w, _ in profiling.events()
                       if name.strip().startswith("reduction_")})
        # the rows engine's steps, summed over its instances
        phases.update({k: round(v, 6)
                       for k, v in span_sums("rows_").items()})
        return (proof, io, wall, phases,
                torch.cuda.max_memory_allocated() / 2**20)

    # the gate path is the prover's default: the card and its measured gate
    paths = [("gate", {}), ("split", {"device": dev,
                                      "msm_gate": gate.forced("split")}),
             ("host", {"device": "cpu"})]
    for _, how in paths[:2]:
        prove(**how)  # warm-up: first launches at each path's shapes
    out, blobs, cap, rows_cap = {}, {}, {}, []
    for name, how in paths:
        need = ("bucket_accumulate", "bucket_combine") + ROWS \
            + REDUCTION + ONEHOT + BIND if name != "host" else ()
        with (capture_reduction(cap) if name == "host"
              else contextlib.nullcontext()), (
                capture_rows(rows_cap) if name == "host"
                else contextlib.nullcontext()):
            (proof, io, wall, phases, peak), tele = counted(
                results, need, lambda: prove(**how))
        if name != "host":
            d = tele["dispatches"]
            for site in ("msm:hyperkzg_fold", "msm:hyperkzg_witness"):
                if not d.get(site):
                    raise AssertionError(f"{name}: no device MSM dispatch at "
                                         f"{site}: {tele}")
            if not tele["decisions"].get("reduction", "").startswith(
                    "ENGAGED"):
                raise AssertionError(f"{name}: the reduction engine did not "
                                     f"engage: {tele['decisions']}")
            if not tele["decisions"].get("iop", "").startswith("ENGAGED"):
                raise AssertionError(f"{name}: the IOP rows engine did not "
                                     f"engage: {tele['decisions']}")
        blobs[name] = serde.serialize_proof(proof)
        out[name] = {"prove_s": wall, "phases": phases,
                     "peak_device_MiB": peak, "telemetry": tele}
        if name == "gate":
            gate_proof, gate_io = proof, io
    blob = blobs["gate"]
    if any(b != blob for b in blobs.values()):
        raise AssertionError("proof bytes differ between the paths")
    verifier = AtlasVerifier(pp)
    t0 = time.time()
    if not verifier.verify(serde.deserialize_proof(blob), gate_io):
        raise AssertionError("verifier rejected the gate-path proof")
    verify_s = time.time() - t0
    bad = serde.deserialize_proof(blob)
    pid = sorted(bad.commitments)[0]
    bad.commitments[pid] = bad.commitments[pid] + g1_generator()
    if verifier.verify(bad, gate_io):
        raise AssertionError("verifier accepted a flipped commitment")
    say("prove", json.dumps({
        "model": f"nanogpt {blocks} blocks, {heads} heads, d{dim}, "
                 f"seq {seq}, vocab {vocab}",
        "setup_s": setup_s, "verify_s": verify_s, "proof_bytes": len(blob),
        "bytes_equal_all_paths": True, "tamper_rejected": True,
        "paths": out}))
    trace, tele = counted(
        results, ("bucket_accumulate", "bucket_combine") + ROWS + REDUCTION
        + ONEHOT + BIND,
        lambda: trace_prove(lambda: AtlasProver(pp).prove([toks])))
    results["launches_per_prove"] = tele["launches"]
    # what phase 13 proves again on the mesh, and the gate path beside it
    results["bench"] = {"pp": pp, "toks": toks, "blob": blob,
                        "gate": {k: out["gate"][k] for k in ("prove_s",
                                                             "phases")}}
    # kernel 7: one launch a device round, in telemetry and in the trace
    rounds = re.search(r"(\d+) device rounds", tele["decisions"]["iop"])
    k7 = (tele["launches"].get("rows_points", 0),
          trace["kernels"]["rows_points"]["n"])
    if rounds is None or k7 != (int(rounds.group(1)),) * 2:
        raise AssertionError(f"kernel 7 launched {k7} times (telemetry, "
                             f"trace) in a prove of "
                             f"{tele['decisions']['iop']}")
    overlap = trace_split(dev, srs)
    say("trace", "gate-path prove under torch.profiler: "
        + json.dumps(trace) + "; split MSM, host prefix against the device "
        "suffix: " + json.dumps(overlap))
    return cap, rows_cap


# ---------------------------------------------------------------------------
# phase 11: the opening reduction's kernels and engine
# ---------------------------------------------------------------------------

def reduction_instances(cap: dict, max_rounds=None):
    """Fresh, prepared opening-reduction instances of the captured prove
    (those of at most ``max_rounds`` rounds) and a copy of its transcript
    that has drawn their gamma powers."""
    from jolt_atlas_tpu_torch.poly.opening import (_GroupReductionProver,
                                                   _group_by_point)
    tr = copy.deepcopy(cap["transcript"])
    pending = cap["acc"].sorted_pending()
    gamma = tr.challenge_scalar_powers(len(pending))
    insts = [_GroupReductionProver(m, gamma)
             for m in _group_by_point(pending)]
    if max_rounds is not None:
        insts = [i for i in insts if i.num_rounds() <= max_rounds]
    for i in insts:
        i.prepare(cap["poly_map"])
    return insts, tr


def largest_round(nrs: list) -> tuple:
    """(round, continuing lanes, lanes, log2 lane size) of the round of a
    reduction over instances of these round counts whose buffer is
    largest."""
    top = max(nrs)
    rounds = []
    for r in range(top):
        lanes = sum(1 for n in nrs if top - n <= r)
        prev = sum(1 for n in nrs if top - n <= r - 1)
        rounds.append((lanes << (top - r), r, prev, lanes, top - r))
    _, r, prev, lanes, lg = max(rounds)
    return r, prev, lanes, lg


def tail_args(t: dict, joined: int) -> tuple:
    """kernel 6's arguments from random_tail's inputs, up to the state."""
    return (t["q0s"], joined, t["Q"], t["es"], t["qinit"], t["coeff"],
            t["l0"], t["l1"], t["inv_l1"], t["const_b0"])


def _check_tail(dev, gen, lanes: int, joined: int):
    """Kernel 6 against its plain version on random inputs (lane 0 with
    l1 = 0, lane 1 with l0 = 0, unjoined and zero-padding lanes): (max
    abs error, the inputs)."""
    from jolt_atlas_tpu_torch.device import reduction as dred
    d = dred.random_tail(dev, gen, lanes, joined)
    k = {n: t.clone() for n, t in d.items()}
    c = torch.empty((1, 4), dtype=torch.int64, device=dev)
    msg = torch.empty((2, 4), dtype=torch.int64, device=dev)
    args = lambda x: tail_args(x, joined)
    dred.tail(*args(k), k["state"], c, msg)
    want = dred.tail_plain(*args(d), d["state"])
    return require_equal(f"reduction_tail ({lanes} lanes, {joined} joined)",
                         (k["Q"], k["es"], k["state"], c, msg), want), d


def _reduction_run(cap, dev, engine: bool, max_rounds=None):
    """One opening reduction of the captured instances (of at most
    ``max_rounds`` rounds), by the engine (forced onto ``dev``) or by the
    host BatchedSumcheck: (ms, round polys, challenges, transcript state,
    final claims, the engine's steps)."""
    from jolt_atlas_tpu_torch.device import reduction as dred
    from jolt_atlas_tpu_torch.subprotocols.sumcheck import BatchedSumcheck
    from jolt_atlas_tpu_torch.utils import profiling
    insts, tr = reduction_instances(cap, max_rounds)
    profiling.enable()
    profiling.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if engine:
        proof, r = dred.try_prove(insts, cap["acc"], tr, dev, dred.forced(0))
    else:
        for i in insts:
            i.setup_sumcheck()
        proof, r = BatchedSumcheck.prove(insts, cap["acc"], tr)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    steps = {n.strip(): w * 1e3 for n, w, _ in profiling.events()}
    polys = [[x.v for x in cp.coeffs_except_linear_term]
             for cp in proof.compressed_polys]
    return (ms, polys, [x.v for x in r], tr.state,
            [i.final_poly_claim().v for i in insts], steps)


def bench_round_weights(insts, r: int, dev) -> tuple:
    """Kernel 5's weight table and lane parameters at round r of the
    engine's plan for these instances (their split-eq tables as the prove
    builds them; claims and coefficients do not enter them)."""
    from jolt_atlas_tpu_torch.device import reduction as dred
    from jolt_atlas_tpu_torch.field.scalar import Fr
    top = max(i.num_rounds() for i in insts)
    head = [k for k, i in enumerate(insts) if i.num_rounds() > 0]
    plan = dred.Plan(insts, head, [Fr.zero()] * len(insts),
                     [Fr.one()] * len(insts), top, top)
    _, _, (t0, t1), (p0, p1), _ = plan.rounds[r]
    return (torch.from_numpy(plan.elems[t0:t1]).to(dev),
            torch.from_numpy(plan.ints[p0:p1]).to(dev))


def q0_products(lanep, lg: int) -> int:
    """The fewest Fr products q(0) = sum_j whi[j >> shift] wlo[j & mask]
    lo[j] needs over these lanes of 2^lg: with both tables, one a term and
    one a row of the coarser factor (sum the other weight times lo over a
    row, then multiply once); with one table, one a row or wlo entry; with
    none, only adds."""
    from jolt_atlas_tpu_torch.device.reduction import ABSENT_SHIFT
    half, n = 1 << (lg - 1), 0
    for _, shift, _, mask in lanep.tolist():
        rows = max(half >> shift, 1) if shift < ABSENT_SHIFT else 0
        wlo = min(mask + 1, half) if mask else 0
        n += half + min(rows, wlo) if rows and wlo else rows + wlo
    return n


def q0_lazy_imads(lanep, lg: int, per: int = 8, threads: int = 256) -> int:
    """The 32-bit multiplies kernel 5's lazy design needs on these lanes
    of 2^lg, thread by thread as it lays the terms out (csrc/reduction.cu):
    a wide product (128) a term whose weight varies over the thread, and a
    Montgomery product (264) more where both weights vary; a reduction
    (136) a thread that multiplied; a Montgomery product a thread for each
    weight that is the same over its terms, where that table exists. A
    thread of a lane with no tables only adds."""
    from jolt_atlas_tpu_torch.device.reduction import ABSENT_SHIFT
    half, lper = 1 << (lg - 1), per.bit_length() - 1
    lthr = threads.bit_length() - 1
    tid = np.arange(threads)
    total = 0
    for _, shift, _, mask in lanep.tolist():
        sh = min(shift, 63)
        log_wlo = int(mask).bit_count()
        d = sh - lper
        kb = d if lthr > d >= 5 else lthr
        hfix, lfix = kb + lper <= sh, kb >= log_wlo
        has_hi, has_lo = shift < ABSENT_SHIFT, mask > 0
        j0 = (tid & ((1 << kb) - 1)) | ((tid >> kb) << (kb + lper))
        chunk = threads * per
        for part in range(-(-half // chunk)):
            j = (part * chunk) | j0[:, None] | (np.arange(per)[None] << kb)
            terms = (j < half).sum(1)
            live = int((terms > 0).sum())
            n = int(terms.sum())
            if not (hfix and lfix):
                total += n * 128 + live * 136
                if not (hfix or lfix):
                    total += n * IMADS_PER_MUL
            total += live * IMADS_PER_MUL * ((hfix and has_hi)
                                             + (lfix and has_lo))
    return total


def kernels_ms(fn, names: tuple, reps: int = 10) -> float:
    """Mean device milliseconds a call of fn() spends in the CUDA kernels
    named by ``names`` (telemetry names, found in the kernels' names), from
    torch.profiler's kernel durations between two pads: each kernel's mean
    duration times its launches, counted by its wrapper's telemetry (or,
    where fn calls a library directly and telemetry counts none, the
    launches the trace holds), as device_ms does. fn() runs once before,
    untraced."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from jolt_atlas_tpu_torch.device import telemetry
    fn()
    before = telemetry.launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _profiler_pad()
        for _ in range(reps):
            fn()
        _profiler_pad()
    after = telemetry.launches()
    total = 0.0
    for name in names:
        hits = [e.time_range.elapsed_us() for e in prof.events()
                if e.device_type == DeviceType.CUDA and name in e.name]
        launched = after.get(name, 0) - before.get(name, 0) or len(hits)
        if not hits or launched < reps:
            raise AssertionError(f"the profiler saw {len(hits)} launches of "
                                 f"{name} in {reps} calls")
        total += sum(hits) / len(hits) * launched
    return total / 1e3 / reps


Q0_WORST = {"limbs": "every factor with limbs r - 1",
            "mont": "every factor r - 1"}


def q0_worst_rows() -> dict:
    """Kernel 5's worst factors as one (1, 4) limb row each (Q0_WORST):
    limbs r - 1 (the value (r - 1) R^-1) and the Montgomery form of
    r - 1."""
    from jolt_atlas_tpu_torch.device import reduction as dred
    top = dred.FR_MODULUS - 1
    return {"limbs": dred.mont_rows([top * dred.FR_R_INV % dred.FR_MODULUS]),
            "mont": dred.mont_rows([top])}


def tail_latency_bound(results) -> dict:
    """Kernel 6's latency bound: the longest dependent chain of its serial
    work a round (kernel_report.tail_path_chain: one lane's message terms,
    a canonical conversion, the long absorb and the squeeze, the challenge,
    one lane's update; not the block sums nor the loads' latency), counted
    from SASS, times the integer pipe's dependent-issue latency measured on
    this card (kernel_report.int_latency), over the card's maximum SM
    clock."""
    from jolt_atlas_tpu_torch.device import build, kernel_report
    path = kernel_report.tail_path_chain(build.CUDA_SRC)
    lat = kernel_report.int_latency()
    mhz = results["imad_peak"] / (
        64 * torch.cuda.get_device_properties(0).multi_processor_count * 1e6)
    return {**path, "latency_cycles": lat, "sm_mhz": mhz,
            "ms": path["chain"] * lat["per_instruction"] / (mhz * 1e3)}


def phase_reduction(dev, results, cap, tail_shapes=((8, 5), (2, 0),
                                                    (256, 175), (256, 256),
                                                    (640, 600), (385, 385)),
                    b2_n=4096, long_lg=21) -> None:
    """Kernels 4-6 and the BLAKE2b test kernel against their plain versions
    at small shapes and at the edges, bit for bit, and the test kernel
    against hashlib; kernels 4 and 5 timed at the largest round of the
    bench's reduction, kernel 6 at its lanes, beside their bounds; the
    engine against the host BatchedSumcheck on the bench's own instances,
    in turns."""
    from jolt_atlas_tpu_torch.device import blake2b as db
    from jolt_atlas_tpu_torch.device import reduction as dred
    gen = np.random.default_rng(4040)
    err = {k: 0.0 for k in REDUCTION + ("blake2b_transcript",)}
    # -- small shapes: a first round, late joiners, a pure bind, lanes of
    # several q0 blocks (2^14: with a table of 1024 rows, every weight
    # layout of kernel 5) and of one element's half
    for jp, lanes, lg, table in ((0, 3, 4, 64), (2, 5, 3, 64), (4, 4, 2, 64),
                                 (3, 3, 14, 64), (0, 12, 14, 1024),
                                 (1, 2, 1, 64)):
        d = dred.random_round(dev, gen, jp, lanes, lg, table)
        args = (d["buf"], d["init"], d["c"], d["init_off"], jp, lanes, lg)
        out = dred.bind(*args)
        err["reduction_bind"] = max(err["reduction_bind"], require_equal(
            f"reduction_bind ({jp}/{lanes} lanes, 2^{lg})", [out],
            [dred.bind_plain(*args)]))
        checked(results, "reduction_bind", dred.bind_case(jp, lanes))
        qa = (out, d["tab"], d["lanep"], lanes, lg)
        err["reduction_q0"] = max(err["reduction_q0"], require_equal(
            f"reduction_q0 ({lanes} lanes, 2^{lg})", [dred.q0(*qa)],
            [dred.q0_plain(*qa)]))
        checked(results, "reduction_q0", dred.q0_case(lg))
    # kernel 5's lazy sum at its worst case, every lo and every table row
    # with limbs r - 1 (a thread's 16 wide products near 16 r^2), and at
    # the Montgomery form of r - 1 (limbs ~0.71 r); 6 lanes of 2^14 (every
    # weight layout, every thread 16 terms) and lanes of 2^long_lg
    # (2^(long_lg - 13) partials a lane for the fold), random and worst
    for lanes, lg, worst in ((6, 14, "limbs"), (6, 14, "mont"),
                             (1, long_lg, None), (2, long_lg, "limbs"),
                             (2, long_lg, "mont")):
        d = dred.random_round(dev, gen, 0, lanes, lg)
        buf, tab = d["init"][:lanes << lg], d["tab"]
        if worst:
            top = torch.from_numpy(q0_worst_rows()[worst]).to(dev)
            buf = top.expand(lanes << lg, 4).contiguous()
            tab = top.expand(tab.shape[0], 4).contiguous()
        qa = (buf, tab, d["lanep"], lanes, lg)
        want = dred.q0_plain(*qa)
        for _ in range(2):  # the lane counters are back at 0
            err["reduction_q0"] = max(err["reduction_q0"], require_equal(
                f"reduction_q0 ({lanes} lanes, 2^{lg}, "
                f"{Q0_WORST.get(worst, 'random')})",
                [dred.q0(*qa)], [want]))
        checked(results, "reduction_q0", dred.q0_case(lg))
        del d, buf, tab, qa, want
    for lanes, joined in tail_shapes:
        e, _ = _check_tail(dev, gen, lanes, joined)
        err["reduction_tail"] = max(err["reduction_tail"], e)
        checked(results, "reduction_tail", lanes)
    hashed = 0
    for npw in (0, 4, 9, 16, 17):
        n = 257
        raw, pay = gen.bytes(32 * n), gen.bytes(8 * npw * n)
        nr = gen.integers(0, 1 << 32, size=n)
        st = torch.from_numpy(db.bytes_to_words(raw).reshape(n, 4)).to(dev)
        rd = torch.from_numpy(nr.astype(np.int64)).to(dev)
        pl = torch.from_numpy(db.bytes_to_words(pay).reshape(n, npw)).to(dev)
        got = db.transcript_step(st, rd, pl)
        err["blake2b_transcript"] = max(
            err["blake2b_transcript"], require_equal(
                f"blake2b_transcript ({npw} words)", [got],
                [db.transcript_absorb_long_plain(st, rd, pl)]))
        out = got.cpu().numpy()
        for i in range(n):
            msg = (raw[32 * i:32 * i + 32] + b"\x00" * 28
                   + int(nr[i]).to_bytes(4, "big")
                   + pay[8 * npw * i:8 * npw * (i + 1)])
            if db.words_to_bytes(out[i]) != hashlib.blake2b(
                    msg, digest_size=32).digest():
                raise AssertionError(f"blake2b_transcript differs from "
                                     f"hashlib ({npw} words, row {i})")
            hashed += 1
    lines = [f"bit-equal to the plain versions at 6 round shapes, kernel "
             f"5 at every factor with limbs r - 1 and at every factor r - 1 "
             f"(2^14, 2^{long_lg}) and at a random lane of 2^{long_lg}, "
             f"twice each, {len(tail_shapes)} tail "
             f"shapes and 5 transcript lengths; "
             f"{hashed} digests equal hashlib's"]

    # -- timed at the bench's largest round, q0 on that round's own tables
    insts, _ = reduction_instances(cap)
    nrs = [i.num_rounds() for i in insts]
    total = sum(1 << n for n in nrs)
    r, jp, lanes, lg = largest_round(nrs)
    tab, lanep = bench_round_weights(insts, r, dev)
    del insts
    d = dred.random_round(dev, gen, jp, lanes, lg)
    args = (d["buf"], d["init"], d["c"], d["init_off"], jp, lanes, lg)
    ms, call_ms, out = device_ms(lambda: dred.bind(*args), 5,
                                 "reduction_bind")
    plain_ms, want = cuda_ms(lambda: dred.bind_plain(*args), 1, warmup=False)
    err["reduction_bind"] = max(err["reduction_bind"], require_equal(
        "reduction_bind (bench round)", [out], [want]))
    del want
    nc, nn = jp << lg, (lanes - jp) << lg
    shape = f"round {r}: {jp} of {lanes} lanes continue, 2^{lg} each"
    lines.append("bind " + timed(results, "reduction_bind", shape, ms, nc,
                                 (3 * nc + 2 * nn) * FR_BYTES,
                                 IMADS_PER_MUL, call_ms)
                 + f", plain {plain_ms:.1f} ms")
    results["reduction_bind"] = {"ms": ms, "plain_ms": plain_ms,
                                 **results["timed"]["reduction_bind"][-1]}
    qa = (out, tab, lanep, lanes, lg)
    ms, call_ms, part = device_ms(lambda: dred.q0(*qa), 5, "reduction_q0")
    plain_ms, want = cuda_ms(lambda: dred.q0_plain(*qa), 1, warmup=False)
    err["reduction_q0"] = max(err["reduction_q0"], require_equal(
        "reduction_q0 (bench round)", [part], [want]))
    terms = lanes << (lg - 1)
    nbytes = (terms + tab.shape[0] + part.shape[0] + lanes) * FR_BYTES
    lazy = q0_lazy_imads(lanep.cpu(), lg, dred.Q0_PER_THREAD)
    lines.append("q0 " + timed(
        results, "reduction_q0", f"round {r}: {lanes} lanes of 2^{lg}, its "
        f"split-eq tables", ms, lazy, nbytes, 1, call_ms)
        + f" ({lazy} IMAD as it sums lazily), plain {plain_ms:.1f} ms")
    products = q0_products(lanep.cpu(), lg)
    mb, mby = bound(products, nbytes, results["imad_peak"], IMADS_PER_MUL)
    lines.append(f"q0 against a Montgomery product a term ({products} "
                 f"products of {IMADS_PER_MUL} IMAD): bound {mb:.4f} ms "
                 f"({mby}), share {mb / ms:.3f}")
    results["reduction_q0"] = {"ms": ms, "plain_ms": plain_ms,
                               **results["timed"]["reduction_q0"][-1],
                               "bound_montgomery_ms": mb,
                               "bound_montgomery_by": mby,
                               "share_montgomery": mb / ms}
    del d, out, part, want, args, qa, tab, lanep
    L = max(1 << (len(nrs) - 1).bit_length(), 2)
    J = len(nrs)
    e, t = _check_tail(dev, gen, L, J)
    err["reduction_tail"] = max(err["reduction_tail"], e)
    checked(results, "reduction_tail", L)
    c = torch.empty((1, 4), dtype=torch.int64, device=dev)
    msg = torch.empty((2, 4), dtype=torch.int64, device=dev)
    targs = tail_args(t, J) + (t["state"],)
    ms, call_ms, _ = device_ms(lambda: dred.tail(*targs, c, msg), 20,
                               "reduction_tail")
    plain_ms, _ = cuda_ms(lambda: dred.tail_plain(*targs), 1, warmup=False)
    lines.append("tail " + timed(
        results, "reduction_tail", f"{L} lanes, {J} joined", ms, 10 * J + 3,
        (J + 8 * L + 4) * FR_BYTES, IMADS_PER_MUL, call_ms)
        + f", plain {plain_ms:.1f} ms")
    lat = tail_latency_bound(results)
    row = results["timed"]["reduction_tail"][-1]
    row.update(bound_latency_ms=lat["ms"], share_latency=lat["ms"] / ms,
               latency=lat)
    lines.append(f"tail latency bound (beside the throughput bound above): "
                 f"{lat['chain']} dependent "
                 f"instructions of {lat['instructions']} ({lat['branches']} "
                 f"branches) x {lat['latency_cycles']['per_instruction']:.2f}"
                 f" cycles at {lat['sm_mhz']:.0f} MHz = {lat['ms']:.5f} ms, "
                 f"share {lat['ms'] / ms:.3f}")
    results["reduction_tail"] = {"ms": ms, "plain_ms": plain_ms, **row}
    # -- kernels 5 and 6 as a pair at the bench's round 0, on its tables
    insts, _ = reduction_instances(cap)
    joined0 = sum(1 for n in nrs if n == max(nrs))
    tab0, lanep0 = bench_round_weights(insts, 0, dev)
    del insts
    d0 = dred.random_round(dev, gen, 0, joined0, max(nrs))
    buf0 = d0["init"][:joined0 << max(nrs)]
    q0a = (buf0, tab0, lanep0, joined0, max(nrs))
    err["reduction_q0"] = max(err["reduction_q0"], require_equal(
        "reduction_q0 (bench round 0)", [dred.q0(*q0a)],
        [dred.q0_plain(*q0a)]))
    t0 = dred.random_tail(dev, gen, L, joined0)

    def pair():
        t0["q0s"] = dred.q0(*q0a)
        dred.tail(*tail_args(t0, joined0), t0["state"], c, msg)
    pms = kernels_ms(pair, ("reduction_q0", "reduction_tail"))
    pcall, _ = cuda_ms(pair, 10)
    results["reduction_pair"] = {
        "shape": f"round 0: {joined0} lanes of 2^{max(nrs)}, its split-eq "
                 f"tables; tail over {L} lanes", "ms": pms,
        "call_ms": pcall}
    lines.append(f"q0 + tail at round 0 ({joined0} lanes of 2^{max(nrs)}, "
                 f"tail over {L} lanes): {pms:.4f} ms on the device (a call "
                 f"{pcall:.4f} ms)")
    del d0, buf0, q0a, t0, tab0, lanep0
    st = torch.from_numpy(db.bytes_to_words(gen.bytes(32 * b2_n)).reshape(
        b2_n, 4)).to(dev)
    rd = torch.arange(b2_n, dtype=torch.int64, device=dev)
    pl = torch.from_numpy(db.bytes_to_words(gen.bytes(72 * b2_n)).reshape(
        b2_n, 9)).to(dev)
    ms, call_ms, got = device_ms(lambda: db.transcript_step(st, rd, pl), 20,
                                 "blake2b_transcript")
    plain_ms, want = cuda_ms(lambda: db.transcript_absorb_long_plain(
        st, rd, pl), 1, warmup=False)
    err["blake2b_transcript"] = max(err["blake2b_transcript"], require_equal(
        "blake2b_transcript (timed)", [got], [want]))
    lines.append("blake2b_transcript " + timed(
        results, "blake2b_transcript", f"{b2_n} round-message absorbs (9 "
        "words, 2 compressions)", ms, b2_n * 2 * B2_OPS_PER_COMPRESS,
        b2_n * (32 + 8 + 72 + 32), 1, call_ms) + f", plain {plain_ms:.1f} ms")
    results["blake2b_transcript"] = {
        "ms": ms, "plain_ms": plain_ms,
        **results["timed"]["blake2b_transcript"][-1]}
    for k, v in err.items():
        results[k]["max_abs_err"] = v
    say("reduction", "; ".join(lines))

    # -- the engine against the host sumcheck, in turns
    report = {"instances": len(nrs), "elements": total}
    runs = {"engine": [], "host": []}
    for which in ("engine", "host", "host", "engine"):
        if which == "engine" and not runs["engine"]:
            torch.cuda.reset_peak_memory_stats()
        runs[which].append(_reduction_run(cap, dev, which == "engine"))
        if which == "engine" and len(runs["engine"]) == 1:
            report["engine_peak_device_MiB"] = \
                torch.cuda.max_memory_allocated() / 2**20
    first = runs["host"][0][1:5]
    for name, rs in runs.items():
        for got in rs:
            if got[1:5] != first:
                raise AssertionError(
                    f"reduction ({name}) differs from the host: messages, "
                    "challenges, transcript state or final claims")
    report.update({"engine_ms": [g[0] for g in runs["engine"]],
                   "host_ms": [g[0] for g in runs["host"]],
                   "engine_steps_ms": runs["engine"][-1][5]})
    say("reduction", "engine against the host BatchedSumcheck on the bench's "
        "instances (engine, host, host, engine; messages, challenges, "
        "transcript state and final claims equal): " + json.dumps(report))



# ---------------------------------------------------------------------------
# phase 12: the IOP rows engine's kernel and engine
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def capture_rows(store: list):
    """Keep the IOP's Gruen rows instances of the proves inside: each
    RowsInstance.setup_rows call with an eq point, outside the opening
    reduction, as a copy of its rows (their small integers or field
    vector), its terms, degree and eq layout."""
    from jolt_atlas_tpu_torch.poly.opening import _GroupReductionProver
    from jolt_atlas_tpu_torch.subprotocols.sumcheck import RowsInstance
    real = RowsInstance.setup_rows

    def keep(self, mlpolys, terms, degree, eq_r=None, eq_pre=0, eq_post=0):
        if (eq_r is not None and mlpolys
                and not isinstance(self, _GroupReductionProver)):
            store.append({
                "rows": [("ints", p.ints.copy()) if p.is_small()
                         else ("field", p.to_field().d.copy())
                         for p in mlpolys],
                "terms": [(c, list(f)) for c, f in terms],
                "degree": degree, "eq": (list(eq_r), eq_pre, eq_post)})
        return real(self, mlpolys, terms, degree, eq_r, eq_pre, eq_post)

    RowsInstance.setup_rows = keep
    try:
        yield store
    finally:
        RowsInstance.setup_rows = real


def rows_class(inst) -> tuple:
    """(P rows, degree, terms, most factors) of a captured instance."""
    return (len(inst["rows"]), inst["degree"], len(inst["terms"]),
            max([len(f) for _, f in inst["terms"]] + [0]))


def rows_n(inst) -> int:
    return len(inst["rows"][0][1])


def rows_eligible(inst, gate) -> bool:
    P, n = len(inst["rows"]), rows_n(inst)
    return gate.decline(P, n, inst["degree"], sum(
        len(f) for _, f in inst["terms"])) is None


def span_sums(prefix: str) -> dict:
    """Seconds of the recorded profiling spans named ``prefix``...,
    summed by name."""
    from jolt_atlas_tpu_torch.utils import profiling
    out: dict = {}
    for name, w, _ in profiling.events():
        name = name.strip()
        if name.startswith(prefix):
            out[name] = out.get(name, 0.0) + w
    return out


def rows_run(inst, dev=None, gate=None) -> dict:
    """Every round of one captured instance alone, by the engine (under an
    rows Scope of ``dev`` and ``gate``) or, without ``dev``, by the host
    GruenInstance, on fresh copies of its rows, at challenges from a fixed
    seed: its ms (host clock; the first two rounds apart), round messages,
    final row values and the engine's steps (ms by span)."""
    from jolt_atlas_tpu_torch.device import rows as drows
    from jolt_atlas_tpu_torch.field.frvec import FrArray
    from jolt_atlas_tpu_torch.field.scalar import Fr
    from jolt_atlas_tpu_torch.poly.mlpoly import MLPoly
    from jolt_atlas_tpu_torch.subprotocols.sumcheck import RowsInstance
    from jolt_atlas_tpu_torch.utils import profiling
    polys = [MLPoly(ints=a) if kind == "ints" else MLPoly(fvec=FrArray(a))
             for kind, a in inst["rows"]]
    eq_r, pre, post = inst["eq"]
    P, n = len(polys), len(polys[0])
    gen = np.random.default_rng(n + 7 * P)
    chal = [Fr(int(gen.integers(1, 1 << 62))) for _ in range(n.bit_length()
                                                             - 1)]
    profiling.enable()
    profiling.reset()
    r = RowsInstance()
    t0 = time.perf_counter()
    with (drows.Scope(dev, gate) if dev is not None
          else contextlib.nullcontext()):
        r.setup_rows(polys, inst["terms"], inst["degree"], eq_r, pre, post)
    engaged = isinstance(r._gruen, drows.DeviceGruen)
    claim, msgs, head_ms = Fr(1), [], None
    for k, c in enumerate(chal):
        poly = r.rows_message(claim)
        msgs.append([x.v for x in poly.compress().coeffs_except_linear_term])
        claim = poly.evaluate(c)
        r.rows_bind(c)
        if k == 1:
            head_ms = (time.perf_counter() - t0) * 1e3
    finals = [r.row_final(i).v for i in range(P)]
    ms = (time.perf_counter() - t0) * 1e3
    steps = {k: v * 1e3 for k, v in span_sums("rows_").items()}
    return {"ms": ms, "head_ms": head_ms if head_ms is not None else ms,
            "msgs": msgs, "finals": finals, "steps": steps,
            "engaged": engaged}


# the factor lists of the bench nanoGPT's largest rows class (27 rows, 36
# terms): two 5-factor heads, each times 8 rows and alone, and 18 linear
# terms; True where the coefficient is one
_HEADS = {"A": [22, 23, 20, 21, 7], "B": [2, 3, 0, 1, 5]}
BENCH_TERMS = ([(True, ["A", 8]), (True, ["B", 8])]
               + [(False, [h, f]) for f in (9, 12, 13, 14, 15, 16, 17)
                  for h in "AB"]
               + [(False, ["B"]), (False, [6]), (False, ["A"])]
               + [(False, [f]) for f in (4, 26, 8, 9, 12, 13, 14, 15, 16,
                                         17, 18, 19, 10, 11, 4, 24, 25)])


def bench_terms(gen: np.random.Generator) -> list:
    """BENCH_TERMS with random coefficients where not one."""
    from jolt_atlas_tpu_torch.field.constants import FR_MODULUS
    from jolt_atlas_tpu_torch.field.scalar import Fr
    out = []
    for one, f in BENCH_TERMS:
        rows = [i for g in f for i in (_HEADS[g] if g in _HEADS else [g])]
        out.append((Fr.one() if one else Fr(int.from_bytes(
            gen.bytes(32), "little") % FR_MODULUS), rows))
    return out


def rows_products(x, n: int, nevals: int, terms, w) -> tuple:
    """(products this run's data needs as kernel 7 evaluates the terms,
    term by term, term by term with no zero skipped) of kernel 7's
    function. A product chain costs a product for each further factor while
    it is nonzero and one by a coefficient other than one where it is
    nonzero. Kernel 7 evaluates the terms by their groups (Terms.groups):
    the head's chain, on pairs where it is nonzero each member's tail
    chain, and the head times the members' sum where that is nonzero (an
    exact cancellation inside the sum is not looked for). The weight
    factors out by table (sum_h whi[h] sum_{j in h} wlo[j] s(j)), so per
    point one product by wlo on each pair whose term sum s(j) is nonzero
    and one by whi for each whi row such a pair reaches."""
    from jolt_atlas_tpu_torch.device import rows as drows
    from jolt_atlas_tpu_torch.field.constants import FR_MODULUS, FR_R
    one = FR_R % FR_MODULUS
    coeff = [int.from_bytes(r.astype("<u8").tobytes(), "little")
             for r in terms.coeffs.cpu().numpy()]
    half = n // 2
    _, _, whi_n, whi_shift, _, log_wlo = w
    hrow = ((torch.arange(half, device=x.device) >> min(whi_shift, 63))
            & (whi_n - 1))
    lo_w, hi_w = log_wlo >= 0, whi_n > 1
    dense = sum(max(len(f) - 1, 0) + (bool(f) and c != one)
                for f, c in zip(terms.factors, coeff))
    need = direct = 0
    for E, inner in drows.term_sums(x, n, nevals, terms):
        nz = (E != 0).any(0)

        def chain(f, c, run):
            """(products, pairs where the chain is nonzero) from ``run``."""
            k, run = 0, run & nz[f[0]]
            for g in f[1:]:
                k += int(run.sum())
                run = run & nz[g]
            return k + (c != one) * int(run.sum()), run
        every = torch.ones(half, dtype=torch.bool, device=x.device)
        for f, c in zip(terms.factors, coeff):
            if f:
                direct += chain(f, c, every)[0]
        for head, mem in terms.groups:
            k, hl = chain(head, one, every) if head else (0, every)
            need += k
            live = torch.zeros_like(every)
            for t, tail in mem:
                if tail:
                    k, run = chain(tail, coeff[t], hl)
                    need += k
                    live |= run
                elif coeff[t]:
                    live |= hl
            if head:
                need += int(live.sum())
        live = (inner != 0).any(0)
        weight = lo_w * int(live.sum()) + hi_w * int(
            torch.unique(hrow[live]).numel())
        need += weight
        direct += weight
    return need, direct, nevals * (half * (dense + lo_w) + hi_w * int(
        torch.unique(hrow).numel()))


def message_nevals(se, rnd: int, degree: int) -> int:
    """The points RowsInstance._gruen_message asks for in round rnd."""
    lin = se.l_linear(rnd)
    if lin is None:
        return max(1, degree)
    dq = max(1, degree - 1)
    return dq + 1 if lin[1].is_zero() else dq


ROWS_STEPS = ("rows_upload", "rows_points", "rows_bind",
              "rows_handoff")  # the engine's profiling spans


def rows_passes(insts, dev, gate, order=("engine", "host", "host",
                                          "engine")) -> dict:
    """Each instance's rounds by the engine and by the host, a pass over
    all of them at a time in ``order``; raises unless every pass's round
    messages and final row values equal the first host pass's. Returns
    {"engine": [pass, ...], "host": [...]}, a pass a list of rows_run
    results."""
    runs = {"engine": [], "host": []}
    for which in order:
        runs[which].append([rows_run(i, dev if which == "engine" else None,
                                     gate) for i in insts])
    want = [(r["msgs"], r["finals"]) for r in runs["host"][0]]
    for which, passes in runs.items():
        for ps in passes:
            for k, (r, w) in enumerate(zip(ps, want)):
                if (r["msgs"], r["finals"]) != w:
                    raise AssertionError(
                        f"rows engine ({which}) differs from the host on "
                        f"instance {k} {rows_class(insts[k])}, n = "
                        f"{rows_n(insts[k])}")
            if which == "engine" and not all(r["engaged"] for r in ps):
                raise AssertionError("the rows engine declined an instance")
    return runs


def rows_report(insts, runs) -> dict:
    """Per instance class (P, degree, terms, most factors): count, sizes,
    the host's ms (all rounds and the first two; mean of its passes) and
    the engine's, split into its steps and the host rounds after the
    handoff (mean of its passes)."""
    out = {}
    nh, ne = len(runs["host"]), len(runs["engine"])
    for k, inst in enumerate(insts):
        row = out.setdefault(str(rows_class(inst)), {
            "count": 0, "n": [], "host_ms": 0.0, "host_first2_ms": 0.0,
            "engine_ms": 0.0, **{s: 0.0 for s in ROWS_STEPS}})
        row["count"] += 1
        if rows_n(inst) not in row["n"]:
            row["n"].append(rows_n(inst))
        for ps in runs["host"]:
            row["host_ms"] += ps[k]["ms"] / nh
            row["host_first2_ms"] += ps[k]["head_ms"] / nh
        for ps in runs["engine"]:
            row["engine_ms"] += ps[k]["ms"] / ne
            for s in ROWS_STEPS:
                row[s] += ps[k]["steps"].get(s, 0.0) / ne
    for row in out.values():
        row["engine_host_rounds"] = row["engine_ms"] - sum(
            row[s] for s in ROWS_STEPS)
    return out


def phase_rows(dev, results, rows_cap,
               shapes=((1, 4, 1, 1), (1, 256, 2, 2), (2, 512, 4, 3),
                       (27, 256, 36, 6), (96, 64, 8, 5)),
               evals=(1, 2, 6, 20),
               bind_shapes=((1, 2), (2, 256), (27, 16384), (96, 64)),
               i64_sizes=(1, 500, 1 << 18)) -> None:
    """Kernel 7 against its plain version at every shape of ``shapes`` (P,
    n, terms, most factors) and point count of ``evals``, on every weight
    layout; kernel 4 in the rows layout; kernel 7 timed on the bench's
    largest instance class; the engine against the host on the bench's
    own instances, in turns."""
    from jolt_atlas_tpu_torch.device import reduction as dred
    from jolt_atlas_tpu_torch.device import rows as drows
    from jolt_atlas_tpu_torch.field.frvec import FrArray
    from jolt_atlas_tpu_torch.poly.spliteq import SplitEq
    gen = np.random.default_rng(5050)
    err = {"rows_points": 0.0, "reduction_bind": 0.0}
    ncmp = 0
    for P, n, T, mf in shapes:
        x = drows.random_rows_for(P, n, gen, dev)
        terms = drows.Terms(drows.random_terms(P, T, mf, gen), dev)
        for nevals in evals:
            for kind in drows.WEIGHT_KINDS:
                w = drows.weights(*drows.random_weights(n, kind, gen), dev)
                err["rows_points"] = max(err["rows_points"], require_equal(
                    f"rows_points (P={P}, n={n}, {T} terms, {nevals} "
                    f"points, {kind})",
                    [drows.points(x, n, nevals, terms, w)],
                    [drows.points_plain(x, n, nevals, terms, w)]))
                checked(results, "rows_points",
                        drows.kernel_case(x, n, nevals, terms, w))
                ncmp += 1
    # the bench class's own factor lists: grouped terms (shared heads)
    x = drows.random_rows_for(27, 256, gen, dev)
    terms = drows.Terms(bench_terms(gen), dev)
    for nevals in evals:
        for kind in drows.WEIGHT_KINDS:
            w = drows.weights(*drows.random_weights(256, kind, gen), dev)
            err["rows_points"] = max(err["rows_points"], require_equal(
                f"rows_points (bench terms, {nevals} points, {kind})",
                [drows.points(x, 256, nevals, terms, w)],
                [drows.points_plain(x, 256, nevals, terms, w)]))
            checked(results, "rows_points",
                    drows.kernel_case(x, 256, nevals, terms, w))
            ncmp += 1
    for P, n in bind_shapes:
        x = drows.random_rows_for(P, n, gen, dev)
        c = dred.random_rows(6, gen, dev)[5:]
        err["reduction_bind"] = max(err["reduction_bind"], require_equal(
            f"reduction_bind (rows layout, P={P}, n={n})",
            [drows.bind_rows(x, c, n)],
            [dred.bind_plain(x, x, c, torch.zeros(P, dtype=torch.int64,
                                                  device=dev), P, P,
                             (n // 2).bit_length() - 1)]))
        checked(results, "reduction_bind", dred.bind_case(P, P))
    edge = [0, 1, -1, 2, -2, (1 << 63) - 1, -(1 << 63), 1 << 62,
            -(1 << 62) - 7, 65535, -65536, 1 << 32]
    err["rows_from_i64"] = 0.0
    for m in i64_sizes:
        v = np.concatenate([gen.integers(-(1 << 63), (1 << 63) - 1, size=m,
                                         dtype=np.int64, endpoint=True),
                            gen.integers(-(1 << 16), 1 << 16, size=m)])
        v[:min(len(edge), 2 * m)] = edge[:2 * m]
        src = torch.from_numpy(v.astype(np.int64)).to(dev)
        # and a ragged view at an 8-byte offset
        for part in (src, src[1:]):
            err["rows_from_i64"] = max(err["rows_from_i64"], require_equal(
                f"rows_from_i64 ({part.shape[0]} values)",
                [drows.from_i64(part)], [drows.from_i64_plain(part)]))
    checked(results, "rows_from_i64", 0)
    lines = [f"kernel 7 bit-equal to its plain version at {ncmp} shapes "
             f"(P, n) in {[s[:2] for s in shapes]} and (27, 256) with the "
             f"bench class's terms x points {list(evals)} x "
             f"{len(drows.WEIGHT_KINDS)} weight layouts; kernel 4 in the "
             f"rows layout at (P, n) in {list(bind_shapes)}; kernel 8 at "
             f"{[2 * m for m in i64_sizes]} values (the int64 edges, full "
             "range and small) and at one fewer from an 8-byte offset"]

    # -- kernel 7 against its plain version at every class the bench's own
    # instances launch it at (the first engine pass, not timed)
    gate = drows.RowsGate()
    elig = [i for i in rows_cap if rows_eligible(i, gate)]
    real, seen = drows.points, set()

    def check(x, n, nevals, terms, w):
        got = real(x, n, nevals, terms, w)
        case = drows.kernel_case(x, n, nevals, terms, w)
        if case not in seen:
            seen.add(case)
            err["rows_points"] = max(err["rows_points"], require_equal(
                f"rows_points (bench class {case})", [got],
                [drows.points_plain(x, n, nevals, terms, w)]))
            checked(results, "rows_points", case)
        return got
    drows.points = check
    try:
        for i in elig:
            rows_run(i, dev, gate)
    finally:
        drows.points = real
    lines.append(f"kernel 7 bit-equal to its plain version at the "
                 f"{len(seen)} shape classes the bench's {len(elig)} "
                 f"eligible instances launch it at")

    # -- timed on the bench's largest class, round 0
    big = max(elig, key=lambda i: (rows_n(i) * len(i["rows"]) * sum(
        len(f) for _, f in i["terms"])))
    P, n = len(big["rows"]), rows_n(big)
    x = drows.upload([a if k == "ints" else FrArray(a)
                      for k, a in big["rows"]], dev)
    terms = drows.Terms(big["terms"], dev)
    se = SplitEq(big["eq"][0], pre_vars=big["eq"][1], post_vars=big["eq"][2])
    nevals = message_nevals(se, 0, big["degree"])
    w = drows.weights(*se.tables(0), dev)
    ms, call_ms, got = device_ms(
        lambda: drows.points(x, n, nevals, terms, w), 10, "rows_points")
    plain_ms, want = cuda_ms(lambda: drows.points_plain(x, n, nevals, terms,
                                                        w), 1, warmup=False)
    err["rows_points"] = max(err["rows_points"], require_equal(
        "rows_points (timed)", [got], [want]))
    need, direct, dense = rows_products(x, n, nevals, terms, w)
    shape = (f"{rows_class(big)} (P, degree, terms, most factors), n = {n}, "
             f"{nevals} points, round 0's weight")
    nbytes = (P * n + nevals + w[0].shape[0]) * FR_BYTES
    direct_ms = bound(direct, nbytes, results["imad_peak"], IMADS_PER_MUL)[0]
    dense_ms = bound(dense, nbytes, results["imad_peak"], IMADS_PER_MUL)[0]
    plan = drows.points_plan(P, n, nevals, terms.slices,
                             torch.cuda.get_device_properties(
                                 dev).multi_processor_count)
    lines.append("points " + timed(
        results, "rows_points", shape, ms, need, nbytes, IMADS_PER_MUL,
        call_ms) + f" ({need} products this data needs as kernel 7 groups "
        f"the terms; {direct} term by term: bound {direct_ms:.4f} ms; "
        f"{dense} with no zero skipped: bound {dense_ms:.4f} ms), plan "
        f"{json.dumps(plan)}, plain {plain_ms:.1f} ms")
    results["rows_points"] = {
        "plain_ms": plain_ms, "plan": plan,
        "bound_term_by_term_ms": direct_ms,
        **results["timed"]["rows_points"][-1]}
    # the launch plan against its neighbours, on the same data
    alt = {}
    for slices in (3, 4, 6, 8):
        ts = drows.Terms(big["terms"], dev, slices)
        for group in (1, 2, nevals):
            ams, _, got = device_ms(lambda: drows.points(
                x, n, nevals, ts, w, 32, group), 10, "rows_points")
            err["rows_points"] = max(err["rows_points"], require_equal(
                f"rows_points (tile 32, group {group}, {slices} slices)",
                [got], [want]))
            alt[f"tile 32, group {group}, {slices} slices"] = ams
    lines.append("points at other launch plans, device ms: "
                 + json.dumps(alt))
    c = dred.random_rows(6, gen, dev)[5:]
    bms, bcall, _ = device_ms(lambda: drows.bind_rows(x, c, n), 10,
                              "reduction_bind")
    bb, bby = bound(P * n // 2, (3 * P * n // 2) * FR_BYTES,
                    results["imad_peak"], IMADS_PER_MUL)
    results["rows_bind"] = {"ms": bms, "call_ms": bcall, "bound_ms": bb,
                            "shape": f"{P} rows of {n}"}
    lines.append(f"kernel 4 in the rows layout on that instance ({P} rows "
                 f"of {n}): {bms:.4f} ms on the device (a call {bcall:.4f} "
                 f"ms), bound {bb:.4f} ms ({bby})")
    ints = [a for k, a in big["rows"] if k == "ints"] or [
        gen.integers(-(1 << 16), 1 << 16, size=n)]
    src = torch.from_numpy(np.concatenate(ints).astype(np.int64)).to(dev)
    ms8, call8, got = device_ms(lambda: drows.from_i64(src), 10,
                                "rows_from_i64", cold=True)
    warm8 = device_ms(lambda: drows.from_i64(src), 10, "rows_from_i64")[0]
    plain8, want = cuda_ms(lambda: drows.from_i64_plain(src), 1,
                           warmup=False)
    err["rows_from_i64"] = max(err["rows_from_i64"], require_equal(
        "rows_from_i64 (timed)", [got], [want]))
    m8 = src.shape[0]
    lines.append("from_i64 " + timed(
        results, "rows_from_i64", f"that instance's {len(ints)} integer "
        f"rows, {m8} values, after an L2 flush", ms8, m8, m8 * (8 + FR_BYTES),
        IMADS_PER_I64, call8) + f"; back to back (its {m8 * 40} bytes "
        f"held in the L2) {warm8:.4f} ms; plain {plain8:.1f} ms")
    results["rows_from_i64"] = {"ms": ms8, "plain_ms": plain8,
                                "ms_l2_warm": warm8,
                                **results["timed"]["rows_from_i64"][-1]}
    for k, v in err.items():
        results[k]["max_abs_err"] = max(results[k].get("max_abs_err", 0.0),
                                        v)
    del x, got, want
    say("rows", "; ".join(lines))

    # -- the engine against the host GruenInstance, in turns
    runs = rows_passes(elig, dev, gate)
    per = rows_report(elig, runs)
    tot = lambda key: sum(r[key] for r in per.values())
    say("rows", "engine against the host GruenInstance on the bench's "
        "eligible instances (engine, host, host, engine; every round "
        "message and final row value equal), ms, means of the passes: "
        + json.dumps({
            "instances": len(elig), "of": len(rows_cap),
            "elements": sum(len(i["rows"]) * rows_n(i) for i in elig),
            "engine_ms": tot("engine_ms"), "host_ms": tot("host_ms"),
            "host_first2_ms": tot("host_first2_ms"),
            **{s: tot(s) for s in ROWS_STEPS},
            "engine_host_rounds": tot("engine_host_rounds"),
            "per_class": per}))


# ---------------------------------------------------------------------------
# phase 12b: the read-check engine's kernels
# ---------------------------------------------------------------------------

# (K, D, T, read checks) held launch by launch: the benchmark cell's
# largest class (timed), its LayerNorm class at T = 64, Gather's at the
# bench (K 128), int32 indices (K 512), and K 1024 at a T of 2 (the close
# gathers)
ONEHOT_CLASSES = ((16, 16, 16384, 44), (16, 26, 64, 61), (128, 1, 64, 1),
                  (512, 2, 64, 3), (1024, 1, 2, 1))


def onehot_work(lay) -> tuple:
    """(Montgomery products, bytes) each of the read-check engine's kernels
    needs at least, for a batch of layout ``lay``: {kernel: (products,
    bytes)}. prepare: each eq table built by doubling, a product an entry
    (eq(r_cycle), the E_s and A_l tables), and the scalars into Montgomery
    form; its scalars read, the tables, U and es written. buckets: field
    sums only (no product); the chunk indices and the two eq tables read
    once, GB and H written. The rounds: five products a (row, value) of an address
    round (H by A, by U twice, the two gammas) and U's update; five a (row,
    pair) of a cycle round (the weight, two squares, two by the weight)
    and one a bound value after the first; the read checks' two a pair
    (p(0), p(2)) and the binds of their tables and G rows; the inputs
    (indices, H, GB, the tables, E) read once."""
    D, T, K, N, S = lay.D, lay.T, lay.K, lay.N, lay.S
    idx_bytes = D * T * (4 if lay.wide else 1)
    prep = (T + (2 * T - 1) + (K - 1) + lay.ns,
            (lay.ns + 1 + T + (2 * T - 1) + (K - 1) + lay.ns + lay.M + K
             + 1) * FR_BYTES)
    buck = (0, idx_bytes + (2 * T + 2 * D * K) * FR_BYTES)
    rounds = (5 * D * K * lay.logK + K * lay.logK + 6 * D * (T - 1)
              + 2 * N * (K - 1) + (S + D) * (K - 1),
              idx_bytes + (2 * D * K + S * K + 2 * T) * FR_BYTES)
    return {"onehot_prepare": prep, "onehot_buckets": buck,
            "onehot_round": rounds}


def onehot_rounds(b, rs, fetch: bool = True) -> list:
    """Every round launch of a batch at the challenges rs (rs[0] None),
    the close included; the fetched rows of each."""
    from jolt_atlas_tpu_torch.device import onehot as donehot
    M, D = b.lay.M, b.lay.D
    return [donehot.round_(b, rnd, rs[rnd], 4 if rnd < M else 2 * D, fetch)
            for rnd in range(M + 1)]


def phase_onehot(dev, results) -> None:
    """The read-check engine's three kernels (onehot_prepare,
    onehot_buckets, onehot_round) against their plain versions on the card:
    every launch of a random batch of each of ONEHOT_CLASSES, the workspace
    copied before the launch and the plain version run on the copy
    (onehot_state and the fetched rows compared), then every class the
    bench prove launches, held on its own inputs (hold_kernels; the bytes
    equal phase 9's). Each kernel timed at the cell's largest class
    (device ms from the profiler; the round's over one batch's M + 1
    launches) beside its plain version's ms on the card and its bound
    (onehot_work)."""
    from jolt_atlas_tpu_torch import serde
    from jolt_atlas_tpu_torch.device import onehot as donehot
    from jolt_atlas_tpu_torch.field.constants import FR_MODULUS
    from jolt_atlas_tpu_torch.field.scalar import Fr
    from jolt_atlas_tpu_torch.prover import AtlasProver
    err: dict = {}
    batches = {}
    for K, D, T, N in ONEHOT_CLASSES:
        gen = np.random.default_rng(K + D + T)
        b = donehot.random_batch(K, D, T, N, gen, dev)
        lay = b.lay
        rs = [None] + [Fr(int.from_bytes(gen.bytes(32), "little")
                          % FR_MODULUS) for _ in range(lay.M)]
        steps = [("onehot_prepare", 0, lambda: donehot.prepare(b),
                  lambda ws: donehot.prepare_plain(ws, lay)),
                 ("onehot_buckets", lay.wide, lambda: donehot.buckets(b),
                  lambda ws: donehot.buckets_plain(ws, lay, b.idx))]
        for rnd in range(lay.M + 1):
            nout = 4 if rnd < lay.M else 2 * D
            steps.append((
                "onehot_round", (lay.wide, donehot.round_case(lay, rnd)),
                lambda rnd=rnd, nout=nout: donehot.round_(b, rnd, rs[rnd],
                                                          nout),
                lambda ws, rnd=rnd: donehot.round_plain(
                    ws, lay, b.idx, rnd, challenge_words(rs[rnd]))))
        for kernel, case, launch, plain in steps:
            pre = b.ws.clone()
            got = launch()
            plain(pre)
            what = f"{kernel} (K {K}, D {D}, T {T}, class {case})"
            err[kernel] = max(err.get(kernel, 0.0), require_equal(
                what, [onehot_state(b.ws, lay)], [onehot_state(pre, lay)]))
            if got is not None and not np.array_equal(
                    got, pre[lay.out:lay.out + len(got)].cpu().numpy()):
                raise AssertionError(f"{what}: the fetched rows differ")
            checked(results, kernel, case)
        batches[(K, D, T, N)] = (b, rs)
    # the bench prove's own launches
    bench = results["bench"]
    with hold_kernels(results, err, "bench prove", ONEHOT) as seen:
        (proof, _), tele = counted(
            results, ONEHOT,
            lambda: AtlasProver(bench["pp"]).prove([bench["toks"]]))
    if serde.serialize_proof(proof) != bench["blob"]:
        raise AssertionError("onehot: the held prove's bytes differ")
    if not tele["decisions"].get("rachecks", "").startswith("ENGAGED"):
        raise AssertionError(f"onehot: the engine did not engage: "
                             f"{tele['decisions']}")
    # timed at the cell's largest class
    b, rs = batches[ONEHOT_CLASSES[0]]
    lay = b.lay
    donehot.prepare(b)
    donehot.buckets(b)
    start = b.ws.clone()
    work = onehot_work(lay)

    def rounds():
        b.ws.copy_(start)
        onehot_rounds(b, rs, fetch=False)

    def plain_rounds(ws):
        for rnd in range(lay.M + 1):
            donehot.round_plain(ws, lay, b.idx, rnd, challenge_words(rs[rnd]))

    calls = {"onehot_prepare": (lambda: donehot.prepare(b),
                                lambda ws: donehot.prepare_plain(ws, lay)),
             "onehot_buckets": (lambda: donehot.buckets(b),
                                lambda ws: donehot.buckets_plain(ws, lay,
                                                                 b.idx)),
             "onehot_round": (rounds, plain_rounds)}
    K, D, T, N = ONEHOT_CLASSES[0]
    shape = f"K {K}, D {D}, T {T}, {N} read checks, {lay.S} tables"
    lines = []
    for kernel, (call, plain) in calls.items():
        ms, call_ms, _ = device_ms(call, 5, kernel)
        ws = start.clone()
        plain_ms, _ = cuda_ms(lambda: plain(ws), 1, warmup=False)
        products, nbytes = work[kernel]
        bnd, by = bound(products, nbytes, results["imad_peak"],
                        IMADS_PER_MUL)
        what = shape + (f": one batch's {lay.M + 1} launches"
                        if kernel == "onehot_round" else "")
        results[kernel] = {"shape": what, "ms": ms, "call_ms": call_ms,
                           "plain_ms": plain_ms, "bound_ms": bnd,
                           "bound_by": by, "share": bnd / ms,
                           "products": products, "bytes": nbytes,
                           "max_abs_err": err.get(kernel, 0.0)}
        lines.append(f"{kernel} ({what}): {ms:.4f} ms on the device (a "
                     f"call {call_ms:.4f} ms), plain {plain_ms:.2f} ms, "
                     f"bound {bnd:.4f} ms ({by}), share {bnd / ms:.4f}")
    say("onehot", "; ".join(lines))
    say("onehot", json.dumps({
        "classes": [list(c) for c in ONEHOT_CLASSES],
        "bench_prove_classes_held": sorted(f"{k} {c}" for k, c in seen),
        "bench_prove_launches": {k: tele["launches"].get(k, 0)
                                 for k in ONEHOT},
        "decision": tele["decisions"]["rachecks"],
        "max_abs_err": err}))


# ---------------------------------------------------------------------------
# phase 12c: the einsum bind kernel
# ---------------------------------------------------------------------------

# (K, E) of gpt2-1l's binds that are weights (timed): fc, proj, the tied
# head; then their activations (16 tokens) and attention's second operand
BIND_WEIGHTS = ((1024, 4096), (4096, 1024), (1024, 8192))
BIND_SHAPES = BIND_WEIGHTS + ((1024, 16), (4096, 16), (256, 64), (64, 1))


def bind_case(A) -> tuple:
    """The einsum bind's launch class: the operand's bytes an element and
    the lanes a row (device/bind.py group)."""
    from jolt_atlas_tpu_torch.device import bind as dbind
    return A.element_size(), dbind.group(A.shape[1])


def bind_inputs(K: int, E: int, dtype, gen, dev) -> tuple:
    """A (K, E) operand of random values of dtype with its extremes (and 0,
    -1) at the first entries, and an eq table of E random field elements
    (their Montgomery forms), on dev."""
    from jolt_atlas_tpu_torch.field.constants import FR_MODULUS
    info = np.iinfo(dtype)
    A = gen.integers(info.min, info.max, size=(K, E), dtype=np.int64,
                     endpoint=True).astype(dtype)
    A.flat[:4] = (info.min, info.max, 0, -1)[:A.size]
    raw = b"".join((int.from_bytes(gen.bytes(32), "little") % FR_MODULUS)
                   .to_bytes(32, "little") for _ in range(E))
    eq = np.frombuffer(raw, dtype=np.int64).reshape(E, 4)
    return (torch.from_numpy(A).to(dev), torch.from_numpy(eq.copy()).to(dev))


def bind_work(K: int, E: int, width: int) -> tuple:
    """(IMADs, bytes) a bind of a (K, E) operand of ``width`` bytes an
    element needs at least: one 8-limb row of products an element (two for
    int64: 16 IMADs a 32-bit word); the operand and the eq table read once,
    the K results written."""
    return 16 * (width // 4) * K * E, K * E * width + (E + K) * FR_BYTES


def phase_bind(dev, results) -> None:
    """The einsum bind kernel against its plain version on the card at
    BIND_SHAPES (int32 and int64, the extremes of each), attention's
    middle-axis operand through the engine against the host's bind, the
    bench prove with every class it launches held (its bytes phase 9's),
    and each of BIND_WEIGHTS timed (device ms after an L2 flush) beside its
    bound and its plain version's ms."""
    from jolt_atlas_tpu_torch import serde
    from jolt_atlas_tpu_torch.device import bind as dbind
    from jolt_atlas_tpu_torch.field import vec
    from jolt_atlas_tpu_torch.field.constants import FR_MODULUS
    from jolt_atlas_tpu_torch.field.scalar import Fr
    from jolt_atlas_tpu_torch.prover import AtlasProver
    from jolt_atlas_tpu_torch.zkops.ops import EinsumLayout
    err: dict = {}
    gen = np.random.default_rng(2100)
    inputs = {}
    for K, E in BIND_SHAPES:
        for dtype in (np.int32, np.int64):
            A, eq = bind_inputs(K, E, dtype, gen, dev)
            got = dbind.bind(A, eq)
            err["einsum_bind"] = max(err.get("einsum_bind", 0.0),
                                     require_equal(
                f"einsum_bind ({K} x {E}, {dtype.__name__})",
                [torch.from_numpy(got)], [dbind.bind_plain(A, eq).cpu()]))
            checked(results, "einsum_bind", bind_case(A))
            inputs[(K, E, dtype)] = (A, eq)
    # attention's first operand, its exclusive axis in the middle
    lay = EinsumLayout("hmk,hnk->hmn", [(16, 16, 64)] * 2, (16, 16, 16))
    point = [Fr(int.from_bytes(gen.bytes(32), "little") % FR_MODULUS)
             for _ in range(12)]
    groups = lay.split_out_point(point)
    arr = gen.integers(-2 ** 31, 2 ** 31, size=(16, 16, 64)).astype(np.int32)
    perm, K, E, points, _ = lay.operand_layout("hmk", groups)
    want = dbind.bind_operand(arr, perm, K, E, points)  # the host's
    with dbind.Scope(dev) as sc:
        got = dbind.bind_operand(arr, perm, K, E, points)
    if sc.engaged != 1 or list(vec.as_object(got)) != list(
            vec.as_object(want)):
        raise AssertionError("einsum_bind: attention's hmk bind differs "
                             "from the host's")
    # the bench prove's own launches
    bench = results["bench"]
    with hold_kernels(results, err, "bench prove", BIND) as seen:
        (proof, _), tele = counted(
            results, BIND,
            lambda: AtlasProver(bench["pp"]).prove([bench["toks"]]))
    if serde.serialize_proof(proof) != bench["blob"]:
        raise AssertionError("einsum_bind: the held prove's bytes differ")
    if not tele["decisions"].get("einsum_bind", "").startswith("ENGAGED"):
        raise AssertionError(f"einsum_bind: the engine did not engage: "
                             f"{tele['decisions']}")
    timed = {}
    for K, E in BIND_WEIGHTS:
        A, eq = inputs[(K, E, np.int32)]
        ms, call_ms, _ = device_ms(lambda: dbind.bind(A, eq), 5,
                                   "einsum_bind", cold=True)
        plain_ms, _ = cuda_ms(lambda: dbind.bind_plain(A, eq), 1,
                              warmup=False)
        imads, nbytes = bind_work(K, E, 4)
        bnd, by = bound(imads, nbytes, results["imad_peak"], 1)
        timed[f"{K} x {E}"] = {"ms": ms, "call_ms": call_ms,
                               "plain_ms": plain_ms, "bound_ms": bnd,
                               "bound_by": by, "share": bnd / ms,
                               "imads": imads, "bytes": nbytes}
    head = timed["1024 x 8192"]
    results["einsum_bind"] = dict(
        head, shape="1024 x 8192 int32 (the tied head), L2 flushed",
        timed=timed, max_abs_err=err.get("einsum_bind", 0.0))
    say("bind", "; ".join(
        f"einsum_bind ({shape} int32): {t['ms']:.4f} ms on the device (a "
        f"call {t['call_ms']:.4f} ms), plain {t['plain_ms']:.2f} ms, bound "
        f"{t['bound_ms']:.4f} ms ({t['bound_by']}), share {t['share']:.4f}"
        for shape, t in timed.items()))
    say("bind", json.dumps({
        "shapes": [list(s) for s in BIND_SHAPES],
        "bench_prove_classes_held": sorted(f"{k} {c}" for k, c in seen),
        "bench_prove_launches": tele["launches"].get("einsum_bind", 0),
        "decision": tele["decisions"]["einsum_bind"],
        "max_abs_err": err}))


# ---------------------------------------------------------------------------
# phase 13: the multi-device proving step on the card
# ---------------------------------------------------------------------------

# the kernels hold_kernels can hold at a path's launches
HELD = ("bucket_accumulate", "bucket_combine", "reduction_bind",
        "reduction_q0", "reduction_tail", "rows_points") + ONEHOT + BIND


def onehot_state(ws, lay):
    """The read-check engine's workspace without the round kernel's
    per-block partials (scratch whose partition the plain version does not
    follow)."""
    return torch.cat([ws[:lay.partials], ws[lay.out:]])


def challenge_words(r) -> list:
    """A round's challenge as the round kernel takes it: four canonical
    64-bit words, least significant first (0 before round 1)."""
    v = 0 if r is None else r.v
    return [(v >> (64 * i)) & ((1 << 64) - 1) for i in range(4)]


def _clone(obj):
    """obj with every tensor in it (through tuples and lists) copied."""
    if isinstance(obj, torch.Tensor):
        return obj.clone()
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_clone(o) for o in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(_clone(o) for o in obj)
    return obj


@contextlib.contextmanager
def hold_kernels(results, err: dict, label: str, kernels=HELD,
                 largest: dict | None = None, note=dict, seen=None,
                 defer: list | None = None):
    """While entered, each of ``kernels`` (kernels 2-7, the read-check
    engine's three and the einsum bind) is held bit-equal
    to its plain version (on the card, on the launch's own inputs) at the
    first launch of every shape class the path makes, which is then
    checked: its launch shape as its wrapper records it in telemetry, and
    for kernels 2 and 3 also the MSM's entries and the batch's MSMs, so
    that each new MSM size is held once. The read-check engine's kernels
    work in place: its workspace is copied before a launch of a new class,
    and the plain version runs on the copy (onehot_state compared). Yields
    ``seen``, the set of
    (kernel, class) held (a set given in is added to). ``largest`` keeps
    each kernel's largest launch: its size, its arguments and ``note()``.
    ``defer``: the launch's inputs and result are copied into this list
    instead, to be held after the path (``check_deferred``), so that the
    plain versions stay out of the path's time."""
    from jolt_atlas_tpu_torch.device import bind as dbind
    from jolt_atlas_tpu_torch.device import msm as dmsm
    from jolt_atlas_tpu_torch.device import onehot as donehot
    from jolt_atlas_tpu_torch.device import reduction as dred
    from jolt_atlas_tpu_torch.device import rows as drows
    real = {"bucket_accumulate": dmsm.bucket_accumulate,
            "bucket_combine": dmsm.bucket_combine,
            "reduction_bind": dred.bind, "reduction_q0": dred.q0,
            "reduction_tail": dred.tail, "rows_points": drows.points,
            "onehot_prepare": donehot.prepare,
            "onehot_buckets": donehot.buckets,
            "onehot_round": donehot.round_, "einsum_bind": dbind.bind}
    seen = set() if seen is None else seen

    def hold(kernel, key, case, got, plain_of, args, fresh=False):
        # fresh: got and args are copies already, which the path does not
        # write again
        if (kernel, key) in seen:
            return
        seen.add((kernel, key))
        held = (kernel, key, case, got, plain_of, args)
        if defer is not None:
            defer.append(held if fresh else _clone(held))
        else:
            hold_one(results, err, label, *held)

    def first(kernel, key, case, got, plain_of, args, size,
              plain_args=None):
        if largest is not None and (kernel not in largest
                                    or size > largest[kernel][0]):
            largest[kernel] = (size, args, note())
        hold(kernel, key, case, got, plain_of,
             args if plain_args is None else plain_args)

    def accumulate(bases, lanes, out=None, run=dmsm.ACCUM_RUN):
        got = real["bucket_accumulate"](bases, lanes, out, run)
        case, E = dmsm.accumulate_class(lanes, run), lanes[0].shape[0]
        first("bucket_accumulate", (case, E), case, got,
              lambda a: dmsm.bucket_accumulate_plain(a[0], a[1], run),
              (bases, lanes), E)
        return got

    def combine(acc, c, groups=0):
        got = real["bucket_combine"](acc, c, groups)
        k, dev = acc[0].shape[0], acc[0].device
        G = groups or (dmsm.combine_groups(
            k, c, torch.cuda.get_device_properties(dev).multi_processor_count)
            if dev.type == "cuda" else 1)
        L = acc[0].shape[1]
        # the largest is the widest window's, then the largest batch
        first("bucket_combine", (L, G, k), (L, G), got,
              lambda a: dmsm.bucket_combine_plain(a[0], a[1], G), (acc, c),
              (L, k))
        return got

    def q0(*a):
        got = real["reduction_q0"](*a)
        case = dred.q0_case(a[4])
        first("reduction_q0", case, case, [got],
              lambda b: [dred.q0_plain(*b)], a, a[3] << a[4])
        return got

    def bind(*a):
        got = real["reduction_bind"](*a)
        case = dred.bind_case(a[4], a[5])
        first("reduction_bind", case, case, [got],
              lambda b: [dred.bind_plain(*b)], a, a[5] << a[6])
        return got

    def tail(*a):
        # Q, es and the state advance in place: keep what they were
        lanes = a[2].shape[0]
        new = ("reduction_tail", lanes) not in seen
        pre = [t.clone() for t in (a[2], a[3], a[10])] if new else None
        real["reduction_tail"](*a)
        if new:
            first("reduction_tail", lanes, lanes, (a[2], a[3], a[10], a[11],
                                                   a[12]),
                  lambda b: dred.tail_plain(*b), a, lanes,
                  (*a[:2], pre[0], pre[1], *a[4:10], pre[2]))
        return None

    def points(x, n, nevals, terms, w, tile=None, group=None):
        got = real["rows_points"](x, n, nevals, terms, w, tile, group)
        a = (x, n, nevals, terms, w)
        case = drows.kernel_case(*a)
        first("rows_points", case, case, [got],
              lambda b: [drows.points_plain(*b)], a, x.shape[0] * nevals)
        return got

    def in_place(kernel, case, b, launch, plain):
        # the read-check engine: plain(workspace copy, lay, idx) against
        # the launch's workspace after it
        new = (kernel, case) not in seen
        pre = b.ws.clone() if new else None
        got = launch()
        if new:
            def plain_state(a):
                plain(*a)
                return [onehot_state(a[0], a[1])]
            hold(kernel, case, case, [onehot_state(b.ws, b.lay)],
                 plain_state, (pre, b.lay, b.idx.clone()), fresh=True)
        return got

    def prepare(b):
        return in_place("onehot_prepare", 0, b,
                        lambda: real["onehot_prepare"](b),
                        lambda ws, lay, idx: donehot.prepare_plain(ws, lay))

    def buckets(b):
        return in_place("onehot_buckets", b.lay.wide, b,
                        lambda: real["onehot_buckets"](b),
                        donehot.buckets_plain)

    def round_(b, rnd, r, nout, fetch=True):
        words = challenge_words(r)
        return in_place(
            "onehot_round", (b.lay.wide, donehot.round_case(b.lay, rnd)), b,
            lambda: real["onehot_round"](b, rnd, r, nout, fetch),
            lambda ws, lay, idx: donehot.round_plain(ws, lay, idx, rnd,
                                                     words))

    def bind(A, eq):
        got = real["einsum_bind"](A, eq)
        case = bind_case(A)
        first("einsum_bind", case, case, [torch.from_numpy(got)],
              lambda a: [dbind.bind_plain(*a).cpu()], (A, eq), A.numel())
        return got

    # (module, name) of each wrapper where its callers find it: the rows
    # engine binds with kernel 4 through its own import
    wrap = {"bucket_accumulate": ([(dmsm, "bucket_accumulate")], accumulate),
            "bucket_combine": ([(dmsm, "bucket_combine")], combine),
            "reduction_bind": ([(dred, "bind"), (drows, "bind")], bind),
            "reduction_q0": ([(dred, "q0")], q0),
            "reduction_tail": ([(dred, "tail")], tail),
            "rows_points": ([(drows, "points")], points),
            "onehot_prepare": ([(donehot, "prepare")], prepare),
            "onehot_buckets": ([(donehot, "buckets")], buckets),
            "onehot_round": ([(donehot, "round_")], round_),
            "einsum_bind": ([(dbind, "bind")], bind)}
    for k in kernels:
        for mod, attr in wrap[k][0]:
            setattr(mod, attr, wrap[k][1])
    try:
        yield seen
    finally:
        for k in kernels:
            for mod, attr in wrap[k][0]:
                setattr(mod, attr, real[k])


def hold_one(results, err: dict, label: str, kernel, key, case, got,
             plain_of, args) -> None:
    """Hold one launch of ``kernel`` (its result ``got``) against its plain
    version on the same inputs, plain_of(args); note the class checked."""
    err[kernel] = max(err.get(kernel, 0.0), require_equal(
        f"{kernel} ({label}, class {key})", got, plain_of(args)))
    checked(results, kernel, case)


def check_deferred(results, err: dict, label: str, defer: list) -> None:
    """Hold the launches that hold_kernels(defer=) kept, emptying it."""
    while defer:
        hold_one(results, err, label, *defer.pop(0))


@contextlib.contextmanager
def check_mesh_kernels(results, err: dict, largest: dict):
    """While entered, kernels 4, 5 and 7 are each held bit-equal to their
    plain versions (on the card) at the first launch of every shape class
    the path makes, which is then checked (hold_kernels); ``largest``
    keeps each kernel's largest launch (its size, its arguments, and for
    kernels 5 and 7 the rows of the split-eq tables its gathered weights
    were made from and the gather itself, as a call)."""
    from jolt_atlas_tpu_torch.device import reduction as dred
    from jolt_atlas_tpu_torch.parallel import shardedreduction as SR
    from jolt_atlas_tpu_torch.parallel import shardedrows as SW
    real = (SR._ShardedRows.weights, SW.shard_weights)
    gather: dict = {}  # the weights' source rows and gather, the last made

    def table_rows(tables) -> int:
        return sum(len(t) for whi, _, wlo, _ in tables for t in (whi, wlo)
                   if t is not None)

    def q0_weights(self, tables, lg):
        # each instance as one single-card lane of its global length
        lanep = torch.tensor([
            [0, dred.ABSENT_SHIFT if whi is None else shift, 0,
             0 if wlo is None else (1 << log_wlo) - 1]
            for whi, shift, wlo, log_wlo in tables], dtype=torch.int64)
        gather.update(rows=table_rows(tables) + 1, lanep=lanep,
                      lg=lg + self.D.bit_length() - 1,
                      call=lambda: real[0](self, tables, lg))
        return real[0](self, tables, lg)

    def points_weights(mesh, whi, whi_shift, wlo, log_wlo, m):
        gather.update(rows=table_rows([(whi, 0, wlo, 0)]), call=lambda:
                      real[1](mesh, whi, whi_shift, wlo, log_wlo, m))
        return real[1](mesh, whi, whi_shift, wlo, log_wlo, m)

    SR._ShardedRows.weights, SW.shard_weights = q0_weights, points_weights
    try:
        with hold_kernels(results, err, "mesh path", ("reduction_q0",
                                                      "reduction_bind",
                                                      "rows_points"),
                          largest, lambda: dict(gather)) as seen:
            yield seen
    finally:
        SR._ShardedRows.weights, SW.shard_weights = real


def time_mesh_kernels(dev, results, largest: dict) -> dict:
    """Kernels 4, 5 and 7 timed at the mesh path's largest launch of each
    (device ms after an L2 flush, the call's ms, the bound of what this
    data needs, the plain version's ms on the card). The bound of kernels
    5 and 7 counts the split-eq tables the function needs, not the dense
    tables gathered from them for each shard; those are reported beside
    it (their bytes, the gather's device ms)."""
    from jolt_atlas_tpu_torch.device import reduction as dred
    from jolt_atlas_tpu_torch.device import rows as drows
    peak, out = results["imad_peak"], {}
    plains = {"reduction_q0": dred.q0_plain, "reduction_bind":
              dred.bind_plain, "rows_points": drows.points_plain}
    calls = {"reduction_q0": dred.q0, "reduction_bind": dred.bind,
             "rows_points": drows.points}
    for kernel, (_, a, gather) in sorted(largest.items()):
        ms, call, got = device_ms(lambda: calls[kernel](*a), 5, kernel,
                                  cold=True)
        plain_ms, want = cuda_ms(lambda: plains[kernel](*a), 1, warmup=False)
        require_equal(f"{kernel} (mesh path, timed)", [got], [want])
        if kernel == "reduction_q0":
            _, tab, lanep, lanes, lg = a
            shape = f"{lanes} lanes of 2^{lg}, gathered weights"
            # the function's least: its terms, the split-eq tables and a
            # value a lane, and the IMADs kernel 5's lazy sums need on the
            # split-eq tables, each instance as one single-card lane of its
            # global length (a process holds every shard). The gathered
            # layout makes both weights vary a term: its count stands
            # beside it
            terms = lanes << (lg - 1)
            nbytes = (terms + gather["rows"] + lanes) * FR_BYTES
            b, by = bound(q0_lazy_imads(gather["lanep"], gather["lg"],
                                        dred.Q0_PER_THREAD),
                          nbytes, peak, 1)
            gathered = tab.shape[0]
            layout_ops = q0_lazy_imads(lanep.cpu(), lg, dred.Q0_PER_THREAD)
        elif kernel == "reduction_bind":
            jp, lanes, lg = a[4:]
            shape = f"{jp} of {lanes} lanes continue, 2^{lg} each"
            nc, nn = jp << lg, (lanes - jp) << lg
            b, by = bound(nc, (3 * nc + 2 * nn) * FR_BYTES, peak,
                          IMADS_PER_MUL)
        else:
            x, n, nevals, terms, w = a
            P = x.shape[0] // n
            shape = (f"{P} rows of {n} (a shard), {terms.T} terms, "
                     f"{nevals} points, gathered weights")
            need = rows_products(*a)[0]
            b, by = bound(need, (P * n + nevals + gather["rows"])
                          * FR_BYTES, peak, IMADS_PER_MUL)
            gathered = n  # this shard's m whi and m wlo rows
        out[kernel] = {"shape": shape, "ms": ms, "call_ms": call,
                       "bound_ms": b, "bound_by": by, "share": b / ms,
                       "plain_ms": plain_ms}
        if kernel == "reduction_q0":
            out[kernel]["bound_gathered_layout_ms"] = bound(
                layout_ops, nbytes, peak, 1)[0]
        if kernel != "reduction_bind":
            out[kernel].update(
                split_eq_table_bytes=gather["rows"] * FR_BYTES,
                gathered_table_bytes=gathered * FR_BYTES,
                gather_ms=all_device_ms(gather["call"], 5))
    return out


MESH = ("reduction_bind", "reduction_q0", "rows_points", "rows_from_i64")


def mesh_keccak(dev, results, err: dict, shards: int) -> dict:
    """BENCH_SMALL's nanoGPT (1 block, 1 head, d16, seq 8, vocab 32, seed
    1234) under KeccakTranscript in a ``shards``-shard mesh_scope on
    ``dev``, counted: its bytes equal the host path's Keccak prove
    (device="cpu"), the Keccak verifier accepts them and the BLAKE2b
    verifier rejects them, both mesh engines engage (each runs its
    Fiat-Shamir on the host, whatever the transcript); kernels 4, 5 and 7
    held at the first launch of each new class, kernels 2 and 3 at each
    new MSM size."""
    from jolt_atlas_tpu_torch import models, serde
    from jolt_atlas_tpu_torch.parallel import make_mesh, mesh_scope
    from jolt_atlas_tpu_torch.preprocessing import AtlasPreprocessing
    from jolt_atlas_tpu_torch.prover import AtlasProver
    from jolt_atlas_tpu_torch.transcripts import KeccakTranscript
    from jolt_atlas_tpu_torch.verifier import AtlasVerifier
    rng = np.random.default_rng(1234)
    model = models.build_nanogpt(32, 8, 16, 1, 8, rng, heads=1)
    toks = rng.integers(0, 32, size=8).astype(np.int32)
    pp = AtlasPreprocessing.preprocess(model)
    t0 = time.time()
    host, _ = AtlasProver(pp, device="cpu",
                          transcript_factory=KeccakTranscript).prove([toks])
    host_s = time.time() - t0

    def prove():
        t0 = time.time()
        with mesh_scope(make_mesh(shards, device=dev)):
            proof, io = AtlasProver(pp, device=dev,
                                    transcript_factory=KeccakTranscript
                                    ).prove([toks])
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return proof, io, time.time() - t0

    need = MESH if dev.type == "cuda" else ()
    with check_mesh_kernels(results, err, {}) as seen, hold_kernels(
            results, err, "mesh path, Keccak", MSM, seen=seen):
        (proof, io, wall), tele = counted(results, need, prove)
    d = tele["decisions"]
    blob = serde.serialize_proof(proof)
    if blob != serde.serialize_proof(host):
        raise AssertionError("the Keccak mesh proof's bytes differ from the "
                             "host path's")
    if not AtlasVerifier(pp, KeccakTranscript).verify(proof, io):
        raise AssertionError("the Keccak verifier rejected the Keccak mesh "
                             "proof")
    if AtlasVerifier(pp).verify(proof, io):
        raise AssertionError("the BLAKE2b verifier accepted the Keccak mesh "
                             "proof")
    for k in ("mesh_reduction", "mesh_iop"):
        if not d.get(k, "").startswith("ENGAGED"):
            raise AssertionError(f"Keccak mesh prove: {k} did not engage: "
                                 f"{d}")
    return {"model": "nanogpt 1 block, 1 head, d16, seq 8, vocab 32",
            "proof_bytes": len(blob), "bytes_equal_host_path": True,
            "keccak_verified": True, "blake2b_rejected": True,
            "prove_s": wall, "host_prove_s": host_s,
            "mesh_reduction": d["mesh_reduction"], "mesh_iop": d["mesh_iop"],
            "launches": tele["launches"],
            "classes_held": sorted(f"{k} {c}" for k, c in seen)}


def phase_mesh(dev, results, shards: int = 8, log_t: int = 20) -> None:
    """The bench prove under mesh_scope over ``shards`` shards of the card,
    in one process and over a 1-rank NCCL group: bytes equal the gate
    path's, the verifier accepts, both mesh engines engage; kernels 4, 5
    and 7 held at every shape class the mesh path launches them at; the
    sharded product round at 2^log_t elements against the CPU plain
    version and Python integers; dryrun_multichip."""
    import tempfile

    import torch.distributed as dist

    from jolt_atlas_tpu_torch import serde
    from jolt_atlas_tpu_torch.device import telemetry
    from jolt_atlas_tpu_torch.entry import dryrun_multichip
    from jolt_atlas_tpu_torch.parallel import make_mesh, mesh_scope
    from jolt_atlas_tpu_torch.parallel import mesh as M
    from jolt_atlas_tpu_torch.prover import AtlasProver
    from jolt_atlas_tpu_torch.utils import profiling
    from jolt_atlas_tpu_torch.verifier import AtlasVerifier
    bench = results["bench"]
    pp, toks, blob = bench["pp"], bench["toks"], bench["blob"]
    err: dict = {}

    def prove(group=None):
        profiling.enable()
        profiling.reset()
        t0 = time.time()
        with mesh_scope(make_mesh(shards, device=dev, group=group)):
            proof, io = AtlasProver(pp, device=dev).prove([toks])
        torch.cuda.synchronize()
        wall = time.time() - t0
        phases = {name: round(w, 6) for name, w, _ in profiling.events()
                  if not name.startswith(" ")}
        phases.update(span_sums("mesh_"))
        return proof, io, wall, phases

    largest: dict = {}
    with check_mesh_kernels(results, err, largest) as seen:
        prove()  # warm-up, each shape class held against its plain version
    timed_mesh = time_mesh_kernels(dev, results, largest)
    del largest
    out = {}
    verifier = AtlasVerifier(pp)
    # a CPU rehearsal launches no kernel and has no NCCL
    need = MESH if dev.type == "cuda" else ()
    backend = "nccl" if dev.type == "cuda" else "gloo"
    with tempfile.TemporaryDirectory() as tmp:
        for name in ("virtual", backend):
            group = None
            if name == backend:
                dist.init_process_group(
                    backend, store=dist.FileStore(os.path.join(tmp, "store"),
                                                  1), rank=0, world_size=1)
                group = dist.group.WORLD
            try:
                (proof, io, wall, phases), tele = counted(
                    results, need, lambda: prove(group))
            finally:
                if group is not None:
                    dist.destroy_process_group()
            d = tele["decisions"]
            if serde.serialize_proof(proof) != blob:
                raise AssertionError(f"{name} mesh proof bytes differ from "
                                     f"the gate path's")
            if not verifier.verify(proof, io):
                raise AssertionError(f"verifier rejected the {name} mesh "
                                     f"proof")
            for k in ("mesh_reduction", "mesh_iop"):
                if not d.get(k, "").startswith("ENGAGED"):
                    raise AssertionError(f"{name}: {k} did not engage: {d}")
            out[name] = {"prove_s": wall, "phases": phases,
                         "mesh_iop": d["mesh_iop"],
                         "mesh_iop_declined": d.get("mesh_iop:declined"),
                         "mesh_reduction": d["mesh_reduction"],
                         "launches": tele["launches"]}
    results["launches_mesh_prove"] = out["virtual"]["launches"]
    keccak = mesh_keccak(dev, results, err, shards)
    results["mesh_timed"] = timed_mesh
    results["mesh_err"] = err

    # the sharded product round: the card's kernels against its plain
    # version on the card (FR planes, the reference's round op by op) and
    # Python integers, timed beside its bound
    import random
    rng = random.Random(log_t)
    T = 1 << log_t
    eq = [rng.randrange(M.FR.P) for _ in range(T)]
    p = [rng.randrange(M.FR.P) for _ in range(T)]
    r = rng.randrange(M.FR.P)
    eqt, pt, rt = (M.mont_tensor(v).to(dev) for v in (eq, p, [r]))
    m = make_mesh(shards, device=dev)
    blocks = (M.shard_blocks(m, eqt), M.shard_blocks(m, pt), rt)
    round_fn = M.sharded_product_round(m)
    telemetry.reset()
    res = [x.cpu() for x in round_fn(*blocks)]
    launches = telemetry.snapshot()["launches"]
    if dev.type == "cuda" and not all(launches.get(k) for k in (
            "rows_points", "reduction_bind")):
        raise AssertionError(f"the product round did not launch kernels 7 "
                             f"and 4: {launches}")
    plain = [x.cpu() for x in M.product_round_planes(eqt, pt, rt)]
    got = res[:2] + [x.reshape(-1, 4) for x in res[2:]]
    if not all(torch.equal(a, b) for a, b in zip(got, plain)):
        raise AssertionError("sharded product round: the card differs from "
                             "the plain version")
    want = M.product_round_plain(eq, p, r)
    if (M.ints_of(res[0])[0], M.ints_of(res[1])[0], M.ints_of(res[2]),
            M.ints_of(res[3])) != want:
        raise AssertionError("sharded product round differs from Python "
                             "integers")
    product_round = {"elements": T, "equal_plain_and_python_ints": True,
                     "launches": launches}
    if dev.type == "cuda":
        # bytes: eq and p read, eq' and p' written; products: m0's and
        # m2's T/2 each and the two binds' T/2 each
        b, by = bound(2 * T, 3 * T * FR_BYTES, results["imad_peak"],
                      IMADS_PER_MUL)
        call = cuda_ms(lambda: round_fn(*blocks), 3)[0]
        kms = kernels_ms(lambda: round_fn(*blocks), ("rows_points",
                                                     "reduction_bind"), 3)
        ms = all_device_ms(lambda: round_fn(*blocks), 3)
        plain_ms = cuda_ms(lambda: M.product_round_planes(eqt, pt, rt),
                           1)[0]
        product_round.update(ms=ms, kernels_ms=kms, call_ms=call,
                             bound_ms=b, bound_by=by, share=b / ms,
                             plain_ms=plain_ms)
    del blocks, eqt, pt, round_fn
    t0 = time.time()
    dryrun_multichip(shards, device=dev)
    dry_s = time.time() - t0
    say("mesh", json.dumps({
        "shards": shards, "proof_bytes": len(blob),
        "bytes_equal_gate_path": True, "verified": True,
        "gate_path": bench["gate"], "mesh": out,
        "classes_held": sorted(f"{k} {c}" for k, c in seen),
        "kernels_at_largest_launch": timed_mesh,
        "max_abs_err": err,
        "product_round": product_round,
        "keccak_bench_small": keccak,
        "dryrun_multichip_s": dry_s}))


# ---------------------------------------------------------------------------
# phase 14: kernel 9, the exact matrix product, and the quantized forward
# ---------------------------------------------------------------------------

EXACT_SHIFTS = (0, 1, 7, 8, 12, 16, 24)
# kernel 9's tile edges: 16 x 128 tiles for M <= 16, 64 x 64 above, k32
# slices; each M beside an N of the same list
EXACT_EDGES = (1, 15, 16, 17, 63, 64, 65, 129)
EXACT_EDGE_K = (1, 31, 32, 33, 4096)
# the H100 SXM's dense int8 tensor-core rate (NVIDIA datasheet)
INT8_OPS_PER_S = 1.979e15
# the timed shapes: a GPT-2 sized product, and a GPT-2 MLP product at seq
# 16 (examples/gpt2_style.py's dims padded to 1024)
EXACT_TIMED = ((1024, 768, 3072), (16, 1024, 4096))


def exact_cases(gen: np.random.Generator) -> list:
    """(name, a (B, M, K), b (B, K, N), modes) int32: the example MLP's
    products, the one-block transformer's (16 x 16 x 16) and the bench's
    attention products batched (4 heads, seq 64, d16), K = 4096 at the
    extremes, kernel 9's tile edges (EXACT_EDGES x EXACT_EDGE_K, random
    i32), a batch with a split depth, and the wrapping mode alone at K =
    16,384 (two 8,192-deep chunks) at the extremes."""
    lo, hi = -(2**31), 2**31 - 1
    both, wrap = (False, True), (True,)
    rnd = lambda shape, lim: gen.integers(-lim, lim, size=shape,
                                          dtype=np.int32)
    mixed = np.full((1, 8, 4096), lo, np.int32)
    mixed[..., ::3] = hi
    deep = np.full((1, 3, 16384), lo, np.int32)
    deep[..., ::3] = hi
    cases = [
        ("mlp 8x64x128", rnd((1, 8, 64), 2**10), rnd((1, 64, 128), 2**8),
         both),
        ("mlp 8x128x32", rnd((1, 8, 128), 2**10), rnd((1, 128, 32), 2**8),
         both),
        ("block 16x16x16", rnd((1, 16, 16), 2**12), rnd((1, 16, 16), 2**12),
         both),
        ("heads 4x64x16x64", rnd((4, 64, 16), 2**14),
         rnd((4, 16, 64), 2**14), both),
        ("heads 4x64x64x16", rnd((4, 64, 64), 2**14),
         rnd((4, 64, 16), 2**14), both),
        ("K4096 max", np.full((1, 8, 4096), hi, np.int32),
         np.full((1, 4096, 8), hi, np.int32), both),
        ("K4096 min", np.full((1, 8, 4096), lo, np.int32),
         np.full((1, 4096, 8), lo, np.int32), both),
        ("K4096 mixed", mixed, np.full((1, 4096, 8), hi, np.int32), both),
        ("K4096 random", rnd((1, 65, 4096), 2**31),
         rnd((1, 4096, 70), 2**31), both),
        ("batched split 4x33x1000x65", rnd((4, 33, 1000), 2**31),
         rnd((4, 1000, 65), 2**31), both),
        ("K16384 max", np.full((1, 3, 16384), hi, np.int32),
         np.full((1, 16384, 5), hi, np.int32), wrap),
        ("K16384 min", np.full((1, 3, 16384), lo, np.int32),
         np.full((1, 16384, 5), lo, np.int32), wrap),
        ("K16384 mixed", deep, np.full((1, 16384, 5), hi, np.int32), wrap)]
    for K in EXACT_EDGE_K:
        for i, M in enumerate(EXACT_EDGES):
            N = EXACT_EDGES[(i + EXACT_EDGE_K.index(K)) % len(EXACT_EDGES)]
            cases.append((f"edge {M}x{K}x{N}", rnd((1, M, K), 2**31),
                          rnd((1, K, N), 2**31), both))
    return cases


def exact_class(a, b, wrap: bool) -> tuple:
    """The shape class kernel 9's wrapper records for these operands."""
    from jolt_atlas_tpu_torch import torchexec
    B, M, K = a.shape
    sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    return torchexec.exact_case(B, wrap, torchexec.exact_plan(
        B, M, K, b.shape[2], sms)[1])


def exact_bounds(B: int, M: int, K: int, N: int, imad: float) -> dict:
    """Kernel 9's least time: the larger of its 16 int8 limb products on
    the tensor cores (2 operations a multiply-add) and its bytes; beside
    it the 2-IMAD-a-product bound of a scalar design."""
    nbytes = 4 * B * (M * K + K * N + M * N)
    ops_ms = 16 * 2 * B * M * K * N / INT8_OPS_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    imad_ms = bound(B * M * K * N, nbytes, imad, 2)[0]
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "bound_imad_ms": imad_ms}


def time_exact(dev, gen, M: int, K: int, N: int, imad: float) -> dict:
    """Kernel 9 at (1, M, K) x (1, K, N), i32 in a scale-2^12 range, shift
    12: device ms after an L2 flush (10 calls), bit-equal to its plain
    version, beside both bounds and 16 torch._int_mm limb products with b
    row-major and column-major."""
    from jolt_atlas_tpu_torch import torchexec
    a = torch.from_numpy(gen.integers(-2**14, 2**14, size=(1, M, K),
                                      dtype=np.int32)).to(dev)
    b = torch.from_numpy(gen.integers(-2**14, 2**14, size=(1, K, N),
                                      dtype=np.int32)).to(dev)
    ms, call, got = device_ms(lambda: torchexec.exact_matmul(a, b, 12), 10,
                              "exact_matmul", cold=True)
    plain_ms, want = cuda_ms(lambda: torchexec.exact_matmul_plain(a, b, 12),
                             3)
    err = require_equal(f"exact_matmul ({M}x{K}x{N})", [got], [want])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rec = {"shape": f"{M}x{K}x{N}, shift 12, after an L2 flush", "ms": ms,
           "call_ms": call, "plain_ms": plain_ms, "max_abs_err": err,
           "plan": dict(zip(("tile", "splits", "kchunk"),
                            torchexec.exact_plan(1, M, K, N, sms))),
           **exact_bounds(1, M, K, N, imad)}
    rec.update(share=rec["bound_ms"] / ms,
               share_imad=rec["bound_imad_ms"] / ms)
    a8 = torch.randint(-128, 128, (M, K), dtype=torch.int8, device=dev)
    b8 = torch.randint(-128, 128, (K, N), dtype=torch.int8, device=dev)
    b8c = b8.t().contiguous().t()  # column-major: cuBLASLt's IMMA layout
    for key, bb in (("int_mm_16_ms", b8), ("int_mm_16_colmajor_ms", b8c)):
        try:  # the yardstick only, not the port's path
            rec[key] = cuda_ms(lambda: [torch._int_mm(a8, bb)
                                        for _ in range(16)], 5)[0]
        except RuntimeError as e:
            rec[key], rec[key + "_error"] = None, str(e).splitlines()[0]
    return rec


def phase_exact(dev, results, timed=EXACT_TIMED) -> None:
    """Kernel 9 bit-equal to its plain version (run on the card) at
    ``exact_cases`` in their modes and every shift of EXACT_SHIFTS,
    through the einsum lowering of the transformer's equations (strided
    operands), and timed at ``timed`` beside its bounds; its SASS holds
    tensor-core instructions and no spill; entry() on the card against
    the CPU forward."""
    from jolt_atlas_tpu_torch import torchexec
    from jolt_atlas_tpu_torch.entry import entry
    gen = np.random.default_rng(1414)
    err, n = 0.0, 0
    for name, a, b, modes in exact_cases(gen):
        ta, tb = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
        for wrap in modes:
            for shift in EXACT_SHIFTS:
                err = max(err, require_equal(
                    f"exact_matmul ({name}, wrap {wrap}, shift {shift})",
                    [torchexec.exact_matmul(ta, tb, shift, wrap)],
                    [torchexec.exact_matmul_plain(ta, tb, shift, wrap)]))
                n += 1
            checked(results, "exact_matmul", exact_class(ta, tb, wrap))
    # the transformer's equations through the lowering (strided operands)
    for eq, sa, sb in [("mk,kn->mn", (16, 16), (16, 16)),
                       ("mk,nk->mn", (16, 16), (16, 16)),
                       ("mk,nk->mn", (40, 300), (72, 300)),
                       ("bi,ij->bj", (1, 32), (32, 16)),
                       ("hmk,hnk->hmn", (4, 64, 16), (4, 64, 16)),
                       ("hmn,hnk->hmk", (4, 64, 64), (4, 64, 16)),
                       ("bmk,kn->bmn", (3, 24, 200), (200, 40))]:
        x = torch.from_numpy(gen.integers(-2**14, 2**14, size=sa,
                                          dtype=np.int32))
        y = torch.from_numpy(gen.integers(-2**14, 2**14, size=sb,
                                          dtype=np.int32))
        err = max(err, require_equal(
            f"einsum {eq} on the card", [torchexec.einsum_rescale(
                eq, x.to(dev), y.to(dev), 8).cpu()],
            [torchexec.einsum_rescale(eq, x, y, 8)]))
        n += 1
    if dev.type == "cuda":
        from jolt_atlas_tpu_torch.device import build, kernel_report
        ptx = kernel_report.parse_ptxas(build.ptxas_report())
        sass = kernel_report.sass(build.CUDA_SRC)
        for k in EXACT_KERNELS[:2]:
            if not sass[k]["tensor"]:
                raise AssertionError(f"{k}: no tensor-core instruction in "
                                     f"its SASS: {sass[k]}")
        compiled = {k: {**ptx[k], "sass_tensor": sass[k]["tensor"],
                        "sass_instructions": sass[k]["instructions"]}
                    for k in EXACT_KERNELS}
    else:
        compiled = None
    # the forward, the path that launches kernel 9
    def forward():
        fn, args = entry(dev)
        t0 = time.time()
        got = fn(*args)
        torch.cuda.synchronize()
        return got, time.time() - t0

    (out, fwd_s), tele = counted(
        results, ("exact_matmul",) if dev.type == "cuda" else (), forward)
    cfn, cargs = entry(device="cpu")
    if not all(torch.equal(o.cpu(), w) for o, w in zip(out, cfn(*cargs))):
        raise AssertionError("entry() on the card differs from the CPU "
                             "forward")
    recs = []
    for M, K, N in timed:
        recs.append(time_exact(dev, gen, M, K, N, results["imad_peak"]))
        err = max(err, recs[-1]["max_abs_err"])
        checked(results, "exact_matmul", torchexec.exact_case(
            1, False, recs[-1]["plan"]["splits"]))
    results["exact_matmul"] = {**recs[0], "max_abs_err": err,
                               "timed": recs, "compiled": compiled}
    say("exact", json.dumps({
        "compared": n, "max_abs_err": err,
        "entry": {"outputs": [list(o.shape) for o in out],
                  "forward_s": fwd_s, "launches": tele["launches"],
                  "equal_cpu_forward": True},
        "timed": recs, "compiled": compiled}))



# ---------------------------------------------------------------------------
# phase 15: the model entry points on the card
# ---------------------------------------------------------------------------

MSM = ("bucket_accumulate", "bucket_combine")
# the GPT-2-style slice's flags beyond gpt2_style's own (2 blocks, 4 heads,
# d128, vocab 8192)
GPT2_ARGV = ["--gen", "1"]


@contextlib.contextmanager
def capture_msms(store: list):
    """Keep (site, counts, as one batch) of every routed MSM call of the
    proves inside: the commits and the witness (msm_batch_routed, each MSM
    by its own route) and the fold batch (msm_fold_batch)."""
    from jolt_atlas_tpu_torch.device import split as dsplit
    real = (dsplit.msm_batch_routed, dsplit.msm_fold_batch)

    def routed(dev, gate, prep, packed, counts, site):
        store.append((site, list(counts), False))
        return real[0](dev, gate, prep, packed, counts, site)

    def folds(dev, gate, prep, packed, counts, site):
        store.append((site, list(counts), True))
        return real[1](dev, gate, prep, packed, counts, site)

    dsplit.msm_batch_routed, dsplit.msm_fold_batch = routed, folds
    try:
        yield store
    finally:
        dsplit.msm_batch_routed, dsplit.msm_fold_batch = real


def msm_plan(gate, msms: list) -> dict:
    """The gate's route for each MSM size of a prove (capture_msms): a
    batch routed MSM by MSM, [route, device points, why] a size; the fold
    batch whole on the device, or its first MSM's split."""
    plan = {}
    for site, counts, batch in msms:
        if batch:
            whole, why = gate.engage(sum(counts))
            plan[f"{site} batch of {len(counts)}, {sum(counts)} points"] = {
                "device_whole": whole, "why": why,
                "first_split": list(gate.split_plan(counts[0]))}
        else:
            for n in sorted(set(counts)):
                plan[f"{site} {n}"] = list(gate.choose(n))
    return plan


def relu_mlp():
    """tests/test_zk_pipeline.py's _relu_mlp (16 -> relu(16) -> two
    einsums added) on the port's builder, weights and input from seed
    0x2B5: (model, inputs)."""
    from jolt_atlas_tpu_torch.frontend import ModelBuilder
    from jolt_atlas_tpu_torch.frontend.quantize import quantize_tensor
    rng = np.random.default_rng(0x2B5)
    b = ModelBuilder(scale=8)
    x = b.input((1, 16))
    w = [b.constant(quantize_tensor(rng.standard_normal((16, 16)), 8))
         for _ in range(3)]
    h = b.relu(b.einsum("bi,ij->bj", [x, w[0]]))
    b.output(b.add(b.einsum("bi,ij->bj", [h, w[1]]),
                   b.einsum("bi,ij->bj", [h, w[2]])))
    return b.build(), [quantize_tensor(rng.standard_normal((1, 16)), 8)]


def dory_e2e():
    """tests/test_dory.py's e2e model (16 -> relu(16)) on the port's
    builder, from seed 0xD0FF: (model, inputs)."""
    from jolt_atlas_tpu_torch.frontend import ModelBuilder
    from jolt_atlas_tpu_torch.frontend.quantize import quantize_tensor
    rng = np.random.default_rng(0xD0FF)
    b = ModelBuilder(scale=8)
    x = b.input((1, 16))
    w1 = b.constant(quantize_tensor(rng.standard_normal((16, 16)), 8))
    b.output(b.relu(b.einsum("bi,ij->bj", [x, w1])))
    return b.build(), [quantize_tensor(rng.standard_normal((1, 16)), 8)]


def path_record(out: dict, tele: dict) -> dict:
    """What one run of a phase-15 path and its counted telemetry report:
    its seconds (and phase spans, for a driver run: prove_model's dict)
    and proof size, its engines' decisions, launches and dispatches."""
    return {**{k: out[k] for k in ("setup_s", "prove_s", "verify_s",
                                   "phases") if k in out},
            "proof_bytes": len(out["blob"]),
            "decisions": tele["decisions"], "launches": tele["launches"],
            "dispatches": tele["dispatches"]}


def models_path(results, name: str, required, fn, err, seen,
                largest: dict | None = None, merged: bool = False):
    """One phase-15 path on the card, run twice: first with every kernel
    shape it launches held against its plain version (hold_kernels, which
    keeps ``largest``), then counted, where each kernel of ``required``
    and of the first run's launches must launch. ``merged``: one run, held
    and counted at once (its seconds then hold the plain versions'). The
    counted launches are added to results["launches_models"]. Returns the
    counted run's result and telemetry."""
    from jolt_atlas_tpu_torch.device import telemetry

    def held():
        with hold_kernels(results, err, name, largest=largest, seen=seen):
            return fn()
    if merged:
        out, tele = counted(results, required, held)
    else:
        telemetry.reset()
        held()
        need = tuple(sorted(set(required) | set(telemetry.launches())))
        out, tele = counted(results, need, fn)
    total = results.setdefault("launches_models", {})
    for k, v in tele["launches"].items():
        total[k] = total.get(k, 0) + v
    return out, tele


def card_vs_host(dev, results, name: str, required, card, host, err,
                 seen, largest: dict | None = None, merged: bool = False):
    """One phase-15 path: ``card()`` through models_path (its kernel
    shapes held, then counted, or both in one run when ``merged``;
    ``required``, on a CUDA ``dev``, must launch), ``host()`` counted. Each
    returns a dict with the proof's bytes under "blob"; they must be equal.
    Returns the card run's result and telemetry, and the report of both
    runs."""
    out, tele = models_path(results, name, required if dev.type == "cuda"
                            else (), card, err, seen, largest, merged)
    host_out, host_tele = counted(results, (), host)
    if out["blob"] != host_out["blob"]:
        raise AssertionError(f"{name}: the card's bytes differ from the "
                             "host path's")
    return out, tele, {"bytes_equal": True, "verified": True,
                       "held_in_the_counted_run": merged,
                       "card": path_record(out, tele),
                       "host": path_record(host_out, host_tele)}


def time_largest(results, largest: dict) -> dict:
    """Kernels 2-5 and 7 at the largest launch a path made of each
    (hold_kernels' ``largest``): device ms after an L2 flush, the call's
    ms and the plain version's ms on the card, beside the bound of what
    this data needs (as phases 4, 5, 11 and 12 count it)."""
    from jolt_atlas_tpu_torch.device import msm as dmsm
    from jolt_atlas_tpu_torch.device import reduction as dred
    from jolt_atlas_tpu_torch.device import rows as drows
    out = {}
    for kernel, (_, a, _) in sorted(largest.items()):
        if kernel == "bucket_accumulate":
            bases, lanes = a
            L, E = lanes[2].shape[0] - 1, lanes[0].shape[0]
            c = next(c for c in range(3, 24)
                     if dmsm.window_shape(c)[0] * dmsm.window_shape(c)[1]
                     == L)
            n = E // dmsm.window_shape(c)[0]
            call = lambda: dmsm.bucket_accumulate(bases, lanes)
            plain = lambda: dmsm.bucket_accumulate_plain(bases, lanes)
            (adds, nbytes), design = accumulate_work(lanes, n, c)
            shape = f"n={n} c={c}"
        elif kernel == "bucket_combine":
            acc, c = a
            k = acc[0].shape[0]
            G = dmsm.combine_groups(k, c, torch.cuda.get_device_properties(
                acc[0].device).multi_processor_count)
            call = lambda: dmsm.bucket_combine(acc, c)
            plain = lambda: dmsm.bucket_combine_plain(acc, c, G)
            adds, nbytes = combine_work(k, c)
            design = combine_design(k, c, G)
            shape = f"k={k} c={c} G={G}"
        elif kernel == "reduction_q0":
            _, tab, lanep, lanes, lg = a
            call, plain = lambda: dred.q0(*a), lambda: dred.q0_plain(*a)
            adds, imads = q0_lazy_imads(lanep.cpu(), lg,
                                        dred.Q0_PER_THREAD), 1
            nbytes = ((lanes << (lg - 1)) + tab.shape[0] + 2 * lanes) \
                * FR_BYTES
            shape = f"{lanes} lanes of 2^{lg}"
        elif kernel == "reduction_bind":
            jp, lanes, lg = a[4:]
            call, plain = lambda: dred.bind(*a), lambda: dred.bind_plain(*a)
            nc, nn = jp << lg, (lanes - jp) << lg
            adds, nbytes, imads = nc, (3 * nc + 2 * nn) * FR_BYTES, \
                IMADS_PER_MUL
            shape = f"{jp} of {lanes} lanes continue, 2^{lg} each"
        elif kernel == "rows_points":
            x, n, nevals, terms, w = a
            call = lambda: drows.points(*a)
            plain = lambda: drows.points_plain(*a)
            P = x.shape[0] // n
            adds, imads = rows_products(*a)[0], IMADS_PER_MUL
            nbytes = (P * n + nevals + w[0].shape[0]) * FR_BYTES
            shape = f"{P} rows of {n}, {terms.T} terms, {nevals} points"
        else:
            continue  # kernel 6: its lanes are phase 11's
        ms, call_ms, got = device_ms(call, 3, kernel, cold=True)
        plain_ms, want = cuda_ms(plain, 1, warmup=False)
        pair = (got, want) if isinstance(got, tuple) else ([got], [want])
        require_equal(f"{kernel} ({shape}, timed)", *pair)
        out[kernel] = {"shape": shape, "ms": ms, "call_ms": call_ms,
                       "plain_ms": plain_ms}
        if kernel in MSM:  # kernels 2 and 3: both designs' bounds
            out[kernel].update(msm_bound(results, design, (adds, nbytes),
                                         ms)[0])
        else:
            b, by = bound(adds, nbytes, results["imad_peak"], imads)
            out[kernel].update(bound_ms=b, bound_by=by, share=b / ms)
    return out


def models_gpt2(dev, results, err, seen) -> dict:
    """The GPT-2-style slice (GPT2_ARGV: GPT-2 cut to 2 blocks, 4 heads,
    d128, vocab 8192) through nanogpt_style.run, the gate path against the
    host path (card_vs_host), its 2^20 - 2^18 point folds on the card;
    a flipped commitment rejected; each kernel timed at its largest
    launch; the gate's plan for each MSM size of the prove; the largest
    MSM on the device and the host, in turns."""
    from jolt_atlas_tpu_torch import serde
    from jolt_atlas_tpu_torch.curve.points import g1_generator
    from jolt_atlas_tpu_torch.device import gate as dgate
    from jolt_atlas_tpu_torch.examples import gpt2_style, nanogpt_style
    from jolt_atlas_tpu_torch.verifier import AtlasVerifier
    msms, largest = [], {}

    def run(device):
        return nanogpt_style.run(gpt2_style.args(GPT2_ARGV
                                                 + ["--device", device]))

    def card():
        with capture_msms(msms):
            return run(dev.type)
    out, _, report = card_vs_host(dev, results, "gpt2_style", MSM, card,
                                  lambda: run("cpu"), err, seen, largest)
    timed_largest = time_largest(results, largest) if dev.type == "cuda" \
        else {}
    results["models_timed"] = timed_largest
    del largest
    bad = serde.deserialize_proof(out["blob"])
    pid = sorted(bad.commitments)[0]
    bad.commitments[pid] = bad.commitments[pid] + g1_generator()
    if AtlasVerifier(out["pp"]).verify(bad, out["io"]):
        raise AssertionError("gpt2_style: a flipped commitment verified")
    gate = dgate.for_device(dev)
    n = max(c for _, counts, _ in msms for c in counts)
    srs = out["pp"].srs
    prep = srs.prepared_bases()
    engine = srs.device_bases(dev, dgate.forced("device"))
    raw = dgate.random_scalars(n, 2121)
    want = prep.msm_packed(raw, n)
    ms = {"device": [], "host": []}
    for which in ("device", "host", "host", "device", "device", "host"):
        t0 = time.perf_counter()
        got = (engine.msm_packed(raw, n) if which == "device"
               else prep.msm_packed(raw, n))
        ms[which].append((time.perf_counter() - t0) * 1e3)
        if got != want:
            raise AssertionError(f"{n}-point MSM: the {which} differs")
    a, model = gpt2_style.args(GPT2_ARGV), out["model"]
    return {"model": f"{a.blocks} blocks, {a.heads} heads, d{a.dim}, seq "
                     f"{a.seq}, vocab {a.vocab}, scale 2^{a.scale}, "
                     f"{len(model.graph.nodes)} nodes, largest polynomial "
                     f"2^{model.graph.max_num_vars()}",
            "argv": GPT2_ARGV, "tamper_rejected": True, **report,
            "msm_plan": msm_plan(gate, msms),
            "plan_2e20_2e21": {str(m): list(gate.choose(m)) for m in (
                1 << 20, (1 << 21) - 3)},
            "kernels_at_largest_launch": timed_largest,
            "largest_msm": {"n": n, "ms_in_turns": ms,
                            "device_min_ms": min(ms["device"]),
                            "host_min_ms": min(ms["host"])}}


def models_qwen(dev, results, err, seen) -> dict:
    """qwen_slice from the committed ONNX through qwen_style.run: the gate
    path against the host path (card_vs_host)."""
    from jolt_atlas_tpu_torch.examples import qwen_style

    def run(device):
        return qwen_style.run(qwen_style.parser().parse_args(
            ["--device", device]))
    out, _, report = card_vs_host(dev, results, "qwen_slice", MSM,
                                  lambda: run(dev.type), lambda: run("cpu"),
                                  err, seen, merged=True)
    return {"nodes": len(out["model"].graph.nodes), **report}


ZK = MSM + ("reduction_bind", "rows_points", "rows_from_i64")


def models_zk(dev, results, err, seen) -> dict:
    """prove_zk on BENCH_SMALL (nanogpt_style at its default shape) and on
    _relu_mlp under one seeded blinding stream: the card with the MSM and
    rows engines forced against the host path (card_vs_host); verify_zk
    accepts (inside the driver); the masked opening's MSMs dispatched to
    the card, the reduction on the host ("zk")."""
    import argparse

    from jolt_atlas_tpu_torch.device import gate as dgate
    from jolt_atlas_tpu_torch.device import rows as drows
    from jolt_atlas_tpu_torch.examples import nanogpt_style
    mlp, mlp_in = relu_mlp()
    cases = {
        "bench_small": lambda device, **kw: nanogpt_style.run(
            nanogpt_style.parser().parse_args(["--zk", "--gen", "1",
                                               "--device", device]), **kw),
        "relu_mlp": lambda device, **kw: nanogpt_style.prove_model(
            mlp, mlp_in, argparse.Namespace(device=device, zk=True,
                                            trace=False), **kw)}
    report = {}
    for case, run in cases.items():
        def card():
            with nanogpt_style.seeded_blinding():
                return run(dev.type, msm_gate=dgate.forced("device"),
                           iop_gate=drows.forced())

        def host():
            with nanogpt_style.seeded_blinding():
                return run("cpu")
        _, tele, report[case] = card_vs_host(dev, results, f"zk {case}", ZK,
                                             card, host, err, seen,
                                             merged=True)
        d, why = tele["dispatches"], tele["decisions"]
        for site in ("msm:hyperkzg_fold", "msm:hyperkzg_witness"):
            if not d.get(site):
                raise AssertionError(f"zk {case}: no device MSM dispatch "
                                     f"at {site}: {tele}")
        if why.get("reduction") != "zk":
            raise AssertionError(f"zk {case}: reduction decision "
                                 f"{why.get('reduction')}")
    return report


def prove_timed(pp, inputs, **how) -> dict:
    """One AtlasProver(pp, **how).prove of ``inputs``: its serialized
    bytes, io and seconds."""
    from jolt_atlas_tpu_torch import serde
    from jolt_atlas_tpu_torch.prover import AtlasProver
    t0 = time.time()
    proof, io = AtlasProver(pp, **how).prove(inputs)
    return {"blob": serde.serialize_proof(proof), "io": io,
            "prove_s": time.time() - t0}


def models_dory(dev, results, err, seen) -> dict:
    """tests/test_dory.py's e2e model with pcs="dory": the opening
    reduction and the rows engine forced on the card against the host
    path (card_vs_host); kernels 4-8 launch; the port verifies."""
    from jolt_atlas_tpu_torch import serde
    from jolt_atlas_tpu_torch.device import reduction as dred
    from jolt_atlas_tpu_torch.device import rows as drows
    from jolt_atlas_tpu_torch.preprocessing import AtlasPreprocessing
    from jolt_atlas_tpu_torch.verifier import AtlasVerifier
    model, inputs = dory_e2e()
    pp = AtlasPreprocessing.preprocess(model, pcs="dory")
    out, _, report = card_vs_host(
        dev, results, "dory", REDUCTION + ROWS,
        lambda: prove_timed(pp, inputs, device=dev,
                            reduction_gate=dred.forced(),
                            iop_gate=drows.forced()),
        lambda: prove_timed(pp, inputs, device="cpu"), err, seen,
        merged=True)
    if not AtlasVerifier(pp).verify(serde.deserialize_proof(out["blob"]),
                                    out["io"]):
        raise AssertionError("dory: the verifier rejected the card's proof")
    return report


def models_keccak(dev, results, err, seen) -> dict:
    """The full bench nanoGPT (phase 9's) under KeccakTranscript with the
    default gates against the host path (card_vs_host): the reduction
    declines, the MSM and rows engines engage, the port verifies."""
    from jolt_atlas_tpu_torch import serde
    from jolt_atlas_tpu_torch.transcripts import KeccakTranscript
    from jolt_atlas_tpu_torch.verifier import AtlasVerifier
    pp, toks = results["bench"]["pp"], results["bench"]["toks"]
    out, tele, report = card_vs_host(
        dev, results, "keccak", MSM + ROWS,
        lambda: prove_timed(pp, [toks], device=dev,
                            transcript_factory=KeccakTranscript),
        lambda: prove_timed(pp, [toks], device="cpu",
                            transcript_factory=KeccakTranscript),
        err, seen, merged=True)
    why = tele["decisions"]
    if dev.type == "cuda":
        if why.get("reduction") != "transcript not BLAKE2b":
            raise AssertionError(f"keccak: reduction decision "
                                 f"{why.get('reduction')}")
        for engine in ("msm", "iop"):
            if not why.get(engine, "").startswith("ENGAGED"):
                raise AssertionError(f"keccak: {engine} did not engage: "
                                     f"{why}")
    if not AtlasVerifier(pp, KeccakTranscript).verify(
            serde.deserialize_proof(out["blob"]), out["io"]):
        raise AssertionError("keccak: the verifier rejected the proof")
    return report


def phase_models(dev, results) -> None:
    """The model entry points on the card, each against the host path's
    bytes: the GPT-2-style slice (2 blocks, d128), qwen_slice from the
    committed ONNX, prove_zk, Dory and the Keccak transcript; every
    kernel shape they launch held against its plain version."""
    err: dict = {}
    seen: set = set()
    for name, step in (("gpt2_style", models_gpt2),
                       ("qwen_slice", models_qwen), ("zk", models_zk),
                       ("dory", models_dory), ("keccak", models_keccak)):
        t0 = time.time()
        rec = step(dev, results, err, seen)
        say("models", json.dumps({"path": name, "seconds": time.time() - t0,
                                  **rec}))
    for k, v in err.items():
        results[k]["max_abs_err"] = max(results[k]["max_abs_err"], v)
    say("models", json.dumps({"classes_held": len(seen), "max_abs_err": err,
                              "launches_models": results[
                                  "launches_models"]}))


# ---------------------------------------------------------------------------
# phase 16: the reference's flagship, GPT-2 at its padded 125M shape
# ---------------------------------------------------------------------------

# GPT-2 at the reference's padded 125M shape (examples/gpt2_style.py --full:
# dim 1024, 16 heads, vocab 50257 padded to 65536, seq 16, scale 2^12), its
# depth cut to FLAGSHIP_BLOCKS: the blocks are all alike, so one is a whole
# period of the layer pattern, and the joint opening is 2^24 points at any
# depth (LOG_K_CHUNK + log2(16 x 65536)); fewer blocks make the host IOP's
# share smaller than in the 12-block model
FLAGSHIP_BLOCKS = 1
FLAGSHIP_ARGV = ["--full", "--blocks", str(FLAGSHIP_BLOCKS), "--gen", "0"]
FLAGSHIP_VARS = 24
# kernel 2 is held at the flagship's class (c = 16, level 1 a thread a
# chunk, a lane far over 32 x the mean) on the 2^20 scalars of the largest
# fold that hold most of its deepest lane, at runs of 4 (16 windows x 2^20
# entries over 2^19 lanes: 8 runs a lane), where its plain version takes
# seconds; kernels
# 3-7 on every class the prove launches
FLAGSHIP_HOLD_N = 1 << 20
FLAGSHIP_HOLD_RUN = 4
FLAGSHIP_HELD = ("bucket_combine", "reduction_bind", "reduction_q0",
                 "reduction_tail", "rows_points") + ONEHOT + BIND


@contextlib.contextmanager
def keep_msm_scalars(store: dict):
    """Keep (packed scalars, points) of the fold batch's first (largest)
    MSM and of the witness MSM of the proves inside, as store["fold"] and
    store["witness"]."""
    from jolt_atlas_tpu_torch.device import split as dsplit
    real = (dsplit.msm_batch_routed, dsplit.msm_fold_batch)

    def routed(dev, gate, prep, packed, counts, site):
        if site == "hyperkzg_witness":
            store["witness"] = (packed[0], counts[0])
        return real[0](dev, gate, prep, packed, counts, site)

    def folds(dev, gate, prep, packed, counts, site):
        store["fold"] = (packed[0], counts[0])
        return real[1](dev, gate, prep, packed, counts, site)

    dsplit.msm_batch_routed, dsplit.msm_fold_batch = routed, folds
    try:
        yield store
    finally:
        dsplit.msm_batch_routed, dsplit.msm_fold_batch = real


def accumulate_stages_ms(bases, lanes, want) -> tuple:
    """Device milliseconds (CUDA events, mean of 3 after a warm-up) of
    kernel 2's runs alone and of its levels, the join, alone on digit
    lanes, the levels repeated after a launch of the runs; the buckets the
    two leave are held equal to ``want``, the one-call result."""
    from jolt_atlas_tpu_torch.device import msm as dmsm
    L = lanes[2].shape[0] - 1
    outs = [torch.empty((L, 4), dtype=torch.int64, device=lanes[0].device)
            for _ in range(3)]
    parts = dmsm.accumulate_scratch(lanes)
    runs, _ = cuda_ms(lambda: dmsm.accumulate_launch(
        bases, lanes, outs, parts, stages=1), 3)
    join, _ = cuda_ms(lambda: dmsm.accumulate_launch(
        bases, lanes, outs, parts, stages=2), 3)
    if not all(torch.equal(o, w) for o, w in zip(outs, want)):
        raise AssertionError("kernel 2's runs and levels launched apart "
                             "differ from one launch of both")
    return runs, join


def lane_depth(lanes) -> dict:
    """The deepest lane (entries) of digit lanes beside the mean a lane."""
    starts = lanes[2]
    L = starts.shape[0] - 1
    deepest = int((starts[1:] - starts[:-1]).max())
    mean = int(starts[L]) / L
    return {"deepest": deepest, "mean": mean, "ratio": deepest / mean}


def time_flagship_msm(dev, results, engine, scal: dict, largest: dict,
                      err: dict, windows=(16, 18)) -> dict:
    """Kernels 2 and 3 at the flagship's largest launches beside their
    bounds (the design before the redesign's and their own): kernels 2
    and 3 on the witness's and the largest fold's digit lanes (kernel 2's
    runs and its levels, the join, also launched apart; kernel 3 on that
    one MSM's buckets), kernel 3 at the largest combine the prove
    launched; kernels 2 + 3 on the witness at c = 16 and c = 18
    (``windows``) in turns; kernel 2 held against its plain version at
    the class of these launches (FLAGSHIP_HOLD_N). These launches take
    milliseconds on data of gigabytes (no L2 flush needed); their device
    time is taken by CUDA events (``cuda_ms``, mean of 3 after a
    warm-up)."""
    from jolt_atlas_tpu_torch.device import msm as dmsm
    bases = engine.bases
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {}
    for site in ("witness", "fold"):
        raw, n = scal[site]
        c = dmsm._pick_c(n)
        lanes = dmsm.digit_lanes(dmsm.scalars_tensor(raw, n, dev), c, 0,
                                 engine.inf)
        ms, want = cuda_ms(lambda: dmsm.bucket_accumulate(bases, lanes), 3)
        runs_ms, join_ms = accumulate_stages_ms(bases, lanes, want)
        prev, design = accumulate_work(lanes, n, c)
        out[f"bucket_accumulate {site}"] = {
            "shape": f"n={n} c={c}", "ms": ms, "runs_ms": runs_ms,
            "join_ms": join_ms, "class": dmsm.accumulate_class(lanes),
            "levels": len(dmsm.accumulate_levels(lanes[0].shape[0])) - 1,
            **msm_bound(results, design, prev, ms)[0], **lane_depth(lanes)}
        acc = tuple(a.unsqueeze(0) for a in want)
        ms, _ = cuda_ms(lambda: dmsm.bucket_combine(acc, c), 3)
        G = dmsm.combine_groups(1, c, sms)
        out[f"bucket_combine {site}"] = {
            "shape": f"k=1 c={c} G={G} ({dmsm.combine_threads(c)} "
                     f"threads)", "ms": ms,
            **msm_bound(results, combine_design(1, c, G), combine_work(1, c),
                        ms)[0]}
        del acc
        if site == "fold":
            # the first of the FLAGSHIP_HOLD_N points that hold the most
            # of the deepest lane's entries
            starts = lanes[2]
            deep = int((starts[1:] - starts[:-1]).argmax())
            p = lanes[1][int(starts[deep]):int(starts[deep + 1])].long()
            ends = torch.searchsorted(p, p + FLAGSHIP_HOLD_N)
            first = int(p[int((ends - torch.arange(
                p.shape[0], device=p.device)).argmax())])
        del lanes, want
    raw, n = scal["witness"]
    sc = dmsm.scalars_tensor(raw, n, dev)
    turns = {c: [] for c in windows}
    for rep in range(3):
        for c in (windows if rep % 2 == 0 else windows[::-1]):
            lanes = dmsm.digit_lanes(sc, c)

            def both():
                acc = dmsm.bucket_accumulate(bases, lanes)
                return dmsm.bucket_combine(tuple(a.unsqueeze(0)
                                                 for a in acc), c)
            turns[c].append(cuda_ms(both, 1)[0])
            del lanes
    out["witness_k2_k3_by_window_ms"] = turns
    del sc
    size, (acc, c), _ = largest["bucket_combine"]
    k = acc[0].shape[0]
    ms, _ = cuda_ms(lambda: dmsm.bucket_combine(acc, c), 3)
    G = dmsm.combine_groups(k, c, sms)
    out["bucket_combine"] = {
        "shape": f"k={k} c={c} G={G} ({dmsm.combine_threads(c)} threads)",
        "ms": ms, **msm_bound(results, combine_design(k, c, G),
                              combine_work(k, c), ms)[0]}
    del acc
    raw, n = scal["fold"]
    m, run, c = min(n, FLAGSHIP_HOLD_N), FLAGSHIP_HOLD_RUN, dmsm._pick_c(n)
    a = max(0, min(first, n - m))
    lanes = dmsm.digit_lanes(dmsm.scalars_tensor(raw[32 * a:32 * (a + m)],
                                                 m, dev), c, a)
    case, depth = dmsm.accumulate_class(lanes, run), lane_depth(lanes)
    if case[1] != 1 or depth["deepest"] <= max(64, 32 * depth["mean"]):
        raise AssertionError("kernel 2's hold is not at the flagship's "
                             f"class: {case}, {depth}")
    got = dmsm.bucket_accumulate(bases, lanes, run=run)
    t0 = time.time()
    want = dmsm.bucket_accumulate_plain(bases, lanes, run)
    plain_s = time.time() - t0
    err["bucket_accumulate"] = max(err.get("bucket_accumulate", 0.0),
                                   require_equal(
        f"bucket_accumulate (the largest fold's scalars {a}..{a + m})", got,
        want))
    checked(results, "bucket_accumulate", case)
    out["bucket_accumulate held"] = {
        "shape": f"the largest fold's scalars [{a}, {a + m}), c={c}, runs "
                 f"of {run}", "class": case, "plain_s": plain_s,
        "levels": len(dmsm.accumulate_levels(lanes[0].shape[0], run)) - 1,
        **depth}
    return out


FLAGSHIP_REQUIRED = MSM + REDUCTION + ONEHOT


def phase_flagship(dev, results, windows=(16, 18)) -> None:
    """GPT-2 at the reference's padded 125M shape (FLAGSHIP_ARGV) through
    nanogpt_style.run on the card with the default gates, counted and
    timed; the first launch of every class of kernels 3-7 and of the
    read-check engine's is copied and
    held against its plain version after the prove (hold_kernels(defer=)),
    kernel 2 at the class of its launches (time_flagship_msm). Requires
    the verifier's acceptance, a flipped commitment and a flipped byte
    rejected, hyperkzg_open's fold batch and witness MSMs on the card or
    split, and the reduction ENGAGED; the largest fold's and the
    witness's points on the card equal to the host engine's; kernels 2
    and 3 at their largest launches beside their bounds. Prints set-up (the SRS, the bases'
    upload), the prove and its phases, verify, proof bytes, peak memory,
    the gate's routes, every engine decision and the MSMs' lane depths."""
    from jolt_atlas_tpu_torch import serde
    from jolt_atlas_tpu_torch.curve.points import g1_generator
    from jolt_atlas_tpu_torch.device import gate as dgate
    from jolt_atlas_tpu_torch.examples import gpt2_style, nanogpt_style
    from jolt_atlas_tpu_torch.verifier import AtlasVerifier
    a = gpt2_style.args(FLAGSHIP_ARGV)
    say("flagship", f"GPT-2 at its padded 125M shape: {a.blocks} of 12 "
        f"blocks, dim {a.dim}, {a.heads} heads, seq {a.seq}, vocab "
        f"{a.vocab}, scale 2^{a.scale}")
    msms, scal, largest, err, seen, defer = [], {}, {}, {}, set(), []

    def run():
        with capture_msms(msms), keep_msm_scalars(scal), hold_kernels(
                results, err, "flagship", kernels=FLAGSHIP_HELD,
                largest=largest, seen=seen, defer=defer):
            return nanogpt_style.run(gpt2_style.args(FLAGSHIP_ARGV))

    torch.cuda.reset_peak_memory_stats(dev)
    out, tele = counted(results, FLAGSHIP_REQUIRED, run)
    results["launches_flagship"] = tele["launches"]
    t0 = time.time()
    check_deferred(results, err, "flagship", defer)
    held_s = time.time() - t0
    why, d = tele["decisions"], tele["dispatches"]
    if not why.get("reduction", "").startswith("ENGAGED"):
        raise AssertionError(f"flagship: reduction {why.get('reduction')}")
    for site in ("hyperkzg_fold", "hyperkzg_witness"):
        route = why.get("msm:" + site, "")
        if not route.startswith(("device", "split")) or not d.get(
                "msm:" + site):
            raise AssertionError(f"flagship: {site} not on the card: "
                                 f"{route!r}, {d}")
    if any("skew" in k for k in d):
        raise AssertionError(f"flagship: a refusal was counted: {d}")
    model = out["model"]
    verifier = AtlasVerifier(out["pp"])
    bad = serde.deserialize_proof(out["blob"])
    pid = sorted(bad.commitments)[0]
    bad.commitments[pid] = bad.commitments[pid] + g1_generator()
    if verifier.verify(bad, out["io"]):
        raise AssertionError("flagship: a flipped commitment verified")
    blob = bytearray(out["blob"])
    blob[len(blob) // 2] ^= 1
    try:
        accepted = verifier.verify(serde.deserialize_proof(bytes(blob)),
                                   out["io"])
    except Exception:  # a byte that no longer parses is a rejection
        accepted = False
    if accepted:
        raise AssertionError("flagship: a flipped byte verified")
    engine = out["pp"].srs.device_bases(dev, dgate.forced("device"))
    prep = out["pp"].srs.prepared_bases()
    equal = {}
    for site in ("fold", "witness"):
        raw, n = scal[site]
        t1 = time.perf_counter()
        want = prep.msm_packed(raw, n)
        t2 = time.perf_counter()
        got = engine.msm_packed(raw, n)
        t3 = time.perf_counter()
        if got != want:
            raise AssertionError(f"flagship: the {site}'s {n}-point MSM on "
                                 "the card differs from the host engine's")
        equal[site] = {"n": n, "host_ms": (t2 - t1) * 1e3,
                       "card_ms": (t3 - t2) * 1e3}
    timed_msm = time_flagship_msm(dev, results, engine, scal, largest, err,
                                  windows)
    del largest, scal
    for k, v in err.items():
        results[k]["max_abs_err"] = max(results[k]["max_abs_err"], v)
    results["flagship_timed"] = timed_msm
    depth = {site: max(tele["msm_depth"].get("msm:" + site, []),
                       key=lambda r: r[1], default=None)
             for site in ("commit", "hyperkzg_fold", "hyperkzg_witness")}
    say("flagship", json.dumps({
        "model": f"{a.blocks} blocks, {a.heads} heads, d{a.dim}, seq "
                 f"{a.seq}, vocab {a.vocab}, scale 2^{a.scale}, "
                 f"{len(model.graph.nodes)} nodes, largest polynomial "
                 f"2^{model.graph.max_num_vars()}",
        "argv": FLAGSHIP_ARGV, "holds_s": held_s,
        "classes_held": len(seen), "max_abs_err": err,
        "tamper_rejected": True, "verified": True,
        **path_record(out, tele),
        "srs_s": out["srs_s"], "bases_s": out["bases_s"],
        "peak_memory_gb": out["peak_memory"],
        "msm_plan": msm_plan(dgate.for_device(dev), msms),
        "deepest_lane_points_deepest_mean": depth,
        "msm_depth": tele["msm_depth"],
        "card_vs_host_engine": equal,
        "kernels_at_largest_launch": timed_msm}))


# ---------------------------------------------------------------------------
# phase 17: the bench entry
# ---------------------------------------------------------------------------

BENCH_PROOF_BYTES = 764_841  # the bench proof's length, on every path


def phase_bench(timeout: int = 300) -> None:
    """``python -m jolt_atlas_tpu_torch.bench`` once, in a subprocess, at
    the full bench shape on the card: its JSON line printed on a line of
    its own; the entry exits 0 (it asserts that its proof verified), the
    proof is BENCH_PROOF_BYTES long, and its fastest prove engaged the MSM,
    reduction and rows engines (their decisions ENGAGED, the fold and
    witness MSMs dispatched to the card)."""
    env = {k: v for k, v in os.environ.items() if k != "BENCH_SMALL"}
    r = subprocess.run([sys.executable, "-m", "jolt_atlas_tpu_torch.bench"],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=timeout)
    lines = r.stdout.splitlines()
    if r.returncode != 0 or len(lines) != 1:
        raise AssertionError(f"the bench entry exited {r.returncode} with "
                             f"{len(lines)} lines on stdout: "
                             f"{r.stdout[-2000:]} {r.stderr[-3000:]}")
    print(lines[0], flush=True)
    out = json.loads(lines[0])
    if out["proof_bytes"] != BENCH_PROOF_BYTES:
        raise AssertionError(f"bench proof of {out['proof_bytes']} bytes, "
                             f"not {BENCH_PROOF_BYTES}")
    d = out["device"]["decisions"]
    for engine in ("msm", "reduction", "iop"):
        if not d.get(engine, "").startswith("ENGAGED"):
            raise AssertionError(f"bench: the {engine} engine did not "
                                 f"engage: {d}")
    for site in ("msm:hyperkzg_fold", "msm:hyperkzg_witness"):
        if not out["device"]["dispatches"].get(site):
            raise AssertionError(f"bench: no device MSM dispatch at {site}: "
                                 f"{out['device']}")


KERNELS = (
    ("pp_add", "jolt_atlas_tpu_torch/csrc/curve.cu",
     "jolt_atlas_tpu/tpu/pallas_curve.py:174"),
    ("bucket_accumulate", "jolt_atlas_tpu_torch/csrc/msm.cu",
     "jolt_atlas_tpu/tpu/msm.py:211"),
    ("bucket_combine", "jolt_atlas_tpu_torch/csrc/combine.cu",
     "jolt_atlas_tpu/tpu/msm.py:356"),
    ("reduction_bind", "jolt_atlas_tpu_torch/csrc/reduction.cu",
     "jolt_atlas_tpu/tpu/reduction.py:176"),
    ("reduction_q0", "jolt_atlas_tpu_torch/csrc/reduction.cu",
     "jolt_atlas_tpu/tpu/reduction.py:153"),
    ("reduction_tail", "jolt_atlas_tpu_torch/csrc/reduction.cu",
     "jolt_atlas_tpu/tpu/reduction.py:193"),
    # the device BLAKE2b (csrc/blake2b.cuh) runs inside every reduction_tail
    # launch, counted there; its test kernel, jolt_blake2b_transcript, is
    # what is timed and compared, and no path launches it
    ("blake2b_transcript", "jolt_atlas_tpu_torch/csrc/blake2b.cuh",
     "jolt_atlas_tpu/tpu/blake2b.py:75"),
    ("rows_points", "jolt_atlas_tpu_torch/csrc/rows.cu",
     "jolt_atlas_tpu/parallel/shardedrows.py:65"),
    # the reference converts the rows on the host (p.to_field())
    ("rows_from_i64", "jolt_atlas_tpu_torch/csrc/rows.cu",
     "jolt_atlas_tpu/parallel/shardedrows.py:303"),
    # the exact forward's products (torchexec.py; no prove launches it)
    ("exact_matmul", "jolt_atlas_tpu_torch/csrc/exact.cu",
     "jolt_atlas_tpu/jaxexec.py:34"),
    # the read-check engine (device/onehot.py): its set-up (the Booleanity's
    # and the read checks' eq tables), its bucket sums (compute_G, the
    # sparse address rounds' buckets) and its round (every instance's
    # message and bind, the batched polynomial)
    ("onehot_prepare", "jolt_atlas_tpu_torch/csrc/onehot.cu",
     "jolt_atlas_tpu/subprotocols/onehot.py:275"),
    ("onehot_buckets", "jolt_atlas_tpu_torch/csrc/onehot.cu",
     "jolt_atlas_tpu/subprotocols/onehot.py:138"),
    ("onehot_round", "jolt_atlas_tpu_torch/csrc/onehot.cu",
     "jolt_atlas_tpu/subprotocols/onehot.py:383"),
    # the operand bind engine (device/bind.py): the reference's
    # object-dtype np.einsum of EinsumLayout.bound_operand
    ("einsum_bind", "jolt_atlas_tpu_torch/csrc/bind.cu",
     "jolt_atlas_tpu/zkops/ops.py:360"),
)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import jolt_atlas_tpu_torch  # noqa: F401  (fails outside a checkout)
    # the SRS files (the flagship's ~1 GB) go to a temporary directory, out
    # of the checkout, removed at the end
    cache = tempfile.mkdtemp(prefix="jolt_srs_")
    os.environ["JOLT_ATLAS_SRS_CACHE"] = cache
    try:
        return run_phases()
    finally:
        shutil.rmtree(cache, ignore_errors=True)


def run_phases() -> int:
    from jolt_atlas_tpu_torch.device import gate
    dev = torch.device("cuda")
    card = card_line()
    say("device", f"{torch.cuda.get_device_name(0)}; nvidia-smi: {card}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    t_start = time.time()

    def phase(name, fn, *args):
        t0 = time.time()
        out = fn(*args)
        say("time", f"{name}: {time.time() - t0:.1f} s (script "
            f"{time.time() - t_start:.1f} s)")
        return out

    phase("build", phase_build)
    results: dict = {"imad_peak": imad_peak()}
    from jolt_atlas_tpu_torch.preprocessing import cached_srs
    # the flagship's SRS (2^24, ~1 GB) first, made once: the GPT-2-style
    # slice's 2^21 and the bench's 2^18 are it trimmed
    flagship = phase(f"srs 2^{FLAGSHIP_VARS}", cached_srs, FLAGSHIP_VARS)
    flagship.trim(1 << 21).save(os.path.join(
        os.environ["JOLT_ATLAS_SRS_CACHE"], "srs_2e21.bin"))
    del flagship
    srs = cached_srs(18)  # the bench prove's SRS size
    engine = srs.device_bases(dev, gate.forced("device"))
    proj = engine.projective()  # the complete add's operands
    phase("pp_add", phase_pp_add, dev, proj, results)
    sums = phase("bucket", phase_bucket, dev, engine.bases, results)
    phase("combine", phase_combine, dev, proj, results, sums)
    del proj
    del sums  # not to count toward the proves' peak device memory
    phase("msm", phase_msm, dev, srs)
    phase("gate", phase_gate, dev, results)
    phase("split", phase_split, dev, srs, results)
    cap, rows_cap = phase("prove", phase_prove, dev, srs, results)
    phase("reduction", phase_reduction, dev, results, cap)
    del cap
    phase("rows", phase_rows, dev, results, rows_cap)
    phase("onehot", phase_onehot, dev, results)
    phase("bind", phase_bind, dev, results)
    phase("mesh", phase_mesh, dev, results)
    phase("exact", phase_exact, dev, results)
    phase("models", phase_models, dev, results)
    phase("flagship", phase_flagship, dev, results)
    torch.cuda.empty_cache()  # the entry's process has the card beside us
    phase("bench", phase_bench)
    require_checked(results)
    launches = results["launches"]
    kernels = []
    for name, src, repl in KERNELS:
        r = results[name]
        row = {"name": name, "route": "cuda", "source": src,
               "replaces": repl, "launches": launches.get(name, 0),
               "launches_per_prove": results["launches_per_prove"].get(
                   name, 0),
               "launches_models": results["launches_models"].get(name, 0),
               "launches_flagship": results["launches_flagship"].get(name,
                                                                     0),
               "max_abs_err": r["max_abs_err"], "ms": r["ms"],
               "call_ms": r["call_ms"], "plain_ms": r["plain_ms"],
               "bound_ms": r["bound_ms"],
               "bound_by": r["bound_by"], "library_ms": None,
               "shape": r["shape"]}
        if name == "blake2b_transcript":
            row["runs_in"] = "reduction_tail (device functions)"
        if name == "pp_add":  # no launch in a prove
            row["runs_in"] = "the MSM gate's calibration (device/gate.py)"
        if name == "bucket_combine":  # the window fold, on the card
            row["also_replaces"] = "jolt_atlas_tpu/tpu/msm.py:522"
        if name == "reduction_bind":  # also the rows engine's bind
            row["also_replaces"] = \
                "jolt_atlas_tpu/parallel/shardedrows.py:130"
            row["rows_layout"] = results["rows_bind"]
        for extra in ("bound_montgomery_ms", "share_montgomery",
                      "bound_prev_design_ms", "bound_prev_design_by",
                      "share_prev_design",
                      "bound_latency_ms", "share_latency", "latency",
                      "ms_l2_warm"):
            if extra in r:  # kernels 1-3, 5 and 6: their second bounds
                row[extra] = r[extra]
        if name in ("reduction_q0", "reduction_tail"):
            row["pair_round0"] = results["reduction_pair"]
        if name == "rows_points":
            row["plan"] = r["plan"]
            row["bound_term_by_term_ms"] = r["bound_term_by_term_ms"]
        if name in MESH:  # also the mesh path's (phase 13)
            row["launches_mesh_prove"] = results[
                "launches_mesh_prove"].get(name, 0)
            if name in results["mesh_timed"]:
                row["mesh_largest_launch"] = results["mesh_timed"][name]
        if name in results["models_timed"]:  # phase 15's largest launch
            row["models_largest_launch"] = results["models_timed"][name]
        if name in MSM:  # phase 16's largest launches
            row["flagship_largest_launch"] = {
                k: v for k, v in results["flagship_timed"].items()
                if k.startswith(name)}
        if name in ONEHOT:
            row.update({k: r[k] for k in ("share", "products", "bytes")})
        if name in BIND:  # no TPU kernel: the host's np.einsum
            row.update({k: r[k] for k in ("share", "imads", "bytes",
                                          "timed")})
        if name == "onehot_buckets":
            row["also_replaces"] = "jolt_atlas_tpu/subprotocols/onehot.py:336"
        if name == "onehot_round":
            row["also_replaces"] = "jolt_atlas_tpu/subprotocols/onehot.py:189"
        if name == "exact_matmul":
            row["runs_in"] = "the quantized forward (entry(), torchexec.py)"
            for extra in ("bound_imad_ms", "share", "share_imad",
                          "int_mm_16_ms", "int_mm_16_colmajor_ms", "plan",
                          "timed", "compiled"):
                row[extra] = r[extra]
            row["also_replaces"] = "jolt_atlas_tpu/jaxexec.py:71, :163"
        kernels.append(row)
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
