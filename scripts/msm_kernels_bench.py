"""Kernels 1-3 (device/curve.py pp_add, device/msm.py bucket_accumulate
and bucket_combine; csrc/curve.cu, msm.cu, combine.cu) alone on one GPU.

    python3 scripts/msm_kernels_bench.py [--root DIR] [--expect FILE]
                                         [--witness] [--shapes] [--plans]

Inputs, at chip_smoke.py's shapes, from its seeds: the bench's SRS
(cached_srs(18)) as the bases; kernel 1 at the gate's 2^17 lanes (the
projective sums of 2^16 random pairs of bases, seed 2024, and their roll
by 3, as chip_smoke.phase_pp_add), held bit-equal to its plain version.
Kernels 2 and 3 are taken per MSM, as the device engine runs them: the
same scalars through the checkout's own digit lanes, kernel 2 and kernel
3, and its conversion to affine points (since kernel 3's redesign the
window fold runs on the card and the host only inverts; before it, the
host ran a Horner over the window sums), for one MSM of 2^17 random
scalars (c = 14; random_scalars, seed 79), the bench's fold batch (17
MSMs of 2^17 ... 2 points, seed 90: kernel 2 once an MSM, kernel 3 once a
window size), and with ``--witness`` the flagship witness's class (2^24 -
3 random scalars at c = 16, seed 91, on the SRS's bases tiled to 2^24).
Each MSM's affine point is held equal to the host csrc engine's (the
witness's: to ``--expect``). Times: device ms of each kernel from
torch.profiler's durations (chip_smoke.kernels_ms, 5 calls; kernel 1 by
chip_smoke.device_ms, 20 calls), the digit lanes and the host conversion
by the host clock, beside the bound of the checkout's own design
(bound_ms: chip_smoke.accumulate_work, combine_design) and, in a checkout
since kernels 2 and 3's redesign, the bound of the design before it on
the same MSMs (bound_prev_design_ms: chip_smoke.accumulate_work,
combine_work).

``--root DIR`` takes the port's package from another checkout (a parent
unpacked with ``git archive``), so two versions are compared within one
call: run this, parent, this, parent. ``--expect FILE`` keeps digests of
the results that both must share: kernel 1's projective limbs and every
MSM's affine point. Kernels 2 and 3's projective outputs differ between
the two designs (signed digits, the mixed add, the new partition and
fold), so they are held equal only as affine points. ``--shapes`` also
builds kernel 1's lane (csrc/curve.cu pp_add_lane) at other launch shapes
(threads a block, ``__launch_bounds__`` minimum blocks) and times each on
the same lanes. ``--plans`` also times kernel 3 at c = 16 for one MSM
(the witness's launch) and for five (the fold batch's), on sums of two
random bases, at two launch plans in turns (PLANS_TURNS, CUDA events,
mean of 5 a turn): 128-thread blocks, G doubled while the launch holds
fewer than two blocks an SM and a thread keeps 8 buckets, and 64-thread
blocks, G as many as one wave of the card holds (6 blocks an SM; a power
of two where the checkout's kernel 3 takes only those); the two plans'
results are held equal as points. In this checkout ``--plans`` also
builds kernels 2 and 3 as probe libraries at the launch plans of
BUILD_PLANS (threads a block of kernel 2's runs, msm.cu ACCUM_THREADS;
blocks an SM that kernel 3's walk must hold, JOLT_COMBINE_MIN_BLOCKS) and
times each in turns (BUILD_TURNS, CUDA events, mean of 3 a turn, the
wrappers calling the probe) on kernel 2 at the 2^17 MSM (and with
``--witness`` the witness class) and kernel 3 on random sums at the fold
batch's k = 16, c = 12 and the flagship's five folds (k = 5, c = 16),
each result held bit-equal to the default build's; and it times kernel 2
on 2^21 - 3 and 2^20 random scalars at c = 16 (the GPT-2-style slice's
witness and largest fold, on the bases tiled to 2^21) at each level-1
threshold of CHUNK_RUNS (msm.ACCUM_CHUNK_RUNS: the lanes' average runs
from which level 1 takes a thread a chunk; the buckets are the same at
every threshold), in another checkout at its own threshold only.
Prints ptxas's registers and spills of kernels 1-3, the card's name and
power limit, then one JSON line. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib.util
import json
import os
import re
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS = ("pp_add_kernel", "bucket_accumulate_runs",
           "bucket_accumulate_level", "bucket_combine_kernel",
           "bucket_combine_groups", "bucket_combine_fold")
REPS = 5  # calls of an MSM case traced
PLANS_TURNS = 5
# --plans' builds: (name, kernel 2's runs' threads a block, blocks an SM
# kernel 3's walk must hold); None keeps the source's own
BUILD_PLANS = (("default", None, None), ("accum 128 threads", 128, None),
               ("accum 512 threads", 512, None),
               ("combine 2 blocks an SM", None, 2),
               ("combine 4 blocks an SM", None, 4))
BUILD_TURNS = 2
CHUNK_RUNS = (1, 2, 3, 4)  # --plans' level-1 thresholds
# kernel 1's launch shapes for --shapes: (threads a block, minimum blocks
# an SM for __launch_bounds__, 0 for none)
SHAPES = ((64, 0), (128, 0), (128, 3), (128, 4), (256, 0), (256, 2),
          (512, 1))


def chip_smoke():
    """This checkout's chip_smoke.py (its timers and bounds), loaded by
    path so that --root's own copy is not taken instead."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def digest(ts) -> str:
    h = hashlib.sha256()
    for t in ts:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def shape_probe(shapes) -> str:
    """A source that builds pp_add_lane at each (threads, min blocks) as
    its own extern "C" kernel and launcher."""
    out = ['#include "curve.cu"', "using jolt::u64;"]
    for t, b in shapes:
        name = f"pp_add_{t}_{b}"
        bounds = f"{t}, {b}" if b else f"{t}"
        out.append(f"""
extern "C" __global__ void __launch_bounds__({bounds}) {name}(
    const u64* x1, const u64* y1, const u64* z1, const u64* x2,
    const u64* y2, const u64* z2, u64* x3, u64* y3, u64* z3, int64_t n) {{
  const int64_t i = (int64_t)blockIdx.x * {t} + threadIdx.x;
  if (i < n) jolt::pp_add_lane(x1, y1, z1, x2, y2, z2, x3, y3, z3, i);
}}
extern "C" int jolt_{name}(const void* x1, const void* y1, const void* z1,
                           const void* x2, const void* y2, const void* z2,
                           void* x3, void* y3, void* z3, int64_t n,
                           void* stream) {{
  {name}<<<(unsigned)((n + {t} - 1) / {t}), {t}, 0,
          (cudaStream_t)stream>>>(
      (const u64*)x1, (const u64*)y1, (const u64*)z1, (const u64*)x2,
      (const u64*)y2, (const u64*)z2, (u64*)x3, (u64*)y3, (u64*)z3, n);
  return (int)cudaGetLastError();
}}""")
    return "\n".join(out) + "\n"


def points(R) -> list:
    """Kernel 3's output (one point an MSM, or window sums before its
    redesign) as affine points."""
    from jolt_atlas_tpu_torch.device import curve
    return curve.tensors_to_points(tuple(t.reshape(-1, 4).cpu() for t in R))


def combine_plans(cs, curve, dmsm, dev, bases, sms: int) -> list:
    """Kernel 3 at c = 16 under its two launch plans in turns (--plans)."""
    c = 16
    W, B, _ = dmsm.window_shape(c)
    real = dmsm.combine_threads
    pow2 = hasattr(dmsm, "combine_chunk")  # G a power of two
    out = []
    for k in (1, 5):
        # sums of two random bases: curve points only (two orders of adds
        # agree only on those; random_bucket_sums adds raw field elements)
        gen = torch.Generator(device="cpu").manual_seed(2025 + k)
        i1, i2 = (torch.randint(0, bases[0].shape[0], (k * W * B,),
                                generator=gen).to(dev) for _ in range(2))
        acc = tuple(t.reshape(k, W * B, 4) for t in curve.pp_add(
            tuple(b[i1] for b in bases), tuple(b[i2] for b in bases)))
        G = 1
        while k * W * G < 2 * sms and B // (2 * G * 128) >= 8:
            G *= 2
        wide = max(1, min(sms * 6 // (k * W), B // (64 * 8)))
        if pow2:
            wide = 1 << wide.bit_length() - 1
        plans = {(128, G): [], (64, wide): []}
        want = None
        for turn in range(PLANS_TURNS):
            for T, G in (list(plans) if turn % 2 == 0
                         else list(plans)[::-1]):
                dmsm.combine_threads = lambda cc, T=T: T
                try:
                    ms, got = cs.cuda_ms(
                        lambda: dmsm.bucket_combine(acc, c, G), 5)
                finally:
                    dmsm.combine_threads = real
                pts = points(got)
                if want is None:
                    want = pts
                if pts != want:
                    raise AssertionError(f"kernel 3 at k={k}, {T} threads, "
                                         f"G={G} differs")
                plans[(T, G)].append(ms)
        out.append({"k": k, "c": c, "turns_ms": {
            f"{T} threads G={G}": v for (T, G), v in plans.items()}})
        del acc
    return out


def plan_source(csrc: str, threads, blocks) -> str:
    """msm.cu and combine.cu as one probe source at a build plan."""
    with open(os.path.join(csrc, "msm.cu")) as f:
        text = f.read()
    if threads is not None:
        text, hits = re.subn(r"constexpr int ACCUM_THREADS = \d+;",
                             f"constexpr int ACCUM_THREADS = {threads};",
                             text)
        if hits != 1:
            raise AssertionError("msm.cu holds no ACCUM_THREADS")
    head = (f"#define JOLT_COMBINE_MIN_BLOCKS {blocks}\n"
            if blocks is not None else "")
    return head + text + '#include "combine.cu"\n'


def build_plans(cs, dmsm, build, kernel_report, engine, proj, dev) -> dict:
    """Kernels 2 and 3 at each build plan in turns (--plans)."""
    from jolt_atlas_tpu_torch.device import gate
    cases = []
    sizes = [("k2 2^17 c=14", 1 << 17, 79)]
    if engine.n >= (1 << 24) - 3:
        sizes.append(("k2 witness 2^24-3 c=16", (1 << 24) - 3, 91))
    for name, n, seed in sizes:
        lanes = dmsm.digit_lanes(dmsm.scalars_tensor(
            gate.random_scalars(n, seed), n, dev), dmsm._pick_c(n))
        cases.append((name, lambda lanes=lanes:
                      dmsm.bucket_accumulate(engine.bases, lanes)))
    for k, c, seed in ((16, 12, 2041), (5, 16, 2030)):
        acc = cs.random_bucket_sums(dev, proj, k, c, seed)
        cases.append((f"k3 k={k} c={c}", lambda acc=acc, c=c:
                      dmsm.bucket_combine(acc, c)))
    real = build.cuda_library
    want, out, libs = {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for turn in range(BUILD_TURNS):
            for name, threads, blocks in (BUILD_PLANS if turn % 2 == 0
                                          else BUILD_PLANS[::-1]):
                if name not in libs:
                    d = os.path.join(tmp, str(len(libs)))
                    os.makedirs(d)
                    lib = kernel_report.probe_library(
                        plan_source(build.CUDA_SRC, threads, blocks),
                        build.CUDA_SRC, d)
                    for f in ("jolt_bucket_accumulate",
                              "jolt_bucket_combine"):
                        getattr(lib, f).argtypes = build.SIGNATURES[f]
                        getattr(lib, f).restype = ctypes.c_int
                    libs[name] = lib
                    out[name] = {"ptxas": {
                        k: (v["registers"], v["spill_stores"])
                        for k, v in lib.ptxas.items()}}
                build.cuda_library = lambda lib=libs[name]: lib
                try:
                    for case, fn in cases:
                        ms, got = cs.cuda_ms(fn, 3)
                        if case not in want:
                            want[case] = [t.clone() for t in got]
                        elif not all(torch.equal(a, b)
                                     for a, b in zip(got, want[case])):
                            raise AssertionError(f"{name}: {case} differs")
                        out[name].setdefault(case, []).append(ms)
                finally:
                    build.cuda_library = real
    return out


def chunk_runs(cs, dmsm, engine, own_only: bool) -> dict:
    """Kernel 2 at each level-1 threshold (--plans); ``engine`` holds 2^21
    bases or more."""
    from jolt_atlas_tpu_torch.device import gate
    dev = engine.device
    own = dmsm.ACCUM_CHUNK_RUNS
    out = {"own": own}
    for n in ((1 << 21) - 3, 1 << 20):
        c = dmsm._pick_c(n)
        lanes = dmsm.digit_lanes(dmsm.scalars_tensor(
            gate.random_scalars(n, 92), n, dev), c)
        want = None
        try:
            for t in (own,) if own_only else CHUNK_RUNS:
                dmsm.ACCUM_CHUNK_RUNS = t
                ms = cs.kernels_ms(
                    lambda: dmsm.bucket_accumulate(engine.bases, lanes),
                    ("bucket_accumulate",), REPS)
                got = dmsm.bucket_accumulate(engine.bases, lanes)
                if want is None:
                    want = got
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise AssertionError(f"n={n}: threshold {t} differs")
                out[f"n={n} chunk runs {t}, class "
                    f"{dmsm.accumulate_class(lanes)}"] = ms
        finally:
            dmsm.ACCUM_CHUNK_RUNS = own
        del lanes, want
    return out


def msm_cases(witness: bool) -> list:
    """(name, [(scalar count, seed)], base count) of the MSM cases."""
    cases = [("bench 2^17", [(1 << 17, 79)], 1 << 18),
             ("bench fold batch", [(1 << e, 90 + e) for e in range(17, 0, -1)],
              1 << 18)]
    if witness:
        cases.append(("flagship witness class", [((1 << 24) - 3, 91)],
                      1 << 24))
    return cases


def run_msms(cs, dmsm, engine, packed: list, counts: list) -> tuple:
    """One batch as the device engine queues it (DeviceBases._launch: per
    window size, kernel 2 an MSM into one stack, then kernel 3 once), and
    the conversion of kernel 3's output to affine points on the host.
    (per window size (lanes stage, kernel 2 stack and kernel 3 output), the
    points; the stages' host ms)."""
    dev = engine.device
    sc = [dmsm.scalars_tensor(r, n, dev) for r, n in zip(packed, counts)]
    by_c: dict = {}
    for i, n in enumerate(counts):
        by_c.setdefault(dmsm._pick_c(n), []).append(i)
    inf = getattr(engine, "inf", None)
    t0 = cs.time.perf_counter()
    lanes = {c: [dmsm.digit_lanes(sc[i], c, 0, *([inf] if inf is not None
                                                 else []))
                 for i in idx] for c, idx in by_c.items()}
    torch.cuda.synchronize()
    t1 = cs.time.perf_counter()
    parts = {}
    for c, idx in by_c.items():
        W, B, _ = dmsm.window_shape(c)
        acc = tuple(torch.empty((len(idx), W * B, 4), dtype=torch.int64,
                                device=dev) for _ in range(3))
        for j, ln in enumerate(lanes[c]):
            dmsm.bucket_accumulate(engine.bases, ln,
                                   out=tuple(a[j] for a in acc))
        parts[c] = (acc, dmsm.bucket_combine(acc, c))
    torch.cuda.synchronize()
    t2 = cs.time.perf_counter()
    pts = [None] * len(counts)
    for c, idx in by_c.items():
        R = parts[c][1]
        got = (dmsm.affine_points(R) if hasattr(dmsm, "affine_points")
               else dmsm.window_points(R, c))
        for i, p in zip(idx, got):
            pts[i] = p
    t3 = cs.time.perf_counter()
    return lanes, parts, pts, {"digit_lanes_ms": (t1 - t0) * 1e3,
                               "kernels_ms": (t2 - t1) * 1e3,
                               "host_points_ms": (t3 - t2) * 1e3}


def msm_case(cs, dmsm, engine, prep, name, sizes, expect, peak) -> dict:
    """One MSM case (msm_cases) through the checkout's engine: its points
    held to the host engine's (``prep``) or to ``expect``; kernels 2 and 3
    timed by torch.profiler over REPS calls each, on the lanes and bucket
    sums of the first call; their bounds summed over the batch."""
    from jolt_atlas_tpu_torch.device import gate
    packed = [gate.random_scalars(n, seed) for n, seed in sizes]
    counts = [n for n, _ in sizes]
    lanes, parts, pts, host = run_msms(cs, dmsm, engine, packed, counts)
    key = f"points {name}"
    got = cs.hashlib.sha256(repr([(p.infinity, p.x, p.y)
                                  for p in pts]).encode()).hexdigest()[:16]
    if prep is not None:
        want = prep.msm_batch_packed(packed)
        if [(p.x, p.y) for p in pts] != [(w.x, w.y) for w in want]:
            raise AssertionError(f"{name}: differs from the host engine")
    if expect.setdefault(key, got) != got:
        raise AssertionError(f"{name}: differs from --expect's points")
    k2 = k3 = 0.0
    old2, old3, des2, des3 = [0, 0], [0, 0], [0, 0], [0, 0]
    design = hasattr(dmsm, "combine_chunk")  # a checkout since the redesign
    sms = torch.cuda.get_device_properties(engine.device).multi_processor_count
    for c, (acc, _) in parts.items():
        ls = lanes[c]

        def accumulate():
            for j, ln in enumerate(ls):
                dmsm.bucket_accumulate(engine.bases, ln,
                                       out=tuple(a[j] for a in acc))
        k2 += cs.kernels_ms(accumulate, ("bucket_accumulate",), REPS)
        k3 += cs.kernels_ms(lambda: dmsm.bucket_combine(acc, c),
                            ("bucket_combine",), REPS)
        for ln in ls:
            n = ln[0].shape[0] // dmsm.window_shape(c)[0]
            if design:
                (a, b), (i, d) = cs.accumulate_work(ln, n, c)
                des2 = [des2[0] + i, des2[1] + d]
            else:  # unsigned lanes: the old design's own count
                starts = ln[2]
                L = starts.shape[0] - 1
                a = int(starts[L]) - int((starts[1:] > starts[:-1]).sum())
                b = 8 * ln[0].shape[0] + 4 * (L + 1) + (n + L) * \
                    cs.POINT_BYTES
            old2 = [old2[0] + a, old2[1] + b]
        k = acc[0].shape[0]
        a, b = cs.combine_work(k, c)
        old3 = [old3[0] + a, old3[1] + b]
        if design:
            i, d = cs.combine_design(k, c, dmsm.combine_groups(k, c, sms))
            des3 = [des3[0] + i, des3[1] + d]
    out = {"case": name, "msms": len(counts), "points": got, **host,
           "kernel2_ms": k2, "kernel3_ms": k3}
    for kernel, ms, old, des in (("kernel2", k2, old2, des2),
                                 ("kernel3", k3, old3, des3)):
        pb = b = cs.bound(old[0], old[1], peak, cs.IMADS_PER_ADD)[0]
        if design:  # the old design is not the checkout's own
            b = cs.bound(des[0], des[1], peak, 1)[0]
            out[f"{kernel}_bound_prev_design_ms"] = pb
            out[f"{kernel}_share_prev_design"] = pb / ms
        out[f"{kernel}_bound_ms"], out[f"{kernel}_share"] = b, b / ms
    return out


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--expect", default=None)
    ap.add_argument("--witness", action="store_true")
    ap.add_argument("--shapes", action="store_true")
    ap.add_argument("--plans", action="store_true")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("msm_kernels_bench: no CUDA device", file=sys.stderr)
        return 1
    cs = chip_smoke()
    # both checkouts read this one's SRS cache: the same bases, made once
    os.environ.setdefault("JOLT_ATLAS_SRS_CACHE", os.path.join(
        ROOT, "jolt_atlas_tpu_torch", "_build", "srs"))
    sys.path.insert(0, os.path.abspath(a.root))
    from jolt_atlas_tpu_torch.device import build, curve, gate, kernel_report
    from jolt_atlas_tpu_torch.device import msm as dmsm, telemetry
    from jolt_atlas_tpu_torch.preprocessing import cached_srs
    dev = torch.device("cuda")
    peak = cs.imad_peak()
    srs = cached_srs(18)
    engine = srs.device_bases(dev, gate.forced("device"))
    proj = (engine.projective() if hasattr(engine, "projective")
            else engine.bases)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    expect = {}
    if a.expect and os.path.exists(a.expect):
        with open(a.expect) as f:
            expect = json.load(f)
    out = {"root": os.path.abspath(a.root), "kernels": [], "msms": []}

    # -- kernel 1 (as chip_smoke.phase_pp_add makes its inputs)
    g = torch.Generator(device="cpu").manual_seed(2024)
    i1, i2 = (torch.randint(0, proj[0].shape[0], (1 << 16,), generator=g)
              .to(dev) for _ in range(2))
    R1 = curve.pp_add_plain(tuple(b[i1] for b in proj),
                            tuple(b[i2] for b in proj))
    m = 1 << 17
    X = tuple(t.repeat(2, 1)[:m] for t in R1)
    Y = tuple(t.roll(3, 0) for t in X)
    ms, call, got = cs.device_ms(lambda: curve.pp_add(X, Y), 20, "pp_add")
    key = f"pp_add {m} lanes"
    if expect.setdefault(key, digest(curve.pp_add_plain(X, Y))) != digest(
            got):
        raise AssertionError(f"{key}: the kernel differs from its plain "
                             "version")
    b, by = cs.bound(m, m * 3 * cs.POINT_BYTES, peak, cs.IMADS_PER_ADD)
    mb = cs.bound(m, m * 3 * cs.POINT_BYTES, peak,
                  cs.IMADS_PER_ADD_MONTGOMERY)[0]
    out["kernels"].append({
        "kernel": "pp_add", "shape": f"{m} lanes", "ms": ms, "call_ms": call,
        "bound_ms": b, "bound_by": by, "share": b / ms,
        "bound_montgomery_ms": mb, "share_montgomery": mb / ms})

    # -- kernels 2 and 3, an MSM case at a time
    prep = srs.prepared_bases()
    for name, sizes, nbases in msm_cases(a.witness):
        if nbases > engine.n:  # the bases tiled (gate.py calibrates so)
            from jolt_atlas_tpu_torch.device.msm import DeviceBases
            del engine
            reps = -(-nbases // prep.n)
            engine = DeviceBases(prep.buf.raw * reps, reps * prep.n, dev)
        out["msms"].append(msm_case(cs, dmsm, engine,
                                    prep if nbases <= prep.n else None,
                                    name, sizes, expect, peak))
        print(json.dumps(out["msms"][-1]), flush=True)
        torch.cuda.empty_cache()
    if a.expect:
        with open(a.expect, "w") as f:
            json.dump(expect, f)
    ptx = kernel_report.parse_ptxas(build.ptxas_report())
    out["ptxas"] = {k: ptx.get(k) for k in KERNELS}
    if a.shapes:
        b = cs.bound(m, m * 3 * cs.POINT_BYTES, peak, cs.IMADS_PER_ADD)[0]
        want = expect.get(f"pp_add {m} lanes") or digest(
            curve.pp_add_plain(X, Y))
        outs = [torch.empty_like(X[0]) for _ in range(3)]
        out["shapes"] = []
        with tempfile.TemporaryDirectory() as tmp:
            lib = kernel_report.probe_library(shape_probe(SHAPES),
                                              build.CUDA_SRC, tmp)
            for t, mb in SHAPES:
                f = getattr(lib, f"jolt_pp_add_{t}_{mb}")
                f.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int64,
                                                      ctypes.c_void_p]

                def run(f=f):
                    stream = torch.cuda.current_stream(dev).cuda_stream
                    if f(*(x.data_ptr() for x in (*X, *Y, *outs)), m,
                         stream):
                        raise RuntimeError("probe launch failed")
                    telemetry.launch("pp_add_probe", m)
                    return outs
                ms, call, got = cs.device_ms(run, 20, f"pp_add_{t}_{mb}",
                                             "pp_add_probe")
                if digest(got) != want:
                    raise AssertionError(f"pp_add at ({t}, {mb}) differs "
                                         "from its plain version")
                out["shapes"].append({
                    "threads": t, "min_blocks": mb, "ms": ms,
                    "call_ms": call, "share": b / ms,
                    **lib.ptxas[f"pp_add_{t}_{mb}"]})
    if a.plans:
        out["plans"] = combine_plans(cs, curve, dmsm, dev, proj, sms)
        this = os.path.abspath(a.root) == ROOT
        if this:
            out["build_plans"] = build_plans(cs, dmsm, build, kernel_report,
                                             engine, proj, dev)
        if engine.n < 1 << 21:
            del engine
            reps = -(-(1 << 21) // prep.n)
            engine = dmsm.DeviceBases(prep.buf.raw * reps, reps * prep.n,
                                      dev)
        out["chunk_runs"] = chunk_runs(cs, dmsm, engine, not this)
    for k, r in out["ptxas"].items():
        print(f"ptxas -v {k}: {json.dumps(r)}")
    print(cs.card_line())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
