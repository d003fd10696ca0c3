"""Kernels 1-3 (device/curve.py pp_add, device/msm.py bucket_accumulate
and bucket_combine; csrc/curve.cu, msm.cu, combine.cu) alone on one GPU.

    python3 scripts/msm_kernels_bench.py [--root DIR] [--expect FILE]
                                         [--shapes] [--plans]

Inputs, at chip_smoke.py's shapes, from its seeds: the bench's SRS
(cached_srs(18)) as the bases; kernel 1 at the gate's 2^17 lanes (the
projective sums of 2^16 random pairs of bases, seed 2024, and their roll
by 3, as chip_smoke.phase_pp_add); kernel 2 on the digit lanes of one MSM
of 2^16 (c = 12), 2^17 and 2^18 - 3 (c = 14) points (random_scalars,
seeds 78-80); kernel 3 on random bucket sums (chip_smoke.
random_bucket_sums, seed 2025 + k) at the fold batch's two launches (k =
1, c = 14; k = 16, c = 12) and at k = 17, c = 14, at the blocks per
window the card's rule gives. Each result is held bit-equal to its plain
version, or, with ``--expect FILE``, to the SHA-256 digests that file
keeps (written by the first run from the plain versions), so that two
checkouts are held to the same numbers without the plain versions' ~20 s
each time. Times are torch.profiler's device durations (chip_smoke.
device_ms, 20 calls), beside each shape's bound (chip_smoke.bound: the
lazy add's IMAD, and 12 Montgomery products an add beside it).

``--root DIR`` takes the port's package from another checkout (a parent
unpacked with ``git archive``), so two versions are compared within one
call: run this, parent, this, parent. ``--shapes`` also builds kernel 1's
lane (csrc/curve.cu pp_add_lane) at other launch shapes (threads a block,
``__launch_bounds__`` minimum blocks) and times each on the same lanes.
``--plans`` also times kernel 3 at c = 16 for one MSM (the witness's
launch) and for five (the fold batch's), on sums of two random bases, at two
launch plans in turns (PLANS_TURNS, CUDA events, mean of 5 a turn):
128-thread blocks, G doubled while the launch holds fewer than two blocks
an SM and a thread keeps 8 buckets, and 64-thread blocks, G as many as one
wave of the card holds (6 blocks an SM); the two plans' window sums are
held equal as points.
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
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS = ("pp_add_kernel", "bucket_accumulate_runs",
           "bucket_accumulate_level", "bucket_combine_kernel",
           "bucket_combine_groups")
PLANS_TURNS = 5
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


def combine_plans(cs, curve, dmsm, dev, bases, sms: int) -> list:
    """Kernel 3 at c = 16 under its two launch plans in turns (--plans)."""
    c = 16
    W, B, _ = dmsm.window_shape(c)
    real = dmsm.combine_threads
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
        plans = {(128, G): [], (64, max(1, min(sms * 6 // (k * W),
                                               B // (64 * 8)))): []}
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
                pts = cs.curve_points(got)
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


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--expect", default=None)
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
    bases = cached_srs(18).device_bases(dev, gate.forced("device")).bases
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    # -- the inputs (as chip_smoke.py's phases make them)
    g = torch.Generator(device="cpu").manual_seed(2024)
    i1, i2 = (torch.randint(0, bases[0].shape[0], (1 << 16,), generator=g)
              .to(dev) for _ in range(2))
    R1 = curve.pp_add_plain(tuple(b[i1] for b in bases),
                            tuple(b[i2] for b in bases))
    m = 1 << 17
    X = tuple(t.repeat(2, 1)[:m] for t in R1)
    Y = tuple(t.roll(3, 0) for t in X)
    cases = [("pp_add", f"{m} lanes", lambda: curve.pp_add(X, Y),
              lambda: curve.pp_add_plain(X, Y), m, m * 3 * cs.POINT_BYTES)]
    for i, n in enumerate((1 << 16, 1 << 17, (1 << 18) - 3)):
        c = dmsm._pick_c(n)
        lanes = dmsm.digit_lanes(dmsm.scalars_tensor(
            gate.random_scalars(n, 78 + i), n, dev), c)
        adds, nbytes = cs.accumulate_work(lanes, n)
        cases.append(("bucket_accumulate", f"n={n} c={c}",
                      lambda lanes=lanes: dmsm.bucket_accumulate(bases,
                                                                 lanes),
                      lambda lanes=lanes: dmsm.bucket_accumulate_plain(
                          bases, lanes), adds, nbytes))
    for k, c in ((1, 14), (16, 12), (17, 14)):
        acc = cs.random_bucket_sums(dev, bases, k, c, 2025 + k)
        G = dmsm.combine_groups(k, c, sms)
        adds, nbytes = cs.combine_work(k, c)
        cases.append(("bucket_combine", f"k={k} c={c} G={G}",
                      lambda acc=acc, c=c, G=G: dmsm.bucket_combine(acc, c,
                                                                    G),
                      lambda acc=acc, c=c, G=G: dmsm.bucket_combine_plain(
                          acc, c, G), adds, nbytes))

    expect = {}
    if a.expect and os.path.exists(a.expect):
        with open(a.expect) as f:
            expect = json.load(f)
    out = {"root": os.path.abspath(a.root), "kernels": []}
    for kernel, shape, fn, plain, adds, nbytes in cases:
        ms, call, got = cs.device_ms(fn, 20, kernel)
        key = f"{kernel} {shape}"
        if key not in expect:
            expect[key] = digest(plain())
        if digest(got) != expect[key]:
            raise AssertionError(f"{key}: the kernel differs from its "
                                 "plain version")
        b, by = cs.bound(adds, nbytes, peak, cs.IMADS_PER_ADD)
        mb = cs.bound(adds, nbytes, peak, cs.IMADS_PER_ADD_MONTGOMERY)[0]
        out["kernels"].append({
            "kernel": kernel, "shape": shape, "ms": ms, "call_ms": call,
            "bound_ms": b, "bound_by": by, "share": b / ms,
            "bound_montgomery_ms": mb, "share_montgomery": mb / ms})
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
        out["plans"] = combine_plans(cs, curve, dmsm, dev, bases, sms)
    for k, r in out["ptxas"].items():
        print(f"ptxas -v {k}: {json.dumps(r)}")
    print(cs.card_line())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
