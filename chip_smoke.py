"""Chip smoke run of the PyTorch/CUDA port (jolt_atlas_tpu_torch) on one GPU.

    python3 chip_smoke.py            # every phase, from the repo root

Phases, in order; each prints one line and raises on failure, so the
script exits non-zero when any phase fails:

  1. device   a CUDA device is present; its name and power limit
  2. build    the CUDA kernels (sm_90a, one nvcc per source, in parallel)
              and the host C++ engines, from source
  3. pp_add   kernel 1 against its plain PyTorch version on the card: 2^16
              random pairs plus doubling, P + (-P), the identity on either
              side and coordinates near p; bit-equal, timed at the gate's
              2^17 lanes
  4. bucket   kernel 2 against its plain version on a small grid with empty
              (-1) slots and on the grids of a 2^16-point (c = 12) and a
              2^17-point (c = 14) MSM; bit-equal. Both timed at 2^17
  5. combine  kernel 3 against its plain version on the real bucket sums
              of phase 4 (one MSM at c = 12 and at c = 14) and at the fold
              batch's shape (17 MSMs, c = 14) with identity buckets and
              the add's edge cases; bit-equal, both timed at the latter
  6. msm      the device MSM against the host csrc MSM at n = 2^17: random
              254-bit scalars (adaptive window) and 16-bit scalars; affine
              points equal; the stage breakdown of one MSM
  7. gate     the MSM gate measures this card and host (the calibration
              path: pp_add chain, host MSM, device MSM at 2^16 and 2^18)
              and persists it; its plan for every MSM size of the bench
  8. split    2^18 - 3 random scalars on the device alone, the host alone,
              and split at device shares 2^15, 2^16, 2^17: all equal the
              host point; medians of 3, alternated
  9. prove    the bench nanoGPT (4 blocks, 4 heads, d64, seq 64, vocab 65,
              random weights from seed 1234) proved on the gate's routes,
              with a forced split and on the host; proof bytes equal; the
              port's verifier accepts it and rejects a flipped commitment
 10. trace    one more gate-path prove under torch.profiler (the device's
              idle share, its busiest kernels), and one split MSM whose
              host prefix must overlap its device kernels.

Each path (gate calibration, split, the two device proves) runs with the
launch counts set to 0 just before it and read just after; the kernels
JSON sums them. Every lane count a path launched a kernel at must be one
that phases 3-5 held against the plain version, or the run fails. The
second line from the end is that JSON, the last line {"ok": true,
"device": {...}}. Imports nothing of JAX or jolt_atlas_tpu.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
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


def max_abs_err(got, want) -> float:
    return max(float((g - w).abs().max()) if g.numel() else 0.0
               for g, w in zip(got, want))


def require_equal(what: str, got, want) -> float:
    err = max_abs_err(got, want)
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"{what}: kernel differs from its plain "
                             f"version (max abs limb difference {err})")
    return err


def checked(results, kernel: str, lanes: int) -> None:
    """Note that ``kernel`` was held bit-equal to its plain version at a
    launch over ``lanes`` lanes."""
    results.setdefault("checked_lanes", {}).setdefault(kernel, set()).add(
        int(lanes))


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
    ms, got = cuda_ms(lambda: curve.pp_add(X, Y), 20)
    plain_ms, want = cuda_ms(lambda: curve.pp_add_plain(X, Y), 1,
                             warmup=False)
    err = max(err, require_equal(f"pp_add ({m} lanes)", got, want))
    for lanes in (n, Pe[0].shape[0], m):
        checked(results, "pp_add", lanes)
    results["pp_add"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         "shape": m}
    say("pp_add", f"bit-equal to the plain version on {n} random pairs, "
        f"their projective sums and doublings, {Pe[0].shape[0]} edge "
        f"cases and the {m} timed lanes; {m} lanes: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.3f} ms")


def phase_bucket(dev, bases, results,
                 sizes=(1 << 16, 1 << 17)) -> dict:
    """Kernel 2 against its plain version on a small grid with empty slots,
    then on the grid of one MSM of each size in ``sizes`` at the window the
    device MSM picks for it (c = 12 and 14: every window the driven paths
    use), timed at the last. Returns {c: the kernel's bucket sums}."""
    from jolt_atlas_tpu_torch.device import msm as dmsm
    from jolt_atlas_tpu_torch.device.gate import random_scalars
    # small grid: 4096 random 254-bit scalars, window 6 (-1 padded rows)
    n, c = 4096, 6
    raw = random_scalars(n, 77)
    small_rows = dmsm.rows_for(raw, n, c)
    grid = dmsm.digit_grid(dmsm.scalars_tensor(raw, n, dev), c, small_rows)
    if not bool((grid < 0).any()):
        raise AssertionError("bucket check grid has no empty slots")
    err = require_equal("bucket_accumulate",
                        dmsm.bucket_accumulate(bases, grid),
                        dmsm.bucket_accumulate_plain(bases, grid))
    checked(results, "bucket_accumulate", grid.shape[1])
    sums, shapes = {}, []
    for i, n in enumerate(sizes):
        c = dmsm._pick_c(n)
        raw = random_scalars(n, 78 + i)
        grid = dmsm.digit_grid(dmsm.scalars_tensor(raw, n, dev), c,
                               dmsm.rows_for(raw, n, c))
        ms, got = cuda_ms(lambda: dmsm.bucket_accumulate(bases, grid), 5)
        plain_ms, want = cuda_ms(
            lambda: dmsm.bucket_accumulate_plain(bases, grid), 1,
            warmup=False)
        err = max(err, require_equal(f"bucket_accumulate (n={n}, c={c}, "
                                     f"grid {tuple(grid.shape)})", got, want))
        checked(results, "bucket_accumulate", grid.shape[1])
        sums[c] = got
        shapes.append(f"{n} scalars at c={c}, grid {tuple(grid.shape)}: "
                      f"kernel {ms:.3f} ms, plain {plain_ms:.1f} ms")
    results["bucket_accumulate"] = {"max_abs_err": err, "ms": ms,
                                    "plain_ms": plain_ms,
                                    "shape": list(grid.shape)}
    say("bucket", f"bit-equal to the plain version on a {small_rows}-row "
        f"grid (4096 scalars, c=6) and on " + "; ".join(shapes))
    return sums


def phase_combine(dev, bases, results, sums: dict, k: int = 17,
                  c: int = 14) -> None:
    """Kernel 3 against its plain version on one MSM's real bucket sums at
    each window of ``sums`` (phase_bucket's), then, timed, at the largest
    shape the prove gives it: the fold batch of 17 MSMs at c = 14."""
    from jolt_atlas_tpu_torch.device import curve, msm as dmsm
    err, real = 0.0, []
    for cc, acc1 in sorted(sums.items()):
        acc1 = tuple(a.unsqueeze(0) for a in acc1)
        ms1, got = cuda_ms(lambda: dmsm.bucket_combine(acc1, cc), 5)
        plain1, want = cuda_ms(lambda: dmsm.bucket_combine_plain(acc1, cc),
                               1, warmup=False)
        err = max(err, require_equal(
            f"bucket_combine (k=1, c={cc}, real bucket sums)", got, want))
        checked(results, "bucket_combine", acc1[0].shape[1])
        real.append(f"c={cc} (kernel {ms1:.3f} ms, plain {plain1:.1f} ms)")
    W, B, _ = dmsm.window_shape(c)
    L = W * B
    gen = torch.Generator(device="cpu").manual_seed(2025)
    i1, i2 = (torch.randint(0, bases[0].shape[0], (k * L,), generator=gen)
              .to(dev) for _ in range(2))
    acc = curve.pp_add(tuple(b[i1] for b in bases),
                       tuple(b[i2] for b in bases))
    acc = tuple(t.reshape(k, L, 4).clone() for t in acc)
    # empty buckets, as digit 0 and the top window's spare lanes leave them
    ident = (torch.rand((k, L), generator=gen) < 0.2).to(dev)
    for a, o in zip(acc, curve.pp_identity(1, dev)):
        a[ident] = o[0]
    Pe, Qe = curve.edge_case_pairs(dev)
    m = Pe[0].shape[0]
    for a, p, q in zip(acc, Pe, Qe):
        a[:, 1:1 + m] = p
        a[:, B + 1:B + 1 + m] = q
    ms, got = cuda_ms(lambda: dmsm.bucket_combine(acc, c), 5)
    plain_ms, want = cuda_ms(lambda: dmsm.bucket_combine_plain(acc, c), 1,
                             warmup=False)
    err = max(err, require_equal(f"bucket_combine (k={k}, c={c})", got,
                                 want))
    checked(results, "bucket_combine", L)
    results["bucket_combine"] = {"max_abs_err": err, "ms": ms,
                                 "plain_ms": plain_ms, "shape": [k, L]}
    say("combine", f"bit-equal to the plain version on one MSM's real "
        f"bucket sums at {', '.join(real)}, and on {k} MSMs x {L} buckets "
        f"(c={c}, {dmsm.combine_threads(c)} threads per window) with "
        f"identity buckets and {m} edge cases: kernel {ms:.3f} ms, plain "
        f"{plain_ms:.1f} ms")


def _msm_stages(engine, raw: bytes, n: int) -> dict:
    """Milliseconds (host clock, synchronised after each stage) of the
    stages of one device MSM at the adaptive window, and the kernel
    launches of its combine. The caller keeps the minimum of a few runs:
    the host-side stages share a busy host."""
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

    rows = dmsm.rows_for(raw, n, c)
    lap("host_count")
    sc = dmsm.scalars_tensor(raw, n, engine.device)
    lap("upload")
    grid = dmsm.digit_grid(sc, c, rows)
    lap("digit_grid")
    acc = dmsm.bucket_accumulate(engine.bases, grid)
    lap("bucket_accumulate")
    before = telemetry.launches()
    R = dmsm.bucket_combine(tuple(a.unsqueeze(0) for a in acc), c)
    lap("bucket_combine")
    after = telemetry.launches()
    out["combine_launches"] = sum(after.values()) - sum(before.values())
    engine.finish((R, 1, c))
    lap("host_horner")
    return out


def phase_msm(dev, srs, n: int = 1 << 17) -> None:
    from jolt_atlas_tpu_torch.device import gate, msm as dmsm
    from jolt_atlas_tpu_torch.curve.native import pack_scalars
    from jolt_atlas_tpu_torch.field.constants import FR_MODULUS
    prep = srs.prepared_bases()
    rng = np.random.default_rng(1717)
    vals = [int.from_bytes(rng.bytes(32), "little") % FR_MODULUS
            for _ in range(n)]
    full = pack_scalars(vals)
    small = pack_scalars(rng.integers(0, 1 << 16, size=n))
    out = []
    # 16-bit scalars at c = 8: a window straddling bit 16 would be skewed
    for name, raw, c in (("254-bit", full, 0), ("16-bit", small, 8)):
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
    runs = [_msm_stages(srs.device_bases(dev, gate.forced("device")), full,
                        n) for _ in range(3)]
    stages = {k: min(r[k] for r in runs) for k in runs[0]}
    out.append("stages (min of 3, ms) " + ", ".join(
        f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
        for k, v in stages.items()))
    if dmsm._host_grid_rows(small, n, dmsm._pick_c(n)) >= 0:
        raise AssertionError("16-bit scalars at the adaptive window were "
                             "not refused as skewed")
    out.append("16-bit at the adaptive window refused as skewed")
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
        "dev_base_setup_s_per_pt": g.cal["dev_base_setup_sppt"],
        "fit_fixed_s": fixed, "fit_rate_pps": rate,
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
    return {"wall_s": wall_us / 1e6, "device_busy_s": busy / 1e6,
            "idle_share": 1 - busy / wall_us,
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


def phase_prove(dev, srs, results, dims=(65, 64, 64, 4, 4)) -> None:
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

    def prove(device, msm_gate):
        profiling.enable()
        profiling._EVENTS.clear()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        proof, io = AtlasProver(pp, device=device,
                                msm_gate=msm_gate).prove([toks])
        torch.cuda.synchronize()
        wall = time.time() - t0
        phases = {name: round(w, 6) for name, w, _ in profiling._EVENTS
                  if not name.startswith(" ")}
        return (proof, io, wall, phases,
                torch.cuda.max_memory_allocated() / 2**20)

    paths = [("gate", dev, None), ("split", dev, gate.forced("split")),
             ("host", None, None)]
    for _, device, g in paths[:2]:
        prove(device, g)  # warm-up: first launches at each path's shapes
    out, blobs = {}, {}
    for name, device, g in paths:
        need = ("bucket_accumulate", "bucket_combine") if device else ()
        (proof, io, wall, phases, peak), tele = counted(
            results, need, lambda: prove(device, g))
        if device is not None:
            d = tele["dispatches"]
            for site in ("msm:hyperkzg_fold", "msm:hyperkzg_witness"):
                if not d.get(site):
                    raise AssertionError(f"{name}: no device MSM dispatch at "
                                         f"{site}: {tele}")
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
    trace = trace_prove(lambda: AtlasProver(pp, device=dev).prove([toks]))
    overlap = trace_split(dev, srs)
    say("trace", "gate-path prove under torch.profiler: "
        + json.dumps(trace) + "; split MSM, host prefix against the device "
        "suffix: " + json.dumps(overlap))


KERNELS = (
    ("pp_add", "jolt_atlas_tpu_torch/csrc/curve.cu",
     "jolt_atlas_tpu/tpu/pallas_curve.py:174"),
    ("bucket_accumulate", "jolt_atlas_tpu_torch/csrc/msm.cu",
     "jolt_atlas_tpu/tpu/msm.py:211"),
    ("bucket_combine", "jolt_atlas_tpu_torch/csrc/combine.cu",
     "jolt_atlas_tpu/tpu/msm.py:356"),
)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import jolt_atlas_tpu_torch  # noqa: F401  (fails outside a checkout)
    from jolt_atlas_tpu_torch.device import gate
    dev = torch.device("cuda")
    card = card_line()
    say("device", f"{torch.cuda.get_device_name(0)}; nvidia-smi: {card}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    phase_build()
    results: dict = {}
    from jolt_atlas_tpu_torch.preprocessing import cached_srs
    srs = cached_srs(18)  # the bench prove's SRS size
    bases = srs.device_bases(dev, gate.forced("device")).bases
    phase_pp_add(dev, bases, results)
    sums = phase_bucket(dev, bases, results)
    phase_combine(dev, bases, results, sums)
    del sums  # not to count toward the proves' peak device memory
    phase_msm(dev, srs)
    phase_gate(dev, results)
    phase_split(dev, srs, results)
    phase_prove(dev, srs, results)
    require_checked(results)
    launches = results["launches"]
    kernels = []
    for name, src, repl in KERNELS:
        r = results[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": repl, "launches": launches.get(name, 0),
                        "max_abs_err": r["max_abs_err"],
                        "ms": r["ms"], "plain_ms": r["plain_ms"]})
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
