"""Chip smoke run of the PyTorch/CUDA port (jolt_atlas_tpu_torch) on one GPU.

    python3 chip_smoke.py            # every phase, from the repo root

Phases, in order; each prints one line and raises on failure, so the
script exits non-zero when any phase fails:

  1. device   a CUDA device is present; its name and power limit
  2. build    the CUDA kernels (sm_90a) and the host C++ engines, from source
  3. pp_add   kernel 1 against its plain PyTorch version on the card: 2^16
              random pairs plus doubling, P + (-P), the identity on either
              side and coordinates near p; bit-equal
  4. bucket   kernel 2 against its plain version on a small grid with empty
              (-1) slots; bit-equal. Both timed at the main path's shape
  5. msm      the device MSM against the host csrc MSM at n = 2^17: random
              254-bit scalars (adaptive window) and 16-bit scalars; affine
              points equal
  6. prove    the bench nanoGPT (4 blocks, 4 heads, d64, seq 64, vocab 65,
              random weights from seed 1234) proved with the device MSM
              engine and again on the host; proof bytes equal; the port's
              verifier accepts it and rejects a flipped commitment. The
              kernel launch counts are read from this run alone.
  7. trace    one more device-path prove under torch.profiler: the
              device's idle share and its busiest kernels.

The second line from the end is the kernels JSON, the last line
{"ok": true, "device": {...}}. Imports nothing of JAX or jolt_atlas_tpu.
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
    from jolt_atlas_tpu_torch.device import curve, msm as dmsm
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
    # the biggest pp_add of the bench prove: the combine's first reduction
    # over the fold batch (17 MSMs padded to 32, c = 14)
    W, _, _ = dmsm.window_shape(14)
    m = 32 * W * (1 << 7)
    X = tuple(t.repeat(2, 1)[:m] for t in R1)
    Y = tuple(t.roll(3, 0) for t in X)
    ms, got = cuda_ms(lambda: curve.pp_add(X, Y), 20)
    plain_ms, want = cuda_ms(lambda: curve.pp_add_plain(X, Y), 1,
                             warmup=False)
    err = max(err, require_equal(f"pp_add ({m} lanes)", got, want))
    results["pp_add"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         "shape": m}
    say("pp_add", f"bit-equal to the plain version on {n} random pairs, "
        f"their projective sums and doublings, {Pe[0].shape[0]} edge "
        f"cases and the {m} timed lanes; {m} lanes: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.3f} ms")


def phase_bucket(dev, bases, results, n_main: int = 1 << 17) -> None:
    from jolt_atlas_tpu_torch.device import msm as dmsm
    rng = np.random.default_rng(77)
    # small grid: 4096 random 254-bit scalars, window 6 (-1 padded rows)
    n, c = 4096, 6
    raw = _random_scalars(rng, n)
    small_rows = dmsm.rows_for(raw, n, c)
    grid = dmsm.digit_grid(dmsm.scalars_tensor(raw, n, dev), c, small_rows)
    if not bool((grid < 0).any()):
        raise AssertionError("bucket check grid has no empty slots")
    err = require_equal("bucket_accumulate",
                        dmsm.bucket_accumulate(bases, grid),
                        dmsm.bucket_accumulate_plain(bases, grid))
    # the main path's shape: the 2^17-point fold MSM, c = 14
    n, c = n_main, 14
    raw = _random_scalars(rng, n)
    rows = dmsm.rows_for(raw, n, c)
    grid = dmsm.digit_grid(dmsm.scalars_tensor(raw, n, dev), c, rows)
    ms, got = cuda_ms(lambda: dmsm.bucket_accumulate(bases, grid), 5)
    plain_ms, want = cuda_ms(
        lambda: dmsm.bucket_accumulate_plain(bases, grid), 1, warmup=False)
    err = max(err, require_equal(f"bucket_accumulate (grid "
                                 f"{tuple(grid.shape)})", got, want))
    results["bucket_accumulate"] = {"max_abs_err": err, "ms": ms,
                                    "plain_ms": plain_ms,
                                    "shape": list(grid.shape)}
    say("bucket", f"bit-equal to the plain version on a {small_rows}-row "
        f"grid (4096 scalars, c=6) and on {n} scalars at c={c}, grid "
        f"{tuple(grid.shape)}: kernel {ms:.3f} ms, plain {plain_ms:.1f} ms")


def _random_scalars(rng, n: int) -> bytes:
    """n uniform scalars below 2^253 (< r), 32 bytes LE each."""
    limbs = np.frombuffer(rng.bytes(32 * n), dtype=np.uint64).reshape(n, 4)
    limbs = limbs.copy()
    limbs[:, 3] &= np.uint64((1 << 61) - 1)
    return limbs.tobytes()


def _msm_stages(engine, raw: bytes, n: int) -> dict:
    """Milliseconds (host clock, synchronised after each stage) of the
    stages of one device MSM at the adaptive window, and the pp_add
    launches of its fold and combine. The caller keeps the minimum of a
    few runs: the host-side stages share a busy host."""
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
    before = telemetry.launches().get("pp_add", 0)
    acc = dmsm.fold_top(acc, c)
    lap("fold_top")
    R = dmsm.combine_batch([acc], c)
    lap("combine")
    out["pp_add_launches"] = telemetry.launches().get("pp_add", 0) - before
    engine.finish((R, 1, c))
    lap("host_horner")
    return out


def phase_msm(dev, srs, n: int = 1 << 17) -> None:
    from jolt_atlas_tpu_torch.device import msm as dmsm
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
        engine = srs.device_bases(dev, c=c)
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
    runs = [_msm_stages(srs.device_bases(dev), full, n) for _ in range(3)]
    stages = {k: min(r[k] for r in runs) for k in runs[0]}
    out.append("stages (min of 3, ms) " + ", ".join(
        f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
        for k, v in stages.items()))
    if dmsm._host_grid_rows(small, n, dmsm._pick_c(n)) >= 0:
        raise AssertionError("16-bit scalars at the adaptive window were "
                             "not refused as skewed")
    out.append("16-bit at the adaptive window refused as skewed")
    say("msm", f"n={n} equal to the host MSM; " + "; ".join(out))


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


def phase_prove(dev, results, dims=(65, 64, 64, 4, 4)) -> None:
    from jolt_atlas_tpu_torch import models, serde
    from jolt_atlas_tpu_torch.curve.points import g1_generator
    from jolt_atlas_tpu_torch.device import telemetry
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
    pp.srs.device_bases(dev)  # base upload: set-up, outside the prove
    torch.cuda.synchronize()

    def prove(device):
        profiling.enable()
        profiling._EVENTS.clear()
        t0 = time.time()
        proof, io = AtlasProver(pp, device=device).prove([toks])
        torch.cuda.synchronize()
        wall = time.time() - t0
        phases = {name: round(w, 6) for name, w, _ in profiling._EVENTS
                  if not name.startswith(" ")}
        return proof, io, wall, phases

    prove(dev)  # warm-up: first launches, allocator
    telemetry.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    proof, io, dev_s, dev_phases = prove(dev)
    tele = telemetry.snapshot()
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    host_proof, _, host_s, host_phases = prove(None)
    blob = serde.serialize_proof(proof)
    if blob != serde.serialize_proof(host_proof):
        raise AssertionError("device-path proof bytes differ from host path")
    verifier = AtlasVerifier(pp)
    t0 = time.time()
    if not verifier.verify(serde.deserialize_proof(blob), io):
        raise AssertionError("verifier rejected the device-path proof")
    verify_s = time.time() - t0
    bad = serde.deserialize_proof(blob)
    pid = sorted(bad.commitments)[0]
    bad.commitments[pid] = bad.commitments[pid] + g1_generator()
    if verifier.verify(bad, io):
        raise AssertionError("verifier accepted a flipped commitment")
    trace = trace_prove(lambda: AtlasProver(pp, device=dev).prove([toks]))
    d = tele["dispatches"]
    for site in ("msm:hyperkzg_fold", "msm:hyperkzg_witness"):
        if not d.get(site):
            raise AssertionError(f"no device MSM dispatch at {site}: {tele}")
    for k in ("pp_add", "bucket_accumulate"):
        if not tele["launches"].get(k):
            raise AssertionError(f"kernel {k} not launched by the prove")
    results["launches"] = tele["launches"]
    say("prove", json.dumps({
        "model": f"nanogpt {blocks} blocks, {heads} heads, d{dim}, "
                 f"seq {seq}, vocab {vocab}",
        "setup_s": setup_s, "prove_s_device": dev_s, "prove_s_host": host_s,
        "verify_s": verify_s, "peak_device_MiB": peak_mib,
        "phases_device": dev_phases,
        "phases_host": host_phases, "proof_bytes": len(blob),
        "bytes_equal_host": True, "tamper_rejected": True,
        "telemetry": tele}))
    say("trace", "device-path prove under torch.profiler: "
        + json.dumps(trace))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import jolt_atlas_tpu_torch  # noqa: F401  (fails outside a checkout)
    dev = torch.device("cuda")
    card = card_line()
    say("device", f"{torch.cuda.get_device_name(0)}; nvidia-smi: {card}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    phase_build()
    results: dict = {}
    from jolt_atlas_tpu_torch.preprocessing import cached_srs
    srs = cached_srs(18)  # the bench prove's SRS size
    bases = srs.device_bases(dev).bases
    phase_pp_add(dev, bases, results)
    phase_bucket(dev, bases, results)
    phase_msm(dev, srs)
    phase_prove(dev, results)
    launches = results["launches"]
    kernels = []
    for name, src, repl in (
            ("pp_add", "jolt_atlas_tpu_torch/csrc/curve.cu",
             "jolt_atlas_tpu/tpu/pallas_curve.py:174"),
            ("bucket_accumulate", "jolt_atlas_tpu_torch/csrc/msm.cu",
             "jolt_atlas_tpu/tpu/msm.py:211")):
        r = results.get(name, {})
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": repl, "launches": launches.get(name, 0),
                        "max_abs_err": r.get("max_abs_err"),
                        "ms": r.get("ms"), "plain_ms": r.get("plain_ms")})
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
