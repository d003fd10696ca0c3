"""Kernel 7 (device/rows.py:points, csrc/rows.cu) alone on one GPU.

    python3 scripts/rows_points_bench.py [--terms bench] [--plans]
                                         [--root DIR]

Builds one instance of the bench's largest rows class from seed 27 (27
rows of n = 16,384 random field elements, row 26 all zero, 6 points,
under a split-eq weight) with 36 random terms of up to 6 factors (term
0's coefficient one, a constant term last) or, with ``--terms bench``,
the class's own factor lists (chip_smoke.BENCH_TERMS). Holds the kernel bit-equal to its plain
version, then times it from torch.profiler's device durations
(chip_smoke.device_ms, 20 calls) beside its bound (chip_smoke.
rows_products: the products this data needs as kernel 7 evaluates the
terms, over the card's IMAD peak; only for a package whose Terms groups
them). ``--root DIR`` takes the port's package from another checkout
(e.g. a parent commit unpacked with ``git archive``), so two versions are
compared within one call; ``--plans`` also times kernel 7 at each launch
plan of a small grid (tile, points a block, term slices) where the
package's wrapper takes one. It also times kernel 8 (device/rows.py
from_i64) on as many integers as the bench class's rows hold (27 x
16,384 = 442,368; from seed 28: small values of either sign, one in 16
full-range, as witness rows are mostly small), bit-equal to its plain
version, beside its bound (chip_smoke.bound: 40 bytes an element, and
chip_smoke.IMADS_PER_I64), each traced call after an L2 flush
(chip_smoke.l2_flush), under --root too; ``--i64-variants`` also
builds csrc/rows.cu's conversion (fr_from_i64) into other kernel layouts
(I64_VARIANTS: two or four values a thread, two with stores coalesced by
a swap of halves between neighbouring lanes) and kernel 8's layout with
no arithmetic (the same loads and stores: its floor), each timed on the
same values.
Prints the card's name and power limit, then one JSON line. Exits
non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# kernel 8 in other layouts (--i64-variants); each kernel takes (src, n,
# out) and is launched with 256 threads on min(needed, SMs x 8) blocks of a
# grid that strides over its groups
I64_VARIANTS = r"""
#include "rows.cu"
using namespace jolt;

// kernel 8's own layout (a value a thread), no arithmetic: v in every
// limb
__global__ void __launch_bounds__(256) i64_copy(const int64_t* src,
                                                int64_t n, u64* out) {
  for (int64_t i = blockIdx.x * 256 + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * 256) {
    Fr a;
    for (int j = 0; j < 8; ++j) a.v[j] = (u32)src[i];
    store_fr(out, i, a);
  }
}

// two values a thread: one 16-byte load, four 16-byte stores
__global__ void __launch_bounds__(256) i64_pair(const int64_t* src,
                                                int64_t n, u64* out) {
  for (int64_t g = blockIdx.x * 256 + threadIdx.x; 2 * g < n;
       g += (int64_t)gridDim.x * 256) {
    if (2 * g + 1 < n) {
      const longlong2 w = reinterpret_cast<const longlong2*>(src)[g];
      store_fr(out, 2 * g, fr_from_i64(w.x));
      store_fr(out, 2 * g + 1, fr_from_i64(w.y));
    } else {
      store_fr(out, 2 * g, fr_from_i64(src[2 * g]));
    }
  }
}

// four values a thread: both 16-byte loads first
__global__ void __launch_bounds__(256) i64_quad(const int64_t* src,
                                                int64_t n, u64* out) {
  for (int64_t g = blockIdx.x * 256 + threadIdx.x; 4 * g < n;
       g += (int64_t)gridDim.x * 256) {
    if (4 * g + 3 < n) {
      const longlong2 w0 = reinterpret_cast<const longlong2*>(src)[2 * g];
      const longlong2 w1 =
          reinterpret_cast<const longlong2*>(src)[2 * g + 1];
      store_fr(out, 4 * g, fr_from_i64(w0.x));
      store_fr(out, 4 * g + 1, fr_from_i64(w0.y));
      store_fr(out, 4 * g + 2, fr_from_i64(w1.x));
      store_fr(out, 4 * g + 3, fr_from_i64(w1.y));
    } else {
      for (int64_t i = 4 * g; i < n; ++i)
        store_fr(out, i, fr_from_i64(src[i]));
    }
  }
}

// two values a thread, every store a warp's 512 contiguous bytes: a warp
// takes 64 values; lane 2j + s converts values 16 s + j and 32 + 16 s + j,
// and the two lanes of a pair swap halves so that store k writes value
// 16 k + j's half s from lane 2j + s
// the partner lane's half s of its x (each lane sends its other half)
__device__ __forceinline__ uint4 swap_half(const Fr& x, int s) {
  u32 r[4];
  for (int q = 0; q < 4; ++q)
    r[q] = __shfl_xor_sync(0xffffffffu, s ? x.v[q] : x.v[4 + q], 1);
  return make_uint4(r[0], r[1], r[2], r[3]);
}

__global__ void __launch_bounds__(256) i64_swap(const int64_t* src,
                                                int64_t n, u64* out) {
  const int lane = threadIdx.x & 31, j = lane >> 1, s = lane & 1;
  const int64_t warps = (int64_t)gridDim.x * 8;
  for (int64_t w = blockIdx.x * 8 + (threadIdx.x >> 5); 64 * w < n;
       w += warps) {
    const int64_t base = 64 * w;
    const int64_t ia = base + 16 * s + j, ib = ia + 32;
    const Fr xa = fr_from_i64(ia < n ? src[ia] : 0);
    const Fr xb = fr_from_i64(ib < n ? src[ib] : 0);
    const uint4 ra = swap_half(xa, s), rb = swap_half(xb, s);
    uint4* o = reinterpret_cast<uint4*>(out);
    for (int k = 0; k < 4; ++k) {
      const Fr& x = k < 2 ? xa : xb;
      // value 16 k + j is lane 2j + (k & 1)'s: its own half s where
      // (k & 1) == s, else the half its partner sent
      const uint4 v = (k & 1) == s
          ? make_uint4(x.v[4 * s], x.v[4 * s + 1], x.v[4 * s + 2],
                       x.v[4 * s + 3])
          : (k < 2 ? ra : rb);
      const int64_t e = base + 16 * k + j;
      if (e < n) o[2 * e + s] = v;
    }
  }
}

template <class K>
int launch(K kernel, int per, const void* src, int64_t n, void* out,
           void* stream) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t need = ((n + per - 1) / per + 255) / 256;
  const int64_t most = (int64_t)sms * 8;
  kernel<<<(unsigned)(need < most ? need : most), 256, 0,
           (cudaStream_t)stream>>>((const int64_t*)src, n, (u64*)out);
  return (int)cudaGetLastError();
}

extern "C" int i64_variant(int which, const void* src, int64_t n, void* out,
                           void* stream) {
  switch (which) {
    case 0: return launch(i64_copy, 1, src, n, out, stream);
    case 1: return launch(i64_pair, 2, src, n, out, stream);
    case 2: return launch(i64_quad, 4, src, n, out, stream);
    default: return launch(i64_swap, 2, src, n, out, stream);
  }
}
"""
I64_NAMES = ("i64_copy", "i64_pair", "i64_quad", "i64_swap")
PLANS = [(32, g, s) for g in (1, 2, 3, 6) for s in (2, 3, 4, 6, 8, 12, 16)
         ] + [(64, g, s) for g in (2, 3) for s in (2, 3, 4)]


def chip_smoke():
    """This checkout's chip_smoke.py (its timers and bounds), loaded by
    path so that --root's own copy is not taken instead."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--plans", action="store_true")
    ap.add_argument("--i64-variants", action="store_true")
    ap.add_argument("--terms", choices=("random", "bench"), default="random",
                    help="random terms, or the bench class's factor lists "
                    "(chip_smoke.BENCH_TERMS; 27 rows, 36 terms)")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("rows_points_bench: no CUDA device", file=sys.stderr)
        return 1
    cs = chip_smoke()
    sys.path.insert(0, os.path.abspath(a.root))
    from jolt_atlas_tpu_torch.device import build
    from jolt_atlas_tpu_torch.device import rows as drows
    P, n, T, mf, nevals = 27, 1 << 14, 36, 6, 6  # the bench's largest
    dev = torch.device("cuda")
    gen = np.random.default_rng(27)
    x = drows.random_rows_for(P, n, gen, dev)
    raw = (cs.bench_terms(gen) if a.terms == "bench"
           else drows.random_terms(P, T, mf, gen))
    terms = drows.Terms(raw, dev)
    w = drows.weights(*drows.random_weights(n, "split", gen), dev)
    want = drows.points_plain(x, n, nevals, terms, w)
    out = {"root": os.path.abspath(a.root), "terms": a.terms,
           "class": [P, n, T, mf, nevals]}
    bound_ms = None
    if hasattr(terms, "groups"):  # the kernel's own count of products
        need, direct, _ = cs.rows_products(x, n, nevals, terms, w)
        nbytes = (P * n + nevals + w[0].shape[0]) * cs.FR_BYTES
        bound_ms, by = cs.bound(need, nbytes, cs.imad_peak(),
                                cs.IMADS_PER_MUL)
        out.update(products=need, bound_ms=bound_ms, bound_by=by,
                   products_term_by_term=direct)

    def one(fn):
        ms, call, got = cs.device_ms(fn, 20, "rows_", "rows_points")
        if not torch.equal(got, want):
            raise AssertionError("kernel 7 differs from its plain version")
        return {"ms": ms, "call_ms": call,
                "share": bound_ms / ms if bound_ms else None}

    out["default"] = one(lambda: drows.points(x, n, nevals, terms, w))
    if hasattr(drows, "points_plan"):
        out["default"]["plan"] = drows.points_plan(
            P, n, nevals, terms.slices, torch.cuda.get_device_properties(
                0).multi_processor_count)
        from jolt_atlas_tpu_torch.device import kernel_report
        out["ptxas"] = kernel_report.parse_ptxas(build.ptxas_report()).get(
            "rows_points_kernel")
    if a.plans and hasattr(drows, "points_plan"):
        out["plans"] = []
        for tile, group, slices in PLANS:
            ts = drows.Terms(raw, dev, slices)
            try:
                drows.points_plan(P, n, nevals, slices, 1, tile, group)
            except ValueError:
                continue
            r = one(lambda: drows.points(x, n, nevals, ts, w, tile, group))
            out["plans"].append({"tile": tile, "group": group,
                                 "slices": slices, **r})
    # each call after an L2 flush: the 17.7 MB it moves would otherwise
    # stay in the 50 MB L2 between calls
    gen8 = np.random.default_rng(28)
    v = gen8.integers(-(1 << 16), 1 << 16, size=P * n)
    wide = gen8.random(P * n) < 1 / 16
    v[wide] = gen8.integers(-(1 << 63), (1 << 63) - 1, size=int(wide.sum()),
                            dtype=np.int64, endpoint=True)
    src = torch.from_numpy(v.astype(np.int64)).to(dev)
    ms8, call8, got = cs.device_ms(lambda: drows.from_i64(src), 20,
                                   "rows_from_i64", cold=True)
    if not torch.equal(got, drows.from_i64_plain(src)):
        raise AssertionError("kernel 8 differs from its plain version")
    b8, by8 = cs.bound(P * n, P * n * (8 + cs.FR_BYTES), cs.imad_peak(),
                       cs.IMADS_PER_I64)
    out["from_i64"] = {"values": P * n, "ms": ms8, "call_ms": call8,
                       "bound_ms": b8, "bound_by": by8, "share": b8 / ms8}
    if a.i64_variants:
        from jolt_atlas_tpu_torch.device import kernel_report, telemetry
        want = got.clone()
        res = torch.empty_like(want)
        out["from_i64"]["variants"] = {}
        with tempfile.TemporaryDirectory() as tmp:
            lib = kernel_report.probe_library(I64_VARIANTS, build.CUDA_SRC,
                                              tmp)
            f = lib.i64_variant
            f.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
                          ctypes.c_void_p, ctypes.c_void_p]
            for which, name in enumerate(I64_NAMES):
                def run(which=which):
                    stream = torch.cuda.current_stream(dev).cuda_stream
                    if f(which, src.data_ptr(), P * n, res.data_ptr(),
                         stream):
                        raise RuntimeError(f"{name} launch failed")
                    telemetry.launch("i64_probe", 0)
                    return res
                vms, vcall, vgot = cs.device_ms(run, 20, name, "i64_probe",
                                                cold=True)
                if name != "i64_copy" and not torch.equal(vgot, want):
                    raise AssertionError(f"{name} differs from kernel 8")
                out["from_i64"]["variants"][name] = {
                    "ms": vms, "call_ms": vcall, "share": b8 / vms,
                    **lib.ptxas.get(name, {})}
    if hasattr(build, "ptxas_report"):
        from jolt_atlas_tpu_torch.device import kernel_report
        out["from_i64"]["ptxas"] = kernel_report.parse_ptxas(
            build.ptxas_report()).get("rows_from_i64_kernel")
    print(cs.card_line())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
