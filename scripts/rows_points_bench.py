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
package's wrapper takes one. Prints the card's name and power limit,
then one JSON line. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
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
    print(cs.card_line())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
