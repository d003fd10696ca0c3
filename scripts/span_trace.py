"""One traced run of a benchmark cell, its device trace split by the
program's spans.

    python3 scripts/span_trace.py --workload <cell> --seed <n> --seconds <s>
        [--root DIR] [--device cuda|cpu]

Runs the cell as ``atlas_bench/run.py --trace 1`` does and prints one JSON
object: the run's ``metrics``, ``device`` and ``correct``; the program's
spans a proof by path (wall s, CPU s, calls) and its counters a proof
(``atlas_bench/spans.window``); the traced window split by the program's
spans (``spans.by_span``: device seconds by the spans open at each
operation's launch, idle seconds by the spans open at each gap's middle);
and ``iop_rows_device_ms``, the device milliseconds a proof of the
operations launched inside a ``rows_*`` span. ``--root`` names another
checkout's BENCHMARK.json and cells (its package must be this one's).
"""

from __future__ import annotations

import time

T0 = time.time()  # set-up runs from the process's start, as in run.py

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    from atlas_bench import cells, harness, run, spans, trace

    split: dict = {}
    reduce = trace.reduce

    def reduce_and_split(path, msm_points):
        split.update(spans.by_span(path))
        return reduce(path, msm_points)

    for var, sub in run.CACHES.items():
        os.environ[var] = os.path.join(ROOT, "atlas_bench", "_cache", sub)
    cell = cells.find(args.root, args.workload)
    trace.reduce = reduce_and_split
    try:
        with run.stdout_to_stderr():
            out = harness.run(cell, args.seed, args.seconds, True,
                              torch.device(args.device), T0)
    finally:
        trace.reduce = reduce
    proofs = out["attempted"] - out["failed"]  # all, where it is correct
    w = spans.window({"proofs": proofs})
    rows_s = sum(v for k, v in split.get("device_by_span", {}).items()
                 if k.rsplit("/", 1)[-1].startswith("rows_"))
    print(json.dumps({
        "correct": out["correct"], "metrics": out["metrics"],
        "device": out["device"], "proofs": proofs,
        "spans": w and w["spans"], "counters": w and w["counters"],
        "iop_rows_device_ms": rows_s * 1e3 / proofs if proofs else None,
        **split}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
