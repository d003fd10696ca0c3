"""The port's benchmark: one run of one cell of BENCHMARK.json.

    python3 atlas_bench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Run from the root of a checkout on a machine with the cell's cards. The
last line of standard output is the run's one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``; with ``--trace 1``
also ``breakdown``; ``checks`` last): ``--trace 0`` reports the cell's
end-to-end metrics, ``--trace 1`` its per-layer ones. Everything else goes
to standard error, whose last lines are the numbers compared beside their
limits. Without the cards the cell asks for, or with JAX or the JAX
package loaded once the window has closed, it exits with another code
than 0 and prints no result.
"""

import time

T0 = time.time()  # set-up runs from the process's start

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "jolt_atlas_tpu")
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR":
          "torch_extensions"}


def loaded_forbidden() -> list[str]:
    """The forbidden top-level modules in sys.modules, by whole name."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


@contextlib.contextmanager
def stdout_to_stderr():
    """Send everything written to standard output, by Python or by native
    code, to standard error while the block runs."""
    sys.stdout.flush()
    saved = os.dup(1)
    os.dup2(2, 1)
    try:
        yield
    finally:
        sys.stdout.flush()
        os.dup2(saved, 1)
        os.close(saved)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = os.path.join(ROOT, "atlas_bench", "_cache", sub)
    sys.path.insert(0, ROOT)

    import torch

    from atlas_bench import cells, harness

    cell = cells.find(ROOT, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    with stdout_to_stderr():
        out = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                          torch.device("cuda", 0), T0)
    bad = loaded_forbidden()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
