"""The control of ``correct``, at a cell's own size: the reference put in
the program's place at the nearest precision below the configuration's.

The configuration states int32 fixed point with s fractional bits, every
product exact in int64 and then floor-rescaled. The control keeps s - 1
fractional bits in every product (the plain forward's ``lost=1``):
each served io's logits are replaced by that forward's, the proofs stay
the program's. A run of the control has to come out not correct; its
numbers are the upper readings of the limits in ``correct.LIMITS``.

    python3 atlas_bench/control.py --workload <cell> --seeds <a,b,c>
        --seconds <s> [--lost 1]

One JSON line a seed on standard output (the run's ``correct`` and
``checks``). The benchmark's own runs never run it.
"""

import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@contextlib.contextmanager
def in_program_place(cell, seed: int, device, lost: int):
    """While entered, every proof's io carries the control's logits: the
    configuration's plain forward over the seed's weights with ``lost``
    fractional bits fewer in every product."""
    from jolt_atlas_tpu_torch.prover import AtlasProver

    from atlas_bench import inputs

    builder, cfg = cell.builder, cell.config
    weights = builder.weights(cfg, inputs.normals(
        builder.weight_shapes(cfg), seed, device))
    real = AtlasProver.prove

    def prove(self, ins):
        proof, (pin, pout) = real(self, ins)
        low = cell.reference.forward(cfg, weights, ins[0], lost=lost)
        return proof, (pin, [low] + list(pout[1:]))

    AtlasProver.prove = prove
    try:
        yield
    finally:
        AtlasProver.prove = real


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--lost", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from atlas_bench import cells, harness
    from atlas_bench.run import stdout_to_stderr

    cell = cells.find(ROOT, args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        device = torch.device(args.device)
        with stdout_to_stderr(), in_program_place(cell, seed, device,
                                                  args.lost):
            out = harness.run(cell, seed, args.seconds, False, device,
                              time.time())
        print(json.dumps({"seed": seed, "correct": out["correct"],
                          "attempted": out["attempted"],
                          "checks": out["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
