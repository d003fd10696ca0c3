"""iop_eval_reduction_s: seconds a proof in the program's
``eval_reduction`` spans (prover.py, around each node's eval reduction,
outside the node spans) under its ``iop`` span; the mean over the window's
proofs (spans.window)."""

from atlas_bench import spans


def read(r):
    return spans.seconds(spans.window(r), "iop", "eval_reduction")
