"""reduction_prepare_s: seconds a proof in the program's
``reduction_prepare`` spans (poly/opening.py: the groups' RLC build and the
joint vector's combination) under its ``batch_opening_reduction`` span; the
mean over the window's proofs (spans.window)."""

from atlas_bench import spans


def read(r):
    return spans.seconds(spans.window(r), "batch_opening_reduction",
                         "reduction_prepare")
