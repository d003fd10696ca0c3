"""iop_sumcheck_s: seconds a proof in the program's sumcheck spans
(``sumcheck:<kind>``, one a Sumcheck.prove, BatchedSumcheck.prove or
prove_tail call; subprotocols/sumcheck.py) under its ``iop`` span, the
rows engine's rounds inside them included; the mean over the window's
proofs (spans.window)."""

from atlas_bench import spans


def read(r):
    return spans.seconds(spans.window(r), "iop", "sumcheck:")
