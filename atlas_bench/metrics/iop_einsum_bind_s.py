"""iop_einsum_bind_s: seconds a proof in the program's ``einsum_bind``
spans under its ``iop`` span: each einsum operand partially evaluated at
its exclusive output variables before the contraction sumcheck
(``_prove_einsum`` in zkops/ops.py), the mean over the window's proofs
(spans.window)."""

from atlas_bench import spans


def read(r):
    return spans.seconds(spans.window(r), "iop", "einsum_bind")
