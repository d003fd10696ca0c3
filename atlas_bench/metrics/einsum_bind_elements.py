"""einsum_bind_elements: the operand elements a proof's einsum binds read
(the program's telemetry counter ``einsum_bind_elements``, an operand's
size at each bind in ``_prove_einsum``, zkops/ops.py), the mean over the
window's proofs (spans.window)."""

from atlas_bench import spans


def read(r):
    w = spans.window(r)
    return None if w is None else w["counters"].get("einsum_bind_elements")
