"""iop_einsum_bind_share: the Einsum operand elements that the card's bind
engine bound, over all that were bound, card and host, in % (the program's
telemetry counters ``einsum_bind_card``, device/bind.py, and
``einsum_bind_host``, zkops/ops.py's host path), over the window's proofs
(spans.window). None where the program counts neither."""

from atlas_bench import spans


def read(r):
    w = spans.window(r)
    if w is None:
        return None
    c = w["counters"]
    card = c.get("einsum_bind_card", 0)
    total = card + c.get("einsum_bind_host", 0)
    return 100.0 * card / total if total else None
