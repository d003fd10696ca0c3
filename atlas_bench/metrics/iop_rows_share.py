"""iop_rows_share: the row elements the IOP's split-eq (Gruen) instances
bound on the card over all they bound, card and host, in % (the program's
telemetry counters ``iop_rows_bound_card`` and ``iop_rows_bound_host``,
P x n a bind; device/rows.py, subprotocols/sumcheck.py), over the window's
proofs (spans.window)."""

from atlas_bench import spans


def read(r):
    w = spans.window(r)
    if w is None:
        return None
    c = w["counters"]
    card = c.get("iop_rows_bound_card", 0)
    total = card + c.get("iop_rows_bound_host", 0)
    return 100.0 * card / total if total else None
