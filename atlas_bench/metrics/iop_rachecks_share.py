"""iop_rachecks_share: the one-hot elements of the IOP's read-check
batches (D chunk rows x T cycles a batch of a Booleanity and its
AddressReadChecks) that the card's read-check engine proved, over all that
were proved, card and host, in % (the program's telemetry counters
``iop_rachecks_card``, device/onehot.py, and ``iop_rachecks_host``,
subprotocols/onehot.py), over the window's proofs (spans.window). None
where the program counts neither."""

from atlas_bench import spans


def read(r):
    w = spans.window(r)
    if w is None:
        return None
    c = w["counters"]
    card = c.get("iop_rachecks_card", 0)
    total = card + c.get("iop_rachecks_host", 0)
    return 100.0 * card / total if total else None
