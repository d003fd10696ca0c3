"""host_field_calls: calls a proof into the host field engine (the
program's telemetry counter ``host_field_calls``, counted at the handles of
field/frvec.py's C library), the mean over the window's proofs
(spans.window)."""

from atlas_bench import spans


def read(r):
    w = spans.window(r)
    return None if w is None else w["counters"].get("host_field_calls")
