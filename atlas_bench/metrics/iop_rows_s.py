"""iop_rows_s: seconds a proof in the program's rows engine spans
(``rows_upload``, ``rows_points``, ``rows_bind``, ``rows_handoff``;
device/rows.py) under its ``iop`` span: the engine as the host waits on it;
the mean over the window's proofs (spans.window)."""

from atlas_bench import spans


def read(r):
    return spans.seconds(spans.window(r), "iop", "rows_")
