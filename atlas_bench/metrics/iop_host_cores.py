"""iop_host_cores: the process's CPU seconds over the wall seconds of the
program's ``iop`` span (utils/profiling.py), over the window's proofs
(spans.window): the cores the IOP keeps busy, OpenMP threads that spin
while they wait counted as busy."""

from atlas_bench import spans


def read(r):
    w = spans.window(r)
    row = None if w is None else w["spans"].get("iop")
    if not row or not row[0]:
        return None
    return row[1] / row[0]
