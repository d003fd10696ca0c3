"""reduction_s: seconds a proof in the program's
``batch_opening_reduction`` span (utils/profiling.py), the mean over the
window's proofs."""


def read(r):
    return r["phases"].get("batch_opening_reduction")
