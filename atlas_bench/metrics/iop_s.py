"""iop_s: seconds a proof in the program's ``iop`` span
(utils/profiling.py), the mean over the window's proofs."""


def read(r):
    return r["phases"].get("iop")
