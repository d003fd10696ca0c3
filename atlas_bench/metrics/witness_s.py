"""witness_s: seconds a proof in the program's ``witness_generation`` span
(utils/profiling.py), the mean over the window's proofs."""


def read(r):
    return r["phases"].get("witness_generation")
