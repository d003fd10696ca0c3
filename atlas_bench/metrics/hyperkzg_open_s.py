"""hyperkzg_open_s: seconds a proof in the program's ``hyperkzg_open`` span
(utils/profiling.py), the mean over the window's proofs."""


def read(r):
    return r["phases"].get("hyperkzg_open")
