"""What decides ``correct``: every proof of the window, held against the
plain reference once the window has closed.

Two numbers, each an exact comparison with the limit 0:
- ``io_mismatch``: the elements of the served io (the tokens the proof
  binds and the logits it attests) that differ from the request's tokens
  and from the plain forward that the configuration names
  (``reference/<name>.py``): the reference comparison;
- ``rejected``: the proofs that the frozen verifier (``frozen_judge.py``)
  rejects when it is given the reference's tokens and logits. It is a
  copy of the program's verifier taken when the benchmark was written, a
  guard that later changes to the program's verifier cannot move, and
  no independent reference: a fault that the prover and the verifier
  share passes it.
A run is correct when both are within their limits, every request of the
window was proved and the program's own verifier accepted every proof.
"""

from __future__ import annotations

import numpy as np

LIMITS = {"io_mismatch": 0, "rejected": 0}


def mismatches(got, want: np.ndarray) -> int:
    """Elements of ``got`` that differ from ``want`` (all of them when the
    shapes differ)."""
    got = np.asarray(got)
    if got.shape != want.shape:
        return int(want.size)
    return int(np.count_nonzero(got != want))


def judge(cell, weights: dict, served: list) -> tuple[dict, dict | None]:
    """(each number compared, the shapes the first proof fixes) for
    ``served``, a list of (tokens, io, serialised proof), of ``cell`` with
    the benchmark's ``weights``."""
    from .frozen_judge import Judge
    judge_ = Judge(cell, weights)
    got = {"io_mismatch": 0, "rejected": 0}
    shapes = None
    for toks, (ins, outs), blob in served:
        ref = cell.reference.forward(cell.config, weights, toks)
        got["io_mismatch"] += (mismatches(ins[0], toks)
                               + mismatches(outs[0], ref))
        ok, sh = judge_.verify(blob, toks, ref)
        got["rejected"] += not ok
        if shapes is None and ok:
            shapes = sh
    return got, shapes


def within(got: dict) -> bool:
    return all(got[k] <= LIMITS[k] for k in LIMITS)
