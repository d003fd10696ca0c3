"""The one generator of traffic: it reads a mix's parameters
(``traffic/<name>.json``) and makes each proof's request from the seed.

Parameters:
- ``loop``: "closed", the only kind: one request at a time, the next sent
  when the last proof is done;
- ``clients``: 1;
- ``transcript``: the Fiat-Shamir transcript the proofs run under,
  "blake2b" or "keccak";
- ``pcs``: the polynomial commitment, "hyperkzg" or "dory";
- ``entry``: the prover's entry, "prove" or "prove_zk" (verified by
  ``verify`` or ``verify_zk``);
- ``tokens``: "uniform", every token id drawn uniformly from the
  configuration's vocabulary (unpadded);
- ``warmup_proofs``: proofs made in set-up, from a stream of their own,
  so that the window's requests do not depend on how many there are.
"""

from __future__ import annotations

import numpy as np

from .inputs import seed64

KNOWN = {"loop": ("closed",), "clients": (1,),
         "transcript": ("blake2b", "keccak"), "pcs": ("hyperkzg", "dory"),
         "entry": ("prove", "prove_zk"), "tokens": ("uniform",)}


def check(params: dict) -> None:
    """Raise ValueError for a mix this generator cannot make."""
    for key, allowed in KNOWN.items():
        if params.get(key) not in allowed:
            raise ValueError(f"traffic {key}={params.get(key)!r}: this "
                             f"generator makes {allowed}")
    if int(params.get("warmup_proofs", 0)) < 1:
        raise ValueError("traffic warmup_proofs: at least 1, so that "
                         "nothing builds inside the window")


def verify_entry(params: dict) -> str:
    """The verifier's entry for the mix's prover entry."""
    return "verify" + params["entry"][len("prove"):]


class Requests:
    """The seed's requests: ``next()`` the window's, ``warmup()`` set-up's
    (each an int32 array of ``seq`` token ids below ``vocab``)."""

    def __init__(self, params: dict, vocab: int, seq: int, seed: int):
        check(params)
        self.vocab, self.seq = vocab, seq
        self._window = np.random.default_rng([seed64(seed), 0])
        self._warmup = np.random.default_rng([seed64(seed), 1])

    def _draw(self, rng) -> np.ndarray:
        return rng.integers(0, self.vocab, size=self.seq).astype(np.int32)

    def next(self) -> np.ndarray:
        return self._draw(self._window)

    def warmup(self) -> np.ndarray:
        return self._draw(self._warmup)
