"""The reference's judgement of a proof, made without the program.

The verifier is ``frozen/``, a copy of the port's verifier and of what its
path imports, taken when this benchmark was written and never updated
(its host C++ engines are built from ``frozen/csrc/`` into
``frozen/_build/``). It is no independent reference: a fault that the
program's prover and verifier share passes it. It gets a model that it
builds itself with the configuration's builder and the frozen
ModelBuilder from the benchmark's weights, a verifier key it works out
from the setup's public seed (HyperKZG) or the transparent setup (Dory),
and the tokens and logits of the configuration's plain forward, never
the program's: a proof passes only if it proves the reference's answer.
"""

from __future__ import annotations

import contextlib
import hashlib
import sys

import numpy as np

from . import traffic
from .frozen import serde as fserde
from .frozen import transcripts as ftranscripts
from .frozen.commitment.kzg import KZGSRS
from .frozen.curve.points import g1_generator, g2_generator
from .frozen.commitment.hyperkzg import HyperKZGProof
from .frozen.field.constants import FR_MODULUS
from .frozen.frontend.builder import ModelBuilder
from .frozen.poly import opening as fopening
from .frozen.preprocessing import AtlasPreprocessing
from .frozen.verifier import AtlasVerifier

SRS_SEED = b"jolt-atlas-tpu-srs"  # the public seed of the setup's tau


def verifier_key(g1_count: int = 3) -> KZGSRS:
    """The setup's verifier key: [tau^i] G1 for i < ``g1_count`` (3 for a
    plain proof; a zero-knowledge one also takes its Pedersen generators
    from the first 128) and [1, tau, tau^2, tau^3] G2, from tau =
    BLAKE2b-256(seed) mod r."""
    tau = int.from_bytes(hashlib.blake2b(SRS_SEED, digest_size=32).digest(),
                         "little") % FR_MODULUS
    g, h = g1_generator(), g2_generator()
    bh = h * tau
    g1 = [g]
    for _ in range(max(g1_count, 3) - 1):
        g1.append(g1[-1] * tau)
    return KZGSRS(g1, h, bh,
                  g2_powers=[bh * tau, bh * (tau * tau % FR_MODULUS)])


@contextlib.contextmanager
def _record_openings(out: list):
    """Record (committed poly, its tag, its number of variables) of every
    opening that the joint opening reduces, as the verifier reaches it."""
    cls = fopening.VerifierOpeningAccumulator
    real = cls.verify_batch_opening

    def wrapped(self, *args, **kwargs):
        out.extend((repr(p.poly_id), p.poly_id.tag, len(p.point))
                   for p in self.sorted_pending())
        return real(self, *args, **kwargs)

    cls.verify_batch_opening = wrapped
    try:
        yield
    finally:
        cls.verify_batch_opening = real


class Judge:
    """Verifies proofs of the model of ``cell`` with the benchmark's
    ``weights`` under the cell's mix, against the reference's io."""

    def __init__(self, cell, weights: dict):
        mix = cell.traffic
        self.model = cell.builder.build(ModelBuilder, cell.config, weights)
        factory = getattr(ftranscripts, f"{mix['transcript'].capitalize()}"
                          "Transcript")
        if mix["pcs"] == "dory":
            from .frozen.commitment.dory import DorySetup
            pp = AtlasPreprocessing(
                self.model, None, pcs="dory",
                pcs_setup=DorySetup.for_num_vars(
                    self.model.graph.max_num_vars()))
        else:
            pp = AtlasPreprocessing(self.model, verifier_key(
                128 if mix["entry"] == "prove_zk" else 3))
        self.verifier = AtlasVerifier(pp, factory)
        self._verify = getattr(self.verifier, traffic.verify_entry(mix))

    def verify(self, blob: bytes, tokens: np.ndarray,
               logits: np.ndarray) -> tuple[bool, dict | None]:
        """(whether the serialised proof ``blob`` proves ``logits`` for
        ``tokens``, the shapes a plain HyperKZG proof fixes: the openings
        that the reduction joins, the IOP's sumchecks' rounds and degree,
        the reduction's degree and the joint opening's variables; None for
        other proofs)."""
        try:
            proof = fserde.deserialize_proof(blob)
        except (ValueError, IndexError, KeyError, EOFError) as e:
            print(f"undecodable proof: {e!r}", file=sys.stderr)
            return False, None
        openings: list = []
        io = ([np.asarray(tokens, dtype=np.int32)],
              [np.asarray(logits, dtype=np.int32)])
        with _record_openings(openings):
            ok = self._verify(proof, io)
        hk = proof.joint_opening_proof
        if not isinstance(hk, HyperKZGProof) or not all(
                hasattr(p, "compressed_polys") for p in proof.proofs.values()):
            return ok, None
        return ok, {"openings": openings,
                    "sumchecks": [_shape(p) for p in proof.proofs.values()],
                    "reduction_degree": _shape(proof.batch_opening_proof)[1]
                    if proof.batch_opening_proof is not None else 0,
                    "joint_vars": len(hk.v[0])}


def _shape(p) -> tuple[int, int]:
    """(rounds, degree) of a sumcheck proof."""
    return (len(p.compressed_polys),
            max((c.degree() for c in p.compressed_polys), default=0))
