"""Proof container for an ONNX-inference proof.

Reference: jolt-atlas-core/src/onnx_proof/mod.rs ONNXProof {opening_claims,
proofs, commitments, eval_reduction_proofs, reduced_opening_proof}.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .curve.points import G1
from .commitment.hyperkzg import HyperKZGProof
from .field.scalar import Fr
from .ids import CommittedPoly, OpeningId
from .subprotocols.sumcheck import SumcheckInstanceProof
from .subprotocols.eval_reduction import EvalReductionProof


@dataclass
class ONNXProof:
    commitments: dict            # CommittedPoly -> G1
    proofs: dict                 # (node_idx, kind) -> SumcheckInstanceProof
    eval_reduction_proofs: dict  # node_idx -> EvalReductionProof
    opening_claims: dict         # OpeningId -> Fr
    reduced_claims: list         # [Fr] per reduction instance (sorted order)
    batch_opening_proof: SumcheckInstanceProof
    joint_opening_proof: HyperKZGProof
    aux: dict = field(default_factory=dict)  # (node_idx, name) -> np arrays
                                 # (softmax per-slice advice, reference #218)

    def size_estimate(self) -> int:
        """Rough serialized size in bytes (exact for zk entries)."""
        n = 64 * len(self.commitments)
        for p in self.proofs.values():
            if hasattr(p, "compressed_polys"):
                n += sum(32 * (cp.degree()) + 8 for cp in p.compressed_polys)
            else:
                n += len(p.serialize())
        n += 32 * len(self.opening_claims) + 32 * len(self.reduced_claims)
        for e in self.eval_reduction_proofs.values():
            n += (32 * len(e.h.coeffs) if hasattr(e, "h")
                  else len(e.serialize()))
        if self.batch_opening_proof is not None:
            if hasattr(self.batch_opening_proof, "compressed_polys"):
                n += sum(32 * cp.degree() + 8
                         for cp in self.batch_opening_proof.compressed_polys)
            else:
                n += len(self.batch_opening_proof.serialize())
            if hasattr(self.joint_opening_proof, "com"):
                n += 64 * (len(self.joint_opening_proof.com)
                           + len(self.joint_opening_proof.w))
                n += 32 * sum(len(row) for row in self.joint_opening_proof.v)
            else:  # zk hidden opening / dory
                n += len(self.joint_opening_proof.serialize())
        return n
