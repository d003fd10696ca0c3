"""The ONNX-inference verifier.

Mirrors reference jolt-atlas-core/src/onnx_proof/verifier.rs: replay the
transcript (inputs, commitments, output claim), walk nodes in reverse
topological order re-deriving every challenge, check Input/Constant claims
against public MLEs, then verify the batched opening reduction and the
single joint HyperKZG opening.
"""

from __future__ import annotations

import numpy as np

from .field.scalar import Fr
from .frontend import ops as FOPS
from .ids import OpeningId, SumcheckId, VirtualPoly
from .poly.mlpoly import MLPoly
from .poly.opening import VerifierOpeningAccumulator
from .preprocessing import AtlasPreprocessing
from .proof import ONNXProof
from .subprotocols.eval_reduction import verify_eval_reduction
from .subprotocols.sumcheck import SumcheckError, zk_mode
from .transcripts import Blake2bTranscript
from .commitment.hyperkzg import HyperKZG
from .curve.msm import msm
from .zkops import ops as ZOPS
from .zkops.ops import VerificationError, padded_flat


class VerifierContext:
    def __init__(self, model, transcript, accumulator, proofs, aux=None):
        self.model = model
        self.transcript = transcript
        self.accumulator = accumulator
        self.proofs = proofs
        self.reduced = {}
        self.aux = aux or {}

    def node(self, idx):
        return self.model.graph.nodes[idx]

    def padded_len(self, idx):
        return self.node(idx).padded_output_len()



def append_io_to_transcript(transcript, tensors):
    """Bind public tensors (LE i32 bytes, reference mod.rs:110-114)."""
    for t in tensors:
        transcript.append_bytes(np.asarray(t, dtype="<i4").tobytes())


def collect_node_claims(accumulator, node_idx):
    """All (id, point, claim) openings on NodeOutput(node_idx), sorted."""
    target = VirtualPoly.make("NodeOutput", node_idx)
    ids = accumulator.by_virtual.get(target)
    if not ids:
        return []
    out = []
    for oid in sorted(ids, key=OpeningId.sort_key):
        point, claim = accumulator.openings[oid]
        out.append((oid, point, claim))
    return out


class AtlasVerifier:
    def __init__(self, preprocessing: AtlasPreprocessing,
                 transcript_factory=Blake2bTranscript):
        self.pp = preprocessing
        self.transcript_factory = transcript_factory

    def verify(self, proof: ONNXProof, io) -> bool:
        try:
            self._verify_inner(proof, io)
            return True
        except (VerificationError, AssertionError, KeyError, ValueError,
                SumcheckError, ZeroDivisionError, AttributeError,
                TypeError, IndexError) as e:
            self.last_error = e
            return False

    def verify_zk(self, proof: ONNXProof, io) -> bool:
        """Verify a proof produced by AtlasProver.prove_zk."""
        with zk_mode(self.pp.pedersen_gens()):
            return self.verify(proof, io)

    def _verify_inner(self, proof: ONNXProof, io):
        model = self.pp.model
        padded_inputs, padded_outputs = io
        transcript = self.transcript_factory(b"ONNXProof")
        accumulator = VerifierOpeningAccumulator(proof.opening_claims)
        ctx = VerifierContext(model, transcript, accumulator, proof.proofs,
                              proof.aux)

        append_io_to_transcript(transcript, padded_inputs)

        for pid in sorted(proof.commitments):
            transcript.append_point(proof.commitments[pid])

        # output claims: recompute from the public outputs
        for k, out_idx in enumerate(model.graph.outputs):
            flat = padded_flat(np.asarray(padded_outputs[k]))
            nv = len(flat).bit_length() - 1
            r_tau = transcript.challenge_vector_optimized(nv)
            expected = MLPoly(ints=flat.astype(np.int64)).evaluate(r_tau)
            oid = OpeningId.virtual(
                VirtualPoly.make("NodeOutput", out_idx),
                SumcheckId.make("NodeExecution", out_idx + 1, k),
            )
            if proof.opening_claims[oid] != expected:
                raise VerificationError("output claim mismatch")
            accumulator.append_virtual(transcript, oid, r_tau)

        input_map = dict(zip(model.graph.inputs, padded_inputs))
        for node in reversed(model.graph.sorted_nodes()):
            claims = collect_node_claims(accumulator, node.idx)
            if isinstance(node.operator, (FOPS.Input, FOPS.Constant)):
                if isinstance(node.operator, FOPS.Input):
                    data = padded_flat(np.asarray(input_map[node.idx]))
                else:
                    data = padded_flat(node.operator.array)
                poly = MLPoly(ints=data.astype(np.int64))
                for _, point, claim in claims:
                    if poly.clone().evaluate(point) != claim:
                        raise VerificationError(
                            f"public poly claim mismatch at node {node.idx}")
                continue
            if not claims:
                continue
            if len(claims) == 1:
                ctx.reduced[node.idx] = (claims[0][1], claims[0][2])
            else:
                nv = ctx.padded_len(node.idx).bit_length() - 1
                gens = zk_mode.gens()
                if gens is not None:
                    from .subprotocols.eval_reduction import (
                        ZkEvalReductionProof, verify_eval_reduction_zk)
                    erp = proof.eval_reduction_proofs[node.idx]
                    if not isinstance(erp, ZkEvalReductionProof):
                        raise VerificationError(
                            "zk verify: expected zk eval reduction")
                    new_pt, new_claim = verify_eval_reduction_zk(
                        erp, [c[1] for c in claims],
                        [c[2] for c in claims], nv, transcript, gens)
                else:
                    new_pt, new_claim = verify_eval_reduction(
                        proof.eval_reduction_proofs[node.idx],
                        [c[1] for c in claims], [c[2] for c in claims], nv,
                        transcript)
                ctx.reduced[node.idx] = (new_pt, new_claim)
            ZOPS.verify_node(node, ctx)

        # --- batched opening reduction ---
        if not accumulator.reductions:
            if proof.batch_opening_proof is not None or proof.reduced_claims:
                raise VerificationError("unexpected batch opening proof")
            return
        from .subprotocols.zk_opening import ZkJointOpeningProof
        if isinstance(proof.joint_opening_proof, ZkJointOpeningProof):
            # zk pipeline: hidden group claims + masked joint opening
            gens = zk_mode.gens()
            if gens is None:
                raise VerificationError("zk opening outside zk mode")
            if proof.reduced_claims:
                raise VerificationError(
                    "zk proof carries cleartext reduced claims")
            accumulator.verify_batch_opening_zk(
                proof.batch_opening_proof, proof.joint_opening_proof,
                transcript, gens, self.pp.srs,
                lambda: [proof.commitments[p.poly_id]
                         for p in accumulator.sorted_pending()])
            return
        r_sumcheck, joint_claim, commit_coeffs = accumulator.verify_batch_opening(
            proof.batch_opening_proof, proof.reduced_claims, transcript)
        bases = [proof.commitments[p.poly_id]
                 for p in accumulator.sorted_pending()]
        if self.pp.pcs == "dory":
            from .commitment.dory import DoryPC, DoryScheme
            joint_c = DoryScheme().combine_commitments(bases, commit_coeffs)
            joint_c.num_vars = len(r_sumcheck)
            ok = DoryPC.verify(self.pp.pcs_setup, joint_c, list(r_sumcheck),
                               joint_claim, proof.joint_opening_proof,
                               transcript)
        else:
            joint_c = msm(bases, [c.v for c in commit_coeffs])
            ok = HyperKZG.verify(self.pp.srs, joint_c, list(r_sumcheck),
                                 joint_claim, proof.joint_opening_proof,
                                 transcript)
        if not ok:
            raise VerificationError("joint opening failed")
