"""The ONNX-inference prover.

Reference call stack (jolt-atlas-core/src/onnx_proof/prover.rs, SURVEY §3.1):
trace -> witness gen -> commit -> bind public inputs -> output claim ->
reverse-topological IOP (per-node eval reduction + operator sumchecks) ->
batched opening reduction -> gamma RLC -> single HyperKZG opening.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .field.scalar import Fr
from .frontend import ops as FOPS
from .frontend.graph import Model
from .ids import OpeningId, SumcheckId, VirtualPoly
from .poly.mlpoly import MLPoly
from .poly.opening import ProverOpeningAccumulator
from .preprocessing import AtlasPreprocessing
from .proof import ONNXProof
from .subprotocols.eval_reduction import prove_eval_reduction
from .subprotocols.sumcheck import zk_mode
from .transcripts import Blake2bTranscript
from .commitment.hyperkzg import HyperKZG
from .device import rows as drows
from .commitment.kzg import kzg_commit
from .curve.msm import msm
from .utils.profiling import span
from .zkops import ops as ZOPS
from .zkops.ops import padded_flat


def append_io_to_transcript(transcript, tensors):
    """Bind public tensors (LE i32 bytes, reference mod.rs:110-114)."""
    for t in tensors:
        transcript.append_bytes(np.asarray(t, dtype="<i4").tobytes())


class ProverContext:
    def __init__(self, model, trace, transcript, accumulator):
        self.model = model
        self.trace = trace
        self.transcript = transcript
        self.accumulator = accumulator
        self.proofs = {}
        self.eval_reduction_proofs = {}
        self.chunks = {}
        self.reduced = {}
        self.aux = {}

    def node(self, idx):
        return self.model.graph.nodes[idx]

    def padded_len(self, idx):
        return self.node(idx).padded_output_len()


def _fvec_to_ints(fvec) -> list[int]:
    """Field vector (FrArray or list[Fr]) -> canonical Python ints."""
    from .field.frvec import FrArray
    if isinstance(fvec, FrArray):
        limbs = fvec.canonical()
        out = []
        for row in limbs:
            out.append(int(row[0]) | (int(row[1]) << 64)
                       | (int(row[2]) << 128) | (int(row[3]) << 192))
        return out
    return [int(x.v) for x in fvec]


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


class AtlasProver:
    def __init__(self, preprocessing: AtlasPreprocessing,
                 transcript_factory=Blake2bTranscript, device="cuda",
                 msm_window: int = 0, msm_gate=None, reduction_gate=None,
                 iop_gate=None):
        # transcript_factory: Blake2bTranscript (default, matching the
        # reference) or transcripts.KeccakTranscript — must match verifier
        # device: the card by default, whose device MSM engine
        # (device/msm.py) the gate offers the dense witness commits and
        # the HyperKZG opening; "cpu" asks for the host path (the
        # reference's own). Without a card, the default raises: the
        # prover never falls back to the host by itself.
        # msm_gate: the MSM gate (device/gate.py) that routes each MSM to
        # the device, a host+device split or the host; None loads the
        # device's measured calibration here (measuring it at first use),
        # never inside prove(). A CPU device's gate keeps every MSM on the
        # host; a forced one runs the kernels' plain versions there.
        # msm_window: forced MSM window size c (0: chosen per MSM size)
        # reduction_gate: when the opening reduction's rounds run on the
        # device (device/reduction.py); None: on a CUDA device once its
        # rows total the size floor. reduction.forced(tail_rounds=t) runs
        # them on any device at any size (a CPU device: the plain
        # versions), the last t rounds on the host.
        # iop_gate: which of the IOP's dense Gruen sumchecks run their head
        # rounds on the device (device/rows.py); None: on a CUDA device,
        # rows of >= 2048 elements and a first round of >= 2^20 row values
        # (rows.work), 2 rounds.
        # rows.forced(head_rounds=, min_n=) runs them on any device (a CPU
        # device: the plain versions).
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("AtlasProver: no CUDA device; pass "
                               "device=\"cpu\" to prove on the host")
        self.pp = preprocessing
        self.transcript_factory = transcript_factory
        self.device = device
        self.msm_window = msm_window
        self.uses_msm_engine = (self.pp.srs is not None
                                and self.pp.pcs != "dory")
        if self.uses_msm_engine and msm_gate is None:
            from .device import gate as dgate
            msm_gate = dgate.for_device(device)
        self.msm_gate = msm_gate
        self.reduction_gate = reduction_gate
        self.iop_gate = iop_gate

    def _msm_engine(self):
        """(the device MSM engine or None, the gate that routes the MSMs)."""
        if not self.uses_msm_engine:
            return None, None
        return (self.pp.srs.device_bases(self.device, self.msm_gate,
                                         c=self.msm_window), self.msm_gate)

    def prove_zk(self, inputs: list[np.ndarray]):
        """Zero-knowledge prove: identical pipeline, but every sumcheck's
        round polynomials and every eval-reduction h polynomial are
        Pedersen-committed and proven by sigma protocols instead of sent
        in the clear (subprotocols/zk_sumcheck.py). Mirrors the role of
        the reference's prove_zk (jolt-atlas-core zk.rs:2081) with the
        documented sigma-protocol deviation (BASELINE.md #3).

        The reduced group claims and the joint evaluation are HIDDEN
        (Pedersen-committed; masked HyperKZG opening —
        subprotocols/zk_opening.py). What stays public, exactly as in
        the reference's zk pipeline: witness PCS commitments, per-node
        cached opening claims (aggregate scalars, zk.rs:96-105), and the
        softmax aux advice vectors (reference TODO #218)."""
        with zk_mode(self.pp.pedersen_gens()):
            return self.prove(inputs)

    def prove(self, inputs: list[np.ndarray]):
        """Returns (proof, io) where io = (padded inputs, padded outputs)."""
        model = self.pp.model
        trace = model.trace(inputs)
        transcript = self.transcript_factory(b"ONNXProof")
        accumulator = ProverOpeningAccumulator()
        ctx = ProverContext(model, trace, transcript, accumulator)

        padded_inputs = [trace.node_outputs[i] for i in model.graph.inputs]
        padded_outputs = [trace.node_outputs[i] for i in model.graph.outputs]
        append_io_to_transcript(transcript, padded_inputs)

        # --- witness generation + commitments (sorted CommittedPoly order) ---
        poly_map = {}
        with span("witness_generation"):
            # per-node witness builds are independent (pure reads of the
            # trace, fresh output dicts) and numpy/C-bound — thread them
            # across cores, merging results in topological order so the
            # poly/chunk maps stay deterministic. Plays the role of the
            # reference's rayon polynomial_map fan-out
            # (jolt-atlas-core/src/onnx_proof/prover.rs:207-233).
            nodes = model.graph.sorted_nodes()
            if len(nodes) >= 8:
                import os
                from concurrent.futures import ThreadPoolExecutor
                workers = min(4, os.cpu_count() or 1)
                with ThreadPoolExecutor(max_workers=workers) as ex:
                    results = list(ex.map(
                        lambda nd: ZOPS.node_witness(nd, model, trace),
                        nodes))
            else:
                results = [ZOPS.node_witness(nd, model, trace)
                           for nd in nodes]
            for polys, chunks in results:
                poly_map.update(polys)
                ctx.chunks.update(chunks)
        commitments = {}
        with span("commit"):
            dev, gate = self._msm_engine()
            pids = sorted(poly_map)
            if self.pp.pcs == "dory":
                from .commitment.dory import DoryPC
                for pid in pids:
                    commitments[pid] = DoryPC.commit(self.pp.pcs_setup,
                                                     poly_map[pid].to_ints())
                prep = None
            elif (prep := self.pp.srs.prepared_bases()) is not None and pids:
                oh_pids = [p for p in pids
                           if poly_map[p].onehot_indices is not None]
                dn_pids = [p for p in pids
                           if poly_map[p].onehot_indices is None]
                if oh_pids:  # sparse subset-sum commits for one-hot ra polys
                    pts = prep.msm_onehot_batch(
                        [poly_map[p].onehot_indices for p in oh_pids])
                    commitments.update(zip(oh_pids, pts))
                # vocab-scale dense witnesses (GPT-2 fullvocab LM head)
                # stream through the two-tier chunked committer so the
                # 32 B/coeff packed scalar buffer is never resident at
                # full length (reference StreamingCommitmentScheme,
                # commitment_scheme.rs:133)
                STREAM_MIN = 1 << 21
                big_pids = [p for p in dn_pids
                            if len(poly_map[p]) >= STREAM_MIN
                            and poly_map[p].ints is not None]
                dn_pids = [p for p in dn_pids if p not in set(big_pids)]
                for pid in big_pids:
                    from .commitment.scheme import StreamingCommitter
                    sc = StreamingCommitter(self.pp.srs)
                    ints = poly_map[pid].ints
                    for off in range(0, len(ints), STREAM_MIN):
                        sc.process(ints[off:off + STREAM_MIN])
                    commitments[pid] = sc.finalize()
                if dn_pids:
                    # dense witness commits, each by the gate's route: the
                    # device, a host+device split or the host batch-affine
                    # engine, which also takes any commit whose digit grid
                    # would be skewed (low-entropy windows); all counted in
                    # telemetry
                    from .curve.native import pack_scalars
                    from .device.split import msm_batch_routed
                    pts = msm_batch_routed(
                        dev, gate, prep,
                        [pack_scalars(poly_map[p].ints) for p in dn_pids],
                        [len(poly_map[p]) for p in dn_pids], "commit")
                    commitments.update(zip(dn_pids, pts))
            else:
                for pid in pids:
                    commitments[pid] = kzg_commit(self.pp.srs,
                                                  poly_map[pid].to_ints())
            for pid in pids:
                transcript.append_point(commitments[pid])

        # --- output claims ---
        for k, out_idx in enumerate(model.graph.outputs):
            flat = padded_flat(trace.node_outputs[out_idx])
            nv = len(flat).bit_length() - 1
            r_tau = transcript.challenge_vector_optimized(nv)
            claim = MLPoly(ints=flat.astype(np.int64)).evaluate(r_tau)
            oid = OpeningId.virtual(
                VirtualPoly.make("NodeOutput", out_idx),
                SumcheckId.make("NodeExecution", out_idx + 1, k),
            )
            accumulator.append_virtual(transcript, oid, r_tau, claim)

        # --- reverse-topological IOP ---
        # the rows engine's scope (device/rows.py; the reference's
        # single-chip mesh scope), or None for the host path: the IOP's
        # dense Gruen instances run their head rounds on the device. It
        # steps aside while a mesh scope is active: the mesh engine
        # (parallel/shardedrows.py) takes them.
        from .parallel import shardedreduction
        if shardedreduction.active_mesh() is not None:
            from .device import telemetry
            telemetry.decide("iop", "mesh scope active")
            scope = None
        else:
            scope = drows.iop_scope(self.device, self.iop_gate)
        with span("iop"), scope or contextlib.nullcontext():
            for node in reversed(model.graph.sorted_nodes()):
                claims = collect_node_claims(accumulator, node.idx)
                if isinstance(node.operator, (FOPS.Input, FOPS.Constant)):
                    # claims on public polys are checked by the verifier
                    continue
                if not claims:
                    continue  # dead node
                if len(claims) == 1:
                    ctx.reduced[node.idx] = (claims[0][1], claims[0][2])
                else:
                    flat = padded_flat(trace.node_outputs[node.idx])
                    poly = MLPoly(ints=flat.astype(np.int64))
                    gens = zk_mode.gens()
                    if gens is not None:
                        from .subprotocols.eval_reduction import \
                            prove_eval_reduction_zk
                        proof, new_pt, new_claim = prove_eval_reduction_zk(
                            poly, [c[1] for c in claims],
                            [c[2] for c in claims], transcript, gens)
                    else:
                        proof, new_pt, new_claim = prove_eval_reduction(
                            poly, [c[1] for c in claims],
                            [c[2] for c in claims], transcript)
                    ctx.eval_reduction_proofs[node.idx] = proof
                    ctx.reduced[node.idx] = (new_pt, new_claim)
                with span(f"node[{node.idx}] "
                          f"{type(node.operator).__name__}"):
                    ZOPS.prove_node(node, ctx)

        # --- batched opening reduction + joint HyperKZG opening ---
        if accumulator.reductions:
            gens = zk_mode.gens()
            if gens is not None and self.pp.pcs != "dory":
                # zk pipeline: group claims stay Pedersen-committed and the
                # joint polynomial opens through the masked HyperKZG
                # protocol — no reduced claim is ever serialized in the
                # clear (subprotocols/zk_opening.py); its public opening
                # takes the MSM engine and gate as the plain path's does
                with span("batch_opening_reduction"):
                    bo_proof, hk_proof = \
                        accumulator.prove_batch_opening_zk(
                            poly_map, transcript, gens, self.pp.srs, dev,
                            gate)
                reduced_claims = []
            else:
                with span("batch_opening_reduction"):
                    (bo_proof, r_sumcheck, reduced_claims, joint) = \
                        accumulator.prove_batch_opening(
                            poly_map, transcript, self.device,
                            self.reduction_gate)
                with span("hyperkzg_open"):
                    if self.pp.pcs == "dory":
                        from .commitment.dory import DoryPC
                        ints = _fvec_to_ints(joint)
                        hk_proof = DoryPC.open(self.pp.pcs_setup, ints,
                                               list(r_sumcheck), transcript)
                    else:
                        hk_proof = HyperKZG.open(self.pp.srs, joint,
                                                 list(r_sumcheck),
                                                 transcript, dev=dev,
                                                 gate=gate)
        else:  # no committed polynomials (pure claim-plumbing graph)
            bo_proof, reduced_claims, hk_proof = None, [], None

        proof = ONNXProof(
            commitments=commitments,
            proofs=ctx.proofs,
            eval_reduction_proofs=ctx.eval_reduction_proofs,
            opening_claims=accumulator.take_claims(),
            reduced_claims=reduced_claims,
            batch_opening_proof=bo_proof,
            joint_opening_proof=hk_proof,
            aux=ctx.aux,
        )
        io = (padded_inputs, padded_outputs)
        return proof, io
