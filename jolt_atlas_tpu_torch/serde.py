"""Canonical proof serialization.

Reference: jolt-atlas-core/src/onnx_proof/proof_serialization.rs — maps are
written as length-prefixed sorted (key, value) pairs with stable type tags,
scalars as 32-byte LE, points as 64-byte uncompressed affine.
"""

from __future__ import annotations

import struct

import numpy as np

from .curve.points import G1
from .field.scalar import Fr
from .ids import CommittedPoly, OpeningId, SumcheckId, VirtualPoly
from .commitment.hyperkzg import HyperKZGProof
from .proof import ONNXProof
from .subprotocols.eval_reduction import EvalReductionProof
from .subprotocols.sumcheck import SumcheckInstanceProof
from .poly.unipoly import UniPoly


class _W:
    def __init__(self):
        self.parts = []

    def u8(self, v):
        self.parts.append(bytes([v]))

    def u64(self, v):
        self.parts.append(int(v).to_bytes(8, "little"))

    def raw(self, b):
        self.parts.append(b)

    def fr(self, x: Fr):
        self.parts.append(x.to_bytes_le())

    def point(self, p: G1):
        self.parts.append(p.serialize())

    def string(self, s: str):
        b = s.encode()
        self.u64(len(b))
        self.raw(b)

    def payload(self, tup):
        self.u64(len(tup))
        for item in tup:
            if isinstance(item, str):
                self.u8(1)
                self.string(item)
            else:
                self.u8(0)
                self.u64(int(item))

    def out(self) -> bytes:
        return b"".join(self.parts)


class _R:
    def __init__(self, data: bytes):
        self.d = data
        self.o = 0

    def u8(self):
        v = self.d[self.o]
        self.o += 1
        return v

    def u64(self):
        v = int.from_bytes(self.d[self.o:self.o + 8], "little")
        self.o += 8
        return v

    def raw(self, n):
        v = self.d[self.o:self.o + n]
        self.o += n
        return v

    def fr(self) -> Fr:
        return Fr.from_bytes_le(self.raw(32))

    def point(self) -> G1:
        return G1.deserialize(self.raw(64))

    def string(self) -> str:
        return self.raw(self.u64()).decode()

    def payload(self) -> tuple:
        n = self.u64()
        out = []
        for _ in range(n):
            if self.u8() == 1:
                out.append(self.string())
            else:
                out.append(self.u64())
        return tuple(out)


def _write_tagged(w: _W, tid):
    w.u64(tid.tag_index)
    w.payload(tid.payload)


def _read_committed(r: _R) -> CommittedPoly:
    return CommittedPoly(r.u64(), r.payload())


def _read_sumcheck_id(r: _R) -> SumcheckId:
    return SumcheckId(r.u64(), r.payload())


def _write_opening_id(w: _W, oid: OpeningId):
    w.u8(1 if oid.is_virtual else 0)
    _write_tagged(w, oid.poly)
    _write_tagged(w, oid.sumcheck)


def _read_opening_id(r: _R) -> OpeningId:
    is_virtual = r.u8() == 1
    if is_virtual:
        poly = VirtualPoly(r.u64(), r.payload())
    else:
        poly = CommittedPoly(r.u64(), r.payload())
    return OpeningId(is_virtual, poly, _read_sumcheck_id(r))


def serialize_proof(proof: ONNXProof) -> bytes:
    from .commitment.dory import DoryCommitment
    w = _W()
    dory = any(isinstance(c, DoryCommitment)
               for c in proof.commitments.values())
    w.u8(1 if dory else 0)  # PCS tag: 0 = HyperKZG (G1), 1 = Dory (GT)
    w.u64(len(proof.commitments))
    for pid in sorted(proof.commitments):
        _write_tagged(w, pid)
        com = proof.commitments[pid]
        if dory:
            blob = com.serialize()
            w.u64(len(blob))
            w.raw(blob)
        else:
            w.point(com)
    from .subprotocols.eval_reduction import ZkEvalReductionProof
    from .subprotocols.zk_sumcheck import ZkSumcheckProof
    w.u64(len(proof.proofs))
    for key in sorted(proof.proofs, key=lambda k: (k[0], k[1])):
        w.u64(key[0])
        w.string(key[1])
        p = proof.proofs[key]
        w.u8(1 if isinstance(p, ZkSumcheckProof) else 0)
        w.raw(p.serialize())
    w.u64(len(proof.eval_reduction_proofs))
    for idx in sorted(proof.eval_reduction_proofs):
        w.u64(idx)
        erp = proof.eval_reduction_proofs[idx]
        if isinstance(erp, ZkEvalReductionProof):
            w.u8(1)
            w.raw(erp.serialize())
        else:
            w.u8(0)
            w.u64(len(erp.h.coeffs))
            for cf in erp.h.coeffs:
                w.fr(cf)
    w.u64(len(proof.opening_claims))
    for oid in sorted(proof.opening_claims):
        _write_opening_id(w, oid)
        w.fr(proof.opening_claims[oid])
    w.u64(len(proof.reduced_claims))
    for c in proof.reduced_claims:
        w.fr(c)
    if proof.batch_opening_proof is not None:
        from .subprotocols.zk_opening import ZkJointOpeningProof
        if isinstance(proof.joint_opening_proof, ZkJointOpeningProof):
            w.u8(3)  # zk hidden opening (zk sumcheck + masked HyperKZG)
        elif isinstance(proof.batch_opening_proof, ZkSumcheckProof):
            w.u8(2)
        else:
            w.u8(1)
        w.raw(proof.batch_opening_proof.serialize())
        w.raw(proof.joint_opening_proof.serialize())
    else:
        w.u8(0)
    w.u64(len(proof.aux))
    for key in sorted(proof.aux):
        w.u64(key[0])
        w.string(key[1])
        arr = np.asarray(proof.aux[key], dtype="<i4")
        w.u64(arr.size)
        w.raw(arr.tobytes())
    return w.out()


def deserialize_proof(data: bytes) -> ONNXProof:
    from .commitment.dory import DoryCommitment
    r = _R(data)
    dory = bool(r.u8())
    commitments = {}
    for _ in range(r.u64()):
        pid = _read_committed(r)
        if dory:
            commitments[pid] = DoryCommitment.deserialize(r.raw(r.u64()))
        else:
            commitments[pid] = r.point()
    from .subprotocols.eval_reduction import ZkEvalReductionProof
    from .subprotocols.zk_sumcheck import ZkSumcheckProof
    proofs = {}
    for _ in range(r.u64()):
        node = r.u64()
        kind = r.string()
        if r.u8():
            sp, r.o = ZkSumcheckProof.deserialize(r.d, r.o)
        else:
            sp, r.o = SumcheckInstanceProof.deserialize(r.d, r.o)
        proofs[(node, kind)] = sp
    eval_reductions = {}
    for _ in range(r.u64()):
        idx = r.u64()
        if r.u8():
            erp, r.o = ZkEvalReductionProof.deserialize(r.d, r.o)
            eval_reductions[idx] = erp
        else:
            n = r.u64()
            coeffs = [r.fr() for _ in range(n)]
            eval_reductions[idx] = EvalReductionProof(UniPoly(coeffs))
    opening_claims = {}
    for _ in range(r.u64()):
        oid = _read_opening_id(r)
        opening_claims[oid] = r.fr()
    reduced_claims = [r.fr() for _ in range(r.u64())]
    tag = r.u8()
    if tag in (2, 3):
        bo, r.o = ZkSumcheckProof.deserialize(r.d, r.o)
    elif tag == 1:
        bo, r.o = SumcheckInstanceProof.deserialize(r.d, r.o)
    else:
        bo, hk = None, None
    if tag == 3:
        from .subprotocols.zk_opening import ZkJointOpeningProof
        hk, r.o = ZkJointOpeningProof.deserialize(r.d, r.o)
    elif tag:
        if dory:
            from .commitment.dory import DoryProof
            hk, r.o = DoryProof.deserialize(r.d, r.o)
        else:
            hk, r.o = HyperKZGProof.deserialize(r.d, r.o)
    aux = {}
    for _ in range(r.u64()):
        node = r.u64()
        name = r.string()
        n = r.u64()
        aux[(node, name)] = np.frombuffer(r.raw(4 * n), dtype="<i4").copy()
    assert r.o == len(r.d), "trailing bytes in proof"
    return ONNXProof(
        commitments=commitments, proofs=proofs,
        eval_reduction_proofs=eval_reductions,
        opening_claims=opening_claims, reduced_claims=reduced_claims,
        batch_opening_proof=bo, joint_opening_proof=hk, aux=aux,
    )
