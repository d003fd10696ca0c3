"""The port's Dory PCS and Keccak transcript against the reference's.

tests/test_dory.py's cases run on the port (its 1 s wall-clock bound is
the reference's own test, not mirrored here), the port's commitments and
opening proofs equal the reference's bytes, and a model proved with
pcs="dory" gives the reference's proof bytes: on the host path, and with
the opening reduction and the IOP rows engine forced onto a CPU device
(their kernels' plain versions). A prove under KeccakTranscript gives the
reference's bytes, and the port verifies it.
"""

import numpy as np
import pytest
import torch

from examples.nanogpt_style import build_model as ref_build_nanogpt
from jolt_atlas_tpu import serde as ref_serde
from jolt_atlas_tpu.commitment.dory import DoryPC as RefDoryPC
from jolt_atlas_tpu.commitment.dory import DorySetup as RefDorySetup
from jolt_atlas_tpu.field.scalar import Fr as RefFr
from jolt_atlas_tpu.frontend import ModelBuilder as RefBuilder
from jolt_atlas_tpu.frontend.quantize import quantize_tensor
from jolt_atlas_tpu.preprocessing import AtlasPreprocessing as RefPP
from jolt_atlas_tpu.prover import AtlasProver as RefProver
from jolt_atlas_tpu.transcripts import Blake2bTranscript as RefBlake2b
from jolt_atlas_tpu.transcripts import KeccakTranscript as RefKeccak
from jolt_atlas_tpu.verifier import AtlasVerifier as RefVerifier
from jolt_atlas_tpu_torch import convert, serde
from jolt_atlas_tpu_torch.commitment.dory import (DoryPC, DoryProof,
                                                  DoryScheme, DorySetup)
from jolt_atlas_tpu_torch.device import reduction, rows, split, telemetry
from jolt_atlas_tpu_torch.field.scalar import Fr
from jolt_atlas_tpu_torch.poly.mlpoly import MLPoly
from jolt_atlas_tpu_torch.preprocessing import AtlasPreprocessing
from jolt_atlas_tpu_torch.prover import AtlasProver
from jolt_atlas_tpu_torch.transcripts import Blake2bTranscript
from jolt_atlas_tpu_torch.transcripts import KeccakTranscript
from jolt_atlas_tpu_torch.verifier import AtlasVerifier
from test_torch_srs import reference_native

# the suite runs in several worker processes at once: a small intra-op
# pool keeps this file from starving its neighbours' timed tests
torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def _host_engines():
    """The reference's csrc engine loaded in this worker before a fixture
    here builds a reference SRS (test_torch_srs.reference_native), and the
    csrc host engines' OpenMP threads capped at 2 while this file runs
    (the reference's wall-clock tests share the machine)."""
    reference_native()
    split.set_host_threads(2)
    yield
    split.set_host_threads(None)


@pytest.fixture(scope="module")
def setup():
    return DorySetup.for_num_vars(10, max_log_rows=3)


def _opening(setup, seed: int, lo: int, hi: int):
    """(coeffs, commitment, point, claim, proof) of a random 2^8 polynomial
    opened at a random point."""
    rng = np.random.default_rng(seed)
    coeffs = rng.integers(lo, hi, 1 << 8).astype(np.int64)
    com = DoryPC.commit(setup, coeffs)
    point = [Fr(int(x)) for x in rng.integers(0, 2**61, 8)]
    claim = MLPoly(ints=coeffs.copy()).evaluate(point)
    proof = DoryPC.open(setup, coeffs, point, Blake2bTranscript(b"dory"))
    return coeffs, com, point, claim, proof


def test_open_verify(setup):
    _, com, point, claim, proof = _opening(setup, 1, -2**31, 2**31)
    assert DoryPC.verify(setup, com, point, claim, proof,
                         Blake2bTranscript(b"dory"))


def test_wrong_claim_rejected(setup):
    _, com, point, claim, proof = _opening(setup, 2, -100, 100)
    assert not DoryPC.verify(setup, com, point, claim + Fr.one(), proof,
                             Blake2bTranscript(b"dory"))


def test_tampered_cross_term_rejected(setup):
    _, com, point, claim, proof = _opening(setup, 3, -100, 100)
    cl, cr, ul, ur = proof.pair_rounds[0]
    proof.pair_rounds[0] = (cl, cr, ul + ul, ur)
    assert not DoryPC.verify(setup, com, point, claim, proof,
                             Blake2bTranscript(b"dory"))


def test_homomorphic_combine_fixed_columns(setup):
    rng = np.random.default_rng(4)
    big = rng.integers(-500, 500, 1 << 9).astype(np.int64)
    small = rng.integers(-500, 500, 1 << 5).astype(np.int64)
    coms = [DoryPC.commit(setup, big), DoryPC.commit(setup, small)]
    joint = big * 3
    joint[:32] += small * 11
    combined = DoryScheme().combine_commitments(coms, [Fr(3), Fr(11)])
    assert combined.gt.c == DoryPC.commit(setup, joint).gt.c


def test_proof_serde(setup):
    _, com, point, claim, proof = _opening(setup, 5, -100, 100)
    blob = proof.serialize()
    back, off = DoryProof.deserialize(blob)
    assert off == len(blob)
    assert DoryPC.verify(setup, com, point, claim, back,
                         Blake2bTranscript(b"dory"))


def test_commit_and_open_equal_reference(setup):
    """The same polynomial and point: the port's commitment and opening
    proof are the reference's, byte for byte."""
    coeffs, com, point, _, proof = _opening(setup, 6, -2**31, 2**31)
    ref_setup = RefDorySetup.for_num_vars(10, max_log_rows=3)
    ref_com = RefDoryPC.commit(ref_setup, coeffs)
    assert com.serialize() == ref_com.serialize()
    ref_proof = RefDoryPC.open(ref_setup, coeffs, [RefFr(x.v) for x in point],
                               RefBlake2b(b"dory"))
    assert proof.serialize() == ref_proof.serialize()


# ---------------------------------------------------------------------------
# whole models: Dory, and the Keccak transcript with HyperKZG
# ---------------------------------------------------------------------------

def _e2e():
    """tests/test_dory.py:test_dory_e2e_model's graph: 16 -> relu(16)."""
    rng = np.random.default_rng(0xD0FF)
    b = RefBuilder(scale=8)
    x = b.input((1, 16))
    w1 = b.constant(quantize_tensor(rng.standard_normal((16, 16)), 8))
    b.output(b.relu(b.einsum("bi,ij->bj", [x, w1])))
    return b.build(), [quantize_tensor(rng.standard_normal((1, 16)), 8)]


def _bench_small():
    """bench.py's BENCH_SMALL workload (seed 1234)."""
    rng = np.random.default_rng(1234)
    model = ref_build_nanogpt(32, 8, 16, 1, 8, rng, heads=1)
    return model, [rng.integers(0, 32, size=8).astype(np.int32)]


def _port_model(ref_model):
    return convert.model_from_reference(convert.describe_model(ref_model))


@pytest.fixture(scope="module")
def dory_e2e():
    """The e2e model proved with pcs="dory" by the reference and by the
    port's host path: (reference bytes, port pp, port proof, io, inputs,
    reference pp)."""
    ref_model, inputs = _e2e()
    ref_pp = RefPP.preprocess(ref_model, pcs="dory")
    assert ref_pp.srs is None
    ref_proof, _ = RefProver(ref_pp).prove(inputs)
    pp = AtlasPreprocessing.preprocess(_port_model(ref_model), pcs="dory")
    assert pp.srs is None, "dory mode must not build a trusted SRS"
    proof, io = AtlasProver(pp, device="cpu").prove(inputs)
    return (ref_serde.serialize_proof(ref_proof), pp, proof, io, inputs,
            ref_pp)


def test_dory_e2e_bytes_equal_reference(dory_e2e):
    ref_bytes, _, proof, _, _, _ = dory_e2e
    blob = serde.serialize_proof(proof)
    assert blob == ref_bytes
    assert len(blob) == 25845
    assert serde.serialize_proof(serde.deserialize_proof(blob)) == blob


def test_dory_e2e_both_verifiers_accept(dory_e2e):
    ref_bytes, pp, proof, io, _, ref_pp = dory_e2e
    assert AtlasVerifier(pp).verify(
        serde.deserialize_proof(serde.serialize_proof(proof)), io)
    ref_io = tuple([np.asarray(t) for t in part] for part in io)
    assert RefVerifier(ref_pp).verify(ref_serde.deserialize_proof(
        serde.serialize_proof(proof)), ref_io)


def test_dory_e2e_tampered_commitment_rejected(dory_e2e):
    _, pp, proof, io, _, _ = dory_e2e
    bad = serde.deserialize_proof(serde.serialize_proof(proof))
    pid = next(iter(bad.commitments))
    bad.commitments[pid].gt = bad.commitments[pid].gt * \
        bad.commitments[pid].gt
    assert not AtlasVerifier(pp).verify(bad, io)


def test_dory_e2e_engines_keep_the_bytes(dory_e2e):
    """With the opening reduction and the IOP rows engine forced (their
    kernels' plain versions on a CPU device), a Dory prove engages both
    and keeps the reference's bytes. No MSM goes to an engine: Dory
    commits in the target group."""
    ref_bytes, pp, _, _, inputs, _ = dory_e2e
    telemetry.reset()
    proof, _ = AtlasProver(pp, device="cpu",
                           reduction_gate=reduction.forced(),
                           iop_gate=rows.forced(min_n=2)).prove(inputs)
    tele = telemetry.snapshot()
    assert tele["decisions"]["reduction"].startswith("ENGAGED")
    assert tele["decisions"]["iop"].startswith("ENGAGED")
    assert not any(k.startswith("msm") for k in tele["dispatches"])
    assert serde.serialize_proof(proof) == ref_bytes


@pytest.mark.parametrize("case", ["e2e", "bench_small"])
def test_keccak_bytes_equal_reference(case):
    """transcript_factory=KeccakTranscript with HyperKZG: the port's host
    path gives the reference's bytes (15,221 on the e2e model), the port's
    Keccak verifier accepts and its BLAKE2b verifier does not."""
    ref_model, inputs = {"e2e": _e2e, "bench_small": _bench_small}[case]()
    ref_pp = RefPP.preprocess(ref_model)
    ref_proof, _ = RefProver(ref_pp, transcript_factory=RefKeccak).prove(
        inputs)
    pp = AtlasPreprocessing.preprocess(_port_model(ref_model))
    proof, io = AtlasProver(pp, device="cpu",
                            transcript_factory=KeccakTranscript).prove(inputs)
    blob = serde.serialize_proof(proof)
    assert blob == ref_serde.serialize_proof(ref_proof)
    if case == "e2e":
        assert len(blob) == 15221
    assert AtlasVerifier(pp, KeccakTranscript).verify(
        serde.deserialize_proof(blob), io)
    assert not AtlasVerifier(pp).verify(serde.deserialize_proof(blob), io)
