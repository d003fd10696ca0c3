"""The port's zero-knowledge pipeline (AtlasProver.prove_zk,
AtlasVerifier.verify_zk) against the reference's.

Both packages draw their blinding from ``secrets.randbelow``
(subprotocols/zk_sumcheck.py, subprotocols/zk_opening.py,
commitment/pedersen.py). Here it is replaced, for each prove, by one
seeded stream, so the same statement gives the same zk proof in both: the
port's bytes must equal the reference's, and each verifier accepts the
other's proof. tests/test_zk_pipeline.py's tamper cases run on the port,
and without the seeded stream two zk proofs still differ. With a device
MSM engine (its plain versions on the CPU), the masked opening's public
HyperKZG opening goes through the engine, as the plain path's does.
"""

import copy

import numpy as np
import pytest
import torch

from jolt_atlas_tpu import serde as ref_serde
from jolt_atlas_tpu.frontend import ModelBuilder as RefBuilder
from jolt_atlas_tpu.frontend.quantize import quantize_tensor
from jolt_atlas_tpu.preprocessing import AtlasPreprocessing as RefPP
from jolt_atlas_tpu.prover import AtlasProver as RefProver
from jolt_atlas_tpu.verifier import AtlasVerifier as RefVerifier
from jolt_atlas_tpu_torch import serde
from jolt_atlas_tpu_torch.curve.points import g1_generator
from jolt_atlas_tpu_torch.device import gate, split, telemetry
from jolt_atlas_tpu_torch.examples.nanogpt_style import seeded_blinding
from jolt_atlas_tpu_torch.field.scalar import Fr
from jolt_atlas_tpu_torch.prover import AtlasProver
from jolt_atlas_tpu_torch.subprotocols.zk_opening import ZkJointOpeningProof
from jolt_atlas_tpu_torch.subprotocols.zk_sumcheck import ZkSumcheckProof
from jolt_atlas_tpu_torch.verifier import AtlasVerifier
from test_torch_srs import port_pp, reference_native

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


def _relu_mlp():
    """tests/test_zk_pipeline.py:_relu_mlp: h feeds two einsums, so a
    multi-claim node runs the zk eval reduction."""
    rng = np.random.default_rng(0x2B5)
    b = RefBuilder(scale=8)
    x = b.input((1, 16))
    w1 = b.constant(quantize_tensor(rng.standard_normal((16, 16)), 8))
    w2 = b.constant(quantize_tensor(rng.standard_normal((16, 16)), 8))
    w3 = b.constant(quantize_tensor(rng.standard_normal((16, 16)), 8))
    h = b.relu(b.einsum("bi,ij->bj", [x, w1]))
    b.output(b.add(b.einsum("bi,ij->bj", [h, w2]),
                   b.einsum("bi,ij->bj", [h, w3])))
    return b.build(), [quantize_tensor(rng.standard_normal((1, 16)), 8)]


def _softmax():
    """tests/test_zk_pipeline.py:test_zk_softmax_model's graph: the staged
    batched sumchecks and the aux advice."""
    rng = np.random.default_rng(0x2B6)
    b = RefBuilder(scale=8)
    b.output(b.softmax_last_axis(b.input((4, 8))))
    return b.build(), [quantize_tensor(rng.standard_normal((4, 8)), 8)]


MODELS = {"relu_mlp": _relu_mlp, "softmax": _softmax}


@pytest.fixture(scope="module")
def zk_cases():
    """Per model: the reference's and the port's (host path) zk proofs
    under the same seeded blinding stream."""
    out = {}
    for name, make in MODELS.items():
        ref_model, inputs = make()
        ref_pp = RefPP.preprocess(ref_model)
        with seeded_blinding():
            ref_proof, _ = RefProver(ref_pp).prove_zk(inputs)
        pp = port_pp(ref_model, ref_pp)
        with seeded_blinding():
            proof, io = AtlasProver(pp, device="cpu").prove_zk(inputs)
        out[name] = {"ref_pp": ref_pp, "ref_bytes":
                     ref_serde.serialize_proof(ref_proof), "pp": pp,
                     "proof": proof, "io": io, "inputs": inputs}
    return out


@pytest.fixture(scope="module")
def zk_setup(zk_cases):
    """The relu MLP's port case as (pp, proof, io, input), the shape of
    tests/test_zk_pipeline.py's fixture."""
    c = zk_cases["relu_mlp"]
    return c["pp"], c["proof"], c["io"], c["inputs"][0]


def _tampered(proof):
    """A deep copy of a proof by serde, to tamper with."""
    return serde.deserialize_proof(serde.serialize_proof(proof))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_zk_bytes_equal_reference(zk_cases, name):
    c = zk_cases[name]
    assert serde.serialize_proof(c["proof"]) == c["ref_bytes"]


@pytest.mark.parametrize("name", sorted(MODELS))
def test_verifiers_accept_each_others_proofs(zk_cases, name):
    c = zk_cases[name]
    ref_io = tuple([np.asarray(t) for t in part] for part in c["io"])
    port_blob = serde.serialize_proof(c["proof"])
    assert AtlasVerifier(c["pp"]).verify_zk(c["proof"], c["io"])
    assert RefVerifier(c["ref_pp"]).verify_zk(
        ref_serde.deserialize_proof(port_blob), ref_io)
    assert AtlasVerifier(c["pp"]).verify_zk(
        serde.deserialize_proof(c["ref_bytes"]), c["io"])


def test_zk_opening_takes_the_msm_engine(zk_cases):
    """With a device MSM engine (forced, its plain versions on the CPU),
    the masked opening's public HyperKZG opening of K = J + rho M is
    dispatched to the engine, as the plain path's opening is, the
    reduction stays on the host ("zk"), and the bytes stay the
    reference's."""
    c = zk_cases["relu_mlp"]
    telemetry.reset()
    with seeded_blinding():
        proof, _ = AtlasProver(c["pp"], device="cpu", msm_window=6,
                               msm_gate=gate.forced("device")).prove_zk(
                                   c["inputs"])
    tele = telemetry.snapshot()
    assert tele["dispatches"].get("msm:hyperkzg_fold", 0) > 0
    assert tele["dispatches"].get("msm:hyperkzg_witness", 0) > 0
    assert tele["decisions"]["reduction"] == "zk"
    assert tele["launches"] == {}  # CPU tensors: plain versions only
    assert serde.serialize_proof(proof) == c["ref_bytes"]


# ---------------------------------------------------------------------------
# tests/test_zk_pipeline.py's cases, on the port
# ---------------------------------------------------------------------------

def test_round_polys_hidden(zk_setup):
    """Every per-node sumcheck proof is the committed form."""
    _, proof, _, _ = zk_setup
    assert proof.proofs, "no sumcheck proofs produced"
    for key, p in proof.proofs.items():
        assert isinstance(p, ZkSumcheckProof), key
    assert isinstance(proof.batch_opening_proof, ZkSumcheckProof)
    for erp in proof.eval_reduction_proofs.values():
        assert not hasattr(erp, "h"), "cleartext h poly in zk proof"


def test_serde_round_trip(zk_setup):
    pp, proof, io, _ = zk_setup
    blob = serde.serialize_proof(proof)
    back = serde.deserialize_proof(blob)
    assert serde.serialize_proof(back) == blob
    assert AtlasVerifier(pp).verify_zk(back, io)


def test_plain_verifier_rejects_zk_proof(zk_setup):
    pp, proof, io, _ = zk_setup
    assert not AtlasVerifier(pp).verify(proof, io)


def test_zk_verifier_rejects_plain_proof(zk_setup):
    pp, _, _, xq = zk_setup
    plain, io = AtlasProver(pp, device="cpu").prove([xq])
    assert not AtlasVerifier(pp).verify_zk(plain, io)


def test_tampered_round_commitment_rejected(zk_setup):
    pp, proof, io, _ = zk_setup
    tampered = _tampered(proof)
    zp = tampered.proofs[next(iter(tampered.proofs))]
    zp.round_commitments[0] = zp.round_commitments[0] + \
        zp.round_commitments[0]
    assert not AtlasVerifier(pp).verify_zk(tampered, io)


def test_tampered_sigma_response_rejected(zk_setup):
    pp, proof, io, _ = zk_setup
    tampered = _tampered(proof)
    zp = tampered.proofs[next(iter(tampered.proofs))]
    zp.responses[0][0] = zp.responses[0][0] + Fr.one()
    assert not AtlasVerifier(pp).verify_zk(tampered, io)


def test_tampered_opening_claim_rejected(zk_setup):
    pp, proof, io, _ = zk_setup
    tampered = _tampered(proof)
    oid = next(iter(tampered.opening_claims))
    tampered.opening_claims[oid] = tampered.opening_claims[oid] + Fr.one()
    assert not AtlasVerifier(pp).verify_zk(tampered, io)


def test_tampered_eval_reduction_rejected(zk_setup):
    pp, proof, io, _ = zk_setup
    assert proof.eval_reduction_proofs, "the relu MLP has a multi-claim node"
    tampered = _tampered(proof)
    erp = tampered.eval_reduction_proofs[next(iter(
        tampered.eval_reduction_proofs))]
    erp.new_claim = erp.new_claim + Fr.one()
    assert not AtlasVerifier(pp).verify_zk(tampered, io)


def test_no_cleartext_reduced_claims(zk_setup):
    pp, proof, _, xq = zk_setup
    assert proof.reduced_claims == []
    assert isinstance(proof.joint_opening_proof, ZkJointOpeningProof)
    # the claims a plain prove of the same input produces appear nowhere
    # in the zk proof's bytes
    plain, _ = AtlasProver(pp, device="cpu").prove([xq])
    assert plain.reduced_claims, "plain prove produced no group claims"
    blob = serde.serialize_proof(proof)
    for c in plain.reduced_claims:
        assert c.to_bytes_le() not in blob
        assert c.to_bytes_be() not in blob


def _with_opening(proof, **fields):
    """A shallow copy of the proof whose joint opening has ``fields``."""
    tampered = copy.copy(proof)
    zo = copy.copy(proof.joint_opening_proof)
    for k, v in fields.items():
        setattr(zo, k, v)
    tampered.joint_opening_proof = zo
    return tampered


def test_mask_tamper_rejected(zk_setup):
    pp, proof, io, _ = zk_setup
    zo = proof.joint_opening_proof
    bad = _with_opening(proof, c_mask=zo.c_mask + g1_generator())
    assert not AtlasVerifier(pp).verify_zk(bad, io)


@pytest.mark.parametrize("field", ["e_m", "d", "w_m", "a_d", "e_g"])
def test_hidden_claim_commitment_tamper_rejected(zk_setup, field):
    pp, proof, io, _ = zk_setup
    zo = proof.joint_opening_proof
    if field == "e_g":  # a group claim's commitment
        bad = _with_opening(proof, e_g=[zo.e_g[0] + g1_generator()]
                            + zo.e_g[1:])
    else:
        bad = _with_opening(proof, **{field: getattr(zo, field)
                                      + g1_generator()})
    assert not AtlasVerifier(pp).verify_zk(bad, io)


def test_masked_eval_tamper_rejected(zk_setup):
    pp, proof, io, _ = zk_setup
    zo = proof.joint_opening_proof
    assert not AtlasVerifier(pp).verify_zk(
        _with_opening(proof, y_k=zo.y_k + Fr.one()), io)
    z = [list(zv) for zv in zo.z]
    z[0][0] = z[0][0] + Fr.one()
    assert not AtlasVerifier(pp).verify_zk(_with_opening(proof, z=z), io)


def test_zk_proof_differs_per_run(zk_setup):
    """Without the seeded stream, the blinding makes two zk proofs of the
    same statement differ (the plain pipeline is deterministic)."""
    pp, proof, _, xq = zk_setup
    first, _ = AtlasProver(pp, device="cpu").prove_zk([xq])
    second, _ = AtlasProver(pp, device="cpu").prove_zk([xq])
    assert serde.serialize_proof(first) != serde.serialize_proof(second)
