"""The port as a whole (jolt_atlas_tpu_torch) against the reference
(jolt_atlas_tpu): same model, same inputs, same SRS, same transcript.

The bar is exact: the port's serialized proof must equal the reference's
byte for byte, with the port's device MSM engine engaged on the CPU (its
kernels then run as their plain PyTorch versions). Both verifiers accept,
and the port's verifier rejects a tampered proof. A subprocess shows that a
port prove loads neither jax nor jolt_atlas_tpu, and that chip_smoke.py
refuses to run without a GPU.
"""

import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from examples.nanogpt_style import build_model as ref_build_nanogpt
from jolt_atlas_tpu import serde as ref_serde
from jolt_atlas_tpu.frontend import ModelBuilder as RefBuilder
from jolt_atlas_tpu.frontend.quantize import quantize_tensor
from jolt_atlas_tpu.preprocessing import AtlasPreprocessing as RefPP
from jolt_atlas_tpu.prover import AtlasProver as RefProver
from jolt_atlas_tpu.verifier import AtlasVerifier as RefVerifier
from jolt_atlas_tpu_torch import convert, models, serde
from jolt_atlas_tpu_torch.curve.points import g1_generator
from jolt_atlas_tpu_torch.device import gate, split, telemetry
from jolt_atlas_tpu_torch.prover import AtlasProver
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

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _both(ref_model, inputs, msm_window):
    """Reference host prove and port prove with the device engine on the
    CPU; returns (ref_pp, ref bytes, port pp, port proof, io)."""
    ref_pp = RefPP.preprocess(ref_model)
    ref_proof, _ = RefProver(ref_pp).prove(inputs)
    pp = port_pp(ref_model, ref_pp)
    telemetry.reset()
    proof, io = AtlasProver(pp, device=torch.device("cpu"),
                            msm_window=msm_window,
                            msm_gate=gate.forced("device")).prove(inputs)
    return ref_pp, ref_serde.serialize_proof(ref_proof), pp, proof, io


@pytest.fixture(scope="module")
def bench_small():
    """bench.py's BENCH_SMALL workload: vocab 32, seq 8, d16, 1 block,
    1 head, weights and tokens from default_rng(1234)."""
    rng = np.random.default_rng(1234)
    model = ref_build_nanogpt(32, 8, 16, 1, 8, rng, heads=1)
    toks = rng.integers(0, 32, size=8).astype(np.int32)
    out = _both(model, [toks], msm_window=6)
    return (model,) + out + (telemetry.snapshot(),)


@pytest.fixture(scope="module")
def perceptron():
    """tests/test_e2e.py::test_perceptron's model: input -> matmul -> bias
    -> relu -> matmul."""
    rng = np.random.default_rng(7)
    s = 8
    b = RefBuilder(scale=s)
    x = b.input([1, 8])
    h = b.matmul(x, b.constant(quantize_tensor(rng.normal(size=(8, 4)) * .5,
                                               s)))
    hb = b.add(h, b.constant(quantize_tensor(rng.normal(size=(1, 4)) * .1,
                                             s)))
    w2 = b.constant(quantize_tensor(rng.normal(size=(4, 2)) * 0.5, s))
    b.output(b.matmul(b.relu(hb), w2))
    model = b.build()
    xs = quantize_tensor(rng.normal(size=(1, 8)), s)
    return (model,) + _both(model, [xs], msm_window=4)


@pytest.mark.parametrize("case", ["bench_small", "perceptron"])
def test_proof_bytes_equal_reference(case, request):
    _, _, ref_bytes, _, proof, _ = request.getfixturevalue(case)[:6]
    assert serde.serialize_proof(proof) == ref_bytes


@pytest.mark.parametrize("case", ["bench_small", "perceptron"])
def test_both_verifiers_accept(case, request):
    _, ref_pp, ref_bytes, pp, proof, io = request.getfixturevalue(case)[:6]
    assert AtlasVerifier(pp).verify(proof, io)
    ref_io = tuple([np.asarray(t) for t in part] for part in io)
    assert RefVerifier(ref_pp).verify(ref_serde.deserialize_proof(ref_bytes),
                                      ref_io)


@pytest.mark.parametrize("case", ["bench_small", "perceptron"])
def test_port_verifier_rejects_tampering(case, request):
    _, _, _, pp, proof, io = request.getfixturevalue(case)[:6]
    blob = serde.serialize_proof(proof)
    bad = serde.deserialize_proof(blob)
    pid = sorted(bad.commitments)[0]
    bad.commitments[pid] = bad.commitments[pid] + g1_generator()
    assert not AtlasVerifier(pp).verify(bad, io)
    flipped = bytearray(blob)
    flipped[len(blob) // 2] ^= 1
    try:
        ok = AtlasVerifier(pp).verify(serde.deserialize_proof(bytes(flipped)),
                                      io)
    except ValueError:
        ok = False  # the flipped byte no longer parses
    assert not ok


def test_engine_carried_the_opening(bench_small):
    tele = bench_small[-1]
    d = tele["dispatches"]
    assert d.get("msm:hyperkzg_fold", 0) > 0
    assert d.get("msm:hyperkzg_witness", 0) > 0
    assert d.get("msm:commit", 0) > 0  # no commit is skewed at c = 6
    assert tele["decisions"]["msm"].startswith("ENGAGED")
    assert tele["decisions"]["iop"] == "host path (device=cpu)"
    assert tele["launches"] == {}  # CPU tensors: plain versions only


def test_prover_defaults_to_the_card(bench_small):
    """Without a device argument the prover asks for the card: here, with
    none, construction raises instead of proving on the host."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device exists")
    pp = bench_small[3]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AtlasProver(pp)


def test_cpu_device_proves_on_the_host(bench_small):
    """device="cpu" asks for the host path: the gate of a CPU device has no
    measured rates, the MSM engine declines, and the bytes equal the
    reference's."""
    _, _, ref_bytes, pp = bench_small[:4]
    rng = np.random.default_rng(1234)
    ref_build_nanogpt(32, 8, 16, 1, 8, rng, heads=1)  # the fixture's draws
    toks = rng.integers(0, 32, size=8).astype(np.int32)
    telemetry.reset()
    proof, _ = AtlasProver(pp, device="cpu").prove([toks])
    tele = telemetry.snapshot()
    assert tele["decisions"]["msm"].startswith("declined on cpu")
    assert not any(k.startswith("msm:") for k in tele["dispatches"])
    assert tele["launches"] == {}
    assert serde.serialize_proof(proof) == ref_bytes


def test_build_nanogpt_matches_reference_graph():
    rng = np.random.default_rng(1234)
    want = convert.describe_model(ref_build_nanogpt(32, 8, 16, 1, 8, rng))
    got = convert.describe_model(
        models.build_nanogpt(32, 8, 16, 1, 8, np.random.default_rng(1234)))
    assert len(got["nodes"]) == len(want["nodes"])
    for g, w in zip(got["nodes"], want["nodes"]):
        assert g.keys() == w.keys() and g["op"] == w["op"]
        assert g["inputs"] == w["inputs"]
        assert g["output_dims"] == w["output_dims"]
        if "array" in g:
            assert np.array_equal(g["array"], w["array"])
        else:
            assert g["params"] == w["params"]


def test_port_prove_imports_no_jax():
    code = textwrap.dedent("""
        import sys
        import numpy as np
        import torch
        from jolt_atlas_tpu_torch.frontend import ModelBuilder
        from jolt_atlas_tpu_torch.preprocessing import AtlasPreprocessing
        from jolt_atlas_tpu_torch.prover import AtlasProver
        from jolt_atlas_tpu_torch.verifier import AtlasVerifier
        from jolt_atlas_tpu_torch.device.gate import forced
        b = ModelBuilder()
        x = b.input([8])
        b.output(b.relu(b.add(x, b.constant(np.arange(8, dtype=np.int32)))))
        pp = AtlasPreprocessing.preprocess(b.build())
        xs = np.array([3, -4, 5, -6, 7, -8, 9, -10], dtype=np.int32)
        proof, io = AtlasProver(pp, device=torch.device("cpu"),
                                msm_window=4,
                                msm_gate=forced("device")).prove([xs])
        assert AtlasVerifier(pp).verify(proof, io)
        bad = [m for m in sys.modules
               if m == "jax" or m.startswith("jax.")
               or m == "jolt_atlas_tpu" or m.startswith("jolt_atlas_tpu.")]
        assert not bad, bad
        print("ok")
    """)
    # as few threads as this file's own process takes
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       env=dict(os.environ, OMP_NUM_THREADS="2"),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "ok"


def test_chip_smoke_refuses_without_gpu(tmp_path):
    """Here (no CUDA device), and alone in a directory, chip_smoke.py exits
    non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py would run")
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    for cwd in (REPO, str(tmp_path)):
        r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                           capture_output=True, text=True, timeout=300)
        assert r.returncode != 0
        assert r.stdout == ""
