"""The port's benchmark entry (jolt_atlas_tpu_torch/bench.py) on the CPU.

At BENCH_SMALL's shape only (the full shape is the card's): the entry
prints one JSON line with bench.py's keys, in a process where importing
jax or jolt_atlas_tpu fails; its proof is the reference's, byte for byte,
for the same model and tokens proved here through jolt_atlas_tpu; with no
card and no ``--device cpu`` it raises before it proves; and its MSM rate
runs on the host engine.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from examples.nanogpt_style import build_model as ref_build_nanogpt
from jolt_atlas_tpu import serde as ref_serde
from jolt_atlas_tpu.preprocessing import AtlasPreprocessing as RefPP
from jolt_atlas_tpu.prover import AtlasProver as RefProver
from jolt_atlas_tpu_torch import bench, serde
from jolt_atlas_tpu_torch.commitment.kzg import KZGSRS
from jolt_atlas_tpu_torch.device import split
from test_torch_srs import reference_native

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = {"metric", "value", "unit", "vs_baseline", "setup_s", "bases_s",
        "verify_s", "proof_bytes", "phases", "device", "card"}


@pytest.fixture(scope="module", autouse=True)
def _host_engines():
    """The reference's csrc engine loaded in this worker before a test
    here builds a reference SRS (test_torch_srs.reference_native), and the
    csrc host engines' OpenMP threads capped at 2 while this file runs
    (the reference's wall-clock tests share the machine)."""
    reference_native()
    split.set_host_threads(2)
    yield
    split.set_host_threads(None)


def test_bench_small_prints_one_json_line_without_jax():
    """BENCH_SMALL=1 ... --device cpu, with jax and jolt_atlas_tpu
    blocked: one line on stdout, a JSON object with bench.py's keys (no
    MSM rate at this shape), the proof verified on the host path."""
    code = textwrap.dedent("""
        import runpy, sys

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "jolt_atlas_tpu"):
                    raise ImportError(f"blocked: {name}")
                return None

        sys.meta_path.insert(0, Block())
        sys.argv = ["bench", "--device", "cpu"]
        try:
            runpy.run_module("jolt_atlas_tpu_torch.bench",
                             run_name="__main__")
        except SystemExit as e:
            assert e.code == 0, e.code
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "jolt_atlas_tpu")]
        assert not bad, bad
    """)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       env=dict(os.environ, BENCH_SMALL="1",
                                OMP_NUM_THREADS="2"),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    lines = r.stdout.splitlines()
    assert len(lines) == 1, r.stdout
    out = json.loads(lines[0])
    assert set(out) == KEYS
    assert out["metric"] == "nanogpt_smoke_prove_wall_s"
    assert out["unit"] == "s" and out["value"] > 0
    assert out["vs_baseline"] == pytest.approx(2.288 / out["value"])
    assert out["card"] is None
    assert {"commit", "iop", "hyperkzg_open"} <= set(out["phases"])
    assert out["device"]["decisions"]["iop"] == "host path (device=cpu)"
    assert out["device"]["launches"] == {}


def test_bench_small_proof_equals_reference(monkeypatch):
    """The entry's proof at BENCH_SMALL, kept as it is serialised, equals
    the reference's proof of bench.py's BENCH_SMALL model and tokens
    (default_rng(1234)), and proof_bytes is its length."""
    rng = np.random.default_rng(1234)
    model = ref_build_nanogpt(32, 8, 16, 1, 8, rng, heads=1)
    toks = rng.integers(0, 32, size=8).astype(np.int32)
    want = ref_serde.serialize_proof(
        RefProver(RefPP.preprocess(model)).prove([toks])[0])
    kept = []
    real = serde.serialize_proof

    def keep(proof):
        kept.append(real(proof))
        return kept[-1]

    monkeypatch.setattr(serde, "serialize_proof", keep)
    out = bench.run("cpu", small=True)
    assert kept == [want]
    assert out["proof_bytes"] == len(want)


def test_bench_without_a_card_raises(capsys):
    """With no card, the default device raises before anything is proved
    and nothing is printed on stdout: no quiet fallback to the host."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([])
    assert capsys.readouterr().out == ""


def test_msm_rate_on_the_host_engine():
    """The full shape's MSM rate on the CPU: the host csrc MSM over the
    SRS's bases, a positive rate."""
    srs = KZGSRS.setup(255)
    assert bench.msm_pts_per_s(srs, torch.device("cpu"), n=256) > 0
