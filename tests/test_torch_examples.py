"""The port's example drivers (jolt_atlas_tpu_torch.examples) against the
reference's examples/*.py.

Each driver's ``run`` proves on the host path (--device cpu) at a narrow
size, and its proof bytes must equal those of the reference's driver at
the same flags, captured by wrapping the reference's AtlasProver.prove
around the driver's main. A subprocess with jax and jolt_atlas_tpu
blocked imports every driver and runs one. The GPT-2-style slice at its
full width is a slow test.
"""

import os
import subprocess
import sys
import textwrap

import pytest
import torch

import jolt_atlas_tpu.prover as ref_prover
from examples import bge_style as ref_bge
from examples import gpt2_style as ref_gpt2
from examples import nanogpt_style as ref_nanogpt
from examples import qwen_style as ref_qwen
from jolt_atlas_tpu import serde as ref_serde
from jolt_atlas_tpu_torch.device import split
from jolt_atlas_tpu_torch.examples import (bge_style, gpt2_style,
                                           microgpt_style, minigpt_style,
                                           nanogpt_style, qwen_style)

# the suite runs in several worker processes at once: a small intra-op
# pool keeps this file from starving its neighbours' timed tests
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the GPT-2-style slice's structure at a narrow size: 1 block, 2 heads,
# d32, seq 8, vocab 256 (scale 2^12 from gpt2_style)
GPT2_NARROW = ["--blocks", "1", "--heads", "2", "--dim", "32", "--seq", "8",
               "--vocab", "256", "--gen", "2"]
MINI_NARROW = ["--seq", "8", "--vocab", "64", "--gen", "1"]
BGE_NARROW = ["--blocks", "1", "--dim", "16", "--seq", "8", "--vocab", "64"]


@pytest.fixture(scope="module", autouse=True)
def _few_host_threads():
    """The csrc host engines' OpenMP threads capped likewise while this
    file runs (the reference's wall-clock tests share the machine)."""
    split.set_host_threads(2)
    yield
    split.set_host_threads(None)


def reference_bytes(main, argv: list[str], monkeypatch) -> bytes:
    """The serialized proof of the reference driver ``main`` run with
    command line ``argv``: its AtlasProver.prove wrapped to keep it."""
    kept = []
    real = ref_prover.AtlasProver.prove

    def keep(self, inputs):
        out = real(self, inputs)
        kept.append(ref_serde.serialize_proof(out[0]))
        return out

    monkeypatch.setattr(ref_prover.AtlasProver, "prove", keep)
    monkeypatch.setattr(sys, "argv", ["driver"] + argv)
    main()
    monkeypatch.undo()
    assert len(kept) == 1
    return kept[0]


CASES = {
    # name: (port run, its flags, reference main, the reference's flags)
    "nanogpt": (lambda a: nanogpt_style.run(nanogpt_style.parser()
                                            .parse_args(a)),
                ["--gen", "2"], ref_nanogpt.main, ["--gen", "2"]),
    "nanogpt_zk": (lambda a: nanogpt_style.run(nanogpt_style.parser()
                                               .parse_args(a)),
                   ["--zk", "--dim", "8", "--seq", "4", "--vocab", "16",
                    "--gen", "1"], ref_nanogpt.main,
                   ["--zk", "--dim", "8", "--seq", "4", "--vocab", "16",
                    "--gen", "1"]),
    "gpt2": (lambda a: nanogpt_style.run(gpt2_style.args(a)), GPT2_NARROW,
             ref_nanogpt.main, ["--scale", "12"] + GPT2_NARROW),
    # the reference's microgpt and minigpt start nanogpt_style in a
    # subprocess with their shape's flags: run its main with them here
    "microgpt": (lambda a: nanogpt_style.run(microgpt_style.args(a)),
                 ["--gen", "1"], ref_nanogpt.main,
                 microgpt_style.SHAPE + ["--gen", "1"]),
    "minigpt": (lambda a: nanogpt_style.run(minigpt_style.args(a)),
                MINI_NARROW, ref_nanogpt.main,
                minigpt_style.SHAPE + MINI_NARROW),
    "bge": (lambda a: bge_style.run(bge_style.parser().parse_args(a)),
            BGE_NARROW, ref_bge.main, BGE_NARROW),
    # the reference falls back to the committed models/qwen_slice
    "qwen": (lambda a: qwen_style.run(qwen_style.parser().parse_args(a)),
             ["--gen", "2"], ref_qwen.main, ["--gen", "2"]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_driver_bytes_equal_reference(name, monkeypatch, capsys):
    port_run, argv, ref_main, ref_argv = CASES[name]
    with nanogpt_style.seeded_blinding():
        want = reference_bytes(ref_main, ref_argv, monkeypatch)
    with nanogpt_style.seeded_blinding():
        out = port_run(argv + ["--device", "cpu"])
    assert out["blob"] == want
    assert out["telemetry"]["decisions"]["msm"].startswith(
        "declined on cpu")
    printed = capsys.readouterr().out
    for line in ("preprocessing (SRS)...", "  prove: ", "  verify: ",
                 "  phases: witness_generation", "  reduction: "):
        assert line in printed, line
    # the zk pipeline opens inside its batch_opening_reduction span
    assert set(out["phases"]) == {"witness_generation", "commit", "iop",
                                  "batch_opening_reduction"} | (
        set() if "--zk" in argv else {"hyperkzg_open"})


def test_gpt2_style_flags():
    """The slice by default; --fullvocab and --full as the reference's
    driver sets them; later flags override the slice's."""
    a = gpt2_style.args([])
    assert (a.blocks, a.heads, a.dim, a.seq, a.vocab, a.scale) == (
        2, 4, 128, 16, 8192, 12)
    assert a.device == "cuda"
    assert gpt2_style.args(["--fullvocab"]).vocab == 50257
    full = gpt2_style.args(["--full", "--device", "cpu"])
    assert (full.blocks, full.heads, full.dim, full.vocab, full.device) == (
        12, 16, 1024, 50257, "cpu")
    assert gpt2_style.args(["--blocks", "1"]).blocks == 1


def test_gpt2_style_full_flags_match_reference(monkeypatch):
    """--full parses to the reference driver's configuration, GPT-2 at its
    padded 125M shape: 12 blocks, dim 1024, 16 heads, seq 16, vocab 50257
    (padded to 65536 by the model), scale 2^12; the reference driver's own
    command line, read where it calls its nanogpt main, parses to the same
    arguments."""
    full = gpt2_style.args(["--full", "--gen", "1"])
    assert (full.blocks, full.dim, full.heads, full.seq, full.vocab,
            full.scale, full.gen) == (12, 1024, 16, 16, 50257, 12, 1)
    seen = []
    monkeypatch.setattr(ref_gpt2, "nanogpt_main",
                        lambda: seen.append(list(sys.argv)) or 0)
    monkeypatch.setattr(sys, "argv", ["gpt2_style.py"])
    ref_gpt2.main(["--full", "--gen", "1"])
    assert vars(nanogpt_style.parser().parse_args(seen[0][1:])) == vars(full)


def test_qwen_style_raises_without_its_file(tmp_path):
    args = qwen_style.parser().parse_args(
        ["--model", str(tmp_path / "network.onnx"), "--device", "cpu"])
    with pytest.raises(FileNotFoundError, match="qwen_slice"):
        qwen_style.run(args)


def test_drivers_ask_for_the_card():
    """Without a device flag a driver proves on the card: here, with none,
    it raises before it proves."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        nanogpt_style.check_device(nanogpt_style.parser().parse_args(
            []).device)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bge_style.run(bge_style.parser().parse_args(BGE_NARROW))


def test_drivers_import_no_jax():
    """In a process where importing jax or jolt_atlas_tpu fails, every
    driver imports and microgpt_style proves and verifies on the CPU."""
    code = textwrap.dedent("""
        import importlib, sys

        class Block:
            def find_spec(self, name, path=None, target=None):
                if (name.split(".")[0] in ("jax", "jaxlib")
                        or name == "jolt_atlas_tpu"
                        or name.startswith("jolt_atlas_tpu.")):
                    raise ImportError(f"blocked: {name}")
                return None

        sys.meta_path.insert(0, Block())
        for name in ("nanogpt_style", "gpt2_style", "microgpt_style",
                     "minigpt_style", "bge_style", "qwen_style"):
            importlib.import_module("jolt_atlas_tpu_torch.examples." + name)
        from jolt_atlas_tpu_torch.examples import microgpt_style
        assert microgpt_style.main(["--device", "cpu", "--gen", "1"]) == 0
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "jolt_atlas_tpu")]
        assert not bad, bad
        print("ok")
    """)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       env=dict(os.environ, OMP_NUM_THREADS="2"),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().endswith("ok")
    assert "verify: " in r.stdout


@pytest.mark.slow
def test_gpt2_style_slice_bytes_equal_reference(monkeypatch):
    """The GPT-2-style slice (GPT-2 cut to 2 blocks, 4 heads, d128, seq 16,
    vocab 8192, scale 2^12; an SRS of 2^21)."""
    want = reference_bytes(lambda: ref_gpt2.main(["--gen", "1"]), [],
                           monkeypatch)
    out = nanogpt_style.run(gpt2_style.args(["--gen", "1", "--device",
                                             "cpu"]))
    assert len(out["model"].graph.nodes) == 67
    assert out["blob"] == want
