"""The benchmark's GPT-2 configuration (``atlas_bench/configs/gpt2-1l.json``)
on the CPU: its plain PyTorch reference (``reference/gpt2.py``) against the
NumPy one (``reference/gpt.py``) where their shapes meet, the padded graph
of ``builders/gpt2.py`` against the reference at widths that are not
powers of two, the LayerNorm mask as the control of that, a prove of the
small model accepted by the program's verifier and by the frozen judge
against the reference's logits, the control's precision, the float32
forward, and the reference's imports.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from atlas_bench import cells, frozen_judge, inputs
from atlas_bench.builders import gpt, gpt2
from atlas_bench.reference import contract
from atlas_bench.reference import gpt as ref_gpt
from atlas_bench.reference import gpt2 as ref_gpt2
from jolt_atlas_tpu_torch import serde, transcripts
from jolt_atlas_tpu_torch.device import split
from jolt_atlas_tpu_torch.frontend.builder import ModelBuilder
from jolt_atlas_tpu_torch.preprocessing import AtlasPreprocessing
from jolt_atlas_tpu_torch.prover import AtlasProver
from jolt_atlas_tpu_torch.utils import profiling
from jolt_atlas_tpu_torch.verifier import AtlasVerifier

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")

# nanoGPT's benchmark shape: every width a power of two but the vocabulary
NANO = {"n_layer": 4, "n_head": 4, "n_embd": 64, "seq_len": 64,
        "vocab_size": 65, "scale": 8, "bias": True}
# GPT-2's pattern at a small size: no width a power of two but the heads'
SMALL = {"builder": "gpt2", "reference": "gpt2", "n_layer": 1, "n_head": 3,
         "n_embd": 96, "n_inner": 384, "vocab_size": 200, "seq_len": 8,
         "scale": 12, "bias": True}

# The integer forward against float32 on the same weights, in real units.
# The largest departures are the contract's: GELU's tanh sees its argument
# floored to a step of 2^-7, so each MLP unit is off by up to ~0.004 |u|,
# and eps and GELU's constants are rounded to 2^-12; summed into a logit
# over the MLP's 384 units and the head's 96 columns, they come to
# 0.025-0.037 on logits of ~60-80 here (six seeds); 0.1 leaves room for
# other seeds. The float32 forward cannot tell the control's lost bit
# (0.034-0.046) nor an unmasked LayerNorm (0.09-0.79): the exact
# comparisons do that.
FLOAT_TOL = 0.1


def _weights(builder, cfg, seed):
    return builder.weights(cfg, inputs.normals(builder.weight_shapes(cfg),
                                               seed, CPU))


def _tokens(cfg, seed):
    return np.random.default_rng(seed).integers(
        0, cfg["vocab_size"], size=cfg["seq_len"]).astype(np.int32)


@pytest.mark.parametrize("seed", [3, 2 ** 40 + 1])
def test_the_torch_reference_is_the_numpy_one_on_nanogpts_shape(seed):
    normals = inputs.normals(gpt.weight_shapes(NANO), seed, CPU)
    w, w2 = gpt.weights(NANO, normals), gpt2.weights(NANO, normals)
    assert w2["wte"].shape == (65, 64)
    for k in range(2):
        toks = _tokens(NANO, seed + k)
        want = ref_gpt.forward(NANO, w, toks)
        got = ref_gpt2.forward(NANO, w2, toks)
        assert got.dtype == np.int32 and np.array_equal(got, want)


@pytest.mark.parametrize("s", [8, 12])
def test_the_tables_are_the_contracts(s):
    """The teleported tanh over every input it can tell apart, and the
    softmax's exp tables, equal the contract's."""
    x = np.arange(-(1 << 16), 1 << 16, 2 << (s - 8), dtype=np.int64)
    assert np.array_equal(ref_gpt2._tanh(torch.as_tensor(x), s).numpy(),
                          contract.tanh(x, s))
    hi, lo, B = ref_gpt2.exp_tables(1 << s)
    want = contract.exp_tables(1 << s)
    assert np.array_equal(hi.numpy(), want[0])
    assert np.array_equal(lo.numpy(), want[1]) and B == want[2]


@pytest.fixture(scope="module")
def small():
    """The small model's weights, its graph and a request's tokens."""
    w = _weights(gpt2, SMALL, 2 ** 33 + 5)
    return w, gpt2.build(ModelBuilder, SMALL, w), _tokens(SMALL, 7)


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 11])
def test_the_padded_graph_executes_to_the_references_logits(seed):
    w = _weights(gpt2, SMALL, seed)
    model = gpt2.build(ModelBuilder, SMALL, w)
    weights = {tuple(model.graph.nodes[n.inputs[1]].output_dims)
               for n in model.graph.nodes.values()
               if getattr(n.operator, "equation", "") == "mk,kn->mn"}
    assert weights == {(128, 128), (128, 512), (512, 128), (128, 256)}
    for k in range(3):
        toks = _tokens(SMALL, seed + k)
        want = ref_gpt2.forward(SMALL, w, toks)
        assert want.shape == (8, 256) and not want[:, 200:].any()
        assert np.array_equal(model.forward([toks])[0], want)


def test_without_the_layernorm_mask_the_graph_differs(small, monkeypatch):
    """The control of the mask: with every column taken as real, the
    centred values' padded columns (minus the mean) enter the variance."""
    w, model, toks = small
    want = ref_gpt2.forward(SMALL, w, toks)
    assert np.array_equal(model.forward([toks])[0], want)
    monkeypatch.setattr(gpt2, "_real_columns",
                        lambda seq, d, width: np.ones((seq, width), np.int32))
    unmasked = gpt2.build(ModelBuilder, SMALL, w)
    got = unmasked.forward([toks])[0]
    assert np.count_nonzero(got[:, :200] != want[:, :200]) > 200 * 8 // 2


def test_the_port_proves_the_small_model_and_the_judges_accept(small):
    w, model, toks = small
    split.set_host_threads(2)
    mix = {"transcript": "blake2b", "pcs": "hyperkzg", "entry": "prove"}
    pp = AtlasPreprocessing.preprocess(model, pcs="hyperkzg")
    factory = transcripts.Blake2bTranscript
    was = profiling.enabled()
    profiling.enable()
    try:
        proof, io = AtlasProver(pp, transcript_factory=factory,
                                device="cpu").prove([toks])
        counted = profiling.proofs()[-1].counters["einsum_bind_elements"]
    finally:
        profiling.enable(was)
        split.set_host_threads(None)
    ref = ref_gpt2.forward(SMALL, w, toks)
    assert np.array_equal(io[0][0], toks) and np.array_equal(io[1][0], ref)
    blob = serde.serialize_proof(proof)
    assert AtlasVerifier(pp, factory).verify(serde.deserialize_proof(blob),
                                             io)
    cell = cells.Cell("small.closed-blake2b", 1, SMALL, mix, [], [])
    judge = frozen_judge.Judge(cell, w)
    assert judge.verify(blob, toks, ref)[0]
    wrong = ref.copy()
    wrong[3, 5] += 1
    assert not judge.verify(blob, toks, wrong)[0]
    # q, k, v, o 4 x 128^2, fc and proj 2 x 128 x 512, the head 128 x 256;
    # their activations 5 x 8 x 128 + 8 x 512 + 8 x 128; attention's
    # q, k, v 3 x 4 x 8 x 32 and its weights 4 x 8 x 8
    assert counted == (4 * 128 ** 2 + 2 * 128 * 512 + 128 * 256
                       + 6 * 8 * 128 + 8 * 512 + 3 * 4 * 8 * 32 + 4 * 8 * 8)


def test_one_bit_lost_in_every_product_changes_the_logits(small):
    w, _, toks = small
    exact = ref_gpt2.forward(SMALL, w, toks)
    low = ref_gpt2.forward(SMALL, w, toks, lost=1)
    assert np.all(low % 2 == 0)
    assert np.count_nonzero(low[:, :200] != exact[:, :200]) > 200 * 8 // 4


@pytest.mark.parametrize("seed", [1, 2 ** 35 + 2])
def test_the_quantized_logits_follow_the_float32_forward(seed):
    w = _weights(gpt2, SMALL, seed)
    toks = _tokens(SMALL, seed)
    fl = ref_gpt2.forward_float(SMALL, w, toks)
    assert fl.dtype == np.float32 and fl.shape == (8, 200)
    q = ref_gpt2.forward(SMALL, w, toks)[:, :200] / 2.0 ** SMALL["scale"]
    assert np.abs(q - fl).max() < FLOAT_TOL


def test_the_reference_imports_no_program_and_no_jax():
    code = ("import sys; import atlas_bench.reference.gpt2; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'jolt_atlas_tpu', 'jolt_atlas_tpu_torch'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip() == "[]"


def test_the_configuration_keeps_every_published_width():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    entry = {c["name"]: c for c in bench["configs"]}["gpt2-1l"]
    with open(os.path.join(REPO, entry["file"])) as f:
        cfg = json.load(f)
    assert (cfg["n_embd"], cfg["n_head"], cfg["n_inner"]) == (768, 12, 3072)
    assert cfg["layer_norm_epsilon"] == gpt.EPS and cfg["scale"] == 12
    assert entry["reduced"] == cfg["reduced"] == ["n_layer", "vocab_size"]
    assert cfg["published"]["n_layer"] == 12
    assert cfg["vocab_size"] == -(-cfg["published"]["vocab_size"] // 8)
    cell = cells.find(REPO, "gpt2-1l.closed-blake2b")
    assert cell.builder is gpt2 and cell.reference is ref_gpt2
    assert gpt2.padded(cfg)["n_head"] == 16
    assert cfg["parameters"] == sum(int(np.prod(s)) for _, s, _ in
                                    gpt2.weight_shapes(cfg))
