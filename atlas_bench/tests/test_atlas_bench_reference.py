"""The plain forward against the port's quantized forward at tiny sizes on
the CPU, the contract's pieces against their definitions, and the seed's
inputs."""

import math

import numpy as np
import pytest
import torch

from atlas_bench import inputs
from atlas_bench.builders import gpt
from atlas_bench.reference import contract
from atlas_bench.reference import gpt as ref_gpt

CFGS = [
    {"n_layer": 1, "n_head": 1, "n_embd": 16, "seq_len": 8,
     "vocab_size": 32, "scale": 8},
    {"n_layer": 2, "n_head": 2, "n_embd": 16, "seq_len": 8,
     "vocab_size": 20, "scale": 8, "bias": False},
    {"n_layer": 1, "n_head": 4, "n_embd": 64, "seq_len": 16,
     "vocab_size": 65, "scale": 8},
    {"n_layer": 1, "n_head": 4, "n_embd": 128, "seq_len": 4,
     "vocab_size": 64, "scale": 12},
]


def _weights(cfg, seed):
    return gpt.weights(cfg, inputs.normals(gpt.weight_shapes(cfg), seed,
                                           torch.device("cpu")))


@pytest.mark.parametrize("cfg", CFGS)
@pytest.mark.parametrize("seed", [0, 2 ** 31 + 3, 2 ** 40 + 1])
def test_forward_matches_the_port(cfg, seed):
    from jolt_atlas_tpu_torch.frontend.builder import ModelBuilder
    w = _weights(cfg, seed)
    model = gpt.build(ModelBuilder, cfg, w)
    rng = np.random.default_rng(seed)
    for _ in range(3):
        toks = rng.integers(0, cfg["vocab_size"],
                            size=cfg["seq_len"]).astype(np.int32)
        want = model.forward([toks])[0]
        got = ref_gpt.forward(cfg, w, toks)
        assert got.dtype == np.int32 and np.array_equal(got, want)


def test_the_mask_is_causal():
    # a later token changes no earlier position's logits
    cfg = CFGS[2]
    w = _weights(cfg, 11)
    toks = np.arange(16, dtype=np.int32)
    a = ref_gpt.forward(cfg, w, toks)
    toks[-1] = 40
    b = ref_gpt.forward(cfg, w, toks)
    assert np.array_equal(a[:-1], b[:-1]) and not np.array_equal(a[-1], b[-1])


def test_the_head_is_tied_and_padded():
    cfg = CFGS[2]
    w = _weights(cfg, 12)
    assert w["wte"].shape == (128, 64) and not w["wte"][65:].any()
    logits = ref_gpt.forward(cfg, w, np.zeros(16, dtype=np.int32))
    assert logits.shape == (16, 128) and not logits[:, 65:].any()


def test_the_control_loses_a_bit_in_every_product():
    cfg = CFGS[0]
    w = _weights(cfg, 5)
    toks = np.arange(8, dtype=np.int32)
    exact = ref_gpt.forward(cfg, w, toks)
    low = ref_gpt.forward(cfg, w, toks, lost=1)
    assert np.all(low % 2 == 0)
    assert np.count_nonzero(low != exact) > exact.size // 4


def test_pieces():
    assert gpt.quantize(np.array([1e-9, -1e-9, 0.0, 0.5 / 256, -1.5 / 256]),
                        8).tolist() == [1, -1, 0, 1, -2]
    assert contract.rescale(np.array([-1, 255, 256]), 8).tolist() == \
        [-1, 0, 1]
    assert contract.rsqrt(np.array([256, 0, -3]), 8).tolist() == \
        [math.isqrt(2 ** 24 // 256), 0, 0]
    assert contract.cube(np.array([512, -256]), 8).tolist() == [2048, -256]
    assert contract.mean_of_squares(np.array([[256, -256, 0, 0]]),
                                    8).tolist() == [[128]]
    x = np.array([[0, -5, 3, 3]])
    sm = contract.softmax(x, 8)
    assert sm.shape == x.shape and sm[0, 2] == sm[0, 3] > sm[0, 0] > sm[0, 1]
    assert 240 <= sm.sum() <= 256


def test_the_same_seed_gives_the_same_inputs():
    shapes = gpt.weight_shapes(CFGS[0])
    a = inputs.normals(shapes, 2 ** 33, torch.device("cpu"))
    b = inputs.normals(shapes, 2 ** 33, torch.device("cpu"))
    c = inputs.normals(shapes, 2 ** 33 + 1, torch.device("cpu"))
    assert list(a) == [n for n, *_ in shapes]
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not np.array_equal(a["wte"], c["wte"])
