"""The port's ONNX front end and model zoo (jolt_atlas_tpu_torch.frontend)
against the reference's.

Every committed models/*/network.onnx loads in both packages to the same
graph (convert.describe_model), and proves on the port's host path with
the reference's proof bytes; both verifiers accept. The same holds for the
random GPT-2, Qwen2 and BGE exports of tests/test_gpt2_onnx.py and
tests/test_qwen_bge_onnx.py, at their shapes. tests/test_onnx.py's cases
run again on the port.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from jolt_atlas_tpu import serde as ref_serde
from jolt_atlas_tpu.frontend.onnx_load import OnnxLoader as RefLoader
from jolt_atlas_tpu.frontend.onnx_load import RunArgs as RefRunArgs
from jolt_atlas_tpu.frontend.quantize import quantize_tensor as ref_quantize
from jolt_atlas_tpu.preprocessing import AtlasPreprocessing as RefPP
from jolt_atlas_tpu.prover import AtlasProver as RefProver
from jolt_atlas_tpu.verifier import AtlasVerifier as RefVerifier
from jolt_atlas_tpu_torch import convert, serde
from jolt_atlas_tpu_torch.device import split
from jolt_atlas_tpu_torch.frontend.onnx_load import OnnxLoader, RunArgs
from jolt_atlas_tpu_torch.frontend.onnx_proto import (
    encode_attr_i, encode_attr_ints, encode_attr_tensor, encode_model,
    encode_node, parse_onnx)
from jolt_atlas_tpu_torch.frontend.quantize import dequantize, quantize_tensor
from jolt_atlas_tpu_torch.preprocessing import AtlasPreprocessing
from jolt_atlas_tpu_torch.prover import AtlasProver
from jolt_atlas_tpu_torch.verifier import AtlasVerifier
from test_torch_srs import port_srs, reference_native

# the suite runs in several worker processes at once: a small intra-op
# pool keeps this file from starving its neighbours' timed tests
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = sorted(d for d in os.listdir(os.path.join(REPO, "models"))
                  if os.path.exists(os.path.join(REPO, "models", d,
                                                 "network.onnx")))


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


def _same(a, b) -> bool:
    """Deep equality of describe_model values (dicts, sequences, arrays)."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_same(a[k], b[k]) for k in a))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b))
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    return a == b


def _inputs_for(model, rng):
    """tests/test_model_zoo.py:_inputs_for: gather indices as small
    nonnegative ints, every other input a quantized normal tensor."""
    ins = []
    for idx in model.graph.inputs:
        dims = model.graph.nodes[idx].output_dims
        producer_ops = [n.operator.name for n in model.graph.nodes.values()
                        if idx in n.inputs]
        if "GatherSmall" in producer_ops or "GatherLarge" in producer_ops:
            ins.append(rng.integers(0, 8, size=dims).astype(np.int32))
        else:
            ins.append(ref_quantize(rng.normal(size=dims), model.scale))
    return ins


def _prove_both(ref_model, port_model, inputs):
    """The reference's host prove and the port's host prove of one graph
    (the port's own load of it) on the reference's SRS: (reference bytes,
    reference pp, port pp, port proof, io)."""
    ref_pp = RefPP.preprocess(ref_model)
    ref_proof, _ = RefProver(ref_pp).prove(inputs)
    pp = AtlasPreprocessing(port_model, port_srs(ref_pp.srs))
    proof, io = AtlasProver(pp, device="cpu").prove(inputs)
    return ref_serde.serialize_proof(ref_proof), ref_pp, pp, proof, io


def _check_proves_alike(ref_model, port_model, inputs):
    ref_bytes, ref_pp, pp, proof, io = _prove_both(ref_model, port_model,
                                                   inputs)
    blob = serde.serialize_proof(proof)
    assert blob == ref_bytes
    assert AtlasVerifier(pp).verify(serde.deserialize_proof(blob), io)
    ref_io = tuple([np.asarray(t) for t in part] for part in io)
    assert RefVerifier(ref_pp).verify(ref_serde.deserialize_proof(blob),
                                      ref_io)


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_loads_alike(name):
    path = os.path.join(REPO, "models", name, "network.onnx")
    want = convert.describe_model(RefLoader().load_file(path))
    got = convert.describe_model(OnnxLoader().load_file(path))
    assert _same(got, want)


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_proves_as_reference(name):
    path = os.path.join(REPO, "models", name, "network.onnx")
    ref_model = RefLoader().load_file(path)
    inputs = _inputs_for(ref_model, np.random.default_rng(17))
    _check_proves_alike(ref_model, OnnxLoader().load_file(path), inputs)


def test_every_fixture_is_covered():
    assert len(FIXTURES) == 18


# ---------------------------------------------------------------------------
# the random GPT-2, Qwen2 and BGE exports (scripts/download_*.py)
# ---------------------------------------------------------------------------

def _export(tmp_path, script, args):
    subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", script), "--random",
         "--out", str(tmp_path), *args],
        check=True, capture_output=True, timeout=300)
    return os.path.join(str(tmp_path), "network.onnx")


EXPORTS = {
    # tests/test_gpt2_onnx.py:20-29, proved at scale 2^12
    "gpt2": ("download_gpt2.py",
             ["--layers", "1", "--heads", "2", "--dim", "32", "--vocab",
              "64", "--block", "16", "--seq", "8"], 12,
             np.array([1, 5, 9, 13, 2, 6, 10, 0], dtype=np.int32)),
    # tests/test_qwen_bge_onnx.py:30-44, proved at scale 2^8
    "qwen": ("download_qwen.py",
             ["--layers", "2", "--dim", "64", "--heads", "4", "--kv-heads",
              "2", "--ffn", "128", "--vocab", "512", "--seq", "8"], 8,
             np.random.default_rng(5).integers(0, 512, size=8).astype(
                 np.int32)),
    "bge": ("download_bge_small_en_v1_5.py",
            ["--layers", "2", "--dim", "64", "--heads", "4", "--ffn", "128",
             "--vocab", "512", "--seq", "8"], 8,
            np.random.default_rng(5).integers(0, 512, size=8).astype(
                np.int32)),
}


@pytest.mark.parametrize("kind", sorted(EXPORTS))
def test_random_export_proves_as_reference(kind, tmp_path):
    script, args, scale, toks = EXPORTS[kind]
    path = _export(tmp_path, script, args)
    ref_model = RefLoader(RefRunArgs(scale=scale)).load_file(path)
    port_model = OnnxLoader(RunArgs(scale=scale)).load_file(path)
    assert _same(convert.describe_model(port_model),
                 convert.describe_model(ref_model))
    _check_proves_alike(ref_model, port_model, [toks])


# ---------------------------------------------------------------------------
# tests/test_onnx.py's cases, on the port
# ---------------------------------------------------------------------------

def mlp_onnx(din=8, dh=16, dout=4, batch=2, seed=0):
    r = np.random.default_rng(seed)
    w1 = r.normal(size=(din, dh)).astype(np.float32) * 0.4
    b1 = r.normal(size=(dh,)).astype(np.float32) * 0.1
    w2 = r.normal(size=(dh, dout)).astype(np.float32) * 0.4
    nodes = [
        encode_node("MatMul", ["x", "w1"], ["h"]),
        encode_node("Add", ["h", "b1"], ["hb"]),
        encode_node("Relu", ["hb"], ["a"]),
        encode_node("MatMul", ["a", "w2"], ["y"]),
    ]
    data = encode_model(nodes, {"w1": w1, "b1": b1, "w2": w2},
                        [("x", [batch, din])], [("y", [batch, dout])])
    return data, lambda x: np.maximum(x @ w1 + b1, 0) @ w2


def _proves_as_reference(data, inputs):
    """The port's load of ``data`` proves on the host with the bytes of
    the reference's load, and verifies."""
    _check_proves_alike(RefLoader().load_bytes(data),
                        OnnxLoader().load_bytes(data), inputs)


def test_parse_roundtrip():
    data, _ = mlp_onnx()
    g = parse_onnx(data)
    assert len(g.nodes) == 4
    assert set(g.initializers) == {"w1", "b1", "w2"}
    assert g.inputs[0].name == "x" and g.inputs[0].shape == [2, 8]


def test_parse_negative_ints_and_attrs():
    arr = np.array([-5, 3, -(2**40)], dtype=np.int64)
    nodes = [encode_node("Gather", ["d", "i"], ["y"],
                         [encode_attr_i("axis", 0)])]
    data = encode_model(nodes, {"d": arr}, [("i", [2])], [("y", [2])])
    g = parse_onnx(data)
    assert list(g.initializers["d"].to_array()) == [-5, 3, -(2**40)]
    assert g.nodes[0].attributes["axis"].i == 0


def test_mlp_forward():
    data, ref = mlp_onnx()
    model = OnnxLoader().load_bytes(data)
    x = np.random.default_rng(55).normal(size=(2, 8)).astype(np.float32)
    got = dequantize(model.forward([quantize_tensor(x, 8)])[0], 8)
    assert np.abs(got - ref(x)).max() < 0.15


def test_mlp_prove_verify():
    data, _ = mlp_onnx(din=8, dh=8, dout=4, batch=1, seed=1)
    rng = np.random.default_rng(56)
    xq = quantize_tensor(rng.normal(size=(1, 8)).astype(np.float32), 8)
    _proves_as_reference(data, [xq])


def test_softmax_transpose():
    nodes = [
        encode_node("Transpose", ["x"], ["xt"],
                    [encode_attr_ints("perm", [1, 0])]),
        encode_node("Softmax", ["xt"], ["y"], [encode_attr_i("axis", -1)]),
    ]
    data = encode_model(nodes, {}, [("x", [8, 4])], [("y", [4, 8])])
    model = OnnxLoader().load_bytes(data)
    x = np.random.default_rng(57).normal(size=(8, 4)).astype(np.float32)
    got = dequantize(model.forward([quantize_tensor(x, 8)])[0], 8)
    want = np.exp(x.T) / np.exp(x.T).sum(axis=-1, keepdims=True)
    assert np.abs(got - want).max() < 0.05


def test_gather_reduce():
    emb = np.random.default_rng(58).normal(size=(16, 8)).astype(np.float32)
    nodes = [
        encode_node("Gather", ["emb", "idx"], ["e"],
                    [encode_attr_i("axis", 0)]),
        encode_node("ReduceMean", ["e"], ["m"],
                    [encode_attr_ints("axes", [1]),
                     encode_attr_i("keepdims", 1)]),
    ]
    data = encode_model(nodes, {"emb": emb}, [("idx", [4])],
                        [("m", [4, 1])])
    model = OnnxLoader().load_bytes(data)
    idx = np.array([3, 0, 15, 7], dtype=np.int32)
    got = dequantize(model.forward([idx])[0], 8)
    want = emb[idx].mean(axis=1, keepdims=True)
    assert np.abs(got - want).max() < 0.05


def test_symbolic_dims():
    nodes = [encode_node("Relu", ["x"], ["y"])]
    data = encode_model(nodes, {}, [("x", ["batch", 8])],
                        [("y", ["batch", 8])])
    model = OnnxLoader(RunArgs(variables={"batch": 2})).load_bytes(data)
    x = np.random.default_rng(59).integers(-10, 10, size=(2, 8)).astype(
        np.int32)
    assert (model.forward([x])[0] == np.maximum(x, 0)).all()


def test_constant_node_and_div():
    cval = np.array([2.0], dtype=np.float32)
    nodes = [
        encode_node("Constant", [], ["c"],
                    [encode_attr_tensor("value", cval)]),
        encode_node("Div", ["x", "c"], ["y"]),
    ]
    model = OnnxLoader().load_bytes(encode_model(
        nodes, {}, [("x", [4])], [("y", [4])]))
    x = np.random.default_rng(60).normal(size=(4,)).astype(np.float32)
    got = dequantize(model.forward([quantize_tensor(x, 8)])[0], 8)
    assert np.abs(got - x / 2).max() < 0.05
    # Div by an initializer constant
    nodes2 = [encode_node("Div", ["x", "c2"], ["y"])]
    model = OnnxLoader().load_bytes(encode_model(
        nodes2, {"c2": cval}, [("x", [4])], [("y", [4])]))
    got = dequantize(model.forward([quantize_tensor(x, 8)])[0], 8)
    assert np.abs(got - x / 2).max() < 0.05


@pytest.mark.parametrize("opname", ["Tanh", "Sigmoid"])
def test_activations_prove(opname):
    """ONNX Tanh and Sigmoid go through the neural-teleport proof path end
    to end, with the reference's bytes."""
    ref = {"Tanh": np.tanh, "Sigmoid": lambda v: 1 / (1 + np.exp(-v))}[opname]
    data = encode_model([encode_node(opname, ["x"], ["y"])], {},
                        [("x", [8])], [("y", [8])])
    model = OnnxLoader().load_bytes(data)
    x = np.random.default_rng(61).normal(size=8).astype(np.float32)
    got = dequantize(model.forward([quantize_tensor(x, 8)])[0], 8)
    assert np.abs(got - ref(x)).max() < 0.05, opname
    _proves_as_reference(data, [quantize_tensor(x, 8)])


def test_nonpow2_padding():
    r = np.random.default_rng(6)
    w = r.normal(size=(6, 10)).astype(np.float32) * 0.4
    nodes = [encode_node("MatMul", ["x", "w"], ["h"]),
             encode_node("Relu", ["h"], ["y"])]
    data = encode_model(nodes, {"w": w}, [("x", [1, 6])], [("y", [1, 10])])
    model = OnnxLoader().load_bytes(data)
    in_node = model.graph.nodes[model.graph.inputs[0]]
    assert tuple(in_node.output_dims) == (1, 8)
    x = r.normal(size=(1, 6)).astype(np.float32)
    xpad = np.zeros((1, 8), dtype=np.float32)
    xpad[:, :6] = x
    got = dequantize(model.forward([quantize_tensor(xpad, 8)])[0], 8)
    want = np.maximum(x @ w, 0)
    assert np.abs(got[:, :10] - want).max() < 0.1


def _quantized_or_error(fn, a, scale):
    try:
        return "ok", fn(a, scale).tolist()
    except (ValueError, OverflowError) as e:
        return (type(e).__name__,)


@pytest.mark.parametrize("scale", [0, 4, 8, 12, 16, 24])
def test_quantize_tensor_matches_reference(scale):
    """The port's quantize_tensor works on whole arrays; the reference's
    element by element (jolt_atlas_tpu/frontend/quantize.py). Equal
    integers, or the same error, on random values and on the edges: signed
    zeros, ties at +-0.5, 1.5, 2.5 units, values that round to 0 (kept as
    +-1), the clamp bounds and just past them, the mask sentinel's range,
    infinities, NaN and an int32 overflow."""
    rng = np.random.default_rng(scale)
    m = 2.0 ** scale
    mv = round((2 ** 31 - 1) / m)
    edges = [0.0, -0.0, 1e-12, -1e-12, 0.5 / m, -0.5 / m, 1.5 / m, -1.5 / m,
             2.5 / m, -2.5 / m, 0.49999999999999994 / m, mv, -mv, mv + 0.4,
             -mv - 0.4, mv - 0.6, 3e6, -3e6, 1e7, -1e7, 1e300, -1e300,
             np.inf, -np.inf, np.nan]
    for v in edges:
        a = np.array([1.0, v, -2.0])
        assert _quantized_or_error(quantize_tensor, a, scale) == \
            _quantized_or_error(ref_quantize, a, scale), v
    a = np.concatenate([rng.normal(size=(3000,)) * 10,
                        rng.normal(size=(500,)) * mv / 3,
                        rng.integers(-100, 100, size=500) / m * 0.5])
    a = np.clip(a, -0.99 * mv, 0.99 * mv).reshape(40, 100)
    got = quantize_tensor(a, scale)
    assert got.dtype == np.int32 and got.shape == a.shape
    assert np.array_equal(got, ref_quantize(a, scale))
