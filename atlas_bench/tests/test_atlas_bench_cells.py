"""The cells are data: each is found by name, and one added as data alone
runs; a run loads no JAX; without a card the benchmark refuses."""

import json
import os
import subprocess
import sys

import pytest
import torch

from conftest import ROOT, TINY, TINY_CELL, add_cell

from atlas_bench import cells, harness, traffic


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", [w["name"] for w in _bench()["workloads"]])
def test_every_cell_finds_its_files(name):
    cell = cells.find(ROOT, name)
    vocab, seq = cell.builder.request(cell.config)
    assert vocab > 0 and seq > 0
    assert callable(cell.builder.build) and callable(cell.reference.forward)
    traffic.check(cell.traffic)
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "prove_s"}
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(cells.reader(m["name"]))


def test_every_metric_has_a_reader_and_a_layer():
    bench = _bench()
    layers = {}
    for m in bench["per_layer"]:
        assert callable(cells.reader(m["name"]))
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
        layers.setdefault(m["layer"], []).append(m["name"])
    assert sorted(layers["device MSM"]) == ["msm_device_ms", "msm_roofline"]


def test_unknown_cell_traffic_and_modules_are_refused(tiny_root):
    with pytest.raises(KeyError):
        cells.find(tiny_root, "no-such.cell")
    mix = {"loop": "closed", "clients": 1, "transcript": "blake2b",
           "pcs": "hyperkzg", "entry": "prove", "tokens": "uniform",
           "warmup_proofs": 1}
    traffic.check(mix)
    for key, bad in (("loop", "open"), ("pcs", "ipa"), ("entry", "run"),
                     ("warmup_proofs", 0)):
        with pytest.raises(ValueError):
            traffic.check(dict(mix, **{key: bad}))
    for kind, name in (("builders", "../run"), ("metrics", "gpt"),
                       ("reference", "a b")):
        with pytest.raises(KeyError):
            cells.module(kind, name)


def test_a_cell_added_as_data_alone_runs(tiny_root):
    cell = cells.find(tiny_root, TINY_CELL)
    out = harness.run(cell, 2 ** 31 + 11, 0.5, False, torch.device("cpu"),
                      0.0)
    assert out["correct"], out
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {"prove_s", "setup_s"}
    assert list(out)[-1] == "checks"
    assert out["checks"]["io_mismatch"] == {"value": 0, "limit": 0}


def test_a_traced_run_reports_the_per_layer_metrics(tiny_root):
    cell = cells.find(tiny_root, TINY_CELL)
    out = harness.run(cell, 2 ** 33 + 5, 0.5, True, torch.device("cpu"),
                      0.0)
    assert out["correct"], out
    # no device on the CPU: the readers of the trace find nothing to
    # read, and no share is reported as 0
    assert set(out["metrics"]) == {"witness_s", "commit_s", "iop_s",
                                   "reduction_s", "hyperkzg_open_s"}
    assert out["device"]["window_s"] > 0
    assert out["breakdown"]["device_ops"] == []


@pytest.mark.parametrize("pcs,entry", [("dory", "prove"),
                                       ("hyperkzg", "prove_zk")])
def test_a_mix_of_another_commitment_or_entry_runs_as_data(
        tmp_path, pcs, entry):
    # a mix is a data file: the commitment and the prover's entry are its
    # parameters, and the frozen verifier judges those proofs too
    mix = {"loop": "closed", "clients": 1, "transcript": "blake2b",
           "pcs": pcs, "entry": entry, "tokens": "uniform",
           "warmup_proofs": 1}
    name = f"tiny.closed-{pcs}-{entry}"
    root = add_cell(str(tmp_path), TINY, name=name, mix=mix)
    out = harness.run(cells.find(root, name), 2 ** 32 + 9, 0.1, False,
                      torch.device("cpu"), 0.0)
    assert out["correct"], out
    assert out["checks"]["rejected"] == {"value": 0, "limit": 0}


_RUN_NO_JAX = """
import sys, time, torch
sys.path.insert(0, {root!r})
from jolt_atlas_tpu_torch.device import split
split.set_host_threads(2)
from atlas_bench import cells, harness, run
cell = cells.find({tiny!r}, {name!r})
harness.run(cell, 7, 0.2, False, torch.device("cpu"), 0.0)
print(run.loaded_forbidden())
"""


def test_a_run_loads_no_jax(tiny_root):
    code = _RUN_NO_JAX.format(root=ROOT, tiny=tiny_root, name=TINY_CELL)
    got = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=tiny_root)
    assert got.returncode == 0, got.stderr[-2000:]
    assert got.stdout.strip().splitlines()[-1] == "[]"


def test_without_a_card_the_benchmark_refuses():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    got = subprocess.run(
        [sys.executable, "atlas_bench/run.py", "--workload",
         "nanogpt-4l-d64.closed-blake2b", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=ROOT, env=env)
    assert got.returncode != 0
    assert got.stdout.strip() == ""


def test_the_forbidden_modules_are_matched_by_whole_name(monkeypatch):
    from atlas_bench import run
    monkeypatch.setitem(sys.modules, "jolt_atlas_tpu_torch_x", sys)
    assert run.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.loaded_forbidden() == ["jax"]
