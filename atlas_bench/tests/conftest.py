"""Shared set-up of the benchmark's CPU tests: the repository's root on the
path, the host engines capped at two threads, and a tiny cell."""

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY = {"builder": "gpt", "reference": "gpt", "n_layer": 1, "n_head": 2,
        "n_embd": 16, "vocab_size": 20, "bias": True, "seq_len": 8,
        "scale": 8}
TINY_CELL = "tiny.closed-blake2b"


@pytest.fixture(autouse=True, scope="session")
def _two_threads():
    from jolt_atlas_tpu_torch.device import split
    split.set_host_threads(2)


def add_cell(root: str, config: dict, name: str = TINY_CELL,
             mix: dict | None = None) -> str:
    """A checkout root whose BENCHMARK.json is the repository's with one
    more cell, ``name``, added as data alone: a configuration file, its
    entry and its name under each per-layer metric in BENCHMARK.json, the
    repository's traffic files and ``mix``, if given, as the cell's."""
    os.makedirs(os.path.join(root, "atlas_bench", "configs"), exist_ok=True)
    shutil.copytree(os.path.join(ROOT, "atlas_bench", "traffic"),
                    os.path.join(root, "atlas_bench", "traffic"),
                    dirs_exist_ok=True)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cfg_name, traffic = name.split(".", 1)
    if mix is not None:
        with open(os.path.join(root, "atlas_bench", "traffic",
                               f"{traffic}.json"), "w") as f:
            json.dump(mix, f)
    path = f"atlas_bench/configs/{cfg_name}.json"
    with open(os.path.join(root, path), "w") as f:
        json.dump(config, f)
    if cfg_name not in {c["name"] for c in bench["configs"]}:
        bench["configs"].append({"name": cfg_name, "source": "test",
                                 "file": path, "reduced": [], "why": "test"})
    bench["workloads"].append({"name": name, "config": cfg_name,
                               "traffic": traffic, "chips": 1,
                               "why": "test"})
    for metric in bench["per_layer"]:
        metric.setdefault("workloads", []).append(name)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return add_cell(str(tmp_path_factory.mktemp("bench")), TINY)
