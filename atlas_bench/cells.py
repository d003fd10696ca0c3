"""A cell, found by name: its entry in BENCHMARK.json, its configuration's
file, its traffic mix's file, and the modules that the configuration and
the per-layer metrics name.

Everything that belongs to one configuration, mix or metric is a file of
its own, found by name: ``configs/<config>.json`` as BENCHMARK.json names
it, which names its graph's builder (``builders/<builder>.py``) and its
plain forward (``reference/<reference>.py``); ``traffic/<traffic>.json``;
``metrics/<metric>.py``. A cell, a configuration, an architecture or a
metric is added by adding files and entries.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import re
from dataclasses import dataclass

HERE = os.path.dirname(os.path.abspath(__file__))
_NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict        # the configuration's file, as run
    traffic: dict       # the mix's parameters
    end_to_end: list    # BENCHMARK.json's entries this cell reports
    per_layer: list

    @property
    def builder(self):
        """``builders/<config's builder>.py``: the graph through the
        program's ModelBuilder, from the benchmark's weights."""
        return module("builders", self.config["builder"])

    @property
    def reference(self):
        """``reference/<config's reference>.py``: the plain forward."""
        return module("reference", self.config["reference"])


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find(root: str, name: str) -> Cell:
    """The cell ``name`` of ``root``/BENCHMARK.json; raises KeyError if
    there is none."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(os.path.join(root, entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, "atlas_bench", "traffic",
                           f"{w['traffic']}.json")) as f:
        traffic = json.load(f)
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in moved)]
    return Cell(name, w["chips"], config, traffic, e2e, per_layer)


def module(kind: str, name: str):
    """The module ``atlas_bench.<kind>.<name>`` (``kind`` "builders" or
    "reference"), found by the name a configuration gives."""
    if kind not in ("builders", "reference") or not _NAME.match(name):
        raise KeyError(f"no {kind} module {name!r}")
    return importlib.import_module(f"atlas_bench.{kind}.{name}")


def reader(metric: str):
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    mod = "atlas_bench_metric_" + metric.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod, path)
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    return m.read
