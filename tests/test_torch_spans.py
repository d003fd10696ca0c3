"""The port's spans and counters (utils/profiling.py, device/telemetry.py)
and the benchmark's readers of them (atlas_bench/spans.py, metrics/), on
the CPU.

A small prove's span records nest, share the proof's number and carry
their times, with the five phases alone at the top, and the proof's bytes
are the same with the spans off; a disabled span records nothing and no
span opens a profiler annotation while no profiler records; under
torch.profiler the spans are ``jolt:`` annotations; ``trace.reduce``
gives the same numbers with the annotations in the trace as without, and
``spans.by_span`` splits the trace by them; every reader, old and new, on
a synthetic reading and trace.
"""

import json
import os

import numpy as np
import pytest
import torch

from atlas_bench import cells, spans, trace, work
from jolt_atlas_tpu_torch import models, serde
from jolt_atlas_tpu_torch.device import split, telemetry
from jolt_atlas_tpu_torch.field import frvec
from jolt_atlas_tpu_torch.preprocessing import AtlasPreprocessing
from jolt_atlas_tpu_torch.prover import AtlasProver
from jolt_atlas_tpu_torch.utils import profiling

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = {"witness_generation", "commit", "iop", "batch_opening_reduction",
          "hyperkzg_open"}


@pytest.fixture(autouse=True)
def _spans_off_after():
    """Each test leaves the spans as it found them: off, no records."""
    was = profiling.enabled()
    yield
    profiling.enable(was)
    profiling.reset()


@pytest.fixture(scope="module")
def proved():
    """A tiny nanoGPT-shaped model proved twice on the host, the spans off
    then on: (serialized proof off, on, the kept proof, its events, the
    model)."""
    split.set_host_threads(2)
    rng = np.random.default_rng(1234)
    model = models.build_nanogpt(32, 8, 16, 1, 8, rng, heads=1)
    toks = rng.integers(0, 32, size=8).astype(np.int32)
    prover = AtlasProver(AtlasPreprocessing.preprocess(model), device="cpu")
    profiling.enable(False)
    off = serde.serialize_proof(prover.prove([toks])[0])
    profiling.enable()
    profiling.reset()
    kept = len(profiling.proofs())
    on = serde.serialize_proof(prover.prove([toks])[0])
    profiling.enable(False)
    assert len(profiling.proofs()) == min(kept + 1, profiling.KEEP)
    split.set_host_threads(None)
    return off, on, profiling.proofs()[-1], profiling.events(), model


def test_a_proofs_records_nest_and_share_its_number(proved):
    off, on, proof, events, _ = proved
    assert off == on
    recs = proof.records
    by_id = {r.id: r for r in recs}
    assert proof.seq > 0 and {r.proof for r in recs} == {proof.seq}
    for r in recs:
        assert r.start_ns < r.end_ns and r.cpu_ns >= 0
        up = by_id.get(r.parent)
        if r.parent == -1:
            assert r.depth == 0
        else:
            assert up.depth + 1 == r.depth
            assert up.start_ns <= r.start_ns and r.end_ns <= up.end_ns
    assert {r.name for r in recs if r.depth == 0} == PHASES
    assert len([r for r in recs if r.depth == 0]) == len(PHASES)
    names = {r.name for r in recs}
    assert {"eval_reduction", "reduction_prepare",
            "reduction_rounds"} <= names
    assert any(n.startswith("sumcheck:") for n in names)
    # the records since the reset, as events: indented name, wall, CPU
    assert [(n.strip(), round(w, 9)) for n, w, _ in events] == [
        (r.name, round((r.end_ns - r.start_ns) * 1e-9, 9)) for r in recs]
    assert all(c >= 0 for _, _, c in events)


def test_a_proofs_counters_are_its_own(proved):
    c = proved[2].counters
    assert c["host_field_calls"] > 0 and c["sumcheck_batched_rounds"] > 0
    assert c["iop_rows_bound_host"] > 0 and "iop_rows_bound_card" not in c


def test_each_einsum_operand_bind_is_a_span_and_counts_its_elements(proved):
    """Two ``einsum_bind`` spans an Einsum node, under the node's span in
    ``iop``, and ``einsum_bind_elements`` the sum of its operands' sizes."""
    proof, model = proved[2], proved[4]
    einsums = [n for n in model.graph.nodes.values()
               if type(n.operator).__name__ == "Einsum"]
    want = sum(int(np.prod(model.graph.nodes[i].output_dims))
               for n in einsums for i in n.inputs)
    assert einsums and want > 0
    assert proof.counters["einsum_bind_elements"] == want
    by_id = {r.id: r for r in proof.records}
    binds = [r for r in proof.records if r.name == "einsum_bind"]
    assert len(binds) == 2 * len(einsums)
    assert all(by_id[r.parent].name.endswith("] Einsum")
               and by_id[by_id[r.parent].parent].name == "iop"
               for r in binds)


def test_the_tree_shows_self_time_calls_and_cores(proved):
    recs = proved[2].records
    rows = {p: (calls, wall, own, cpu)
            for p, calls, wall, own, cpu in profiling.tree(recs)}
    assert [p for p in rows if len(p) == 1] == [
        (r.name,) for r in sorted(recs, key=lambda r: r.start_ns)
        if r.depth == 0]
    iop = rows[("iop",)]
    below = sum(w for p, (_, w, _, _) in rows.items()
                if len(p) == 2 and p[0] == "iop")
    assert iop[0] == 1 and iop[2] == iop[1] - below
    assert rows[("batch_opening_reduction", "reduction_prepare")][0] == 2
    # each path follows its parent
    order = list(rows)
    assert all(order.index(p[:-1]) < order.index(p)
               for p in order if len(p) > 1)
    assert not any(p[-1].startswith("node[") for p in order)


def test_report_prints_the_tree():
    profiling.enable()
    profiling.reset()
    for _ in range(2):
        with profiling.span("outer"):
            with profiling.span("node[3] Einsum"):
                pass
    lines = profiling.report().splitlines()
    assert lines[0].split() == ["span", "calls", "wall_s", "self_s",
                                "cpu_s", "cores"]
    assert lines[1].split()[:2] == ["outer", "2"]
    assert lines[2].startswith("  Einsum ") and lines[2].split()[1] == "2"


def test_a_disabled_span_records_nothing(monkeypatch):
    profiling.enable(False)
    profiling.reset()
    kept = profiling.proofs()
    with profiling.proof(), profiling.span("x"):
        pass
    assert profiling.events() == []
    assert profiling.proofs() == kept


def test_no_annotation_opens_without_a_profiler(monkeypatch):
    def refused(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")
    monkeypatch.setattr(profiling._torch_profiler, "record_function",
                        refused)
    profiling.enable()
    profiling.reset()
    with profiling.span("x"):
        pass
    assert [n for n, _, _ in profiling.events()] == ["x"]


def test_the_spans_are_annotations_under_the_profiler(tmp_path):
    profiling.enable()
    profiling.reset()
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with profiling.span("outer"), profiling.span("inner"):
            torch.ones(4).sum()
    path = str(tmp_path / "t.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        ev = {e["name"]: e for e in json.load(f)["traceEvents"]
              if e.get("cat") == "user_annotation"}
    outer, inner = ev["jolt:outer"], ev["jolt:inner"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


def test_the_field_engine_counts_each_call():
    lib = frvec._load()
    telemetry.reset()
    assert frvec.available()
    assert telemetry.counters() == {}
    a = frvec.FrArray.from_i64(np.arange(-4, 4))  # frv_from_i64
    assert telemetry.counters() == {"host_field_calls": 1}
    b = a.add(a)  # frv_add
    assert telemetry.counters() == {"host_field_calls": 2}
    b.sum()  # frv_sum, then frv_decode of the sum
    assert telemetry.counters() == {"host_field_calls": 4}
    assert telemetry.snapshot()["counters"] == telemetry.counters()
    assert callable(lib.frv_mul)
    telemetry.reset()
    assert telemetry.snapshot()["counters"] == {}


# ---------------------------------------------------------------------------
# the benchmark's side: a synthetic trace and reading
# ---------------------------------------------------------------------------

def _x(name, ts, dur, cat="user_annotation", **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "args": args}


def _trace(with_spans: bool) -> dict:
    S = trace.MARK_SPAN
    ev = [_x(trace.MARK_WINDOW, 0, 1000),
          _x(S + "iop", 10, 500), _x(S + "node[3] Einsum", 50, 200),
          _x(S + "batch_opening_reduction", 600, 300),
          _x(trace.MARK_MSM, 700, 50)]
    for k, (launch, start, dur) in enumerate(
            [(105, 110, 20), (320, 330, 10), (710, 720, 40),
             (950, 960, 10)]):
        ev.append(_x("cudaLaunchKernel", launch, 1, "cuda_runtime",
                     correlation=k))
        ev.append(_x(f"k{k % 2}", start, dur, "kernel", correlation=k))
    if with_spans:
        ev += [_x("jolt:" + n, ts, dur) for n, ts, dur in [
            ("iop", 10, 500), ("node[3] Einsum", 50, 200),
            ("sumcheck:EinsumProver", 60, 180), ("rows_points", 100, 20),
            ("eval_reduction", 300, 50),
            ("batch_opening_reduction", 600, 300),
            ("reduction_rounds", 610, 280)]]
    return {"traceEvents": ev}


def _reduced(tmp_path, with_spans: bool) -> dict:
    path = tmp_path / f"{with_spans}.json"
    path.write_text(json.dumps(_trace(with_spans)))
    return trace.reduce(str(path), [131072])


def test_trace_reduce_is_the_same_with_the_programs_spans(tmp_path):
    got = _reduced(tmp_path, True)
    assert got == _reduced(tmp_path, False)
    assert got["window_s"] == pytest.approx(1e-3)
    assert got["busy_s"] == pytest.approx(80e-6)
    assert got["msm_device_s"] == pytest.approx(40e-6)
    assert got["msm_calls"] == 1 and got["msm_points"] == [131072]
    assert got["device_ops"] == [["k0", pytest.approx(60e-6)],
                                 ["k1", pytest.approx(20e-6)]]
    assert dict(got["idle"]) == pytest.approx({
        "iop/Einsum": 310e-6, "between proofs": 410e-6,
        "batch_opening_reduction": 200e-6})


def test_by_span_splits_the_trace_by_the_programs_spans(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps(_trace(True)))
    got = spans.by_span(str(path))
    assert got["device_by_span"] == pytest.approx({
        "iop/Einsum/sumcheck:EinsumProver/rows_points": 20e-6,
        "iop/eval_reduction": 10e-6,
        "batch_opening_reduction/reduction_rounds": 40e-6,
        spans.NO_SPAN: 10e-6})
    assert got["idle_by_span"] == pytest.approx({
        "iop/Einsum": 110e-6, "iop/Einsum/sumcheck:EinsumProver": 200e-6,
        "batch_opening_reduction/reduction_rounds": 200e-6,
        spans.NO_SPAN: 410e-6})
    assert list(got["idle_by_span"])[0] == spans.NO_SPAN
    path.write_text(json.dumps(_trace(False)))
    assert spans.by_span(str(path))["idle_by_span"] == pytest.approx(
        {spans.NO_SPAN: 920e-6})


READING = {
    "proofs": 2, "prove_s": 16.0,
    "phases": {"witness_generation": 0.5, "commit": 0.8, "iop": 12.0,
               "batch_opening_reduction": 3.0, "hyperkzg_open": 0.25},
    "trace": {"window_s": 40.0, "busy_s": 0.8, "msm_device_s": 0.06,
              "msm_calls": 8, "msm_points": [131072, 4096],
              "device_ops": [], "idle": []},
    "imads_per_proof": 6.0e11, "peak": work.peak("NVIDIA H100 80GB HBM3"),
    "spans": {
        "iop": [12.0, 48.0, 1],
        "iop/Einsum": [6.0, 24.0, 24],
        "iop/Einsum/sumcheck:EinsumProver": [4.0, 16.0, 24],
        "iop/Einsum/sumcheck:EinsumProver/rows_points": [0.5, 0.6, 40],
        "iop/Einsum/rows_upload": [0.25, 0.3, 20],
        "iop/Einsum/einsum_bind": [0.75, 0.75, 48],
        "iop/Mul/sumcheck:A+B": [2.0, 8.0, 4],
        "iop/eval_reduction": [0.5, 1.0, 30],
        "batch_opening_reduction": [3.0, 9.0, 1],
        "batch_opening_reduction/reduction_prepare": [1.5, 6.0, 2],
        "batch_opening_reduction/reduction_rounds": [1.25, 2.5, 1],
        "batch_opening_reduction/reduction_rounds/sumcheck:_G": [1.0, 2.0,
                                                                 1]},
    "counters": {"host_field_calls": 60000.0, "iop_rows_bound_card": 3e6,
                 "iop_rows_bound_host": 9e6, "iop_rachecks_card": 1.2e7,
                 "iop_rachecks_host": 4e5, "einsum_bind_elements": 2.1e7,
                 "einsum_bind_card": 2.0e7, "einsum_bind_host": 1.0e6}}


def _read(name: str, reading: dict):
    return cells.reader(name)(reading)


def test_every_reader_on_a_synthetic_reading():
    pk = READING["peak"]
    bound = sum(work.msm_bound_s(n, pk) for n in (131072, 4096))
    expected = {
        "prove_mfu": 100 * 6.0e11 / (16.0 * pk["imad_per_s"]),
        "witness_s": 0.5, "commit_s": 0.8, "iop_s": 12.0,
        "reduction_s": 3.0, "hyperkzg_open_s": 0.25,
        "msm_device_ms": 30.0, "msm_roofline": 100 * bound / 0.06,
        "device_idle_share": 98.0,
        "iop_sumcheck_s": 6.0, "iop_eval_reduction_s": 0.5,
        "iop_rows_s": 0.75, "iop_rows_share": 25.0, "iop_host_cores": 4.0,
        "host_field_calls": 60000.0, "reduction_prepare_s": 1.5,
        "iop_rachecks_share": 100 * 1.2e7 / 1.24e7,
        "iop_einsum_bind_s": 0.75, "einsum_bind_elements": 2.1e7,
        "iop_einsum_bind_share": 100 * 2.0e7 / 2.1e7}
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        names = [m["name"] for m in json.load(f)["per_layer"]]
    assert sorted(names) == sorted(expected)
    for name, want in expected.items():
        assert _read(name, READING) == pytest.approx(want), name


NEW = ["iop_sumcheck_s", "iop_eval_reduction_s", "iop_rows_s",
       "iop_rows_share", "iop_host_cores", "host_field_calls",
       "reduction_prepare_s", "iop_rachecks_share", "iop_einsum_bind_s",
       "einsum_bind_elements", "iop_einsum_bind_share"]


@pytest.mark.parametrize("name", NEW)
def test_a_new_reader_is_none_where_its_span_or_counter_is_missing(name):
    bare = dict(READING, spans={"witness_generation": [0.5, 1.0, 1]},
                counters={"sumcheck_batched_rounds": 3000.0})
    assert _read(name, bare) is None


def test_the_new_readers_read_the_programs_kept_proofs(proved):
    """Without ``spans`` in the reading, the readers take the program's
    last ``proofs`` proofs, and find nothing without a proof."""
    reading = {k: v for k, v in READING.items()
               if k not in ("spans", "counters")}
    reading["proofs"] = 1
    w = spans.window(reading)
    recs = proved[2].records
    iop = [r for r in recs if r.name == "iop"][0]
    assert w["spans"]["iop"][0] == pytest.approx(
        (iop.end_ns - iop.start_ns) * 1e-9)
    assert w["counters"] == pytest.approx(proved[2].counters)
    for name in NEW:
        got = _read(name, reading)
        assert got is None if name == "iop_rows_s" else got >= 0, name
    assert _read("iop_rows_share", reading) == 0.0
    assert spans.window(dict(reading, proofs=0)) is None
