"""The port's IOP rows engine (jolt_atlas_tpu_torch/device/rows.py) against
the reference, on the CPU, where every kernel wrapper runs its plain
version.

- the plain points (kernel 7's function) against the reference's host
  engine, jolt_atlas_tpu.field.frvec.GruenInstance.round_points, over a
  grid of row counts, term structures (repeated factors, a constant term,
  coefficient one), point counts (1, 2, 3 = the degenerate eq line's dq +
  1, 6, 20), an all-zero row, and every weight layout SplitEq gives (split,
  prefix-eq, suffix-eq, wlo only, none, a folded one-row whi, a shift past
  the pairs);
- the plain rows bind (kernel 4 with P continuing lanes) against big-int
  lo + c (hi - lo);
- the engine's sequence, DeviceGruen with the plain versions: points,
  bind, points, bind, the handoff, the host rounds and row_value, against
  the reference's host engine driven by the same split-eq tables and
  challenges;
- one direct check against the reference's parallel/shardedrows.py
  MeshGruen on a 1-device CPU mesh at the smallest shape;
- proof bytes with AtlasProver(iop_gate=forced()) on the BENCH_SMALL
  nanoGPT and on tests/test_multichip.py's one-block transformer: equal to
  the reference's AtlasProver(pp).prove, a spy on try_setup shows the
  engine engaged, the port's verifier accepts and rejects a tampered
  proof;
- the gate: its reasons, and that the opening reduction's rows never reach
  the engine.

Tolerance: exact everywhere.
"""

import numpy as np
import pytest
import torch

from examples.nanogpt_style import build_model as ref_build_nanogpt
from jolt_atlas_tpu import serde as ref_serde
from jolt_atlas_tpu.field import frvec as ref_frvec
from jolt_atlas_tpu.field.constants import FR_MODULUS
from jolt_atlas_tpu.field.scalar import Fr as RefFr
from jolt_atlas_tpu.preprocessing import AtlasPreprocessing as RefPP
from jolt_atlas_tpu.prover import AtlasProver as RefProver
from jolt_atlas_tpu_torch import convert, serde
from jolt_atlas_tpu_torch.curve.points import g1_generator
from jolt_atlas_tpu_torch.device import rows as R
from jolt_atlas_tpu_torch.device import split, telemetry
from jolt_atlas_tpu_torch.device.reduction import fr_of_row, mont_rows
from jolt_atlas_tpu_torch.field.frvec import FrArray, GruenInstance
from jolt_atlas_tpu_torch.field.scalar import Fr
from jolt_atlas_tpu_torch.poly.mlpoly import MLPoly
from jolt_atlas_tpu_torch.poly.spliteq import SplitEq
from jolt_atlas_tpu_torch.preprocessing import AtlasPreprocessing
from jolt_atlas_tpu_torch.prover import AtlasProver
from jolt_atlas_tpu_torch.subprotocols.sumcheck import RowsInstance
from jolt_atlas_tpu_torch.verifier import AtlasVerifier

# the suite runs in several worker processes at once: a small intra-op
# pool keeps this file from starving its neighbours' timed tests
torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def _few_host_threads():
    split.set_host_threads(2)
    yield
    split.set_host_threads(None)


def _u64_rows(x: torch.Tensor, P: int, n: int) -> list[np.ndarray]:
    flat = x.numpy().view(np.uint64).reshape(P, n, 4)
    return [np.ascontiguousarray(flat[p]) for p in range(P)]


def _ref_terms(terms):
    return [(RefFr(c.v), list(f)) for c, f in terms]


# ---------------------------------------------------------------------------
# kernel 7's function against the reference's host engine
# ---------------------------------------------------------------------------

# (P, n, terms, most factors, nevals): the bench's classes at small n (27
# rows, 36 terms, 6 factors, 6 points; 23 / 62 / 2 / 3; 3 / 1 / 3 / 3), the
# caps (96 rows, 20 points), one row, the degenerate line's dq + 1 = 3
POINTS_CASES = [
    (1, 2, 1, 1, 1), (1, 8, 1, 1, 2), (2, 16, 3, 2, 3), (3, 8, 1, 3, 3),
    (5, 32, 6, 4, 6), (27, 16, 36, 6, 6), (23, 8, 62, 2, 3),
    (96, 4, 8, 5, 2), (4, 4, 5, 3, 20), (7, 16, 11, 1, 2),
]


@pytest.mark.parametrize("P,n,T,mf,nevals", POINTS_CASES)
def test_plain_points_match_reference_host(P, n, T, mf, nevals):
    gen = np.random.default_rng(100 * P + n + nevals)
    x = R.random_rows_for(P, n, gen, "cpu")
    terms = R.random_terms(P, T, mf, gen)
    ref = ref_frvec.GruenInstance(
        [ref_frvec.FrArray(r) for r in _u64_rows(x, P, n)],
        _ref_terms(terms), nevals)
    dev_terms = R.Terms(terms, "cpu")
    for kind in R.WEIGHT_KINDS:
        whi, shift, wlo, log_wlo = R.random_weights(n, kind, gen)
        w = R.weights(whi, shift, wlo, log_wlo, "cpu")
        got = R.points(x, n, nevals, dev_terms, w)
        want = ref.round_points(nevals, whi, shift, wlo, log_wlo)
        assert np.array_equal(got.numpy().view(np.uint64),
                              np.asarray(want.d)), kind


def test_points_wrapper_refuses_bad_shapes():
    gen = np.random.default_rng(3)
    x = R.random_rows_for(2, 8, gen, "cpu")
    terms = R.Terms([(Fr.one(), [0, 2])], "cpu")  # row 2 of 2
    w = R.weights(None, 0, None, -1, "cpu")
    with pytest.raises(ValueError, match="over rows"):
        R.points(x, 8, 2, terms, w)
    ok = R.Terms([(Fr.one(), [0, 1])], "cpu")
    with pytest.raises(ValueError, match="nevals"):
        R.points(x, 8, 21, ok, w)
    with pytest.raises(ValueError, match="power of two"):
        R.points(x, 6, 2, ok, w)
    assert telemetry.launches().get("rows_points", 0) == 0


@pytest.mark.parametrize("P,n", [(1, 2), (3, 4), (27, 16)])
def test_plain_rows_bind_is_lo_plus_c_hi_minus_lo(P, n):
    gen = np.random.default_rng(7 * P + n)
    x = R.random_rows_for(P, n, gen, "cpu")
    c = Fr(int.from_bytes(gen.bytes(32), "little") % FR_MODULUS)
    got = R.bind_rows(x, torch.from_numpy(mont_rows([c])), n)
    vals = [fr_of_row(r) for r in x.numpy()]
    half = n // 2
    want = [vals[p * n + j] + c * (vals[p * n + half + j] - vals[p * n + j])
            for p in range(P) for j in range(half)]
    assert [fr_of_row(r) for r in got.numpy()] == want


I64_EDGES = [0, 1, -1, 2, -2, (1 << 63) - 1, -(1 << 63), 1 << 62,
             -(1 << 62) - 7, 65535, -65536, 1 << 32]


@pytest.mark.parametrize("kind", ["edges", "small", "full"])
def test_plain_from_i64_matches_reference(kind):
    """Kernel 8's function: int64 values in Montgomery form, equal to the
    reference's host FrArray.from_i64 and to big-int v R mod r."""
    gen = np.random.default_rng(len(kind))
    v = {"edges": np.array(I64_EDGES, dtype=np.int64),
         "small": gen.integers(-(1 << 16), 1 << 16, size=300),
         "full": gen.integers(-(1 << 63), (1 << 63) - 1, size=300,
                              dtype=np.int64, endpoint=True)}[kind]
    got = R.from_i64(torch.from_numpy(v.astype(np.int64)))
    assert np.array_equal(got.numpy().view(np.uint64),
                          ref_frvec.FrArray.from_i64(v).d)
    assert [fr_of_row(r).v for r in got.numpy()] == [
        int(x) % FR_MODULUS for x in v]


def test_upload_mixes_integer_and_field_rows():
    """A row of small integers goes up as int64 and is converted on the
    device (the plain version here); a field row as it is."""
    gen = np.random.default_rng(4)
    ints = gen.integers(-1000, 1000, size=16)
    field = R.random_rows_for(1, 16, gen, "cpu").numpy().view(np.uint64)
    x = R.upload([ints, FrArray(field.copy()), ints.astype(np.int32)], "cpu")
    want = np.concatenate([FrArray.from_i64(ints).d, field,
                           FrArray.from_i64(ints).d])
    assert np.array_equal(x.numpy().view(np.uint64), want)
    assert np.array_equal(R.upload([ints], "cpu").numpy().view(np.uint64),
                          FrArray.from_i64(ints).d)


def test_cuda_r2_constant():
    """csrc/rows.cu's R^2 mod r, kernel 8's multiplier."""
    import os
    import re
    src = open(os.path.join(os.path.dirname(R.__file__), "..", "csrc",
                            "rows.cu")).read()
    m = re.search(r"R2\[8\] = \{([^}]*)\}", src)
    limbs = [int(x.strip().rstrip("u"), 16) for x in m.group(1).split(",")]
    assert sum(v << (32 * i) for i, v in enumerate(limbs)) == pow(
        2, 512, FR_MODULUS)


# ---------------------------------------------------------------------------
# the engine's sequence against the reference's host engine
# ---------------------------------------------------------------------------

def _message_nevals(se: SplitEq, rnd: int, degree: int) -> int:
    """The point count RowsInstance._gruen_message asks for."""
    lin = se.l_linear(rnd)
    if lin is None:
        return max(1, degree)
    dq = max(1, degree - 1)
    return dq + 1 if lin[1].is_zero() else dq


@pytest.mark.parametrize("layout,head", [
    ("suffix", 2), ("pre2", 2), ("post3", 2), ("suffix", 1),
    ("suffix", 6), ("zero_coord", 2), ("int_rows", 2)])
def test_engine_sequence_matches_reference_host(layout, head):
    """DeviceGruen (plain versions) and the reference's host engine take
    the same tables and challenges: every round's points and the final row
    values are equal; ``head`` >= the round count runs to n = 1 on the
    device before the handoff."""
    gen = np.random.default_rng(len(layout) + head)
    P, n, degree = 3, 32, 4
    nv = 5
    pre = 2 if layout == "pre2" else 0
    post = 3 if layout == "post3" else 0
    rand = lambda: Fr(int.from_bytes(gen.bytes(32), "little") % FR_MODULUS)
    eq_r = [rand() for _ in range(nv - pre - post)]
    if layout == "zero_coord":
        eq_r[0] = Fr.zero()  # l1 = 0 in round 0: one more point
    terms = [(Fr.one(), [0, 1, 2]), (rand(), [1, 1]), (rand(), [])]
    x = R.random_rows_for(P, n, gen, "cpu")
    rows = _u64_rows(x, P, n)
    dev_rows = [FrArray(r) for r in rows]
    ref_rows = [ref_frvec.FrArray(r) for r in rows]
    if layout == "int_rows":  # small integers, as the host takes them
        ints = [gen.integers(-300, 300, size=n) for _ in range(P)]
        dev_rows = ref_rows = ints
    dev = R.DeviceGruen(dev_rows, terms, degree, torch.device("cpu"), head)
    ref = ref_frvec.GruenInstance(ref_rows, _ref_terms(terms), degree)
    se = SplitEq(eq_r, pre_vars=pre, post_vars=post)
    for rnd in range(nv):
        nevals = _message_nevals(se, rnd, degree)
        tabs = se.tables(rnd)
        got = dev.round_points(nevals, *tabs)
        want = ref.round_points(nevals, *tabs)
        assert np.array_equal(np.asarray(got.d), np.asarray(want.d)), rnd
        on_device = dev._host is None
        assert on_device == (rnd < head)
        r = rand()
        dev.bind(r)
        ref.bind(RefFr(r.v))
        se.note_challenge(r, rnd)
    assert dev._host is not None
    for p in range(P):
        assert dev.row_value(p).v == ref.row_value(p).v


def test_direct_against_reference_mesh_gruen():
    """The reference's MeshGruen on a 1-device CPU mesh and DeviceGruen on
    the same rows, terms, tables and challenges: equal points in both head
    rounds and equal row values after the handoff."""
    from jolt_atlas_tpu.parallel.mesh import make_mesh
    from jolt_atlas_tpu.parallel.shardedrows import MeshGruen
    gen = np.random.default_rng(11)
    P, n, degree = 2, 8, 3
    x = R.random_rows_for(P, n, gen, "cpu", zero_row=False)
    rows = _u64_rows(x, P, n)
    terms = [(Fr.one(), [0, 1]), (Fr(5), [])]
    mesh = MeshGruen(make_mesh(1), [ref_frvec.FrArray(r) for r in rows],
                     _ref_terms(terms), degree)
    dev = R.DeviceGruen([FrArray(r) for r in rows], terms, degree,
                        torch.device("cpu"), 2)
    se = SplitEq([Fr(3), Fr(9), Fr(4)])
    for rnd in range(3):
        tabs = se.tables(rnd)
        nevals = _message_nevals(se, rnd, degree)
        got = dev.round_points(nevals, *tabs)
        want = mesh.round_points(nevals, *tabs)
        assert [got.item(i).v for i in range(nevals)] == \
            [w.v for w in want], rnd
        r = Fr(1000 + rnd)
        dev.bind(r)
        mesh.bind(RefFr(r.v))
        se.note_challenge(r, rnd)
    assert [dev.row_value(p).v for p in range(P)] == \
        [mesh.row_value(p).v for p in range(P)]


# ---------------------------------------------------------------------------
# proofs
# ---------------------------------------------------------------------------

def _g2(p):
    return (p.x.a, p.x.b, p.y.a, p.y.b)


def _port_pp(ref_model, ref_pp):
    srs = ref_pp.srs
    limbs = np.frombuffer(srs._raw_points, dtype=np.uint64).reshape(-1, 8)
    port_srs = convert.srs_from_arrays(limbs, _g2(srs.g2), _g2(srs.beta_g2),
                                       [_g2(p) for p in srs.g2_powers])
    model = convert.model_from_reference(convert.describe_model(ref_model))
    return AtlasPreprocessing(model, port_srs)


def _bench_small():
    """bench.py's BENCH_SMALL nanoGPT: vocab 32, seq 8, d16, 1 block."""
    rng = np.random.default_rng(1234)
    model = ref_build_nanogpt(32, 8, 16, 1, 8, rng, heads=1)
    return model, [rng.integers(0, 32, size=8).astype(np.int32)]


def _transformer_block():
    """tests/test_multichip.py's one-block transformer (gather, softmax,
    tanh teleport), its weights drawn from a fresh generator of that
    file's seed."""
    import test_multichip as tm
    saved = tm.rng
    tm.rng = np.random.default_rng(0x3E5)
    try:
        model, toks = tm._transformer_block()
    finally:
        tm.rng = saved
    return model, [toks]


@pytest.fixture(scope="module", params=["bench_small", "transformer_block"])
def case(request):
    """(port pp, inputs, the reference's proof bytes)."""
    model, inputs = {"bench_small": _bench_small,
                     "transformer_block": _transformer_block}[
        request.param]()
    ref_pp = RefPP.preprocess(model)
    ref_bytes = ref_serde.serialize_proof(RefProver(ref_pp).prove(inputs)[0])
    return _port_pp(model, ref_pp), inputs, ref_bytes


def test_forced_engine_bytes_equal_reference(case, monkeypatch):
    pp, inputs, ref_bytes = case
    engaged = []
    real = R.try_setup

    def spy(rows, terms, degree):
        got = real(rows, terms, degree)
        if got is not None:
            engaged.append((len(rows), len(rows[0])))
        return got
    monkeypatch.setattr(R, "try_setup", spy)
    telemetry.reset()
    proof, io = AtlasProver(pp, device="cpu", iop_gate=R.forced()).prove(
        inputs)
    tele = telemetry.snapshot()
    assert engaged, "the rows engine did not engage on any instance"
    assert tele["decisions"]["iop"].startswith(
        f"ENGAGED ({len(engaged)} of ")
    assert tele["dispatches"]["iop_rows"] >= 2 * len(engaged)
    assert tele["launches"] == {}  # CPU tensors: plain versions only
    blob = serde.serialize_proof(proof)
    assert blob == ref_bytes
    verifier = AtlasVerifier(pp)
    assert verifier.verify(serde.deserialize_proof(blob), io)
    bad = serde.deserialize_proof(blob)
    pid = sorted(bad.commitments)[0]
    bad.commitments[pid] = bad.commitments[pid] + g1_generator()
    assert not verifier.verify(bad, io)


def test_host_path_records_its_reason(case):
    pp, inputs, ref_bytes = case
    telemetry.reset()
    proof, _ = AtlasProver(pp, device="cpu").prove(inputs)
    assert telemetry.snapshot()["decisions"]["iop"] == \
        "host path (device=cpu)"
    assert serde.serialize_proof(proof) == ref_bytes


# ---------------------------------------------------------------------------
# the gate
# ---------------------------------------------------------------------------

class _Rows(RowsInstance):
    pass


def _polys(P, n, gen):
    return [MLPoly(ints=gen.integers(-50, 50, size=n)) for _ in range(P)]


@pytest.mark.parametrize("P,n,gate,why", [
    (2, 1024, R.RowsGate(forced=True), "n < 2048"),
    (97, 256, R.forced(), "P > 96"),
    (2, 1, R.forced(min_n=1), "n < 2"),
    (2, 8, R.forced(head_rounds=0), "no head rounds"),
    (2, 4096, R.RowsGate(forced=True), "work < 1048576"),
])
def test_gate_declines_with_its_reason(P, n, gate, why):
    """try_setup, offered rows as setup_rows converts them, declines and
    counts the reason (setup_rows offers no more than 96 rows)."""
    gen = np.random.default_rng(P + n)
    rows = [gen.integers(-50, 50, size=n) for _ in range(P)]
    telemetry.reset()
    with R.IopScope(torch.device("cpu"), gate) as sc:
        assert R.try_setup(rows, [(Fr.one(), [0, 1])], 3) is None
    assert (sc.offered, sc.engaged, sc.declined) == (1, 0, {why: 1})
    tele = telemetry.snapshot()["decisions"]
    assert tele["iop"] == "none engaged (1 instances offered)"
    assert tele["iop:declined"] == f"{why}: 1"


def test_declined_instance_runs_on_host():
    """Under the default gate, a one-term instance of 4,096 elements a row
    (work 2,048 x 2 x 3 < 2^20) is declined and set up on the host engine,
    and its messages equal those of a set-up outside any scope."""
    gen = np.random.default_rng(17)
    polys = _polys(2, 4096, gen)
    eq_r = [Fr(3 + k) for k in range(12)]
    a, b = _Rows(), _Rows()
    with R.IopScope(torch.device("cpu"), R.RowsGate(forced=True)) as sc:
        a.setup_rows(polys, [(Fr.one(), [0, 1])], 3, eq_r=eq_r)
    b.setup_rows(polys, [(Fr.one(), [0, 1])], 3, eq_r=eq_r)
    assert isinstance(a._gruen, GruenInstance)
    assert sc.declined == {"work < 1048576": 1}
    for k in range(3):
        assert [c.v for c in a.rows_message(Fr(k)).coeffs] == \
            [c.v for c in b.rows_message(Fr(k)).coeffs]
        a.rows_bind(Fr(5 + k))
        b.rows_bind(Fr(5 + k))


def test_gate_engages_on_eq_rows_only():
    """Inside a scope an instance with eq_r engages; one without eq_r
    is never offered; outside any scope nothing engages."""
    gen = np.random.default_rng(9)
    with R.IopScope(torch.device("cpu"), R.forced()) as sc:
        a, b = _Rows(), _Rows()
        a.setup_rows(_polys(2, 16, gen), [(Fr.one(), [0, 1])], 3,
                     eq_r=[Fr(3)] * 4)
        b.setup_rows(_polys(2, 16, gen), [(Fr.one(), [0, 1])], 2)
    assert isinstance(a._gruen, R.DeviceGruen) and b._gruen is None
    assert (sc.offered, sc.engaged, sc.elements) == (1, 1, 32)
    c = _Rows()
    c.setup_rows(_polys(2, 16, gen), [(Fr.one(), [0, 1])], 3,
                 eq_r=[Fr(3)] * 4)
    assert isinstance(c._gruen, GruenInstance)


def test_default_gate_per_device():
    """None: the host path on a CPU device (with its reason), a scope on a
    CUDA device (no card needed to build it), default caps."""
    telemetry.reset()
    assert R.iop_scope("cpu") is None
    assert telemetry.snapshot()["decisions"]["iop"] == \
        "host path (device=cpu)"
    sc = R.iop_scope("cuda")
    assert (sc.gate.head_rounds, sc.gate.min_n, sc.gate.min_work,
            sc.gate.forced) == (2, 2048, 1 << 20, False)
    # work: 1,024 pairs x factors x 20 points against 2^20
    assert sc.gate.decline(96, 2048, 20, 52) is None
    assert sc.gate.decline(96, 2048, 20, 51) == "work < 1048576"
    assert (R.forced().head_rounds, R.forced().min_work) == (2, 0)


def test_opening_reduction_rows_never_engage(monkeypatch):
    """A forced engine on a small MLP: every instance the opening
    reduction sets up on the host is set up outside the IOP scope."""
    from jolt_atlas_tpu_torch.frontend import ModelBuilder
    from jolt_atlas_tpu_torch.poly import opening
    b = ModelBuilder(scale=8)
    x = b.input((1, 16))
    rng = np.random.default_rng(5)
    w = b.constant(rng.integers(-60, 60, size=(16, 16)).astype(np.int32))
    b.output(b.relu(b.einsum("bi,ij->bj", [x, w])))
    pp = AtlasPreprocessing.preprocess(b.build())
    seen = []
    real = opening._GroupReductionProver.setup_sumcheck

    def spy(self):
        seen.append(R.active())
        return real(self)
    monkeypatch.setattr(opening._GroupReductionProver, "setup_sumcheck", spy)
    xs = rng.integers(-100, 100, size=(1, 16)).astype(np.int32)
    telemetry.reset()
    AtlasProver(pp, device="cpu", iop_gate=R.forced()).prove([xs])
    assert seen and all(s is None for s in seen)
    assert telemetry.snapshot()["decisions"]["iop"].startswith("ENGAGED")
