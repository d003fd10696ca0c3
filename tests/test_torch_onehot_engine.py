"""The one-hot read-check engine (jolt_atlas_tpu_torch/device/onehot.py)
against the host path and the reference, on the CPU, where every kernel
wrapper runs its plain version (the engine's scope entered, as the prover
enters it where the rows gate is forced).

- one batch of each class of the benchmark's nanoGPT and of Gather, (K, D,
  T) = (16, 14, 4096), (16, 9, 64), (16, 26, 64), (128, 1, 64): a
  Booleanity over D chunk rows and read checks of every table kind with K
  entries (the hamming weight of each row, then identity, msb, eq0, ltc,
  lut, onesN and the rest), one of them with a claim that is not the true
  sum (the hint p(1) = claim - p(0) carries it). The engine's
  SumcheckInstanceProof bytes, challenges, accumulator openings and
  transcript state equal the host path's;
- the BENCH_SMALL nanoGPT and a small MLP proved with the engine engaged
  (telemetry shows it): the reference package's proof bytes, and both
  verifiers accept;
- each decline (a mixed batch, a zero coordinate of r_b) is counted with
  its reason and gives the host path's bytes; in zk mode or under a mesh
  scope the prover enters no read-check scope (nor, under a mesh, the
  rows and bind engines'), records why, and gives the host path's bytes;
- the plain kernels' state against a direct computation: the bucket sums
  and the eq tables.

Tolerance: exact everywhere.
"""

import contextlib

import numpy as np
import pytest
import torch

from examples.nanogpt_style import build_model as ref_build_nanogpt
from jolt_atlas_tpu import serde as ref_serde
from jolt_atlas_tpu.frontend import ModelBuilder as RefBuilder
from jolt_atlas_tpu.preprocessing import AtlasPreprocessing as RefPP
from jolt_atlas_tpu.prover import AtlasProver as RefProver
from jolt_atlas_tpu.frontend.quantize import quantize_tensor
from jolt_atlas_tpu.verifier import AtlasVerifier as RefVerifier
from jolt_atlas_tpu_torch import serde
from jolt_atlas_tpu_torch.device import onehot as O
from jolt_atlas_tpu_torch.device import rows as drows
from jolt_atlas_tpu_torch.device import split, telemetry
from jolt_atlas_tpu_torch.field.constants import FR_MODULUS
from jolt_atlas_tpu_torch.field.scalar import Fr
from jolt_atlas_tpu_torch.ids import CommittedPoly, SumcheckId
from jolt_atlas_tpu_torch.poly.eq import eq_evals
from jolt_atlas_tpu_torch.poly.opening import ProverOpeningAccumulator
from jolt_atlas_tpu_torch.prover import AtlasProver
from jolt_atlas_tpu_torch.subprotocols import onehot
from jolt_atlas_tpu_torch.subprotocols.sumcheck import BatchedSumcheck
from jolt_atlas_tpu_torch.transcripts import Blake2bTranscript
from jolt_atlas_tpu_torch.verifier import AtlasVerifier
from test_torch_srs import port_pp, reference_native

# the suite runs in several worker processes at once: a small intra-op
# pool keeps this file from starving its neighbours' timed tests
torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def _host_engines():
    """The reference's csrc engine loaded before a fixture here builds a
    reference SRS, and the csrc host engines' OpenMP threads capped at 2
    while this file runs."""
    reference_native()
    split.set_host_threads(2)
    yield
    split.set_host_threads(None)


# ---------------------------------------------------------------------------
# one batch, engine against host path
# ---------------------------------------------------------------------------

CLASSES = [(16, 14, 4096), (16, 9, 64), (16, 26, 64), (128, 1, 64)]

SPECS = ["identity", "msb", "notmsb", "eq0", "eq15", ("ltc", 11),
         ("eqc", 3), ("lut", (7, -2, 0, 250, 9, 1, 1, 3, 5)),
         ("onesN", 16), ("identN", 16), ("onesN", 128), ("identN", 128),
         ("lut", tuple(range(-40, 60)))]


def _batch(K, D, T, seed, transcript, zero_at=None, extra=None):
    """A read-check batch as build_ra_checks_provers makes one: the
    Booleanity first, a hamming-weight check of each row, then a check of
    each table kind with K entries on a row in turn (the last one's claim
    off by one). zero_at: a coordinate of r_b set to zero."""
    gen = np.random.default_rng(seed)
    logK, logT = K.bit_length() - 1, T.bit_length() - 1
    idx = [gen.integers(0, K, size=T).astype(np.int64) for _ in range(D)]
    idx[0][:2] = (0, K - 1)
    ids = [CommittedPoly.make("GatherRaD", 900 + seed, d) for d in range(D)]
    gammas = transcript.challenge_vector(D)
    r_b = transcript.challenge_vector_optimized(logK + logT)
    if zero_at is not None:
        r_b[zero_at] = Fr.zero()
    r_cycle = transcript.challenge_vector_optimized(logT)
    b = onehot.BooleanityProver(ids, idx, K, r_b, gammas)
    reads = onehot.CycleReads(b.idx, r_cycle, K)
    out = [b]
    sid = SumcheckId.make("Raf")
    hamming = "one" if K == 16 else ("onesN", K)
    for d in range(D):
        out.append(onehot.AddressReadCheckProver(
            ids[d], sid, hamming, reads, d, Fr.one(), appends_opening=True))
    kinds = [s for s in SPECS if len(onehot.table_vec(s)) == K]
    eq = eq_evals(r_cycle)
    for i, spec in enumerate(kinds):
        d = i % D
        G = onehot.compute_G(idx[d], eq, K).to_fr_list()
        claim = Fr.zero()
        for g, v in zip(G, onehot.table_vec(spec)):
            claim = claim + g * Fr(int(v))
        if i == len(kinds) - 1:
            claim = claim + Fr.one()
        out.append(onehot.AddressReadCheckProver(
            ids[d], sid, spec, reads, d, claim, appends_opening=False))
    return out + (extra or [])


def _prove(instances_of, engine: bool):
    """(proof bytes, challenges, openings, transcript state, scope) of one
    BatchedSumcheck.prove, under a forced engine scope or none."""
    t = Blake2bTranscript(b"rachecks")
    acc = ProverOpeningAccumulator()
    instances = instances_of(t)
    sc = O.Scope("cpu") if engine else None
    with sc or contextlib.nullcontext():
        proof, r = BatchedSumcheck.prove(instances, acc, t)
    openings = {k: ([x.v for x in pt], c.v)
                for k, (pt, c) in acc.openings.items()}
    return proof.serialize(), [x.v for x in r], openings, t.state, sc


@pytest.mark.parametrize("K,D,T", CLASSES)
def test_engine_equals_host_path(K, D, T):
    make = lambda t: _batch(K, D, T, K + D + T, t)
    host = _prove(make, False)
    telemetry.reset()
    got = _prove(make, True)
    assert got[:4] == host[:4]
    sc = got[4]
    assert (sc.offered, sc.engaged, sc.declined) == (1, 1, {})
    tele = telemetry.snapshot()
    M = K.bit_length() + T.bit_length() - 2
    assert tele["decisions"]["rachecks"] == (
        f"ENGAGED (1 of 1 batches, {D * T} one-hot elements, {M + 3} "
        f"dispatches)")
    assert tele["counters"]["iop_rachecks_card"] == D * T
    assert "iop_rachecks_host" not in tele["counters"]
    assert tele["counters"]["iop_rows_bound_card"] == D * (2 * T - 2)
    assert tele["launches"] == {}  # CPU tensors: plain versions only
    assert len(host[2]) == 2 * D  # the Booleanity's D, the hamming D


# ---------------------------------------------------------------------------
# the declines
# ---------------------------------------------------------------------------

def _mixed(t):
    """A read-check batch with one more instance of another class."""
    insts = _batch(16, 3, 16, 5, t)
    b = insts[0]
    rc = onehot.EqPairCheckProver(
        b.poly_ids[0], b.poly_ids[1], SumcheckId.make("Raf"), b.idx[0],
        b.idx[1], insts[1].r_cycle, Fr(3))
    return insts + [rc]


@pytest.mark.parametrize("why", ["mixed batch", "zero coordinate of r_b"])
def test_decline_gives_host_path_bytes(why):
    make = {"mixed batch": _mixed,
            "zero coordinate of r_b":
                lambda t: _batch(16, 4, 16, 7, t, zero_at=5)}[why]
    host = _prove(make, False)
    telemetry.reset()
    got = _prove(make, True)
    assert got[:4] == host[:4]
    sc = got[4]
    assert (sc.offered, sc.engaged, sc.declined) == (1, 0, {why: 1})


@pytest.mark.parametrize("why", ["zk mode", "mesh scope"])
def test_prover_enters_no_card_scope_under_zk_or_a_mesh(why, monkeypatch):
    """A prover whose rows gate is forced (every IOP card engine would run
    on the CPU) in zk mode or under a mesh scope: it enters none of the
    scopes that rules out (zk mode: the read-check engine's; a mesh: all
    three), records why once for each, and gives the host path's bytes
    (zk proofs under one seeded blinding stream)."""
    from jolt_atlas_tpu_torch.examples.nanogpt_style import seeded_blinding
    from jolt_atlas_tpu_torch.parallel import make_mesh, mesh_scope
    model, inputs = _mlp()
    pp = port_pp(model, RefPP.preprocess(model))
    entered = []
    real = telemetry.EngineScope.__enter__
    monkeypatch.setattr(telemetry.EngineScope, "__enter__",
                        lambda self: entered.append(self.ENGINE)
                        or real(self))

    def prove(prover):
        del entered[:]
        telemetry.reset()
        if why == "zk mode":
            with seeded_blinding(7):
                return serde.serialize_proof(prover.prove_zk(inputs)[0])
        with mesh_scope(make_mesh(2, device="cpu")):
            return serde.serialize_proof(prover.prove(inputs)[0])
    host = prove(AtlasProver(pp, device="cpu"))
    got = prove(AtlasProver(pp, device="cpu", iop_gate=drows.forced()))
    d = telemetry.snapshot()["decisions"]
    if why == "zk mode":
        out, reason = ["rachecks"], "zk mode"
        assert {"iop", "einsum_bind"} <= set(entered)
    else:
        out, reason = ["iop", "rachecks", "einsum_bind"], "mesh scope active"
        assert entered == ["mesh_iop"]
    assert not set(out) & set(entered)
    assert all(d[engine] == reason for engine in out)
    assert got == host


def test_scope_records_its_decisions():
    telemetry.reset()
    assert O.Scope("cuda").device.type == "cuda"  # no card needed
    telemetry.tally("iop_rachecks_card", 11)  # before the scope: not its
    with O.Scope("cpu") as sc:
        assert O.Scope.entered is sc
        sc.offered, sc.engaged = 3, 2
        telemetry.tally("iop_rachecks_card", 5)
        telemetry.count("rachecks", 7)
        sc.decline("mixed batch")
    d = telemetry.snapshot()["decisions"]
    assert d["rachecks"] == ("ENGAGED (2 of 3 batches, 5 one-hot "
                             "elements, 7 dispatches)")
    assert d["rachecks:declined"] == "mixed batch: 1"
    assert O.Scope.entered is None


def test_other_batches_are_not_offered():
    """A batch of no read-check class never reaches the engine."""
    t = Blake2bTranscript(b"x")
    insts = _mixed(t)[-1:]
    with O.Scope("cpu") as sc:
        assert O.try_prove(insts, ProverOpeningAccumulator(), t) is None
    assert sc.offered == 0


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------

def _bench_small():
    rng = np.random.default_rng(1234)
    model = ref_build_nanogpt(32, 8, 16, 1, 8, rng, heads=1)
    return model, [rng.integers(0, 32, size=8).astype(np.int32)]


def _mlp():
    """input -> matmul -> bias -> relu -> matmul -> relu."""
    rng = np.random.default_rng(31)
    s = 8
    b = RefBuilder(scale=s)
    x = b.input([1, 16])
    h = b.matmul(x, b.constant(quantize_tensor(
        rng.normal(size=(16, 8)) * .5, s)))
    h = b.relu(b.add(h, b.constant(quantize_tensor(
        rng.normal(size=(1, 8)) * .1, s))))
    b.output(b.relu(b.matmul(h, b.constant(quantize_tensor(
        rng.normal(size=(8, 4)) * .5, s)))))
    return b.build(), [quantize_tensor(rng.normal(size=(1, 16)), s)]


@pytest.fixture(scope="module", params=["bench_small", "mlp"])
def case(request):
    model, inputs = {"bench_small": _bench_small, "mlp": _mlp}[
        request.param]()
    ref_pp = RefPP.preprocess(model)
    ref_bytes = ref_serde.serialize_proof(RefProver(ref_pp).prove(inputs)[0])
    return ref_pp, port_pp(model, ref_pp), inputs, ref_bytes


def test_forced_engine_gives_reference_bytes(case):
    ref_pp, pp, inputs, ref_bytes = case
    telemetry.reset()
    proof, io = AtlasProver(pp, device="cpu",
                            iop_gate=drows.forced()).prove(inputs)
    tele = telemetry.snapshot()
    assert tele["decisions"]["rachecks"].startswith("ENGAGED")
    assert tele["counters"]["iop_rachecks_card"] > 0
    blob = serde.serialize_proof(proof)
    assert blob == ref_bytes
    assert AtlasVerifier(pp).verify(serde.deserialize_proof(blob), io)
    ref_io = tuple([np.asarray(t) for t in part] for part in io)
    assert RefVerifier(ref_pp).verify(ref_serde.deserialize_proof(blob),
                                      ref_io)


# ---------------------------------------------------------------------------
# the plain kernels' state
# ---------------------------------------------------------------------------

def _fr(row) -> int:
    return O._fr_rows(np.asarray(row).reshape(1, 4))[0].v


def test_plain_setup_tables_and_buckets():
    """prepare and buckets: eq(r_cycle), the E and A tables and the bucket
    sums GB, H against big-int sums; U all ones, es one."""
    gen = np.random.default_rng(3)
    b = O.random_batch(16, 3, 32, 5, gen, "cpu")
    O.prepare(b)
    O.buckets(b)
    lay, ws = b.lay, b.ws
    R = pow(2, 256, FR_MODULUS)
    mont = lambda off: _fr(ws[off]) * pow(R, -1, FR_MODULUS) % FR_MODULUS
    stage = lambda off: _fr(ws[off])
    rb = [stage(lay.stage + i) for i in range(lay.M)]
    rc = [stage(lay.stage + lay.M + i) for i in range(lay.logT)]

    def eq(ch, x):
        p = 1
        for i, c in enumerate(ch):
            bit = (x >> (len(ch) - 1 - i)) & 1
            p = p * (c if bit else 1 - c) % FR_MODULUS
        return p
    assert [mont(lay.eqC + j) for j in range(lay.T)] == \
        [eq(rc, j) for j in range(lay.T)]
    off = 0
    for s in range(lay.logK, lay.M + 1):
        assert [mont(lay.E + off + x) for x in range(1 << (lay.M - s))] == \
            [eq(rb[s:], x) for x in range(1 << (lay.M - s))]
        off += 1 << (lay.M - s)
    off = 0
    for lv in range(lay.logK):
        n = 1 << (lay.logK - lv - 1)
        assert [mont(lay.A + off + x) for x in range(n)] == \
            [eq(rb[lv + 1:lay.logK], x) for x in range(n)]
        off += n
    idx = b.idx.reshape(lay.D, lay.T).numpy()
    for d in range(lay.D):
        for k in range(lay.K):
            js = np.nonzero(idx[d] == k)[0]
            assert mont(lay.GB + d * lay.K + k) == \
                sum(eq(rc, j) for j in js) % FR_MODULUS
            assert mont(lay.H + d * lay.K + k) == \
                sum(eq(rb[lay.logK:], j) for j in js) % FR_MODULUS
    assert all(mont(lay.U + k) == 1 for k in range(lay.K))
    assert mont(lay.es) == 1


def test_layout_fields_match_the_kernel():
    """29 fields in the kernel's order; regions that do not overlap."""
    lay = O.Layout(16, 64, 9, 40, 7)
    assert len(O.FIELDS) == 29 and len(lay.fields()) == 29
    assert lay.blocks == O.booleanity_blocks(lay, lay.logK) == \
        -(-9 * 32 // O.THREADS)
    offs = [getattr(lay, f) for f in O.FIELDS[9:]]
    assert offs == sorted(offs) and offs[0] == 0
    assert lay.rows == lay.out + max(4, 2 * lay.D)
