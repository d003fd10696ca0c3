"""The port's CUDA kernels against their plain PyTorch versions, on the card.

This file imports only numpy, torch and the port (no JAX, no reference), so
it also runs on a GPU machine that has no JAX, without the suite's
conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Without a CUDA device every test skips. Tolerance: exact (bit-equal limbs,
equal affine points, equal digests and proof bytes). A forced gate
(device/gate.py, device/reduction.py, device/rows.py) picks each MSM,
reduction and IOP rows path.
"""

import numpy as np
import pytest
import torch

from jolt_atlas_tpu_torch.commitment.kzg import KZGSRS
from jolt_atlas_tpu_torch.curve.native import pack_scalars
from jolt_atlas_tpu_torch.device import curve, gate, split
from jolt_atlas_tpu_torch.device import blake2b as db, msm as dmsm
from jolt_atlas_tpu_torch.device import reduction as dred, telemetry
from jolt_atlas_tpu_torch.field.constants import FR_MODULUS, FR_R_INV

pytestmark = pytest.mark.cuda

N = 2048


@pytest.fixture(scope="module")
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def srs(gpu):
    return KZGSRS.setup(N - 1)


def _equal(got, want):
    torch.cuda.synchronize()
    return all(torch.equal(g, w) for g, w in zip(got, want))


def test_pp_add_kernel_matches_plain(gpu, srs):
    bases = srs.device_bases(gpu, gate.forced("device")).bases
    rng = np.random.default_rng(11)
    i1, i2 = (torch.from_numpy(rng.integers(0, N, size=4096)).to(gpu)
              for _ in range(2))
    P = tuple(b[i1] for b in bases)
    Q = tuple(b[i2] for b in bases)
    before = telemetry.launches().get("pp_add", 0)
    R = curve.pp_add(P, Q)
    assert _equal(R, curve.pp_add_plain(P, Q))
    S = tuple(t.roll(1, 0) for t in R)  # projective inputs (Z != 1)
    assert _equal(curve.pp_add(R, S), curve.pp_add_plain(R, S))
    assert _equal(curve.pp_add(R, R), curve.pp_add_plain(R, R))
    Pe, Qe = curve.edge_case_pairs(gpu)
    assert _equal(curve.pp_add(Pe, Qe), curve.pp_add_plain(Pe, Qe))
    assert telemetry.launches()["pp_add"] - before == 4


def _sms(gpu):
    return torch.cuda.get_device_properties(gpu).multi_processor_count


@pytest.mark.parametrize("c,run", [(6, 16), (6, 5), (12, 16), (12, 3)])
def test_bucket_kernel_matches_plain(gpu, srs, c, run):
    """Kernel 2 against its plain version at a run length: lanes cut by
    runs, empty lanes, and a run that does not divide the entry count."""
    bases = srs.device_bases(gpu, gate.forced("device")).bases
    rng = np.random.default_rng(12)
    packed = pack_scalars([int.from_bytes(rng.bytes(32), "little")
                           % FR_MODULUS for _ in range(N)])
    lanes = dmsm.digit_lanes(dmsm.scalars_tensor(packed, N, gpu), c)
    starts = lanes[2]
    assert bool((starts[1:] == starts[:-1]).any())  # empty lanes
    before = telemetry.launches().get("bucket_accumulate", 0)
    got = dmsm.bucket_accumulate(bases, lanes, run=run)
    assert telemetry.launches()["bucket_accumulate"] - before == 2
    assert _equal(got, dmsm.bucket_accumulate_plain(bases, lanes, run))


@pytest.mark.parametrize("kind", ["random254", "bits16"])
def test_device_msm_matches_host_on_gpu(gpu, srs, kind):
    rng = np.random.default_rng(13)
    if kind == "random254":
        scalars = [int.from_bytes(rng.bytes(32), "little") % FR_MODULUS
                   for _ in range(N)]
        c = 0  # the adaptive window
    else:
        scalars = [int(x) for x in rng.integers(0, 1 << 16, size=N)]
        c = 8  # divides 16: a window straddling bit 16 would be skewed
    packed = pack_scalars(scalars)
    want = srs.prepared_bases().msm_packed(packed, N)
    before = telemetry.launches()
    got = srs.device_bases(gpu, gate.forced("device"), c=c).msm_packed(
        packed, N)
    assert (got.infinity, got.x, got.y) == (want.infinity, want.x, want.y)
    G = dmsm.combine_groups(1, c or dmsm._pick_c(N), _sms(gpu))
    for k, n in (("bucket_accumulate", 2),
                 ("bucket_combine", 2 if G > 1 else 1)):
        assert telemetry.launches()[k] - before.get(k, 0) == n


@pytest.mark.parametrize("k,c", [(3, 6), (1, 12), (2, 14), (1, 14),
                                 (16, 12)])
def test_combine_kernel_matches_plain(gpu, srs, k, c):
    """Kernel 3 against its plain version at the blocks per window the
    card's rule gives (G = 16 for one MSM at c = 14): projective bucket
    sums, a fifth of them the identity, and the add's edge cases (doubling,
    P + (-P), coordinates near p) in the first lanes of every MSM."""
    bases = srs.device_bases(gpu, gate.forced("device")).bases
    W, B, _ = dmsm.window_shape(c)
    L = W * B
    rng = np.random.default_rng(14)
    i1, i2 = (torch.from_numpy(rng.integers(0, N, size=k * L)).to(gpu)
              for _ in range(2))
    acc = curve.pp_add(tuple(b[i1] for b in bases),
                       tuple(b[i2] for b in bases))
    acc = tuple(t.reshape(k, L, 4).clone() for t in acc)
    ident = torch.from_numpy(rng.random((k, L)) < 0.2).to(gpu)
    for a, o in zip(acc, curve.pp_identity(1, gpu)):
        a[ident] = o[0]
    Pe, Qe = curve.edge_case_pairs(gpu)
    m = Pe[0].shape[0]
    for a, p, q in zip(acc, Pe, Qe):
        a[:, 1:1 + m] = p
        a[:, B + 1:B + 1 + m] = q
    G = dmsm.combine_groups(k, c, _sms(gpu))
    before = telemetry.launches().get("bucket_combine", 0)
    got = dmsm.bucket_combine(acc, c)
    assert telemetry.launches()["bucket_combine"] - before == (
        2 if G > 1 else 1)
    assert (L, G) in telemetry.snapshot()["lanes"]["bucket_combine"]
    assert got[0].shape == (k, W, 4)
    assert _equal(got, dmsm.bucket_combine_plain(acc, c, G))


def test_split_msm_matches_host_on_gpu(gpu, srs):
    rng = np.random.default_rng(15)
    packed = pack_scalars([int.from_bytes(rng.bytes(32), "little")
                           % FR_MODULUS for _ in range(N)])
    prep = srs.prepared_bases()
    dev = srs.device_bases(gpu, gate.forced("split"))
    want = prep.msm_packed(packed, N)
    for n_dev in (N // 2, N // 8, N):
        got = split.msm_packed_split(dev, prep, packed, N, n_dev, "test")
        assert (got.infinity, got.x, got.y) == (want.infinity, want.x, want.y)
    folds = [packed[:32 * 1000], packed[32 * 1000:32 * 1500], packed[:64]]
    got = split.msm_batch_split_first(dev, prep, folds, [1000, 500, 2], 512,
                                      "test")
    assert got == prep.msm_batch_packed(folds)


# ---------------------------------------------------------------------------
# kernels 4-6 and the device transcript (device/reduction.py, blake2b.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("j_prev,lanes,lg,table", [
    (0, 3, 4, 64), (2, 5, 3, 64), (4, 4, 2, 64), (3, 3, 14, 64),
    (0, 12, 14, 1024), (1, 2, 1, 64)])
def test_reduction_bind_and_q0_match_plain(gpu, j_prev, lanes, lg, table):
    """Kernels 4 and 5 against their plain versions: a first round (every
    lane joins), lanes joining late, a pure bind, lanes of several blocks
    (2^14; with 1024 table rows, every weight layout of kernel 5) and of
    one element's half; elements at 0, 1, r - 1, r - 2. Kernel 5 twice on
    the same inputs: its ticket counters are back at zero after a launch."""
    d = dred.random_round(gpu, np.random.default_rng(21 + lg), j_prev,
                          lanes, lg, table)
    before = telemetry.launches()
    out = dred.bind(d["buf"], d["init"], d["c"], d["init_off"], j_prev,
                    lanes, lg)
    assert _equal([out], [dred.bind_plain(d["buf"], d["init"], d["c"],
                                          d["init_off"], j_prev, lanes, lg)])
    want = dred.q0_plain(out, d["tab"], d["lanep"], lanes, lg)
    for _ in range(2):
        got = dred.q0(out, d["tab"], d["lanep"], lanes, lg)
        assert got.shape == (lanes, 4)
        assert _equal([got], [want])
    assert telemetry.launches()["reduction_bind"] - before.get(
        "reduction_bind", 0) == 1
    assert telemetry.launches()["reduction_q0"] - before.get(
        "reduction_q0", 0) == 2


@pytest.mark.parametrize("lanes,lg,edge", [
    (6, 14, "limbs"), (6, 14, "mont"), (1, 21, "random"), (3, 21, "limbs"),
    (3, 21, "mont")])
def test_reduction_q0_worst_case_and_long_lane(gpu, lanes, lg, edge):
    """Kernel 5's lazy sum at its worst case, every lo and every table
    entry with limbs r - 1 (a thread's 16 wide products near 16 r^2: the
    largest wide sums), and at the Montgomery form of r - 1; lanes of 2^21
    elements (256 partials a lane for the fold); twice each."""
    d = dred.random_round(gpu, np.random.default_rng(lg), 0, lanes, lg, 64)
    buf = d["init"][:lanes << lg]
    tab = d["tab"]
    if edge != "random":
        top = FR_MODULUS - 1
        if edge == "limbs":  # the element whose Montgomery limbs are r - 1
            top = top * FR_R_INV % FR_MODULUS
        top = torch.from_numpy(dred.mont_rows([top])).to(gpu)
        buf = top.expand(lanes << lg, 4).contiguous()
        tab = top.expand(tab.shape[0], 4).contiguous()
    want = dred.q0_plain(buf, tab, d["lanep"], lanes, lg)
    for _ in range(2):
        assert _equal([dred.q0(buf, tab, d["lanep"], lanes, lg)], [want])


@pytest.mark.parametrize("lanes,joined", [(8, 5), (256, 175), (2, 0),
                                          (32, 32)])
def test_reduction_tail_matches_plain(gpu, lanes, joined):
    """Kernel 6 against its plain version: unjoined and zero-padding
    lanes, l1 = 0 (1/l1 given as 0) and l0 = 0 in lanes 0 and 1."""
    d = dred.random_tail(gpu, np.random.default_rng(31 + lanes), lanes,
                         joined)
    k = {n: t.clone() for n, t in d.items()}
    c = torch.empty((1, 4), dtype=torch.int64, device=gpu)
    msg = torch.empty((2, 4), dtype=torch.int64, device=gpu)
    names = ("q0s", "Q", "es", "qinit", "coeff", "l0", "l1", "inv_l1",
             "const_b0", "state")
    dred.tail(k["q0s"], joined, *(k[n] for n in names[1:]), c, msg)
    want = dred.tail_plain(d["q0s"], joined, *(d[n] for n in names[1:]))
    assert _equal((k["Q"], k["es"], k["state"], c, msg), want)


def test_serial_kernels_have_no_stack_frame(gpu):
    """ptxas keeps kernel 6 and the BLAKE2b test kernel in registers: no
    stack frame (the message words indexed by constants)."""
    from jolt_atlas_tpu_torch.device import build, kernel_report
    rep = kernel_report.parse_ptxas(build.ptxas_report())
    for k in ("reduction_tail_kernel", "blake2b_transcript_kernel"):
        assert rep[k]["stack"] == 0, rep[k]


@pytest.mark.parametrize("np_words", [0, 4, 9, 16, 17])
def test_blake2b_kernel_matches_plain_and_hashlib(gpu, np_words):
    import hashlib
    rng = np.random.default_rng(41 + np_words)
    n = 300
    raw = rng.bytes(32 * n)
    pay = rng.bytes(8 * np_words * n)
    nr = rng.integers(0, 1 << 32, size=n)
    states = torch.from_numpy(db.bytes_to_words(raw).reshape(n, 4)).to(gpu)
    payload = torch.from_numpy(
        db.bytes_to_words(pay).reshape(n, np_words)).to(gpu)
    rounds = torch.from_numpy(nr.astype(np.int64)).to(gpu)
    got = db.transcript_step(states, rounds, payload)
    assert _equal([got], [db.transcript_absorb_long_plain(states, rounds,
                                                          payload)])
    out = got.cpu().numpy()
    for i in range(0, n, 37):
        msg = (raw[32 * i:32 * i + 32] + b"\x00" * 28
               + int(nr[i]).to_bytes(4, "big")
               + pay[8 * np_words * i:8 * np_words * (i + 1)])
        assert db.words_to_bytes(out[i]) == hashlib.blake2b(
            msg, digest_size=32).digest()


def _bench_small_pp():
    from jolt_atlas_tpu_torch import models
    from jolt_atlas_tpu_torch.preprocessing import AtlasPreprocessing
    rng = np.random.default_rng(1234)
    model = models.build_nanogpt(32, 8, 16, 1, 8, rng, heads=1)
    toks = rng.integers(0, 32, size=8).astype(np.int32)
    return AtlasPreprocessing.preprocess(model), toks


@pytest.mark.parametrize("tail_rounds", [0, 4])
def test_forced_reduction_matches_host_on_gpu(gpu, tail_rounds):
    """The engine on the card (forced: the model is below the floor)
    against the host path: equal proof bytes, kernels 4-6 launched."""
    from jolt_atlas_tpu_torch import serde
    from jolt_atlas_tpu_torch.prover import AtlasProver
    pp, toks = _bench_small_pp()
    want, _ = AtlasProver(pp, device="cpu").prove([toks])
    telemetry.reset()
    got, _ = AtlasProver(pp, device=gpu, msm_gate=gate.forced("host"),
                         reduction_gate=dred.forced(tail_rounds)).prove(
                             [toks])
    tele = telemetry.snapshot()
    assert tele["decisions"]["reduction"].startswith("ENGAGED")
    for k in ("reduction_bind", "reduction_q0", "reduction_tail"):
        assert tele["launches"].get(k, 0) > 0
    assert serde.serialize_proof(got) == serde.serialize_proof(want)


# ---------------------------------------------------------------------------
# kernel 7 and kernel 4 in the rows layout (device/rows.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("P,n,T,mf,nevals,slices", [
    (1, 2, 1, 1, 1, None), (2, 256, 3, 2, 2, None), (27, 1024, 36, 6, 6, None),
    (96, 64, 8, 5, 20, None), (3, 512, 1, 3, 3, None), (5, 8192, 6, 4, 6, None),
    # tile edges: n / 2 below a tile, exactly one tile of 32 (8 slices)
    (4, 16, 5, 3, 6, None), (27, 64, 36, 6, 6, None),
    # 96 rows at 20 points and 16 slices: the most shared memory
    (96, 128, 40, 6, 20, 16),
    # no terms; constant terms only (max_factors 0)
    (3, 64, 0, 1, 3, None), (3, 64, 4, 0, 4, None)])
def test_rows_points_kernel_matches_plain(gpu, P, n, T, mf, nevals, slices):
    """Kernel 7 against its plain version on every weight layout: one row
    and 96, 1 to 20 points, repeated factors, a constant term, a
    coefficient of one, an all-zero row, no terms and constant terms only,
    n / 2 below one tile, one tile and several, 1 to 16 term slices; one
    launch a call, back to back (the last block's ticket resets)."""
    from jolt_atlas_tpu_torch.device import rows as drows
    gen = np.random.default_rng(50 + P + n + T)
    x = drows.random_rows_for(P, n, gen, gpu)
    terms = drows.random_terms(P, T, max(mf, 1), gen)
    if mf == 0:
        terms = [(c, []) for c, _ in terms]
    tg = drows.Terms(terms, gpu, slices)
    tc = drows.Terms(terms, "cpu", slices)
    before = telemetry.launches().get("rows_points", 0)
    got, want = [], []
    for kind in drows.WEIGHT_KINDS:
        args = drows.random_weights(n, kind, gen)
        got.append(drows.points(x, n, nevals, tg, drows.weights(*args, gpu)))
        want.append(drows.points_plain(x.cpu(), n, nevals, tc,
                                       drows.weights(*args, "cpu")))
    assert _equal([g.cpu() for g in got], want)
    assert telemetry.launches()["rows_points"] - before == len(
        drows.WEIGHT_KINDS)


@pytest.mark.parametrize("tile,group", [(32, 1), (32, 6), (64, 4), (128, 2)])
def test_rows_points_kernel_plans_and_ragged_tile(gpu, tile, group):
    """Kernel 7 at launch plans other than the default, and with one pair
    more than a tile (n / 2 = tile + 1: the last tile holds one pair),
    twice in a row without a synchronisation."""
    from jolt_atlas_tpu_torch.device import rows as drows
    gen = np.random.default_rng(80 + tile + group)
    terms = drows.random_terms(17, 32, 3, gen)
    tg, tc = drows.Terms(terms, gpu, 4), drows.Terms(terms, "cpu", 4)
    for n in (2 * tile, 2 * (tile + 1), 4 * tile):
        x = drows.random_rows_for(17, n, gen, gpu)
        w = drows.random_weights(n, "split", gen)
        wg, wc = drows.weights(*w, gpu), drows.weights(*w, "cpu")
        a = drows._launch(x, n, 6, tg, wg, tile, group)
        b = drows._launch(x, n, 6, tg, wg, tile, group)
        want = drows.points_plain(x.cpu(), n, 6, tc, wc)
        assert _equal([a.cpu(), b.cpu()], [want, want]), n


@pytest.mark.parametrize("P,n", [(1, 2), (3, 4), (27, 256), (27, 16384)])
def test_rows_bind_kernel_matches_plain(gpu, P, n):
    """Kernel 4 with P lanes that all continue: the rows bind."""
    from jolt_atlas_tpu_torch.device import rows as drows
    gen = np.random.default_rng(60 + P + n)
    x = drows.random_rows_for(P, n, gen, gpu)
    c = dred.random_rows(6, gen, gpu)[5:]
    before = telemetry.launches().get("reduction_bind", 0)
    got = drows.bind_rows(x, c, n)
    assert _equal([got.cpu()], [drows.bind_rows(x.cpu(), c.cpu(), n)])
    assert telemetry.launches()["reduction_bind"] - before == 1


def test_forced_iop_engine_matches_host_on_gpu(gpu):
    """The rows engine on the card at every size (forced) against the host
    path: equal proof bytes, kernel 7 launched."""
    from jolt_atlas_tpu_torch import serde
    from jolt_atlas_tpu_torch.device import rows as drows
    from jolt_atlas_tpu_torch.prover import AtlasProver
    pp, toks = _bench_small_pp()
    want, _ = AtlasProver(pp, device="cpu").prove([toks])
    telemetry.reset()
    got, _ = AtlasProver(pp, device=gpu, msm_gate=gate.forced("host"),
                         iop_gate=drows.forced()).prove([toks])
    tele = telemetry.snapshot()
    assert tele["decisions"]["iop"].startswith("ENGAGED")
    for k in ("rows_points", "rows_from_i64"):
        assert tele["launches"].get(k, 0) > 0
    assert serde.serialize_proof(got) == serde.serialize_proof(want)


@pytest.mark.parametrize("n", [1, 12, 1000, 1 << 18])
def test_rows_from_i64_kernel_matches_plain(gpu, n):
    """Kernel 8 against its plain version: the int64 edges (0, +-1,
    +-2^62, 2^63 - 1, -2^63), full-range and small values."""
    from jolt_atlas_tpu_torch.device import rows as drows
    gen = np.random.default_rng(70 + n)
    v = gen.integers(-(1 << 63), (1 << 63) - 1, size=n, dtype=np.int64,
                     endpoint=True)
    edge = [0, 1, -1, (1 << 63) - 1, -(1 << 63), 1 << 62, -(1 << 62) - 7,
            65535, -65536, 1 << 32, 2, -2]
    v[:min(n, len(edge))] = edge[:n]
    v[len(edge):n // 2] %= 1 << 16
    src = torch.from_numpy(v).to(gpu)
    before = telemetry.launches().get("rows_from_i64", 0)
    got = drows.from_i64(src)
    assert _equal([got.cpu()], [drows.from_i64_plain(src.cpu())])
    assert telemetry.launches()["rows_from_i64"] - before == 1


@pytest.mark.parametrize("n", [33, 4097, 442_369])
def test_rows_from_i64_two_word_kernel(gpu, n):
    """Kernel 8's two-word conversion (a grid sized from the SMs strided
    over the values): warps that mix small values with full 64-bit ones of
    either sign, -2^63 and 2^63 - 1 in every warp, ragged lengths (442,369
    takes a second pass of the grid) and a view at an 8-byte offset."""
    from jolt_atlas_tpu_torch.device import rows as drows
    gen = np.random.default_rng(n)
    v = gen.integers(-(1 << 63), (1 << 63) - 1, size=n + 1, dtype=np.int64,
                     endpoint=True)
    small = gen.random(n + 1) < 0.5
    v[small] = gen.integers(-(1 << 16), 1 << 16, size=int(small.sum()))
    v[::32] = -(1 << 63)
    v[5::32] = (1 << 63) - 1
    v[7::32] = 0
    whole = torch.from_numpy(v).to(gpu)
    for src in (whole[:n], whole[1:]):
        got = drows.from_i64(src)
        assert _equal([got.cpu()], [drows.from_i64_plain(src.cpu())])


def test_pp_add_kernel_lazy_sums_edges_and_full_width(gpu, srs):
    """Kernel 1's lazy sums where t4 = 0 (identity + identity: p itself
    as a factor), with an affine point and its inverse beside it, and at
    the gate's 2^17 lanes of projective inputs."""
    bases = srs.device_bases(gpu, gate.forced("device")).bases
    ident = curve.pp_identity(64, gpu)
    P = tuple(torch.cat([a, b[:64]]) for a, b in zip(ident, bases))
    Q = tuple(torch.cat([a, b[:64]]) for a, b in zip(ident, bases))
    from jolt_atlas_tpu_torch.device import field as dfield
    neg = dfield.sub4(torch.zeros_like(Q[1][64:]), Q[1][64:])
    Q = (Q[0], torch.cat([Q[1][:64], neg]), Q[2])  # then P + (-P)
    assert _equal(curve.pp_add(P, Q), curve.pp_add_plain(P, Q))
    rng = np.random.default_rng(17)
    i1, i2 = (torch.from_numpy(rng.integers(0, N, size=1 << 17)).to(gpu)
              for _ in range(2))
    R = curve.pp_add(tuple(b[i1] for b in bases), tuple(b[i2] for b in bases))
    S = tuple(t.roll(3, 0) for t in R)
    assert _equal(curve.pp_add(R, S), curve.pp_add_plain(R, S))


# ---------------------------------------------------------------------------
# kernel 9 (the exact matrix product) and the mesh path
# ---------------------------------------------------------------------------

I32_MIN, I32_MAX = -(2**31), 2**31 - 1


def _exact_cases():
    """(name, a (B, M, K), b (B, K, N), shifts): the saturation edges at K =
    4096, the example MLP's products, ragged tiles, a batch."""
    gen = np.random.default_rng(90)
    full = lambda s, v: np.full(s, v, np.int32)
    rnd = lambda s, lim: gen.integers(-lim, lim, size=s, dtype=np.int32)
    mixed = full((1, 3, 4096), I32_MIN)
    mixed[..., ::3] = I32_MAX
    return [("max", full((1, 3, 4096), I32_MAX), full((1, 4096, 5), I32_MAX)),
            ("min", full((1, 3, 4096), I32_MIN), full((1, 4096, 5), I32_MIN)),
            ("mixed", mixed, full((1, 4096, 5), I32_MAX)),
            ("random32", rnd((1, 65, 4096), 2**31), rnd((1, 4096, 70), 2**31)),
            ("mlp1", rnd((1, 8, 64), 2**10), rnd((1, 64, 128), 2**8)),
            ("mlp2", rnd((1, 8, 128), 2**10), rnd((1, 128, 32), 2**8)),
            ("batched", rnd((4, 33, 16), 2**20), rnd((4, 16, 65), 2**20))]


@pytest.mark.parametrize("case", range(7))
def test_exact_matmul_kernel_matches_plain(gpu, case):
    from jolt_atlas_tpu_torch import torchexec
    name, a, b = _exact_cases()[case]
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for wrap in (False, True):
        for shift in (0, 1, 7, 8, 12, 16, 24):
            got = torchexec.exact_matmul(ta.to(gpu), tb.to(gpu), shift, wrap)
            want = torchexec.exact_matmul_plain(ta, tb, shift, wrap)
            assert torch.equal(got.cpu(), want), (name, wrap, shift)
            # the plain version runs on the card too (float64 limb sums)
            on_card = torchexec.exact_matmul_plain(ta.to(gpu), tb.to(gpu),
                                                   shift, wrap)
            assert torch.equal(on_card.cpu(), want), (name, wrap, shift)


def test_exact_matmul_kernel_strided_einsums(gpu):
    """Every lowered einsum reads its operands through strides (a
    transposed operand, a broadcast batch): equal to the CPU path."""
    from jolt_atlas_tpu_torch import torchexec
    gen = np.random.default_rng(91)
    for eq, sa, sb in [("mk,nk->mn", (40, 24), (72, 24)),
                       ("hmk,hnk->hmn", (4, 64, 16), (4, 64, 16)),
                       ("hmn,hnk->hmk", (4, 64, 64), (4, 64, 16)),
                       ("bmk,kn->bmn", (2, 24, 16), (16, 40)),
                       ("kn,k->n", (16, 72), (16,))]:
        x = torch.from_numpy(gen.integers(-2**30, 2**30, size=sa,
                                          dtype=np.int32))
        y = torch.from_numpy(gen.integers(-2**30, 2**30, size=sb,
                                          dtype=np.int32))
        for shift in (0, 12):
            got = torchexec.einsum_rescale(eq, x.to(gpu), y.to(gpu), shift)
            want = torchexec.einsum_rescale(eq, x, y, shift)
            assert torch.equal(got.cpu(), want), eq


EDGES = (1, 15, 16, 17, 63, 64, 65, 129)


@pytest.mark.parametrize("K", [1, 31, 32, 33, 4096])
def test_exact_matmul_kernel_tile_edges(gpu, K):
    """Every M and N of EDGES (16 x 64 tiles for M <= 16, 64 x 64 above,
    split depths at K = 4096) at depths around a 32-deep slice, random
    i32 in both modes: equal to the plain version (which runs on the card,
    held to the CPU by test_exact_matmul_kernel_matches_plain)."""
    from jolt_atlas_tpu_torch import torchexec
    gen = np.random.default_rng(K)
    for M in EDGES:
        for N in EDGES:
            a = torch.from_numpy(gen.integers(I32_MIN, I32_MAX, size=(1, M, K),
                                              dtype=np.int32)).to(gpu)
            b = torch.from_numpy(gen.integers(I32_MIN, I32_MAX, size=(1, K, N),
                                              dtype=np.int32)).to(gpu)
            for wrap in (False, True):
                for shift in (0, 12, 24):
                    got = torchexec.exact_matmul(a, b, shift, wrap)
                    want = torchexec.exact_matmul_plain(a, b, shift, wrap)
                    assert torch.equal(got, want), (M, K, N, wrap, shift)


def test_exact_matmul_kernel_strides(gpu):
    """A batch stride of 0 (broadcast), transposed operands (b K-major, a
    M-major) and rows that are not 16-byte aligned, at a split depth and
    not: equal to the plain version."""
    from jolt_atlas_tpu_torch import torchexec
    gen = np.random.default_rng(92)
    rnd = lambda s: torch.from_numpy(gen.integers(I32_MIN, I32_MAX, size=s,
                                                  dtype=np.int32)).to(gpu)
    for M, K, N in ((40, 300, 72), (12, 1000, 70)):
        x, y = rnd((2, M, K)), rnd((2, N, K))
        for a, b in [(x, y.transpose(1, 2)),
                     (x.transpose(1, 2).contiguous().transpose(1, 2),
                      y.transpose(1, 2)),
                     (x[:1].expand(3, M, K), y[:1].transpose(1, 2).expand(
                         3, K, N)),
                     (x[:, :, 1:], y.transpose(1, 2)[:, 1:]),
                     (x, y.transpose(1, 2).contiguous()[:1].expand(2, K, N))]:
            for wrap in (False, True):
                got = torchexec.exact_matmul(a, b, 7, wrap)
                assert torch.equal(got, torchexec.exact_matmul_plain(
                    a, b, 7, wrap)), (M, K, N, a.stride(), b.stride(), wrap)


@pytest.mark.parametrize("kind", ["max", "min", "mixed"])
def test_exact_matmul_kernel_wrap_deep(gpu, kind):
    """The wrapping mode at K = 16,384 (two 8,192-deep chunks, summed by
    the finish kernel) at the extremes: equal to the plain version on the
    CPU."""
    from jolt_atlas_tpu_torch import torchexec
    a = np.full((1, 3, 16384), I32_MAX if kind == "max" else I32_MIN,
                np.int32)
    if kind == "mixed":
        a[..., ::3] = I32_MAX
    b = np.full((1, 16384, 5), I32_MIN if kind == "min" else I32_MAX,
                np.int32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for shift in (0, 1, 12, 24, 63):
        got = torchexec.exact_matmul(ta.to(gpu), tb.to(gpu), shift, True)
        assert torch.equal(got.cpu(), torchexec.exact_matmul_plain(
            ta, tb, shift, True)), shift


@pytest.mark.parametrize("shape", [(1024, 768, 3072), (16, 1024, 4096)])
def test_exact_matmul_kernel_timed_shapes(gpu, shape):
    """chip_smoke's two timed shapes, i32 in a scale-2^12 range: equal to
    the plain version on the card."""
    from jolt_atlas_tpu_torch import torchexec
    M, K, N = shape
    gen = np.random.default_rng(M)
    a = torch.from_numpy(gen.integers(-2**14, 2**14, size=(1, M, K),
                                      dtype=np.int32)).to(gpu)
    b = torch.from_numpy(gen.integers(-2**14, 2**14, size=(1, K, N),
                                      dtype=np.int32)).to(gpu)
    assert torch.equal(torchexec.exact_matmul(a, b, 12),
                       torchexec.exact_matmul_plain(a, b, 12))


def test_exact_kernels_use_tensor_cores(gpu):
    """Kernel 9's tiles hold tensor-core instructions in their SASS, and
    none of its kernels spills."""
    from jolt_atlas_tpu_torch.device import build, kernel_report
    sass = kernel_report.sass(build.CUDA_SRC)
    ptx = kernel_report.parse_ptxas(build.ptxas_report())
    for k in ("exact_matmul_wide", "exact_matmul_narrow"):
        assert sass[k]["tensor"] > 0, sass[k]
    for k in ("exact_matmul_wide", "exact_matmul_narrow",
              "exact_matmul_finish"):
        assert ptx[k]["spill_stores"] == ptx[k]["spill_loads"] == 0, ptx[k]


def test_entry_on_gpu_matches_cpu(gpu):
    from jolt_atlas_tpu_torch.entry import entry
    before = telemetry.launches().get("exact_matmul", 0)
    fn, args = entry()
    got = fn(*args)
    assert telemetry.launches()["exact_matmul"] - before == 2
    cfn, cargs = entry(device="cpu")
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, cfn(*cargs)))


@pytest.mark.parametrize("nccl", [False, True])
def test_mesh_prove_on_gpu_matches_host(gpu, nccl, tmp_path):
    """The one-block transformer under an 8-shard mesh on the card (in one
    process, or a 1-rank NCCL group): bytes equal the host prove, both
    mesh engines engage through kernels 4, 5, 7 and 8."""
    import torch.distributed as dist
    from jolt_atlas_tpu_torch import serde
    from jolt_atlas_tpu_torch.parallel import make_mesh, mesh, mesh_scope
    from jolt_atlas_tpu_torch.preprocessing import AtlasPreprocessing
    from jolt_atlas_tpu_torch.prover import AtlasProver
    model, toks = mesh.one_block_transformer()
    pp = AtlasPreprocessing.preprocess(model)
    want = serde.serialize_proof(AtlasProver(pp, device="cpu").prove(
        [toks])[0])
    group = None
    if nccl:
        dist.init_process_group("nccl", store=dist.FileStore(
            str(tmp_path / "store"), 1), rank=0, world_size=1)
        group = dist.group.WORLD
    try:
        telemetry.reset()
        with mesh_scope(make_mesh(8, device=gpu, group=group)):
            proof, _ = AtlasProver(pp, msm_gate=gate.forced("host")).prove(
                [toks])
        tele = telemetry.snapshot()
    finally:
        if nccl:
            dist.destroy_process_group()
    assert serde.serialize_proof(proof) == want
    assert tele["decisions"]["mesh_reduction"].startswith("ENGAGED (8 ")
    assert tele["decisions"]["mesh_iop"].startswith("ENGAGED")
    for k in ("reduction_bind", "reduction_q0", "rows_points",
              "rows_from_i64"):
        assert tele["launches"].get(k), (k, tele["launches"])


def test_sharded_product_round_on_gpu(gpu):
    import random
    from jolt_atlas_tpu_torch.parallel import make_mesh, mesh as M
    rng = random.Random(12)
    T = 1 << 12
    eq = [rng.randrange(FR_MODULUS) for _ in range(T)]
    p = [rng.randrange(FR_MODULUS) for _ in range(T)]
    r = rng.randrange(FR_MODULUS)
    m = make_mesh(8, device=gpu)
    out = M.sharded_product_round(m)(M.shard_blocks(m, M.mont_tensor(eq)),
                                     M.shard_blocks(m, M.mont_tensor(p)),
                                     M.mont_tensor([r]).to(gpu))
    got = (M.ints_of(out[0])[0], M.ints_of(out[1])[0],
           M.ints_of(out[2].cpu()), M.ints_of(out[3].cpu()))
    assert got == M.product_round_plain(eq, p, r)
    planes = [M.ints_of(x.cpu()) for x in M.product_round_planes(
        *(M.mont_tensor(v).to(gpu) for v in (eq, p, [r])))]
    assert got == (planes[0][0], planes[1][0], planes[2], planes[3])


def test_compile_forward_defaults_to_the_card(gpu):
    from jolt_atlas_tpu_torch import torchexec
    model, xq = torchexec.example_mlp()
    out = torchexec.compile_forward(model)(torch.as_tensor(xq, device=gpu))
    assert out[0].device.type == "cuda"
    assert np.array_equal(out[0].cpu().numpy(), model.forward([xq])[0])


def test_zk_driver_on_gpu_matches_host(gpu):
    """nanogpt_style --zk at BENCH_SMALL's shape with the MSM and rows
    engines forced on the card, under one seeded blinding stream: the
    card's bytes equal the host path's, verify_zk accepts (inside the
    driver), the masked opening's MSMs run on the card."""
    from jolt_atlas_tpu_torch.device import rows
    from jolt_atlas_tpu_torch.examples import nanogpt_style
    blobs = {}
    for device in ("cuda", "cpu"):
        args = nanogpt_style.parser().parse_args(
            ["--zk", "--gen", "1", "--device", device])
        how = ({"msm_gate": gate.forced("device"),
                "iop_gate": rows.forced()} if device == "cuda" else {})
        with nanogpt_style.seeded_blinding():
            out = nanogpt_style.run(args, **how)
        blobs[device] = out["blob"]
        if device == "cuda":
            tele = out["telemetry"]
            assert tele["dispatches"].get("msm:hyperkzg_witness", 0) > 0
            assert tele["decisions"]["reduction"] == "zk"
            for k in ("bucket_accumulate", "bucket_combine", "rows_points",
                      "rows_from_i64"):
                assert tele["launches"].get(k, 0) > 0, k
    assert blobs["cuda"] == blobs["cpu"]


def test_qwen_driver_on_gpu_matches_host(gpu):
    """qwen_style on the committed models/qwen_slice: the card's default
    gates against the host path, bytes equal."""
    from jolt_atlas_tpu_torch.examples import qwen_style
    blobs = {device: qwen_style.run(qwen_style.parser().parse_args(
        ["--device", device]))["blob"] for device in ("cuda", "cpu")}
    assert blobs["cuda"] == blobs["cpu"]
