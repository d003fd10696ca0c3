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
- kernel 7's launch plan (tile of pairs, term slices, points a block,
  shared bytes) for every P <= 96 within Hopper's 227 KB, a model of its
  indexing that reaches every (pair, point, term) once, and the grouped
  terms it reads (shared heads, split and dealt into slices) summing to
  the term list;
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

import types

import numpy as np
import pytest
import torch

import chip_smoke as cs
from examples.nanogpt_style import build_model as ref_build_nanogpt
from jolt_atlas_tpu import serde as ref_serde
from jolt_atlas_tpu.field import frvec as ref_frvec
from jolt_atlas_tpu.field.constants import FR_MODULUS
from jolt_atlas_tpu.field.scalar import Fr as RefFr
from jolt_atlas_tpu.preprocessing import AtlasPreprocessing as RefPP
from jolt_atlas_tpu.prover import AtlasProver as RefProver
from jolt_atlas_tpu_torch import serde
from jolt_atlas_tpu_torch.curve.points import g1_generator
from jolt_atlas_tpu_torch.device import bind as B
from jolt_atlas_tpu_torch.device import onehot as O
from jolt_atlas_tpu_torch.device import rows as R
from jolt_atlas_tpu_torch.device import split, telemetry
from jolt_atlas_tpu_torch.device.field import tensor_to_ints
from jolt_atlas_tpu_torch.device.reduction import fr_of_row, mont_rows
from jolt_atlas_tpu_torch.field.frvec import FrArray, GruenInstance
from jolt_atlas_tpu_torch.field.scalar import Fr
from jolt_atlas_tpu_torch.poly.mlpoly import MLPoly
from jolt_atlas_tpu_torch.poly.spliteq import SplitEq
from jolt_atlas_tpu_torch.preprocessing import AtlasPreprocessing
from jolt_atlas_tpu_torch.prover import AtlasProver
from jolt_atlas_tpu_torch.subprotocols.sumcheck import RowsInstance
from jolt_atlas_tpu_torch.verifier import AtlasVerifier
from test_torch_srs import port_pp, reference_native

# the suite runs in several worker processes at once: a small intra-op
# pool keeps this file from starving its neighbours' timed tests
torch.set_num_threads(2)


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


# ---------------------------------------------------------------------------
# kernel 7's launch plan: tiles of pairs, term slices, point groups, shared
# memory (device/rows.py:points_plan, Terms; csrc/rows.cu)
# ---------------------------------------------------------------------------

def test_cuda_plan_constants():
    """csrc/rows.cu's caps and shared-memory budget are rows.py's."""
    import os
    import re
    src = open(os.path.join(os.path.dirname(R.__file__), "..", "csrc",
                            "rows.cu")).read()

    def const(name):
        expr = re.search(rf"constexpr int {name} = ([0-9 \-]+);", src)
        return eval(expr.group(1))
    assert const("ROWS_MAX_EVALS") == R.MAX_EVALS
    assert const("ROWS_MAX_P") == R.MAX_P
    assert const("ROWS_MAX_SLICES") == R.MAX_SLICES
    assert const("ROWS_MAX_BLOCK") == R.MAX_BLOCK
    assert const("ROWS_SMEM_MAX") == R.SMEM_MAX
    assert "(2 * P + 1 + slices) * tile * 32" in src  # rows_points_smem
    assert "group * (tile / 32) * 32" in src


@pytest.mark.parametrize("slices", [1, 3, 8, 16])
def test_points_plan_fits_every_shape(slices):
    """Every P <= 96 at every point count launches within Hopper's 227 KB
    of shared memory a block and 512 threads, and the tiles and groups
    cover the pairs and points exactly."""
    for P in range(1, R.MAX_P + 1):
        for nevals in (1, 2, 6, 20):
            for n in (2, 64, 1 << 14, 1 << 20):
                for sms in (1, 132):
                    pl = R.points_plan(P, n, nevals, slices, sms)
                    assert pl["smem"] <= R.SMEM_MAX < 227 * 1024
                    assert pl["smem"] == R.smem_bytes(
                        P, slices, pl["tile"], pl["group"])
                    assert pl["threads"] == pl["tile"] * slices
                    assert pl["threads"] <= R.MAX_BLOCK
                    assert pl["tile"] >= 32 and not pl["tile"] & (
                        pl["tile"] - 1)
                    half = n // 2
                    assert (pl["tiles"] - 1) * pl["tile"] < half \
                        <= pl["tiles"] * pl["tile"]
                    assert (pl["groups"] - 1) * pl["group"] < nevals \
                        <= pl["groups"] * pl["group"]


def test_points_plan_of_the_bench_class():
    """The bench's largest class (27 rows, 36 terms of up to 6 factors, 6
    points, n = 16,384) on a 132-SM card: 6 slices of 32 pairs, all 6
    points a block, 256 blocks; at n = 4,096, 64 tiles, 3 groups of 2
    points."""
    gen = np.random.default_rng(27)
    terms = R.Terms(R.random_terms(27, 36, 6, gen), "cpu")
    assert terms.slices == 6
    pl = R.points_plan(27, 1 << 14, 6, terms.slices, 132)
    assert (pl["tile"], pl["group"], pl["tiles"], pl["groups"]) == (
        32, 6, 256, 1)
    pl = R.points_plan(27, 1 << 12, 6, terms.slices, 132)
    assert (pl["tile"], pl["group"], pl["tiles"], pl["groups"]) == (
        32, 2, 64, 3)
    with pytest.raises(ValueError, match="no launch"):
        R.points_plan(96, 64, 20, 16, 132, tile=64)


@pytest.mark.parametrize("P,n,T,nevals,slices,tile,group", [
    (3, 16, 5, 3, None, None, None),    # n / 2 below one tile
    (27, 64, 36, 6, None, None, None),  # exactly one tile
    (4, 128, 9, 6, 3, 32, 4),           # two tiles, a ragged point group
    (5, 256, 7, 20, 2, 64, 7),
    (2, 8, 0, 2, None, None, None),     # no terms
])
def test_points_partition_covers_each_pair_point_term_once(
        P, n, T, nevals, slices, tile, group):
    """A model of kernel 7's indexing: blocks (tile, point group), threads
    (slice, pair), the walk over a group's points, the slices' parts and
    the staging of rows into shared planes reach every (pair, point, term)
    and every shared slot exactly once."""
    gen = np.random.default_rng(P + n + T)
    terms = R.Terms(R.random_terms(P, T, 4, gen), "cpu", slices)
    pl = R.points_plan(P, n, nevals, terms.slices, 132, tile, group)
    bounds = terms.bounds.tolist()
    parts = terms.parts.numpy().reshape(-1, 4)
    assert bounds[0] == 0 and bounds[-1] == len(parts)
    half, tile = n // 2, pl["tile"]
    cnt = np.zeros((half, nevals, max(T, 1)), dtype=np.int64)
    for bx in range(pl["tiles"]):
        for by in range(pl["groups"]):
            i0 = by * pl["group"]
            t = 0 if i0 == 0 else i0 + 1
            for g in range(min(pl["group"], nevals - i0)):
                if g:
                    t += 2 if i0 + g == 1 else 1
                assert t == (i0 + g + 1 if i0 + g else 0)
                for tid in range(pl["threads"]):
                    p, s = tid % tile, tid // tile
                    j = bx * tile + p
                    if j < half:
                        for q in range(bounds[s], bounds[s + 1]):
                            for k in range(parts[q, 2], parts[q, 3]):
                                cnt[j, i0 + g, k] += 1
    assert (cnt[:, :, :T] == 1).all()
    rowq, lt = 2 * tile, tile.bit_length() - 1
    dst = sorted((c >> (lt + 1)) * rowq + (c & 1) * tile
                 + ((c & (rowq - 1)) >> 1) for c in range(P * rowq))
    assert dst == list(range(P * rowq))


def _grouped_sum(terms: R.Terms, e: list) -> Fr:
    """Kernel 7's sum at one pair from the arrays it reads: each part's
    head product times its members' sum, members c_k prod(tail)."""
    coeffs = [fr_of_row(r) for r in terms.kcoeffs.numpy()]
    parts = terms.parts.numpy().reshape(-1, 4)
    mem = terms.members.numpy().reshape(-1, 2)
    fidx, bounds = terms.fidx.numpy(), terms.bounds.numpy()
    v = Fr.zero()
    for q in range(int(bounds[0]), int(bounds[-1])):
        ha, hb, ma, mb = parts[q]
        inner = Fr.zero()
        for k in range(ma, mb):
            p = coeffs[k]
            for f in fidx[mem[k, 0]:mem[k, 1]]:
                p = p * e[f]
            inner = inner + p
        for f in fidx[ha:hb]:
            inner = inner * e[f]
        v = v + inner
    return v


def test_grouped_terms_sum_to_the_terms():
    """The groups share the bench class's two 5-factor heads (42 products a
    pair and point against 122 term by term); at every slice count the
    parts the kernel reads hold each term once and sum to the term list at
    random row values, also with repeated factors, constants, a term
    equal to another's head and one row."""
    gen = np.random.default_rng(9)
    bench = cs.bench_terms(gen)
    groups = R.group_terms(bench)
    heads = sorted(h for h, _ in groups if h)
    assert heads == [[0, 1, 2, 3, 5], [7, 20, 21, 22, 23]]
    ones = [c.is_one() for c, _ in bench]
    prods = sum(R.part_cost(h, m, ones) - len(m) for h, m in groups)
    assert prods == 42
    cases = [(27, bench), (7, R.random_terms(7, 23, 6, gen)),
             (1, R.random_terms(1, 4, 3, gen)),
             (3, [(Fr(5), [0, 1]), (Fr(7), [1, 0]), (Fr(2), [0]),
                  (Fr(9), []), (Fr.one(), [0, 1, 2]), (Fr(3), [0, 0, 1])])]
    for P, raw in cases:
        e = [Fr(int.from_bytes(gen.bytes(32), "little") % FR_MODULUS)
             for _ in range(P)]
        want = Fr.zero()
        for c, f in raw:
            for i in f:
                c = c * e[i]
            want = want + c
        for slices in (1, 3, 8, 16):
            t = R.Terms(raw, "cpu", slices)
            assert t.slices == slices and t.bounds.shape == (slices + 1,)
            parts = t.parts.numpy().reshape(-1, 4)
            assert sorted(k for q in parts for k in range(q[2], q[3])) \
                == list(range(len(raw)))
            assert _grouped_sum(t, e) == want, (P, slices)


def test_parts_are_dealt_evenly():
    """deal_terms places each unit once, longest first onto the least
    loaded slice; make_parts splits a head's group only to bring it within
    a slice's share; the dealt order leaves the points unchanged."""
    gen = np.random.default_rng(10)
    raw = R.random_terms(7, 23, 6, gen)
    ones = [c.is_one() for c, _ in raw]
    groups = R.group_terms(raw)
    for slices in (1, 2, 5, 8):
        parts = R.make_parts(groups, ones, slices)
        costs = [R.part_cost(h, m, ones) for h, m in parts]
        dealt = R.deal_terms(costs, slices)
        assert sorted(q for sl in dealt for q in sl) == list(range(
            len(parts)))
        loads = [sum(costs[q] for q in sl) for sl in dealt]
        assert max(loads) - min(loads) <= max(costs)
    assert len(R.make_parts(R.group_terms(cs.bench_terms(gen)), [False] * 36,
                            1)) == 20
    assert [R.default_slices(T) for T in (0, 1, 5, 36)] == [1, 1, 5, 6]
    x = R.random_rows_for(7, 16, gen, "cpu")
    w = R.weights(*R.random_weights(16, "split", gen), "cpu")
    want = R.points(x, 16, 6, R.Terms(raw, "cpu", 1), w)
    for slices in (3, 16):
        assert torch.equal(R.points(x, 16, 6, R.Terms(raw, "cpu", slices),
                                    w), want)
    with pytest.raises(ValueError, match="slices"):
        R.Terms(raw, "cpu", 17)


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


def _rows_cu_constant() -> int:
    """csrc/rows.cu's C, kernel 8's multiplier, as an integer."""
    import os
    import re
    src = open(os.path.join(os.path.dirname(R.__file__), "..", "csrc",
                            "rows.cu")).read()
    m = re.search(r"C\[8\] = \{([^}]*)\}", src)
    limbs = [int(x.strip().rstrip("u"), 16) for x in m.group(1).split(",")]
    return sum(v << (32 * i) for i, v in enumerate(limbs))


def test_cuda_r2_constant():
    """csrc/rows.cu's constant C = 2^320 mod r, kernel 8's multiplier:
    two CIOS steps by C over |v|'s two words divide by 2^64 and leave
    |v| 2^256 = |v| R mod r."""
    assert _rows_cu_constant() == pow(2, 320, FR_MODULUS)


def _from_u64_model(u: int) -> tuple:
    """csrc/rows.cu fr_from_u64 over 32-bit words: two CIOS steps, each a
    row of u_i C and one of m r, then one conditional subtraction. (the
    value before the subtraction, the result)."""
    r, W = FR_MODULUS, 1 << 32
    n0 = (-pow(r, -1, W)) % W
    C = _rows_cu_constant()
    t = 0
    for i in range(2):
        t += ((u >> (32 * i)) & (W - 1)) * C
        m = (t % W) * n0 % W
        t += m * r
        assert t % W == 0 and t < 1 << 320  # mad_row's 10 words
        t >>= 32
    assert t < 1 << 256  # t[8] = 0
    return t, t - r if t >= r else t


def _from_i64_model(v: int) -> tuple:
    """fr_from_i64: |v| (-2^63 included), then r - x where v < 0."""
    before, x = _from_u64_model(-v if v < 0 else v)
    return before, FR_MODULUS - x if v < 0 else x


@pytest.mark.parametrize("v", [0, 1, -1, (1 << 32) - 1, 1 << 32,
                               -((1 << 32) - 1), (1 << 63) - 1, -(1 << 63),
                               (1 << 64) - 1, "random"])
def test_two_word_conversion_model(v):
    """Kernel 8's two-word conversion, modelled in big-int arithmetic over
    32-bit words: below 2r before its one subtraction, and v R mod r after
    it, at the edges (2^64 - 1 as |v| through fr_from_u64) and at 2,000
    seeded random values of either sign; the int64 ones equal the plain
    version's limbs too."""
    r, Rm = FR_MODULUS, 1 << 256
    if v == "random":
        gen = np.random.default_rng(8)
        vals = [int(x) for x in gen.integers(-(1 << 63), (1 << 63) - 1,
                                             size=1000, dtype=np.int64,
                                             endpoint=True)]
        vals += [int(x) for x in gen.integers(-(1 << 16), 1 << 16,
                                              size=1000)]
    else:
        vals = [v]
    worst = 0
    for x in vals:
        before, got = (_from_u64_model(x) if x >= 1 << 63
                       else _from_i64_model(x))
        worst = max(worst, before)
        assert before < 2 * r
        assert 0 <= got < r and got == x * Rm % r
    assert worst < 2 * r
    ints = [x for x in vals if x < 1 << 63]
    if ints:
        plain = R.from_i64_plain(torch.tensor(ints, dtype=torch.int64))
        assert tensor_to_ints(plain) == [_from_i64_model(x)[1] for x in ints]


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
    return port_pp(model, ref_pp), inputs, ref_bytes


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
    with R.Scope(torch.device("cpu"), gate) as sc:
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
    with R.Scope(torch.device("cpu"), R.RowsGate(forced=True)) as sc:
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
    with R.Scope(torch.device("cpu"), R.forced()) as sc:
        a, b = _Rows(), _Rows()
        a.setup_rows(_polys(2, 16, gen), [(Fr.one(), [0, 1])], 3,
                     eq_r=[Fr(3)] * 4)
        b.setup_rows(_polys(2, 16, gen), [(Fr.one(), [0, 1])], 2)
    assert isinstance(a._gruen, R.DeviceGruen) and b._gruen is None
    assert (sc.offered, sc.engaged, a._gruen.P * a._gruen.n) == (1, 1, 32)
    c = _Rows()
    c.setup_rows(_polys(2, 16, gen), [(Fr.one(), [0, 1])], 3,
                 eq_r=[Fr(3)] * 4)
    assert isinstance(c._gruen, GruenInstance)


def test_default_gate_per_device():
    """The prover's choice of the IOP's scopes: none on a CPU device (each
    engine's reason recorded), the three on a CUDA device (no card needed
    to enter them) under the default caps; the rows scope's summary with
    its rounds."""
    prover = lambda device, gate=None: types.SimpleNamespace(
        device=torch.device(device), iop_gate=gate, bind_residents={})
    telemetry.reset()
    with AtlasProver._iop_engines(prover("cpu")):
        assert R.Scope.entered is None
    d = telemetry.snapshot()["decisions"]
    assert [d[e] for e in ("iop", "rachecks", "einsum_bind")] == \
        ["host path (device=cpu)"] * 3
    with AtlasProver._iop_engines(prover("cuda")):
        sc = R.Scope.entered
        assert (O.Scope.entered.device.type, B.Scope.entered.device.type) \
            == ("cuda", "cuda")
    assert (sc.gate.head_rounds, sc.gate.min_n, sc.gate.min_work,
            sc.gate.forced) == (2, 2048, 1 << 20, False)
    # work: 1,024 pairs x factors x 20 points against 2^20
    assert sc.gate.decline(96, 2048, 20, 52) is None
    assert sc.gate.decline(96, 2048, 20, 51) == "work < 1048576"
    assert (R.forced().head_rounds, R.forced().min_work) == (2, 0)
    with AtlasProver._iop_engines(prover("cpu", R.forced())):
        sc = R.Scope.entered
        sc.offered, sc.engaged, sc.rounds = 3, 1, 2
        telemetry.tally("iop_rows_bound_card", 64)
        telemetry.count("iop_rows", 4)
    assert telemetry.snapshot()["decisions"]["iop"] == (
        "ENGAGED (1 of 3 instances, 64 row elements bound, 4 dispatches, "
        "2 device rounds)")


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
        seen.append(R.Scope.entered)
        return real(self)
    monkeypatch.setattr(opening._GroupReductionProver, "setup_sumcheck", spy)
    xs = rng.integers(-100, 100, size=(1, 16)).astype(np.int32)
    telemetry.reset()
    AtlasProver(pp, device="cpu", iop_gate=R.forced()).prove([xs])
    assert seen and all(s is None for s in seen)
    assert telemetry.snapshot()["decisions"]["iop"].startswith("ENGAGED")
