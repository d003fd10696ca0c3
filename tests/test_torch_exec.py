"""The port's exact quantized forward (jolt_atlas_tpu_torch/torchexec.py)
against the reference's (jolt_atlas_tpu/jaxexec.py) and the numpy
frontend, on the CPU, where kernel 9 runs as its plain version.

Exact equality everywhere: kernel 9's plain version against jaxexec's
limb products at the saturation edges (K = 4096, every operand at 2^31 - 1
or -2^31, shifts 0 .. 24) and against Python integers, in both modes;
every op of ``_node_fn`` and tests/test_jaxexec.py's models through both
executors; the einsum lowering against torch.einsum in int64.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jolt_atlas_tpu import jaxexec
from jolt_atlas_tpu.frontend import ModelBuilder as RefBuilder
from jolt_atlas_tpu.frontend.quantize import quantize_tensor
from jolt_atlas_tpu_torch import convert, torchexec
from jolt_atlas_tpu_torch.entry import entry

torch.set_num_threads(2)
I32_MIN, I32_MAX = -(2**31), 2**31 - 1
SHIFTS = (0, 1, 7, 8, 12, 16, 24)


def _big(a, b, shift: int, wrap: bool) -> np.ndarray:
    """Python-integer oracle of kernel 9's function."""
    out = np.empty((a.shape[0], b.shape[1]), dtype=np.int64)
    for i in range(a.shape[0]):
        for j in range(b.shape[1]):
            s = sum(int(x) * int(y) for x, y in zip(a[i], b[:, j]))
            if wrap:
                s = (s + 2**63) % 2**64 - 2**63
            out[i, j] = min(max(s >> shift, I32_MIN), I32_MAX)
    return out.astype(np.int32)


def _operands(kind: str, M: int, K: int, N: int, seed: int):
    gen = np.random.default_rng(seed)
    if kind == "max":
        return (np.full((M, K), I32_MAX, np.int32),
                np.full((K, N), I32_MAX, np.int32))
    if kind == "min":
        return (np.full((M, K), I32_MIN, np.int32),
                np.full((K, N), I32_MIN, np.int32))
    if kind == "mixed":
        a = np.full((M, K), I32_MIN, np.int32)
        b = np.full((K, N), I32_MAX, np.int32)
        a[:, ::3] = I32_MAX
        return a, b
    return (gen.integers(I32_MIN, I32_MAX, size=(M, K), dtype=np.int32),
            gen.integers(I32_MIN, I32_MAX, size=(K, N), dtype=np.int32))


@pytest.mark.parametrize("kind", ["max", "min", "mixed", "random"])
def test_exact_matmul_edges_match_reference(kind):
    """K = 4096 at the operands' extremes: kernel 9's plain version equals
    jaxexec.exact_matmul_rescale at every shift, and Python integers."""
    a, b = _operands(kind, 3, 4096, 5, 7)
    ta, tb = torch.from_numpy(a)[None], torch.from_numpy(b)[None]
    for shift in SHIFTS:
        got = torchexec.exact_matmul(ta, tb, shift)[0].numpy()
        ref = np.asarray(jaxexec.exact_matmul_rescale(
            jnp.asarray(a), jnp.asarray(b), shift))
        assert np.array_equal(got, ref), shift
        assert np.array_equal(got, _big(a, b, shift, False)), shift


@pytest.mark.parametrize("kind", ["max", "min", "mixed", "random"])
def test_exact_matmul_wrap_matches_int64_einsum(kind):
    """Wrapping mode: the sum mod 2^64 as XLA's s64 einsum (jaxexec's
    general branch) and Python integers give it."""
    a, b = _operands(kind, 2, 4096, 3, 8)
    for shift in SHIFTS:
        got = torchexec.exact_matmul(torch.from_numpy(a)[None],
                                     torch.from_numpy(b)[None], shift,
                                     wrap=True)[0].numpy()
        acc = jnp.einsum("mk,kn->mn", jnp.asarray(a, jnp.int64),
                         jnp.asarray(b, jnp.int64))
        ref = np.asarray(jaxexec._clamp_i32(jaxexec._floor_div_pow2(acc,
                                                                  shift)))
        assert np.array_equal(got, ref), shift
        assert np.array_equal(got, _big(a, b, shift, True)), shift


@pytest.mark.parametrize("kind", ["max", "min", "mixed"])
def test_exact_matmul_wrap_deep(kind):
    """Wrapping mode at K = 16,384, past the depth whose int32 digit sums
    kernel 9 folds (8,192): the plain version equals Python integers."""
    a, b = _operands(kind, 2, 16384, 3, 9)
    for shift in (0, 12, 63):
        got = torchexec.exact_matmul_plain(torch.from_numpy(a)[None],
                                           torch.from_numpy(b)[None], shift,
                                           wrap=True)[0].numpy()
        assert np.array_equal(got, _big(a, b, shift, True)), shift


def _plan_holds(B, M, K, N, sms):
    """exact_plan's definition: the tile by M, whole slices, every split
    non-empty and at most EXACT_MAX_CHUNK deep."""
    tile, splits, kchunk = torchexec.exact_plan(B, M, K, N, sms)
    bm, bn, bk, per_sm = torchexec.EXACT_TILES[tile]
    assert tile == (1 if M <= 16 else 0)
    assert kchunk % bk == 0 and bk <= kchunk <= torchexec.EXACT_MAX_CHUNK
    assert splits * kchunk >= K and (K == 0 or (splits - 1) * kchunk < K)
    return tile, splits, kchunk


@pytest.mark.parametrize("shape", [(1, 1024, 768, 3072), (1, 16, 1024, 4096),
                                   (1, 8, 64, 128), (1, 8, 128, 32),
                                   (4, 64, 16, 64), (1, 3, 16384, 5),
                                   (1, 129, 4096, 129), (1, 1, 1, 1),
                                   (2, 16, 0, 8), (1, 17, 100_000, 3),
                                   (30000, 16, 4096, 8), (1, 1024, 8192, 1024),
                                   (1, 1024, 8193, 1024),
                                   (1, 1024, 16384, 1024),
                                   (1, 1024, 100_000, 1024)])
def test_exact_plan(shape):
    B, M, K, N = shape
    tile, splits, kchunk = _plan_holds(B, M, K, N, 132)
    bm, bn, bk, per_sm = torchexec.EXACT_TILES[tile]
    tiles = B * -(-M // bm) * -(-N // bn)
    # the definition: as many splits as still fit in one wave of the
    # persistent grid (per_sm blocks an SM), each at least 4 slices deep,
    # at least one a 8,192 of depth
    target = max(-(-K // 8192) if K else 1,
                 min(max(1, per_sm * 132 // tiles), max(1, K // (4 * bk))))
    assert kchunk == max(bk, -(-(-(-K // target)) // bk) * bk)
    assert splits == max(1, -(-K // kchunk)) <= target


def test_exact_plan_timed_shapes():
    """The two timed shapes: a GPT-2 product at 64 x 64 tiles unsplit,
    and its MLP product at seq 16 on 16 x 64 tiles split 2 ways (64
    tiles, 132 SMs: 128 tiles in one wave)."""
    assert torchexec.exact_plan(1, 1024, 768, 3072, 132) == (0, 1, 768)
    assert torchexec.exact_plan(1, 16, 1024, 4096, 132) == (1, 2, 512)
    # the entry's MLP products stay one launch each
    assert torchexec.exact_plan(1, 8, 64, 128, 132)[1] == 1
    assert torchexec.exact_plan(1, 8, 128, 32, 132)[1] == 1


def test_exact_matmul_refuses():
    a = torch.zeros((1, 2, 4097), dtype=torch.int32)
    b = torch.zeros((1, 4097, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="depth 4097"):
        torchexec.exact_matmul(a, b, 8)
    assert torchexec.exact_matmul(a, b, 8, wrap=True).shape == (1, 2, 2)
    with pytest.raises(ValueError, match="shift 64"):
        torchexec.exact_matmul(a[:, :, :4], b[:, :4], 64)
    with pytest.raises(ValueError, match="int32"):
        torchexec.exact_matmul(a.long(), b.long(), 8)


EQUATIONS = [("mk,kn->mn", (8, 16), (16, 4)),
             ("mk,nk->mn", (8, 16), (4, 16)),
             ("bi,ij->bj", (2, 16), (16, 8)),
             ("hmk,hnk->hmn", (4, 8, 16), (4, 8, 16)),
             ("hmn,hnk->hmk", (4, 8, 8), (4, 8, 16)),
             ("bmk,kn->bmn", (2, 8, 16), (16, 4)),
             ("abmk,abkn->abmn", (2, 2, 4, 8), (2, 2, 8, 4)),
             ("kn,k->n", (16, 8), (16,)),
             ("ve,e->v", (8, 16), (16,))]


@pytest.mark.parametrize("eq,sa,sb", EQUATIONS)
def test_einsum_lowering(eq, sa, sb):
    """Each equation lowers to one (B, M, K) x (B, K, N) product through
    strided views, in both modes equal to torch.einsum in int64 (at K <= 16
    nothing wraps)."""
    gen = np.random.default_rng(len(eq))
    x = torch.from_numpy(gen.integers(-2**20, 2**20, size=sa, dtype=np.int32))
    y = torch.from_numpy(gen.integers(-2**20, 2**20, size=sb, dtype=np.int32))
    want = torch.einsum(eq, x.long(), y.long())
    a, b, finish = torchexec.lower_einsum(eq, x, y)
    assert a.dim() == b.dim() == 3
    for wrap in (False, True):
        got = finish(torchexec.exact_matmul(a, b, 4, wrap))
        assert torch.equal(got.long(), (want >> 4).clamp(I32_MIN, I32_MAX))


@pytest.mark.parametrize("eq", ["ij,jk,kl->il", "ii->i", "ij->j",
                                "ik,jk->i", "...k,kn->...n"])
def test_einsum_that_does_not_lower(eq):
    shapes = {"ij,jk,kl->il": [(2, 2)] * 3, "ii->i": [(2, 2)],
              "ij->j": [(2, 2)], "ik,jk->i": [(2, 2), (2, 2)],
              "...k,kn->...n": [(2, 2), (2, 2)]}[eq]
    ops = [torch.ones(s, dtype=torch.int32) for s in shapes]
    assert torchexec.lower_einsum(eq, ops[0], ops[-1]) is None


# ---------------------------------------------------------------------------
# the forward against jaxexec and the numpy frontend
# ---------------------------------------------------------------------------

def _check(ref_model, inputs, frontend: bool = True):
    """The reference model's forward through jaxexec, the port's (built
    from its description) through torchexec on the CPU, and the numpy
    frontend (unless its magnitude contract refuses the inputs): all
    equal."""
    ref = jax.jit(jaxexec.compile_forward(ref_model))(
        *[jnp.asarray(x) for x in inputs])
    model = convert.model_from_reference(convert.describe_model(ref_model))
    got = torchexec.compile_forward(model, "cpu")(
        *[torch.from_numpy(np.asarray(x)) for x in inputs])
    want = ref_model.forward(inputs) if frontend else ref
    assert len(got) == len(ref) == len(want)
    for g, r, w in zip(got, ref, want):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), np.asarray(r))
        assert np.array_equal(g.numpy(), np.asarray(w))


rng = np.random.default_rng(21)


def test_mlp_matches_reference():
    model, xq = jaxexec.example_mlp(batch=4, din=32, dh=32, dout=16)
    _check(model, [xq])


def test_example_mlp_is_the_reference_model():
    ref_model, ref_x = jaxexec.example_mlp()
    model, xq = torchexec.example_mlp()
    assert np.array_equal(xq, ref_x)
    assert np.array_equal(model.forward([xq])[0], ref_model.forward([xq])[0])
    _check(ref_model, [ref_x])


def test_mixed_ops():
    s = 8
    b = RefBuilder(scale=s)
    x = b.input([4, 8])
    c = b.constant(quantize_tensor(rng.normal(size=(4, 8)), s))
    m = b.mul(x, c)
    sq = b.square(m)
    r = b.relu(b.sub(sq, c))
    b.output(b.reshape(r, [32]))
    _check(b.build(), [quantize_tensor(rng.normal(size=(4, 8)), s)])


def test_gather_iff_concat():
    b = RefBuilder()
    dict_w = b.constant(rng.integers(-50, 50, size=(8, 4)).astype(np.int32))
    idx = b.input([4])
    g = b.gather(dict_w, idx)
    g2 = b.move_axis(g, 0, 1)
    b.output(b.concat([g, b.move_axis(g2, 0, 1)], axis=1))
    _check(b.build(), [np.array([1, 0, 7, 3], dtype=np.int32)])


def _every_op_model(s: int = 8):
    """One graph through every op _node_fn takes: add, sub, mul (rescaled
    and raw), square (both), cube (both), neg, identity, reshape,
    broadcast, move_axis, slice, concat, gather, sum, mean_of_squares,
    iff, and, clamp, relu, and einsums of every lowered form."""
    b = RefBuilder(scale=s)
    x = b.input([4, 8])
    y = b.input([4, 8])
    c = b.constant(quantize_tensor(rng.normal(size=(4, 8)), s))
    w = b.constant(quantize_tensor(rng.normal(size=(8, 8)) * 0.5, s))
    h = b.add(b.mul(x, c), b.sub(y, b.square(x)))
    h = b.add(h, b.mul(b.relu(x), y, scale=0))
    h = b.add(h, b.cube(b.slice(b.concat([x, y], 1), 1, 4, 12)))
    h = b.add(h, b.square(b.identity(b.neg(y)), scale=0))
    m = b.einsum("mk,kn->mn", [h, w])
    t = b.einsum("mk,nk->mn", [m, h])                     # (4, 4)
    t3 = b.reshape(b.broadcast(b.reshape(t, [1, 4, 4]), [2, 4, 4]),
                   [2, 4, 4])
    hh = b.move_axis(b.reshape(b.concat([m, m], 0), [2, 4, 8]), 0, 0)
    u = b.einsum("hmn,hnk->hmk", [t3, hh])                 # (2, 4, 8)
    v = b.einsum("hmk,hnk->hmn", [u, hh])                  # (2, 4, 4)
    z = b.einsum("bi,ij->bj", [b.reshape(v, [2, 16]),
                               b.constant(rng.integers(-60, 60, size=(16, 8)
                                                       ).astype(np.int32))])
    mask = b.and_(b.relu(x), y)
    sel = b.iff(mask, x, y)
    g = b.gather(b.constant(rng.integers(-90, 90, size=(8, 8)
                                         ).astype(np.int32)),
                 b.input([4]))
    b.output(z)
    b.output(b.cube(b.sub(x, y), scale=0))
    b.output(b.sum(b.add(sel, g), [1]))
    b.output(b.mean_of_squares(m, [1]))
    b.output(b.clamp(b.add(sel, m), 1, 200))
    b.output(b.clamp(b.reshape(sel, [32]), 1, 300))
    return b.build()


def test_every_op_matches_reference():
    model = _every_op_model()
    xs = [quantize_tensor(rng.normal(size=(4, 8)) * 0.25, 8),
          quantize_tensor(rng.normal(size=(4, 8)) * 0.25, 8),
          np.array([5, 0, 7, 2], dtype=np.int32)]
    _check(model, xs)


BIG = np.array([[I32_MAX, I32_MIN, I32_MAX, -5],
                [I32_MIN, 7, I32_MAX - 1, I32_MIN + 1]], np.int32)


def test_saturation_edges_match_reference():
    """Inputs at the i32 extremes: saturating add, rescaled mul, square
    and cube, negation and a saturating product (the numpy frontend's
    magnitude contract refuses these inputs: jaxexec is the reference)."""
    s = 8
    b = RefBuilder(scale=s)
    x = b.input([2, 4])
    y = b.input([2, 4])
    b.output(b.add(x, y))
    b.output(b.mul(x, y))
    b.output(b.square(x))
    b.output(b.cube(y))
    b.output(b.neg(x))
    b.output(b.matmul(x, b.reshape(y, [4, 2])))
    _check(b.build(), [BIG, BIG[::-1].copy()], frontend=False)


def test_sub_saturates_as_the_frontend():
    """a - b saturates in int64, as the numpy frontend's Sub. jaxexec
    negates b in int32 first (saturating_add, jaxexec.py:116), so at b =
    -2^31 it adds -2^31 instead: the one place the port follows the
    frontend and not jaxexec (ROADMAP queue 3). Elsewhere they agree."""
    b = RefBuilder(scale=8)
    x = b.input([2, 4])
    y = b.input([2, 4])
    b.output(b.sub(x, y))
    model = b.build()
    xs, ys = BIG, BIG[::-1].copy()
    want = np.clip(xs.astype(np.int64) - ys, I32_MIN, I32_MAX)
    got = torchexec.compile_forward(
        convert.model_from_reference(convert.describe_model(model)), "cpu")(
        torch.from_numpy(xs), torch.from_numpy(ys))[0].numpy()
    assert np.array_equal(got, want)
    ref = np.asarray(jax.jit(jaxexec.compile_forward(model))(
        jnp.asarray(xs), jnp.asarray(ys))[0])
    keep = ys != I32_MIN
    assert np.array_equal(got[keep], ref[keep])
    assert not np.array_equal(got[~keep], ref[~keep])
    small = [quantize_tensor(rng.normal(size=(2, 4)), 8) for _ in range(2)]
    _check(model, small)


def test_lut_ops_raise():
    b = RefBuilder(scale=8)
    x = b.input([4])
    b.output(b.tanh(x))
    model = convert.model_from_reference(convert.describe_model(b.build()))
    fn = torchexec.compile_forward(model, "cpu")
    with pytest.raises(NotImplementedError, match="f64-LUT"):
        fn(torch.zeros(4, dtype=torch.int32))


def test_compile_forward_defaults_to_the_card():
    """Without a device argument the forward asks for the card: here, with
    none, it raises instead of running on the host."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device exists")
    model, _ = torchexec.example_mlp()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torchexec.compile_forward(model)


def test_entry_on_cpu():
    fn, (x,) = entry(device="cpu")
    model, xq = torchexec.example_mlp()
    out = fn(x)
    assert out[0].device.type == "cpu"
    assert np.array_equal(out[0].numpy(), model.forward([xq])[0])
    ref_fn = jax.jit(jaxexec.compile_forward(jaxexec.example_mlp()[0]))
    assert np.array_equal(out[0].numpy(), np.asarray(ref_fn(
        jnp.asarray(xq))[0]))
    with pytest.raises(ValueError, match="an input on"):
        torchexec.compile_forward(model, "meta")(x)
