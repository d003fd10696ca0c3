"""The operand bind (jolt_atlas_tpu_torch/device/bind.py ``bind_operand``)
against the JAX package's own binds, on the CPU, under the engine's scope
(its kernel wrapper runs the plain version there) and with no scope (the
host path).

- each caller's layout, element for element against the JAX package's
  EinsumLayout.bound_operand (object-dtype np.einsum mod r) or
  softmax_op._expsum_bound: the Einsum operands the benchmark's cells bind
  (a weight bound over its last axis, mk,kn->mn, and its activation, the
  tied head's 1,024 x 8,192 constant, attention's hmk,hnk->hmn and
  hmn,hnk->hmk with the exclusive char in the middle, an operand with no
  exclusive char, two exclusive chars, a scalar bound), Sum's input over
  one, two and all its axes, Gather's dictionary, GatherLarge's (V not a
  power of 16, zero-extended to 16^D rows) and Softmax's exp sums, at
  int32 and int64 extremes;
- csrc/bind.cu's arithmetic, modelled step by step in Python integers (the
  offset word sums, their limbs' bounds, the Montgomery reductions and the
  constants read from the source), against the plain version;
- a small GPT proved twice by one prover with the engine forced: both
  proofs the host path's bytes, both verified, the constants uploaded at
  the first proof only;
- the scope's decisions and counters, its decline (no host field engine)
  giving the host path's values, and the layout's refusal of an operand
  with a repeated char.

Tolerance: exact everywhere.
"""

import contextlib
import os
import re

import numpy as np
import pytest
import torch

from jolt_atlas_tpu.field import vec as ref_vec
from jolt_atlas_tpu.field.scalar import Fr as RefFr
from jolt_atlas_tpu.zkops.ops import EinsumLayout as RefLayout
from jolt_atlas_tpu.zkops.softmax_op import _expsum_bound as ref_expsum
from jolt_atlas_tpu_torch import models, serde
from jolt_atlas_tpu_torch.device import bind as B
from jolt_atlas_tpu_torch.device import rows as drows
from jolt_atlas_tpu_torch.device import split, telemetry
from jolt_atlas_tpu_torch.field import frvec, vec
from jolt_atlas_tpu_torch.field.constants import FR_MODULUS
from jolt_atlas_tpu_torch.field.scalar import Fr
from jolt_atlas_tpu_torch.preprocessing import AtlasPreprocessing
from jolt_atlas_tpu_torch.prover import AtlasProver
from jolt_atlas_tpu_torch.verifier import AtlasVerifier
from jolt_atlas_tpu_torch.zkops.ops import (EinsumLayout, _dict_bound,
                                            _sum_bound)
from jolt_atlas_tpu_torch.zkops.softmax_op import _expsum_bound
from test_torch_reduction import CSRC, _redc_sum

# the suite runs in several worker processes at once: a small intra-op
# pool keeps this file from starving its neighbours' timed tests
torch.set_num_threads(2)


def _sizes(equation: str, in_dims: list) -> tuple:
    lhs, rhs = equation.split("->")
    sizes = {ch: d for term, dims in zip(lhs.split(","), in_dims)
             for ch, d in zip(term, dims)}
    return tuple(sizes[c] for c in rhs)


def _layout(equation: str, in_dims: list) -> EinsumLayout:
    return EinsumLayout(equation, in_dims, _sizes(equation, in_dims))


def _ints(n: int, gen) -> list[int]:
    return [int.from_bytes(gen.bytes(32), "little") % FR_MODULUS
            for _ in range(n)]


def _operand(dims, dtype, gen) -> np.ndarray:
    """Random values of dtype, its extremes (and 0, -1) first."""
    info = np.iinfo(dtype)
    a = gen.integers(info.min, info.max, size=dims, dtype=np.int64,
                     endpoint=True).astype(dtype)
    a.flat[:4] = (info.min, info.max, 0, -1)[:a.size]
    return a


def _values(fvec) -> list[int]:
    return [int(x) for x in vec.as_object(fvec)]


# each caller's layout: (a thunk of the port's bind, the JAX package's
# values, the operand elements bound)

def _einsum(args, dtype, gen):
    """_prove_einsum's: the operand laid out by EinsumLayout, bound, then
    broadcast along the domain chars its term lacks."""
    equation, dims, which = args
    lay = _layout(equation, dims)
    point = _ints(sum(lay.char_vars(c) for c in lay.out_chars), gen)
    groups = lay.split_out_point([Fr(x) for x in point])
    term, arr = lay.terms[which], _operand(dims[which], dtype, gen)
    ref = RefLayout(equation, dims, _sizes(equation, dims))
    want = ref.bound_operand(arr, term, ref.split_out_point(
        [RefFr(x) for x in point])).fvec

    def run():
        perm, K, E, points, kept = lay.operand_layout(term, groups)
        return lay.broadcast_bound(B.bind_operand(arr, perm, K, E, points),
                                   kept)
    return run, want, arr.size


def _sum(args, dtype, gen):
    """_prove_sum's: the input bound at its kept axes' points; the JAX
    package's the same bind as the einsum <input>,<summed>-><kept>."""
    dims, axes = args
    x = _operand(dims, dtype, gen)
    chars = "abcdefgh"[:len(dims)]
    kept = [ax for ax in range(len(dims)) if ax not in axes]
    pts = {ax: _ints(dims[ax].bit_length() - 1, gen) for ax in kept}
    info = [(False, [Fr(v) for v in pts[ax]]) if ax in pts
            else (True, d.bit_length() - 1) for ax, d in enumerate(dims)]
    eqn = (f"{chars},{''.join(chars[a] for a in axes)}->"
           f"{''.join(chars[a] for a in kept)}")
    ref = RefLayout(eqn, [dims, tuple(dims[a] for a in axes)],
                    tuple(dims[a] for a in kept))
    want = ref.bound_operand(x, chars, {chars[a]: [RefFr(v) for v in pts[a]]
                                        for a in kept}).fvec
    return lambda: _sum_bound(x, info), want, x.size


def _gather(args, dtype, gen):
    """Gather's and GatherLarge's: the dictionary's V rows bound at r_e,
    zero-extended to ``rows``; the JAX package's the zero-padded
    dictionary bound as the einsum ve,v->e."""
    dims, rows = args
    d = _operand(dims, dtype, gen)
    V = dims[0]
    E = d.size // V
    pts = _ints(E.bit_length() - 1, gen)
    padded = np.zeros((rows, E), dtype=np.int64)
    padded[:V] = d.reshape(V, E)
    ref = RefLayout("ve,v->e", [(rows, E), (rows,)], (E,))
    want = ref.bound_operand(padded, "ve",
                             {"e": [RefFr(v) for v in pts]}).fvec
    return lambda: _dict_bound(d, [Fr(v) for v in pts], rows), want, d.size


def _softmax(args, dtype, gen):
    """Softmax's exp sums, against the JAX package's _expsum_bound."""
    F_n, N = args
    q = _operand((F_n * N,), dtype, gen)
    pts = _ints(F_n.bit_length() - 1, gen)
    want = ref_expsum(q, F_n, N, [RefFr(v) for v in pts])
    return lambda: _expsum_bound(q, F_n, N, [Fr(v) for v in pts]), want, \
        q.size


CALLERS = {"einsum": _einsum, "sum": _sum, "gather": _gather,
           "softmax": _softmax}

# (caller, its layout, dtype): Einsum (equation, operand dims, the operand
# bound); Sum (input dims, summed axes); Gather (dictionary dims, rows);
# Softmax (F_n, N)
CASES = {
    "weight": ("einsum", ("mk,kn->mn", [(16, 256), (256, 1024)], 1),
               np.int32),
    "activation": ("einsum", ("mk,kn->mn", [(16, 256), (256, 1024)], 0),
                   np.int32),
    "tied head": ("einsum", ("mk,kn->mn", [(16, 1024), (1024, 8192)], 1),
                  np.int32),
    "attention q": ("einsum", ("hmk,hnk->hmn", [(4, 16, 64)] * 2, 0),
                    np.int32),
    "attention k": ("einsum", ("hmk,hnk->hmn", [(4, 16, 64)] * 2, 1),
                    np.int32),
    "attention weights": ("einsum", ("hmn,hnk->hmk", [(4, 16, 16),
                                                      (4, 16, 64)], 0),
                          np.int32),
    "attention v": ("einsum", ("hmn,hnk->hmk", [(4, 16, 16), (4, 16, 64)],
                               1), np.int32),
    "no exclusive char": ("einsum", ("mk,k->m", [(8, 64), (64,)], 1),
                          np.int32),
    "two exclusive chars": ("einsum", ("ab,bcd->acd", [(4, 8), (8, 2, 16)],
                                       1), np.int32),
    "a scalar bound": ("einsum", ("m,n->mn", [(8,), (4,)], 0), np.int32),
    "int64 weight": ("einsum", ("mk,kn->mn", [(16, 64), (64, 256)], 1),
                     np.int64),
    "int64 attention": ("einsum", ("hmk,hnk->hmn", [(2, 8, 16)] * 2, 0),
                        np.int64),
    "sum over the last axis": ("sum", ((4, 16, 64), (2,)), np.int32),
    "sum over two axes": ("sum", ((8, 4, 16), (0, 2)), np.int64),
    "sum over every axis": ("sum", ((16, 8), (0, 1)), np.int32),
    "gather": ("gather", ((64, 32), 64), np.int32),
    "gather a vector": ("gather", ((16,), 16), np.int64),
    "gather large": ("gather", ((32, 16), 256), np.int32),
    "gather large, int64": ("gather", ((512, 8), 4096), np.int64),
    "softmax": ("softmax", (16, 64), np.int64),
    "softmax, int32": ("softmax", (8, 16), np.int32),
}


@pytest.mark.parametrize("where", ["card", "host"])
@pytest.mark.parametrize("case", list(CASES))
def test_engine_bind_equals_host_bind(case, where):
    caller, args, dtype = CASES[case]
    run, want, elements = CALLERS[caller](args, dtype,
                                          np.random.default_rng(len(case)))
    telemetry.reset()
    sc = B.Scope("cpu") if where == "card" else None
    with sc or contextlib.nullcontext():
        got = run()
    assert isinstance(got, frvec.FrArray)
    assert _values(got) == [int(x) for x in ref_vec.as_object(want)]
    tele = telemetry.snapshot()
    c = tele["counters"]
    if sc is None:
        assert c["einsum_bind_host"] == elements
        assert "einsum_bind_card" not in c and "einsum_bind" not in \
            tele["decisions"]
    else:
        assert (sc.offered, sc.engaged, sc.declined) == (1, 1, {})
        assert c["einsum_bind_card"] == elements
        assert "einsum_bind_host" not in c
        assert tele["decisions"]["einsum_bind"] == (
            f"ENGAGED (1 of 1 binds, {elements} operand elements, 1 "
            f"dispatches)")
    assert tele["launches"] == {}  # CPU tensors: the plain version only


# ---------------------------------------------------------------------------
# the kernel's arithmetic
# ---------------------------------------------------------------------------

def _kernel_constants() -> list[int]:
    """bind_const's three values in csrc/bind.cu."""
    text = open(os.path.join(CSRC, "bind.cu")).read()
    body = text[text.index("constexpr u32 C[3][8]"):]
    arrays = re.findall(r"\{(0x[^{}]*)\}", body[:body.index("};")])
    return [sum(int(x.strip().rstrip("u"), 16) << (32 * i)
                for i, x in enumerate(a.split(","))) for a in arrays]


def _kernel_model(A: np.ndarray, eq: list[int], width: int) -> list[int]:
    """csrc/bind.cu's function, step by step: each row's sum of the offset
    words u = a + 2^(8 width - 1) times eq, and the sum of eq, as the
    kernel's limbs hold them; each reduced by mont_redc_sum (one product)
    and a Montgomery product by the source's constant; their difference."""
    p, R = FR_MODULUS, 1 << 256
    r2, off31, off63 = _kernel_constants()
    shift = 8 * width - 1
    mont = lambda x, c: x * c * pow(R, -1, p) % p
    out = []
    for row in A.tolist():
        acc = sum((a + (1 << shift)) * e for a, e in zip(row, eq))
        s = sum(eq)
        assert acc < 1 << 352 and s < 1 << 288  # BIND_ACC's 11 limbs used
        value = mont(_redc_sum(acc, 1), r2)
        offset = mont(_redc_sum(s, 1), off31 if width == 4 else off63)
        out.append((value - offset) % p)
    return out


def test_kernel_constants_are_r2_and_the_offsets():
    p, R = FR_MODULUS, 1 << 256
    assert _kernel_constants() == [R * R % p, (1 << 31) * R * R % p,
                                   (1 << 63) * R * R % p]


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_kernel_arithmetic_equals_plain(dtype):
    """The model of the kernel against the plain version on random values
    and at the sums' worst case (every a at an extreme, every eq r - 1)."""
    gen = np.random.default_rng(7)
    K, E = 6, 300
    A = _operand((K, E), dtype, gen)
    info = np.iinfo(dtype)
    A[4], A[5] = info.min, info.max
    eq = [int.from_bytes(gen.bytes(32), "little") % FR_MODULUS
          for _ in range(E)]
    eq[:3] = [FR_MODULUS - 1, 0, 1]
    limbs = np.array([[(x >> (64 * i)) & ((1 << 64) - 1) for i in range(4)]
                      for x in eq], dtype=np.uint64)
    got = B.bind_plain(torch.from_numpy(A),
                       torch.from_numpy(limbs.view(np.int64)))
    plain = [sum((int(v) & ((1 << 64) - 1)) << (64 * i)
                 for i, v in enumerate(row)) for row in got.tolist()]
    want = [sum(int(a) * e for a, e in zip(row, eq)) % FR_MODULUS
            for row in A.tolist()]
    assert plain == want == _kernel_model(A, eq, A.itemsize)


def test_kernel_sums_fit_their_limbs_at_the_largest_row():
    """At 2^32 - 1 elements a row, every word and eq at its largest, the
    offset sum fits the 11 limbs the element loop carries into (the int64
    word's high half added a limb up) and the eq sum its 9."""
    n, eqmax = (1 << 32) - 1, FR_MODULUS - 1
    assert n * ((1 << 64) - 1) * eqmax < 1 << 352
    assert n * eqmax < 1 << 288


def test_group_sizes():
    """At least 4 elements a lane, a power of two, at most a block."""
    assert [B.group(E) for E in (1, 2, 4, 8, 16, 17, 64, 1000, 1024,
                                 8192)] == [1, 1, 1, 2, 4, 8, 16, 256, 256,
                                            256]


# ---------------------------------------------------------------------------
# the scope and its decline
# ---------------------------------------------------------------------------

def test_scope_records_its_decisions():
    telemetry.reset()
    assert B.Scope("cuda").device.type == "cuda"  # no card needed
    telemetry.tally("einsum_bind_card", 11)  # before the scope: not its
    with B.Scope("cpu") as sc:
        assert B.Scope.entered is sc
        sc.offered, sc.engaged = 3, 2
        telemetry.tally("einsum_bind_card", 5)
        telemetry.count("einsum_bind", 2)
        sc.decline("no host field engine")
    d = telemetry.snapshot()["decisions"]
    assert d["einsum_bind"] == ("ENGAGED (2 of 3 binds, 5 operand "
                                "elements, 2 dispatches)")
    assert d["einsum_bind:declined"] == "no host field engine: 1"
    assert B.Scope.entered is None
    with B.Scope("cpu"):
        pass
    assert telemetry.snapshot()["decisions"]["einsum_bind"] == \
        "none engaged (0 binds offered)"


@pytest.mark.parametrize("why", ["no scope", "no host field engine"])
def test_a_decline_leaves_the_host_path(why, monkeypatch):
    """The host path's values, as the engine's: with no scope, and under a
    scope where the host field engine did not load (the scope counts the
    decline; the values come back as canonical ints)."""
    run, _, _ = _einsum(("mk,kn->mn", [(4, 8), (8, 16)], 1), np.int32,
                        np.random.default_rng(5))
    with B.Scope("cpu"):
        want = _values(run())
    if why == "no host field engine":
        monkeypatch.setattr(frvec, "available", lambda: False)
    sc = None if why == "no scope" else B.Scope("cpu")
    with sc or contextlib.nullcontext():
        got = run()
    assert [int(x) for x in vec.as_object(got)] == want
    if sc is not None:
        assert (sc.offered, sc.engaged, sc.declined) == (1, 0, {why: 1})


def test_layout_refuses_a_repeated_char():
    """An operand with a repeated char has no (K, E) layout, and its proof
    could not verify: the layout refuses it."""
    with pytest.raises(AssertionError, match="repeated char"):
        _layout("ii,i->i", [(8, 8), (8,)])


# ---------------------------------------------------------------------------
# a model, proved twice
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_gpt():
    """BENCH_SMALL's nanoGPT at two heads, and two token sequences."""
    rng = np.random.default_rng(1234)
    model = models.build_nanogpt(32, 8, 16, 1, 8, rng, heads=2)
    toks = [rng.integers(0, 32, size=8).astype(np.int32) for _ in range(2)]
    return AtlasPreprocessing.preprocess(model), toks


def test_forced_engine_proves_twice_with_the_host_paths_bytes(small_gpt,
                                                              monkeypatch):
    """One prover, the engine forced (the rows engine held back by its
    size floor), two proofs of different tokens: each the host path's
    bytes and verified; every bind on the engine (the Einsum operands, the
    dictionary, the sums and the exp sums); the constant operands uploaded
    at the first proof and reused, the others at every proof."""
    pp, toks = small_gpt
    split.set_host_threads(2)
    uploads, binds = [], []
    real, real_bind = B.upload, B.bind_operand
    monkeypatch.setattr(B, "upload", lambda *a: uploads.append(a) or real(
        *a))
    monkeypatch.setattr(B, "bind_operand", lambda *a: binds.append(
        (a[5] if len(a) > 5 else None, a[1])) or real_bind(*a))
    try:
        prover = AtlasProver(pp, device="cpu",
                             iop_gate=drows.forced(min_n=1 << 30))
        counts, kept, seen = [], None, []
        for t in toks:
            telemetry.reset()
            want, _ = AtlasProver(pp, device="cpu").prove([t])
            host = telemetry.snapshot()["counters"]
            assert host["einsum_bind_host"] > host["einsum_bind_elements"]
            assert "einsum_bind_card" not in host
            telemetry.reset()
            del uploads[:], binds[:]
            got, io = prover.prove([t])
            tele = telemetry.snapshot()
            counts.append(len(uploads))
            seen.append(list(binds))
            blob = serde.serialize_proof(got)
            assert blob == serde.serialize_proof(want)
            assert AtlasVerifier(pp).verify(serde.deserialize_proof(blob),
                                            io)
            c = tele["counters"]
            assert c["einsum_bind_card"] == host["einsum_bind_host"]
            assert c["einsum_bind_elements"] == host["einsum_bind_elements"]
            assert "einsum_bind_host" not in c
            assert tele["decisions"]["einsum_bind"] == (
                f"ENGAGED ({len(binds)} of {len(binds)} binds, "
                f"{c['einsum_bind_card']} operand elements, {len(binds)} "
                f"dispatches)")
            if kept is None:
                kept = dict(prover.bind_residents)
    finally:
        split.set_host_threads(None)
    einsums = [n for n in pp.model.graph.nodes.values()
               if type(n.operator).__name__ == "Einsum"]
    assert len(seen[0]) == len(seen[1]) > 2 * len(einsums)
    consts = {(i, perm) for i, perm in seen[0] if i is not None}
    assert consts and all(type(pp.model.graph.nodes[i].operator).__name__
                          == "Constant" for i, _ in consts)
    assert set(kept) == consts
    assert counts == [len(seen[0]), len(seen[1]) - sum(
        i is not None for i, _ in seen[1])]
    assert all(prover.bind_residents[k] is v for k, v in kept.items())
    assert all(v.dtype == torch.int32 for v in kept.values())
