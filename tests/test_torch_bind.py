"""The einsum bind engine (jolt_atlas_tpu_torch/device/bind.py) against the
host path, on the CPU, where its kernel wrapper runs the plain version (the
engine's scope forced, as the prover enters it where the rows gate is
forced).

- each layout the benchmark's cells bind, element for element against
  EinsumLayout.bound_operand (object-dtype np.einsum mod r): a weight bound
  over its last axis (mk,kn->mn) and its activation, the tied head's
  1,024 x 8,192 constant, attention's hmk,hnk->hmn and hmn,hnk->hmk with
  the exclusive char in the middle, an operand with no exclusive char, two
  exclusive chars, a scalar bound, at int32 and int64 extremes;
- csrc/bind.cu's arithmetic, modelled step by step in Python integers (the
  offset word sums, their limbs' bounds, the Montgomery reductions and the
  constants read from the source), against the plain version;
- a small GPT proved twice by one prover with the engine forced: both
  proofs the host path's bytes, both verified, the constants uploaded at
  the first proof only;
- the scope's decisions and counters, each decline (a mesh scope, a
  repeated char, no host field engine) giving the host path's values.

Tolerance: exact everywhere.
"""

import contextlib
import os
import re

import numpy as np
import pytest
import torch

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
from jolt_atlas_tpu_torch.zkops.ops import EinsumLayout
from test_torch_reduction import CSRC, _redc_sum

# the suite runs in several worker processes at once: a small intra-op
# pool keeps this file from starving its neighbours' timed tests
torch.set_num_threads(2)


def _layout(equation: str, in_dims: list) -> EinsumLayout:
    lhs, rhs = equation.split("->")
    sizes = {ch: d for term, dims in zip(lhs.split(","), in_dims)
             for ch, d in zip(term, dims)}
    return EinsumLayout(equation, in_dims, tuple(sizes[c] for c in rhs))


def _point(lay: EinsumLayout, gen) -> dict:
    n = sum(lay.char_vars(c) for c in lay.out_chars)
    return lay.split_out_point([
        Fr(int.from_bytes(gen.bytes(32), "little") % FR_MODULUS)
        for _ in range(n)])


def _operand(dims, dtype, gen) -> np.ndarray:
    """Random values of dtype, its extremes (and 0, -1) first."""
    info = np.iinfo(dtype)
    a = gen.integers(info.min, info.max, size=dims, dtype=np.int64,
                     endpoint=True).astype(dtype)
    a.flat[:4] = (info.min, info.max, 0, -1)[:a.size]
    return a


def _values(poly) -> list[int]:
    return [int(x) for x in vec.as_object(poly.fvec)]


# (equation, operand dims, the operand bound, dtype)
CASES = {
    "weight": ("mk,kn->mn", [(16, 256), (256, 1024)], 1, np.int32),
    "activation": ("mk,kn->mn", [(16, 256), (256, 1024)], 0, np.int32),
    "tied head": ("mk,kn->mn", [(16, 1024), (1024, 8192)], 1, np.int32),
    "attention q": ("hmk,hnk->hmn", [(4, 16, 64)] * 2, 0, np.int32),
    "attention k": ("hmk,hnk->hmn", [(4, 16, 64)] * 2, 1, np.int32),
    "attention weights": ("hmn,hnk->hmk", [(4, 16, 16), (4, 16, 64)], 0,
                          np.int32),
    "attention v": ("hmn,hnk->hmk", [(4, 16, 16), (4, 16, 64)], 1,
                    np.int32),
    "no exclusive char": ("mk,k->m", [(8, 64), (64,)], 1, np.int32),
    "two exclusive chars": ("ab,bcd->acd", [(4, 8), (8, 2, 16)], 1,
                            np.int32),
    "a scalar bound": ("m,n->mn", [(8,), (4,)], 0, np.int32),
    "int64 weight": ("mk,kn->mn", [(16, 64), (64, 256)], 1, np.int64),
    "int64 attention": ("hmk,hnk->hmn", [(2, 8, 16)] * 2, 0, np.int64),
}


@pytest.mark.parametrize("case", list(CASES))
def test_engine_bind_equals_host_bind(case):
    equation, dims, which, dtype = CASES[case]
    gen = np.random.default_rng(len(case))
    lay = _layout(equation, dims)
    groups = _point(lay, gen)
    term = lay.terms[which]
    arr = _operand(dims[which], dtype, gen)
    want = lay.bound_operand(arr, term, groups)
    telemetry.reset()
    with B.scope("cpu", forced=True) as sc:
        got = B.try_bind(lay, arr, term, groups)
    assert isinstance(got.fvec, frvec.FrArray)
    assert _values(got) == _values(want)
    assert (sc.offered, sc.engaged, sc.declined) == (1, 1, {})
    tele = telemetry.snapshot()
    assert tele["counters"]["einsum_bind_card"] == arr.size
    assert tele["decisions"]["einsum_bind"] == (
        f"ENGAGED (1 of 1 binds, {arr.size} operand elements, 1 "
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
# the scope and its declines
# ---------------------------------------------------------------------------

def test_scope_records_its_decisions():
    telemetry.reset()
    assert B.scope("cpu") is None
    assert telemetry.snapshot()["decisions"]["einsum_bind"] == \
        "host path (device=cpu)"
    assert B.scope("cuda").device.type == "cuda"  # no card needed
    telemetry.tally("einsum_bind_card", 11)  # before the scope: not its
    with B.scope("cpu", forced=True) as sc:
        sc.offered, sc.engaged = 3, 2
        telemetry.tally("einsum_bind_card", 5)
        telemetry.count("einsum_bind", 2)
        sc.decline("mesh scope")
    d = telemetry.snapshot()["decisions"]
    assert d["einsum_bind"] == ("ENGAGED (2 of 3 binds, 5 operand "
                                "elements, 2 dispatches)")
    assert d["einsum_bind:declined"] == "mesh scope: 1"
    assert B.active() is None
    with B.scope("cpu", forced=True):
        pass
    assert telemetry.snapshot()["decisions"]["einsum_bind"] == \
        "none engaged (0 binds offered)"


class _Mesh:
    mesh = object()


@pytest.mark.parametrize("why", ["no scope", "mesh scope", "a repeated char",
                                 "no host field engine"])
def test_a_decline_leaves_the_host_path(why, monkeypatch):
    gen = np.random.default_rng(5)
    equation, dims, term = (("ii,i->i", [(8, 8), (8,)], "ii")
                            if why == "a repeated char" else
                            ("mk,kn->mn", [(4, 8), (8, 16)], "kn"))
    lay = _layout(equation, dims)
    arr = _operand(dims[0] if term == "ii" else dims[1], np.int32, gen)
    groups = _point(lay, gen)
    if why == "mesh scope":
        from jolt_atlas_tpu_torch.parallel import shardedreduction
        monkeypatch.setattr(shardedreduction, "active_scope", _Mesh)
    if why == "no host field engine":
        monkeypatch.setattr(frvec, "available", lambda: False)
    sc = None if why == "no scope" else B.scope("cpu", forced=True)
    with sc or contextlib.nullcontext():
        assert B.try_bind(lay, arr, term, groups) is None
    if sc is not None:
        assert (sc.offered, sc.engaged, sc.declined) == (1, 0, {why: 1})


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
    bytes and verified; every bind on the engine; the constant operands
    uploaded at the first proof and reused, the others at every proof."""
    pp, toks = small_gpt
    split.set_host_threads(2)
    uploads = []
    real = B.upload
    monkeypatch.setattr(B, "upload", lambda *a: uploads.append(a) or real(
        *a))
    try:
        prover = AtlasProver(pp, device="cpu",
                             iop_gate=drows.forced(min_n=1 << 30))
        counts, kept = [], None
        for t in toks:
            telemetry.reset()
            want, _ = AtlasProver(pp, device="cpu").prove([t])
            host = telemetry.snapshot()["counters"]
            assert host["einsum_bind_host"] == host["einsum_bind_elements"]
            assert "einsum_bind_card" not in host
            telemetry.reset()
            del uploads[:]
            got, io = prover.prove([t])
            tele = telemetry.snapshot()
            counts.append(len(uploads))
            blob = serde.serialize_proof(got)
            assert blob == serde.serialize_proof(want)
            assert AtlasVerifier(pp).verify(serde.deserialize_proof(blob),
                                            io)
            c = tele["counters"]
            assert c["einsum_bind_card"] == c["einsum_bind_elements"] == \
                host["einsum_bind_elements"]
            assert "einsum_bind_host" not in c
            assert tele["decisions"]["einsum_bind"].startswith("ENGAGED")
            if kept is None:
                kept = dict(prover.bind_residents)
    finally:
        split.set_host_threads(None)
    einsums = [n for n in pp.model.graph.nodes.values()
               if type(n.operator).__name__ == "Einsum"]
    consts = sum(type(pp.model.graph.nodes[i].operator).__name__
                 == "Constant" for n in einsums for i in n.inputs)
    assert consts > 0 and len(kept) == consts
    assert counts == [2 * len(einsums), 2 * len(einsums) - consts]
    assert all(prover.bind_residents[k] is v for k, v in kept.items())
    assert all(v.dtype == torch.int32 for v in kept.values())
