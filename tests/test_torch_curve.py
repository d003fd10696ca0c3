"""The port's Fq arithmetic and complete point add (jolt_atlas_tpu_torch
device/field.py, device/curve.py) against the reference.

pp_add_plain is held bit-for-bit against the Pallas kernel's own body,
run on numpy (pallas_curve._pp_add_body(numpy, ...) interprets the kernel
without Pallas), and against big-int point addition of the reference's
curve/points.py. The field ops are held against Python big ints. Every
comparison is exact equality. The CUDA kernel itself is compared with the
plain version in tests/test_torch_cuda.py, which runs only on a GPU.
"""

import numpy as np
import pytest
import torch

from jolt_atlas_tpu.commitment.kzg import KZGSRS as RefSRS
from jolt_atlas_tpu.curve import points as ref_points
from jolt_atlas_tpu.field.constants import FQ_MODULUS
from jolt_atlas_tpu.tpu import pallas_curve
from jolt_atlas_tpu_torch.device import curve, field as F
from test_torch_srs import reference_native

# the suite runs in several worker processes at once: a small intra-op
# pool keeps this file from starving its neighbours' timed tests
torch.set_num_threads(2)

rng = np.random.default_rng(0xC0DE)
P = FQ_MODULUS


def _rand_fq(n):
    return [int.from_bytes(rng.bytes(32), "little") % P for _ in range(n)]


def _np_planes(t):
    """(n, 4) int64 limb tensor -> list of 16 numpy uint32 planes."""
    planes = F.to_planes(t).numpy().astype(np.uint32)
    return [planes[i] for i in range(16)]


def _pallas_body(Pt, Qt):
    """The Pallas kernel body on numpy planes -> (X, Y, Z) (16, n) int64."""
    out = pallas_curve._pp_add_body(
        np, tuple(_np_planes(t) for t in Pt), tuple(_np_planes(t) for t in Qt))
    return tuple(np.stack([np.asarray(p, dtype=np.int64) for p in c])
                 for c in out)


def _ref_point(x, y):
    return ref_points.G1.identity() if x == 0 and y == 0 \
        else ref_points.G1(x, y)


@pytest.fixture(scope="module")
def pairs():
    """1024 random pairs of SRS points, plus the edge cases: doubling,
    P + (-P), the identity on either side and on both."""
    reference_native()
    pts = list(RefSRS.setup(2047).g1_powers)
    A, B = pts[:1024], pts[1024:2048]
    g = ref_points.g1_generator()
    inf = ref_points.G1.identity()
    A += [g * 3, g * 3, inf, g * 5, inf]
    B += [g * 3, -(g * 3), g * 7, inf, inf]
    return A, B


def _to_tensors(points):
    xs = [0 if p.infinity else F.to_mont(p.x) for p in points]
    ys = [F.R_MONT if p.infinity else F.to_mont(p.y) for p in points]
    zs = [0 if p.infinity else F.R_MONT for p in points]
    return tuple(F.ints_to_tensor(v) for v in (xs, ys, zs))


def _to_ref(Pt):
    return [_ref_point(q.x, q.y) if not q.infinity else ref_points.G1.identity()
            for q in curve.tensors_to_points(Pt)]


class TestField:
    """Tolerance: exact (canonical Montgomery limbs)."""

    def test_mul_matches_bigint(self):
        a, b = _rand_fq(256) + [0, 1, P - 1], _rand_fq(256) + [P - 1, P - 1, 2]
        got = F.tensor_to_ints(F.mul4(F.ints_to_tensor(a),
                                      F.ints_to_tensor(b)))
        rinv = pow(1 << 256, -1, P)
        assert got == [x * y * rinv % P for x, y in zip(a, b)]

    def test_add_sub_match_bigint(self):
        a, b = _rand_fq(256) + [P - 1, 0, 5], _rand_fq(256) + [P - 1, P - 1, 5]
        ta, tb = F.ints_to_tensor(a), F.ints_to_tensor(b)
        assert F.tensor_to_ints(F.add4(ta, tb)) == \
            [(x + y) % P for x, y in zip(a, b)]
        assert F.tensor_to_ints(F.sub4(ta, tb)) == \
            [(x - y) % P for x, y in zip(a, b)]

    def test_montgomery_one_and_layout(self):
        t = F.ints_to_tensor([F.R_MONT, P - 1])
        assert torch.equal(F.from_planes(F.to_planes(t)), t)
        assert F.tensor_to_ints(F.mul4(t, t))[0] == F.R_MONT


class TestPointAdd:
    """Tolerance: exact, limb for limb and point for point."""

    def test_plain_matches_pallas_body(self, pairs):
        Pt, Qt = _to_tensors(pairs[0]), _to_tensors(pairs[1])
        got = curve.pp_add_plain(Pt, Qt)
        want = _pallas_body(Pt, Qt)
        for g, w in zip(got, want):
            assert np.array_equal(F.to_planes(g).numpy(), w)
        # projective inputs (Z != 1): add the sums to shifted sums
        sh = tuple(t.roll(1, 0) for t in got)
        got2 = curve.pp_add_plain(got, sh)
        for g, w in zip(got2, _pallas_body(got, sh)):
            assert np.array_equal(F.to_planes(g).numpy(), w)

    def test_plain_matches_pallas_body_near_p(self):
        """The shared edge cases (device/curve.py edge_case_pairs), raw
        coordinates near p included."""
        Pt, Qt = curve.edge_case_pairs("cpu")
        for g, w in zip(curve.pp_add_plain(Pt, Qt), _pallas_body(Pt, Qt)):
            assert np.array_equal(F.to_planes(g).numpy(), w)

    def test_plain_matches_bigint_points(self, pairs):
        A, B = pairs
        got = _to_ref(curve.pp_add(_to_tensors(A), _to_tensors(B)))
        assert got == [a + b for a, b in zip(A, B)]

    def test_conversions_round_trip(self, pairs):
        assert _to_ref(_to_tensors(pairs[0])) == pairs[0]
        ident = curve.pp_identity(3, "cpu")
        assert all(q.infinity for q in curve.tensors_to_points(ident))

    def test_wrapper_raises_off_cpu_and_cuda(self):
        meta = tuple(torch.empty((4, 4), dtype=torch.int64, device="meta")
                     for _ in range(3))
        with pytest.raises(ValueError):
            curve.pp_add(meta, meta)
        with pytest.raises(ValueError):
            curve.pp_add(tuple(t.to(torch.int32) for t in
                               curve.pp_identity(2, "cpu")),
                         curve.pp_identity(2, "cpu"))


def _mul_sum2_model(a: int, b: int, c: int, d: int) -> tuple:
    """csrc/fq.cuh mont_mul_sum2 over 32-bit words: 8 CIOS steps, each
    adding a b_i, c d_i and m p (m = t N0 mod 2^32) and shifting one word,
    then one conditional subtraction of p. (the largest running sum after
    a step, the value before the subtraction, the result)."""
    W = 1 << 32
    n0 = (-pow(P, -1, W)) % W
    t = top = 0
    for i in range(8):
        t += a * (b >> (32 * i) & (W - 1)) + c * (d >> (32 * i) & (W - 1))
        t += (t % W) * n0 % W * P
        assert t % W == 0 and t < 1 << 288  # 9 limbs: t[9] stays 0
        t >>= 32
        top = max(top, t)
    return top, t, t - P if t >= P else t


def _lazy_add_model(p1, p2, seen: dict) -> tuple:
    """csrc/fq.cuh pp_add_dev in big-int arithmetic: six Montgomery
    products, then X3, Y3 and Z3 each a sum of two products reduced once
    (the difference as t3 t1 + (p - t4) Y3). Montgomery ints in and out;
    ``seen`` notes a negated zero factor and the bounds reached."""
    rinv = pow(1 << 256, -1, P)
    mul = lambda a, b: a * b * rinv % P
    add = lambda a, b: (a + b) % P
    sub = lambda a, b: (a - b) % P
    (X1, Y1, Z1), (X2, Y2, Z2) = p1, p2
    t0, t1, t2 = mul(X1, X2), mul(Y1, Y2), mul(Z1, Z2)
    t3 = sub(mul(add(X1, Y1), add(X2, Y2)), add(t0, t1))
    t4 = sub(mul(add(Y1, Z1), add(Y2, Z2)), add(t1, t2))
    Y3 = sub(mul(add(X1, Z1), add(X2, Z2)), add(t0, t2))
    t0 = 3 * t0 % P
    t2 = 9 * t2 % P
    Z3, t1 = add(t1, t2), sub(t1, t2)
    Y3 = 9 * Y3 % P
    out = []
    for a, b, c, d in ((t3, t1, P - t4, Y3), (Y3, t0, t1, Z3),
                       (Z3, t4, t0, t3)):
        seen["p_factor"] = seen.get("p_factor", False) or c == P
        top, before, got = _mul_sum2_model(a, b, c, d)
        seen["top"] = max(seen.get("top", 0), top)
        seen["before"] = max(seen.get("before", 0), before)
        assert got == (a * b + c * d) * rinv % P
        out.append(got)
    return tuple(out)


def test_lazy_complete_add_model(pairs):
    """Kernel 1's add with three sums of two products each reduced once,
    modelled in big-int arithmetic over 32-bit words: limb for limb equal
    to pp_add_plain on 1,024 random pairs of SRS points, their projective
    sums, the identity, doubling and inverse cases (identity + identity
    gives t4 = 0, so p itself as a factor) and raw coordinates near p, and
    point for point equal to big-int addition. The sums' bounds, with a
    factor p and every other word at its largest: the running sum below
    4p after each step, the result below 2p (one subtraction)."""
    Pt, Qt = _to_tensors(pairs[0]), _to_tensors(pairs[1])
    S = curve.pp_add_plain(Pt, Qt)
    Pe, Qe = curve.edge_case_pairs("cpu")
    seen: dict = {}
    for A, B in ((Pt, Qt), (S, tuple(t.roll(1, 0) for t in S)), (Pe, Qe)):
        lanes = [list(zip(*(F.tensor_to_ints(t) for t in X))) for X in (A, B)]
        got = [_lazy_add_model(a, b, seen) for a, b in zip(*lanes)]
        want = curve.pp_add_plain(A, B)
        assert got == list(zip(*(F.tensor_to_ints(t) for t in want)))
        if A is Pt:
            model = tuple(F.ints_to_tensor(c) for c in zip(*got))
            assert _to_ref(model) == [a + b for a, b in zip(*pairs)]
    assert seen["p_factor"]
    assert seen["top"] < 4 * P and seen["before"] < 2 * P
    ones = (1 << 256) - 1  # every word 2^32 - 1: the steps at their largest
    top, before, _ = _mul_sum2_model(P, ones, P, ones)
    assert top < 4 * P
    _, before, got = _mul_sum2_model(P - 1, P - 1, P, P - 1)
    assert before < 2 * P and got == ((P - 1) ** 2 + P * (P - 1)) * pow(
        1 << 256, -1, P) % P
    import os
    fq = open(os.path.join(os.path.dirname(curve.__file__), "..", "csrc",
                           "fq.cuh")).read()
    assert "mont_mul_sum2<FqField>(t3, t1, mont_neg_raw<FqField>(t4), Y3)" \
        in fq


def _mont_ints(t):
    return F.tensor_to_ints(t)


def _affine_of(points):
    """Finite points -> (x, y) Montgomery limb tensors."""
    (xy, inf) = curve.points_to_affine(points, "cpu")
    assert not inf.any()
    return xy


class TestMixedAddAndDoubling:
    """Kernels 2 and 3's mixed add (RCB15 Algorithm 8) and doubling
    (Algorithm 9), csrc/fq.cuh pm_add_dev and pp_double_dev, as their plain
    versions. Tolerance: exact, limb for limb and point for point."""

    def _cases(self, pairs):
        """(P1 projective, P2 affine finite, big-int P1, big-int P2): random
        pairs with P1 projective (a sum, Z != 1), then P1 the identity, P1 =
        P2, P1 = -P2 and P2 a negated base."""
        A, B = pairs[0][:256], pairs[1][:256]
        S = curve.pp_add_plain(_to_tensors(A), _to_tensors(A[1:] + A[:1]))
        want1 = [a + b for a, b in zip(A, A[1:] + A[:1])]
        g = ref_points.g1_generator()
        p, q = g * 11, g * 13
        edge1 = [ref_points.G1.identity(), p, p, q]
        edge2 = [p, p, -p, q]
        P1 = tuple(torch.cat([s, e]) for s, e in
                   zip(S, _to_tensors(edge1)))
        x2, y2 = _affine_of(B + edge2)
        neg = torch.zeros(len(B) + 4, dtype=torch.bool)
        neg[::3] = True  # every third base negated, as a negative digit
        y2 = torch.where(neg.unsqueeze(-1), curve.neg_y(y2), y2)
        Q = [(-b if m else b) for b, m in zip(B + edge2, neg.tolist())]
        return P1, (x2, y2), want1 + edge1, Q

    def test_mixed_add_matches_bigint_and_projective_add(self, pairs):
        P1, Q, Pref, Qref = self._cases(pairs)
        got = curve.pm_add_plain(P1, Q)
        assert _to_ref(got) == [a + b for a, b in zip(Pref, Qref)]
        one = torch.tensor(F.MONT_ONE_64, dtype=torch.int64).expand_as(Q[0])
        # Algorithm 7 at Z2 = 1: the same projective triples
        for g, w in zip(got, curve.pp_add_plain(P1, Q + (one,))):
            assert torch.equal(g, w)

    def test_mixed_add_near_p(self):
        """Raw coordinates near p (field elements, not curve points): the
        same triples as the projective add at Z2 = 1."""
        Pe, Qe = curve.edge_case_pairs("cpu")
        Q = (Qe[0], Qe[1])
        one = torch.tensor(F.MONT_ONE_64, dtype=torch.int64).expand_as(Q[0])
        for g, w in zip(curve.pm_add_plain(Pe, Q),
                        curve.pp_add_plain(Pe, Q + (one,))):
            assert torch.equal(g, w)

    def test_doubling_matches_bigint_and_model(self, pairs):
        """2P of projective sums, affine points and the identity as
        big-int points; near p, limb for limb the big-int model of
        Algorithm 9."""
        A = pairs[0][:128] + [ref_points.G1.identity()]
        S = curve.pp_add_plain(_to_tensors(A), _to_tensors(A[1:] + A[:1]))
        sums = [a + b for a, b in zip(A, A[1:] + A[:1])]
        assert _to_ref(curve.pp_double_plain(S)) == [s + s for s in sums]
        assert _to_ref(curve.pp_double_plain(_to_tensors(A))) == \
            [a + a for a in A]
        Pe, _ = curve.edge_case_pairs("cpu")
        rinv = pow(1 << 256, -1, P)
        mul = lambda a, b: a * b * rinv % P
        got = list(zip(*(_mont_ints(t) for t in curve.pp_double_plain(Pe))))
        for (x, y, z), g in zip(zip(*(_mont_ints(t) for t in Pe)), got):
            t0, t2 = mul(y, y), 9 * mul(z, z) % P
            d = (t0 - 3 * t2) % P
            assert g == (2 * mul(d, mul(x, y)) % P,
                         (mul(t2, 8 * t0 % P) + mul(d, t0 + t2)) % P,
                         mul(mul(y, z), 8 * t0 % P))
