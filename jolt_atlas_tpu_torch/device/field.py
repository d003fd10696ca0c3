"""BN254 Montgomery arithmetic on limb tensors, over either prime: the base
field Fq (the curve kernels) and the scalar field Fr (the opening
reduction). The plain PyTorch versions behind the CUDA kernels.

Counterpart of jolt_atlas_tpu/tpu/fqplanes.py (``PlanesCtx``, built with
FQ_MODULUS by the curve code and with FR_MODULUS by tpu/reduction.py) and
the field helpers of tpu/pallas_curve.py (``_mont_mul``, ``_cond_sub_p``,
``_fadd``, ``_fsub``). ``PrimeField(modulus)`` is one field; ``FQ`` and
``FR`` are the two, and the module-level names are FQ's.

Layout. The port keeps field elements in the host's layout: ``(n, 4)``
64-bit little-endian Montgomery limbs with R = 2^256, held in an int64
tensor (the bits of the u64 limbs). That is ``FrArray.d`` and the prepared
bases buffer of csrc/msm.cpp, so uploads need no reshuffle. The reference's
16x16-bit planes use the same R, so both sides hold the same numbers, and
every output here is canonical (< p), as there.

The plain versions compute on 16-bit limbs in int64, limb-major
(``(16, n)`` planes, like the reference), because CPU PyTorch has no
unsigned 64-bit add, shift, compare or widening multiply. Right shifts on
int64 are arithmetic, so every right shift is masked. Carries are
propagated by whole-plane rounds until none is left, instead of limb by
limb: the result is the same canonical number.
"""

from __future__ import annotations

import torch

from ..field.constants import FQ_MODULUS, FR_MODULUS

NLIMBS = 16
MASK = 0xFFFF


def _u64_to_i64(v: int) -> int:
    return v - (1 << 64) if v >= 1 << 63 else v


def int_to_limbs64(x: int) -> list[int]:
    """Nonnegative int < 2^256 -> 4 int64 values holding its u64 limbs."""
    return [_u64_to_i64((x >> (64 * i)) & ((1 << 64) - 1)) for i in range(4)]


def limbs64_to_int(row) -> int:
    return sum((int(v) & ((1 << 64) - 1)) << (64 * i)
               for i, v in enumerate(row))


def ints_to_tensor(values, device=None) -> torch.Tensor:
    """Canonical ints (already Montgomery or not: taken as-is) ->
    (n, 4) int64 limb tensor."""
    return torch.tensor([int_to_limbs64(int(v)) for v in values],
                        dtype=torch.int64, device=device).reshape(-1, 4)


def tensor_to_ints(t: torch.Tensor) -> list[int]:
    return [limbs64_to_int(row) for row in t.cpu().reshape(-1, 4).tolist()]


# ---------------------------------------------------------------------------
# (n, 4) u64 limbs <-> (16, n) 16-bit planes
# ---------------------------------------------------------------------------

_SHIFTS = torch.tensor([0, 16, 32, 48], dtype=torch.int64)


def to_planes(x: torch.Tensor) -> torch.Tensor:
    """(n, 4) int64 u64 limbs -> (16, n) int64 planes of 16-bit limbs."""
    n = x.shape[0]
    planes = (x.unsqueeze(-1) >> _SHIFTS.to(x.device)) & MASK  # (n, 4, 4)
    return planes.reshape(n, NLIMBS).t().contiguous()


def from_planes(p: torch.Tensor) -> torch.Tensor:
    """(16, n) canonical 16-bit planes -> (n, 4) int64 u64 limbs."""
    q = p.t().reshape(-1, 4, 4) << _SHIFTS.to(p.device)
    return (q[..., 0] | q[..., 1] | q[..., 2] | q[..., 3]).contiguous()


def _const_planes(limbs: list[int], device) -> torch.Tensor:
    return torch.tensor(limbs, dtype=torch.int64, device=device)[:, None]


def _carry(t: torch.Tensor) -> torch.Tensor:
    """Propagate carries (and borrows: shifts are arithmetic) through the
    planes of t in place until every plane but the top one is in
    [0, 2^16). The top plane keeps the signed overflow."""
    while True:
        c = t[:-1] >> 16
        if not bool(c.any()):
            return t
        t[:-1] &= MASK
        t[1:] += c


class PrimeField:
    """Montgomery arithmetic mod one prime p < 2^254, R = 2^256: plain
    versions on (16, n) planes (``mul``, ``add``, ``sub``) and on the
    (n, 4) host layout (``mul4``, ``add4``, ``sub4``)."""

    def __init__(self, modulus: int):
        self.P = modulus
        self.R_MONT = (1 << 256) % modulus
        self.N0INV = (-pow(modulus, -1, 1 << 16)) % (1 << 16)
        self.P_LIMBS = [(modulus >> (16 * i)) & MASK for i in range(NLIMBS)]
        self.MONT_ONE_LIMBS = [(self.R_MONT >> (16 * i)) & MASK
                               for i in range(NLIMBS)]
        self.MONT_ONE_64 = int_to_limbs64(self.R_MONT)
        self.P_64 = int_to_limbs64(modulus)

    def to_mont(self, x: int) -> int:
        return x % self.P * self.R_MONT % self.P

    def from_mont(self, x: int) -> int:
        return x * pow(self.R_MONT, -1, self.P) % self.P

    def cond_sub_p(self, t: torch.Tensor) -> torch.Tensor:
        """(17, n) planes holding a value in [0, 2p) -> canonical (16, n)."""
        t = _carry(t)
        d = t.clone()
        d[:NLIMBS] -= _const_planes(self.P_LIMBS, t.device)
        d = _carry(d)
        keep = d[NLIMBS] < 0  # value < p
        return torch.where(keep, t[:NLIMBS], d[:NLIMBS])

    def mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Montgomery product a*b/R mod p of canonical (16, n) planes:
        16-step CIOS on 16-bit limbs (the same steps as
        pallas_curve._mont_mul), with the in-row carries left lazy and
        settled once at the end. b may be one column (16, 1)."""
        n = max(a.shape[1], b.shape[1])
        p_col = _const_planes(self.P_LIMBS, a.device)
        t = torch.zeros((2 * NLIMBS + 1, n), dtype=torch.int64,
                        device=a.device)
        for i in range(NLIMBS):
            t[i:i + NLIMBS].addcmul_(b, a[i])
            m = (t[i] * self.N0INV) & MASK
            t[i:i + NLIMBS].addcmul_(p_col, m)
            t[i + 1] += t[i] >> 16  # t[i] is now a multiple of 2^16
        return self.cond_sub_p(t[NLIMBS:])

    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        t = torch.zeros((NLIMBS + 1, max(a.shape[1], b.shape[1])),
                        dtype=torch.int64, device=a.device)
        torch.add(a, b, out=t[:NLIMBS])
        return self.cond_sub_p(t)

    def sub(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """(a - b) mod p as a + p - b, which lies in (0, 2p)."""
        t = torch.zeros((NLIMBS + 1, max(a.shape[1], b.shape[1])),
                        dtype=torch.int64, device=a.device)
        torch.sub(a, b, out=t[:NLIMBS])
        t[:NLIMBS] += _const_planes(self.P_LIMBS, a.device)
        return self.cond_sub_p(t)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """(16, m, k) planes -> (16, m): the sums over the last axis, by a
        halving tree (zero-padded to a power of two)."""
        k = x.shape[2]
        width = 1 << max(k - 1, 0).bit_length()
        if width > k:
            x = torch.cat([x, x.new_zeros(x.shape[:2] + (width - k,))], 2)
        while x.shape[2] > 1:
            h = x.shape[2] // 2
            m = x.shape[1]
            s = self.add(x[:, :, :h].reshape(NLIMBS, -1),
                         x[:, :, h:].reshape(NLIMBS, -1))
            x = s.reshape(NLIMBS, m, h)
        return x[:, :, 0]

    # -- the reference's (n, 16) Fr engine's reductions (field/jaxfr.py:
    # sum_reduce :251, dot :266), for parallel/mesh.py's plain product
    # round. jaxfr keeps values below 2r and needs to_canonical (:240) to
    # compare them; every output here is already canonical, so
    # to_canonical has no counterpart, and mont_mul_scalar (:174) is
    # ``mul`` with a (16, 1) column.
    def sum_reduce(self, a: torch.Tensor) -> torch.Tensor:
        """(16, n) planes -> (16, 1): the sum of the n values."""
        return self.sum(a[:, None, :])

    def dot(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """(16, 1): sum_i a_i b_i of two (16, n) planes."""
        return self.sum_reduce(self.mul(a, b))

    # -- the same on the (n, 4) host layout
    def mul4(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return from_planes(self.mul(to_planes(a), to_planes(b)))

    def add4(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return from_planes(self.add(to_planes(a), to_planes(b)))

    def sub4(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return from_planes(self.sub(to_planes(a), to_planes(b)))


FQ = PrimeField(FQ_MODULUS)
FR = PrimeField(FR_MODULUS)

# the base field's names, as the curve code uses them
P = FQ.P
R_MONT = FQ.R_MONT
N0INV = FQ.N0INV
P_LIMBS = FQ.P_LIMBS
MONT_ONE_LIMBS = FQ.MONT_ONE_LIMBS
MONT_ONE_64 = FQ.MONT_ONE_64
P_64 = FQ.P_64
to_mont = FQ.to_mont
from_mont = FQ.from_mont
cond_sub_p = FQ.cond_sub_p
mul = FQ.mul
add = FQ.add
sub = FQ.sub
mul4 = FQ.mul4
add4 = FQ.add4
sub4 = FQ.sub4
