"""BN254 base-field (Fq) Montgomery arithmetic on limb tensors: the plain
PyTorch versions behind the CUDA curve kernels.

Counterpart of jolt_atlas_tpu/tpu/fqplanes.py and the field helpers of
tpu/pallas_curve.py (``_mont_mul``, ``_cond_sub_p``, ``_fadd``, ``_fsub``).

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

from ..field.constants import FQ_MODULUS

NLIMBS = 16
MASK = 0xFFFF
P = FQ_MODULUS
R_MONT = (1 << 256) % P
N0INV = (-pow(P, -1, 1 << 16)) % (1 << 16)
P_LIMBS = [(P >> (16 * i)) & MASK for i in range(NLIMBS)]
MONT_ONE_LIMBS = [(R_MONT >> (16 * i)) & MASK for i in range(NLIMBS)]


def _u64_to_i64(v: int) -> int:
    return v - (1 << 64) if v >= 1 << 63 else v


def int_to_limbs64(x: int) -> list[int]:
    """Nonnegative int < 2^256 -> 4 int64 values holding its u64 limbs."""
    return [_u64_to_i64((x >> (64 * i)) & ((1 << 64) - 1)) for i in range(4)]


def limbs64_to_int(row) -> int:
    return sum((int(v) & ((1 << 64) - 1)) << (64 * i)
               for i, v in enumerate(row))


MONT_ONE_64 = int_to_limbs64(R_MONT)
P_64 = int_to_limbs64(P)


def to_mont(x: int) -> int:
    return x % P * R_MONT % P


def from_mont(x: int) -> int:
    return x * pow(R_MONT, -1, P) % P


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


# ---------------------------------------------------------------------------
# plain arithmetic on planes
# ---------------------------------------------------------------------------

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


def cond_sub_p(t: torch.Tensor) -> torch.Tensor:
    """(17, n) planes holding a value in [0, 2p) -> canonical (16, n)."""
    t = _carry(t)
    d = t.clone()
    d[:NLIMBS] -= _const_planes(P_LIMBS, t.device)
    d = _carry(d)
    keep = d[NLIMBS] < 0  # value < p
    return torch.where(keep, t[:NLIMBS], d[:NLIMBS])


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product a*b/R mod p of canonical (16, n) planes: 16-step
    CIOS on 16-bit limbs (the same steps as pallas_curve._mont_mul), with
    the in-row carries left lazy and settled once at the end."""
    n = a.shape[1]
    p_col = _const_planes(P_LIMBS, a.device)
    t = torch.zeros((2 * NLIMBS + 1, n), dtype=torch.int64, device=a.device)
    for i in range(NLIMBS):
        t[i:i + NLIMBS].addcmul_(b, a[i])
        m = (t[i] * N0INV) & MASK
        t[i:i + NLIMBS].addcmul_(p_col, m)
        t[i + 1] += t[i] >> 16  # t[i] is now a multiple of 2^16
    return cond_sub_p(t[NLIMBS:])


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    t = torch.zeros((NLIMBS + 1, a.shape[1]), dtype=torch.int64,
                    device=a.device)
    torch.add(a, b, out=t[:NLIMBS])
    return cond_sub_p(t)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod p as a + p - b, which lies in (0, 2p)."""
    t = torch.zeros((NLIMBS + 1, a.shape[1]), dtype=torch.int64,
                    device=a.device)
    torch.sub(a, b, out=t[:NLIMBS])
    t[:NLIMBS] += _const_planes(P_LIMBS, a.device)
    return cond_sub_p(t)


# ---------------------------------------------------------------------------
# the same on the (n, 4) host layout
# ---------------------------------------------------------------------------

def mul4(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return from_planes(mul(to_planes(a), to_planes(b)))


def add4(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return from_planes(add(to_planes(a), to_planes(b)))


def sub4(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return from_planes(sub(to_planes(a), to_planes(b)))
