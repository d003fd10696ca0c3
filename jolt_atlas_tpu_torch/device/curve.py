"""Batched BN254 G1 complete projective addition on tensors.

Counterpart of jolt_atlas_tpu/tpu/curveops.py and tpu/pallas_curve.py.
A batch of points is a tuple (X, Y, Z) of int64 tensors of one shape
(..., 4): homogeneous projective coordinates as u64 Montgomery limbs, the
identity being (0 : 1 : 0).

``pp_add`` dispatches on the tensors' device: a CUDA tensor goes to the
hand-written kernel (csrc/curve.cu), a CPU tensor to ``pp_add_plain``.
There is no fallback from one to the other.
"""

from __future__ import annotations

import torch

from . import field as F
from . import telemetry


def pp_add_plain(P, Q):
    """RCB15 Algorithm 7 (a = 0, b3 = 9) in plain PyTorch, the same
    sequence of field operations as pallas_curve._pp_add_body."""
    shape = P[0].shape
    X1, Y1, Z1 = (F.to_planes(t.reshape(-1, 4)) for t in P)
    X2, Y2, Z2 = (F.to_planes(t.reshape(-1, 4)) for t in Q)
    m, a, s = F.mul, F.add, F.sub

    def b3(x):  # 9x = 8x + x
        x2 = a(x, x)
        x4 = a(x2, x2)
        x8 = a(x4, x4)
        return a(x8, x)

    t0 = m(X1, X2)
    t1 = m(Y1, Y2)
    t2 = m(Z1, Z2)
    t3 = a(X1, Y1)
    t4 = a(X2, Y2)
    t3 = m(t3, t4)
    t4 = a(t0, t1)
    t3 = s(t3, t4)          # X1Y2 + X2Y1
    t4 = a(Y1, Z1)
    X3 = a(Y2, Z2)
    t4 = m(t4, X3)
    X3 = a(t1, t2)
    t4 = s(t4, X3)          # Y1Z2 + Y2Z1
    X3 = a(X1, Z1)
    Y3 = a(X2, Z2)
    X3 = m(X3, Y3)
    Y3 = a(t0, t2)
    Y3 = s(X3, Y3)          # X1Z2 + X2Z1
    X3 = a(t0, t0)
    t0 = a(X3, t0)          # 3 X1X2
    t2 = b3(t2)             # b3 Z1Z2
    Z3 = a(t1, t2)
    t1 = s(t1, t2)
    Y3 = b3(Y3)             # b3 (X1Z2 + X2Z1)
    X3 = m(t4, Y3)
    t2 = m(t3, t1)
    X3 = s(t2, X3)
    Y3 = m(Y3, t0)
    t1 = m(t1, Z3)
    Y3 = a(t1, Y3)
    t0 = m(t0, t3)
    Z3 = m(Z3, t4)
    Z3 = a(Z3, t0)
    return tuple(F.from_planes(c).reshape(shape) for c in (X3, Y3, Z3))


def check_points(P, device: torch.device) -> None:
    shape = P[0].shape
    for t in P:
        if t.dtype != torch.int64 or t.shape != shape or shape[-1] != 4:
            raise ValueError("points must be int64 tensors of one shape "
                             f"(..., 4); got {t.dtype} {tuple(t.shape)}")
        if t.device != device:
            raise ValueError(f"point tensor on {t.device}, expected {device}")


def _flat(t: torch.Tensor) -> torch.Tensor:
    t = t.reshape(-1, 4).contiguous()
    if t.data_ptr() % 16:
        t = t.clone()
    return t


def pp_add(P, Q):
    """Complete projective add of two point batches of one shape."""
    device = P[0].device
    check_points(P, device)
    check_points(Q, device)
    if P[0].shape != Q[0].shape:
        raise ValueError("pp_add operands differ in shape")
    if device.type == "cpu":
        return pp_add_plain(P, Q)
    if device.type != "cuda":
        raise ValueError(f"pp_add: no kernel for device {device}")
    from . import build
    shape = P[0].shape
    ins = [_flat(t) for t in (*P, *Q)]
    n = ins[0].shape[0]
    outs = [torch.empty_like(ins[0]) for _ in range(3)]
    if n:
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = build.cuda_library().jolt_pp_add(
                *(t.data_ptr() for t in ins), *(t.data_ptr() for t in outs),
                n, stream)
        if rc != 0:
            raise RuntimeError(f"pp_add kernel launch failed: CUDA error {rc}")
        telemetry.launch("pp_add")
    return tuple(t.reshape(shape) for t in outs)


def pp_identity(n: int, device) -> tuple:
    """(0 : 1 : 0) batch of n points."""
    zero = torch.zeros((n, 4), dtype=torch.int64, device=device)
    one = torch.tensor(F.MONT_ONE_64, dtype=torch.int64,
                       device=device).expand(n, 4).contiguous()
    return (zero, one, zero.clone())


# ---------------------------------------------------------------------------
# host conversions
# ---------------------------------------------------------------------------

def points_to_tensors(points, device) -> tuple:
    """list[G1] -> (X, Y, Z) Montgomery limb tensors (identity (0, 1, 0))."""
    xs = [0 if p.infinity else F.to_mont(p.x) for p in points]
    ys = [F.R_MONT if p.infinity else F.to_mont(p.y) for p in points]
    zs = [0 if p.infinity else F.R_MONT for p in points]
    return tuple(F.ints_to_tensor(v, device) for v in (xs, ys, zs))


def edge_case_pairs(device) -> tuple:
    """(P, Q) batches of the add's edge cases: doubling, P + (-P), the
    identity on either side and on both, then raw coordinates near p
    (field elements, not curve points: they reach the carries and the final
    reduction). The kernel checks hold pp_add to pp_add_plain on them."""
    from ..curve.points import G1, g1_generator
    g = g1_generator()
    A, B, inf = g * 5, g * 7, G1.identity()
    P = points_to_tensors([A, A, inf, A, inf], device)
    Q = points_to_tensors([A, -A, B, inf, inf], device)
    near = [F.P - 1, F.P - 2, F.P - (1 << 64), (1 << 255) % F.P, 1, 0]
    rev = near[::-1]
    nearP = [F.ints_to_tensor(near[i:] + near[:i], device) for i in range(3)]
    nearQ = [F.ints_to_tensor(rev[i:] + rev[:i], device) for i in range(3)]
    return (tuple(torch.cat([a, b]) for a, b in zip(P, nearP)),
            tuple(torch.cat([a, b]) for a, b in zip(Q, nearQ)))


def tensors_to_points(P) -> list:
    """(X, Y, Z) Montgomery limb tensors -> list[G1] (affine, on the host)."""
    from ..curve.points import G1
    X, Y, Z = (F.tensor_to_ints(t) for t in P)
    p = F.P
    out = []
    for x, y, z in zip(X, Y, Z):
        if z == 0:
            out.append(G1.identity())
            continue
        # the Montgomery factors R of x/z and y/z cancel
        zi = pow(z, -1, p)
        out.append(G1(x * zi % p, y * zi % p))
    return out
