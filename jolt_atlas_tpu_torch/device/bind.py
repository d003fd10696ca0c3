"""The IOP's operand binds: an integer array partially evaluated at some of
its variables, one entry point ``bind_operand`` for every caller, on the
card by one launch of csrc/bind.cu (with its plain version and its
wrapper) under the engine's scope, else on the host.

A bind is out[k] = sum_e A[k, e] eq[e] mod r: A the operand laid out (K,
E), the axes it keeps first and those it is bound at last (so the bound
axes' eq tables joined are one eq table over their points concatenated);
eq that table in Montgomery form; out K field elements. An operand bound
at no axis is the same bind at E = 1 against eq = [1]. Its callers lay
out their own operands (zkops/ops.py: each Einsum operand at its
exclusive output chars, then broadcast along the domain chars it lacks;
Sum's input at its kept axes; Gather's and GatherLarge's dictionary rows
at their entries, GatherLarge's zero-extended to 16^D rows; and
zkops/softmax_op.py: Softmax's exp sums at their rows). The result equals
the host path's limb for limb, so the proof bytes do not change.

On the card (under ``Scope``, which the prover enters around its IOP loop,
AtlasProver._iop_engines; the plain version on a CPU device):

- constant operands (the model's weights and dictionaries) stay on the
  card: each is laid out and uploaded once a prover (its int32 values as
  int32), at its first bind, so in the benchmark's warm-up proof, and kept
  in the prover's ``residents`` keyed by (node index, axis order);
- every other operand goes up at each bind as it is (int32, or int64), is
  laid out on the card by a torch copy, and is bound by the same kernel;
- one launch a bind; its K results come back in one fetch into pinned
  memory. The eq table goes up beside the operand (E x 32 bytes).

Where the host field engine (field/frvec.py) did not load, the scope
declines (counted in telemetry.decisions["einsum_bind:declined"]). The host
path is the field engine's ``i64_mat_vec``, and object-dtype np.einsum
mod r only where that engine did not load. Counters: ``einsum_bind_card``
(the operand elements the engine bound) and ``einsum_bind_host`` (those
the host bound), over all callers; ``_prove_einsum`` counts the Einsum
operands' own elements (``einsum_bind_elements``).

The wrapper dispatches on its tensors' device: CUDA tensors launch the
kernel, CPU tensors run the plain version, with no fallback from one to the
other. Field elements are (n, 4) int64 rows of Montgomery limbs
(device/field.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..field.constants import FR_MODULUS
from . import telemetry
from .field import FR, MASK, NLIMBS, _carry, from_planes, int_to_limbs64, \
    to_planes

THREADS = 256      # a block (csrc/bind.cu BIND_THREADS)
PLAIN_CHUNK = 1 << 20  # the plain version's exact float64 sums: E x 2^32
#                        below 2^53 a chunk


# ---------------------------------------------------------------------------
# the scope
# ---------------------------------------------------------------------------

class Scope(telemetry.EngineScope):
    """While entered, ``bind_operand`` binds on the scope's device
    (telemetry.EngineScope: decisions["einsum_bind"] and
    ["einsum_bind:declined"], the engine's operand elements the
    ``einsum_bind_card`` counter). ``residents``: the prover's constant
    operands on the card, {(node index, axis order): tensor}, kept across
    its proofs."""

    ENGINE, COUNTER = "einsum_bind", "einsum_bind_card"
    ITEMS, ELEMENTS = "binds", "operand elements"

    def __init__(self, device, residents: dict | None = None):
        super().__init__(device)
        self.residents = {} if residents is None else residents

    def operand(self, arr: np.ndarray, perm: tuple, K: int, E: int,
                resident) -> torch.Tensor:
        """arr laid out (K, E) on the scope's device by the axis order
        perm: a constant's from ``residents`` (uploaded at its first
        bind), any other operand uploaded now."""
        if resident is None:
            return upload(arr, perm, K, E, self.device)
        key = (resident, perm)
        got = self.residents.get(key)
        if got is None:
            got = self.residents[key] = upload(arr, perm, K, E, self.device)
        return got.view(K, E)


def upload(arr: np.ndarray, perm: tuple, K: int, E: int,
           device) -> torch.Tensor:
    """arr on ``device`` (int32 kept, anything else as int64), its axes in
    the order perm, as a contiguous (K, E) tensor."""
    a = np.asarray(arr)
    if a.dtype != np.int32:
        a = a.astype(np.int64)
    t = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return t.permute(perm).reshape(K, E).contiguous()


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------

_R2 = to_planes(torch.tensor([int_to_limbs64(pow(2, 512, FR_MODULUS))],
                             dtype=torch.int64))  # R^2 mod r, raw


def _mod_r(acc: torch.Tensor) -> torch.Tensor:
    """(n, m) int64 planes of 16 bits each, nonnegative, whose value is
    below 2^(16 (NLIMBS + 6)) -> (16, m) canonical planes of it mod r: lo +
    hi 2^256 with lo < 2^256 < 6r reduced by subtraction and hi (2^256 mod
    r) as a Montgomery product of hi and R^2."""
    m = acc.shape[1]
    t = torch.zeros((NLIMBS + 6, m), dtype=torch.int64, device=acc.device)
    t[:acc.shape[0]] = acc
    _carry(t)
    lo = torch.zeros((NLIMBS + 1, m), dtype=torch.int64, device=acc.device)
    lo[:NLIMBS] = t[:NLIMBS]
    for _ in range(5):
        lo[:NLIMBS] = FR.cond_sub_p(lo)
        lo[NLIMBS] = 0
    hi = torch.zeros((NLIMBS, m), dtype=torch.int64, device=acc.device)
    hi[:6] = t[NLIMBS:]
    return FR.add(lo[:NLIMBS], FR.mul(hi, _R2.to(acc.device)))


def bind_plain(A: torch.Tensor, eq: torch.Tensor) -> torch.Tensor:
    """einsum_bind_kernel's function on the FR limb planes: (K, 4) int64,
    out[k] = sum_e A[k, e] eq[e] mod r. The positive and negative parts of
    A are summed apart, each as 16-bit digits times eq's 16-bit planes:
    every digit-plane sum is a float64 matrix product of integers below
    2^52 (PLAIN_CHUNK elements at a time), so exact, then reduced mod r;
    out is their difference."""
    K, E = A.shape
    a = A.to(torch.int64)
    digits = A.element_size() // 2  # 16-bit digits of a magnitude
    parts = []
    for mag in (a.clamp(min=0), torch.where(a < 0, -a, 0)):  # -(-2^63)
        # wraps to 2^63's bits, which the digits read as unsigned
        acc = torch.zeros((K, NLIMBS + digits), dtype=torch.int64,
                          device=A.device)
        for e0 in range(0, E, PLAIN_CHUNK):
            planes = to_planes(eq[e0:e0 + PLAIN_CHUNK]).t().to(torch.float64)
            for j in range(digits):
                d = ((mag[:, e0:e0 + PLAIN_CHUNK] >> (16 * j)) & MASK)
                acc[:, j:j + NLIMBS] += (d.to(torch.float64) @ planes).to(
                    torch.int64)
        parts.append(_mod_r(acc.t()))
    return from_planes(FR.sub(parts[0], parts[1]))


# ---------------------------------------------------------------------------
# the kernel wrapper
# ---------------------------------------------------------------------------

def group(E: int) -> int:
    """The lanes that take one row (csrc/bind.cu's G): a power of two, at
    least 4 elements a lane, at most a block."""
    return min(THREADS, max(1, (1 << (E - 1).bit_length()) // 4))


def _check(A: torch.Tensor, eq: torch.Tensor) -> tuple:
    if A.dim() != 2 or A.dtype not in (torch.int32, torch.int64) or (
            not A.is_contiguous()):
        raise ValueError(f"einsum_bind: a contiguous (K, E) int32 or int64 "
                         f"operand expected, got {A.dtype} "
                         f"{tuple(A.shape)}")
    K, E = A.shape
    if eq.dtype != torch.int64 or eq.shape != (E, 4) or (
            not eq.is_contiguous() or eq.device != A.device):
        raise ValueError(f"einsum_bind: a contiguous ({E}, 4) int64 eq "
                         f"table on {A.device} expected, got {eq.dtype} "
                         f"{tuple(eq.shape)} on {eq.device}")
    if A.device.type not in ("cpu", "cuda"):
        raise ValueError(f"einsum_bind: no kernel for device {A.device}")
    if K < 1 or not 1 <= E < 1 << 32:
        raise ValueError(f"einsum_bind: 1 <= K and 1 <= E < 2^32, got "
                         f"({K}, {E})")
    return K, E


_PINNED: dict = {}


def _pinned(device, rows: int) -> tuple:
    """A pinned (rows, 4) int64 fetch buffer of a CUDA device and its numpy
    view, grown to ``rows``."""
    k = device.index if device.index is not None else \
        torch.cuda.current_device()
    got = _PINNED.get(k)
    if got is None or got[0].shape[0] < rows:
        pinned = torch.empty((max(rows, 64), 4), dtype=torch.int64,
                             pin_memory=True)
        got = _PINNED[k] = (pinned, pinned.numpy())
    return got


def bind(A: torch.Tensor, eq: torch.Tensor) -> np.ndarray:
    """out[k] = sum_e A[k, e] eq[e] mod r, as (K, 4) int64 Montgomery limbs
    on the host: on CUDA tensors one launch, then its copy into pinned
    memory and the stream's synchronisation, in one call; on CPU tensors
    the plain version."""
    K, E = _check(A, eq)
    if A.device.type == "cpu":
        return bind_plain(A, eq).numpy()
    from . import build
    out = torch.empty((K, 4), dtype=torch.int64, device=A.device)
    pinned, view = _pinned(A.device, K)
    G = group(E)
    with torch.cuda.device(A.device):
        rc = build.cuda_library().jolt_einsum_bind(
            A.data_ptr(), A.element_size(), K, E, eq.data_ptr(),
            out.data_ptr(), G, pinned.data_ptr(),
            torch.cuda.current_stream(A.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"einsum_bind kernel failed: CUDA error {rc}")
    telemetry.launch("einsum_bind", (A.element_size(), G))
    return view[:K].copy()


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def bind_operand(arr: np.ndarray, perm: tuple, K: int, E: int, points,
                 resident=None):
    """out[k] = sum_e A[k, e] eq(points)[e] mod r, A the integer array arr
    with its axes in the order perm, as (K, E): K field elements, an
    FrArray (an object array of canonical ints where the host field engine
    did not load). On the entered scope's device, else on the host.
    resident: the node index of a constant operand, kept on the card
    across the prover's proofs."""
    from ..field import frvec
    from ..poly.eq import eq_evals
    eq = eq_evals(list(points))
    sc = Scope.entered
    if sc is not None:
        sc.offered += 1
        if isinstance(eq, frvec.FrArray):
            sc.engaged += 1
            A = sc.operand(arr, perm, K, E, resident)
            rows = bind(A, torch.from_numpy(np.ascontiguousarray(
                eq.d).view(np.int64)).to(sc.device))
            telemetry.count("einsum_bind")
            telemetry.tally("einsum_bind_card", K * E)
            return frvec.FrArray(rows.view(np.uint64))
        sc.decline("no host field engine")
    telemetry.tally("einsum_bind_host", K * E)
    a = np.asarray(arr).transpose(perm).reshape(K, E)
    if isinstance(eq, frvec.FrArray):
        return frvec.i64_mat_vec(a, eq)
    return np.einsum("ke,e->k", a.astype(object) % FR_MODULUS,
                     eq) % FR_MODULUS
