"""The exact quantized forward of a Model's graph, in PyTorch.

Counterpart of jolt_atlas_tpu/jaxexec.py. ``compile_forward`` turns a Model
into a plain function over int32 tensors on one device (the port has no
jit) with the numpy frontend's semantics (frontend/ops.py): exact i64
accumulation, Euclidean floor rebase and saturation to i32, bit for bit.

The matrix products are kernel 9 (csrc/exact.cu) on a CUDA device and its
plain version here on the CPU (``exact_matmul``). ``mk,kn->mn`` is exact
(the reference's ``exact_matmul_rescale``); every other two-operand
einsum accumulates mod 2^64 as XLA's s64 einsum does (the reference's
general branch), in kernel 9's wrapping mode, lowered to a batched (B, M,
K) x (B, K, N) product through strided views (``lower_einsum``). On the
card an equation that does not lower raises; the CPU takes it through
torch.einsum in int64. The elementwise ops are int64 torch ops on either
device. The ops whose reference runs a float lookup table (tanh, softmax,
...) raise NotImplementedError, as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import telemetry
from .frontend import ops as FOPS
from .frontend.graph import Model

I32_MIN = -(2**31)
I32_MAX = 2**31 - 1
MAX_EXACT_K = 1 << 12  # the reference's limit (jaxexec.py:46)


def _clamp_i32(x: torch.Tensor) -> torch.Tensor:
    return x.clamp(I32_MIN, I32_MAX).to(torch.int32)


# ---------------------------------------------------------------------------
# kernel 9: the exact matrix product
# ---------------------------------------------------------------------------

def _limbs(x: torch.Tensor) -> list:
    """Four 8-bit limbs of int64 values in i32 range, the top one signed."""
    return [(x >> 0) & 0xFF, (x >> 8) & 0xFF, (x >> 16) & 0xFF, x >> 24]


def digits_rescale_saturate(D: list, shift: int) -> torch.Tensor:
    """Base-256 partial sums D_t (int64) -> floor(total / 2^shift)
    saturated to i32: jaxexec._digits_rescale_saturate, step for step."""
    NDIG = 12
    digits = []
    carry = torch.zeros_like(D[0])
    for t in range(NDIG):
        v = (D[t] if t < len(D) else torch.zeros_like(carry)) + carry
        digits.append(torch.remainder(v, 256))
        carry = torch.div(v, 256, rounding_mode="floor")
    whole, frac = divmod(shift, 8)
    digits = digits[whole:]
    if frac:
        mask = (1 << frac) - 1
        r = carry & mask
        carry = carry >> frac
        for t in range(len(digits) - 1, -1, -1):
            cur = r * 256 + digits[t]
            digits[t] = cur >> frac
            r = cur & mask
    lo = (digits[0] + digits[1] * 256 + digits[2] * 65536
          + torch.remainder(digits[3], 128) * (1 << 24))
    top_zero = digits[4] == 0
    top_ones = digits[4] == 255
    for d in digits[5:]:
        top_zero = top_zero & (d == 0)
        top_ones = top_ones & (d == 255)
    in_pos = (carry == 0) & top_zero & (digits[3] < 128)
    in_neg = (carry == -1) & top_ones & (digits[3] >= 128)
    sat = torch.where(carry >= 0, torch.full_like(lo, I32_MAX),
                      torch.full_like(lo, I32_MIN))
    out = torch.where(in_pos, lo, torch.where(in_neg, lo + I32_MIN, sat))
    return out.to(torch.int32)


def _limb_matmul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """An int64 product of limb matrices: torch.matmul in int64 on the CPU;
    on the card, which has no int64 matmul, in float64, exact while every
    sum stays below 2^53 (limbs below 2^8 in magnitude: K < 2^37)."""
    if x.device.type == "cpu":
        return torch.matmul(x, y)
    return torch.matmul(x.double(), y.double()).to(torch.int64)


def _digit_sums(a: torch.Tensor, b: torch.Tensor) -> list:
    """D_t = sum_{i + j = t} A_i @ B_j over the 8-bit limbs (int64
    products: each |D_t| < 4 K 2^16, no intermediate overflows)."""
    al, bl = _limbs(a.to(torch.int64)), _limbs(b.to(torch.int64))
    D = [None] * 7
    for i in range(4):
        for j in range(4):
            p = _limb_matmul(al[i], bl[j])
            D[i + j] = p if D[i + j] is None else D[i + j] + p
    return D


def exact_matmul_plain(a: torch.Tensor, b: torch.Tensor, shift: int,
                       wrap: bool = False) -> torch.Tensor:
    """Kernel 9's plain version: (B, M, K) x (B, K, N) i32 -> (B, M, N) i32,
    floor(sum / 2^shift) saturated; exact, or with ``wrap`` the sum taken
    mod 2^64 as a signed int64 first. The reference's limb split in int64,
    on either device (the card's comparisons run it there)."""
    D = _digit_sums(a, b)
    if not wrap:
        return digits_rescale_saturate(D, shift)
    # the low 64 bits of the carried digits, as a signed int64
    carry = torch.zeros_like(D[0])
    low = torch.zeros_like(D[0])
    for t in range(8):
        v = (D[t] if t < len(D) else torch.zeros_like(carry)) + carry
        d = torch.remainder(v, 256)
        carry = torch.div(v, 256, rounding_mode="floor")
        if t == 7:
            d = torch.where(d >= 128, d - 256, d)  # the sign byte
        low = low + (d << (8 * t))
    return _clamp_i32(low >> shift)


def _check_operands(a, b, shift: int, wrap: bool) -> None:
    if a.dim() != 3 or b.dim() != 3 or a.shape[2] != b.shape[1] or (
            a.shape[0] != b.shape[0]):
        raise ValueError(f"exact_matmul: (B, M, K) and (B, K, N) expected, "
                         f"got {tuple(a.shape)} and {tuple(b.shape)}")
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise ValueError(f"exact_matmul: int32 operands expected, got "
                         f"{a.dtype} and {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"exact_matmul: operands on {a.device} and "
                         f"{b.device}")
    if not 0 <= shift <= 63:
        raise ValueError(f"exact_matmul: shift {shift} outside 0 .. 63")
    if not wrap and a.shape[2] > MAX_EXACT_K:
        raise ValueError(f"exact_matmul: contraction depth {a.shape[2]} > "
                         f"{MAX_EXACT_K}")


# Kernel 9's tiles (csrc/exact.cu ExactWide, ExactNarrow): (rows, columns,
# depth of a slice, blocks an SM holds: one, its persistent grid's)
EXACT_TILES = ((64, 64, 64, 1), (16, 64, 64, 1))
EXACT_MAX_CHUNK = 1 << 13  # depth a block: its int32 digit sums stay exact
EXACT_MIN_SLICES = 4       # slices a split at least, where K allows


def _cdiv(x: int, y: int) -> int:
    return -(-x // y)


def exact_plan(B: int, M: int, K: int, N: int, sms: int) -> tuple:
    """Kernel 9's launch plan: (tile, splits, kchunk). Tile 1 (16 x 64)
    for M <= 16, else tile 0 (64 x 64). The depth goes to ``splits``
    tiles of ``kchunk`` (a multiple of the slice depth, at most
    EXACT_MAX_CHUNK): where the tiles leave SMs of the persistent grid
    idle, as many as still fit in one wave, each at least
    EXACT_MIN_SLICES slices deep where K allows."""
    tile = 1 if M <= 16 else 0
    bm, bn, bk, per_sm = EXACT_TILES[tile]
    tiles = B * _cdiv(M, bm) * _cdiv(N, bn)
    least = max(1, _cdiv(K, EXACT_MAX_CHUNK))
    want = max(1, per_sm * sms // max(tiles, 1))
    most = max(1, K // (EXACT_MIN_SLICES * bk))
    splits = max(least, min(want, most))
    kchunk = max(bk, _cdiv(_cdiv(K, splits), bk) * bk)
    return tile, max(1, _cdiv(K, kchunk)), kchunk


def exact_matmul(a: torch.Tensor, b: torch.Tensor, shift: int,
                 wrap: bool = False) -> torch.Tensor:
    """Kernel 9 on CUDA tensors, its plain version on CPU ones: (B, M, K)
    x (B, K, N) int32, any strides (a batch stride of 0 broadcasts) ->
    contiguous (B, M, N) int32. A split depth (``exact_plan``) is two
    launches, the tile kernel's and its finish, each counted."""
    _check_operands(a, b, shift, wrap)
    device = a.device
    if device.type == "cpu":
        return exact_matmul_plain(a, b, shift, wrap)
    if device.type != "cuda":
        raise ValueError(f"exact_matmul: no kernel for device {device}")
    from .device import build
    B, M, K = a.shape
    N = b.shape[2]
    out = torch.empty((B, M, N), dtype=torch.int32, device=device)
    if out.numel():
        tile, splits, kchunk = exact_plan(
            B, M, K, N,
            torch.cuda.get_device_properties(device).multi_processor_count)
        ws = (torch.empty((B * splits * 7 * M * N,), dtype=torch.int32,
                          device=device) if splits > 1 else None)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = build.cuda_library().jolt_exact_matmul(
                a.data_ptr(), b.data_ptr(), out.data_ptr(),
                None if ws is None else ws.data_ptr(), B, M, K, N,
                *a.stride(), *b.stride(), shift, int(wrap), tile, splits,
                kchunk, stream)
        if rc != 0:
            raise RuntimeError(f"exact_matmul kernel launch failed: CUDA "
                               f"error {rc}")
        case = exact_case(B, wrap, splits)
        for _ in range(1 + (splits > 1)):
            telemetry.launch("exact_matmul", case)
    return out


def exact_case(batch: int, wrap: bool, splits: int = 1) -> tuple:
    """The shape class of a kernel 9 launch: (wrapping mode, batched,
    depth split)."""
    return (int(wrap), int(batch > 1), int(splits > 1))


def exact_matmul_rescale(a, b, shift: int) -> torch.Tensor:
    """(M, K) x (K, N) i32 -> exact floor(a @ b / 2^shift), saturated."""
    return exact_matmul(a[None], b[None], shift)[0]


def lower_einsum(equation: str, x, y):
    """A two-operand einsum as a (B, M, K) x (B, K, N) product: (a, b,
    finish), where finish((B, M, N)) gives the equation's output; or None
    where it does not lower (not two operands, a repeated index within an
    operand, an index summed within one operand, an ellipsis). Views
    only: no operand is copied."""
    eq = equation.replace(" ", "")
    if "->" not in eq or "." in eq:
        return None
    ins, out = eq.split("->")
    ins = ins.split(",")
    if len(ins) != 2:
        return None
    xs, ys = ins
    if any(len(set(s)) != len(s) for s in (xs, ys, out)):
        return None
    if any(c not in out and (c in xs) != (c in ys) for c in xs + ys) or (
            any(c not in xs + ys for c in out)):
        return None
    if len(xs) != x.dim() or len(ys) != y.dim():
        return None
    bat = [c for c in out if c in xs and c in ys]
    ms = [c for c in out if c in xs and c not in ys]
    ns = [c for c in out if c in ys and c not in xs]
    ks = [c for c in xs if c in ys and c not in out]
    size = {c: x.shape[xs.index(c)] for c in xs}
    size.update({c: y.shape[ys.index(c)] for c in ys})
    prod = lambda cs: int(np.prod([size[c] for c in cs], dtype=np.int64))
    B, M, K, N = prod(bat), prod(ms), prod(ks), prod(ns)
    a = x.permute([xs.index(c) for c in bat + ms + ks]).reshape(B, M, K)
    b = y.permute([ys.index(c) for c in bat + ks + ns]).reshape(B, K, N)
    order = bat + ms + ns

    def finish(r):
        r = r.reshape([size[c] for c in order])
        return r.permute([order.index(c) for c in out])

    return a, b, finish


def einsum_rescale(equation: str, x, y, shift: int) -> torch.Tensor:
    """An Einsum node: ``mk,kn->mn`` exact, any other equation wrapping mod
    2^64 (the reference's two branches), floor-shifted and saturated."""
    exact = equation.replace(" ", "") == "mk,kn->mn"
    low = lower_einsum(equation, x, y)
    if low is None:
        if x.device.type != "cpu":
            raise NotImplementedError(f"torchexec: einsum {equation!r} does "
                                      f"not lower to kernel 9")
        acc = torch.einsum(equation, x.to(torch.int64), y.to(torch.int64))
        return _clamp_i32(acc >> shift)
    a, b, finish = low
    return finish(exact_matmul(a.to(torch.int32), b.to(torch.int32), shift,
                               wrap=not exact)).contiguous()


# ---------------------------------------------------------------------------
# elementwise ops
# ---------------------------------------------------------------------------

def saturating_add(a, b, sign: int = 1) -> torch.Tensor:
    """i32 a +- b, saturated."""
    b = b.to(torch.int64)
    return _clamp_i32(a.to(torch.int64) + (b if sign > 0 else -b))


def exact_mul_rescale(a, b, shift: int) -> torch.Tensor:
    """Elementwise i32 a b -> floor(a b / 2^shift), saturated (|a b| <=
    2^62: exact in int64)."""
    a = a.to(torch.int64)
    return _clamp_i32((a * b.to(torch.int64).expand_as(a)) >> shift)


def _node_fn(op, ins):
    if isinstance(op, FOPS.Add):
        return saturating_add(ins[0], ins[1], 1)
    if isinstance(op, FOPS.Sub):
        return saturating_add(ins[0], ins[1], -1)
    if isinstance(op, FOPS.Mul):
        if op.scale == 0:
            acc = ins[0].to(torch.int32)
            for x in ins[1:]:
                acc = acc * x.to(torch.int32)  # raw path: wraps as int32
            return acc
        if len(ins) != 2:
            raise ValueError("torchexec: a rescaled Mul takes two operands")
        return exact_mul_rescale(ins[0], ins[1], op.scale)
    if isinstance(op, FOPS.Square):
        if op.scale == 0:
            a = ins[0].to(torch.int32)
            return a * a
        return exact_mul_rescale(ins[0], ins[0], op.scale)
    if isinstance(op, FOPS.Cube):
        a = ins[0].to(torch.int64)
        if op.scale == 0:
            return (a * a * a).to(torch.int32)
        return _clamp_i32((a * a * a) >> op.rebase_bits())
    if isinstance(op, FOPS.Einsum):
        if len(ins) != 2:
            if ins[0].device.type != "cpu":
                raise NotImplementedError(f"torchexec: einsum "
                                          f"{op.equation!r} of {len(ins)} "
                                          f"operands")
            acc = torch.einsum(op.equation, *[x.to(torch.int64)
                                              for x in ins])
            return _clamp_i32(acc >> op.scale)
        return einsum_rescale(op.equation, ins[0], ins[1], op.scale)
    if isinstance(op, FOPS.ReLU):
        return torch.clamp(ins[0], min=0).to(torch.int32)
    if isinstance(op, FOPS.Neg):
        return (-ins[0].to(torch.int64)).to(torch.int32)
    if isinstance(op, FOPS.Identity):
        return ins[0]
    if isinstance(op, FOPS.Reshape):
        return ins[0].reshape(tuple(op.shape))
    if isinstance(op, FOPS.Broadcast):
        return ins[0].expand(tuple(op.shape)).to(torch.int32).contiguous()
    if isinstance(op, FOPS.MoveAxis):
        return torch.movedim(ins[0], op.source, op.destination)
    if isinstance(op, FOPS.Slice):
        return ins[0].narrow(op.axis, op.start, op.end - op.start)
    if isinstance(op, FOPS.Concat):
        rank = ins[0].dim()
        axis = op.axis if op.axis >= 0 else op.axis + rank
        return torch.cat(ins, axis)
    if isinstance(op, (FOPS.GatherSmall, FOPS.GatherLarge)):
        return torch.index_select(ins[0], 0,
                                  ins[1].to(torch.int64).reshape(-1)
                                  ).reshape(tuple(ins[1].shape)
                                            + tuple(ins[0].shape[1:]))
    if isinstance(op, FOPS.Sum):
        acc = torch.sum(ins[0].to(torch.int64), dim=tuple(op.axes),
                        keepdim=True)
        return _clamp_i32(acc)
    if isinstance(op, FOPS.MeanOfSquares):
        a = ins[0].to(torch.int64)
        acc = torch.sum(a * a, dim=tuple(op.axes), keepdim=True)
        return _clamp_i32(torch.div(acc, op.divisor(),
                                    rounding_mode="floor"))
    if isinstance(op, FOPS.Iff):
        return torch.where(ins[0] != 0, ins[1], ins[2]).to(torch.int32)
    if isinstance(op, FOPS.And):
        return ((ins[0] != 0) & (ins[1] != 0)).to(torch.int32)
    if isinstance(op, FOPS.Clamp):
        a = ins[0]
        if a.dim() == 1:
            mx = torch.max(a)
        else:
            mx = torch.amax(a, dim=-1, keepdim=True)
        return torch.maximum(a, mx - op.max_spread).to(torch.int32)
    raise NotImplementedError(f"torchexec: {op.name} (f64-LUT ops run on "
                              f"host)")


def compile_forward(model: Model, device="cuda"):
    """fn(*inputs) -> tuple of the model's output tensors, on ``device``
    (the card unless the caller asks for the CPU): the constants go there
    once; the inputs (int32 tensors or arrays) are taken there, and a
    tensor on another device is refused."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("compile_forward: no CUDA device; pass "
                           "device=\"cpu\" to run on the host")
    graph = model.graph
    nodes = graph.sorted_nodes()
    consts = {n.idx: torch.as_tensor(np.asarray(n.operator.array),
                                     device=device)
              for n in nodes if isinstance(n.operator, FOPS.Constant)}

    def forward(*inputs):
        vals = dict(consts)
        for idx, x in zip(graph.inputs, inputs):
            if isinstance(x, torch.Tensor) and (
                    x.device.type != device.type
                    or device.index not in (None, x.device.index)):
                raise ValueError(f"forward: an input on {x.device}, the "
                                 f"model on {device}")
            vals[idx] = torch.as_tensor(x, dtype=torch.int32, device=device)
        for node in nodes:
            if isinstance(node.operator, (FOPS.Input, FOPS.Constant)):
                continue
            vals[node.idx] = _node_fn(node.operator,
                                      [vals[i] for i in node.inputs])
        return tuple(vals[i] for i in graph.outputs)

    return forward


def example_mlp(scale: int = 8, batch: int = 8, din: int = 64, dh: int = 128,
                dout: int = 32, seed: int = 0):
    """The flagship demo model: a quantized 2-layer MLP (the reference's,
    the same weights from the same seed)."""
    from .frontend import ModelBuilder
    from .frontend.quantize import quantize_tensor
    rng = np.random.default_rng(seed)
    b = ModelBuilder(scale=scale)
    x = b.input([batch, din])
    w1 = b.constant(quantize_tensor(rng.normal(size=(din, dh)) * 0.2, scale))
    h = b.matmul(x, w1)
    bias = b.constant(quantize_tensor(rng.normal(size=(batch, dh)) * 0.05,
                                      scale))
    a = b.relu(b.add(h, bias))
    w2 = b.constant(quantize_tensor(rng.normal(size=(dh, dout)) * 0.2, scale))
    out = b.matmul(a, w2)
    b.output(out)
    model = b.build()
    xq = quantize_tensor(rng.normal(size=(batch, din)), scale)
    return model, xq
