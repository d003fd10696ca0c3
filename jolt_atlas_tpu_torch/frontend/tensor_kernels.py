"""Quantized tensor kernels beyond the 33 proven operators.

Completes the reference's tensor library surface (atlas-onnx-tracer
tensor/ops.rs:42-3963): convolution / deconvolution / pooling, per-axis
reductions, comparison/logic kernels and the remaining quantized
nonlinearities. Like the reference's, these back model EXECUTION and
tooling (interpreting graphs whose proofs would decompose them into the
33 proven ops) — they are not themselves proof operators.

All kernels follow the repo's fixed-point contract: i32 values at scale
2^s, i64 accumulation, floor rebase by 2^s where a product of two scaled
operands occurs (ops.py `sat_binop`/`floor_rebase` semantics).
"""

from __future__ import annotations

import numpy as np


def _rebase(acc: np.ndarray, s: int) -> np.ndarray:
    q = np.floor_divide(acc, np.int64(1) << np.int64(s))
    return np.clip(q, -(2**31), 2**31 - 1).astype(np.int32)


def conv2d(x: np.ndarray, w: np.ndarray, s: int, bias=None,
           stride: tuple = (1, 1), padding: tuple = (0, 0)) -> np.ndarray:
    """x (C_in, H, W) * w (C_out, C_in, KH, KW) -> (C_out, H', W').

    i64 accumulation over the full receptive field, one floor rebase —
    the same fused accumulate/rescale contract as Einsum (ops.py)."""
    cin, H, W = x.shape
    cout, cin2, KH, KW = w.shape
    assert cin == cin2
    ph, pw = padding
    sh, sw = stride
    xp = np.pad(x.astype(np.int64), ((0, 0), (ph, ph), (pw, pw)))
    Ho = (H + 2 * ph - KH) // sh + 1
    Wo = (W + 2 * pw - KW) // sw + 1
    # im2col: (C_in*KH*KW, Ho*Wo)
    cols = np.empty((cin * KH * KW, Ho * Wo), dtype=np.int64)
    idx = 0
    for c in range(cin):
        for i in range(KH):
            for j in range(KW):
                patch = xp[c, i:i + Ho * sh:sh, j:j + Wo * sw:sw]
                cols[idx] = patch.reshape(-1)
                idx += 1
    wm = w.astype(np.int64).reshape(cout, -1)
    acc = wm @ cols
    if bias is not None:
        acc += np.asarray(bias, dtype=np.int64)[:, None] << np.int64(s)
    return _rebase(acc, s).reshape(cout, Ho, Wo)


def deconv2d(x: np.ndarray, w: np.ndarray, s: int,
             stride: tuple = (1, 1), padding: tuple = (0, 0)) -> np.ndarray:
    """Transposed convolution: x (C_in, H, W) * w (C_in, C_out, KH, KW)."""
    cin, H, W = x.shape
    cin2, cout, KH, KW = w.shape
    assert cin == cin2
    sh, sw = stride
    ph, pw = padding
    Ho = (H - 1) * sh + KH - 2 * ph
    Wo = (W - 1) * sw + KW - 2 * pw
    acc = np.zeros((cout, Ho + 2 * ph, Wo + 2 * pw), dtype=np.int64)
    xl = x.astype(np.int64)
    wl = w.astype(np.int64)
    for i in range(H):
        for j in range(W):
            # broadcast one input pixel over its kernel footprint
            acc[:, i * sh:i * sh + KH, j * sw:j * sw + KW] += np.einsum(
                "c,cokl->okl", xl[:, i, j], wl)
    if ph or pw:
        acc = acc[:, ph:ph + Ho, pw:pw + Wo]
    return _rebase(acc, s)


def max_pool2d(x: np.ndarray, k: tuple = (2, 2),
               stride: tuple | None = None) -> np.ndarray:
    """x (C, H, W) -> (C, H', W') max pooling (no rescale — order op)."""
    kh, kw = k
    sh, sw = stride or k
    C, H, W = x.shape
    Ho = (H - kh) // sh + 1
    Wo = (W - kw) // sw + 1
    out = np.full((C, Ho, Wo), np.iinfo(np.int32).min, dtype=np.int32)
    for i in range(kh):
        for j in range(kw):
            out = np.maximum(out, x[:, i:i + Ho * sh:sh, j:j + Wo * sw:sw])
    return out


def avg_pool2d(x: np.ndarray, s: int, k: tuple = (2, 2),
               stride: tuple | None = None) -> np.ndarray:
    """Average pooling with exact floor division by the window size."""
    kh, kw = k
    sh, sw = stride or k
    C, H, W = x.shape
    Ho = (H - kh) // sh + 1
    Wo = (W - kw) // sw + 1
    acc = np.zeros((C, Ho, Wo), dtype=np.int64)
    for i in range(kh):
        for j in range(kw):
            acc += x[:, i:i + Ho * sh:sh, j:j + Wo * sw:sw]
    return np.floor_divide(acc, kh * kw).astype(np.int32)


def downsample(x: np.ndarray, axis: int, stride: int,
               offset: int = 0) -> np.ndarray:
    sl = [slice(None)] * x.ndim
    sl[axis] = slice(offset, None, stride)
    return x[tuple(sl)]


def argmax_axis(x: np.ndarray, axis: int) -> np.ndarray:
    return np.argmax(x, axis=axis).astype(np.int32)


def argmin_axis(x: np.ndarray, axis: int) -> np.ndarray:
    return np.argmin(x, axis=axis).astype(np.int32)


def prod_axes(x: np.ndarray, s: int, axes: tuple) -> np.ndarray:
    """Product reduction with one rebase per multiply (sequential fold,
    matching repeated Mul op semantics)."""
    out = x.astype(np.int64)
    for ax in sorted(axes, reverse=True):
        acc = np.take(out, 0, axis=ax).astype(np.int64)
        for i in range(1, out.shape[ax]):
            acc = np.floor_divide(acc * np.take(out, i, axis=ax),
                                  np.int64(1) << np.int64(s))
        out = acc
    return np.clip(out, -(2**31), 2**31 - 1).astype(np.int32)


def kronecker_delta(a: np.ndarray, b: np.ndarray, s: int) -> np.ndarray:
    """1.0 (quantized) where equal, else 0 (reference nonlinearities)."""
    return np.where(a == b, np.int32(1 << s), np.int32(0))


def greater(a, b):
    return (np.asarray(a) > np.asarray(b)).astype(np.int32)


def less(a, b):
    return (np.asarray(a) < np.asarray(b)).astype(np.int32)


def equals(a, b):
    return (np.asarray(a) == np.asarray(b)).astype(np.int32)


def logical_or(a, b):
    return ((np.asarray(a) != 0) | (np.asarray(b) != 0)).astype(np.int32)


def logical_xor(a, b):
    return ((np.asarray(a) != 0) ^ (np.asarray(b) != 0)).astype(np.int32)


def range_check_percent(a: np.ndarray, b: np.ndarray,
                        tol_percent: float) -> float:
    """Fraction of entries whose relative deviation exceeds tol (the
    reference's quantization-accuracy helper)."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    denom = np.maximum(np.abs(b), 1.0)
    return float(np.mean(np.abs(a - b) / denom > tol_percent / 100.0))


# -- additional quantized nonlinearities (f64-roundtrip, reference
#    tensor/ops.rs nonlinearities module) ----------------------------------

def _roundtrip(fn, a: np.ndarray, s: int) -> np.ndarray:
    x = np.asarray(a, dtype=np.float64) / (1 << s)
    return np.clip(np.rint(fn(x) * (1 << s)),
                   -(2**31), 2**31 - 1).astype(np.int32)


def gelu(a: np.ndarray, s: int) -> np.ndarray:
    from .nonlinearities import erf_f64
    return _roundtrip(lambda x: 0.5 * x * (1 + erf_f64(x / np.sqrt(2.0))),
                      a, s)


def softplus(a: np.ndarray, s: int) -> np.ndarray:
    return _roundtrip(lambda x: np.log1p(np.exp(-np.abs(x)))
                      + np.maximum(x, 0), a, s)


def exp(a: np.ndarray, s: int) -> np.ndarray:
    return _roundtrip(np.exp, a, s)


def ln(a: np.ndarray, s: int) -> np.ndarray:
    return _roundtrip(lambda x: np.log(np.maximum(x, 1e-30)), a, s)


def sqrt(a: np.ndarray, s: int) -> np.ndarray:
    return _roundtrip(lambda x: np.sqrt(np.maximum(x, 0.0)), a, s)


def arctan(a: np.ndarray, s: int) -> np.ndarray:
    return _roundtrip(np.arctan, a, s)


def sinh(a: np.ndarray, s: int) -> np.ndarray:
    return _roundtrip(np.sinh, a, s)


def cosh(a: np.ndarray, s: int) -> np.ndarray:
    return _roundtrip(np.cosh, a, s)
