"""The plain forward of GPT-2 (Radford et al. 2019; ``openai-community/gpt2``)
at its true widths, in plain PyTorch.

It takes the benchmark's quantized weights at the published shapes
(``builders.gpt2.weights``), never anything the program made, and imports
nothing of the program, of its JAX reference or of JAX. Its integer
forward follows the quantization contract (``contract.py``: int32 fixed
point at scale 2^s, products exact in int64 then floor-rescaled and
saturated, a constant divisor floors), written anew in int64 torch
operations; the tanh and the exponential tables come from the same
float64 formulas. It computes no padded width: the vocabulary's padding
is put on the logits at the end, as zero columns.

Departures from the published description, all the quantization
contract's and shared by the program:
- fixed point at scale 2^s; each product floors (``lost`` > 0, the
  control, keeps that many fractional bits fewer);
- LayerNorm's mean and variance floor, its eps 1e-5 is one unit (2^-s);
  1/sqrt is the integer isqrt(2^(3s) // v);
- GELU's tanh is the teleported one: its argument floored to a multiple
  of 2^(s-7) and clamped to 16 bits, the table rounded;
- softmax is the contract's integer softmax on two exp tables;
- a masked attention score is -10 (the reference project's export; the
  published model's masked_bias is -10,000);
- the sequence is 16 positions, so wpe holds 16 rows, not 1,024.

``forward_float`` is the same model in float32 on the same weights (each
integer over 2^s), with the published model's floating-point operations:
the tests hold the integer forward to it within a tolerance.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from ..builders.gpt import EPS, sizes

I32_MIN, I32_MAX = -(2 ** 31), 2 ** 31 - 1


def _sat(x: torch.Tensor) -> torch.Tensor:
    return x.clamp(I32_MIN, I32_MAX)


def _add(a, b):
    return _sat(a + b)


def _rescale(acc: torch.Tensor, s: int, lost: int) -> torch.Tensor:
    """floor(acc / 2^s) saturated, its last ``lost`` bits cleared."""
    return _sat(torch.div(acc, 1 << (s + lost), rounding_mode="floor")
                * (1 << lost))


def _mul(a, b, s, lost):
    return _rescale(a * b, s, lost)


def _matmul(a, b, s, lost):
    return _rescale(torch.matmul(a, b), s, lost)


def _cube(a, s, lost):
    if a.abs().max() >= 1 << 21:
        raise OverflowError("a cube's operand beyond 2^21")
    return _rescale(a * a * a, 2 * s, lost)


def _round_half_away(v: torch.Tensor) -> torch.Tensor:
    return torch.where(v >= 0, torch.floor(v + 0.5), torch.ceil(v - 0.5))


def _isqrt(q: torch.Tensor) -> torch.Tensor:
    """floor(sqrt(q)) of int64 q in [0, 2^52), exactly."""
    r = torch.sqrt(q.double()).floor().long()
    r = r - (r * r > q).long()
    return r + ((r + 1) * (r + 1) <= q).long()


def _rsqrt(v: torch.Tensor, s: int) -> torch.Tensor:
    """isqrt(2^(3s) // v) for v > 0, else 0."""
    q = torch.div(1 << (3 * s), v.clamp(min=1), rounding_mode="floor")
    return torch.where(v > 0, _isqrt(q), torch.zeros_like(v))


def _tanh(x: torch.Tensor, s: int) -> torch.Tensor:
    """The teleported tanh: x floored to a multiple of tau = 2^(s-7),
    clamped to 16 bits, then round(2^s tanh(x / 2^s))."""
    tau = 2 << (s - 8)
    t = (torch.div(x, tau, rounding_mode="floor") * tau).clamp(
        -(1 << 15), (1 << 15) - 1)
    S = float(2 ** s)
    return _round_half_away(S * torch.tanh(t.double() / S)).long()


def exp_tables(S: int) -> tuple[torch.Tensor, torch.Tensor, int]:
    """exp(-z / S) at scale S as two tables, z = hi * B + lo: hi[h] =
    round(S exp(-h B / S)), lo[l] = round(S exp(-l / S)), B the power of
    two nearest the square root of the range that matters (exp(-z/S) S
    under 1/2)."""
    needed = int(math.ceil(S * math.log(2.0 * S))) + 2
    B = 1 << int(math.ceil(math.log2(needed) / 2.0))
    h = torch.arange(needed // B + 2, dtype=torch.float64)
    lo = torch.arange(B, dtype=torch.float64)
    hi_t = _round_half_away(S * torch.exp(-(h * B) / S)).clamp(min=0)
    lo_t = _round_half_away(S * torch.exp(-lo / S)).clamp(min=0)
    return hi_t.long(), lo_t.long(), B


def _softmax(x: torch.Tensor, s: int) -> torch.Tensor:
    """The contract's integer softmax over the last axis at S = 2^s."""
    S = 1 << s
    hi_t, lo_t, B = exp_tables(S)
    z = (x.amax(dim=-1, keepdim=True) - x).clamp(max=len(hi_t) * B - 1)
    e = torch.div(hi_t[torch.div(z, B, rounding_mode="floor")]
                  * lo_t[z % B], S, rounding_mode="floor")
    inv = torch.div(S * S, e.sum(dim=-1, keepdim=True),
                    rounding_mode="floor")
    return torch.div(e * inv, S, rounding_mode="floor")


def _layernorm(x, g, beta, s, eps, lost):
    """Over the real width n: the mean and the mean of squares floor."""
    n = x.shape[-1]
    c = _sat(x - torch.div(_sat(x.sum(-1, keepdim=True)), n,
                           rounding_mode="floor"))
    var = _add(_sat(torch.div((c * c).sum(-1, keepdim=True), (1 << s) * n,
                              rounding_mode="floor")), eps)
    return _add(_mul(_mul(c, _rsqrt(var, s), s, lost), g, s, lost), beta)


def _padded_vocab(vocab: int) -> int:
    return 1 << max(0, (vocab - 1).bit_length())


def forward(cfg: dict, w: dict, tokens, lost: int = 0) -> np.ndarray:
    """The int32 logits (seq, vocabulary padded to a power of two; the
    padded columns zero) for ``tokens``; ``lost`` > 0 is the control."""
    z = sizes(cfg)
    s, d, heads, seq = z["scale"], z["dim"], z["heads"], z["seq"]
    hd = d // heads
    t = {k: torch.as_tensor(np.asarray(v), dtype=torch.int64)
         for k, v in w.items()}
    c = {k[len("const."):]: int(v) for k, v in w.items()
         if k.startswith("const.")}

    def linear(x, i, name):
        y = _matmul(x, t[f"{i}.{name}"], s, lost)
        return _add(y, t[f"{i}.{name}.b"]) if z["bias"] else y

    def ln(x, name):
        return _layernorm(x, t[f"{name}.g"], t[f"{name}.b"], s, c["eps"],
                          lost)

    toks = torch.as_tensor(np.asarray(tokens, dtype=np.int64))
    causal = torch.tril(torch.ones(seq, seq, dtype=torch.bool))
    x = _add(t["wte"][toks], t["wpe"])
    for i in range(z["layers"]):
        h = ln(x, f"{i}.ln_1")
        q, k, v = (linear(h, i, n).reshape(seq, heads, hd).transpose(0, 1)
                   for n in ("q", "k", "v"))
        att = _mul(_matmul(q, k.transpose(1, 2), s, lost), c["att"], s, lost)
        att = torch.where(causal, att, torch.full_like(att, c["masked"]))
        y = _matmul(_softmax(att, s), v, s, lost)
        x = _add(x, linear(y.transpose(0, 1).reshape(seq, d), i, "o"))
        h = ln(x, f"{i}.ln_2")
        u = linear(h, i, "fc")
        inner = _add(u, _mul(_cube(u, s, lost), c["gelu_c"], s, lost))
        th = _tanh(_mul(inner, c["gelu_k"], s, lost), s)
        g = _mul(_mul(u, _add(th, c["one"]), s, lost), c["half"], s, lost)
        x = _add(x, linear(g, i, "proj"))
    logits = _matmul(ln(x, "ln_f"), t["wte"].T, s, lost)
    out = np.zeros((seq, _padded_vocab(z["vocab"])), dtype=np.int32)
    out[:, :logits.shape[1]] = logits.numpy()
    return out


@contextlib.contextmanager
def _no_tf32():
    """Float32 matrix products in float32, not TF32, on a GPU."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def forward_float(cfg: dict, w: dict, tokens,
                  device: str = "cpu") -> np.ndarray:
    """GPT-2's forward in float32 on the same weights (integers over
    2^s; eps and GELU's constants unquantized): LayerNorm, causal
    attention (masked scores -10, as the integer forward's), the tanh
    GELU, the tied head. Float logits (seq, vocab)."""
    z = sizes(cfg)
    s, d, heads, seq = z["scale"], z["dim"], z["heads"], z["seq"]
    hd = d // heads
    f = {k: torch.as_tensor(np.asarray(v, dtype=np.float64) / 2.0 ** s,
                            dtype=torch.float32, device=device)
         for k, v in w.items()}

    def linear(x, i, name):
        y = x @ f[f"{i}.{name}"]
        return y + f[f"{i}.{name}.b"] if z["bias"] else y

    def ln(x, name):
        return torch.nn.functional.layer_norm(
            x, (d,), f[f"{name}.g"], f[f"{name}.b"], EPS)

    toks = torch.as_tensor(np.asarray(tokens, dtype=np.int64), device=device)
    causal = torch.tril(torch.ones(seq, seq, dtype=torch.bool,
                                   device=device))
    with _no_tf32():
        x = f["wte"][toks] + f["wpe"]
        for i in range(z["layers"]):
            h = ln(x, f"{i}.ln_1")
            q, k, v = (linear(h, i, n).reshape(seq, heads, hd).transpose(0, 1)
                       for n in ("q", "k", "v"))
            att = (q @ k.transpose(1, 2)) / math.sqrt(hd)
            att = att.masked_fill(~causal, float(f["const.masked"]))
            y = torch.softmax(att, dim=-1) @ v
            x = x + linear(y.transpose(0, 1).reshape(seq, d), i, "o")
            u = linear(ln(x, f"{i}.ln_2"), i, "fc")
            g = torch.nn.functional.gelu(u, approximate="tanh")
            x = x + linear(g, i, "proj")
        logits = ln(x, "ln_f") @ f["wte"].T
    return logits.cpu().numpy()
