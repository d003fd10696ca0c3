"""The GPT of nanoGPT and GPT-2, as a graph of the program's ModelBuilder.

The layer equations (Radford et al. 2019; Karpathy's nanoGPT
``model.py``), in the int32 fixed point of the quantization contract at
scale 2^s (``reference/contract.py``):

    x = wte[tokens] + wpe
    per block:  x = x + attn(ln_1(x));  x = x + mlp(ln_2(x))
    logits = ln_f(x) @ wte^T                       (the head tied to wte)

- ``ln(x)``: LayerNorm over the width with gain and bias: the mean (the
  sum floor-divided by the width), the centred x, its variance (the mean
  of squares) plus eps, the centred x times rsqrt of that, times the gain,
  plus the bias;
- ``attn``: q, k and v, each ``x W + b`` (c_attn's three column blocks);
  per head (q k^T) times 1/sqrt(head width), the causal mask (the scores
  of later positions set to -10, as the reference project's nanoGPT
  export masks them), softmax, times v; the heads joined, ``y W + b``;
- ``mlp``: ``gelu(x W_fc + b_fc) W_proj + b_proj``, W_fc of width
  4 x n_embd, gelu the tanh form 0.5 h (1 + tanh(sqrt(2/pi)(h + 0.044715
  h^3)));
- the vocabulary padded with zero rows to a power of two for the gather,
  so the logits have zero columns there.

The weights come from the seed's standard normals (``inputs.py``), scaled
as ``weight_shapes`` says and quantized here, by the benchmark; the
program and the reference (``reference/gpt.py``) get the same integers.
"""

from __future__ import annotations

import math

import numpy as np

EPS = 1e-5          # LayerNorm's epsilon
MASKED = -10.0      # a masked attention score
GELU_C = 0.044715
LINEAR = ("q", "k", "v", "o", "fc", "proj")


def sizes(cfg: dict) -> dict:
    """The sizes this builder reads from a configuration: layers, heads,
    width, feed-forward width, positions, vocabulary, scale."""
    d = cfg["n_embd"]
    return {"layers": cfg["n_layer"], "heads": cfg["n_head"], "dim": d,
            "ffn": cfg.get("n_inner") or 4 * d, "seq": cfg["seq_len"],
            "vocab": cfg["vocab_size"], "scale": cfg["scale"],
            "bias": bool(cfg.get("bias", True))}


def request(cfg: dict) -> tuple[int, int]:
    """(vocabulary, tokens a request) of the traffic."""
    z = sizes(cfg)
    return z["vocab"], z["seq"]


def weight_shapes(cfg: dict) -> list[tuple[str, tuple, str]]:
    """(name, shape, kind) of every tensor drawn from the seed, in order.
    Kinds: "emb" (x 1), "linear" (x 1/sqrt(fan in)), "bias" (x 0.1),
    "gain" (1 + 0.1 x), "ln_bias" (x 0.1)."""
    z = sizes(cfg)
    d, f = z["dim"], z["ffn"]
    out = [("wte", (z["vocab"], d), "emb"), ("wpe", (z["seq"], d), "emb")]
    for i in range(z["layers"]):
        for ln in ("ln_1", "ln_2"):
            out += [(f"{i}.{ln}.g", (d,), "gain"),
                    (f"{i}.{ln}.b", (d,), "ln_bias")]
        for name, shape in (("q", (d, d)), ("k", (d, d)), ("v", (d, d)),
                            ("o", (d, d)), ("fc", (d, f)),
                            ("proj", (f, d))):
            out.append((f"{i}.{name}", shape, "linear"))
            if z["bias"]:
                out.append((f"{i}.{name}.b", (shape[1],), "bias"))
    return out + [("ln_f.g", (d,), "gain"), ("ln_f.b", (d,), "ln_bias")]


def quantize(x, s: int) -> np.ndarray:
    """round(x 2^s), half away from zero, int64; a nonzero x never
    becomes 0 (the contract's quantization of a constant)."""
    x = np.asarray(x, dtype=np.float64)
    v = x * float(1 << s)
    r = np.where(v >= 0, np.floor(v + 0.5), np.ceil(v - 0.5))
    if np.abs(r).max(initial=0) > 2 ** 31 - 1:
        raise OverflowError("a weight out of the int32 range at this scale")
    return np.where((r == 0) & (x != 0), np.sign(x), r).astype(np.int64)


def weights(cfg: dict, normals: dict) -> dict:
    """The quantized weights (int64) from the seed's normals, by name; the
    embedding padded with zero rows to a power of two."""
    z, s = sizes(cfg), sizes(cfg)["scale"]
    out = {}
    for name, shape, kind in weight_shapes(cfg):
        n = normals[name]
        if kind == "linear":
            v = n / math.sqrt(shape[0])
        elif kind == "gain":
            v = 1.0 + 0.1 * n
        elif kind in ("bias", "ln_bias"):
            v = 0.1 * n
        else:
            v = n
        out[name] = quantize(v, s)
    vp = 1 << max(0, (z["vocab"] - 1).bit_length())
    wte = np.zeros((vp, z["dim"]), dtype=np.int64)
    wte[:z["vocab"]] = out["wte"]
    out["wte"] = wte
    consts = {"eps": EPS, "masked": MASKED, "gelu_c": GELU_C,
              "gelu_k": math.sqrt(2.0 / math.pi), "one": 1.0, "half": 0.5,
              "att": 1.0 / math.sqrt(z["dim"] // z["heads"])}
    for k, v in consts.items():
        out["const." + k] = int(quantize(v, s))
    return out


def build(builder_cls, cfg: dict, w: dict):
    """The model's graph with the weights ``w`` (``weights``), built with
    ``builder_cls``: the program's ModelBuilder."""
    z = sizes(cfg)
    seq, d, heads, vp = z["seq"], z["dim"], z["heads"], len(w["wte"])
    hd = d // heads
    b = builder_cls(scale=z["scale"])

    def const(v, shape):
        return b.constant(np.broadcast_to(np.asarray(v, dtype=np.int32),
                                          shape))

    def layernorm(x, g, beta):
        mean = b.scalar_const_div(b.sum(x, [1]), d)
        c = b.sub(x, b.broadcast(mean, [seq, d]))
        var = b.add(b.mean_of_squares(c, [1]), const(w["const.eps"],
                                                     [seq, 1]))
        xn = b.mul(c, b.broadcast(b.rsqrt(var), [seq, d]))
        return b.add(b.mul(xn, const(g, [seq, d])), const(beta, [seq, d]))

    def linear(x, i, name, n_out):
        y = b.matmul(x, b.constant(w[f"{i}.{name}"]))
        if z["bias"]:
            y = b.add(y, const(w[f"{i}.{name}.b"], [seq, n_out]))
        return y

    def split(t):
        return b.move_axis(b.reshape(t, [seq, heads, hd]), 1, 0)

    tok = b.input([seq])
    x = b.add(b.gather(b.constant(w["wte"]), tok), b.constant(w["wpe"]))
    causal = np.broadcast_to(np.tril(np.ones((seq, seq), dtype=np.int32)),
                             (heads, seq, seq))
    for i in range(z["layers"]):
        h = layernorm(x, w[f"{i}.ln_1.g"], w[f"{i}.ln_1.b"])
        q, k, v = (split(linear(h, i, n, d)) for n in ("q", "k", "v"))
        att = b.mul(b.einsum("hmk,hnk->hmn", [q, k]),
                    const(w["const.att"], [heads, seq, seq]))
        att = b.iff(b.constant(causal), att,
                    const(w["const.masked"], [heads, seq, seq]))
        y = b.einsum("hmn,hnk->hmk", [b.softmax_last_axis(att), v])
        y = b.reshape(b.move_axis(y, 0, 1), [seq, d])
        x = b.add(x, linear(y, i, "o", d))
        h = layernorm(x, w[f"{i}.ln_2.g"], w[f"{i}.ln_2.b"])
        u = linear(h, i, "fc", z["ffn"])
        inner = b.add(u, b.mul(b.cube(u), const(w["const.gelu_c"],
                                                [seq, z["ffn"]])))
        t = b.tanh(b.mul(inner, const(w["const.gelu_k"], [seq, z["ffn"]])))
        g = b.mul(b.mul(u, b.add(t, const(w["const.one"], [seq, z["ffn"]]))),
                  const(w["const.half"], [seq, z["ffn"]]))
        x = b.add(x, linear(g, i, "proj", d))
    x = layernorm(x, w["ln_f.g"], w["ln_f.b"])
    b.output(b.matmul(x, b.constant(np.ascontiguousarray(w["wte"].T))))
    assert vp >= z["vocab"]
    return b.build()
