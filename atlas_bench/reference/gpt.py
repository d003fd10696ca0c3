"""The plain forward of the GPT of nanoGPT and GPT-2 (``builders/gpt.py``
states its equations), in NumPy on the contract's integer operations.

It takes the benchmark's quantized weights (``builders.gpt.weights``),
never anything the program made, and imports nothing of the program.
"""

from __future__ import annotations

import numpy as np

from ..builders.gpt import sizes
from .contract import (add, cube, matmul, mean_of_squares, mul, row_sum,
                       rsqrt, softmax, sub, tanh)


def forward(cfg: dict, w: dict, tokens: np.ndarray,
            lost: int = 0) -> np.ndarray:
    """The int32 logits (seq, vocabulary padded to a power of two) for
    ``tokens``; ``lost`` > 0 is the control (``contract.py``)."""
    z = sizes(cfg)
    s, d, heads, seq = z["scale"], z["dim"], z["heads"], z["seq"]
    hd = d // heads

    def layernorm(x, g, beta):
        c = sub(x, np.floor_divide(row_sum(x), d))
        var = add(mean_of_squares(c, s), w["const.eps"])
        return add(mul(mul(c, rsqrt(var, s), s, lost), g, s, lost), beta)

    def linear(x, i, name):
        y = matmul(x, w[f"{i}.{name}"], s, lost)
        return add(y, w[f"{i}.{name}.b"]) if z["bias"] else y

    def heads_first(t):
        return t.reshape(seq, heads, hd).transpose(1, 0, 2)

    causal = np.tril(np.ones((seq, seq), dtype=bool))
    x = add(w["wte"][np.asarray(tokens, dtype=np.int64)], w["wpe"])
    for i in range(z["layers"]):
        h = layernorm(x, w[f"{i}.ln_1.g"], w[f"{i}.ln_1.b"])
        q, k, v = (heads_first(linear(h, i, n)) for n in ("q", "k", "v"))
        att = mul(matmul(q, k.transpose(0, 2, 1), s, lost), w["const.att"],
                  s, lost)
        att = np.where(causal, att, w["const.masked"])
        y = matmul(softmax(att, s), v, s, lost)
        x = add(x, linear(y.transpose(1, 0, 2).reshape(seq, d), i, "o"))
        h = layernorm(x, w[f"{i}.ln_2.g"], w[f"{i}.ln_2.b"])
        u = linear(h, i, "fc")
        inner = add(u, mul(cube(u, s, lost), w["const.gelu_c"], s, lost))
        t = tanh(mul(inner, w["const.gelu_k"], s, lost), s)
        g = mul(mul(u, add(t, w["const.one"]), s, lost), w["const.half"], s,
                lost)
        x = add(x, linear(g, i, "proj"))
    x = layernorm(x, w["ln_f.g"], w["ln_f.b"])
    return matmul(x, w["wte"].T, s, lost).astype(np.int32)
