"""Models the port is driven with.

``build_nanogpt`` is the bench workload: the logic of the reference's
examples/nanogpt_style.py ``build_model`` on the port's ModelBuilder. From
the same numpy Generator state it draws the same weights in the same order,
so it yields the same quantized graph as the reference's bench.py.
"""

from __future__ import annotations

import numpy as np

from .frontend import ModelBuilder
from .frontend.quantize import quantize_tensor


def build_nanogpt(vocab, seq, dim, blocks, scale, rng, heads=1):
    """nanoGPT-shaped LM: token + position embeddings; per block an RMS
    norm, (multi-head) softmax attention, a tanh FFN and residuals; an LM
    head with the vocabulary zero-padded to a power of two."""
    assert dim % heads == 0
    hd = dim // heads
    # weight std: fixed 0.3 at the small bench dims, 1/sqrt(dim)-scaled
    # beyond so deep wide stacks keep activations inside the quantized
    # ranges (as in the reference's build_model)
    wstd = 0.3 if dim <= 64 else 0.3 * (64.0 / dim) ** 0.5
    vp = 1
    while vp < vocab:
        vp *= 2
    b = ModelBuilder(scale=scale)

    def weight(shape, std):
        return b.constant(quantize_tensor(rng.normal(size=shape) * std,
                                          scale))

    embw = np.zeros((vp, dim))
    embw[:vocab] = rng.normal(size=(vocab, dim)) * 0.3
    emb = b.constant(quantize_tensor(embw, scale))
    pos = weight((seq, dim), 0.1)
    tok = b.input([seq])
    x = b.add(b.gather(emb, tok), pos)
    for _ in range(blocks):
        mos = b.mean_of_squares(x, [1])
        xn = b.mul(x, b.broadcast(b.rsqrt(mos), [seq, dim]))
        wq = weight((dim, dim), wstd)
        wk = weight((dim, dim), wstd)
        wv = weight((dim, dim), wstd)
        q = b.matmul(xn, wq)
        k = b.matmul(xn, wk)
        v = b.matmul(xn, wv)
        if heads == 1:
            att = b.softmax_last_axis(b.einsum("mk,nk->mn", [q, k]))
            y = b.matmul(att, v)
        else:
            qh = b.move_axis(b.reshape(q, [seq, heads, hd]), 1, 0)
            kh = b.move_axis(b.reshape(k, [seq, heads, hd]), 1, 0)
            vh = b.move_axis(b.reshape(v, [seq, heads, hd]), 1, 0)
            att = b.softmax_last_axis(b.einsum("hmk,hnk->hmn", [qh, kh]))
            ctx = b.einsum("hmn,hnk->hmk", [att, vh])
            y = b.reshape(b.move_axis(ctx, 0, 1), [seq, dim])
        wo = weight((dim, dim), wstd)
        x = b.add(x, b.matmul(y, wo))
        w1 = weight((dim, 2 * dim), wstd)
        w2 = weight((2 * dim, dim), wstd)
        x = b.add(x, b.matmul(b.tanh(b.matmul(x, w1)), w2))
    woutw = np.zeros((dim, vp))
    woutw[:, :vocab] = rng.normal(size=(dim, vocab)) * wstd
    wout = b.constant(quantize_tensor(woutw, scale))
    b.output(b.matmul(x, wout))
    return b.build()
