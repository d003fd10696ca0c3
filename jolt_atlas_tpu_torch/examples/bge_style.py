"""BGE-style embedding demo: transformer encoder -> mean pooling ->
RMS-normalized sentence embedding, proven end to end.

Port of examples/bge_style.py (reference analogue: jolt-atlas-core/
examples/bge.rs). ``build_model`` draws the reference's weights in the
reference's order, so the same flags give its graph and its proof bytes.

    python -m jolt_atlas_tpu_torch.examples.bge_style [--dim 32] [--seq 16]
        [--blocks 2] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from . import nanogpt_style


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--blocks", type=int, default=2)
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--seq", type=int, default=16)
    ap.add_argument("--vocab", type=int, default=256)
    ap.add_argument("--heads", type=int, default=4)
    nanogpt_style.add_common(ap)
    return ap


def build_model(blocks: int, dim: int, seq: int, vocab: int, heads: int,
                rng, scale: int = 8):
    """Token + position embeddings, ``blocks`` encoder blocks (RMS norm,
    multi-head softmax attention, a tanh FFN, residuals), mean pooling
    over the sequence and an RMS-normalized (1, dim) embedding."""
    from ..frontend import ModelBuilder
    from ..frontend.quantize import quantize_tensor

    def weight(shape, std):
        return b.constant(quantize_tensor(rng.normal(size=shape) * std,
                                          scale))

    b = ModelBuilder(scale=scale)
    emb = weight((vocab, dim), 0.3)
    pos = weight((seq, dim), 0.1)
    tok = b.input([seq])
    x = b.add(b.gather(emb, tok), pos)
    hd = dim // heads
    for _ in range(blocks):
        mos = b.mean_of_squares(x, [1])
        xn = b.mul(x, b.broadcast(b.rsqrt(mos), [seq, dim]))
        wq = weight((dim, dim), 0.3)
        wk = weight((dim, dim), 0.3)
        wv = weight((dim, dim), 0.3)
        qh = b.move_axis(b.reshape(b.matmul(xn, wq), [seq, heads, hd]), 1, 0)
        kh = b.move_axis(b.reshape(b.matmul(xn, wk), [seq, heads, hd]), 1, 0)
        vh = b.move_axis(b.reshape(b.matmul(xn, wv), [seq, heads, hd]), 1, 0)
        att = b.softmax_last_axis(b.einsum("hmk,hnk->hmn", [qh, kh]))
        y = b.reshape(b.move_axis(b.einsum("hmn,hnk->hmk", [att, vh]), 0, 1),
                      [seq, dim])
        x = b.add(x, y)
        w1 = weight((dim, 2 * dim), 0.3)
        w2 = weight((2 * dim, dim), 0.3)
        x = b.add(x, b.matmul(b.tanh(b.matmul(x, w1)), w2))
    # mean pooling over the sequence -> (1, dim), then RMS-normalize
    pooled = b.scalar_const_div(b.sum(x, [0]), seq)
    mos = b.mean_of_squares(pooled, [1])
    b.output(b.mul(pooled, b.broadcast(b.rsqrt(mos), [1, dim])))
    return b.build()


def run(args, **prover) -> dict:
    """Build the encoder, embed random tokens and prove and verify that
    forward pass (nanogpt_style.prove_model). Returns prove_model's dict
    with the model and the tokens."""
    from ..frontend.quantize import dequantize
    scale = 8
    rng = np.random.default_rng(11)
    model = build_model(args.blocks, args.dim, args.seq, args.vocab,
                        args.heads, rng, scale)
    print(f"encoder: {len(model.graph.nodes)} nodes -> {args.dim}-d "
          "embedding")
    toks = rng.integers(0, args.vocab, size=args.seq).astype(np.int32)
    e = dequantize(model.forward([toks])[0], scale)
    print("embedding norm (RMS-normalized):",
          round(float(np.sqrt((e ** 2).mean())), 3))
    out = nanogpt_style.prove_model(model, [toks], args, **prover)
    return {"model": model, "tokens": toks, **out}


def main(argv: list[str] | None = None) -> int:
    run(parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
