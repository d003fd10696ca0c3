"""Qwen2-style proving demo on the committed ONNX slice.

Port of examples/qwen_style.py (reference analogue: examples/qwen.rs).
Loads models/qwen_slice/network.onnx (2 layers, dim 64, GQA 4/2 heads,
rotary, SwiGLU, random weights) with the port's ONNX loader, or the file
that ``--model`` names, greedy-generates a few tokens with the quantized
interpreter and proves and verifies one forward pass. It exports nothing:
without the file it raises.

    python -m jolt_atlas_tpu_torch.examples.qwen_style [--seq 8] [--gen 4]
        [--scale 8] [--model PATH] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from . import nanogpt_style

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SLICE = os.path.join(REPO, "models", "qwen_slice", "network.onnx")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq", type=int, default=8)
    ap.add_argument("--gen", type=int, default=4)
    ap.add_argument("--scale", type=int, default=8)
    ap.add_argument("--model", default=SLICE)
    nanogpt_style.add_common(ap)
    return ap


def run(args, **prover) -> dict:
    """Load the model, generate ``args.gen`` greedy tokens, prove and
    verify the forward pass of the first ``args.seq``
    (nanogpt_style.prove_model). Returns prove_model's dict with the model
    and the tokens."""
    from ..frontend.onnx_load import RunArgs, load_onnx
    if not os.path.exists(args.model):
        raise FileNotFoundError(
            f"{args.model} is missing: the committed slice lives at "
            "models/qwen_slice/network.onnx (scripts/download_qwen.py "
            "exports other shapes)")
    model = load_onnx(args.model, RunArgs(scale=args.scale))
    vocab = model.graph.nodes[model.graph.outputs[0]].output_dims[-1]
    print(f"model: {len(model.graph.nodes)} nodes, vocab {vocab}")
    rng = np.random.default_rng(7)
    toks = [int(t) for t in rng.integers(0, min(vocab, 512),
                                          size=args.seq)]
    for _ in range(args.gen):
        logits = model.forward(
            [np.array(toks[-args.seq:], dtype=np.int32)])[0]
        toks.append(int(np.argmax(logits[-1])))
    print("greedy tokens:", toks)
    out = nanogpt_style.prove_model(
        model, [np.array(toks[:args.seq], dtype=np.int32)], args, **prover)
    return {"model": model, "tokens": toks, **out}


def main(argv: list[str] | None = None) -> int:
    run(parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
