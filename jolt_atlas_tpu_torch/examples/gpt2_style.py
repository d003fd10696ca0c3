"""GPT-2-style proving demo at the reference's benchmark quantization scale.

Port of examples/gpt2_style.py (reference analogue: jolt-atlas-core/
examples/gpt2.rs: GPT-2 125M, 12 layers, 12 heads, n_embd 768, seq 16,
scale 2^12). The default proves a proportional slice (2 layers, 4 heads,
n_embd 128, seq 16, vocab 8192, scale 2^12) that runs GPT-2's code paths:
multi-head attention, scale-2^12 activations and softmax, a vocab-scale
gather and a wide LM head.

    python -m jolt_atlas_tpu_torch.examples.gpt2_style [--device cpu]

Flags: every nanogpt_style flag (given after the slice's, they override
it), and
  --fullvocab  the true 50257-token vocabulary (padded to 65536)
  --full       the 125M shape as the reference pads it (12 layers, 16
               heads, dim 1024, full vocabulary)
"""

from __future__ import annotations

import sys

from . import nanogpt_style


def args(argv: list[str]):
    """The nanogpt_style arguments of the slice (or of --full /
    --fullvocab), overridden by the flags in ``argv``."""
    full = "--full" in argv
    fullvocab = full or "--fullvocab" in argv
    argv = [a for a in argv if a not in ("--full", "--fullvocab")]
    vocab = "50257" if fullvocab else "8192"
    if full:
        # the reference pads every tensor dim to a power of two at load:
        # GPT-2's 768-dim / 12-head tensors prove as 1024-dim / 16-head
        # zero-padded shapes, vocab 50257 -> 65536
        cfg = ["--blocks", "12", "--dim", "1024", "--seq", "16",
               "--vocab", vocab, "--heads", "16"]
    else:
        cfg = ["--blocks", "2", "--dim", "128", "--seq", "16",
               "--vocab", vocab, "--heads", "4"]
    return nanogpt_style.parser().parse_args(["--scale", "12"] + cfg + argv)


def main(argv: list[str] | None = None) -> int:
    nanogpt_style.run(args(sys.argv[1:] if argv is None else argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
