"""miniGPT proving demo: a 2-layer 8-head transformer LM at the
reference's minigpt benchmark shape (vocab 1024, n_embd 32, 8 heads, 2
layers, block 32).

Port of examples/minigpt_style.py; runs nanogpt_style in-process.

    python -m jolt_atlas_tpu_torch.examples.minigpt_style [--device cpu]
"""

from __future__ import annotations

import sys

from . import nanogpt_style

SHAPE = ["--blocks", "2", "--dim", "32", "--seq", "32", "--vocab", "1024",
         "--heads", "8"]


def args(argv: list[str]):
    """nanogpt_style's arguments at this shape, then ``argv``'s flags."""
    return nanogpt_style.parser().parse_args(SHAPE + argv)


def main(argv: list[str] | None = None) -> int:
    nanogpt_style.run(args(sys.argv[1:] if argv is None else argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
