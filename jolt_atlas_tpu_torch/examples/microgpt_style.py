"""microGPT proving demo: a 1-layer 4-head transformer LM at the
reference's microgpt benchmark shape (vocab 32, n_embd 16, 4 heads, 1
layer, block 16).

Port of examples/microgpt_style.py; runs nanogpt_style in-process.

    python -m jolt_atlas_tpu_torch.examples.microgpt_style [--device cpu]
"""

from __future__ import annotations

import sys

from . import nanogpt_style

SHAPE = ["--blocks", "1", "--dim", "16", "--seq", "16", "--vocab", "32",
         "--heads", "4"]


def args(argv: list[str]):
    """nanogpt_style's arguments at this shape, then ``argv``'s flags."""
    return nanogpt_style.parser().parse_args(SHAPE + argv)


def main(argv: list[str] | None = None) -> int:
    nanogpt_style.run(args(sys.argv[1:] if argv is None else argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
