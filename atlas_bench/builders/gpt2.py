"""GPT-2 at its published widths, laid exactly into the power-of-two layout
that the proof needs.

The layer equations, the weight kinds and the constants are those of
``builders/gpt.py``, imported. The proof's einsums take power-of-two
dimensions only, and GPT-2 small's are not: n_embd 768, n_inner 3,072, a
vocabulary of 50,257 (or a slice of it). ``build`` zero-pads each width to
the next power of two (768 -> 1,024, 3,072 -> 4,096, 6,283 -> 8,192) and
runs ``gpt.build`` on the padded shapes:

- q, k and v's padded columns are zero, so the 12 heads of 64 are laid as
  16 of 64 whose heads 12-15 are all zero: their scores are 0, and what
  their softmax weighs is a zero v, so they add nothing; the padded rows of
  W_o, W_fc and W_proj and of the head are zero too, so every padded
  column of the residual stream, of the MLP and of the logits stays zero;
- LayerNorm is the one place where zero columns change a value: its
  statistics. The mean divides the row's sum (zero in the padded columns)
  by the real width; the centred values are masked to the real columns
  (``Iff``); the variance floor(sum c^2 / (2^s d)) is, with d = m 2^t and
  m odd, MeanOfSquares at scale s + t - log2(D) over the padded width D
  (floor(sum c^2 / 2^(s + t))) followed by a constant division by m, which
  is exact since floor(floor(a / b) / m) = floor(a / (b m)). The padded
  gains and biases are zero.

So the padded graph computes GPT-2's arithmetic at its true widths, which
the plain forward (``reference/gpt2.py``) computes without any padding.
The weights are drawn at the published shapes (``weights``); only
``build`` pads them.
"""

from __future__ import annotations

import numpy as np

from . import gpt

sizes = gpt.sizes
request = gpt.request
weight_shapes = gpt.weight_shapes


def _pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def padded(cfg: dict) -> dict:
    """The configuration at its power-of-two widths: n_embd, n_head (heads
    of the same width), n_inner and the vocabulary each padded."""
    z = sizes(cfg)
    hd = z["dim"] // z["heads"]
    if z["dim"] % z["heads"] or hd != _pow2(hd) or z["seq"] != _pow2(z["seq"]):
        raise ValueError("the head width and the sequence must be powers "
                         "of two")
    d = _pow2(z["dim"])
    return dict(cfg, n_embd=d, n_head=d // hd, n_inner=_pow2(z["ffn"]),
                vocab_size=_pow2(z["vocab"]))


def weights(cfg: dict, normals: dict) -> dict:
    """The quantized weights at the published shapes (``gpt.weights``,
    whose vocabulary padding is taken off again: ``build`` pads)."""
    w = gpt.weights(cfg, normals)
    w["wte"] = w["wte"][:sizes(cfg)["vocab"]]
    return w


def _real_columns(seq: int, d: int, width: int) -> np.ndarray:
    """1 in the real columns of a (seq, width) activation, 0 in the
    padded ones: LayerNorm's mask."""
    mask = np.zeros((seq, width), dtype=np.int32)
    mask[:, :d] = 1
    return mask


def _real_width_layernorm(builder_cls, seq: int, d: int, width: int,
                          scale: int):
    """``builder_cls`` whose LayerNorm statistics run over the real width d
    of a row padded to ``width``. ``gpt.build`` calls ``scalar_const_div``,
    ``sub`` and ``mean_of_squares`` in its LayerNorm alone."""
    if d == width:
        return builder_cls
    t = (d & -d).bit_length() - 1       # d = m 2^t, m odd
    m = d >> t
    mos_scale = scale + t - (width.bit_length() - 1)
    if mos_scale < 0:
        raise ValueError(f"width {d} in {width}: no exact variance at "
                         f"scale {scale}")

    class RealWidth(builder_cls):
        _wires: tuple | None = None

        def _mask(self):
            if self._wires is None:
                self._wires = (
                    self.constant(_real_columns(seq, d, width)),
                    self.constant(np.zeros((seq, width), dtype=np.int32)))
            return self._wires

        def scalar_const_div(self, a, divisor):   # the mean
            assert divisor == width
            return super().scalar_const_div(a, d)

        def sub(self, a, b):                      # the centred values
            real, zero = self._mask()
            return self.iff(real, super().sub(a, b), zero)

        def mean_of_squares(self, a, axes, scale=None):  # the variance
            q = super().mean_of_squares(a, axes, scale=mos_scale)
            return q if m == 1 else super().scalar_const_div(q, m)

    return RealWidth


def build(builder_cls, cfg: dict, w: dict):
    """The model's graph with the weights ``w`` (``weights``, published
    shapes), built with ``builder_cls`` (the program's ModelBuilder) in
    the padded layout the module describes."""
    z, pcfg = sizes(cfg), padded(cfg)
    pw = {k: v for k, v in w.items() if k.startswith("const.")}
    for name, shape, _ in weight_shapes(pcfg):
        a = np.zeros(shape, dtype=np.int64)
        a[tuple(slice(0, n) for n in w[name].shape)] = w[name]
        pw[name] = a
    width = pcfg["n_embd"]
    return gpt.build(_real_width_layernorm(builder_cls, z["seq"], z["dim"],
                                           width, z["scale"]), pcfg, pw)
