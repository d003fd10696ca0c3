"""The inputs of a run, made from its seed: the model's weights and every
proof's tokens. The program and the reference get exactly these.

The weights are standard normals in one draw from a ``torch.Generator``
on the run's device, split into the tensors that the configuration's
builder names (``builders/<name>.py``: ``weight_shapes``); the builder
scales and quantizes them.
"""

from __future__ import annotations

import numpy as np
import torch


def seed64(seed: int) -> int:
    """Any whole number as a 64-bit generator seed."""
    return seed % (1 << 64)


def normals(shapes: list, seed: int, device: torch.device) -> dict:
    """The seed's standard normals, float64 on the host, one array for
    each (name, shape, ...) of ``shapes``, in one draw in that order."""
    sizes = [int(np.prod(s[1])) for s in shapes]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed64(seed))
    flat = torch.randn(sum(sizes), generator=gen, device=device,
                       dtype=torch.float32).cpu().numpy().astype(np.float64)
    out, off = {}, 0
    for (name, shape, *_), n in zip(shapes, sizes):
        out[name] = flat[off:off + n].reshape(shape)
        off += n
    return out
