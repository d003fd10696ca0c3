"""The package's entry points: the single-device forward and the
multi-device dry run.

Counterpart of __graft_entry__.py (which stays the reference's). Both run
on the card unless the caller asks for the CPU (``device="cpu"``).
"""

from __future__ import annotations

import torch


def entry(device="cuda"):
    """(fn, example_args): the quantized forward of ``example_mlp``
    (torchexec), its constants and the example input on ``device``."""
    from . import torchexec
    model, xq = torchexec.example_mlp()
    device = torch.device(device)
    fn = torchexec.compile_forward(model, device)
    return fn, (torch.as_tensor(xq, device=device),)


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """The multi-device proving step over an n_devices-shard mesh on
    ``device`` (parallel/mesh.py dryrun_proving_step): a mesh prove equal
    in bytes to the single-device prove and verified, one sharded product
    round at 2^6 elements, and the quantized forward."""
    from .parallel.mesh import dryrun_proving_step
    dryrun_proving_step(n_devices, log_t=6, device=device)
