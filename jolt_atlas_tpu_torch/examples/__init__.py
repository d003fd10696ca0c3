"""The port's example drivers, one for each of the reference's
examples/*.py that runs on the models in the repository.

    python -m jolt_atlas_tpu_torch.examples.<name> [flags] [--device cpu]

Each builds or loads its model, runs greedy generation (or the embedding)
with the quantized interpreter, then proves and verifies one forward pass
on the card, or on the host with ``--device cpu``. ``run(args)`` does the
work in-process and returns what it measured; ``main(argv)`` parses the
flags and calls it.
"""
