"""A frozen copy of the port's verifier path, taken when the benchmark was
written and never updated: the verifier, the proof's decoding, the
transcripts, the field, curve, polynomial and commitment code it runs,
the per-operator checks and the model graph it verifies against, with
the host C++ engines built from ``csrc/`` into ``_build/``. The prover's
side is left out. ``atlas_bench/frozen_judge.py`` runs it on every
proof of a run; it is a guard against later changes to the program's
verifier, and no independent reference.
"""

__version__ = "0.1.0"
