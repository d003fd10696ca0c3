"""Prover/verifier preprocessing: SRS sized from the model.

Reference: jolt-atlas-core/src/onnx_proof/preprocessing.rs — the SRS is
sized by the model's max committed-polynomial size; the shared preprocessing
carries the model.
"""

from __future__ import annotations

import os

from .commitment.kzg import KZGSRS
from .frontend.graph import Model


def cached_srs(max_vars: int) -> KZGSRS:
    """Seed-derived SRS with a disk cache (reference SRS save/load,
    hyperkzg/mod.rs:60-100: production deployments load a ceremony file
    instead of regenerating; the seed-derived file plays that role here).

    A cached file of >= the requested size is trimmed; a fresh generation
    is saved for next time, in the port's git-ignored build directory.
    JOLT_ATLAS_SRS_CACHE overrides the directory (empty string disables
    caching).
    """
    base = os.environ.get("JOLT_ATLAS_SRS_CACHE")
    if base is None:
        base = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "_build", "srs")
    if not base:
        return KZGSRS.setup(1 << max_vars)
    try:
        os.makedirs(base, exist_ok=True)
        for v in range(max_vars, max_vars + 7):
            path = os.path.join(base, f"srs_2e{v}.bin")
            if os.path.exists(path):
                srs = KZGSRS.load(path)
                if srs.g2_powers is None:
                    continue  # legacy file without extended G2 powers
                return srs.trim(1 << max_vars) if v > max_vars else srs
        srs = KZGSRS.setup(1 << max_vars)
        tmp = os.path.join(base, f".srs_2e{max_vars}.tmp.{os.getpid()}")
        srs.save(tmp)
        os.replace(tmp, os.path.join(base, f"srs_2e{max_vars}.bin"))
        return srs
    except OSError:
        return KZGSRS.setup(1 << max_vars)


class AtlasPreprocessing:
    def __init__(self, model: Model, srs: KZGSRS, pcs: str = "hyperkzg",
                 pcs_setup=None):
        self.model = model
        self.srs = srs
        self.pcs = pcs              # "hyperkzg" | "dory"
        self.pcs_setup = pcs_setup  # DorySetup when pcs == "dory"
        self._pedersen = None

    def pedersen_gens(self, count: int = 128):
        """Pedersen generators for the ZK pipeline, derived from the SRS
        G1 powers (reference preprocessing.rs:115-123). Deterministic, so
        prover and verifier preprocessing agree. Sized for the widest
        committed vector (round polys are ~degree 8; eval-reduction h
        polys grow with claim fan-in — 128 covers the model zoo and the
        generators auto-extend by hashing past the SRS length)."""
        if self._pedersen is None:
            from .commitment.pedersen import PedersenGenerators
            if self.srs is None:
                # transparent (dory) mode: hash-to-curve generators (no
                # known discrete logs -> binding without any trusted setup)
                from .commitment.dory import hash_to_g1
                self._pedersen = PedersenGenerators(
                    [hash_to_g1(b"jolt-atlas-tpu-pedersen", i)
                     for i in range(128)],
                    hash_to_g1(b"jolt-atlas-tpu-pedersen-h", 0))
            else:
                # fixed base width: generators beyond 128 always come from
                # the hash chain (never later SRS powers), so any two sides
                # agree regardless of how wide each needed to commit
                self._pedersen = PedersenGenerators.from_srs(self.srs, 128)
        if count > 128:
            self._pedersen.ensure(count)
        return self._pedersen

    @classmethod
    def preprocess(cls, model: Model, extra_log2: int = 0,
                   pcs: str = "hyperkzg") -> "AtlasPreprocessing":
        max_vars = model.graph.max_num_vars() + extra_log2
        if pcs == "dory":
            # transparent: no trusted tau anywhere (reference dory/mod.rs)
            from .commitment.dory import DorySetup
            return cls(model, None, pcs="dory",
                       pcs_setup=DorySetup.for_num_vars(max_vars))
        srs = cached_srs(max_vars)
        return cls(model, srs)
