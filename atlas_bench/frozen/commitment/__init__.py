from .kzg import KZGSRS, kzg_commit
from .hyperkzg import HyperKZG, HyperKZGProof

__all__ = ["KZGSRS", "kzg_commit", "HyperKZG", "HyperKZGProof"]
