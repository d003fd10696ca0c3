from .points import G1, G2, g1_generator, g2_generator
from .pairing import pairing, pairing_check
from .msm import msm

__all__ = ["G1", "G2", "g1_generator", "g2_generator", "pairing",
           "pairing_check", "msm"]
