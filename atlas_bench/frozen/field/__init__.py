from .constants import FR_MODULUS, FQ_MODULUS
from .scalar import Fr, batch_inverse

__all__ = ["FR_MODULUS", "FQ_MODULUS", "Fr", "batch_inverse"]
