from .unipoly import UniPoly, CompressedUniPoly
from .mlpoly import MLPoly, BindingOrder
from .eq import eq_evals, eq_eval_scalar

__all__ = ["UniPoly", "CompressedUniPoly", "MLPoly", "BindingOrder",
           "eq_evals", "eq_eval_scalar"]
