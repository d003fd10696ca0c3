from .sumcheck import (
    Sumcheck,
    BatchedSumcheck,
    SumcheckInstanceProof,
    SumcheckInstanceVerifier)

__all__ = [
    "Sumcheck",
    "BatchedSumcheck",
    "SumcheckInstanceProof",
    "SumcheckInstanceProver",
    "SumcheckInstanceVerifier",
]
