from .sumcheck import (
    Sumcheck,
    BatchedSumcheck,
    SumcheckInstanceProof,
    SumcheckInstanceProver,
    SumcheckInstanceVerifier,
)

__all__ = [
    "Sumcheck",
    "BatchedSumcheck",
    "SumcheckInstanceProof",
    "SumcheckInstanceProver",
    "SumcheckInstanceVerifier",
]
