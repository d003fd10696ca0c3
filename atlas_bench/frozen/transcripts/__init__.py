from .blake2b import Blake2bTranscript
from .keccak import KeccakTranscript

__all__ = ["Blake2bTranscript", "KeccakTranscript"]
