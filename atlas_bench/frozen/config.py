"""Global protocol constants.

Reference: common/src/consts.rs — XLEN=32 (operand bit width), LOG_K_CHUNK=4
(one-hot chunk log-size, K_CHUNK=16), LOG_K=64 (interleaved two-operand
address width); DEFAULT_SCALE=8 fractional bits (model quantization).
"""

XLEN = 32
LOG_K_CHUNK = 4
K_CHUNK = 1 << LOG_K_CHUNK
LOG_K = 64
DEFAULT_SCALE = 8

# Dictionary-height threshold for the dense GatherSmall one-hot (V * T_idx
# commitment). The reference switches at 2^16 (handlers/index.rs:34-45); we
# switch far earlier because the chunked GatherRaD path (4-bit chunks +
# RaVirtualization) costs O(T_idx) per chunk instead of O(V * T_idx) for
# the one-hot Booleanity — at V = 2^16, T = 16 that is a 2^20-entry one-hot
# versus four 16x16 chunks.
GATHER_SMALL_MAX = 1 << 12
