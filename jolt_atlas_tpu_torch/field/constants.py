"""BN254 field constants.

Reference semantics: joltworks/src/field/mod.rs (JoltField over ark_bn254::Fr)
and arkworks' Montgomery representation with R = 2^256.
"""

# BN254 (alt_bn128) scalar field modulus r  (order of G1/G2)
FR_MODULUS = (
    21888242871839275222246405745257275088548364400416034343698204186575808495617
)
# BN254 base field modulus q (coordinates of curve points)
FQ_MODULUS = (
    21888242871839275222246405745257275088696311157297823662689037894645226208583
)

# Montgomery parameters for Fr with R = 2^256 (arkworks-compatible).
FR_R = (1 << 256) % FR_MODULUS
FR_R2 = (FR_R * FR_R) % FR_MODULUS
FR_R_INV = pow(FR_R, -1, FR_MODULUS)
# -r^{-1} mod 2^16 / 2^32 / 2^64 (word-size variants for limb implementations)
FR_N0_INV_16 = (-pow(FR_MODULUS, -1, 1 << 16)) % (1 << 16)
FR_N0_INV_32 = (-pow(FR_MODULUS, -1, 1 << 32)) % (1 << 32)
FR_N0_INV_64 = (-pow(FR_MODULUS, -1, 1 << 64)) % (1 << 64)

# BN curve parameter x ("seed"); |6x+2| drives the ate pairing loop.
BN_X = 4965661367192848881

# The 125-bit optimized challenge type stores masked value v as Montgomery
# limbs [0, 0, lo64, hi64], i.e. the Montgomery representation v*2^128, so the
# canonical field value is v * 2^128 * R^{-1} = v * 2^{-128} mod r.
# Reference: joltworks/src/field/challenge/mont_ark_u128.rs:62-84.
CHALLENGE_MASK_125 = (1 << 125) - 1
TWO_NEG_128 = pow(1 << 128, -1, FR_MODULUS)


def limbs_from_int(x: int, num_limbs: int, bits: int) -> list[int]:
    """Little-endian fixed-width limb decomposition of a nonnegative int."""
    mask = (1 << bits) - 1
    return [(x >> (bits * i)) & mask for i in range(num_limbs)]


def int_from_limbs(limbs, bits: int) -> int:
    acc = 0
    for i, limb in enumerate(limbs):
        acc |= int(limb) << (bits * i)
    return acc
