"""The yardstick: the field work a proof needs and the card's peaks.

Counted from the shapes a proof fixes (as the frozen verifier reads
them: every committed polynomial's variables, every sumcheck's rounds and
degree, the joint opening's variables) and never from what an engine of
the program ran, so a share reads the same work whatever implements it:

- a Montgomery product of two 254-bit field elements is 264 IMADs (32-bit
  multiply-adds, over eight 32-bit limbs);
- a group addition is 12 products (the complete projective addition of
  Renes, Costello and Batina, 2015, Algorithm 7, a = 0), and a doubling
  is counted as an addition;
- an n-point MSM of 254-bit scalars is textbook Pippenger at the window c
  that minimises its additions: per window n bucket additions and 2^(c+1)
  - 2 for the running sums, then c doublings and an addition a window to
  join the windows;
- a one-hot commitment (a read-address polynomial: its tag ends in "Ra"
  or "RaD") adds one base per column, 2^vars / 16 columns;
- a dense commitment is an MSM of 2^vars points;
- the joint HyperKZG opening at l variables is l - 1 fold MSMs of 2^(l-1),
  ..., 2 points and one witness MSM of 2^l - 3;
- a sumcheck of n rounds and degree d is (2^n - 1) d^2 products: over its
  2^(n-1-j) pairs in round j, d evaluations of d - 1 products and d
  bindings; each of the IOP's sumcheck proofs counts as one instance of
  its rounds, and the opening reduction as one instance an opening (its
  polynomial's variables, at the reduction's degree).

It leaves out the opening's host arithmetic, the witness and everything
that is not a product in the field, so it is a lower bound of the work.
"""

from __future__ import annotations

IMADS_PER_PRODUCT = 264
PRODUCTS_PER_ADD = 12
SCALAR_BITS = 254
ONEHOT_K = 16
BASE_BYTES, SCALAR_BYTES = 64, 32  # an affine base, a canonical scalar

# The card's peaks, by the name torch.cuda.get_device_name() gives: the
# IMAD rate is SMs x 64 IMAD lanes x the boost clock, the bytes rate is
# the data sheet's HBM bandwidth. Both assume the full power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"sms": 132, "imad_lanes": 64,
                              "clock_hz": 1.98e9, "bytes_per_s": 3.35e12},
}


def peak(kind: str) -> dict | None:
    """{imad_per_s, bytes_per_s} of the card named ``kind``, or None."""
    p = PEAKS.get(kind)
    if p is None:
        return None
    return {"imad_per_s": p["sms"] * p["imad_lanes"] * p["clock_hz"],
            "bytes_per_s": p["bytes_per_s"]}


def pippenger_adds(n: int, bits: int = SCALAR_BITS) -> int:
    """Group additions of textbook Pippenger over n points at its best
    window."""
    if n <= 0:
        return 0
    best = None
    for c in range(1, 25):
        w = -(-bits // c)
        adds = w * (n + 2 * ((1 << c) - 1)) + (w - 1) * (c + 1)
        best = adds if best is None else min(best, adds)
    return best


def msm_imads(n: int) -> int:
    return pippenger_adds(n) * PRODUCTS_PER_ADD * IMADS_PER_PRODUCT


def msm_bytes(n: int) -> int:
    return n * (BASE_BYTES + SCALAR_BYTES)


def msm_bound_s(n: int, pk: dict) -> float:
    """The least time the card could take for an n-point MSM: the larger
    of its IMADs over the IMAD peak and its bytes over the bytes peak."""
    return max(msm_imads(n) / pk["imad_per_s"],
               msm_bytes(n) / pk["bytes_per_s"])


def sumcheck_products(rounds: int, degree: int) -> int:
    return ((1 << rounds) - 1) * max(degree, 1) ** 2


def is_onehot(tag: str) -> bool:
    return tag.endswith("Ra") or tag.endswith("RaD")


def proof_imads(shapes: dict) -> int:
    """IMADs of one proof whose shapes (``frozen_judge``) are given:
    its commitments, the joint opening's MSMs and its sumchecks."""
    adds = 0
    committed = {key: (tag, nv) for key, tag, nv in shapes["openings"]}
    for tag, nv in committed.values():
        if is_onehot(tag):
            adds += max((1 << nv) // ONEHOT_K - 1, 0)
        else:
            adds += pippenger_adds(1 << nv)
    ell = shapes["joint_vars"]
    if ell:
        adds += sum(pippenger_adds(1 << j) for j in range(1, ell))
        adds += pippenger_adds((1 << ell) - 3)
    products = adds * PRODUCTS_PER_ADD + sum(
        sumcheck_products(r, d) for r, d in shapes["sumchecks"]) + sum(
        sumcheck_products(nv, shapes["reduction_degree"])
        for _, _, nv in shapes["openings"])
    return products * IMADS_PER_PRODUCT
