"""The port's plain BLAKE2b transcript steps (jolt_atlas_tpu_torch/device/
blake2b.py) against hashlib and against the reference's device transcript
(jolt_atlas_tpu/tpu/blake2b.py, run eagerly in jnp as
tests/test_tpu_kernels.py runs it), on the same numpy-seeded inputs.

The plain versions are what the CUDA test kernel and the reduction's tail
kernel are held to on the card. Tolerance: exact (equal digests).
"""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jolt_atlas_tpu.tpu import blake2b as RB
from jolt_atlas_tpu_torch.device import blake2b as B

# the suite runs in several worker processes at once: a small intra-op
# pool keeps this file from starving its neighbours' timed tests
torch.set_num_threads(2)


def _pairs(data: bytes):
    w = np.frombuffer(data, dtype="<u4")
    return [(jnp.uint32(w[2 * i]), jnp.uint32(w[2 * i + 1]))
            for i in range(len(w) // 2)]


def _unpairs(pairs) -> bytes:
    return np.array([int(x) for pair in pairs for x in pair],
                    dtype="<u4").tobytes()


def _step_inputs(rng, n: int, np_words: int):
    raw = rng.bytes(32 * n)
    pay = rng.bytes(8 * np_words * n)
    nr = rng.integers(0, 1 << 32, size=n)
    return (raw, pay, nr,
            torch.from_numpy(B.bytes_to_words(raw).reshape(n, 4)),
            torch.from_numpy(nr.astype(np.int64)),
            torch.from_numpy(B.bytes_to_words(pay).reshape(n, np_words)))


def _hashlib_step(state: bytes, n: int, payload: bytes) -> bytes:
    msg = state + b"\x00" * 28 + int(n).to_bytes(4, "big") + payload
    return hashlib.blake2b(msg, digest_size=32).digest()


@pytest.mark.parametrize("np_words", [0, 4, 9, 15, 16, 17, 33])
def test_plain_step_matches_hashlib(np_words):
    """Squeeze (0 words), absorb (4), the round message's long absorb (9)
    and lengths at and around the block boundaries (15-17, 33)."""
    rng = np.random.default_rng(100 + np_words)
    n = 6
    raw, pay, nr, states, rounds, payload = _step_inputs(rng, n, np_words)
    got = B.transcript_step(states, rounds, payload).numpy()
    for i in range(n):
        want = _hashlib_step(raw[32 * i:32 * i + 32], nr[i],
                             pay[8 * np_words * i:8 * np_words * (i + 1)])
        assert B.words_to_bytes(got[i]) == want


def test_plain_absorb_matches_reference():
    rng = np.random.default_rng(201)
    raw, pay, nr, states, rounds, payload = _step_inputs(rng, 3, 4)
    got = B.transcript_absorb_plain(states, rounds, payload).numpy()
    for i in range(3):
        want = RB.transcript_absorb(_pairs(raw[32 * i:32 * i + 32]),
                                    jnp.uint32(nr[i]),
                                    _pairs(pay[32 * i:32 * i + 32]))
        assert B.words_to_bytes(got[i]) == _unpairs(want)


def test_plain_absorb_long_matches_reference():
    """The round message's shape: "UniPoly\\x01" and two 32-byte words,
    nine payload words, two compressions."""
    rng = np.random.default_rng(202)
    raw, pay, nr, states, rounds, payload = _step_inputs(rng, 2, 9)
    got = B.transcript_absorb_long_plain(states, rounds, payload).numpy()
    for i in range(2):
        want = RB.transcript_absorb_long(_pairs(raw[32 * i:32 * i + 32]),
                                         jnp.uint32(nr[i]),
                                         _pairs(pay[72 * i:72 * i + 72]))
        assert B.words_to_bytes(got[i]) == _unpairs(want)


def test_plain_squeeze_matches_reference():
    rng = np.random.default_rng(203)
    raw, _, nr, states, rounds, _ = _step_inputs(rng, 3, 0)
    got = B.transcript_squeeze_plain(states, rounds).numpy()
    for i in range(3):
        want = RB.transcript_squeeze(_pairs(raw[32 * i:32 * i + 32]),
                                     jnp.uint32(nr[i]))
        assert B.words_to_bytes(got[i]) == _unpairs(want)


@pytest.mark.parametrize("last", [False, True])
def test_plain_compress_matches_reference(last):
    rng = np.random.default_rng(204 + last)
    h = rng.bytes(64)
    m = rng.bytes(128)
    t = int(rng.integers(0, 1 << 40))
    hw = [torch.tensor([x]) for x in B.bytes_to_words(h)]
    mw = [torch.tensor([x]) for x in B.bytes_to_words(m)]
    got = torch.cat(B.compress_plain(hw, mw, t, last)).numpy()
    want = RB.compress(_pairs(h), _pairs(m), t, final=last)
    assert B.words_to_bytes(got) == _unpairs(want)


def test_bswap32_matches_reference():
    xs = np.random.default_rng(205).integers(0, 1 << 32, size=16)
    got = B.bswap32(torch.from_numpy(xs.astype(np.int64))).numpy()
    want = [int(RB.bswap32(jnp.uint32(x))) for x in xs]
    assert got.tolist() == want


def test_step_rejects_bad_inputs():
    states = torch.zeros((2, 4), dtype=torch.int64)
    with pytest.raises(ValueError):
        B.transcript_step(states, torch.zeros(3, dtype=torch.int64),
                          torch.zeros((2, 4), dtype=torch.int64))
    with pytest.raises(ValueError):
        B.transcript_step(states.int(), torch.zeros(2, dtype=torch.int64),
                          torch.zeros((2, 4), dtype=torch.int64))
    with pytest.raises(ValueError):
        B.transcript_absorb_plain(states, torch.zeros(2, dtype=torch.int64),
                                  torch.zeros((2, 5), dtype=torch.int64))


def _cuh_array(name: str) -> list[int]:
    import os
    import re
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "jolt_atlas_tpu_torch", "csrc", "blake2b.cuh")
    m = re.search(name + r"\[\d+\] = \{([^}]*)\}", open(path).read())
    return [int(x.strip().rstrip("ul"), 16) for x in m.group(1).split(",")]


def _x4_compress(h, m, t, last):
    """csrc/blake2b.cuh's blake2b_compress_x4 lane by lane: lane q runs
    column q's mix, the diagonal mixes take b, c, d from lanes q + 1, q + 2,
    q + 3 (b2_sigma's packed rows name each lane's message words)."""
    M = (1 << 64) - 1
    rotr = lambda x, n: ((x >> n) | (x << (64 - n))) & M
    sig = _cuh_array("S")
    lanes = [[h[q], h[4 + q], B.IV[q], B.IV[4 + q]] for q in range(4)]
    lanes[0][3] ^= t
    if last:
        lanes[2][3] ^= M

    def g(v, x, y):
        a, b, c, d = v
        a = (a + b + x) & M
        d = rotr(d ^ a, 32)
        c = (c + d) & M
        b = rotr(b ^ c, 24)
        a = (a + b + y) & M
        d = rotr(d ^ a, 16)
        c = (c + d) & M
        b = rotr(b ^ c, 63)
        return [a, b, c, d]

    def shfl(k, offs):  # component k of lane q from lane q + offs
        return [lanes[(q + offs) % 4][k] for q in range(4)]
    for r in range(12):
        s = sig[r]
        nib = lambda i: (s >> (4 * i)) & 15
        lanes = [g(lanes[q], m[nib(2 * q)], m[nib(2 * q + 1)])
                 for q in range(4)]
        b, c, d = shfl(1, 1), shfl(2, 2), shfl(3, 3)
        lanes = [[lanes[q][0], b[q], c[q], d[q]] for q in range(4)]
        lanes = [g(lanes[q], m[nib(8 + 2 * q)], m[nib(9 + 2 * q)])
                 for q in range(4)]
        b, c, d = shfl(1, 3), shfl(2, 2), shfl(3, 1)
        lanes = [[lanes[q][0], b[q], c[q], d[q]] for q in range(4)]
    return ([h[q] ^ lanes[q][0] ^ lanes[q][2] for q in range(4)]
            + [h[4 + q] ^ lanes[q][1] ^ lanes[q][3] for q in range(4)])


@pytest.mark.parametrize("last", [False, True])
def test_four_lane_compression_schedule(last):
    """The packed SIGMA rows and the four-lane schedule of the card's
    compression (one mix a lane, shuffles for the diagonals) give
    BLAKE2b's compression: against hashlib's digest of one block."""
    assert [[(s >> (4 * i)) & 15 for i in range(16)]
            for s in _cuh_array("S")] == [B.SIGMA[r % 10] for r in range(12)]
    assert _cuh_array("IV") == B.IV
    rng = np.random.default_rng(5 + last)
    data = rng.bytes(128 if not last else 77)
    m = list(np.frombuffer(data.ljust(128, b"\0"), dtype="<u8").tolist())
    h = list(B.IV)
    h[0] ^= 0x01010020
    if last:
        got = _x4_compress(h, m, len(data), True)
        assert b"".join(x.to_bytes(8, "little") for x in got[:4]) == \
            hashlib.blake2b(data, digest_size=32).digest()
    else:  # a first block of two: the second block finishes the digest
        h2 = _x4_compress(h, m, 128, False)
        tail = rng.bytes(40)
        m2 = list(np.frombuffer(tail.ljust(128, b"\0"), dtype="<u8").tolist())
        got = _x4_compress(h2, m2, 168, True)
        assert b"".join(x.to_bytes(8, "little") for x in got[:4]) == \
            hashlib.blake2b(data + tail, digest_size=32).digest()
