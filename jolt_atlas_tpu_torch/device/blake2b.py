"""BLAKE2b-256 transcript steps on tensors: the plain PyTorch versions of
the device transcript (csrc/blake2b.cuh), and the wrapper of its test
kernel.

Counterpart of jolt_atlas_tpu/tpu/blake2b.py (``compress``,
``transcript_absorb``, ``transcript_absorb_long``, ``transcript_squeeze``,
``bswap32``). The transcript (transcripts/blake2b.py) hashes
``state[32] || 28 zero bytes || n_rounds (4 bytes, big-endian) ||
payload`` and takes the 32-byte digest as its new state. Here a state is
four little-endian u64 words, a payload a whole number of such words, and
N transcripts step at once: ``states`` (N, 4), ``n_rounds`` (N,),
``payload`` (N, P), all int64 tensors holding the bits of the u64 words.

The TPU version carried each 64-bit word as a (lo, hi) u32 pair. Torch has
int64: adds and left shifts wrap as u64 ones do, but right shifts are
arithmetic, so every right shift is masked.

``transcript_step`` dispatches on the tensors' device: a CUDA tensor goes
to the test kernel ``jolt_blake2b_transcript`` (csrc/reduction.cu), which
runs the same device functions as the reduction's tail kernel; a CPU
tensor to the plain version. There is no fallback from one to the other.
"""

from __future__ import annotations

import numpy as np
import torch

from . import telemetry

IV = [
    0x6A09E667F3BCC908, 0xBB67AE8584CAA73B,
    0x3C6EF372FE94F82B, 0xA54FF53A5F1D36F1,
    0x510E527FADE682D1, 0x9B05688C2B3E6C1F,
    0x1F83D9ABFB41BD6B, 0x5BE0CD19137E2179,
]

SIGMA = [
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15],
    [14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3],
    [11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4],
    [7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8],
    [9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13],
    [2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9],
    [12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11],
    [13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10],
    [6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5],
    [10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0],
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15],
    [14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3],
]


def i64(v: int) -> int:
    """The int64 holding the bits of a u64."""
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >= 1 << 63 else v


def _rotr(x: torch.Tensor, n: int) -> torch.Tensor:
    return ((x >> n) & ((1 << (64 - n)) - 1)) | (x << (64 - n))


def bswap32(x):
    return (((x & 0xFF) << 24) | ((x & 0xFF00) << 8)
            | ((x >> 8) & 0xFF00) | ((x >> 24) & 0xFF))


def compress_plain(h: list, m: list, t: int, last: bool) -> list:
    """One BLAKE2b compression: h 8 words, m 16 words (each an int64 tensor
    of one shape), t the byte count so far, last the final-block flag."""
    v = list(h) + [torch.full_like(h[0], i64(x)) for x in IV]
    v[12] = v[12] ^ i64(t)
    if last:
        v[14] = ~v[14]

    def mix(a, b, c, d, x, y):
        v[a] = v[a] + v[b] + x
        v[d] = _rotr(v[d] ^ v[a], 32)
        v[c] = v[c] + v[d]
        v[b] = _rotr(v[b] ^ v[c], 24)
        v[a] = v[a] + v[b] + y
        v[d] = _rotr(v[d] ^ v[a], 16)
        v[c] = v[c] + v[d]
        v[b] = _rotr(v[b] ^ v[c], 63)

    for s in SIGMA:
        mix(0, 4, 8, 12, m[s[0]], m[s[1]])
        mix(1, 5, 9, 13, m[s[2]], m[s[3]])
        mix(2, 6, 10, 14, m[s[4]], m[s[5]])
        mix(3, 7, 11, 15, m[s[6]], m[s[7]])
        mix(0, 5, 10, 15, m[s[8]], m[s[9]])
        mix(1, 6, 11, 12, m[s[10]], m[s[11]])
        mix(2, 7, 8, 13, m[s[12]], m[s[13]])
        mix(3, 4, 9, 14, m[s[14]], m[s[15]])
    return [h[i] ^ v[i] ^ v[i + 8] for i in range(8)]


def transcript_absorb_long_plain(states: torch.Tensor, n_rounds: torch.Tensor,
                                 payload: torch.Tensor) -> torch.Tensor:
    """BLAKE2b-256(state || 28 zero bytes || n_rounds big-endian ||
    payload words) of each row: the new (N, 4) states."""
    zero = torch.zeros_like(states[:, 0])
    words = ([states[:, i] for i in range(4)] + [zero] * 3
             + [bswap32(n_rounds & 0xFFFFFFFF) << 32]
             + [payload[:, i] for i in range(payload.shape[1])])
    h = [torch.full_like(zero, i64(x)) for x in IV]
    h[0] = h[0] ^ 0x01010020  # keyless, 32-byte digest
    done = 0
    while len(words) - done > 16:
        done += 16
        h = compress_plain(h, words[done - 16:done], 8 * done, False)
    block = words[done:] + [zero] * (16 - (len(words) - done))
    h = compress_plain(h, block, 8 * len(words), True)
    return torch.stack(h[:4], 1)


def transcript_absorb_plain(states, n_rounds, payload) -> torch.Tensor:
    """An absorb of one 32-byte payload (4 words) a row."""
    if payload.shape[1] != 4:
        raise ValueError("an absorb takes 4 payload words")
    return transcript_absorb_long_plain(states, n_rounds, payload)


def transcript_squeeze_plain(states, n_rounds) -> torch.Tensor:
    """A squeeze: the digest of the 64-byte prefix alone."""
    return transcript_absorb_long_plain(
        states, n_rounds, states.new_zeros((states.shape[0], 0)))


def transcript_step(states: torch.Tensor, n_rounds: torch.Tensor,
                    payload: torch.Tensor) -> torch.Tensor:
    """One transcript step of each of N transcripts: a squeeze (payload of
    0 words), an absorb (4) or a long absorb (any other count). CUDA
    tensors run the test kernel, CPU tensors the plain version."""
    device = states.device
    n = states.shape[0]
    for t, shape in ((states, (n, 4)), (n_rounds, (n,)),
                     (payload, (n, payload.shape[-1]))):
        if t.dtype != torch.int64 or tuple(t.shape) != shape or (
                t.device != device):
            raise ValueError("transcript_step takes int64 tensors on one "
                             "device: states (N, 4), n_rounds (N,), payload "
                             f"(N, P); got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    if device.type == "cpu":
        return transcript_absorb_long_plain(states, n_rounds, payload)
    if device.type != "cuda":
        raise ValueError(f"transcript_step: no kernel for device {device}")
    from . import build
    states, n_rounds, payload = (t.contiguous()
                                 for t in (states, n_rounds, payload))
    out = torch.empty_like(states)
    if n:
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = build.cuda_library().jolt_blake2b_transcript(
                states.data_ptr(), n_rounds.data_ptr(), payload.data_ptr(),
                payload.shape[1], n, out.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError("blake2b_transcript kernel launch failed: "
                               f"CUDA error {rc}")
        telemetry.launch("blake2b_transcript", n)
    return out


# ---------------------------------------------------------------------------
# host conversions
# ---------------------------------------------------------------------------

def bytes_to_words(data: bytes) -> np.ndarray:
    """Bytes (a multiple of 8) -> int64 array of their LE u64 words."""
    return np.frombuffer(data, dtype="<i8").astype(np.int64)


def words_to_bytes(words) -> bytes:
    return np.asarray(words, dtype=np.int64).astype("<i8").tobytes()
