"""Blake2b Fiat-Shamir transcript.

Bit-compatible re-implementation of the reference transcript state machine
(joltworks/src/transcripts/blake2b.rs:12-260):

  - 32-byte running state, u32 round counter.
  - Every absorb/squeeze hashes  BLAKE2b-256(state || 28 zero bytes ||
    n_rounds as 4 BE bytes || payload)  and replaces the state.
  - `new(label)`: state = BLAKE2b-256(label right-padded with zeros to 32).
  - `append_message`: payload = message right-padded with zeros to 32.
  - `append_u64`: payload = 24 zero bytes || x as 8 BE bytes.
  - `append_scalar`: payload = 32-byte big-endian canonical scalar bytes
    (arkworks LE serialization reversed, blake2b.rs:138-146).
  - vectors are wrapped in begin/end_append_vector marker messages.
  - `challenge_bytes32`: state = squeeze = BLAKE2b-256(state || pad || round).
  - `challenge_scalar`: 16 squeezed bytes interpreted BIG-endian mod r.
  - `challenge_u128`: 16 squeezed bytes interpreted LITTLE-endian.
  - optimized (125-bit) challenges: Fr.from_u128_challenge(challenge_u128()).

The full `state_history` is always recorded (cheap) so prover/verifier
lockstep divergence can be pinpointed exactly, mirroring the reference's
test-only `compare_to` oracle (blake2b.rs:19-27,108-116).
"""

from __future__ import annotations

import hashlib

from ..field.scalar import Fr


def _blake2b256(data: bytes) -> bytes:
    return hashlib.blake2b(data, digest_size=32).digest()


class Blake2bTranscript:
    __slots__ = ("state", "n_rounds", "state_history", "expected_state_history")

    HASH = staticmethod(_blake2b256)

    def __init__(self, label: bytes):
        assert len(label) <= 32, "transcript label must fit in 32 bytes"
        self.state = self.HASH(label.ljust(32, b"\x00"))
        self.n_rounds = 0
        self.state_history: list[bytes] = [self.state]
        self.expected_state_history: list[bytes] | None = None

    # -- internals ---------------------------------------------------------
    def _prefix(self) -> bytes:
        return self.state + b"\x00" * 28 + self.n_rounds.to_bytes(4, "big")

    def _update(self, new_state: bytes) -> None:
        self.state = new_state
        self.n_rounds += 1
        if self.expected_state_history is not None:
            exp = self.expected_state_history
            if self.n_rounds >= len(exp) or new_state != exp[self.n_rounds]:
                raise AssertionError(
                    f"Fiat-Shamir transcript mismatch at round {self.n_rounds}"
                )
        self.state_history.append(new_state)

    # -- lockstep oracle ---------------------------------------------------
    def compare_to(self, other: "Blake2bTranscript") -> None:
        """Panic at the exact append where this transcript diverges from
        `other`'s recorded history (the reference's debugging oracle)."""
        self.expected_state_history = list(other.state_history)

    # -- absorb ------------------------------------------------------------
    def append_message(self, msg: bytes) -> None:
        assert len(msg) <= 32
        self._update(self.HASH(self._prefix() + msg.ljust(32, b"\x00")))

    def append_bytes(self, data: bytes) -> None:
        self._update(self.HASH(self._prefix() + data))

    def append_u64(self, x: int) -> None:
        self._update(
            self.HASH(self._prefix() + b"\x00" * 24 + int(x).to_bytes(8, "big"))
        )

    def append_scalar(self, scalar: Fr) -> None:
        self.append_bytes(scalar.to_bytes_be())

    def append_scalars(self, scalars) -> None:
        self.append_message(b"begin_append_vector")
        for s in scalars:
            self.append_scalar(s)
        self.append_message(b"end_append_vector")

    def append_point(self, point) -> None:
        """Absorb an affine G1/G2 point; identity hashes as 64 zero bytes.

        `point` must expose `is_zero()` and big-endian coordinate bytes via
        `to_transcript_bytes()` (x||y, 32 bytes each for G1).
        """
        if point.is_zero():
            self.append_bytes(b"\x00" * 64)
        else:
            self.append_bytes(point.to_transcript_bytes())

    def append_points(self, points) -> None:
        self.append_message(b"begin_append_vector")
        for p in points:
            self.append_point(p)
        self.append_message(b"end_append_vector")

    # -- squeeze -----------------------------------------------------------
    def challenge_bytes32(self) -> bytes:
        rand = self.HASH(self._prefix())
        self._update(rand)
        return rand

    def challenge_bytes(self, n: int) -> bytes:
        out = b""
        while n - len(out) > 32:
            out += self.challenge_bytes32()
        out += self.challenge_bytes32()[: n - len(out)]
        return out

    def challenge_u128(self) -> int:
        return int.from_bytes(self.challenge_bytes(16), "little")

    def challenge_scalar(self) -> Fr:
        # reference challenge_scalar_128_bits: 16 bytes read big-endian mod r
        return Fr(int.from_bytes(self.challenge_bytes(16), "big"))

    def challenge_vector(self, n: int) -> list[Fr]:
        return [self.challenge_scalar() for _ in range(n)]

    def challenge_scalar_powers(self, n: int) -> list[Fr]:
        q = self.challenge_scalar()
        powers = [Fr.one()]
        for _ in range(1, n):
            powers.append(powers[-1] * q)
        return powers

    def challenge_scalar_optimized(self) -> Fr:
        """125-bit optimized challenge (canonical value = masked_u128 * 2^-128)."""
        return Fr.from_u128_challenge(self.challenge_u128())

    def challenge_vector_optimized(self, n: int) -> list[Fr]:
        return [self.challenge_scalar_optimized() for _ in range(n)]

    def challenge_scalar_powers_optimized(self, n: int) -> list[Fr]:
        q = self.challenge_scalar_optimized()
        powers = [Fr.one()]
        for _ in range(1, n):
            powers.append(q * powers[-1])
        return powers
