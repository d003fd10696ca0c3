"""Polynomial and sumcheck ID registry.

Mirrors the reference's canonical enums (common/src/lib.rs:35-438 CommittedPoly
/ VirtualPoly; joltworks/src/poly/opening_proof.rs:1167-1183 SumcheckId).
IDs are (tag, payload...) tuples with total ordering given by the variant tag
order of the reference enums, so BTreeMap-ordered iteration (which fixes
batching order and transcript order) matches.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


_COMMITTED_TAGS = [
    "NodeOutputRaD",            # (node, d)
    "CosRaD",                   # (node, d)
    "ErfRaD",                   # (node, d)
    "SinRaD",                   # (node, d)
    "TanhRaD",                  # (node, d)
    "DivRangeCheckRaD",         # (node, d)
    "SqrtDivRangeCheckRaD",     # (node, d)
    "MeanOfSquaresRangeCheckRaD",  # (node, d)
    "SqrtRangeCheckRaD",        # (node, d)
    "TeleportRangeCheckRaD",    # (node, d)
    "DivNodeQuotient",          # (node,)
    "ScalarConstDivNodeRemainder",  # (node,)
    "RsqrtQuotient",            # (node,)
    "TeleportNodeQuotient",     # (node,)
    "SigmoidRaD",               # (node, d)
    "GatherRa",                 # (node,)
    "GatherRaD",                # (node, d)
    "SoftmaxRemainderRaD",      # (node, d)
    "SoftmaxExpRemainderRaD",   # (node, d)
    "SoftmaxZHiRaD",            # (node, d)
    "SoftmaxZLoRaD",            # (node, d)
    "SoftmaxSatDiffRaD",        # (node, d)
    "ClampRaD",                 # (node, d)
    "RescaleRemainderRaD",      # (node, d)
    # --- extensions beyond the reference enum (this implementation) ---
    "SoftmaxExpQDense",         # (node,) dense committed exp_q advice
    "ClampIndicator",           # (node,) dense 0/1 advice: [x >= max - C]
    "ClampSpreadRaD",           # (node, d) |x - (max-C)| side-distance chunks
    "ClampMaxDiffRaD",          # (node, d) max - x dominance chunks
]

_VIRTUAL_TAGS = [
    "NodeOutput", "NodeOutputRa", "SigmoidRa", "CosRa", "ErfRa", "SinRa",
    "TanhRa", "SoftmaxSumOutput", "SoftmaxMaxOutput", "SoftmaxMaxIndex",
    "HammingWeight", "DivRangeCheckRa", "SqrtRangeCheckRa",
    "TeleportRangeCheckRa", "MeanOfSquaresRangeCheckRa", "DivRemainder",
    "SqrtRemainder", "TeleportQuotient", "TeleportRemainder", "SoftmaxExpSum",
    "SoftmaxExpQ", "SoftmaxRemainderRa", "SoftmaxExpHi", "SoftmaxExpLo",
    "SoftmaxExpRemainder", "SoftmaxExpRemainderRa", "SoftmaxZHi", "SoftmaxZLo",
    "SoftmaxZHiRa", "SoftmaxZLoRa", "SoftmaxSatDiff", "SoftmaxSatDiffRa",
    "SoftmaxRecipMultRemainder", "NTEvalShiftOutput", "ClampAcc", "ClampRa",
    "RescaleRemainder", "RescaleRemainderRa", "DummyClampedTanhInput",
    # --- extensions beyond the reference enum (this implementation) ---
    "GatherLargeRa",
]

_SUMCHECK_TAGS = [
    "NodeExecution",            # (node,)
    "Raf",
    "RaVirtualization",
    "RamHammingBooleanity",
    "RamHammingWeight",
    "Booleanity",
    "HammingWeight",
    "RLC",                      # (node,)
    "BlindFoldBatchOpening",
    "NTEvalShift",
]


_COMMITTED_IDX = {t: i for i, t in enumerate(_COMMITTED_TAGS)}
_VIRTUAL_IDX = {t: i for i, t in enumerate(_VIRTUAL_TAGS)}
_SUMCHECK_IDX = {t: i for i, t in enumerate(_SUMCHECK_TAGS)}


@dataclass(frozen=True, order=True)
class _TaggedId:
    tag_index: int
    payload: tuple

    @property
    def tag(self) -> str:
        return self._TAGS[self.tag_index]

    def __repr__(self):
        return f"{self.tag}{self.payload}"


class CommittedPoly(_TaggedId):
    _TAGS = _COMMITTED_TAGS
    _MEMO: dict = {}

    @classmethod
    def make(cls, tag: str, *payload) -> "CommittedPoly":
        # interned: ids are immutable and recur thousands of times per
        # prove/verify (frozen-dataclass construction was a measured
        # verifier hotspot)
        got = cls._MEMO.get((tag, payload))
        if got is None:
            got = cls._MEMO[(tag, payload)] = cls(_COMMITTED_IDX[tag],
                                                  tuple(payload))
        return got


class VirtualPoly(_TaggedId):
    _TAGS = _VIRTUAL_TAGS
    _MEMO: dict = {}

    @classmethod
    def make(cls, tag: str, *payload) -> "VirtualPoly":
        got = cls._MEMO.get((tag, payload))
        if got is None:
            got = cls._MEMO[(tag, payload)] = cls(_VIRTUAL_IDX[tag],
                                                  tuple(payload))
        return got


class SumcheckId(_TaggedId):
    _TAGS = _SUMCHECK_TAGS
    _MEMO: dict = {}

    @classmethod
    def make(cls, tag: str, *payload) -> "SumcheckId":
        got = cls._MEMO.get((tag, payload))
        if got is None:
            got = cls._MEMO[(tag, payload)] = cls(_SUMCHECK_IDX[tag],
                                                  tuple(payload))
        return got


@dataclass(frozen=True, order=True)
class OpeningId:
    """(polynomial, sumcheck) — committed polys sort before virtual polys."""
    is_virtual: bool
    poly: _TaggedId
    sumcheck: SumcheckId

    def sort_key(self):
        """Flat primitive tuple, cached — dataclass-recursive __lt__ was a
        measured hotspot (1M comparisons per prove in sorted_pending)."""
        k = self.__dict__.get("_sk")
        if k is None:
            k = (self.is_virtual, self.poly.tag_index, self.poly.payload,
                 self.sumcheck.tag_index, self.sumcheck.payload)
            object.__setattr__(self, "_sk", k)
        return k

    @classmethod
    def committed(cls, poly: CommittedPoly, sumcheck: SumcheckId) -> "OpeningId":
        return cls(False, poly, sumcheck)

    @classmethod
    def virtual(cls, poly: VirtualPoly, sumcheck: SumcheckId) -> "OpeningId":
        return cls(True, poly, sumcheck)

    def committed_poly(self) -> Optional[CommittedPoly]:
        return None if self.is_virtual else self.poly

    def virtual_poly(self) -> Optional[VirtualPoly]:
        return self.poly if self.is_virtual else None

    def __repr__(self):
        kind = "V" if self.is_virtual else "C"
        return f"{kind}:{self.poly}@{self.sumcheck}"


