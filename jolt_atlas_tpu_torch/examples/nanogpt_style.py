"""nanoGPT-style proving demo: build a small multi-block transformer LM,
run greedy generation, and prove+verify one forward pass.

Port of examples/nanogpt_style.py (reference analogue: jolt-atlas-core/
examples/nanoGPT.rs). The model is models.build_nanogpt, so the same flags
give the reference's graph and, on either device, its proof bytes.

    python -m jolt_atlas_tpu_torch.examples.nanogpt_style [--blocks 2]
        [--dim 16] [--seq 8] [--zk] [--device cpu]

``prove_model`` is the proving half that the other drivers share;
``seeded_blinding`` makes a zk prove's bytes repeatable.
"""

from __future__ import annotations

import argparse
import contextlib
import random
import secrets
import sys
import time

import numpy as np
import torch


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--blocks", type=int, default=1)
    ap.add_argument("--dim", type=int, default=16)
    ap.add_argument("--seq", type=int, default=8)
    ap.add_argument("--vocab", type=int, default=32)
    ap.add_argument("--heads", type=int, default=1)
    ap.add_argument("--scale", type=int, default=8,
                    help="fixed-point log2 scale")
    ap.add_argument("--gen", type=int, default=4,
                    help="greedy tokens to generate")
    add_common(ap)
    ap.add_argument("--zk", action="store_true",
                    help="zero-knowledge mode: Pedersen-committed round "
                         "polynomials (prove_zk/verify_zk)")
    return ap


def add_common(ap: argparse.ArgumentParser) -> None:
    """The flags every driver takes: --trace and --device."""
    ap.add_argument("--trace", action="store_true",
                    help="print every profiling span of the prove")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default: the card) or cpu (the host "
                         "path)")


def check_device(name: str) -> torch.device:
    """The device a driver proves on; raises when it is the card and there
    is none (a driver never falls back to the host by itself)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to prove on "
                           "the host")
    return device


@contextlib.contextmanager
def seeded_blinding(seed: int = 0x5EED):
    """secrets.randbelow, the source of every blinding factor and mask
    value of the zk pipeline, as one stream from ``seed`` while entered,
    so that two zk proves of one model give the same bytes."""
    real = secrets.randbelow
    secrets.randbelow = random.Random(seed).randrange
    try:
        yield
    finally:
        secrets.randbelow = real


def prove_model(model, inputs: list, args, **prover) -> dict:
    """Preprocess ``model``, prove ``inputs`` on ``args.device`` (prove_zk
    under ``args.zk``) and verify the deserialized proof; prints the
    setup, prove and verify lines, each engine's decision and the prove's
    phase spans (every span under ``args.trace``). ``prover``: keyword
    arguments of AtlasProver (gates, transcript_factory); the verifier
    takes the same transcript. Raises if the verifier rejects the proof.
    Returns the preprocessing, proof, io, serialized bytes, seconds and
    the prove's telemetry."""
    from ..device import telemetry
    from ..preprocessing import AtlasPreprocessing
    from ..prover import AtlasProver
    from ..serde import deserialize_proof, serialize_proof
    from ..transcripts import Blake2bTranscript
    from ..utils import profiling
    from ..verifier import AtlasVerifier

    device = check_device(args.device)
    zk = getattr(args, "zk", False)
    print("preprocessing (SRS)...")
    t0 = time.time()
    pp = AtlasPreprocessing.preprocess(model)
    prv = AtlasProver(pp, device=device, **prover)
    if prv.uses_msm_engine and device.type == "cuda":
        # the bases' upload to the card is set-up, as the SRS is
        pp.srs.device_bases(device, prv.msm_gate, c=prv.msm_window)
        torch.cuda.synchronize(device)
    setup_s = time.time() - t0
    print(f"  setup: {setup_s:.1f}s")
    was = profiling.enabled()
    profiling.enable()
    profiling.reset()
    telemetry.reset()
    t0 = time.time()
    proof, io = (prv.prove_zk if zk else prv.prove)(inputs)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prove_s = time.time() - t0
    tele = telemetry.snapshot()
    events = profiling.events()
    profiling.enable(was)
    blob = serialize_proof(proof)
    print(f"  prove: {prove_s:.1f}s, proof {len(blob) / 1024:.1f} KB")
    t0 = time.time()
    verifier = AtlasVerifier(pp, prover.get("transcript_factory",
                                            Blake2bTranscript))
    ok = (verifier.verify_zk if zk else verifier.verify)(
        deserialize_proof(blob), io)
    verify_s = time.time() - t0
    print(f"  verify: {verify_s:.1f}s -> {ok}")
    phases = {name: w for name, w, _ in events if not name.startswith(" ")}
    print("  phases: " + ", ".join(f"{k} {v:.3f}s" for k, v in
                                  phases.items()))
    for engine, why in sorted(tele["decisions"].items()):
        print(f"  {engine}: {why}")
    if args.trace:
        print("\n".join(f"  {name:<48} {w:9.3f}" for name, w, _ in events))
    if not ok:
        raise AssertionError("the verifier rejected the proof")
    return {"pp": pp, "proof": proof, "io": io, "blob": blob,
            "setup_s": setup_s, "prove_s": prove_s, "verify_s": verify_s,
            "phases": phases, "telemetry": tele}


def run(args, **prover) -> dict:
    """Build the model of ``args``, generate ``args.gen`` greedy tokens,
    prove and verify the forward pass of the first ``args.seq``
    (``prove_model``). Returns prove_model's dict with the model and the
    tokens."""
    from .. import models
    rng = np.random.default_rng(42)
    model = models.build_nanogpt(args.vocab, args.seq, args.dim, args.blocks,
                                 args.scale, rng, heads=args.heads)
    print(f"model: {len(model.graph.nodes)} nodes, {args.blocks} blocks, "
          f"dim {args.dim}, seq {args.seq}, vocab {args.vocab}")
    # greedy generation with the quantized interpreter
    toks = [int(t) for t in rng.integers(0, args.vocab, size=args.seq)]
    for _ in range(args.gen):
        logits = model.forward([np.array(toks[-args.seq:],
                                         dtype=np.int32)])[0]
        toks.append(int(np.argmax(logits[-1][: args.vocab])))
    print("greedy tokens:", toks)
    out = prove_model(model, [np.array(toks[:args.seq], dtype=np.int32)],
                      args, **prover)
    return {"model": model, "tokens": toks, **out}


def main(argv: list[str] | None = None) -> int:
    run(parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
