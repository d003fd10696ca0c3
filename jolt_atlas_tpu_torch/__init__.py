"""jolt_atlas_tpu_torch: the PyTorch/CUDA port of jolt_atlas_tpu.

The JAX package jolt_atlas_tpu stays the reference; this package proves the
same statements with byte-identical proofs, with its device engines written
in PyTorch and hand-written CUDA kernels for an NVIDIA H100. It imports
neither jax nor jolt_atlas_tpu.

Like the reference, it is a Jolt-style lookup-based zkML SNARK with the
capabilities of ICME-Lab/jolt-atlas: it proves that an ONNX neural-network
inference was executed correctly, using sumcheck IOPs + Twist/Shout lookup
arguments over BN254 with a single batched HyperKZG opening.

Layer map (mirrors reference layers L0-L4, see SURVEY.md):
  - field/        BN254 scalar-field arithmetic (Python-int scalars and the
                  native C++ Montgomery vectors, csrc/frvec.cpp)
  - transcripts/  Blake2b Fiat-Shamir transcript (bit-compatible state machine
                  with reference joltworks/src/transcripts/blake2b.rs)
  - curve/        BN254 G1/G2, pairing, Pippenger MSM
  - poly/         multilinear polynomials (dense/compact/one-hot), eq polys,
                  univariate polys, opening accumulator
  - subprotocols/ sumcheck engine, Shout lookups, prefix-suffix sumchecks,
                  one-hot validity checks, evaluation reduction
  - commitment/   HyperKZG / KZG / Pedersen commitment schemes
  - frontend/     ONNX loader + fixed-point (i32) quantized graph interpreter
                  (reference: atlas-onnx-tracer)
  - zkops/        per-operator proof layer (reference: jolt-atlas-core ops)
  - device/       PyTorch tensors + hand-written CUDA kernels: the device
                  MSM engine that carries commit and hyperkzg_open, the
                  opening reduction and the IOP rows engine
  - parallel/     the ("dp", "sp") mesh: the opening reduction and the IOP
                  rows sharded over it (torch.distributed collectives)
  - torchexec     the exact quantized forward (an exact-product kernel)
  - entry         the package's entry points: entry(), dryrun_multichip()
"""

__version__ = "0.1.0"
