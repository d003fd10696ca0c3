"""The port's device layer: PyTorch tensors plus hand-written CUDA kernels.

- build.py      builds the host C++ engines and the CUDA kernels at first use
- telemetry.py  per-engine decisions, dispatch counts and kernel launches
- field.py      BN254 Fq Montgomery arithmetic on (n, 4) int64 limb tensors
- curve.py      complete projective point add (kernel ``pp_add``)
- msm.py        device Pippenger MSM (kernel ``bucket_accumulate``)
"""
