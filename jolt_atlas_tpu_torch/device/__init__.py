"""The port's device layer: PyTorch tensors plus hand-written CUDA kernels.

- build.py      builds the host C++ engines and the CUDA kernels at first use
- telemetry.py  per-engine decisions, dispatch counts and kernel launches
- field.py      BN254 Fq Montgomery arithmetic on (n, 4) int64 limb tensors
- curve.py      complete projective point add (kernel ``pp_add``)
- msm.py        device Pippenger MSM (kernels ``bucket_accumulate`` and
                ``bucket_combine``)
- gate.py       measured routing of each MSM: device, split or host
- split.py      host+device split MSM and per-MSM routing of a batch
- kernel_report.py  ptxas and SASS figures of the kernels (GPU machine)
"""
