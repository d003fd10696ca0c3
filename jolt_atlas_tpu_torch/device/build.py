"""Build the port's native libraries at first use.

Two kinds of shared library, both loaded with ctypes:

- the host C++ engines from the repo's ``csrc/`` (``msm.cpp``,
  ``frvec.cpp``), compiled with g++ for the CPU this process runs on;
- the port's CUDA kernels, ``jolt_atlas_tpu_torch/csrc/*.cu``, compiled
  with nvcc for Hopper (``sm_90a``) into one library with a plain C
  interface.

Everything lands in ``jolt_atlas_tpu_torch/_build/`` (git-ignored), never in
``csrc/``. Each output is named by a hash of its sources, its compiler
flags and, for host code, the CPU model, so a stale or foreign binary is
never loaded. Builds take a file lock and rename atomically: concurrent
test workers build once and never see a half-written file. A failed build
raises.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO = os.path.dirname(_PKG)
BUILD_DIR = os.path.join(_PKG, "_build")
CUDA_SRC = os.path.join(_PKG, "csrc")
HOST_SRC = os.path.join(_REPO, "csrc")

HOST_FLAGS = ["-O3", "-march=native", "-fopenmp", "-shared", "-fPIC"]
CUDA_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]


def _cpu_tag() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return line
    except OSError:
        pass
    return "unknown-cpu"


def _digest(paths: list[str], extra: list[str]) -> str:
    h = hashlib.sha256()
    for p in paths:
        h.update(os.path.basename(p).encode())
        with open(p, "rb") as f:
            h.update(f.read())
    for e in extra:
        h.update(e.encode())
    return h.hexdigest()[:16]


@contextlib.contextmanager
def _locked(name: str):
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, f".{name}.lock"), "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(lk, fcntl.LOCK_UN)


def _build(name: str, out: str, cmd_for) -> str:
    """Run cmd_for(tmp_path) under the lock unless `out` exists; rename."""
    if os.path.exists(out):
        return out
    with _locked(name):
        if os.path.exists(out):
            return out
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
        os.close(fd)
        try:
            r = subprocess.run(cmd_for(tmp), capture_output=True, text=True,
                               timeout=600)
            if r.returncode != 0:
                raise RuntimeError(f"building {name} failed:\n"
                                   f"{r.stdout}\n{r.stderr}")
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return out


def host_library(name: str) -> str:
    """Path of lib<name>.so built from the repo's csrc/<name>.cpp."""
    src = os.path.join(HOST_SRC, f"{name}.cpp")
    deps = [src] + sorted(glob.glob(os.path.join(HOST_SRC, "*.h")))
    tag = _digest(deps, HOST_FLAGS + [_cpu_tag()])
    out = os.path.join(BUILD_DIR, f"lib{name}-{tag}.so")
    return _build(name, out,
                  lambda tmp: ["g++", *HOST_FLAGS, "-o", tmp, src])


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def cuda_library_path() -> str:
    """Path of the kernels library built from jolt_atlas_tpu_torch/csrc."""
    srcs = sorted(glob.glob(os.path.join(CUDA_SRC, "*.cu")))
    deps = srcs + sorted(glob.glob(os.path.join(CUDA_SRC, "*.cuh")))
    nvcc = nvcc_path()
    tag = _digest(deps, CUDA_FLAGS)
    out = os.path.join(BUILD_DIR, f"libjolt_cuda-{tag}.so")
    return _build("jolt_cuda", out,
                  lambda tmp: [nvcc, *CUDA_FLAGS, "-I", CUDA_SRC,
                               "-o", tmp, *srcs])


_CUDA = None


def cuda_library():
    """The loaded kernels library with its C signatures set (built once)."""
    global _CUDA
    if _CUDA is None:
        lib = ctypes.CDLL(cuda_library_path())
        vp, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.jolt_pp_add.argtypes = [vp] * 9 + [i64, vp]
        lib.jolt_pp_add.restype = ctypes.c_int
        lib.jolt_bucket_accumulate.argtypes = [vp] * 4 + [i64, i64] \
            + [vp] * 3 + [vp]
        lib.jolt_bucket_accumulate.restype = ctypes.c_int
        _CUDA = lib
    return _CUDA
