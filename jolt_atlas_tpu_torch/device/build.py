"""Build the port's native libraries at first use.

Two kinds of shared library, both loaded with ctypes:

- the host C++ engines from the repo's ``csrc/`` (``msm.cpp``,
  ``frvec.cpp``), compiled with g++ for the CPU this process runs on;
- the port's CUDA kernels, ``jolt_atlas_tpu_torch/csrc/*.cu`` (curve,
  msm, combine, reduction, rows, exact, onehot, bind), compiled
  with nvcc for Hopper (``sm_90a``), one nvcc process per source, all
  started together, and linked into one library with a plain C interface.
  ptxas reports each kernel's registers, spills and shared memory
  (``-Xptxas -v``); the report is kept beside the library
  (``ptxas_report``).

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
PTXAS_FLAGS = ["-Xptxas", "-v"]


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
            for f in [tmp] + glob.glob(tmp + ".*.o"):
                if os.path.exists(f):
                    os.unlink(f)
    return out


def host_tag(name: str) -> str:
    """Digest of csrc/<name>.cpp, its headers, flags and CPU: names the
    library built from them."""
    src = os.path.join(HOST_SRC, f"{name}.cpp")
    deps = [src] + sorted(glob.glob(os.path.join(HOST_SRC, "*.h")))
    return _digest(deps, HOST_FLAGS + [_cpu_tag()])


def host_library(name: str) -> str:
    """Path of lib<name>.so built from the repo's csrc/<name>.cpp."""
    src = os.path.join(HOST_SRC, f"{name}.cpp")
    out = os.path.join(BUILD_DIR, f"lib{name}-{host_tag(name)}.so")
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


def _nvcc_objects(nvcc: str, srcs: list[str], tmp: str,
                  log_path: str) -> list[str]:
    """Compile each source to an object next to `tmp`, one nvcc process per
    source, all started together, writing their ptxas reports to
    `log_path`; the link command for them."""
    objs = [f"{tmp}.{i}.o" for i in range(len(srcs))]
    compile_flags = [f for f in CUDA_FLAGS if f != "-shared"] + PTXAS_FLAGS
    procs = [subprocess.Popen([nvcc, *compile_flags, "-I", CUDA_SRC, "-c",
                               src, "-o", obj], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(srcs, objs)]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    failed = [f"{src}:\n{log}" for src, p, log in zip(srcs, procs, logs)
              if p.returncode != 0]
    if failed:
        for obj in objs:
            if os.path.exists(obj):
                os.unlink(obj)
        raise RuntimeError("building jolt_cuda failed:\n" + "\n".join(failed))
    with open(log_path, "w") as f:
        f.write("".join(logs))
    return [nvcc, *CUDA_FLAGS, "-o", tmp, *objs]


def cuda_tag() -> str:
    """Digest of the kernels' sources and flags: names their library."""
    deps = sorted(glob.glob(os.path.join(CUDA_SRC, "*.cu"))
                  + glob.glob(os.path.join(CUDA_SRC, "*.cuh")))
    return _digest(deps, CUDA_FLAGS + PTXAS_FLAGS)


def cuda_library_path() -> str:
    """Path of the kernels library built from jolt_atlas_tpu_torch/csrc."""
    srcs = sorted(glob.glob(os.path.join(CUDA_SRC, "*.cu")))
    nvcc = nvcc_path()
    out = os.path.join(BUILD_DIR, f"libjolt_cuda-{cuda_tag()}.so")
    return _build("jolt_cuda", out,
                  lambda tmp: _nvcc_objects(nvcc, srcs, tmp,
                                            out + ".ptxas.txt"))


def ptxas_report() -> str:
    """ptxas's report (-v) of the build of the kernels library: registers,
    spills and shared memory per kernel. Builds the library if needed."""
    with open(cuda_library_path() + ".ptxas.txt") as f:
        return f.read()


_VP, _I64, _CI = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_U64 = ctypes.c_uint64

# The C signature of every kernel entry point of csrc/*.cu (each returns
# int, a cudaError_t)
SIGNATURES = {
    "jolt_pp_add": [_VP] * 9 + [_I64, _VP],
    "jolt_bucket_accumulate": [_VP] * 5 + [_I64, _I64] + [_CI] * 4
    + [_VP] * 10,
    "jolt_bucket_combine": [_VP] * 3 + [_I64, _CI, _CI, _I64, _CI, _CI]
    + [_VP] * 13,
    "jolt_reduction_bind": [_VP] * 5 + [_I64, _I64, _CI, _VP],
    "jolt_reduction_q0": [_VP] * 6 + [_I64, _CI, _I64, _VP],
    "jolt_reduction_tail": [_VP, _I64, _I64] + [_VP] * 12,
    "jolt_blake2b_transcript": [_VP] * 3 + [_CI, _I64, _VP, _VP],
    "jolt_rows_points": [_VP, _I64, _CI, _CI] + [_VP] * 5 + [_CI, _VP, _I64,
                                                              _I64, _CI, _I64,
                                                              _CI, _CI, _CI]
    + [_VP] * 4,
    "jolt_rows_from_i64": [_VP, _I64, _VP, _VP],
    "jolt_exact_matmul": [_VP] * 4 + [_I64] * 10 + [_CI] * 4 + [_I64, _VP],
    "jolt_onehot_prepare": [_VP] * 3,
    "jolt_onehot_buckets": [_VP] * 4,
    "jolt_onehot_round": [_VP] * 3 + [_I64] + [_U64] * 4 + [_VP, _VP, _I64,
                                                            _VP],
    "jolt_einsum_bind": [_VP, _I64, _I64, _I64, _VP, _VP, _I64, _VP, _VP],
}

_CUDA = None


def cuda_library():
    """The loaded kernels library with its C signatures set (built once)."""
    global _CUDA
    if _CUDA is None:
        lib = ctypes.CDLL(cuda_library_path())
        for name, args in SIGNATURES.items():
            f = getattr(lib, name)
            f.argtypes = args
            f.restype = ctypes.c_int
        _CUDA = lib
    return _CUDA
