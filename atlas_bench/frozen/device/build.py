"""Build the frozen verifier's host C++ engines (``csrc/msm.cpp``,
``csrc/frvec.cpp``) at first use, with g++ for the CPU this process runs
on, into ``_build/`` (git-ignored). Each output is named by a hash of its
sources, its compiler flags and the CPU model, so a stale or foreign
binary is never loaded. Builds take a file lock and rename atomically. A
failed build raises.
"""

from __future__ import annotations

import contextlib
import fcntl
import glob
import hashlib
import os
import subprocess
import tempfile

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG, "_build")
HOST_SRC = os.path.join(_PKG, "csrc")

HOST_FLAGS = ["-O3", "-march=native", "-fopenmp", "-shared", "-fPIC"]


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
