"""What the compiler made of the port's CUDA kernels: ptxas's registers,
spills and shared memory per kernel, a digest of each kernel's SASS, and
the SASS of one Fq product.

    python -m jolt_atlas_tpu_torch.device.kernel_report [-DNAME=V ...] \
        [CSRC_DIR ...]

For each directory of kernel sources (default: the port's own csrc/), it
compiles every .cu for sm_90a with ``-Xptxas -v`` and reads each kernel's
registers, spill bytes and shared memory, and each kernel's SASS
(``cuobjdump -sass``) as an instruction count and a digest of its text, so
two copies of the sources (e.g. a parent commit's) can be shown to compile
a kernel to the same code; then it compiles a probe kernel that does one
``fq_mul`` of that directory's ``fq.cuh`` and counts the probe's SASS
instructions by opcode, IMADs apart.
``-D`` options go to nvcc (e.g. a kernel's launch-bound macro). One JSON
line per directory. Needs nvcc and cuobjdump (the CUDA toolkit),
so it runs on the GPU machine only.
"""

from __future__ import annotations

import collections
import glob
import hashlib
import json
import os
import re
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

from . import build

ARCH = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3"]

_PROBE = r"""
#include "fq.cuh"
extern "C" __global__ void fq_mul_probe(const jolt::u64* a,
                                        const jolt::u64* b, jolt::u64* o) {
  const int i = threadIdx.x;
  jolt::store_fq(o, i, jolt::fq_mul(jolt::load_fq(a, i),
                                    jolt::load_fq(b, i)));
}
"""


def _kernel_name(symbol: str) -> str:
    """The kernel's own name from its (jolt-namespaced) mangled symbol."""
    m = re.match(r"_ZN4jolt(\d+)", symbol)
    if not m:
        return symbol
    start = m.end()
    return symbol[start:start + int(m.group(1))]


def parse_ptxas(text: str) -> dict:
    """{kernel: {"registers", "spill_stores", "spill_loads", "smem"}} from
    ptxas -v output."""
    out: dict = {}
    cur = None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = out.setdefault(_kernel_name(m.group(1)), {
                "registers": None, "spill_stores": 0, "spill_loads": 0,
                "smem": 0})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(s.group(1)) if s else 0
    return out


def _run(cmd: list[str]) -> str:
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{r.stdout}{r.stderr}")
    return r.stdout + r.stderr


def ptxas(csrc: str, defines: tuple = ()) -> dict:
    """ptxas's figures for every kernel of csrc/*.cu (one nvcc each, in
    parallel), compiled with the given -D options."""
    nvcc = build.nvcc_path()
    srcs = sorted(glob.glob(os.path.join(csrc, "*.cu")))
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(
            len(srcs) or 1) as ex:
        logs = ex.map(lambda src: _run(
            [nvcc, *ARCH, *defines, "-Xptxas", "-v", "-I", csrc, "-c", src,
             "-o",
             os.path.join(tmp, os.path.basename(src) + ".o")]), srcs)
        return parse_ptxas("".join(logs))


_SASS_INSN = re.compile(r"\s*/\*[0-9a-f]{4,}\*/\s+([^;]*);")


def parse_sass(text: str) -> dict:
    """{kernel: {"instructions", "digest"}} from cuobjdump -sass output:
    the digest hashes each instruction's text (addresses and encodings
    left out)."""
    out: dict = {}
    name, insns = None, []

    def close():
        if name is not None:
            out[_kernel_name(name)] = {
                "instructions": len(insns),
                "digest": hashlib.sha256(
                    "\n".join(insns).encode()).hexdigest()[:16]}

    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            close()
            name, insns = m.group(1), []
            continue
        m = _SASS_INSN.match(line)
        if m and name is not None:
            insns.append(" ".join(m.group(1).split()))
    close()
    return out


def sass(csrc: str, defines: tuple = ()) -> dict:
    """parse_sass of every kernel of csrc/*.cu (one nvcc each, in
    parallel)."""
    nvcc = build.nvcc_path()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    srcs = sorted(glob.glob(os.path.join(csrc, "*.cu")))

    def one(tmp, src):
        cubin = os.path.join(tmp, os.path.basename(src) + ".cubin")
        _run([nvcc, *ARCH, *defines, "-I", csrc, "-cubin", src, "-o", cubin])
        return _run([cuobjdump, "-sass", cubin])

    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(
            len(srcs) or 1) as ex:
        return parse_sass("".join(ex.map(lambda s: one(tmp, s), srcs)))


def fq_mul_sass(csrc: str) -> dict:
    """SASS instruction counts of a kernel that loads two Fq elements,
    multiplies them once with csrc/fq.cuh's fq_mul and stores the result:
    {"instructions", "imad", "registers", "top": {opcode: count}}."""
    nvcc = build.nvcc_path()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "probe.cu")
        with open(src, "w") as f:
            f.write(_PROBE)
        cubin = os.path.join(tmp, "probe.cubin")
        log = _run([nvcc, *ARCH, "-Xptxas", "-v", "-I", csrc, "-cubin", src,
                    "-o", cubin])
        sass = _run([cuobjdump, "-sass", cubin])
    ops = collections.Counter()
    for line in sass.splitlines():
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]\s+)?"
                     r"([A-Z][A-Z0-9_]*)", line)
        if m:
            ops[m.group(1)] += 1
    return {"instructions": sum(ops.values()),
            "imad": sum(v for k, v in ops.items() if k.startswith("IMAD")),
            "registers": parse_ptxas(log).get("fq_mul_probe", {}).get(
                "registers"),
            "top": dict(ops.most_common(8))}


def report(csrc: str, defines: tuple = ()) -> dict:
    return {"csrc": csrc, "defines": list(defines),
            "kernels": ptxas(csrc, defines),
            "sass": sass(csrc, defines),
            "fq_mul_sass": fq_mul_sass(csrc)}


def main(argv: list[str]) -> int:
    defines = tuple(a for a in argv if a.startswith("-D"))
    for csrc in [a for a in argv if not a.startswith("-D")] or [
            build.CUDA_SRC]:
        print(json.dumps(report(os.path.abspath(csrc), defines)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
