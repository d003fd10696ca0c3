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
    """{kernel: {"registers", "stack", "spill_stores", "spill_loads",
    "smem"}} from ptxas -v output (stack: the bytes of its stack frame)."""
    out: dict = {}
    cur = None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = out.setdefault(_kernel_name(m.group(1)), {
                "registers": None, "stack": 0, "spill_stores": 0,
                "spill_loads": 0, "smem": 0})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur["stack"], cur["spill_stores"], cur["spill_loads"] = map(
                int, m.groups())
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


def sass_functions(text: str) -> dict:
    """{kernel: [instruction text, ...]} from cuobjdump -sass output,
    addresses and encodings left out."""
    out: dict = {}
    insns = None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            insns = out.setdefault(_kernel_name(m.group(1)), [])
            continue
        m = _SASS_INSN.match(line)
        if m and insns is not None:
            insns.append(" ".join(m.group(1).split()))
    return out


def _opcode(insn: str) -> str:
    """An instruction's opcode, its guard predicate (@P0, @!P1) aside."""
    words = insn.split()
    return words[1] if words[0].startswith("@") else words[0]


# tensor-core opcodes: mma.sync's (IMMA for integers, HMMA) and wgmma's
# (the GMMA family)
TENSOR_OPCODES = ("IMMA", "HMMA", "IGMMA", "HGMMA", "QGMMA", "BGMMA")


def parse_sass(text: str) -> dict:
    """{kernel: {"instructions", "imad", "tensor", "digest"}} from
    cuobjdump -sass output: the digest hashes each instruction's text
    (addresses and encodings left out); imad counts the IMAD instructions
    and tensor the tensor-core ones (TENSOR_OPCODES), a guard predicate
    aside."""
    return {name: {"instructions": len(insns),
                   "imad": sum(_opcode(i).startswith("IMAD")
                               for i in insns),
                   "tensor": sum(_opcode(i).startswith(TENSOR_OPCODES)
                                 for i in insns),
                   "digest": hashlib.sha256(
                       "\n".join(insns).encode()).hexdigest()[:16]}
            for name, insns in sass_functions(text).items()}


_NO_DEST = ("ST", "RED", "BAR", "BRA", "EXIT", "RET", "BSYNC", "BSSY",
            "WARPSYNC", "CALL", "NOP", "MEMBAR", "FENCE", "CCTL", "DEPBAR",
            "JMP", "YIELD", "ERRBAR")
_REG = re.compile(r"\b(U?R)(\d+)(\.64)?\b|\b(U?P)(\d)\b")


def _regs(operand: str, width: int = 1) -> list:
    """The registers an operand names (R2.64 is R2 and R3; PT, RZ none)."""
    out = []
    for m in _REG.finditer(operand):
        if m.group(1):
            n = int(m.group(2))
            w = 2 if m.group(3) else width
            out += [f"{m.group(1)}{n + k}" for k in range(w)]
        else:
            out.append(f"{m.group(4)}{m.group(5)}")
    return out


def chain_length(insns: list) -> int:
    """The longest chain of dependent instructions in straight-line SASS
    (each instruction one step after the latest writer of any register or
    predicate it reads, a shared-memory load one step after the latest
    shared-memory store): the fewest dependent issues the code needs.
    Branches are read as straight-line code, so give it code without
    them."""
    depth: dict = {}
    longest = 0
    for ins in insns:
        guard = []
        if ins.startswith("@"):
            g, ins = ins.split(None, 1)
            guard = _regs(g)
        op, _, args = ins.partition(" ")
        ops = [a.strip() for a in args.split(",")] if args else []
        nd = 0
        if ops and not op.startswith(_NO_DEST):
            nd = 1  # the first operand, then any carry-out predicates
            while nd < len(ops) and re.fullmatch(r"U?P[T\d]", ops[nd]):
                nd += 1
            if op.startswith("SHFL"):  # SHFL Pout, Rout, ...
                nd = 2
        width = 4 if ".128" in op else 2 if (".64" in op or ".WIDE" in op) \
            else 1
        dests = [r for o in ops[:nd] for r in _regs(o, width)]
        srcs = guard + [r for o in ops[nd:] for r in _regs(o)]
        if op.startswith("LDS"):
            srcs.append("smem")
        d = 1 + max((depth.get(r, 0) for r in srcs), default=0)
        for r in dests:
            depth[r] = d
        if op.startswith("STS"):
            depth["smem"] = max(depth.get("smem", 0), d)
        longest = max(longest, d)
    return longest


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


# Kernel 6's round (csrc/reduction.cu tail_round, the code the kernel
# runs) on four lanes with no block sum: one lane's message terms, the
# canonical conversion and payload words, the long absorb and the squeeze,
# the challenge and one lane's update. Its block sums and the latency of
# its loads are left out, so its chain is a part of the kernel's critical
# path.
_TAIL_PATH_PROBE = r"""
#include "reduction.cu"
using namespace jolt;
struct NoSum {
  __device__ void operator()(Fr&, Fr&) const {}
};
extern "C" __global__ void tail_path_probe(u64* a) {
  tail_round(TailIo{a, a + 32, a + 64, a + 96, a + 128, a + 160, a + 192,
                    a + 224, a + 256, a + 264, a + 268},
             threadIdx.x & 3, true, NoSum{});
}
"""


def tail_path_chain(csrc: str) -> dict:
    """The serial work of one kernel 6 round (``_TAIL_PATH_PROBE``,
    compiled against csrc's reduction.cu): its SASS instructions up to
    EXIT, its longest dependent chain (``chain_length``, which reads
    branches as straight-line code) and its branches."""
    nvcc = build.nvcc_path()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "probe.cu")
        with open(src, "w") as f:
            f.write(_TAIL_PATH_PROBE)
        cubin = os.path.join(tmp, "probe.cubin")
        _run([nvcc, *ARCH, "-I", csrc, "-cubin", src, "-o", cubin])
        insns = sass_functions(_run([cuobjdump, "-sass", cubin]))[
            "tail_path_probe"]
    body = insns[:insns.index("EXIT")] if "EXIT" in insns else insns
    return {"instructions": len(body), "chain": chain_length(body),
            "branches": sum(i.lstrip("@!P0123456T ").startswith("BRA")
                            for i in body)}


# Dependent-issue latency of the integer pipe: one thread runs a chain of
# n steps and times it with clock64. Kind 0: x = rotl(x + y, 7), a 3-input
# add and a funnel shift a step (BLAKE2b's mixes; the two cannot fuse);
# kind 1: x = x * x + y, one IMAD a step (the field products).
_CHAIN_PROBE = r"""
#include <cuda_runtime.h>
__global__ void chain_probe(unsigned long long* out, unsigned x, unsigned y,
                            int n, int kind) {
  const long long t0 = clock64();
  if (kind == 0) {
    for (int i = 0; i < n; ++i) {
#pragma unroll
      for (int k = 0; k < 32; ++k)
        asm volatile("add.u32 %0, %0, %1;\n\tshf.l.wrap.b32 %0, %0, %0, 7;"
                     : "+r"(x) : "r"(y));
    }
  } else {
    for (int i = 0; i < n; ++i) {
#pragma unroll
      for (int k = 0; k < 32; ++k)
        asm volatile("mad.lo.u32 %0, %0, %0, %1;" : "+r"(x) : "r"(y));
    }
  }
  const long long t1 = clock64();
  out[0] = (unsigned long long)(t1 - t0);
  out[1] = x;
}
extern "C" int jolt_chain_probe(void* out, unsigned x, unsigned y, int n,
                                int kind) {
  chain_probe<<<1, 1>>>((unsigned long long*)out, x, y, n, kind);
  return (int)cudaGetLastError();
}
"""


def probe_library(source: str, csrc: str, tmp: str):
    """``source`` built with nvcc (sm_90a, csrc on the include path) into a
    shared library under ``tmp``, loaded with ctypes; ptxas's figures for
    its kernels (``parse_ptxas``) as its ``ptxas`` attribute."""
    import ctypes
    src = os.path.join(tmp, "probe.cu")
    with open(src, "w") as f:
        f.write(source)
    lib = os.path.join(tmp, "libprobe.so")
    log = _run([build.nvcc_path(), *ARCH, "-Xptxas", "-v", "-shared",
                "-Xcompiler", "-fPIC", "-I", csrc, src, "-o", lib])
    loaded = ctypes.CDLL(lib)
    loaded.ptxas = parse_ptxas(log)
    return loaded


def int_latency(steps: int = 4096) -> dict:
    """Cycles a dependent step of each ``_CHAIN_PROBE`` chain takes on the
    current CUDA device ("add_shf" two instructions a step, "imad" one),
    and the least cycles of one dependent integer instruction of the two
    ("per_instruction")."""
    import ctypes
    import torch
    out = torch.zeros(2, dtype=torch.int64, device="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        lib = probe_library(_CHAIN_PROBE, build.CUDA_SRC, tmp)
        f = lib.jolt_chain_probe
        f.argtypes = [ctypes.c_void_p, ctypes.c_uint, ctypes.c_uint,
                      ctypes.c_int, ctypes.c_int]
        res = {}
        for kind, name, per in ((0, "add_shf", 2), (1, "imad", 1)):
            cyc = []
            for _ in range(3):  # the first launch loads the module
                if f(out.data_ptr(), 3, 5, steps // 32, kind):
                    raise RuntimeError("chain probe launch failed")
                torch.cuda.synchronize()
                cyc.append(int(out[0]))
            res[name] = min(cyc) / steps
            res[name + "_per_instruction"] = res[name] / per
    res["per_instruction"] = min(res["add_shf_per_instruction"],
                                 res["imad_per_instruction"])
    return res


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
