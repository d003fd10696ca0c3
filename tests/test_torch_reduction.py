"""The port's opening-reduction engine (jolt_atlas_tpu_torch/device/
reduction.py) and its Fr field against the reference and host oracles, on
the CPU, where every kernel wrapper runs its plain version.

- Fr plain mul, add and sub against Python big-int and the reference's
  PlanesCtx(FR_MODULUS) (jolt_atlas_tpu/tpu/fqplanes.py);
- the plain bind and q(0) against the reference's XLA programs
  (tpu/reduction.py: _bind_kernel, _q0_kernel) at tiny shapes;
- the plain tail against a host oracle built from the port's
  Blake2bTranscript and Fr (the reference's _tail_kernel takes minutes to
  compile on a CPU, so it is not run here);
- the engine end to end through AtlasProver(reduction_gate=forced(t)) for
  t = 0 and 4 on an MLP and on the BENCH_SMALL nanoGPT: the proof bytes
  equal the port's host path and the reference's AtlasProver(pp).prove
  (whose own engine declines below its size floor on a CPU, and whose
  device path is byte-identical to its host path by
  tests/test_tpu_reduction.py);
- a tampered device state makes the replay check raise; the gate's
  reasons; a KeccakTranscript prove under a forced gate keeps the host
  path (the card's transcript is BLAKE2b) with the reference's Keccak
  bytes; the constants of the CUDA sources; no module of the port (nor
  chip_smoke.py) imports jax or the reference.

Tolerance: exact everywhere.
"""

import os
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from examples.nanogpt_style import build_model as ref_build_nanogpt
from jolt_atlas_tpu import serde as ref_serde
from jolt_atlas_tpu.field.constants import FR_MODULUS
from jolt_atlas_tpu.frontend import ModelBuilder as RefBuilder
from jolt_atlas_tpu.frontend.quantize import quantize_tensor
from jolt_atlas_tpu.preprocessing import AtlasPreprocessing as RefPP
from jolt_atlas_tpu.prover import AtlasProver as RefProver
from jolt_atlas_tpu.tpu import reduction as ref_red
from jolt_atlas_tpu.tpu.fqplanes import PlanesCtx
from jolt_atlas_tpu_torch import serde
from jolt_atlas_tpu_torch.device import field as F
from jolt_atlas_tpu_torch.device import reduction as R
from jolt_atlas_tpu_torch.device import split, telemetry
from jolt_atlas_tpu_torch.field.scalar import Fr
from jolt_atlas_tpu_torch.poly.unipoly import CompressedUniPoly
from jolt_atlas_tpu_torch.preprocessing import AtlasPreprocessing
from jolt_atlas_tpu_torch.prover import AtlasProver
from jolt_atlas_tpu_torch.transcripts import Blake2bTranscript
from jolt_atlas_tpu_torch.verifier import AtlasVerifier
from test_torch_srs import port_pp, reference_native

# the suite runs in several worker processes at once: a small intra-op
# pool keeps this file from starving its neighbours' timed tests
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "jolt_atlas_tpu_torch", "csrc")


@pytest.fixture(scope="module", autouse=True)
def _host_engines():
    """The reference's csrc engine loaded in this worker before a fixture
    here builds a reference SRS (test_torch_srs.reference_native), and the
    csrc host engines' OpenMP threads capped at 2 while this file runs
    (the reference's wall-clock tests share the machine)."""
    reference_native()
    split.set_host_threads(2)
    yield
    split.set_host_threads(None)


def _ints(rng, n):
    vals = [int.from_bytes(rng.bytes(32), "little") % FR_MODULUS
            for _ in range(n)]
    return [0, 1, FR_MODULUS - 1, FR_MODULUS - 2] + vals


def _u64(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


def _mont_ints(t: torch.Tensor) -> list[int]:
    return F.tensor_to_ints(t)


# ---------------------------------------------------------------------------
# Fr field
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", ["mul", "add", "sub"])
def test_fr_plain_matches_bigint_and_reference(op):
    rng = np.random.default_rng({"mul": 1, "add": 2, "sub": 3}[op])
    a, b = _ints(rng, 60), _ints(rng, 60)[::-1]
    ta, tb = (F.ints_to_tensor([F.FR.to_mont(v) for v in x]) for x in (a, b))
    got = [F.FR.from_mont(v) for v in F.tensor_to_ints(
        getattr(F.FR, op + "4")(ta, tb))]
    want = {"mul": lambda x, y: x * y, "add": lambda x, y: x + y,
            "sub": lambda x, y: x - y}[op]
    assert got == [want(x, y) % FR_MODULUS for x, y in zip(a, b)]
    ctx = PlanesCtx(FR_MODULUS)
    ref = ctx.from_planes(np.asarray(getattr(ctx, op)(ctx.to_planes(a),
                                                      ctx.to_planes(b))))
    assert got == ref


def _cuda_constants(name: str) -> list[int]:
    """The 8 u32 limbs of the array ``name`` in the CUDA sources."""
    text = "".join(open(os.path.join(CSRC, f)).read()
                   for f in ("fq.cuh", "reduction.cu"))
    m = re.search(name + r"\[8\] = \{([^}]*)\}", text)
    return [int(x.strip().rstrip("u"), 16) for x in m.group(1).split(",")]


def test_cuda_field_constants():
    """p, -p^-1 mod 2^32 and R mod p of both fields in csrc/fq.cuh, and
    2^384 mod r in csrc/reduction.cu, are the moduli's."""
    text = open(os.path.join(CSRC, "fq.cuh")).read()
    for field, p in (("FqField", F.FQ.P), ("FrField", F.FR.P)):
        body = text[text.index(f"struct {field}"):]
        body = body[:body.index("};\n\n")]
        arrays = re.findall(r"\[8\] = \{([^}]*)\}", body)
        limbs = [[int(x.strip().rstrip("u"), 16) for x in a.split(",")]
                 for a in arrays]
        as_int = [sum(v << (32 * i) for i, v in enumerate(lm))
                  for lm in limbs]
        assert as_int == [p, (1 << 256) % p]
        n0 = int(re.search(r"N0 = (0x[0-9a-f]+)u", body).group(1), 16)
        assert n0 == (-pow(p, -1, 1 << 32)) % (1 << 32)
    t384 = _cuda_constants("T384")
    assert sum(v << (32 * i) for i, v in enumerate(t384)) == pow(
        2, 384, FR_MODULUS)


def test_cuda_signatures_match_sources():
    """The ctypes signatures device/build.py gives the kernels library are
    those of the extern "C" entry points in csrc/*.cu."""
    import ctypes
    from jolt_atlas_tpu_torch.device import build
    ctype = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
             "int64_t": ctypes.c_int64, "int": ctypes.c_int,
             "unsigned long long": ctypes.c_uint64}
    found = {}
    for f in sorted(os.listdir(CSRC)):
        if f.endswith(".cu"):
            text = open(os.path.join(CSRC, f)).read()
            for name, args in re.findall(
                    r'extern "C" int (jolt_\w+)\(([^)]*)\)', text):
                found[name] = [ctype[" ".join(a.split()[:-1])]
                               for a in args.split(",")]
    assert found == build.SIGNATURES


def _redc_sum(T: int, n: int) -> int:
    """csrc/fq.cuh's mont_redc_sum on a sum T of n products, step by step:
    8 word steps of m = t N0 mod 2^32 on the low half, the high half added,
    then the conditional subtractions (4r only for n > 15, then 2r, r)."""
    R32, p = 1 << 32, FR_MODULUS
    n0 = (-pow(p, -1, R32)) % R32
    t = T % (1 << 256)
    for _ in range(8):
        t = (t + (t % R32) * n0 % R32 * p) >> 32
    assert t <= p
    x = t + (T >> 256)
    assert x < 1 << 256, "u + H must fit the 8 limbs"
    for k in ((4, 2, 1) if n > 15 else (2, 1)):
        if x >= k * p:
            x -= k * p
    return x


@pytest.mark.parametrize("n", [8, 15, 16, 22])
def test_lazy_sum_bounds_hold(n):
    """The lazy sum of kernel 5 (wide products, one reduction) gives the
    canonical Montgomery sum for n products at the worst case (every factor
    r - 1) and on random factors; the limits its source states (at most 22
    products, a third subtraction from 16) are the tight ones; kernel 5's
    terms a thread fit them."""
    p, big = FR_MODULUS, 1 << 256
    rng = np.random.default_rng(n)
    for pairs in ([(p - 1, p - 1)] * n,
                  [tuple(_ints(rng, 2)[4:]) for _ in range(n)]):
        T = sum(a * b for a, b in pairs)
        assert T < 1 << 512
        got = _redc_sum(T, n)
        assert got < p and got == T * pow(big, -1, p) % p
    worst = lambda k: (k * (p - 1) ** 2 >> 256) + p  # u + H at its largest
    assert worst(22) < big <= worst(23)
    assert worst(15) < 4 * p <= worst(16)
    fq = open(os.path.join(CSRC, "fq.cuh")).read()
    assert "N <= 22, \"" in fq and "if (N > 15)" in fq
    log = int(re.search(r"constexpr int LOG_Q0_PER_THREAD = (\d+);", open(
        os.path.join(CSRC, "reduction.cu")).read()).group(1))
    assert R.Q0_PER_THREAD == 1 << log <= 22


def test_kernel_report_reads_stack_frames_and_chains():
    """device/kernel_report.py reads a kernel's stack frame from ptxas -v
    (the card tests require none for kernel 6) and counts the longest
    chain of dependent SASS instructions (kernel 6's latency bound):
    registers, register pairs (.64, .WIDE), 128-bit loads and carry
    predicates carry the dependences."""
    from jolt_atlas_tpu_torch.device import kernel_report as kr
    log = textwrap.dedent("""
        ptxas info    : Compiling entry function '_ZN4jolt4tailEv' for 'sm_90a'
        ptxas info    : Function properties for _ZN4jolt4tailEv
            112 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
        ptxas info    : Used 128 registers, 1056 bytes smem, 472 bytes cmem[0]
        ptxas info    : Compiling entry function '_ZN4jolt2q0Ev' for 'sm_90a'
        ptxas info    : Function properties for _ZN4jolt2q0Ev
            0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
        ptxas info    : Used 56 registers, 1025 bytes smem
    """)
    assert kr.parse_ptxas(log) == {
        "tail": {"registers": 128, "stack": 112, "spill_stores": 0,
                 "spill_loads": 0, "smem": 1056},
        "q0": {"registers": 56, "stack": 0, "spill_stores": 8,
               "spill_loads": 4, "smem": 1025}}
    insns = ["MOV R2, 0x1", "MOV R3, 0x2",
             "IADD3 R4, P0, R2, R3, RZ",          # 2
             "IADD3.X R5, R3, R3, RZ, P0, !PT",   # 3: the carry
             "LOP3.LUT R9, R3, R3, R3, 0x96, !PT",  # 2: independent
             "IMAD.WIDE.U32 R6, R5, R4, R2",      # 4: writes R6, R7
             "LDG.E.128 R12, desc[UR4][R6.64]",   # 5: R12..R15
             "@P0 IADD3 R20, R15, R9, RZ",        # 6
             "STG.E desc[UR4][R2.64], R20",       # 7: a store, no dest
             "STS.64 [R3+0x8], R20",              # 7
             "LDS R30, [R9]",                     # 8: after the store
             "SHFL.IDX PT, R31, R30, 0x1, 0x1c03"]  # 9: writes R31
    assert kr.chain_length(insns) == 9
    assert kr.chain_length(insns[:5]) == 3
    assert kr.chain_length(insns[:7] + ["SHFL.IDX PT, R31, R9, 0x1, 0x1c03",
                                        "IADD3 R32, R31, R31, RZ"]) == 5


# ---------------------------------------------------------------------------
# kernels 4 and 5 against the reference's XLA programs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("j_prev,lanes,lg", [(0, 3, 3), (2, 4, 2)])
def test_plain_bind_matches_reference(j_prev, lanes, lg):
    d = R.random_round("cpu", np.random.default_rng(50 + lg), j_prev, lanes,
                       lg)
    got = R.bind(d["buf"], d["init"], d["c"], d["init_off"], j_prev, lanes,
                 lg)
    size, n_out = 1 << lg, lanes << lg
    i = np.arange(n_out)
    s, j = i >> lg, i & (size - 1)
    cont = s < j_prev
    lo_pos = np.where(cont, 2 * s * size + j, 0).astype(np.int32)
    hi_pos = np.where(cont, 2 * s * size + size + j, 0).astype(np.int32)
    init_pos = np.where(cont, 0, d["init_off"].numpy()[s] + j).astype(
        np.int32)
    buf = _u64(d["buf"]) if j_prev else np.zeros((1, 4), np.uint64)
    init = _u64(d["init"])
    want = ref_red._bind_kernel(n_out, len(buf), len(init))(
        ref_red._u64_to_planes(buf), ref_red._u64_to_planes(init),
        ref_red._u64_to_planes(_u64(d["c"])), lo_pos, hi_pos, init_pos,
        ~cont)
    assert np.array_equal(ref_red._planes_to_u64(np.asarray(want)),
                          _u64(got))


@pytest.mark.parametrize("lanes,lg", [(3, 4), (2, 13), (1, 15), (12, 13)])
def test_plain_q0_matches_reference(lanes, lg):
    """Each lane's q(0) equals the reference's lazy limb sums reduced mod
    r: lanes of one kernel block and of several (2^15: four blocks of
    4,096 terms), and 12 lanes over a table of 1024 rows, every weight
    layout of random_round (s % 6)."""
    d = R.random_round("cpu", np.random.default_rng(60 + lg), 0, lanes, lg,
                       1024 if lanes >= 12 else 64)
    buf = R.bind(d["buf"], d["init"], d["c"], d["init_off"], 0, lanes, lg)
    got = R.q0(buf, d["tab"], d["lanep"], lanes, lg)
    assert got.shape == (lanes, 4)
    got = [v % FR_MODULUS for v in _mont_ints(got)]
    half = 1 << (lg - 1)
    tab = _u64(d["tab"])
    K = len(tab)                          # an all-zero column for padding
    Kpad = 1 << K.bit_length()
    tabz = np.zeros((Kpad, 4), np.uint64)
    tabz[:K] = tab
    lp = d["lanep"].numpy()
    j = np.arange(half)
    blk = min(ref_red._Q0_BLK, half)
    Ipad = 1 << lanes.bit_length()        # lane Ipad - 1 takes the padding
    G = 1 << (lanes * half - 1).bit_length()
    whi_idx = np.full(G, K, np.int32)
    wlo_idx = np.full(G, K, np.int32)
    lo_q = np.zeros(G, np.int32)
    blkseg = np.full(G // blk, Ipad - 1, np.int32)
    for s in range(lanes):
        sl = slice(s * half, (s + 1) * half)
        whi_idx[sl] = lp[s, 0] + (j >> lp[s, 1])
        wlo_idx[sl] = lp[s, 2] + (j & lp[s, 3])
        lo_q[sl] = (s << lg) + j
        blkseg[s * half // blk:(s + 1) * half // blk] = s
    planes = ref_red._u64_to_planes(tabz)
    qsum = np.asarray(ref_red._q0_kernel(len(buf), Kpad, Ipad, G // blk,
                                         blk)(
        ref_red._u64_to_planes(_u64(buf)), planes, planes, whi_idx, wlo_idx,
        lo_q, blkseg)).astype(object)
    want = [sum((int(qsum[0, i, s]) + (int(qsum[1, i, s]) << 16)) << (16 * i)
                for i in range(16)) % FR_MODULUS for s in range(lanes)]
    assert got == want


# ---------------------------------------------------------------------------
# kernel 6 against a host oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lanes,joined,bpl", [(8, 5, 3), (4, 0, 1),
                                              (4, 4, 2), (32, 32, 1),
                                              (640, 600, 1)])
def test_plain_tail_matches_host_oracle(lanes, joined, bpl):
    """Unjoined and zero-padding lanes; l1 = 0 with 1/l1 given as 0 (lane
    0) and l0 = 0 (lane 1). Each joined lane's q(0) is the sum of bpl
    random partials, as kernel 5's blocks hand it over."""
    rng = np.random.default_rng(70 + lanes)
    d = R.random_tail("cpu", rng, lanes, joined)
    parts = [R.fr_of_row(r) for r in R.random_rows(
        max(joined * bpl, 1), rng, "cpu").numpy()]
    d["q0s"] = torch.from_numpy(R.mont_rows(
        [sum(parts[s * bpl:(s + 1) * bpl], Fr.zero())
         for s in range(max(joined, 1))]))
    k = {n: t.clone() for n, t in d.items()}
    c = torch.empty((1, 4), dtype=torch.int64)
    msg = torch.empty((2, 4), dtype=torch.int64)
    R.tail(k["q0s"], joined, k["Q"], k["es"], k["qinit"], k["coeff"],
           k["l0"], k["l1"], k["inv_l1"], k["const_b0"], k["state"], c, msg)
    fr = {n: [R.fr_of_row(row) for row in t.numpy()]
          for n, t in d.items() if n != "state"}
    b0, b2 = fr["const_b0"][0], Fr.zero()
    Qw, esw = list(fr["qinit"]), list(fr["es"])
    lines = []
    for s in range(joined):
        q0 = Fr.zero()
        for x in parts[s * bpl:(s + 1) * bpl]:
            q0 = q0 + x
        assert fr["q0s"][s] == q0
        l0, l1 = fr["l0"][s], fr["l1"][s]
        q1 = (fr["Q"][s] - l0 * q0) * fr["inv_l1"][s]
        b0 = b0 + fr["coeff"][s] * fr["es"][s] * l0 * q0
        b2 = b2 + fr["coeff"][s] * fr["es"][s] * (l1 - l0) * (q1 - q0)
        lines.append((q0, q1, l0, l1))
    t = Blake2bTranscript(b"oracle")
    state = d["state"].numpy()
    t.state = state[:4].astype("<i8").tobytes()
    t.n_rounds = int(state[4])
    CompressedUniPoly([b0, b2]).append_to_transcript(t)
    ch = t.challenge_scalar_optimized()
    for s, (q0, q1, l0, l1) in enumerate(lines):
        Qw[s] = q0 + (q1 - q0) * ch
        esw[s] = fr["es"][s] * (l0 + (l1 - l0) * ch)
    assert [R.fr_of_row(r) for r in msg.numpy()] == [b0, b2]
    assert R.fr_of_row(c[0].numpy()) == ch
    assert k["state"][:4].numpy().astype("<i8").tobytes() == t.state
    assert int(k["state"][4]) == t.n_rounds
    assert [R.fr_of_row(r) for r in k["Q"].numpy()] == Qw
    assert [R.fr_of_row(r) for r in k["es"].numpy()] == esw


# ---------------------------------------------------------------------------
# the engine end to end
# ---------------------------------------------------------------------------

def _mlp():
    """tests/test_tpu_reduction.py's MLP: 64 -> relu(64) -> 32."""
    rng = np.random.default_rng(0xD0)
    b = RefBuilder(scale=8)
    x = b.input((1, 64))
    w1 = b.constant(quantize_tensor(rng.standard_normal((64, 64)), 8))
    w2 = b.constant(quantize_tensor(rng.standard_normal((64, 32)), 8))
    h = b.relu(b.einsum("bi,ij->bj", [x, w1]))
    b.output(b.einsum("bi,ij->bj", [h, w2]))
    return b.build(), [quantize_tensor(rng.standard_normal((1, 64)), 8)]


def _bench_small():
    """bench.py's BENCH_SMALL nanoGPT: vocab 32, seq 8, d16, 1 block."""
    rng = np.random.default_rng(1234)
    model = ref_build_nanogpt(32, 8, 16, 1, 8, rng, heads=1)
    return model, [rng.integers(0, 32, size=8).astype(np.int32)]


@pytest.fixture(scope="module", params=["mlp", "bench_small"])
def case(request):
    """(port pp, inputs, the reference's proof bytes, the port's host-path
    proof bytes)."""
    model, inputs = {"mlp": _mlp, "bench_small": _bench_small}[
        request.param]()
    ref_pp = RefPP.preprocess(model)
    ref_bytes = ref_serde.serialize_proof(RefProver(ref_pp).prove(inputs)[0])
    pp = port_pp(model, ref_pp)
    telemetry.reset()
    host, _ = AtlasProver(pp, device="cpu").prove(inputs)
    assert telemetry.snapshot()["decisions"]["reduction"] == \
        "host path (device=cpu)"
    return pp, inputs, ref_bytes, serde.serialize_proof(host)


@pytest.mark.parametrize("tail_rounds", [0, 4])
def test_forced_engine_bytes_equal_host_and_reference(case, tail_rounds):
    pp, inputs, ref_bytes, host_bytes = case
    assert host_bytes == ref_bytes
    telemetry.reset()
    proof, io = AtlasProver(pp, device="cpu",
                            reduction_gate=R.forced(tail_rounds)).prove(
                                inputs)
    tele = telemetry.snapshot()
    assert tele["decisions"]["reduction"].startswith("ENGAGED (")
    assert tele["dispatches"]["reduction"] > 0
    assert tele["launches"] == {}  # CPU tensors: plain versions only
    assert serde.serialize_proof(proof) == ref_bytes
    if tail_rounds == 0:
        assert AtlasVerifier(pp).verify(proof, io)


def test_tampered_device_state_raises(case, monkeypatch):
    """A device transcript that differs from the host's replay (one bit of
    the state after the last round) makes the engine raise."""
    pp, inputs = case[:2]
    real = R.tail
    calls = []

    def bad_tail(*args):
        real(*args)
        calls.append(1)
        args[10][0] ^= 1  # state word 0
    monkeypatch.setattr(R, "tail", bad_tail)
    with pytest.raises(RuntimeError, match="diverged from the host replay"):
        AtlasProver(pp, device="cpu", reduction_gate=R.forced(0)).prove(
            inputs)
    assert calls


class _Inst:
    """Just what the gate reads of a reduction instance."""

    def __init__(self, nr):
        from jolt_atlas_tpu_torch.field.frvec import FrArray
        self.nr = nr
        self.rlc_fvec = FrArray(np.zeros((1 << nr, 4), np.uint64))

    def num_rounds(self):
        return self.nr


@pytest.mark.parametrize("device,gate,why", [
    ("cpu", R.ReductionGate(), "host path (device=cpu)"),
    ("cuda", R.ReductionGate(), "below size floor (48 elems)"),
    ("cuda", R.forced(tail_rounds=3), "too few rounds (4, 3 on the host)"),
])
def test_gate_declines_with_its_reason(device, gate, why):
    """The engine declines before touching the device or the transcript
    (a CUDA device need not exist here) and says why."""
    telemetry.reset()
    insts = [_Inst(4), _Inst(4), _Inst(3), _Inst(3)]
    assert R.try_prove(insts, None, None, torch.device(device), gate) is None
    assert telemetry.snapshot()["decisions"]["reduction"] == why


def test_keccak_transcript_keeps_the_host_path():
    """The card's transcript is BLAKE2b: under KeccakTranscript a forced
    gate declines before any device work, and the proof bytes equal the
    host path's and the reference's Keccak proof."""
    from jolt_atlas_tpu.transcripts import KeccakTranscript as RefKeccak
    from jolt_atlas_tpu_torch.transcripts import KeccakTranscript
    model, inputs = _mlp()
    ref_pp = RefPP.preprocess(model)
    ref_bytes = ref_serde.serialize_proof(RefProver(
        ref_pp, transcript_factory=RefKeccak).prove(inputs)[0])
    pp = port_pp(model, ref_pp)
    host, _ = AtlasProver(pp, device="cpu",
                          transcript_factory=KeccakTranscript).prove(inputs)
    telemetry.reset()
    got, _ = AtlasProver(pp, device="cpu", transcript_factory=KeccakTranscript,
                         reduction_gate=R.forced(0)).prove(inputs)
    tele = telemetry.snapshot()
    assert tele["decisions"]["reduction"] == "transcript not BLAKE2b"
    assert not tele["dispatches"].get("reduction")
    assert serde.serialize_proof(got) == serde.serialize_proof(host) \
        == ref_bytes


def test_zk_prove_keeps_the_host_path():
    from jolt_atlas_tpu_torch.frontend import ModelBuilder
    b = ModelBuilder()
    x = b.input([8])
    b.output(b.relu(b.add(x, b.constant(np.arange(8, dtype=np.int32)))))
    pp = AtlasPreprocessing.preprocess(b.build())
    xs = np.array([3, -4, 5, -6, 7, -8, 9, -10], dtype=np.int32)
    telemetry.reset()
    AtlasProver(pp, device="cpu", reduction_gate=R.forced(0)).prove_zk([xs])
    assert telemetry.snapshot()["decisions"]["reduction"] == "zk"


def test_port_modules_import_no_jax():
    """Every module of jolt_atlas_tpu_torch, and chip_smoke.py, loads
    neither jax nor jolt_atlas_tpu."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import jolt_atlas_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                       pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        import chip_smoke
        bad = [m for m in sys.modules
               if m == "jax" or m.startswith("jax.")
               or m == "jolt_atlas_tpu" or m.startswith("jolt_atlas_tpu.")]
        assert not bad, bad
        assert "jolt_atlas_tpu_torch.device.reduction" in sys.modules
        assert "jolt_atlas_tpu_torch.device.rows" in sys.modules
        print(len(names))
    """)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       env=dict(os.environ, OMP_NUM_THREADS="2"),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert int(r.stdout.strip()) > 50
