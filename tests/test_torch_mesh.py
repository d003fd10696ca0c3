"""The port's multi-device proving step (jolt_atlas_tpu_torch/parallel/)
against the reference (jolt_atlas_tpu/parallel/, field/jaxfr.py).

Exact equality everywhere: FR's added operations against jaxfr's after
to_canonical; the all-reduce's renormalisation against the reference's
pure-jnp ``_cond_sub_const`` and at its worst case; the sharded product
round against the reference's on its virtual 8-device CPU mesh; and the
proof bytes of mesh proves against the reference's host prove bytes
(tests/test_multichip.py ties the reference's own mesh to its host), at D
= 8 shards in one process and at D = 4 over two gloo processes. On the CPU
the kernels run as their plain versions, and the mesh engines must engage.
"""

import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jolt_atlas_tpu import serde as ref_serde
from jolt_atlas_tpu.field import jaxfr
from jolt_atlas_tpu.field.constants import FR_MODULUS
from jolt_atlas_tpu.parallel import make_mesh as ref_make_mesh
from jolt_atlas_tpu.parallel import mesh_scope as ref_mesh_scope
from jolt_atlas_tpu.preprocessing import AtlasPreprocessing as RefPP
from jolt_atlas_tpu.prover import AtlasProver as RefProver
from jolt_atlas_tpu.transcripts import KeccakTranscript as RefKeccak
from jolt_atlas_tpu_torch import convert, serde
from jolt_atlas_tpu_torch.device import rows as drows
from jolt_atlas_tpu_torch.device import split, telemetry
from jolt_atlas_tpu_torch.device.field import FR, from_planes, to_planes
from jolt_atlas_tpu_torch.parallel import make_mesh, mesh_scope
from jolt_atlas_tpu_torch.parallel import mesh as M
from jolt_atlas_tpu_torch.parallel import shardedreduction as SR
from jolt_atlas_tpu_torch.parallel import shardedrows
from jolt_atlas_tpu_torch.prover import AtlasProver
from jolt_atlas_tpu_torch.transcripts import KeccakTranscript
from jolt_atlas_tpu_torch.verifier import AtlasVerifier
from test_torch_srs import port_pp, reference_native

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


# ---------------------------------------------------------------------------
# FR against jaxfr
# ---------------------------------------------------------------------------

def _vals(n: int, seed: int) -> list:
    gen = np.random.default_rng(seed)
    edges = [0, 1, FR_MODULUS - 1, FR_MODULUS - 2, 2**255 % FR_MODULUS]
    return edges + [int.from_bytes(gen.bytes(32), "little") % FR_MODULUS
                    for _ in range(n - len(edges))]


def _port(vals) -> torch.Tensor:
    """Canonical ints -> (16, n) Montgomery planes."""
    return to_planes(M.mont_tensor(vals))


def _port_ints(planes) -> list:
    return M.ints_of(from_planes(planes))


def _ref_ints(limbs) -> list:
    """jaxfr (n, 16) Montgomery limbs (< 2r) -> canonical ints through
    jaxfr.to_canonical."""
    canon = np.asarray(jaxfr.to_canonical(jnp.asarray(limbs)),
                       dtype=np.uint64).reshape(-1, 16)
    return [sum(int(v) << (16 * i) for i, v in enumerate(row))
            for row in canon]


@pytest.mark.parametrize("op", ["mul", "mul_scalar", "add", "sub",
                                "sum_reduce", "dot"])
def test_fr_matches_jaxfr(op):
    a, b = _vals(40, 1), _vals(40, 2)[::-1]
    ja = jnp.asarray(jaxfr.to_limbs_host(a))
    jb = jnp.asarray(jaxfr.to_limbs_host(b))
    pa, pb = _port(a), _port(b)
    ref = {"mul": lambda: jaxfr.mont_mul(ja, jb),
           "mul_scalar": lambda: jaxfr.mont_mul_scalar(ja, jb[3]),
           "add": lambda: jaxfr.add(ja, jb),
           "sub": lambda: jaxfr.sub(ja, jb),
           "sum_reduce": lambda: jaxfr.sum_reduce(ja)[None],
           "dot": lambda: jaxfr.dot(ja, jb)[None]}[op]()
    got = {"mul": lambda: FR.mul(pa, pb),
           "mul_scalar": lambda: FR.mul(pa, pb[:, 3:4]),
           "add": lambda: FR.add(pa, pb),
           "sub": lambda: FR.sub(pa, pb),
           "sum_reduce": lambda: FR.sum_reduce(pa),
           "dot": lambda: FR.dot(pa, pb)}[op]()
    assert _port_ints(got) == _ref_ints(ref)


# ---------------------------------------------------------------------------
# the all-reduce's renormalisation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_cond_sub_const_matches_reference(k):
    from jolt_atlas_tpu.parallel.shardedreduction import \
        _cond_sub_const as ref_cond_sub
    gen = np.random.default_rng(10 + k)
    const = k * FR_MODULUS
    vals = [0, const - 1, const, const + 1, 2 * const - 1] + [
        int(gen.integers(0, 2 * k)) * FR_MODULUS // 2
        + int.from_bytes(gen.bytes(30), "little") for _ in range(27)]
    planes = np.array([[(v >> (16 * i)) & 0xFFFF for v in vals]
                       for i in range(17)], dtype=np.int64)
    ref = ref_cond_sub([jnp.asarray(p, dtype=jnp.uint32) for p in planes],
                       const, jnp)
    got = SR._cond_sub_const(torch.from_numpy(planes), const)
    assert np.array_equal(got.numpy(), np.stack([np.asarray(p) for p in ref]))
    assert [sum(int(got[i, j]) << (16 * i) for i in range(17))
            for j in range(len(vals))] == [v - const if v >= const else v
                                           for v in vals]


class _Shards:
    """The fields of a Mesh _psum_planes reads: D shards, no group."""

    def __init__(self, D):
        self.shape = {"sp": D}
        self.group = None


@pytest.mark.parametrize("D", [1, 2, 4, 8, 16])
def test_psum_renormalises_below_p(D):
    """D values below p sum below D p; subtracting k p for k = D/2 ... 1
    leaves the sum mod p, canonical: at the worst case (every value p - 1)
    and on random values (the planes taken as they are stored)."""
    from jolt_atlas_tpu_torch.device.field import (ints_to_tensor,
                                                   tensor_to_ints)
    vals = [[FR_MODULUS - 1] * D, _vals(D + 5, D)[-D:]]
    s = torch.stack([to_planes(ints_to_tensor(v)) for v in vals], 2)
    got = tensor_to_ints(from_planes(SR._psum_planes(s, _Shards(D))))
    assert got == [sum(v) % FR_MODULUS for v in vals]


# ---------------------------------------------------------------------------
# the sharded product round
# ---------------------------------------------------------------------------

def test_sharded_product_round_matches_reference():
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from jolt_atlas_tpu.parallel.mesh import make_mesh as ref_make_mesh
    from jolt_atlas_tpu.parallel.mesh import \
        sharded_product_round as ref_round
    import random
    rng = random.Random(5)
    T = 1 << 6
    eq = [rng.randrange(FR_MODULUS) for _ in range(T)]
    p = [rng.randrange(FR_MODULUS) for _ in range(T)]
    r = rng.randrange(FR_MODULUS)
    rmesh = ref_make_mesh(8, dp=1)
    spec = NamedSharding(rmesh, P("sp", None))
    outs = ref_round(rmesh)(
        jax.device_put(jnp.asarray(jaxfr.to_limbs_host(eq)), spec),
        jax.device_put(jnp.asarray(jaxfr.to_limbs_host(p)), spec),
        jnp.asarray(jaxfr.to_limbs_host([r])[0]))
    want = [jaxfr.from_limbs_host(np.asarray(o)) for o in outs]
    mesh = make_mesh(8, device="cpu")
    m0, m2, eq2, p2 = M.sharded_product_round(mesh)(
        M.shard_blocks(mesh, M.mont_tensor(eq)),
        M.shard_blocks(mesh, M.mont_tensor(p)), M.mont_tensor([r]))
    got = [M.ints_of(m0), M.ints_of(m2), M.ints_of(eq2), M.ints_of(p2)]
    assert got == want
    plain = M.product_round_plain(eq, p, r)
    assert got == [[plain[0]], [plain[1]], plain[2], plain[3]]
    planes = M.product_round_planes(M.mont_tensor(eq), M.mont_tensor(p),
                                    M.mont_tensor([r]))
    assert [M.ints_of(x) for x in planes] == got


# ---------------------------------------------------------------------------
# mesh proves against the reference's host prove
# ---------------------------------------------------------------------------

def _multichip_model(name):
    """tests/test_multichip.py's models, their weights from a fresh
    generator of that file's seed: the MLP of test_mesh_proof_matches_
    host_proof and the one-block transformer."""
    import test_multichip as tm
    saved = tm.rng
    tm.rng = np.random.default_rng(0x3E5)
    try:
        model, x = (tm._model() if name == "mlp"
                    else tm._transformer_block())
    finally:
        tm.rng = saved
    return model, [x]


_CASES: dict = {}


def _case(name):
    """(name, reference model, port pp, inputs, the reference's host proof
    bytes), made once a name."""
    if name not in _CASES:
        model, inputs = _multichip_model(name)
        ref_pp = RefPP.preprocess(model)
        ref_bytes = ref_serde.serialize_proof(
            RefProver(ref_pp).prove(inputs)[0])
        _CASES[name] = (name, model, port_pp(model, ref_pp), inputs,
                        ref_bytes)
    return _CASES[name]


@pytest.fixture(scope="module", params=["mlp", "transformer_block"])
def case(request):
    return _case(request.param)


_MLP_GATE = drows.forced()


def test_mesh_prove_bytes_equal_reference_host(case):
    """D = 8 shards in one process: both mesh engines engage (the MLP's
    rows instances, of 4 rows or more and 64-512 elements, under a gate
    that takes any row count from 4D = 32 elements up), the bytes equal
    the reference's host prove, the verifier accepts."""
    name, _, pp, inputs, ref_bytes = case
    gate = _MLP_GATE if name == "mlp" else None
    telemetry.reset()
    with mesh_scope(make_mesh(8, device="cpu"), gate) as mesh:
        proof, io = AtlasProver(pp, device="cpu").prove(inputs)
    tele = telemetry.snapshot()
    assert mesh.shape["sp"] == 8
    assert tele["decisions"]["mesh_reduction"].startswith("ENGAGED (8 ")
    assert tele["decisions"]["mesh_iop"].startswith("ENGAGED")
    assert tele["decisions"]["iop"] == "mesh scope active"
    assert tele["dispatches"]["mesh_iop_rows"] > 0
    assert tele["launches"] == {}  # CPU tensors: plain versions only
    assert serde.serialize_proof(proof) == ref_bytes
    assert AtlasVerifier(pp).verify(proof, io)


def test_mesh_declines_record_their_reason():
    """A mesh of 3 shards (not a power of two) and one without an "sp"
    axis: both engines decline with their reason, and the host path gives
    the reference's bytes."""
    _, _, pp, inputs, ref_bytes = _case("mlp")
    for mesh, why in ((make_mesh(3, device="cpu"), "3 shards, not a power "
                       "of two"),
                      (M.Mesh(1, 8, "cpu", axis_names=("dp", "x")),
                       "no 'sp' axis")):
        telemetry.reset()
        with mesh_scope(mesh, _MLP_GATE):
            proof, _ = AtlasProver(pp, device="cpu").prove(inputs)
        tele = telemetry.snapshot()["decisions"]
        assert tele["mesh_reduction"] == f"declined: {why}"
        assert tele["mesh_iop:declined"].startswith(f"{why}: ")
        assert serde.serialize_proof(proof) == ref_bytes


def test_mesh_gate_declines():
    g = shardedrows.mesh_gate("cpu")
    assert (g.max_p, g.min_n, g.head_rounds, g.min_work) == (3, 256, 2, 0)
    assert shardedrows.mesh_gate("cuda").max_p == 96
    assert g.decline(4, 1024, 3, 1) == "P > 3"
    assert g.decline(3, 128, 3, 1) == "n < 256"
    assert SR.mesh_decline(make_mesh(128, device="cpu"), 256) == "n < 512"
    assert SR.mesh_decline(make_mesh(8, device="cpu"), 256) is None
    assert g.decline(3, 256, 21, 1) == "degree > 20"
    assert g.decline(3, 256, 3, 1) is None


def test_keccak_mesh_prove_bytes_equal_reference_mesh():
    """The MLP under KeccakTranscript: the reference's prove on its own
    8-device CPU mesh and the port's in an 8-shard mesh_scope, both mesh
    engines engaged (each runs Fiat-Shamir on the host, whatever the
    transcript), give the same bytes; the port's Keccak verifier accepts
    them and its BLAKE2b verifier rejects them."""
    _, model, pp, inputs, _ = _case("mlp")
    ref_pp = RefPP.preprocess(model)
    with ref_mesh_scope(ref_make_mesh(8, dp=1)):
        ref_proof, _ = RefProver(ref_pp,
                                 transcript_factory=RefKeccak).prove(inputs)
    telemetry.reset()
    with mesh_scope(make_mesh(8, device="cpu"), _MLP_GATE):
        proof, io = AtlasProver(pp, device="cpu",
                                transcript_factory=KeccakTranscript
                                ).prove(inputs)
    tele = telemetry.snapshot()["decisions"]
    assert tele["mesh_reduction"].startswith("ENGAGED (8 ")
    assert tele["mesh_iop"].startswith("ENGAGED")
    assert serde.serialize_proof(proof) == \
        ref_serde.serialize_proof(ref_proof)
    assert AtlasVerifier(pp, KeccakTranscript).verify(proof, io)
    assert not AtlasVerifier(pp).verify(proof, io)


_GLOO = textwrap.dedent("""
    import pickle, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(2)
    from jolt_atlas_tpu_torch import convert, serde
    from jolt_atlas_tpu_torch.device import telemetry
    from jolt_atlas_tpu_torch.parallel import make_mesh, mesh_scope
    from jolt_atlas_tpu_torch.device.rows import forced
    from jolt_atlas_tpu_torch.preprocessing import AtlasPreprocessing
    from jolt_atlas_tpu_torch.prover import AtlasProver
    rank, store_path, desc_path, out_path = (int(sys.argv[1]), sys.argv[2],
                                             sys.argv[3], sys.argv[4])
    store = dist.FileStore(store_path, 2)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=2)
    with open(desc_path, "rb") as f:
        desc, inputs = pickle.load(f)
    pp = AtlasPreprocessing.preprocess(convert.model_from_reference(desc))
    mesh = make_mesh(4, device="cpu", group=dist.group.WORLD)
    assert (mesh.local, mesh.first) == (2, 2 * rank)
    telemetry.reset()
    with mesh_scope(mesh, forced()):
        proof, io = AtlasProver(pp, device="cpu").prove(inputs)
    tele = telemetry.snapshot()["decisions"]
    assert tele["mesh_reduction"].startswith("ENGAGED (4 "), tele
    assert tele["mesh_iop"].startswith("ENGAGED"), tele
    bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
           or m == "jolt_atlas_tpu" or m.startswith("jolt_atlas_tpu.")]
    assert not bad, bad
    with open(out_path, "wb") as f:
        f.write(serde.serialize_proof(proof))
    dist.destroy_process_group()
""")


def test_two_gloo_processes_bytes_equal_reference_host(tmp_path):
    """Two processes of a gloo group, 2 shards each (D = 4), prove the
    MLP: each rank's bytes equal the reference's host prove."""
    _, model, _, inputs, ref_bytes = _case("mlp")
    desc = tmp_path / "model.pkl"
    with open(desc, "wb") as f:
        pickle.dump((convert.describe_model(model), inputs), f)
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _GLOO, str(rank), str(tmp_path / "store"),
         str(desc), str(tmp_path / f"proof{rank}.bin")], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
    for rank in range(2):
        assert (tmp_path / f"proof{rank}.bin").read_bytes() == ref_bytes


# ---------------------------------------------------------------------------
# the entry points, and no jax in the port
# ---------------------------------------------------------------------------

def test_dryrun_multichip_on_cpu():
    from jolt_atlas_tpu_torch.entry import dryrun_multichip
    telemetry.reset()
    dryrun_multichip(8, device="cpu")
    tele = telemetry.snapshot()["decisions"]
    assert tele["mesh_reduction"].startswith("ENGAGED (8 ")
    assert tele["mesh_iop"].startswith("ENGAGED")


def test_new_modules_import_no_jax():
    code = textwrap.dedent("""
        import sys
        import torch
        from jolt_atlas_tpu_torch import entry, torchexec
        from jolt_atlas_tpu_torch.parallel import (make_mesh, mesh_scope,
                                                   sharded_product_round)
        from jolt_atlas_tpu_torch.parallel import mesh, shardedreduction
        from jolt_atlas_tpu_torch.parallel import shardedrows
        fn, args = entry.entry(device="cpu")
        out = fn(*args)
        assert out[0].shape == (8, 32) and out[0].dtype == torch.int32
        m = make_mesh(4, device="cpu")
        t = mesh.mont_tensor(list(range(16)))
        sharded_product_round(m)(mesh.shard_blocks(m, t),
                                 mesh.shard_blocks(m, t),
                                 mesh.mont_tensor([3]))
        bad = [m for m in sys.modules
               if m == "jax" or m.startswith("jax.")
               or m == "jolt_atlas_tpu" or m.startswith("jolt_atlas_tpu.")]
        assert not bad, bad
        print("ok")
    """)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       env=dict(os.environ, OMP_NUM_THREADS="2"),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "ok"
