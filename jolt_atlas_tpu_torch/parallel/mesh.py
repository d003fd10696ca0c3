"""The ("dp", "sp") mesh, one sharded product round and the dry run of the
multi-device proving step.

Counterpart of jolt_atlas_tpu/parallel/mesh.py. The reference's mesh is a
jax.sharding.Mesh of devices; here a ``Mesh`` is D = "sp" shards of one
device, of which each process of an optional ``torch.distributed`` group
holds an equal run (``local`` of them, from ``first``). D shards in one
process exercise the cyclic layout and the renormalisation of the
all-reduce, as the reference's virtual 8-device CPU mesh does; ranks of a
group (NCCL on the card, gloo on the CPU) exercise the collective. "dp"
counts replicas of the whole step (the forward's batch shards); the
proving engines shard over "sp".
"""

from __future__ import annotations

import random

import numpy as np
import torch

from ..device.field import FR, from_planes, to_planes
from .shardedreduction import gather_shards, psum_rows


class Mesh:
    """D "sp" shards (times ``dp`` replicas) on ``device``; with ``group``
    (a torch.distributed process group whose size divides D) this process
    holds shards first .. first + local - 1, else all of them."""

    def __init__(self, dp: int, sp: int, device, group=None,
                 axis_names=("dp", "sp")):
        self.axis_names = tuple(axis_names)
        self.shape = {"dp": dp, "sp": sp}
        self.device = torch.device(device)
        self.group = group
        if group is None:
            rank, self.world = 0, 1
        else:
            import torch.distributed as dist
            rank, self.world = (dist.get_rank(group),
                                dist.get_world_size(group))
        if sp % self.world:
            raise ValueError(f"Mesh: {sp} shards over {self.world} ranks")
        self.local = sp // self.world
        self.first = rank * self.local


def make_mesh(n_devices: int, dp: int = 1, device="cuda",
              group=None) -> Mesh:
    """A mesh of n_devices shards, dp x (n_devices / dp), on ``device``
    (the card unless the caller asks for the CPU)."""
    if n_devices < 1 or n_devices % dp:
        raise ValueError(f"make_mesh: {n_devices} shards in {dp} replicas")
    return Mesh(dp, n_devices // dp, device, group)


def shard_blocks(mesh: Mesh, rows: torch.Tensor) -> torch.Tensor:
    """(T, 4) Montgomery rows -> (L, T/D, 4): this process's contiguous
    blocks (the reference's PartitionSpec("sp", None)), on mesh.device."""
    D = mesh.shape["sp"]
    x = rows.reshape(D, -1, 4)[mesh.first:mesh.first + mesh.local]
    return x.contiguous().to(mesh.device)


def sharded_product_round(mesh: Mesh):
    """One low-to-high round of the product sumcheck sum_j eq(j) p(j) over
    the mesh, as a function round_fn(eq, p, r) -> (m0, m2, eq', p').

    eq, p: (L, T/D, 4) Montgomery rows, this process's blocks of the
    (T, 4) rows (``shard_blocks``: block sharding, as the reference's
    "sp" spec); r: a (1, 4) Montgomery challenge. m0 = sum eq_lo p_lo and
    m2 = sum (2 eq_hi - eq_lo)(2 p_hi - p_lo) over the pairs (2i, 2i + 1)
    of the whole mesh, (4,) canonical Montgomery limbs on the host; eq' =
    eq_lo + r (eq_hi - eq_lo) and p' likewise, bound on each shard.

    Each shard's pairs are split into lo and hi halves, which makes them
    the (j, j + n/2) pairs of a 2-row rows instance: kernel 7 (one term
    eq p, no weight) gives its points at 0 and 2, the round's two values,
    and kernel 4 binds its rows in one launch for all shards."""
    from ..device import rows as drows
    from ..field.scalar import Fr
    terms = drows.Terms([(Fr.one(), [0, 1])], mesh.device)
    none = drows.weights(None, 0, None, -1, mesh.device)

    def round_fn(eq, p, r):
        L, t, _ = eq.shape
        h = t // 2
        halves = lambda x: x.reshape(L, h, 2, 4).transpose(1, 2)
        x = torch.stack([halves(eq), halves(p)], 1).reshape(
            L * 2 * t, 4)                      # shard l: rows eq, p of t
        pts = torch.stack([drows.points(x[2 * t * l:2 * t * (l + 1)], t, 2,
                                        terms, none) for l in range(L)])
        m = psum_rows(mesh, pts)               # (2, 4): points 0 and 2
        bound = drows.bind_rows(x, r, t).reshape(L, 2, h, 4)
        return (torch.from_numpy(m[0].view(np.int64)),
                torch.from_numpy(m[1].view(np.int64)),
                bound[:, 0].contiguous(), bound[:, 1].contiguous())

    return round_fn


def product_round_planes(eq: torch.Tensor, p: torch.Tensor,
                         r: torch.Tensor) -> tuple:
    """The round's plain version on FR planes, the reference's round_fn
    op by op over the full rows: eq, p (T, 4) Montgomery rows and r a
    (1, 4) challenge on one device -> (m0, m2) (4,) and eq', p' (T/2, 4)
    Montgomery rows there."""
    e, q, rc = to_planes(eq), to_planes(p), to_planes(r)
    elo, ehi, plo, phi = e[:, 0::2], e[:, 1::2], q[:, 0::2], q[:, 1::2]
    m0 = FR.dot(elo, plo)
    m2 = FR.dot(FR.add(ehi, FR.sub(ehi, elo)), FR.add(phi, FR.sub(phi, plo)))
    bind = lambda lo, hi: FR.add(lo, FR.mul(FR.sub(hi, lo), rc))
    return (from_planes(m0)[0], from_planes(m2)[0],
            from_planes(bind(elo, ehi)), from_planes(bind(plo, phi)))


def product_round_plain(eq: list, p: list, r: int) -> tuple:
    """The round in Python integers over the full rows: (m0, m2, eq', p')
    canonical."""
    P = FR.P
    m0 = sum(a * b for a, b in zip(eq[0::2], p[0::2])) % P
    m2 = sum((2 * eh - el) * (2 * ph - pl) for el, eh, pl, ph in
             zip(eq[0::2], eq[1::2], p[0::2], p[1::2])) % P
    bind = lambda v: [(lo + r * (hi - lo)) % P for lo, hi in
                      zip(v[0::2], v[1::2])]
    return m0, m2, bind(eq), bind(p)


def ints_of(rows) -> list:
    """(..., 4) Montgomery limb rows (a host tensor or array) -> canonical
    ints."""
    a = rows.numpy() if isinstance(rows, torch.Tensor) else np.asarray(rows)
    a = np.ascontiguousarray(a.reshape(-1, 4)).astype("<u8")
    return [FR.from_mont(int.from_bytes(row.tobytes(), "little"))
            for row in a]


def mont_tensor(values) -> torch.Tensor:
    """Canonical ints -> (n, 4) int64 Montgomery limbs."""
    from ..device.reduction import mont_rows
    return torch.from_numpy(mont_rows(values))


def one_block_transformer(seed: int = 0, seq: int = 16, dim: int = 16,
                          vocab: int = 32):
    """The reference dry run's model: a one-block transformer (gather
    embedding, self-attention with softmax, tanh MLP, residuals, LM head)
    and its tokens, from the same seed's draws."""
    from ..frontend import ModelBuilder
    from ..frontend.quantize import quantize_tensor
    nrng = np.random.default_rng(seed + 7)
    b = ModelBuilder(scale=8)
    idx = b.input((seq,))
    emb = b.constant(quantize_tensor(nrng.standard_normal((vocab, dim)), 8))
    x = b.gather(emb, idx)
    wq, wk, wv, wf = (b.constant(quantize_tensor(
        nrng.standard_normal((dim, dim)) * 0.4, 8)) for _ in range(4))
    q = b.einsum("mk,kn->mn", [x, wq])
    k = b.einsum("mk,kn->mn", [x, wk])
    v = b.einsum("mk,kn->mn", [x, wv])
    att = b.softmax_last_axis(b.einsum("mk,nk->mn", [q, k]))
    res1 = b.add(x, b.einsum("mk,kn->mn", [att, v]))
    res2 = b.add(res1, b.tanh(b.einsum("mk,kn->mn", [res1, wf])))
    wl = b.constant(quantize_tensor(
        nrng.standard_normal((dim, vocab)) * 0.4, 8))
    b.output(b.einsum("mk,kn->mn", [res2, wl]))
    model = b.build()
    return model, nrng.integers(0, vocab, size=seq).astype(np.int32)


def dryrun_proving_step(n_devices: int, log_t: int = 6, seed: int = 0,
                        device="cuda"):
    """The multi-device proving step on an n-shard mesh: the one-block
    transformer proved under ``mesh_scope`` (both mesh engines engaged)
    with bytes equal to the single-device prove on ``device`` and
    accepted by the verifier; one sharded product round at 2^log_t
    elements against Python integers; and the quantized forward of
    ``example_mlp`` at 2 rows a shard against the numpy frontend. Raises
    on any difference; returns (m0, the forward's outputs)."""
    from .. import serde, torchexec
    from ..device import telemetry
    from ..preprocessing import AtlasPreprocessing
    from ..prover import AtlasProver
    from ..verifier import AtlasVerifier
    from .shardedreduction import mesh_scope

    mesh = make_mesh(n_devices, dp=1, device=device)
    model, toks = one_block_transformer(seed)
    pp = AtlasPreprocessing.preprocess(model)
    proof_one, _ = AtlasProver(pp, device=device).prove([toks])
    telemetry.reset()
    with mesh_scope(mesh):
        proof_mesh, io = AtlasProver(pp, device=device).prove([toks])
    tele = telemetry.snapshot()["decisions"]
    if not tele.get("mesh_iop", "").startswith("ENGAGED"):
        raise AssertionError(f"the mesh rows engine did not engage: {tele}")
    if not tele.get("mesh_reduction", "").startswith("ENGAGED"):
        raise AssertionError(f"the mesh reduction did not engage: {tele}")
    if serde.serialize_proof(proof_mesh) != serde.serialize_proof(proof_one):
        raise AssertionError("mesh proof bytes differ from the single-device "
                             "proof")
    if not AtlasVerifier(pp).verify(proof_mesh, io):
        raise AssertionError("the verifier rejected the mesh proof")

    # one sharded product round over 2^log_t elements
    rng = random.Random(seed)
    T = 1 << log_t
    eq_v = [rng.randrange(FR.P) for _ in range(T)]
    p_v = [rng.randrange(FR.P) for _ in range(T)]
    r = rng.randrange(FR.P)
    fn = sharded_product_round(mesh)
    m0, m2, eq2, p2 = fn(shard_blocks(mesh, mont_tensor(eq_v)),
                         shard_blocks(mesh, mont_tensor(p_v)),
                         mont_tensor([r]).to(mesh.device))
    got = (ints_of(m0)[0], ints_of(m2)[0],
           ints_of(gather_shards(mesh, eq2)), ints_of(gather_shards(mesh, p2)))
    plain = [ints_of(x.cpu()) for x in product_round_planes(
        *(mont_tensor(v).to(mesh.device) for v in (eq_v, p_v, [r])))]
    if got != (plain[0][0], plain[1][0], plain[2], plain[3]):
        raise AssertionError("sharded product round differs from its plain "
                             "version")
    if got != product_round_plain(eq_v, p_v, r):
        raise AssertionError("sharded product round differs from Python "
                             "integers")

    # the quantized forward, 2 rows a shard, on the mesh's device
    model, xq = torchexec.example_mlp(batch=n_devices * 2, din=32, dh=32,
                                      dout=16)
    outs = torchexec.compile_forward(model, mesh.device)(
        torch.as_tensor(xq, device=mesh.device))
    for o, w in zip(outs, model.forward([xq])):
        if not np.array_equal(o.cpu().numpy(), w):
            raise AssertionError("the quantized forward differs from the "
                                 "numpy frontend")
    return got[0], outs
