"""The batched opening reduction over a mesh's "sp" shards.

Counterpart of jolt_atlas_tpu/parallel/shardedreduction.py. Every head
instance's RLC row is sharded cyclically over the mesh's D "sp" shards:
element j lives on shard j mod D, as local element j // D. The engine binds
high-to-low, pairing global j with j + n/2, and both lie on one shard while
n >= 2D, so binding never leaves a shard, and shard d's local row is a row
of n/D whose halves pair in the same way. Every instance reaches length D
at global round r_dev = max_rounds - log2(D), where the D values are
gathered and BatchedSumcheck.prove_tail finishes on the host: the proof
bytes equal the single-device and host paths' (the determinism contract,
"N-chip proof == 1-chip proof", tests/test_torch_mesh.py).

A process holds ``mesh.local`` of the D shards (all of them without a
process group). The rows of all joined instances are lanes of one buffer,
lane (s, l) the local shard l of the s-th instance in join order, so each
round is one launch of kernel 4 (``device/reduction.bind``: the joined
lanes bound at the last challenge, the joining ones brought in) and one of
kernel 5 (``device/reduction.q0``: each lane's q(0)). Kernel 5 reads a
lane's weight as whi[off + (i >> shift)] wlo[off' + (i & mask)] over its
local index i, which cannot express the global index i D + d; so each
round the split-eq tables are gathered (``torch.index_select`` on the
device) into two dense tables a lane, read with shift 0 and a full mask.
The lanes' q(0)s meet in ``_psum_planes``: a sum over the local shards,
then, with a process group, one ``dist.all_reduce`` of the int64 planes
(NCCL on the card, gloo on the CPU), and the renormalisation. Fiat-Shamir
runs on the host, one fetch a round, as in the reference.

The engine declines (None, the reason in telemetry.decisions
["mesh_reduction"]) without an "sp" axis, when D is not a power of two,
when no round is left for it (r_dev < 1) and when a head instance's row
is not an FrArray; a build or launch error propagates.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import telemetry
from ..device.rows import Scope
from ..device.field import FR, NLIMBS, _carry, from_planes, to_planes
from ..field.scalar import Fr
from ..utils.profiling import span


def active_mesh():
    sc = active_scope()
    return None if sc is None else sc.mesh


def active_scope():
    return mesh_scope.entered


class mesh_scope(Scope):
    """``with mesh_scope(mesh): prover.prove(...)`` runs the opening
    reduction (``try_prove``) and the IOP's dense Gruen instances
    (parallel/shardedrows.py, under ``rows_gate``, by default
    ``shardedrows.mesh_gate(mesh.device)``) on the mesh; it enters as the
    mesh. As device/rows.Scope (telemetry.EngineScope), it counts what the
    rows engine was offered, took and declined, and records it in
    telemetry on exit: decisions["mesh_iop"] and, for the declines,
    "mesh_iop:declined"."""

    ENGINE, COUNTER, DISPATCHES = ("mesh_iop", "mesh_iop_rows_bound",
                                   "mesh_iop_rows")
    WHERE = "mesh"
    entered = None  # its own, not device/rows.Scope's

    def __init__(self, mesh, rows_gate=None):
        from .shardedrows import mesh_gate
        super().__init__(mesh.device, mesh_gate(mesh.device)
                         if rows_gate is None else rows_gate)
        self.mesh = mesh

    def __enter__(self):
        super().__enter__()
        return self.mesh


def mesh_decline(mesh, n: int | None = None) -> str | None:
    """Why the mesh engines cannot run on ``mesh`` (no "sp" axis, a shard
    count that is not a power of two) or, given ``n``, cannot take rows of
    n elements (fewer than 4 a shard), or None."""
    D = mesh.shape["sp"] if "sp" in mesh.axis_names else 0
    if D < 1:
        return "no 'sp' axis"
    if D & (D - 1):
        return f"{D} shards, not a power of two"
    if n is not None and n < 4 * D:
        return f"n < {4 * D}"
    return None


def shard_index(mesh, m: int) -> torch.Tensor:
    """(L, m) int64 on mesh.device: the global index j = i D + d of local
    element i < m of each local shard d = mesh.first + l (the cyclic
    layout), for gathering weight tables."""
    dev = mesh.device
    i = torch.arange(m, dtype=torch.int64, device=dev)
    d = mesh.first + torch.arange(mesh.local, dtype=torch.int64, device=dev)
    return i[None, :] * mesh.shape["sp"] + d[:, None]


# ---------------------------------------------------------------------------
# the all-reduce of canonical limb planes
# ---------------------------------------------------------------------------

def _cond_sub_const(planes: torch.Tensor, const: int) -> torch.Tensor:
    """(17, ...) int64 planes (16-bit limbs, the top one holding the rest)
    of a value v -> v - const where v >= const, else v."""
    cl = torch.tensor([(const >> (16 * i)) & 0xFFFF for i in range(17)],
                      dtype=torch.int64, device=planes.device)
    d = _carry(planes - cl.reshape((17,) + (1,) * (planes.dim() - 1)))
    return torch.where(d[16] >= 0, d, planes)


def _psum_planes(s: torch.Tensor, mesh) -> torch.Tensor:
    """(16, L, m) canonical planes, a value for each of this process's L
    shards -> (16, m) canonical planes of the sum over the mesh's D shards,
    on the host.

    Each value is below p, so the D values sum to less than D p, each plane
    to less than D 2^16 (an int64 sum, all-reduced over the process group
    if the mesh has one). One carry pass leaves 17 planes of that value,
    and subtracting k p where the value reaches it, for k = D/2, D/4, ...,
    1, halves its bound each time: below 2k p before the step for k, below
    k p after it, so below p at the end (D a power of two;
    tests/test_torch_mesh.py holds it at the worst case, every value p -
    1)."""
    t = s.sum(1)
    if mesh.group is not None:
        import torch.distributed as dist
        dist.all_reduce(t, group=mesh.group)
    t = t.cpu()
    planes = torch.zeros((17,) + t.shape[1:], dtype=torch.int64)
    c = torch.zeros_like(t[0])
    for j in range(16):
        cur = t[j] + c
        planes[j] = cur & 0xFFFF
        c = cur >> 16
    planes[16] = c
    k = mesh.shape["sp"] // 2
    while k >= 1:
        planes = _cond_sub_const(planes, k * FR.P)
        k //= 2
    return planes[:16]


def psum_rows(mesh, vals: torch.Tensor) -> np.ndarray:
    """(L, m, 4) canonical Montgomery rows, a value of each of m sums on
    each local shard -> (m, 4) uint64 rows of the m sums over all shards,
    on the host (the round's one fetch)."""
    L, m = vals.shape[:2]
    planes = to_planes(vals.reshape(-1, 4)).reshape(NLIMBS, L, m)
    return from_planes(_psum_planes(planes, mesh)).numpy().view(np.uint64)


def gather_shards(mesh, x: torch.Tensor) -> torch.Tensor:
    """(L, ...) per-local-shard values -> (D, ...) of every shard in shard
    order, on the host: this process's own, or all of the group's
    (``dist.all_gather``)."""
    if mesh.group is None:
        return x.cpu()
    import torch.distributed as dist
    parts = [torch.empty_like(x) for _ in range(mesh.world)]
    dist.all_gather(parts, x.contiguous(), group=mesh.group)
    return torch.cat(parts).cpu()


def local_columns(x: torch.Tensor, mesh) -> torch.Tensor:
    """(n, 4) rows -> (L, n/D, 4) on their device: local shard l's elements
    j = i D + d (d = mesh.first + l), shard-major, by one strided copy
    there."""
    D = mesh.shape["sp"]
    return x.reshape(-1, D, 4)[:, mesh.first:mesh.first + mesh.local
                               ].transpose(0, 1).contiguous()


# ---------------------------------------------------------------------------
# the sharded rows of the joined instances
# ---------------------------------------------------------------------------

class _ShardedRows:
    """The head instances' rows, cyclically sharded over the mesh, as lanes
    of one buffer on mesh.device: lane s L + l is local shard l of the
    instance order[s] (join order). ``q0`` and ``bind`` run kernels 5 and
    4 over the joined lanes; ``fetch_rows`` gathers the D values an
    instance has left."""

    def __init__(self, mesh, fvecs):
        from ..device.reduction import mont_rows, upload_rows
        self.mesh = mesh
        self.D = mesh.shape["sp"]
        self.L = mesh.local
        dev = mesh.device
        with span("mesh_reduction_upload"):
            # the rows go up as they are (one buffer), and the cyclic
            # layout is made on the device
            raw = upload_rows([f.d for f in fvecs], dev)
            sizes = [len(f) // self.D for f in fvecs]
            self.init_off = torch.tensor(
                np.cumsum([0] + [n for n in sizes for _ in range(self.L)]
                          )[:-1], dtype=torch.int64, device=dev)
            self.init = torch.empty((self.L * sum(sizes), 4),
                                    dtype=torch.int64, device=dev)
            o = 0
            for f, n in zip(fvecs, sizes):
                self.init[o * self.L:(o + n) * self.L] = local_columns(
                    raw[o * self.D:(o + n) * self.D], mesh).reshape(-1, 4)
                o += n
            del raw
        self.buf = torch.empty((0, 4), dtype=torch.int64, device=dev)
        self.one = mont_rows([Fr.one()])
        self.joined = 0

    def bind(self, c, joined: int, lg: int) -> None:
        """Kernel 4: the joined lanes bound at the challenge c ((1, 4)
        Montgomery on the device) into lanes of 2^lg, the next instances'
        lanes up to ``joined`` brought in."""
        from ..device import reduction as dred
        L = self.L
        self.buf = dred.bind(self.buf, self.init, c, self.init_off,
                             self.joined * L, joined * L, lg)
        self.joined = joined
        telemetry.count("mesh_reduction")

    def weights(self, tables, lg: int) -> tuple:
        """Kernel 5's weight table and lane parameters for the joined lanes
        of 2^lg: ``tables`` an instance's (whi, shift, wlo, log_wlo)
        (SplitEq.tables) each. Lane (s, l)'s two tables hold whi[(i D + d)
        >> shift] and wlo[(i D + d) & mask] for i < 2^(lg - 1) (the row of
        Montgomery one where a table is absent), gathered on the device."""
        from ..device.reduction import ABSENT_SHIFT
        dev = self.mesh.device
        m = 1 << (lg - 1)
        raw, rows, prm = [self.one], 1, []
        for whi, shift, wlo, log_wlo in tables:
            p = [0, ABSENT_SHIFT, 0, 0]
            if whi is not None:
                raw.append(np.asarray(whi).view(np.int64).reshape(-1, 4))
                p[:2] = (rows, shift)
                rows += len(raw[-1])
            if wlo is not None:
                raw.append(np.asarray(wlo).view(np.int64).reshape(-1, 4))
                p[2:] = (rows, (1 << log_wlo) - 1)
                rows += len(raw[-1])
            prm.append(p)
        tab = torch.from_numpy(np.concatenate(raw)).to(dev)
        prm = torch.tensor(prm, dtype=torch.int64, device=dev)[:, :, None,
                                                                None]
        j = shard_index(self.mesh, m)[None]                   # (1, L, m)
        idx = torch.stack([prm[:, 0] + (j >> prm[:, 1]),
                           prm[:, 2] + (j & prm[:, 3])], 2)   # (J, L, 2, m)
        gathered = tab.index_select(0, idx.reshape(-1))
        lane = torch.arange(idx.shape[0] * self.L, dtype=torch.int64,
                            device=dev) * (2 * m)
        lanep = torch.stack([lane, torch.zeros_like(lane), lane + m,
                             torch.full_like(lane, m - 1)], 1).contiguous()
        return gathered, lanep

    def q0(self, tables, lg: int) -> np.ndarray:
        """Kernel 5 on every joined lane, then the all-reduce: (J, 4) u64,
        each joined instance's q(0) over the whole mesh."""
        from ..device import reduction as dred
        J, L = self.joined, self.L
        tab, lanep = self.weights(tables, lg)
        q = dred.q0(self.buf, tab, lanep, J * L, lg)
        telemetry.count("mesh_reduction")
        return psum_rows(self.mesh, q.reshape(J, L, 4).transpose(0, 1))

    def fetch_rows(self) -> np.ndarray:
        """(J, D, 4) u64: the D coefficients each instance has left (lanes
        of one element), shard d's at d."""
        J, L = self.joined, self.L
        x = self.buf.reshape(J, L, 4).transpose(0, 1).contiguous()
        got = gather_shards(self.mesh, x)                      # (D, J, 4)
        return np.ascontiguousarray(
            got.transpose(0, 1).numpy()).view(np.uint64)


def lane_order(instances, head, max_rounds: int) -> list:
    """The head instances in join order (by the round they join, then by
    index)."""
    return sorted(head, key=lambda k: (max_rounds - instances[k].num_rounds(),
                                       k))


def try_prove(instances, accumulator, transcript, mesh=None):
    """The opening reduction's BatchedSumcheck with its first r_dev =
    max_rounds - log2(D) rounds on the mesh: (proof, r_sumcheck),
    byte-identical to the host path, or None if no mesh is active or the
    engine declines (the caller falls back; the reason is in
    telemetry.decisions["mesh_reduction"]). The instances must not have
    had setup_sumcheck()."""
    mesh = mesh or active_mesh()
    if mesh is None:
        return None

    def decline(why: str):
        telemetry.decide("mesh_reduction", f"declined: {why}")
        return None

    why = mesh_decline(mesh)
    if why is not None:
        return decline(why)
    D = mesh.shape["sp"]
    log_d = D.bit_length() - 1

    from ..field.frvec import FrArray
    from ..poly.spliteq import SplitEq, inv_cached
    from ..poly.unipoly import CompressedUniPoly
    from ..subprotocols.sumcheck import BatchedSumcheck, _mul_pow2
    from ..device.reduction import fr_of_row, mont_rows

    max_rounds = max(i.num_rounds() for i in instances)
    r_dev = max_rounds - log_d
    if r_dev < 1:
        return decline(f"{max_rounds} rounds, none above the {D} shards")
    head = [k for k, inst in enumerate(instances)
            if max_rounds - inst.num_rounds() < r_dev]
    if not all(isinstance(instances[k].rlc_fvec, FrArray) for k in head):
        return decline("a head row not an FrArray")
    telemetry.decide("mesh_reduction", f"ENGAGED ({D} shards, {len(head)} "
                     f"instances, {r_dev} rounds)")

    # ---- protocol prefix (as BatchedSumcheck.prove)
    claims = [inst.input_claim(accumulator) for inst in instances]
    for c in claims:
        transcript.append_scalar(c)
    coeffs = transcript.challenge_vector(len(instances))

    order = lane_order(instances, head, max_rounds)
    offs = [max_rounds - instances[k].num_rounds() for k in order]
    lane_of = {k: s for s, k in enumerate(order)}
    ses = [SplitEq(instances[k].point) for k in order]
    rows = _ShardedRows(mesh, [instances[k].rlc_fvec for k in order])
    one = Fr.one()
    Q = [claims[k] for k in order]   # running claim a lane
    es = [one] * len(order)          # accumulated eq-line scalar a lane
    r_sumcheck: list[Fr] = []
    compressed: list[CompressedUniPoly] = []
    c_dev = torch.zeros((1, 4), dtype=torch.int64, device=mesh.device)

    for r in range(r_dev):
        joined = sum(1 for o in offs if o <= r)
        lg = max_rounds - r - log_d        # a lane's local length, log2
        with span("mesh_reduction_round"):
            rows.bind(c_dev, joined, lg)
            q0s = rows.q0([ses[s].tables(r - offs[s]) for s in range(joined)],
                          lg)
        b0 = Fr.zero()
        b2 = Fr.zero()
        lane = {}
        for k, inst in enumerate(instances):
            nr = inst.num_rounds()
            if max_rounds - nr > r:
                b0 = b0 + coeffs[k] * _mul_pow2(claims[k],
                                                max_rounds - r - nr - 1)
                continue
            s = lane_of[k]
            q0 = fr_of_row(q0s[s])
            l0, l1 = ses[s].l_linear(r - offs[s])
            q1 = (Q[s] - l0 * q0) * inv_cached(l1)
            dq, dl = q1 - q0, l1 - l0
            b0 = b0 + coeffs[k] * (es[s] * l0 * q0)
            b2 = b2 + coeffs[k] * (es[s] * dl * dq)
            lane[s] = (q0, dq, l0, dl)
        cp = CompressedUniPoly([b0, b2])
        cp.append_to_transcript(transcript)
        c = transcript.challenge_scalar_optimized()
        r_sumcheck.append(c)
        compressed.append(cp)
        for s, (q0, dq, l0, dl) in lane.items():
            Q[s] = q0 + dq * c
            es[s] = es[s] * (l0 + dl * c)
            ses[s].note_challenge(c, r - offs[s])
        c_dev = torch.from_numpy(mont_rows([c])).to(mesh.device)
    with span("mesh_reduction_round"):
        rows.bind(c_dev, len(order), 0)
    with span("mesh_reduction_fetch"):
        left = rows.fetch_rows()

    # ---- hand off to the host tail (each row holds D values now)
    individual_claims: list[Fr] = []
    for k, inst in enumerate(instances):
        nr = inst.num_rounds()
        if k in lane_of:
            s = lane_of[k]
            inst.resume_from_device(FrArray(left[s]), r_dev - offs[s],
                                    ses[s])
            individual_claims.append(es[s] * Q[s])
        else:
            if nr > 0:
                inst.setup_sumcheck()
            individual_claims.append(
                _mul_pow2(claims[k], max_rounds - r_dev - nr)
                if max_rounds - r_dev - nr >= 0 else claims[k])
    return BatchedSumcheck.prove_tail(
        instances, claims, coeffs, individual_claims, compressed,
        r_sumcheck, accumulator, transcript, r_dev, max_rounds)
