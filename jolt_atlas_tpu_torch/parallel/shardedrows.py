"""The IOP's dense Gruen instances over a mesh's "sp" shards.

Counterpart of jolt_atlas_tpu/parallel/shardedrows.py with D > 1 (on one
device the port's single-card engine is device/rows.py). It extends the
cyclic layout of parallel/shardedreduction.py to the IOP's rows
instances: P rows of n, element j of every row on shard j mod D, so
high-to-low binding pairs (j, j + n/2) on one shard while n >= 2D and
shard d's P local rows of n/D are a rows instance of their own. The only
traffic between shards is one all-reduce of the round's points. After
``head_rounds`` rounds, or at n == D, the rows are gathered and the
instance resumes on the host GruenInstance; the round messages, so the
proof bytes, equal the single-device path's.

On the device (``MeshGruen``):

- set-up: the P rows go up as one buffer (``device/rows.upload``: the
  integer rows as int64, converted there by kernel 8 in one launch, the
  field rows as they are), and one strided copy on the device makes the
  local shards' rows of it, shard-major (shard l's P rows at l P n/D);
- each round's points: kernel 7 (``device/rows.points``) on each local
  shard, then ``_psum_planes``. Kernel 7 reads the split-eq weight as
  whi[(i >> shift) & (whi_n - 1)] and wlo[i & (2^log_wlo - 1)] over the
  shard's index i, which cannot express the global index i D + d; so the
  round's tables are gathered on the device (``torch.index_select``) into
  dense per-shard tables, read with shift 0 and masks covering them;
- each bind: kernel 4 (``device/reduction.bind``) with the L P local rows
  as lanes that all continue, one launch.

The caps are a gate object (``mesh_gate``: a device/rows.RowsGate, whose
scope, offer and decline this engine shares), not the reference's
environment variables (JOLT_ATLAS_MESH_MAX_P, _MIN_N, _HEAD_ROUNDS): the
rows at most ``max_p`` (96 on the card, the host engine's cap; 3 on the
CPU, the reference's CPU value), n at least max(4D, ``min_n``), and
``head_rounds`` rounds. A declined instance is counted with its reason in
the active ``mesh_scope``; a build or launch error propagates (the
reference returns None on any exception).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import telemetry
from ..device.rows import RowsGate, offer
from ..field.frvec import FrArray, GruenInstance
from ..utils.profiling import span
from .shardedreduction import (active_mesh, active_scope, gather_shards,
                               mesh_decline, psum_rows, shard_index)

MIN_N = 256
MAX_P_CUDA = 96  # the host GruenInstance.MAXP
MAX_P_CPU = 3    # the reference's cap off an accelerator (shardedrows.py:57)


def mesh_gate(device) -> RowsGate:
    """The mesh rows engine's default gate on ``device``: at most
    MAX_P_CUDA rows on the card (MAX_P_CPU elsewhere), MAX_EVALS points,
    n >= MIN_N (and >= 4D, ``mesh_decline``), for device/rows.HEAD_ROUNDS
    rounds, whatever the instance's work."""
    cuda = torch.device(device).type == "cuda"
    return RowsGate(min_n=MIN_N, min_work=0,
                    max_p=MAX_P_CUDA if cuda else MAX_P_CPU)


def shard_weights(mesh, whi, whi_shift: int, wlo, log_wlo: int,
                  m: int) -> list:
    """One round's split-eq weight (SplitEq.tables' output) as kernel 7
    reads it on each local shard of m pairs: [(tab, whi_off, whi_n, 0,
    wlo_off, log_wlo)], the shards' tables gathered into one tensor, shard
    l's at l 2m: whi[((i D + d) >> whi_shift) & (whi_n - 1)] and wlo[(i D +
    d) & (2^log_wlo - 1)] for i < m. As on the host, whi is used when it has
    more than one row and wlo when log_wlo >= 0. A dense whi of one pair is
    read with whi_n = 2 (its mask keeps i = 0)."""
    from ..device.rows import weights
    dev = mesh.device
    tab, _, whi_n, shift, wlo_off, log_wlo = weights(whi, whi_shift, wlo,
                                                     log_wlo, dev)
    j = shard_index(mesh, m)                               # (L, m)
    hi = (j >> min(shift, 63)) & (whi_n - 1)
    lo = wlo_off + (j & ((1 << max(log_wlo, 0)) - 1))
    gathered = tab.index_select(0, torch.stack([hi, lo], 1).reshape(-1))
    use_hi, use_lo = whi_n > 1, log_wlo >= 0
    log_m = m.bit_length() - 1
    return [(gathered, 2 * m * l, max(m, 2) if use_hi else 1, 0,
             2 * m * l + m, log_m if use_lo else -1)
            for l in range(mesh.local)]


class MeshGruen:
    """frvec.GruenInstance's interface (``round_points``, ``bind``,
    ``row_value``) with the rows cyclically sharded over the mesh for the
    first ``head_rounds`` rounds. ``rows``: each an FrArray or a vector of
    small integers, as the host engine takes them. ``scope`` (the active
    mesh_scope) counts its rounds."""

    def __init__(self, mesh, rows, terms, degree: int, head_rounds: int,
                 scope=None):
        from ..device import rows as drows
        self.mesh = mesh
        self.D = mesh.shape["sp"]
        self.L = mesh.local
        self.terms = [(c, list(f)) for c, f in terms]
        self.degree = degree
        self.P = len(rows)
        self.n = len(rows[0])
        self._host = None
        self._scope = scope
        self._rounds_left = head_rounds
        with span("mesh_rows_upload"):
            # the rows go up as device/rows.upload sends them (integer rows
            # through kernel 8), and the cyclic layout is made on the
            # device: (L P n/D, 4), shard l's P rows at l P n/D
            x = drows.upload(rows, mesh.device).reshape(
                self.P, self.n // self.D, self.D, 4)
            self.x = x[:, :, mesh.first:mesh.first + self.L].permute(
                2, 0, 1, 3).contiguous().reshape(-1, 4)
            self._terms = drows.Terms(self.terms, mesh.device)

    def _fetch_host(self) -> None:
        """Gather every shard's rows and hand them to a host
        GruenInstance."""
        with span("mesh_rows_handoff"):
            m = self.n // self.D
            x = gather_shards(self.mesh, self.x.reshape(self.L, self.P, m,
                                                        4))
            flat = np.ascontiguousarray(
                x.permute(1, 2, 0, 3).numpy()).view(np.uint64)
            self._host = GruenInstance(
                [FrArray(flat[p].reshape(self.n, 4)) for p in range(self.P)],
                self.terms, self.degree)
            self.x = None

    def round_points(self, nevals: int, whi, whi_shift: int, wlo,
                     log_wlo: int):
        """[q(0), q(2), ..., q(nevals)] as an FrArray, as the host's."""
        if self._host is not None:
            return self._host.round_points(nevals, whi, whi_shift, wlo,
                                           log_wlo)
        from ..device.rows import points
        m = self.n // self.D
        with span("mesh_rows_points"):
            ws = shard_weights(self.mesh, whi, whi_shift, wlo, log_wlo,
                               m // 2)
            span_rows = self.P * m
            pts = torch.stack([
                points(self.x[l * span_rows:(l + 1) * span_rows], m, nevals,
                       self._terms, ws[l]) for l in range(self.L)])
            telemetry.count("mesh_iop_rows", self.L)
            got = psum_rows(self.mesh, pts)
        if self._scope is not None:
            self._scope.rounds += 1
        return FrArray(got)

    def bind(self, r) -> None:
        if self._host is not None:
            self._host.bind(r)
            return
        from ..device.reduction import bind, mont_rows
        m = self.n // self.D
        lanes = self.L * self.P
        with span("mesh_rows_bind"):
            c = torch.from_numpy(mont_rows([r])).to(self.mesh.device)
            zero = torch.zeros(lanes, dtype=torch.int64,
                               device=self.mesh.device)
            self.x = bind(self.x, self.x, c, zero, lanes, lanes,
                          (m // 2).bit_length() - 1)
            telemetry.count("mesh_iop_rows")
        telemetry.tally("mesh_iop_rows_bound", self.P * self.n)
        self.n //= 2
        self._rounds_left -= 1
        if self.n <= self.D or self._rounds_left <= 0:
            self._fetch_host()

    def row_value(self, i: int):
        if self._host is None:
            self._fetch_host()
        return self._host.row_value(i)


def try_setup(rows, terms, degree: int):
    """A MeshGruen for this instance under the active mesh_scope, or None
    (no mesh, or declined: the caller takes the next engine; the reason is
    counted in the scope). ``rows``: as the host GruenInstance takes them,
    each an FrArray or a vector of small integers."""
    mesh = active_mesh()
    if mesh is None or not rows:
        return None
    sc = active_scope()
    if not offer(sc, rows, terms, degree, mesh_decline(mesh, len(rows[0]))):
        return None
    return MeshGruen(mesh, rows, terms, degree, sc.gate.head_rounds, sc)
