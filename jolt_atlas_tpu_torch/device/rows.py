"""The IOP rows engine on the card: the head rounds of the dense Gruen
sumchecks of the IOP, with plain versions, kernel wrappers and the engine's
entry point ``try_setup``.

Counterpart of jolt_atlas_tpu/parallel/shardedrows.py on one device. The
IOP proves each graph node by sumchecks over rows instances
(subprotocols/sumcheck.py:RowsInstance): P rows of n Fr elements, a list of
product terms sum_k c_k prod_{f in F_k} row_f, and an eq factor that the
Gruen split-eq schedule (poly/spliteq.py) turns into small weight tables a
round. The host engine is field/frvec.py:GruenInstance. ``DeviceGruen`` has
its interface (``round_points``, ``bind``, ``row_value``) and runs the
first ``head_rounds`` rounds on the card, where the rows are largest:

- set-up: the rows go up in one buffer of P equal segments, row p at p n:
  a row of small integers as int64, turned into Montgomery form on the
  card by kernel 8 (csrc/rows.cu) ``from_i64``, a field row as it is (the
  reference converts every row on the host and sends 32 bytes an
  element); the term list goes up once;
- each round's message, kernel 7 (csrc/rows.cu) ``points``: the weighted
  term sums at t = 0, 2, ..., nevals, summed on the card and fetched, the
  round's one synchronisation (the challenge comes from the host
  transcript);
- each bind, kernel 4 (csrc/reduction.cu) as ``bind_rows``: the P rows are
  P lanes of kernel 4 that all continue and none joins;
- the handoff: after the head rounds, or once the rows hold one element,
  they come back to a host GruenInstance for the remaining rounds.

The round messages, and so the proof bytes, equal the host engine's.

The reference's mesh ('sp' axis, cyclic layout, psum of limb planes) is
parallel/shardedrows.py's, which builds on this engine. Its switches
(JOLT_ATLAS_TPU_IOP, the relay link model, JOLT_ATLAS_MESH_MIN_N,
JOLT_ATLAS_MESH_HEAD_ROUNDS, JOLT_ATLAS_MESH_MAX_P) are one argument, the
gate (``RowsGate``, ``forced``), given to ``AtlasProver(iop_gate=)``; the
prover enters the engine's ``Scope`` around its IOP loop only
(AtlasProver._iop_engines), so the opening reduction's rows never reach
this engine. A gate declines an instance before any device work and
records why; a build or launch failure propagates (the reference's
``except Exception: return None`` is gone).

Each wrapper dispatches on its tensors' device: CUDA tensors launch the
kernel, CPU tensors run the plain version, with no fallback from one to the
other. Field elements are (n, 4) int64 tensors of Montgomery limbs
(device/field.py), which is ``FrArray.d`` as it is.
"""

from __future__ import annotations

import numpy as np
import torch

from ..field.frvec import FrArray, GruenInstance
from ..utils.profiling import span
from . import telemetry
from .field import FR, NLIMBS, from_planes, to_planes
from .reduction import _check, bind, mont_rows

MAX_P = 96           # the host GruenInstance.MAXP
MAX_EVALS = 20       # GruenInstance.MAXE
# kernel 7's launch plan (csrc/rows.cu; ``points_plan``): a block takes a
# tile of pairs (a power of two, >= 32: a warp's worth) times the terms'
# slices in threads, at most MAX_BLOCK; the tile grows while the block has
# at most BLOCK_THREADS threads and its shared memory fits SMEM_MAX. A
# block walks all the points unless that leaves fewer than BLOCKS_PER_SM
# blocks an SM. Measured on an H100 on the bench's largest class
# (scripts/rows_points_bench.py --terms bench --plans; PERF.md): 6 slices
# and all 6 points a block 0.120 ms, 8 slices 0.134, 4 slices 0.125, 2
# points a block 0.128, one 0.137.
TILE_MIN = 32
BLOCK_THREADS = 256
MAX_BLOCK = 512
MAX_SLICES = 16
DEFAULT_MAX_SLICES = 6
SMEM_MAX = 232448 - 2048  # Hopper's 227 KB a block, less the static part
BLOCKS_PER_SM = 1
# The default gate, measured on an H100 host against the host engine on
# the bench's own instances (scripts/rows_sweep.py, chip_smoke.py phase 12;
# PERF.md): with 2 head rounds the card lost at 1,024 elements a row in
# every run, so the floor rose from the reference's JOLT_ATLAS_MESH_MIN_N
# (256); running every round down to the floor did not beat 2 head rounds
# beyond the runs' spread, so the reference's JOLT_ATLAS_MESH_HEAD_ROUNDS
# (2) stays. The engine costs a few ms an instance whatever its work (its
# copies, a fetch a round, the handoff), so it also declines an instance
# with little work in its first round (``work``): the one-term classes of
# 2-4 rows (2-4 factors a pair, <= 82K) lost in every run, the 17-row
# class (0.54M) in most, and the classes of 23-28 rows (>= 1.78M) tied or
# won.
MIN_N = 2048
MIN_WORK = 1 << 20
HEAD_ROUNDS = 2


def work(n: int, factors: int, degree: int) -> int:
    """An instance's first round as the host does it: the row values it
    forms, n / 2 pairs x ``factors`` (sum_k |F_k| over the term list) x
    ``degree`` points."""
    return (n // 2) * factors * max(1, degree)


class RowsGate:
    """Which instances the engine takes: on a CUDA device, those of at
    least ``min_n`` elements a row and ``min_work`` (``work``), at most
    ``max_p`` rows and MAX_EVALS points, for ``head_rounds`` rounds;
    ``forced``, the same on any device (the plain versions on a CPU
    one). The mesh rows engine (parallel/shardedrows.py) takes its
    instances through one too (``shardedrows.mesh_gate``)."""

    def __init__(self, head_rounds: int = HEAD_ROUNDS, min_n: int = MIN_N,
                 forced: bool = False, min_work: int = MIN_WORK,
                 max_p: int = MAX_P):
        self.head_rounds = head_rounds
        self.min_n = min_n
        self.forced = forced
        self.min_work = min_work
        self.max_p = max_p

    def decline(self, P: int, n: int, degree: int,
                factors: int) -> str | None:
        """Why the engine does not take an instance of P rows of n
        elements, this degree and ``factors`` factors over its terms, or
        None."""
        if P > self.max_p:
            return f"P > {self.max_p}"
        if max(1, degree) > MAX_EVALS:
            return f"degree > {MAX_EVALS}"
        if n < max(self.min_n, 2):
            return f"n < {max(self.min_n, 2)}"
        if self.head_rounds < 1:
            return "no head rounds"
        if work(n, factors, degree) < self.min_work:
            return f"work < {self.min_work}"
        return None


def forced(head_rounds: int = HEAD_ROUNDS, min_n: int = 2) -> RowsGate:
    """A gate that engages on any device at any size from ``min_n`` up."""
    return RowsGate(head_rounds, min_n, True, 0)


# ---------------------------------------------------------------------------
# kernel 7: the round's points
# ---------------------------------------------------------------------------

def group_terms(terms) -> list:
    """The terms [(coeff, factors)] as groups that share a head:
    [(head, [(k, tail), ...])], k the term's index. A term's factors are
    ordered by how many terms hold them (most first, then by row); its head
    is all but the last and its tail the last, or the whole term is the
    head (empty tail) where that is another term's head. Terms of one
    factor or none, and a head that only one term has, go headless with
    their factors as given. The sum of c_k prod(head) prod(tail) over the
    members is prod(head) times the members' sum: one product of the head a
    group instead of one a term (the bench's 36-term class: two 5-factor
    heads of 9 terms each)."""
    held: dict = {}
    for _, fs in terms:
        for f in set(fs):
            held[f] = held.get(f, 0) + 1
    order = [sorted(fs, key=lambda f: (-held[f], f)) for _, fs in terms]
    heads = {tuple(o[:-1]) for o in order if len(o) >= 2}
    groups: dict = {}
    for k, o in enumerate(order):
        if tuple(o) in heads:
            head, tail = tuple(o), []
        elif len(o) >= 2:
            head, tail = tuple(o[:-1]), o[-1:]
        else:
            head, tail = (), o
        groups.setdefault(head, []).append((k, tail))
    alone = [(k, terms[k][1]) for h, m in groups.items() if h and len(m) == 1
             for k, _ in m]
    out = [(list(h), m) for h, m in groups.items() if h and len(m) > 1]
    return out + [([], groups.get((), []) + alone)] if (
        alone or () in groups) else out


def part_cost(head: list, members: list, ones: list) -> int:
    """A part's work a pair and point: its head's product chain and the
    head's product by the members' sum (if it has a head), and each
    member's tail chain, its coefficient product (unless one) and add.
    ``ones[k]``: term k's coefficient is one."""
    c = len(head)
    for k, tail in members:
        c += 1 + max(len(tail) - 1, 0) + (bool(tail) and not ones[k])
    return c


def deal_terms(costs: list, slices: int) -> list:
    """The indices of each slice: longest first, each to the slice with
    the least work so far (ties to the lowest slice)."""
    out = [[] for _ in range(slices)]
    load = [0] * slices
    for k in sorted(range(len(costs)), key=lambda k: -costs[k]):
        s = min(range(slices), key=lambda s: (load[s], s))
        out[s].append(k)
        load[s] += costs[k]
    return out


def make_parts(groups: list, ones: list, slices: int) -> list:
    """The units ``slices`` threads share, [(head, members)]: each member
    of a headless group alone, and each group with a head whole, or split
    into as many parts (each with the head) as bring it within a slice's
    share of the work."""
    parts = []
    for head, mem in groups:
        parts += [(head, mem)] if head else [([], [m]) for m in mem]
    total = sum(part_cost(h, m, ones) for h, m in parts)
    share = max(1, -(-total // slices))
    out = []
    for head, mem in parts:
        k = min(len(mem), -(-part_cost(head, mem, ones) // share))
        if not head or k <= 1:
            out.append((head, mem))
            continue
        bins = deal_terms([part_cost([], [m], ones) for m in mem], k)
        out += [(head, [mem[i] for i in b]) for b in bins if b]
    return out


def default_slices(T: int) -> int:
    """Term slices a pair for T terms: DEFAULT_MAX_SLICES, or T if fewer
    (at least one)."""
    return max(1, min(DEFAULT_MAX_SLICES, T))


class Terms:
    """A term list [(Fr coeff, [row indices])] on a device. ``factors``
    and ``coeffs`` ((T, 4) Montgomery limbs) keep the terms as given (the
    plain version's); ``groups`` (``group_terms``) share heads. Kernel 7
    reads the groups' parts (``make_parts``) dealt into ``slices``
    (``deal_terms``; default ``default_slices``), slice after slice, from
    one int64 buffer: the members' coefficients (``kcoeffs``, (T, 4),
    first: 16-byte aligned), the parts (``parts``, (parts, 4): head
    factors [ha, hb) and members [ma, mb)), the members (``members``, (T,
    2): tail factors [ta, tb)), the factor indices ``fidx`` (at least one
    entry) and the slices' slices + 1 ``bounds`` into the parts."""

    def __init__(self, terms, device, slices: int | None = None):
        terms = [(c, [int(i) for i in f]) for c, f in terms]
        self.T = len(terms)
        self.slices = default_slices(self.T) if slices is None else slices
        if not 1 <= self.slices <= MAX_SLICES:
            raise ValueError(f"Terms: 1 <= slices <= {MAX_SLICES}, got "
                             f"{self.slices}")
        self.factors = [f for _, f in terms]
        ones = [c.is_one() for c, _ in terms]
        self.groups = group_terms(terms)
        parts = make_parts(self.groups, ones, self.slices)
        dealt = deal_terms([part_cost(h, m, ones) for h, m in parts],
                           self.slices)
        fidx, ptab, mtab, order = [], [], [], []
        for q in (q for sl in dealt for q in sl):
            head, mem = parts[q]
            ha = len(fidx)
            fidx += head
            ptab.append([ha, len(fidx), len(order), len(order) + len(mem)])
            for k, tail in mem:
                mtab.append([len(fidx), len(fidx) + len(tail)])
                fidx += tail
                order.append(k)
        bounds = np.cumsum([0] + [len(sl) for sl in dealt])
        buf = np.concatenate([
            mont_rows([c for c, _ in terms]).reshape(-1),
            mont_rows([terms[k][0] for k in order]).reshape(-1),
            np.asarray(ptab, dtype=np.int64).reshape(-1),
            np.asarray(mtab, dtype=np.int64).reshape(-1),
            np.asarray(fidx or [0], dtype=np.int64),
            bounds.astype(np.int64)])
        buf = torch.from_numpy(buf).to(device)
        T, o = self.T, 8 * self.T
        self.coeffs = buf[:4 * T].view(T, 4)
        self.kcoeffs = buf[4 * T:o].view(T, 4)
        self.parts = buf[o:o + 4 * len(ptab)]
        o += 4 * len(ptab)
        self.members = buf[o:o + 2 * T]
        o += 2 * T
        self.fidx = buf[o:o + max(len(fidx), 1)]
        self.bounds = buf[o + max(len(fidx), 1):]


def weights(whi, whi_shift: int, wlo, log_wlo: int, device) -> tuple:
    """One round's split-eq weight (SplitEq.tables' output) as kernel 7
    reads it: (tab, whi_off, whi_n, whi_shift, wlo_off, log_wlo), both
    tables in one upload. As on the host, whi is used when it has more
    than one row and wlo when log_wlo >= 0; a missing wlo counts as
    log_wlo = -1."""
    parts, whi_n, wlo_off = [], 1, 0
    if whi is not None:
        parts.append(np.asarray(whi).view(np.int64).reshape(-1, 4))
        whi_n = wlo_off = len(parts[0])
    if wlo is None:
        log_wlo = -1
    else:
        parts.append(np.asarray(wlo).view(np.int64).reshape(-1, 4))
    tab = np.concatenate(parts) if parts else np.zeros((1, 4), np.int64)
    return (torch.from_numpy(np.ascontiguousarray(tab)).to(device), 0,
            whi_n, int(whi_shift), wlo_off, int(log_wlo))


def layout(w: tuple) -> int:
    """The weight layout of a round: 1 if whi is used, plus 2 if wlo is."""
    return int(w[2] > 1) + 2 * int(w[5] >= 0)


def smem_bytes(P: int, slices: int, tile: int, group: int) -> int:
    """Kernel 7's shared memory a block (csrc/rows.cu rows_points_smem):
    the P rows' e and d, the weights and the slices' sums, rows of ``tile``
    Fr elements, and a sum a point of the group and warp of pairs."""
    return (2 * P + 1 + slices) * tile * 32 + group * (tile // 32) * 32


def points_plan(P: int, n: int, nevals: int, slices: int, sms: int,
                tile: int | None = None, group: int | None = None) -> dict:
    """Kernel 7's launch over the n / 2 pairs of P rows at ``nevals``
    points with ``slices`` term slices on a card of ``sms`` SMs: the tile
    (pairs a block; ``TILE_MIN`` up, doubled while the block stays within
    BLOCK_THREADS threads and SMEM_MAX, and below n / 2), the group (points
    a block, so that the grid has about BLOCKS_PER_SM blocks an SM), the
    grid (tiles, groups) and the shared bytes. ``tile`` and ``group`` may
    be given (measurement)."""
    half = n // 2
    if tile is None:
        tile = TILE_MIN
        while (2 * tile * slices <= BLOCK_THREADS and 2 * tile <= half
               and smem_bytes(P, slices, 2 * tile, nevals) <= SMEM_MAX):
            tile *= 2
    tiles = -(-half // tile)
    if group is None:
        groups = min(nevals, max(1, -(-BLOCKS_PER_SM * sms // tiles)))
        group = -(-nevals // groups)
    groups = -(-nevals // group)
    smem = smem_bytes(P, slices, tile, group)
    if (tile < TILE_MIN or tile & (tile - 1) or tile * slices > MAX_BLOCK
            or not 1 <= group <= nevals or smem > SMEM_MAX):
        raise ValueError(f"points_plan: no launch for P = {P}, {slices} "
                         f"slices, tile {tile}, group {group}")
    return {"tile": tile, "slices": slices, "group": group, "tiles": tiles,
            "groups": groups, "threads": tile * slices, "smem": smem}


def points_case(P: int, nevals: int, T: int, w: tuple, plan: dict) -> tuple:
    """The shape class of a kernel 7 launch: (P, nevals, terms, layout)
    and the tile, slices and group of its plan, which partition it."""
    return (P, nevals, T, layout(w), plan["tile"], plan["slices"],
            plan["group"])


def kernel_case(x, n: int, nevals: int, terms: Terms, w: tuple) -> tuple:
    """The shape class ``points`` records for this launch on x's CUDA
    device (its default plan)."""
    P = x.shape[0] // n
    plan = points_plan(P, n, nevals, terms.slices, _card(x.device)[0])
    return points_case(P, nevals, terms.T, w, plan)


_CARDS: dict = {}


def _card(device) -> tuple:
    """(SMs, kernel 7's ticket counter) of a CUDA device, made at its first
    launch: the counter is one u32, zero between launches (the kernel's
    last block resets it)."""
    k = device.index if device.index is not None else \
        torch.cuda.current_device()
    if k not in _CARDS:
        _CARDS[k] = (torch.cuda.get_device_properties(k).multi_processor_count,
                     torch.zeros(1, dtype=torch.int32,
                                 device=torch.device("cuda", k)))
    return _CARDS[k]


def _weight_planes(w: tuple, half: int, device):
    """(16, half) planes of w(j) for j < half, or None where it is one."""
    tab, whi_off, whi_n, whi_shift, wlo_off, log_wlo = w
    j = torch.arange(half, dtype=torch.int64, device=device)
    out = None
    if log_wlo >= 0:
        out = to_planes(tab[wlo_off + (j & ((1 << log_wlo) - 1))])
    if whi_n > 1:
        h = to_planes(tab[whi_off + ((j >> min(whi_shift, 63))
                                     & (whi_n - 1))])
        out = h if out is None else FR.mul(out, h)
    return out


def term_sums(x, n: int, nevals: int, terms: Terms):
    """For t = 0, 2, ..., nevals in turn: (E, inner), the (16, P + 1, n / 2)
    planes of every row at t (row P all ones) and the (16, n / 2) planes of
    sum_k c_k prod_f E[f] on every pair, each term a product chain over its
    factors padded with the row of ones."""
    device = x.device
    P, half, T = x.shape[0] // n, n // 2, terms.T
    rows = x.reshape(P, n, 4)
    lo = to_planes(rows[:, :half].reshape(-1, 4))
    hi = to_planes(rows[:, half:].reshape(-1, 4))
    d = FR.sub(hi, lo)
    one = torch.tensor(FR.MONT_ONE_LIMBS, dtype=torch.int64, device=device)
    ones = one[:, None, None].expand(NLIMBS, 1, half)
    width = max([len(f) for f in terms.factors] + [1])
    idx = torch.tensor([f + [P] * (width - len(f)) for f in terms.factors],
                       dtype=torch.int64, device=device).reshape(T, width)
    cf = to_planes(terms.coeffs)[:, :, None].expand(NLIMBS, T, half)
    cf = cf.reshape(NLIMBS, T * half)
    e = lo
    for i in range(nevals):
        t = i + 1 if i else 0
        if t == 2:
            e = FR.add(hi, d)
        elif t > 2:
            e = FR.add(e, d)
        E = torch.cat([e.reshape(NLIMBS, P, half), ones], 1)
        if T:
            prod = E[:, idx[:, 0]].reshape(NLIMBS, T * half)
            for f in range(1, width):
                prod = FR.mul(prod, E[:, idx[:, f]].reshape(NLIMBS, -1))
            prod = FR.mul(prod, cf).reshape(NLIMBS, T, half)
            inner = FR.sum(prod.transpose(1, 2).contiguous())
        else:
            inner = torch.zeros((NLIMBS, half), dtype=torch.int64,
                                device=device)
        yield E, inner


def points_plain(x, n: int, nevals: int, terms: Terms, w: tuple):
    """(nevals, 4): at t = 0, 2, ..., nevals, sum_j w(j) sum_k c_k prod_f
    (lo_f[j] + t (hi_f[j] - lo_f[j])) over the P rows of n in x, on every
    pair at once (``term_sums``)."""
    wt = _weight_planes(w, n // 2, x.device)
    out = []
    for _, inner in term_sums(x, n, nevals, terms):
        if wt is not None:
            inner = FR.mul(inner, wt)
        out.append(FR.sum(inner.reshape(NLIMBS, 1, -1)))
    return from_planes(torch.cat(out, 1))


def points(x, n: int, nevals: int, terms: Terms, w: tuple,
           tile: int | None = None, group: int | None = None
           ) -> torch.Tensor:
    """Kernel 7 on CUDA tensors, its plain version on CPU ones: the
    (nevals, 4) points of the P = len(x) / n rows in x under ``terms``
    and the weight ``w`` (``weights``). ``tile`` and ``group`` override
    the launch plan (``points_plan``)."""
    device = x.device
    _check("points x", x, device)
    _check("points coeffs", terms.coeffs, device, terms.T)
    _check("points tab", w[0], device)
    if n < 2 or n & (n - 1) or x.shape[0] % n:
        raise ValueError(f"points: rows of n = {n} (a power of two >= 2) "
                         f"expected in {tuple(x.shape)}")
    if not 1 <= nevals <= MAX_EVALS:
        raise ValueError(f"points: 1 <= nevals <= {MAX_EVALS}, got {nevals}")
    P = x.shape[0] // n
    if terms.fidx.device != device or any(i >= P for f in terms.factors
                                          for i in f):
        raise ValueError(f"points: terms on {terms.fidx.device} over rows "
                         f">= {P}")
    if device.type == "cpu":
        return points_plain(x, n, nevals, terms, w)
    if device.type != "cuda":
        raise ValueError(f"points: no kernel for device {device}")
    return _launch(x, n, nevals, terms, w, tile, group)


def _launch(x, n: int, nevals: int, terms: Terms, w: tuple,
            tile: int | None = None, group: int | None = None
            ) -> torch.Tensor:
    """One launch of kernel 7 on CUDA tensors that ``points`` checked
    (the kernel itself takes any even n >= 2)."""
    from . import build
    device = x.device
    P = x.shape[0] // n
    sms, counter = _card(device)
    plan = points_plan(P, n, nevals, terms.slices, sms, tile, group)
    out = torch.empty((nevals, 4), dtype=torch.int64, device=device)
    part = torch.empty((nevals * plan["tiles"], 4), dtype=torch.int64,
                       device=device)
    tab, whi_off, whi_n, whi_shift, wlo_off, log_wlo = w
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = build.cuda_library().jolt_rows_points(
            x.data_ptr(), n, P, nevals, terms.kcoeffs.data_ptr(),
            terms.parts.data_ptr(), terms.members.data_ptr(),
            terms.fidx.data_ptr(), terms.bounds.data_ptr(), terms.slices,
            tab.data_ptr(), whi_off,
            whi_n, whi_shift, wlo_off, log_wlo, plan["tile"], plan["group"],
            part.data_ptr(), counter.data_ptr(), out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"rows_points kernel launch failed: CUDA error "
                           f"{rc}")
    telemetry.launch("rows_points", points_case(P, nevals, terms.T, w, plan))
    return out


# ---------------------------------------------------------------------------
# kernel 8: small-integer rows into Montgomery form
# ---------------------------------------------------------------------------

_R2 = pow(2, 512, FR.P)  # R^2 mod r: mont(|v|, R^2) = |v| R


def from_i64_plain(src) -> torch.Tensor:
    """(n, 4) canonical Montgomery limbs of the int64 values src (n,):
    |v| times R^2 by a Montgomery product, negated where v < 0 (-2^63
    included: its two's complement bits are |v|)."""
    device = src.device
    neg = src < 0
    u = torch.where(neg, -src, src)
    planes = torch.zeros((NLIMBS, src.shape[0]), dtype=torch.int64,
                         device=device)
    for k in range(4):
        planes[k] = (u >> (16 * k)) & 0xFFFF
    r2 = torch.tensor([(_R2 >> (16 * k)) & 0xFFFF for k in range(NLIMBS)],
                      dtype=torch.int64, device=device)[:, None]
    m = FR.mul(planes, r2)
    return from_planes(torch.where(neg, FR.sub(torch.zeros_like(m), m), m))


def from_i64(src) -> torch.Tensor:
    """Kernel 8 on a CUDA tensor, its plain version on a CPU one: the (n,
    4) Montgomery form of the int64 values src (n,)."""
    device = src.device
    if src.dtype != torch.int64 or src.dim() != 1 or (
            device.type == "cuda" and not src.is_contiguous()):
        raise ValueError(f"from_i64: a contiguous int64 vector expected, got "
                         f"{src.dtype} {tuple(src.shape)}")
    if device.type == "cpu":
        return from_i64_plain(src)
    if device.type != "cuda":
        raise ValueError(f"from_i64: no kernel for device {device}")
    from . import build
    n = src.shape[0]
    out = torch.empty((n, 4), dtype=torch.int64, device=device)
    if n:
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = build.cuda_library().jolt_rows_from_i64(
                src.data_ptr(), n, out.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"rows_from_i64 kernel launch failed: CUDA "
                               f"error {rc}")
        telemetry.launch("rows_from_i64", 0)
    return out


def upload(rows, device) -> torch.Tensor:
    """The P rows (each an (n, 4) u64 FrArray or n small integers) as one
    (P n, 4) Montgomery buffer on ``device``, row p at p n: the field rows
    copied as they are, the integer rows staged on the host as int64, sent
    in one copy and converted there in one launch (``from_i64``)."""
    P, n = len(rows), len(rows[0])
    ints = [k for k, rw in enumerate(rows) if not isinstance(rw, FrArray)]
    if ints:  # one host buffer, one copy: a copy a row costs ~0.1 ms
        staged = np.empty(len(ints) * n, dtype=np.int64)
        for j, k in enumerate(ints):
            staged[j * n:(j + 1) * n] = rows[k]
        conv = from_i64(torch.from_numpy(staged).to(device))
        if len(ints) == P:
            return conv
    x = torch.empty((P * n, 4), dtype=torch.int64, device=device)
    for j, k in enumerate(ints):
        x[k * n:(k + 1) * n] = conv[j * n:(j + 1) * n]
    for k, rw in enumerate(rows):
        if isinstance(rw, FrArray):
            x[k * n:(k + 1) * n].copy_(torch.from_numpy(
                np.ascontiguousarray(rw.d).view(np.int64)))
    return x


def bind_rows(x, c, n: int, init_off=None) -> torch.Tensor:
    """The HighToLow bind lo + c (hi - lo) of the P = len(x) / n rows in x
    (n a power of two >= 2) at the challenge c ((1, 4) Montgomery): kernel
    4 with P lanes that all continue (its plain version on CPU tensors).
    init_off: P zeros (int64) on x's device, allocated if not given."""
    P = x.shape[0] // n
    if init_off is None:
        init_off = torch.zeros(P, dtype=torch.int64, device=x.device)
    return bind(x, x, c, init_off, P, P, (n // 2).bit_length() - 1)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

class DeviceGruen:
    """frvec.GruenInstance's interface with the rows on ``device`` for the
    first ``head_rounds`` rounds (``try_setup`` builds it). ``rows``: each
    an FrArray or a vector of small integers, as the host engine takes
    them. ``stats`` (the entered Scope) counts its device rounds. The
    steps are profiling spans (rows_upload, rows_points, rows_bind,
    rows_handoff); each bind counts the row elements it binds (P x n) in
    telemetry, as ``iop_rows_bound_card`` or, once handed to the host,
    ``iop_rows_bound_host``."""

    def __init__(self, rows, terms, degree: int, device, head_rounds: int,
                 stats=None):
        self.terms = [(c, list(f)) for c, f in terms]
        self.degree = degree
        self.P = len(rows)
        self.n = len(rows[0])
        self.device = device
        self._host = None
        self._stats = stats
        self._rounds_left = head_rounds
        with span("rows_upload"):
            self.x = upload(rows, device)
            self._terms = Terms(self.terms, device)
            self._init_off = torch.zeros(self.P, dtype=torch.int64,
                                         device=device)

    def _fetch_host(self) -> None:
        """Hand the rows to a host GruenInstance (one fetch)."""
        with span("rows_handoff"):
            flat = self.x.cpu().numpy().view(np.uint64).reshape(
                self.P, self.n, 4)
            self._host = GruenInstance(
                [FrArray(np.ascontiguousarray(flat[i]))
                 for i in range(self.P)], self.terms, self.degree)
            self.x = None

    def round_points(self, nevals: int, whi, whi_shift: int, wlo,
                     log_wlo: int):
        """[q(0), q(2), ..., q(nevals)] as an FrArray, as the host's."""
        if self._host is not None:
            return self._host.round_points(nevals, whi, whi_shift, wlo,
                                           log_wlo)
        with span("rows_points"):
            w = weights(whi, whi_shift, wlo, log_wlo, self.device)
            out = points(self.x, self.n, nevals, self._terms, w)
            telemetry.count("iop_rows")
            got = out.cpu().numpy()  # the round's one fetch
        if self._stats is not None:
            self._stats.rounds += 1
        return FrArray(got.view(np.uint64))

    def bind(self, r) -> None:
        if self._host is not None:
            telemetry.tally("iop_rows_bound_host", self.P * self._host.n)
            self._host.bind(r)
            return
        with span("rows_bind"):
            c = torch.from_numpy(mont_rows([r])).to(self.device)
            self.x = bind_rows(self.x, c, self.n, self._init_off)
            telemetry.count("iop_rows")
        telemetry.tally("iop_rows_bound_card", self.P * self.n)
        self.n //= 2
        self._rounds_left -= 1
        if self.n <= 1 or self._rounds_left <= 0:
            self._fetch_host()

    def row_value(self, i: int):
        if self._host is None:
            self._fetch_host()
        return self._host.row_value(i)


class Scope(telemetry.EngineScope):
    """While entered, RowsInstance.setup_rows offers its eq-weighted
    instances to ``try_setup`` (telemetry.EngineScope: decisions["iop"]
    and ["iop:declined"], the row elements the card bound the
    ``iop_rows_bound_card`` counter, kernel 7's and kernel 4's dispatches
    ``iop_rows``) under ``gate``, and counts the engine's rounds."""

    ENGINE, COUNTER, DISPATCHES = "iop", "iop_rows_bound_card", "iop_rows"
    ITEMS, ELEMENTS, WHERE = "instances", "row elements bound", "device"

    def __init__(self, device, gate: RowsGate):
        super().__init__(device)
        self.gate = gate
        self.rounds = 0

    def summary(self) -> str:
        s = super().summary()
        return (f"{s[:-1]}, {self.rounds} {self.WHERE} rounds)"
                if self.engaged else s)


def offer(sc: Scope, rows, terms, degree: int,
          why: str | None = None) -> bool:
    """Offer an instance to the scope's engine: True if it takes it
    (counted as engaged), False if ``why`` (the engine's own reason), the
    gate, unequal rows or rows that are not field vectors decline it (the
    reason counted in the scope)."""
    sc.offered += 1
    P, n = len(rows), len(rows[0])
    if why is None:
        why = sc.gate.decline(P, n, degree, sum(len(f) for _, f in terms))
    if why is None and any(len(rw) != n for rw in rows):
        why = "rows of unequal length"
    if why is None and not all(isinstance(rw, (FrArray, np.ndarray))
                               for rw in rows):
        why = "rows not field vectors"
    if why is not None:
        sc.decline(why)
        return False
    sc.engaged += 1
    return True


def try_setup(rows, terms, degree: int) -> DeviceGruen | None:
    """A DeviceGruen for this instance under the entered scope, or None (no
    scope, or the gate declined: the caller uses the host engine; the
    reason is counted in the scope). ``rows``: as the host GruenInstance
    takes them, each an FrArray or a vector of small integers."""
    sc = Scope.entered
    if sc is None or not rows or not offer(sc, rows, terms, degree):
        return None
    return DeviceGruen(rows, terms, degree, sc.device, sc.gate.head_rounds, sc)


# ---------------------------------------------------------------------------
# inputs for holding kernel 7 against its plain version
# ---------------------------------------------------------------------------

def random_terms(P: int, T: int, max_factors: int,
                 gen: np.random.Generator) -> list:
    """T terms over P rows: random coefficients (term 0 coefficient one),
    1 to max_factors factors with repeats, and a constant term last when T
    > 1."""
    from ..field.constants import FR_MODULUS
    from ..field.scalar import Fr
    out = []
    for k in range(T):
        c = Fr.one() if k == 0 else Fr(int.from_bytes(gen.bytes(32),
                                                      "little") % FR_MODULUS)
        nf = 0 if (k == T - 1 and T > 1) else int(gen.integers(
            1, max_factors + 1))
        out.append((c, [int(i) for i in gen.integers(0, P, size=nf)]))
    return out


def random_weights(n: int, kind: str, gen: np.random.Generator) -> tuple:
    """(whi, whi_shift, wlo, log_wlo) of one weight layout over n / 2
    pairs, as SplitEq.tables gives them: "split" (whi rows of 2^s pairs,
    wlo of 2^s), "prefix" (whi only, j >> post: post_vars layouts),
    "suffix" (whi masked to fewer rows than j >> s spans: plain rounds of
    eq_pre layouts), "lo" (wlo only), "none", "folded" (a one-row whi,
    skipped), "wide" (whi_shift >= log2(n / 2))."""
    from .reduction import random_rows
    half = n // 2
    lg = half.bit_length() - 1
    tab = lambda k: random_rows(k, gen, "cpu").numpy().view(np.uint64)
    s = lg // 2
    if kind == "split":
        return tab(max(half >> s, 1)), s, tab(1 << s), s
    if kind == "prefix":
        return tab(max(half >> s, 1)), s, None, -1
    if kind == "suffix":
        return tab(max(half >> (s + 1), 1)), s, tab(1 << s), s
    if kind == "lo":
        return None, 0, tab(1 << lg), lg
    if kind == "folded":
        return tab(1), 0, tab(1 << s), s
    if kind == "wide":
        return tab(2), lg + 3, tab(1 << s), s
    return None, 0, None, -1


WEIGHT_KINDS = ("split", "prefix", "suffix", "lo", "none", "folded", "wide")


def random_rows_for(P: int, n: int, gen: np.random.Generator, device,
                    zero_row: bool = True) -> torch.Tensor:
    """(P n, 4) random Montgomery rows (the field's edge values first), row
    P - 1 all zero when ``zero_row`` and P > 1."""
    from .reduction import random_rows
    x = random_rows(P * n, gen, device)
    if zero_row and P > 1:
        x[(P - 1) * n:] = 0
    return x
