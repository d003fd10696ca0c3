"""ONNX model loading: parse, quantize, build the computation graph.

The tract-onnx replacement (reference atlas-onnx-tracer/src/model/load.rs +
node/handlers/): each ONNX node is mapped through a handler registry onto
the quantized operator set, float initializers are quantized to i32 at the
model scale, symbolic dims are concretized from RunArgs-style variables, and
every dimension is padded to a power of two (weights zero-padded; exact for
contractions/elementwise ops, approximate for softmax axes — the same
padding contract as the reference's load.rs:504 `pad`).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..config import DEFAULT_SCALE
from .builder import ModelBuilder
from .graph import Model
from .onnx_proto import parse_onnx
from .quantize import quantize_tensor


@dataclass
class RunArgs:
    variables: dict = field(default_factory=dict)  # dim_param -> value
    scale: int = DEFAULT_SCALE
    pad_to_power_of_two: bool = True


def _pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def _pad_dims(dims, pad: bool):
    return [(_pow2(d) if pad else d) for d in dims]


def _pad_array(arr: np.ndarray, pad: bool) -> np.ndarray:
    if not pad:
        return arr
    target = [_pow2(d) for d in arr.shape]
    widths = [(0, t - s) for s, t in zip(arr.shape, target)]
    return np.pad(arr, widths, mode="constant")


class OnnxLoader:
    def __init__(self, run_args: RunArgs | None = None):
        self.ra = run_args or RunArgs()

    def load_bytes(self, data: bytes, base_dir: str = "") -> Model:
        g = parse_onnx(data, base_dir=base_dir)
        b = ModelBuilder(scale=self.ra.scale)
        wires: dict[str, int] = {}
        raw_consts: dict[str, np.ndarray] = {}  # unquantized (shape/idx data)

        # graph inputs (minus initializers)
        for vi in g.inputs:
            if vi.name in g.initializers:
                continue
            dims = []
            for d in vi.shape:
                if isinstance(d, str):
                    if d not in self.ra.variables:
                        raise ValueError(f"unbound symbolic dim {d!r}")
                    dims.append(self.ra.variables[d])
                else:
                    dims.append(int(d) if d else 1)
            dims = _pad_dims(dims, self.ra.pad_to_power_of_two)
            wires[vi.name] = b.input(dims)

        def materialize_const(name: str):
            if name in wires:
                return
            t = g.initializers[name]
            arr = t.to_array()
            raw_consts[name] = arr
            arr = np.atleast_1d(arr)
            if arr.dtype in (np.float32, np.float64):
                q = quantize_tensor(arr, self.ra.scale)
            else:
                q = arr.astype(np.int32)
            q = _pad_array(q, self.ra.pad_to_power_of_two)
            wires[name] = b.constant(q)

        def materialize_folded(name: str):
            """Fold-pass result consumed by a live op -> builder constant."""
            arr = raw_consts[name]
            if arr.dtype in (np.float32, np.float64, np.float16):
                q = quantize_tensor(np.asarray(arr, np.float64), self.ra.scale)
            elif arr.dtype == np.bool_:
                q = arr.astype(np.int32)
            else:
                a = arr.astype(np.int64)
                if a.size and (a.max() > 2**31 - 1 or a.min() < -(2**31)):
                    raise ValueError(
                        f"folded constant {name!r} exceeds i32 range")
                q = a.astype(np.int32)
            q = _pad_array(np.atleast_1d(q), self.ra.pad_to_power_of_two)
            wires[name] = b.constant(q)

        def w(name: str) -> int:
            if name not in wires:
                if name in g.initializers:
                    materialize_const(name)
                elif name in raw_consts:
                    materialize_folded(name)
                else:
                    raise ValueError(f"unknown tensor {name!r}")
            return wires[name]

        def known(name: str):
            """Static value of a tensor if it is known at load time."""
            if name == "":
                return None
            if name in raw_consts:
                return raw_consts[name]
            if name in wires:
                return None
            t = g.initializers.get(name)
            if t is not None:
                arr = t.to_array()
                raw_consts[name] = arr
                return arr
            return None

        for node in g.nodes:
            if node.op_type == "Shape":
                # static graph: a tensor's shape is a load-time constant.
                # Wires report their padded dims (the only shape that exists
                # downstream); known consts report the padded shape they
                # would materialize at.
                src = node.input[0]
                if src in wires:
                    dims = list(b.dims(wires[src]))
                else:
                    arr = known(src)
                    if arr is None:
                        raise ValueError(f"Shape of unknown tensor {src!r}")
                    dims = _pad_dims(np.atleast_1d(arr).shape,
                                     self.ra.pad_to_power_of_two)
                a_start = node.attributes.get("start")
                a_end = node.attributes.get("end")
                lo = a_start.i if a_start is not None else 0
                hi = a_end.i if a_end is not None else len(dims)
                raw_consts[node.output[0]] = np.array(
                    dims[lo if lo >= 0 else lo + len(dims):
                         hi if hi >= 0 else hi + len(dims)], dtype=np.int64)
                continue
            folder = _FOLDERS.get(node.op_type)
            if folder is not None:
                vals = [known(i) for i in node.input]
                if all(v is not None or i == ""
                       for v, i in zip(vals, node.input)):
                    outs = folder(node, vals)
                    for name, arr in zip(node.output, outs):
                        raw_consts[name] = np.asarray(arr)
                    continue
            handler = _HANDLERS.get(node.op_type)
            if handler is None:
                raise NotImplementedError(f"ONNX op {node.op_type}")
            ctx = _Ctx(self, b, g, node, wires, raw_consts, w)
            outs = handler(ctx)
            for name, wire in zip(node.output, outs):
                wires[name] = wire

        for vo in g.outputs:
            b.output(w(vo.name))
        return b.build()

    def load_file(self, path: str) -> Model:
        import os
        with open(path, "rb") as f:
            return self.load_bytes(f.read(),
                                   base_dir=os.path.dirname(
                                       os.path.abspath(path)))


@dataclass
class _Ctx:
    loader: OnnxLoader
    b: ModelBuilder
    g: object
    node: object
    wires: dict
    raw_consts: dict
    w: object  # name -> wire resolver

    def attr(self, name, default=None):
        a = self.node.attributes.get(name)
        return a if a is not None else default

    def const_array(self, name: str) -> np.ndarray:
        """Raw (unquantized) constant value, e.g. shapes and axes."""
        if name in self.raw_consts:
            return self.raw_consts[name]
        t = self.g.initializers.get(name)
        if t is None:
            raise ValueError(f"expected constant input {name}")
        arr = t.to_array()
        self.raw_consts[name] = arr
        return arr


# ---------------------------------------------------------------------------
# handlers (reference node/handlers/: arith, activation, shape, reduce, ...)
# ---------------------------------------------------------------------------

def _h_gemm(c: _Ctx):
    n = c.node
    a = c.w(n.input[0])
    w2 = c.w(n.input[1])
    trans_b = c.attr("transB")
    bdims = c.b.dims(w2)
    if trans_b is not None and trans_b.i:
        assert len(bdims) == 2
        w2 = c.b.move_axis(w2, 0, 1)
    out = c.b.matmul(a, w2)
    if len(n.input) > 2:
        bias = c.w(n.input[2])
        bdims = c.b.dims(bias)
        out_dims = c.b.dims(out)
        if tuple(bdims) != tuple(out_dims):
            bias = c.b.broadcast(bias, out_dims)
        out = c.b.add(out, bias)
    return [out]


def _h_matmul(c: _Ctx):
    a, bb = c.w(c.node.input[0]), c.w(c.node.input[1])
    da, db = c.b.dims(a), c.b.dims(bb)
    if len(da) == 2 and len(db) == 2:
        return [c.b.matmul(a, bb)]
    if len(da) == 3 and len(db) == 3:
        return [c.b.einsum("bmk,bkn->bmn", [a, bb])]
    if len(da) == 3 and len(db) == 2:
        return [c.b.einsum("bmk,kn->bmn", [a, bb])]
    if len(da) == 4 and len(db) == 4:
        return [c.b.einsum("abmk,abkn->abmn", [a, bb])]
    if len(da) == 4 and len(db) == 2:
        return [c.b.einsum("abmk,kn->abmn", [a, bb])]
    raise NotImplementedError(f"MatMul ranks {len(da)}x{len(db)}")


def _h_relu(c: _Ctx):
    return [c.b.relu(c.w(c.node.input[0]))]


def _binary(fn):
    def h(c: _Ctx):
        a, bb = c.w(c.node.input[0]), c.w(c.node.input[1])
        da, db = tuple(c.b.dims(a)), tuple(c.b.dims(bb))
        if da != db:
            target = list(int(d) for d in np.broadcast_shapes(da, db))
            if da != tuple(target):
                a = c.b.broadcast(a, target)
            if db != tuple(target):
                bb = c.b.broadcast(bb, target)
        return [fn(c.b, a, bb)]
    return h


def _h_div(c: _Ctx):
    n = c.node
    if n.input[1] in c.g.initializers:
        d = c.const_array(n.input[1])
        if d.size == 1 and d.dtype in (np.float32, np.float64):
            # divide by float constant -> multiply by quantized reciprocal
            recip = quantize_tensor(np.array(1.0 / float(d.reshape(-1)[0])),
                                    c.loader.ra.scale)
            rw = c.b.constant(np.full(c.b.dims(c.w(n.input[0])),
                                      int(recip), dtype=np.int32))
            return [c.b.mul(c.w(n.input[0]), rw)]
    # builder.div defaults to the model-scale requantizing semantics
    # (out_hat = a_hat * 2^s / b_hat), matching float ONNX Div
    return [_binary(lambda b, a, d: b.div(a, d))(c)[0]]


def _h_layernorm(c: _Ctx):
    """LayerNormalization -> mean/var/rsqrt decomposition (the same ops the
    torch exporter emits when it decomposes LN itself)."""
    n = c.node
    x = c.w(n.input[0])
    dims = list(c.b.dims(x))
    a = c.attr("axis")
    ax = (a.i if a is not None else -1) % len(dims)
    axes = list(range(ax, len(dims)))
    count = int(np.prod([dims[i] for i in axes]))
    mean = c.b.scalar_const_div(c.b.sum(x, axes), count)
    mean = c.b.broadcast(mean, dims)
    d = c.b.sub(x, mean)
    var = c.b.scalar_const_div(c.b.sum(c.b.square(d), axes), count)
    eps = c.attr("epsilon")
    eps_q = int(round((eps.f if eps is not None else 1e-5) *
                      (1 << c.loader.ra.scale)))
    if eps_q:
        var = c.b.add(var, c.b.constant(
            np.full(c.b.dims(var), eps_q, dtype=np.int32)))
    r = c.b.broadcast(c.b.rsqrt(var), dims)
    y = c.b.mul(d, r)
    if len(n.input) > 1 and n.input[1]:
        scale_w = c.w(n.input[1])
        if tuple(c.b.dims(scale_w)) != tuple(dims):
            scale_w = c.b.broadcast(scale_w, dims)
        y = c.b.mul(y, scale_w)
    if len(n.input) > 2 and n.input[2]:
        bias = c.w(n.input[2])
        if tuple(c.b.dims(bias)) != tuple(dims):
            bias = c.b.broadcast(bias, dims)
        y = c.b.add(y, bias)
    return [y]


def _h_tile(c: _Ctx):
    x = c.w(c.node.input[0])
    reps = [int(v) for v in c.const_array(c.node.input[1]).reshape(-1)]
    for ax, r in enumerate(reps):
        if r > 1:
            x = c.b.concat([x] * r, ax)
            if c.loader.ra.pad_to_power_of_two:
                x = _pad_axis_pow2(c, x, ax)
    return [x]


def _h_reciprocal(c: _Ctx):
    # 1/x via the proven requantizing division op (ones / x)
    x = c.w(c.node.input[0])
    ones = c.b.constant(np.full(c.b.dims(x), 1 << c.loader.ra.scale,
                                dtype=np.int32))
    return [c.b.div(ones, x)]


def _h_sqrt(c: _Ctx):
    # sqrt(x) = x * rsqrt(x): reuses the proven rsqrt advice op (the
    # reference reaches the same decomposition via tract declutter)
    x = c.w(c.node.input[0])
    r = c.b.rsqrt(x)
    if tuple(c.b.dims(r)) != tuple(c.b.dims(x)):
        r = c.b.broadcast(r, c.b.dims(x))
    return [c.b.mul(x, r)]


def _h_pow(c: _Ctx):
    e = c.const_array(c.node.input[1]).reshape(-1)
    assert e.size == 1, "Pow needs a scalar exponent"
    exp = float(e[0])
    x = c.w(c.node.input[0])
    if exp == 2.0:
        return [c.b.square(x)]
    if exp == 3.0:
        return [c.b.cube(x)]
    raise NotImplementedError(f"Pow exponent {exp} (only 2 and 3)")


def _h_where(c: _Ctx):
    n = c.node
    ops = [c.w(i) for i in n.input]
    dims = [tuple(c.b.dims(o)) for o in ops]
    target = tuple(int(d) for d in
                   np.broadcast_shapes(*[tuple(d) for d in dims]))
    ops = [c.b.broadcast(o, list(target)) if d != target else o
           for o, d in zip(ops, dims)]
    return [c.b.iff(*ops)]


def _h_einsum(c: _Ctx):
    eq = c.attr("equation")
    assert eq is not None, "Einsum needs an equation attribute"
    equation = eq.s.decode() if isinstance(eq.s, bytes) else str(eq.s)
    ops = [c.w(i) for i in c.node.input]
    return [c.b.einsum(equation.replace(" ", ""), ops)]


def _h_softmax(c: _Ctx):
    axis = c.attr("axis")
    x = c.w(c.node.input[0])
    rank = len(c.b.dims(x))
    ax = axis.i if axis is not None else -1
    if ax < 0:
        ax += rank
    assert ax == rank - 1, "softmax only on the last axis"
    return [c.b.softmax_last_axis(x)]


def _h_transpose(c: _Ctx):
    perm_attr = c.attr("perm")
    x = c.w(c.node.input[0])
    rank = len(c.b.dims(x))
    perm = list(perm_attr.ints) if perm_attr else list(reversed(range(rank)))
    # decompose permutation into a sequence of single-axis moves
    cur = list(range(rank))
    for dst in range(rank):
        src = cur.index(perm[dst])
        if src != dst:
            x = c.b.move_axis(x, src, dst)
            ax = cur.pop(src)
            cur.insert(dst, ax)
    return [x]


def _h_reshape(c: _Ctx):
    x = c.w(c.node.input[0])
    shape = [int(v) for v in c.const_array(c.node.input[1]).reshape(-1)]
    in_dims = c.b.dims(x)
    total = int(np.prod(in_dims))
    out = []
    for i, d in enumerate(shape):
        if d == 0:
            out.append(in_dims[i])
        else:
            out.append(d)
    if -1 in out:
        known = int(np.prod([d for d in out if d != -1]))
        out[out.index(-1)] = total // known
    out = _pad_dims(out, c.loader.ra.pad_to_power_of_two)
    assert int(np.prod(out)) == total, \
        f"reshape {in_dims} -> {out} changes padded element count"
    return [c.b.reshape(x, out)]


def _h_flatten(c: _Ctx):
    x = c.w(c.node.input[0])
    dims = c.b.dims(x)
    ax_attr = c.attr("axis")
    ax = ax_attr.i if ax_attr is not None else 1
    lead = int(np.prod(dims[:ax])) if ax else 1
    rest = int(np.prod(dims[ax:]))
    return [c.b.reshape(x, [lead, rest])]


def _h_squeeze(c: _Ctx):
    x = c.w(c.node.input[0])
    dims = list(c.b.dims(x))
    if len(c.node.input) > 1:
        axes = [int(v) for v in c.const_array(c.node.input[1]).reshape(-1)]
    else:
        a = c.attr("axes")
        axes = list(a.ints) if a else [i for i, d in enumerate(dims) if d == 1]
    axes = [ax % len(dims) for ax in axes]
    new = [d for i, d in enumerate(dims) if i not in axes]
    return [c.b.reshape(x, new or [1])]


def _h_unsqueeze(c: _Ctx):
    x = c.w(c.node.input[0])
    dims = list(c.b.dims(x))
    if len(c.node.input) > 1:
        axes = [int(v) for v in c.const_array(c.node.input[1]).reshape(-1)]
    else:
        axes = list(c.attr("axes").ints)
    for ax in sorted(axes):
        dims.insert(ax if ax >= 0 else ax + len(dims) + 1, 1)
    return [c.b.reshape(x, dims)]


def _h_gather(c: _Ctx):
    data = c.w(c.node.input[0])
    idx = c.w(c.node.input[1])
    ax = c.attr("axis")
    assert ax is None or ax.i == 0, "gather axis 0 only"
    return [c.b.gather(data, idx)]


def _h_reduce(sum_only: bool):
    def h(c: _Ctx):
        x = c.w(c.node.input[0])
        dims = c.b.dims(x)
        if len(c.node.input) > 1:
            axes = [int(v) for v in c.const_array(c.node.input[1]).reshape(-1)]
        else:
            a = c.attr("axes")
            axes = list(a.ints) if a else list(range(len(dims)))
        axes = [ax % len(dims) for ax in axes]
        out = c.b.sum(x, axes)
        if not sum_only:  # ReduceMean: divide by the true element count
            count = int(np.prod([dims[ax] for ax in axes]))
            out = c.b.scalar_const_div(out, count)
        keep = c.attr("keepdims")
        if keep is not None and keep.i == 0:
            newd = [d for i, d in enumerate(c.b.dims(out)) if i not in axes]
            out = c.b.reshape(out, newd or [1])
        return [out]
    return h


def _h_constant(c: _Ctx):
    a = c.attr("value")
    arr = a.t.to_array()
    if arr.dtype in (np.float32, np.float64):
        q = quantize_tensor(arr, c.loader.ra.scale)
    else:
        q = arr.astype(np.int32)
    c.raw_consts[c.node.output[0]] = arr
    q = _pad_array(q, c.loader.ra.pad_to_power_of_two)
    return [c.b.constant(q)]


def _h_concat(c: _Ctx):
    ax = c.attr("axis").i
    return [c.b.concat([c.w(i) for i in c.node.input], ax)]


def _pad_axis_pow2(c: _Ctx, x: int, ax: int) -> int:
    """Zero-pad axis ax of wire x up to a power of two (keeps the
    all-dims-pow2 invariant after slicing to an odd length)."""
    dims = list(c.b.dims(x))
    tgt = _pow2(dims[ax])
    if tgt == dims[ax]:
        return x
    zdims = dims.copy()
    zdims[ax] = tgt - dims[ax]
    return c.b.concat([x, c.b.constant(np.zeros(zdims, dtype=np.int32))], ax)


def _h_slice(c: _Ctx):
    n = c.node
    x = c.w(n.input[0])
    if len(n.input) > 1:
        starts = [int(v) for v in c.const_array(n.input[1]).reshape(-1)]
        ends = [int(v) for v in c.const_array(n.input[2]).reshape(-1)]
        axes = ([int(v) for v in c.const_array(n.input[3]).reshape(-1)]
                if len(n.input) > 3 else list(range(len(starts))))
    else:
        starts = list(c.attr("starts").ints)
        ends = list(c.attr("ends").ints)
        a = c.attr("axes")
        axes = list(a.ints) if a else list(range(len(starts)))
    for st, en, ax in zip(starts, ends, axes):
        dims = c.b.dims(x)
        ax %= len(dims)
        en = min(en, dims[ax])
        if st == 0 and en == dims[ax]:
            continue
        x = c.b.slice(x, ax, st, en)
        if c.loader.ra.pad_to_power_of_two:
            x = _pad_axis_pow2(c, x, ax)
    return [x]


# ---------------------------------------------------------------------------
# load-time constant folding (shape arithmetic + mask construction)
#
# torch.export emits Shape->Gather->Unsqueeze->Concat->Reshape chains and
# ConstantOfShape/NonZero/Equal causal-mask subgraphs whose values are fully
# determined by the static input shapes. The reference resolves these inside
# tract's declutter passes (atlas-onnx-tracer/src/model/load.rs); here they
# are evaluated with numpy at load time and only materialize as quantized
# builder constants if a live operator consumes them.
# ---------------------------------------------------------------------------

_CAST_DTYPES = {1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16,
                5: np.int16, 6: np.int32, 7: np.int64, 9: np.bool_,
                10: np.float16, 11: np.float64, 12: np.uint32, 13: np.uint64}


def _attr(node, name, default=None):
    a = node.attributes.get(name)
    return a if a is not None else default


def _axes_of(node, vals, idx, default):
    if len(vals) > idx and vals[idx] is not None:
        return [int(v) for v in np.atleast_1d(vals[idx])]
    a = _attr(node, "axes")
    return list(a.ints) if a is not None else default


def _f_elementwise(fn):
    def f(node, vals):
        return [fn(*vals)]
    return f


def _f_div(node, vals):
    a, d = vals
    if np.issubdtype(np.asarray(a).dtype, np.integer) and \
            np.issubdtype(np.asarray(d).dtype, np.integer):
        q = np.trunc(np.asarray(a, np.float64) / np.asarray(d, np.float64))
        return [q.astype(np.asarray(a).dtype)]
    return [a / d]


def _f_gather(node, vals):
    ax = _attr(node, "axis")
    return [np.take(vals[0], np.asarray(vals[1], np.int64),
                    axis=ax.i if ax is not None else 0)]


def _f_cast(node, vals):
    to = _attr(node, "to")
    return [np.asarray(vals[0]).astype(_CAST_DTYPES[to.i])]


def _f_unsqueeze(node, vals):
    x = np.asarray(vals[0])
    for ax in sorted(_axes_of(node, vals, 1, [0])):
        x = np.expand_dims(x, ax if ax >= 0 else ax + x.ndim + 1)
    return [x]


def _f_squeeze(node, vals):
    x = np.asarray(vals[0])
    axes = _axes_of(node, vals, 1,
                    [i for i, d in enumerate(x.shape) if d == 1])
    return [np.squeeze(x, axis=tuple(ax % x.ndim for ax in axes))]


def _f_concat(node, vals):
    return [np.concatenate([np.atleast_1d(v) for v in vals],
                           axis=_attr(node, "axis").i)]


def _f_slice(node, vals):
    x = np.asarray(vals[0])
    if len(vals) > 1:
        starts = [int(v) for v in np.atleast_1d(vals[1])]
        ends = [int(v) for v in np.atleast_1d(vals[2])]
        axes = ([int(v) for v in np.atleast_1d(vals[3])]
                if len(vals) > 3 and vals[3] is not None
                else list(range(len(starts))))
        steps = ([int(v) for v in np.atleast_1d(vals[4])]
                 if len(vals) > 4 and vals[4] is not None
                 else [1] * len(starts))
    else:
        starts = list(_attr(node, "starts").ints)
        ends = list(_attr(node, "ends").ints)
        a = _attr(node, "axes")
        axes = list(a.ints) if a else list(range(len(starts)))
        steps = [1] * len(starts)
    sl = [slice(None)] * x.ndim
    for st, en, ax, sp in zip(starts, ends, axes, steps):
        sl[ax % x.ndim] = slice(st, en, sp)
    return [x[tuple(sl)]]


def _f_tile(node, vals):
    return [np.tile(vals[0], [int(v) for v in np.atleast_1d(vals[1])])]


def _f_constantofshape(node, vals):
    shape = tuple(int(v) for v in np.atleast_1d(vals[0]))
    a = _attr(node, "value")
    if a is not None and a.t is not None:
        fill = a.t.to_array().reshape(-1)[0]
        return [np.full(shape, fill, dtype=fill.dtype)]
    return [np.zeros(shape, dtype=np.float32)]


def _f_constant(node, vals):
    a = _attr(node, "value")
    if a is not None and a.t is not None:
        return [a.t.to_array()]
    for name, conv in (("value_int", lambda a: np.int64(a.i)),
                       ("value_float", lambda a: np.float32(a.f)),
                       ("value_ints", lambda a: np.array(a.ints, np.int64)),
                       ("value_floats",
                        lambda a: np.array(a.floats, np.float32))):
        a = _attr(node, name)
        if a is not None:
            return [np.asarray(conv(a))]
    raise ValueError("Constant node without a recognized value attribute")


def _f_reshape(node, vals):
    x = np.asarray(vals[0])
    shape = [int(v) for v in np.atleast_1d(vals[1])]
    shape = [x.shape[i] if d == 0 else d for i, d in enumerate(shape)]
    return [x.reshape(shape)]


def _f_transpose(node, vals):
    a = _attr(node, "perm")
    return [np.transpose(vals[0], list(a.ints) if a else None)]


def _f_expand(node, vals):
    x = np.asarray(vals[0])
    shape = tuple(int(v) for v in np.atleast_1d(vals[1]))
    return [np.broadcast_to(x, np.broadcast_shapes(x.shape, shape)).copy()]


def _f_trilu(node, vals):
    k = int(np.atleast_1d(vals[1])[0]) if len(vals) > 1 and \
        vals[1] is not None else 0
    a = _attr(node, "upper")
    upper = a.i if a is not None else 1
    return [np.triu(vals[0], k) if upper else np.tril(vals[0], k)]


def _f_range(node, vals):
    s, e, d = (np.atleast_1d(v)[0] for v in vals)
    return [np.arange(s, e, d)]


_FOLDERS = {
    "Identity": _f_elementwise(lambda a: a),
    "Add": _f_elementwise(lambda a, b: a + b),
    "Sub": _f_elementwise(lambda a, b: a - b),
    "Mul": _f_elementwise(lambda a, b: a * b),
    "Div": _f_div,
    "Neg": _f_elementwise(lambda a: -a),
    "Equal": _f_elementwise(lambda a, b: a == b),
    "Less": _f_elementwise(lambda a, b: a < b),
    "Greater": _f_elementwise(lambda a, b: a > b),
    "Not": _f_elementwise(lambda a: ~np.asarray(a, np.bool_)),
    "And": _f_elementwise(lambda a, b: np.logical_and(a, b)),
    "Or": _f_elementwise(lambda a, b: np.logical_or(a, b)),
    "Where": _f_elementwise(lambda c, a, b: np.where(c, a, b)),
    "Sqrt": _f_elementwise(np.sqrt),
    "Pow": _f_elementwise(lambda a, b: np.power(a, b)),
    "NonZero": _f_elementwise(
        lambda a: np.array(np.nonzero(a), dtype=np.int64)),
    "Gather": _f_gather,
    "Cast": _f_cast,
    "Unsqueeze": _f_unsqueeze,
    "Squeeze": _f_squeeze,
    "Concat": _f_concat,
    "Slice": _f_slice,
    "ConstantOfShape": _f_constantofshape,
    "Constant": _f_constant,
    "Reshape": _f_reshape,
    "Transpose": _f_transpose,
    "Expand": _f_expand,
    "Trilu": _f_trilu,
    "Range": _f_range,
    "Tile": _f_tile,
    "ReduceSum": lambda node, vals: [np.sum(
        vals[0], axis=tuple(_axes_of(node, vals, 1,
                                     list(range(np.asarray(vals[0]).ndim)))),
        keepdims=bool(getattr(_attr(node, "keepdims"), "i", 1)))],
}


def _h_split(c: _Ctx):
    n = c.node
    x = c.w(n.input[0])
    dims = c.b.dims(x)
    a = c.attr("axis")
    ax = (a.i if a is not None else 0) % len(dims)
    if len(n.input) > 1:
        sizes = [int(v) for v in c.const_array(n.input[1]).reshape(-1)]
    else:
        a = c.attr("split")
        if a is not None and a.ints:
            sizes = list(a.ints)
        else:
            # equal split divides the NOMINAL dim, not the padded one
            k = len(n.output)
            vi = c.g.value_info.get(n.input[0])
            nominal = dims[ax]
            if vi is not None and len(vi.shape) == len(dims) and \
                    isinstance(vi.shape[ax], int):
                nominal = vi.shape[ax]
            sizes = [nominal // k] * k
    outs, off = [], 0
    for s in sizes:
        part = c.b.slice(x, ax, off, off + s)
        if c.loader.ra.pad_to_power_of_two:
            part = _pad_axis_pow2(c, part, ax)
        outs.append(part)
        off += s
    return outs


_HANDLERS = {
    "Split": _h_split,
    "Gemm": _h_gemm,
    "MatMul": _h_matmul,
    "Relu": _h_relu,
    "Add": _binary(lambda b, a, d: b.add(a, d)),
    "Sub": _binary(lambda b, a, d: b.sub(a, d)),
    "Mul": _binary(lambda b, a, d: b.mul(a, d)),
    "Div": _h_div,
    "Softmax": _h_softmax,
    "Tanh": lambda c: [c.b.tanh(c.w(c.node.input[0]))],
    "Erf": lambda c: [c.b.erf(c.w(c.node.input[0]))],
    "Sigmoid": lambda c: [c.b.sigmoid(c.w(c.node.input[0]))],
    "Sin": lambda c: [c.b.sin(c.w(c.node.input[0]))],
    "Cos": lambda c: [c.b.cos(c.w(c.node.input[0]))],
    "Neg": lambda c: [c.b.neg(c.w(c.node.input[0]))],
    "Identity": lambda c: [c.b.identity(c.w(c.node.input[0]))],
    "Transpose": _h_transpose,
    "Reshape": _h_reshape,
    "Flatten": _h_flatten,
    "Squeeze": _h_squeeze,
    "Unsqueeze": _h_unsqueeze,
    "Gather": _h_gather,
    "ReduceSum": _h_reduce(True),
    "ReduceMean": _h_reduce(False),
    "Constant": _h_constant,
    "Concat": _h_concat,
    "Slice": _h_slice,
    "Sqrt": _h_sqrt,
    "Pow": _h_pow,
    "Where": _h_where,
    "Einsum": _h_einsum,
    "Cast": lambda c: [c.b.identity(c.w(c.node.input[0]))],
    "Reciprocal": _h_reciprocal,
    "LayerNormalization": _h_layernorm,
    "Tile": _h_tile,
}


def load_onnx(path: str, run_args: RunArgs | None = None) -> Model:
    return OnnxLoader(run_args).load_file(path)
