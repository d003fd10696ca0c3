"""Minimal pure-Python ONNX protobuf parser.

The environment ships no `onnx` package, so ONNX files are decoded directly
from the protobuf wire format (varint / 64-bit / length-delimited / 32-bit
records). Only the message fields the loader needs are modeled — the same
role tract-onnx's parser plays for the reference
(atlas-onnx-tracer/src/model/load.rs).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np


def _read_varint(buf: bytes, pos: int):
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf: bytes):
    """Yields (field_number, wire_type, value) over a message buffer."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        fno, wt = tag >> 3, tag & 7
        if wt == 0:
            v, pos = _read_varint(buf, pos)
        elif wt == 1:
            v = buf[pos:pos + 8]
            pos += 8
        elif wt == 2:
            ln, pos = _read_varint(buf, pos)
            v = buf[pos:pos + ln]
            pos += ln
        elif wt == 5:
            v = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield fno, wt, v


def _zigzag64(v: int) -> int:
    # ONNX int64 fields use plain (non-zigzag) varints; negative values come
    # through as 2^64 complements
    return v - (1 << 64) if v >= (1 << 63) else v


@dataclass
class TensorProto:
    dims: list = field(default_factory=list)
    data_type: int = 0
    name: str = ""
    raw_data: bytes = b""
    float_data: list = field(default_factory=list)
    int32_data: list = field(default_factory=list)
    int64_data: list = field(default_factory=list)
    external_data: dict = field(default_factory=dict)  # location/offset/length
    data_location: int = 0  # 1 = EXTERNAL (data lives in a sibling file)
    base_dir: str = ""

    def _load_external(self) -> bytes:
        """Read the raw bytes of an externally-stored tensor (ONNX
        data_location=EXTERNAL; reference models ship network.onnx.data
        alongside network.onnx)."""
        import os
        loc = self.external_data.get("location")
        if loc is None:
            raise ValueError(f"tensor {self.name!r} is external but has "
                             "no location entry")
        if not self.base_dir:
            raise ValueError(
                f"tensor {self.name!r} has external data {loc!r}; parse the "
                "model with parse_onnx(data, base_dir=...) to resolve it")
        path = os.path.normpath(os.path.join(self.base_dir, loc))
        if not os.path.abspath(path).startswith(
                os.path.abspath(self.base_dir) + os.sep):
            raise ValueError(f"external data path escapes model dir: {loc!r}")
        offset = int(self.external_data.get("offset", 0))
        with open(path, "rb") as f:
            f.seek(offset)
            length = self.external_data.get("length")
            return f.read(int(length)) if length is not None else f.read()

    def to_array(self) -> np.ndarray:
        dt = self.data_type
        shape = tuple(self.dims)
        if self.data_location == 1 and not self.raw_data:
            self.raw_data = self._load_external()
        if self.raw_data:
            dtype = {1: "<f4", 6: "<i4", 7: "<i8", 11: "<f8", 9: "|b1",
                     10: "<f2", 12: "<u4", 13: "<u8", 2: "|u1", 3: "|i1",
                     4: "<u2", 5: "<i2"}[dt]
            arr = np.frombuffer(self.raw_data, dtype=dtype)
        elif dt == 1:
            arr = np.array(self.float_data, dtype=np.float32)
        elif dt == 6:
            arr = np.array(self.int32_data, dtype=np.int32)
        elif dt == 7:
            arr = np.array(self.int64_data, dtype=np.int64)
        else:
            raise ValueError(f"unsupported tensor data_type {dt}")
        # shape == () is a genuine scalar (dims=[] in the proto)
        return arr.reshape(shape)


def _parse_tensor(buf: bytes) -> TensorProto:
    t = TensorProto()
    for fno, wt, v in _iter_fields(buf):
        if fno == 1 and wt == 0:
            t.dims.append(_zigzag64(v))
        elif fno == 1 and wt == 2:  # packed dims
            pos = 0
            while pos < len(v):
                d, pos = _read_varint(v, pos)
                t.dims.append(_zigzag64(d))
        elif fno == 2:
            t.data_type = v
        elif fno == 4 and wt == 2:
            t.float_data.extend(struct.unpack(f"<{len(v)//4}f", v))
        elif fno == 4 and wt == 5:
            t.float_data.append(struct.unpack("<f", v)[0])
        elif fno == 5 and wt == 2:
            pos = 0
            while pos < len(v):
                d, pos = _read_varint(v, pos)
                t.int32_data.append(_zigzag64(d))
        elif fno == 5 and wt == 0:
            t.int32_data.append(_zigzag64(v))
        elif fno == 7 and wt == 2:
            pos = 0
            while pos < len(v):
                d, pos = _read_varint(v, pos)
                t.int64_data.append(_zigzag64(d))
        elif fno == 7 and wt == 0:
            t.int64_data.append(_zigzag64(v))
        elif fno == 8:
            t.name = v.decode()
        elif fno == 9:
            t.raw_data = v
        elif fno == 13 and wt == 2:  # external_data: StringStringEntryProto
            key = val = None
            for f2, _, v2 in _iter_fields(v):
                if f2 == 1:
                    key = v2.decode()
                elif f2 == 2:
                    val = v2.decode()
            if key is not None:
                t.external_data[key] = val
        elif fno == 14:
            t.data_location = v
    return t


@dataclass
class AttributeProto:
    name: str = ""
    f: float = 0.0
    i: int = 0
    s: bytes = b""
    t: TensorProto | None = None
    floats: list = field(default_factory=list)
    ints: list = field(default_factory=list)
    type: int = 0


def _parse_attribute(buf: bytes) -> AttributeProto:
    a = AttributeProto()
    for fno, wt, v in _iter_fields(buf):
        if fno == 1:
            a.name = v.decode()
        elif fno == 2:
            a.f = struct.unpack("<f", v)[0]
        elif fno == 3:
            a.i = _zigzag64(v)
        elif fno == 4:
            a.s = v
        elif fno == 5:
            a.t = _parse_tensor(v)
        elif fno == 7 and wt == 2:
            a.floats.extend(struct.unpack(f"<{len(v)//4}f", v))
        elif fno == 7 and wt == 5:
            a.floats.append(struct.unpack("<f", v)[0])
        elif fno == 8 and wt == 2:
            pos = 0
            while pos < len(v):
                d, pos = _read_varint(v, pos)
                a.ints.append(_zigzag64(d))
        elif fno == 8 and wt == 0:
            a.ints.append(_zigzag64(v))
        elif fno == 20:
            a.type = v
    return a


@dataclass
class NodeProto:
    input: list = field(default_factory=list)
    output: list = field(default_factory=list)
    name: str = ""
    op_type: str = ""
    attributes: dict = field(default_factory=dict)


def _parse_node(buf: bytes) -> NodeProto:
    n = NodeProto()
    for fno, wt, v in _iter_fields(buf):
        if fno == 1:
            n.input.append(v.decode())
        elif fno == 2:
            n.output.append(v.decode())
        elif fno == 3:
            n.name = v.decode()
        elif fno == 4:
            n.op_type = v.decode()
        elif fno == 5:
            a = _parse_attribute(v)
            n.attributes[a.name] = a
    return n


@dataclass
class ValueInfo:
    name: str = ""
    shape: list = field(default_factory=list)  # ints or str (dim_param)
    elem_type: int = 0


def _parse_value_info(buf: bytes) -> ValueInfo:
    vi = ValueInfo()
    for fno, _, v in _iter_fields(buf):
        if fno == 1:
            vi.name = v.decode()
        elif fno == 2:  # TypeProto
            for f2, _, v2 in _iter_fields(v):
                if f2 == 1:  # tensor_type
                    for f3, _, v3 in _iter_fields(v2):
                        if f3 == 1:
                            vi.elem_type = v3
                        elif f3 == 2:  # shape
                            for f4, _, v4 in _iter_fields(v3):
                                if f4 == 1:  # dim
                                    dim_val = None
                                    for f5, _, v5 in _iter_fields(v4):
                                        if f5 == 1:
                                            dim_val = _zigzag64(v5)
                                        elif f5 == 2:
                                            dim_val = v5.decode()
                                    vi.shape.append(dim_val)
    return vi


@dataclass
class GraphProto:
    nodes: list = field(default_factory=list)
    initializers: dict = field(default_factory=dict)
    inputs: list = field(default_factory=list)
    outputs: list = field(default_factory=list)
    value_info: dict = field(default_factory=dict)  # name -> ValueInfo
    name: str = ""


def parse_onnx(data: bytes, base_dir: str = "") -> GraphProto:
    """ModelProto bytes -> GraphProto contents.

    base_dir resolves data_location=EXTERNAL initializers (stored in a
    sibling file, e.g. network.onnx.data)."""
    graph_buf = None
    try:
        for fno, _, v in _iter_fields(data):
            if fno == 7:
                graph_buf = v
    except (IndexError, KeyError, struct.error) as e:
        raise ValueError(f"malformed ONNX file: {e!r}") from e
    if graph_buf is None:
        raise ValueError("no graph in ONNX model")
    g = GraphProto()
    for fno, _, v in _iter_fields(graph_buf):
        if fno == 1:
            g.nodes.append(_parse_node(v))
        elif fno == 2:
            g.name = v.decode()
        elif fno == 5:
            t = _parse_tensor(v)
            t.base_dir = base_dir
            g.initializers[t.name] = t
        elif fno == 11:
            g.inputs.append(_parse_value_info(v))
        elif fno == 12:
            g.outputs.append(_parse_value_info(v))
        elif fno == 13:
            vi = _parse_value_info(v)
            g.value_info[vi.name] = vi
    return g


# ---------------------------------------------------------------------------
# minimal writer (fixture generation; the reference uses torch gen.py scripts)
# ---------------------------------------------------------------------------

def _varint(v: int) -> bytes:
    out = b""
    while True:
        b7 = v & 0x7F
        v >>= 7
        if v:
            out += bytes([b7 | 0x80])
        else:
            return out + bytes([b7])


def _fld(fno: int, wt: int, payload: bytes) -> bytes:
    return _varint((fno << 3) | wt) + payload


def _ld(fno: int, payload: bytes) -> bytes:
    return _fld(fno, 2, _varint(len(payload)) + payload)


def encode_tensor(name: str, arr: np.ndarray) -> bytes:
    arr = np.asarray(arr)
    dt = {np.dtype("float32"): 1, np.dtype("int32"): 6,
          np.dtype("int64"): 7, np.dtype("float64"): 11}[arr.dtype]
    out = b""
    for d in arr.shape:
        out += _fld(1, 0, _varint(d))
    out += _fld(2, 0, _varint(dt))
    out += _ld(8, name.encode())
    out += _ld(9, arr.tobytes())
    return out


def encode_attr_i(name: str, v: int) -> bytes:
    p = _ld(1, name.encode()) + _fld(3, 0, _varint(v % (1 << 64)))
    p += _fld(20, 0, _varint(2))  # type INT
    return p


def encode_attr_f(name: str, v: float) -> bytes:
    import struct
    p = _ld(1, name.encode()) + _fld(2, 5, struct.pack("<f", v))
    p += _fld(20, 0, _varint(1))  # type FLOAT
    return p


def encode_attr_s(name: str, s: str) -> bytes:
    p = _ld(1, name.encode()) + _ld(4, s.encode())
    p += _fld(20, 0, _varint(3))  # type STRING
    return p


def encode_attr_ints(name: str, vals) -> bytes:
    p = _ld(1, name.encode())
    for v in vals:
        p += _fld(8, 0, _varint(v % (1 << 64)))
    p += _fld(20, 0, _varint(7))  # type INTS
    return p


def encode_attr_tensor(name: str, arr: np.ndarray) -> bytes:
    p = _ld(1, name.encode()) + _ld(5, encode_tensor("", arr))
    p += _fld(20, 0, _varint(4))  # type TENSOR
    return p


def encode_node(op_type: str, inputs, outputs, attrs: list = ()) -> bytes:
    p = b""
    for i in inputs:
        p += _ld(1, i.encode())
    for o in outputs:
        p += _ld(2, o.encode())
    p += _ld(4, op_type.encode())
    for a in attrs:
        p += _ld(5, a)
    return p


def _encode_value_info(name: str, shape, elem_type: int = 1) -> bytes:
    dims = b""
    for d in shape:
        if isinstance(d, str):
            dims += _ld(1, _ld(2, d.encode()))
        else:
            dims += _ld(1, _fld(1, 0, _varint(d)))
    tensor_type = _fld(1, 0, _varint(elem_type)) + _ld(2, dims)
    type_proto = _ld(1, tensor_type)
    return _ld(1, name.encode()) + _ld(2, type_proto)


def encode_model(nodes: list, initializers: dict, inputs: list,
                 outputs: list) -> bytes:
    """inputs/outputs: [(name, shape)]; initializers: name -> np array."""
    g = b""
    for n in nodes:
        g += _ld(1, n)
    g += _ld(2, b"graph")
    for name, arr in initializers.items():
        g += _ld(5, encode_tensor(name, arr))
    for name, shape in inputs:
        g += _ld(11, _encode_value_info(name, shape))
    for name, shape in outputs:
        g += _ld(12, _encode_value_info(name, shape))
    model = _fld(1, 0, _varint(8))  # ir_version
    model += _ld(7, g)
    return model
