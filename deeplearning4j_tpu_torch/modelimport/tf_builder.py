"""TensorFlow GraphDef *builder*: protobuf wire encoder + NodeDef helpers.

A copy of ``deeplearning4j_tpu/modelimport/tf_builder.py`` (host code):
for the same calls it writes the same bytes.

Reference parity: the reference consumes frozen GraphDefs produced by TF
itself (samediff-import-tensorflow test resources are .pb files exported
from TF). This environment has no TensorFlow, so the framework ships the
inverse of modelimport/protowire.py — a minimal wire-format ENCODER — plus
GraphDef/NodeDef/TensorProto builders. Uses:

- test fixtures: golden TF graphs are constructed programmatically and fed
  to the importer (tests/test_tf_import.py), the same methodology as the
  hand-written Keras h5 fixtures;
- model construction: zoo/bert builds a faithful frozen-BERT GraphDef via
  these builders (BASELINE config 4's input artifact);
- export: a SameDiff graph restricted to TF-mappable ops can be serialized
  for TF-side consumption.

Field numbers are the frozen public schema of
tensorflow/core/framework/{graph,node_def,attr_value,tensor,tensor_shape,
types}.proto — the same constants documented in tf_pb.py.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

# numpy dtype -> TF DataType enum (inverse of tf_pb.TF_DTYPES)
NP_TO_TF_DTYPE = {
    np.dtype(np.float32): 1,
    np.dtype(np.float64): 2,
    np.dtype(np.int32): 3,
    np.dtype(np.uint8): 4,
    np.dtype(np.int16): 5,
    np.dtype(np.int8): 6,
    np.dtype(np.int64): 9,
    np.dtype(np.bool_): 10,
    np.dtype(np.uint16): 17,
    np.dtype(np.float16): 19,
    np.dtype(np.uint32): 22,
    np.dtype(np.uint64): 23,
}


def np_to_tf_dtype(dt) -> int:
    dt = np.dtype(dt)
    if dt.name == "bfloat16":
        return 14
    try:
        return NP_TO_TF_DTYPE[dt]
    except KeyError:
        raise ValueError(f"no TF dtype for numpy dtype {dt}") from None


# ---------------------------------------------------------------------------
# wire primitives
def _varint(value: int) -> bytes:
    if value < 0:
        value &= (1 << 64) - 1  # two's-complement int64, per proto encoding
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def field_varint(field: int, value: int) -> bytes:
    return _varint(field << 3 | 0) + _varint(value)


def field_bytes(field: int, data: bytes) -> bytes:
    return _varint(field << 3 | 2) + _varint(len(data)) + data


def field_string(field: int, s: str) -> bytes:
    return field_bytes(field, s.encode("utf-8"))


def field_f32(field: int, value: float) -> bytes:
    return _varint(field << 3 | 5) + struct.pack("<f", value)


# ---------------------------------------------------------------------------
# schema builders
def tensor_shape_proto(dims: Optional[Sequence[int]]) -> bytes:
    """TensorShapeProto: dim=2{size=1}, unknown_rank=3."""
    if dims is None:
        return field_varint(3, 1)
    out = b""
    for d in dims:
        out += field_bytes(2, field_varint(1, int(d)))
    return out


def tensor_proto(arr: np.ndarray) -> bytes:
    """TensorProto with tensor_content encoding (dtype=1, shape=2, content=4)."""
    # NOT ascontiguousarray — it promotes 0-d arrays to 1-d
    arr = np.asarray(arr, order="C")
    enum = np_to_tf_dtype(arr.dtype)
    out = field_varint(1, enum)
    out += field_bytes(2, tensor_shape_proto(arr.shape))
    out += field_bytes(4, arr.tobytes())
    return out


def attr_value(value) -> bytes:
    """Encode one AttrValue from a python value (type-directed):
    bytes/str->s, bool->b, int->i, float->f, np.ndarray->tensor,
    ("dtype", enum)->type, ("shape", dims)->shape, list[int]->list.i,
    list[str]->list.s, list[float]->list.f.
    """
    if isinstance(value, tuple) and len(value) == 2 and value[0] == "dtype":
        return field_varint(6, int(value[1]))
    if isinstance(value, tuple) and len(value) == 2 and value[0] == "func":
        # NameAttrList (field 10): name=1 — While/If branch references
        return field_bytes(10, field_string(1, value[1]))
    if isinstance(value, tuple) and len(value) == 2 and value[0] == "shape":
        return field_bytes(7, tensor_shape_proto(value[1]))
    if isinstance(value, bool):
        return field_varint(5, int(value))
    if isinstance(value, (bytes,)):
        return field_bytes(2, value)
    if isinstance(value, str):
        return field_string(2, value)
    if isinstance(value, int):
        return field_varint(3, value)
    if isinstance(value, float):
        return field_f32(4, value)
    if isinstance(value, np.ndarray):
        return field_bytes(8, tensor_proto(value))
    if isinstance(value, (list, tuple)):
        lv = b""
        for v in value:
            if isinstance(v, bool):
                lv += field_varint(5, int(v))
            elif isinstance(v, int):
                lv += field_varint(3, v)
            elif isinstance(v, float):
                lv += field_f32(4, v)
            elif isinstance(v, str):
                lv += field_string(2, v)
            else:
                raise TypeError(f"unsupported attr list element {type(v)}")
        return field_bytes(1, lv)
    raise TypeError(f"unsupported attr value {type(value)}")


def node_def(name: str, op: str, inputs: Sequence[str] = (),
             attrs: Optional[Dict[str, object]] = None) -> bytes:
    """NodeDef: name=1, op=2, input=3, attr=5 (map entry key=1, value=2)."""
    out = field_string(1, name) + field_string(2, op)
    for i in inputs:
        out += field_string(3, i)
    for k, v in (attrs or {}).items():
        entry = field_string(1, k) + field_bytes(2, attr_value(v))
        out += field_bytes(5, entry)
    return out


def function_def(name: str, args: Sequence, outputs: Sequence,
                 body: "GraphDefBuilder") -> bytes:
    """Encode a FunctionDef (the subgraph a TF2 functional While/If node
    invokes). ``args``: [(arg_name, np_dtype)]; ``outputs``:
    [(output_name, body_ref, np_dtype)] where body_ref is the function-
    internal tensor ref (e.g. "mul:z:0"); ``body``: a GraphDefBuilder
    holding the body NodeDefs (inputs reference arg names / node refs).

    Wire: FunctionDef signature=1 (OpDef name=1, input_arg=2,
    output_arg=3; ArgDef name=1 type=3), node_def=3, ret=4 (map)."""
    sig = field_string(1, name)
    for an, dt in args:
        sig += field_bytes(2, field_string(1, an)
                           + field_varint(3, np_to_tf_dtype(dt)))
    for on, _ref, dt in outputs:
        sig += field_bytes(3, field_string(1, on)
                           + field_varint(3, np_to_tf_dtype(dt)))
    out = field_bytes(1, sig)
    for nd in body._nodes:
        out += field_bytes(3, nd)
    for on, ref, _dt in outputs:
        out += field_bytes(4, field_string(1, on) + field_string(2, ref))
    return out


class GraphDefBuilder:
    """Accumulates NodeDefs and serializes a frozen-graph .pb byte string."""

    def __init__(self):
        self._nodes: List[bytes] = []
        self._functions: List[bytes] = []

    def add_function(self, fbytes: bytes) -> None:
        """Attach an encoded FunctionDef to the graph's library."""
        self._functions.append(fbytes)

    def raw_node(self, name: str, op: str, inputs: Sequence[str] = (),
                 attrs: Optional[Dict[str, object]] = None) -> str:
        self._nodes.append(node_def(name, op, inputs, attrs))
        return name

    def const(self, name: str, value) -> str:
        arr = np.asarray(value)
        return self.raw_node(name, "Const", (), {
            "dtype": ("dtype", np_to_tf_dtype(arr.dtype)),
            "value": arr,
        })

    def placeholder(self, name: str, shape: Optional[Sequence[int]] = None,
                    dtype=np.float32) -> str:
        return self.raw_node(name, "Placeholder", (), {
            "dtype": ("dtype", np_to_tf_dtype(dtype)),
            "shape": ("shape", shape),
        })

    def node(self, op: str, name: str, *inputs: str, **attrs) -> str:
        """Generic op node; attrs passed python-typed (see attr_value)."""
        return self.raw_node(name, op, inputs, attrs or None)

    def build(self) -> bytes:
        """GraphDef: node=1 repeated, library=2 (function=1 repeated)."""
        out = b"".join(field_bytes(1, n) for n in self._nodes)
        if self._functions:
            lib = b"".join(field_bytes(1, f) for f in self._functions)
            out += field_bytes(2, lib)
        return out

    def save(self, path: str) -> None:
        with open(path, "wb") as fh:
            fh.write(self.build())
