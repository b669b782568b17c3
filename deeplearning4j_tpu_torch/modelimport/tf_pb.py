"""TensorFlow GraphDef schema views over the protowire decoder.

A copy of ``deeplearning4j_tpu/modelimport/tf_pb.py`` (host code).

Reference parity: the reference parses TF protos with generated bindings
(org.nd4j.ir + tensorflow protos; TFGraphMapper.java:56 walks NodeDef/
AttrValue/TensorProto). Field numbers below are the public, frozen schema of
tensorflow/core/framework/{graph,node_def,attr_value,tensor,tensor_shape,
types}.proto — schema constants, not code.

GraphDef:        node=1, library=2, versions=4
NodeDef:         name=1, op=2, input=3, device=4, attr=5 (map entry: key=1, value=2)
AttrValue:       list=1, s=2, i=3, f=4, b=5, type=6, shape=7, tensor=8, func=10
AttrValue.ListValue: s=2, i=3, f=4, b=5, type=6, shape=7, tensor=8
NameAttrList:    name=1, attr=2 (map entry: key=1, value=2)
FunctionDefLibrary: function=1, gradient=2
FunctionDef:     signature=1 (OpDef), node_def=3, ret=4 (map), attr=5
OpDef:           name=1, input_arg=2, output_arg=3 (ArgDef: name=1, type=3,
                 type_attr=4)
TensorProto:     dtype=1, tensor_shape=2, tensor_content=4, half_val=13,
                 float_val=5, double_val=6, int_val=7, string_val=8,
                 int64_val=10, bool_val=11, uint32_val=16, uint64_val=17
TensorShapeProto: dim=2 (size=1, name=2), unknown_rank=3
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from deeplearning4j_tpu_torch.modelimport.protowire import Fields

# tensorflow/core/framework/types.proto DataType enum (public constants)
TF_DTYPES: Dict[int, Optional[np.dtype]] = {
    1: np.dtype(np.float32),    # DT_FLOAT
    2: np.dtype(np.float64),    # DT_DOUBLE
    3: np.dtype(np.int32),      # DT_INT32
    4: np.dtype(np.uint8),      # DT_UINT8
    5: np.dtype(np.int16),      # DT_INT16
    6: np.dtype(np.int8),       # DT_INT8
    7: None,                    # DT_STRING (handled separately)
    9: np.dtype(np.int64),      # DT_INT64
    10: np.dtype(np.bool_),     # DT_BOOL
    14: None,                   # DT_BFLOAT16 (np has no bf16; via ml_dtypes)
    17: np.dtype(np.uint16),    # DT_UINT16
    19: np.dtype(np.float16),   # DT_HALF
    22: np.dtype(np.uint32),    # DT_UINT32
    23: np.dtype(np.uint64),    # DT_UINT64
}


def tf_dtype_to_np(enum: int) -> np.dtype:
    if enum == 14:
        import ml_dtypes
        return np.dtype(ml_dtypes.bfloat16)
    dt = TF_DTYPES.get(enum)
    if dt is None:
        raise ValueError(f"unsupported TF dtype enum {enum}")
    return dt


def decode_shape(shape_fields: Optional[Fields]) -> Optional[List[int]]:
    """TensorShapeProto -> [dims] with -1 for unknown; None if unknown rank."""
    if shape_fields is None:
        return []
    if shape_fields.boolean(3):   # unknown_rank
        return None
    dims = []
    for d in shape_fields.repeated_message(2):
        dims.append(d.svarint(1, 0))
    return dims


def decode_tensor(t: Fields) -> np.ndarray:
    """TensorProto -> numpy array."""
    dtype_enum = t.varint(1)
    shape = decode_shape(t.message(2)) or []
    if dtype_enum == 7:  # DT_STRING
        vals = [b.decode("utf-8", "replace") for b in t.repeated_bytes(8)]
        return np.array(vals, dtype=object).reshape(shape)
    np_dtype = tf_dtype_to_np(dtype_enum)
    content = t.bytes_(4)
    n = int(np.prod(shape)) if shape else 1
    if content:
        arr = np.frombuffer(content, dtype=np_dtype).copy()
        return arr.reshape(shape)
    # typed value fields (possibly length 1 broadcast to shape)
    if dtype_enum == 1:
        vals = np.array(t.repeated_f32(5), dtype=np.float32)
    elif dtype_enum == 2:
        vals = np.array(t.repeated_f64(6), dtype=np.float64)
    elif dtype_enum in (3, 4, 5, 6, 17):
        vals = np.array(t.repeated_svarint(7), dtype=np_dtype)
    elif dtype_enum == 9:
        vals = np.array(t.repeated_svarint(10), dtype=np.int64)
    elif dtype_enum == 10:
        vals = np.array([bool(v) for v in t.repeated_varint(11)], dtype=np.bool_)
    elif dtype_enum == 19:  # half stored as repeated int (bit patterns)
        bits = np.array(t.repeated_varint(13), dtype=np.uint16)
        vals = bits.view(np.float16)
    elif dtype_enum == 14:  # bfloat16 bit patterns
        import ml_dtypes
        bits = np.array(t.repeated_varint(13), dtype=np.uint16)
        vals = bits.view(ml_dtypes.bfloat16)
    elif dtype_enum in (22, 23):
        vals = np.array(t.repeated_varint(16 if dtype_enum == 22 else 17),
                        dtype=np_dtype)
    else:
        raise ValueError(f"cannot decode TensorProto dtype {dtype_enum}")
    if vals.size == 0:
        return np.zeros(shape, np_dtype)
    if vals.size == 1 and n > 1:   # splat encoding
        return np.full(shape, vals[0], dtype=np_dtype)
    return vals.reshape(shape)


class AttrValue:
    """One NodeDef attribute."""

    def __init__(self, fields: Fields):
        self._f = fields

    @property
    def s(self) -> str:
        return self._f.bytes_(2).decode("utf-8", "replace")

    @property
    def i(self) -> int:
        return self._f.svarint(3)

    @property
    def f(self) -> float:
        return self._f.f32(4)

    @property
    def b(self) -> bool:
        return self._f.boolean(5)

    @property
    def type(self) -> int:
        return self._f.varint(6)

    @property
    def shape(self) -> Optional[List[int]]:
        return decode_shape(self._f.message(7))

    @property
    def tensor(self) -> np.ndarray:
        m = self._f.message(8)
        if m is None:
            raise ValueError("attr has no tensor")
        return decode_tensor(m)

    @property
    def func(self) -> Optional[str]:
        """NameAttrList.name — the FunctionDef a While/If node's
        cond/body/then_branch/else_branch attr points at."""
        m = self._f.message(10)
        return m.string(1) if m is not None else None

    @property
    def list(self) -> Dict[str, list]:
        lv = self._f.message(1)
        if lv is None:
            return {"s": [], "i": [], "f": [], "b": [], "type": [], "shape": []}
        return {
            "s": [b.decode("utf-8", "replace") for b in lv.repeated_bytes(2)],
            "i": lv.repeated_svarint(3),
            "f": lv.repeated_f32(4),
            "b": [bool(v) for v in lv.repeated_varint(5)],
            "type": lv.repeated_varint(6),
            "shape": [decode_shape(s) for s in lv.repeated_message(7)],
        }


class NodeDef:
    def __init__(self, fields: Fields):
        self.name = fields.string(1)
        self.op = fields.string(2)
        self.inputs = fields.repeated_string(3)
        self.attrs: Dict[str, AttrValue] = {}
        for entry in fields.repeated_message(5):
            key = entry.string(1)
            val = entry.message(2)
            if val is not None:
                self.attrs[key] = AttrValue(val)

    def attr(self, name: str) -> Optional[AttrValue]:
        return self.attrs.get(name)

    def __repr__(self):
        return f"NodeDef({self.op} {self.name!r} inputs={self.inputs})"


class ArgDef:
    def __init__(self, fields: Fields):
        self.name = fields.string(1)
        self.type = fields.varint(3)        # DataType enum (0 if type_attr)
        self.type_attr = fields.string(4)


class FunctionDef:
    """tensorflow.FunctionDef — the subgraph a TF2 functional
    While/If node invokes."""

    def __init__(self, fields: Fields):
        sig = fields.message(1)
        self.name = sig.string(1) if sig else ""
        self.input_args: List[ArgDef] = (
            [ArgDef(a) for a in sig.repeated_message(2)] if sig else [])
        self.output_args: List[ArgDef] = (
            [ArgDef(a) for a in sig.repeated_message(3)] if sig else [])
        self.nodes: List[NodeDef] = [NodeDef(f)
                                     for f in fields.repeated_message(3)]
        self.ret: Dict[str, str] = {}
        for entry in fields.repeated_message(4):
            self.ret[entry.string(1)] = entry.string(2)


class GraphDef:
    def __init__(self, data: bytes):
        fields = Fields(data)
        self.nodes: List[NodeDef] = [NodeDef(f) for f in fields.repeated_message(1)]
        self.functions: Dict[str, FunctionDef] = {}
        lib = fields.message(2)
        if lib is not None:
            for f in lib.repeated_message(1):
                fd = FunctionDef(f)
                self.functions[fd.name] = fd

    @staticmethod
    def from_file(path: str) -> "GraphDef":
        with open(path, "rb") as fh:
            return GraphDef(fh.read())
