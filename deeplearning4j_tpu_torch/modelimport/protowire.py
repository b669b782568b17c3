"""Minimal protobuf wire-format decoder for model import.

A copy of ``deeplearning4j_tpu/modelimport/protowire.py`` (host code; the
port keeps its own so that it imports nothing of the JAX package).

Reference parity: the reference ships generated protobuf bindings for the
TF/ONNX schemas (nd4j/nd4j-backends/nd4j-api-parent/nd4j-api org.nd4j.ir,
generated from graph.proto et al.) and parses serialized GraphDef/ModelProto
with them (samediff-import-api/.../ImportGraph.kt:218). This framework keeps
the import layer dependency-free instead: the protobuf *wire format* is a
tiny, stable encoding (tag = field<<3|wiretype; varint / 64-bit / length-
delimited / 32-bit payloads), so a ~100-line decoder replaces the generated
binding stack. Schema knowledge (which field number means what) lives in the
per-format view classes in tf_pb.py / onnx_pb.py.

Wire types: 0 varint, 1 fixed64, 2 length-delimited, 5 fixed32.
"""
from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Tuple, Union

WIRE_VARINT = 0
WIRE_FIXED64 = 1
WIRE_BYTES = 2
WIRE_FIXED32 = 5


def read_varint(data: bytes, pos: int) -> Tuple[int, int]:
    """Decode one base-128 varint at ``pos``; returns (value, new_pos)."""
    result = 0
    shift = 0
    while True:
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7
        if shift >= 70:
            raise ValueError("varint too long (corrupt protobuf)")


def iter_fields(data: bytes) -> Iterator[Tuple[int, int, Union[int, bytes]]]:
    """Yield (field_number, wire_type, raw_value) over one message's bytes.

    Length-delimited values come back as bytes; varints as ints;
    fixed32/fixed64 as their raw little-endian bytes (caller interprets:
    float vs int32 vs double vs int64 is schema knowledge).
    """
    pos = 0
    n = len(data)
    while pos < n:
        tag, pos = read_varint(data, pos)
        field, wire = tag >> 3, tag & 7
        if wire == WIRE_VARINT:
            val, pos = read_varint(data, pos)
        elif wire == WIRE_BYTES:
            ln, pos = read_varint(data, pos)
            val = data[pos:pos + ln]
            if len(val) != ln:
                raise ValueError(
                    f"truncated protobuf: field {field} declares {ln} bytes, "
                    f"{len(val)} available")
            pos += ln
        elif wire == WIRE_FIXED64:
            val = data[pos:pos + 8]
            if len(val) != 8:
                raise ValueError(f"truncated protobuf: fixed64 field {field}")
            pos += 8
        elif wire == WIRE_FIXED32:
            val = data[pos:pos + 4]
            if len(val) != 4:
                raise ValueError(f"truncated protobuf: fixed32 field {field}")
            pos += 4
        elif wire == 3 or wire == 4:  # group start/end (legacy, unused)
            raise ValueError("protobuf groups unsupported")
        else:
            raise ValueError(f"bad wire type {wire} at {pos}")
        yield field, wire, val


class Fields:
    """Decoded message: field number -> list of raw values (wire order)."""

    __slots__ = ("_f",)

    def __init__(self, data: bytes):
        self._f: Dict[int, List] = {}
        for field, _wire, val in iter_fields(data):
            self._f.setdefault(field, []).append(val)

    # scalar accessors (last occurrence wins, per proto3 semantics)
    def varint(self, field: int, default: int = 0) -> int:
        v = self._f.get(field)
        return v[-1] if v else default

    def svarint(self, field: int, default: int = 0) -> int:
        """Signed interpretation of a (non-zigzag) int64 varint."""
        u = self.varint(field, default)
        return u - (1 << 64) if u >= (1 << 63) else u

    def boolean(self, field: int, default: bool = False) -> bool:
        return bool(self.varint(field, int(default)))

    def f32(self, field: int, default: float = 0.0) -> float:
        v = self._f.get(field)
        return struct.unpack("<f", v[-1])[0] if v else default

    def f64(self, field: int, default: float = 0.0) -> float:
        v = self._f.get(field)
        return struct.unpack("<d", v[-1])[0] if v else default

    def bytes_(self, field: int, default: bytes = b"") -> bytes:
        v = self._f.get(field)
        return v[-1] if v else default

    def string(self, field: int, default: str = "") -> str:
        v = self._f.get(field)
        return v[-1].decode("utf-8") if v else default

    def message(self, field: int) -> "Fields | None":
        v = self._f.get(field)
        return Fields(v[-1]) if v else None

    # repeated accessors
    def repeated_bytes(self, field: int) -> List[bytes]:
        return list(self._f.get(field, []))

    def repeated_string(self, field: int) -> List[str]:
        return [b.decode("utf-8") for b in self._f.get(field, [])]

    def repeated_message(self, field: int) -> List["Fields"]:
        return [Fields(b) for b in self._f.get(field, [])]

    def repeated_varint(self, field: int) -> List[int]:
        """Repeated int field: handles both packed and unpacked encodings."""
        out: List[int] = []
        for v in self._f.get(field, []):
            if isinstance(v, int):
                out.append(v)
            else:  # packed: length-delimited blob of varints
                pos = 0
                while pos < len(v):
                    x, pos = read_varint(v, pos)
                    out.append(x)
        return out

    def repeated_svarint(self, field: int) -> List[int]:
        return [x - (1 << 64) if x >= (1 << 63) else x
                for x in self.repeated_varint(field)]

    def repeated_f32(self, field: int) -> List[float]:
        out: List[float] = []
        for v in self._f.get(field, []):
            if len(v) == 4:
                out.append(struct.unpack("<f", v)[0])
            else:  # packed
                out.extend(struct.unpack(f"<{len(v)//4}f", v))
        return out

    def repeated_f64(self, field: int) -> List[float]:
        out: List[float] = []
        for v in self._f.get(field, []):
            if len(v) == 8:
                out.append(struct.unpack("<d", v)[0])
            else:
                out.extend(struct.unpack(f"<{len(v)//8}d", v))
        return out

    def has(self, field: int) -> bool:
        return field in self._f
