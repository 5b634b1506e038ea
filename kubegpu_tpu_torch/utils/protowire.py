"""Minimal protobuf wire-format codec (no generated code, no proto
files): the port's copy of the JAX package's ``utils/protowire.py``.

The CRI shim (``crishim/``) decodes just enough of
``runtime.v1.RuntimeService/CreateContainer`` to find the pod and append
env/device entries, and the device plugin speaks the kubelet's
``v1beta1`` messages.  Protobuf's wire format makes this safe without
the schema: unknown fields pass through untouched, and *appending* an
encoded repeated-field entry to a serialized message is exactly
equivalent to adding an element to that repeated field.

Wire types used by CRI messages: 0 = varint, 2 = length-delimited.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple


def encode_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def decode_varint(data: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(data):
            raise ValueError("truncated varint")
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def iter_fields(data: bytes) -> Iterator[Tuple[int, int, object, Tuple[int, int]]]:
    """Yield (field_no, wire_type, value, (start, end) of the whole field).

    value is int for varints, bytes for length-delimited, raw bytes for
    fixed32/64 (returned but never produced by CRI paths we touch)."""
    pos = 0
    n = len(data)
    while pos < n:
        start = pos
        key, pos = decode_varint(data, pos)
        field_no, wire_type = key >> 3, key & 0x7
        if wire_type == 0:
            val, pos = decode_varint(data, pos)
        elif wire_type == 2:
            length, pos = decode_varint(data, pos)
            if pos + length > n:
                raise ValueError("truncated length-delimited field")
            val = data[pos : pos + length]
            pos += length
        elif wire_type == 5:
            val = data[pos : pos + 4]
            pos += 4
        elif wire_type == 1:
            val = data[pos : pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire_type}")
        yield field_no, wire_type, val, (start, pos)


def get_field(data: bytes, field_no: int) -> Optional[object]:
    for fn, _, val, _ in iter_fields(data):
        if fn == field_no:
            return val
    return None


def get_all(data: bytes, field_no: int) -> List[object]:
    return [val for fn, _, val, _ in iter_fields(data) if fn == field_no]


def encode_len_field(field_no: int, payload: bytes) -> bytes:
    return encode_varint((field_no << 3) | 2) + encode_varint(len(payload)) + payload


def encode_string_field(field_no: int, s: str) -> bytes:
    return encode_len_field(field_no, s.encode())


def decode_string_map(entries: List[object]) -> Dict[str, str]:
    """map<string,string> = repeated entry messages {key=1, value=2}."""
    out: Dict[str, str] = {}
    for e in entries:
        if not isinstance(e, (bytes, bytearray)):
            continue
        k = get_field(bytes(e), 1)
        v = get_field(bytes(e), 2)
        out[bytes(k).decode() if k else ""] = bytes(v).decode() if v else ""
    return out


def replace_field(data: bytes, field_no: int, new_payload: bytes) -> bytes:
    """Replace the FIRST occurrence of a length-delimited field in place
    (preserving unknown fields and ordering); append if absent."""
    for fn, wt, _, (start, end) in iter_fields(data):
        if fn == field_no and wt == 2:
            return data[:start] + encode_len_field(field_no, new_payload) + data[end:]
    return data + encode_len_field(field_no, new_payload)


def append_to_message_field(data: bytes, field_no: int, entries: List[bytes]) -> bytes:
    """Append encoded entries as new elements of a repeated message field —
    pure concatenation by protobuf wire semantics."""
    out = bytearray(data)
    for e in entries:
        out += encode_len_field(field_no, e)
    return bytes(out)


def encode_key_value(key: str, value: str) -> bytes:
    """CRI KeyValue {key=1, value=2} (also the shape of map entries)."""
    return encode_string_field(1, key) + encode_string_field(2, value)
