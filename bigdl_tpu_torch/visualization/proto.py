"""Minimal protobuf wire-format encoder for TF Event/Summary messages
(counterpart of ``bigdl_tpu/visualization/proto.py``, a copy).

The reference ships ~157k LoC of GENERATED protobuf Java (SURVEY layout
table); the rebuild needs exactly three messages (Event, Summary,
HistogramProto) so they are hand-encoded here — wire-compatible with
TensorBoard, zero codegen.
"""
from __future__ import annotations

import struct
from typing import List, Sequence


def _varint(n: int) -> bytes:
    out = bytearray()
    n &= 0xFFFFFFFFFFFFFFFF
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _len_delim(field: int, payload: bytes) -> bytes:
    return _key(field, 2) + _varint(len(payload)) + payload


def _double(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _float(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _int64(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v)


def _packed_doubles(field: int, vals: Sequence[float]) -> bytes:
    payload = b"".join(struct.pack("<d", v) for v in vals)
    return _len_delim(field, payload)


def encode_summary_value(tag: str, simple_value: float = None,
                         histo: bytes = None) -> bytes:
    # Summary.Value: tag=1, simple_value=2, histo=5
    out = _len_delim(1, tag.encode("utf-8"))
    if simple_value is not None:
        out += _float(2, simple_value)
    if histo is not None:
        out += _len_delim(5, histo)
    return out


def encode_histogram(minv: float, maxv: float, num: float, total: float,
                     sum_squares: float, bucket_limits: Sequence[float],
                     buckets: Sequence[float]) -> bytes:
    # HistogramProto: min=1,max=2,num=3,sum=4,sum_squares=5,
    # bucket_limit=6 (packed), bucket=7 (packed)
    return (_double(1, minv) + _double(2, maxv) + _double(3, num)
            + _double(4, total) + _double(5, sum_squares)
            + _packed_doubles(6, bucket_limits) + _packed_doubles(7, buckets))


def encode_summary(values: List[bytes]) -> bytes:
    # Summary: repeated Value value = 1
    return b"".join(_len_delim(1, v) for v in values)


def encode_event(wall_time: float, step: int = None, summary: bytes = None,
                 file_version: str = None) -> bytes:
    # Event: wall_time=1 (double), step=2 (int64), file_version=3, summary=5
    out = _double(1, wall_time)
    if step is not None:
        out += _int64(2, step)
    if file_version is not None:
        out += _len_delim(3, file_version.encode("utf-8"))
    if summary is not None:
        out += _len_delim(5, summary)
    return out


# ---------------------------------------------------------------------------
# decoding (for FileReader — reference visualization/tensorboard/FileReader)
# ---------------------------------------------------------------------------
def _read_varint(buf: bytes, pos: int):
    result, shift = 0, 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def decode_fields(buf: bytes):
    """Yield (field_number, wire_type, value) triples."""
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
        elif wire == 1:
            val = struct.unpack("<d", buf[pos:pos + 8])[0]
            pos += 8
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wire == 5:
            val = struct.unpack("<f", buf[pos:pos + 4])[0]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val
