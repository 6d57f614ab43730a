"""CRC32C (Castagnoli) + TFRecord masking (counterpart of
``bigdl_tpu/visualization/crc32c.py``).

:func:`crc32c` and :func:`masked_crc32c` run the native slicing-by-8
CRC (``native/crc32c.cc``, built with ``g++`` at first use); a build
that fails raises.  :func:`crc32c_table` is the pure-Python table
version, the plain version the tests hold the native one against.
"""
from __future__ import annotations

_POLY = 0x82F63B78
_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ _POLY if _c & 1 else _c >> 1
    _TABLE.append(_c)


def crc32c_table(data: bytes, crc: int = 0) -> int:
    """The plain version: one table lookup per byte, in Python."""
    crc ^= 0xFFFFFFFF
    for b in bytes(data):
        crc = _TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def crc32c(data, crc: int = 0) -> int:
    """crc32c of ``data`` (bytes or any buffer), continuing from
    ``crc``, on the native slicing-by-8 CRC."""
    from .. import native

    return native.crc32c(data, crc)


def masked_crc32c(data) -> int:
    """TFRecord mask (the constant the reference RecordWriter uses)."""
    crc = crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF
