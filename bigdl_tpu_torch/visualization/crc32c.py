"""CRC32C (Castagnoli) + TFRecord masking (counterpart of
``bigdl_tpu/visualization/crc32c.py``).

The pure-Python table implementation.  The JAX package also has a
native slicing-by-8 path (``native/``); it comes with that package's
port.
"""
from __future__ import annotations

_POLY = 0x82F63B78
_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ _POLY if _c & 1 else _c >> 1
    _TABLE.append(_c)


def crc32c(data: bytes, crc: int = 0) -> int:
    crc ^= 0xFFFFFFFF
    for b in data:
        crc = _TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """TFRecord mask (the constant the reference RecordWriter uses)."""
    crc = crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF
