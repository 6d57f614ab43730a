"""Prefill/decode pool roles + the verified KV handoff between them
(counterpart of ``bigdl_tpu/serving/pools.py``).

Prefill is one big causal pass over the prompt (compute-bound); decode
streams the whole KV cache per token (memory-bound).  Disaggregation
sends each phase to a pool sized for its own bottleneck: servers
advertise a ``role`` in their health snapshots (``prefill`` |
``decode`` | ``both``), and the filled KV pages travel between them as
a **handoff** blob.

The blob is a pickled payload behind a header carrying a crc32c over
its bytes, verified on receipt: a blob corrupted in flight (or a
version-skewed peer) raises :class:`HandoffCorrupt` and the decode
resolves as a typed INTERNAL_ERROR instead of decoding garbage K/V.
The wire format is the JAX package's: an f32 blob sealed by either
package reads in the other.  A bf16 arena's pages (numpy has no bf16)
travel as their 16-bit patterns with ``kv_dtype: "bfloat16"`` among
the payload's fields.
"""
from __future__ import annotations

import pickle
import struct
from typing import Dict, Optional, Tuple

import numpy as np

from ..visualization.crc32c import crc32c

__all__ = ["PREFILL", "DECODE", "BOTH", "ROLES", "HandoffCorrupt",
           "serialize_handoff", "deserialize_handoff",
           "peek_handoff_trace", "serves_phase", "split_pool",
           "pool_members"]

PREFILL = "prefill"
DECODE = "decode"
BOTH = "both"
ROLES = (PREFILL, DECODE, BOTH)

#: wire header: magic + crc32c + payload length
_MAGIC = b"BKVH"
_HEADER = struct.Struct("<4sII")


class HandoffCorrupt(RuntimeError):
    """The KV handoff blob failed its crc32c (or geometry) check —
    refused before any of its bytes reach a decode step."""


def serves_phase(role: Optional[str], phase: str) -> bool:
    """Does a server advertising ``role`` serve ``phase``?  Unknown /
    unreported roles default to ``both``."""
    r = role if role in ROLES else BOTH
    return r == BOTH or r == phase


def split_pool(pool: str) -> Tuple[Optional[str], str]:
    """Parse a pool spec into ``(model, role)``: a bare role
    (``"decode"``) is ``(None, "decode")``; ``"model:role"`` scopes the
    pool to one model's servers."""
    if ":" in pool:
        model, role = pool.split(":", 1)
        return model, role
    return None, pool


def pool_members(health: Dict[str, dict], phase: str) -> Tuple[str, ...]:
    """Members of one pool, from a health view keyed by server name.
    ``phase`` accepts the specs :func:`split_pool` does."""
    model, role = split_pool(phase)
    return tuple(sorted(
        r for r, h in health.items()
        if serves_phase((h or {}).get("role"), role)
        and (model is None or (h or {}).get("model") == model)))


def serialize_handoff(k_pages: np.ndarray, v_pages: np.ndarray,
                      first_token: int, pos: int, page_size: int,
                      extras: Optional[dict] = None) -> bytes:
    """Pack filled KV pages + the first generated token into a
    crc-sealed blob.  ``pos`` is the next write position (the prompt
    length); geometry fields ride along so the importing pool can
    refuse a mismatched arena loudly."""
    n, layers, hkv, ps, dh = k_pages.shape
    if ps != page_size:
        raise ValueError(f"k_pages page dim {ps} != page_size "
                         f"{page_size}")
    payload = pickle.dumps({
        "k_pages": np.asarray(k_pages),
        "v_pages": np.asarray(v_pages),
        "first_token": int(first_token),
        "pos": int(pos),
        "page_size": int(page_size),
        "layers": int(layers),
        "num_kv_heads": int(hkv),
        "head_dim": int(dh),
        **(extras or {}),
    }, protocol=pickle.HIGHEST_PROTOCOL)
    return _HEADER.pack(_MAGIC, crc32c(payload) & 0xFFFFFFFF,
                        len(payload)) + payload


def deserialize_handoff(blob: bytes) -> dict:
    """Verify and unpack a handoff blob (:class:`HandoffCorrupt` on a
    bad magic, length, or crc)."""
    if not isinstance(blob, (bytes, bytearray)):
        raise HandoffCorrupt(
            f"handoff must be bytes, got {type(blob).__name__}")
    if len(blob) < _HEADER.size:
        raise HandoffCorrupt(f"handoff truncated ({len(blob)} bytes)")
    magic, crc, size = _HEADER.unpack_from(blob)
    payload = bytes(blob[_HEADER.size:])
    if magic != _MAGIC:
        raise HandoffCorrupt(f"bad handoff magic {magic!r}")
    if len(payload) != size:
        raise HandoffCorrupt(
            f"handoff payload {len(payload)} bytes, header says {size}")
    if (crc32c(payload) & 0xFFFFFFFF) != crc:
        raise HandoffCorrupt("handoff failed crc32c verification")
    out = pickle.loads(payload)
    for key in ("k_pages", "v_pages", "first_token", "pos",
                "page_size", "layers", "num_kv_heads", "head_dim"):
        if key not in out:
            raise HandoffCorrupt(f"handoff missing field {key!r}")
    return out


def peek_handoff_trace(blob) -> Optional[dict]:
    """The distributed-trace context a prefill server sealed into the
    handoff extras (``telemetry.trace_context.TRACE_WIRE_KEY``), or
    None — on an untraced blob AND on a corrupt one.  The crc verdict
    belongs to the decode path; this peek must never preempt it."""
    from ..telemetry.trace_context import TRACE_WIRE_KEY

    try:
        wire = deserialize_handoff(blob).get(TRACE_WIRE_KEY)
        return wire if isinstance(wire, dict) else None
    except Exception:
        return None
