"""Continuous micro-batching into static bucket shapes.

The compiled eval forward traces one executable per input shape, so a
server that stacked whatever happened to be queued (7 requests now, 13
next tick) would recompile on nearly every batch — the exact failure
mode Parallax warns against (keep the hot path static-shaped, let the
control plane absorb variability).  The batcher therefore owns a
**bucket ladder**: batch sizes double from the mesh multiple up to
``max_batch``, every coalesced batch is padded (by repeating the last
record — ``pad_batch``'s numerically-valid convention) up to the
smallest bucket that holds it, and the padded rows are sliced off the
output.  Worst-case ``len(ladder)`` compiles per feature shape,
ever — regardless of traffic.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def round_up(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def bucket_ladder(max_batch: int, multiple: int = 1) -> List[int]:
    """Doubling bucket sizes ending exactly at ``max_batch``, each
    rounded up to ``multiple`` (the mesh data-axis size — shard_map
    needs every batch divisible by it)."""
    if max_batch < 1:
        raise ValueError("max_batch must be >= 1")
    ladder, b = [], 1
    while b < max_batch:
        ladder.append(round_up(b, multiple))
        b *= 2
    ladder.append(round_up(max_batch, multiple))
    # rounding can introduce duplicates (e.g. 1,2,4 all round to 8)
    return sorted(set(ladder))


class MicroBatcher:
    def __init__(self, max_batch: int, multiple: int = 1):
        self.ladder = bucket_ladder(max_batch, multiple)
        self.max_batch = self.ladder[-1]
        #: buckets actually dispatched — the compile-accounting hook:
        #: the jit cache may hold at most one entry per (bucket,
        #: feature-shape) ever dispatched
        self.buckets_dispatched: set = set()

    def bucket_for(self, n: int) -> int:
        for b in self.ladder:
            if n <= b:
                return b
        raise ValueError(f"batch of {n} exceeds max_batch "
                         f"{self.max_batch}")

    def coalesce(self, features: Sequence[np.ndarray]
                 ) -> Tuple[np.ndarray, int]:
        """Stack per-request feature rows and pad up to the bucket by
        repeating the last row.  Returns ``(batch, bucket)``; the
        caller slices outputs back to ``len(features)``."""
        x = np.stack([np.asarray(f) for f in features])
        n = x.shape[0]
        bucket = self.bucket_for(n)
        if n < bucket:
            x = np.concatenate(
                [x, np.repeat(x[-1:], bucket - n, axis=0)], axis=0)
        self.buckets_dispatched.add(bucket)
        return x, bucket
