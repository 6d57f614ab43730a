"""Paged KV-cache arena — pages instead of whole static buckets
(counterpart of ``bigdl_tpu/serving/kvpool.py``).

The unpaged decode path (``models/generate.py``) gives every in-flight
generate request a dense ``[B, Hkv, T_max, Dh]`` cache: a request that
will emit 40 tokens still pins ``T_max`` positions of device memory
for its whole lifetime.  A :class:`KVPagePool` holds ONE arena of
fixed-size pages::

    arena_k / arena_v : [num_pages, layers, Hkv, page_size, Dh]

and each request holds a **page table** (a short list of page ids)
covering only the positions it has actually filled, extending one page
at a time as the decode grows.

Allocation is host-side and O(1) (a free list under a lock).  The
arena is a pair of tensors on the pool's device, written in place by
the paged decoder (``models.generate.PagedDecoder``) under
``arena_lock``: the pool hands out page ids, the decoder gathers and
scatters through them.  Nothing copies the arena to the host except
:meth:`KVPagePool.read_pages` (the prefill → decode handoff export).

Exhaustion is an admission-control event, not an error: ``alloc``
raises :class:`PoolExhausted` and the server sheds the request with a
typed ``OVERLOADED``.  Every lease is release-idempotent and the pool
counts allocs/frees/exhaustions plus a high-water mark, so leak
detection is one ``free_pages == num_pages`` assert after drain.
"""
from __future__ import annotations

import threading
from typing import List, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device

__all__ = ["KVPagePool", "PageLease", "PoolExhausted",
           "page_bucket_ladder", "page_bucket_for"]

#: the arena dtype numpy cannot hold: its pages travel as their raw
#: 16-bit patterns (``uint16``), with the dtype's name beside them
_BF16 = "bfloat16"


class PoolExhausted(RuntimeError):
    """No free pages — the caller must shed (typed OVERLOADED), not
    block: a decode admitted without backing pages can never finish."""


def page_bucket_ladder(max_pages: int) -> List[int]:
    """Doubling page-table sizes ending exactly at ``max_pages`` — one
    decode shape per bucket."""
    if max_pages < 1:
        raise ValueError("max_pages must be >= 1")
    ladder, b = [], 1
    while b < max_pages:
        ladder.append(b)
        b *= 2
    ladder.append(max_pages)
    return sorted(set(ladder))


def page_bucket_for(n: int, max_pages: int) -> int:
    """Smallest ladder bucket holding ``n`` pages."""
    for b in page_bucket_ladder(max_pages):
        if n <= b:
            return b
    raise PoolExhausted(
        f"page table of {n} exceeds max_pages {max_pages}")


class PageLease:
    """One request's hold on a set of pages.  ``extend`` grows it one
    allocation at a time as the decode crosses page boundaries;
    ``release`` is idempotent (the exhaustion/cancel/stop paths may
    race a finally-block release)."""

    __slots__ = ("pool", "pages", "owner", "_released")

    def __init__(self, pool: "KVPagePool", pages: List[int],
                 owner: Optional[str] = None):
        self.pool = pool
        self.pages = list(pages)
        self.owner = owner
        self._released = False

    def extend(self, n: int = 1) -> None:
        """Grow by ``n`` pages (raises :class:`PoolExhausted` — the
        already-held pages stay held; the caller decides whether to
        shed and release).  Growth is charged to the lease's owner."""
        if self._released:
            raise RuntimeError("lease already released")
        self.pages.extend(self.pool._take(n, self.owner))

    def release(self) -> None:
        if self._released:
            return
        self._released = True
        self.pool._give(self.pages, self.owner)

    @property
    def released(self) -> bool:
        return self._released

    def __len__(self) -> int:
        return len(self.pages)


class KVPagePool:
    """Paged KV arena on one device + free-list allocator.

    Parameters mirror the decode cache geometry: ``layers`` transformer
    blocks, ``num_kv_heads`` KV heads (GQA: may be fewer than query
    heads), ``page_size`` positions per page, ``head_dim`` features.
    ``dtype`` is the arena's torch dtype (default ``torch.float32``);
    ``device`` its device (default the current CUDA device, see
    :mod:`bigdl_tpu_torch.device`; ``"cpu"`` runs it on the CPU).

    The arena is built lazily on first use, so constructing a pool (for
    sizing math, tests of the allocator) costs no device memory.
    """

    def __init__(self, num_pages: int, layers: int, num_kv_heads: int,
                 page_size: int, head_dim: int,
                 dtype: Optional[torch.dtype] = None,
                 device: DeviceLike = None):
        if num_pages < 1:
            raise ValueError("num_pages must be >= 1")
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        self.num_pages = int(num_pages)
        self.layers = int(layers)
        self.num_kv_heads = int(num_kv_heads)
        self.page_size = int(page_size)
        self.head_dim = int(head_dim)
        self.dtype = dtype or torch.float32
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        #: serializes the decoder's writes to the arena (one writer at a
        #: time: the serving worker thread in practice)
        self.arena_lock = threading.RLock()
        self._free = list(range(self.num_pages))
        self._arena_k: Optional[torch.Tensor] = None
        self._arena_v: Optional[torch.Tensor] = None
        # accounting (leak detection + the occupancy gauge family)
        self.allocs = 0
        self.frees = 0
        self.exhaustions = 0
        self.high_water = 0
        # owner-scoped accounting: pages held and optional hard budgets
        # per owner.  An owner over its budget is refused
        # (PoolExhausted → typed OVERLOADED shed) even while the free
        # list could cover it
        self._held = {}
        self._budgets = {}
        #: owner charged for allocations that don't name one
        self.default_owner: Optional[str] = None

    # ------------------------------------------------------------ sizing
    @classmethod
    def for_model(cls, model, num_pages: int, page_size: int = 16,
                  dtype: Optional[torch.dtype] = None) -> "KVPagePool":
        """Size a pool from a ``TransformerLM``'s own geometry, on the
        model's device."""
        from ..models.generate import _check_model

        first, count = _check_model(model)
        mha = model[first][1]
        return cls(num_pages, count, mha.num_kv_heads, page_size,
                   mha.head_dim, dtype=dtype, device=model.device)

    def arena_bytes(self) -> int:
        """Bytes the full K+V arena occupies."""
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        per = (self.layers * self.num_kv_heads * self.page_size
               * self.head_dim * itemsize)
        return 2 * self.num_pages * per

    def pages_for_tokens(self, tokens: int) -> int:
        return -(-int(tokens) // self.page_size)

    @property
    def max_positions(self) -> int:
        return self.num_pages * self.page_size

    # ------------------------------------------------------------ arena
    def _ensure_arena(self):
        if self._arena_k is None:
            shape = (self.num_pages, self.layers, self.num_kv_heads,
                     self.page_size, self.head_dim)
            self._arena_k = torch.zeros(shape, dtype=self.dtype,
                                        device=self.device)
            self._arena_v = torch.zeros(shape, dtype=self.dtype,
                                        device=self.device)

    @property
    def arena(self):
        """(arena_k, arena_v) — built on first access."""
        self._ensure_arena()
        return self._arena_k, self._arena_v

    def set_arena(self, arena_k: torch.Tensor, arena_v: torch.Tensor):
        """Install an arena (call under ``arena_lock``).  The paged
        decoder writes the arena in place and installs the same
        tensors."""
        for t in (arena_k, arena_v):
            if t.device != self.device or t.dtype != self.dtype:
                raise ValueError(
                    f"arena tensor on {t.device} in {t.dtype}; this pool "
                    f"is on {self.device} in {self.dtype}")
        self._arena_k = arena_k
        self._arena_v = arena_v

    @property
    def wire_dtype(self) -> Optional[str]:
        """The dtype's name where :meth:`read_pages` hands out raw bit
        patterns (numpy has no such dtype), else None."""
        return _BF16 if self.dtype == torch.bfloat16 else None

    def read_pages(self, page_ids):
        """Host copies of the given pages: (k, v) numpy arrays, each
        ``[n, layers, Hkv, page_size, Dh]`` — the prefill → decode
        handoff export.  A dtype numpy has (float32) travels as itself;
        a bf16 arena's pages as their 16-bit patterns (``uint16``),
        named by :attr:`wire_dtype`."""
        self._ensure_arena()
        idx = torch.as_tensor(list(page_ids), dtype=torch.long,
                              device=self.device)
        with self.arena_lock:
            k, v = self._arena_k[idx], self._arena_v[idx]
        if self.dtype == torch.bfloat16:
            return tuple(t.view(torch.int16).cpu().numpy().view(np.uint16)
                         for t in (k, v))
        return k.cpu().numpy(), v.cpu().numpy()

    def write_pages(self, page_ids, k_pages, v_pages,
                    wire_dtype: Optional[str] = None):
        """Scatter handed-off page contents into this pool's arena
        (decode-side import), cast to the arena's dtype.
        ``wire_dtype`` names the dtype whose bit patterns the arrays
        hold (``"bfloat16"``: ``uint16`` arrays); None means the
        arrays' own dtype."""
        self._ensure_arena()
        idx = torch.as_tensor(list(page_ids), dtype=torch.long,
                              device=self.device)
        if k_pages.shape[0] != idx.shape[0] \
                or v_pages.shape[0] != idx.shape[0]:
            raise ValueError(
                f"{k_pages.shape[0]}/{v_pages.shape[0]} pages of data "
                f"for {idx.shape[0]} page ids")

        def to_tensor(a):
            a = np.ascontiguousarray(a)
            if wire_dtype is None:
                t = torch.from_numpy(a)
            elif wire_dtype == _BF16 and a.dtype == np.uint16:
                t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
            else:
                raise ValueError(f"pages of {a.dtype} on the wire as "
                                 f"{wire_dtype!r}: bfloat16 pages travel "
                                 f"as uint16")
            return t.to(self.device).to(self.dtype)

        k, v = to_tensor(k_pages), to_tensor(v_pages)
        with self.arena_lock:
            self._arena_k[idx] = k
            self._arena_v[idx] = v

    # ------------------------------------------------------------ alloc
    def set_owner_budget(self, owner: str, pages: int) -> None:
        """Cap ``owner`` at ``pages`` held pages — allocations past the
        cap raise :class:`PoolExhausted` even with free pages."""
        with self._lock:
            self._budgets[str(owner)] = int(pages)

    def owner_held(self, owner: str) -> int:
        with self._lock:
            return self._held.get(str(owner), 0)

    def _take(self, n: int, owner: Optional[str] = None) -> List[int]:
        if owner is None:
            owner = self.default_owner
        with self._lock:
            if owner is not None:
                held = self._held.get(owner, 0)
                budget = self._budgets.get(owner)
                if budget is not None and held + n > budget:
                    self.exhaustions += 1
                    raise PoolExhausted(
                        f"owner {owner!r} needs {n} page(s) but holds "
                        f"{held} of its {budget}-page budget")
            if n > len(self._free):
                self.exhaustions += 1
                raise PoolExhausted(
                    f"need {n} page(s), {len(self._free)} free of "
                    f"{self.num_pages}")
            pages, self._free = self._free[:n], self._free[n:]
            self.allocs += n
            if owner is not None:
                self._held[owner] = self._held.get(owner, 0) + n
            in_use = self.num_pages - len(self._free)
            self.high_water = max(self.high_water, in_use)
            return pages

    def _give(self, pages: List[int],
              owner: Optional[str] = None) -> None:
        with self._lock:
            self._free.extend(pages)
            self.frees += len(pages)
            if owner is not None and owner in self._held:
                self._held[owner] = max(
                    0, self._held[owner] - len(pages))

    def alloc(self, n: int, owner: Optional[str] = None) -> PageLease:
        """Lease ``n`` pages (raises :class:`PoolExhausted` when the
        free list cannot cover it — shed, don't wait).  ``owner``
        (default: the pool's ``default_owner``) is charged for the
        pages against its optional budget."""
        if owner is None:
            owner = self.default_owner
        return PageLease(self, self._take(n, owner), owner)

    @property
    def free_pages(self) -> int:
        with self._lock:
            return len(self._free)

    def occupancy(self) -> float:
        return 1.0 - self.free_pages / self.num_pages

    def stats(self) -> dict:
        with self._lock:
            free = len(self._free)
            by_owner = {o: h for o, h in self._held.items() if h}
        return {
            "by_owner": by_owner,
            "num_pages": self.num_pages,
            "free_pages": free,
            "in_use": self.num_pages - free,
            "occupancy": 1.0 - free / self.num_pages,
            "page_size": self.page_size,
            "allocs": self.allocs,
            "frees": self.frees,
            "exhaustions": self.exhaustions,
            "high_water": self.high_water,
            "arena_bytes": self.arena_bytes(),
        }
