"""Block-sparse attention and the block-sparse matmul (counterpart of
``bigdl_tpu/ops/block_sparse.py``, BLaST).

Kernels, CUDA C++ for ``sm_90a`` in ``csrc/block_sparse.cu``, whose
header says what each computes, what bounds it and how:

* K6 ``bigdl_bs_fwd`` replaces ``_bs_fwd_kernel``
  (``bigdl_tpu/ops/block_sparse.py:292``);
* K7 ``bigdl_bs_bwd_dkv`` and K8 ``bigdl_bs_bwd_dq`` replace
  ``_bs_dkv_kernel`` (``:317``) and ``_bs_dq_kernel`` (``:345``);
* K9 ``bigdl_bs_mm`` replaces ``_bs_mm_kernel`` (``:626``).

The host side is a numpy copy of the JAX module's: :class:`BlockMask`,
the mask builders, ``pick_block_divisor``, ``_index_tables``,
``attention_work`` and ``matmul_work`` give the JAX values on the same
inputs.  The attention kernels work on 64-row tiles, not on mask
blocks: ``_tile_tables`` lists, for each 64-row tile of one side, the
tiles of the other side that hold a live element (the caller's mask
with the causally dead blocks pruned, AND the element-level causal
mask), and flags the tile pairs the mask covers only in part.  Inside a
flagged pair the kernels test each element against the block mask and
zero-fill the rows that no row of the other tile may attend, so a dead
element never reaches a product.  K6-K8 in bf16 (K1's and K2/K3's Hopper
bodies, ``csrc/attn_fwd_hopper.cuh`` and ``csrc/attn_bwd_hopper.cuh``)
own 128 rows a block: ``_block_lists`` regroups the lists per block, with
per-warpgroup flags, the live rows of each partial pair and a
heaviest-first block order; K6 reads the 128-row query lists
(``dq_blocks``) in both dtypes, in f32 on K1's f32 body (each f32 product
formed from bf16 wgmma products on bf16 pieces of its operands).  K7 and
K8 above head dim 128, and in f32 (K2's and K3's f32 bodies, split
products too), own 64 rows a block and read the lists per 64-row tile.
The f32 K6-K8 at head dims 192 and 256 stream each 64-row list step as
two 32-row tiles.  The tables go to the card once per (mask, causal,
device) and stay cached: no launch uploads anything.  Above the built
head dims (256) K6 runs the chunked forward of ``csrc/attn_fwd_hopper.cuh``
over the same 128-row query lists (D zero-padded to a multiple of 64,
q and K streamed in 64-column panels, O kept 256 columns a block; a
partial pair's live rows staged for every panel), and K7 and K8 the
chunked backward of ``csrc/attn_bwd_hopper.cuh`` over the 64-row key
and query lists (at the forward's padded D, the scores summed over
64-column panels, dK/dV and dQ kept 256 columns a block; a partial
pair's live rows staged for every panel and chunk operand), both in
either dtype.

``block_sparse_attention`` and ``block_sparse_matmul`` are
``torch.autograd.Function``s, the counterparts of the ``custom_vjp``s
``_bs_attn`` and ``_bs_mm``.  For CPU tensors they run the plain
versions (``_bs_attention_plain``, ``_bs_bwd_plain``, ``_bs_mm_plain``:
the kernels' math in PyTorch, masking with a select); for CUDA tensors
they launch the kernels or raise, forward and backward.  Any block size
that tiles the sequence (or the weight), any head dim (padded as
``flash_attention`` pads it), any B*H, float32 or bfloat16.  K9 is a
GEMM on TMA + wgmma in both dtypes (in f32 each f32 product formed from
six bf16 products on three bf16 pieces of each operand).  At blocks that
are multiples of 64 it takes its block route, over the mask's own
blocks, W read in place in either orientation (dX reads W's storage; in
f32 W split once per call in its own orientation, ``_mm_pieces``).  At
every other block it takes its coarse route (``_mm_plan``): a masked
copy of W written once per call (``_mm_masked``: a select, zero-padded
to whole coarse tiles, in W's own orientation; in f32 straight as its
three pieces) walked in coarse (KC, BN) tiles that hold a live element
(``_coarse_grid``).
"""
from __future__ import annotations

import ctypes
import math
from collections import OrderedDict
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..telemetry.perf import kernel_work, nbytes
from ._support import LaunchCounter, on_cpu, split_bf16x3
from .flash_attention import (_DTYPE_CODE, _F, _I, _P, FIRST_HEAD, HEADS,
                              WIDE_F32_DIMS, _attn_bwd_plain, _attn_plain,
                              _bwd_inputs, attention_products, fwd_bytes,
                              _c_fn, _call, _causal_keep, _check_kernel_inputs,
                              _check_lse, _chunked_counter, _cut_head_dim,
                              _bwd_head_dim, _bwd_operands, _empty,
                              _f32_counter, _fwd_head_dim, _kernel_operands,
                              _launch_heads, _pad_head_dim, _strides_arg)

__all__ = ["BlockMask", "block_sparse_attention", "block_sparse_matmul",
           "sliding_window_mask", "strided_mask", "magnitude_block_mask",
           "attention_work", "matmul_work", "pick_block_divisor"]

TILE = 64   # rows of every attention tile the kernels work on
BLOCK_ROWS = 128   # own rows of a bf16 K6-K8 block: two 64-row tiles

#: launches of K6, K7, K8 and K9 (CUDA branch only)
LAUNCHES = LaunchCounter("block_sparse_fwd")
LAUNCHES_DKV = LaunchCounter("block_sparse_bwd_dkv")
LAUNCHES_DQ = LaunchCounter("block_sparse_bwd_dq")
#: the launches of K6, K7 and K8, among those above, in f32 at the built
#: head dims on which the f32 kernels stream 32-row tiles (no model path
#: runs them)
LAUNCHES_F32 = {D: LaunchCounter(f"block_sparse_fwd f32 D {D}")
                for D in WIDE_F32_DIMS}
LAUNCHES_DKV_F32 = {D: LaunchCounter(f"block_sparse_bwd_dkv f32 D {D}")
                    for D in WIDE_F32_DIMS}
LAUNCHES_DQ_F32 = {D: LaunchCounter(f"block_sparse_bwd_dq f32 D {D}")
                   for D in WIDE_F32_DIMS}
#: the launches of K6, among those above, at head dims above 256 (the
#: chunked forward), by dtype (no model path runs them)
LAUNCHES_CHUNKED = {dt: LaunchCounter(f"block_sparse_fwd {name} D > 256")
                    for dt, name in ((torch.bfloat16, "bf16"),
                                     (torch.float32, "f32"))}
#: the launches of K7 and K8, among those above, at head dims above 256
#: on the chunked backward, by dtype (no model path runs them)
LAUNCHES_DKV_CHUNKED = {
    dt: LaunchCounter(f"block_sparse_bwd_dkv {name} D > 256")
    for dt, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32"))}
LAUNCHES_DQ_CHUNKED = {
    dt: LaunchCounter(f"block_sparse_bwd_dq {name} D > 256")
    for dt, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32"))}
LAUNCHES_MM = LaunchCounter("block_sparse_mm")
#: the K9 launches, among those above, on the block route in f32 (split
#: products over the mask's blocks)
LAUNCHES_MM_F32 = LaunchCounter("block_sparse_mm f32")
#: the K9 launches, among those above, on the coarse route (coarse tiles
#: of a masked copy of W: blocks that are not multiples of 64), by dtype
LAUNCHES_MM_COARSE = {dt: LaunchCounter(f"block_sparse_mm coarse {name}")
                      for dt, name in ((torch.bfloat16, "bf16"),
                                       (torch.float32, "f32"))}
#: launches of the coarse route's masked copy of W (``bigdl_bs_mm_mask``)
LAUNCHES_MM_MASK = LaunchCounter("block_sparse_mm masked W")
#: K9's kernels: the K chunks (bf16; f32, whose x boxes hold 4-byte
#: elements) and N tiles they are built for, largest first
MM_CHUNKS = (64, 32, 16)
MM_SPLIT_CHUNKS = (32, 16)
MM_COL_TILES = (128, 64, 32, 16)
#: the coarse route's largest (KC, BN) tile by dtype: taken where it
#: divides K and N
MM_COARSE_TILE = {torch.bfloat16: (64, 128), torch.float32: (32, 128)}
#: the block route takes blocks whose bk and bn are multiples of this.
#: On an H100 at density 0.5 the coarse route was faster at blocks 16 and
#: 32 in both dtypes (the block route's 16- or 32-column N tiles re-read x
#: from L2 for every one), the block route faster in bf16 at 64 and above,
#: and in f32 neither everywhere there (PERF.md §6)
MM_BLOCK_ROUTE = 64


# --------------------------------------------------------------------------
# BlockMask, the builders and the accounting (numpy copies of the JAX
# module's host side)
# --------------------------------------------------------------------------

class BlockMask:
    """A static boolean grid over (row-block, col-block) tiles plus the
    block sizes it was built at.  Immutable and hashable (the bytes are
    the identity), so the tables built from it can be cached by it."""

    __slots__ = ("mask", "block_q", "block_k", "_key")

    def __init__(self, mask, block_q: int, block_k: int):
        m = np.ascontiguousarray(np.asarray(mask), dtype=bool)
        if m.ndim != 2:
            raise ValueError(f"block mask must be 2-D, got shape {m.shape}")
        m.setflags(write=False)
        self.mask = m
        self.block_q = int(block_q)
        self.block_k = int(block_k)
        self._key = (m.shape, m.tobytes(), self.block_q, self.block_k)

    def __hash__(self):
        return hash(self._key)

    def __eq__(self, other):
        return isinstance(other, BlockMask) and self._key == other._key

    def __repr__(self):
        return (f"BlockMask({self.mask.shape[0]}x{self.mask.shape[1]} "
                f"blocks {self.block_q}x{self.block_k}, "
                f"density {self.density:.3f})")

    @property
    def nnz(self) -> int:
        return int(self.mask.sum())

    @property
    def density(self) -> float:
        """Active fraction of the FULL block grid (the dense basis)."""
        return float(self.mask.mean()) if self.mask.size else 0.0

    def transposed(self) -> "BlockMask":
        return BlockMask(self.mask.T, self.block_k, self.block_q)

    def pruned_causal(self) -> "BlockMask":
        """Drop blocks strictly above the causal diagonal (no element of
        the tile can legally attend), top-left aligned."""
        nq, nk = self.mask.shape
        qi = np.arange(nq)[:, None]
        kj = np.arange(nk)[None, :]
        legal = kj * self.block_k <= qi * self.block_q + self.block_q - 1
        return BlockMask(self.mask & legal, self.block_q, self.block_k)

    def elementwise(self) -> np.ndarray:
        """The mask expanded to element granularity [R, C]."""
        return np.repeat(np.repeat(self.mask, self.block_q, axis=0),
                         self.block_k, axis=1)


def pick_block_divisor(n: int, m: int, target: int) -> int:
    """Largest 8-aligned block <= ``target`` dividing both ``n`` and
    ``m``; falls back to the largest common divisor when nothing
    8-aligned divides."""
    g = math.gcd(int(n), int(m))
    best = None
    for b in range(min(int(target), g), 0, -1):
        if g % b == 0:
            if b % 8 == 0:
                return b
            if best is None:
                best = b
    return best or 1


def sliding_window_mask(nq: int, nk: int, window: int, n_global: int = 0,
                        causal: bool = True, block_q: int = 1,
                        block_k: int = 1) -> BlockMask:
    """Sliding-window + global-token pattern at block granularity: each
    q block attends its own and the previous ``window - 1`` k blocks,
    plus the first ``n_global`` k blocks.  Non-causal windows extend
    both directions."""
    if window < 1:
        raise ValueError(f"window must be >= 1 blocks, got {window}")
    qi = np.arange(nq)[:, None]
    kj = np.arange(nk)[None, :]
    if causal:
        m = (kj <= qi) & (kj > qi - window)
    else:
        m = np.abs(qi - kj) < window
    if n_global:
        g = kj < n_global
        if causal:
            g = g & (kj <= qi)
        m = m | g
    return BlockMask(m, block_q, block_k)


def strided_mask(nq: int, nk: int, stride: int, causal: bool = True,
                 block_q: int = 1, block_k: int = 1) -> BlockMask:
    """Local-diagonal + strided pattern: each q block attends its own k
    block and every ``stride``-th k block."""
    if stride < 1:
        raise ValueError(f"stride must be >= 1, got {stride}")
    qi = np.arange(nq)[:, None]
    kj = np.arange(nk)[None, :]
    m = (qi == kj) | ((kj + 1) % stride == 0)
    if causal:
        m = m & (kj <= qi)
    return BlockMask(m, block_q, block_k)


def magnitude_block_mask(w, block_rows: int, block_cols: int,
                         density: float) -> BlockMask:
    """Keep the top ``density`` fraction of tiles of ``w`` (a 2-D numpy
    array or tensor) by L2 norm; the kept count is exact (top-k)."""
    if not 0.0 < density <= 1.0:
        raise ValueError(f"density must be in (0, 1], got {density}")
    if isinstance(w, torch.Tensor):
        w = w.detach().cpu().double().numpy()
    a = np.asarray(w, dtype=np.float64)
    if a.ndim != 2:
        raise ValueError(f"magnitude mask needs a 2-D array, got "
                         f"shape {a.shape}")
    R, C = a.shape
    if R % block_rows or C % block_cols:
        raise ValueError(
            f"shape {a.shape} not divisible by blocks "
            f"({block_rows}, {block_cols})")
    nr, nc = R // block_rows, C // block_cols
    norms = np.sqrt(
        (a.reshape(nr, block_rows, nc, block_cols) ** 2).sum((1, 3)))
    keep = max(1, int(round(density * nr * nc)))
    mask = np.zeros(nr * nc, dtype=bool)
    mask[np.argsort(-norms.ravel(), kind="stable")[:keep]] = True
    return BlockMask(mask.reshape(nr, nc), block_rows, block_cols)


def _index_tables(mask: np.ndarray):
    """Per-row active column indices, padded to the longest row by
    repeating the last active index, plus per-row counts (the JAX
    kernels' scalar-prefetch tables)."""
    n_rows = mask.shape[0]
    counts = mask.sum(axis=1).astype(np.int32)
    L = max(1, int(counts.max()) if n_rows else 1)
    table = np.zeros((n_rows, L), np.int32)
    for i in range(n_rows):
        act = np.nonzero(mask[i])[0]
        if act.size:
            table[i, :act.size] = act
            table[i, act.size:] = act[-1]
    return table, counts, L


def _runtime_mask(mask: BlockMask, causal: bool) -> BlockMask:
    """The caller's mask with causally dead blocks pruned."""
    return mask.pruned_causal() if causal else mask


def attention_work(mask: BlockMask, batch: int, heads: int, head_dim: int,
                   causal: bool = False, train: bool = False) -> dict:
    """Executed vs dense-equivalent FLOPs of one block-sparse attention
    call, counted at mask-block granularity from ``_index_tables`` (4 ·
    bq · bk · D per block pair, times 3.5 for forward + backward)."""
    m = mask.pruned_causal() if causal else mask
    _, counts, _ = _index_tables(m.mask)
    per_pair = 4.0 * mask.block_q * mask.block_k * head_dim
    factor = 3.5 if train else 1.0
    executed = factor * per_pair * float(counts.sum()) * batch * heads
    dense = factor * per_pair * float(mask.mask.size) * batch * heads
    ones = BlockMask(np.ones_like(mask.mask), mask.block_q,
                     mask.block_k)
    flash_pairs = (ones.pruned_causal().nnz if causal
                   else ones.nnz)
    flash_eq = factor * per_pair * float(flash_pairs) * batch * heads
    return {
        "executed_flops": executed,
        "dense_equivalent_flops": dense,
        "flash_equivalent_flops": flash_eq,
        "sparse_flops_skipped": dense - executed,
        "executed_fraction": executed / dense if dense else 0.0,
        "executed_vs_flash_fraction": (executed / flash_eq
                                       if flash_eq else 0.0),
        "executed_block_pairs": int(counts.sum()),
        "dense_block_pairs": int(mask.mask.size),
    }


def matmul_work(mask: BlockMask, m_rows: int, train: bool = False) -> dict:
    """Executed FLOPs of one block-sparse matmul: 2 · M · bk · bn per
    live weight tile (times 3 for forward + backward)."""
    factor = 3.0 if train else 1.0
    per_tile = 2.0 * m_rows * mask.block_q * mask.block_k
    executed = factor * per_tile * mask.nnz
    dense = factor * per_tile * mask.mask.size
    return {
        "executed_flops": executed,
        "dense_equivalent_flops": dense,
        "sparse_flops_skipped": dense - executed,
        "executed_fraction": executed / dense if dense else 0.0,
    }


# --------------------------------------------------------------------------
# 64-row tile tables (the port's form of the scalar-prefetch tables)
# --------------------------------------------------------------------------

def _keep_sub(run: np.ndarray, bq: int, bk: int, causal: bool, q0: int,
              q1: int, k0: int, k1: int) -> np.ndarray:
    """(q1 - q0, k1 - k0) bool: query q attends key k under the runtime
    block mask ``run`` (AND q >= k under ``causal``)."""
    qs, ks = np.arange(q0, q1), np.arange(k0, k1)
    sub = run[qs // bq][:, ks // bk]
    return sub & (qs[:, None] >= ks[None, :]) if causal else sub


def _tile_tables(mask: BlockMask, causal: bool
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """(visited, partial), both (ceil(T/64), ceil(S/64)) bool: tile pair
    (i, j) is visited iff some query of q tile i may attend some key of
    k tile j (runtime block mask AND, under ``causal``, q >= k), and
    partial iff visited but the block mask does not cover the whole
    pair.  Block counts per pair come from a 2-D prefix sum; only the
    pairs that cross the causal diagonal are checked element by
    element."""
    run = _runtime_mask(mask, causal).mask
    bq, bk = mask.block_q, mask.block_k
    T, S = run.shape[0] * bq, run.shape[1] * bk
    nqt, nkt = -(-T // TILE), -(-S // TILE)
    q_start = np.arange(nqt) * TILE
    k_start = np.arange(nkt) * TILE
    q_last = np.minimum(q_start + TILE, T) - 1
    k_last = np.minimum(k_start + TILE, S) - 1
    qb0, qb1 = q_start // bq, q_last // bq + 1
    kb0, kb1 = k_start // bk, k_last // bk + 1
    pre = np.zeros((run.shape[0] + 1, run.shape[1] + 1), np.int64)
    pre[1:, 1:] = run.astype(np.int64).cumsum(0).cumsum(1)
    live_blocks = (pre[qb1][:, kb1] - pre[qb0][:, kb1]
                   - pre[qb1][:, kb0] + pre[qb0][:, kb0])
    area = (qb1 - qb0)[:, None] * (kb1 - kb0)[None, :]
    visited = live_blocks > 0
    if causal:
        visited &= k_start[None, :] <= q_last[:, None]
        crossing = visited & (k_last[None, :] > q_start[:, None])
        for i, j in zip(*np.nonzero(crossing)):
            visited[i, j] = bool(_keep_sub(run, bq, bk, True, q_start[i],
                                           q_last[i] + 1, k_start[j],
                                           k_last[j] + 1).any())
    return visited, visited & (live_blocks < area)


def _block_lists(visited: np.ndarray, partial: np.ndarray, live,
                 per_block: int = 2) -> dict:
    """The bf16 K6-K8 sweep of each block of ``per_block`` 64-row own
    tiles (2: 128 own rows; 1: K7's 64-row blocks at head dims 192 and
    256), from the tile tables ``visited`` and ``partial`` ((own tiles,
    streamed tiles) bool): the ascending union of its tiles' lists, a flag
    byte per entry (bit w: own tile w visits the streamed tile; bit 2 + w:
    that pair is partial), at an entry with a partial pair the streamed
    rows some row of the block attends (``live(b, j)``, 64 bools, as bits
    of a uint64 held in an int64), the count, and the blocks ordered by
    count, largest first (stable).  Arrays: tiles int32, flags uint8,
    rows int64 (blocks, L); counts, order int32 (blocks,)."""
    n_own, n_other = visited.shape
    nb = -(-n_own // per_block)
    v = np.zeros((per_block * nb, n_other), bool)
    p = np.zeros((per_block * nb, n_other), bool)
    v[:n_own], p[:n_own] = visited, partial
    v = v.reshape(nb, per_block, n_other)
    p = p.reshape(nb, per_block, n_other)
    union = v.any(axis=1)
    counts = union.sum(axis=1).astype(np.int32)
    L = max(1, int(counts.max()) if nb else 1)
    tiles = np.zeros((nb, L), np.int32)
    flags = np.zeros((nb, L), np.uint8)
    rows = np.zeros((nb, L), np.uint64)
    bits = np.left_shift(np.uint64(1), np.arange(64, dtype=np.uint64))
    for b in range(nb):
        idx = np.nonzero(union[b])[0]
        f = np.zeros(idx.size, np.uint8)
        for w in range(per_block):
            f |= (v[b, w, idx].astype(np.uint8) << w) \
                | (p[b, w, idx].astype(np.uint8) << (2 + w))
        tiles[b, :idx.size] = idx
        flags[b, :idx.size] = f
        for e in np.nonzero(f & 12)[0]:
            live_r = live(b, idx[e])
            rows[b, e] = bits[:live_r.size][live_r].sum(dtype=np.uint64)
    order = np.argsort(-counts, kind="stable").astype(np.int32)
    return dict(tiles=tiles, flags=flags, rows=rows.view(np.int64),
                counts=counts, order=order)


def _own_lists(mask: BlockMask, causal: bool, visited: np.ndarray,
               partial: np.ndarray, own_queries: bool, rows: int) -> dict:
    """``_block_lists`` over blocks of ``rows`` own rows (128, or 64):
    own query rows and streamed key tiles (K6, K8), or own key rows and
    streamed query tiles (K7)."""
    run = _runtime_mask(mask, causal).mask
    bq, bk = mask.block_q, mask.block_k
    T, S = run.shape[0] * bq, run.shape[1] * bk

    def live_keys(b, j):    # keys of tile j some query of block b attends
        return _keep_sub(run, bq, bk, causal, b * rows,
                         min((b + 1) * rows, T), j * TILE,
                         min((j + 1) * TILE, S)).any(axis=0)

    def live_queries(b, j):   # queries of tile j that attend a key of block b
        return _keep_sub(run, bq, bk, causal, j * TILE, min((j + 1) * TILE, T),
                         b * rows, min((b + 1) * rows, S)).any(axis=1)

    if own_queries:
        return _block_lists(visited, partial, live_keys, rows // TILE)
    return _block_lists(visited.T, partial.T, live_queries, rows // TILE)


def _block_tables(mask: BlockMask, causal: bool, visited: np.ndarray,
                  partial: np.ndarray):
    """``_block_lists`` of 128-row blocks for K6 and K8 (own query
    blocks, streamed key tiles) and for K7 (own key blocks, streamed
    query tiles)."""
    return (_own_lists(mask, causal, visited, partial, True, BLOCK_ROWS),
            _own_lists(mask, causal, visited, partial, False, BLOCK_ROWS))


class _LRU(OrderedDict):
    """A small least-recently-used cache of device tables."""

    def __init__(self, size: int = 64):
        super().__init__()
        self.size = size

    def get_or_make(self, key, make):
        if key in self:
            self.move_to_end(key)
            return self[key]
        value = self[key] = make()
        while len(self) > self.size:
            self.popitem(last=False)
        return value


_ATTN_TABLES = _LRU()
_MM_TABLES = _LRU()
_KEEP = _LRU(8)   # (T, S) element masks of the plain version


def _to_device(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _attention_tables(mask: BlockMask, causal: bool, device):
    """The kernels' tables on ``device``, built once per (mask, causal,
    device): the 128-row block lists of K6 in both dtypes and of the bf16
    K8 (``dq_blocks``) and of the bf16 K7 (``dkv_blocks``), the 64-row
    block lists of K8 (``dq_tiles``) and K7 (``dkv_tiles``) at bf16 head
    dims 192 and 256, above 256 and in f32, and the runtime block mask
    (uint8) for partial pairs."""
    def make():
        visited, partial = _tile_tables(mask, causal)
        dq_blocks, dkv_blocks = _block_tables(mask, causal, visited, partial)
        dq_tiles = _own_lists(mask, causal, visited, partial, True, TILE)
        dkv_tiles = _own_lists(mask, causal, visited, partial, False, TILE)
        run = _runtime_mask(mask, causal).mask.astype(np.uint8)
        lists = dict(dq_blocks=dq_blocks, dkv_blocks=dkv_blocks,
                     dq_tiles=dq_tiles, dkv_tiles=dkv_tiles)
        return dict(**{k: {n: _to_device(a, device) for n, a in t.items()}
                       for k, t in lists.items()},
                    block_mask=_to_device(run, device),
                    visited=int(visited.sum()), partial=int(partial.sum()))

    return _ATTN_TABLES.get_or_make((mask, bool(causal), device), make)


def tile_work(mask: BlockMask, causal: bool) -> dict:
    """How many 64-row tile pairs the attention kernels visit, how many
    of those the mask covers only in part, and how many a flash sweep
    of the same (T, S) visits."""
    visited, partial = _tile_tables(mask, causal)
    ones = BlockMask(np.ones_like(mask.mask), mask.block_q, mask.block_k)
    flash, _ = _tile_tables(ones, causal)
    return dict(visited=int(visited.sum()), partial=int(partial.sum()),
                flash=int(flash.sum()))


# --------------------------------------------------------------------------
# Block-sparse attention: plain versions, kernels, autograd
# --------------------------------------------------------------------------

def _elementwise_keep(mask: BlockMask, causal: bool, device) -> torch.Tensor:
    """(T, S) bool: the runtime block mask at element granularity, AND
    the top-left causal mask under ``causal``; built once per (mask,
    causal, device), so a call captured in a CUDA graph uploads
    nothing.  Read-only."""
    def make():
        keep = _to_device(_runtime_mask(mask, causal).elementwise(), device)
        if causal:
            keep &= _causal_keep(keep.shape[0], keep.shape[1], device)
        return keep

    return _KEEP.get_or_make((mask, bool(causal), torch.device(device)),
                             make)


def _select_live(keep, q, k, v, d_o=None):
    """q (and dO) rows that attend no key and k/v rows that no query
    attends, replaced by zeros with a select: a dead row's values (NaN
    included) never reach a product, as the kernels never load them."""
    q_live = keep.any(dim=1)[:, None]
    k_live = keep.any(dim=0)[:, None]
    zero = torch.zeros((), dtype=q.dtype, device=q.device)
    out = [torch.where(q_live, q, zero), torch.where(k_live, k, zero),
           torch.where(k_live, v, zero)]
    if d_o is not None:
        out.append(torch.where(q_live, d_o, torch.zeros((), dtype=d_o.dtype,
                                                        device=d_o.device)))
    return out


def _bs_attention_plain(q, k, v, mask: BlockMask, causal: bool,
                        sm_scale: float
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6's math over whole rows: ``_flash_plain``'s rounding points
    under the elementwise runtime mask.  A row with no live key gets
    O = 0 and LSE = 1e30.  Returns (O in q's dtype, LSE (B*H, 1, T))."""
    keep = _elementwise_keep(mask, causal, q.device)
    q, k, v = _select_live(keep, q, k, v)
    return _attn_plain(q, k, v, keep, sm_scale)


def _bs_bwd_plain(q, k, v, o, lse, d_o, mask: BlockMask, causal: bool,
                  sm_scale: float
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K7 and K8's math over whole rows: ``_flash_bwd_plain`` under the
    elementwise runtime mask.  Dead query rows get dQ = 0, dead key rows
    dK = dV = 0."""
    keep = _elementwise_keep(mask, causal, q.device)
    q, k, v, d_o = _select_live(keep, q, k, v, d_o)
    return _attn_bwd_plain(q, k, v, o, lse, d_o, keep, sm_scale)


def _attn_fn(name: str, n_ptr: int):
    return _c_fn("block_sparse", name, [_P] * n_ptr + [_I] * 4 + [_P]
                 + [_I] * 7 + [_F, _I, _P])


#: the ``_attention_tables`` entry K6 sweeps: it owns 128 query rows at
#: every head dim, in both dtypes, and sweeps what the bf16 K8 sweeps at
#: D 128
_FWD_TABLES = "dq_blocks"


def _query_tables(dtype: torch.dtype, D: int) -> str:
    """The ``_attention_tables`` entry that K8 sweeps (own query rows,
    streamed key tiles): in bf16 the 128-row block lists, or the 64-row
    ones of its 64-row blocks at head dims above 128; in f32 the 64-row
    ones at every head dim (its blocks own 64 query rows)."""
    return ("dq_blocks" if dtype == torch.bfloat16 and D <= 128
            else "dq_tiles")


def _key_tables(dtype: torch.dtype, D: int) -> str:
    """The ``_attention_tables`` entry that K7 sweeps (own key rows,
    streamed query tiles): in bf16 the 128-row block lists, or the 64-row
    ones of its 64-row blocks at head dims above 128; in f32 the 64-row
    ones at every head dim (its blocks own 64 key rows)."""
    return ("dkv_blocks" if dtype == torch.bfloat16 and D <= 128
            else "dkv_tiles")


def _table_args(tab, which: str, mask: BlockMask, q, k, operands):
    """The arguments of a launch after its tensors' pointers: the block
    lists ``which`` names (tiles, counts, flags), the block mask, the
    lists' order and rows, L, the mask's shape, the operands' strides,
    then the problem's ints."""
    t = tab[which]
    tiles = t["tiles"]
    B, H, T, D = q.shape
    return [tiles.data_ptr(), t["counts"].data_ptr(), t["flags"].data_ptr(),
            tab["block_mask"].data_ptr(), t["order"].data_ptr(),
            t["rows"].data_ptr(), tiles.shape[1],
            mask.mask.shape[1], mask.block_q, mask.block_k,
            _strides_arg(*operands), H, FIRST_HEAD, HEADS, T, k.shape[2], D,
            _DTYPE_CODE[q.dtype]]


def _bs_fwd_cuda(q, k, v, mask: BlockMask, causal: bool, sm_scale: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K6 on the current stream of q's device (a head dim between
    the built ones zero-padded, above 256 padded to a multiple of 64 for
    the chunked forward; O cut back).  q, k and v are read at their
    strides through TMA in both dtypes (copied where TMA cannot read
    them)."""
    _check_kernel_inputs("block_sparse_attention", q, k, v)
    tab = _attention_tables(mask, causal, q.device)
    D_true = q.shape[-1]
    Dp = _fwd_head_dim(D_true)
    q, k, v = _kernel_operands(*(_pad_head_dim(t, Dp) for t in (q, k, v)))
    B, H, T, D = q.shape
    o = _empty(q)
    lse = _empty(q, (B * H, 1, T), torch.float32)
    _launch_heads("block_sparse_fwd",
                  (LAUNCHES, *_f32_counter(LAUNCHES_F32, q),
                   *_chunked_counter(LAUNCHES_CHUNKED, q)),
                  _attn_fn("bigdl_bs_fwd", 11),
                  [*(t.data_ptr() for t in (q, k, v, o, lse)),
                   *_table_args(tab, _FWD_TABLES, mask, q, k, (q, k, v)),
                   float(sm_scale), int(bool(causal))], B * H, q.device)
    return _cut_head_dim(o, D_true), lse


def _launch_bs_dkv(q, k, v, do, lse, delta, mask: BlockMask, causal: bool,
                   sm_scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K7 over prepared inputs (dO in q's dtype, delta (B*H, T)
    f32; at any head dim and read as ``_launch_dkv`` reads them, through
    TMA in both dtypes).  Every k tile writes its rows, zeros where no
    query reads."""
    tab = _attention_tables(mask, causal, q.device)
    B, H, T, D = q.shape
    q, k, v, do = _bwd_operands(q, k, v, do)
    dk, dv = _empty(k), _empty(v)
    _launch_heads("block_sparse_bwd_dkv",
                  (LAUNCHES_DKV, *_f32_counter(LAUNCHES_DKV_F32, q),
                   *_chunked_counter(LAUNCHES_DKV_CHUNKED, q)),
                  _attn_fn("bigdl_bs_bwd_dkv", 14),
                  [*(t.data_ptr() for t in (q, k, v, do, lse, delta, dk, dv)),
                   *_table_args(tab, _key_tables(q.dtype, q.shape[-1]), mask,
                                q, k, (q, k, v, do)),
                   float(sm_scale), int(bool(causal))], B * H, q.device)
    return _cut_head_dim(dk, D), _cut_head_dim(dv, D)


def _launch_bs_dq(q, k, v, do, lse, delta, mask: BlockMask, causal: bool,
                  sm_scale: float) -> torch.Tensor:
    """Launch K8 over the same prepared inputs as ``_launch_bs_dkv``,
    read as it reads them."""
    tab = _attention_tables(mask, causal, q.device)
    B, H, T, D = q.shape
    q, k, v, do = _bwd_operands(q, k, v, do)
    dq = _empty(q)
    _launch_heads("block_sparse_bwd_dq",
                  (LAUNCHES_DQ, *_f32_counter(LAUNCHES_DQ_F32, q),
                   *_chunked_counter(LAUNCHES_DQ_CHUNKED, q)),
                  _attn_fn("bigdl_bs_bwd_dq", 13),
                  [*(t.data_ptr() for t in (q, k, v, do, lse, delta, dq)),
                   *_table_args(tab, _query_tables(q.dtype, q.shape[-1]),
                                mask, q, k, (q, k, v, do)),
                   float(sm_scale), int(bool(causal))], B * H, q.device)
    return _cut_head_dim(dq, D)


def _bs_bwd_cuda(q, k, v, o, lse, d_o, mask: BlockMask, causal: bool,
                 sm_scale: float
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch K7 then K8 on the current stream of q's device (a head dim
    between the built ones zero-padded, above them padded to a multiple
    of 64 for the chunked backward, the gradients cut back)."""
    _check_kernel_inputs("block_sparse_attention backward", q, k, v)
    _check_lse("block_sparse_attention backward", lse)
    do, delta = _bwd_inputs(q, o, d_o)
    D = q.shape[-1]
    Dp = _bwd_head_dim(D)
    q, k, v, do = (_pad_head_dim(t, Dp) for t in (q, k, v, do))
    dk, dv = _launch_bs_dkv(q, k, v, do, lse, delta, mask, causal, sm_scale)
    dq = _launch_bs_dq(q, k, v, do, lse, delta, mask, causal, sm_scale)
    return tuple(_cut_head_dim(t, D) for t in (dq, dk, dv))


class _BlockSparseAttention(torch.autograd.Function):
    """The ``custom_vjp`` of the TPU ``_bs_attn``: (O, LSE) forward, the
    FlashAttention-2 backward over the same tables from the saved
    (q, k, v, o, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, mask: BlockMask, causal: bool,
                sm_scale: float):
        # the dense products of the masked plain math, and beside them
        # the executed and dense-equivalent FLOPs of attention_work
        work = attention_work(mask, q.shape[0], q.shape[1], q.shape[3],
                              causal)
        with kernel_work(attention_products(q, k), fwd_bytes(q, k, v),
                         sparse=(work["executed_flops"],
                                 work["dense_equivalent_flops"])):
            if on_cpu(q, k, v):
                o, lse = _bs_attention_plain(q, k, v, mask, causal,
                                             sm_scale)
            else:
                o, lse = _bs_fwd_cuda(q, k, v, mask, causal, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask, ctx.causal, ctx.sm_scale = mask, causal, sm_scale
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, d_o, _d_lse):
        q, k, v, o, lse = ctx.saved_tensors
        bwd = _bs_bwd_plain if on_cpu(q, k, v, d_o) else _bs_bwd_cuda
        # attention_work's training count less its forward's
        args = (ctx.mask, q.shape[0], q.shape[1], q.shape[3], ctx.causal)
        fwd, both = attention_work(*args), attention_work(*args, train=True)
        with kernel_work(2 * attention_products(q, k),
                         nbytes(q, k, v, o, lse, d_o, q, k, v),
                         sparse=tuple(both[key] - fwd[key] for key in (
                             "executed_flops", "dense_equivalent_flops"))):
            dq, dk, dv = bwd(q, k, v, o, lse, d_o, ctx.mask, ctx.causal,
                             ctx.sm_scale)
        return dq, dk, dv, None, None, None


def _as_block_mask(block_mask, rows: int, cols: int, what: str) -> BlockMask:
    """A BlockMask from ``block_mask`` (or a raw 2-D bool array, its
    block sizes inferred), checked to tile (rows, cols)."""
    if not isinstance(block_mask, BlockMask):
        m = np.asarray(block_mask)
        if m.ndim != 2:
            raise ValueError(f"block mask must be 2-D, got shape {m.shape}")
        if rows % m.shape[0] or cols % m.shape[1]:
            raise ValueError(f"{what} ({rows}, {cols}) not divisible by "
                             f"mask grid {m.shape}")
        block_mask = BlockMask(m, rows // m.shape[0], cols // m.shape[1])
    nr, nc = block_mask.mask.shape
    if nr * block_mask.block_q != rows or nc * block_mask.block_k != cols:
        raise ValueError(
            f"mask grid {block_mask.mask.shape} x blocks "
            f"({block_mask.block_q}, {block_mask.block_k}) does not "
            f"tile {what} ({rows}, {cols})")
    return block_mask


def block_sparse_attention(q, k, v, block_mask, causal: bool = False,
                           sm_scale: Optional[float] = None) -> torch.Tensor:
    """Attention over (B, H, T, D) tensors computing only the pairs the
    block mask allows: on the card, a dead tile is never loaded and
    never multiplied.  ``block_mask`` is a :class:`BlockMask` or a raw
    [nq, nk] bool array (block sizes T // nq, S // nk).  ``causal``
    also applies the top-left causal mask; an all-ones causal mask runs
    the flash kernels' sweep.  Differentiable in q, k and v."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("block_sparse_attention takes (B, H, T, D) tensors")
    if k.shape != v.shape or k.shape[:2] != q.shape[:2] \
            or k.shape[3] != q.shape[3]:
        raise ValueError(f"block_sparse_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if q.shape[2] == 0 or k.shape[2] == 0:
        raise ValueError("block_sparse_attention: empty sequence")
    mask = _as_block_mask(block_mask, q.shape[2], k.shape[2], "seq lens")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    return _BlockSparseAttention.apply(q, k, v, mask, bool(causal),
                                       float(sm_scale))[0]


# --------------------------------------------------------------------------
# Block-sparse matmul (the BLaST sparse-MLP kernel)
# --------------------------------------------------------------------------

def _elementwise_weight_mask(mask: BlockMask, device) -> torch.Tensor:
    return _MM_TABLES.get_or_make(
        ("elementwise", mask, device),
        lambda: _to_device(mask.elementwise(), device))


def _bs_mm_plain(x2, w, mask: BlockMask) -> torch.Tensor:
    """K9's math: x @ (W ∘ mask) in f32, the mask applied with a select
    (a dead tile's NaN never reaches the product), cast to x's dtype."""
    live = _elementwise_weight_mask(mask, w.device)
    wm = torch.where(live, w.float(), torch.zeros((), device=w.device))
    return torch.matmul(x2.float(), wm).to(x2.dtype)


class MmPlan(NamedTuple):
    """K9's route for one call: K chunks of ``kc`` columns and N tiles of
    ``bn`` columns.  ``coarse`` False: the block route, over the mask's own
    blocks (kc divides bk, bn divides the mask's bn); True: the coarse
    route, over coarse (kc, bn) tiles of a masked copy of W."""
    kc: int
    bn: int
    coarse: bool = False


def _mm_plan(dtype: torch.dtype, bk: int, bn: int, K: int, N: int) -> MmPlan:
    """K9's route for W (K, N) in (bk, bn) blocks, chosen by shape before
    the launch: the block route (``_block_plan``) for blocks whose bk and
    bn are multiples of ``MM_BLOCK_ROUTE``, the coarse route
    (``_coarse_plan``) for every other block.  The rule is symmetric, so
    the forward and dX (blocks (bn, bk)) take one route."""
    if bk % MM_BLOCK_ROUTE == 0 and bn % MM_BLOCK_ROUTE == 0:
        return _block_plan(dtype, bk, bn)
    return _coarse_plan(dtype, K, N)


def _block_plan(dtype: torch.dtype, bk: int, bn: int) -> Optional[MmPlan]:
    """The block route's plan for (bk, bn) blocks, which it can take
    wherever bk and bn are multiples of 16 (else None): KC the largest of
    ``MM_CHUNKS`` (bf16) or
    ``MM_SPLIT_CHUNKS`` (f32, on split products) dividing bk, so a K chunk
    never reaches into a dead block, BN the largest of ``MM_COL_TILES``
    dividing bn, so an N tile reads one column block's list."""
    if bk % 16 or bn % 16:
        return None
    chunks = MM_CHUNKS if dtype == torch.bfloat16 else MM_SPLIT_CHUNKS
    return MmPlan(next(c for c in chunks if bk % c == 0),
                  next(c for c in MM_COL_TILES if bn % c == 0))


def _coarse_plan(dtype: torch.dtype, K: int, N: int) -> MmPlan:
    """The coarse route's tile for W (K, N) in ``dtype``: KC the largest
    chunk up to ``MM_COARSE_TILE``'s that divides K, BN the largest column
    tile up to its BN that divides N; where none divides (K or N not a
    multiple of 16), the smallest that covers it, or the largest, and the
    masked copy of W is padded with zeros to whole tiles."""
    kc0, bn0 = MM_COARSE_TILE[dtype]
    chunks = MM_CHUNKS if dtype == torch.bfloat16 else MM_SPLIT_CHUNKS

    def pick(n, sizes, most):
        sizes = [s for s in sizes if s <= most]
        return next((s for s in sizes if n % s == 0), None) or min(
            (s for s in sizes if s >= n), default=sizes[0])

    return MmPlan(pick(K, chunks, kc0), pick(N, MM_COL_TILES, bn0), True)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _row_pitch(t: torch.Tensor) -> Optional[int]:
    """The distance in elements between the rows of 2-D ``t`` when each
    row is contiguous and no two overlap, else None."""
    R, C = t.shape
    if C > 1 and t.stride(1) != 1:
        return None
    if R == 1:
        return C
    return t.stride(0) if t.stride(0) >= C else None


def _tma_readable(t: torch.Tensor, ld: Optional[int]) -> bool:
    """Whether TMA reads 2-D ``t`` at row pitch ``ld`` in place: rows
    contiguous, the pitch a multiple of 16 bytes, the start 16-byte
    aligned."""
    return ld is not None and ld * t.element_size() % 16 == 0 \
        and t.data_ptr() % 16 == 0


def _tma_rows(t: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """2-D ``t`` and its row pitch as TMA reads it: ``t`` itself where
    ``_tma_readable``, else a copy whose rows lie a multiple of 16 bytes
    apart (a view of the first t.shape[1] columns of a padded tensor)."""
    ld = _row_pitch(t)
    if _tma_readable(t, ld):
        return t, ld
    R, C = t.shape
    ld = _round_up(C, 16 // t.element_size())
    rows = torch.empty((R, ld), dtype=t.dtype, device=t.device)
    rows[:, :C].copy_(t)
    return rows[:, :C], ld


def _mm_pieces(w: torch.Tensor) -> torch.Tensor:
    """The f32 block route's B operand: the three bf16 pieces of the f32
    2-D ``w`` (any strides), p1 = bf16(w), p2 = bf16(w − p1), p3 = bf16(w −
    p1 − p2), each rounded to nearest even (the differences are exact in
    f32), as one contiguous (3, *w.shape) tensor: each piece keeps w's
    orientation.  p1 + p2 + p3 = w exactly (for |w| above 2^-102); NaN
    stays NaN in every piece."""
    pieces = torch.empty((3, *w.shape), dtype=torch.bfloat16,
                         device=w.device)
    split_bf16x3(w, pieces)
    return pieces


def _mm_operands(x2, b):
    """x2 (M, K) and the B operand b (K, N) as the block route reads them:
    (x, ldx, w, ldw, kmajor).  Each is read in place where TMA takes its
    rows (``_tma_rows``: else x is copied): b MN-major as it stands (the
    forward's W), or K-major through bᵀ's rows (dX's Wᵀ, W as it stands; a
    weight stored (out, in) and viewed ``.t()``); a b with neither dim
    contiguous is copied.  In f32 w is b's three bf16 pieces
    (``_mm_pieces``) in the orientation b's storage has, so nothing is
    transposed."""
    split = x2.dtype == torch.float32
    x2, ldx = _tma_rows(x2)
    for w, kmajor in ((b, 0), (b.t(), 1)):
        ldw = _row_pitch(w)
        if split and ldw is not None:
            w = _mm_pieces(w)
            return x2, ldx, w, w.shape[2], kmajor
        if not split and _tma_readable(w, ldw):
            return x2, ldx, w, ldw, kmajor
    if split:
        return x2, ldx, _mm_pieces(b), b.shape[1], 0
    return x2, ldx, b.clone(memory_format=torch.contiguous_format), \
        b.shape[1], 0


def _coarse_grid(mask: BlockMask, kc: int, bn: int) -> np.ndarray:
    """(ceil(K / kc), ceil(N / bn)) bool over the coarse tiles of W (K, N):
    whether each holds a live element of ``mask`` (the OR of the
    elementwise mask over the tile; tiles need not line up with the
    mask's blocks, and the last ones reach past K and N)."""
    def spans(n_blocks, block, tile):   # each tile's first and last block
        start = np.arange(0, n_blocks * block, tile)
        return (start // block,
                (np.minimum(start + tile, n_blocks * block) - 1) // block)

    def any_over(a, first, last, axis):   # OR over blocks first..last
        c = np.cumsum(a, axis=axis, dtype=np.int64)
        c = np.concatenate([np.zeros_like(np.take(c, [0], axis=axis)), c],
                           axis=axis)
        return np.take(c, last + 1, axis=axis) \
            - np.take(c, first, axis=axis) > 0

    g = any_over(mask.mask, *spans(mask.mask.shape[0], mask.block_q, kc), 0)
    return any_over(g, *spans(mask.mask.shape[1], mask.block_k, bn), 1)


def _mm_tables(mask: BlockMask, plan: MmPlan, device):
    """(tiles, counts) on the card for K9 on ``plan``: for each column
    block (block route) or BN-column tile (coarse route), its live K
    blocks or KC-row chunks, as ``_index_tables`` lists them; cached per
    (mask, plan, device)."""
    def make():
        grid = _coarse_grid(mask, plan.kc, plan.bn) if plan.coarse \
            else mask.mask
        return tuple(_to_device(a, device)
                     for a in _index_tables(grid.T)[:2])

    return _MM_TABLES.get_or_make(
        ("tables", mask, plan if plan.coarse else None, device), make)


def _mm_mask_call(ptrs, ints, strides, device):
    """``bigdl_bs_mm_mask`` on the current stream of ``device``; raises on
    a launch error."""
    _call("block_sparse_mm_mask",
          _c_fn("block_sparse", "bigdl_bs_mm_mask",
                [_P] * 3 + [_I] * 2 + [ctypes.c_longlong] * 2 + [_I] * 6
                + [_P]),
          [*ptrs, *ints[:2], *strides, *ints[2:]], device)


def _mm_masked_plain(stored: torch.Tensor, mask: BlockMask,
                     dst: torch.Tensor) -> None:
    """``bigdl_bs_mm_mask``'s math: ``stored`` (R, C) with its dead
    elements under ``mask`` selected to 0 into the top-left (R, C) corner
    of ``dst`` (P, Rp, Cp) bf16, zeros elsewhere; in bf16 (P 1) the
    elements, in f32 (P 3) their three bf16 pieces (``split_bf16x3``)."""
    R, C = stored.shape
    live = _elementwise_weight_mask(mask, stored.device)
    kept = torch.where(live, stored, torch.zeros((), dtype=stored.dtype,
                                                 device=stored.device))
    dst.zero_()
    if dst.shape[0] == 3:
        split_bf16x3(kept, dst[:, :R, :C])
    else:
        dst[0, :R, :C] = kept


def _mm_masked(b: torch.Tensor, mask: BlockMask, plan: MmPlan):
    """The coarse route's B operand for b (K, N) under ``mask``: (w, ldw,
    kmajor), w a fresh masked copy of b, padded with zeros to whole
    coarse tiles (K and N rounded up to ``plan``'s kc and bn), its dead
    elements selected to 0 (a select: NaN or inf in a dead block never
    reaches the product), in the orientation of b's storage: MN-major
    (Kp, Np) for b as it stands, K-major (Np, Kp) where bᵀ's rows are the
    contiguous ones (dX's Wᵀ, a weight stored (out, in) viewed ``.t()``),
    so nothing is transposed.  In bf16 w is the bf16 copy; in f32 its
    three bf16 pieces, (3, rows, ldw), written in the same pass.  On the
    card ``bigdl_bs_mm_mask`` writes it; on the CPU its plain version."""
    kmajor = int(b.stride(0) < b.stride(1))
    stored, smask = (b.t(), mask.transposed()) if kmajor else (b, mask)
    K, N = b.shape
    Kp, Np = _round_up(K, plan.kc), _round_up(N, plan.bn)
    rows, cols = (Np, Kp) if kmajor else (Kp, Np)
    split = b.dtype == torch.float32
    dst = torch.empty((3 if split else 1, rows, cols), dtype=torch.bfloat16,
                      device=b.device)
    if on_cpu(b):
        _mm_masked_plain(stored, smask, dst)
    else:
        grid = _MM_TABLES.get_or_make(
            ("grid", smask, b.device),
            lambda: _to_device(smask.mask.astype(np.uint8), b.device))
        _mm_mask_call([stored.data_ptr(), dst.data_ptr(), grid.data_ptr()],
                      [*stored.shape, rows, cols, smask.block_q,
                       smask.block_k, smask.mask.shape[1],
                       _DTYPE_CODE[b.dtype]], stored.stride(), b.device)
        LAUNCHES_MM_MASK.add()
    return (dst if split else dst[0]), cols, kmajor


def _mm_call(ptrs, ints, device):
    """``bigdl_bs_mm`` on the current stream of ``device``; raises on a
    launch error."""
    _call("block_sparse_mm",
          _c_fn("block_sparse", "bigdl_bs_mm", [_P] * 5 + [_I] * 15 + [_P]),
          [*ptrs, *ints], device)


def _bs_mm_cuda(x2, b, mask: BlockMask) -> torch.Tensor:
    """Launch K9 on the current stream of x's device: x2 (M, K) @ b (K, N)
    over b's live blocks (``mask``), on the route ``_mm_plan`` picks.  b
    is the forward's W or dX's Wᵀ, read in place on the block route where
    its layout allows."""
    if x2.dtype not in _DTYPE_CODE:
        raise TypeError(f"block_sparse_matmul: dtype {x2.dtype} not in "
                        f"{tuple(_DTYPE_CODE)}")
    return _launch_mm(x2, b, mask, _mm_plan(x2.dtype, mask.block_q,
                                            mask.block_k, *b.shape))


def _launch_mm(x2, b, mask: BlockMask, plan: MmPlan) -> torch.Tensor:
    """K9 on route ``plan``.  A B operand of another dtype than x is cast
    to x's (the output is in x's dtype, as the plain version's).  On the
    coarse route the masked copy of b, and in f32 on the block route the
    split of b into its bf16 pieces, is part of the call.  The output is
    (M, N), contiguous: where its rows must be padded (the f32 epilogue
    writes whole N tiles; the bf16 TMA store needs rows of a multiple of
    16 bytes), it is written padded and copied out."""
    if x2.dtype not in _DTYPE_CODE:
        raise TypeError(f"block_sparse_matmul: dtype {x2.dtype} not in "
                        f"{tuple(_DTYPE_CODE)}")
    M, K = x2.shape
    N = b.shape[1]
    if M == 0:
        raise ValueError("block_sparse_matmul: x has no rows")
    b = b.to(x2.dtype)
    if plan.coarse:
        x2, ldx = _tma_rows(x2)
        w, ldw, kmajor = _mm_masked(b, mask, plan)
        Kp, Np, bk, bn = (_round_up(K, plan.kc), _round_up(N, plan.bn),
                          plan.kc, plan.bn)
    else:
        x2, ldx, w, ldw, kmajor = _mm_operands(x2, b)
        Kp, Np, bk, bn = K, N, mask.block_q, mask.block_k
    tiles, counts = _mm_tables(mask, plan, x2.device)
    split = x2.dtype == torch.float32
    ldo = Np if split else _round_up(N, 8)
    out = torch.empty((M, ldo), dtype=x2.dtype, device=x2.device)
    _mm_call([x2.data_ptr(), w.data_ptr(), out.data_ptr(), tiles.data_ptr(),
              counts.data_ptr()],
             [tiles.shape[1], M, Kp, Np, bk, bn, ldx, ldw, kmajor, plan.kc,
              plan.bn, K, N, ldo, _DTYPE_CODE[x2.dtype]], x2.device)
    LAUNCHES_MM.add()
    if plan.coarse:
        LAUNCHES_MM_COARSE[x2.dtype].add()
    elif split:
        LAUNCHES_MM_F32.add()
    return out if ldo == N else out[:, :N].contiguous()


def _mm_work(a, w, mask: BlockMask, K: int, N: int, out_like=None
             ) -> kernel_work:
    """K9's work report for ``a`` [M, K] times the masked W: the dense
    product 2·M·K·N, the bytes of a, W and the [M, N] result (in
    ``out_like``'s dtype, else a's), and matmul_work's executed and
    dense-equivalent FLOPs."""
    M = a.shape[0]
    work = matmul_work(mask, M)
    size = (out_like if out_like is not None else a).element_size()
    return kernel_work(2.0 * M * K * N, nbytes(a, w) + M * N * size,
                       sparse=(work["executed_flops"],
                               work["dense_equivalent_flops"]))


class _BlockSparseMatmul(torch.autograd.Function):
    """The ``custom_vjp`` of the TPU ``_bs_mm``: dX is K9 again on
    (g, Wᵀ, mask.T), Wᵀ a view that K9 reads in place; dW = (x2ᵀ · g) ∘
    mask is one dense product outside the kernels, as the JAX package
    leaves it to XLA."""

    @staticmethod
    def forward(ctx, x2, w, mask: BlockMask):
        mm = _bs_mm_plain if on_cpu(x2, w) else _bs_mm_cuda
        ctx.save_for_backward(x2, w)
        ctx.mask = mask
        with _mm_work(x2, w, mask, x2.shape[1], w.shape[1]):
            return mm(x2, w, mask)

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        mask = ctx.mask
        dx = dw = None
        if ctx.needs_input_grad[0]:
            mm = _bs_mm_plain if on_cpu(x2, w, g) else _bs_mm_cuda
            with _mm_work(g, w, mask, w.shape[1], w.shape[0], x2):
                dx = mm(g, w.t().to(g.dtype), mask.transposed()).to(
                    x2.dtype)
        if ctx.needs_input_grad[1]:
            live = _elementwise_weight_mask(mask, w.device)
            dw = torch.matmul(x2.t(), g.to(x2.dtype))
            dw = torch.where(live, dw, torch.zeros((), dtype=dw.dtype,
                                                   device=dw.device))
            dw = dw.to(w.dtype)
        return dx, dw, None


def block_sparse_matmul(x, w, block_mask) -> torch.Tensor:
    """``x @ w`` where ``w`` [K, N] carries a static :class:`BlockMask`
    (or a raw bool array) over its (K-block, N-block) tiles: masked
    tiles are structural zeros, never read on the card.  ``x`` may carry
    leading batch dims ([..., K]); returns [..., N].  Any layout: on the
    card a strided x or w (a column slice, a ``.t()`` view of a weight
    stored (N, K)) is read in place where its rows are contiguous."""
    if w.dim() != 2:
        raise ValueError(f"block_sparse_matmul: w must be 2-D, got "
                         f"{tuple(w.shape)}")
    K, N = w.shape
    mask = _as_block_mask(block_mask, K, N, "weight shape")
    if x.shape[-1] != K:
        raise ValueError(f"block_sparse_matmul: x {tuple(x.shape)} does not "
                         f"match w {tuple(w.shape)}")
    lead = x.shape[:-1]
    y = _BlockSparseMatmul.apply(x.reshape(-1, K), w, mask)
    return y.reshape(*lead, N)
