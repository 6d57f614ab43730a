"""MultiHeadAttention and rotary embedding (counterpart of
``bigdl_tpu/nn/attention.py``).  The ``dense``, ``flash``, ``block``
and ``blocksparse`` strategies are ported; ``ring`` and ``ulysses`` come
with the distributed slice and raise."""
from __future__ import annotations

from typing import Optional

import torch

from ..device import DeviceLike
from ..ops.block_sparse import (block_sparse_attention, pick_block_divisor,
                                sliding_window_mask, strided_mask)
from ..ops.flash_attention import flash_attention
from ..parallel.ring_attention import attention, blockwise_attention
from .initialization import IN_OUT, ONE_D, Xavier, Zeros
from .module import TensorModule

#: the JAX layer's strategies, and those ported so far
SEQ_STRATEGIES = ("dense", "flash", "block", "ring", "ulysses",
                  "blocksparse")
PORTED_STRATEGIES = ("dense", "flash", "block", "blocksparse")

#: block-sparse mask patterns the layer can build (ops/block_sparse.py)
SPARSE_PATTERNS = ("sliding", "strided")


def rope_rotate(x, pos, theta: float = 10000.0):
    """Rotary position embedding (HF Llama's rotate-half convention)
    over ``x`` [B, H, T, D] at absolute positions ``pos`` [T]; the
    tables in at-least-f32, cast to x's dtype for the product."""
    D = x.shape[-1]
    ct = torch.promote_types(x.dtype, torch.float32)
    inv = 1.0 / (theta ** (torch.arange(0, D, 2, dtype=ct,
                                        device=x.device) / D))
    ang = pos.to(ct)[:, None] * inv[None, :]                 # [T, D/2]
    cos = torch.cat([torch.cos(ang), torch.cos(ang)], -1)    # [T, D]
    sin = torch.cat([torch.sin(ang), torch.sin(ang)], -1)
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    rot = torch.cat([-x2, x1], -1)
    return x * cos.to(x.dtype) + rot * sin.to(x.dtype)


def proj(x, params, w: str, b: str, with_bias: bool):
    """x W^T (+ b) by parameter name — the JAX ``jnp.dot`` projection,
    shared with the cached decode path."""
    y = torch.matmul(x, params[w].t())
    return y + params[b] if with_bias else y


class MultiHeadAttention(TensorModule):
    """Multi-head self-attention over [batch, seq, embed]; ``flash``
    runs kernel K1 forward and K2/K3 backward
    (``ops/flash_attention.py``), ``block`` the online softmax over K/V
    blocks of ``block_size`` in plain PyTorch
    (``parallel/ring_attention.py::blockwise_attention``, no kernel, as
    the JAX strategy), ``blocksparse`` K6 forward and K7/K8
    backward (``ops/block_sparse.py``) over a static block mask built
    from ``sparse_pattern`` at ``sparse_block`` granularity (default
    ``block_size``): ``"sliding"`` = ``sparse_window`` blocks back plus
    ``sparse_globals`` anchor blocks, ``"strided"`` = own block + every
    ``sparse_stride``-th block; cached per (T, S)."""

    def __init__(self, embed_dim: int, num_heads: int,
                 causal: bool = False, with_bias: bool = True,
                 seq_strategy: str = "dense",
                 num_kv_heads: Optional[int] = None,
                 rope: bool = False, rope_theta: float = 10000.0,
                 block_size: int = 512, sparse_pattern: str = "sliding",
                 sparse_window: int = 2, sparse_globals: int = 1,
                 sparse_stride: int = 4,
                 sparse_block: Optional[int] = None,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        if embed_dim % num_heads:
            raise ValueError("embed_dim % num_heads != 0")
        if seq_strategy not in SEQ_STRATEGIES:
            raise ValueError(f"seq_strategy {seq_strategy!r} not in "
                             f"{SEQ_STRATEGIES}")
        if seq_strategy not in PORTED_STRATEGIES:
            raise NotImplementedError(
                f"seq_strategy {seq_strategy!r} is not ported yet "
                f"(ported: {PORTED_STRATEGIES})")
        if sparse_pattern not in SPARSE_PATTERNS:
            raise ValueError(f"sparse_pattern {sparse_pattern!r} not in "
                             f"{SPARSE_PATTERNS}")
        super().__init__(device)
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.causal = causal
        self.with_bias = with_bias
        self.seq_strategy = seq_strategy
        # grouped-query attention: kv projections carry num_kv_heads
        # heads, each shared by num_heads/num_kv_heads query groups
        self.num_kv_heads = int(num_kv_heads or num_heads)
        if self.num_heads % self.num_kv_heads:
            raise ValueError(
                f"num_heads {num_heads} not divisible by num_kv_heads "
                f"{self.num_kv_heads}")
        self.rope = bool(rope)
        self.rope_theta = float(rope_theta)
        self.block_size = block_size
        self.sparse_pattern = sparse_pattern
        self.sparse_window = int(sparse_window)
        self.sparse_globals = int(sparse_globals)
        self.sparse_stride = int(sparse_stride)
        self.sparse_block = sparse_block
        self._sparse_masks = {}   # (T, S) -> BlockMask
        E = embed_dim
        kv = self.num_kv_heads * self.head_dim
        for name, rows in (("wq", E), ("wk", kv), ("wv", kv), ("wo", E)):
            self._register_param(name, Xavier().init((rows, E), IN_OUT,
                                                     generator),
                                 Xavier(), IN_OUT)
        if with_bias:
            for name, n in (("bq", E), ("bk", kv), ("bv", kv), ("bo", E)):
                self._register_param(name, Zeros().init((n,), ONE_D),
                                     Zeros(), ONE_D)

    def _split(self, x, heads=None):
        B, T, _ = x.shape
        h = heads or self.num_heads
        return x.reshape(B, T, h, self.head_dim).transpose(1, 2)

    def block_mask(self, T: int, S: int):
        """The layer's static :class:`~bigdl_tpu_torch.ops.block_sparse.
        BlockMask` for a (T, S) attention, built once per shape."""
        key = (int(T), int(S))
        if key not in self._sparse_masks:
            b = pick_block_divisor(T, S, self.sparse_block or self.block_size)
            nq, nk = T // b, S // b
            if self.sparse_pattern == "strided":
                m = strided_mask(nq, nk, self.sparse_stride,
                                 causal=self.causal, block_q=b, block_k=b)
            else:
                m = sliding_window_mask(nq, nk, self.sparse_window,
                                        n_global=self.sparse_globals,
                                        causal=self.causal, block_q=b,
                                        block_k=b)
            self._sparse_masks[key] = m
        return self._sparse_masks[key]

    def _attend(self, q, k, v):
        if self.seq_strategy == "blocksparse":
            return block_sparse_attention(
                q, k, v, self.block_mask(q.shape[2], k.shape[2]),
                causal=self.causal)
        if self.seq_strategy == "block":
            return blockwise_attention(q, k, v, block_size=self.block_size,
                                       causal=self.causal)
        if self.seq_strategy == "flash":
            return flash_attention(q, k, v, causal=self.causal)
        return attention(q, k, v, causal=self.causal)

    def _compute(self, params, x):
        q = self._split(proj(x, params, "wq", "bq", self.with_bias))
        k = self._split(proj(x, params, "wk", "bk", self.with_bias),
                        self.num_kv_heads)
        v = self._split(proj(x, params, "wv", "bv", self.with_bias),
                        self.num_kv_heads)
        if self.rope:
            pos = torch.arange(q.shape[2], device=q.device)
            q = rope_rotate(q, pos, self.rope_theta)
            k = rope_rotate(k, pos, self.rope_theta)
        if self.num_kv_heads != self.num_heads:
            group = self.num_heads // self.num_kv_heads
            k = k.repeat_interleave(group, dim=1)
            v = v.repeat_interleave(group, dim=1)
        o = self._attend(q, k, v)
        B, H, T, D = o.shape
        o = o.transpose(1, 2).reshape(B, T, H * D)
        return proj(o, params, "wo", "bo", self.with_bias)
