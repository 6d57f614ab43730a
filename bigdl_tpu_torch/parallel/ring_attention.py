"""Dense and blockwise attention (counterpart of
``bigdl_tpu/parallel/ring_attention.py``): the dense oracle ``attention``
and the single-device ``blockwise_attention`` with its online-softmax
pieces (``_online_block``, ``_finish``, ``_causal_bias``).  Ring and
Ulysses sequence parallelism come with the distributed slice.

``blockwise_attention`` is plain PyTorch, as the JAX function is a
``lax.scan`` of plain ``jnp`` outside any Pallas kernel: a loop over
K/V blocks, each folded into f32 running ``m``, ``l`` and ``o``; the
scores of a block are [T, block], never [T, S]."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention(q, k, v, causal: bool = False):
    """Dense reference attention over (B, H, T, D), materializing the
    (T, S) scores.  As in the JAX function: scores stay in the INPUT
    dtype (the scale cast to it first), the causal mask is top-left
    aligned and fills ``NEG_INF``, and only the softmax normalisation
    runs in f32 (f64 inputs keep f64)."""
    scale = float(torch.tensor(1.0 / math.sqrt(q.shape[-1]), dtype=q.dtype))
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    if causal:
        Tq, Tk = s.shape[-2:]
        keep = (torch.arange(Tq, device=s.device)[:, None]
                >= torch.arange(Tk, device=s.device)[None, :])
        s = s.masked_fill(~keep, NEG_INF)
    acc = torch.float64 if s.dtype == torch.float64 else torch.float32
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp((s - m).to(acc))
    p = (e / e.sum(dim=-1, keepdim=True)).to(q.dtype)
    return torch.matmul(p, v)


def _online_block(q, k, v, bias, m, l, o):
    """Fold one K/V block into the (m, l, o) online-softmax accumulator.

    q: [B, H, Tq, D]; k, v: [B, H, Tk, D]; bias: [Tq, Tk] additive mask
    (0 or ``NEG_INF``); m, l: [B, H, Tq]; o: [B, H, Tq, D].  As the JAX
    function: the scores are q.k summed in f32 (``_f32_matmul``), scaled
    by 1/sqrt(D) cast to q's dtype; P is cast to v's dtype for P.V, which
    is summed into the f32 ``o``."""
    scale = float(torch.tensor(1.0 / math.sqrt(q.shape[-1]), dtype=q.dtype))
    s = _f32_matmul(q, k.transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias
    m_new = torch.maximum(m, s.amax(dim=-1))
    # all-masked rows keep m == NEG_INF; corrections stay finite
    p = torch.exp(s - m_new[..., None])
    correction = torch.exp(m - m_new)
    l_new = l * correction + p.sum(dim=-1)
    o_new = o * correction[..., None] + _f32_matmul(p.to(v.dtype), v)
    return m_new, l_new, o_new


def _f32_matmul(a, b):
    """a @ b in f32: the JAX ``preferred_element_type=jnp.float32``.
    Products of bf16 values are exact in f32, so a bf16 pair is
    multiplied as f32 copies (a bf16 matmul would round its f32 sums to
    bf16)."""
    if a.dtype == torch.float32:
        return torch.matmul(a, b)
    return torch.matmul(a.float(), b.float())


def _finish(m, l, o, dtype):
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    return (o / l_safe[..., None]).to(dtype)


def _causal_bias(q_pos, k_pos):
    return torch.where(q_pos[:, None] >= k_pos[None, :], 0.0, NEG_INF)


def blockwise_attention(q, k, v, block_size: int = 512,
                        causal: bool = False):
    """Flash-style attention on one device, block by block over K/V
    (the JAX ``lax.scan``).  Never builds the [T, S] matrix; O(T·block)
    working set.  The K/V tail is padded to a whole block and the padded
    keys masked; the causal mask is top-left aligned."""
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    block = min(block_size, Tk)
    n_blocks = -(-Tk // block)
    pad = n_blocks * block - Tk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
    dev = q.device
    q_pos = torch.arange(Tq, device=dev)
    m = torch.full((B, H, Tq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, Tq), dtype=torch.float32, device=dev)
    o = torch.zeros((B, H, Tq, D), dtype=torch.float32, device=dev)
    for idx in range(n_blocks):
        k_pos = idx * block + torch.arange(block, device=dev)
        bias = torch.where(k_pos[None, :] < Tk, 0.0, NEG_INF)
        if causal:
            bias = bias + _causal_bias(q_pos, k_pos)
        sl = slice(idx * block, (idx + 1) * block)
        m, l, o = _online_block(q, k[:, :, sl], v[:, :, sl], bias, m, l, o)
    return _finish(m, l, o, q.dtype)
