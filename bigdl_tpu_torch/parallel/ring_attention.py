"""Dense attention (counterpart of ``bigdl_tpu/parallel/ring_attention.py``;
only the dense oracle ``attention`` is ported — ring and Ulysses
sequence parallelism come with the distributed slice)."""
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
