"""Fused softmax cross-entropy over a large class dimension
(counterpart of ``bigdl_tpu/ops/fused_xent.py``).

The logits stay in their compute dtype (bf16 under mixed precision),
the log-sum-exp accumulates in f32, and the backward recomputes the
softmax from the saved row statistics ``(logits, t, m, s)`` instead of
storing it: the only ``[N, V]`` residual is the logits array the head's
matmul produced anyway.  The JAX module is plain jnp under a
``custom_vjp``, not a Pallas kernel, so this is plain PyTorch under a
``torch.autograd.Function`` on every device.

The backward builds the gradient in one f32 ``[N, V]`` buffer, in
place: exp, divide by s, subtract 1 at each row's target by scatter,
times g, then one cast to the logits' dtype.  No dense one-hot is built
(one alone would be 2.1 GB in f32 at 16384 x 32000).
"""
from __future__ import annotations

import torch


def _acc(dtype):
    # f32 accumulation for f32/bf16 logits; f64 logits must never be
    # silently downcast
    return torch.float64 if dtype == torch.float64 else torch.float32


class _SoftmaxXentRows(torch.autograd.Function):

    @staticmethod
    def forward(ctx, logits, t):
        acc = _acc(logits.dtype)
        m = logits.amax(dim=-1)
        s = torch.exp((logits - m[:, None]).to(acc)).sum(dim=-1)
        lse = torch.log(s) + m.to(acc)
        picked = logits.gather(1, t[:, None])[:, 0]
        ctx.save_for_backward(logits, t, m, s)
        return lse - picked.to(acc)

    @staticmethod
    def backward(ctx, g):
        logits, t, m, s = ctx.saved_tensors
        acc = _acc(logits.dtype)
        d = (logits - m[:, None]).to(acc)
        d.exp_().div_(s[:, None])
        d.scatter_add_(1, t[:, None],
                       torch.full((d.shape[0], 1), -1.0, dtype=acc,
                                  device=d.device))
        d.mul_(g.to(acc)[:, None])
        return d.to(logits.dtype), None


def softmax_xent_rows(logits: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Per-row softmax cross entropy.

    Args:
      logits: ``[N, V]`` float tensor (any float dtype; bf16 stays bf16).
      t: ``[N]`` integer class ids, 0-based.
    Returns:
      ``[N]`` f32 losses ``logsumexp(logits) - logits[t]`` (f64 for f64
      logits).
    """
    return _SoftmaxXentRows.apply(logits, t.to(torch.int64))
