"""Flash attention forward (counterpart of ``bigdl_tpu/ops/flash_attention.py``).

Kernel K1: ``csrc/flash_fwd.cu``, CUDA C++ for ``sm_90a``, replacing
the TPU kernel ``_fwd_kernel`` (``bigdl_tpu/ops/flash_attention.py:150``).
The source's header says what it computes, what bounds it and how.

``flash_attention`` takes the plain version (``_flash_plain``, the
kernel's math in PyTorch) only when its tensors lie on the CPU; for CUDA
tensors it launches the kernel or raises.  It takes any T and S (the
kernel masks the ragged edge: there is no TPU-style block-multiple
fallback), head dims 16/32/64/128, and float32 or bfloat16.  Forward
only: the backward kernels (the TPU's ``_dkv_kernel``/``_dq_kernel``)
come with the training slice.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from ._support import (LaunchCounter, check_cuda_input, forbid_grad,
                       load_cuda_library, on_cpu)

_BIG_LSE = 1e30  # lse sentinel for fully-masked rows: exp(s - BIG) == 0
HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

#: launches of K1 (CUDA branch only)
LAUNCHES = LaunchCounter("flash_fwd")


def _flash_plain(q, k, v, causal: bool, sm_scale: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's math over whole rows: f32 scores (bf16 inputs are
    exact in f32), top-left causal mask, max-subtracted exp, P cast to
    v's dtype before P.V with f32 accumulation.  Returns (O in q's
    dtype, LSE (B*H, 1, T) f32)."""
    B, H, T, _ = q.shape
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    if causal:
        S = k.shape[2]
        keep = (torch.arange(T, device=q.device)[:, None]
                >= torch.arange(S, device=q.device)[None, :])
        s = s.masked_fill(~keep, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m_safe)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / l.clamp_min(1e-30)
    lse = torch.where(l > 0, m + torch.log(l.clamp_min(1e-30)),
                      torch.full_like(l, _BIG_LSE))
    return o.to(q.dtype), lse.reshape(B * H, 1, T)


def _flash_cuda(q, k, v, causal: bool, sm_scale: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K1 on the current stream of q's device."""
    forbid_grad("flash_attention", q, k, v)
    B, H, T, D = q.shape
    S = k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in {HEAD_DIMS}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention: q, k and v must share a dtype")
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_cuda_input(f"flash_attention {name}", t, tuple(_DTYPE_CODE))
    if B * H > 65535:
        raise ValueError(f"flash_attention: B*H {B * H} > 65535")
    lib = load_cuda_library("flash_fwd")
    fn = lib.bigdl_flash_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    o = torch.empty_like(q)
    lse = torch.empty((B * H, 1, T), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), B * H, T, S, D, _DTYPE_CODE[q.dtype],
                 float(sm_scale), int(bool(causal)), stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd launch failed: cudaError {err}")
    LAUNCHES.add()
    return o, lse


def flash_forward(q, k, v, causal: bool = False,
                  sm_scale: Optional[float] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(O, LSE) over (B, H, T, D) q and (B, H, S, D) k/v — the TPU
    ``_flash_fwd``'s two outputs."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes (B, H, T, D) tensors")
    if k.shape != v.shape or k.shape[:2] != q.shape[:2] \
            or k.shape[3] != q.shape[3]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if q.shape[2] == 0 or k.shape[2] == 0:
        raise ValueError("flash_attention: empty sequence")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if on_cpu(q, k, v):
        return _flash_plain(q, k, v, causal, sm_scale)
    return _flash_cuda(q, k, v, causal, sm_scale)


def flash_attention(q, k, v, causal: bool = False,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """Attention over (B, H, T, D) tensors without materializing the
    scores on the card."""
    return flash_forward(q, k, v, causal, sm_scale)[0]
