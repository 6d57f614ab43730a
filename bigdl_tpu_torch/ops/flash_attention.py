"""Flash attention, forward and backward (counterpart of
``bigdl_tpu/ops/flash_attention.py``).

Kernels, CUDA C++ for ``sm_90a``; each source's header says what it
computes, what bounds it and how:

* K1 ``csrc/flash_fwd.cu`` replaces ``_fwd_kernel``
  (``bigdl_tpu/ops/flash_attention.py:150``): for bf16 a warp-specialised
  Hopper kernel (TMA loads into an mbarrier ring, wgmma products, the
  softmax in registers, on ``csrc/hopper_common.cuh``), for f32 the FMA
  tile loop of ``csrc/tile_common.cuh``;
* K2 and K3 ``csrc/flash_bwd.cu`` replace ``_dkv_kernel`` (``:236``)
  and ``_dq_kernel`` (``:271``): for bf16 the warp-specialised Hopper
  body of ``csrc/attn_bwd_hopper.cuh`` (TMA ring, wgmma, dK/dV and dQ in
  registers) over the dense causal sweep, for f32 the tile loop;
* head dims above 128 take the wide route, ``csrc/attn_wide.cu``: one
  warp per output row, any D, under the dense mask here and the block
  mask in ``block_sparse.py``.  A wide launch counts under the counter of
  the kernel it stands for and under ``LAUNCHES_WIDE``.

``flash_attention`` and ``flash_forward`` run through one
``torch.autograd.Function``, the counterpart of the ``custom_vjp`` of
``_flash``: its forward is K1 and saves ``(q, k, v, o, lse)``, the JAX
residuals; its backward computes delta = rowsum(dO * O) in f32 and
launches K2 then K3.  For CPU tensors the same Function runs the plain
versions (``_flash_plain``, ``_flash_bwd_plain``: the kernels' math in
PyTorch); for CUDA tensors it launches the kernels or raises, forward
and backward.  Any T and S (the kernels mask the ragged edge: there is
no TPU-style block-multiple fallback), any B*H (launched 65535 heads at
a time), any head dim (the Hopper kernels and tile loops are built for
16/32/64/128, and a head dim between them is zero-padded to the next,
which leaves attention and its gradients as they are, and cut back after
the launch; above 128 the wide route takes it as it is), float32 or
bfloat16.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from ._support import (LaunchCounter, check_cuda_input, load_cuda_library,
                       on_cpu)

_BIG_LSE = 1e30  # lse sentinel for fully-masked rows: exp(s - BIG) == 0
HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

#: launches of K1 (CUDA branch only)
LAUNCHES = LaunchCounter("flash_fwd")
#: launches of K2 and K3 (CUDA branch only)
LAUNCHES_DKV = LaunchCounter("flash_bwd_dkv")
LAUNCHES_DQ = LaunchCounter("flash_bwd_dq")
#: launches of the wide route (head dims above 128) of K1-K3 and K6-K8
LAUNCHES_WIDE = LaunchCounter("attn_wide")
#: heads a launch takes at most: the limit of a grid's y dimension
MAX_HEADS = 65535
#: marks the head count's place among a launch's arguments
HEADS = object()


def _causal_keep(T: int, S: int, device) -> torch.Tensor:
    """(T, S) bool: the top-left aligned causal mask, q_pos >= k_pos."""
    return (torch.arange(T, device=device)[:, None]
            >= torch.arange(S, device=device)[None, :])


def _attn_plain(q, k, v, keep: Optional[torch.Tensor], sm_scale: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernels' math over whole rows, under ``keep`` ((T, S)
    bool, None for all): f32 scores (bf16 inputs are exact in f32),
    masked to -inf, max-subtracted exp, P cast to v's dtype before P.V
    with f32 accumulation.  Returns (O in q's dtype, LSE (B*H, 1, T)
    f32); a row with no kept key gets O = 0 and LSE = 1e30."""
    B, H, T, _ = q.shape
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    if keep is not None:
        s = s.masked_fill(~keep, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m_safe)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / l.clamp_min(1e-30)
    lse = torch.where(l > 0, m + torch.log(l.clamp_min(1e-30)),
                      torch.full_like(l, _BIG_LSE))
    return o.to(q.dtype), lse.reshape(B * H, 1, T)


def _flash_plain(q, k, v, causal: bool, sm_scale: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1's math: ``_attn_plain`` under the top-left causal mask (or
    none)."""
    keep = _causal_keep(q.shape[2], k.shape[2], q.device) if causal else None
    return _attn_plain(q, k, v, keep, sm_scale)


def _attn_bwd_plain(q, k, v, o, lse, d_o, keep: Optional[torch.Tensor],
                    sm_scale: float
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels' math over whole rows (the TPU
    ``_flash_bwd``), under ``keep`` as in ``_attn_plain``: dO cast to q's
    dtype, delta = rowsum(dO * O) in f32, P = exp(S - LSE) recomputed
    from f32 scores, dP = dO . V^T, dS = P * (dP - delta); P cast to v's
    dtype before dV = P^T . dO, dS cast to q's (k's) dtype before dK =
    dS^T . Q (dQ = dS . K), both times sm_scale.  Returns (dq, dk, dv)
    in the inputs' dtypes."""
    B, H, T, _ = q.shape
    do = d_o.to(q.dtype)
    delta = (d_o.float() * o.float()).sum(dim=-1, keepdim=True)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    if keep is not None:
        s = s.masked_fill(~keep, float("-inf"))
    p = torch.exp(s - lse.reshape(B, H, T, 1))
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = p * (dp - delta)
    dv = torch.matmul(p.to(v.dtype).float().transpose(-1, -2), do.float())
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2),
                      q.float()) * sm_scale
    dq = torch.matmul(ds.to(k.dtype).float(), k.float()) * sm_scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _flash_bwd_plain(q, k, v, o, lse, d_o, causal: bool, sm_scale: float
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2 and K3's math: ``_attn_bwd_plain`` under the top-left causal
    mask (or none)."""
    keep = _causal_keep(q.shape[2], k.shape[2], q.device) if causal else None
    return _attn_bwd_plain(q, k, v, o, lse, d_o, keep, sm_scale)


def _check_kernel_inputs(what: str, q, k, v):
    if q.shape[-1] < 1:
        raise ValueError(f"{what}: head dim {q.shape[-1]}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{what}: q, k and v must share a dtype")
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_cuda_input(f"{what} {name}", t, tuple(_DTYPE_CODE))


def _wide(D: int) -> bool:
    """Whether head dim D takes the wide route (above the built ones)."""
    return D > HEAD_DIMS[-1]


def _padded_head_dim(D: int) -> int:
    """The head dim the kernels run for a true head dim D: the next of
    ``HEAD_DIMS``, or D itself on the wide route."""
    return D if _wide(D) else next(d for d in HEAD_DIMS if d >= D)


def _pad_head_dim(t: torch.Tensor, Dp: int) -> torch.Tensor:
    """``t`` zero-padded in its last dim to ``Dp`` columns (``t`` itself
    when it has them).  Exact for attention at the caller's sm_scale:
    zero q and k columns add 0 to every score, zero v columns only fill
    output columns that are cut off, and zero dO columns leave delta =
    rowsum(dO * O) as it is."""
    D = t.shape[-1]
    return t if D == Dp else torch.nn.functional.pad(t, (0, Dp - D))


def _cut_head_dim(t: torch.Tensor, D: int) -> torch.Tensor:
    """The first D columns of a kernel's output, contiguous."""
    return t if t.shape[-1] == D else t[..., :D].contiguous()


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _launch_heads(name: str, counters, fn, per_head, shared, BH: int):
    """Launch ``fn`` over B*H heads, at most ``MAX_HEADS`` a launch, on
    the current stream of the tensors' device: each launch takes the
    tensors of ``per_head`` (contiguous (B*H, ...) views) from its first
    head on, then ``shared`` (the arguments every head reads: ints,
    floats, table pointers) with its head count in place of ``HEADS``,
    then the stream.  Each launch adds one to each of ``counters``; a
    launch error raises."""
    device = per_head[0].device
    stream = _stream(device)
    for h0 in range(0, BH, MAX_HEADS):
        n = min(MAX_HEADS, BH - h0)
        ptrs = [t.data_ptr() + h0 * (t.numel() // BH) * t.element_size()
                for t in per_head]
        args = [n if a is HEADS else a for a in shared]
        with torch.cuda.device(device):
            err = fn(*ptrs, *args, stream)
        if err != 0:
            raise RuntimeError(f"{name} launch failed: cudaError {err}")
        for c in counters:
            c.add()


def _wide_fn(name: str, n_ptr: int):
    fn = getattr(load_cuda_library("attn_wide"), name)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _wide_mask(mask):
    """The wide kernels' mask arguments: the block-sparse wrappers'
    (runtime block mask uint8 (T / bq, S / bk), bq, bk), or None for the
    dense mask."""
    if mask is None:
        return [None, 0, 1, 1]
    grid, bq, bk = mask
    return [grid.data_ptr(), grid.shape[1], bq, bk]


def _wide_fwd(q, k, v, causal: bool, sm_scale: float, counter, mask=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The wide forward (head dim above 128, taken as it is) under the
    dense mask or ``mask`` (see ``_wide_mask``); counts under ``counter``
    and ``LAUNCHES_WIDE``."""
    B, H, T, D = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((B * H, 1, T), dtype=torch.float32, device=q.device)
    m_ptr, *m_ints = _wide_mask(mask)
    _launch_heads("attn_wide fwd", (counter, LAUNCHES_WIDE),
                  _wide_fn("bigdl_wide_fwd", 6), [q, k, v, o, lse],
                  [m_ptr, *m_ints, HEADS, T, k.shape[2], D,
                   _DTYPE_CODE[q.dtype], float(sm_scale), int(bool(causal))],
                  B * H)
    return o, lse


def _wide_dkv(q, k, v, do, lse, delta, causal: bool, sm_scale: float, counter,
              mask=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The wide dK/dV over prepared inputs (as ``_launch_dkv``)."""
    B, H, T, D = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    m_ptr, *m_ints = _wide_mask(mask)
    _launch_heads("attn_wide dkv", (counter, LAUNCHES_WIDE),
                  _wide_fn("bigdl_wide_bwd_dkv", 9),
                  [q, k, v, do, lse, delta, dk, dv],
                  [m_ptr, *m_ints, HEADS, T, k.shape[2], D,
                   _DTYPE_CODE[q.dtype], float(sm_scale), int(bool(causal))],
                  B * H)
    return dk, dv


def _wide_dq(q, k, v, do, lse, delta, causal: bool, sm_scale: float, counter,
             mask=None) -> torch.Tensor:
    """The wide dQ over prepared inputs (as ``_launch_dq``)."""
    B, H, T, D = q.shape
    dq = torch.empty_like(q)
    m_ptr, *m_ints = _wide_mask(mask)
    _launch_heads("attn_wide dq", (counter, LAUNCHES_WIDE),
                  _wide_fn("bigdl_wide_bwd_dq", 8),
                  [q, k, v, do, lse, delta, dq],
                  [m_ptr, *m_ints, HEADS, T, k.shape[2], D,
                   _DTYPE_CODE[q.dtype], float(sm_scale), int(bool(causal))],
                  B * H)
    return dq


def _flash_cuda(q, k, v, causal: bool, sm_scale: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K1 on the current stream of q's device (a head dim between
    the built ones zero-padded, O cut back; above 128 the wide route)."""
    _check_kernel_inputs("flash_attention", q, k, v)
    D_true = q.shape[-1]
    if _wide(D_true):
        return _wide_fwd(q, k, v, causal, sm_scale, LAUNCHES)
    Dp = _padded_head_dim(D_true)
    q, k, v = (_pad_head_dim(t, Dp) for t in (q, k, v))
    B, H, T, D = q.shape
    fn = load_cuda_library("flash_fwd").bigdl_flash_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    o = torch.empty_like(q)
    lse = torch.empty((B * H, 1, T), dtype=torch.float32, device=q.device)
    _launch_heads("flash_fwd", (LAUNCHES,), fn, [q, k, v, o, lse],
                  [HEADS, T, k.shape[2], D, _DTYPE_CODE[q.dtype],
                   float(sm_scale), int(bool(causal))], B * H)
    return _cut_head_dim(o, D_true), lse


def _bwd_fn(name: str, n_ptr: int):
    fn = getattr(load_cuda_library("flash_bwd"), name)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch_dkv(q, k, v, do, lse, delta, causal: bool, sm_scale: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K2 over prepared inputs: dO in q's dtype and delta
    (B*H, T) f32, both contiguous, at a built head dim or above 128 (the
    wide route).  Returns (dk, dv)."""
    B, H, T, D = q.shape
    if _wide(D):
        return _wide_dkv(q, k, v, do, lse, delta, causal, sm_scale,
                         LAUNCHES_DKV)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch_heads("flash_bwd_dkv", (LAUNCHES_DKV,),
                  _bwd_fn("bigdl_flash_bwd_dkv", 8),
                  [q, k, v, do, lse, delta, dk, dv],
                  [HEADS, T, k.shape[2], D, _DTYPE_CODE[q.dtype],
                   float(sm_scale), int(bool(causal))], B * H)
    return dk, dv


def _launch_dq(q, k, v, do, lse, delta, causal: bool, sm_scale: float
               ) -> torch.Tensor:
    """Launch K3 over the same prepared inputs as ``_launch_dkv``."""
    B, H, T, D = q.shape
    if _wide(D):
        return _wide_dq(q, k, v, do, lse, delta, causal, sm_scale, LAUNCHES_DQ)
    dq = torch.empty_like(q)
    _launch_heads("flash_bwd_dq", (LAUNCHES_DQ,),
                  _bwd_fn("bigdl_flash_bwd_dq", 7),
                  [q, k, v, do, lse, delta, dq],
                  [HEADS, T, k.shape[2], D, _DTYPE_CODE[q.dtype],
                   float(sm_scale), int(bool(causal))], B * H)
    return dq


def _bwd_inputs(q, o, d_o):
    """dO in q's dtype and delta = rowsum(dO * O) (B*H, T) in f32 — the
    plain reduction the JAX package leaves to XLA."""
    B, H, T, _ = q.shape
    delta = (d_o.float() * o.float()).sum(dim=-1).reshape(B * H, T)
    return d_o.to(q.dtype).contiguous(), delta.contiguous()


def _flash_bwd_cuda(q, k, v, o, lse, d_o, causal: bool, sm_scale: float
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch K2 then K3 on the current stream of q's device (a head dim
    between the built ones zero-padded, the gradients cut back; above 128
    the wide route)."""
    _check_kernel_inputs("flash_attention backward", q, k, v)
    check_cuda_input("flash_attention backward lse", lse, (torch.float32,))
    do, delta = _bwd_inputs(q, o, d_o)
    D = q.shape[-1]
    Dp = _padded_head_dim(D)
    q, k, v, do = (_pad_head_dim(t, Dp) for t in (q, k, v, do))
    dk, dv = _launch_dkv(q, k, v, do, lse, delta, causal, sm_scale)
    dq = _launch_dq(q, k, v, do, lse, delta, causal, sm_scale)
    return tuple(_cut_head_dim(t, D) for t in (dq, dk, dv))


class _FlashAttention(torch.autograd.Function):
    """The ``custom_vjp`` of the TPU ``_flash``: (O, LSE) forward, the
    FlashAttention-2 backward from the saved (q, k, v, o, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, sm_scale: float):
        if on_cpu(q, k, v):
            o, lse = _flash_plain(q, k, v, causal, sm_scale)
        else:
            o, lse = _flash_cuda(q, k, v, causal, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, d_o, _d_lse):
        q, k, v, o, lse = ctx.saved_tensors
        bwd = _flash_bwd_plain if on_cpu(q, k, v, d_o) else _flash_bwd_cuda
        dq, dk, dv = bwd(q, k, v, o, lse, d_o, ctx.causal, ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_forward(q, k, v, causal: bool = False,
                  sm_scale: Optional[float] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(O, LSE) over (B, H, T, D) q and (B, H, S, D) k/v — the TPU
    ``_flash_fwd``'s two outputs; O is differentiable, LSE is not."""
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
    return _FlashAttention.apply(q, k, v, bool(causal), float(sm_scale))


def flash_attention(q, k, v, causal: bool = False,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """Attention over (B, H, T, D) tensors without materializing the
    scores on the card; differentiable in q, k and v."""
    return flash_forward(q, k, v, causal, sm_scale)[0]
