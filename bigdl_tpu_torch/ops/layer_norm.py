"""Fused LayerNorm (counterpart of ``bigdl_tpu/ops/layer_norm.py``).

Kernel K4: a Triton kernel replacing the TPU kernel ``_ln_kernel``
(``bigdl_tpu/ops/layer_norm.py:25``).  It computes exactly what that
kernel computes: x cast to f32, the row mean, the centered row, var =
mean(centered^2), rsqrt(var + eps), then gamma and beta in f32 and the
output cast back to x's dtype.

Design: one program per row, the whole row in one masked block (the
next power of two >= F).  x is read in place at its row pitch where its
rows are unit-stride and one pitch apart (a column slice, the rows of a
sliced batch).  A layout whose rows take two strides to reach and whose
row elements need not be adjacent — the last two dims of a transposed
[B, F, T] activation read as [B, T, F] — goes to a second instantiation,
``_ln_fwd_strided_kernel``, the same arithmetic over (outer, inner,
column) strides, so it too is read in place; only a layout that is
neither is copied (``X_COPIES``).  The output is contiguous.  The work
is a one-row reduction plus an
elementwise pass, with no matrix product and no reuse across rows, so
it is bound by memory: read x once, write y once.  At the served
prefill shape (2048 rows x 1024, bf16) that is 8.4 MB, 2.5 us at
3.35 TB/s on an H100; a decode step's (4 x 1024) is bound by the launch
itself.

``triton`` is imported, and the kernel built, only when a CUDA tensor
reaches the wrapper; CPU tensors take the plain version.

The gradient, as in the JAX package's ``custom_vjp`` of ``_fused_ln``,
launches no kernel: a ``torch.autograd.Function`` saves ``(x, gamma,
beta)`` and its backward is autograd over the plain version recomputed
from them.  It recomputes in f32 and casts each gradient to its input's
dtype.  The JAX VJP runs its jnp reference in the input dtype, so the
two are identical in f32 and differ under bf16 compute: there the JAX
backward rounds its intermediates (mean, centered row, rsqrt, the
products with g) to bf16, while this one rounds only the three
gradients it returns.
"""
import os

import torch

from ..telemetry.perf import kernel_work, nbytes
from ._support import BUILD_DIR, LaunchCounter, on_cpu

_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_MAX_BLOCK = 32768

#: launches of K4 (CUDA branch only)
LAUNCHES = LaunchCounter("layer_norm_fwd")
#: copies of x the CUDA branch makes: rows that are not unit-stride or
#: not one pitch apart
X_COPIES = LaunchCounter("layer_norm_x_copies")

#: launches of K4 on a strided layout (``_ln_fwd_strided_kernel``), also
#: counted in ``LAUNCHES``
LAUNCHES_STRIDED = LaunchCounter("layer_norm_fwd_strided")

_KERNEL = None
_STRIDED_KERNEL = None


def _layer_norm_plain(x, gamma, beta, eps: float):
    """The kernel's math: f32 statistics and affine, cast back."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    centered = xf - mean
    var = (centered * centered).mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    return (centered * inv * gamma.float() + beta.float()).to(x.dtype)


def _triton_kernel():
    """Import triton and define the kernel (once per process).  Triton's
    compile cache goes beside the CUDA builds unless the caller set
    ``TRITON_CACHE_DIR``."""
    global _KERNEL, triton, tl
    if _KERNEL is None:
        os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR / "triton"))
        import triton
        import triton.language as tl

        @triton.jit
        def _ln_fwd_kernel(x_ptr, g_ptr, b_ptr, o_ptr, F, x_pitch, eps,
                           BLOCK: tl.constexpr):
            row = tl.program_id(0).to(tl.int64)
            cols = tl.arange(0, BLOCK)
            mask = cols < F
            x = tl.load(x_ptr + row * x_pitch + cols, mask=mask,
                        other=0.0).to(tl.float32)
            mean = tl.sum(x, axis=0) / F
            centered = tl.where(mask, x - mean, 0.0)
            var = tl.sum(centered * centered, axis=0) / F
            inv = 1.0 / tl.sqrt(var + eps)
            g = tl.load(g_ptr + cols, mask=mask, other=0.0).to(tl.float32)
            b = tl.load(b_ptr + cols, mask=mask, other=0.0).to(tl.float32)
            y = centered * inv * g + b
            tl.store(o_ptr + row * F + cols,
                     y.to(o_ptr.dtype.element_ty), mask=mask)

        _KERNEL = _ln_fwd_kernel
    return _KERNEL


def _triton_strided_kernel():
    """K4 over a layout of (outer, inner, column) strides (once per
    process): row r of the [outer x inner] rows starts at
    (r // inner) * s_outer + (r % inner) * s_inner, its elements
    s_col apart; the arithmetic is ``_ln_fwd_kernel``'s."""
    global _STRIDED_KERNEL
    if _STRIDED_KERNEL is None:
        _triton_kernel()

        @triton.jit
        def _ln_fwd_strided_kernel(x_ptr, g_ptr, b_ptr, o_ptr, F, inner,
                                   s_outer, s_inner, s_col, eps,
                                   BLOCK: tl.constexpr):
            row = tl.program_id(0).to(tl.int64)
            base = (row // inner) * s_outer + (row % inner) * s_inner
            cols = tl.arange(0, BLOCK)
            mask = cols < F
            x = tl.load(x_ptr + base + cols.to(tl.int64) * s_col, mask=mask,
                        other=0.0).to(tl.float32)
            mean = tl.sum(x, axis=0) / F
            centered = tl.where(mask, x - mean, 0.0)
            var = tl.sum(centered * centered, axis=0) / F
            inv = 1.0 / tl.sqrt(var + eps)
            g = tl.load(g_ptr + cols, mask=mask, other=0.0).to(tl.float32)
            b = tl.load(b_ptr + cols, mask=mask, other=0.0).to(tl.float32)
            y = centered * inv * g + b
            tl.store(o_ptr + row * F + cols,
                     y.to(o_ptr.dtype.element_ty), mask=mask)

        _STRIDED_KERNEL = _ln_fwd_strided_kernel
    return _STRIDED_KERNEL


def _three_level(x: torch.Tensor):
    """(inner rows, outer stride, inner stride, column stride) of x read
    as [outer, inner, F] without a copy, or None."""
    F = x.shape[-1]
    if x.dim() < 2:
        return None
    try:
        x3 = x.view(-1, x.shape[-2], F)
    except RuntimeError:
        return None
    return (x3.shape[1],) + tuple(x3.stride())


def _pitch(x: torch.Tensor):
    """x's row pitch in elements where its rows are unit-stride and one
    pitch apart, else None."""
    F = x.shape[-1]
    if F == 1 or x.stride(-1) == 1:
        try:
            x2 = x.view(-1, F)
            return x2.stride(0) if x2.shape[0] > 1 else F
        except RuntimeError:   # the leading dims do not share one pitch
            pass
    return None


def _rows(x: torch.Tensor):
    """x as the kernel reads it: (x, row pitch in elements) where its rows
    are unit-stride and one pitch apart, else (a contiguous copy, F),
    counted in ``X_COPIES``."""
    pitch = _pitch(x)
    if pitch is not None:
        return x, pitch
    X_COPIES.add()
    return x.contiguous(), x.shape[-1]


def _layer_norm_cuda(x, gamma, beta, eps: float):
    if x.dtype not in _DTYPES:
        raise TypeError(f"fused_layer_norm: dtype {x.dtype} not in {_DTYPES}")
    F = x.shape[-1]
    if gamma.shape != (F,) or beta.shape != (F,):
        raise ValueError(f"fused_layer_norm: gamma/beta must be ({F},)")
    block = 1 << max(F - 1, 0).bit_length()
    if block > _MAX_BLOCK:
        raise ValueError(f"fused_layer_norm: F {F} > {_MAX_BLOCK}")
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    rows = x.numel() // F if F else 0
    if rows == 0:
        return out
    warps = min(max(block // 256, 1), 16)
    strided = _three_level(x) if _pitch(x) is None else None
    if strided is not None:
        kernel = _triton_strided_kernel()
        with torch.cuda.device(x.device):
            kernel[(rows,)](x, gamma.contiguous(), beta.contiguous(), out,
                            F, *strided, float(eps), BLOCK=block,
                            num_warps=warps)
        LAUNCHES_STRIDED.add()
        LAUNCHES.add()
        return out
    x, pitch = _rows(x)
    kernel = _triton_kernel()
    with torch.cuda.device(x.device):
        kernel[(rows,)](x, gamma.contiguous(), beta.contiguous(), out, F,
                        pitch, float(eps), BLOCK=block, num_warps=warps)
    LAUNCHES.add()
    return out


class _FusedLayerNorm(torch.autograd.Function):
    """Forward: K4 for CUDA tensors, the plain version for CPU ones.
    Backward: autograd over the plain version in f32, recomputed from
    the saved (x, gamma, beta)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps: float):
        ctx.save_for_backward(x, gamma, beta)
        ctx.eps = eps
        # no products; reads x, gamma, beta and writes y once
        with kernel_work(0.0, nbytes(x, gamma, beta, x)):
            if on_cpu(x, gamma, beta):
                return _layer_norm_plain(x, gamma, beta, eps)
            return _layer_norm_cuda(x, gamma, beta, eps)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().float().requires_grad_() for t in saved]
            y = _layer_norm_plain(*leaves, ctx.eps)
            grads = torch.autograd.grad(y, leaves, g.float())
        return (*(d.to(t.dtype) for d, t in zip(grads, saved)), None)


def fused_layer_norm(x, gamma, beta, eps: float = 1e-5):
    """LayerNorm over the last dim, differentiable in all three inputs:
    the Triton kernel for CUDA tensors, the plain version for CPU
    tensors."""
    return _FusedLayerNorm.apply(x, gamma, beta, float(eps))
