"""The 3×3 stride-1 SAME convolution, forward and backward (counterpart
of ``bigdl_tpu/ops/conv3x3_pallas.py``; the name drops "pallas", since
nothing here is Pallas).

Kernel K5, CUDA C++ for ``sm_90a`` (``csrc/conv3x3.cu``, whose header
says what it computes, what bounds it and how), replaces ``_kernel``
(``bigdl_tpu/ops/conv3x3_pallas.py:60``): an implicit GEMM on TMA and
wgmma, in bf16 on the operands as they are, in f32 with every f32
product formed from six bf16 products on three bf16 pieces of each
operand (a1 = bf16(a), a2 = bf16(a − a1), a3 = bf16(a − a1 − a2)).

``conv3x3_s1_same(x, w)`` takes NHWC ``x`` and HWIO ``w``, as the JAX
entry point does, and runs one ``torch.autograd.Function``, the
counterpart of that module's ``custom_vjp``:

* forward: K5 on ``x`` and the weights laid out (tap, out, in), f32
  accumulation, the output in x's dtype;
* backward: dX is K5 again, on the output gradient (cast to x's dtype)
  with the spatially flipped, in/out-transposed weights; dW is nine
  products (C, N) × (N, O) over one zero-padded, flattened copy of x and
  one of the gradient (``_conv3x3_dw``), as the JAX package leaves dW to
  XLA.

For CPU tensors the same Function runs the plain version,
``_conv3x3_plain`` (the nine shifted products of ``ops/conv_gemm.py``
with f32 accumulation), forward and dX; a CUDA tensor launches K5 or
raises.  Any B, H, W, C and O, bfloat16 or float32.  The kernel reads x
through TMA, which needs a 16-byte row stride (C a multiple of 8 in
bf16, of 4 in f32; at least 16 here) and a 16-byte-aligned base: where
x falls short, the wrapper hands the kernel a zero-padded
(``_pad_channels``) or aligned copy and counts it in ``X_COPIES``.  In
f32 the wrapper also splits the (tap, out, in) weights into their three
bf16 pieces once per call (``_weight_pieces``), which the kernel reads
through TMA beside the f32 pixel boxes it splits itself.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..telemetry.perf import kernel_work, nbytes
from ._support import LaunchCounter, load_cuda_library, on_cpu, split_bf16x3
from .conv_gemm import conv2d_gemm_nhwc

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

#: launches of K5, forward and dX alike (CUDA branch only)
LAUNCHES = LaunchCounter("conv3x3")
#: copies of x the CUDA branch makes for TMA: a channel pad or an aligned
#: copy
X_COPIES = LaunchCounter("conv3x3_x_copies")


def _conv3x3_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K5's math: NHWC ``x`` and HWIO ``w``, nine shifted products with
    f32 accumulation, the output in x's dtype."""
    return conv2d_gemm_nhwc(x, w.to(x.dtype), stride=(1, 1), padding=(1, 1))


def _padded_channels(c: int, dtype: torch.dtype) -> int:
    """The channel count the kernel takes for ``c`` in ``dtype``: the
    next multiple of 8 in bf16, of 4 in f32 (TMA's 16-byte row stride),
    at least 16."""
    step = 4 if dtype == torch.float32 else 8
    return max(16, -(-c // step) * step)


def _pad_channels(x: torch.Tensor, wk: torch.Tensor):
    """NHWC ``x`` and (3, 3, out, in) ``wk`` with their input channels
    zero-padded to ``_padded_channels`` (of x's dtype): the zero channels
    add nothing, so the conv is unchanged.  Returns them as they are
    where no pad is needed."""
    pad = _padded_channels(x.shape[-1], x.dtype) - x.shape[-1]
    if pad == 0:
        return x, wk
    return F.pad(x, (0, pad)), F.pad(wk, (0, pad))


def _weight_pieces(wk: torch.Tensor, c8: int) -> torch.Tensor:
    """The f32 kernel's weights: the three bf16 pieces of the f32 (3, 3,
    out, in) ``wk`` (any strides), p1 = bf16(w), p2 = bf16(w − p1), p3 =
    bf16(w − p1 − p2), each rounded to nearest even (the differences are
    exact in f32), as one (3, 9, out, c8) tensor, input channels
    zero-padded to ``c8``.  p1 + p2 + p3 = w exactly (for |w| above
    2^-102)."""
    O, C = wk.shape[2], wk.shape[3]
    w = wk.reshape(9, O, C)
    pieces = torch.empty((3, 9, O, c8), dtype=torch.bfloat16,
                         device=wk.device)
    pieces[..., C:].zero_()
    split_bf16x3(w, pieces[..., :C])
    return pieces


def _launch(x: torch.Tensor, wk: torch.Tensor, y: torch.Tensor) -> None:
    """K5 on the current stream of x's device: ``x`` and ``y`` NHWC and
    ``wk`` as ``bigdl_conv3x3`` takes them (``_conv3x3_cuda`` makes
    them)."""
    B, H, W, C = x.shape
    fn = load_cuda_library("conv3x3").bigdl_conv3x3
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), wk.data_ptr(), y.data_ptr(), B, H, W, C,
                 y.shape[-1], _DTYPE_CODE[x.dtype],
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv3x3 launch failed: cudaError {err}")
    LAUNCHES.add()


def _conv3x3_cuda(x: torch.Tensor, wk: torch.Tensor) -> torch.Tensor:
    """Launch K5 on the current stream of x's device: NHWC ``x`` and
    weights ``wk`` as (3, 3, out, in), both contiguous in one dtype.  In
    f32 the weights are split into their bf16 pieces first."""
    if x.dtype not in _DTYPE_CODE or wk.dtype != x.dtype:
        raise TypeError(f"conv3x3: x {x.dtype} and weights {wk.dtype} must "
                        f"share a dtype in {tuple(_DTYPE_CODE)}")
    if not (x.is_contiguous() and wk.is_contiguous()):
        raise ValueError("conv3x3: inputs must be contiguous")
    B, H, W, C = x.shape
    O = wk.shape[2]
    if wk.shape != (3, 3, O, C):
        raise ValueError(f"conv3x3: weights {tuple(wk.shape)} do not match "
                         f"x {tuple(x.shape)}")
    if wk.data_ptr() % 16:
        raise ValueError("conv3x3: weights must be 16-byte aligned")
    y = torch.empty((B, H, W, O), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    if _padded_channels(C, x.dtype) != C or x.data_ptr() % 16:
        x, wk = _pad_channels(x, wk)
        if x.data_ptr() % 16:
            x = x.clone()
        X_COPIES.add()
    if x.dtype == torch.float32:
        wk = _weight_pieces(wk, -(-x.shape[-1] // 8) * 8)
    _launch(x, wk, y)
    return y


def _conv3x3_dw(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dW (3, 3, C, O) = Σ over b, h, w of x[b, h + dy − 1, w + dx − 1]ᵀ
    g[b, h, w], products in x's dtype with f32 accumulation.

    Two copies in all: x zero-padded to (B + 1, H + 2, W + 2, C) and g to
    (B, H + 2, W + 2, O), zero outside [:H, :W], both flattened to rows.
    Row i of g is pixel (b, h, w) and row i + dy·(W + 2) + dx of x its tap
    (dy, dx), so each tap is one contiguous window of x's rows times all of
    g's; a row that would cross into a pad column or the next image meets
    a zero row of g, and the zero image at the end keeps every window in
    range.  The extra work is (H + 2)(W + 2) / HW of the products."""
    B, H, W, C = x.shape
    Wp = W + 2
    n = B * (H + 2) * Wp
    xf = F.pad(x, (0, 0, 1, 1, 1, 1, 0, 1)).reshape(-1, C)
    gf = F.pad(g.to(x.dtype), (0, 0, 0, 2, 0, 2)).reshape(n, -1)
    dw = x.new_empty((3, 3, C, gf.shape[1]))
    for dy in range(3):
        for dx in range(3):
            off = dy * Wp + dx
            torch.mm(xf[off:off + n].t(), gf, out=dw[dy, dx])
    return dw


def _conv_products(x, w) -> float:
    """The products of the 3×3 SAME conv of NHWC ``x`` by HWIO ``w``:
    2·9·B·H·W·C·O (its dX and its dW are as many each)."""
    B, H, W, C = x.shape
    return 18.0 * B * H * W * C * w.shape[3]


class _Conv3x3(torch.autograd.Function):
    """The ``custom_vjp`` of the TPU ``_conv3x3``: K5 forward; dX by K5
    on the flipped, transposed weights; dW by nine matmuls.  Each pass
    reports the conv's products and bytes to the work counter
    (``telemetry.perf.kernel_work``), the backward's dW among them, so
    the count is the conv's whatever computes it."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        y_bytes = x.numel() // x.shape[3] * w.shape[3] * x.element_size()
        with kernel_work(_conv_products(x, w), nbytes(x, w) + y_bytes):
            if on_cpu(x, w):
                return _conv3x3_plain(x, w)
            # (3, 3, C, O) -> (tap, out, in): one small copy per call
            return _conv3x3_cuda(
                x.contiguous(), w.to(x.dtype).permute(0, 1, 3, 2).contiguous())

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        need = ctx.needs_input_grad
        dx = dw = None
        # reads g, x, w; writes dX and dW where they are wanted
        with kernel_work(_conv_products(x, w) * (need[0] + need[1]),
                         nbytes(g, x, w) + need[0] * nbytes(x)
                         + need[1] * nbytes(w)):
            gx = g.to(x.dtype)
            if need[0]:
                # the dX conv's HWIO weights are w[::-1, ::-1] with in and
                # out swapped, so as (tap, out, in) they are w[::-1, ::-1]
                w_flip = w.to(x.dtype).flip(0, 1)
                if on_cpu(x, w, g):
                    dx = _conv3x3_plain(gx, w_flip.transpose(2, 3))
                else:
                    dx = _conv3x3_cuda(gx.contiguous(), w_flip.contiguous())
            if need[1]:
                dw = _conv3x3_dw(x, gx).to(w.dtype)
        return dx, dw


def conv3x3_s1_same(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3×3 stride-1 SAME NHWC conv through K5 (the plain version for CPU
    tensors); differentiable in x and w.

    x: [B, H, W, C]; w: [3, 3, C, O] (HWIO).  Returns [B, H, W, O] in
    x's dtype (f32 accumulation)."""
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:2]) != (3, 3) \
            or w.shape[2] != x.shape[3]:
        raise ValueError(f"conv3x3_s1_same: x {tuple(x.shape)} (NHWC) and w "
                         f"{tuple(w.shape)} (3, 3, C, O) disagree")
    return _Conv3x3.apply(x, w)
