"""Flash attention, forward and backward (counterpart of
``bigdl_tpu/ops/flash_attention.py``).

Kernels, CUDA C++ for ``sm_90a``; each source's header says what it
computes, what bounds it and how:

* K1 ``csrc/flash_fwd.cu`` replaces ``_fwd_kernel``
  (``bigdl_tpu/ops/flash_attention.py:150``): the warp-specialised Hopper
  body of ``csrc/attn_fwd_hopper.cuh`` (TMA loads into an mbarrier ring,
  wgmma products, the softmax in registers, on
  ``csrc/hopper_common.cuh``); in f32 each f32 product is formed from
  bf16 wgmma products on three bf16 pieces of its operands (K and V
  split in place; q too up to D 128, into registers above); above head
  dim 256 the chunked forward of the same header
  (``attn_fwd_chunk_kernel``): the scores summed over 64-column panels
  of q and K streamed through the ring, O kept 256 columns a block, the
  chunks of a head in blocks of their own;
* K2 and K3 ``csrc/flash_bwd.cu`` replace ``_dkv_kernel`` (``:236``)
  and ``_dq_kernel`` (``:271``): the warp-specialised Hopper body of
  ``csrc/attn_bwd_hopper.cuh`` (TMA ring, wgmma, dK/dV and dQ in
  registers) over the dense causal sweep; in f32 each f32 product is
  formed from bf16 wgmma products on three bf16 pieces of its operands
  (the streamed tiles split in place; the block's own rows too up to
  D 128, into registers at 192 and 256); above head dim 256, in both
  dtypes, the chunked backward of the same header
  (``bwd_dkv_chunk_kernel``, ``bwd_dq_chunk_kernel``): the scores summed
  over 64-column panels of the own rows and the streamed tile through a
  ring, dK/dV or dQ kept 256 columns a block, the chunks of a head in
  blocks of their own.

Routing by head dim D, the same in all three passes and both dtypes: the
Hopper bodies at 16, 32, 64, 128, 192 and 256 (f32 on split products), a
head dim between them zero-padded to the next (160 runs at 192, 200 at
256); above 256 the chunked forward and backward at D zero-padded to a
multiple of 64 (``_fwd_head_dim``, ``_bwd_head_dim``: 300 runs at 320),
counted under ``LAUNCHES_CHUNKED``, ``LAUNCHES_DKV_CHUNKED`` and
``LAUNCHES_DQ_CHUNKED`` for their dtype too.  A head dim whose chunks,
times the heads of a launch, outgrow a grid raises (``MAX_GRID_X``).

Layouts: every kernel reads q, k, v and dO through TMA at their own
strides, so the (B, T, H, D).transpose(1, 2) view that every attention
layer makes is read in place; only an operand TMA cannot read (a start
not 16-byte aligned, a stride not a multiple of 16 bytes, a last dim
that is not unit-stride) is copied (``OPERAND_COPIES``).  Outputs are
contiguous.

``flash_attention`` and ``flash_forward`` run through one
``torch.autograd.Function``, the counterpart of the ``custom_vjp`` of
``_flash``: its forward is K1 and saves ``(q, k, v, o, lse)``, the JAX
residuals; its backward computes delta = rowsum(dO * O) in f32 and
launches K2 then K3.  For CPU tensors the same Function runs the plain
versions (``_flash_plain``, ``_flash_bwd_plain``: the kernels' math in
PyTorch); for CUDA tensors it launches the kernels or raises, forward
and backward.  Any T and S (the kernels mask the ragged edge: there is
no TPU-style block-multiple fallback), any B*H (launched 65535 heads at
a time), any head dim (zero padding leaves attention and its gradients
as they are; the outputs are cut back after the launch), any layout,
float32 or bfloat16.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from ..telemetry.perf import kernel_work, nbytes
from ._support import LaunchCounter, load_cuda_library, on_cpu

_BIG_LSE = 1e30  # lse sentinel for fully-masked rows: exp(s - BIG) == 0
#: head dims the kernels are built for, in both dtypes and all passes
HEAD_DIMS = (16, 32, 64, 128, 192, 256)
#: the built head dims on which the f32 kernels keep the block's own rows
#: in f32 and stream 32-row tiles (no model path runs them)
WIDE_F32_DIMS = (192, 256)
#: the chunked forward above the built head dims: q and K stream in
#: panels of ``CHUNK_PANEL`` columns (D is zero-padded to a multiple of
#: it), and a block keeps ``CHUNK_COLS`` columns of O
CHUNK_PANEL = 64
CHUNK_COLS = 256
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

#: launches of K1 (CUDA branch only)
LAUNCHES = LaunchCounter("flash_fwd")
#: launches of K2 and K3 (CUDA branch only)
LAUNCHES_DKV = LaunchCounter("flash_bwd_dkv")
LAUNCHES_DQ = LaunchCounter("flash_bwd_dq")
#: the launches of K1, K2 and K3, among those above, in f32 at
#: ``WIDE_F32_DIMS``
LAUNCHES_F32 = {D: LaunchCounter(f"flash_fwd f32 D {D}")
                for D in WIDE_F32_DIMS}
LAUNCHES_DKV_F32 = {D: LaunchCounter(f"flash_bwd_dkv f32 D {D}")
                    for D in WIDE_F32_DIMS}
LAUNCHES_DQ_F32 = {D: LaunchCounter(f"flash_bwd_dq f32 D {D}")
                   for D in WIDE_F32_DIMS}
#: the launches of K1, among those above, at head dims above 256 (the
#: chunked forward), by dtype (no model path runs them)
LAUNCHES_CHUNKED = {dt: LaunchCounter(f"flash_fwd {name} D > 256")
                    for dt, name in ((torch.bfloat16, "bf16"),
                                     (torch.float32, "f32"))}
#: the launches of K2 and K3, among those above, at head dims above 256 on
#: the chunked backward, by dtype (no model path runs them)
LAUNCHES_DKV_CHUNKED = {dt: LaunchCounter(f"flash_bwd_dkv {name} D > 256")
                        for dt, name in ((torch.bfloat16, "bf16"),
                                         (torch.float32, "f32"))}
LAUNCHES_DQ_CHUNKED = {dt: LaunchCounter(f"flash_bwd_dq {name} D > 256")
                       for dt, name in ((torch.bfloat16, "bf16"),
                                        (torch.float32, "f32"))}
#: q, k, v and dO operands the attention wrappers copied because TMA
#: could not read them in place (not 16-byte aligned, or a stride TMA
#: does not take); padded head dims are not counted (the pad is the copy)
OPERAND_COPIES = LaunchCounter("attn_operand_copies")
#: heads a launch takes at most: the limit of a grid's y dimension
MAX_HEADS = 65535
#: blocks a grid's x dimension takes at most: the chunked kernels launch
#: one block per chunk of each head there
MAX_GRID_X = 2 ** 31 - 1
#: mark the head count and the first head index among a launch's arguments
HEADS = object()
FIRST_HEAD = object()


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


def _upcast(t: torch.Tensor) -> torch.Tensor:
    """``t`` in the plain backward's arithmetic: f32, or f64 where ``t``
    is f64 (the yardstick of the f32 kernels on the card carries their
    math in f64)."""
    return t if t.dtype == torch.float64 else t.float()


def _attn_bwd_plain(q, k, v, o, lse, d_o, keep: Optional[torch.Tensor],
                    sm_scale: float
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels' math over whole rows (the TPU
    ``_flash_bwd``), under ``keep`` as in ``_attn_plain``: dO cast to q's
    dtype, delta = rowsum(dO * O) in f32, P = exp(S - LSE) recomputed
    from f32 scores, dP = dO . V^T, dS = P * (dP - delta); P cast to v's
    dtype before dV = P^T . dO, dS cast to q's (k's) dtype before dK =
    dS^T . Q (dQ = dS . K), both times sm_scale.  Returns (dq, dk, dv)
    in the inputs' dtypes.  On f64 inputs the same math runs in f64."""
    B, H, T, _ = q.shape
    f = _upcast
    do = d_o.to(q.dtype)
    delta = (f(d_o) * f(o)).sum(dim=-1, keepdim=True)
    s = torch.matmul(f(q), f(k).transpose(-1, -2)) * sm_scale
    if keep is not None:
        s = s.masked_fill(~keep, float("-inf"))
    p = torch.exp(s - lse.reshape(B, H, T, 1))
    dp = torch.matmul(f(do), f(v).transpose(-1, -2))
    ds = p * (dp - delta)
    dv = torch.matmul(f(p.to(v.dtype)).transpose(-1, -2), f(do))
    dk = torch.matmul(f(ds.to(q.dtype)).transpose(-1, -2), f(q)) * sm_scale
    dq = torch.matmul(f(ds.to(k.dtype)), f(k)) * sm_scale
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
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"{what}: dtype {q.dtype} not in {tuple(_DTYPE_CODE)}")


def _wide(D: int) -> bool:
    """Whether head dim D is above the built ones: the chunked forward
    and backward."""
    return D > HEAD_DIMS[-1]


def _padded_head_dim(D: int) -> int:
    """The next built head dim at or above D (129-256: 192 or 256, the
    next multiple of 64), or D itself above them."""
    return D if _wide(D) else next(d for d in HEAD_DIMS if d >= D)


def _fwd_head_dim(D: int) -> int:
    """The head dim the forward (K1, K6) runs for a true head dim D: the
    next built one, or above them the next multiple of ``CHUNK_PANEL``
    (the chunked forward)."""
    return -(-D // CHUNK_PANEL) * CHUNK_PANEL if _wide(D) \
        else _padded_head_dim(D)


def _bwd_head_dim(D: int) -> int:
    """The head dim dK/dV and dQ run for a true head dim D, in both
    dtypes: the forward's (``_fwd_head_dim``; above 256 the chunked
    backward)."""
    return _fwd_head_dim(D)


def _fwd_chunks(D: int):
    """The blocks of the chunked forward and backward over the columns of
    their output at a head dim D above 256 (a multiple of
    ``CHUNK_PANEL``), as ``chunk_of`` in ``csrc/hopper_common.cuh``
    computes them: for each chunk (col0, lo, hi), the ``CHUNK_COLS``
    columns from col0 it forms (inside D) and the columns lo .. hi - 1 it
    writes."""
    out = []
    for lo in range(0, D, CHUNK_COLS):
        whole = lo + CHUNK_COLS <= D
        out.append((lo if whole else D - CHUNK_COLS, lo,
                    lo + CHUNK_COLS if whole else D))
    return out


def _chunked_counter(counters, q: torch.Tensor) -> Tuple[LaunchCounter, ...]:
    """The counter of ``counters`` (by dtype) for a launch on the padded
    operand ``q``, if it runs a chunked kernel, whose grid must take its
    chunks: ``MAX_GRID_X`` blocks at most for the heads of one launch
    (``MAX_HEADS``), or it raises."""
    B, H, _, D = q.shape
    if not _wide(D):
        return ()
    heads = min(B * H, MAX_HEADS)
    chunks = len(_fwd_chunks(D))
    if heads * chunks > MAX_GRID_X:
        raise ValueError(
            f"attention: head dim {D} takes {chunks} chunks a head, "
            f"{heads * chunks} blocks for {heads} heads a launch, more than "
            f"a grid's {MAX_GRID_X}")
    return (counters[q.dtype],)


def _f32_counter(counters, q: torch.Tensor) -> Tuple[LaunchCounter, ...]:
    """The counter of ``counters`` (by built head dim) for a launch on
    the padded operand ``q`` in f32, if one is kept for its head dim."""
    c = counters.get(q.shape[-1]) if q.dtype == torch.float32 else None
    return () if c is None else (c,)


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


def _head_strides(t: torch.Tensor):
    """The (batch, head, row) element strides of (B, H, rows, D) ``t``; a
    dim of size 1 gets the stride a contiguous tensor has there."""
    B, H, R, D = t.shape
    dense = (H * R * D, R * D, D)
    return [s if n > 1 else c
            for s, n, c in zip(t.stride()[:3], t.shape[:3], dense)]


def _readable(t: torch.Tensor) -> bool:
    """Whether TMA reads ``t`` in place: a unit-stride last dim, a
    16-byte-aligned start and strides that are non-zero multiples of 16
    bytes."""
    item = t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s > 0 and s * item % 16 == 0 for s in _head_strides(t)))


def _kernel_operands(*tensors):
    """The tensors as a kernel reads them: each in place where
    ``_readable``, else a contiguous copy (counted in
    ``OPERAND_COPIES``)."""
    out = []
    for t in tensors:
        if not _readable(t):
            t = t.contiguous()
            OPERAND_COPIES.add()
        out.append(t)
    return out


def _strides_arg(*tensors):
    """The C entries' strides array: (batch, head, row) of each tensor."""
    flat = [s for t in tensors for s in _head_strides(t)]
    return (ctypes.c_longlong * len(flat))(*flat)


def _empty(t: torch.Tensor, shape=None, dtype=None) -> torch.Tensor:
    """A contiguous output like ``t``: the kernels write their outputs
    contiguous, whatever the layout of their inputs."""
    return torch.empty(t.shape if shape is None else shape,
                       dtype=t.dtype if dtype is None else dtype,
                       device=t.device)


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _c_fn(lib: str, name: str, argtypes):
    """C entry ``name`` of ``csrc/<lib>.cu`` (built at first use)."""
    fn = getattr(load_cuda_library(lib), name)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def _call(name: str, fn, args, device):
    """``fn(*args, stream)`` on the current stream of ``device``; a launch
    error raises."""
    with torch.cuda.device(device):
        err = fn(*args, _stream(device))
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _launch_heads(name: str, counters, fn, args, BH: int, device):
    """Launch ``fn`` over B*H heads, at most ``MAX_HEADS`` a launch, on
    the current stream of ``device``: ``args`` with the launch's head
    count in place of ``HEADS`` and its first head in place of
    ``FIRST_HEAD``; every pointer stays the tensor's start (the kernels
    find a head from its index and the strides).  Each launch adds one to
    each of ``counters``; a launch error raises."""
    for h0 in range(0, BH, MAX_HEADS):
        n = min(MAX_HEADS, BH - h0)
        _call(name, fn, [n if a is HEADS else h0 if a is FIRST_HEAD else a
                         for a in args], device)
        for c in counters:
            c.add()


def _flash_cuda(q, k, v, causal: bool, sm_scale: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K1 on the current stream of q's device (a head dim between
    the built ones zero-padded, above 256 padded to a multiple of 64 for
    the chunked forward; O cut back).  q, k and v are read at their
    strides through TMA in both dtypes (copied where TMA cannot read
    them)."""
    _check_kernel_inputs("flash_attention", q, k, v)
    D_true = q.shape[-1]
    Dp = _fwd_head_dim(D_true)
    q, k, v = _kernel_operands(*(_pad_head_dim(t, Dp) for t in (q, k, v)))
    B, H, T, D = q.shape
    fn = _c_fn("flash_fwd", "bigdl_flash_fwd", [_P] * 6 + [_I] * 7
               + [_F, _I, _P])
    o = _empty(q)
    lse = _empty(q, (B * H, 1, T), torch.float32)
    _launch_heads("flash_fwd", (LAUNCHES, *_f32_counter(LAUNCHES_F32, q),
                                *_chunked_counter(LAUNCHES_CHUNKED, q)),
                  fn,
                  [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                   lse.data_ptr(), _strides_arg(q, k, v), H, FIRST_HEAD,
                   HEADS, T, k.shape[2], D, _DTYPE_CODE[q.dtype],
                   float(sm_scale), int(bool(causal))], B * H, q.device)
    return _cut_head_dim(o, D_true), lse


def _bwd_fn(name: str, n_ptr: int):
    return _c_fn("flash_bwd", name, [_P] * (n_ptr + 1) + [_I] * 7
                 + [_F, _I, _P])


def _bwd_operands(q, k, v, do):
    """q, k, v and dO as the Hopper dK/dV and dQ read them: zero-padded to
    the head dim they run (``_bwd_head_dim``; as they are where they have
    it), in place where TMA reads them, else copied."""
    Dp = _bwd_head_dim(q.shape[-1])
    return _kernel_operands(*(_pad_head_dim(t, Dp) for t in (q, k, v, do)))


def _launch_dkv(q, k, v, do, lse, delta, causal: bool, sm_scale: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K2 over prepared inputs: dO in q's dtype and delta
    (B*H, T) f32, at any head dim (zero-padded to the one it runs,
    ``_bwd_head_dim``, the gradients cut back).  q, k, v and dO are read
    at their strides through TMA in both dtypes (copied where TMA cannot
    read them).  Returns contiguous (dk, dv)."""
    B, H, T, D = q.shape
    q, k, v, do = _bwd_operands(q, k, v, do)
    dk, dv = _empty(k), _empty(v)
    _launch_heads("flash_bwd_dkv",
                  (LAUNCHES_DKV, *_f32_counter(LAUNCHES_DKV_F32, q),
                   *_chunked_counter(LAUNCHES_DKV_CHUNKED, q)),
                  _bwd_fn("bigdl_flash_bwd_dkv", 8),
                  [*(t.data_ptr() for t in (q, k, v, do, lse, delta, dk, dv)),
                   _strides_arg(q, k, v, do), H, FIRST_HEAD, HEADS, T,
                   k.shape[2], q.shape[-1], _DTYPE_CODE[q.dtype],
                   float(sm_scale), int(bool(causal))], B * H, q.device)
    return _cut_head_dim(dk, D), _cut_head_dim(dv, D)


def _launch_dq(q, k, v, do, lse, delta, causal: bool, sm_scale: float
               ) -> torch.Tensor:
    """Launch K3 over the same prepared inputs as ``_launch_dkv``, read
    as ``_launch_dkv`` reads them (through TMA in both dtypes)."""
    B, H, T, D = q.shape
    q, k, v, do = _bwd_operands(q, k, v, do)
    dq = _empty(q)
    _launch_heads("flash_bwd_dq",
                  (LAUNCHES_DQ, *_f32_counter(LAUNCHES_DQ_F32, q),
                   *_chunked_counter(LAUNCHES_DQ_CHUNKED, q)),
                  _bwd_fn("bigdl_flash_bwd_dq", 7),
                  [*(t.data_ptr() for t in (q, k, v, do, lse, delta, dq)),
                   _strides_arg(q, k, v, do), H, FIRST_HEAD, HEADS, T,
                   k.shape[2], q.shape[-1], _DTYPE_CODE[q.dtype],
                   float(sm_scale), int(bool(causal))], B * H, q.device)
    return _cut_head_dim(dq, D)


def _bwd_inputs(q, o, d_o):
    """dO in q's dtype (in its own layout: the kernels read it in place)
    and delta = rowsum(dO * O) (B*H, T) in f32, contiguous — the plain
    reduction the JAX package leaves to XLA."""
    B, H, T, _ = q.shape
    delta = (d_o.float() * o.float()).sum(dim=-1).reshape(B * H, T)
    return d_o.to(q.dtype), delta.contiguous()


def _check_lse(what: str, lse):
    if lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"{what}: lse must be contiguous f32")


def _flash_bwd_cuda(q, k, v, o, lse, d_o, causal: bool, sm_scale: float
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch K2 then K3 on the current stream of q's device (a head dim
    between the built ones zero-padded, above them padded to a multiple
    of 64 for the chunked backward, the gradients cut back)."""
    _check_kernel_inputs("flash_attention backward", q, k, v)
    _check_lse("flash_attention backward", lse)
    do, delta = _bwd_inputs(q, o, d_o)
    D = q.shape[-1]
    Dp = _bwd_head_dim(D)
    q, k, v, do = (_pad_head_dim(t, Dp) for t in (q, k, v, do))
    dk, dv = _launch_dkv(q, k, v, do, lse, delta, causal, sm_scale)
    dq = _launch_dq(q, k, v, do, lse, delta, causal, sm_scale)
    return tuple(_cut_head_dim(t, D) for t in (dq, dk, dv))


def attention_products(q, k) -> float:
    """The products of dense attention's forward over (B, H, T, D) q
    and (B, H, S, D) k: QKᵀ and PV, 2·B·H·T·S·D each, the whole [T, S]
    grid whatever the mask (the backward's four are twice these)."""
    B, H, T, D = q.shape
    return 4.0 * B * H * T * k.shape[2] * D


def fwd_bytes(q, k, v) -> int:
    """What an attention forward reads and writes once: q, k, v, then O
    (q's shape and dtype) and the f32 LSE (B·H·T)."""
    return nbytes(q, k, v, q) + 4 * q.shape[0] * q.shape[1] * q.shape[2]


class _FlashAttention(torch.autograd.Function):
    """The ``custom_vjp`` of the TPU ``_flash``: (O, LSE) forward, the
    FlashAttention-2 backward from the saved (q, k, v, o, lse).  Each
    pass reports the dense products and the bytes of its math to the
    work counter (``telemetry.perf.kernel_work``), from either branch."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, sm_scale: float):
        with kernel_work(attention_products(q, k), fwd_bytes(q, k, v)):
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
        # reads q, k, v, O, LSE, dO; writes dq, dk, dv
        with kernel_work(2 * attention_products(q, k),
                         nbytes(q, k, v, o, lse, d_o, q, k, v)):
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
