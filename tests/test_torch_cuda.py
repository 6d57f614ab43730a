"""The port's kernels on the card (``cuda``-marked; they skip without a
CUDA device).

This file imports neither jax nor the JAX package, so it also runs on a
GPU machine that has no jax.  There, run it without the suite's
conftest (which configures jax):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Each kernel is held against its plain PyTorch version on the same
inputs, forward and backward (the f32 forward, K1 and K6, dK/dV, K2 and
K7, and dQ, K3 and K8, on bf16 products an f32 one at every head dim
they are built for), also at head dims the kernels are not built for
(zero-padded to the next, or above the built ones, 256: the chunked
forward, dK/dV and dQ at D padded to a multiple of 64, in both dtypes)
and at more heads than one grid takes; a small
TransformerLM served on
the card in f32 (also at head dim 8, through the server; paged, with
the page window's prefill on K6 at block 16, across a bf16 handoff, by
one beam, over the int8 cache), and small
flash and block-sparse ones, a ResNet-CIFAR on K5 and a LeNet-5 trained
three steps on the card in f32, are held against the same model on the
CPU.  Checkpoints written from card tensors load in a process that
sees no card, a resumed run on the card is held against an
uninterrupted one, and a bf16 server on the card swaps in a verified
checkpoint.  Over a one-rank NCCL group, ``DistriOptimizer`` trains the
small LM bit for bit as ``LocalOptimizer`` does, with a derived plan
and ``set_fsdp`` as without (FSDP is a no-op on one rank), and
``AllReduceParameter``'s round trip returns its input bit for bit.  The
telemetry's work counter reads the same work from K1-K4 on the card as
from their plain versions on the CPU, a Telemetry bundle leaves the
small LM's losses and weights as they are, bit for bit, and the memory
gauges read the caching allocator.  A two-replica fleet of the small
LM on the card routes the CPU fleet's greedy tokens, its traces
stitched.
"""
import math

import numpy as np
import pytest
import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.dataset import Sample, array
from bigdl_tpu_torch.models.generate import (_paged_machinery,
                                             cached_generate,
                                             cached_paged_decoder,
                                             make_beam_search, make_generate)
from bigdl_tpu_torch.models.lenet import LeNet5
from bigdl_tpu_torch.models.resnet import ResNetCifar
from bigdl_tpu_torch.models.transformer import TransformerLM
from bigdl_tpu_torch.ops import block_sparse as bs
from bigdl_tpu_torch.ops import conv3x3
from bigdl_tpu_torch.ops import flash_attention as fa
from bigdl_tpu_torch.ops import layer_norm as ln
from bigdl_tpu_torch.optim import (SGD, LocalOptimizer, Trigger, max_iteration,
                                   several_iteration)
from bigdl_tpu_torch.serving import InferenceServer, KVPagePool, Status
from bigdl_tpu_torch.serving.pools import deserialize_handoff
from bigdl_tpu_torch.utils import api_cases
from bigdl_tpu_torch.utils.rng import RNG

pytestmark = pytest.mark.cuda

# K1-K3 are held row by row (chip_smoke.py says why): bf16 rounds P, dS
# and the outputs at different points on the two sides; f32 differs in
# summation order only
ROW_TOL = {torch.bfloat16: 7e-3, torch.float32: 1e-4}


def _row_rel_err(got, ref, scale=None):
    """The worst row's ||got - ref|| / (||ref|| + 1e-4 * scale) over the
    last dim, in f32; ``scale`` defaults to ref's largest row norm."""
    d = torch.linalg.vector_norm(got.float() - ref.float(), dim=-1)
    r = torch.linalg.vector_norm(ref.float(), dim=-1)
    if scale is None:
        scale = r.max().item()
    return (d / (r + 1e-4 * scale)).max().item()


def _keep(T, S, causal, device, mask=None):
    """(T, S) bool: the keys each query row attends, under ``mask`` (a
    ``BlockMask``) or the dense mask, top-left causal under ``causal``."""
    if mask is not None:
        return bs._elementwise_keep(mask, causal, device)
    if causal:
        return fa._causal_keep(T, S, device)
    return torch.ones(T, S, dtype=torch.bool, device=device)


def _dq_row_err(got, ref, keep, k, v, d_o, sm_scale, scale):
    """dQ's ``_row_rel_err`` at ``scale``, but a query row with one live
    key j under ``keep`` ((T, S) bool), whose dQ is 0 in exact arithmetic
    and holds only the rounding of dP - delta on both sides, against the
    size of its terms before they cancel, sm_scale ||dO_i|| ||v_j||
    ||k_j|| (chip_smoke.py, ``dq_row_err``)."""
    one = keep.sum(dim=-1) == 1
    err = _row_rel_err(got[..., ~one, :], ref[..., ~one, :], scale) \
        if not one.all() else 0.0
    if one.any():
        i = torch.nonzero(one).flatten()
        j = keep[i].int().argmax(dim=-1)

        def norm(t):
            return torch.linalg.vector_norm(t.float(), dim=-1)

        size = sm_scale * norm(d_o[..., i, :]) * norm(v[..., j, :]) * \
            norm(k[..., j, :])
        err = max(err, (norm(got[..., i, :] - ref[..., i, :]) / size)
                  .max().item())
    return err


def _dk_row_err(got, ref, keep, q, v, d_o, sm_scale, scale):
    """dK's ``_row_rel_err`` at ``scale``, but a key row j whose every
    live query i under ``keep`` ((T, S) bool) has j as its one live key,
    whose dK is 0 in exact arithmetic (dS_ij = P_ij (dP_ij - delta_i)
    with O_i = v_j) and holds only the rounding of dP - delta on both
    sides, against the size of its terms before they cancel, sm_scale
    ||v_j|| sum_i ||dO_i|| ||q_i||, as ``_dq_row_err`` reads dQ's rows
    with one live key."""
    one = keep.sum(dim=-1) == 1      # query rows with one live key
    gone = keep.any(dim=0) & ~(keep & ~one[:, None]).any(dim=0)
    err = _row_rel_err(got[..., ~gone, :], ref[..., ~gone, :], scale) \
        if not gone.all() else 0.0
    if gone.any():
        def norm(t):
            return torch.linalg.vector_norm(t.float(), dim=-1)

        j = torch.nonzero(gone).flatten()
        terms = (norm(d_o) * norm(q))[..., None, :] @ keep[:, j].float()
        size = sm_scale * norm(v[..., j, :]) * terms[..., 0, :]
        err = max(err, (norm(got[..., j, :] - ref[..., j, :]) / size)
                  .max().item())
    return err


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels do not run on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


bf16 = torch.bfloat16


@pytest.mark.parametrize("T,S,D,dtype,causal,B,H", [
    (512, 512, 128, bf16, True, 2, 4),
    (200, 200, 128, bf16, True, 2, 4),
    (300, 200, 64, bf16, True, 2, 4),
    (1, 1, 16, bf16, True, 2, 4),
    (130, 96, 32, torch.float32, False, 2, 4),
    (256, 256, 128, torch.float32, True, 2, 4),
    # bf16 K1 (128 query rows a block, 64-key tiles at D 128, 128 below):
    # at and around the tile edges
    (127, 127, 128, bf16, True, 2, 4),
    (128, 128, 128, bf16, True, 2, 4),
    (129, 129, 128, bf16, True, 2, 4),
    (257, 257, 128, bf16, True, 2, 4),
    (129, 257, 128, bf16, False, 2, 4),
    (257, 127, 128, bf16, False, 2, 4),
    # causal T > S and T < S
    (257, 129, 128, bf16, True, 2, 4),
    (129, 257, 128, bf16, True, 2, 4),
    (200, 300, 64, bf16, True, 2, 4),
    # every head dim
    (200, 200, 16, bf16, True, 2, 4),
    (96, 130, 32, bf16, False, 2, 4),
    (257, 257, 64, bf16, True, 2, 4),
    # more blocks than an H100 has SMs (132): 512, and 256 from B*H alone
    (512, 512, 128, bf16, True, 8, 16),
    (128, 128, 64, bf16, False, 16, 16),
])
def test_flash_kernel_matches_plain_on_card(cuda_device, T, S, D, dtype,
                                            causal, B, H):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn(B, H, n, D, device=cuda_device,
                           generator=g).to(dtype) for n in (T, S, S))
    before = fa.LAUNCHES.count
    o, lse = fa.flash_forward(q, k, v, causal)
    torch.cuda.synchronize()
    assert fa.LAUNCHES.count == before + 1
    o_ref, lse_ref = fa._flash_plain(q, k, v, causal, 1 / math.sqrt(D))
    assert _row_rel_err(o, o_ref) <= ROW_TOL[dtype]
    assert (lse - lse_ref).abs().max().item() <= 1e-3


@pytest.mark.parametrize("D", [128, 32])
def test_flash_kernel_is_deterministic_on_card(cuda_device, D):
    """No atomics (each output row has one owner block) and a fixed order
    of products and sums: two launches of K1, of K2 and of K3 on the
    same inputs give the same bits."""
    g = torch.Generator(device=cuda_device).manual_seed(9)
    q, k, v, d_o = (torch.randn(4, 8, 333, D, device=cuda_device,
                                generator=g).to(bf16) for _ in range(4))
    first = fa._flash_cuda(q, k, v, True, 0.1)
    second = fa._flash_cuda(q, k, v, True, 0.1)
    do, delta = fa._bwd_inputs(q, first[0], d_o)
    runs = [fa._launch_dkv(q, k, v, do, first[1], delta, True, 0.1)
            + (fa._launch_dq(q, k, v, do, first[1], delta, True, 0.1),)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0])
    assert torch.equal(first[1], second[1])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("rows,F,dtype", [
    (2048, 1024, torch.bfloat16), (4, 1024, torch.bfloat16),
    (300, 1000, torch.float32)])
def test_layer_norm_kernel_matches_plain_on_card(cuda_device, rows, F,
                                                 dtype):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(rows, F, device=cuda_device, generator=g).to(dtype)
    gamma = (1 + 0.1 * torch.randn(F, device=cuda_device,
                                   generator=g)).to(dtype)
    beta = (0.1 * torch.randn(F, device=cuda_device, generator=g)).to(dtype)
    before = ln.LAUNCHES.count
    y = ln.fused_layer_norm(x, gamma, beta)
    torch.cuda.synchronize()
    assert ln.LAUNCHES.count == before + 1
    tol = 4e-2 if dtype == torch.bfloat16 else 1e-4
    ref = ln._layer_norm_plain(x, gamma, beta, 1e-5)
    assert (y.float() - ref.float()).abs().max().item() <= tol


def test_kernels_reject_what_they_do_not_take(cuda_device):
    # an f32 forward at a head dim up to 256 is padded to a built one (160
    # runs K1 and K6 at 192); past 256 the chunked forward takes it padded
    # to a multiple of 64
    g = torch.Generator(device=cuda_device).manual_seed(3)
    q, k, v = (torch.randn(1, 2, 16, 160, device=cuda_device, generator=g)
               for _ in range(3))
    counters = (fa.LAUNCHES, bs.LAUNCHES, fa.LAUNCHES_CHUNKED[torch.float32])
    before = [c.count for c in counters]
    o = fa.flash_attention(q, k, v)
    ob = bs.block_sparse_attention(q, k, v, np.ones((1, 1), bool))
    torch.cuda.synchronize()
    assert [c.count - n for c, n in zip(counters, before)] == [1, 1, 0]
    want = fa._flash_plain(q, k, v, False, 1 / math.sqrt(160))[0]
    assert _row_rel_err(o, want) <= ROW_TOL[torch.float32]
    assert _row_rel_err(ob, want) <= ROW_TOL[torch.float32]
    q = torch.randn(1, 2, 16, 32, device=cuda_device, dtype=torch.float16)
    with pytest.raises(TypeError):
        fa.flash_attention(q, q, q)
    # the (B, T, H, D).transpose(1, 2) layout every attention layer makes
    # is taken (it raised before): read in place in both dtypes; the plain
    # version's result, and the contiguous launch's bits
    for dtype in (bf16, torch.float32):
        q = torch.randn(1, 16, 2, 32, device=cuda_device,
                        generator=g).to(dtype).transpose(1, 2)
        copies = fa.OPERAND_COPIES.count
        o = fa.flash_attention(q, q, q)
        torch.cuda.synchronize()
        assert fa.OPERAND_COPIES.count == copies
        want = fa._flash_plain(q, q, q, False, 1 / math.sqrt(32))[0]
        assert _row_rel_err(o, want) <= ROW_TOL[dtype]
        qc = q.contiguous()
        assert torch.equal(o, fa.flash_attention(qc, qc, qc))


@pytest.mark.parametrize("T,S,D,dtype,causal,B,H", [
    (512, 512, 128, bf16, True, 2, 4),
    (200, 200, 128, bf16, True, 2, 4),
    (300, 200, 64, bf16, True, 2, 4),
    (200, 300, 64, bf16, True, 2, 4),
    (1, 1, 16, bf16, True, 2, 4),
    (96, 130, 32, bf16, False, 2, 4),
    (130, 96, 32, torch.float32, False, 2, 4),
    (256, 256, 128, torch.float32, True, 2, 4),
    # bf16 K2/K3 (128 output rows a block, 64-row streamed tiles): at and
    # around the tile edges
    (63, 63, 128, bf16, True, 2, 4),
    (64, 64, 128, bf16, True, 2, 4),
    (65, 65, 128, bf16, True, 2, 4),
    (127, 127, 128, bf16, True, 2, 4),
    (128, 128, 128, bf16, True, 2, 4),
    (129, 129, 128, bf16, True, 2, 4),
    (257, 257, 128, bf16, True, 2, 4),
    (65, 129, 128, bf16, False, 2, 4),
    (257, 63, 128, bf16, False, 2, 4),
    # causal T > S and T < S at D 128
    (257, 129, 128, bf16, True, 2, 4),
    (129, 257, 128, bf16, True, 2, 4),
    # every head dim
    (200, 200, 16, bf16, True, 2, 4),
    (129, 65, 32, bf16, True, 2, 4),
    (257, 257, 64, bf16, True, 2, 4),
    (64, 200, 16, bf16, False, 2, 4),
    # more blocks than an H100 has SMs (132): 512, and 256 from B*H alone
    (512, 512, 128, bf16, True, 8, 16),
    (128, 128, 64, bf16, False, 16, 16),
])
def test_flash_bwd_kernels_match_plain_on_card(cuda_device, T, S, D, dtype,
                                               causal, B, H):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    q, k, v = (torch.randn(B, H, n, D, device=cuda_device,
                           generator=g).to(dtype) for n in (T, S, S))
    d_o = torch.randn(B, H, T, D, device=cuda_device, generator=g).to(dtype)
    scale = 1 / math.sqrt(D)
    o, lse = fa._flash_cuda(q, k, v, causal, scale)
    before = (fa.LAUNCHES_DKV.count, fa.LAUNCHES_DQ.count)
    got = fa._flash_bwd_cuda(q, k, v, o, lse, d_o, causal, scale)
    torch.cuda.synchronize()
    assert (fa.LAUNCHES_DKV.count, fa.LAUNCHES_DQ.count) == (
        before[0] + 1, before[1] + 1)
    want = fa._flash_bwd_plain(q, k, v, o, lse, d_o, causal, scale)
    # one scale for the three: at T = S = 1 dq and dk vanish in exact
    # arithmetic and both sides hold rounding noise
    _check_attention_grads(got, want, dtype, _keep(T, S, causal, q.device),
                           k, v, d_o, scale)
    if causal and S > T:   # keys no query attends get exactly zero
        assert not got[1][:, :, T:].any() and not got[2][:, :, T:].any()


def _check_attention_grads(got, want, dtype, keep, k, v, d_o, sm_scale):
    """Each of (dq, dk, dv) row by row against the plain version's, at
    one scale for the three; dQ by ``_dq_row_err`` under ``keep`` ((T,
    S) bool), of inputs k, v and dO at ``sm_scale``."""
    largest = max(torch.linalg.vector_norm(b.float(), dim=-1).max().item()
                  for b in want)
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == b.shape
        assert torch.isfinite(a.float()).all()
    assert _dq_row_err(got[0], want[0], keep, k, v, d_o, sm_scale,
                       largest) <= ROW_TOL[dtype]
    for a, b in zip(got[1:], want[1:]):
        assert _row_rel_err(a, b, largest) <= ROW_TOL[dtype]


@pytest.mark.parametrize("D", [6, 8, 96])
@pytest.mark.parametrize("dtype", [bf16, torch.float32])
@pytest.mark.parametrize("which", ["flash", "block_sparse"])
def test_odd_head_dims_run_the_kernels_on_card(cuda_device, D, dtype, which):
    """A head dim the kernels are not built for is zero-padded to the
    next built one and cut back: forward and backward through the entry
    points launch K1-K3 (K6-K8) once each and match the plain versions
    on the unpadded inputs at the true sm_scale.

    O is held against the plain forward with q and k in f32: it rounds
    P to v's dtype where the kernels do and returns O unrounded.  A row
    here holds as few as 6 elements, and two bf16 roundings of one f32
    value may land one ulp apart (2^-8 to 2^-7 of the element), which in
    a row this short is that share of its norm; against the unrounded O
    the kernel's output rounds once, within half an ulp.  The gradients
    are held against the plain backward in the working dtype, whose
    rounding points (P, dS, the outputs) are the kernels'."""
    T = 200
    g = torch.Generator(device=cuda_device).manual_seed(14)
    q, k, v, d_o = (torch.randn(2, 4, T, D, device=cuda_device,
                                generator=g).to(dtype) for _ in range(4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    q32, k32 = q.float(), k.float()
    scale = 1 / math.sqrt(D)
    if which == "flash":
        counters = (fa.LAUNCHES, fa.LAUNCHES_DKV, fa.LAUNCHES_DQ)
        before = [c.count for c in counters]
        o, lse = fa.flash_forward(*leaves, causal=True)
        o_ref, lse_ref = fa._flash_plain(q32, k32, v, True, scale)
        got = torch.autograd.grad(o, leaves, d_o)
        want = fa._flash_bwd_plain(q, k, v, o.detach(), lse, d_o, True,
                                   scale)
    else:
        mask = bs.sliding_window_mask(5, 5, 2, 1, True, 40, 40)
        counters = (bs.LAUNCHES, bs.LAUNCHES_DKV, bs.LAUNCHES_DQ)
        before = [c.count for c in counters]
        o = bs.block_sparse_attention(*leaves, mask, causal=True)
        # the entry point returns O alone: the plain LSE stands for K6's
        o_ref, lse_ref = bs._bs_attention_plain(q32, k32, v, mask, True,
                                                scale)
        lse = lse_ref
        got = torch.autograd.grad(o, leaves, d_o)
        want = bs._bs_bwd_plain(q, k, v, o.detach(), lse_ref, d_o, mask,
                                True, scale)
    torch.cuda.synchronize()
    assert [c.count - n for c, n in zip(counters, before)] == [1, 1, 1]
    assert o.shape == (2, 4, T, D) and o.dtype == dtype
    assert o_ref.dtype == torch.float32
    assert _row_rel_err(o, o_ref) <= ROW_TOL[dtype]
    assert (lse - lse_ref).abs().max().item() <= 1e-3
    _check_attention_grads(got, want, dtype, _keep(
        T, T, True, q.device, None if which == "flash" else mask), k, v, d_o,
        scale)


@pytest.mark.parametrize("D", [160, 200, 256, 320, 300, 384, 512, 1024])
@pytest.mark.parametrize("dtype", [bf16, torch.float32])
@pytest.mark.parametrize("which", ["flash", "block_sparse"])
def test_wide_head_dims_run_the_chunked_kernels_on_card(cuda_device, D,
                                                        dtype, which):
    """Head dims above 128: up to 256 all three passes are zero-padded to
    192 or 256 and run the Hopper bodies in both dtypes (in f32 on split
    products); above 256 all three run the chunked kernels at D
    zero-padded to a multiple of 64 in both dtypes (one launch each under
    its dtype's ``LAUNCHES_CHUNKED``, ``LAUNCHES_DKV_CHUNKED`` and
    ``LAUNCHES_DQ_CHUNKED``), no operand copied.  Forward and backward
    through the entry points launch K1-K3 (K6-K8) once each and match the
    plain versions in the working dtype row by row, LSE within 1e-3."""
    T = 200
    g = torch.Generator(device=cuda_device).manual_seed(D)
    q, k, v, d_o = (torch.randn(2, 4, T, D, device=cuda_device,
                                generator=g).to(dtype) for _ in range(4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    scale = 1 / math.sqrt(D)
    if which == "flash":
        counters = (fa.LAUNCHES, fa.LAUNCHES_DKV, fa.LAUNCHES_DQ,
                    fa.OPERAND_COPIES, fa.LAUNCHES_CHUNKED[dtype],
                    fa.LAUNCHES_DKV_CHUNKED[dtype],
                    fa.LAUNCHES_DQ_CHUNKED[dtype])
        before = [c.count for c in counters]
        o, lse = fa.flash_forward(*leaves, causal=True)
        got = torch.autograd.grad(o, leaves, d_o)
        o_ref, lse_ref = fa._flash_plain(q, k, v, True, scale)
        want = fa._flash_bwd_plain(q, k, v, o.detach(), lse, d_o, True,
                                   scale)
    else:
        mask = bs.sliding_window_mask(5, 5, 2, 1, True, 40, 40)
        counters = (bs.LAUNCHES, bs.LAUNCHES_DKV, bs.LAUNCHES_DQ,
                    fa.OPERAND_COPIES, bs.LAUNCHES_CHUNKED[dtype],
                    bs.LAUNCHES_DKV_CHUNKED[dtype],
                    bs.LAUNCHES_DQ_CHUNKED[dtype])
        before = [c.count for c in counters]
        # the Function behind block_sparse_attention, which returns O alone
        o, lse = bs._BlockSparseAttention.apply(*leaves, mask, True, scale)
        got = torch.autograd.grad(o, leaves, d_o)
        o_ref, lse_ref = bs._bs_attention_plain(q, k, v, mask, True, scale)
        want = bs._bs_bwd_plain(q, k, v, o.detach(), lse, d_o, mask, True,
                                scale)
    torch.cuda.synchronize()
    above = int(D > 256)
    assert [c.count - n for c, n in zip(counters, before)] == [
        1, 1, 1, 0, above, above, above]
    assert o.shape == (2, 4, T, D) and o.dtype == dtype
    assert _row_rel_err(o, o_ref) <= ROW_TOL[dtype]
    assert (lse - lse_ref).abs().max().item() <= 1e-3
    _check_attention_grads(got, want, dtype, _keep(
        T, T, True, q.device, None if which == "flash" else mask), k, v, d_o,
        scale)


@pytest.mark.parametrize("D", [320, 512])
@pytest.mark.parametrize("dtype", [bf16, torch.float32])
def test_chunked_forward_of_k6_is_k1s_and_never_reads_dead_kv_on_card(
        cuda_device, D, dtype):
    """Above head dim 256 K6 runs K1's chunked forward over the 128-row
    query lists: on an all-ones causal mask at block 128 they visit the
    same key tiles in the same order with the same flags, so O and LSE
    are K1's bits, also at a ragged T 200 (block 40).  Under a mask at
    block 32 (partly live 64-key tiles, whose live rows the producer
    stages for every panel of K and for V's chunk) with NaN in every K/V
    row that no query may attend, O and LSE are finite and equal the
    clean run's bit for bit, and match the plain forward."""
    q, k, v, _ = _bs_inputs(512, 512, D, dtype, cuda_device, D + 3)
    scale = 1 / math.sqrt(D)
    for T, block in ((512, 128), (200, 40)):
        n = T // block
        ones = bs.BlockMask(np.ones((n, n), bool), block, block)
        got = bs._bs_fwd_cuda(q[:, :, :T], k[:, :, :T], v[:, :, :T], ones,
                              True, scale)
        want = fa._flash_cuda(q[:, :, :T], k[:, :, :T], v[:, :, :T], True,
                              scale)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    m = np.eye(16, dtype=bool)
    m[:, 0] = True
    m[9, 9] = False   # k block 9 is read by no query
    mask = bs.BlockMask(m, 32, 32)
    dead = ~bs._elementwise_keep(mask, True, cuda_device).any(dim=0)
    kp, vp = k.clone(), v.clone()
    kp[:, :, dead] = float("nan")
    vp[:, :, dead] = float("nan")
    runs = [bs._bs_fwd_cuda(q, kk, vv, mask, True, scale)
            for kk, vv in ((k, v), (kp, vp))]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.isfinite(b).all() and torch.equal(a, b)
    o_ref, lse_ref = bs._bs_attention_plain(q, k, v, mask, True, scale)
    assert _row_rel_err(runs[1][0], o_ref) <= ROW_TOL[dtype]
    assert (runs[1][1] - lse_ref).abs().max().item() <= 1e-3


@pytest.mark.parametrize("dtype", [bf16, torch.float32])
@pytest.mark.parametrize("which", ["flash", "block_sparse"])
def test_chunked_forward_reads_head_strided_operands_in_place_on_card(
        cuda_device, dtype, which):
    """q, k and v at head dim 320 in the (B, T, H, D).transpose(1, 2)
    layout an attention layer makes: the chunked forward reads them in
    place through its tensor maps (no operand copy) and gives, bit for
    bit, what the same values contiguous give, which match the plain
    forward row by row, LSE within 1e-3."""
    B, T, H, D = 2, 200, 4, 320
    g = torch.Generator(device=cuda_device).manual_seed(321)
    q, k, v = (torch.randn(B, T, H, D, device=cuda_device,
                           generator=g).to(dtype).transpose(1, 2)
               for _ in range(3))
    scale = 1 / math.sqrt(D)
    mask = bs.sliding_window_mask(5, 5, 2, 1, True, 40, 40)

    def run(*t):
        if which == "flash":
            return fa._flash_cuda(*t, True, scale)
        return bs._bs_fwd_cuda(*t, mask, True, scale)

    copies = fa.OPERAND_COPIES.count
    strided = run(q, k, v)
    torch.cuda.synchronize()
    assert fa.OPERAND_COPIES.count - copies == 0
    contiguous = run(q.contiguous(), k.contiguous(), v.contiguous())
    for a, b in zip(strided, contiguous):
        assert a.is_contiguous() and torch.equal(a, b)
    if which == "flash":
        o_ref, lse_ref = fa._flash_plain(q, k, v, True, scale)
    else:
        o_ref, lse_ref = bs._bs_attention_plain(q, k, v, mask, True, scale)
    assert _row_rel_err(strided[0], o_ref) <= ROW_TOL[dtype]
    assert (strided[1] - lse_ref).abs().max().item() <= 1e-3


def test_f32_chunked_forward_and_wide_backward_through_autograd_on_card(
        cuda_device):
    """f32 at head dim 320 through ``flash_attention``'s autograd: the
    chunked forward (one K1 launch, under ``LAUNCHES_CHUNKED``) and the
    chunked dK/dV and dQ (one launch each, under the f32
    ``LAUNCHES_DKV_CHUNKED`` and ``LAUNCHES_DQ_CHUNKED``, none under the
    bf16 ones), O, LSE and the
    gradients against the CPU plain version row by row within the f32
    limit.  The gradient of a key bias, the sum of dK over the key rows
    (0 in exact arithmetic), stays at rounding level: within twice what
    the same chunked backward reads from the plain forward's O and LSE
    on the card, or the CPU plain pipeline's, whichever is larger (the
    split products' O must agree with the backward's recomputed P . V to
    f32 rounding, and the backward's scores, summed over the panels, with
    the forward's LSE: ``tests/test_torch_f32_split.py``)."""
    B, H, T, D = 2, 4, 130, 320
    g = torch.Generator().manual_seed(320)
    q, k, v, d_o = (torch.randn(B, H, T, D, generator=g) for _ in range(4))
    scale = 1 / math.sqrt(D)
    counters = (fa.LAUNCHES, fa.LAUNCHES_DKV, fa.LAUNCHES_DQ,
                fa.LAUNCHES_DKV_CHUNKED[bf16],
                fa.LAUNCHES_CHUNKED[torch.float32],
                fa.LAUNCHES_DKV_CHUNKED[torch.float32],
                fa.LAUNCHES_DQ_CHUNKED[torch.float32])
    before = [c.count for c in counters]
    leaves = [t.to(cuda_device).requires_grad_() for t in (q, k, v)]
    o, lse = fa.flash_forward(*leaves, causal=True)
    got = torch.autograd.grad(o, leaves, d_o.to(cuda_device))
    torch.cuda.synchronize()
    assert [c.count - n for c, n in zip(counters, before)] == [
        1, 1, 1, 0, 1, 1, 1]
    cpu = [t.clone().requires_grad_() for t in (q, k, v)]
    o_cpu, lse_cpu = fa.flash_forward(*cpu, causal=True)
    want = torch.autograd.grad(o_cpu, cpu, d_o)
    assert _row_rel_err(o.cpu(), o_cpu) <= ROW_TOL[torch.float32]
    assert (lse.cpu() - lse_cpu).abs().max().item() <= 1e-3
    _check_attention_grads([a.cpu() for a in got], want, torch.float32,
                           _keep(T, T, True, "cpu"), k, v, d_o, scale)
    qd, kd, vd = (t.detach() for t in leaves)
    o_plain, lse_plain = fa._flash_plain(qd, kd, vd, True, scale)
    dk_plain = fa._flash_bwd_cuda(qd, kd, vd, o_plain, lse_plain,
                                  d_o.to(cuda_device), True, scale)[1]

    def bias(dk):
        return dk.double().sum(dim=2).norm().item()

    level = max(bias(dk_plain), bias(want[1]))
    assert bias(got[1]) <= 2 * level, (bias(got[1]), level)


@pytest.mark.parametrize("D", [64, 128, 256, 320])
@pytest.mark.parametrize("which", ["flash", "block_sparse"])
def test_head_strided_layout_is_read_in_place_on_card(cuda_device, D, which):
    """bf16 q, k, v and dO in the (B, T, H, D).transpose(1, 2) layout an
    attention layer makes: forward and backward through the entry points
    read them in place (no copy, at D 256 and on the chunked kernels at
    320 too) and give, bit for bit, what the same values contiguous give,
    which match the plain versions row by row."""
    B, T, H = 2, 200, 4
    g = torch.Generator(device=cuda_device).manual_seed(D + 1)
    q, k, v, d_o = (torch.randn(B, T, H, D, device=cuda_device,
                                generator=g).to(bf16).transpose(1, 2)
                    for _ in range(4))
    scale = 1 / math.sqrt(D)
    mask = bs.sliding_window_mask(5, 5, 2, 1, True, 40, 40)

    def run(q, k, v, d_o):
        leaves = [t.detach().clone(memory_format=torch.preserve_format)
                  .requires_grad_() for t in (q, k, v)]
        if which == "flash":
            o, lse = fa.flash_forward(*leaves, causal=True)
        else:
            o, lse = bs._BlockSparseAttention.apply(*leaves, mask, True,
                                                    scale)
        return (o, lse) + torch.autograd.grad(o, leaves, d_o)

    copies = fa.OPERAND_COPIES.count
    strided = run(q, k, v, d_o)
    torch.cuda.synchronize()
    assert fa.OPERAND_COPIES.count - copies == 0
    contiguous = run(*(t.contiguous() for t in (q, k, v, d_o)))
    for a, b in zip(strided, contiguous):
        assert a.is_contiguous() and torch.equal(a, b)
    o, lse, *grads = strided
    if which == "flash":
        o_ref, lse_ref = fa._flash_plain(q, k, v, True, scale)
        want = fa._flash_bwd_plain(q, k, v, o.detach(), lse, d_o, True,
                                   scale)
    else:
        o_ref, lse_ref = bs._bs_attention_plain(q, k, v, mask, True, scale)
        want = bs._bs_bwd_plain(q, k, v, o.detach(), lse, d_o, mask, True,
                                scale)
    assert _row_rel_err(o, o_ref) <= ROW_TOL[bf16]
    assert (lse - lse_ref).abs().max().item() <= 1e-3
    _check_attention_grads(grads, want, bf16, _keep(
        T, T, True, q.device, None if which == "flash" else mask), k, v, d_o,
        scale)


@pytest.mark.parametrize("D", [192, 256])
@pytest.mark.parametrize("block", [None, 128, 32])
def test_bf16_dq_of_64_row_blocks_repeats_its_bits_on_card(cuda_device, D,
                                                            block):
    """K3 (block None) and K8 (block-sparse at block 128, whole tiles, and
    at block 32, partial pairs staged) at D 192 and 256, on the 64-row dQ
    block: two launches on the same inputs give the same bits, no launch
    is counted as chunked, and dQ matches the plain version row by row.
    Under the block mask, NaN in every K/V row that no query may attend
    changes no bit of O, LSE, dQ, dK or dV: such a row is never loaded,
    or zero-filled where a partial pair is staged."""
    T = 512
    g = torch.Generator(device=cuda_device).manual_seed(D + (block or 0))
    q, k, v, d_o = (torch.randn(2, 4, T, D, device=cuda_device,
                                generator=g).to(bf16) for _ in range(4))
    scale = 1 / math.sqrt(D)
    chunked = (fa if block is None else bs).LAUNCHES_DQ_CHUNKED[bf16]
    before_chunked = chunked.count
    if block is None:
        o, lse = fa._flash_cuda(q, k, v, True, scale)
        do, delta = fa._bwd_inputs(q, o, d_o)
        before = fa.LAUNCHES_DQ.count
        runs = [fa._launch_dq(q, k, v, do, lse, delta, True, scale)
                for _ in range(2)]
        torch.cuda.synchronize()
        assert fa.LAUNCHES_DQ.count - before == 2
        want = fa._flash_bwd_plain(q, k, v, o, lse, d_o, True, scale)
    else:
        n = T // block
        m = np.eye(n, dtype=bool)
        m[:, 0] = True
        m[n // 2, n // 2] = False   # k block n / 2 is read by no query
        mask = bs.BlockMask(m, block, block)
        dead = ~bs._elementwise_keep(mask, True, cuda_device).any(dim=0)
        kp, vp = k.clone(), v.clone()
        kp[:, :, dead] = float("nan")
        vp[:, :, dead] = float("nan")
        before = bs.LAUNCHES_DQ.count
        outs = []
        for kk, vv in ((k, v), (k, v), (kp, vp)):
            o, lse = bs._bs_fwd_cuda(q, kk, vv, mask, True, scale)
            outs.append((o, lse) + bs._bs_bwd_cuda(q, kk, vv, o, lse, d_o,
                                                    mask, True, scale))
        torch.cuda.synchronize()
        assert bs.LAUNCHES_DQ.count - before == 3
        assert int(dead.sum()) == block
        for a, b in zip(outs[0], outs[2]):   # clean and poisoned
            assert torch.equal(a, b)
        runs = [r[2] for r in outs[:2]]
        o, lse = outs[0][:2]
        want = bs._bs_bwd_plain(q, k, v, o, lse, d_o, mask, True, scale)
    assert chunked.count == before_chunked
    assert torch.equal(runs[0], runs[1])
    largest = max(torch.linalg.vector_norm(b.float(), dim=-1).max().item()
                  for b in want)
    assert torch.isfinite(runs[0].float()).all()
    assert _row_rel_err(runs[0], want[0], largest) <= ROW_TOL[bf16]


# (T, S, D, causal, layout, bq, bk): the f32 dK/dV (K2, and K7 under a
# block mask of bq x bk blocks) at every head dim it is built for, causal
# and not, ragged T != S, and q, k, v and dO in the head-strided layout of
# an attention layer; at D 192 and 256 (the block's own rows split into
# registers, 32-row streamed tiles) causal T = S, one query row, one
# 64-row block, a ragged edge past it, and the head-strided layout at a
# ragged T
F32_DKV_CASES = {
    "D16_causal": (200, 200, 16, True, "contiguous", 40, 40),
    "D32_noncausal_T130_S96": (130, 96, 32, False, "contiguous", 26, 32),
    "D64_causal_T264_S136": (264, 136, 64, True, "contiguous", 24, 8),
    "D128_causal": (512, 512, 128, True, "contiguous", 32, 32),
    "D128_causal_T200_S300": (200, 300, 128, True, "contiguous", 40, 60),
    "D64_strided_causal": (200, 200, 64, True, "strided", 40, 40),
    "D128_strided_noncausal_T136_S264": (136, 264, 128, False, "strided", 8,
                                         24),
    "D192_causal": (512, 512, 192, True, "contiguous", 32, 32),
    "D256_causal": (512, 512, 256, True, "contiguous", 32, 32),
    "D192_causal_T1": (1, 1, 192, True, "contiguous", 1, 1),
    "D256_causal_T1": (1, 1, 256, True, "contiguous", 1, 1),
    "D192_causal_T64": (64, 64, 192, True, "contiguous", 32, 32),
    "D256_causal_T64": (64, 64, 256, True, "contiguous", 32, 32),
    "D192_noncausal_T65_S130": (65, 130, 192, False, "contiguous", 13, 26),
    "D256_noncausal_T65_S130": (65, 130, 256, False, "contiguous", 13, 26),
    "D192_strided_causal_T264": (264, 264, 192, True, "strided", 24, 24),
    "D256_strided_noncausal_T136_S264": (136, 264, 256, False, "strided", 8,
                                         24),
}
# the same, above head dim 256: the f32 chunked backward (300 padded to
# 320), one query row, T 64, the ragged non-causal T 65 x S 130 and the
# head-strided layout at 320
F32_CHUNKED_CASES = {
    "D320_causal_T1": (1, 1, 320, True, "contiguous", 1, 1),
    "D1024_causal_T1": (1, 1, 1024, True, "contiguous", 1, 1),
    "D300_causal_T64": (64, 64, 300, True, "contiguous", 32, 32),
    "D384_causal_T64": (64, 64, 384, True, "contiguous", 32, 32),
    "D512_causal_T64": (64, 64, 512, True, "contiguous", 32, 32),
    "D300_noncausal_T65_S130": (65, 130, 300, False, "contiguous", 13, 26),
    "D320_noncausal_T65_S130": (65, 130, 320, False, "contiguous", 13, 26),
    "D512_noncausal_T65_S130": (65, 130, 512, False, "contiguous", 13, 26),
    "D1024_noncausal_T65_S130": (65, 130, 1024, False, "contiguous", 13,
                                 26),
    "D320_strided_causal_T264": (264, 264, 320, True, "strided", 24, 24),
    "D320_strided_noncausal_T136_S264": (136, 264, 320, False, "strided", 8,
                                         24),
}
F32_BWD_CASES = {**F32_DKV_CASES, **F32_CHUNKED_CASES}


def _f32_dkv_mask(T, S, bq, bk):
    """A random block mask (density 0.6) over (T / bq, S / bk) blocks with
    the first key block live for every query block and the last key
    block read by no query."""
    m = np.random.RandomState(T + S).rand(T // bq, S // bk) < 0.6
    m[:, 0] = True
    m[:, -1] = False
    return bs.BlockMask(m, bq, bk)


@pytest.mark.parametrize("case", sorted(F32_BWD_CASES))
@pytest.mark.parametrize("which", ["flash", "block_sparse"])
def test_f32_dkv_runs_the_split_products_on_card(cuda_device, case, which):
    """The f32 K2 (flash) and K7 (block-sparse) on the Hopper dK/dV block
    whose f32 products are formed from bf16 products on three bf16 pieces
    of their operands: one launch per call,
    no wide launch, q, k, v and dO read where they lie (no operand copy,
    the head-strided layout too), dK and dV row by row within the f32
    limit of the plain backward (one scale for both; a key row whose
    queries attend it alone, 0 in exact arithmetic, against its terms'
    size, ``_dk_row_err``), and two launches give the same bits.  At D
    192 and 256 each launch also counts under that head dim's counter,
    above 256 (the chunked backward) under ``LAUNCHES_DKV_CHUNKED``."""
    T, S, D, causal, layout, bq, bk = F32_BWD_CASES[case]
    g = torch.Generator(device=cuda_device).manual_seed(T * 7 + D)

    def make(rows):
        if layout == "strided":
            return torch.randn(2, rows, 4, D, device=cuda_device,
                               generator=g).transpose(1, 2)
        return torch.randn(2, 4, rows, D, device=cuda_device, generator=g)

    q, k, v, d_o = make(T), make(S), make(S), make(T)
    scale = 1 / math.sqrt(D)
    mask = None
    if which == "block_sparse":
        mask = _f32_dkv_mask(T, S, bq, bk) if T > 1 else bs.BlockMask(
            np.ones((1, 1), bool), 1, 1)
    if mask is None:
        o, lse = fa._flash_cuda(q, k, v, causal, scale)
        counter = fa.LAUNCHES_DKV

        def launch():
            return fa._launch_dkv(q, k, v, do, lse, delta, causal, scale)
    else:
        o, lse = bs._bs_fwd_cuda(q, k, v, mask, causal, scale)
        counter = bs.LAUNCHES_DKV

        def launch():
            return bs._launch_bs_dkv(q, k, v, do, lse, delta, mask, causal,
                                     scale)
    do, delta = fa._bwd_inputs(q, o, d_o)
    mod = fa if mask is None else bs
    by_dim = mod.LAUNCHES_DKV_F32.get(D)
    chunked = mod.LAUNCHES_DKV_CHUNKED[torch.float32]

    def tally():
        return (counter.count, fa.OPERAND_COPIES.count,
                mod.LAUNCHES_DKV_CHUNKED[bf16].count,
                by_dim.count if by_dim else 0, chunked.count)

    counts = tally()
    runs = [launch(), launch()]
    torch.cuda.synchronize()
    assert tally() == (counts[0] + 2, counts[1], counts[2],
                       counts[3] + (2 if by_dim else 0),
                       counts[4] + 2 * (D > 256))
    for a, b in zip(*runs):
        assert a.dtype == torch.float32 and a.is_contiguous()
        assert torch.equal(a, b)
    if mask is None:
        want = fa._flash_bwd_plain(q, k, v, o, lse, d_o, causal, scale)[1:]
    else:
        want = bs._bs_bwd_plain(q, k, v, o, lse, d_o, mask, causal,
                                scale)[1:]
    largest = max(torch.linalg.vector_norm(b, dim=-1).max().item()
                  for b in want)
    for a in runs[0]:
        assert torch.isfinite(a).all()
    # a key row whose queries attend it alone (one query row at T 1) reads
    # against its terms' size (``_dk_row_err``)
    keep = _keep(T, S, causal, cuda_device, mask)
    assert _dk_row_err(runs[0][0], want[0], keep, q, v, d_o, scale,
                       largest) <= ROW_TOL[torch.float32]
    assert _row_rel_err(runs[0][1], want[1], largest) \
        <= ROW_TOL[torch.float32]
    if mask is not None and T > 1:   # the dead key block's rows are zero
        assert not runs[0][0][:, :, S - bk:].any()
        assert not runs[0][1][:, :, S - bk:].any()


# (T, S, D, causal, layout, bq, bk): the f32 forward (K1, and K6 under a
# block mask of bq x bk blocks): the dK/dV cases (at D 192 and 256, q split
# into registers, 32-key tiles), one query row, and the edges of a
# 128-row block (the second 64-row q tile partly or wholly past T)
F32_FWD_CASES = dict(
    F32_DKV_CASES,
    D16_causal_T1=(1, 1, 16, True, "contiguous", 1, 1),
    D128_causal_T64=(64, 64, 128, True, "contiguous", 32, 32),
    D32_noncausal_T65_S130=(65, 130, 32, False, "contiguous", 13, 26),
    D128_strided_causal_T264=(264, 264, 128, True, "strided", 24, 24))


@pytest.mark.parametrize("case", sorted(F32_FWD_CASES))
@pytest.mark.parametrize("which", ["flash", "block_sparse"])
def test_f32_forward_runs_the_split_products_on_card(cuda_device, case,
                                                     which):
    """The f32 K1 (flash) and K6 (block-sparse) on the Hopper forward
    body whose f32 products are formed from bf16 products on bf16 pieces
    of their operands: one launch per call, no wide launch, q, k and v
    read where they lie (no operand copy, the head-strided layout too,
    whose O and LSE are the contiguous launch's bits), O row by row
    within the f32 limit of the plain forward and LSE within 1e-3, and
    two launches give the same bits.  At D 192 and 256 each launch also
    counts under that head dim's counter."""
    T, S, D, causal, layout, bq, bk = F32_FWD_CASES[case]
    g = torch.Generator(device=cuda_device).manual_seed(T * 5 + D)

    def make(rows):
        if layout == "strided":
            return torch.randn(2, rows, 4, D, device=cuda_device,
                               generator=g).transpose(1, 2)
        return torch.randn(2, 4, rows, D, device=cuda_device, generator=g)

    q, k, v = make(T), make(S), make(S)
    scale = 1 / math.sqrt(D)
    if which == "flash":
        counter = fa.LAUNCHES

        def launch(*t):
            return fa._flash_cuda(*t, causal, scale)

        want = fa._flash_plain(q, k, v, causal, scale)
    else:
        mask = _f32_dkv_mask(T, S, bq, bk) if T > 1 else bs.BlockMask(
            np.ones((1, 1), bool), 1, 1)
        counter = bs.LAUNCHES

        def launch(*t):
            return bs._bs_fwd_cuda(*t, mask, causal, scale)

        want = bs._bs_attention_plain(q, k, v, mask, causal, scale)
    mod = fa if which == "flash" else bs
    by_dim = mod.LAUNCHES_F32.get(D)

    def tally():
        return (counter.count, fa.OPERAND_COPIES.count,
                mod.LAUNCHES_CHUNKED[bf16].count,
                by_dim.count if by_dim else 0)

    counts = tally()
    runs = [launch(q, k, v), launch(q, k, v)]
    torch.cuda.synchronize()
    assert tally() == (counts[0] + 2, counts[1], counts[2],
                       counts[3] + (2 if by_dim else 0))
    for a, b in zip(*runs):
        assert a.dtype == torch.float32 and a.is_contiguous()
        assert torch.equal(a, b)
    o, lse = runs[0]
    assert torch.isfinite(o).all()
    assert _row_rel_err(o, want[0]) <= ROW_TOL[torch.float32]
    assert (lse - want[1]).abs().max().item() <= 1e-3
    if layout == "strided":
        same = launch(q.contiguous(), k.contiguous(), v.contiguous())
        assert torch.equal(o, same[0]) and torch.equal(lse, same[1])


@pytest.mark.parametrize("D", [16, 32, 64, 128, 192, 256])
def test_f32_forward_of_k6_is_k1s_and_never_reads_dead_kv_on_card(
        cuda_device, D):
    """The f32 K6 runs K1's f32 body over the 128-row query lists: on an
    all-ones causal mask at block 128 they visit the same key tiles (64
    keys; at D 192 and 256 32, each list step streamed as two halves) in
    the same order with the same flags, so O and LSE are K1's bits, also
    at a ragged T 200 (block 40).  Under a mask at block 32 with NaN in
    every K/V row that no query may attend, O and LSE equal the clean
    run's bit for bit."""
    q, k, v, _ = _bs_inputs(512, 512, D, torch.float32, cuda_device, D + 1)
    scale = 1 / math.sqrt(D)
    for T, block in ((512, 128), (200, 40)):
        n = T // block
        ones = bs.BlockMask(np.ones((n, n), bool), block, block)
        got = bs._bs_fwd_cuda(q[:, :, :T], k[:, :, :T], v[:, :, :T], ones,
                              True, scale)
        want = fa._flash_cuda(q[:, :, :T], k[:, :, :T], v[:, :, :T], True,
                              scale)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    m = np.eye(16, dtype=bool)
    m[:, 0] = True
    m[9, 9] = False   # k block 9 is read by no query
    mask = bs.BlockMask(m, 32, 32)
    dead = ~bs._elementwise_keep(mask, True, cuda_device).any(dim=0)
    kp, vp = k.clone(), v.clone()
    kp[:, :, dead] = float("nan")
    vp[:, :, dead] = float("nan")
    runs = [bs._bs_fwd_cuda(q, kk, vv, mask, True, scale)
            for kk, vv in ((k, v), (kp, vp))]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.isfinite(b).all() and torch.equal(a, b)


@pytest.mark.parametrize("D", [16, 32, 64, 128, 192, 256])
def test_f32_dkv_of_k7_is_k2s_and_never_reads_dead_kv_on_card(cuda_device,
                                                               D):
    """The f32 K7 runs K2's body over its 64-row key lists: on an
    all-ones causal mask at block 128 they visit the same query tiles in
    the same order (at D 192 and 256 each list step streamed as two
    32-row halves), so K7 = K2 bit for bit (fed the same O, LSE, dO and
    delta).  Under a mask at block 32 with NaN in every K/V row that no
    query may attend, O, LSE, dQ, dK and dV equal the clean run's bit for
    bit: such a row is never loaded, or zero-filled where a partial pair
    is staged, and a dead row of the block's own K or V is selected
    away."""
    q, k, v, d_o = _bs_inputs(512, 512, D, torch.float32, cuda_device, D)
    scale = 1 / math.sqrt(D)
    ones = bs.BlockMask(np.ones((4, 4), bool), 128, 128)
    o, lse = bs._bs_fwd_cuda(q, k, v, ones, True, scale)
    do, delta = fa._bwd_inputs(q, o, d_o)
    got = bs._launch_bs_dkv(q, k, v, do, lse, delta, ones, True, scale)
    want = fa._launch_dkv(q, k, v, do, lse, delta, True, scale)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    m = np.eye(16, dtype=bool)
    m[:, 0] = True
    m[9, 9] = False   # k block 9 is read by no query
    mask = bs.BlockMask(m, 32, 32)
    dead = ~bs._elementwise_keep(mask, True, cuda_device).any(dim=0)
    assert int(dead.sum()) == 32
    kp, vp = k.clone(), v.clone()
    kp[:, :, dead] = float("nan")
    vp[:, :, dead] = float("nan")
    runs = []
    for kk, vv in ((k, v), (kp, vp)):
        o, lse = bs._bs_fwd_cuda(q, kk, vv, mask, True, scale)
        runs.append((o, lse) + bs._bs_bwd_cuda(q, kk, vv, o, lse, d_o, mask,
                                                True, scale))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.isfinite(b).all() and torch.equal(a, b)


# (T, S, D, causal, layout, bq, bk): the f32 dQ (K3, and K8 under a block
# mask of bq x bk blocks): the dK/dV cases (at D 192 and 256, Q and dO
# split into registers, 32-key tiles), one query row, the edge of a
# 64-row block and keys past it
F32_DQ_CASES = dict(
    F32_DKV_CASES,
    D16_causal_T1=(1, 1, 16, True, "contiguous", 1, 1),
    D128_causal_T64=(64, 64, 128, True, "contiguous", 32, 32),
    D32_noncausal_T65_S130=(65, 130, 32, False, "contiguous", 13, 26),
    D128_strided_causal_T264=(264, 264, 128, True, "strided", 24, 24),
    **F32_CHUNKED_CASES)


@pytest.mark.parametrize("case", sorted(F32_DQ_CASES))
@pytest.mark.parametrize("which", ["flash", "block_sparse"])
def test_f32_dq_runs_the_split_products_on_card(cuda_device, case, which):
    """The f32 K3 (flash) and K8 (block-sparse) on the 64-row Hopper dQ
    block whose f32 products are formed from bf16 products on three bf16
    pieces of their operands: one launch per call, no wide launch, q, k,
    v and dO read where they lie (no operand copy, the head-strided layout
    too, whose dQ is the contiguous launch's bits), dQ row by row within
    the f32 limit of the plain backward (one scale for dQ, dK and dV; a
    row with one live key against its terms' size, ``_dq_row_err``), and
    two launches give the same bits.  At D 192 and 256 each launch also
    counts under that head dim's counter, above 256 (the chunked
    backward) under ``LAUNCHES_DQ_CHUNKED``."""
    T, S, D, causal, layout, bq, bk = F32_DQ_CASES[case]
    g = torch.Generator(device=cuda_device).manual_seed(T * 3 + D)

    def make(rows):
        if layout == "strided":
            return torch.randn(2, rows, 4, D, device=cuda_device,
                               generator=g).transpose(1, 2)
        return torch.randn(2, 4, rows, D, device=cuda_device, generator=g)

    q, k, v, d_o = make(T), make(S), make(S), make(T)
    scale = 1 / math.sqrt(D)
    if which == "flash":
        o, lse = fa._flash_cuda(q, k, v, causal, scale)
        counter = fa.LAUNCHES_DQ

        def launch(*t):
            return fa._launch_dq(*t, lse, delta, causal, scale)

        want = None
    else:
        mask = _f32_dkv_mask(T, S, bq, bk) if T > 1 else bs.BlockMask(
            np.ones((1, 1), bool), 1, 1)
        o, lse = bs._bs_fwd_cuda(q, k, v, mask, causal, scale)
        counter = bs.LAUNCHES_DQ

        def launch(*t):
            return bs._launch_bs_dq(*t, lse, delta, mask, causal, scale)

    do, delta = fa._bwd_inputs(q, o, d_o)
    mod = fa if which == "flash" else bs
    by_dim = mod.LAUNCHES_DQ_F32.get(D)
    chunked = mod.LAUNCHES_DQ_CHUNKED[torch.float32]

    def tally():
        return (counter.count, fa.OPERAND_COPIES.count,
                mod.LAUNCHES_DQ_CHUNKED[bf16].count,
                by_dim.count if by_dim else 0, chunked.count)

    counts = tally()
    runs = [launch(q, k, v, do), launch(q, k, v, do)]
    torch.cuda.synchronize()
    assert tally() == (counts[0] + 2, counts[1], counts[2],
                       counts[3] + (2 if by_dim else 0),
                       counts[4] + 2 * (D > 256))
    assert runs[0].dtype == torch.float32 and runs[0].is_contiguous()
    assert torch.equal(runs[0], runs[1])
    if which == "flash":
        want = fa._flash_bwd_plain(q, k, v, o, lse, d_o, causal, scale)
        keep = _keep(T, S, causal, cuda_device)
    else:
        want = bs._bs_bwd_plain(q, k, v, o, lse, d_o, mask, causal, scale)
        keep = _keep(T, S, causal, cuda_device, mask)
    largest = max(torch.linalg.vector_norm(b, dim=-1).max().item()
                  for b in want)
    assert torch.isfinite(runs[0]).all()
    assert _dq_row_err(runs[0], want[0], keep, k, v, d_o, scale,
                       largest) <= ROW_TOL[torch.float32]
    if layout == "strided":
        same = launch(*(t.contiguous() for t in (q, k, v, do)))
        assert torch.equal(runs[0], same)


@pytest.mark.parametrize("D", [16, 32, 64, 128, 192, 256])
def test_f32_dq_of_k8_is_k3s_and_never_reads_dead_kv_on_card(cuda_device,
                                                             D):
    """The f32 K8 runs K3's f32 body over its 64-row query lists: on an
    all-ones causal mask at block 128 (and at a ragged T 200, block 40)
    they visit the same key tiles in the same order (at D 192 and 256
    each list step streamed as two 32-key halves), so K8 = K3 bit for
    bit (fed the same O, LSE, dO and delta).  Under a mask at block 32
    with NaN in every K/V row that no query may attend, dQ (and O, LSE,
    dK, dV) equal the clean run's bit for bit."""
    q, k, v, d_o = _bs_inputs(512, 512, D, torch.float32, cuda_device,
                              D + 2)
    scale = 1 / math.sqrt(D)
    for T, block in ((512, 128), (200, 40)):
        n = T // block
        ones = bs.BlockMask(np.ones((n, n), bool), block, block)
        qt, kt, vt, dt = (t[:, :, :T] for t in (q, k, v, d_o))
        o, lse = bs._bs_fwd_cuda(qt, kt, vt, ones, True, scale)
        do, delta = fa._bwd_inputs(qt, o, dt)
        got = bs._launch_bs_dq(qt, kt, vt, do, lse, delta, ones, True, scale)
        want = fa._launch_dq(qt, kt, vt, do, lse, delta, True, scale)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    m = np.eye(16, dtype=bool)
    m[:, 0] = True
    m[9, 9] = False   # k block 9 is read by no query
    mask = bs.BlockMask(m, 32, 32)
    dead = ~bs._elementwise_keep(mask, True, cuda_device).any(dim=0)
    kp, vp = k.clone(), v.clone()
    kp[:, :, dead] = float("nan")
    vp[:, :, dead] = float("nan")
    runs = []
    for kk, vv in ((k, v), (kp, vp)):
        o, lse = bs._bs_fwd_cuda(q, kk, vv, mask, True, scale)
        runs.append((o, lse) + bs._bs_bwd_cuda(q, kk, vv, o, lse, d_o, mask,
                                                True, scale))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.isfinite(b).all() and torch.equal(a, b)


def _chunked_k7_k8_are_k2_k3s(cuda_device, D, dtype):
    """K7 and K8 above head dim 256 in ``dtype``: K7 = K2 and K8 = K3 bit
    for bit on all-ones causal masks at block 128 (and at a ragged T 200,
    block 40), fed the same O, LSE, dO and delta; under a mask at block
    32 with NaN in every K/V row that no query may attend, O, LSE, dQ, dK
    and dV finite and equal to the clean run's bit for bit, the gradients
    matching the plain backward row by row."""
    q, k, v, d_o = _bs_inputs(512, 512, D, dtype, cuda_device, D + 5)
    scale = 1 / math.sqrt(D)
    for T, block in ((512, 128), (200, 40)):
        n = T // block
        ones = bs.BlockMask(np.ones((n, n), bool), block, block)
        qt, kt, vt, dt = (t[:, :, :T] for t in (q, k, v, d_o))
        o, lse = bs._bs_fwd_cuda(qt, kt, vt, ones, True, scale)
        do, delta = fa._bwd_inputs(qt, o, dt)
        args = (qt, kt, vt, do, lse, delta)
        got = bs._launch_bs_dkv(*args, ones, True, scale) + (
            bs._launch_bs_dq(*args, ones, True, scale),)
        want = fa._launch_dkv(*args, True, scale) + (
            fa._launch_dq(*args, True, scale),)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    m = np.eye(16, dtype=bool)
    m[:, 0] = True
    m[9, 9] = False   # k block 9 is read by no query
    mask = bs.BlockMask(m, 32, 32)
    dead = ~bs._elementwise_keep(mask, True, cuda_device).any(dim=0)
    assert int(dead.sum()) == 32
    kp, vp = k.clone(), v.clone()
    kp[:, :, dead] = float("nan")
    vp[:, :, dead] = float("nan")
    runs = []
    for kk, vv in ((k, v), (kp, vp)):
        o, lse = bs._bs_fwd_cuda(q, kk, vv, mask, True, scale)
        runs.append((o, lse) + bs._bs_bwd_cuda(q, kk, vv, o, lse, d_o, mask,
                                                True, scale))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.isfinite(b).all() and torch.equal(a, b)
    o, lse = runs[0][:2]
    want = bs._bs_bwd_plain(q, k, v, o, lse, d_o, mask, True, scale)
    _check_attention_grads(runs[0][2:], want, dtype,
                           _keep(512, 512, True, cuda_device, mask), k, v,
                           d_o, scale)


@pytest.mark.parametrize("D", [320, 512])
def test_f32_chunked_k7_k8_are_k2_k3s_and_never_read_dead_kv_on_card(
        cuda_device, D):
    """Above head dim 256 the f32 K7 and K8 run K2's and K3's chunked
    backward over their 64-row key and query lists: on an all-ones causal
    mask at block 128 (and at a ragged T 200, block 40) they visit the
    same tiles in the same order, each list step streamed as two 32-row
    halves, so K7 = K2 and K8 = K3 bit for bit (fed the same O, LSE, dO
    and delta).  Under a mask at block 32 (partly live tiles, whose live
    rows the producer stages for every panel and chunk operand) with NaN
    in every K/V row that no query may attend, O, LSE, dQ, dK and dV are
    finite and equal the clean run's bit for bit, and the gradients
    match the plain backward row by row (``_chunked_k7_k8_are_k2_k3s``)."""
    _chunked_k7_k8_are_k2_k3s(cuda_device, D, torch.float32)


@pytest.mark.parametrize("D", [320, 512])
def test_bf16_chunked_k7_k8_are_k2_k3s_and_never_read_dead_kv_on_card(
        cuda_device, D):
    """Above head dim 256 the bf16 K7 and K8 run K2's and K3's chunked
    backward (their bf16 consumers) over the 64-row key and query lists,
    each list step one 64-row tile: K7 = K2 and K8 = K3 bit for bit on
    all-ones masks, NaN in dead K/V rows changes no bit (a partial pair's
    live rows staged for every panel and chunk operand), and the
    gradients match the plain backward row by row at the bf16 limit
    (``_chunked_k7_k8_are_k2_k3s``)."""
    _chunked_k7_k8_are_k2_k3s(cuda_device, D, bf16)


# (T, S, D, causal): the bf16 chunked backward at a causal T not a
# multiple of 64, T != S not causal, one query row, a long ragged head
# dim (300 padded to 320) and D 1024 (four chunks)
BF16_CHUNKED_CASES = {
    "D320_causal_T200": (200, 200, 320, True),
    "D384_noncausal_T130_S200": (130, 200, 384, False),
    "D512_causal_T1": (1, 1, 512, True),
    "D300_causal_T129": (129, 129, 300, True),
    "D1024_causal_T129": (129, 129, 1024, True),
}


@pytest.mark.parametrize("case", sorted(BF16_CHUNKED_CASES))
def test_bf16_chunked_backward_runs_its_kernels_on_card(cuda_device, case):
    """bf16 K2 and K3 above head dim 256: one chunked launch each (under
    the bf16 ``LAUNCHES_DKV_CHUNKED`` and ``LAUNCHES_DQ_CHUNKED``), no
    operand copied, two launches on the same inputs give the same bits,
    and dQ, dK and dV match the plain backward row by row at the bf16
    limit, one scale for the three (dQ's rows with one live key and dK's
    rows whose queries have one live key, 0 in exact arithmetic, against
    their terms' size: ``_dq_row_err``, ``_dk_row_err``)."""
    T, S, D, causal = BF16_CHUNKED_CASES[case]
    q, k, v, d_o = _bs_inputs(T, S, D, bf16, cuda_device, D + T)
    scale = 1 / math.sqrt(D)
    o, lse = fa._flash_cuda(q, k, v, causal, scale)
    do, delta = fa._bwd_inputs(q, o, d_o)
    counters = (fa.LAUNCHES_DKV_CHUNKED[bf16], fa.LAUNCHES_DQ_CHUNKED[bf16],
                fa.OPERAND_COPIES)
    before = [c.count for c in counters]
    runs = []
    for _ in range(2):
        dk, dv = fa._launch_dkv(q, k, v, do, lse, delta, causal, scale)
        torch.cuda.synchronize()   # one kernel per synchronise
        dq = fa._launch_dq(q, k, v, do, lse, delta, causal, scale)
        torch.cuda.synchronize()
        runs.append((dq, dk, dv))
    assert [c.count - n for c, n in zip(counters, before)] == [2, 2, 0]
    for a, b in zip(*runs):
        assert a.is_contiguous() and torch.equal(a, b)
    want = fa._flash_bwd_plain(q, k, v, o, lse, d_o, causal, scale)
    keep = _keep(T, S, causal, cuda_device)
    largest = max(torch.linalg.vector_norm(b.float(), dim=-1).max().item()
                  for b in want)
    dq, dk, dv = runs[0]
    assert all(torch.isfinite(t.float()).all() for t in runs[0])
    assert _dq_row_err(dq, want[0], keep, k, v, d_o, scale,
                       largest) <= ROW_TOL[bf16]
    assert _dk_row_err(dk, want[1], keep, q, v, d_o, scale,
                       largest) <= ROW_TOL[bf16]
    assert _row_rel_err(dv, want[2], largest) <= ROW_TOL[bf16]


def test_bf16_chunked_backward_raises_where_its_kernel_refuses_on_card(
        cuda_device):
    """The bf16 K2 and K3 above head dim 256 launch the chunked backward
    or raise: the C entries refuse a head dim that is not a multiple of
    64 (the wrappers pad to one), and each call raises, counts no launch
    and writes nothing."""
    g = torch.Generator(device=cuda_device).manual_seed(17)
    q, k, v, d_o = (torch.randn(1, 2, 64, 288, device=cuda_device,
                                generator=g).to(bf16) for _ in range(4))
    lse = torch.zeros(2, 1, 64, device=cuda_device)
    delta = torch.zeros(2, 64, device=cuda_device)
    for name, outs, counter in (
            ("bigdl_flash_bwd_dkv", [torch.full_like(k, float("nan")),
                                     torch.full_like(v, float("nan"))],
             fa.LAUNCHES_DKV),
            ("bigdl_flash_bwd_dq", [torch.full_like(q, float("nan"))],
             fa.LAUNCHES_DQ)):
        before = counter.count
        with pytest.raises(RuntimeError, match="cudaError"):
            fa._launch_heads(
                name, (counter,), fa._bwd_fn(name, 6 + len(outs)),
                [*(t.data_ptr() for t in (q, k, v, d_o, lse, delta, *outs)),
                 fa._strides_arg(q, k, v, d_o), 2, fa.FIRST_HEAD, fa.HEADS,
                 64, 64, 288, 1, 0.125, 1], 2, q.device)
        torch.cuda.synchronize()
        assert counter.count == before
        assert all(t.isnan().all() for t in outs)


def test_f32_dq_raises_where_its_kernel_refuses_on_card(cuda_device):
    """The f32 K3 and K8 launch their split-product kernel or raise: no
    route falls back to a tile loop or to the plain version.  The C
    entries refuse a head dim they are not built for (K3 at 288: above
    256 the chunked backward takes multiples of 64, which the wrappers
    pad to) and an f32 K8 launch without its block lists' order and rows
    (the tile tables the retired loop read had none); each raises, counts
    no launch and writes nothing."""
    g = torch.Generator(device=cuda_device).manual_seed(11)
    q, k, v, d_o = (torch.randn(1, 2, 64, 288, device=cuda_device,
                                generator=g) for _ in range(4))
    lse = torch.zeros(2, 1, 64, device=cuda_device)
    delta = torch.zeros(2, 64, device=cuda_device)
    dq = torch.full_like(q, float("nan"))
    before = fa.LAUNCHES_DQ.count
    with pytest.raises(RuntimeError, match="cudaError"):
        fa._launch_heads(
            "flash_bwd_dq", (fa.LAUNCHES_DQ,),
            fa._bwd_fn("bigdl_flash_bwd_dq", 7),
            [*(t.data_ptr() for t in (q, k, v, d_o, lse, delta, dq)),
             fa._strides_arg(q, k, v, d_o), 2, fa.FIRST_HEAD, fa.HEADS, 64,
             64, 288, 0, 0.125, 1], 2, q.device)
    torch.cuda.synchronize()
    assert fa.LAUNCHES_DQ.count == before and dq.isnan().all()
    q, k, v, d_o = (t[..., :64].contiguous() for t in (q, k, v, d_o))
    dq = torch.full_like(q, float("nan"))
    mask = bs.sliding_window_mask(2, 2, 1, 0, True, 32, 32)
    tab = bs._attention_tables(mask, True, q.device)
    args = bs._table_args(tab, "dq_tiles", mask, q, k, (q, k, v, d_o))
    args[4:6] = [None, None]   # no order, no rows
    before = bs.LAUNCHES_DQ.count
    with pytest.raises(RuntimeError, match="cudaError"):
        fa._launch_heads(
            "block_sparse_bwd_dq", (bs.LAUNCHES_DQ,),
            bs._attn_fn("bigdl_bs_bwd_dq", 13),
            [*(t.data_ptr() for t in (q, k, v, d_o, lse, delta, dq)), *args,
             0.125, 1], 2, q.device)
    torch.cuda.synchronize()
    assert bs.LAUNCHES_DQ.count == before and dq.isnan().all()


def test_layer_norm_reads_a_column_slice_in_place_on_card(cuda_device):
    """K4 on a column slice (rows 1000 apart, under a leading dim) reads
    it in place and matches the plain version and the contiguous launch
    bit for bit; so does its strided instantiation on a transposed x; a
    layout neither reads (leading dims that do not merge, columns not
    adjacent) is copied first."""
    g = torch.Generator(device=cuda_device).manual_seed(12)
    base = torch.randn(3, 50, 1000, device=cuda_device, generator=g).to(bf16)
    gamma = (1 + 0.1 * torch.randn(768, device=cuda_device,
                                   generator=g)).to(bf16)
    beta = (0.1 * torch.randn(768, device=cuda_device, generator=g)).to(bf16)
    odd = torch.randn(2, 3, 50, 4, device=cuda_device, generator=g).to(
        bf16).permute(3, 0, 2, 1)
    for x, copied, strided in ((base[:, :, 16:784], False, False),
                               (base[0, :768, :50].t(), False, True),
                               (odd, True, False)):
        copies, before = ln.X_COPIES.count, ln.LAUNCHES.count
        before_strided = ln.LAUNCHES_STRIDED.count
        y = ln.fused_layer_norm(x, gamma[:x.shape[-1]], beta[:x.shape[-1]])
        torch.cuda.synchronize()
        assert (ln.X_COPIES.count - copies, ln.LAUNCHES.count - before,
                ln.LAUNCHES_STRIDED.count - before_strided) == (
            int(copied), 1, int(strided))
        assert y.is_contiguous() and y.shape == x.shape
        ref = ln._layer_norm_plain(x, gamma[:x.shape[-1]], beta[:x.shape[-1]],
                                   1e-5)
        assert (y.float() - ref.float()).abs().max().item() <= 4e-2
        xc = x.contiguous()
        assert torch.equal(y, ln.fused_layer_norm(xc, gamma[:x.shape[-1]],
                                                  beta[:x.shape[-1]]))


def test_block_sparse_matmul_takes_mixed_dtypes_on_card(cuda_device):
    """x bf16 with W f32 (fault F5: it raised): K9 casts W to x's dtype
    and returns bf16 within the bf16 row limit of the port's CPU path."""
    g = torch.Generator(device=cuda_device).manual_seed(13)
    x = torch.randn(256, 256, device=cuda_device, generator=g).to(bf16)
    w = 0.05 * torch.randn(256, 128, device=cuda_device, generator=g)
    mask = bs.magnitude_block_mask(w, 32, 32, 0.5)
    before = bs.LAUNCHES_MM.count
    y = bs.block_sparse_matmul(x, w, mask)
    torch.cuda.synchronize()
    assert bs.LAUNCHES_MM.count == before + 1 and y.dtype == bf16
    want = bs.block_sparse_matmul(x.cpu(), w.cpu(), mask)
    assert want.dtype == bf16
    assert _row_rel_err(y.cpu(), want) <= ROW_TOL[bf16]


def test_more_heads_than_a_grid_takes_on_card(cuda_device):
    """B*H = 65536 + 8 heads, more than a grid's y dimension (65535): the
    wrappers launch 65535 heads at a time over the contiguous (B*H, T, D)
    views, two launches of each kernel.  Heads of both launches equal,
    bit for bit, the same heads run alone (each head's rows have one
    owner block, so a head's result does not depend on the others), and
    those match the plain versions."""
    B, H, T, D = 8193, 8, 8, 16
    g = torch.Generator(device=cuda_device).manual_seed(21)
    q, k, v, d_o = (torch.randn(B, H, T, D, device=cuda_device,
                                generator=g).to(bf16) for _ in range(4))
    scale = 1 / math.sqrt(D)
    mask = bs.BlockMask(np.eye(2, dtype=bool), 4, 4)

    def run(q, k, v, d_o):
        o, lse = fa._flash_cuda(q, k, v, True, scale)
        ob, lseb = bs._bs_fwd_cuda(q, k, v, mask, True, scale)
        return ((o, lse) + fa._flash_bwd_cuda(q, k, v, o, lse, d_o, True,
                                              scale),
                (ob, lseb) + bs._bs_bwd_cuda(q, k, v, ob, lseb, d_o, mask,
                                             True, scale))

    counters = (fa.LAUNCHES, fa.LAUNCHES_DKV, fa.LAUNCHES_DQ, bs.LAUNCHES,
                bs.LAUNCHES_DKV, bs.LAUNCHES_DQ)
    before = [c.count for c in counters]
    big = run(q, k, v, d_o)
    torch.cuda.synchronize()
    assert [c.count - n for c, n in zip(counters, before)] == [2] * 6
    heads = torch.tensor([0, 1, 65534, 65535, 65536, 65543],
                         device=cuda_device)
    pick = [t.reshape(B * H, T, -1)[heads].reshape(1, len(heads), T, -1)
            .contiguous() for t in (q, k, v, d_o)]
    alone = run(*pick)
    for got_family, want_family in zip(big, alone):
        for got, want in zip(got_family, want_family):
            sel = got.reshape(B * H, T, -1)[heads]
            assert torch.equal(sel, want.reshape(len(heads), T, -1))
    (o, lse, *grads), (ob, lseb, *grads_b) = alone
    o_ref, lse_ref = fa._flash_plain(*pick[:3], True, scale)
    assert _row_rel_err(o, o_ref) <= ROW_TOL[bf16]
    assert (lse - lse_ref).abs().max().item() <= 1e-3
    _check_attention_grads(grads, fa._flash_bwd_plain(
        *pick[:3], o, lse, pick[3], True, scale), bf16,
        _keep(T, T, True, q.device), *pick[1:], scale)
    ob_ref, lseb_ref = bs._bs_attention_plain(*pick[:3], mask, True, scale)
    assert _row_rel_err(ob, ob_ref) <= ROW_TOL[bf16]
    assert (lseb - lseb_ref).abs().max().item() <= 1e-3
    _check_attention_grads(grads_b, bs._bs_bwd_plain(
        *pick[:3], ob, lseb, pick[3], mask, True, scale), bf16,
        _keep(T, T, True, q.device, mask), *pick[1:], scale)


def test_cuda_gradients_match_the_plain_backward(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(2)
    q, k, v = (torch.randn(1, 2, 40, 16, device=cuda_device, generator=g
                           ).requires_grad_() for _ in range(3))
    d_o = torch.randn(1, 2, 40, 16, device=cuda_device, generator=g)
    before = fa.LAUNCHES_DKV.count
    o = fa.flash_attention(q, k, v, causal=True)
    got = torch.autograd.grad(o, (q, k, v), d_o)
    assert fa.LAUNCHES_DKV.count == before + 1
    o2, lse = fa._flash_plain(q.detach(), k.detach(), v.detach(), True, 0.25)
    want = fa._flash_bwd_plain(q.detach(), k.detach(), v.detach(), o2, lse,
                               d_o, True, 0.25)
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= 1e-4 * b.abs().max().item()
    # bf16 at D 128 through the Hopper K1 into K2/K3: O against the plain
    # forward, the gradients against the plain backward fed the O and LSE
    # that autograd saved (K1 is deterministic)
    q, k, v = (torch.randn(2, 4, 257, 128, device=cuda_device, generator=g
                           ).to(bf16).requires_grad_() for _ in range(3))
    d_o = torch.randn(2, 4, 257, 128, device=cuda_device, generator=g).to(bf16)
    counts = (fa.LAUNCHES.count, fa.LAUNCHES_DKV.count, fa.LAUNCHES_DQ.count)
    o = fa.flash_attention(q, k, v, causal=True)
    got = torch.autograd.grad(o, (q, k, v), d_o)
    assert (fa.LAUNCHES.count, fa.LAUNCHES_DKV.count,
            fa.LAUNCHES_DQ.count) == tuple(n + 1 for n in counts)
    qd, kd, vd = q.detach(), k.detach(), v.detach()
    scale = 1 / math.sqrt(128)
    o_k1, lse = fa._flash_cuda(qd, kd, vd, True, scale)
    assert torch.equal(o_k1, o.detach())
    assert _row_rel_err(o, fa._flash_plain(qd, kd, vd, True, scale)[0]) \
        <= ROW_TOL[bf16]
    want = fa._flash_bwd_plain(qd, kd, vd, o_k1, lse, d_o, True, scale)
    largest = max(torch.linalg.vector_norm(b.float(), dim=-1).max().item()
                  for b in want)
    for a, b in zip(got, want):
        assert a.dtype == bf16 and torch.isfinite(a.float()).all()
        assert _row_rel_err(a, b, largest) <= ROW_TOL[bf16]
    x = torch.randn(4, 16, device=cuda_device, generator=g,
                    requires_grad=True)
    gam = (1 + 0.1 * torch.randn(16, device=cuda_device, generator=g)
           ).requires_grad_()
    bet = torch.zeros(16, device=cuda_device, requires_grad=True)
    w = torch.randn(4, 16, device=cuda_device, generator=g)
    got = torch.autograd.grad(ln.fused_layer_norm(x, gam, bet), (x, gam, bet),
                              w)
    leaves = [t.detach().cpu().requires_grad_() for t in (x, gam, bet)]
    want = torch.autograd.grad(ln._layer_norm_plain(*leaves, 1e-5), leaves,
                               w.cpu())
    for a, b in zip(got, want):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-5)


def _train_small(device, steps=3, seq_strategy="flash", T=20, block_size=None,
                 optimizer=LocalOptimizer, **extra):
    cfg = dict(embed_dim=64, num_heads=4, num_layers=2, max_len=max(32, T),
               seq_strategy=seq_strategy, output="logits", **extra)
    V, B = 64, 3
    model = TransformerLM(V, **cfg, device=device,
                          generator=torch.Generator().manual_seed(3))
    if block_size is not None:   # the "block" strategy's K/V block
        for blk in model.blocks:
            blk[1].block_size = block_size
    rng = np.random.RandomState(0)
    x = rng.randint(1, V + 1, size=(B, T)).astype(np.int32)
    y = rng.randint(1, V + 1, size=(B, T)).astype(np.int32)
    losses = []

    def check(state):
        if "loss" in state:
            losses.append(state["loss"])
        return max_iteration(steps)(state)

    opt = optimizer(model, array([Sample(a, b) for a, b in zip(x, y)]),
                    nn.TimeDistributedCriterion(
                        nn.CrossEntropyCriterion(), True), batch_size=B)
    opt.set_optim_method(SGD(0.05)).set_end_when(Trigger(check))
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    RNG().set_seed(1)
    opt.optimize()
    updates = {n: (p.detach() - start[n]).cpu()
               for n, p in model.named_parameters()}
    return losses, model, updates


def test_small_lm_trains_on_card_like_cpu(cuda_device):
    counts = [c.count for c in (fa.LAUNCHES, fa.LAUNCHES_DKV,
                                fa.LAUNCHES_DQ, ln.LAUNCHES)]
    card, card_model, card_upd = _train_small(cuda_device)
    launched = [c.count - n for c, n in zip(
        (fa.LAUNCHES, fa.LAUNCHES_DKV, fa.LAUNCHES_DQ, ln.LAUNCHES), counts)]
    assert launched == [6, 6, 6, 15]   # 3 steps x (2, 2, 2, 2*2+1)
    cpu, cpu_model, cpu_upd = _train_small("cpu")
    np.testing.assert_allclose(card, cpu, rtol=2e-3)
    for (name, a), b in zip(card_model.state_dict().items(),
                            cpu_model.state_dict().values()):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=2e-3,
                                   atol=1e-6, err_msg=name)
    # the losses start near ln V whatever the backward computes, and the
    # updates are small against the weights: hold the decreases and the
    # updates themselves (f32 on both sides, summation order only)
    np.testing.assert_allclose(np.subtract(card[1:], card[0]),
                               np.subtract(cpu[1:], cpu[0]), rtol=1e-4)
    scale = max(torch.linalg.vector_norm(u, dim=-1).max().item()
                for u in cpu_upd.values())
    for name, u in cpu_upd.items():
        assert _row_rel_err(card_upd[name], u, scale) <= 1e-3, name


@pytest.fixture
def nccl_group(cuda_device):
    """An NCCL group of this process alone on the card; destroyed after
    the test."""
    from bigdl_tpu_torch.utils.engine import Engine

    Engine.reset()
    yield Engine.init_distributed(device=cuda_device)
    Engine.reset()


def test_distri_optimizer_on_one_nccl_rank_is_local_bit_for_bit(nccl_group):
    """The small LM trained 3 f32 steps by DistriOptimizer over a group
    of one (NCCL): one term summed and divided by 1, so every loss and
    parameter is LocalOptimizer's bit for bit, through the same K1-K4
    launches."""
    import torch.distributed as dist

    from bigdl_tpu_torch.optim import DistriOptimizer

    counters = (fa.LAUNCHES, fa.LAUNCHES_DKV, fa.LAUNCHES_DQ, ln.LAUNCHES)
    local, local_model, _ = _train_small("cuda")
    before = [c.count for c in counters]
    got, model, _ = _train_small("cuda", optimizer=DistriOptimizer)
    assert [c.count - n for c, n in zip(counters, before)] == [6, 6, 6, 15]
    assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
    assert got == local
    for (name, a), b in zip(model.state_dict().items(),
                            local_model.state_dict().values()):
        assert torch.equal(a, b), name


def test_derived_plan_and_fsdp_on_one_nccl_rank_are_planless_bit_for_bit(
        nccl_group):
    """The small LM by DistriOptimizer over a group of one with a plan
    derived for a 4-way data axis and ``set_fsdp``: the plan re-binds to
    the one rank, where FSDP is a no-op (no ``[fsdp]`` row, no gather),
    so every loss and parameter is the planless run's bit for bit,
    through the same K1-K4 launches."""
    from bigdl_tpu_torch.optim import DistriOptimizer
    from bigdl_tpu_torch.parallel.plan import MeshShape, derive_plan

    counters = (fa.LAUNCHES, fa.LAUNCHES_DKV, fa.LAUNCHES_DQ, ln.LAUNCHES)
    plain, plain_model, _ = _train_small("cuda", optimizer=DistriOptimizer)
    seen = []

    class Planned(DistriOptimizer):
        def __init__(self, model, *a, **kw):
            super().__init__(model, *a, **kw)
            self.set_sharding_plan(derive_plan(
                model, MeshShape(data=4), fsdp_min_bytes=1024))
            self.set_fsdp(1024)
            seen.append(self)

    before = [c.count for c in counters]
    got, model, _ = _train_small("cuda", optimizer=Planned)
    assert [c.count - n for c, n in zip(counters, before)] == [6, 6, 6, 15]
    engine = seen[0].engine
    assert engine.single and not engine.has_fsdp
    assert not any(r.endswith("[fsdp]") for r in engine.table.values())
    assert engine.collective_bytes == 0
    assert got == plain
    for (name, a), b in zip(model.state_dict().items(),
                            plain_model.state_dict().values()):
        assert torch.equal(a, b), name


def test_allreduce_parameter_round_trip_over_nccl_is_bit_for_bit(nccl_group):
    """Reduce-scatter then all-gather over a group of one returns the
    flat parameter bit for bit in f32, and within bf16 rounding with
    ``compress="bf16"``."""
    from bigdl_tpu_torch.parallel import AllReduceParameter

    g = torch.Generator().manual_seed(0)
    tree = {"w": torch.randn(1000, 37, generator=g).cuda(),
            "b": {"v": torch.randn(123, generator=g).cuda()}}
    for compress in ("none", "bf16"):
        arp = AllReduceParameter(tree, 1, compress=compress)
        back = arp.all_gather_weights(arp.reduce_scatter_gradients(tree))
        for a, b in zip((back["w"], back["b"]["v"]),
                        (tree["w"], tree["b"]["v"])):
            if compress == "none":
                assert torch.equal(a, b)
            else:
                torch.testing.assert_close(a, b, rtol=2 ** -8, atol=0)


@pytest.mark.parametrize("capacity", [8.0, 0.5])
def test_small_moe_lm_trains_on_card_like_cpu(cuda_device, capacity):
    """A Switch-MoE LM (4 experts, aux 0.01) trained 3 f32 steps on the
    card and on the CPU, capacity loose and binding: K1-K4 as the dense
    LM's, the losses, decreases, aux buffers and every update row by
    row at the dense LM's limits."""
    moe = dict(moe_experts=4, moe_aux_coef=0.01,
               moe_capacity_factor=capacity)
    counts = [c.count for c in (fa.LAUNCHES, fa.LAUNCHES_DKV,
                                fa.LAUNCHES_DQ, ln.LAUNCHES)]
    card, card_model, card_upd = _train_small(cuda_device, **moe)
    launched = [c.count - n for c, n in zip(
        (fa.LAUNCHES, fa.LAUNCHES_DKV, fa.LAUNCHES_DQ, ln.LAUNCHES), counts)]
    assert launched == [6, 6, 6, 15]
    cpu, cpu_model, cpu_upd = _train_small("cpu", **moe)
    np.testing.assert_allclose(card, cpu, rtol=2e-3)
    np.testing.assert_allclose(np.subtract(card[1:], card[0]),
                               np.subtract(cpu[1:], cpu[0]), rtol=1e-4)
    for blk_card, blk_cpu in zip(card_model.blocks, cpu_model.blocks):
        np.testing.assert_allclose(float(blk_card[3].aux_loss),
                                   float(blk_cpu[3].aux_loss), rtol=1e-5)
    scale = max(torch.linalg.vector_norm(u, dim=-1).max().item()
                for u in cpu_upd.values())
    for name, u in cpu_upd.items():
        assert _row_rel_err(card_upd[name], u, scale) <= 1e-3, name


@pytest.mark.parametrize("top_k,capacity", [(1, 0.5), (2, 1.25)])
def test_moe_index_dispatch_is_the_onehot_einsum_on_card(cuda_device, top_k,
                                                         capacity):
    """The index dispatch against the JAX layer's one-hot einsum form on
    the card, f32, 2048 tokens at the bench width (D 512, H 2048, E 8),
    capacity binding (top-1 at 0.5; top-2 at 1.25 has fewer slots than
    assignments): bit for bit for top-1, within 1e-6 of the largest
    output for top-2 (the order of its two products' sum)."""
    from bigdl_tpu_torch.parallel.moe import MoEFFN, onehot_forward

    moe = MoEFFN(512, 2048, 8, capacity_factor=capacity, top_k=top_k,
                 device=cuda_device,
                 generator=torch.Generator().manual_seed(0)).evaluate()
    x = torch.randn(2, 1024, 512, generator=torch.Generator().manual_seed(1)
                    ).to(cuda_device)
    with torch.no_grad():
        got = moe(x)
        want = onehot_forward(moe, moe.param_tree(), x)
        _, keep, _ = moe.slots(moe.route(moe.param_tree(),
                                         x.reshape(-1, 512))[1])
    assert not bool(keep.all())
    err = (got - want).abs().max().item()
    assert err <= 1e-6 * want.abs().max().item()
    if top_k == 1:
        assert torch.equal(got, want)


def test_small_lm_on_card_matches_cpu(cuda_device):
    cfg = dict(embed_dim=64, num_heads=4, num_layers=2, max_len=64,
               seq_strategy="flash")
    V, T0, max_new = 64, 20, 12
    cpu = TransformerLM(V, **cfg, device="cpu",
                        generator=torch.Generator().manual_seed(9))
    card = TransformerLM(V, **cfg, device=cuda_device,
                         generator=torch.Generator().manual_seed(9))
    prompts = np.random.RandomState(0).randint(
        1, V + 1, size=(3, T0)).astype(np.int32)
    fa.LAUNCHES.reset()
    ln.LAUNCHES.reset()
    with torch.no_grad():
        lp_card = card(torch.as_tensor(prompts, device=cuda_device)).cpu()
        lp_cpu = cpu(torch.as_tensor(prompts))
    assert fa.LAUNCHES.count == 2 and ln.LAUNCHES.count == 5
    np.testing.assert_allclose(lp_card.numpy(), lp_cpu.numpy(), rtol=0,
                               atol=1e-4)
    want = make_generate(cpu)(cpu.param_tree(), prompts, max_new).numpy()
    got = make_generate(card)(card.param_tree(), prompts,
                              max_new).cpu().numpy()
    with torch.no_grad():
        lp = cpu(torch.as_tensor(want[:, :-1])).numpy()
    top2 = np.sort(lp[:, T0 - 1:], axis=-1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0]).min() > 1e-3
    np.testing.assert_array_equal(got, want)


def test_head_dim_8_lm_served_on_card_matches_cpu(cuda_device):
    """A TransformerLM with heads of 8 (the JAX package's test models)
    served in f32 by the port's InferenceServer on the card: its prefill
    runs K1 on heads zero-padded to 16, and the greedy decode is token
    exact against the same model on the CPU."""
    cfg = dict(embed_dim=32, num_heads=4, num_layers=2, max_len=64,
               seq_strategy="flash")
    V, T0, max_new = 64, 20, 12
    cpu = TransformerLM(V, **cfg, device="cpu",
                        generator=torch.Generator().manual_seed(9))
    card = TransformerLM(V, **cfg, device=cuda_device,
                         generator=torch.Generator().manual_seed(9))
    prompts = np.random.RandomState(1).randint(
        1, V + 1, size=(3, T0)).astype(np.int32)
    want = make_generate(cpu)(cpu.param_tree(), prompts, max_new).numpy()
    with torch.no_grad():
        lp = cpu(torch.as_tensor(want[:, :-1])).numpy()
    top2 = np.sort(lp[:, T0 - 1:], axis=-1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0]).min() > 1e-3
    before = fa.LAUNCHES.count
    server = InferenceServer(card, max_batch=3).start()
    try:
        results = [f.result(timeout=300) for f in
                   [server.submit_generate(p, max_new) for p in prompts]]
    finally:
        assert server.stop(timeout=60)
    assert [r.status for r in results] == [Status.OK] * 3
    assert fa.LAUNCHES.count > before   # the prefill ran K1
    np.testing.assert_array_equal(np.stack([r.output for r in results]),
                                  want[:, T0:])


def test_small_lm_fleet_on_card_routes_like_cpu_fleet(cuda_device):
    """A two-replica ``ServingFleet`` of a small LM on the card in f32,
    ``max_batch`` 1, tracing on and every trace kept: the routed greedy
    tokens equal the same fleet's on the CPU (six prompts whose greedy
    choices clear the runner-up by 1e-3), and every kept trace stitches
    across the router and a replica with coverage >= 0.95 (the JAX
    package's spec limit)."""
    from bigdl_tpu_torch.serving import ServingFleet, trace_coverage

    cfg = dict(embed_dim=64, num_heads=4, num_layers=2, max_len=64,
               seq_strategy="flash")
    V, T0, max_new = 64, 20, 12
    prompts = np.random.RandomState(0).randint(
        1, V + 1, size=(6, T0)).astype(np.int32)

    def routed(device):
        model = TransformerLM(V, **cfg, device=device,
                              generator=torch.Generator().manual_seed(9))
        fl = ServingFleet.build(
            model, n_replicas=2, server_kw=dict(max_batch=1),
            heartbeat_timeout=2.0, pump_interval_s=0.05, tracing=True,
            trace_kw=dict(keep_per_s=1e9, burst=1e9),
            router_kw=dict(default_deadline_s=300.0)).start()
        try:
            # one replica at a time before the router routes
            for srv in fl.servers.values():
                assert srv.submit_generate(prompts[0],
                                           max_new).result(300).ok
            res = [fl.submit_generate(p, max_new).result(300)
                   for p in prompts]
            traces = [fl.stitch_trace(k["trace_id"])
                      for k in fl.kept_traces()]
        finally:
            assert fl.stop(timeout=60)
        assert [r.status for r in res] == [Status.OK] * len(prompts)
        return np.stack([r.output for r in res]), traces, model

    want, _, cpu = routed("cpu")
    full = np.concatenate([prompts, want], axis=1)
    with torch.no_grad():
        lp = cpu(torch.as_tensor(full[:, :-1])).numpy()
    top2 = np.sort(lp[:, T0 - 1:], axis=-1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0]).min() > 1e-3
    before = fa.LAUNCHES.count
    got, traces, _ = routed(cuda_device)
    assert fa.LAUNCHES.count > before
    np.testing.assert_array_equal(got, want)
    assert len(traces) == len(prompts)
    for t in traces:
        assert len(t["hosts"]) >= 2
        assert trace_coverage(t) >= 0.95


# ----------------------------------------------------------------------
# block-sparse attention (K6-K8) and the block-sparse matmul (K9)
# ----------------------------------------------------------------------

def _rect_mask():
    m = np.random.RandomState(4).rand(3, 5) < 0.6
    m[:, 0] = True
    return bs.BlockMask(m, 100, 40)


def _dead_blocks_mask():
    m = np.ones((4, 4), bool)
    m[2, :] = False   # q block 2 attends nothing
    m[:, 3] = False   # k block 3 is read by no query
    return bs.BlockMask(m, 64, 64)


# (T, S, D, dtype, causal, mask): aligned blocks, partly live 64-row
# tiles (block 32, 8, 96, 100 x 40), f32, a dead q block and k block,
# strided, T != S
BS_CASES = {
    "aligned_block256": (1024, 1024, 128, torch.bfloat16, True,
                         lambda: bs.sliding_window_mask(4, 4, 2, 1, True,
                                                        256, 256)),
    "block32": (256, 256, 64, torch.bfloat16, True,
                lambda: bs.sliding_window_mask(8, 8, 2, 1, True, 32, 32)),
    "ragged_T200_block8": (200, 200, 128, torch.bfloat16, True,
                           lambda: bs.sliding_window_mask(25, 25, 3, 1, True,
                                                          8, 8)),
    "block96_strided": (384, 384, 64, torch.bfloat16, True,
                        lambda: bs.strided_mask(4, 4, 2, True, 96, 96)),
    "f32_block32": (256, 256, 32, torch.float32, True,
                    lambda: bs.sliding_window_mask(8, 8, 2, 1, True, 32, 32)),
    "noncausal_dead_blocks": (256, 256, 16, torch.float32, False,
                              _dead_blocks_mask),
    "strided_block64": (512, 512, 128, torch.bfloat16, True,
                        lambda: bs.strided_mask(8, 8, 3, True, 64, 64)),
    "rect_T300_S200": (300, 200, 64, torch.bfloat16, True, _rect_mask),
}


def _bs_inputs(T, S, D, dtype, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (torch.randn(2, 4, n, D, device=device, generator=g).to(dtype)
               for n in (T, S, S))
    d_o = torch.randn(2, 4, T, D, device=device, generator=g).to(dtype)
    return q, k, v, d_o


@pytest.mark.parametrize("case", sorted(BS_CASES))
def test_block_sparse_kernels_match_plain_on_card(cuda_device, case):
    T, S, D, dtype, causal, make_mask = BS_CASES[case]
    mask = make_mask()
    q, k, v, d_o = _bs_inputs(T, S, D, dtype, cuda_device, 5)
    scale = 1 / math.sqrt(D)
    before = (bs.LAUNCHES.count, bs.LAUNCHES_DKV.count, bs.LAUNCHES_DQ.count)
    o, lse = bs._bs_fwd_cuda(q, k, v, mask, causal, scale)
    got = bs._bs_bwd_cuda(q, k, v, o, lse, d_o, mask, causal, scale)
    torch.cuda.synchronize()
    assert (bs.LAUNCHES.count, bs.LAUNCHES_DKV.count, bs.LAUNCHES_DQ.count) \
        == tuple(n + 1 for n in before)
    o_ref, lse_ref = bs._bs_attention_plain(q, k, v, mask, causal, scale)
    assert torch.isfinite(o.float()).all()
    assert _row_rel_err(o, o_ref) <= ROW_TOL[dtype]
    assert (lse - lse_ref).abs().max().item() <= 1e-3
    want = bs._bs_bwd_plain(q, k, v, o, lse, d_o, mask, causal, scale)
    _check_attention_grads(got, want, dtype,
                           _keep(T, S, causal, q.device, mask), k, v, d_o,
                           scale)


def test_block_sparse_empty_rows_are_exactly_zero_on_card(cuda_device):
    mask = _dead_blocks_mask()
    q, k, v, d_o = _bs_inputs(256, 256, 32, torch.bfloat16, cuda_device, 6)
    o, lse = bs._bs_fwd_cuda(q, k, v, mask, False, 0.2)
    dq, dk, dv = bs._bs_bwd_cuda(q, k, v, o, lse, d_o, mask, False, 0.2)
    torch.cuda.synchronize()
    assert not o[:, :, 128:192].any() and not dq[:, :, 128:192].any()
    assert (lse.reshape(2, 4, 256)[:, :, 128:192] == 1e30).all()
    assert not dk[:, :, 192:].any() and not dv[:, :, 192:].any()
    assert o[:, :, :128].abs().max() > 0 and dk[:, :, :192].abs().max() > 0


def _dead_half_mask():
    m = bs.sliding_window_mask(8, 8, 2, 1, True, 32, 32).mask.copy()
    m[2:4] = False   # q rows 64..127: one 64-row half of a 128-row block
    return bs.BlockMask(m, 32, 32)


# (T, D, mask) for the bf16 K6 (the Hopper body over K8's 128-row lists):
# every built head dim, the list sweep's 64-key tiles being K1's 128 below
# D 128; a 128-row block with a dead 64-row half, whose warpgroup only
# releases; ragged T 200 at block 8; block 96, whose partial pairs straddle
# 128-row blocks
BS_FWD_CASES = {
    "D16": (512, 16, lambda: bs.sliding_window_mask(16, 16, 3, 1, True,
                                                     32, 32)),
    "D32": (512, 32, lambda: bs.sliding_window_mask(16, 16, 3, 1, True,
                                                     32, 32)),
    "D64": (512, 64, lambda: bs.sliding_window_mask(16, 16, 3, 1, True,
                                                     32, 32)),
    "D128": (512, 128, lambda: bs.sliding_window_mask(16, 16, 3, 1, True,
                                                       32, 32)),
    "dead_half": (256, 128, _dead_half_mask),
    "ragged_T200_block8": (200, 64, lambda: bs.sliding_window_mask(
        25, 25, 3, 1, True, 8, 8)),
    "block96": (384, 128, lambda: bs.sliding_window_mask(4, 4, 2, 1, True,
                                                          96, 96)),
}


@pytest.mark.parametrize("case", sorted(BS_FWD_CASES))
def test_block_sparse_bf16_forward_matches_plain_on_card(cuda_device, case):
    T, D, make_mask = BS_FWD_CASES[case]
    mask = make_mask()
    q, k, v, _ = _bs_inputs(T, T, D, torch.bfloat16, cuda_device, 10)
    before = bs.LAUNCHES.count
    o, lse = bs._bs_fwd_cuda(q, k, v, mask, True, 1 / math.sqrt(D))
    torch.cuda.synchronize()
    assert bs.LAUNCHES.count == before + 1
    o_ref, lse_ref = bs._bs_attention_plain(q, k, v, mask, True,
                                            1 / math.sqrt(D))
    assert torch.isfinite(o.float()).all()
    assert _row_rel_err(o, o_ref) <= ROW_TOL[torch.bfloat16]
    assert (lse - lse_ref).abs().max().item() <= 1e-3
    if case == "dead_half":
        assert not o[:, :, 64:128].any()
        assert (lse.reshape(2, 4, T)[:, :, 64:128] == 1e30).all()
        assert o[:, :, :64].abs().max() > 0 and o[:, :, 128:].abs().max() > 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_block_sparse_all_ones_mask_is_the_flash_kernels(cuda_device, dtype):
    """An all-ones causal mask at a 128-multiple block visits the flash
    kernels' tiles in their order with no partial tile.  K6 equals K1, and
    K7/K8 fed the same (O, LSE, dO) from K6 equal K2/K3, bit for bit in
    both dtypes: in bf16 each pair is one Hopper body
    (``attn_fwd_hopper.cuh``, ``attn_bwd_hopper.cuh``) over the same
    tiles; in f32 each pair is one Hopper body too (their split
    products)."""
    T, D = 512, 128 if dtype == torch.bfloat16 else 64
    mask = bs.BlockMask(np.ones((4, 4), bool), 128, 128)
    q, k, v, d_o = _bs_inputs(T, T, D, dtype, cuda_device, 7)
    scale = 1 / math.sqrt(D)
    o, lse = bs._bs_fwd_cuda(q, k, v, mask, True, scale)
    o1, lse1 = fa._flash_cuda(q, k, v, True, scale)
    assert torch.equal(o, o1) and torch.equal(lse, lse1)
    got = bs._bs_bwd_cuda(q, k, v, o, lse, d_o, mask, True, scale)
    want = fa._flash_bwd_cuda(q, k, v, o, lse, d_o, True, scale)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_block_sparse_kernels_never_touch_dead_kv_on_card(cuda_device, dtype):
    """The JAX skip proof on the card: K/V rows that no query may attend
    hold NaN; the outputs and every gradient equal the clean run's bit
    for bit (block 32: the dead rows sit in partly live 64-row tiles)."""
    m = np.eye(4, dtype=bool)
    m[:, 0] = True
    m[2, 2] = False
    mask = bs.BlockMask(m, 32, 32)
    q, k, v, d_o = _bs_inputs(128, 128, 32, dtype, cuda_device, 8)
    dead = ~bs._elementwise_keep(mask, True, cuda_device).any(dim=0)
    assert dead.any()
    kp, vp = k.clone(), v.clone()
    kp[:, :, dead] = float("nan")
    vp[:, :, dead] = float("nan")
    clean = bs._bs_fwd_cuda(q, k, v, mask, True, 0.2)
    poisoned = bs._bs_fwd_cuda(q, kp, vp, mask, True, 0.2)
    assert torch.isfinite(poisoned[0].float()).all()
    assert torch.equal(poisoned[0], clean[0])
    assert torch.equal(poisoned[1], clean[1])
    g_clean = bs._bs_bwd_cuda(q, k, v, *clean, d_o, mask, True, 0.2)
    g_pois = bs._bs_bwd_cuda(q, kp, vp, *poisoned, d_o, mask, True, 0.2)
    for a, b in zip(g_pois, g_clean):
        assert torch.isfinite(a.float()).all() and torch.equal(a, b)


def test_block_sparse_autograd_runs_k6_to_k8(cuda_device):
    mask = bs.sliding_window_mask(4, 4, 2, 1, True, 32, 32)
    q, k, v, d_o = _bs_inputs(128, 128, 16, torch.float32, cuda_device, 9)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = (bs.LAUNCHES.count, bs.LAUNCHES_DKV.count, bs.LAUNCHES_DQ.count)
    o = bs.block_sparse_attention(*leaves, mask.mask, causal=True)
    got = torch.autograd.grad(o, leaves, d_o)
    assert (bs.LAUNCHES.count, bs.LAUNCHES_DKV.count, bs.LAUNCHES_DQ.count) \
        == tuple(n + 1 for n in before)
    o2, lse = bs._bs_attention_plain(q, k, v, mask, True, 0.25)
    want = bs._bs_bwd_plain(q, k, v, o2, lse, d_o, mask, True, 0.25)
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= 1e-4 * b.abs().max().item()


# (M, K, N, bk, bn, dtype, route).  The Hopper route over the mask's
# blocks ("hopper": blocks that are multiples of 64): in bf16 the flagship
# MLP shape cut in M, M a multiple of 128 and not, block 64 (KC 64, BN
# 64); in f32 (split products) the MLP shape, the lab shape, block 64,
# BN 128 one way and 64 the other (64 x 128).  The coarse route (every
# other block, coarse tiles of the masked W): blocks 32 and 16 at ragged
# M, 64 x 32, 48 (KC 16 and BN 32 from K 144 and N 96), one row, in bf16;
# block 32, ragged M, 48 x 80, one row in f32; block 8 at ragged M in
# both dtypes, bk 24 x bn 40 (blocks across the tiles' edges) in both,
# bn 100 and bk 6 x bn 20 (N 200, 60 padded to the tile; K 96), N 100 in
# bf16 (rows of 200 bytes, which TMA cannot store: the output is written
# padded and copied out), K 100 (x rows copied), one row.
MM_CASES = {
    "mlp_bf16": (512, 1024, 4096, 128, 128, torch.bfloat16, "hopper"),
    "ragged_M100": (100, 256, 192, 32, 32, torch.bfloat16, "coarse"),
    "m256_b64": (256, 512, 384, 64, 64, torch.bfloat16, "hopper"),
    "m129_b64": (129, 192, 320, 64, 64, torch.bfloat16, "hopper"),
    "m200_b16": (200, 160, 240, 16, 16, torch.bfloat16, "coarse"),
    "m129_b64x32": (129, 192, 160, 64, 32, torch.bfloat16, "coarse"),
    "m64_b48": (64, 144, 96, 48, 48, torch.bfloat16, "coarse"),
    "m1_b16": (1, 64, 64, 16, 16, torch.bfloat16, "coarse"),
    "mlp_f32": (256, 1024, 4096, 128, 128, torch.float32, "hopper"),
    "lab_f32": (64, 1024, 1024, 512, 512, torch.float32, "hopper"),
    "m130_b64_f32": (130, 256, 192, 64, 64, torch.float32, "hopper"),
    "block32_f32": (96, 128, 64, 32, 32, torch.float32, "coarse"),
    "ragged_M100_f32": (100, 256, 192, 32, 32, torch.float32, "coarse"),
    "m129_b48x80_f32": (129, 240, 160, 48, 80, torch.float32, "coarse"),
    "m200_b64x128_f32": (200, 256, 384, 64, 128, torch.float32, "hopper"),
    "m1_b16_f32": (1, 64, 64, 16, 16, torch.float32, "coarse"),
    "bn100_bf16": (70, 96, 200, 24, 100, torch.bfloat16, "coarse"),
    "bk6_f32": (33, 96, 60, 6, 20, torch.float32, "coarse"),
    "m200_b8_bf16": (200, 256, 384, 8, 8, torch.bfloat16, "coarse"),
    "m200_b8_f32": (200, 256, 384, 8, 8, torch.float32, "coarse"),
    "m130_b24x40_bf16": (130, 240, 200, 24, 40, torch.bfloat16, "coarse"),
    "m130_b24x40_f32": (130, 240, 200, 24, 40, torch.float32, "coarse"),
    "n100_bf16": (96, 160, 100, 16, 20, torch.bfloat16, "coarse"),
    "k100_f32": (64, 100, 96, 20, 8, torch.float32, "coarse"),
    "m1_b8_bf16": (1, 64, 64, 8, 8, torch.bfloat16, "coarse"),
}


def _mm_launches():
    """K9's launches, those on the coarse route, and its masked copies."""
    return (bs.LAUNCHES_MM.count,
            sum(c.count for c in bs.LAUNCHES_MM_COARSE.values()),
            bs.LAUNCHES_MM_MASK.count)


def _check_mm_on_card(x, w, gy, mask, route):
    """block_sparse_matmul under autograd on (x, w), as they are laid
    out: forward and dX row by row against the plain version on
    contiguous copies, dW zero on every dead tile, 2 launches on
    ``route`` (the Hopper route in f32: both on split products; the
    coarse route: both after a masked copy of W); NaN in every dead block
    of W leaves the forward and dX bit for bit."""
    xl, wl = x.detach().requires_grad_(), w.detach().requires_grad_()
    before = _mm_launches()
    split_before = bs.LAUNCHES_MM_F32.count
    y = bs.block_sparse_matmul(xl, wl, mask)
    dx, dw = torch.autograd.grad(y, (xl, wl), gy)
    torch.cuda.synchronize()
    launches, coarse, copies = (a - b for a, b in zip(_mm_launches(), before))
    n = 2 if route == "coarse" else 0
    assert (launches, coarse, copies) == (2, n, n)
    split = route == "hopper" and x.dtype == torch.float32
    assert bs.LAUNCHES_MM_F32.count - split_before == (2 if split else 0)
    dtype = x.dtype
    assert y.dtype == dtype and dx.dtype == dtype and dw.dtype == dtype
    assert y.is_contiguous() and dx.is_contiguous()
    tol = ROW_TOL[dtype]
    xc, wc = x.contiguous(), w.contiguous()
    assert _row_rel_err(y, bs._bs_mm_plain(xc, wc, mask)) <= tol
    want_dx = bs._bs_mm_plain(gy, wc.t().contiguous(), mask.transposed())
    assert _row_rel_err(dx, want_dx) <= tol
    live = torch.from_numpy(mask.elementwise()).to(x.device)
    assert not dw[~live].any()
    poisoned = w.detach().clone().masked_fill_(~live, float("nan"))
    assert torch.equal(bs._bs_mm_cuda(x, poisoned, mask), y)
    assert torch.equal(bs._bs_mm_cuda(gy, poisoned.t(), mask.transposed()),
                       dx)
    return y, dx


@pytest.mark.parametrize("case", sorted(MM_CASES))
def test_block_sparse_matmul_kernel_matches_plain_on_card(cuda_device, case):
    M, K, N, bk, bn, dtype, route = MM_CASES[case]
    g = torch.Generator(device=cuda_device).manual_seed(10)
    x = torch.randn(M, K, device=cuda_device, generator=g).to(dtype)
    w = (0.05 * torch.randn(K, N, device=cuda_device, generator=g)).to(dtype)
    gy = torch.randn(M, N, device=cuda_device, generator=g).to(dtype)
    mask = bs.magnitude_block_mask(w, bk, bn, 0.5)
    _check_mm_on_card(x, w, gy, mask, route)


def test_block_sparse_matmul_dead_column_block_writes_zeros_on_card(
        cuda_device):
    """An output column block with no live K block is exactly zero, in
    the forward (a dead column of the mask) and in dX (a dead row)."""
    g = torch.Generator(device=cuda_device).manual_seed(12)
    m = np.random.RandomState(12).rand(4, 4) < 0.6
    m[:, 1] = False
    m[2, :] = False
    mask = bs.BlockMask(m, 64, 64)
    x = torch.randn(200, 256, device=cuda_device, generator=g).bfloat16()
    w = (0.05 * torch.randn(256, 256, device=cuda_device, generator=g)
         ).bfloat16()
    gy = torch.randn(200, 256, device=cuda_device, generator=g).bfloat16()
    y, dx = _check_mm_on_card(x, w, gy, mask, "hopper")
    assert not y[:, 64:128].any() and not dx[:, 128:192].any()


# the layouts of the reference's any-layout block_sparse_matmul
# (bigdl_tpu/ops/block_sparse.py:708-742): (M, K, N, block, dtype, route)
# and how x and W are laid out
MM_LAYOUTS = {
    "w_t_view_bf16": (300, 1024, 512, 128, torch.bfloat16, "hopper",
                      "w_t_view"),
    "w_t_view_f32": (70, 256, 192, 64, torch.float32, "hopper", "w_t_view"),
    "x_column_slice_f32": (300, 1024, 512, 128, torch.float32, "hopper",
                           "x_column_slice"),
    "x_misaligned_columns_f32": (130, 256, 192, 64, torch.float32, "hopper",
                                 "x_misaligned_columns"),
    "x_rows_from_1_f32": (129, 256, 192, 64, torch.float32, "hopper",
                          "x_rows_from_1"),
    "x_column_slice": (300, 1024, 512, 128, torch.bfloat16, "hopper",
                       "x_column_slice"),
    "x_misaligned_columns": (130, 256, 192, 64, torch.bfloat16, "hopper",
                             "x_misaligned_columns"),
    "x_misaligned_rows_k100": (71, 100, 60, 20, torch.bfloat16, "coarse",
                               "x_rows_from_1"),
    "w_t_view_b8_bf16": (300, 1024, 512, 8, torch.bfloat16, "coarse",
                         "w_t_view"),
    "w_t_view_b8_f32": (200, 256, 192, 8, torch.float32, "coarse",
                        "w_t_view"),
    "x_column_slice_b8_bf16": (300, 1024, 512, 8, torch.bfloat16, "coarse",
                               "x_column_slice"),
    "x_misaligned_columns_b8_f32": (130, 256, 192, 8, torch.float32, "coarse",
                                    "x_misaligned_columns"),
    "x_rows_from_1_hopper": (129, 256, 192, 64, torch.bfloat16, "hopper",
                             "x_rows_from_1"),
    "x_rows_from_1_b8": (129, 256, 192, 8, torch.bfloat16, "coarse",
                         "x_rows_from_1"),
}


@pytest.mark.parametrize("case", sorted(MM_LAYOUTS))
def test_block_sparse_matmul_takes_any_layout_on_card(cuda_device, case):
    """W as a ``.t()`` view of an (N, K) tensor (a Linear-style weight),
    x as a column slice of a wider tensor (16-byte aligned or not) or as
    a row slice starting one row in (not 16-byte aligned at K 100 in
    bf16) each equal the plain version on contiguous copies."""
    M, K, N, block, dtype, route, layout = MM_LAYOUTS[case]
    g = torch.Generator(device=cuda_device).manual_seed(14)
    x = torch.randn(M + 1, K + 24, device=cuda_device, generator=g).to(dtype)
    w = (0.05 * torch.randn(N, K, device=cuda_device, generator=g)).to(dtype)
    gy = torch.randn(M, N, device=cuda_device, generator=g).to(dtype)
    if layout == "w_t_view":
        x, w = x[:M, :K].contiguous(), w.t()
    else:
        w = w.t().contiguous()
        x = {"x_column_slice": x[:M, 8:8 + K],
             "x_misaligned_columns": x[:M, 1:1 + K],
             "x_rows_from_1": x[:, :K].contiguous()[1:]}[layout]
    mask = bs.magnitude_block_mask(w.float().cpu(), block, block, 0.5)
    _check_mm_on_card(x, w, gy, mask, route)


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "hopper"),
                                         (torch.float32, "coarse")])
def test_block_sparse_matmul_more_column_tiles_than_a_grid_axis_on_card(
        cuda_device, dtype, route):
    """N / bn above 65535 at a tiny K: the grid is 1-D."""
    bk = 64 if dtype == torch.bfloat16 else 8
    K, N = bk, bk * 66000
    g = torch.Generator(device=cuda_device).manual_seed(15)
    x = torch.randn(8, K, device=cuda_device, generator=g).to(dtype)
    w = (0.1 * torch.randn(K, N, device=cuda_device, generator=g)).to(dtype)
    gy = torch.randn(8, N, device=cuda_device, generator=g).to(dtype)
    mask = bs.magnitude_block_mask(w.float().cpu(), bk, bk, 0.5)
    _check_mm_on_card(x, w, gy, mask, route)


def test_block_sparse_matmul_never_reads_dead_tiles_on_card(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(11)
    x = torch.randn(100, 256, device=cuda_device, generator=g)
    w = torch.randn(256, 192, device=cuda_device, generator=g)
    mask = bs.magnitude_block_mask(w, 32, 64, 0.5)
    live = torch.from_numpy(mask.elementwise()).to(cuda_device)
    clean = bs._bs_mm_cuda(x, w, mask)
    poisoned = bs._bs_mm_cuda(x, w.masked_fill(~live, float("nan")), mask)
    assert torch.isfinite(poisoned).all() and torch.equal(poisoned, clean)


@pytest.mark.parametrize("w_layout", ["mn_major", "k_major"])
def test_block_sparse_matmul_hopper_route_never_reads_dead_tiles_on_card(
        cuda_device, w_layout):
    """The same on the Hopper route, W read MN-major (the forward's W) and
    K-major (dX's Wᵀ): NaN in every dead W tile leaves the output
    bit-identical, and two calls give equal bits."""
    g = torch.Generator(device=cuda_device).manual_seed(11)
    x = torch.randn(100, 256, device=cuda_device, generator=g).bfloat16()
    w = torch.randn(256, 192, device=cuda_device, generator=g).bfloat16()
    mask = bs.magnitude_block_mask(w, 64, 64, 0.5)
    live = torch.from_numpy(mask.elementwise()).to(cuda_device)
    poisoned = w.masked_fill(~live, float("nan"))
    if w_layout == "k_major":
        w, poisoned = w.t().contiguous().t(), poisoned.t().contiguous().t()
    before = _mm_launches()
    clean = bs._bs_mm_cuda(x, w, mask)
    dirty = bs._bs_mm_cuda(x, poisoned, mask)
    again = bs._bs_mm_cuda(x, w, mask)
    assert _mm_launches() == (before[0] + 3, before[1], before[2])
    assert torch.isfinite(dirty.float()).all()
    assert torch.equal(dirty, clean) and torch.equal(again, clean)


def test_block_sparse_matmul_f32_dead_column_block_writes_zeros_on_card(
        cuda_device):
    """The same in f32 on split products: a dead column of the mask
    gives exactly zero forward columns, a dead row exactly zero dX
    columns."""
    g = torch.Generator(device=cuda_device).manual_seed(16)
    m = np.random.RandomState(16).rand(4, 4) < 0.6
    m[:, 2] = False
    m[1, :] = False
    mask = bs.BlockMask(m, 64, 64)
    x = torch.randn(200, 256, device=cuda_device, generator=g)
    w = 0.05 * torch.randn(256, 256, device=cuda_device, generator=g)
    gy = torch.randn(200, 256, device=cuda_device, generator=g)
    y, dx = _check_mm_on_card(x, w, gy, mask, "hopper")
    assert not y[:, 128:192].any() and not dx[:, 64:128].any()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_block_sparse_matmul_coarse_dead_column_tile_writes_zeros_on_card(
        cuda_device, dtype):
    """On the coarse route (block 8): a BN-column tile of the masked W
    with no live element writes exactly zero, in the forward (output
    columns 128..255 dead) and in dX (W's rows 128..255 dead, dX's
    columns there)."""
    g = torch.Generator(device=cuda_device).manual_seed(19)
    m = np.random.RandomState(19).rand(32, 48) < 0.5
    m[:, 16:32] = False
    m[16:32, :] = False
    m[0, :] = True
    m[0, 16:32] = False
    mask = bs.BlockMask(m, 8, 8)
    x = torch.randn(200, 256, device=cuda_device, generator=g).to(dtype)
    w = (0.05 * torch.randn(256, 384, device=cuda_device, generator=g)
         ).to(dtype)
    gy = torch.randn(200, 384, device=cuda_device, generator=g).to(dtype)
    assert bs._mm_plan(dtype, 8, 8, 256, 384).bn == 128
    y, dx = _check_mm_on_card(x, w, gy, mask, "coarse")
    assert not y[:, 128:256].any() and not dx[:, 128:256].any()
    assert y[:, :128].any() and dx[:, :128].any()


@pytest.mark.parametrize("w_layout", ["mn_major", "k_major"])
def test_block_sparse_matmul_f32_route_never_reads_dead_tiles_on_card(
        cuda_device, w_layout):
    """The f32 Hopper route (split products), W read MN-major and
    K-major: NaN in every dead W tile, and so in its pieces, leaves the
    output bit-identical; two calls give equal bits; every launch on
    split products, none on the coarse route."""
    g = torch.Generator(device=cuda_device).manual_seed(17)
    x = torch.randn(100, 256, device=cuda_device, generator=g)
    w = torch.randn(256, 192, device=cuda_device, generator=g)
    mask = bs.magnitude_block_mask(w, 64, 64, 0.5)
    live = torch.from_numpy(mask.elementwise()).to(cuda_device)
    poisoned = w.masked_fill(~live, float("nan"))
    if w_layout == "k_major":
        w, poisoned = w.t().contiguous().t(), poisoned.t().contiguous().t()
    before = (*_mm_launches(), bs.LAUNCHES_MM_F32.count)
    clean = bs._bs_mm_cuda(x, w, mask)
    dirty = bs._bs_mm_cuda(x, poisoned, mask)
    again = bs._bs_mm_cuda(x, w, mask)
    assert (*_mm_launches(), bs.LAUNCHES_MM_F32.count) == (
        before[0] + 3, before[1], before[2], before[3] + 3)
    assert torch.isfinite(dirty).all()
    assert torch.equal(dirty, clean) and torch.equal(again, clean)
    want = bs._bs_mm_plain(x, w, mask)
    assert _row_rel_err(clean, want) <= ROW_TOL[torch.float32]


def test_block_sparse_matmul_f32_route_raises_instead_of_falling_back(
        cuda_device):
    """A launch the f32 Hopper route refuses (a K chunk of 64, which it is
    not built for) raises; it does not fall back to another route."""
    g = torch.Generator(device=cuda_device).manual_seed(18)
    x = torch.randn(64, 128, device=cuda_device, generator=g)
    w = torch.randn(128, 128, device=cuda_device, generator=g)
    mask = bs.magnitude_block_mask(w, 64, 64, 0.5)
    before = (*_mm_launches(), bs.LAUNCHES_MM_F32.count)
    with pytest.raises(RuntimeError):
        bs._launch_mm(x, w, mask, bs.MmPlan(64, 64))
    assert (*_mm_launches(), bs.LAUNCHES_MM_F32.count) == before


def test_small_blocksparse_lm_trains_on_card_like_cpu(cuda_device):
    # block 16 < 64: every visited tile pair is partly live
    extra = dict(seq_strategy="blocksparse", T=64,
                 blocksparse={"window": 2, "globals": 1, "block": 16})
    counters = (bs.LAUNCHES, bs.LAUNCHES_DKV, bs.LAUNCHES_DQ, fa.LAUNCHES)
    counts = [c.count for c in counters]
    card, card_model, card_upd = _train_small(cuda_device, **extra)
    assert [c.count - n for c, n in zip(counters, counts)] == [6, 6, 6, 0]
    cpu, cpu_model, cpu_upd = _train_small("cpu", **extra)
    np.testing.assert_allclose(card, cpu, rtol=2e-3)
    np.testing.assert_allclose(np.subtract(card[1:], card[0]),
                               np.subtract(cpu[1:], cpu[0]), rtol=1e-4)
    scale = max(torch.linalg.vector_norm(u, dim=-1).max().item()
                for u in cpu_upd.values())
    for name, u in cpu_upd.items():
        assert _row_rel_err(card_upd[name], u, scale) <= 1e-3, name


# ----------------------------------------------------------------------
# the 3x3 conv (K5) and the conv models
# ----------------------------------------------------------------------

K5_CASES = [(2, 56, 56, 64, 64, torch.bfloat16),
            (2, 14, 14, 256, 256, torch.bfloat16),
            (3, 7, 7, 512, 512, torch.float32),
            (2, 7, 5, 3, 10, torch.bfloat16),
            (2, 7, 5, 3, 10, torch.float32),
            (1, 33, 70, 40, 72, torch.bfloat16),
            (1, 1, 1, 8, 3, torch.float32),
            # ResNetCifar's widths; C 96, a partial 64-channel chunk; C 8
            # padded to 16 for TMA, one pixel, all nine taps but one in pad
            (2, 32, 32, 16, 16, torch.bfloat16),
            (2, 16, 16, 32, 32, torch.bfloat16),
            (2, 9, 13, 96, 80, torch.bfloat16),
            (1, 1, 1, 8, 3, torch.bfloat16),
            # the f32 route (split products): ResNet-50's stage 1 and 3
            # widths; C 30, not a multiple of 4 (padded to 32 for TMA),
            # with a ragged O
            (2, 56, 56, 64, 64, torch.float32),
            (2, 14, 14, 256, 256, torch.float32),
            (2, 9, 13, 30, 70, torch.float32)]


@pytest.mark.parametrize("B,H,W,C,O,dtype", K5_CASES)
def test_conv3x3_kernel_matches_plain_on_card(cuda_device, B, H, W, C, O,
                                              dtype):
    """Forward and dX (K5 on the flipped weights) row by row over output
    pixels against the plain version; ragged C, O, H and W included."""
    _check_conv3x3_on_card(cuda_device, B, H, W, C, O, dtype)


def test_conv3x3_kernel_takes_a_misaligned_x_on_card(cuda_device):
    """A bf16 x whose base is not 16-byte aligned (TMA needs one): the
    wrapper launches on an aligned copy, forward and dX."""
    copies = conv3x3.X_COPIES.count
    _check_conv3x3_on_card(cuda_device, 2, 14, 14, 24, 130, torch.bfloat16,
                           misaligned=True)
    # x, misaligned; and the dX conv's input gy, 130 channels padded to 136
    assert conv3x3.X_COPIES.count == copies + 2


def test_conv3x3_kernel_takes_a_misaligned_f32_x_on_card(cuda_device):
    """An f32 x whose base is not 16-byte aligned: the wrapper launches
    on an aligned copy, forward and dX."""
    copies = conv3x3.X_COPIES.count
    _check_conv3x3_on_card(cuda_device, 2, 14, 14, 24, 130, torch.float32,
                           misaligned=True)
    # x, misaligned; and the dX conv's input gy, 130 channels padded to 132
    assert conv3x3.X_COPIES.count == copies + 2


def _check_conv3x3_on_card(cuda_device, B, H, W, C, O, dtype,
                           misaligned=False):
    g = torch.Generator(device=cuda_device).manual_seed(3)
    if misaligned:   # one element into a buffer: 2 or 4 bytes off
        flat = torch.randn(B * H * W * C + 1, device=cuda_device,
                           generator=g).to(dtype)
        x = flat[1:].view(B, H, W, C)
        assert x.data_ptr() % 16
    else:
        x = torch.randn(B, H, W, C, device=cuda_device, generator=g
                        ).to(dtype)
    w = (torch.randn(3, 3, C, O, device=cuda_device, generator=g)
         / (3 * C ** 0.5)).to(dtype)
    gy = torch.randn(B, H, W, O, device=cuda_device, generator=g).to(dtype)
    before = conv3x3.LAUNCHES.count
    y = conv3x3._conv3x3_cuda(x, w.permute(0, 1, 3, 2).contiguous())
    dx = conv3x3._conv3x3_cuda(gy, w.flip(0, 1).contiguous())
    torch.cuda.synchronize()
    assert conv3x3.LAUNCHES.count == before + 2
    assert y.dtype == dx.dtype == dtype
    want_y = api_cases.conv3x3_yardstick(x, w)
    want_dx = api_cases.conv3x3_yardstick(gy, w.flip(0, 1).transpose(2, 3))
    assert _row_rel_err(y, want_y) <= ROW_TOL[dtype]
    assert _row_rel_err(dx, want_dx) <= ROW_TOL[dtype]


def test_conv3x3_autograd_runs_k5_forward_and_dx(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(4)
    x = torch.randn(2, 9, 11, 24, device=cuda_device, generator=g
                    ).requires_grad_()
    w = (0.1 * torch.randn(3, 3, 24, 20, device=cuda_device, generator=g)
         ).requires_grad_()
    gy = torch.randn(2, 9, 11, 20, device=cuda_device, generator=g)
    before = conv3x3.LAUNCHES.count
    got = torch.autograd.grad(conv3x3.conv3x3_s1_same(x, w), (x, w), gy)
    assert conv3x3.LAUNCHES.count == before + 2
    leaves = [t.detach().cpu().requires_grad_() for t in (x, w)]
    want = torch.autograd.grad(conv3x3.conv3x3_s1_same(*leaves), leaves,
                               gy.cpu())
    for a, b in zip(got, want):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-5)


def _train_conv_model(build, x, y, device, steps=3):
    """``steps`` f32 SGD steps of ``build(device)`` over one batch;
    returns (losses, model, updates)."""
    model = build(device)
    losses = []

    def check(state):
        if "loss" in state:
            losses.append(state["loss"])
        return max_iteration(steps)(state)

    opt = LocalOptimizer(model, array([Sample(a, b) for a, b in zip(x, y)]),
                         nn.ClassNLLCriterion(), batch_size=len(x))
    opt.set_optim_method(SGD(0.05)).set_end_when(Trigger(check))
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    RNG().set_seed(1)
    opt.optimize()
    updates = {n: (p.detach() - start[n]).cpu()
               for n, p in model.named_parameters()}
    return losses, model, updates


def _pallas(model):
    for m in model.modules():
        if isinstance(m, nn.SpatialConvolution):
            m.set_conv_impl("pallas")
    return model


@pytest.mark.parametrize("which", ["resnet_cifar8", "lenet5"])
def test_conv_models_train_on_card_like_cpu(cuda_device, which):
    rng = np.random.RandomState(0)
    if which == "resnet_cifar8":
        x = rng.randn(4, 3, 32, 32).astype(np.float32)
        build = lambda dev: _pallas(ResNetCifar(   # noqa: E731
            8, device=dev, generator=torch.Generator().manual_seed(5)))
        # 5 K5 convs forward, and the dX of all but the stem's
        want_launches = 3 * (5 + 4)
    else:
        x = rng.rand(4, 28, 28).astype(np.float32)
        build = lambda dev: LeNet5(   # noqa: E731
            device=dev, generator=torch.Generator().manual_seed(5))
        want_launches = 0
    y = rng.randint(1, 11, size=len(x)).astype(np.float32)
    before = conv3x3.LAUNCHES.count
    card, card_model, card_upd = _train_conv_model(build, x, y, cuda_device)
    assert conv3x3.LAUNCHES.count - before == want_launches
    cpu, cpu_model, cpu_upd = _train_conv_model(build, x, y, "cpu")
    # f32 on both sides: summation order only
    np.testing.assert_allclose(card, cpu, rtol=1e-5)
    np.testing.assert_allclose(np.subtract(card[1:], card[0]),
                               np.subtract(cpu[1:], cpu[0]), rtol=1e-3)
    scale = max(torch.linalg.vector_norm(u, dim=-1).max().item()
                for u in cpu_upd.values())
    for name, u in cpu_upd.items():
        err = _row_rel_err(card_upd[name], u, scale)
        assert err <= 1e-3, (name, err)
    card_stats = dict(card_model.named_buffers())
    for name, b in cpu_model.named_buffers():
        torch.testing.assert_close(card_stats[name].cpu(), b, rtol=1e-4,
                                   atol=1e-6)


# K5 at the shapes Inception v1/v2 and VGG give it (chip_smoke.py phase
# 13 (e) holds every one at B 32): output channels that are not multiples
# of 64 or 128 (208, 224, 288, 320), input channels 96-192, 7 x 7 grids,
# 224 x 224 and 112 x 112 planes, VGG's 3-channel first conv (padded to
# 16), and dX's reversed shapes
K5_ZOO_CASES = [(2, 56, 56, 64, 192, torch.bfloat16),
                (2, 28, 28, 96, 128, torch.float32),
                (2, 14, 14, 96, 208, torch.bfloat16),
                (2, 14, 14, 112, 224, torch.float32),
                (2, 14, 14, 144, 288, torch.bfloat16),
                (2, 14, 14, 288, 144, torch.float32),
                (3, 7, 7, 160, 320, torch.bfloat16),
                (3, 7, 7, 320, 160, torch.float32),
                (2, 7, 7, 192, 384, torch.bfloat16),
                (2, 7, 7, 224, 224, torch.float32),
                (2, 14, 14, 192, 256, torch.bfloat16),
                (1, 224, 224, 3, 64, torch.bfloat16),
                (1, 224, 224, 3, 64, torch.float32),
                (1, 224, 224, 64, 64, torch.bfloat16),
                (1, 112, 112, 128, 64, torch.float32),
                (2, 28, 28, 512, 256, torch.bfloat16)]


@pytest.mark.parametrize("B,H,W,C,O,dtype", K5_ZOO_CASES)
def test_conv3x3_kernel_at_zoo_shapes_matches_plain_on_card(
        cuda_device, B, H, W, C, O, dtype):
    """Forward and dX row by row against the plain version at phase 3's
    limits."""
    _check_conv3x3_on_card(cuda_device, B, H, W, C, O, dtype)


def _inception_module(device):
    from bigdl_tpu_torch.models._build import Build
    from bigdl_tpu_torch.models.inception import _inception_module

    m = _inception_module(Build(device, torch.Generator().manual_seed(6)),
                          32, ((16,), (24, 40), (8, 16), (16,)), "m/")
    return _pallas(m)


def test_inception_module_on_card_matches_cpu(cuda_device):
    """A small Inception v1 module on ``"pallas"`` (its 3x3 on K5, beside
    cuDNN's 1x1, 5x5 and the pool branch, joined by Concat over K5's
    channels-last output), forward and backward in f32: the card against
    the CPU within 1e-5 of each tensor's largest value."""
    x = np.random.RandomState(7).randn(2, 32, 14, 14).astype(np.float32)
    go = np.random.RandomState(8).randn(2, 88, 14, 14).astype(np.float32)
    got, want = {}, {}
    before = conv3x3.LAUNCHES.count
    for dev, out in ((cuda_device, got), ("cpu", want)):
        m = _inception_module(dev)
        xt = torch.from_numpy(x).to(dev)
        out["y"] = m.forward(xt)
        m.zero_grad_parameters()
        out["gi"] = m.backward(xt, torch.from_numpy(go).to(dev))
        out.update({n: p.grad for n, p in m.named_parameters()})
    assert conv3x3.LAUNCHES.count - before == 2      # forward and dX
    for k, w in want.items():
        assert got[k].device.type == "cuda"
        assert api_cases.rel_err(got[k], w) <= 1e-5, k


def test_recurrent_lstm_trains_on_card_like_cpu(cuda_device):
    """``Recurrent(LSTM)`` under a Select and a classifier, 3 f32 SGD
    steps on the card and on the CPU from the same weights: the losses,
    their decreases and every update row by row."""
    rng = np.random.RandomState(9)
    x = rng.randn(8, 12, 10).astype(np.float32)
    y = rng.randint(1, 5, 8).astype(np.float32)

    def build(dev):
        g = torch.Generator().manual_seed(4)
        return nn.Sequential(
            nn.Recurrent(nn.LSTM(10, 16, device=dev, generator=g)),
            nn.Select(2, -1, device=dev),
            nn.Linear(16, 4, device=dev, generator=g),
            nn.LogSoftMax(device=dev))

    card, _, card_upd = _train_conv_model(build, x, y, cuda_device)
    cpu, _, cpu_upd = _train_conv_model(build, x, y, "cpu")
    np.testing.assert_allclose(card, cpu, rtol=1e-5)
    np.testing.assert_allclose(np.subtract(card[1:], card[0]),
                               np.subtract(cpu[1:], cpu[0]), rtol=1e-3)
    scale = max(torch.linalg.vector_norm(u, dim=-1).max().item()
                for u in cpu_upd.values())
    for name, u in cpu_upd.items():
        assert _row_rel_err(card_upd[name], u, scale) <= 1e-3, name


@pytest.mark.parametrize("case", api_cases.zoo_tail_cases(),
                         ids=lambda c: c[0])
def test_zoo_tail_class_on_card_matches_cpu(cuda_device, case):
    """Each class of the image and sequence zoo that phase 13 (a)-(c) do
    not train, forward and backward in f32 on the card against the same
    module on the CPU (chip_smoke.py phase 13 (d)): every tensor it
    returns on the card, each within 1e-5 of its largest value."""
    ref = api_cases.zoo_case_on(case, "cpu")
    got = api_cases.zoo_case_on(case, cuda_device, module=ref[4])
    assert all(t.device.type == "cuda" for t in got[3])
    for part in range(3):
        for g, w in zip(got[part], ref[part], strict=True):
            assert api_cases.rel_err(g, w) <= api_cases.ZOO_REL_TOL


@pytest.fixture
def deterministic_cudnn():
    """cuDNN's deterministic algorithms for one test: its default
    backward algorithms need not give the same bits twice."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield
    torch.backends.cudnn.deterministic = saved


def test_lenet_graph_is_lenet5_on_card(cuda_device, deterministic_cudnn):
    from bigdl_tpu_torch.models.lenet import lenet_graph

    seq = LeNet5(device=cuda_device,
                 generator=torch.Generator().manual_seed(3))
    g = lenet_graph(device=cuda_device)
    with torch.no_grad():
        for p, q in zip(g.parameters(), seq.parameters(), strict=True):
            p.copy_(q)
    x = torch.rand(4, 28, 28, device=cuda_device)
    go = torch.randn(4, 10, device=cuda_device)
    assert torch.equal(seq.forward(x), g.forward(x))
    assert torch.equal(seq.backward(x, go), g.backward(x, go))
    for p, q in zip(g.parameters(), seq.parameters()):
        assert torch.equal(p.grad, q.grad)


# ----------------------------------------------------------------------
# paged serving, beam search and the int8 KV cache on the card
# ----------------------------------------------------------------------

def _serving_lm(device, seed=11):
    return TransformerLM(64, embed_dim=64, num_heads=4, num_layers=2,
                         max_len=128, seq_strategy="flash", device=device,
                         generator=torch.Generator().manual_seed(seed))


def _paged_stream(dec, params, prompt, max_new):
    seq = dec.start(params, prompt)
    toks = [seq.last]
    for _ in range(max_new - 1):
        toks.append(dec.step(params, seq))
    seq.release()
    return np.asarray(toks)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_paged_stream_equals_unpaged_on_card(cuda_device, dtype):
    """The paged decode gathers each request's pages into the view the
    unpaged decode reads from its cache: the same values, shapes and ops
    on the card, so the same tokens.  The prefill runs K1 once a
    layer."""
    model = _serving_lm(cuda_device)
    params = model.param_tree()
    pool = KVPagePool.for_model(model, 32, page_size=16, dtype=dtype)
    dec = cached_paged_decoder(model, pool, compute_dtype=dtype)
    gen = cached_generate(model, compute_dtype=dtype)
    rng = np.random.RandomState(2)
    for T0, max_new in ((40, 20), (64, 24)):
        prompt = rng.randint(1, 65, T0).astype(np.int32)
        before = fa.LAUNCHES.count
        got = _paged_stream(dec, params, prompt, max_new)
        assert fa.LAUNCHES.count - before == 2
        want = gen(params, prompt[None], max_new).cpu().numpy()[0, T0:]
        np.testing.assert_array_equal(got, want)
    assert pool.free_pages == pool.num_pages
    assert pool.arena[0].device == model.device


def test_windowed_paged_prefill_runs_k6_at_block_16_on_card(cuda_device):
    """A 96-token prompt (6 pages of 16) under a window of 2 + 1 global
    binds: the prefill runs K6 once a layer over the page-window mask at
    block 16, no K1, and its first-token logits equal the CPU's plain
    version of the same prefill in f32."""
    model = _serving_lm(cuda_device)
    cpu = _serving_lm("cpu")
    prompt = np.random.RandomState(3).randint(1, 65, 96).astype(np.int32)
    shape = (8, 2, 4, 16, 16)
    logits = []
    for m in (model, cpu):
        prefill, _ = _paged_machinery(m, 1, 2, 16, page_window=2,
                                      page_globals=1)
        k6, k1 = bs.LAUNCHES.count, fa.LAUNCHES.count
        with torch.no_grad():
            logits.append(prefill(
                m.param_tree(), torch.as_tensor(prompt, device=m.device)[None],
                torch.arange(6, device=m.device),
                torch.zeros(shape, device=m.device),
                torch.zeros(shape, device=m.device)).cpu())
        if m is model:
            assert (bs.LAUNCHES.count - k6, fa.LAUNCHES.count - k1) == (2, 0)
    np.testing.assert_allclose(logits[0].numpy(), logits[1].numpy(), rtol=0,
                               atol=1e-4)
    # through the server: windowed stream ids in range, pages back
    pool = KVPagePool.for_model(model, 16, page_size=16,
                                dtype=torch.bfloat16)
    server = InferenceServer(model, kv_pool=pool, kv_page_window=2,
                             generate_dtype=torch.bfloat16).start()
    before = bs.LAUNCHES.count
    try:
        res = server.submit_generate(prompt, 30).result(timeout=300)
    finally:
        assert server.stop(timeout=60)
    assert res.ok and res.output.min() >= 1 and res.output.max() <= 64
    assert bs.LAUNCHES.count - before == 2
    assert pool.free_pages == pool.num_pages


def test_bf16_handoff_round_trip_on_card(cuda_device):
    """Prefill on one server, decode on another, bf16 arenas on the
    card: the pages cross as their bit patterns and the stream equals
    one server's."""
    model = _serving_lm(cuda_device)
    prompt = np.random.RandomState(4).randint(1, 65, 50).astype(np.int32)
    pools = [KVPagePool.for_model(model, 16, page_size=16,
                                  dtype=torch.bfloat16) for _ in range(3)]
    servers = [InferenceServer(model, kv_pool=p, role=r,
                               generate_dtype=torch.bfloat16).start()
               for p, r in zip(pools, ("both", "prefill", "decode"))]
    try:
        want = servers[0].submit_generate(prompt, 12).result(timeout=300)
        blob = servers[1].submit_prefill(prompt).result(timeout=300)
        got = servers[2].submit_decode(blob.output, 12).result(timeout=300)
    finally:
        for s in servers:
            assert s.stop(timeout=60)
    assert want.ok and blob.ok and got.ok
    first = deserialize_handoff(blob.output)["first_token"]
    np.testing.assert_array_equal(np.concatenate([[first], got.output]),
                                  want.output)
    assert all(p.free_pages == p.num_pages for p in pools)


def test_one_beam_is_greedy_and_int8_first_token_exact_on_card(cuda_device):
    model = _serving_lm(cuda_device)
    params = model.param_tree()
    prompts = np.random.RandomState(5).randint(1, 65, (2, 30)).astype(
        np.int32)
    for dtype in (torch.bfloat16, torch.float32):
        greedy = make_generate(model, compute_dtype=dtype)(
            params, prompts, 10).cpu().numpy()
        ids, scores = make_beam_search(model, compute_dtype=dtype)(
            params, prompts, 10, num_beams=1)
        np.testing.assert_array_equal(ids.cpu().numpy(), greedy)
        assert torch.isfinite(scores).all()
        q8 = make_generate(model, compute_dtype=dtype, kv_dtype="int8")(
            params, prompts, 10).cpu().numpy()
        np.testing.assert_array_equal(q8[:, :31], greedy[:, :31])
        assert q8.min() >= 1 and q8.max() <= 64


# ----------------------------------------------------------------------
# checkpoints, resume and the hot swap on the card
# ----------------------------------------------------------------------

def _ckpt_lm(device, seed):
    return TransformerLM(64, embed_dim=64, num_heads=4, num_layers=2,
                         max_len=32, seq_strategy="flash", output="logits",
                         device=device,
                         generator=torch.Generator().manual_seed(seed))


def _ckpt_trainer(model, ckpt_dir, steps, method):
    rng = np.random.RandomState(2)
    x = rng.randint(1, 65, size=(16, 32)).astype(np.int32)
    y = rng.randint(1, 65, size=(16, 32)).astype(np.int32)
    opt = LocalOptimizer(model, array([Sample(a, b) for a, b in zip(x, y)]),
                         nn.TimeDistributedCriterion(
                             nn.CrossEntropyCriterion(), True), batch_size=4)
    opt.set_optim_method(method)
    opt.set_end_when(max_iteration(steps))
    opt.set_checkpoint(ckpt_dir, several_iteration(1))
    return opt


def test_checkpoint_from_card_loads_in_a_cpu_only_process(cuda_device,
                                                          tmp_path):
    """Legs written from card tensors (params, Adam's slots) unpickle in a
    process that sees no card, every tensor on the CPU."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    from bigdl_tpu_torch.optim import Adam

    model = _ckpt_lm(cuda_device, 0)
    opt = _ckpt_trainer(model, str(tmp_path), 2, Adam(1e-3))
    opt.optimize()
    want = sum(float(p.detach().double().sum()) for p in model.parameters())
    code = (
        "import torch\n"
        "from bigdl_tpu_torch.resilience.checkpoint import "
        "verify_and_load_latest\n"
        "from bigdl_tpu_torch.utils.tree import tree_leaves\n"
        "assert not torch.cuda.is_available()\n"
        f"d = {str(tmp_path)!r}\n"
        "leg, p = verify_and_load_latest(d, 'model')\n"
        "om, _ = verify_and_load_latest(d, 'optimMethod')\n"
        "ts, _ = verify_and_load_latest(d, 'trainState')\n"
        "ts_ok = ts['records_this_epoch'] == 8\n"
        "leaves = tree_leaves(leg['params']) + tree_leaves(om._slots)\n"
        "assert all(t.device.type == 'cpu' for t in leaves)\n"
        "print(p.rsplit('.', 1)[-1], int(om._slots['t']), ts_ok,\n"
        "      repr(sum(float(t.double().sum())\n"
        "               for t in tree_leaves(leg['params']))))\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(Path(__file__).resolve().parents[1]))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    step, t, ts_ok, total = out.stdout.split()
    assert (step, t, ts_ok) == ("2", "2", "True")
    assert float(total) == want


def test_resume_on_card(cuda_device, tmp_path):
    """2 steps + resume + 2 steps against 4 uninterrupted ones on the
    card: bit for bit when two uninterrupted runs agree bit for bit
    (the card's kernels need not be deterministic), else within the
    card-vs-CPU training limit."""
    def run(seed, resume=None, steps=4, ckpt="a"):
        model = _ckpt_lm(cuda_device, seed)
        opt = _ckpt_trainer(model, str(tmp_path / ckpt), steps,
                            SGD(0.05, momentum=0.9))
        RNG().set_seed(999 if resume else 1)
        if resume is not None:
            assert opt.resume_from_checkpoint(resume)
        opt.optimize()
        return [p.detach().cpu() for p in model.parameters()]

    ref = run(0)
    again = run(0, ckpt="b")
    got = run(5, resume=2)
    if all(torch.equal(a, b) for a, b in zip(ref, again)):
        assert all(torch.equal(a, b) for a, b in zip(ref, got))
    else:
        for a, b in zip(ref, got):
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=2e-3,
                                       atol=1e-6)


def test_swap_from_checkpoint_on_card(cuda_device, tmp_path):
    """A bf16 server on the card swaps in a verified checkpoint written
    from card tensors: the next stream equals a fresh server's on the
    new params; a bit-flipped file is refused and quarantined."""
    import os

    from bigdl_tpu_torch.resilience import faults
    from bigdl_tpu_torch.serving import SwapRejected
    from bigdl_tpu_torch.utils import file_io

    prompts = np.random.RandomState(6).randint(1, 65, (2, 12)).astype(
        np.int32)

    def streams(server):
        futs = [server.submit_generate(p, 8) for p in prompts]
        res = [f.result(timeout=300) for f in futs]
        assert all(r.ok for r in res)
        return [r.output.tolist() for r in res]

    new = _ckpt_lm(cuda_device, 3)
    path = str(tmp_path / "model.8")
    file_io.save({"params": new.param_tree(), "buffers": new.buffer_tree()},
                 path, atomic=True, checksum=True)
    bad = str(tmp_path / "model.9")
    file_io.save({"params": _ckpt_lm(cuda_device, 4).param_tree(),
                  "buffers": new.buffer_tree()}, bad, atomic=True,
                 checksum=True)
    faults.bit_flip(bad)
    server = InferenceServer(_ckpt_lm(cuda_device, 0),
                             generate_dtype=torch.bfloat16).start()
    fresh = InferenceServer(new, generate_dtype=torch.bfloat16).start()
    try:
        old = streams(server)
        assert server.swap_params(path=path)
        got = streams(server)
        with pytest.raises(SwapRejected, match="crc32c"):
            server.swap_params(path=bad)
        assert streams(server) == got
        want = streams(fresh)
    finally:
        assert server.stop(timeout=60) and fresh.stop(timeout=60)
    assert got == want and got != old
    assert os.path.exists(bad + ".corrupt")


# ----------------------------------------------------------------------
# the Torch-style API on the card: strided layouts through K4 and K1-K3,
# every class ported with the API against the CPU, a verbs step
# ----------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [bf16, torch.float32])
def test_transposed_layer_norm_input_is_read_in_place_on_card(cuda_device,
                                                              dtype):
    """``Sequential(Transpose([(2, 3)]), LayerNorm)`` on [B, F, T]: K4's
    strided instantiation reads the view (no copy), bit for bit the
    kernel on the contiguous input."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    seq = nn.Sequential(nn.Transpose([(2, 3)], device=cuda_device),
                        nn.LayerNorm(96, device=cuda_device))
    x = torch.randn(3, 96, 40, device=cuda_device, generator=g).to(dtype)
    gam = torch.randn(96, device=cuda_device, generator=g).to(dtype)
    bet = torch.randn(96, device=cuda_device, generator=g).to(dtype)
    params = {"0": {}, "1": {"weight": gam, "bias": bet}}
    for c in (ln.LAUNCHES, ln.LAUNCHES_STRIDED, ln.X_COPIES):
        c.reset()
    with torch.no_grad():
        y = seq.apply_fn(params, x)
        want = seq[1].apply_fn(params["1"], x.transpose(1, 2).contiguous())
    assert (ln.LAUNCHES.count, ln.LAUNCHES_STRIDED.count,
            ln.X_COPIES.count) == (2, 1, 0)
    assert torch.equal(y, want)
    plain = ln._layer_norm_plain(x.transpose(1, 2), gam, bet, 1e-5)
    tol = 4e-2 if dtype == bf16 else 1e-4
    assert (y.float() - plain.float()).abs().max().item() <= tol


@pytest.mark.parametrize("dtype", [bf16, torch.float32])
def test_narrowed_attention_input_is_read_in_place_on_card(cuda_device,
                                                           dtype):
    """A ``Narrow`` column slice into flash attention: K1-K3 read the
    layer's head-strided q, k, v with no operand copy; the output is the
    contiguous input's bit for bit."""
    from bigdl_tpu_torch.optim.optimizer import cast_floats

    g = torch.Generator(device=cuda_device).manual_seed(1)
    model = nn.Sequential(
        nn.Narrow(3, 1, 64, device=cuda_device),
        nn.MultiHeadAttention(64, 2, causal=True, seq_strategy="flash",
                              device=cuda_device,
                              generator=torch.Generator().manual_seed(0)))
    params = cast_floats(model.param_tree(), dtype)
    x = torch.randn(2, 48, 128, device=cuda_device, generator=g).to(dtype)
    for c in (fa.LAUNCHES, fa.LAUNCHES_DKV, fa.LAUNCHES_DQ,
              fa.OPERAND_COPIES):
        c.reset()
    xl = x.detach().requires_grad_()
    y = model.apply_fn(params, xl)
    y.float().square().sum().backward()
    assert (fa.LAUNCHES.count, fa.LAUNCHES_DKV.count, fa.LAUNCHES_DQ.count,
            fa.OPERAND_COPIES.count) == (1, 1, 1, 0)
    with torch.no_grad():
        want = model[1].apply_fn(params["1"], x.narrow(2, 0, 64).contiguous())
    assert torch.equal(y.detach(), want)
    assert torch.isfinite(xl.grad).all() and not xl.grad[..., 64:].any()


@pytest.mark.parametrize("case", api_cases.zoo_cases(), ids=lambda c: c[0])
def test_ported_api_class_on_card_matches_cpu(cuda_device, case):
    """Each class ported with the Torch-style API, forward and backward
    in f32 on the card against the same module on the CPU (chip_smoke.py
    phase 11 (d)): every tensor it returns on the card, each within
    1e-5 of its largest value."""
    ref = api_cases.zoo_case_on(case, "cpu")
    got = api_cases.zoo_case_on(case, "cuda",
                                module=ref[4] if case[3] is None else None)
    assert all(t.device.type == "cuda" for t in got[3])
    for part in range(3):
        for g, w in zip(got[part], ref[part], strict=True):
            assert api_cases.rel_err(g, w) <= api_cases.ZOO_REL_TOL


def test_tensor_facade_on_card_matches_cpu(cuda_device):
    got, on_card = api_cases.tensor_ops("cuda")
    want, _ = api_cases.tensor_ops("cpu")
    assert on_card
    for k in want:
        assert api_cases.rel_err(got[k], want[k]) <= 1e-5, k


def test_verbs_step_equals_local_optimizer_step_on_card(cuda_device):
    """One step of a small flash TransformerLM written with the verbs
    (zero_grad_parameters, forward, criterion forward and backward,
    backward, update_parameters) against LocalOptimizer's step from the
    same weights: the same loss and parameters; one forward a step (K1
    once a layer)."""
    V, T, B = 64, 32, 4
    kw = dict(embed_dim=64, num_heads=2, num_layers=2, max_len=T,
              seq_strategy="flash", output="logits", device=cuda_device)
    rng = np.random.RandomState(0)
    ids = rng.randint(1, V + 1, size=(B, T)).astype(np.int32)
    crit = nn.TimeDistributedCriterion(nn.CrossEntropyCriterion(), True)

    ref = TransformerLM(V, **kw, generator=torch.Generator().manual_seed(0))
    opt = LocalOptimizer(ref, array([Sample(a, a) for a in ids]), crit,
                         batch_size=B)
    opt.set_optim_method(SGD(0.1)).set_end_when(max_iteration(1))
    RNG().set_seed(1)
    opt.optimize()

    model = TransformerLM(V, **kw, generator=torch.Generator().manual_seed(0))
    x = torch.as_tensor(ids, device=cuda_device)
    fa.LAUNCHES.reset()
    model.zero_grad_parameters()
    out = model.forward(x)
    loss = crit.forward(out, x)
    model.backward(x, crit.backward(out, x))
    model.update_parameters(0.1)
    assert fa.LAUNCHES.count == 2
    assert math.isclose(loss, opt.optim_method.state["loss"], rel_tol=1e-6)
    for (name, p), q in zip(model.named_parameters(), ref.parameters()):
        torch.testing.assert_close(p, q, rtol=1e-5, atol=1e-6, msg=name)


# ----------------------------------------------------------------------
# training breadth: remat, "block" attention, the optim methods
# ----------------------------------------------------------------------

def _lm_grads(model, ids, generator_seed=5):
    """Loss and parameter gradients of one training-mode forward of
    ``model`` on ``ids``, random draws from a seeded step generator."""
    from bigdl_tpu_torch.nn.module import rng_scope
    from bigdl_tpu_torch.utils.tree import tree_leaves

    model.train()
    params = model.param_tree()
    leaves = tree_leaves(params)
    crit = nn.TimeDistributedCriterion(nn.CrossEntropyCriterion(), True)
    x = torch.as_tensor(ids, device=model.device)
    gen = torch.Generator(device=model.device).manual_seed(generator_seed)
    with rng_scope(gen):
        loss = crit._loss(model.apply_fn(params, x), x)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), grads


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_remat_runs_each_block_twice_and_keeps_the_gradients_on_card(
        cuda_device, dropout):
    """remat=True on the card: K1 and K4 run again for each block in the
    backward (K1 2L, K2 L, K3 L, K4 4L + 1 a step), and the loss and
    every gradient equal the plain model's; under dropout the recompute
    draws the forward's masks."""
    V, T, B, L = 64, 32, 3, 2
    ids = np.random.RandomState(0).randint(1, V + 1, size=(B, T)) \
        .astype(np.int32)
    out = {}
    for remat in (False, True):
        model = TransformerLM(V, embed_dim=64, num_heads=4, num_layers=L,
                              max_len=T, seq_strategy="flash",
                              output="logits", dropout=dropout, remat=remat,
                              device=cuda_device,
                              generator=torch.Generator().manual_seed(3))
        counts = [c.count for c in (fa.LAUNCHES, fa.LAUNCHES_DKV,
                                    fa.LAUNCHES_DQ, ln.LAUNCHES)]
        out[remat] = _lm_grads(model, ids)
        torch.cuda.synchronize()
        launched = [c.count - n for c, n in zip(
            (fa.LAUNCHES, fa.LAUNCHES_DKV, fa.LAUNCHES_DQ, ln.LAUNCHES),
            counts)]
        want = [2 * L, L, L, 4 * L + 1] if remat else [L, L, L, 2 * L + 1]
        assert launched == want, (remat, launched)
    assert torch.equal(out[True][0], out[False][0])
    for a, b in zip(out[True][1], out[False][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_remat_costs_nothing_without_gradients_on_card(cuda_device):
    V, T, L = 64, 32, 2
    model = TransformerLM(V, embed_dim=64, num_heads=4, num_layers=L,
                          max_len=T, seq_strategy="flash", remat=True,
                          device=cuda_device,
                          generator=torch.Generator().manual_seed(3))
    x = torch.randint(1, V + 1, (2, T), device=cuda_device)
    fa.LAUNCHES.reset()
    ln.LAUNCHES.reset()
    with torch.no_grad():
        model.evaluate()(x)
    assert fa.LAUNCHES.count == L and ln.LAUNCHES.count == 2 * L + 1


def test_block_strategy_lm_trains_on_card_like_cpu(cuda_device):
    """seq_strategy="block" (plain PyTorch, no kernel): 3 f32 steps on
    the card held against the CPU, blocks of 8 over a ragged T 20."""
    counts = [c.count for c in (fa.LAUNCHES, fa.LAUNCHES_DKV,
                                fa.LAUNCHES_DQ, ln.LAUNCHES)]
    card, _, card_upd = _train_small(cuda_device, seq_strategy="block", block_size=8)
    launched = [c.count - n for c, n in zip(
        (fa.LAUNCHES, fa.LAUNCHES_DKV, fa.LAUNCHES_DQ, ln.LAUNCHES), counts)]
    assert launched == [0, 0, 0, 15]
    cpu, _, cpu_upd = _train_small("cpu", seq_strategy="block", block_size=8)
    np.testing.assert_allclose(card, cpu, rtol=1e-6)
    np.testing.assert_allclose(np.subtract(card[1:], card[0]),
                               np.subtract(cpu[1:], cpu[0]), rtol=1e-4)
    scale = max(torch.linalg.vector_norm(u, dim=-1).max().item()
                for u in cpu_upd.values())
    for name, u in cpu_upd.items():
        assert _row_rel_err(card_upd[name], u, scale) <= 1e-3, name


def _method_cases():
    from bigdl_tpu_torch import optim

    return {
        "Adagrad": lambda: optim.Adagrad(0.05, weight_decay=0.01),
        "Adadelta": lambda: optim.Adadelta(epsilon=1e-2),
        "Adamax": lambda: optim.Adamax(0.05),
        "RMSprop": lambda: optim.RMSprop(0.05),
        "TorchOptimMethod(Adam)": lambda: optim.TorchOptimMethod(
            torch.optim.Adam, lr=0.05),
        "TorchOptimMethod(SGD)": lambda: optim.TorchOptimMethod(
            torch.optim.SGD, lr=0.05, momentum=0.9, dampening=0.5),
    }


@pytest.mark.parametrize("name", list(_method_cases()))
def test_optim_method_steps_on_card_match_cpu(cuda_device, name):
    """Three steps of each optim method on a small tree, card vs CPU."""
    rng = np.random.RandomState(5)
    params = {"w": rng.randn(4, 3).astype(np.float32),
              "sub": {"b": rng.randn(3).astype(np.float32)}}
    grads = [{"w": rng.randn(4, 3).astype(np.float32),
              "sub": {"b": rng.randn(3).astype(np.float32)}}
             for _ in range(3)]
    from bigdl_tpu_torch.utils.tree import tree_leaves, tree_map

    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        method = _method_cases()[name]()
        p = tree_map(lambda a: torch.as_tensor(a, device=dev), params)
        slots = method.init_state(p)
        for g in grads:
            p, slots = method.step(
                tree_map(lambda a: torch.as_tensor(a, device=dev), g), p,
                slots, method.get_current_lr())
        out[dev.type] = [t.cpu() for t in tree_leaves(p)]
        assert all(t.device.type == dev.type for t in tree_leaves(slots)
                   if torch.is_tensor(t))
    for a, b in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_lbfgs_rosenbrock_on_card(cuda_device):
    from bigdl_tpu_torch.optim import LBFGS

    def feval(x):
        a, b = x[:-1], x[1:]
        r = b - a * a
        g = torch.zeros_like(x)
        g[:-1] += -400.0 * a * r - 2.0 * (1 - a)
        g[1:] += 200.0 * r
        return float(torch.sum(100.0 * r * r + (1 - a) ** 2)), g

    lbfgs = LBFGS(max_iter=100, learning_rate=0.5, line_search=True)
    x = torch.zeros(4, device=cuda_device)
    for _ in range(20):
        x, _ = lbfgs.optimize(feval, x)
    assert x.device.type == "cuda" and feval(x)[0] < 1e-2


# ---------------------------------------------------------------------------
# telemetry: the kernels' work reports, losses with telemetry, memory gauges
# ---------------------------------------------------------------------------

def _counted(fn):
    """(FLOPs, bytes, sparse reports) of ``fn()`` under the work counter."""
    from bigdl_tpu_torch.telemetry.perf import WorkCounter

    with WorkCounter() as c:
        fn()
    return c.flops, c.bytes, c.sparse


@pytest.mark.parametrize("dtype", [bf16, torch.float32])
def test_k1_k4_report_the_same_work_on_card_as_on_cpu(cuda_device, dtype):
    """K1-K3 (forward and backward of flash attention) and K4 report the
    same FLOPs and bytes from the card as their plain versions from the
    CPU: the work is counted by the op's shapes, not by what runs it."""
    rng = np.random.RandomState(0)
    B, H, T, D = 2, 4, 128, 64
    arrays = [rng.randn(B, H, T, D).astype(np.float32) for _ in range(4)]
    x = rng.randn(6, 96).astype(np.float32)
    gb = [rng.randn(96).astype(np.float32) for _ in range(2)]
    got = {}
    for dev in ("cpu", cuda_device):
        q, k, v, g = (torch.tensor(a, device=dev, dtype=dtype,
                                   requires_grad=i < 3)
                      for i, a in enumerate(arrays))

        def attend():
            o = fa.flash_attention(q, k, v, causal=True)
            torch.autograd.backward(o, g)

        xs = [torch.tensor(a, device=dev, dtype=dtype) for a in [x] + gb]
        got[torch.device(dev).type] = (
            _counted(attend), _counted(lambda: ln.fused_layer_norm(*xs)))
    assert got["cuda"] == got["cpu"]
    (flops, _, _), (ln_flops, ln_bytes, _) = got["cuda"]
    assert flops == 12.0 * B * H * T * T * D   # fwd 4 BHTSD, bwd 8 BHTSD
    assert ln_flops == 0.0
    assert ln_bytes == (2 * x.size + 2 * 96) * torch.empty(
        (), dtype=dtype).element_size()


def test_telemetry_leaves_small_lm_losses_unchanged_bit_for_bit(cuda_device):
    """The 2-layer LM trained 3 f32 steps on the card with a Telemetry
    bundle attached (the first step under the work counter) gives every
    loss and parameter of the run without it, bit for bit, through the
    same K1-K4 launches, and the bundle counts 3 steps, one compile."""
    from bigdl_tpu_torch.telemetry import MetricsRegistry, Telemetry

    counters = (fa.LAUNCHES, fa.LAUNCHES_DKV, fa.LAUNCHES_DQ, ln.LAUNCHES)
    plain, plain_model, _ = _train_small("cuda")
    tm = Telemetry(registry=MetricsRegistry())

    class Observed(LocalOptimizer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.set_telemetry(tm)

    before = [c.count for c in counters]
    got, model, _ = _train_small("cuda", optimizer=Observed)
    assert [c.count - n for c, n in zip(counters, before)] == [6, 6, 6, 15]
    assert got == plain
    for (name, a), b in zip(model.state_dict().items(),
                            plain_model.state_dict().values()):
        assert torch.equal(a, b), name
    assert tm.steps.value == 3 and tm.compile_seconds.count == 1
    assert tm.perf.current_cost.flops > 0
    assert tm.perf.spec.kind in ("h100", "cpu")


def test_memory_gauges_read_the_allocator(cuda_device):
    """``poll_memory_stats`` on the card: in use and peak are the caching
    allocator's allocated bytes, the limit the device's total memory."""
    from bigdl_tpu_torch.telemetry import MetricsRegistry
    from bigdl_tpu_torch.telemetry.perf import PerfAccountant

    keep = torch.empty(1 << 24, device=cuda_device)
    pa = PerfAccountant(registry=MetricsRegistry(), device=cuda_device)
    stats = pa.poll_memory_stats()
    assert stats["bytes_in_use"] == torch.cuda.memory_allocated()
    assert stats["peak_bytes_in_use"] == torch.cuda.max_memory_allocated()
    assert stats["bytes_limit"] == torch.cuda.get_device_properties(
        cuda_device).total_memory
    snap = pa.registry.snapshot()["metrics"]
    assert snap["bigdl_perf_hbm_peak_bytes"]["series"][0]["value"] == \
        stats["peak_bytes_in_use"]
    assert stats["bytes_in_use"] >= keep.numel() * 4
