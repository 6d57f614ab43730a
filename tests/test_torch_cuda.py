"""The port's kernels on the card (``cuda``-marked; they skip without a
CUDA device).

This file imports neither jax nor the JAX package, so it also runs on a
GPU machine that has no jax.  There, run it without the suite's
conftest (which configures jax):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Each kernel is held against its plain PyTorch version on the same
inputs, forward and backward; a small TransformerLM served on the card
in f32, and one trained three steps on the card in f32, are held
against the same model on the CPU.
"""
import math

import numpy as np
import pytest
import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.dataset import Sample, array
from bigdl_tpu_torch.models.generate import make_generate
from bigdl_tpu_torch.models.transformer import TransformerLM
from bigdl_tpu_torch.ops import flash_attention as fa
from bigdl_tpu_torch.ops import layer_norm as ln
from bigdl_tpu_torch.optim import SGD, LocalOptimizer, Trigger, max_iteration
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


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels do not run on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("T,S,D,dtype,causal", [
    (512, 512, 128, torch.bfloat16, True),
    (200, 200, 128, torch.bfloat16, True),
    (300, 200, 64, torch.bfloat16, True),
    (1, 1, 16, torch.bfloat16, True),
    (130, 96, 32, torch.float32, False),
    (256, 256, 128, torch.float32, True),
])
def test_flash_kernel_matches_plain_on_card(cuda_device, T, S, D, dtype,
                                            causal):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn(2, 4, n, D, device=cuda_device,
                           generator=g).to(dtype) for n in (T, S, S))
    before = fa.LAUNCHES.count
    o, lse = fa.flash_forward(q, k, v, causal)
    torch.cuda.synchronize()
    assert fa.LAUNCHES.count == before + 1
    o_ref, lse_ref = fa._flash_plain(q, k, v, causal, 1 / math.sqrt(D))
    assert _row_rel_err(o, o_ref) <= ROW_TOL[dtype]
    assert (lse - lse_ref).abs().max().item() <= 1e-3


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
    q = torch.randn(1, 2, 16, 48, device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q, q, q)
    q = torch.randn(1, 2, 16, 32, device=cuda_device, dtype=torch.float16)
    with pytest.raises(TypeError):
        fa.flash_attention(q, q, q)
    q = torch.randn(1, 16, 2, 32, device=cuda_device).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q, q, q)


@pytest.mark.parametrize("T,S,D,dtype,causal", [
    (512, 512, 128, torch.bfloat16, True),
    (200, 200, 128, torch.bfloat16, True),
    (300, 200, 64, torch.bfloat16, True),
    (200, 300, 64, torch.bfloat16, True),
    (1, 1, 16, torch.bfloat16, True),
    (96, 130, 32, torch.bfloat16, False),
    (130, 96, 32, torch.float32, False),
    (256, 256, 128, torch.float32, True),
])
def test_flash_bwd_kernels_match_plain_on_card(cuda_device, T, S, D, dtype,
                                               causal):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    q, k, v = (torch.randn(2, 4, n, D, device=cuda_device,
                           generator=g).to(dtype) for n in (T, S, S))
    d_o = torch.randn(2, 4, T, D, device=cuda_device, generator=g).to(dtype)
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
    largest = max(torch.linalg.vector_norm(b.float(), dim=-1).max().item()
                  for b in want)
    for a, b in zip(got, want):
        assert a.dtype == dtype and torch.isfinite(a.float()).all()
        assert _row_rel_err(a, b, largest) <= ROW_TOL[dtype]
    if causal and S > T:   # keys no query attends get exactly zero
        assert not got[1][:, :, T:].any() and not got[2][:, :, T:].any()


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


def _train_small(device, steps=3):
    cfg = dict(embed_dim=64, num_heads=4, num_layers=2, max_len=32,
               seq_strategy="flash", output="logits")
    V, T, B = 64, 20, 3
    model = TransformerLM(V, **cfg, device=device,
                          generator=torch.Generator().manual_seed(3))
    rng = np.random.RandomState(0)
    x = rng.randint(1, V + 1, size=(B, T)).astype(np.int32)
    y = rng.randint(1, V + 1, size=(B, T)).astype(np.int32)
    losses = []

    def check(state):
        if "loss" in state:
            losses.append(state["loss"])
        return max_iteration(steps)(state)

    opt = LocalOptimizer(model, array([Sample(a, b) for a, b in zip(x, y)]),
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
