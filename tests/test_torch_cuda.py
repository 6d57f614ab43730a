"""The port's kernels on the card (``cuda``-marked; they skip without a
CUDA device).

This file imports neither jax nor the JAX package, so it also runs on a
GPU machine that has no jax.  There, run it without the suite's
conftest (which configures jax):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Each kernel is held against its plain PyTorch version on the same
inputs, and a small TransformerLM served on the card in f32 is held
against the same model on the CPU.
"""
import math

import numpy as np
import pytest
import torch

from bigdl_tpu_torch.models.generate import make_generate
from bigdl_tpu_torch.models.transformer import TransformerLM
from bigdl_tpu_torch.ops import flash_attention as fa
from bigdl_tpu_torch.ops import layer_norm as ln

pytestmark = pytest.mark.cuda


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
    # bf16: P and O round to bf16 at different points (chip_smoke.py)
    tol = 3e-2 if dtype == torch.bfloat16 else 1e-4
    assert (o.float() - o_ref.float()).abs().max().item() <= tol
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


def test_cuda_kernels_refuse_gradients(cuda_device):
    q = torch.randn(1, 2, 16, 16, device=cuda_device, requires_grad=True)
    with pytest.raises(NotImplementedError, match="training slice"):
        fa.flash_attention(q, q, q)
    x = torch.randn(4, 16, device=cuda_device, requires_grad=True)
    with pytest.raises(NotImplementedError, match="training slice"):
        ln.fused_layer_norm(x, x[0].detach(), x[0].detach())


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
