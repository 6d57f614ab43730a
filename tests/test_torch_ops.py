"""The port's kernel modules (bigdl_tpu_torch.ops) against the JAX
package's Pallas kernels, run in interpret mode on the CPU.

On the CPU the wrappers take their plain versions — the kernels' math
in PyTorch — and launch nothing.  The kernels themselves are compared
with those plain versions on the card by ``tests/test_torch_cuda.py``
and by ``chip_smoke.py``.
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bigdl_tpu.ops.flash_attention import _flash_fwd
from bigdl_tpu.ops.flash_attention import flash_attention as jax_flash
from bigdl_tpu.ops.layer_norm import fused_layer_norm as jax_ln
from bigdl_tpu_torch.ops import flash_attention as fa
from bigdl_tpu_torch.ops import layer_norm as ln

# The suite runs in several processes at once: one intra-op thread each
# keeps these small tensors from crowding the timing-sensitive tests.
torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-5)   # as tests/test_pallas_ops.py


def _qkv(B, H, T, S, D, seed):
    rng = np.random.RandomState(seed)
    q = (rng.randn(B, H, T, D) * 0.5).astype(np.float32)
    k = (rng.randn(B, H, S, D) * 0.5).astype(np.float32)
    v = (rng.randn(B, H, S, D) * 0.5).astype(np.float32)
    return q, k, v


# (B, H, T, S, D, causal, sm_scale, block): one block each way, two
# blocks each way (online-softmax rescale), causal T > S, a non-default
# scale
FLASH_CASES = {
    "one_block": (2, 2, 128, 128, 32, False, None, None),
    "one_block_causal": (2, 2, 128, 128, 32, True, None, None),
    "multi_block_causal": (1, 2, 256, 256, 32, True, None, 128),
    "multi_block": (1, 2, 256, 256, 32, False, None, 128),
    "causal_t_gt_s": (1, 2, 256, 128, 32, True, None, 128),
    "sm_scale": (2, 2, 128, 128, 32, True, 0.3, None),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_plain_matches_pallas_interpret(case):
    B, H, T, S, D, causal, sm_scale, block = FLASH_CASES[case]
    q, k, v = _qkv(B, H, T, S, D, seed=len(case))
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=causal, sm_scale=sm_scale, interpret=True,
                     block_q=block, block_k=block)
    got = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal=causal,
                             sm_scale=sm_scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_plain_lse_matches_pallas_interpret(causal):
    q, k, v = _qkv(1, 2, 256, 256, 32, seed=3)
    scale = 1 / math.sqrt(32)
    o_want, lse_want = _flash_fwd(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal, scale, 128, 128,
                                  True)
    o, lse = fa.flash_forward(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal)
    assert lse.shape == (2, 1, 256) and lse.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), np.asarray(o_want), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_want), **TOL)


def test_flash_plain_takes_ragged_lengths_and_keeps_dtype():
    # T = 200 is no block multiple: the port masks the ragged edge, the
    # dense oracle is the reference
    q, k, v = _qkv(1, 2, 200, 200, 32, seed=5)
    from bigdl_tpu.ops.flash_attention import _attention_reference

    want = _attention_reference(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), True, 1 / math.sqrt(32))
    got = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    bf = fa.flash_attention(*(torch.from_numpy(a).bfloat16()
                              for a in (q, k, v)), causal=True)
    assert bf.dtype == torch.bfloat16


@pytest.mark.parametrize("shape", [(4, 7, 64), (16, 1000)])
def test_layer_norm_plain_matches_pallas_interpret(shape):
    rng = np.random.RandomState(1)
    F = shape[-1]
    x = (rng.randn(*shape) * 2 + 0.5).astype(np.float32)
    g = (1 + 0.1 * rng.randn(F)).astype(np.float32)
    b = (0.1 * rng.randn(F)).astype(np.float32)
    want = jax_ln(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), 1e-5,
                  interpret=True)
    got = ln.fused_layer_norm(torch.from_numpy(x), torch.from_numpy(g),
                              torch.from_numpy(b), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_cpu_wrappers_take_the_plain_version_and_launch_nothing():
    fa.LAUNCHES.reset()
    ln.LAUNCHES.reset()
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 16, 16, 16, 0))
    o = fa.flash_attention(q, k, v, causal=True)
    assert torch.equal(o, fa._flash_plain(q, k, v, True, 0.25)[0])
    x = torch.randn(3, 16)
    g, b = torch.ones(16), torch.zeros(16)
    y = ln.fused_layer_norm(x, g, b)
    assert torch.equal(y, ln._layer_norm_plain(x, g, b, 1e-5))
    assert fa.LAUNCHES.count == 0 and ln.LAUNCHES.count == 0


def test_non_cpu_tensors_never_reach_the_plain_version():
    # a tensor off the CPU must launch the kernel or raise — here a
    # meta tensor, which no kernel takes
    m = torch.empty(1, 2, 16, 16, device="meta")
    with pytest.raises(ValueError):
        fa.flash_attention(m, m, m)
    with pytest.raises(ValueError):
        ln.fused_layer_norm(torch.empty(3, 16, device="meta"),
                            torch.empty(16, device="meta"),
                            torch.empty(16, device="meta"))
    with pytest.raises(ValueError):   # mixed devices
        fa.flash_attention(torch.zeros(1, 2, 16, 16), m, m)
