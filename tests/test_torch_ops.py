"""The port's kernel modules (bigdl_tpu_torch.ops) against the JAX
package's Pallas kernels, run in interpret mode on the CPU, forward and
backward, and the fused cross entropy against the JAX op.

On the CPU the wrappers take their plain versions — the kernels' math
in PyTorch — and launch nothing.  The kernels themselves are compared
with those plain versions on the card by ``tests/test_torch_cuda.py``
and by ``chip_smoke.py``.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu.ops.flash_attention import _flash_bwd, _flash_fwd, _pick_block
from bigdl_tpu.ops.flash_attention import flash_attention as jax_flash
from bigdl_tpu.ops.fused_xent import softmax_xent_rows as jax_xent
from bigdl_tpu.ops.layer_norm import fused_layer_norm as jax_ln
from bigdl_tpu_torch.ops import flash_attention as fa
from bigdl_tpu_torch.ops import fused_xent
from bigdl_tpu_torch.ops import layer_norm as ln

# The suite runs in several processes at once: one intra-op thread each
# keeps these small tensors from crowding the timing-sensitive tests.
torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-5)   # as tests/test_pallas_ops.py
# gradients: as tests/test_pallas_ops.py holds the Pallas backward
GRAD_TOL = dict(rtol=1e-3, atol=1e-4)


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


def _bwd_case(case):
    """q, k, v, dO of a FLASH_CASES case (numpy f32) and its args."""
    B, H, T, S, D, causal, sm_scale, block = FLASH_CASES[case]
    q, k, v = _qkv(B, H, T, S, D, seed=len(case))
    g = np.random.RandomState(len(case) + 100).randn(
        B, H, T, D).astype(np.float32)
    scale = sm_scale if sm_scale is not None else 1 / math.sqrt(D)
    return q, k, v, g, causal, scale, block


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_bwd_plain_matches_pallas_interpret(case):
    q, k, v, g, causal, scale, block = _bwd_case(case)
    T, S, D = q.shape[2], k.shape[2], q.shape[3]
    bq = block or _pick_block(T, D)
    bk = block or _pick_block(S, D)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    o, lse = _flash_fwd(jq, jk, jv, causal, scale, bq, bk, True)
    want = _flash_bwd(jq, jk, jv, o, lse, jnp.asarray(g), causal, scale,
                      bq, bk, True)
    got = fa._flash_bwd_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(np.array(o)), torch.from_numpy(np.array(lse)),
        torch.from_numpy(g), causal, scale)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("case", ["one_block_causal", "causal_t_gt_s",
                                  "sm_scale"])
def test_flash_autograd_runs_the_plain_backward_on_cpu(case):
    q, k, v, g, causal, scale, _ = _bwd_case(case)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = fa.flash_attention(qt, kt, vt, causal=causal, sm_scale=scale)
    got = torch.autograd.grad(o, (qt, kt, vt), torch.from_numpy(g))
    o2, lse = fa._flash_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                              causal, scale)
    want = fa._flash_bwd_plain(
        *(torch.from_numpy(a) for a in (q, k, v)), o2, lse,
        torch.from_numpy(g), causal, scale)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # and the same gradients as the JAX custom_vjp over the dense oracle
    def jloss(q_, k_, v_):
        out = jax_flash(q_, k_, v_, causal=causal, sm_scale=scale)
        return jnp.sum(out * jnp.asarray(g))

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for a, b in zip(got, jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL)


def test_flash_bwd_fully_masked_rows_give_zero_gradients():
    # causal with T < S: keys past T are attended by no query; their dk
    # and dv must come out exactly zero
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 8, 24, 16, 7))
    g = torch.randn(1, 2, 8, 16, generator=torch.Generator().manual_seed(0))
    o, lse = fa._flash_plain(q, k, v, True, 0.25)
    dq, dk, dv = fa._flash_bwd_plain(q, k, v, o, lse, g, True, 0.25)
    assert torch.isfinite(dq).all()
    assert torch.equal(dk[:, :, 8:], torch.zeros_like(dk[:, :, 8:]))
    assert torch.equal(dv[:, :, 8:], torch.zeros_like(dv[:, :, 8:]))


def test_the_plain_backward_carries_f64_inputs_in_f64():
    """The f32 kernels' yardstick on the card: ``_flash_bwd_plain`` on f64
    copies of f32 inputs runs its math in f64 (the same math written out
    in f64 here, to f64 rounding) and returns f64 gradients within f32
    rounding of the f32 run's; f32 inputs keep f32."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 40, 40, 32, seed=9))
    g = torch.from_numpy(np.random.RandomState(10).randn(1, 2, 40, 32)
                         .astype(np.float32))
    o, lse = fa._flash_plain(q, k, v, True, 0.2)
    f32 = fa._flash_bwd_plain(q, k, v, o, lse, g, True, 0.2)
    f64 = fa._flash_bwd_plain(*(t.double() for t in (q, k, v, o, lse, g)),
                              True, 0.2)
    keep = fa._causal_keep(40, 40, "cpu")
    qd, kd, vd, od, gd = (t.double() for t in (q, k, v, o, g))
    p = torch.exp((qd @ kd.transpose(-1, -2) * 0.2).masked_fill(
        ~keep, float("-inf")) - lse.double().reshape(1, 2, 40, 1))
    ds = p * (gd @ vd.transpose(-1, -2) - (gd * od).sum(-1, keepdim=True))
    exact = (ds @ kd * 0.2, ds.transpose(-1, -2) @ qd * 0.2,
             p.transpose(-1, -2) @ gd)
    for a, b, e in zip(f32, f64, exact):
        assert a.dtype == torch.float32 and b.dtype == torch.float64
        torch.testing.assert_close(b, e, rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(a, b.float(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("D", [6, 8, 48, 96])
@pytest.mark.parametrize("causal", [True, False])
def test_padded_head_dim_leaves_attention_and_grads_unchanged(D, causal):
    """What the CUDA wrappers do for a head dim the kernels are not
    built for: zero-pad q, k, v and dO to the next built head dim, run
    at the true sm_scale, cut the outputs back.  In the plain versions
    this equals attention on the unpadded inputs."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 2, 40, 56, D, seed=D))
    g = torch.from_numpy(np.random.RandomState(D + 1).randn(
        2, 2, 40, D).astype(np.float32))
    scale = 1 / math.sqrt(D)
    Dp = fa._padded_head_dim(D)
    assert Dp == {6: 16, 8: 16, 48: 64, 96: 128}[D]
    qp, kp, vp, gp = (fa._pad_head_dim(t, Dp) for t in (q, k, v, g))
    assert qp.shape[-1] == Dp and not qp[..., D:].any()
    o, lse = fa._flash_plain(q, k, v, causal, scale)
    op, lsep = fa._flash_plain(qp, kp, vp, causal, scale)
    assert not op[..., D:].any()
    torch.testing.assert_close(fa._cut_head_dim(op, D), o, rtol=0, atol=1e-6)
    torch.testing.assert_close(lsep, lse, rtol=0, atol=1e-6)
    want = fa._flash_bwd_plain(q, k, v, o, lse, g, causal, scale)
    got = fa._flash_bwd_plain(qp, kp, vp, op, lsep, gp, causal, scale)
    for a, b in zip(got, want):
        torch.testing.assert_close(fa._cut_head_dim(a, D), b, rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("D", [160, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_wide_head_dim_plain_matches_pallas_interpret(D, causal):
    """What the kernels above head dim 128 must compute (the Hopper bodies
    at 192 and 256, the chunked kernels above 256): the plain forward and
    backward, taken at D as it is, against the Pallas kernels in
    interpret mode, which hand D straight to their (1, block, D)
    blocks."""
    q, k, v = _qkv(1, 2, 128, 128, D, seed=D)
    g = np.random.RandomState(D + 1).randn(1, 2, 128, D).astype(np.float32)
    scale = 1 / math.sqrt(D)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    o_want, lse_want = _flash_fwd(jq, jk, jv, causal, scale, 64, 64, True)
    want = _flash_bwd(jq, jk, jv, o_want, lse_want, jnp.asarray(g), causal,
                      scale, 64, 64, True)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    o, lse = fa._flash_plain(*t, causal, scale)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_want), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_want), **TOL)
    got = fa._flash_bwd_plain(*t, torch.from_numpy(np.array(o_want)),
                              torch.from_numpy(np.array(lse_want)),
                              torch.from_numpy(g), causal, scale)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL,
                                   err_msg=name)
    # both dtypes pad such a head dim to 192 or 256 for all three passes,
    # and take the chunked kernels only above 256
    Dp = fa._padded_head_dim(D)
    assert Dp == {160: 192, 256: 256}[D]
    assert not fa._wide(Dp) and fa._wide(D) == (D > 256)
    assert fa._padded_head_dim(D + 64) == (D + 64 if D > 192 else 256)
    assert fa._wide(fa._padded_head_dim(D + 64)) == (D > 192)


# --------------------------------------------------------------------------
# what the CUDA wrappers hand the kernels: their launches recorded on CPU
# tensors, not run
# --------------------------------------------------------------------------

def _record_launches(monkeypatch):
    """Record each attention launch (C entry name, arguments) instead of
    building and running it."""
    calls = []
    monkeypatch.setattr(fa, "_c_fn", lambda lib, name, argtypes: name)
    monkeypatch.setattr(fa, "_call", lambda name, fn, args, device:
                        calls.append((fn, args)))
    return calls


def _strides(args):
    """The (batch, head, row) strides a launch passed, per operand."""
    flat = list(next(a for a in args if not isinstance(a, (int, float))
                     and a is not None and hasattr(a, "_length_")))
    return [flat[i:i + 3] for i in range(0, len(flat), 3)]


def _head_strided(B, T, H, D, dtype, seed):
    """(B, H, T, D) views of (B, T, H, D) tensors: an attention layer's
    layout."""
    g = torch.Generator().manual_seed(seed)
    return torch.randn(B, T, H, D, generator=g).to(dtype).transpose(1, 2)


def test_head_strided_operands_reach_the_attention_kernels_in_place(
        monkeypatch):
    """bf16 q, k, v and dO in the (B, T, H, D).transpose(1, 2) layout
    reach K1, K2 and K3 as they stand: the same data pointers, their own
    strides (T H D, D, H D), no copy; O, dQ, dK and dV come out
    contiguous."""
    calls = _record_launches(monkeypatch)
    B, T, H, D = 2, 40, 4, 64
    q, k, v, d_o = (_head_strided(B, T, H, D, torch.bfloat16, s)
                    for s in range(4))
    copies = fa.OPERAND_COPIES.count
    o, lse = fa._flash_cuda(q, k, v, True, 0.125)
    grads = fa._flash_bwd_cuda(q, k, v, o, lse, d_o, True, 0.125)
    assert fa.OPERAND_COPIES.count == copies
    assert [c[0] for c in calls] == ["bigdl_flash_fwd", "bigdl_flash_bwd_dkv",
                                     "bigdl_flash_bwd_dq"]
    want = [T * H * D, D, H * D]
    fwd, dkv, dq = (c[1] for c in calls)
    assert fwd[:3] == [t.data_ptr() for t in (q, k, v)]
    assert _strides(fwd) == [want] * 3
    for args in (dkv, dq):
        assert args[:4] == [t.data_ptr() for t in (q, k, v, d_o)]
        assert _strides(args) == [want] * 4
    # H, the first head, the head count
    assert fwd[6:9] == [H, 0, B * H] and dkv[9:12] == [H, 0, B * H]
    for t in (o, *grads):
        assert t.shape == (B, H, T, D) and t.is_contiguous()


def test_attention_wrappers_copy_only_what_the_kernels_cannot_read(
        monkeypatch):
    """Through TMA (K1 in both dtypes) an operand is read in place unless
    its start is not 16-byte aligned, a stride is not a multiple of 16
    bytes, or its last dim is not unit-stride: those are copied,
    contiguous, and counted.  The f32 head-strided layout is read in
    place too."""
    calls = _record_launches(monkeypatch)
    bf16, f32 = torch.bfloat16, torch.float32
    B, H, T, D = 1, 2, 16, 64

    def wide(pad, start, dtype=bf16):   # columns start .. start + D - 1
        return torch.zeros(B, H, T, D + pad, dtype=dtype)[..., start:start + D]

    cases = [(wide(8, 0), False),                    # row pitch 72: read
             (wide(8, 1), True),                     # start misaligned
             (wide(4, 0), True),                     # row pitch 68 elements
             (torch.zeros(B, H, D, T, dtype=bf16).transpose(-1, -2), True),
             (_head_strided(B, T, H, D, f32, 0), False),  # f32: TMA too
             (torch.zeros(B, H, T, D, dtype=f32), False)]
    for q, copied in cases:
        k, v = (torch.zeros(B, H, T, D, dtype=q.dtype) for _ in range(2))
        calls.clear()
        copies = fa.OPERAND_COPIES.count
        fa._flash_cuda(q, k, v, False, 0.125)
        args = calls[0][1]
        assert (args[0] != q.data_ptr()) == copied
        assert fa.OPERAND_COPIES.count - copies == int(copied)
        if copied:
            assert _strides(args)[0] == [H * T * D, T * D, D]


def test_f32_dkv_reads_head_strided_operands_in_place(monkeypatch):
    """f32 K2 and K3 read q, k, v and dO through TMA, as bf16 does: the
    head-strided layout reaches ``bigdl_flash_bwd_dkv`` and
    ``bigdl_flash_bwd_dq`` as it stands (the same pointers, their own
    strides, no copy), with dtype code 0."""
    calls = _record_launches(monkeypatch)
    B, T, H, D = 2, 40, 4, 64
    q, k, v, d_o = (_head_strided(B, T, H, D, torch.float32, s)
                    for s in range(4))
    o, lse = torch.zeros(B, H, T, D), torch.zeros(B * H, 1, T)
    copies = fa.OPERAND_COPIES.count
    dq, dk, dv = fa._flash_bwd_cuda(q, k, v, o, lse, d_o, True, 0.125)
    assert fa.OPERAND_COPIES.count == copies
    (dkv_fn, dkv), (dq_fn, dq_args) = calls
    assert (dkv_fn, dq_fn) == ("bigdl_flash_bwd_dkv", "bigdl_flash_bwd_dq")
    for args in (dkv, dq_args):
        assert args[:4] == [t.data_ptr() for t in (q, k, v, d_o)]
        assert _strides(args) == [[T * H * D, D, H * D]] * 4
        # ..., D, dtype (0: f32), sm_scale, causal
        assert args[-4:] == [D, 0, 0.125, 1]
    for t in (dq, dk, dv):
        assert t.dtype == torch.float32 and t.is_contiguous()


@pytest.mark.parametrize("which", ["flash", "block_sparse"])
def test_f32_forward_reads_head_strided_operands_in_place(monkeypatch,
                                                          which):
    """f32 K1 (flash) and K6 (block-sparse) read q, k and v through TMA,
    as bf16 does: the head-strided layout reaches ``bigdl_flash_fwd`` and
    ``bigdl_bs_fwd`` as it stands (the same pointers, their own strides,
    no copy), with dtype code 0; O and LSE come out contiguous f32."""
    from bigdl_tpu_torch.ops import block_sparse as bs
    calls = _record_launches(monkeypatch)
    monkeypatch.setattr(bs, "_c_fn", lambda lib, name, argtypes: name)
    B, T, H, D = 2, 128, 4, 64
    q, k, v = (_head_strided(B, T, H, D, torch.float32, s) for s in range(3))
    copies = fa.OPERAND_COPIES.count
    if which == "flash":
        o, lse = fa._flash_cuda(q, k, v, True, 0.125)
        name = "bigdl_flash_fwd"
    else:
        mask = bs.sliding_window_mask(4, 4, 2, 1, True, 32, 32)
        o, lse = bs._bs_fwd_cuda(q, k, v, mask, True, 0.125)
        name = "bigdl_bs_fwd"
    assert fa.OPERAND_COPIES.count == copies
    (fn, args), = calls
    assert fn == name
    assert args[:3] == [t.data_ptr() for t in (q, k, v)]
    assert _strides(args) == [[T * H * D, D, H * D]] * 3
    # ..., D, dtype (0: f32), sm_scale, causal
    assert args[-4:] == [D, 0, 0.125, 1]
    assert o.shape == (B, H, T, D) and lse.shape == (B * H, 1, T)
    for t in (o, lse):
        assert t.dtype == torch.float32 and t.is_contiguous()


@pytest.mark.parametrize("D,dtype,fwd,bwd", [
    (160, torch.bfloat16, 192, 192), (200, torch.bfloat16, 256, 256),
    (256, torch.bfloat16, 256, 256), (160, torch.float32, 192, 192),
    (200, torch.float32, 256, 256), (256, torch.float32, 256, 256),
    (320, torch.float32, None, None), (320, torch.bfloat16, None, None),
    (300, torch.float32, None, None), (300, torch.bfloat16, None, None),
    (1000, torch.bfloat16, None, None)])
def test_wide_head_dims_route_by_dtype(monkeypatch, D, dtype, fwd, bwd):
    """The passes route by the same built head dims in both dtypes: head
    dims 129-256 are zero-padded to 192 or 256 and run the Hopper forward
    (K1), dK/dV (K2) and dQ (K3); above 256 the forward runs the chunked
    forward (``bigdl_flash_fwd`` at D zero-padded to a multiple of 64,
    counted under ``LAUNCHES_CHUNKED`` for its dtype), and dK/dV and dQ
    the chunked backward (``bigdl_flash_bwd_dkv`` and
    ``bigdl_flash_bwd_dq`` at the same padded D, counted under
    ``LAUNCHES_DKV_CHUNKED`` and ``LAUNCHES_DQ_CHUNKED`` for its dtype).
    ``fwd`` and ``bwd`` are the head dims the Hopper kernels run at
    (None: above the built ones).  The outputs are cut back to D.  An f32
    launch of each pass at 192 or 256 also counts under that pass's
    counter for the head dim."""
    calls = _record_launches(monkeypatch)
    q, k, v, d_o = (torch.zeros(1, 2, 16, D, dtype=dtype) for _ in range(4))
    counters = (fa.LAUNCHES_F32, fa.LAUNCHES_DKV_F32, fa.LAUNCHES_DQ_F32)
    per_dim = [{d: c.count for d, c in by.items()} for by in counters]
    chunked_counters = (fa.LAUNCHES_CHUNKED, fa.LAUNCHES_DKV_CHUNKED,
                        fa.LAUNCHES_DQ_CHUNKED)
    chunked = [{dt: c.count for dt, c in by.items()}
               for by in chunked_counters]
    o, lse = fa._flash_cuda(q, k, v, True, 0.1)
    grads = fa._flash_bwd_cuda(q, k, v, o, lse, d_o, True, 0.1)
    for by, before, at in zip(counters, per_dim, (fwd, bwd, bwd)):
        assert {d: c.count - before[d] for d, c in by.items()} == {
            d: int(dtype == torch.float32 and d == at) for d in before}
    for by, before in zip(chunked_counters, chunked):
        assert {dt: c.count - before[dt] for dt, c in by.items()} == {
            dt: int(dt == dtype and fwd is None) for dt in before}
    names = [c[0] for c in calls]
    assert names == ["bigdl_flash_fwd", "bigdl_flash_bwd_dkv",
                     "bigdl_flash_bwd_dq"]
    # every entry ends (..., D, dtype, sm_scale, causal)
    padded = -(-D // 64) * 64
    assert [c[1][-4:] for c in calls] == [
        [at or padded, fa._DTYPE_CODE[dtype], 0.1, 1]
        for at in (fwd, bwd, bwd)]
    for t in (o, *grads):
        assert t.shape == (1, 2, 16, D)


@pytest.mark.parametrize("D", [300, 320])
def test_bf16_chunked_backward_reads_head_strided_operands_in_place(
        monkeypatch, D):
    """bf16 q, k, v and dO in an attention layer's (B, T, H, D).transpose(1,
    2) layout above head dim 256: K2 and K3 launch the chunked backward
    once each (counted under the bf16 chunked counters) on the operands as
    they stand at D 320 (their own pointers and strides, no copy), and on
    the operands zero-padded to 320 at D 300 (the pad is the copy, not
    counted), at the padded head dim; dQ, dK and dV come back cut to D,
    contiguous."""
    calls = _record_launches(monkeypatch)
    B, T, H = 1, 24, 2
    q, k, v, d_o = (_head_strided(B, T, H, D, torch.bfloat16, s)
                    for s in range(4))
    o, lse = fa._flash_cuda(q, k, v, True, 0.1)
    calls.clear()
    before = [c[torch.bfloat16].count
              for c in (fa.LAUNCHES_DKV_CHUNKED, fa.LAUNCHES_DQ_CHUNKED)]
    copies = fa.OPERAND_COPIES.count
    grads = fa._flash_bwd_cuda(q, k, v, o, lse, d_o, True, 0.1)
    assert fa.OPERAND_COPIES.count == copies
    assert [c[torch.bfloat16].count - n for c, n in zip(
        (fa.LAUNCHES_DKV_CHUNKED, fa.LAUNCHES_DQ_CHUNKED), before)] == [1, 1]
    assert [c[0] for c in calls] == ["bigdl_flash_bwd_dkv",
                                     "bigdl_flash_bwd_dq"]
    for _, args in calls:
        if D == 320:
            assert args[:4] == [t.data_ptr() for t in (q, k, v, d_o)]
            assert _strides(args) == [[T * H * D, D, H * D]] * 4
        else:
            assert _strides(args) == [[H * T * 320, T * 320, 320]] * 4
        # ..., D, dtype (1: bf16), sm_scale, causal
        assert args[-4:] == [320, 1, 0.1, 1]
    for t in grads:
        assert t.shape == (B, H, T, D) and t.is_contiguous()


def test_a_head_dim_whose_chunks_outgrow_the_grid_raises(monkeypatch):
    """The chunked kernels launch one block per chunk of each head in the
    grid's x dimension: a head dim whose chunks, times the heads of a
    launch, pass ``MAX_GRID_X`` raises a ValueError naming it before any
    launch (here with the limit lowered to 7 blocks: D 512 takes 2 chunks
    a head, 8 blocks for 4 heads), in the forward and in the backward; a
    head dim that fits launches."""
    calls = _record_launches(monkeypatch)
    monkeypatch.setattr(fa, "MAX_GRID_X", 7)
    q, k, v, d_o = (torch.zeros(2, 2, 16, 512, dtype=torch.bfloat16)
                    for _ in range(4))
    with pytest.raises(ValueError, match="head dim 512 takes 2 chunks"):
        fa._flash_cuda(q, k, v, True, 0.1)
    lse = torch.zeros(4, 1, 16)
    with pytest.raises(ValueError, match="more than a grid's 7"):
        fa._flash_bwd_cuda(q, k, v, q, lse, d_o, True, 0.1)
    assert calls == []
    fa._flash_bwd_cuda(*(t[:, :1] for t in (q, k, v, q)), lse[:2],
                       d_o[:, :1], True, 0.1)
    assert [c[0] for c in calls] == ["bigdl_flash_bwd_dkv",
                                     "bigdl_flash_bwd_dq"]


@pytest.mark.parametrize("D,runs", [(160, 192), (200, 256), (256, 256)])
def test_bf16_dq_runs_k3_on_the_padded_operands(monkeypatch, D, runs):
    """bf16 dQ at head dims 129-256 launches K3 (``bigdl_flash_bwd_dq``)
    at 192 or 256 on the operands K2 gets: q, k, v and dO zero-padded to
    that head dim (the originals, in place, where no pad is needed), at the
    padded tensors' strides, with a dQ of the padded width that comes back
    cut to D."""
    calls = _record_launches(monkeypatch)
    B, H, T = 1, 2, 24
    q, k, v, d_o = (_head_strided(B, T, H, D, torch.bfloat16, s)
                    for s in range(4))
    o, lse = fa._flash_cuda(q, k, v, True, 0.1)
    calls.clear()
    dq, dk, dv = fa._flash_bwd_cuda(q, k, v, o, lse, d_o, True, 0.1)
    (dkv_fn, dkv), (dq_fn, dq_args) = calls
    assert (dkv_fn, dq_fn) == ("bigdl_flash_bwd_dkv", "bigdl_flash_bwd_dq")
    assert dq_args[:4] == dkv[:4]
    if D == runs:
        assert dq_args[:4] == [t.data_ptr() for t in (q, k, v, d_o)]
        assert _strides(dq_args) == [[T * H * D, D, H * D]] * 4
    else:
        assert _strides(dq_args) == [[H * T * runs, T * runs, runs]] * 4
    # H, the first head, the head count, T, S, D, dtype, sm_scale, causal
    assert dq_args[8:] == [H, 0, B * H, T, T, runs, 1, 0.1, 1]
    assert dq.shape == (B, H, T, D) and dq.is_contiguous()


def test_more_heads_than_a_grid_launch_from_their_first_head(monkeypatch):
    """Heads beyond one grid's limit launch in chunks: every chunk gets
    the tensors' own pointers, its first head and its head count (the
    kernels find a head from its index and the strides, so a chunk of a
    head-strided tensor is read where it lies)."""
    calls = _record_launches(monkeypatch)
    monkeypatch.setattr(fa, "MAX_HEADS", 3)
    q, k, v = (_head_strided(2, 8, 4, 16, torch.bfloat16, s)
               for s in range(3))
    fa._flash_cuda(q, k, v, True, 0.25)
    assert [c[1][:3] for c in calls] == [[q.data_ptr(), k.data_ptr(),
                                          v.data_ptr()]] * 3
    assert [c[1][7:9] for c in calls] == [[0, 3], [3, 3], [6, 2]]


@pytest.mark.parametrize("shape", [(4, 7, 64), (16, 1000)])
def test_layer_norm_grad_matches_jax_grad_of_pallas_interpret(shape):
    rng = np.random.RandomState(2)
    F = shape[-1]
    x = (rng.randn(*shape) * 2 + 0.5).astype(np.float32)
    gam = (1 + 0.1 * rng.randn(F)).astype(np.float32)
    bet = (0.1 * rng.randn(F)).astype(np.float32)
    w = rng.randn(*shape).astype(np.float32)

    def jloss(x_, g_, b_):
        return jnp.sum(jax_ln(x_, g_, b_, 1e-5, interpret=True)
                       * jnp.asarray(w))

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(gam), jnp.asarray(bet))
    xt, gt, bt = (torch.from_numpy(a).requires_grad_() for a in (x, gam, bet))
    y = ln.fused_layer_norm(xt, gt, bt, 1e-5)
    got = torch.autograd.grad(y, (xt, gt, bt), torch.from_numpy(w))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL)


def test_layer_norm_reads_rows_at_their_pitch():
    """K4's wrapper hands the kernel x in place with its row pitch where
    the rows are unit-stride and one pitch apart (a column slice, also
    under leading dims); a transposed x, or leading dims that share no
    pitch, are copied contiguous (``X_COPIES``)."""
    base = torch.randn(3, 4, 100)
    for x, pitch in ((base[0, :, 8:72], 100), (base[:, :, 8:72], 100),
                     (base[0], 100), (torch.randn(1, 64), 64),
                     (base[0, :, :64].t(), None),
                     (base[:, 1:, :64], None)):
        copies = ln.X_COPIES.count
        got, got_pitch = ln._rows(x)
        if pitch is None:
            assert ln.X_COPIES.count == copies + 1 and got.is_contiguous()
            assert got_pitch == x.shape[-1] and torch.equal(got, x)
        else:
            assert ln.X_COPIES.count == copies and got is x
            assert got_pitch == pitch


def test_layer_norm_grad_keeps_input_dtypes():
    x = torch.randn(5, 32).bfloat16().requires_grad_()
    gam = torch.ones(32, dtype=torch.bfloat16, requires_grad=True)
    bet = torch.zeros(32, dtype=torch.bfloat16, requires_grad=True)
    y = ln.fused_layer_norm(x, gam, bet)
    grads = torch.autograd.grad(y.float().sum(), (x, gam, bet))
    assert [d.dtype for d in grads] == [torch.bfloat16] * 3


def _xent_inputs(N, V, seed):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(N, V) * 3).astype(np.float32)
    t = rng.randint(0, V, size=N).astype(np.int32)
    g = rng.rand(N).astype(np.float32)
    return logits, t, g


@pytest.mark.parametrize("N,V", [(6, 11), (32, 1000)])
def test_softmax_xent_rows_matches_jax(N, V):
    logits, t, g = _xent_inputs(N, V, seed=N)
    want = jax_xent(jnp.asarray(logits), jnp.asarray(t))
    want_grad = jax.grad(lambda a: jnp.sum(
        jax_xent(a, jnp.asarray(t)) * jnp.asarray(g)))(jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_()
    rows = fused_xent.softmax_xent_rows(lt, torch.from_numpy(t))
    assert rows.dtype == torch.float32
    np.testing.assert_allclose(rows.detach().numpy(), np.asarray(want),
                               **TOL)
    (grad,) = torch.autograd.grad(rows, lt, torch.from_numpy(g))
    np.testing.assert_allclose(grad.numpy(), np.asarray(want_grad), **TOL)


def test_softmax_xent_rows_bf16_keeps_dtype_and_tracks_f32():
    logits, t, g = _xent_inputs(16, 300, seed=3)
    lb = torch.from_numpy(logits).bfloat16().requires_grad_()
    rows = fused_xent.softmax_xent_rows(lb, torch.from_numpy(t))
    assert rows.dtype == torch.float32
    (grad,) = torch.autograd.grad(rows, lb, torch.from_numpy(g))
    assert grad.dtype == torch.bfloat16
    # the same bf16 logits through the JAX op: f32 rows and a bf16
    # gradient that agree up to one bf16 rounding of each element
    jl = jnp.asarray(lb.detach().float().numpy()).astype(jnp.bfloat16)
    want = jax_xent(jl, jnp.asarray(t))
    want_grad = jax.grad(lambda a: jnp.sum(
        jax_xent(a, jnp.asarray(t)) * jnp.asarray(g)))(jl)
    np.testing.assert_allclose(rows.detach().numpy(), np.asarray(want),
                               **TOL)
    np.testing.assert_allclose(grad.float().numpy(),
                               np.asarray(want_grad.astype(jnp.float32)),
                               rtol=2 ** -7, atol=1e-6)
