"""The arithmetic of the bf16 attention backward above head dim 256 (K2/K3
and K7/K8 in bf16 at D > 256) on the CPU.

Above head dim 256 the bf16 dK/dV and dQ run the chunked backward of
``csrc/attn_bwd_hopper.cuh`` (``bwd_dkv_chunk_kernel`` with
``dkv_chunk_bf16_consume``, ``bwd_dq_chunk_kernel`` with
``dq_chunk_bf16_consume``): q, k, v and dO zero-padded to a multiple of 64
columns (``fa._bwd_head_dim``); a block owns 64 rows and one chunk of 256
output columns (``fa._fwd_chunks``), and for every streamed 64-row tile
forms the scores anew, summed over the 64-column panels of the operands
in one f32 accumulator (bf16 products, exact in f32); P and dS are
rounded to bf16 before dV += P^T . dO, dK += dS^T . Q and dQ += dS . K
(f32 accumulation, dQ from two warpgroups' key halves summed once), dK
and dQ times sm_scale, and each block writes only its chunk's own
columns.  ``_dkv_chunked`` and ``_dq_chunked`` below form dK, dV and dQ
that way from seeded numpy inputs, O and LSE from the port's plain bf16
forward, and hold them row by row at the bf16 limit the card holds the
kernels to (7e-3) against the gradients ``jax.vjp`` takes through the JAX
package's ``flash_attention`` and ``block_sparse_attention`` with
``interpret=True`` (the Pallas kernels in interpret mode, which take D as
it is).

The kernels themselves are held against the port's plain versions on the
card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu.ops import block_sparse as J
from bigdl_tpu.ops.flash_attention import flash_attention as jax_flash
from bigdl_tpu_torch.ops import block_sparse as P
from bigdl_tpu_torch.ops import flash_attention as fa

# The suite runs in several processes at once: one intra-op thread each
# keeps these small tensors from crowding the timing-sensitive tests.
torch.set_num_threads(1)

# the bf16 limit of the attention kernels, row by row (chip_smoke.py
# ROW_TOL["bfloat16"])
ROW_TOL = 7e-3
LOG2E = 1.4426950408889634
#: rows of a streamed tile, and the keys of a dQ warpgroup's half of one
TILE = 64
HALF = TILE // 2


def _scores(a, b):
    """a . b^T as the bf16 chunked kernels form it: the products of each
    64-column panel of the bf16 operands (exact in f32) added to one f32
    accumulator, panel by panel."""
    acc = torch.zeros(*a.shape[:-1], b.shape[-2])
    for c in range(0, a.shape[-1], fa.CHUNK_PANEL):
        acc = acc + a[..., c:c + fa.CHUNK_PANEL].float() @ \
            b[..., c:c + fa.CHUNK_PANEL].float().transpose(-1, -2)
    return acc


def _bf16(t):
    return t.to(torch.bfloat16).float()


def _dkv_chunk(q, k, v, o, lse, d_o, keep, scale, cols):
    """dK and dV of one chunk (its columns ``cols`` of Q and dO) as a block
    of the bf16 chunked dK/dV forms them: S^T = K . Q^T and dP^T = V . dO^T
    by ``_scores`` anew, P^T = exp(S^T scale - LSE) and dS^T = P^T (dP^T -
    delta) where ``keep``, 0 elsewhere, both rounded to bf16, then over the
    64-row query tiles in order dV += P^T . dO and dK += dS^T . Q in f32;
    dK times sm_scale."""
    B, H, T, _ = q.shape
    delta = (d_o.float() * o.float()).sum(dim=-1)[:, :, None, :]
    lse = lse.reshape(B, H, 1, T)
    zero = torch.zeros(())
    st = _scores(k, q)
    pt = torch.where(keep.T, torch.exp2(st * (scale * LOG2E) - lse * LOG2E),
                     zero)
    dpt = _scores(v, d_o)
    dst = _bf16(torch.where(keep.T, pt * (dpt - delta), zero))
    pt = _bf16(pt)
    qc, doc = q[..., cols].float(), d_o[..., cols].float()
    dk = torch.zeros(B, H, k.shape[2], qc.shape[-1])
    dv = torch.zeros_like(dk)
    for r0 in range(0, T, TILE):
        rows = slice(r0, r0 + TILE)
        dv = dv + pt[..., rows] @ doc[:, :, rows]
        dk = dk + dst[..., rows] @ qc[:, :, rows]
    return dk * scale, dv


def _dq_chunk(q, k, v, o, lse, d_o, keep, scale, cols):
    """dQ of one chunk (its columns ``cols`` of K) as a block of the bf16
    chunked dQ forms it: S = Q . K^T and dP = dO . V^T by ``_scores`` anew,
    P and dS = P (dP - delta) where ``keep``, 0 elsewhere, dS rounded to
    bf16, then over the 64-key tiles in order warpgroup w adding dS . K
    over keys 32 w .. 32 w + 31 of each into its own f32 sum; the two sums
    meet once, at the end; times sm_scale."""
    B, H, T, _ = q.shape
    S = k.shape[2]
    delta = (d_o.float() * o.float()).sum(dim=-1, keepdim=True)
    lse = lse.reshape(B, H, T, 1)
    zero = torch.zeros(())
    s = _scores(q, k)
    p = torch.where(keep, torch.exp2(s * (scale * LOG2E) - lse * LOG2E),
                    zero)
    dp = _scores(d_o, v)
    ds = _bf16(torch.where(keep, p * (dp - delta), zero))
    kc = k[..., cols].float()
    acc = [torch.zeros(B, H, T, kc.shape[-1]) for _ in range(2)]
    for k0 in range(0, S, TILE):
        for w in range(2):
            keys = slice(k0 + HALF * w, min(S, k0 + HALF * (w + 1)))
            if keys.start < S:
                acc[w] = acc[w] + ds[..., keys] @ kc[:, :, keys]
    return (acc[0] + acc[1]) * scale


def _chunked(chunk_fn, outs, q, k, v, o, lse, d_o, keep, scale):
    """The outputs of ``chunk_fn`` (``_dkv_chunk``: dK, dV; ``_dq_chunk``:
    dQ) as the bf16 chunked backward forms them: q, k, v, O and dO
    zero-padded to ``fa._bwd_head_dim``; for each chunk of the columns
    (``fa._fwd_chunks``) a block of its own forms the scores anew and the
    products over the chunk's 256 columns, and writes its own columns.
    Cut back to D, in bf16."""
    D = q.shape[-1]
    Dp = fa._bwd_head_dim(D)
    padded = [fa._pad_head_dim(t, Dp) for t in (q, k, v, o)]
    got = [torch.zeros(*t.shape[:-1], Dp) for t in outs]
    for col0, lo, hi in fa._fwd_chunks(Dp):
        part = chunk_fn(*padded, lse, fa._pad_head_dim(d_o, Dp), keep, scale,
                        slice(col0, col0 + fa.CHUNK_COLS))
        for g, c in zip(got, part if isinstance(part, tuple) else (part,)):
            g[..., lo:hi] = c[..., lo - col0:hi - col0]
    return [g[..., :D].to(torch.bfloat16) for g in got]


def _chunked_backward(q, k, v, d_o, keep, scale):
    """dQ, dK and dV of the bf16 slice above head dim 256: O and LSE from
    the port's plain bf16 forward under ``keep``, then the chunked dQ
    and dK/dV on them."""
    o, lse = fa._attn_plain(q, k, v, keep, scale)
    dq, = _chunked(_dq_chunk, (q,), q, k, v, o, lse, d_o, keep, scale)
    dk, dv = _chunked(_dkv_chunk, (k, v), q, k, v, o, lse, d_o, keep, scale)
    return dq, dk, dv


def _inputs(B, H, T, S, D, seed):
    """q, k, v and dO (B, H, rows, D) from a seeded numpy generator, in
    bf16 (numpy: f32 holding the bf16 values; torch: bf16)."""
    rng = np.random.RandomState(seed)
    out = [torch.from_numpy(rng.randn(B, H, n, D).astype(np.float32))
           .to(torch.bfloat16) for n in (T, S, S, T)]
    return [t.float().numpy() for t in out], out


def _jax_grads(fn, q, k, v, g):
    """dQ, dK, dV of ``fn`` (q, k, v -> O) by ``jax.vjp`` at output
    gradient g, all in bf16, as f32 torch tensors."""
    args = [jnp.asarray(a, dtype=jnp.bfloat16) for a in (q, k, v)]
    _, vjp = jax.vjp(fn, *args)
    grads = vjp(jnp.asarray(g, dtype=jnp.bfloat16))
    return tuple(torch.from_numpy(np.asarray(a, dtype=np.float32))
                 for a in grads)


def _norm(t):
    return torch.linalg.vector_norm(t.double(), dim=-1)


def _row_err(got, ref, scale):
    """The worst row's ||got - ref|| / (||ref|| + 1e-4 scale), in f64 (one
    scale for dQ, dK and dV, as chip_smoke.py takes it)."""
    return (_norm(got.double() - ref.double())
            / (_norm(ref) + 1e-4 * scale)).max().item()


def _dq_err(got, ref, keep, k, v, d_o, sm_scale, scale):
    """dQ's ``_row_err`` over the query rows with other than one live key,
    and over a row with one live key j, where dQ is 0 in exact arithmetic,
    ||got - ref|| against its terms' size sm_scale ||dO_i|| ||v_j|| ||k_j||
    (chip_smoke.py, ``dq_row_err``): the worse."""
    one = keep.sum(dim=-1) == 1
    many = ~one
    err = _row_err(got[..., many, :], ref[..., many, :], scale) \
        if many.any() else 0.0
    if one.any():
        i = torch.nonzero(one).flatten()
        j = keep[i].int().argmax(dim=-1)
        size = sm_scale * _norm(d_o[..., i, :]) * _norm(v[..., j, :]) * \
            _norm(k[..., j, :])
        err = max(err, (_norm(got[..., i, :].double() - ref[..., i, :])
                        / size).max().item())
    return err


def _check(got, want, keep, k, v, d_o, sm_scale):
    """dQ, dK and dV against ``want`` row by row at ``ROW_TOL``, one scale
    for the three."""
    assert [a.shape for a in got] == [a.shape for a in want]
    scale = max(_norm(w).max().item() for w in want)
    assert _dq_err(got[0], want[0], keep, k, v, d_o, sm_scale,
                   scale) <= ROW_TOL
    for name, a, b in zip(("dk", "dv"), got[1:], want[1:]):
        assert _row_err(a, b, scale) <= ROW_TOL, name


# (B, H, T, S, D): causal, T 128, which the Pallas kernels take in
# interpret mode; 320 two chunks, the second reaching back into the first,
# 300 padded to 320
FLASH_CASES = {"causal_T128_D320": (1, 2, 128, 128, 320),
               "causal_T128_D300": (1, 2, 128, 128, 300)}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_bf16_chunked_backward_matches_the_jax_flash_backward(case):
    """The bf16 chunked dK/dV and dQ (scores summed over 64-column panels,
    every chunk forming them anew, P and dS rounded to bf16, each chunk
    writing its own columns) against the gradients ``jax.vjp`` takes in
    bf16 through the JAX flash attention (the Pallas kernels in interpret
    mode), row by row at the bf16 limit."""
    B, H, T, S, D = FLASH_CASES[case]
    (q, k, v, g), t = _inputs(B, H, T, S, D, seed=13 * len(case))
    scale = 1 / math.sqrt(D)
    want = _jax_grads(lambda a, b, c: jax_flash(a, b, c, causal=True,
                                                sm_scale=scale,
                                                interpret=True), q, k, v, g)
    keep = fa._causal_keep(T, S, "cpu")
    got = _chunked_backward(*t, keep, scale)
    _check([a.float() for a in got], want, keep, *t[1:], scale)


@pytest.mark.parametrize("D", [300, 320])
def test_bf16_chunked_backward_matches_the_jax_block_sparse_backward(D):
    """Under a block mask with a dead key block, a dead query block, a
    query row whose one live key is its own and partly live 64-row tiles
    (block 32): the bf16 chunked dK/dV and dQ against ``jax.vjp`` of
    ``block_sparse_attention`` in bf16 through the Pallas kernels in
    interpret mode, row by row at the bf16 limit; the dead blocks' rows
    are 0 on both sides."""
    m = J.sliding_window_mask(4, 4, 2, 1, True, 32, 32).mask.copy()
    m[:, 2] = False     # k block 2: read by no query
    m[3, :] = False     # q block 3: reads nothing
    m[1, 0] = False     # q block 1: its own block alone, so row 32 has one key
    mask = J.BlockMask(m, 32, 32)
    (q, k, v, g), t = _inputs(1, 2, 128, 128, D, seed=D)
    scale = 1 / math.sqrt(D)
    want = _jax_grads(lambda a, b, c: J.block_sparse_attention(
        a, b, c, mask, causal=True, sm_scale=scale, interpret=True),
        q, k, v, g)
    keep = P._elementwise_keep(P.BlockMask(m, 32, 32), True, "cpu")
    assert keep[32].sum() == 1
    got = [a.float() for a in _chunked_backward(*t, keep, scale)]
    _check(got, want, keep, *t[1:], scale)
    assert not got[0][:, :, 96:].any() and not want[0][:, :, 96:].any()
    for a, b in zip(got[1:], want[1:]):
        assert not a[:, :, 64:96].any() and not b[:, :, 64:96].any()


def test_bf16_chunked_emulation_is_the_plain_backward_up_to_rounding():
    """The emulation's dK, dV and dQ against the port's plain bf16 backward
    (``_flash_bwd_plain``, what the card holds the kernels to) at D 320,
    causal, T 130 (a ragged last tile) and non-causal T 65, S 130, row by
    row at the bf16 limit: the panel sums, the chunks and the 32-key
    halves change only the order of f32 sums."""
    for T, S, causal in ((130, 130, True), (65, 130, False)):
        _, t = _inputs(1, 2, T, S, 320, seed=T)
        scale = 1 / math.sqrt(320)
        keep = fa._causal_keep(T, S, "cpu") if causal \
            else torch.ones(T, S, dtype=torch.bool)
        o, lse = fa._flash_plain(*t[:3], causal, scale)
        want = [a.float() for a in fa._flash_bwd_plain(*t[:3], o, lse, t[3],
                                                       causal, scale)]
        got = [a.float() for a in _chunked_backward(*t, keep, scale)]
        _check(got, want, keep, *t[1:], scale)
