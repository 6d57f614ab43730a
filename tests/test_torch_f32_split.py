"""The arithmetic of the f32 dK/dV kernel (K2 and K7 in f32) on the CPU.

The kernel forms every f32 product from bf16 products on the tensor
cores: each f32 operand a is split into bf16 pieces a1 = bf16(a), a2 =
bf16(a - a1), a3 = bf16(a - a1 - a2), and a product a . b is a sum of
bf16 products with f32 accumulation, small terms first: a1 b3 + a2 b2 +
a3 b1, a1 b2 + a2 b1, a1 b1 for the scores S^T = K . Q^T and dP^T = V .
dO^T (six), a2 b2 + a3 b1, a1 b2 + a2 b1, a1 b1 for dV = P^T . dO and dK
= dS^T . Q with dO and Q in two pieces (five) (``csrc/hopper_common.cuh``,
``split_tile`` and ``split_bf16x3``; ``csrc/attn_bwd_hopper.cuh``,
``dkv_f32_consume``).  ``_dkv_split`` below forms dK and dV that way from
seeded numpy inputs, and the results are held row by row, at the f32
limit the card holds the kernel to (1e-4), against the dK and dV that
``jax.vjp`` takes through the JAX package's ``flash_attention`` and
``block_sparse_attention`` with ``interpret=True``: the Pallas kernels
``_flash_bwd`` and ``_bs_bwd`` in interpret mode where the shapes reach
them, the JAX package's plain reference where they do not (T 130).

The kernel itself is held against the port's plain backward on the
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

# the f32 limit of the attention kernels, row by row (chip_smoke.py
# ROW_TOL["float32"])
ROW_TOL = 1e-4
LOG2E = 1.4426950408889634


def _row_rel_err(got, ref):
    """The worst row's ||got - ref|| / (||ref|| + 1e-4 * largest row
    norm) over the last dim, in f64."""
    d = torch.linalg.vector_norm(got.double() - ref.double(), dim=-1)
    r = torch.linalg.vector_norm(ref.double(), dim=-1)
    return (d / (r + 1e-4 * r.max())).max().item()


def _pieces(a, n):
    """The first n bf16 pieces of an f32 tensor, each held in f32: a1 =
    bf16(a), a2 = bf16(a - a1), a3 = bf16(a - a1 - a2), each rounded to
    nearest even (each difference is exact in f32)."""
    out, rest = [], a
    for _ in range(n):
        out.append(rest.to(torch.bfloat16).float())
        rest = rest - out[-1]
    return out


def _mm(a, b, na, nb):
    """a @ b of f32 tensors from bf16 products as the kernel forms it: the
    products a_i b_j of na pieces of a and nb of b with i + j below the
    larger count (0-based), added in f32 smallest terms first (i + j
    descending); each product of two bf16 values is exact in f32.  (3, 3)
    is six products, (3, 2) five, (2, 2) three, (1, 1) one."""
    A, B = _pieces(a, na), _pieces(b, nb)
    order = max(na, nb)
    acc = 0
    for level in range(order - 1, -1, -1):
        for i in range(na):
            if 0 <= level - i < nb:
                acc = acc + A[i] @ B[level - i]
    return acc


#: the kernel's products: (pieces of A, of B) for the scores and for dV, dK
KERNEL = dict(scores=(3, 3), acc=(3, 2))
#: the first design: three bf16 products of two pieces for every product
#: (it read 1.4e-4 on the card, PERF.md)
TWO_PIECES = dict(scores=(2, 2), acc=(2, 2))
#: three pieces a side for the two score products only
SCORES_ONLY = dict(scores=(3, 3), acc=(2, 2))
#: one bf16 product per f32 product
ONE_PIECE = dict(scores=(1, 1), acc=(1, 1))


def _dkv_split(q, k, v, o, lse, d_o, keep, scale, design=KERNEL):
    """dK and dV (B, H, S, D) as the f32 K2/K7 compute them from (q, k,
    v, O, LSE, dO): delta = rowsum(dO * O), S^T = K . Q^T, P^T = exp2(S^T
    scale log2 e - LSE log2 e), dP^T = V . dO^T, dS^T = P^T (dP^T -
    delta), P^T and dS^T 0 by select where ``keep`` ((T, S) bool) is
    false; dV = P^T . dO, dK = dS^T . Q times scale; every product by
    ``_mm`` with the pieces ``design`` gives."""
    B, H, T, _ = q.shape
    delta = (d_o * o).sum(dim=-1)[:, :, None, :]
    lse = lse.reshape(B, H, 1, T)
    st = _mm(k, q.transpose(-1, -2), *design["scores"])
    pt = torch.exp2(st * (scale * LOG2E) - lse * LOG2E)
    pt = torch.where(keep.T, pt, torch.zeros(()))
    dpt = _mm(v, d_o.transpose(-1, -2), *design["scores"])
    dst = torch.where(keep.T, pt * (dpt - delta), torch.zeros(()))
    return (_mm(dst, q, *design["acc"]) * scale,
            _mm(pt, d_o, *design["acc"]))


def _inputs(B, H, T, S, D, seed):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(B, H, n, D).astype(np.float32)
                 for n in (T, S, S, T))


def _jax_dkv(fn, q, k, v, g):
    """dK, dV of ``fn`` (q, k, v -> O) by ``jax.vjp`` at output
    gradient g, as torch tensors."""
    _, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    _, dk, dv = vjp(jnp.asarray(g))
    return torch.from_numpy(np.array(dk)), torch.from_numpy(np.array(dv))


# (B, H, T, S, D, causal): causal at D 128, ragged T != S non-causal
# (T 130 takes the JAX package's plain reference), head dim 16
FLASH_CASES = {
    "causal_D128": (1, 2, 256, 256, 128, True),
    "ragged_T130_S200_noncausal_D64": (1, 2, 130, 200, 64, False),
    "causal_D16": (2, 2, 128, 128, 16, True),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_split_products_match_the_jax_flash_backward(case):
    B, H, T, S, D, causal = FLASH_CASES[case]
    q, k, v, g = _inputs(B, H, T, S, D, seed=len(case))
    scale = 1 / math.sqrt(D)
    want = _jax_dkv(lambda a, b, c: jax_flash(a, b, c, causal=causal,
                                              sm_scale=scale,
                                              interpret=True), q, k, v, g)
    t = [torch.from_numpy(a) for a in (q, k, v, g)]
    o, lse = fa._flash_plain(*t[:3], causal, scale)
    keep = (fa._causal_keep(T, S, "cpu") if causal
            else torch.ones(T, S, dtype=torch.bool))
    got = _dkv_split(t[0], t[1], t[2], o, lse, t[3], keep, scale)
    for name, a, b in zip(("dk", "dv"), got, want):
        assert _row_rel_err(a, b) <= ROW_TOL, name


def _dead_block_mask():
    """A sliding window (2 blocks + 1 global, causal) at block 32 over T
    256, with k block 5 read by no query."""
    m = J.sliding_window_mask(8, 8, 2, 1, True, 32, 32).mask.copy()
    m[:, 5] = False
    return J.BlockMask(m, 32, 32)


def test_split_products_match_the_jax_block_sparse_backward():
    """Under a block mask with a dead key block: the split products'
    dK and dV against ``jax.vjp`` of ``block_sparse_attention`` through
    the Pallas kernels in interpret mode; the dead block's rows are 0
    on both sides."""
    mask = _dead_block_mask()
    q, k, v, g = _inputs(1, 2, 256, 256, 64, seed=11)
    scale = 1 / math.sqrt(64)
    want = _jax_dkv(lambda a, b, c: J.block_sparse_attention(
        a, b, c, mask, causal=True, sm_scale=scale, interpret=True),
        q, k, v, g)
    port = P.BlockMask(mask.mask, mask.block_q, mask.block_k)
    t = [torch.from_numpy(a) for a in (q, k, v, g)]
    o, lse = P._bs_attention_plain(*t[:3], port, True, scale)
    keep = P._elementwise_keep(port, True, "cpu")
    got = _dkv_split(t[0], t[1], t[2], o, lse, t[3], keep, scale)
    for name, a, b in zip(("dk", "dv"), got, want):
        assert _row_rel_err(a, b) <= ROW_TOL, name
        assert not a[:, :, 160:192].any() and not b[:, :, 160:192].any()


@pytest.mark.parametrize("case", ["causal_D128", "causal_D16"])
def test_the_kernels_pieces_leave_the_f32_limit_room(case):
    """The designs against the f32 plain backward: one bf16 product per
    f32 product misses 1e-4 by far; three products on two pieces a side
    (the first design, which read 1.4e-4 on the card against the 3e-5 to
    5e-5 it reads here) pass here but not by enough.  Most of their error
    is the score products' (dS^T = P^T (dP^T - delta) cancels): three
    pieces there alone cut it 2.5 times or more, and the kernel's five
    products for dV and dK (P^T and dS^T in three pieces) cut it further,
    to at least four times below the first design."""
    B, H, T, S, D, causal = FLASH_CASES[case]
    q, k, v, g = _inputs(B, H, T, S, D, seed=3)
    scale = 1 / math.sqrt(D)
    t = [torch.from_numpy(a) for a in (q, k, v, g)]
    o, lse = fa._flash_plain(*t[:3], causal, scale)
    keep = fa._causal_keep(T, S, "cpu")
    want = fa._flash_bwd_plain(*t[:3], o, lse, t[3], causal, scale)[1:]
    err = {}
    for name, design in (("kernel", KERNEL), ("scores", SCORES_ONLY),
                         ("two", TWO_PIECES), ("one", ONE_PIECE)):
        got = _dkv_split(t[0], t[1], t[2], o, lse, t[3], keep, scale, design)
        err[name] = max(_row_rel_err(a, b) for a, b in zip(got, want))
    assert err["one"] > 10 * ROW_TOL
    assert err["two"] <= ROW_TOL
    assert err["scores"] <= err["two"] / 2.5
    assert err["kernel"] < err["scores"] and err["kernel"] <= err["two"] / 4


def test_split_gives_back_the_f32_tensor():
    """Three pieces give a back exactly (for |a| above 2^-102); the first
    two alone within 2^-18 of the tensor's norm and 2^-17 of each
    element (the first leaves at most 2^-8 |a|, which the second rounds
    to 8 bits); a value bf16 holds exactly has zero second and third
    pieces."""
    a = torch.from_numpy(np.random.RandomState(5).randn(1 << 16)
                         .astype(np.float32))
    a1, a2, a3 = (p.double() for p in _pieces(a, 3))
    assert torch.equal(a1 + a2 + a3, a.double())
    r = a.double() - a1 - a2
    assert (torch.linalg.vector_norm(r)
            <= 2.0 ** -18 * torch.linalg.vector_norm(a.double()))
    assert (r.abs() <= 2.0 ** -17 * a.double().abs()).all()
    exact = a.to(torch.bfloat16).float()
    assert not any(p.any() for p in _pieces(exact, 3)[1:])
