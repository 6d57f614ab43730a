"""The arithmetic of the f32 forward (K1 and K6 in f32), dK/dV (K2 and
K7 in f32), dQ (K3 and K8 in f32), 3x3 conv (K5 in f32, forward and
dX) and block-sparse matmul (K9 in f32, forward and dX) kernels on the
CPU.

The kernels form every f32 product from bf16 products on the tensor
cores: each f32 operand a is split into bf16 pieces a1 = bf16(a), a2 =
bf16(a - a1), a3 = bf16(a - a1 - a2), and a product a . b is a sum of
bf16 products with f32 accumulation, small terms first: a1 b3 + a2 b2 +
a3 b1, a1 b2 + a2 b1, a1 b1 for the scores S = Q . K^T, S^T = K . Q^T
and dP^T = V . dO^T and for O += P . V (six), a2 b2 + a3 b1, a1 b2 + a2
b1, a1 b1 for dV = P^T . dO and dK = dS^T . Q with dO and Q in two
pieces (five), six again for dQ's S, dP and dS . K
(``csrc/hopper_common.cuh``, ``split_tile`` and ``split_bf16x3``;
``csrc/attn_fwd_hopper.cuh``, ``fwd_f32_consume``;
``csrc/attn_bwd_hopper.cuh``, ``dkv_f32_consume`` and
``dq_f32_consume``; ``csrc/conv3x3.cu``, ``conv3x3_kernel_split``: six
for each tap's product of the shifted pixels and the weights;
``csrc/block_sparse.cu``, ``bs_mm_kernel_split``: six for each step of
x's columns against W's live block, a fresh partial a step, ``_mm_split``
below, with wgmma's truncation modelled).
``_fwd_split``, ``_dkv_split``, ``_dq_split`` and ``_conv_split`` below
form O and LSE, dK and dV, dQ, and the conv's output that way from
seeded numpy inputs; ``_fwd_wide_split``, ``_dkv_wide_split`` and
``_dq_wide_split`` form O and LSE, dK and dV, and dQ as the f32 kernels
do at D 192 and 256 (``WIDE`` in ``fwd_f32_consume``,
``dkv_f32_consume`` and ``dq_f32_consume``: 32-row streamed tiles, the
block's own rows split into registers per 32-column panel, a fresh
partial of each score per panel), with wgmma's truncation toward zero
modelled, k16 step by step; ``_fwd_chunked_split`` forms O and LSE as
the f32 forward above D 256 does (``attn_fwd_chunk_kernel``: D padded to
a multiple of 64, O in chunks of 256 columns, each chunk forming S anew
as at D 256), ``_dkv_chunked_split`` and ``_dq_chunked_split`` dK, dV
and dQ as the f32 backward above D 256 does (``bwd_dkv_chunk_kernel``,
``bwd_dq_chunk_kernel``: the same padding and chunks, the scores summed
over the panels as at D 256), and the chunks' column plans are checked
for D 257-1024.
The results are held row by row, at the f32 limit the card holds the
kernels to (1e-4; LSE 1e-3; the wide forward, K5 and K9 at a third of
it), against the JAX package's ``flash_attention``,
``block_sparse_attention``, ``conv3x3_s1_same`` and
``block_sparse_matmul`` with ``interpret=True`` (the forward's O and LSE or
y, and the gradients that ``jax.vjp`` takes): the Pallas kernels in
interpret mode where the shapes reach them, the JAX package's plain
reference where they do not (T 130).

The kernels themselves are held against the port's plain versions on
the card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu.ops import block_sparse as J
from bigdl_tpu.ops.conv3x3_pallas import conv3x3_s1_same as jconv3x3
from bigdl_tpu.ops.flash_attention import _attention_reference, _flash_fwd
from bigdl_tpu.ops.flash_attention import flash_attention as jax_flash
from bigdl_tpu_torch.ops import block_sparse as P
from bigdl_tpu_torch.ops import conv3x3
from bigdl_tpu_torch.ops import flash_attention as fa

# The suite runs in several processes at once: one intra-op thread each
# keeps these small tensors from crowding the timing-sensitive tests.
torch.set_num_threads(1)

# the f32 limit of the attention kernels, row by row (chip_smoke.py
# ROW_TOL["float32"])
ROW_TOL = 1e-4
LSE_TOL = 1e-3
LOG2E = 1.4426950408889634
LN2 = math.log(2)
KEY_TILE = 64   # the key rows of a tile the f32 forward sweeps


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


#: the dK/dV kernel's products: (pieces of A, of B) for the scores and for
#: dV, dK
KERNEL = dict(scores=(3, 3), acc=(3, 2))
#: the forward kernel's: three pieces a side for S and for P . V
FORWARD = dict(scores=(3, 3), acc=(3, 3))
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


#: the dQ kernel's: three pieces a side for S, dP and dQ (six products
#: each)
DQ = dict(scores=(3, 3), acc=(3, 3))


def _dq_split(q, k, v, o, lse, d_o, keep, scale, design=DQ):
    """dQ (B, H, T, D) as the f32 K3/K8 compute it from (q, k, v, O, LSE,
    dO): delta = rowsum(dO * O), S = Q . K^T, P = exp2(S scale log2 e -
    LSE log2 e), dP = dO . V^T, dS = P (dP - delta), P and dS 0 by select
    where ``keep`` ((T, S) bool) is false, dQ = dS . K times scale; every
    product by ``_mm`` with the pieces ``design`` gives."""
    B, H, T, _ = q.shape
    delta = (d_o * o).sum(dim=-1, keepdim=True)
    lse = lse.reshape(B, H, T, 1)
    s = _mm(q, k.transpose(-1, -2), *design["scores"])
    p = torch.exp2(s * (scale * LOG2E) - lse * LOG2E)
    p = torch.where(keep, p, torch.zeros(()))
    dp = _mm(d_o, v.transpose(-1, -2), *design["scores"])
    ds = torch.where(keep, p * (dp - delta), torch.zeros(()))
    return _mm(ds, k, *design["acc"]) * scale


def _fwd_split(q, k, v, keep, scale, design=FORWARD):
    """O (B, H, T, D) and LSE (B * H, 1, T) as the f32 K1/K6 compute them:
    over 64-key tiles, S = Q . K^T, scaled to base 2 (scale log2 e) and
    masked to -inf where ``keep`` ((T, S) bool) is false, the running max
    m, the factor alpha = exp2(m_old - m) that rescales the running sum l
    and the accumulator, P = exp2(S - m), l summed from the unrounded P,
    O += P . V; O = acc / max(l, 1e-30) and LSE = (m + log2 l) ln 2, 1e30
    where l is 0; every product by ``_mm`` with the pieces ``design``
    gives."""
    B, H, T, D = q.shape
    m = torch.full((B, H, T, 1), -math.inf)
    l = torch.zeros(B, H, T, 1)
    acc = torch.zeros(B, H, T, D)
    zero = torch.zeros(())
    for k0 in range(0, k.shape[2], KEY_TILE):
        kt, vt = (t[:, :, k0:k0 + KEY_TILE] for t in (k, v))
        s = _mm(q, kt.transpose(-1, -2), *design["scores"]) * (scale * LOG2E)
        s = s.masked_fill(~keep[:, k0:k0 + KEY_TILE], -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        m_safe = torch.where(m_new == -math.inf, zero, m_new)
        alpha = torch.where(m == -math.inf, zero, torch.exp2(m - m_safe))
        p = torch.exp2(s - m_safe)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + _mm(p, vt, *design["acc"])
        m = m_new
    lse = torch.where(l > 0, (m + torch.log2(l.clamp_min(1e-30))) * LN2,
                      torch.full_like(l, 1e30))
    return acc / l.clamp_min(1e-30), lse.reshape(B * H, 1, T)


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


def _jax_grads(fn, q, k, v, g):
    """dQ, dK, dV of ``fn`` (q, k, v -> O) by ``jax.vjp`` at output
    gradient g, as torch tensors."""
    _, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return tuple(torch.from_numpy(np.array(a)) for a in vjp(jnp.asarray(g)))


def _scaled_row_err(got, ref, scale):
    """``_row_rel_err`` with ``scale`` in place of ref's largest row norm
    (one scale for dQ, dK and dV, as chip_smoke.py takes it: a row whose
    exact value is 0 reads against it)."""
    d = torch.linalg.vector_norm(got.double() - ref.double(), dim=-1)
    r = torch.linalg.vector_norm(ref.double(), dim=-1)
    return (d / (r + 1e-4 * scale)).max().item()


def _one_key_err(got, ref, keep, k, v, d_o, sm_scale):
    """The worst ||got_i - ref_i|| / (sm_scale ||dO_i|| ||v_j|| ||k_j||)
    over the query rows i with one live key j under ``keep`` ((T, S)
    bool), 0 where there is none: there dQ = P (dP - delta) k_j sm_scale
    is 0 in exact arithmetic (delta = dO . O and O = v_j), each side holds
    only the rounding of its dP - delta, and the row reads against the
    size of its terms before they cancel (chip_smoke.py,
    ``dq_row_err``)."""
    one = keep.sum(dim=-1) == 1
    if not one.any():
        return 0.0
    i = torch.nonzero(one).flatten()
    j = keep[i].int().argmax(dim=-1)

    def norm(t):
        return torch.linalg.vector_norm(t.double(), dim=-1)

    size = sm_scale * norm(d_o[..., i, :]) * norm(v[..., j, :]) * \
        norm(k[..., j, :])
    return (norm(got[..., i, :] - ref[..., i, :]) / size).max().item()


def _dq_err(got, ref, keep, k, v, d_o, sm_scale, scale):
    """dQ's ``_scaled_row_err`` at ``scale`` over the rows with other than
    one live key, and ``_one_key_err`` over the rest: the worse."""
    many = keep.sum(dim=-1) != 1
    err = _scaled_row_err(got[..., many, :], ref[..., many, :], scale) \
        if many.any() else 0.0
    return max(err, _one_key_err(got, ref, keep, k, v, d_o, sm_scale))


def _check_dq(got, want, keep, k, v, d_o, sm_scale, scale):
    """dQ from the split products against the JAX package's ``want`` row
    by row at ROW_TOL (``_dq_err``); JAX's own rows with one live key
    hold only rounding against their terms' size."""
    assert _dq_err(got, want, keep, k, v, d_o, sm_scale, scale) <= ROW_TOL
    assert _one_key_err(want, torch.zeros_like(want), keep, k, v, d_o,
                        sm_scale) <= ROW_TOL


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_split_dq_matches_the_jax_flash_backward(case):
    """The f32 dQ's split products (six a product, three pieces a side)
    against the dQ that ``jax.vjp`` takes through the JAX flash attention
    (the Pallas kernels in interpret mode; the plain reference at T 130),
    row by row at the f32 limit, one scale for dQ, dK and dV."""
    B, H, T, S, D, causal = FLASH_CASES[case]
    q, k, v, g = _inputs(B, H, T, S, D, seed=3 * len(case))
    scale = 1 / math.sqrt(D)
    want = _jax_grads(lambda a, b, c: jax_flash(a, b, c, causal=causal,
                                                sm_scale=scale,
                                                interpret=True), q, k, v, g)
    t = [torch.from_numpy(a) for a in (q, k, v, g)]
    o, lse = fa._flash_plain(*t[:3], causal, scale)
    keep = (fa._causal_keep(T, S, "cpu") if causal
            else torch.ones(T, S, dtype=torch.bool))
    got = _dq_split(t[0], t[1], t[2], o, lse, t[3], keep, scale)
    largest = max(torch.linalg.vector_norm(w, dim=-1).max().item()
                  for w in want)
    _check_dq(got, want[0], keep, t[1], t[2], t[3], scale, largest)


def test_split_dq_matches_the_jax_block_sparse_backward():
    """Under a block mask with a dead key block, a dead query block and a
    query row whose one live key is its own: the split products' dQ
    against ``jax.vjp`` of ``block_sparse_attention`` through the Pallas
    kernels in interpret mode; the dead block's rows are 0 on both
    sides."""
    m = J.sliding_window_mask(8, 8, 2, 1, True, 32, 32).mask.copy()
    m[:, 5] = False     # k block 5: read by no query
    m[6, :] = False     # q block 6: reads nothing
    m[4, :4] = False    # q block 4: its own block alone, so row 128 has one key
    mask = J.BlockMask(m, 32, 32)
    q, k, v, g = _inputs(1, 2, 256, 256, 64, seed=23)
    scale = 1 / math.sqrt(64)
    want = _jax_grads(lambda a, b, c: J.block_sparse_attention(
        a, b, c, mask, causal=True, sm_scale=scale, interpret=True),
        q, k, v, g)
    port = P.BlockMask(mask.mask, mask.block_q, mask.block_k)
    t = [torch.from_numpy(a) for a in (q, k, v, g)]
    o, lse = P._bs_attention_plain(*t[:3], port, True, scale)
    keep = P._elementwise_keep(port, True, "cpu")
    got = _dq_split(t[0], t[1], t[2], o, lse, t[3], keep, scale)
    one = keep.sum(dim=1) == 1
    assert one[0] and one[128] and int(one.sum()) == 2
    largest = max(torch.linalg.vector_norm(w, dim=-1).max().item()
                  for w in want)
    _check_dq(got, want[0], keep, t[1], t[2], t[3], scale, largest)
    assert not got[:, :, 192:224].any() and not want[0][:, :, 192:224].any()


@pytest.mark.parametrize("case", ["causal_D128", "causal_D16"])
def test_the_dq_pieces_leave_the_f32_limit_room(case):
    """The dQ designs against the f32 plain backward (one scale for dQ,
    dK and dV): one bf16 product per f32 product misses 1e-4 by far;
    three products on two pieces a side pass within the limit at D 128
    only; the kernel's six products on three pieces a side read a
    twentieth of the limit or less (the card's error tail ran about 3x
    the emulation's for dK/dV), below five (K in two pieces) and below
    three pieces for the scores alone."""
    B, H, T, S, D, causal = FLASH_CASES[case]
    q, k, v, g = _inputs(B, H, T, S, D, seed=3)
    scale = 1 / math.sqrt(D)
    t = [torch.from_numpy(a) for a in (q, k, v, g)]
    o, lse = fa._flash_plain(*t[:3], causal, scale)
    keep = fa._causal_keep(T, S, "cpu")
    want = fa._flash_bwd_plain(*t[:3], o, lse, t[3], causal, scale)
    largest = max(torch.linalg.vector_norm(w, dim=-1).max().item()
                  for w in want)
    err = {}
    for name, design in (("kernel", DQ), ("five", KERNEL),
                         ("scores", SCORES_ONLY), ("two", TWO_PIECES),
                         ("one", ONE_PIECE)):
        got = _dq_split(t[0], t[1], t[2], o, lse, t[3], keep, scale, design)
        err[name] = _dq_err(got, want[0], keep, t[1], t[2], t[3], scale,
                            largest)
    assert err["one"] > 10 * ROW_TOL
    assert err["kernel"] <= ROW_TOL / 20
    assert err["kernel"] < err["five"] < err["scores"] < err["two"]
    assert err["two"] >= 5 * err["kernel"]


def test_the_dq_keeps_a_key_shift_at_rounding_level():
    """A common shift b of every key row adds q . b to each score of a
    row, which the softmax ignores, and (sum_j dS_ij) b to dQ, which is 0
    in exact arithmetic: dQ under the shift equals dQ without it.  The
    plain f32 pipeline moves it by rounding only; the kernel's six
    products (three pieces of K) stay within twice that, while K in two
    pieces (five products) or two pieces of dS and K (three) leave K's
    rounding, 2^-17 of the shifted rows, in dQ: eight times the plain
    pipeline's or more.  The shape is the f32 training test's attention
    on the card: B 3, 4 heads of 16, T 20, causal."""
    rng = np.random.RandomState(0)
    q, k, v, g = (torch.from_numpy(rng.randn(3, 4, 20, 16)
                                   .astype(np.float32)) for _ in range(4))
    b = torch.from_numpy(np.random.RandomState(1).randn(1, 4, 1, 16)
                         .astype(np.float32))
    scale = 1 / math.sqrt(16)
    keep = fa._causal_keep(20, 20, "cpu")
    o, lse = fa._flash_plain(q, k, v, True, scale)
    exact = fa._flash_bwd_plain(q, k, v, o, lse, g, True, scale)[0]
    o, lse = fa._flash_plain(q, k + b, v, True, scale)
    plain = fa._flash_bwd_plain(q, k + b, v, o, lse, g, True, scale)[0]
    noise = (plain - exact).norm().item()
    moved = {}
    for name, acc in (("kernel", (3, 3)), ("five", (3, 2)),
                      ("three", (2, 2))):
        got = _dq_split(q, k + b, v, o, lse, g, keep, scale,
                        dict(scores=(3, 3), acc=acc))
        moved[name] = (got - exact).norm().item()
    assert moved["kernel"] <= 2 * noise
    assert min(moved["five"], moved["three"]) > 8 * noise


def _lse_ref(q, k, keep, scale):
    """The row log-sum-exp of the masked scores in f64 (1e30 for a row
    with no kept key), (B * H, 1, T): the reference where the JAX
    package's Pallas forward is not reached."""
    s = np.einsum("bhtd,bhsd->bhts", q.astype(np.float64),
                  k.astype(np.float64)) * scale
    s = np.where(keep, s, -np.inf)
    m = s.max(axis=-1, keepdims=True)
    live = np.isfinite(m)
    m = np.where(live, m, 0.0)
    lse = np.where(live, m + np.log(np.exp(s - m).sum(-1, keepdims=True)),
                   1e30)
    B, H, T, _ = q.shape
    return torch.from_numpy(lse.reshape(B * H, 1, T))


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_split_forward_matches_the_jax_flash_forward(case):
    """The split products' O and LSE against the JAX package's flash
    forward: ``_flash_fwd`` (the Pallas kernel in interpret mode) where
    the shapes reach it, its plain reference (O; LSE in f64) at T 130."""
    B, H, T, S, D, causal = FLASH_CASES[case]
    q, k, v, _ = _inputs(B, H, T, S, D, seed=2 * len(case))
    scale = 1 / math.sqrt(D)
    keep = (fa._causal_keep(T, S, "cpu") if causal
            else torch.ones(T, S, dtype=torch.bool))
    j = [jnp.asarray(a) for a in (q, k, v)]
    if T % 128 == 0 and S % 128 == 0:
        o_want, lse_want = _flash_fwd(*j, causal, scale, 128, 128, True)
        lse_want = torch.from_numpy(np.array(lse_want))
    else:
        o_want = _attention_reference(*j, causal, scale)
        lse_want = _lse_ref(q, k, keep.numpy(), scale)
    o, lse = _fwd_split(*(torch.from_numpy(a) for a in (q, k, v)), keep,
                        scale)
    assert _row_rel_err(o, torch.from_numpy(np.array(o_want))) <= ROW_TOL
    assert (lse.double() - lse_want.double()).abs().max().item() <= LSE_TOL


def test_split_forward_matches_the_jax_block_sparse_forward():
    """Under a block mask with a dead query block: the split products' O
    and LSE against ``_bs_fwd`` (the Pallas kernel in interpret mode);
    the dead block's rows are O = 0 and LSE = 1e30 on both sides."""
    m = J.sliding_window_mask(8, 8, 2, 1, True, 32, 32).mask.copy()
    m[3, :] = False
    mask = J.BlockMask(m, 32, 32)
    q, k, v, _ = _inputs(1, 2, 256, 256, 32, seed=13)
    scale = 1 / math.sqrt(32)
    o_want, lse_want = J._bs_fwd(*(jnp.asarray(a) for a in (q, k, v)), mask,
                                 True, scale, True)
    o_want, lse_want = (torch.from_numpy(np.array(a))
                        for a in (o_want, lse_want))
    port = P.BlockMask(mask.mask, mask.block_q, mask.block_k)
    keep = P._elementwise_keep(port, True, "cpu")
    o, lse = _fwd_split(*(torch.from_numpy(a) for a in (q, k, v)), keep,
                        scale)
    assert _row_rel_err(o, o_want) <= ROW_TOL
    assert (lse - lse_want).abs().max().item() <= LSE_TOL
    for a, b in ((o, o_want), (lse[:, :, :, None], lse_want[:, :, :, None])):
        dead = a.reshape(2, 256, -1)[:, 96:128]
        assert torch.equal(dead, b.reshape(2, 256, -1)[:, 96:128])
    assert not o[:, :, 96:128].any() and (lse[:, :, 96:128] == 1e30).all()


@pytest.mark.parametrize("case", ["causal_D128", "causal_D16"])
def test_the_forwards_pieces_leave_the_f32_limit_room(case):
    """The forward's designs against the f32 plain forward: one bf16
    product per f32 product misses 1e-4 (and LSE 1e-3) by far; three
    products on two pieces a side pass, within a third of the limit, and
    five for P . V (V in two pieces, the dK/dV kernel's plan) read less;
    the kernel's six products on three pieces a side, for S and for P .
    V, read a tenth of the limit or less and less than either."""
    B, H, T, S, D, causal = FLASH_CASES[case]
    q, k, v, _ = _inputs(B, H, T, S, D, seed=3)
    scale = 1 / math.sqrt(D)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    want = fa._flash_plain(*t, causal, scale)
    keep = fa._causal_keep(T, S, "cpu")
    err = {}
    for name, design in (("kernel", FORWARD), ("five", KERNEL),
                         ("two", TWO_PIECES), ("one", ONE_PIECE)):
        o, lse = _fwd_split(*t, keep, scale, design)
        err[name] = _row_rel_err(o, want[0])
        lse_err = (lse - want[1]).abs().max().item()
        assert (lse_err > LSE_TOL) == (name == "one")
    assert err["one"] > 10 * ROW_TOL
    assert err["two"] <= ROW_TOL / 3
    assert err["kernel"] <= ROW_TOL / 10
    assert err["kernel"] < err["five"] < err["two"]


def test_the_forwards_o_keeps_the_key_bias_gradient_at_rounding_level():
    """A key bias adds the same q . b to every score of a row, which the
    softmax ignores: its gradient, the sum of dK over the key rows, is 0
    in exact arithmetic and rounding noise in f32.  The backward's delta =
    rowsum(dO O) takes O from the forward and its own P . dP from
    recomputed products, so that noise grows with O's error: O from P . V
    on two pieces of V (five products, or three on two pieces of P too)
    leaves V's rounding in O and the sum 10x the plain f32 pipeline's; the
    kernel's six products on three pieces of P and of V, with the f32
    dK/dV's products, keep it at that level.  (The f32 training test on
    the card holds this sum, a key bias's update, against the CPU's.)
    The shape is that test's attention: B 3, 4 heads of 16, T 20,
    causal."""
    rng = np.random.RandomState(0)
    q, k, v, g = (torch.from_numpy(rng.randn(3, 4, 20, 16)
                                   .astype(np.float32)) for _ in range(4))
    scale = 1 / math.sqrt(16)
    keep = fa._causal_keep(20, 20, "cpu")
    o, lse = fa._flash_plain(q, k, v, True, scale)
    plain = fa._flash_bwd_plain(q, k, v, o, lse, g, True, scale)[1]
    noise = plain.sum(dim=2).norm().item()
    sums = {}
    for name, acc in (("kernel", (3, 3)), ("five", (3, 2)),
                      ("three", (2, 2))):
        o, lse = _fwd_split(q, k, v, keep, scale, dict(scores=(3, 3),
                                                       acc=acc))
        dk, _ = _dkv_split(q, k, v, o, lse, g, keep, scale)
        sums[name] = dk.sum(dim=2).norm().item()
    assert sums["kernel"] <= 2 * noise
    assert min(sums["five"], sums["three"]) > 10 * noise


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


# ----------------------------------------------------------------------
# the f32 forward at head dims 129-256: K1 and K6 at D 192 and 256
# ----------------------------------------------------------------------

#: key rows of a tile the f32 forward sweeps at D 192 and 256
WIDE_KEY_TILE = 32
#: q columns a consumer warpgroup splits into wgmma's register operand
#: at a time (one TMA panel of 32 f32 columns: two k16 steps)
WIDE_Q_PANEL = 32
#: the six bf16 products of an f32 product in the kernels' order, small
#: terms first: (piece of A, piece of B), 0-based
TERMS = ((0, 2), (1, 1), (2, 0), (0, 1), (1, 0), (0, 0))


def _round_toward_zero(x):
    """f64 ``x`` to f32, rounded toward zero."""
    r = x.float()
    over = r.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(r, torch.zeros_like(r)), r)


def _wgmma_add(acc, a, b, truncate):
    """``acc`` plus one k16 step's bf16 product a . b (a's 16 columns, b's
    16 rows, each product of two bf16 values exact) as wgmma adds it to its
    f32 accumulator: rounded toward zero (``truncate``, as the card rounds
    the sums it accumulates: PERF.md) or to nearest."""
    x = acc.double() + a.double() @ b.double()
    return _round_toward_zero(x) if truncate else x.float()


def _wide_scores(q, kt, truncate=True, partial=WIDE_Q_PANEL):
    """S = Q . K^T of a warpgroup's 64 q rows and a 32-key tile as the f32
    K1/K6 form it at D 192 and 256: for each 32-column panel of q, split
    into registers, the six products of each of its two k16 steps (steps
    outer) into a fresh partial, added to S in f32 once they are done;
    ``partial``: the columns a partial spans (16: one a k16 step, as the
    f32 dK/dV and dQ form their scores; None: one accumulator over all of
    D, a design not taken)."""
    A, B = _pieces(q, 3), _pieces(kt.transpose(-1, -2), 3)
    D = q.shape[-1]
    total = torch.zeros(*q.shape[:-1], kt.shape[-2])
    part = torch.zeros_like(total)
    for c in range(0, D, 16):
        for i, j in TERMS:
            part = _wgmma_add(part, A[i][..., c:c + 16],
                              B[j][..., c:c + 16, :], truncate)
        if partial and (c + 16) % partial == 0:
            total, part = total + part, torch.zeros_like(total)
    return total + part


def _wide_pv(acc, p, vt, truncate=True, terms=TERMS):
    """acc + P . V over a tile of 16 or 32 keys: the products ``terms``
    (pieces of P, of V) of each of its k16 steps, terms outer, into the
    accumulator; six (``TERMS``), or five on two pieces of V
    (``TERMS[1:]``)."""
    A, B = _pieces(p, 3), _pieces(vt, 3)
    for i, j in terms:
        for c in range(0, vt.shape[-2], 16):
            acc = _wgmma_add(acc, A[i][..., c:c + 16], B[j][..., c:c + 16, :],
                             truncate)
    return acc


def _fwd_wide_split(q, k, v, keep, scale, truncate=True,
                    partial=WIDE_Q_PANEL):
    """O (B, H, T, D) and LSE (B * H, 1, T) as the f32 K1/K6 compute them
    at D 192 and 256: blocks of 128 query rows, each consumer warpgroup's
    64 rows over the 32-key tiles where one of them attends a key (K1's
    dense sweep skips a tile above the warpgroup's diagonal, K6's lists a
    dead pair), S by ``_wide_scores``, the online softmax of
    ``_fwd_split``, O += P . V by ``_wide_pv``, O = acc / max(l, 1e-30)
    and LSE as there; wgmma's sums rounded toward zero where
    ``truncate``, S's partials spanning ``partial`` columns."""
    B, H, T, _ = q.shape
    D = v.shape[-1]   # O's columns (the chunked forward: a chunk of them)
    o = torch.zeros(B, H, T, D)
    lse = torch.zeros(B, H, T, 1)
    zero = torch.zeros(())
    for r0 in range(0, T, 64):
        rows = slice(r0, min(T, r0 + 64))
        n = rows.stop - r0
        m = torch.full((B, H, n, 1), -math.inf)
        l = torch.zeros(B, H, n, 1)
        acc = torch.zeros(B, H, n, D)
        for k0 in range(0, k.shape[2], WIDE_KEY_TILE):
            cols = slice(k0, k0 + WIDE_KEY_TILE)
            if not keep[rows, cols].any():
                continue
            s = _wide_scores(q[:, :, rows], k[:, :, cols], truncate,
                             partial) * (scale * LOG2E)
            s = s.masked_fill(~keep[rows, cols], -math.inf)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            m_safe = torch.where(m_new == -math.inf, zero, m_new)
            alpha = torch.where(m == -math.inf, zero, torch.exp2(m - m_safe))
            p = torch.exp2(s - m_safe)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            acc = _wide_pv(acc * alpha, p, v[:, :, cols], truncate)
            m = m_new
        o[:, :, rows] = acc / l.clamp_min(1e-30)
        lse[:, :, rows] = torch.where(
            l > 0, (m + torch.log2(l.clamp_min(1e-30))) * LN2,
            torch.full_like(l, 1e30))
    return o, lse.reshape(B * H, 1, T)


#: the shipped design's limit: a third of the f32 limit, the margin kept
#: for split-product designs (the card's error tail ran about 3x the
#: emulation's, PERF.md)
WIDE_ROW_TOL = ROW_TOL / 3

# (B, H, T, S, D, causal): T 130 and the ragged non-causal case take the
# JAX package's plain reference, T 256 its Pallas forward in interpret mode
WIDE_CASES = {
    "causal_T130_D192": (1, 2, 130, 130, 192, True),
    "causal_T256_D256": (1, 2, 256, 256, 256, True),
    "ragged_T130_S200_noncausal_D256": (1, 2, 130, 200, 256, False),
}


@pytest.mark.parametrize("case", sorted(WIDE_CASES))
def test_wide_split_forward_matches_the_jax_flash_forward(case):
    """The f32 forward at D 192 and 256 (32-key tiles, q split into
    registers a panel at a time, a fresh S partial per 32-column q panel
    added to S in f32, wgmma's truncation toward zero modelled) against
    the JAX flash forward: O row by row within a third of the f32 limit,
    LSE within 1e-3."""
    B, H, T, S, D, causal = WIDE_CASES[case]
    q, k, v, _ = _inputs(B, H, T, S, D, seed=5 * len(case))
    scale = 1 / math.sqrt(D)
    keep = (fa._causal_keep(T, S, "cpu") if causal
            else torch.ones(T, S, dtype=torch.bool))
    j = [jnp.asarray(a) for a in (q, k, v)]
    if T % 128 == 0 and S % 128 == 0:
        o_want, lse_want = _flash_fwd(*j, causal, scale, 128, 128, True)
        lse_want = torch.from_numpy(np.array(lse_want))
    else:
        o_want = _attention_reference(*j, causal, scale)
        lse_want = _lse_ref(q, k, keep.numpy(), scale)
    o, lse = _fwd_wide_split(*(torch.from_numpy(a) for a in (q, k, v)), keep,
                             scale)
    assert _row_rel_err(o, torch.from_numpy(np.array(o_want))) \
        <= WIDE_ROW_TOL
    assert (lse.double() - lse_want.double()).abs().max().item() <= LSE_TOL


@pytest.mark.parametrize("D", [192, 256])
def test_wide_split_forward_matches_the_jax_block_sparse_forward(D):
    """Under a block mask with a dead query block and partly live 64-key
    tiles (block 32): the f32 forward at D 192 and 256 against ``_bs_fwd``
    (the Pallas kernel in interpret mode); the dead block's rows are O = 0
    and LSE = 1e30 on both sides."""
    m = J.sliding_window_mask(8, 8, 2, 1, True, 32, 32).mask.copy()
    m[3, :] = False
    mask = J.BlockMask(m, 32, 32)
    q, k, v, _ = _inputs(1, 2, 256, 256, D, seed=D)
    scale = 1 / math.sqrt(D)
    o_want, lse_want = J._bs_fwd(*(jnp.asarray(a) for a in (q, k, v)), mask,
                                 True, scale, True)
    o_want, lse_want = (torch.from_numpy(np.array(a))
                        for a in (o_want, lse_want))
    port = P.BlockMask(mask.mask, mask.block_q, mask.block_k)
    keep = P._elementwise_keep(port, True, "cpu")
    o, lse = _fwd_wide_split(*(torch.from_numpy(a) for a in (q, k, v)), keep,
                             scale)
    assert _row_rel_err(o, o_want) <= WIDE_ROW_TOL
    assert (lse - lse_want).abs().max().item() <= LSE_TOL
    assert not o[:, :, 96:128].any() and (lse[:, :, 96:128] == 1e30).all()
    assert not o_want[:, :, 96:128].any()


@pytest.mark.parametrize("D", [192, 256])
def test_the_wide_forward_models_wgmmas_truncation(D):
    """Against attention in f64 at T 256: the wide forward's products
    rounding to nearest read about the plain f32 forward's error; with
    the card's truncation toward zero they read three times that or more,
    within the design's limit still.  One S accumulator over all of D (96
    roundings at D 256) reads more than the design's fresh partial per
    32 columns (12), added in f32: the truncation of S's sums is modelled,
    not only that of P . V."""
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(1, 2, 256, 256, D,
                                                       seed=31))
    scale = 1 / math.sqrt(D)
    keep = fa._causal_keep(256, 256, "cpu")
    s = (q.double() @ k.double().transpose(-1, -2) * scale).masked_fill(
        ~keep, -math.inf)
    want = torch.softmax(s, dim=-1) @ v.double()
    plain = _row_rel_err(fa._flash_plain(q, k, v, True, scale)[0], want)
    err = {name: _row_rel_err(_fwd_wide_split(q, k, v, keep, scale, **kw)[0],
                              want)
           for name, kw in (("kernel", {}), ("nearest", dict(truncate=False)),
                            ("one", dict(partial=None)))}
    assert err["nearest"] <= 2 * plain
    assert err["kernel"] >= 3 * err["nearest"]
    assert err["one"] > 1.5 * err["kernel"]
    assert err["kernel"] <= WIDE_ROW_TOL


def test_the_wide_forwards_o_keeps_the_key_bias_gradient_at_rounding_level():
    """The key-bias check of ``test_the_forwards_o_keeps_the_key_bias_
    gradient_at_rounding_level`` at D 256 with the plain f32 backward (the
    math the f32 backward at D 129-256 ran before it had Hopper kernels;
    ``test_the_wide_backward_keeps_the_key_bias_gradient_at_rounding_
    level`` holds the kernels' own): O and LSE from the wide forward's
    products (truncation modelled) keep the sum of dK over the key rows
    within twice the plain f32 pipeline's.  One S accumulator over all of D shrinks the scores by
    its 96 truncations, so LSE and the backward's recomputed P disagree:
    three times the plain pipeline's or more; O from P . V on two pieces
    of V five times it or more."""
    rng = np.random.RandomState(0)
    q, k, v, g = (torch.from_numpy(rng.randn(3, 4, 20, 256)
                                   .astype(np.float32)) for _ in range(4))
    scale = 1 / math.sqrt(256)
    keep = fa._causal_keep(20, 20, "cpu")
    o, lse = fa._flash_plain(q, k, v, True, scale)
    noise = fa._flash_bwd_plain(q, k, v, o, lse, g, True, scale)[1] \
        .sum(dim=2).norm().item()
    sums = {}
    for name, (o, lse) in (
            ("kernel", _fwd_wide_split(q, k, v, keep, scale)),
            ("one", _fwd_wide_split(q, k, v, keep, scale, partial=None)),
            ("five", _fwd_split(q, k, v, keep, scale,
                                dict(scores=(3, 3), acc=(3, 2))))):
        dk = fa._flash_bwd_plain(q, k, v, o, lse, g, True, scale)[1]
        sums[name] = dk.sum(dim=2).norm().item()
    assert sums["kernel"] <= 2 * noise
    assert sums["one"] > 3 * noise
    assert sums["five"] > 5 * noise


# ----------------------------------------------------------------------
# the f32 forward above head dim 256: K1 and K6, the chunked forward
# ----------------------------------------------------------------------

def _fwd_chunked_split(q, k, v, keep, scale, **kw):
    """O and LSE as the f32 K1/K6 compute them above head dim 256 (the
    chunked forward, ``attn_fwd_chunk_kernel``): q, k and v zero-padded
    to a multiple of 64 columns (``fa._fwd_head_dim``); for each chunk of
    O (``fa._fwd_chunks``) a block of its own forms S over every
    64-column panel of q and K as ``_wide_scores`` does (the stage's two
    32-column q panels split into registers, each a fresh partial added
    to S in f32), the online softmax, and P . V over the chunk's 256
    columns of V (``_wide_pv``), by ``_fwd_wide_split`` with ``kw``; it
    writes its own columns of O.  Every chunk forms the same S, l and
    LSE, bit for bit (checked here), and chunk 0 writes LSE.  O is cut
    back to D."""
    D = q.shape[-1]
    Dp = fa._fwd_head_dim(D)
    qp, kp, vp = (fa._pad_head_dim(t, Dp) for t in (q, k, v))
    o = torch.zeros(*q.shape[:-1], Dp)
    lses = []
    for col0, lo, hi in fa._fwd_chunks(Dp):
        oc, lse = _fwd_wide_split(qp, kp, vp[..., col0:col0 + fa.CHUNK_COLS],
                                  keep, scale, **kw)
        o[..., lo:hi] = oc[..., lo - col0:hi - col0]
        lses.append(lse)
    assert all(torch.equal(lse, lses[0]) for lse in lses)
    return o[..., :D], lses[0]


# (B, H, T, S, D, causal): T 256 takes the JAX package's Pallas forward in
# interpret mode, T 130 and the ragged non-causal case its plain reference
CHUNKED_CASES = {
    "causal_T256_D320": (1, 2, 256, 256, 320, True),
    "causal_T256_D512": (1, 2, 256, 256, 512, True),
    "causal_T130_D512": (1, 2, 130, 130, 512, True),
    "causal_T130_D300": (1, 2, 130, 130, 300, True),
    "ragged_T130_S200_noncausal_D320": (1, 2, 130, 200, 320, False),
}


@pytest.mark.parametrize("case", sorted(CHUNKED_CASES))
def test_chunked_split_forward_matches_the_jax_flash_forward(case):
    """The f32 forward above head dim 256 (the chunked forward: S over
    64-column panels, a fresh partial per 32-column q panel, O in chunks
    of 256 columns, each chunk forming S anew; wgmma's truncation toward
    zero modelled) against the JAX flash forward, which takes D as it
    is: O row by row within a third of the f32 limit, LSE within 1e-3."""
    B, H, T, S, D, causal = CHUNKED_CASES[case]
    q, k, v, _ = _inputs(B, H, T, S, D, seed=7 * len(case))
    scale = 1 / math.sqrt(D)
    keep = (fa._causal_keep(T, S, "cpu") if causal
            else torch.ones(T, S, dtype=torch.bool))
    j = [jnp.asarray(a) for a in (q, k, v)]
    if T % 128 == 0 and S % 128 == 0:
        o_want, lse_want = _flash_fwd(*j, causal, scale, 128, 128, True)
        lse_want = torch.from_numpy(np.array(lse_want))
    else:
        o_want = _attention_reference(*j, causal, scale)
        lse_want = _lse_ref(q, k, keep.numpy(), scale)
    o, lse = _fwd_chunked_split(*(torch.from_numpy(a) for a in (q, k, v)),
                                keep, scale)
    assert o.shape == (B, H, T, D)
    assert _row_rel_err(o, torch.from_numpy(np.array(o_want))) \
        <= WIDE_ROW_TOL
    assert (lse.double() - lse_want.double()).abs().max().item() <= LSE_TOL


def test_chunked_split_forward_matches_the_jax_block_sparse_forward():
    """Under a block mask with a dead query block and partly live 64-key
    tiles (block 32), at D 320: the f32 chunked forward against
    ``_bs_fwd`` (the Pallas kernel in interpret mode); the dead block's
    rows are O = 0 and LSE = 1e30 on both sides."""
    m = J.sliding_window_mask(8, 8, 2, 1, True, 32, 32).mask.copy()
    m[3, :] = False
    mask = J.BlockMask(m, 32, 32)
    q, k, v, _ = _inputs(1, 2, 256, 256, 320, seed=320)
    scale = 1 / math.sqrt(320)
    o_want, lse_want = J._bs_fwd(*(jnp.asarray(a) for a in (q, k, v)), mask,
                                 True, scale, True)
    o_want, lse_want = (torch.from_numpy(np.array(a))
                        for a in (o_want, lse_want))
    port = P.BlockMask(mask.mask, mask.block_q, mask.block_k)
    keep = P._elementwise_keep(port, True, "cpu")
    o, lse = _fwd_chunked_split(*(torch.from_numpy(a) for a in (q, k, v)),
                                keep, scale)
    assert _row_rel_err(o, o_want) <= WIDE_ROW_TOL
    assert (lse - lse_want).abs().max().item() <= LSE_TOL
    assert not o[:, :, 96:128].any() and (lse[:, :, 96:128] == 1e30).all()
    assert not o_want[:, :, 96:128].any()


def test_the_chunked_forwards_o_keeps_the_key_bias_gradient_at_rounding_level():
    """The key-bias check of ``test_the_wide_forwards_o_keeps_the_key_bias_
    gradient_at_rounding_level`` at D 320 (two chunks of O): O and LSE
    from the chunked forward's products (truncation modelled) keep the sum
    of dK over the key rows, under the plain f32 backward, within twice
    the plain f32 pipeline's; one S accumulator over all of D (120
    roundings) three times it or more."""
    rng = np.random.RandomState(1)
    q, k, v, g = (torch.from_numpy(rng.randn(3, 4, 20, 320)
                                   .astype(np.float32)) for _ in range(4))
    scale = 1 / math.sqrt(320)
    keep = fa._causal_keep(20, 20, "cpu")
    o, lse = fa._flash_plain(q, k, v, True, scale)
    noise = fa._flash_bwd_plain(q, k, v, o, lse, g, True, scale)[1] \
        .sum(dim=2).norm().item()
    sums = {}
    for name, kw in (("kernel", {}), ("one", dict(partial=None))):
        o, lse = _fwd_chunked_split(q, k, v, keep, scale, **kw)
        dk = fa._flash_bwd_plain(q, k, v, o, lse, g, True, scale)[1]
        sums[name] = dk.sum(dim=2).norm().item()
    assert sums["kernel"] <= 2 * noise
    assert sums["one"] > 3 * noise


def test_the_chunked_forwards_plan_covers_each_column_once():
    """Every head dim from 257 to 1024: the forward runs at D padded to
    the next multiple of 64 (``_fwd_head_dim``), whose 64-column panels
    the scores sum over, in ceil(Dp / 256) chunks of O; each chunk forms
    256 columns from a panel's first column, inside Dp, and writes its
    own columns, which together are each of Dp's columns once, in order
    (the true D's among them)."""
    for D in range(257, 1025):
        Dp = fa._fwd_head_dim(D)
        assert Dp % fa.CHUNK_PANEL == 0 and D <= Dp < D + fa.CHUNK_PANEL
        chunks = fa._fwd_chunks(Dp)
        assert len(chunks) == -(-Dp // fa.CHUNK_COLS)
        written = []
        for col0, lo, hi in chunks:
            assert col0 % fa.CHUNK_PANEL == 0
            assert 0 <= col0 <= lo < hi <= col0 + fa.CHUNK_COLS <= Dp
            written += range(lo, hi)
        assert written == list(range(Dp)), D


# ----------------------------------------------------------------------
# the f32 backward at head dims 129-256: K2/K7 and K3/K8 at D 192 and 256
# ----------------------------------------------------------------------

#: the rows of a tile the f32 dK/dV (query rows) and dQ (key rows) stream
#: at D 192 and 256; each dQ warpgroup takes half of a key tile's
WIDE_TILE = 32
#: the columns of a partial of the backward's scores at D 192 and 256: a
#: fresh one a k16 step (``wide_scores`` with ``kStep``)
WIDE_STEP = 16


def _dkv_wide_split(q, k, v, o, lse, d_o, keep, scale, truncate=True,
                    partial=WIDE_STEP, cols=slice(None)):
    """dK and dV (B, H, S, D) as the f32 K2/K7 compute them at D 192 and
    256 (``dkv_f32_consume`` with ``WIDE``): S^T = K . Q^T and dP^T = V .
    dO^T by ``_wide_scores`` (K and V, the block's own rows, split into
    registers a 32-column panel at a time, a fresh partial per k16 step;
    ``partial`` as there), P^T, dP^T and dS^T as ``_dkv_split`` forms them,
    then over the 32-row query tiles in order dV += P^T . dO and dK +=
    dS^T . Q, five products each (dO and Q in two pieces), terms outer,
    k16 steps inner, in one accumulator a row; wgmma's sums rounded toward
    zero where ``truncate``.  A tile whose pairs are all masked adds zeros,
    which leave the accumulator as it is, as the sweep's skipping it
    does.  dK and dV are formed over the columns ``cols`` of Q and dO
    (the chunked backward's chunk; all of them at D 192 and 256)."""
    B, H, T, D = q.shape
    delta = (d_o * o).sum(dim=-1)[:, :, None, :]
    lse = lse.reshape(B, H, 1, T)
    zero = torch.zeros(())
    st = _wide_scores(k, q, truncate, partial)
    pt = torch.where(keep.T, torch.exp2(st * (scale * LOG2E) - lse * LOG2E),
                     zero)
    dpt = _wide_scores(v, d_o, truncate, partial)
    dst = torch.where(keep.T, pt * (dpt - delta), zero)
    qc, doc = q[..., cols], d_o[..., cols]
    dk = torch.zeros(B, H, k.shape[2], qc.shape[-1])
    dv = torch.zeros_like(dk)
    for r0 in range(0, T, WIDE_TILE):
        rows = slice(r0, r0 + WIDE_TILE)
        dv = _wide_pv(dv, pt[..., rows], doc[:, :, rows], truncate, TERMS[1:])
        dk = _wide_pv(dk, dst[..., rows], qc[:, :, rows], truncate, TERMS[1:])
    return dk * scale, dv


def _dq_wide_split(q, k, v, o, lse, d_o, keep, scale, truncate=True,
                   partial=WIDE_STEP, terms=TERMS, cols=slice(None)):
    """dQ (B, H, T, D) as the f32 K3/K8 compute it at D 192 and 256
    (``dq_f32_consume`` with ``WIDE``): S = Q . K^T and dP = dO . V^T by
    ``_wide_scores`` (Q and dO split into registers a panel at a time, a
    fresh partial per k16 step),
    P and dS as ``_dq_split`` forms them, then over the 32-key tiles in
    order, warpgroup w adding dS . K over keys 16 w .. 16 w + 15 of each
    (six products, ``terms``) into its own accumulator; the two meet
    once, in f32, at the end.  dQ is formed over the columns ``cols`` of
    K (the chunked backward's chunk; all of them at D 192 and 256)."""
    B, H, T, D = q.shape
    S = k.shape[2]
    delta = (d_o * o).sum(dim=-1, keepdim=True)
    lse = lse.reshape(B, H, T, 1)
    zero = torch.zeros(())
    s = _wide_scores(q, k, truncate, partial)
    p = torch.where(keep, torch.exp2(s * (scale * LOG2E) - lse * LOG2E),
                    zero)
    dp = _wide_scores(d_o, v, truncate, partial)
    ds = torch.where(keep, p * (dp - delta), zero)
    half = WIDE_TILE // 2
    kc = k[..., cols]
    acc = [torch.zeros(B, H, T, kc.shape[-1]) for _ in range(2)]
    for k0 in range(0, S, WIDE_TILE):
        for w in range(2):
            keys = slice(k0 + half * w, min(S, k0 + half * (w + 1)))
            if keys.start < S:
                acc[w] = _wide_pv(acc[w], ds[..., keys], kc[:, :, keys],
                                  truncate, terms)
    return (acc[0] + acc[1]) * scale


def _wide_backward(q, k, v, g, keep, scale):
    """dQ, dK and dV of the f32 slice at D 192 and 256 on the card: O and
    LSE from the wide forward's products (``_fwd_wide_split``), then the
    wide dK/dV and dQ on them."""
    o, lse = _fwd_wide_split(q, k, v, keep, scale)
    return (_dq_wide_split(q, k, v, o, lse, g, keep, scale),
            *_dkv_wide_split(q, k, v, o, lse, g, keep, scale))


def _check_wide_grads(got, want, keep, k, v, d_o, sm_scale):
    """dQ, dK and dV against ``want`` row by row within a third of the f32
    limit, one scale for the three (dQ's rows with one live key against
    their terms' size, ``_dq_err``)."""
    largest = max(torch.linalg.vector_norm(w, dim=-1).max().item()
                  for w in want)
    assert _dq_err(got[0], want[0], keep, k, v, d_o, sm_scale,
                   largest) <= WIDE_ROW_TOL
    for name, a, b in zip(("dk", "dv"), got[1:], want[1:]):
        assert _scaled_row_err(a, b, largest) <= WIDE_ROW_TOL, name


@pytest.mark.parametrize("case", sorted(WIDE_CASES))
def test_wide_split_backward_matches_the_jax_flash_backward(case):
    """The f32 slice at D 192 and 256 (the wide forward's O and LSE, then
    the wide dK/dV and dQ, wgmma's truncation toward zero modelled)
    against the gradients ``jax.vjp`` takes through the JAX flash
    attention (the Pallas kernels in interpret mode; the plain reference
    at T 130), row by row within a third of the f32 limit."""
    B, H, T, S, D, causal = WIDE_CASES[case]
    q, k, v, g = _inputs(B, H, T, S, D, seed=7 * len(case))
    scale = 1 / math.sqrt(D)
    want = _jax_grads(lambda a, b, c: jax_flash(a, b, c, causal=causal,
                                                sm_scale=scale,
                                                interpret=True), q, k, v, g)
    t = [torch.from_numpy(a) for a in (q, k, v, g)]
    keep = (fa._causal_keep(T, S, "cpu") if causal
            else torch.ones(T, S, dtype=torch.bool))
    got = _wide_backward(*t[:3], t[3], keep, scale)
    _check_wide_grads(got, want, keep, t[1], t[2], t[3], scale)


@pytest.mark.parametrize("D", [192, 256])
def test_wide_split_backward_matches_the_jax_block_sparse_backward(D):
    """Under a block mask with a dead key block, a dead query block, a
    query row whose one live key is its own and partly live 32-row tiles
    (block 32): the f32 slice at D 192 and 256 against ``jax.vjp`` of
    ``block_sparse_attention`` through the Pallas kernels in interpret
    mode; the dead blocks' rows are 0 on both sides."""
    m = J.sliding_window_mask(8, 8, 2, 1, True, 32, 32).mask.copy()
    m[:, 5] = False     # k block 5: read by no query
    m[6, :] = False     # q block 6: reads nothing
    m[4, :4] = False    # q block 4: its own block alone, so row 128 has one key
    mask = J.BlockMask(m, 32, 32)
    q, k, v, g = _inputs(1, 2, 256, 256, D, seed=23)
    scale = 1 / math.sqrt(D)
    want = _jax_grads(lambda a, b, c: J.block_sparse_attention(
        a, b, c, mask, causal=True, sm_scale=scale, interpret=True),
        q, k, v, g)
    port = P.BlockMask(mask.mask, mask.block_q, mask.block_k)
    t = [torch.from_numpy(a) for a in (q, k, v, g)]
    keep = P._elementwise_keep(port, True, "cpu")
    got = _wide_backward(*t[:3], t[3], keep, scale)
    _check_wide_grads(got, want, keep, t[1], t[2], t[3], scale)
    assert not got[0][:, :, 192:224].any() and not want[0][:, :, 192:224].any()
    for a, b in zip(got[1:], want[1:]):
        assert not a[:, :, 160:192].any() and not b[:, :, 160:192].any()


@pytest.mark.parametrize("D", [192, 256])
def test_the_wide_backward_keeps_the_key_bias_gradient_at_rounding_level(D):
    """The key-bias check of ``test_the_wide_forwards_o_keeps_the_key_bias_
    gradient_at_rounding_level`` with the wide dK/dV in place of the plain
    f32 backward: O and LSE from the wide forward's products, S^T and
    dP^T from a fresh partial per k16 step (truncation modelled), keep
    the sum of dK over the key rows within twice the
    plain f32 pipeline's.  S^T and dP^T over all of D in one accumulator
    (96 truncations at D 256) shrink the recomputed P against LSE: three
    times the plain pipeline's or more."""
    rng = np.random.RandomState(0)
    q, k, v, g = (torch.from_numpy(rng.randn(3, 4, 20, D)
                                   .astype(np.float32)) for _ in range(4))
    scale = 1 / math.sqrt(D)
    keep = fa._causal_keep(20, 20, "cpu")
    o, lse = fa._flash_plain(q, k, v, True, scale)
    noise = fa._flash_bwd_plain(q, k, v, o, lse, g, True, scale)[1] \
        .sum(dim=2).norm().item()
    o, lse = _fwd_wide_split(q, k, v, keep, scale)
    sums = {name: _dkv_wide_split(q, k, v, o, lse, g, keep, scale, **kw)[0]
            .sum(dim=2).norm().item()
            for name, kw in (("kernel", {}), ("one", dict(partial=None)))}
    assert sums["kernel"] <= 2 * noise
    assert sums["one"] > 3 * noise


@pytest.mark.parametrize("D", [192, 256])
def test_the_wide_dq_keeps_a_key_shift_at_rounding_level(D):
    """The property of ``test_the_dq_keeps_a_key_shift_at_rounding_level``
    at D 192 and 256 (truncation modelled): a common shift of the key rows
    moves the wide dQ within twice what it moves the plain f32 pipeline's,
    while K in two pieces (five products for dS . K) or S and dP over all
    of D in one accumulator move it four times that or more."""
    rng = np.random.RandomState(0)
    q, k, v, g = (torch.from_numpy(rng.randn(3, 4, 20, D)
                                   .astype(np.float32)) for _ in range(4))
    b = torch.from_numpy(np.random.RandomState(1).randn(1, 4, 1, D)
                         .astype(np.float32))
    scale = 1 / math.sqrt(D)
    keep = fa._causal_keep(20, 20, "cpu")
    o, lse = fa._flash_plain(q, k, v, True, scale)
    exact = fa._flash_bwd_plain(q, k, v, o, lse, g, True, scale)[0]
    o, lse = fa._flash_plain(q, k + b, v, True, scale)
    plain = fa._flash_bwd_plain(q, k + b, v, o, lse, g, True, scale)[0]
    noise = (plain - exact).norm().item()
    moved = {name: (_dq_wide_split(q, k + b, v, o, lse, g, keep, scale, **kw)
                    - exact).norm().item()
             for name, kw in (("kernel", {}), ("five", dict(terms=TERMS[1:])),
                              ("one", dict(partial=None)))}
    assert moved["kernel"] <= 2 * noise
    assert min(moved["five"], moved["one"]) > 4 * noise


# ----------------------------------------------------------------------
# the f32 backward above head dim 256: K2/K7 and K3/K8, the chunked
# backward
# ----------------------------------------------------------------------

def _chunked(wide_split, outs, q, k, v, o, lse, d_o, keep, scale, **kw):
    """The outputs of ``wide_split`` (``_dkv_wide_split``: dK, dV;
    ``_dq_wide_split``: dQ) as the f32 chunked backward forms them above
    head dim 256 (``bwd_dkv_chunk_kernel``, ``bwd_dq_chunk_kernel``): q,
    k, v, O and dO zero-padded to a multiple of 64 columns
    (``fa._bwd_head_dim``); for each chunk of the columns
    (``fa._fwd_chunks``) a block of its own forms the scores anew over
    every 64-column panel, a fresh partial per k16 step added in f32 (the
    order of ``_wide_scores``: zero columns add exact zeros), and the
    products over the chunk's 256 columns of the chunk operands (dO and
    Q, or K); it writes its own columns.  Cut back to D."""
    D = q.shape[-1]
    Dp = fa._bwd_head_dim(D)
    padded = [fa._pad_head_dim(t, Dp) for t in (q, k, v, o)]
    got = [torch.zeros(*t.shape[:-1], Dp) for t in outs]
    for col0, lo, hi in fa._fwd_chunks(Dp):
        part = wide_split(*padded, lse, fa._pad_head_dim(d_o, Dp), keep,
                          scale, cols=slice(col0, col0 + fa.CHUNK_COLS), **kw)
        for g, c in zip(got, part if isinstance(part, tuple) else (part,)):
            g[..., lo:hi] = c[..., lo - col0:hi - col0]
    return [g[..., :D] for g in got]


def _dkv_chunked_split(q, k, v, o, lse, d_o, keep, scale, **kw):
    """dK and dV (B, H, S, D) as the f32 K2/K7 compute them above head
    dim 256 (``_chunked`` over ``_dkv_wide_split``: S^T and dP^T summed
    over the panels of the own K and V rows and the 32-row Q and dO
    tiles, dV and dK over the chunk's columns of dO and Q, five products
    each)."""
    return tuple(_chunked(_dkv_wide_split, (k, v), q, k, v, o, lse, d_o,
                          keep, scale, **kw))


def _dq_chunked_split(q, k, v, o, lse, d_o, keep, scale, **kw):
    """dQ (B, H, T, D) as the f32 K3/K8 compute it above head dim 256
    (``_chunked`` over ``_dq_wide_split``: S and dP summed over the
    panels of the own Q and dO rows and the 32-key K and V tiles, each
    warpgroup's 16 keys; dS . K over the chunk's columns of K, six
    products)."""
    return _chunked(_dq_wide_split, (q,), q, k, v, o, lse, d_o, keep, scale,
                    **kw)[0]


def _chunked_backward(q, k, v, g, keep, scale):
    """dQ, dK and dV of the f32 slice above head dim 256 on the card: O
    and LSE from the chunked forward's products (``_fwd_chunked_split``),
    then the chunked dK/dV and dQ on them."""
    o, lse = _fwd_chunked_split(q, k, v, keep, scale)
    return (_dq_chunked_split(q, k, v, o, lse, g, keep, scale),
            *_dkv_chunked_split(q, k, v, o, lse, g, keep, scale))


# (B, H, T, S, D, causal): T 128 takes the JAX package's Pallas kernels in
# interpret mode, T 130 and the ragged non-causal case its plain reference
CHUNKED_BWD_CASES = {
    "causal_T128_D320": (1, 2, 128, 128, 320, True),
    "causal_T130_D512": (1, 2, 130, 130, 512, True),
    "causal_T130_D300": (1, 2, 130, 130, 300, True),
    "ragged_T65_S130_noncausal_D320": (1, 2, 65, 130, 320, False),
}


@pytest.mark.parametrize("case", sorted(CHUNKED_BWD_CASES))
def test_chunked_split_backward_matches_the_jax_flash_backward(case):
    """The f32 slice above head dim 256 (the chunked forward's O and LSE,
    then the chunked dK/dV and dQ: the scores summed over 64-column
    panels, a fresh partial per k16 step, the outputs in chunks of 256
    columns; wgmma's truncation toward zero modelled) against the
    gradients ``jax.vjp`` takes through the JAX flash attention, which
    takes D as it is (the Pallas kernels in interpret mode; the plain
    reference at T 130 and 65), row by row within a third of the f32
    limit."""
    B, H, T, S, D, causal = CHUNKED_BWD_CASES[case]
    q, k, v, g = _inputs(B, H, T, S, D, seed=11 * len(case))
    scale = 1 / math.sqrt(D)
    want = _jax_grads(lambda a, b, c: jax_flash(a, b, c, causal=causal,
                                                sm_scale=scale,
                                                interpret=True), q, k, v, g)
    t = [torch.from_numpy(a) for a in (q, k, v, g)]
    keep = (fa._causal_keep(T, S, "cpu") if causal
            else torch.ones(T, S, dtype=torch.bool))
    got = _chunked_backward(*t[:3], t[3], keep, scale)
    assert [a.shape for a in got] == [a.shape for a in t[:3]]
    _check_wide_grads(got, want, keep, t[1], t[2], t[3], scale)


def test_chunked_split_backward_matches_the_jax_block_sparse_backward():
    """Under a block mask with a dead key block, a dead query block, a
    query row whose one live key is its own and partly live 32-row tiles
    (block 32), at D 320: the f32 chunked backward against ``jax.vjp`` of
    ``block_sparse_attention`` through the Pallas kernels in interpret
    mode; the dead blocks' rows are 0 on both sides."""
    m = J.sliding_window_mask(4, 4, 2, 1, True, 32, 32).mask.copy()
    m[:, 2] = False     # k block 2: read by no query
    m[3, :] = False     # q block 3: reads nothing
    m[1, 0] = False     # q block 1: its own block alone, so row 32 has one key
    mask = J.BlockMask(m, 32, 32)
    q, k, v, g = _inputs(1, 2, 128, 128, 320, seed=29)
    scale = 1 / math.sqrt(320)
    want = _jax_grads(lambda a, b, c: J.block_sparse_attention(
        a, b, c, mask, causal=True, sm_scale=scale, interpret=True),
        q, k, v, g)
    port = P.BlockMask(mask.mask, mask.block_q, mask.block_k)
    t = [torch.from_numpy(a) for a in (q, k, v, g)]
    keep = P._elementwise_keep(port, True, "cpu")
    assert keep[32].sum() == 1
    got = _chunked_backward(*t[:3], t[3], keep, scale)
    _check_wide_grads(got, want, keep, t[1], t[2], t[3], scale)
    assert not got[0][:, :, 96:].any() and not want[0][:, :, 96:].any()
    for a, b in zip(got[1:], want[1:]):
        assert not a[:, :, 64:96].any() and not b[:, :, 64:96].any()


def test_the_chunked_backward_keeps_the_key_bias_gradient_at_rounding_level():
    """The key-bias check of ``test_the_wide_backward_keeps_the_key_bias_
    gradient_at_rounding_level`` at D 320 (two chunks): O and LSE from
    the chunked forward's products, S^T and dP^T summed over the panels
    from a fresh partial per k16 step (truncation modelled), keep the sum
    of dK over the key rows within twice the plain f32 pipeline's; S^T
    and dP^T over all of D in one accumulator (120 truncations) three
    times it or more."""
    rng = np.random.RandomState(2)
    q, k, v, g = (torch.from_numpy(rng.randn(3, 4, 20, 320)
                                   .astype(np.float32)) for _ in range(4))
    scale = 1 / math.sqrt(320)
    keep = fa._causal_keep(20, 20, "cpu")
    o, lse = fa._flash_plain(q, k, v, True, scale)
    noise = fa._flash_bwd_plain(q, k, v, o, lse, g, True, scale)[1] \
        .sum(dim=2).norm().item()
    o, lse = _fwd_chunked_split(q, k, v, keep, scale)
    sums = {name: _dkv_chunked_split(q, k, v, o, lse, g, keep, scale, **kw)[0]
            .sum(dim=2).norm().item()
            for name, kw in (("kernel", {}), ("one", dict(partial=None)))}
    assert sums["kernel"] <= 2 * noise
    assert sums["one"] > 3 * noise


def test_the_chunked_dq_keeps_a_key_shift_at_rounding_level():
    """The property of ``test_the_wide_dq_keeps_a_key_shift_at_rounding_
    level`` at D 320 (truncation modelled): a common shift of the key
    rows moves the chunked dQ within twice what it moves the plain f32
    pipeline's, while K in two pieces (five products for dS . K) or S and
    dP over all of D in one accumulator move it four times that or
    more."""
    rng = np.random.RandomState(3)
    q, k, v, g = (torch.from_numpy(rng.randn(3, 4, 20, 320)
                                   .astype(np.float32)) for _ in range(4))
    b = torch.from_numpy(np.random.RandomState(4).randn(1, 4, 1, 320)
                         .astype(np.float32))
    scale = 1 / math.sqrt(320)
    keep = fa._causal_keep(20, 20, "cpu")
    o, lse = fa._flash_plain(q, k, v, True, scale)
    exact = fa._flash_bwd_plain(q, k, v, o, lse, g, True, scale)[0]
    o, lse = fa._flash_plain(q, k + b, v, True, scale)
    plain = fa._flash_bwd_plain(q, k + b, v, o, lse, g, True, scale)[0]
    noise = (plain - exact).norm().item()
    moved = {name: (_dq_chunked_split(q, k + b, v, o, lse, g, keep, scale,
                                      **kw) - exact).norm().item()
             for name, kw in (("kernel", {}), ("five", dict(terms=TERMS[1:])),
                              ("one", dict(partial=None)))}
    assert moved["kernel"] <= 2 * noise
    assert min(moved["five"], moved["one"]) > 4 * noise


def test_the_chunked_backwards_plan_covers_each_column_once():
    """Every head dim from 257 to 1024: dK/dV and dQ run, in both dtypes,
    at the forward's padded head dim (the next multiple of 64,
    ``_bwd_head_dim``), whose 64-column panels the scores sum over, in
    ceil(Dp / 256) chunks of the output, each forming 256 columns from a
    panel's first column, inside Dp, and writing its own, which together
    are each of Dp's columns once, in order.  Up to 256 both dtypes run
    the built head dims."""
    for D in range(257, 1025):
        Dp = fa._bwd_head_dim(D)
        assert Dp == fa._fwd_head_dim(D) and Dp % fa.CHUNK_PANEL == 0
        assert D <= Dp < D + fa.CHUNK_PANEL
        assert fa._wide(D) and fa._wide(Dp)
        written = []
        for col0, lo, hi in fa._fwd_chunks(Dp):
            assert col0 % fa.CHUNK_PANEL == 0
            assert 0 <= col0 <= lo < hi <= col0 + fa.CHUNK_COLS <= Dp
            written += range(lo, hi)
        assert written == list(range(Dp)), D
    for D in range(1, 257):
        assert fa._bwd_head_dim(D) == fa._padded_head_dim(D) \
            == fa._fwd_head_dim(D)
        assert not fa._wide(D)


# ----------------------------------------------------------------------
# the f32 K5: the 3x3 conv's forward and dX on split products
# ----------------------------------------------------------------------

#: the f32 K5's products: three pieces of the pixels and of the weights
CONV = (3, 3)
#: the cheaper designs: the weights in two pieces (five products), both
#: sides in two (three)
CONV_FIVE = (3, 2)
CONV_THREE = (2, 2)
#: input channels a step of the f32 K5 (``split_chunk_channels``: 16 at C
#: <= 16, else 32)
CONV_CHUNK = 32
#: (B, H, W, C, O): a small stage; the deepest stage's channels at 7 x 7
#: (K = 9 * 512 = 4608 terms a sum); the ragged conv of phase 3
CONV_CASES = {"small": (2, 6, 7, 32, 48), "deep": (1, 7, 7, 512, 512),
              "ragged": (2, 7, 5, 3, 10)}


def _conv_split(x, w, design=CONV):
    """y (B, H, W, O) as the f32 K5 forms it from NHWC x and HWIO w: one
    f32 sum over the steps (tap, chunk of ``CONV_CHUNK`` channels) in the
    kernel's order, each step adding the products of the chunk of the
    shifted pixels (zero outside the image) and of w[dy, dx] that
    ``_mm`` forms with the pieces ``design`` gives."""
    B, H, W, C = x.shape
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    acc = torch.zeros(B * H * W, w.shape[-1])
    for dy in range(3):
        for dx in range(3):
            xs = xp[:, dy:dy + H, dx:dx + W].reshape(-1, C)
            for c0 in range(0, C, CONV_CHUNK):
                c1 = c0 + CONV_CHUNK
                acc = acc + _mm(xs[:, c0:c1], w[dy, dx, c0:c1], *design)
    return acc.reshape(B, H, W, -1)


def _conv_inputs(B, H, W, C, O, seed):
    """x, w (scaled 1 / (3 sqrt C), so y is of order 1) and an output
    gradient g, f32 numpy arrays."""
    rng = np.random.RandomState(seed)
    x = rng.randn(B, H, W, C).astype(np.float32)
    w = (rng.randn(3, 3, C, O) / (3 * math.sqrt(C))).astype(np.float32)
    g = rng.randn(B, H, W, O).astype(np.float32)
    return x, w, g


def _dx_weights(w):
    """The dX conv's HWIO weights: w spatially flipped, in and out
    swapped (``_Conv3x3.backward``)."""
    return torch.flip(w, (0, 1)).transpose(2, 3)


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_split_conv_matches_the_jax_kernel(case):
    """The f32 K5's split products, forward and dX, row by row over
    output pixels against ``conv3x3_s1_same`` with ``interpret=True``
    (the Pallas kernel in interpret mode) and ``jax.vjp`` through it, at
    a third of the f32 limit."""
    x, w, g = _conv_inputs(*CONV_CASES[case], seed=17)
    y, vjp = jax.vjp(lambda a, b: jconv3x3(a, b, interpret=True),
                     jnp.asarray(x), jnp.asarray(w))
    dx_want = torch.from_numpy(np.array(vjp(jnp.asarray(g))[0]))
    xt, wt, gt = (torch.from_numpy(a) for a in (x, w, g))
    assert _row_rel_err(_conv_split(xt, wt),
                        torch.from_numpy(np.array(y))) <= ROW_TOL / 3
    assert _row_rel_err(_conv_split(gt, _dx_weights(wt)),
                        dx_want) <= ROW_TOL / 3


def test_the_conv_pieces_keep_f32_rounding():
    """The designs at the deepest stage's channels (K = 4608), forward
    and dX, against the conv in f64: the kernel's six products on three
    pieces a side read what the plain f32 conv reads (within 2x; both of
    the order of 2e-7).  Five products (the weights in two pieces) and
    three (two pieces a side) read 8x and 15x the kernel's or more: they
    would pass the 1e-4 row limit, but leave bf16's rounding of an
    operand (2^-17 of it) in every output, as the f32 forward's O on two
    pieces of V did before it failed a training test."""
    x, w, g = (torch.from_numpy(a) for a in _conv_inputs(
        *CONV_CASES["deep"], seed=19))
    for a, k in ((x, w), (g, _dx_weights(w))):
        want = conv3x3._conv3x3_plain(a.double(), k.double())
        plain = _row_rel_err(conv3x3._conv3x3_plain(a, k), want)
        err = {name: _row_rel_err(_conv_split(a, k, design), want)
               for name, design in (("kernel", CONV), ("five", CONV_FIVE),
                                    ("three", CONV_THREE))}
        assert plain <= 1e-6
        assert err["kernel"] <= 2 * plain
        assert err["five"] >= 8 * err["kernel"]
        assert err["three"] >= 15 * err["kernel"]
        assert err["three"] <= ROW_TOL


def test_the_wrappers_weight_pieces_are_the_split():
    """The f32 K5's weights as the wrapper hands them over: the (tap,
    out, in) weights' three pieces, bit for bit ``_pieces``, in a (3, 9,
    out, c8) bf16 tensor with zeros past the channels, summing back to
    the f32 weights exactly; from a permuted view (the layout the
    Function reads HWIO weights in) the same bits."""
    w = torch.from_numpy(_conv_inputs(1, 1, 1, 30, 20, seed=23)[1])
    wk = w.permute(0, 1, 3, 2).contiguous()
    got = conv3x3._weight_pieces(wk, 32)
    assert got.shape == (3, 9, 20, 32) and got.dtype == torch.bfloat16
    assert not got[..., 30:].any()
    for have, want in zip(got[..., :30], _pieces(wk.reshape(9, 20, 30), 3)):
        assert torch.equal(have.float(), want)
    total = sum(p.double() for p in got[..., :30])
    assert torch.equal(total, wk.reshape(9, 20, 30).double())
    assert torch.equal(conv3x3._weight_pieces(w.permute(0, 1, 3, 2), 32),
                       got)


@pytest.mark.parametrize("C,misaligned,copies",
                         [(64, False, 0), (64, True, 1), (30, False, 1),
                          (3, False, 1)])
def test_the_f32_wrapper_hands_the_kernel_its_operands(monkeypatch, C,
                                                       misaligned, copies):
    """What ``_conv3x3_cuda`` launches the f32 K5 on (recorded, not run):
    x as it is where its channels are a multiple of 4, at least 16, and
    its base 16-byte aligned, else one zero-padded or aligned copy (counted
    in ``X_COPIES``); the weights as their three bf16 pieces, channels
    zero-padded to a multiple of 8; y allocated f32."""
    calls = []
    monkeypatch.setattr(conv3x3, "_launch",
                        lambda *args: calls.append(args))
    x, w, _ = (torch.from_numpy(a) for a in _conv_inputs(2, 5, 4, C, 12,
                                                         seed=29))
    if misaligned:   # one element into a buffer: 4 bytes off
        x = torch.cat([torch.zeros(1), x.reshape(-1)])[1:].view(x.shape)
        assert x.data_ptr() % 16
    wk = w.permute(0, 1, 3, 2).contiguous()
    before = conv3x3.X_COPIES.count
    y = conv3x3._conv3x3_cuda(x, wk)
    (xa, wa, ya), = calls
    c = max(16, -(-C // 4) * 4)
    assert conv3x3.X_COPIES.count - before == copies
    assert (xa is x) == (copies == 0) and xa.data_ptr() % 16 == 0
    assert xa.shape == (2, 5, 4, c) and torch.equal(xa[..., :C], x)
    assert not xa[..., C:].any()
    assert torch.equal(wa, conv3x3._weight_pieces(wk, -(-c // 8) * 8))
    assert ya is y and y.shape == (2, 5, 4, 12) and y.dtype == torch.float32


# ----------------------------------------------------------------------
# the f32 K9: the block-sparse matmul's forward and dX on split products
# ----------------------------------------------------------------------

def _mm_split(x, w, mask, truncate=True, fresh=True):
    """out (M, N) = x @ (W ∘ mask) as the f32 K9 forms it
    (``bs_mm_kernel_split``): each output column block sums its live K
    blocks in ascending order, in steps of KC columns (``_block_plan``: 32
    where it divides bk, else 16); a step's six products a k16 step on
    three pieces a side (``TERMS``, terms outer, k16 steps inner) go into
    a fresh partial with wgmma's truncation toward zero (``_wgmma_add``),
    added to the f32 total (round to nearest) once done.  ``fresh``
    False: one accumulator over all the steps, the design K5 measured
    shrinking every output (PERF.md, PR 16); ``truncate`` False: the
    partials rounded to nearest."""
    bk, bn = mask.block_q, mask.block_k
    kc = P._block_plan(torch.float32, bk, bn).kc
    A, B = _pieces(x, 3), _pieces(w, 3)
    out = torch.zeros(x.shape[0], w.shape[1])
    for c in range(w.shape[1] // bn):
        cols = slice(c * bn, (c + 1) * bn)
        total = torch.zeros(x.shape[0], bn)
        part = torch.zeros_like(total)
        for kb in np.nonzero(mask.mask[:, c])[0]:
            for k0 in range(kb * bk, (kb + 1) * bk, kc):
                if fresh:
                    part = torch.zeros_like(total)
                for i, j in TERMS:
                    for k in range(k0, k0 + kc, 16):
                        part = _wgmma_add(part, A[i][:, k:k + 16],
                                          B[j][k:k + 16, cols], truncate)
                if fresh:
                    total = total + part
        out[:, cols] = total if fresh else part
    return out


def _mm_mask(nk, nn, seed, dead_col=None, live_per_col=None):
    """A (nk, nn) bool block mask at density about 0.5 from a seed: with
    column ``dead_col`` all dead, or with exactly ``live_per_col`` live K
    blocks in every column."""
    rng = np.random.RandomState(seed)
    if live_per_col is not None:
        m = np.zeros((nk, nn), bool)
        for c in range(nn):
            m[rng.choice(nk, live_per_col, replace=False), c] = True
        return m
    m = rng.rand(nk, nn) < 0.5
    m[rng.randint(nk), :] = True    # every column block keeps a live block
    if dead_col is not None:
        m[:, dead_col] = False
    return m


#: (M, K, N, bk, bn, live K blocks a column or None): blocks 32 and 64
#: (KC 32), 48 x 80 (KC 16, BN 16), each at density ~0.5 with one dead
#: column block; and the flagship MLP's column block depth, 4 live blocks
#: of 128 (512 of K 1024), at narrow M and N
MM_SPLIT_CASES = {"b32": (96, 256, 128, 32, 32, None),
                  "b64": (96, 256, 128, 64, 64, None),
                  "b48x80": (96, 240, 160, 48, 80, None),
                  "depth512": (16, 1024, 256, 128, 128, 4)}


def _mm_split_case(case, seed):
    """x, w, g (f32 numpy, W scaled 1 / sqrt(K)) and the mask of a case,
    as (JAX BlockMask, port BlockMask)."""
    M, K, N, bk, bn, per_col = MM_SPLIT_CASES[case]
    rng = np.random.RandomState(seed)
    x = rng.randn(M, K).astype(np.float32)
    w = (rng.randn(K, N) / math.sqrt(K)).astype(np.float32)
    g = rng.randn(M, N).astype(np.float32)
    m = _mm_mask(K // bk, N // bn, seed, dead_col=None if per_col else 1,
                 live_per_col=per_col)
    return x, w, g, J.BlockMask(m, bk, bn), P.BlockMask(m, bk, bn)


@pytest.mark.parametrize("case", sorted(MM_SPLIT_CASES))
def test_split_mm_matches_the_jax_kernel(case):
    """The f32 K9's split products, forward and dX (K9 on (g, Wᵀ, maskᵀ):
    Wᵀ's pieces are W's, transposed), row by row against the JAX
    ``block_sparse_matmul`` with ``interpret=True`` (the Pallas kernel in
    interpret mode) and ``jax.grad`` through it, at a third of the f32
    limit; a dead column block is exactly zero."""
    x, w, g, jmask, pmask = _mm_split_case(case, seed=31)
    want = J.block_sparse_matmul(jnp.asarray(x), jnp.asarray(w), jmask,
                                 interpret=True)
    dx_want = jax.grad(lambda a: jnp.sum(J.block_sparse_matmul(
        a, jnp.asarray(w), jmask, interpret=True) * jnp.asarray(g)))(
        jnp.asarray(x))
    xt, wt, gt = (torch.from_numpy(a) for a in (x, w, g))
    y = _mm_split(xt, wt, pmask)
    dx = _mm_split(gt, wt.t(), pmask.transposed())
    assert _row_rel_err(y, torch.from_numpy(np.array(want))) <= ROW_TOL / 3
    assert _row_rel_err(dx, torch.from_numpy(np.array(dx_want))) \
        <= ROW_TOL / 3
    for c in np.nonzero(~pmask.mask.any(axis=0))[0]:
        assert not y[:, c * pmask.block_k:(c + 1) * pmask.block_k].any()


def _mm_coarse_split(x, w, mask):
    """out (M, N) = x @ (W ∘ mask) as the f32 K9 forms it on the coarse
    route: W's masked copy (dead elements 0, zero-padded to whole (KC,
    BN) tiles of ``_mm_plan``'s coarse plan; ``_mm_masked``), x zero past
    K (TMA's fill), and for each BN-column tile the KC-row chunks that
    hold a live element (``_coarse_grid``), ascending, each chunk's six
    products a k16 step (``TERMS``, terms outer) into a fresh partial with
    wgmma's truncation toward zero, added to the f32 total once done."""
    K, N = w.shape
    kc, bn, coarse = P._mm_plan(torch.float32, mask.block_q, mask.block_k,
                                K, N)
    assert coarse
    grid = P._coarse_grid(mask, kc, bn)
    Kp, Np = grid.shape[0] * kc, grid.shape[1] * bn
    wm = torch.zeros(Kp, Np)
    wm[:K, :N] = torch.where(torch.from_numpy(mask.elementwise()), w,
                             torch.zeros(()))
    xp = torch.zeros(x.shape[0], Kp)
    xp[:, :K] = x
    A, B = _pieces(xp, 3), _pieces(wm, 3)
    out = torch.zeros(x.shape[0], Np)
    for c in range(grid.shape[1]):
        cols = slice(c * bn, (c + 1) * bn)
        total = torch.zeros(x.shape[0], bn)
        for t in np.nonzero(grid[:, c])[0]:
            part = torch.zeros_like(total)
            for i, j in TERMS:
                for k in range(t * kc, (t + 1) * kc, 16):
                    part = _wgmma_add(part, A[i][:, k:k + 16],
                                      B[j][k:k + 16, cols], True)
            total = total + part
        out[:, cols] = total
    return out[:, :N]


#: (M, K, N, bk, bn): block 8 (the Pallas kernel in the JAX package;
#: coarse tiles of 32 x 64 over 8 x 8 blocks, one column tile dead), bk 6
#: x bn 20 (the JAX package's dense path; tiles across block edges, N
#: padded 60 -> 64)
MM_COARSE_CASES = {"b8": (40, 128, 192, 8, 8), "b6x20": (40, 96, 60, 6, 20)}


@pytest.mark.parametrize("case", sorted(MM_COARSE_CASES))
def test_coarse_split_mm_matches_the_jax_kernel(case):
    """The f32 K9 on its coarse route (split products over coarse tiles
    of the masked W), forward and dX (K9 on (g, Wᵀ, maskᵀ)), row by row
    against the JAX ``block_sparse_matmul`` with ``interpret=True`` and
    ``jax.grad`` through it, at a third of the f32 limit; a dead coarse
    column tile is exactly zero."""
    M, K, N, bk, bn = MM_COARSE_CASES[case]
    rng = np.random.RandomState(47)
    x = rng.randn(M, K).astype(np.float32)
    w = (rng.randn(K, N) / math.sqrt(K)).astype(np.float32)
    g = rng.randn(M, N).astype(np.float32)
    m = rng.rand(K // bk, N // bn) < 0.5
    if case == "b8":
        m[:, 8:16] = False          # output columns 64..127: a dead tile
    jmask, pmask = J.BlockMask(m, bk, bn), P.BlockMask(m, bk, bn)
    want = J.block_sparse_matmul(jnp.asarray(x), jnp.asarray(w), jmask,
                                 interpret=True)
    dx_want = jax.grad(lambda a: jnp.sum(J.block_sparse_matmul(
        a, jnp.asarray(w), jmask, interpret=True) * jnp.asarray(g)))(
        jnp.asarray(x))
    xt, wt, gt = (torch.from_numpy(a) for a in (x, w, g))
    y = _mm_coarse_split(xt, wt, pmask)
    dx = _mm_coarse_split(gt, wt.t(), pmask.transposed())
    assert _row_rel_err(y, torch.from_numpy(np.array(want))) <= ROW_TOL / 3
    assert _row_rel_err(dx, torch.from_numpy(np.array(dx_want))) \
        <= ROW_TOL / 3
    if case == "b8":
        assert not y[:, 64:128].any()


def test_the_split_mm_keeps_f32_rounding():
    """The designs at the MLP column block's depth (512 live of K 1024),
    forward and dX, against x @ (W ∘ mask) in f64: a fresh partial a step
    reads what the plain f32 product reads (within 2x: 0.8-1.1e-7 against
    2.5-3.6e-7); one accumulator over all the steps, which wgmma rounds
    toward zero 192 times a sum, reads 16-45x more (1.5-4.8e-6) and leans
    one way (81-83 % of the outputs shrink, as every one of K5's did on
    the card, PERF.md PR 16), though it stays under the limit here;
    rounding to nearest in one accumulator does not lean (49-51 %)."""
    x, w, g, _, mask = _mm_split_case("depth512", seed=37)
    xt, wt, gt = (torch.from_numpy(a) for a in (x, w, g))
    for a, b, m in ((xt, wt, mask), (gt, wt.t(), mask.transposed())):
        bm = torch.where(torch.from_numpy(m.elementwise()), b,
                         torch.zeros(()))
        want = a.double() @ bm.double()
        plain = _row_rel_err(a @ bm, want)
        fresh = _mm_split(a, b, m)
        one = _mm_split(a, b, m, fresh=False)
        nearest = _mm_split(a, b, m, truncate=False, fresh=False)
        err = {name: _row_rel_err(t, want) for name, t in
               (("fresh", fresh), ("one", one), ("nearest", nearest))}
        assert plain <= 1e-6
        assert err["fresh"] <= 2 * plain
        assert err["one"] >= 10 * err["fresh"]
        assert err["one"] <= ROW_TOL / 3
        # the share of the (nonzero) outputs below the exact value in size
        nz = want != 0

        def shrunk(t):
            return ((t.double().abs() < want.abs()) & nz).sum().item() \
                / nz.sum().item()

        assert shrunk(one) >= 0.75 and 0.4 <= shrunk(nearest) <= 0.6


@pytest.mark.parametrize("layout", ["mn_major", "t_view"])
def test_the_mm_pieces_add_back_to_w_in_its_orientation(layout):
    """What the f32 K9 reads for W (``_mm_operands`` on the f32 block
    route): W's three bf16 pieces, bit for bit ``_pieces``, summing back
    to W exactly, in the orientation W is stored in: (3, K, N) MN-major
    for W as it stands, (3, N, K) K-major for a ``.t()`` view of a
    weight stored (N, K), and the same for dX's Wᵀ the other way round;
    the row pitch K9 gets is the pieces'."""
    x, w, _, _, mask = _mm_split_case("b32", seed=41)
    xt = torch.from_numpy(x)
    stored = torch.from_numpy(w)
    if layout == "t_view":
        stored = stored.t().contiguous()
    wt = stored.t() if layout == "t_view" else stored
    for b, kmajor in ((wt, int(layout == "t_view")),
                      (wt.t(), int(layout != "t_view"))):
        x2, ldx, pieces, ldw, got_kmajor = P._mm_operands(xt, b)
        assert x2 is xt and ldx == xt.shape[1] and got_kmajor == kmajor
        assert pieces.dtype == torch.bfloat16 and pieces.is_contiguous()
        assert pieces.shape == (3, *stored.shape) and ldw == stored.shape[1]
        for have, want in zip(pieces, _pieces(stored, 3)):
            assert torch.equal(have.float(), want)
        assert torch.equal(pieces.double().sum(0), stored.double())


def test_the_mm_pieces_keep_nan_in_place():
    """NaN in a dead tile of W stays NaN in all three pieces and nowhere
    else (the kernel never loads a dead tile: the card test holds the
    output bit for bit); the live tiles' pieces are those of W."""
    _, w, _, _, mask = _mm_split_case("b64", seed=43)
    live = torch.from_numpy(mask.elementwise())
    poisoned = torch.from_numpy(w).masked_fill(~live, float("nan"))
    pieces = P._mm_pieces(poisoned)
    assert torch.equal(torch.isnan(pieces), (~live).expand(3, -1, -1))
    clean = P._mm_pieces(torch.from_numpy(w))
    assert torch.equal(pieces[:, live], clean[:, live])
