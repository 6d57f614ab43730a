"""The port's block-sparse module (bigdl_tpu_torch.ops.block_sparse)
against the JAX package's, on the CPU.

* The host side (``BlockMask``, the mask builders, ``pick_block_divisor``,
  the index tables, the work accounting) gives the JAX values exactly.
* The plain versions of K6 (forward) and K7/K8 (backward) are held
  against the JAX Pallas kernels in interpret mode, and the block-sparse
  matmul against JAX ``block_sparse_matmul(..., interpret=True)``,
  forward and both gradients.
* ``MultiHeadAttention(seq_strategy="blocksparse")`` matches the JAX
  layer (GQA included), and a tiny block-sparse TransformerLM trains
  along the JAX LocalOptimizer's trajectory.

The kernels themselves are held against these plain versions on the
card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import functools
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu import nn as jnn
from bigdl_tpu import optim as joptim
from bigdl_tpu.dataset import Sample as JSample
from bigdl_tpu.dataset.dataset import array as jarray
from bigdl_tpu.models.transformer import TransformerLM as JTransformerLM
from bigdl_tpu.ops import block_sparse as J
from bigdl_tpu.optim.optimizer import LocalOptimizer as JLocalOptimizer
from bigdl_tpu.utils.rng import RNG as JRNG
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch import optim as toptim
from bigdl_tpu_torch.dataset import Sample, array
from bigdl_tpu_torch.interop import load_param_tree
from bigdl_tpu_torch.interop.jax_params import param_tree_numpy
from bigdl_tpu_torch.models.transformer import TransformerLM
from bigdl_tpu_torch.ops import block_sparse as P
from bigdl_tpu_torch.utils.rng import RNG

# The suite runs in several processes at once: one intra-op thread each
# keeps these small tensors from crowding the timing-sensitive tests.
torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-5)   # as tests/test_torch_ops.py
GRAD_TOL = dict(rtol=1e-3, atol=1e-4)


def _port(mask) -> P.BlockMask:
    return P.BlockMask(mask.mask, mask.block_q, mask.block_k)


def _same_mask(got: P.BlockMask, want):
    np.testing.assert_array_equal(got.mask, want.mask)
    assert (got.block_q, got.block_k) == (want.block_q, want.block_k)
    assert got.nnz == want.nnz and got.density == want.density


def _magnitude(n, seed, density, block):
    w = np.random.RandomState(seed).randn(n, n)
    return J.BlockMask(J.magnitude_block_mask(w, 1, 1, density).mask,
                       block, block)


# --------------------------------------------------------------------------
# host side: equal to the JAX values
# --------------------------------------------------------------------------

# builder name -> (args, kwargs), the same call on both modules
BUILDERS = {
    "sliding_causal": ("sliding_window_mask", (8, 8, 2),
                       dict(n_global=1, causal=True, block_q=32, block_k=32)),
    "sliding_noncausal": ("sliding_window_mask", (6, 9, 3),
                          dict(n_global=2, causal=False, block_q=16,
                               block_k=8)),
    "sliding_no_globals": ("sliding_window_mask", (8, 8, 1),
                           dict(causal=True)),
    "strided_causal": ("strided_mask", (8, 8, 4),
                       dict(causal=True, block_q=64, block_k=64)),
    "strided_noncausal": ("strided_mask", (5, 7, 3),
                          dict(causal=False, block_q=8, block_k=24)),
}


@pytest.mark.parametrize("case", sorted(BUILDERS))
def test_mask_builders_match_jax(case):
    name, args, kw = BUILDERS[case]
    want = getattr(J, name)(*args, **kw)
    got = getattr(P, name)(*args, **kw)
    _same_mask(got, want)
    _same_mask(got.transposed(), want.transposed())
    _same_mask(got.pruned_causal(), want.pruned_causal())
    np.testing.assert_array_equal(got.elementwise(), want.elementwise())
    assert got == P.BlockMask(want.mask, want.block_q, want.block_k)
    assert hash(got) == hash(_port(want))


@pytest.mark.parametrize("shape,block,density", [
    ((8, 8), (1, 1), 0.5), ((128, 64), (32, 32), 0.5),
    ((96, 200), (24, 40), 0.3), ((64, 64), (16, 16), 1.0)])
def test_magnitude_block_mask_matches_jax(shape, block, density):
    w = np.random.RandomState(sum(shape)).randn(*shape).astype(np.float32)
    want = J.magnitude_block_mask(w, *block, density)
    _same_mask(P.magnitude_block_mask(w, *block, density), want)
    # a tensor gives the numpy array's mask
    _same_mask(P.magnitude_block_mask(torch.from_numpy(w), *block, density),
               want)


def test_builder_errors_match_jax():
    for mod in (J, P):
        with pytest.raises(ValueError):
            mod.sliding_window_mask(4, 4, 0)
        with pytest.raises(ValueError):
            mod.strided_mask(4, 4, 0)
        with pytest.raises(ValueError):
            mod.magnitude_block_mask(np.ones((8, 8)), 3, 3, 0.5)
        with pytest.raises(ValueError):
            mod.magnitude_block_mask(np.ones((8, 8)), 2, 2, 0.0)


@pytest.mark.parametrize("n,m,target", [
    (4096, 4096, 512), (96, 96, 512), (96, 64, 512), (200, 200, 512),
    (4096, 1024, 96), (100, 30, 64), (7, 7, 512), (24, 24, 512),
    (1000, 600, 128), (13, 26, 4)])
def test_pick_block_divisor_matches_jax(n, m, target):
    assert P.pick_block_divisor(n, m, target) == \
        J.pick_block_divisor(n, m, target)


def test_pick_block_divisor_pins():
    assert P.pick_block_divisor(96, 96, 512) == 96
    assert P.pick_block_divisor(96, 64, 512) == 32
    assert P.pick_block_divisor(4096, 4096, 512) == 512


def _table_masks():
    dead = np.ones((4, 4), bool)
    dead[2] = False
    return [J.sliding_window_mask(8, 8, 2, 1, True, 32, 32),
            J.strided_mask(6, 6, 2, False, 16, 16),
            J.BlockMask(dead, 32, 32),
            _magnitude(5, 3, 0.4, 8)]


@pytest.mark.parametrize("causal", [False, True])
def test_index_tables_match_jax_on_run_and_its_transpose(causal):
    for want_mask in _table_masks():
        run_j = J._runtime_mask(want_mask, causal).mask
        run_p = P._runtime_mask(_port(want_mask), causal).mask
        np.testing.assert_array_equal(run_p, run_j)
        for m in (run_j, run_j.T):
            for a, b in zip(P._index_tables(m), J._index_tables(m)):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("train", [False, True])
def test_work_accounting_matches_jax(causal, train):
    for want_mask in _table_masks():
        got = P.attention_work(_port(want_mask), 2, 3, 32, causal=causal,
                               train=train)
        assert got == J.attention_work(want_mask, 2, 3, 32, causal=causal,
                                       train=train)
        assert P.matmul_work(_port(want_mask), 24, train=train) == \
            J.matmul_work(want_mask, 24, train=train)


def _tile_tables_brute(mask, causal):
    """(visited, partial) of the 64-row tile pairs, element by element."""
    keep = P._elementwise_keep(mask, causal, "cpu").numpy()
    el = P._runtime_mask(mask, causal).elementwise()
    T, S = keep.shape
    nq, nk = -(-T // P.TILE), -(-S // P.TILE)
    visited = np.zeros((nq, nk), bool)
    partial = np.zeros((nq, nk), bool)
    for i in range(nq):
        for j in range(nk):
            rows = slice(i * P.TILE, (i + 1) * P.TILE)
            cols = slice(j * P.TILE, (j + 1) * P.TILE)
            visited[i, j] = keep[rows, cols].any()
            partial[i, j] = visited[i, j] and not el[rows, cols].all()
    return visited, partial


def test_tile_tables_match_the_element_masks():
    """The kernels' 64-row tile tables: a pair is visited iff one of its
    elements is live, partial iff the block mask covers it in part, for
    block sizes above, below and across 64 and ragged sequence ends."""
    rng = np.random.RandomState(0)
    sizes = [1, 3, 8, 16, 32, 64, 96, 100, 128, 200]
    for _ in range(60):
        bq, bk = (int(rng.choice(sizes)) for _ in range(2))
        nq = rng.randint(1, max(2, 400 // bq))
        nk = rng.randint(1, max(2, 400 // bk))
        mask = P.BlockMask(rng.rand(nq, nk) < rng.rand(), bq, bk)
        for causal in (False, True):
            got = P._tile_tables(mask, causal)
            want = _tile_tables_brute(mask, causal)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b,
                                              err_msg=f"{mask} {causal}")


def _block_lists_brute(mask, causal, own_q, R=P.BLOCK_ROWS):
    """Per R-row block of the own side (queries for K8, keys for K7):
    [(streamed 64-row tile, flags, live-row bits)] from the element
    masks, where flags bit w marks own tile w visiting the streamed
    tile and bit 2 + w that pair partial."""
    keep = P._elementwise_keep(mask, causal, "cpu").numpy()
    el = P._runtime_mask(mask, causal).elementwise()
    if not own_q:
        keep, el = keep.T, el.T
    n_own, n_str = keep.shape
    t = P.TILE
    out = []
    for b in range(-(-n_own // R)):
        entries = []
        for j in range(-(-n_str // t)):
            cols = slice(j * t, (j + 1) * t)
            flags = 0
            for w in range(R // t):
                rows = slice(b * R + w * t, b * R + (w + 1) * t)
                vis = bool(keep[rows, cols].any())
                part = vis and not el[rows, cols].all()
                flags |= (vis << w) | (part << (2 + w))
            if flags & 3:
                live = keep[b * R:(b + 1) * R, cols].any(axis=0)
                bits = sum(1 << int(r) for r in np.nonzero(live)[0])
                entries.append((j, flags, bits if flags & 12 else 0))
        out.append(entries)
    return out


def _check_block_lists(got, want, what):
    rows = got["rows"].view(np.uint64)
    assert got["counts"].tolist() == [len(e) for e in want], what
    for b, entries in enumerate(want):
        n = len(entries)
        assert got["tiles"][b, :n].tolist() == [e[0] for e in entries], what
        assert got["flags"][b, :n].tolist() == [e[1] for e in entries], what
        assert [int(x) for x in rows[b, :n]] == [e[2] for e in entries], what
    counts = got["counts"]
    order = got["order"].tolist()
    assert sorted(order) == list(range(len(counts))), what
    # heaviest first, ties in block order
    for a, b in zip(order, order[1:]):
        assert (counts[a], -a) > (counts[b], -b), what


def test_block_lists_match_the_element_masks():
    """The bf16 K7/K8 tables: per 128-row block, the union of its two
    64-row tiles' lists, flags per warpgroup (visits, partial), the live
    streamed rows of each partial entry and the heaviest-first order,
    against a scan of the element masks, for block sizes above, below
    and across 64 and 128 and ragged sequence ends."""
    rng = np.random.RandomState(1)
    sizes = [1, 3, 8, 16, 32, 64, 96, 100, 128, 200, 256]
    for _ in range(40):
        bq, bk = (int(rng.choice(sizes)) for _ in range(2))
        nq = rng.randint(1, max(2, 520 // bq))
        nk = rng.randint(1, max(2, 520 // bk))
        mask = P.BlockMask(rng.rand(nq, nk) < rng.rand(), bq, bk)
        for causal in (False, True):
            visited, partial = P._tile_tables(mask, causal)
            dq, dkv = P._block_tables(mask, causal, visited, partial)
            what = f"{mask} causal={causal}"
            _check_block_lists(dq, _block_lists_brute(mask, causal, True),
                               "K8 " + what)
            _check_block_lists(dkv, _block_lists_brute(mask, causal, False),
                               "K7 " + what)


def _check_64_row_lists(own_q: bool, seed: int):
    """``_own_lists`` of 64-row blocks (own query rows for K8, own key
    rows for K7) against a scan of the element masks, for random masks
    at block sizes above, below and across 64; and the row count of the
    cached table."""
    rng = np.random.RandomState(seed)
    sizes = [1, 8, 32, 64, 96, 128, 200]
    what = "K8" if own_q else "K7"
    for _ in range(20):
        bq, bk = (int(rng.choice(sizes)) for _ in range(2))
        nq = rng.randint(1, max(2, 400 // bq))
        nk = rng.randint(1, max(2, 400 // bk))
        mask = P.BlockMask(rng.rand(nq, nk) < rng.rand(), bq, bk)
        for causal in (False, True):
            visited, partial = P._tile_tables(mask, causal)
            got = P._own_lists(mask, causal, visited, partial, own_q, P.TILE)
            _check_block_lists(got, _block_lists_brute(mask, causal, own_q,
                                                       P.TILE),
                               f"{what} 64-row {mask} causal={causal}")
    tab = P._attention_tables(mask, True, "cpu")
    rows = nq * bq if own_q else nk * bk
    assert tab["dq_tiles" if own_q else "dkv_tiles"]["tiles"].shape[0] \
        == -(-rows // P.TILE)


def test_key_lists_of_64_row_blocks_match_the_element_masks():
    """The bf16 K7 at head dims 192 and 256 owns 64 key rows a block: its
    lists (``dkv_tiles``) are one 64-row tile's list, flags bit 0 (visit)
    and bit 2 (partial), the live query rows of each partial entry and
    the heaviest-first order, against a scan of the element masks."""
    _check_64_row_lists(False, 2)


def test_query_lists_of_64_row_blocks_match_the_element_masks():
    """The bf16 K8 at head dims 192 and 256 owns 64 query rows a block:
    its lists (``dq_tiles``) are one 64-row tile's list, flags bit 0
    (visit) and bit 2 (partial), the live key rows of each partial entry
    and the heaviest-first order, against a scan of the element masks."""
    _check_64_row_lists(True, 3)


def _dense_sweep(T, S, causal, dkv):
    """K2's (dkv) or K3's sweep in flash_bwd.cu's DenseSweep: per block
    of 128 own rows, [(streamed tile, per-warpgroup visit bits)], and the
    blocks in launch order."""
    R, t = P.BLOCK_ROWS, P.TILE
    nb = -(-(S if dkv else T) // R)
    sweeps = []
    for b in range(nb):
        if dkv:
            begin = b * R if causal else 0
            n = -(-(T - begin) // t) if T > begin else 0
            tiles = [begin // t + i for i in range(n)]
            flags = [sum(1 << w for w in range(2)
                         if not (causal and j * t + t - 1 < b * R + t * w))
                     for j in tiles]
        else:
            k_end = min(S, (b + 1) * R) if causal else S
            tiles = list(range(-(-k_end // t)))
            flags = [sum(1 << w for w in range(2)
                         if not (causal and j * t > b * R + t * w + t - 1))
                     for j in tiles]
        sweeps.append(list(zip(tiles, flags)))
    order = list(range(nb)) if dkv else list(range(nb))[::-1]
    return sweeps, order


@pytest.mark.parametrize("block,n", [(128, 4), (256, 3), (512, 2)])
@pytest.mark.parametrize("causal", [True, False])
def test_block_lists_on_all_ones_mask_are_the_dense_sweep(block, n, causal):
    """On an all-ones mask at a 128-multiple block the bf16 K7/K8 lists
    are K2/K3's dense sweep, tile for tile and flag for flag (no partial
    pair), and under causal in K2/K3's block order: K7/K8 then run K2/K3's
    products in K2/K3's order and give their bits."""
    mask = P.BlockMask(np.ones((n, n), bool), block, block)
    T = n * block
    visited, partial = P._tile_tables(mask, causal)
    dq, dkv = P._block_tables(mask, causal, visited, partial)
    for got, is_dkv in ((dkv, True), (dq, False)):
        sweeps, order = _dense_sweep(T, T, causal, is_dkv)
        assert got["counts"].tolist() == [len(sw) for sw in sweeps]
        for b, sw in enumerate(sweeps):
            assert got["tiles"][b, :len(sw)].tolist() == [j for j, _ in sw]
            assert got["flags"][b, :len(sw)].tolist() == [f for _, f in sw]
        if causal:
            assert got["order"].tolist() == order


def test_tile_work_at_the_training_shape():
    # sliding window 2 + 1 global at block 512 over T 4096: 1120 of
    # flash's 2080 64-row tile pairs per head, none partial
    mask = P.sliding_window_mask(8, 8, 2, 1, True, 512, 512)
    assert P.tile_work(mask, True) == dict(visited=1120, partial=0,
                                           flash=2080)
    work = P.attention_work(mask, 1, 1, 128, causal=True)
    assert work["executed_vs_flash_fraction"] == pytest.approx(21 / 36)
    assert int(P._elementwise_keep(mask, True, "cpu").sum()) == 4458496


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k6_and_k8_launch_over_one_query_table(monkeypatch, dtype):
    """K6 and K8 own the same query rows and stream the same key tiles:
    in bf16 both launches pass the pointers of the one
    ``_attention_tables`` entry ``_query_tables`` names, the 128-row block
    lists (``dq_blocks``, with their block order and live rows), and the
    same ints.  In f32 K6 reads those same 128-row lists (its body is
    bf16's) while K8, whose f32 blocks own 64 query rows, reads the 64-row
    lists (``dq_tiles``, with theirs): the block mask and the ints are
    shared.  The launches are recorded on CPU tensors, not run."""
    mask = P.sliding_window_mask(8, 8, 2, 1, True, 32, 32)
    calls = {}

    def record(name, counters, fn, args, BH, device):
        calls[name] = (fn, args)

    monkeypatch.setattr(P, "_launch_heads", record)
    monkeypatch.setattr(P, "_attn_fn", lambda name, n_ptr: (name, n_ptr))
    q, k, v = (torch.zeros(1, 2, 256, 64, dtype=dtype) for _ in range(3))
    lse = torch.zeros(2, 1, 256)
    P._bs_fwd_cuda(q, k, v, mask, True, 0.125)
    P._launch_bs_dq(q, k, v, q, lse, lse.reshape(2, 256), mask, True, 0.125)
    which = P._query_tables(dtype, 64)
    assert which == ("dq_blocks" if dtype == torch.bfloat16 else "dq_tiles")
    tab = P._attention_tables(mask, True, q.device)

    def pointers(t):
        return [t["tiles"].data_ptr(), t["counts"].data_ptr(),
                t["flags"].data_ptr(), tab["block_mask"].data_ptr(),
                t["order"].data_ptr(), t["rows"].data_ptr()]

    t = tab["dq_blocks"]
    lists = pointers(t)
    want = pointers(tab[which])
    fwd_fn, fwd_args = calls["block_sparse_fwd"]
    dq_fn, dq_args = calls["block_sparse_bwd_dq"]
    # after the tensors (5 and 7): the tables, then L, the mask's shape,
    # the strides (q, k, v; and dO) and the problem's ints
    assert fwd_fn == ("bigdl_bs_fwd", 5 + 6)
    assert dq_fn == ("bigdl_bs_bwd_dq", 7 + 6)
    fwd_args, dq_args = fwd_args[5:], dq_args[7:]
    assert fwd_args[:6] == lists and dq_args[:6] == want
    assert fwd_args[6] == t["tiles"].shape[1]
    assert fwd_args[7:10] == dq_args[7:10]
    assert list(fwd_args[10]) == list(dq_args[10])[:9]
    assert fwd_args[11:] == dq_args[11:]


# --------------------------------------------------------------------------
# attention: the plain versions against the Pallas kernels in interpret
# mode
# --------------------------------------------------------------------------

def _dead_q_block():
    m = np.ones((4, 4), bool)
    m[2] = False             # q rows 64..95 attend nothing
    return J.BlockMask(m, 32, 32)


def _dead_k_block():
    m = np.eye(4, dtype=bool)
    m[:, 0] = True
    m[2, 2] = False          # k rows 64..95 are read by no query
    return J.BlockMask(m, 32, 32)


def _dead_half_block():
    m = J.sliding_window_mask(8, 8, 2, 1, True, 32, 32).mask.copy()
    m[2:4] = False           # q rows 64..127, the second half of a 128-row
    return J.BlockMask(m, 32, 32)   # block, attend nothing


# (mask factory, causal, sm_scale): T = S from the mask (128 unless the
# case says otherwise), D 32, B 1, H 2.  The last three are the shapes the
# bf16 K6 treats specially: a 128-row block one of whose 64-row halves has
# no live tile, 96-row blocks whose partial pairs straddle 128-row blocks,
# and a ragged T (200) that ends inside a 64-row tile.
ATTN_CASES = {
    "full_causal": (lambda: J.BlockMask(np.ones((4, 4), bool), 32, 32),
                    True, None),
    "full": (lambda: J.BlockMask(np.ones((4, 4), bool), 32, 32),
             False, None),
    "sliding_causal_block32": (
        lambda: J.sliding_window_mask(4, 4, 2, 1, True, 32, 32), True, None),
    "sliding_noncausal_block32": (
        lambda: J.sliding_window_mask(4, 4, 2, 0, False, 32, 32), False,
        None),
    "sliding_causal_block64": (
        lambda: J.sliding_window_mask(2, 2, 1, 1, True, 64, 64), True, None),
    "strided_causal": (lambda: J.strided_mask(4, 4, 2, True, 32, 32),
                       True, None),
    "magnitude": (lambda: _magnitude(4, 1, 0.5, 32), False, None),
    "dead_q_block": (_dead_q_block, False, None),
    "dead_k_block_causal": (_dead_k_block, True, None),
    "sm_scale": (lambda: J.sliding_window_mask(4, 4, 2, 1, True, 32, 32),
                 True, 0.37),
    "dead_half_block128_T256": (_dead_half_block, True, None),
    "block96_T384": (lambda: J.sliding_window_mask(4, 4, 2, 1, True, 96, 96),
                     True, None),
    "ragged_T200_block40": (
        lambda: J.sliding_window_mask(5, 5, 2, 1, True, 40, 40), True, None),
}


def _attn_inputs(case):
    make, causal, sm_scale = ATTN_CASES[case]
    mask = make()
    T = mask.mask.shape[0] * mask.block_q
    rng = np.random.RandomState(len(case))
    q, k, v, g = ((rng.randn(1, 2, T, 32) * 0.5).astype(np.float32)
                  for _ in range(4))
    scale = sm_scale if sm_scale is not None else 1 / math.sqrt(32)
    return q, k, v, g, mask, causal, scale


@functools.lru_cache(maxsize=None)
def _jax_attention(case):
    """(O, LSE, (dq, dk, dv)) of the Pallas kernels in interpret mode."""
    q, k, v, g, mask, causal, scale = _attn_inputs(case)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    o, lse = J._bs_fwd(jq, jk, jv, mask, causal, scale, True)
    grads = J._bs_bwd(jq, jk, jv, o, lse, jnp.asarray(g), mask, causal,
                      scale, True)
    return np.array(o), np.array(lse), tuple(map(np.array, grads))


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_block_sparse_plain_matches_pallas_interpret(case):
    q, k, v, _, mask, causal, scale = _attn_inputs(case)
    o_want, lse_want, _ = _jax_attention(case)
    o, lse = P._bs_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                   _port(mask), causal, scale)
    assert lse.shape == (2, 1, q.shape[2]) and lse.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), o_want, **TOL)
    np.testing.assert_allclose(lse.numpy(), lse_want, **TOL)


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_block_sparse_bwd_plain_matches_pallas_interpret(case):
    q, k, v, g, mask, causal, scale = _attn_inputs(case)
    o, lse, want = _jax_attention(case)
    got = P._bs_bwd_plain(*map(torch.from_numpy, (q, k, v, o, lse, g)),
                          _port(mask), causal, scale)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), b, **GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("D", [160, 256])
def test_block_sparse_wide_head_dim_plain_matches_pallas_interpret(D):
    """What the kernels above head dim 128 (the Hopper bodies at 192 and
    256, the chunked kernels above 256) must compute under a block mask:
    the plain forward and backward at D as it is, against the Pallas
    kernels in interpret mode."""
    rng = np.random.RandomState(D)
    q, k, v, g = ((rng.randn(1, 2, 128, D) * 0.5).astype(np.float32)
                  for _ in range(4))
    mask = J.sliding_window_mask(4, 4, 2, 1, True, 32, 32)
    scale = 1 / math.sqrt(D)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    o_want, lse_want = J._bs_fwd(jq, jk, jv, mask, True, scale, True)
    want = J._bs_bwd(jq, jk, jv, o_want, lse_want, jnp.asarray(g), mask,
                     True, scale, True)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    o, lse = P._bs_attention_plain(*t, _port(mask), True, scale)
    np.testing.assert_allclose(o.numpy(), np.array(o_want), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.array(lse_want), **TOL)
    got = P._bs_bwd_plain(*t, torch.from_numpy(np.array(o_want)),
                          torch.from_numpy(np.array(lse_want)),
                          torch.from_numpy(g), _port(mask), True, scale)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.array(b), **GRAD_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("case", ["sliding_causal_block32", "dead_q_block",
                                  "sm_scale"])
def test_block_sparse_autograd_runs_the_plain_backward_on_cpu(case):
    q, k, v, g, mask, causal, scale = _attn_inputs(case)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    before = (P.LAUNCHES.count, P.LAUNCHES_DKV.count, P.LAUNCHES_DQ.count)
    # a raw bool grid is accepted as the mask (blocks T // nq, S // nk)
    o = P.block_sparse_attention(*leaves, mask.mask, causal=causal,
                                 sm_scale=scale)
    got = torch.autograd.grad(o, leaves, torch.from_numpy(g))
    assert (P.LAUNCHES.count, P.LAUNCHES_DKV.count, P.LAUNCHES_DQ.count) \
        == before
    t = [torch.from_numpy(a) for a in (q, k, v)]
    o2, lse = P._bs_attention_plain(*t, _port(mask), causal, scale)
    assert torch.equal(o.detach(), o2)
    want = P._bs_bwd_plain(*t, o2, lse, torch.from_numpy(g), _port(mask),
                           causal, scale)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # and the JAX custom_vjp's gradients through the kernels
    for a, b in zip(got, _jax_attention(case)[2]):
        np.testing.assert_allclose(a.numpy(), b, **GRAD_TOL)


def test_fully_dead_q_block_gives_zero_output_and_the_lse_sentinel():
    q, k, v, g, mask, causal, scale = _attn_inputs("dead_q_block")
    t = [torch.from_numpy(a) for a in (q, k, v)]
    o, lse = P._bs_attention_plain(*t, _port(mask), causal, scale)
    assert torch.isfinite(o).all()
    assert not o[:, :, 64:96].any() and o[:, :, :64].abs().max() > 0
    assert (lse[:, 0, 64:96] == 1e30).all()
    dq, dk, dv = P._bs_bwd_plain(*t, o, lse, torch.from_numpy(g),
                                 _port(mask), causal, scale)
    assert not dq[:, :, 64:96].any()


def test_dead_key_rows_get_zero_gradients():
    q, k, v, g, mask, causal, scale = _attn_inputs("dead_k_block_causal")
    t = [torch.from_numpy(a) for a in (q, k, v)]
    o, lse = P._bs_attention_plain(*t, _port(mask), causal, scale)
    _, dk, dv = P._bs_bwd_plain(*t, o, lse, torch.from_numpy(g),
                                _port(mask), causal, scale)
    assert not dk[:, :, 64:96].any() and not dv[:, :, 64:96].any()
    assert dk[:, :, :64].abs().max() > 0


def test_nan_in_dead_kv_never_reaches_the_plain_output():
    """``tests/test_block_sparse.py``'s skip proof, for the plain
    version: NaN in every K/V row that no query may attend; the output
    and the gradients stay finite and equal the clean run's.  The plain
    version is dense, so this pins only that it masks with a select; the
    kernels' skip is pinned on the card."""
    q, k, v, g, mask, causal, scale = _attn_inputs("dead_k_block_causal")
    pm = _port(mask)
    dead = ~mask.pruned_causal().elementwise().any(axis=0)
    assert dead.any()
    kp, vp = k.copy(), v.copy()
    kp[:, :, dead] = np.nan
    vp[:, :, dead] = np.nan
    runs = []
    for kk, vv in ((k, v), (kp, vp)):
        leaves = [torch.from_numpy(a).requires_grad_() for a in (q, kk, vv)]
        o = P.block_sparse_attention(*leaves, pm, causal=causal,
                                     sm_scale=scale)
        runs.append((o.detach(),) + torch.autograd.grad(
            o, leaves, torch.from_numpy(g)))
    for clean, poisoned in zip(*runs):
        assert torch.isfinite(poisoned).all()
        assert torch.equal(poisoned, clean)
    # and the JAX kernels in interpret mode give the same output
    want = J.block_sparse_attention(jnp.asarray(q), jnp.asarray(kp),
                                    jnp.asarray(vp), mask, causal=causal,
                                    sm_scale=scale, interpret=True)
    np.testing.assert_allclose(runs[1][0].numpy(), np.asarray(want), **TOL)


def test_block_sparse_attention_keeps_bf16_and_tracks_f32():
    q, k, v, _, mask, causal, scale = _attn_inputs("sliding_causal_block32")
    t = [torch.from_numpy(a) for a in (q, k, v)]
    o32 = P.block_sparse_attention(*t, _port(mask), causal=causal)
    o16 = P.block_sparse_attention(*(a.bfloat16() for a in t), _port(mask),
                                   causal=causal)
    assert o16.dtype == torch.bfloat16
    np.testing.assert_allclose(o16.float().numpy(), o32.numpy(), atol=2e-2)


def test_block_sparse_attention_validates_like_jax():
    q = torch.zeros(1, 2, 128, 32)
    mask = P.sliding_window_mask(4, 4, 2, 1, True, 32, 32)
    with pytest.raises(ValueError):   # 128 rows not divisible by 3 blocks
        P.block_sparse_attention(q, q, q, np.ones((3, 4), bool))
    with pytest.raises(ValueError):   # 4 x 16 does not tile 128
        P.block_sparse_attention(q, q, q, P.BlockMask(mask.mask, 16, 16))
    with pytest.raises(ValueError):   # k / v heads disagree
        P.block_sparse_attention(q, torch.zeros(1, 1, 128, 32),
                                 torch.zeros(1, 1, 128, 32), mask)
    with pytest.raises(ValueError):   # not (B, H, T, D)
        P.block_sparse_attention(q[0], q[0], q[0], mask)
    with pytest.raises(ValueError):   # a tensor off the CPU and the card
        m = torch.empty(1, 2, 128, 32, device="meta")
        P.block_sparse_attention(m, m, m, mask)
    for mod, x in ((J, jnp.zeros((1, 2, 128, 32))), (P, q)):
        with pytest.raises(ValueError):
            mod.block_sparse_attention(x, x, x, np.ones((3, 4), bool))


# --------------------------------------------------------------------------
# the block-sparse matmul
# --------------------------------------------------------------------------

def _mm_case(seed, M=16, K=128, N=64, block=32, density=0.5):
    rng = np.random.RandomState(seed)
    x = rng.randn(M, K).astype(np.float32)
    w = (rng.randn(K, N) * 0.3).astype(np.float32)
    g = rng.randn(M, N).astype(np.float32)
    return x, w, g, J.magnitude_block_mask(w, block, block, density)


@pytest.mark.parametrize("shape", [(16, 128, 64, 32), (24, 64, 96, 16),
                                   (8, 256, 128, 64)])
def test_block_sparse_matmul_matches_pallas_interpret(shape):
    M, K, N, block = shape
    x, w, g, mask = _mm_case(sum(shape), M, K, N, block)
    want = J.block_sparse_matmul(jnp.asarray(x), jnp.asarray(w), mask,
                                 interpret=True)
    jgx, jgw = jax.grad(lambda a, b: jnp.sum(J.block_sparse_matmul(
        a, b, mask, interpret=True) * jnp.asarray(g)), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    xt, wt = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    before = P.LAUNCHES_MM.count
    y = P.block_sparse_matmul(xt, wt, _port(mask))
    gx, gw = torch.autograd.grad(y, (xt, wt), torch.from_numpy(g))
    assert P.LAUNCHES_MM.count == before
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), **GRAD_TOL)
    np.testing.assert_allclose(gw.numpy(), np.asarray(jgw), **GRAD_TOL)
    # structural zeros get no gradient
    assert not gw.numpy()[~mask.elementwise()].any()


def _strided(x, w, layout):
    """(x, w) as torch tensors in ``layout``: W a ``.t()`` view of an
    (N, K) tensor, x a column slice of a wider tensor, or both."""
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    if layout in ("w_t_view", "both"):
        wt = wt.t().contiguous().t()
    if layout in ("x_column_slice", "both"):
        wide = torch.zeros(x.shape[0], x.shape[1] + 12)
        wide[:, 5:5 + x.shape[1]] = xt
        xt = wide[:, 5:5 + x.shape[1]]
    return xt, wt


@pytest.mark.parametrize("layout", ["w_t_view", "x_column_slice", "both"])
def test_block_sparse_matmul_strided_layouts_match_pallas_interpret(layout):
    """A Linear-style weight stored (out, in) and viewed ``.t()``, and a
    column slice of a wider x, give the JAX kernel's forward and both
    gradients (the card reads them in place)."""
    x, w, g, mask = _mm_case(21, 24, 128, 96, 32)
    want = J.block_sparse_matmul(jnp.asarray(x), jnp.asarray(w), mask,
                                 interpret=True)
    jgx, jgw = jax.grad(lambda a, b: jnp.sum(J.block_sparse_matmul(
        a, b, mask, interpret=True) * jnp.asarray(g)), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    xt, wt = _strided(x, w, layout)
    assert not (xt.is_contiguous() and wt.is_contiguous())
    xt.requires_grad_()
    wt.requires_grad_()
    y = P.block_sparse_matmul(xt, wt, _port(mask))
    gx, gw = torch.autograd.grad(y, (xt, wt), torch.from_numpy(g))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), **GRAD_TOL)
    np.testing.assert_allclose(gw.numpy(), np.asarray(jgw), **GRAD_TOL)


@pytest.mark.parametrize("dtype,bk,bn,K,N,want", [
    # blocks that are multiples of 64: the block route, KC and BN dividing
    # the blocks (the flagship MLP's blocks first)
    (torch.bfloat16, 128, 128, 1024, 4096, (64, 128, False)),
    (torch.bfloat16, 64, 64, 256, 256, (64, 64, False)),
    (torch.bfloat16, 64, 192, 192, 384, (64, 64, False)),
    (torch.bfloat16, 256, 512, 512, 1024, (64, 128, False)),
    # multiples of 16 below 64 one way or both: the coarse route, KC and
    # BN dividing K and N (the largest that does)
    (torch.bfloat16, 32, 32, 256, 256, (64, 128, True)),
    (torch.bfloat16, 64, 32, 256, 256, (64, 128, True)),
    (torch.bfloat16, 16, 16, 64, 64, (64, 64, True)),
    (torch.bfloat16, 48, 80, 96, 160, (32, 32, True)),
    (torch.bfloat16, 96, 192, 192, 384, (64, 128, True)),
    # blocks not multiples of 16: coarse tiles, KC and BN dividing K and N
    # where some do, else covering them (N 200 padded to 256, 60 to 64)
    (torch.bfloat16, 24, 100, 96, 200, (32, 128, True)),
    (torch.bfloat16, 128, 8, 256, 64, (64, 64, True)),
    (torch.bfloat16, 8, 8, 1024, 1024, (64, 128, True)),
    (torch.bfloat16, 6, 20, 96, 60, (32, 64, True)),
    (torch.bfloat16, 8, 8, 8, 40, (16, 64, True)),
    # f32 on split products: x boxes of 4-byte elements, KC at most 32
    (torch.float32, 128, 128, 1024, 4096, (32, 128, False)),
    (torch.float32, 64, 192, 192, 384, (32, 64, False)),
    (torch.float32, 512, 512, 1024, 1024, (32, 128, False)),
    (torch.float32, 32, 32, 256, 256, (32, 128, True)),
    (torch.float32, 48, 80, 96, 160, (32, 32, True)),
    (torch.float32, 24, 100, 96, 200, (32, 128, True)),
    (torch.float32, 16, 8, 64, 64, (32, 64, True)),
    (torch.float32, 8, 8, 1024, 1024, (32, 128, True)),
    (torch.float32, 6, 20, 96, 60, (32, 64, True)),
])
def test_mm_plan_picks_the_route_and_tiles(dtype, bk, bn, K, N, want):
    """K9's route by shape, in bf16 and in f32 (six bf16 products an f32
    one): (KC, BN) over the mask's blocks on the block route (blocks that
    are multiples of 64), or over coarse tiles of the masked W on the
    coarse route (every other block); forward and dX take one route."""
    assert P._mm_plan(dtype, bk, bn, K, N) == want
    assert P._mm_plan(dtype, bn, bk, N, K).coarse == want[2]


@pytest.mark.parametrize("dtype,bk,bn,want", [
    (torch.bfloat16, 32, 32, (32, 32)),
    (torch.bfloat16, 16, 16, (16, 16)),
    (torch.bfloat16, 48, 80, (16, 16)),
    (torch.bfloat16, 96, 192, (32, 64)),
    (torch.float32, 32, 32, (32, 32)),
    (torch.float32, 48, 80, (16, 16)),
    (torch.bfloat16, 24, 100, None),
    (torch.float32, 16, 8, None),
])
def test_block_plan_takes_every_multiple_of_16(dtype, bk, bn, want):
    """The block route can take any blocks that are multiples of 16 (an
    explicit plan, as phase 3 times blocks 16 and 32 on it): KC and BN
    the largest built that divide bk and bn; None elsewhere."""
    got = P._block_plan(dtype, bk, bn)
    assert (got and tuple(got)) == (want and (*want, False))


def _record_mm(monkeypatch):
    """Record each K9 launch's pointers and ints instead of running it."""
    calls = []
    monkeypatch.setattr(P, "_mm_call",
                        lambda ptrs, ints, device: calls.append((ptrs, ints)))
    return calls


def _coarse_launches():
    return sum(c.count for c in P.LAUNCHES_MM_COARSE.values())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bs_mm_autograd_reads_w_in_place(monkeypatch, dtype):
    """The forward launches K9 on W as it stands (MN-major) and dX on
    W's own bytes read K-major: no transposed copy of W; a W stored
    (N, K) and viewed ``.t()`` is read K-major in the forward and
    MN-major in dX.  Both dtypes take the block route; in f32 K9 reads
    W's three bf16 pieces, split from W in place and laid out as W's
    storage is (so dX's pieces are W's, not Wᵀ's).  The launches are
    recorded on CPU tensors, not run."""
    calls = _record_mm(monkeypatch)
    split, pieces_of = [], P._mm_pieces

    def record_split(w):
        split.append((w, pieces_of(w)))
        return split[-1][1]

    monkeypatch.setattr(P, "_mm_pieces", record_split)
    monkeypatch.setattr(P, "on_cpu", lambda *t: False)
    mask = P.magnitude_block_mask(np.random.RandomState(3).randn(128, 192),
                                  64, 64, 0.5)
    x = torch.randn(24, 128, dtype=dtype, requires_grad=True)
    for w, fwd_kmajor in ((torch.randn(128, 192, dtype=dtype), 0),
                          (torch.randn(192, 128, dtype=dtype).t(), 1)):
        calls.clear()
        split.clear()
        w.requires_grad_()
        before = (P.LAUNCHES_MM.count, _coarse_launches(),
                  P.LAUNCHES_MM_F32.count)
        y = P.block_sparse_matmul(x, w, mask)
        torch.autograd.grad(y, (x, w), torch.ones_like(y))
        assert (P.LAUNCHES_MM.count - before[0],
                _coarse_launches() - before[1],
                P.LAUNCHES_MM_F32.count - before[2]) == (
                    2, 0, 2 if dtype == torch.float32 else 0)
        (fwd_ptrs, fwd_ints), (dx_ptrs, dx_ints) = calls
        assert fwd_ptrs[0] == x.data_ptr()
        if dtype == torch.bfloat16:
            assert not split
            assert fwd_ptrs[1] == w.data_ptr()
            assert dx_ptrs[1] == w.data_ptr()      # W in place, no copy
        else:
            # one split a launch, of W's own bytes, into pieces laid out
            # as W is stored: (3, K, N) for W, (3, N, K) for a .t() view
            stored = w.t() if fwd_kmajor else w
            assert [p.data_ptr() for _, p in split] == [fwd_ptrs[1],
                                                        dx_ptrs[1]]
            for src, pieces in split:
                assert src.data_ptr() == w.data_ptr()
                assert src.shape == stored.shape
                assert pieces.shape == (3, *stored.shape)
                assert pieces.is_contiguous()
                assert torch.equal(pieces.double().sum(0), stored.double())
        pitch = max(w.stride())
        # ints: L, M, K, N, bk, bn, ldx, ldw, kmajor, kc, bn_tile, kx,
        # nout, ldo, dtype
        kc = 64 if dtype == torch.bfloat16 else 32
        assert fwd_ints[1:4] == [24, 128, 192] and dx_ints[1:4] == [24, 192, 128]
        assert fwd_ints[6:] == [128, pitch, fwd_kmajor, kc, 64, 128, 192, 192,
                                P._DTYPE_CODE[dtype]]
        assert dx_ints[6:] == [192, pitch, 1 - fwd_kmajor, kc, 64, 192, 128,
                               128, P._DTYPE_CODE[dtype]]


def test_bs_mm_copies_only_what_its_route_cannot_read(monkeypatch):
    """x and W are read in place where their rows are contiguous: a
    column slice of x keeps its row pitch.  Both routes read x through
    TMA and copy an x whose start is not 16-byte aligned or whose row
    pitch is not a multiple of 8 elements, into rows padded to such a
    pitch (x's own columns only reach K9: kx); the coarse route always
    reads its own masked copy of W.  A W with neither dim contiguous is
    copied on the block route and read as it stands by the masked
    copy."""
    calls = _record_mm(monkeypatch)
    mask = P.BlockMask(np.ones((2, 2), bool), 32, 32)
    w = torch.zeros(64, 64, dtype=torch.bfloat16)
    block, coarse = P.MmPlan(32, 32), P.MmPlan(64, 64, True)

    def cols(pitch, start, n=64):   # columns start .. start + n - 1 of (8, pitch)
        return torch.zeros(8, pitch, dtype=torch.bfloat16)[:, start:start + n]

    # (x, route, copied, row pitch K9 gets)
    for x, plan, copied, ldx in ((cols(104, 8), block, False, 104),
                                 (cols(100, 8), block, True, 64),
                                 (cols(72, 1), block, True, 64),
                                 (cols(72, 1), coarse, True, 64),
                                 (cols(100, 8), coarse, True, 64),
                                 (cols(104, 8), coarse, False, 104)):
        calls.clear()
        P._launch_mm(x, w, mask, plan)
        ptrs, ints = calls[0]
        assert (ptrs[0] != x.data_ptr()) == copied
        assert ints[6] == ldx and ints[11] == 64
        assert (ptrs[1] == w.data_ptr()) == (plan is block)
    # K 60 (bk 6 and 20-column blocks): 120-byte rows, copied into rows of
    # 64 elements, of which K9 reads 60; W padded to the coarse tile
    calls.clear()
    x = torch.ones(8, 60, dtype=torch.bfloat16)
    mask6 = P.BlockMask(np.ones((10, 3), bool), 6, 20)
    P._launch_mm(x, torch.ones(60, 60, dtype=torch.bfloat16), mask6,
                 P._mm_plan(torch.bfloat16, 6, 20, 60, 60))
    ptrs, ints = calls[0]
    assert ptrs[0] != x.data_ptr() and ints[6] == 64
    assert ints[2:6] == [64, 64, 64, 64] and ints[9:14] == [64, 64, 60, 60, 64]
    for plan in (block, coarse):
        calls.clear()
        w_strided = torch.zeros(128, 128, dtype=torch.bfloat16)[::2, ::2]
        P._launch_mm(torch.zeros(8, 64, dtype=torch.bfloat16), w_strided,
                     mask, plan)
        ptrs, ints = calls[0]
        assert ptrs[1] != w_strided.data_ptr() and ints[7:9] == [64, 0]


def test_bs_mm_f32_copies_only_what_its_route_cannot_read(monkeypatch):
    """The f32 routes read x through TMA in f32: in place where its row
    pitch is a multiple of 4 elements and its start 16-byte aligned, else
    a copy with rows padded to such a pitch; W is never handed over as it
    is but as its three bf16 pieces (the block route's split from W's own
    bytes, the coarse route's masked copy), with the pieces' row pitch; a
    W with neither dim contiguous is split as it stands: no copy before
    the split."""
    calls = _record_mm(monkeypatch)
    mask = P.BlockMask(np.ones((2, 2), bool), 32, 32)
    w = torch.randn(64, 64)
    block, coarse = P.MmPlan(32, 32), P.MmPlan(32, 64, True)

    def cols(pitch, start):   # columns start .. start + 63 of (8, pitch)
        return torch.zeros(8, pitch)[:, start:start + 64]

    # (x, route, copied, row pitch K9 gets)
    for x, plan, copied, ldx in ((cols(100, 8), block, False, 100),
                                 (cols(98, 8), block, True, 64),
                                 (cols(72, 1), block, True, 64),
                                 (cols(72, 1), coarse, True, 64),
                                 (cols(98, 8), coarse, True, 64),
                                 (cols(100, 8), coarse, False, 100)):
        calls.clear()
        P._launch_mm(x, w, mask, plan)
        ptrs, ints = calls[0]
        assert (ptrs[0] != x.data_ptr()) == copied
        assert ints[6] == ldx
        assert ptrs[1] != w.data_ptr()
    split = []
    pieces_of = P._mm_pieces
    monkeypatch.setattr(P, "_mm_pieces",
                        lambda t: split.append(t) or pieces_of(t))
    calls.clear()
    w_strided = torch.randn(128, 128)[::2, ::2]
    P._launch_mm(torch.zeros(8, 64), w_strided, mask, block)
    ptrs, ints = calls[0]
    (src,) = split
    assert src.data_ptr() == w_strided.data_ptr()
    assert ints[7:9] == [64, 0]


def test_bs_mm_casts_w_to_x_dtype_before_the_split(monkeypatch):
    """x f32 with W bf16 (fault F5's other side): K9 splits W cast to
    f32, so its first piece is W's bits and the other two are zero; the
    output is f32 on the f32 Hopper route."""
    calls = _record_mm(monkeypatch)
    split = []
    pieces_of = P._mm_pieces
    monkeypatch.setattr(P, "_mm_pieces",
                        lambda t: split.append(pieces_of(t)) or split[-1])
    mask = P.BlockMask(np.ones((1, 1), bool), 64, 64)
    x = torch.randn(16, 64)
    w = torch.randn(64, 64).bfloat16()
    y = P._bs_mm_cuda(x, w, mask)
    (ptrs, ints), = calls
    (pieces,) = split
    assert y.dtype == torch.float32 and ptrs[0] == x.data_ptr()
    assert ptrs[1] == pieces.data_ptr() and ints[-1] == P._DTYPE_CODE[x.dtype]
    assert ints[9:11] == [32, 64]
    assert torch.equal(pieces[0], w) and not pieces[1:].any()


@pytest.mark.parametrize("shape", [
    # (K, N, bk, bn, kc, bn_tile): blocks that divide the tile, blocks
    # that straddle its edges (bk 24 under KC 64, bk 6 x bn 20), tiles
    # reaching past K and N, one coarse tile
    (1024, 1024, 8, 8, 64, 128),
    (240, 200, 24, 40, 64, 64),
    (96, 60, 6, 20, 32, 64),
    (90, 100, 6, 20, 16, 32),
    (40, 30, 8, 10, 64, 128),
])
def test_coarse_grid_is_the_or_of_the_elementwise_mask(shape):
    """The coarse route's tile grid: a (KC, BN) tile of W is live iff an
    element in it is live, the tiles laid from W's corner whatever the
    mask's blocks (brute force over the elementwise mask, zero-padded to
    whole tiles); the route's tables list exactly those tiles."""
    K, N, bk, bn, kc, bt = shape
    rng = np.random.RandomState(K + N)
    m = rng.rand(K // bk, N // bn) < 0.3
    m[:, 0] = False                 # a dead first column block
    mask = P.BlockMask(m, bk, bn)
    Kp, Np = -(-K // kc) * kc, -(-N // bt) * bt
    e = np.zeros((Kp, Np), bool)
    e[:K, :N] = mask.elementwise()
    want = e.reshape(Kp // kc, kc, Np // bt, bt).any(axis=(1, 3))
    got = P._coarse_grid(mask, kc, bt)
    assert got.dtype == bool and np.array_equal(got, want)
    tiles, counts = P._mm_tables(mask, P.MmPlan(kc, bt, True), "cpu")
    for c in range(Np // bt):
        live = np.nonzero(want[:, c])[0]
        assert counts[c] == live.size
        assert np.array_equal(tiles[c, :live.size].numpy(), live)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("layout", ["mn_major", "t_view"])
def test_the_masked_operand_keeps_live_bits_and_zeros_the_rest(dtype,
                                                               layout):
    """The coarse route's copy of W (``_mm_masked``) for the forward's W
    and dX's Wᵀ, W as it stands or a ``.t()`` view of a weight stored
    (N, K): laid out as W's storage is (K-major for a ``.t()`` view: its
    rows are W's columns), padded with zeros to whole coarse tiles, every
    dead element exactly 0 though NaN and inf are planted in W's dead
    blocks, every live element W's bits; in f32 its three bf16 pieces,
    which add back to W ∘ mask exactly."""
    K, N, bk, bn = 96, 60, 6, 20
    rng = np.random.RandomState(5)
    m = rng.rand(K // bk, N // bn) < 0.5
    m[0, :] = True
    m[:, 1] = False
    mask = P.BlockMask(m, bk, bn)
    live = torch.from_numpy(mask.elementwise())
    w = torch.from_numpy(rng.randn(K, N).astype(np.float32)).to(dtype)
    poisoned = w.masked_fill(~live, float("nan"))
    poisoned[~live & (torch.arange(N) % 2 == 0)] = float("inf")
    w_masked = torch.where(live, w, torch.zeros((), dtype=dtype))
    if layout == "t_view":
        poisoned = poisoned.t().contiguous().t()
    for b, bmask, want in ((poisoned, mask, w_masked),
                           (poisoned.t(), mask.transposed(), w_masked.t())):
        plan = P._mm_plan(dtype, bmask.block_q, bmask.block_k, *b.shape)
        assert plan.coarse
        w_op, ldw, kmajor = P._mm_masked(b, bmask, plan)
        # K-major where b's storage runs along its K dim (bᵀ's rows)
        assert kmajor == int(b.stride(0) < b.stride(1))
        stored = want.t() if kmajor else want
        Kp = -(-b.shape[0] // plan.kc) * plan.kc
        Np = -(-b.shape[1] // plan.bn) * plan.bn
        rows, cols = (Np, Kp) if kmajor else (Kp, Np)
        pieces = w_op if dtype == torch.float32 else w_op[None]
        assert pieces.dtype == torch.bfloat16 and pieces.is_contiguous()
        assert pieces.shape == (3 if dtype == torch.float32 else 1, rows,
                                cols) and ldw == cols
        assert torch.isfinite(pieces.float()).all()
        R, C = stored.shape
        assert not pieces[:, R:].any() and not pieces[:, :, C:].any()
        if dtype == torch.float32:
            assert torch.equal(pieces[:, :R, :C].double().sum(0),
                               stored.double())
            p1 = stored.to(torch.bfloat16)
            assert torch.equal(pieces[0, :R, :C], p1)
        else:
            assert torch.equal(pieces[0, :R, :C], stored)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bs_mm_coarse_route_launches_at_block_8(monkeypatch, dtype):
    """block_sparse_matmul at block 8 under autograd: the forward and dX
    each launch K9 once, both on the coarse route, carrying the coarse
    tile as the blocks (K and N padded up to it, x's own K and the
    output's N beside them) and the masked copy of W (or of Wᵀ, laid out
    as W's storage, K-major) as the B operand, written first, once a
    launch.  Recorded on CPU tensors, not run."""
    calls = _record_mm(monkeypatch)
    masked = []
    monkeypatch.setattr(
        P, "_mm_mask_call",
        lambda ptrs, ints, strides, device: masked.append((ptrs, ints,
                                                           strides)))
    monkeypatch.setattr(P, "on_cpu", lambda *t: False)
    M, K, N = 24, 200, 136
    w = torch.randn(K, N, dtype=dtype, requires_grad=True)
    mask = P.magnitude_block_mask(w.detach().float().numpy(), 8, 8, 0.5)
    x = torch.randn(M, K, dtype=dtype, requires_grad=True)
    before = (P.LAUNCHES_MM.count, P.LAUNCHES_MM_COARSE[dtype].count,
              P.LAUNCHES_MM_F32.count, P.LAUNCHES_MM_MASK.count)
    y = P.block_sparse_matmul(x, w, mask)
    torch.autograd.grad(y, (x, w), torch.ones_like(y))
    assert (P.LAUNCHES_MM.count - before[0],
            P.LAUNCHES_MM_COARSE[dtype].count - before[1],
            P.LAUNCHES_MM_F32.count - before[2],
            P.LAUNCHES_MM_MASK.count - before[3]) == (2, 2, 0, 2)
    code = P._DTYPE_CODE[dtype]
    (fwd_ptrs, fwd_ints), (dx_ptrs, dx_ints) = calls
    kc, bt = P.MM_COARSE_TILE[dtype]
    for (ptrs, ints), (mptrs, mints, strides), (Ko, No, kmajor) in zip(
            calls, masked, ((K, N, 0), (N, K, 1))):
        # neither 200 nor 136 is a multiple of 16: the largest tile,
        # W's copy padded to it
        plan = P._mm_plan(dtype, 8, 8, Ko, No)
        assert plan == (kc, bt, True)
        Kp, Np = -(-Ko // kc) * kc, -(-No // bt) * bt
        rows, cols = (Np, Kp) if kmajor else (Kp, Np)
        # ints: L, M, K, N, bk, bn, ldx, ldw, kmajor, kc, bn_tile, kx,
        # nout, ldo, dtype
        assert ints[1:9] == [M, Kp, Np, plan.kc, plan.bn, Ko, cols, kmajor]
        assert ints[9:] == [plan.kc, plan.bn, Ko, No,
                            Np if dtype == torch.float32 else No, code]
        # the masked copy: src (W's storage), dst, grid; R, C, Rp, Cp, br,
        # bc, ngc, dtype; W's element strides
        assert mptrs[0] == w.data_ptr() and mptrs[1] == ptrs[1]
        assert mints == [K, N, rows, cols, 8, 8, N // 8, code]
        assert strides == (N, 1)
    assert fwd_ptrs[0] == x.data_ptr()


def _record_attention(monkeypatch):
    """Record each attention launch (C entry name, arguments) instead of
    building and running it."""
    from bigdl_tpu_torch.ops import flash_attention as fa
    calls = []
    for mod in (fa, P):
        monkeypatch.setattr(mod, "_c_fn", lambda lib, name, argtypes: name)
    monkeypatch.setattr(fa, "_call", lambda name, fn, args, device:
                        calls.append((fn, args)))
    return calls


def test_head_strided_operands_reach_the_block_sparse_kernels_in_place(
        monkeypatch):
    """bf16 q, k, v and dO in the (B, T, H, D).transpose(1, 2) layout
    reach K6, K7 and K8 as they stand (the same data pointers, their own
    strides), with K7 on the 128-row lists; the outputs are
    contiguous."""
    calls = _record_attention(monkeypatch)
    B, T, H, D = 2, 128, 4, 64
    q, k, v, d_o = (torch.randn(B, T, H, D).bfloat16().transpose(1, 2)
                    for _ in range(4))
    mask = P.sliding_window_mask(4, 4, 2, 1, True, 32, 32)
    o, lse = P._bs_fwd_cuda(q, k, v, mask, True, 0.125)
    grads = P._bs_bwd_cuda(q, k, v, o, lse, d_o, mask, True, 0.125)
    assert [c[0] for c in calls] == ["bigdl_bs_fwd", "bigdl_bs_bwd_dkv",
                                     "bigdl_bs_bwd_dq"]
    want = [T * H * D, D, H * D]
    (_, fwd), (_, dkv), (_, dq) = calls
    assert fwd[:3] == [t.data_ptr() for t in (q, k, v)]
    assert list(fwd[15]) == want * 3
    for args, n in ((dkv, 8), (dq, 7)):
        assert args[:4] == [t.data_ptr() for t in (q, k, v, d_o)]
        assert list(args[n + 10]) == want * 4
    tab = P._attention_tables(mask, True, q.device)
    assert dkv[8] == tab["dkv_blocks"]["tiles"].data_ptr()
    for t in (o, *grads):
        assert t.shape == (B, H, T, D) and t.is_contiguous()


def test_f32_k7_reads_64_row_key_lists_and_its_operands_in_place(
        monkeypatch):
    """In f32, K7 runs K2's f32 body over the 64-row key lists
    (``dkv_tiles``, with their block order and live rows) and K8 K3's f32
    body over the 64-row query lists (``dq_tiles``, with theirs); both
    read a head-strided q, k, v and dO in place, no copy."""
    from bigdl_tpu_torch.ops import flash_attention as fa
    calls = _record_attention(monkeypatch)
    B, T, H, D = 2, 128, 4, 64
    q, k, v, d_o = (torch.randn(B, T, H, D).transpose(1, 2)
                    for _ in range(4))
    mask = P.sliding_window_mask(4, 4, 2, 1, True, 32, 32)
    o, lse = torch.zeros(B, H, T, D), torch.zeros(B * H, 1, T)
    copies = fa.OPERAND_COPIES.count
    grads = P._bs_bwd_cuda(q, k, v, o, lse, d_o, mask, True, 0.125)
    assert fa.OPERAND_COPIES.count == copies
    (dkv_fn, dkv), (dq_fn, dq) = calls
    assert (dkv_fn, dq_fn) == ("bigdl_bs_bwd_dkv", "bigdl_bs_bwd_dq")
    tab = P._attention_tables(mask, True, q.device)
    # after the tensors (8 and 7): tiles, counts, flags, the block mask,
    # order, rows; the strides after L and the mask's shape
    for args, n, name in ((dkv, 8, "dkv_tiles"), (dq, 7, "dq_tiles")):
        t = tab[name]
        assert args[:4] == [t_.data_ptr() for t_ in (q, k, v, d_o)]
        assert args[n:n + 6] == [
            t["tiles"].data_ptr(), t["counts"].data_ptr(),
            t["flags"].data_ptr(), tab["block_mask"].data_ptr(),
            t["order"].data_ptr(), t["rows"].data_ptr()]
        assert list(args[n + 10]) == [T * H * D, D, H * D] * 4
    for g in grads:
        assert g.shape == (B, H, T, D) and g.is_contiguous()


@pytest.mark.parametrize("D,runs", [(160, 192), (200, 256), (256, 256)])
def test_wide_bf16_head_dims_run_k6_k7_on_64_row_key_lists(monkeypatch, D,
                                                          runs):
    """bf16 head dims 129-256 pad to 192 or 256: K6 over the 128-row query
    lists, K7 over the 64-row key lists (``dkv_tiles``) of its 64-row
    blocks, and K8 over the 64-row query lists (``dq_tiles``) of its
    64-row blocks, each with its lists' order and live rows."""
    calls = _record_attention(monkeypatch)
    q, k, v, d_o = (torch.zeros(1, 2, 128, D, dtype=torch.bfloat16)
                    for _ in range(4))
    mask = P.sliding_window_mask(4, 4, 2, 1, True, 32, 32)
    o, lse = P._bs_fwd_cuda(q, k, v, mask, True, 0.1)
    grads = P._bs_bwd_cuda(q, k, v, o, lse, d_o, mask, True, 0.1)
    assert [c[0] for c in calls] == ["bigdl_bs_fwd", "bigdl_bs_bwd_dkv",
                                     "bigdl_bs_bwd_dq"]
    assert [c[1][-4] for c in calls] == [runs] * 3
    tab = P._attention_tables(mask, True, q.device)
    # after the tensors (5, 8 and 7): tiles, counts, flags, the block
    # mask, order, rows
    for (_, args), n, which in zip(calls, (5, 8, 7),
                                   ("dq_blocks", "dkv_tiles", "dq_tiles")):
        t = tab[which]
        assert args[n:n + 6] == [t["tiles"].data_ptr(),
                                 t["counts"].data_ptr(),
                                 t["flags"].data_ptr(),
                                 tab["block_mask"].data_ptr(),
                                 t["order"].data_ptr(), t["rows"].data_ptr()]
    for t in (o, *grads):
        assert t.shape == (1, 2, 128, D)


@pytest.mark.parametrize("D,dtype,fwd,bwd", [
    (160, torch.float32, 192, 192), (200, torch.float32, 256, 256),
    (256, torch.float32, 256, 256), (320, torch.float32, None, None),
    (320, torch.bfloat16, None, None), (300, torch.float32, None, None),
    (512, torch.bfloat16, None, None)])
def test_wide_head_dims_route_the_block_sparse_passes(monkeypatch, D, dtype,
                                                      fwd, bwd):
    """The passes route by the same built head dims, as in
    ``flash_attention``: f32 head dims 129-256 pad to 192 or 256 for K6
    (over the 128-row query lists, with their order and live rows), K7
    (over the 64-row key lists) and K8 (over the 64-row query lists);
    above 256, in both dtypes, K6 runs the chunked forward over the same
    128-row query lists at D zero-padded to a multiple of 64, and dK/dV
    and dQ the chunked backward over the 64-row key and query lists at
    the same padded D (counted under ``LAUNCHES_CHUNKED``,
    ``LAUNCHES_DKV_CHUNKED`` and ``LAUNCHES_DQ_CHUNKED`` for its dtype),
    every launch with its lists' order and live rows.  ``fwd`` and
    ``bwd`` are the head dims the Hopper kernels run at (None: above the
    built ones).  An f32 launch of each pass at 192 or 256 also counts
    under that pass's counter for the head dim."""
    calls = _record_attention(monkeypatch)
    q, k, v, d_o = (torch.zeros(1, 2, 128, D, dtype=dtype)
                    for _ in range(4))
    mask = P.sliding_window_mask(4, 4, 2, 1, True, 32, 32)
    counters = (P.LAUNCHES_F32, P.LAUNCHES_DKV_F32, P.LAUNCHES_DQ_F32)
    per_dim = [{d: c.count for d, c in by.items()} for by in counters]
    chunked_counters = (P.LAUNCHES_CHUNKED, P.LAUNCHES_DKV_CHUNKED,
                        P.LAUNCHES_DQ_CHUNKED)
    chunked = [{dt: c.count for dt, c in by.items()}
               for by in chunked_counters]
    o, lse = P._bs_fwd_cuda(q, k, v, mask, True, 0.1)
    grads = P._bs_bwd_cuda(q, k, v, o, lse, d_o, mask, True, 0.1)
    for by, before, at in zip(counters, per_dim, (fwd, bwd, bwd)):
        assert {d: c.count - before[d] for d, c in by.items()} == {
            d: int(d == at) for d in before}
    for by, before in zip(chunked_counters, chunked):
        assert {dt: c.count - before[dt] for dt, c in by.items()} == {
            dt: int(dt == dtype and fwd is None) for dt in before}
    assert [c[0] for c in calls] == ["bigdl_bs_fwd", "bigdl_bs_bwd_dkv",
                                     "bigdl_bs_bwd_dq"]
    tab = P._attention_tables(mask, True, q.device)
    grid = tab["block_mask"].data_ptr()
    # after the tensors (5, 8 and 7): tiles, counts, flags, the block
    # mask, order, rows; last the head dim, the dtype, sm_scale, causal
    padded = -(-D // 64) * 64
    for (name, args), at, n, which in zip(
            calls, (fwd or padded, bwd or padded, bwd or padded), (5, 8, 7),
            ("dq_blocks", "dkv_tiles", "dq_tiles")):
        t = tab[which]
        assert args[n:n + 6] == [t["tiles"].data_ptr(),
                                 t["counts"].data_ptr(),
                                 t["flags"].data_ptr(), grid,
                                 t["order"].data_ptr(), t["rows"].data_ptr()]
        assert args[-4:] == [at, P._DTYPE_CODE[dtype], 0.1, 1]
    for t in (o, *grads):
        assert t.shape == (1, 2, 128, D)


def test_bs_mm_casts_w_to_x_dtype_on_the_card(monkeypatch):
    """x bf16 with W f32: K9 gets W cast to bf16 (the bf16 Hopper route,
    out in x's dtype), as the plain version returns x's dtype."""
    calls = _record_mm(monkeypatch)
    mask = P.BlockMask(np.ones((1, 1), bool), 64, 64)
    x = torch.randn(16, 64).bfloat16()
    w = torch.randn(64, 64)
    y = P._bs_mm_cuda(x, w, mask)
    (ptrs, ints), = calls
    assert y.dtype == torch.bfloat16 and ptrs[0] == x.data_ptr()
    assert ptrs[1] != w.data_ptr() and ints[-1] == P._DTYPE_CODE[x.dtype]
    assert ints[9:11] == [64, 64]      # the block route's KC, BN


def test_block_sparse_matmul_mixed_dtypes_match_pallas_interpret():
    """x bf16 (16, 64) with W f32 (64, 64) under an all-ones 2 x 2 mask:
    the port's CPU path against the reference's kernel path in interpret
    mode, both in x's dtype."""
    rng = np.random.RandomState(12)
    x = rng.randn(16, 64).astype(np.float32)
    w = rng.randn(64, 64).astype(np.float32)
    mask = J.BlockMask(np.ones((2, 2), bool), 32, 32)
    want = J.block_sparse_matmul(jnp.asarray(x).astype(jnp.bfloat16),
                                 jnp.asarray(w), mask, interpret=True)
    assert want.dtype == jnp.bfloat16
    got = P.block_sparse_matmul(torch.from_numpy(x).bfloat16(),
                                torch.from_numpy(w), _port(mask))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2 ** -7, atol=1e-6)


def test_block_sparse_matmul_ignores_nan_in_dead_tiles():
    x, w, _, mask = _mm_case(9, 8, 64, 64, 32)
    clean = P.block_sparse_matmul(torch.from_numpy(x), torch.from_numpy(w),
                                  _port(mask))
    wp = w.copy()
    wp[~mask.elementwise()] = np.nan
    poisoned = P.block_sparse_matmul(torch.from_numpy(x),
                                     torch.from_numpy(wp), _port(mask))
    assert torch.isfinite(poisoned).all() and torch.equal(poisoned, clean)


def test_block_sparse_matmul_leading_dims_and_raw_mask():
    rng = np.random.RandomState(10)
    x = rng.randn(2, 8, 64).astype(np.float32)
    w = rng.randn(64, 64).astype(np.float32)
    mask = J.magnitude_block_mask(w, 32, 32, 0.25)
    want = J.block_sparse_matmul(jnp.asarray(x), jnp.asarray(w), mask,
                                 interpret=True)
    y = P.block_sparse_matmul(torch.from_numpy(x), torch.from_numpy(w),
                              mask.mask)
    assert y.shape == (2, 8, 64)
    np.testing.assert_allclose(y.numpy(), np.asarray(want), **TOL)


def test_block_sparse_matmul_bf16_keeps_dtypes():
    x, w, g, mask = _mm_case(11)
    xt = torch.from_numpy(x).bfloat16().requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    y = P.block_sparse_matmul(xt, wt, _port(mask))
    assert y.dtype == torch.bfloat16
    gx, gw = torch.autograd.grad(y, (xt, wt), torch.from_numpy(g).bfloat16())
    assert gx.dtype == torch.bfloat16 and gw.dtype == torch.float32
    ref = torch.from_numpy(x) @ (torch.from_numpy(w)
                                 * torch.from_numpy(mask.elementwise()))
    np.testing.assert_allclose(y.detach().float().numpy(), ref.numpy(), rtol=2e-2,
                               atol=5e-2)


def test_block_sparse_matmul_shape_errors_match_jax():
    w = np.zeros((64, 96), np.float32)
    x = np.zeros((4, 64), np.float32)
    for mod, conv in ((J, jnp.asarray), (P, torch.from_numpy)):
        with pytest.raises(ValueError):   # 96 columns not divisible by 5
            mod.block_sparse_matmul(conv(x), conv(w), np.ones((2, 5), bool))
        with pytest.raises(ValueError):   # 2 x 32 tiles 64 rows, 3 x 16 not 96
            mod.block_sparse_matmul(conv(x), conv(w),
                                    mod.BlockMask(np.ones((2, 3), bool),
                                                  32, 16))
    with pytest.raises(ValueError):       # x's last dim is not K
        P.block_sparse_matmul(torch.zeros(4, 32), torch.from_numpy(w),
                              np.ones((2, 3), bool))
    with pytest.raises(ValueError):       # w is not 2-D
        P.block_sparse_matmul(torch.zeros(4, 64), torch.zeros(2, 64, 96),
                              np.ones((2, 3), bool))


def test_ops_package_exports_the_block_sparse_names():
    from bigdl_tpu import ops as jops
    from bigdl_tpu_torch import ops as tops

    for name in ("BlockMask", "block_sparse_attention", "block_sparse_matmul",
                 "magnitude_block_mask", "sliding_window_mask",
                 "strided_mask"):
        assert hasattr(jops, name) and getattr(tops, name) is getattr(P, name)


# --------------------------------------------------------------------------
# the layer and the model
# --------------------------------------------------------------------------

def _numpy_tree(jax_module):
    return jax.tree_util.tree_map(np.asarray, jax_module.param_tree())


@pytest.mark.parametrize("kw", [
    dict(sparse_window=2, sparse_globals=1, block_size=32),
    dict(sparse_window=8, sparse_globals=0, block_size=32),
    dict(sparse_pattern="strided", sparse_stride=2, sparse_block=16),
])
@pytest.mark.parametrize("kv_heads", [None, 2])
def test_multi_head_attention_blocksparse_matches_jax(kw, kv_heads):
    x = np.random.RandomState(6).randn(2, 128, 32).astype(np.float32)
    args = dict(causal=True, seq_strategy="blocksparse",
                num_kv_heads=kv_heads, **kw)
    jm = jnn.MultiHeadAttention(32, 4, **args)
    tm = tnn.MultiHeadAttention(32, 4, device="cpu", **args)
    load_param_tree(tm, _numpy_tree(jm))
    jm.evaluate()
    want = np.asarray(jm.forward(jnp.asarray(x)))
    with torch.no_grad():
        got = tm.evaluate()(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    _same_mask(tm.block_mask(128, 128), jm.block_mask(128, 128))
    assert tm.block_mask(128, 128) is tm.block_mask(128, 128)


def test_multi_head_attention_blocksparse_validation():
    with pytest.raises(ValueError):
        tnn.MultiHeadAttention(32, 4, seq_strategy="blocksparse",
                               sparse_pattern="nope", device="cpu")
    # "block" is ported (tests/test_torch_remat.py); the distributed
    # strategies still raise
    for strategy in ("ring", "ulysses"):
        with pytest.raises(NotImplementedError):
            tnn.MultiHeadAttention(32, 4, seq_strategy=strategy,
                                   device="cpu")


# the trajectory: V 64, D 32, 2 heads, 2 layers, T 64, B 4, 16 samples,
# 6 iterations (an epoch is 4: the run crosses a shuffle)
V, D, HEADS, LAYERS, T_LEN, BATCH, N_SAMPLES, ITERS = 64, 32, 2, 2, 64, 4, 16, 6
LM_KW = dict(embed_dim=D, num_heads=HEADS, num_layers=LAYERS, max_len=T_LEN,
             seq_strategy="blocksparse", output="logits",
             blocksparse={"window": 2, "globals": 1, "block": 16})
TRAJ_RTOL = 2e-3   # as tests/test_torch_training.py


def _run(opt, optim_pkg, rng):
    losses = []

    def check(state):
        if "loss" in state:
            losses.append(state["loss"])
        return optim_pkg.max_iteration(ITERS)(state)

    opt.set_optim_method(optim_pkg.SGD(0.05, momentum=0.9))
    opt.set_end_when(optim_pkg.Trigger(check))
    rng().set_seed(1)
    opt.optimize()
    return losses


def test_blocksparse_lm_trajectory_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.randint(1, V + 1, size=(N_SAMPLES, T_LEN)).astype(np.int32)
    y = rng.randint(1, V + 1, size=(N_SAMPLES, T_LEN)).astype(np.int32)
    jmodel = JTransformerLM(V, **LM_KW)
    tmodel = TransformerLM(V, **LM_KW, device="cpu")
    load_param_tree(tmodel, _numpy_tree(jmodel))
    mha = tmodel.blocks[0][1]
    assert mha.seq_strategy == "blocksparse"
    _same_mask(mha.block_mask(T_LEN, T_LEN),
               J.sliding_window_mask(4, 4, 2, 1, True, 16, 16))

    jopt = JLocalOptimizer(
        jmodel, jarray([JSample(a, b) for a, b in zip(x, y)]),
        jnn.TimeDistributedCriterion(jnn.CrossEntropyCriterion(), True),
        batch_size=BATCH)
    topt = toptim.LocalOptimizer(
        tmodel, array([Sample(a, b) for a, b in zip(x, y)]),
        tnn.TimeDistributedCriterion(tnn.CrossEntropyCriterion(), True),
        batch_size=BATCH)
    jlosses = _run(jopt, joptim, JRNG)
    tlosses = _run(topt, toptim, RNG)

    assert len(tlosses) == len(jlosses) == ITERS
    assert topt.skipped_steps == jopt.skipped_steps == 0
    np.testing.assert_allclose(tlosses, jlosses, rtol=TRAJ_RTOL)
    want = jax.tree_util.tree_flatten_with_path(_numpy_tree(jmodel))[0]
    got = jax.tree_util.tree_leaves(param_tree_numpy(tmodel))
    assert len(want) == len(got)
    for (path, w), g in zip(want, got):
        # atol 1e-6: bk's gradient is zero in exact arithmetic (a shift
        # of each score row, which the softmax cancels); both sides hold
        # only rounding noise there
        np.testing.assert_allclose(g, w, rtol=TRAJ_RTOL, atol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))
