"""The port's Tensor facade (bigdl_tpu_torch.tensor) against the JAX
package's: the twelve cases of ``tests/test_tensor.py``, each run through
both facades on the same numpy inputs and held to the same answers —
bit for bit where the reference test asks for exact values, at 1e-5
relative for the products.  Beyond the JAX facade, whose arrays are
immutable, the port's ``select``/``narrow``/``transpose`` are views that
write through, as in Torch.
"""
import numpy as np
import torch

from bigdl_tpu import tensor as J
from bigdl_tpu_torch import tensor as P

torch.set_num_threads(1)

CPU = dict(device="cpu")


def test_construction_and_shape():
    for t in (J.Tensor(2, 3), P.Tensor(2, 3, **CPU)):
        assert t.size() == (2, 3)
        assert t.size(1) == 2 and t.size(2) == 3
        assert t.dim() == 2
        assert t.n_element() == 6


def test_select_narrow_1based():
    a = np.arange(12).reshape(3, 4)
    for t in (J.tensor(a), P.tensor(a, **CPU)):
        assert t.select(1, 2).numpy().tolist() == [4, 5, 6, 7]
        nar = t.narrow(2, 2, 2)
        assert nar.shape == (3, 2)
        assert nar.numpy()[0].tolist() == [1, 2]


def test_transpose_view():
    a = np.arange(6).reshape(2, 3)
    for t in (J.tensor(a), P.tensor(a, **CPU)):
        assert t.transpose(1, 2).shape == (3, 2)
        assert t.view(3, 2).shape == (3, 2)
    j, p = J.tensor(a), P.tensor(a, **CPU)
    np.testing.assert_array_equal(p.transpose(1, 2).numpy(),
                                  j.transpose(1, 2).numpy())
    np.testing.assert_array_equal(p.view(3, 2).numpy(), j.view(3, 2).numpy())


def test_math_inplace_semantics():
    for mod, kw in ((J, {}), (P, CPU)):
        t = mod.ones(2, 2, **kw)
        t.add(1.0)
        assert t.numpy().tolist() == [[2, 2], [2, 2]]
        t.mul(mod.tensor(np.full((2, 2), 3.0), **kw))
        assert float(t.sum()) == 24.0
        t2 = mod.ones(2, 2, **kw).axpy(2.0, mod.ones(2, 2, **kw))
        assert float(t2.max()) == 3.0


def test_addmm_matches_numpy():
    rng = np.random.RandomState(0)
    a = rng.rand(3, 4).astype(np.float32)
    b = rng.rand(4, 5).astype(np.float32)
    c = rng.rand(3, 5).astype(np.float32)
    want = J.tensor(c.copy()).addmm(0.5, J.tensor(c), 2.0, J.tensor(a),
                                    J.tensor(b)).numpy()
    got = P.tensor(c.copy(), **CPU).addmm(
        0.5, P.tensor(c, **CPU), 2.0, P.tensor(a, **CPU),
        P.tensor(b, **CPU)).numpy()
    np.testing.assert_allclose(got, 0.5 * c + 2.0 * a @ b, rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_max_with_dim_returns_1based_indices():
    a = np.array([[1.0, 5.0, 2.0], [7.0, 0.0, 3.0]])
    for t in (J.tensor(a), P.tensor(a, **CPU)):
        vals, idx = t.max(2)
        assert vals.numpy().flatten().tolist() == [5.0, 7.0]
        assert idx.numpy().flatten().tolist() == [2.0, 1.0]
        vals, idx = t.min(1)
        assert vals.numpy().flatten().tolist() == [1.0, 0.0, 2.0]
        assert idx.numpy().flatten().tolist() == [1.0, 2.0, 1.0]


def test_topk_ascending():
    a = np.array([3.0, 1.0, 2.0, 5.0])
    for t in (J.tensor(a), P.tensor(a, **CPU)):
        vals, idx = t.topk(2)
        assert vals.numpy().tolist() == [1.0, 2.0]
        assert idx.numpy().tolist() == [2.0, 3.0]
        vals, idx = t.topk(2, increase=False)
        assert vals.numpy().tolist() == [5.0, 3.0]
        assert idx.numpy().tolist() == [4.0, 1.0]


def test_arange_inclusive():
    assert J.arange(1, 5).numpy().tolist() == [1, 2, 3, 4, 5]
    assert P.arange(1, 5, **CPU).numpy().tolist() == [1, 2, 3, 4, 5]
    assert P.range_(0, 1, 0.5, **CPU).numpy().tolist() == [0, 0.5, 1]


def test_unfold():
    a = np.arange(7).astype(np.float32)
    for t in (J.tensor(a), P.tensor(a, **CPU)):
        u = t.unfold(1, 3, 2)
        assert u.shape == (3, 3)
        assert u.numpy()[1].tolist() == [2, 3, 4]


def test_fill_zero_copy():
    for mod, kw in ((J, {}), (P, CPU)):
        t = mod.ones(2, 2, **kw)
        t.zero()
        assert float(t.sum()) == 0.0
        t.copy(mod.ones(2, 2, **kw))
        assert float(t.sum()) == 4.0


def test_gather_scatter():
    a = np.arange(6).reshape(2, 3).astype(np.float32)
    idx = np.array([[1.0, 3.0]])
    for mod, kw in ((J, {}), (P, CPU)):
        t = mod.tensor(a, **kw)
        assert t.gather(2, mod.tensor(idx, **kw)).numpy().tolist() \
            == [[0.0, 2.0]]
    # one index row per row of the tensor: numpy's put_along_axis (the
    # JAX facade) would broadcast a single row over all of them
    idx2 = np.array([[1.0, 3.0], [2.0, 1.0]])
    src = np.array([[9.0, 8.0], [7.0, 6.0]])
    want = J.tensor(a).scatter(2, J.tensor(idx2), J.tensor(src)).numpy()
    got = P.tensor(a, **CPU).scatter(2, P.tensor(idx2, **CPU),
                                     P.tensor(src, **CPU)).numpy()
    np.testing.assert_array_equal(got, want)


def test_bf16_roundtrip():
    t = P.randn(4, 4, **CPU)
    b = t.to_bf16()
    assert b.dtype == torch.bfloat16
    assert t.almost_equal(b.to_f32(), 0.05)
    j = J.tensor(t.numpy())
    np.testing.assert_array_equal(
        b.to_f32().numpy(), np.asarray(j.to_bf16().to_f32().numpy()))


# --------------------------------------------------------------------------
# beyond test_tensor.py: Torch's view semantics and the explicit generator
# --------------------------------------------------------------------------

def test_views_write_through():
    t = P.tensor(np.arange(12).reshape(3, 4), **CPU)
    t.select(1, 2).fill(0)
    t.narrow(2, 4, 1).add(100)
    t.transpose(1, 2).select(1, 1).mul(-1)
    assert t.numpy().tolist() == [[0, 1, 2, 103], [0, 0, 0, 100],
                                  [-8, 9, 10, 111]]


def test_rand_from_a_generator_or_the_host_stream():
    from bigdl_tpu.utils.rng import RNG as JRNG
    from bigdl_tpu_torch.utils.rng import RNG as PRNG

    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    a = P.rand(3, 4, generator=g1, **CPU).numpy()
    np.testing.assert_array_equal(a, P.rand(3, 4, generator=g2,
                                            **CPU).numpy())
    assert a.min() >= 0 and a.max() < 1
    JRNG().set_seed(5)
    PRNG().set_seed(5)
    np.testing.assert_array_equal(P.randn(2, 3, **CPU).numpy(),
                                  np.asarray(J.randn(2, 3).numpy()))


def test_blas_and_reductions_match_jax():
    rng = np.random.RandomState(1)
    m, v = rng.rand(3, 4).astype(np.float32), rng.rand(4).astype(np.float32)
    y = rng.rand(3).astype(np.float32)
    for name, args in (("addmv", (0.5, 2.0, m, v)), ("mv", (m, v))):
        want = getattr(J.tensor(y), name)(*(J.tensor(a) if isinstance(
            a, np.ndarray) else a for a in args)).numpy()
        got = getattr(P.tensor(y, **CPU), name)(*(P.tensor(a, **CPU)
                                                  if isinstance(a, np.ndarray)
                                                  else a for a in args)
                                                ).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5)
    j, p = J.tensor(m), P.tensor(m, **CPU)
    for name in ("std", "prod", "norm"):
        np.testing.assert_allclose(getattr(p, name)(), getattr(j, name)(),
                                   rtol=1e-5)
    np.testing.assert_allclose(p.sum(2).numpy(), j.sum(2).numpy(),
                               rtol=1e-6)
    np.testing.assert_array_equal(p.argmax_1based(2).numpy(),
                                  np.asarray(j.argmax_1based(2).numpy()))


def test_constructors_copy_their_data():
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    t = P.tensor(a, **CPU)
    t.fill(7)
    assert a.tolist() == [[0, 1, 2], [3, 4, 5]]
