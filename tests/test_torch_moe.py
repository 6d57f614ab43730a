"""The port's single-device Switch-MoE against the JAX package, in f32
on the CPU (``bigdl_tpu_torch/parallel/moe.py``, the MoE blocks of
``models/transformer.py``, the auxiliary loss in ``LocalOptimizer``,
the capacity-free decode dispatch and ``capacity_bind_report`` of
``models/generate.py``).  Weights cross with ``load_param_tree``.

Mirrors every single-device spec of ``tests/test_moe.py`` (the
per-token oracles, choice-ordered capacity, drops passing through as
zero, top-2 greedy decode against the dense forward, the aux formula,
the guards; the LocalOptimizer smoke strengthened to a 3-step trajectory
against the JAX optimizer), and adds: every gradient against JAX with
capacity loose and binding, tied router logits, the LM forward dense and
flash (the JAX flash kernels in interpret mode), decode streams against
JAX and paged / beam 1 against unpaged greedy, the capacity report, the
index dispatch against the one-hot form, and a checkpoint round trip
that carries the aux buffer.  The expert-parallel specs wait for the
distributed slice.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

import bigdl_tpu.ops as jops
from bigdl_tpu import nn as jnn
from bigdl_tpu import optim as joptim
from bigdl_tpu.dataset.dataset import array as jarray
from bigdl_tpu.dataset.sample import MiniBatch as JMiniBatch
from bigdl_tpu.models import generate as jgen
from bigdl_tpu.models.transformer import TransformerLM as JTransformerLM
from bigdl_tpu.parallel.moe import MoEFFN as JMoEFFN
from bigdl_tpu.utils.rng import RNG as JRNG
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch import optim as toptim
from bigdl_tpu_torch.dataset.dataset import array
from bigdl_tpu_torch.dataset.sample import MiniBatch
from bigdl_tpu_torch.interop import load_param_tree
from bigdl_tpu_torch.interop.jax_params import param_tree_numpy
from bigdl_tpu_torch.models import generate as tgen
from bigdl_tpu_torch.models.transformer import TransformerLM
from bigdl_tpu_torch.parallel import (MoEFFN, aux_loss_term,
                                      collect_aux_paths)
from bigdl_tpu_torch.parallel.moe import (capture_aux, onehot_forward,
                                          top_choices)
from bigdl_tpu_torch.serving import KVPagePool
from bigdl_tpu_torch.utils.rng import RNG

torch.set_num_threads(1)

D, H, E = 8, 16, 4
ATOL = 2e-5
TRAJ_RTOL = 2e-3


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tokens(b, t, seed=0):
    return np.random.RandomState(seed).randn(b, t, D).astype(np.float32)


def _moe_pair(capacity_factor=8.0, n_experts=E, top_k=1, aux=0.0, seed=3):
    JRNG().set_seed(seed)
    jm = JMoEFFN(D, H, n_experts, capacity_factor=capacity_factor,
                 top_k=top_k, aux_loss_coef=aux)
    tm = MoEFFN(D, H, n_experts, capacity_factor=capacity_factor,
                top_k=top_k, aux_loss_coef=aux, device="cpu")
    load_param_tree(tm, _np(jm.param_tree()))
    return jm, tm


def _jax_out(jm, x, training=False):
    out, nb = jm.apply_fn(jm.param_tree(), jm.buffer_tree(), jnp.asarray(x),
                          training, None)
    return np.asarray(out), nb


def _port_out(tm, x):
    with torch.no_grad():
        return tm.apply_fn(tm.param_tree(), torch.from_numpy(x)).numpy()


def _gelu(h):
    return np.asarray(jax.nn.gelu(jnp.asarray(h)))


def _probs(p, x2d):
    logits = x2d @ np.asarray(p["router_w"]).T + np.asarray(p["router_b"])
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    return probs / probs.sum(-1, keepdims=True)


def _expert(p, e, row):
    h = _gelu(row @ np.asarray(p["wi"])[e] + np.asarray(p["bi"])[e])
    return h @ np.asarray(p["wo"])[e] + np.asarray(p["bo"])[e]


# ----------------------------------------------------------------------
# tests/test_moe.py's single-device specs
# ----------------------------------------------------------------------

def test_dense_matches_per_token_oracle():
    """Generous capacity: every token goes through exactly its argmax
    expert scaled by the softmax gate."""
    jm, tm = _moe_pair()
    p = jm.param_tree()
    x = _tokens(2, 6)
    out = _port_out(tm.evaluate(), x)
    x2d = x.reshape(-1, D)
    probs = _probs(p, x2d)
    want = np.empty_like(x2d)
    for n in range(x2d.shape[0]):
        e = int(np.argmax(probs[n]))
        want[n] = probs[n, e] * _expert(p, e, x2d[n])
    np.testing.assert_allclose(out.reshape(-1, D), want, atol=ATOL)
    np.testing.assert_allclose(out, _jax_out(jm, x)[0], atol=ATOL)


def test_top2_matches_per_token_oracle():
    """GShard top-2 with generous capacity: every token is the
    renormalized-gate mixture of its two highest-probability experts."""
    jm, tm = _moe_pair(top_k=2)
    p = jm.param_tree()
    x = _tokens(2, 6, seed=9)
    out = _port_out(tm.evaluate(), x)
    x2d = x.reshape(-1, D)
    probs = _probs(p, x2d)
    want = np.empty_like(x2d)
    for n in range(x2d.shape[0]):
        top2 = np.argsort(-probs[n])[:2]
        g = probs[n, top2] / probs[n, top2].sum()
        want[n] = sum(gi * _expert(p, e, x2d[n]) for gi, e in zip(g, top2))
    np.testing.assert_allclose(out.reshape(-1, D), want, atol=ATOL)
    np.testing.assert_allclose(out, _jax_out(jm, x)[0], atol=ATOL)


def test_top2_capacity_drops_second_choices_first():
    """Choice-ordered capacity (GShard): with identical tokens and C=1,
    each expert's single slot goes to token 0 (its first choice, then
    its second, which queues behind every first choice); every later
    token drops both."""
    jm, tm = _moe_pair(capacity_factor=1e-6, n_experts=2, top_k=2)
    p = jm.param_tree()
    x = np.tile(_tokens(1, 1, seed=4), (1, 4, 1))
    out = _port_out(tm.evaluate(), x)[0]
    x2d = x.reshape(-1, D)
    probs = _probs(p, x2d[:1])[0]
    top2 = np.argsort(-probs)[:2]
    g = probs[top2] / probs[top2].sum()
    want0 = sum(gi * _expert(p, e, x2d[0]) for gi, e in zip(g, top2))
    np.testing.assert_allclose(out[0], want0, atol=ATOL)
    np.testing.assert_allclose(out[1:], 0.0, atol=1e-7)
    np.testing.assert_allclose(out, _jax_out(jm, x)[0][0], atol=ATOL)


def test_capacity_drops_pass_through_as_zero():
    """Only the first token per expert fits (C = 1): later same-expert
    tokens contribute exactly zero."""
    jm, tm = _moe_pair(capacity_factor=1e-6, n_experts=2)
    x = np.tile(_tokens(1, 1, seed=4), (1, 5, 1))
    out = _port_out(tm.evaluate(), x)[0]
    assert np.abs(out[0]).max() > 1e-4
    assert np.all(out[1:] == 0.0)
    np.testing.assert_allclose(out, _jax_out(jm, x)[0][0], atol=ATOL)


def _lm_pair(seed=13, top_k=1, capacity=8.0, aux=0.0, max_len=16,
             seq_strategy="dense", **kw):
    cfg = dict(embed_dim=D, num_heads=2, mlp_dim=H, num_layers=2,
               max_len=max_len, moe_experts=E, moe_capacity_factor=capacity,
               moe_top_k=top_k, moe_aux_coef=aux, seq_strategy=seq_strategy,
               **kw)
    JRNG().set_seed(seed)
    jm = JTransformerLM(17, **cfg)
    tm = TransformerLM(17, **cfg, device="cpu")
    load_param_tree(tm, _np(jm.param_tree()))
    return jm, tm


def test_top2_lm_greedy_decode_matches_dense_forward():
    """A top-2 MoE TransformerLM decodes (capacity-free top-2 dispatch)
    exactly like its own forward under loose capacity."""
    _, lm = _lm_pair(top_k=2)
    lm.evaluate()
    prompt = np.random.RandomState(5).randint(1, 18, (2, 4)).astype(np.int32)
    ids = tgen.make_generate(lm)(lm.param_tree(), prompt, 6).numpy()
    with torch.no_grad():
        out = lm(torch.from_numpy(ids)).numpy()
    pred = 1 + np.argmax(out, axis=-1)
    np.testing.assert_array_equal(ids[:, 4:], pred[:, 3:-1])


def test_aux_loss_value_matches_hand_formula():
    """Switch aux = E * sum_e f_e * P_e over the pre-capacity top-1
    assignment, written to the aux_loss buffer in training."""
    jm, tm = _moe_pair(aux=0.5)
    p = jm.param_tree()
    x = _tokens(2, 6, seed=8)
    tm.train()
    tm(torch.from_numpy(x))
    probs = _probs(p, x.reshape(-1, D))
    onehot = np.eye(E)[probs.argmax(-1)]
    want = E * float(np.sum(onehot.mean(0) * probs.mean(0)))
    np.testing.assert_allclose(float(tm.aux_loss), want, atol=1e-5)
    _, nb = _jax_out(jm, x, training=True)
    np.testing.assert_allclose(float(tm.aux_loss), float(nb["aux_loss"]),
                               atol=1e-5)
    assert tm.aux_loss.dtype == torch.float32
    # an eval forward leaves the buffer as the training forward wrote it
    before = tm.aux_loss.clone()
    tm.evaluate()(torch.from_numpy(_tokens(3, 2, seed=1)))
    assert torch.equal(tm.aux_loss, before)


def test_block_rejects_moe_plus_model_axis():
    with pytest.raises(ValueError, match="model_axis=None"):
        TransformerLM(17, embed_dim=D, num_heads=2, mlp_dim=H, num_layers=2,
                      max_len=6, moe_experts=4, model_axis="model",
                      device="cpu")


def test_moe_guards():
    """The layer's argument guards (the JAX layer's), swiglu + MoE, and
    expert parallelism, which comes with the distributed slice."""
    with pytest.raises(ValueError, match="n_experts"):
        MoEFFN(D, H, 0, device="cpu")
    with pytest.raises(ValueError, match="top_k"):
        MoEFFN(D, H, E, top_k=E + 1, device="cpu")
    with pytest.raises(ValueError, match="swiglu"):
        TransformerLM(17, embed_dim=D, num_heads=2, mlp_dim=H, num_layers=2,
                      max_len=6, moe_experts=E, mlp="swiglu", device="cpu")
    for kw in (dict(axis_name="data"), dict(stat_axes=("seq",))):
        with pytest.raises(NotImplementedError, match="item 5"):
            MoEFFN(D, H, E, device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="axis_name"):
        TransformerLM(17, embed_dim=D, num_heads=2, mlp_dim=H, num_layers=2,
                      max_len=6, moe_experts=E, moe_axis="data",
                      device="cpu")
    _, lm = _lm_pair()
    blk = lm.blocks[0]
    assert blk.is_moe and blk.mlp_kind == "moe" and len(blk) == 4
    assert isinstance(blk[3], MoEFFN)


def _lm_batches(n_batches=3, n=8, T=6, seed=0):
    r = np.random.RandomState(seed)
    return [(r.randint(1, 18, (n, T)).astype(np.int32),
             r.randint(1, 18, (n, T)).astype(np.int32))
            for _ in range(n_batches)]


def _trajectory(opt, pkg, iters):
    losses = []

    def check(state):
        if "loss" in state:
            losses.append(state["loss"])
        return pkg.max_iteration(iters)(state)

    opt.set_end_when(pkg.Trigger(check))
    opt.optimize()
    return losses


def test_aux_loss_local_optimizer_trajectory_matches_jax():
    """3 SGD steps of an MoE LM with aux 0.01 through each package's
    LocalOptimizer from the same weights and batches: the reported
    losses (criterion + aux) and the parameters within rtol 2e-3."""
    jm, tm = _lm_pair(seed=5, aux=0.01, max_len=6)
    batches = _lm_batches()
    jopt = joptim.LocalOptimizer(
        jm, jarray([JMiniBatch(x, y.astype(np.float32))
                    for x, y in batches]),
        jnn.TimeDistributedCriterion(jnn.ClassNLLCriterion()))
    jopt.set_optim_method(joptim.SGD(learning_rate=0.1))
    topt = toptim.LocalOptimizer(
        tm, array([MiniBatch(x, y) for x, y in batches]),
        tnn.TimeDistributedCriterion(tnn.ClassNLLCriterion()))
    topt.set_optim_method(toptim.SGD(learning_rate=0.1))
    JRNG().set_seed(1)
    want = _trajectory(jopt, joptim, 3)
    RNG().set_seed(1)
    got = _trajectory(topt, toptim, 3)
    assert len(got) == 3 and all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=TRAJ_RTOL)
    flat = jax.tree_util.tree_flatten_with_path(_np(jm.param_tree()))[0]
    got_p = param_tree_numpy(tm)
    for path, w in flat:
        node = got_p
        for k in path:
            node = node[k.key]
        np.testing.assert_allclose(node, w, rtol=TRAJ_RTOL, atol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))


def test_step_loss_includes_each_blocks_aux_term():
    """One step: the reported loss minus the criterion's loss of the
    same forward is 0.01 * the sum of the layers' aux buffers."""
    _, tm = _lm_pair(seed=5, aux=0.01, max_len=6)
    x, y = _lm_batches(1)[0]
    crit = tnn.TimeDistributedCriterion(tnn.ClassNLLCriterion())
    tm.train()
    with torch.no_grad():
        crit_loss = float(crit._loss(tm(torch.from_numpy(x)),
                                     torch.from_numpy(y)))
    opt = toptim.LocalOptimizer(tm, array([MiniBatch(x, y)]), crit)
    opt.set_optim_method(toptim.SGD(learning_rate=0.1))
    paths = list(collect_aux_paths(tm))
    assert [p for p, _ in paths] == [("1", "3", "aux_loss"),
                                     ("2", "3", "aux_loss")]
    (loss,) = _trajectory(opt, toptim, 1)
    aux = float(aux_loss_term(tm.buffer_tree(), paths))
    assert aux > 0.01
    # 1e-6 of the loss: the two losses' f32 roundings
    np.testing.assert_allclose(loss - crit_loss, aux, rtol=0,
                               atol=1e-6 * loss)


# ----------------------------------------------------------------------
# beyond the JAX file: gradients, ties, the LM, decode, the report
# ----------------------------------------------------------------------

MOE_CASES = {"top1_loose": (1, 8.0), "top1_binding": (1, 0.5),
             "top2_loose": (2, 8.0), "top2_binding": (2, 0.5)}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_forward_and_every_gradient_match_jax(case):
    top_k, cf = MOE_CASES[case]
    jm, tm = _moe_pair(capacity_factor=cf, top_k=top_k, aux=0.1)
    x = _tokens(3, 5, seed=2)
    g = np.random.RandomState(7).randn(3, 5, D).astype(np.float32)

    def jloss(p, xx):
        out, nb = jm.apply_fn(p, jm.buffer_tree(), xx, True, None)
        return jnp.sum(out * g) + nb["aux_loss"], out

    (_, want), (gp, gx) = jax.value_and_grad(jloss, argnums=(0, 1),
                                             has_aux=True)(
        jm.param_tree(), jnp.asarray(x))
    tm.train()
    params = tm.param_tree()
    leaves = [params[k] for k in sorted(params)]
    xt = torch.from_numpy(x).requires_grad_()
    # the aux term through its live tensor (the buffer holds a copy)
    with capture_aux() as terms:
        out = tm.apply_fn(params, xt)
    assert len(terms) == 1 and terms[0][0] == 0.1
    loss = (out * torch.from_numpy(g)).sum() + terms[0][1]
    grads = torch.autograd.grad(loss, leaves + [xt])
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=ATOL)
    for k, gr in zip(sorted(params), grads):
        np.testing.assert_allclose(gr.numpy(), np.asarray(gp[k]), atol=ATOL,
                                   err_msg=k)
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(gx), atol=ATOL)
    with torch.no_grad():
        _, keep, _ = tm.slots(tm.route(params, xt.reshape(-1, D))[1])
    assert bool(keep.all()) == (cf > 1.0)   # binding: some dropped


@pytest.mark.parametrize("top_k", [1, 2])
def test_tied_router_logits_pick_the_jax_experts(top_k):
    """Experts 1, 2 and 3 tie on every token's logits (identical router
    rows, expert 0 below them): the lower index wins, as ``lax.top_k``
    picks, in the layer and in the decode dispatch."""
    jm, tm = _moe_pair(top_k=top_k)
    p = {k: np.asarray(v).copy() for k, v in jm.param_tree().items()}
    row = np.random.RandomState(1).randn(D).astype(np.float32)
    p["router_w"][:] = row
    p["router_w"][0] = -row
    p["router_b"][:] = 0.0
    x = np.abs(_tokens(2, 4, seed=3)) * np.sign(row)   # row . x > 0
    jm.set_param_tree({k: jnp.asarray(v) for k, v in p.items()})
    load_param_tree(tm, p)
    probs = torch.softmax(torch.from_numpy(x).reshape(-1, D)
                          @ torch.from_numpy(p["router_w"]).t(), -1)
    _, idx = top_choices(probs, top_k)
    _, jidx = lax.top_k(jnp.asarray(probs.numpy()), top_k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert idx[:, 0].eq(1).all()
    got = _port_out(tm.evaluate(), x)
    np.testing.assert_allclose(got, _jax_out(jm, x)[0], atol=ATOL)
    nodrop = tgen._moe_ffn_nodrop(tm, tm.param_tree(),
                                  torch.from_numpy(x)).detach().numpy()
    want = jgen._moe_ffn_nodrop(jm, jm.param_tree(), jnp.asarray(x))
    np.testing.assert_allclose(nodrop, np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_index_dispatch_is_the_onehot_einsum(case):
    """The port's index dispatch against the JAX form transliterated
    (``onehot_forward``), f32: within one f32 rounding of the largest
    output (the top-2 sums' order)."""
    top_k, cf = MOE_CASES[case]
    _, tm = _moe_pair(capacity_factor=cf, top_k=top_k)
    x = torch.from_numpy(_tokens(4, 8, seed=6))
    tm.evaluate()
    with torch.no_grad():
        got = tm(x)
        want = onehot_forward(tm, tm.param_tree(), x)
    assert (got - want).abs().max() <= 1e-6 * want.abs().max()
    if top_k == 1:
        assert torch.equal(got, want)


@pytest.mark.parametrize("strategy", ["dense", "flash"])
def test_moe_lm_forward_matches_jax(strategy, monkeypatch):
    """The MoE LM's forward (eval: the capacity-limited dispatch, no
    jitter) at two batch sizes, whose capacities differ (C from the
    call's B·T), the JAX flash kernels in interpret mode."""
    if strategy == "flash":
        monkeypatch.setattr(jops, "flash_attention", functools.partial(
            jops.flash_attention, interpret=True))
    jm, tm = _lm_pair(capacity=1.0, seq_strategy=strategy)
    tm.evaluate()
    ids = np.random.RandomState(2).randint(1, 18, (3, 8)).astype(np.int32)
    for xb in (ids, ids[:1]):
        want, _ = jm.apply_fn(jm.param_tree(), jm.buffer_tree(),
                              jnp.asarray(xb), False, None)
        with torch.no_grad():
            got = tm(torch.from_numpy(xb)).numpy()
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("top_k", [1, 2])
def test_decode_streams_match_jax_paged_and_beam(top_k):
    """Greedy decode token-exact against the JAX ``make_generate``
    (capacity-free on both sides, capacity binding in the layer), the
    paged stream and one beam against the unpaged greedy."""
    jm, tm = _lm_pair(top_k=top_k, capacity=0.5, max_len=24)
    tm.evaluate()
    jm.evaluate()
    prompt = np.random.RandomState(5).randint(1, 18, (2, 5)).astype(np.int32)
    params = tm.param_tree()
    got = tgen.make_generate(tm)(params, prompt, 8).numpy()
    want = np.asarray(jgen.make_generate(jm)(jm.param_tree(), prompt, 8))
    np.testing.assert_array_equal(got, want)
    beam, _ = tgen.make_beam_search(tm)(params, prompt, 8, num_beams=1)
    np.testing.assert_array_equal(beam.numpy(), got)
    pool = KVPagePool.for_model(tm, 16, page_size=4)
    dec = tgen.cached_paged_decoder(tm, pool)
    for row in range(2):
        seq = dec.start(params, prompt[row])
        toks = [seq.last]
        for _ in range(7):
            toks.append(dec.step(params, seq))
        seq.release()
        np.testing.assert_array_equal(toks, got[row, 5:])
    assert pool.free_pages == pool.num_pages


@pytest.mark.parametrize("top_k", [1, 2])
def test_capacity_bind_report_equals_jax(top_k):
    jm, tm = _lm_pair(top_k=top_k, capacity=0.5, max_len=24)
    ids = np.random.RandomState(8).randint(1, 18, (3, 12)).astype(np.int32)
    want = jgen.capacity_bind_report(jm, jm.param_tree(), ids)
    got = tgen.capacity_bind_report(tm, tm.param_tree(), ids)
    assert set(got) == set(want) == {1, 2, "overall"}
    for k in want:
        np.testing.assert_allclose(got[k], float(want[k]), atol=1e-6,
                                   err_msg=str(k))
    assert got["overall"] > 0.0
    dense = TransformerLM(17, embed_dim=D, num_heads=2, num_layers=1,
                          device="cpu")
    assert tgen.capacity_bind_report(dense, dense.param_tree(), ids) == {}


def test_checkpoint_round_trip_carries_the_aux_buffer(tmp_path):
    """Train 2 steps with a checkpoint each step; a model from another
    seed resumed from it holds the same parameters and aux buffers."""
    _, tm = _lm_pair(seed=5, aux=0.01, max_len=6)
    batches = _lm_batches(2)
    crit = tnn.TimeDistributedCriterion(tnn.ClassNLLCriterion())
    opt = toptim.LocalOptimizer(tm, array([MiniBatch(x, y)
                                           for x, y in batches]), crit)
    opt.set_optim_method(toptim.SGD(learning_rate=0.1))
    opt.set_checkpoint(str(tmp_path), toptim.several_iteration(1))
    RNG().set_seed(1)
    _trajectory(opt, toptim, 2)
    _, other = _lm_pair(seed=6, aux=0.01, max_len=6)
    assert not torch.equal(other[1][3].aux_loss, tm[1][3].aux_loss)
    opt2 = toptim.LocalOptimizer(other, array([MiniBatch(x, y)
                                               for x, y in batches]), crit)
    opt2.set_checkpoint(str(tmp_path), toptim.several_iteration(1))
    assert opt2.resume_from_checkpoint() is True
    for (n, a), b in zip(tm.state_dict().items(),
                         other.state_dict().values()):
        assert torch.equal(a, b), n
    assert float(other[2][3].aux_loss) > 0.0


def test_guard_restores_the_aux_buffer_on_a_skipped_step():
    """A step whose loss is not finite is skipped by the gradient guard:
    the parameters and the aux buffers keep the previous step's values."""
    _, tm = _lm_pair(seed=5, aux=0.01, max_len=6)
    batches = _lm_batches(2)

    class NaNOnSecond(tnn.TimeDistributedCriterion):
        calls = 0

        def _loss(self, out, y):
            NaNOnSecond.calls += 1
            loss = super()._loss(out, y)
            return loss * float("nan") if NaNOnSecond.calls == 2 else loss

    opt = toptim.LocalOptimizer(tm, array([MiniBatch(x, y)
                                           for x, y in batches]),
                                NaNOnSecond(tnn.ClassNLLCriterion()))
    opt.set_optim_method(toptim.SGD(learning_rate=0.1))
    seen = []

    def check(state):
        seen.append(([b.clone() for b in tm.buffers()],
                     [p.detach().clone() for p in tm.parameters()]))
        return toptim.max_iteration(2)(state)

    opt.set_end_when(toptim.Trigger(check))
    opt.optimize()
    assert opt.skipped_steps == 1
    (b1, p1), (b2, p2) = seen[1], seen[2]
    assert float(b1[0]) > 0.0
    for a, b in zip(b1 + p1, b2 + p2):
        assert torch.equal(a, b)
