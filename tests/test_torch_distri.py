"""Data-parallel training on the port against the JAX package, on the
CPU: ``DistriOptimizer`` over a gloo group, ``AllReduceParameter``,
``ModelBroadcast``, the Engine's process group and data mesh, and
validation and prediction over the data axis.

The multi-process cases run ``tests/_torch_distri_child.py`` as 2 and as
4 rank processes (one intra-op thread each), joined by a ``file://``
store under the test's temporary directory; both worlds run every
scenario once, together, at module scope, each launch under its own
timeout that kills the children before it fails.  Each test then holds
one scenario against the JAX ``DistriOptimizer`` (or JAX collective) on
a ``Mesh(jax.devices()[:N], ("data",))`` of the same size, run here from
the same initial weights, and against the port's own ``LocalOptimizer``
or ``evaluate_dataset`` on the global batch.  The one-rank cases run in
this process over an in-process store.

Limits: ``AllReduceParameter`` 1e-5 relative (bf16 on the wire: rtol
and atol 0.05, ``tests/test_distri_optimizer.py``'s); trained weights
against JAX atol 2e-4 (``test_distri_optimizer.py``'s), against the
port's local run 1e-6; LM losses rtol 2e-3 / atol 2e-4
(``tests/test_sharding_plan.py:302``); BatchNorm after a step 1e-5;
validation counts exact, losses 1e-6 relative; predictions 1e-6.
"""
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import _torch_distri_child as child
from bigdl_tpu import nn as jnn
from bigdl_tpu import optim as joptim
from bigdl_tpu.dataset import Sample as JSample
from bigdl_tpu.dataset.dataset import array as jarray
from bigdl_tpu.dataset.sample import MiniBatch as JMiniBatch
from bigdl_tpu.models.transformer import TransformerLM as JTransformerLM
from bigdl_tpu.optim.distri_optimizer import DistriOptimizer as JDistri
from bigdl_tpu.parallel.all_reduce import (AllReduceParameter as
                                           JAllReduceParameter)
from bigdl_tpu.utils.jax_compat import shard_map
from bigdl_tpu.utils.rng import RNG as JRNG
from bigdl_tpu_torch import nn, optim
from bigdl_tpu_torch.optim import _sharding_utils as su
from bigdl_tpu_torch.optim.distri_optimizer import DistriOptimizer
from bigdl_tpu_torch.parallel import AllReduceParameter, padded_size
from bigdl_tpu_torch.parallel.broadcast import ModelBroadcast
from bigdl_tpu_torch.utils.engine import Engine

torch.set_num_threads(1)

WORLDS = (2, 4)
LAUNCH_TIMEOUT_S = 180
JAX_ATOL = 2e-4
LOCAL_TOL = dict(rtol=1e-5, atol=1e-6)


def _jmodel(name):
    if name == "xor":
        return jnn.Sequential(jnn.Linear(2, 32), jnn.Tanh(),
                              jnn.Linear(32, 2), jnn.LogSoftMax())
    if name == "tail":
        return jnn.Sequential(jnn.Linear(6, 16), jnn.Tanh(),
                              jnn.Linear(16, 4), jnn.LogSoftMax())
    if name == "bn":
        return jnn.Sequential(jnn.Linear(4, 8), jnn.BatchNormalization(8),
                              jnn.ReLU(), jnn.Linear(8, 3), jnn.LogSoftMax())
    if name == "drop":
        return jnn.Sequential(jnn.Dropout(0.5), jnn.Linear(4, 3),
                              jnn.LogSoftMax())
    return JTransformerLM(child.LM_V, **child.LM_KW)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def inputs():
    """Each scenario model's initial weights, drawn by the JAX package."""
    out = {}
    for name in ("xor", "tail", "bn", "drop", "lm"):
        JRNG().set_seed(11)
        jm = _jmodel(name)
        out[name] = dict(params=_np(jm.param_tree()),
                         buffers=_np(jm.buffer_tree()))
    return out


def _jax_model(inputs, name):
    jm = _jmodel(name)
    jm.set_param_tree(jax.tree_util.tree_map(jnp.asarray,
                                             inputs[name]["params"]))
    if inputs[name]["buffers"]:
        jm.set_buffer_tree(jax.tree_util.tree_map(
            jnp.asarray, inputs[name]["buffers"]))
    return jm


def _launch(world, workdir):
    """Start ``world`` rank processes of the child."""
    env = dict(os.environ, PYTHONPATH=str(child.REPO), OMP_NUM_THREADS="1")
    init = f"file://{workdir / 'store'}"
    return [subprocess.Popen(
        [sys.executable, str(Path(child.__file__)), str(r), str(world), init,
         str(workdir)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env=env, cwd=str(child.REPO)) for r in range(world)]


@pytest.fixture(scope="module")
def runs(inputs, tmp_path_factory):
    """Every scenario at 2 and at 4 ranks, both worlds at once: world →
    the ranks' results in rank order."""
    procs = {}
    for world in WORLDS:
        workdir = tmp_path_factory.mktemp(f"distri{world}")
        (workdir / "inputs.pkl").write_bytes(pickle.dumps(inputs))
        procs[world] = (workdir, _launch(world, workdir))
    results, failures = {}, []
    deadline = time.monotonic() + LAUNCH_TIMEOUT_S
    try:
        for world, (workdir, ps) in procs.items():
            outs = []
            for p in ps:
                try:
                    out, _ = p.communicate(
                        timeout=max(1.0, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    failures.append(f"world {world}: a rank hung past "
                                    f"{LAUNCH_TIMEOUT_S} s")
                    break
                outs.append(out.decode(errors="replace"))
            if failures:
                break
            ranks = []
            for r, p in enumerate(ps):
                path = workdir / f"rank{r}.pkl"
                res = pickle.loads(path.read_bytes()) if path.exists() \
                    else {"error": "no result file"}
                if p.returncode != 0 or "error" in res:
                    failures.append(f"world {world} rank {r} "
                                    f"(rc {p.returncode}): "
                                    f"{res.get('error')}\n{outs[r][-3000:]}")
                ranks.append(res)
            results[world] = ranks
    finally:
        for _, ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    if failures:
        pytest.fail("\n".join(failures))
    return results


def _mesh(world):
    return Mesh(np.array(jax.devices()[:world]), ("data",))


def _jax_train(jm, data, crit, method, end, world, batch_size=None, seed=1):
    losses = []

    def check(state):
        if "loss" in state:
            losses.append(state["loss"])
        return end(state)

    opt = JDistri(jm, data, crit, batch_size=batch_size, mesh=_mesh(world))
    opt.set_optim_method(method).set_end_when(joptim.Trigger(check))
    JRNG().set_seed(seed)
    opt.optimize()
    return losses


def _jsamples(x, y):
    return jarray([JSample(a, b) for a, b in zip(x, y)])


def _jbatches(pairs):
    return jarray([JMiniBatch(a, b) for a, b in pairs])


def _close(got, want, **tol):
    g = jax.tree_util.tree_leaves(got)
    w = jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)


def _same_on_every_rank(ranks, key):
    first = jax.tree_util.tree_leaves(ranks[0][key])
    for res in ranks[1:]:
        for a, b in zip(jax.tree_util.tree_leaves(res[key]), first):
            np.testing.assert_array_equal(a, b)


def _local(inputs, name, data, crit, method, end, batch_size=None, seed=1):
    """The port's LocalOptimizer on the global batches."""
    model = child.loaded(name, inputs)
    opt, losses = child.train(model, data, crit, method, end, batch_size,
                              seed, optimizer=optim.LocalOptimizer)
    return child.trained(opt, losses, model)


# ----------------------------------------------------------------------
# (1) AllReduceParameter against the JAX one
# ----------------------------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("compress", ["none", "bf16"])
def test_allreduce_parameter_matches_jax(runs, world, compress):
    """Reduce-scatter of each rank's gradient, then all-gather: the sum
    over ranks on every rank, as the JAX ``test_allreduce_parameter_
    semantics`` (1e-5) and ``test_bf16_compression_close`` (0.05) hold
    their ``psum_scatter``."""
    seed, width = (0, 10) if compress == "none" else (1, 16)
    rng = np.random.RandomState(seed)
    g = (rng.rand(world, width) if seed == 0
         else rng.randn(world, width)).astype(np.float32)
    arp = JAllReduceParameter({"w": jnp.zeros(width)}, world,
                              compress=compress)
    want = np.asarray(shard_map(
        lambda a: jax.lax.all_gather(arp.reduce_scatter_gradients(
            {"w": a[0]}), "data", tiled=True)[None],
        mesh=_mesh(world), in_specs=jax.sharding.PartitionSpec("data"),
        out_specs=jax.sharding.PartitionSpec("data"))(jnp.asarray(g)))[0]
    tol = dict(rtol=1e-5) if compress == "none" else dict(rtol=0.05,
                                                          atol=0.05)
    padded = padded_size(width, world)
    s = padded // world
    total = np.pad(g.sum(0), (0, padded - width))
    for rank, res in enumerate(runs[world]):
        got = res["allreduce"][compress]
        np.testing.assert_allclose(got["full"], want[:width], **tol)
        np.testing.assert_allclose(got["full"], g.sum(0), **tol)
        np.testing.assert_allclose(got["slice"],
                                   total[rank * s:(rank + 1) * s], **tol)
        own = np.pad(g[rank], (0, padded - width))
        np.testing.assert_array_equal(got["own"], own[rank * s:(rank + 1) * s])


@pytest.mark.parametrize("world", WORLDS)
def test_shard_batch_takes_this_ranks_rows(runs, world):
    rows = np.arange(world * 3 * 2).reshape(world * 3, 2)
    for rank, res in enumerate(runs[world]):
        got = res["allreduce"]["shard"]
        np.testing.assert_array_equal(got["x"], rows[3 * rank:3 * rank + 3])
        np.testing.assert_array_equal(got["y"], rows[3 * rank:3 * rank + 3, 0])


# ----------------------------------------------------------------------
# (2)-(6) training against the JAX DistriOptimizer
# ----------------------------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_xor_sgd_matches_jax_and_local(runs, inputs, world):
    """The XOR MLP of ``tests/test_distri_optimizer.py``, SGD, 3 steps
    of batch 64."""
    x, y = child.xor_arrays(64, 5)
    jm = _jax_model(inputs, "xor")
    want_losses = _jax_train(jm, _jsamples(x, y), jnn.ClassNLLCriterion(),
                             joptim.SGD(child.XOR_LR),
                             joptim.max_iteration(3), world, batch_size=64)
    local = _local(inputs, "xor", child.samples(x, y),
                   nn.ClassNLLCriterion(), optim.SGD(child.XOR_LR),
                   optim.max_iteration(3), batch_size=64)
    ranks = _runs_of(runs, world, "xor_sgd")
    _same_on_every_rank(ranks, "params")
    got = ranks[0]
    _close(got["params"], _np(jm.param_tree()), atol=JAX_ATOL)
    np.testing.assert_allclose(got["losses"], want_losses, atol=JAX_ATOL)
    _close(got["params"], local["params"], **LOCAL_TOL)
    np.testing.assert_allclose(got["losses"], local["losses"], **LOCAL_TOL)


def _runs_of(runs, world, name):
    return [res[name] for res in runs[world]]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", ["tail40", "masked"])
def test_trailing_batches_match_jax(runs, inputs, world, case):
    """``tests/_multihost_train_child.py``'s run (40 records, batch 16, 3
    epochs and their shuffles) and the same records as prebuilt batches
    of 16, 16 and 9, whose 9 divide by neither world: pad-and-mask."""
    crit = jnn.ClassNLLCriterion()
    jm = _jax_model(inputs, "tail")
    if case == "tail40":
        data, pdata, bsz = (_jsamples(*child.tail_arrays(40)),
                            child.samples(*child.tail_arrays(40)), 16)
    else:
        data, pdata, bsz = (_jbatches(child.masked_batches()),
                            child.batches(child.masked_batches()), None)
    want_losses = _jax_train(jm, data, crit, joptim.SGD(child.TAIL_LR),
                             joptim.max_epoch(3), world, bsz, seed=7)
    local = _local(inputs, "tail", pdata, nn.ClassNLLCriterion(),
                   optim.SGD(child.TAIL_LR), optim.max_epoch(3), bsz, seed=7)
    ranks = _runs_of(runs, world, case)
    for res in ranks[1:]:
        _close(res["params"], ranks[0]["params"], rtol=0, atol=0)
    got = ranks[0]
    assert got["neval"] - 1 == len(want_losses) == 9
    _close(got["params"], _np(jm.param_tree()), atol=JAX_ATOL)
    np.testing.assert_allclose(got["losses"], want_losses, atol=JAX_ATOL)
    _close(got["params"], local["params"], **LOCAL_TOL)
    np.testing.assert_allclose(got["losses"], local["losses"], **LOCAL_TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_adam_slots_identical_on_every_rank(runs, inputs, world):
    ranks = _runs_of(runs, world, "adam")
    for res in ranks[1:]:
        _close(res["slots"], ranks[0]["slots"], rtol=0, atol=0)
        _close(res["params"], ranks[0]["params"], rtol=0, atol=0)
    local = _local(inputs, "xor", child.samples(*child.xor_arrays(64, 5)),
                   nn.ClassNLLCriterion(), optim.Adam(child.ADAM_LR),
                   optim.max_iteration(4), batch_size=16)
    # Adam divides each step by the gradient's own size, so the
    # summation order's rounding shows more than under SGD
    _close(ranks[0]["params"], local["params"], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", ["full", "partial"])
def test_batchnorm_step_matches_jax(runs, inputs, world, case):
    """One step of a BatchNorm net: a full batch of 8 averages the
    ranks' running statistics; a trailing batch of 5 (padded to the
    world's multiple) keeps the statistics from before the step."""
    n = 8 if case == "full" else 5
    jm = _jax_model(inputs, "bn")
    _jax_train(jm, _jbatches([child.bn_arrays(n)]), jnn.ClassNLLCriterion(),
               joptim.SGD(child.BN_LR), joptim.max_iteration(1), world)
    ranks = [r[case] for r in _runs_of(runs, world, "bn")]
    for res in ranks[1:]:
        _close(res["buffers"], ranks[0]["buffers"], rtol=0, atol=0)
    got = ranks[0]
    _close(got["buffers"], _np(jm.buffer_tree()), rtol=1e-5, atol=1e-6)
    _close(got["params"], _np(jm.param_tree()), rtol=1e-5, atol=1e-6)
    if case == "partial":
        _close(got["buffers"], inputs["bn"]["buffers"], rtol=0, atol=0)
    else:
        with pytest.raises(AssertionError):
            _close(got["buffers"], inputs["bn"]["buffers"], rtol=0, atol=0)


@pytest.mark.parametrize("world", WORLDS)
def test_transformer_lm_losses_match_jax(runs, inputs, world):
    """A 2-layer TransformerLM (embed 64, 4 heads, flash), 3 SGD steps
    of B 4, T 16."""
    jm = _jax_model(inputs, "lm")
    want = _jax_train(jm, _jsamples(*child.lm_arrays()),
                      jnn.TimeDistributedCriterion(
                          jnn.CrossEntropyCriterion(), True),
                      joptim.SGD(child.LM_LR), joptim.max_iteration(3),
                      world, batch_size=child.LM_B)
    got = runs[world][0]["lm"]
    assert len(got["losses"]) == len(want) == 3
    np.testing.assert_allclose(got["losses"], want, rtol=2e-3, atol=2e-4)
    _same_on_every_rank(_runs_of(runs, world, "lm"), "params")


# ----------------------------------------------------------------------
# (7) validation and prediction over the data axis
# ----------------------------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("batch_size", [3, 4])
def test_validation_over_the_data_axis_is_the_one_device_result(
        runs, inputs, world, batch_size):
    """Batches of 3 (3, 3, 3, 1) and 4 (4, 4, 2): padded to the world's
    multiple, some ranks with no real row; every rank returns the
    one-device counts exactly and losses within 1e-6."""
    model = child.loaded("xor", inputs)
    want = optim.evaluate_dataset(
        model, child.samples(*child.xor_arrays(10, 9)),
        [optim.Top1Accuracy(), optim.Loss(nn.ClassNLLCriterion())],
        batch_size)
    for res in _runs_of(runs, world, "validate"):
        got = res[f"val{batch_size}"]
        assert [name for *_, name in got] == ["Top1Accuracy", "Loss"]
        (_, acc, _), (_, loss, _) = got
        assert (acc["correct"], acc["count"]) == (want[0].correct,
                                                  want[0].count)
        assert loss["count"] == want[1].count == 10
        np.testing.assert_allclose(loss["loss"], want[1].loss, rtol=1e-6)


@pytest.mark.parametrize("world", WORLDS)
def test_validation_trigger_and_summaries_in_training(runs, inputs, world,
                                                     tmp_path):
    """The optimizer's validation trigger evaluates over the data axis
    (every rank the local run's results), and only rank 0 writes its
    train summary."""
    local = child.trigger(inputs, 0, 1, tmp_path,
                          optimizer=optim.LocalOptimizer)
    ranks = _runs_of(runs, world, "trigger")
    _close(ranks[0]["params"], local["params"], **LOCAL_TOL)
    assert len(local["validation"]) == 2
    for res in ranks:
        assert len(res["validation"]) == 2
        for got, want in zip(res["validation"], local["validation"]):
            assert [n for _, n in got] == [n for _, n in want]
            np.testing.assert_allclose([v for v, _ in got],
                                       [v for v, _ in want], rtol=1e-6)
    assert [s for s, _ in ranks[0]["summary_losses"]] == [1, 2, 3, 4]
    np.testing.assert_allclose([v for _, v in ranks[0]["summary_losses"]],
                               ranks[0]["losses"], rtol=1e-6)
    assert [r["summary_losses"] for r in ranks[1:]] == [[]] * (world - 1)


@pytest.mark.parametrize("world", WORLDS)
def test_prediction_over_the_data_axis_in_order(runs, inputs, world):
    model = child.loaded("xor", inputs)
    data = child.samples(*child.xor_arrays(7, 4))
    want = np.stack(model.predict(data, 3))
    want_class = model.predict_class(data, 2)
    for res in _runs_of(runs, world, "validate"):
        assert res["predict"].shape == (7, 2)
        np.testing.assert_allclose(res["predict"], want, rtol=1e-6,
                                   atol=1e-7)
        assert res["predict_class"] == want_class


# ----------------------------------------------------------------------
# (8)-(10) resilience and randomness on every rank
# ----------------------------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_checkpoint_retry_with_the_fault_on_every_rank(runs, world):
    """JAX ``test_checkpoint_retry_recovers`` on every rank: the fault
    fires on each, each restores rank 0's newest checkpoint and trains
    on; only rank 0 wrote."""
    ranks = _runs_of(runs, world, "retry")
    assert all(r["fired"] and r["rollbacks"] == 1 for r in ranks)
    assert all(r["neval"] > 10 for r in ranks)
    assert ranks[0]["checkpoints"] > 0
    assert [r["checkpoints"] for r in ranks[1:]] == [0] * (world - 1)
    for res in ranks[1:]:
        _close(res["params"], ranks[0]["params"], rtol=0, atol=0)


@pytest.mark.parametrize("world", WORLDS)
def test_nan_on_one_rank_skips_the_step_on_every_rank(runs, inputs, world):
    ranks = _runs_of(runs, world, "nan")
    assert [r["skipped"] for r in ranks] == [1] * world
    for res in ranks[1:]:
        _close(res["params"], ranks[0]["params"], rtol=0, atol=0)
    assert all(np.isfinite(leaf).all() for leaf in
               jax.tree_util.tree_leaves(ranks[0]["params"]))
    assert np.isnan(ranks[0]["losses"][1])


@pytest.mark.parametrize("world", WORLDS)
def test_dropout_masks_differ_by_rank_and_repeat(runs, world):
    ranks = _runs_of(runs, world, "dropout")
    for res in ranks:
        assert res["first"].shape == (8 // world, 4)
        np.testing.assert_array_equal(res["first"], res["again"])
        assert set(np.unique(res["first"])) <= {0.0, 2.0}
    firsts = [r["first"].tobytes() for r in ranks]
    assert len(set(firsts)) == world


@pytest.mark.parametrize("world", WORLDS)
def test_batch_size_must_divide_by_the_data_axis(runs, world):
    for msg in _runs_of(runs, world, "divisibility"):
        assert msg is not None and "divisible" in msg


# ----------------------------------------------------------------------
# one rank, in this process
# ----------------------------------------------------------------------

@pytest.fixture
def one_rank():
    """A gloo group of this process alone; destroyed after the test."""
    Engine.reset()
    yield Engine.init_distributed(device="cpu")
    Engine.reset()


def _regularized_bn_model(inputs):
    model = child.loaded("bn", inputs)
    model[0].w_regularizer = optim.L2Regularizer(1e-2)
    model[3].set_scale_w(0.5)
    return model


ONE_RANK_CASES = {
    "sgd": ("xor", lambda: optim.SGD(0.1, momentum=0.9), 16),
    "adam": ("xor", lambda: optim.Adam(0.05), 8),
    "bn": ("bn", lambda: optim.SGD(0.1), 4),
}


@pytest.mark.parametrize("case", sorted(ONE_RANK_CASES))
def test_one_rank_is_local_bit_for_bit(one_rank, inputs, case):
    """A group of one sums one term and divides by 1: every loss,
    parameter, slot and buffer equals ``LocalOptimizer``'s bit for bit."""
    name, method, bsz = ONE_RANK_CASES[case]
    x, y = (child.xor_arrays(32, 3) if name == "xor"
            else child.bn_arrays(16))
    out = []
    for cls in (optim.LocalOptimizer, DistriOptimizer):
        model = child.loaded(name, inputs)
        if case == "bn":
            model = _regularized_bn_model(inputs)
        opt, losses = child.train(model, child.samples(x, y),
                                  nn.ClassNLLCriterion(), method(),
                                  optim.max_iteration(5), bsz,
                                  optimizer=cls)
        out.append((child.trained(opt, losses, model),
                    child.numpy_tree(opt.optim_method._slots)))
    (local, lslots), (distri, dslots) = out
    assert local["losses"] == distri["losses"]
    for key in ("params", "buffers"):
        _close(distri[key], local[key], rtol=0, atol=0)
    _close(dslots, lslots, rtol=0, atol=0)


def test_one_rank_validation_and_prediction_are_local(one_rank, inputs):
    model = child.loaded("xor", inputs)
    data = child.samples(*child.xor_arrays(10, 9))
    methods = [optim.Top1Accuracy(), optim.Loss(nn.ClassNLLCriterion())]
    want = optim.evaluate_dataset(model, data, methods, 4)
    got = optim.DistriValidator(model).test(data, methods, 4)
    assert [r.result() for r, _ in got] == [r.result() for r in want]
    mesh = Engine.default_mesh()
    np.testing.assert_array_equal(np.stack(model.predict(data, 3, mesh)),
                                  np.stack(model.predict(data, 3)))


def test_default_mesh_starts_a_group_of_one_and_reset_ends_it(inputs):
    import torch.distributed as dist

    Engine.reset()
    model = child.loaded("xor", inputs)
    opt = DistriOptimizer(model, child.samples(*child.xor_arrays(8, 1)),
                          nn.ClassNLLCriterion(), batch_size=8)
    opt.set_end_when(optim.max_iteration(1))
    try:
        opt.optimize()
        assert dist.is_initialized() and dist.get_backend() == "gloo"
        assert dist.get_world_size() == 1
        assert Engine.node_number() == 1 and Engine.core_number() == 1
        mesh = Engine.default_mesh()
        assert mesh.mesh_dim_names == ("data",) and mesh.size() == 1
    finally:
        Engine.reset()
    assert not dist.is_initialized()


# ----------------------------------------------------------------------
# (11) the Engine's errors, the knobs, the helpers
# ----------------------------------------------------------------------

@pytest.mark.parametrize("axis", ["model", "seq", "pipe"])
def test_create_mesh_refuses_the_model_axes(one_rank, axis):
    with pytest.raises(NotImplementedError, match="item 5d"):
        Engine.create_mesh(**{axis: 2})


def test_create_mesh_data_must_be_the_world(one_rank):
    assert Engine.create_mesh(data=1).size() == 1
    with pytest.raises(ValueError, match="processes"):
        Engine.create_mesh(data=2)


@pytest.mark.parametrize("backend", ["nccl", "cpu:gloo,cuda:nccl"])
def test_a_cpu_model_refuses_a_group_without_gloo(one_rank, inputs,
                                                  monkeypatch, backend):
    """A CPU model in an NCCL group raises; so would a CUDA model in a
    gloo group (``check_device_backend``), with no fallback."""
    import torch.distributed as dist

    from bigdl_tpu_torch.utils import engine

    monkeypatch.setattr(dist, "get_backend",
                        lambda *a: backend if backend == "nccl"
                        else "cpu:nccl,cuda:gloo")
    opt = DistriOptimizer(child.loaded("xor", inputs),
                          child.samples(*child.xor_arrays(8, 1)),
                          nn.ClassNLLCriterion(), batch_size=8)
    with pytest.raises(RuntimeError, match="needs a 'gloo' process group"):
        opt.optimize()
    monkeypatch.setattr(dist, "get_backend", lambda *a: "gloo")
    with pytest.raises(RuntimeError, match="needs a 'nccl' process group"):
        engine.check_device_backend(torch.device("cuda", 0))
    engine.check_device_backend(torch.device("cpu"))


def test_init_distributed_refuses_many_processes_without_an_address(
        monkeypatch):
    for var in ("MASTER_ADDR", "BIGDL_COORDINATOR_ADDRESS"):
        monkeypatch.delenv(var, raising=False)
    Engine.reset()
    with pytest.raises(ValueError, match="coordinator address"):
        Engine.init_distributed(num_processes=2, process_id=0, device="cpu")


def test_init_distributed_without_cuda_raises_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    Engine.reset()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine.init_distributed()


@pytest.mark.parametrize("knob,arg,item", [
    ("set_sparse_density", 0.1, "5c"), ("set_sync_period", 4, "5c"),
    ("set_sync_staleness", 1, "5c"), ("set_pipeline_microbatch", 2, "5d")])
def test_plan_engine_knobs_raise_naming_their_item(inputs, knob, arg, item):
    opt = DistriOptimizer(child.loaded("xor", inputs),
                          child.samples(*child.xor_arrays(8, 1)),
                          nn.ClassNLLCriterion(), batch_size=8)
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        getattr(opt, knob)(arg)


def test_retry_aliases_follow_set_retry_policy(inputs):
    from bigdl_tpu_torch.resilience.retry import RetryPolicy

    opt = DistriOptimizer(child.loaded("xor", inputs),
                          child.samples(*child.xor_arrays(8, 1)),
                          nn.ClassNLLCriterion(), batch_size=8)
    opt.set_retry_policy(RetryPolicy(max_retries=20, window=9.0))
    assert (opt.max_retry, opt.retry_window) == (20, 9.0)


def test_pad_batch_repeats_the_last_record():
    x = np.arange(10, dtype=np.float32).reshape(5, 2)
    y = np.array([1, 2, 3, 4, 5], np.float32)
    px, py, w = su.pad_batch([x, torch.from_numpy(x)], y, 5, 8)
    np.testing.assert_array_equal(px[0][5:], np.repeat(x[-1:], 3, 0))
    assert torch.equal(px[1], torch.from_numpy(px[0]))
    np.testing.assert_array_equal(py, [1, 2, 3, 4, 5, 5, 5, 5])
    np.testing.assert_array_equal(w, [1, 1, 1, 1, 1, 0, 0, 0])
    assert su.round_up(5, 4) == 8 and su.round_up(8, 4) == 8
    assert su.maskable((y, x), 5) and not su.maskable(np.float32(1), 5)
    rows = su.rows_of({"a": px[0]}, 1, 4)
    np.testing.assert_array_equal(rows["a"].numpy(), px[0][2:4])


def test_allreduce_parameter_flattens_and_restores_the_tree():
    tree = {"w": torch.arange(6.).reshape(2, 3),
            "sub": {"b": torch.arange(3, dtype=torch.float64)}}
    arp = AllReduceParameter(tree, 4, compress="none")
    assert (arp.size, arp.padded, arp.slice_size) == (9, 12, 3)
    flat = arp.flatten(tree)
    assert flat.dtype == torch.float32 and flat.shape == (12,)
    back = arp.unflatten(flat)
    assert back["sub"]["b"].dtype == torch.float64
    _close(child.numpy_tree(back), child.numpy_tree(tree), rtol=0, atol=0)
    slots = arp.init_slices(optim.Adam(0.1), tree)
    assert {tuple(t.shape) for t in jax.tree_util.tree_leaves(
        child.numpy_tree(slots))} <= {(3,), ()}
    with pytest.raises(ValueError):
        AllReduceParameter(tree, 2, compress="fp8")


def test_model_broadcast_binds_a_skeleton_to_the_weights(one_rank, inputs):
    model = child.loaded("bn", inputs)
    mb = ModelBroadcast().broadcast(model)
    assert all(p.device.type == "meta" for p in mb._skeleton.parameters())
    copy = mb.value()
    assert copy is not model
    _close(child.numpy_tree(copy.param_tree()),
           child.numpy_tree(model.param_tree()), rtol=0, atol=0)
    _close(child.numpy_tree(copy.buffer_tree()),
           child.numpy_tree(model.buffer_tree()), rtol=0, atol=0)
    x = torch.from_numpy(child.bn_arrays(4)[0])
    model.evaluate()
    assert torch.equal(copy.evaluate().forward(x), model.forward(x))


def test_data_mesh_refuses_non_meshes():
    with pytest.raises(TypeError):
        su.data_mesh(object())
    assert su.data_mesh(None) is None


def test_shard_batch_on_one_rank_is_the_whole_batch(one_rank):
    from bigdl_tpu_torch.parallel import shard_batch

    x = np.arange(12, dtype=np.float32).reshape(6, 2)
    got = shard_batch(Engine.default_mesh(), (x, [x[:, 0]]))
    np.testing.assert_array_equal(got[0].numpy(), x)
    np.testing.assert_array_equal(got[1][0].numpy(), x[:, 0])
    assert isinstance(got[1], list)
