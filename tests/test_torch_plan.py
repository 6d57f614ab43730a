"""The port's sharding-plan engine (``bigdl_tpu_torch/parallel/plan.py``,
``parallel/spmd.py``) against the JAX package's, on the CPU, in one
process: ``tests/test_sharding_plan.py``'s rule, degrade, collective-
bytes and FSDP-spec cases on mesh shapes (the port's plan binds to axis
names and sizes, so ``data=8`` and ``data=2 × model=4`` need no process
group); the ResNet-50 golden table; the port's ``derive_plan`` table
against the JAX package's live table for the port-built twin of
ResNet-50, a small TransformerLM, LeNet-5 and Inception v1 at data 1, 2,
4 and 8, with and without an FSDP threshold; the knobs and meshes that
stay refused, each naming its ROADMAP item.

The multi-rank FSDP training is ``tests/test_torch_fsdp.py``'s.
"""
import json
import logging
import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as JP

from bigdl_tpu import nn as jnn
from bigdl_tpu.parallel import plan as jplan
from bigdl_tpu.parallel import spmd as jspmd
from bigdl_tpu.utils.rng import RNG as JRNG
from bigdl_tpu_torch import nn, optim
from bigdl_tpu_torch.parallel import spmd
from bigdl_tpu_torch.parallel.plan import (MeshShape, P, Plan, Rule,
                                           compile_step_with_plan,
                                           derive_plan, match_partition_rules,
                                           mesh_shape, named_leaves,
                                           spec_table)

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
DATA_SIZES = (1, 2, 4, 8)


def _jmesh(**sizes):
    n = int(np.prod(list(sizes.values())))
    return Mesh(np.array(jax.devices()[:n]).reshape(tuple(sizes.values())),
                tuple(sizes))


# ---------------------------------------------------------------------------
# rule matching, degrade, collective bytes (tests/test_sharding_plan.py)
# ---------------------------------------------------------------------------

def test_match_partition_rules_order_scalars_and_unmatched():
    tree = {"0": {"weight": np.zeros((8, 4), np.float32),
                  "bias": np.zeros((8,), np.float32)},
            "t": np.float32(0.0)}  # scalar: never partitioned
    rules = [Rule(r"0/weight", P("model", None)), Rule(r".*", P())]
    specs = match_partition_rules(rules, tree)
    assert specs["0"]["weight"] == P("model", None)
    assert specs["0"]["bias"] == P()
    assert specs["t"] == P()
    rules2 = [Rule(r"weight", P("model", None)),
              Rule(r"0/weight", P(None, "model")), Rule(r".*", P())]
    assert match_partition_rules(rules2, tree)["0"]["weight"] == \
        P("model", None)
    with pytest.raises(ValueError, match="no partition rule"):
        match_partition_rules([Rule(r"nothing", P())], tree)
    # the same specs as the JAX package's, as strings
    jspecs = jplan.match_partition_rules(
        [jplan.Rule(r"0/weight", JP("model", None)),
         jplan.Rule(r".*", JP())], tree)
    assert spec_table(specs) == jplan.spec_table(jspecs)


def test_plan_degrades_missing_axes_with_warning(caplog):
    tree = {"w": np.zeros((8, 4), np.float32)}
    plan = Plan([Rule(r"w", P("model", None)), Rule(r".*", P())],
                mesh=MeshShape(data=8))
    with caplog.at_level(logging.WARNING, logger="bigdl_tpu_torch"):
        specs = plan.param_specs(tree)
    assert specs["w"] == P(None, None)
    assert specs["w"] != P()  # the JAX spec's strict equality
    assert any("model" in r.message and "not in mesh" in r.message
               for r in caplog.records)


def test_resolve_axes_warns_on_dropped_bound_axis(caplog):
    """A model built for a ring sequence strategy on a mesh without a
    seq axis: the dropped bound axis is named; unbound ones drop
    silently."""
    model = nn.Sequential(nn.Linear(4, 8, device="cpu"))
    model.seq_strategy = "ring"
    with caplog.at_level(logging.WARNING, logger="bigdl_tpu_torch"):
        d, s, m = spmd._resolve_axes(MeshShape(data=8), "data", "seq",
                                     "model", bound=spmd.bound_axes(model))
    assert (d, s, m) == ("data", None, None)
    assert any("'seq'" in r.message for r in caplog.records)
    assert not any("'model'" in r.message for r in caplog.records)


def _tree_bytes(tree):
    return sum(int(np.prod(a.shape)) * np.dtype(a.dtype).itemsize
               for _, a in named_leaves(tree))


def test_collective_bytes_matches_data_ring_on_pure_dp():
    tree = {"w": np.zeros((64, 32), np.float32),
            "b": np.zeros((64,), np.float32)}
    plan = Plan([Rule(r".*", P())], mesh=MeshShape(data=8))
    want = 2.0 * 7 / 8 * _tree_bytes(tree)
    assert plan.collective_bytes(tree) == pytest.approx(want)
    assert plan.collective_bytes(tree) == jplan.Plan(
        [jplan.Rule(r".*", JP())], mesh=_jmesh(data=8)).collective_bytes(
        tree)


def test_collective_bytes_counts_tp_and_fsdp():
    w = np.zeros((64, 32), np.float32)          # 8192 bytes
    tree = {"tp": w, "fsdp": w, "repl": w}
    plan = Plan([Rule(r"tp", P("model", None)),
                 Rule(r"fsdp", P("data", None), fsdp=True),
                 Rule(r".*", P())], mesh=MeshShape(data=2, model=4))
    nb = float(w.nbytes)
    want = (2 * 0.5 * nb / 4) + (2 * 0.5 * nb + 2 * 0.75 * nb / 2) \
        + (2 * 7 / 8 * nb)
    assert plan.collective_bytes(tree) == pytest.approx(want)
    jp = jplan.Plan([jplan.Rule(r"tp", JP("model", None)),
                     jplan.Rule(r"fsdp", JP("data", None), fsdp=True),
                     jplan.Rule(r".*", JP())], mesh=_jmesh(data=2, model=4))
    assert plan.collective_bytes(tree) == jp.collective_bytes(tree)
    assert plan.table(tree) == jp.table(tree)


def test_fsdp_specs_shard_large_leaves_only():
    model = nn.Sequential(nn.Linear(256, 512, device="cpu"),
                          nn.Tanh(device="cpu"),
                          nn.Linear(512, 2, device="cpu"))
    plan = derive_plan(model, MeshShape(data=8), fsdp_min_bytes=64 * 1024)
    table = plan.table(model.param_tree())
    assert "[fsdp]" in table["0/weight"]   # 512x256 f32 = 512 KiB
    assert "data" in table["0/weight"]
    assert table["0/bias"] == "replicated | dense | step"
    assert table["2/weight"] == "replicated | dense | step"


def test_sparse_and_sync_vocabulary_and_sizing():
    """The rule vocabulary's rejections, and the sparse and periodic
    sizing (``sparse_bytes_saved``, ``sync_bytes_saved``) equal to the
    JAX plan's on a data=8 table of 4096 × 16."""
    with pytest.raises(ValueError, match="unknown gradient"):
        Plan([Rule(".*", P(), transport="rdma")])
    with pytest.raises(ValueError, match="fsdp=True"):
        Plan([Rule(".*", P("data"), fsdp=True, transport="sparse")])
    with pytest.raises(ValueError, match="unknown synchrony"):
        Plan([Rule(".*", P(), sync="eventually")])
    with pytest.raises(ValueError, match="SPARSE"):
        Plan([Rule(".*", P(), sync="stale(2)")])
    tree = {"table": np.zeros((4096, 16), np.float32),
            "mlp": np.zeros((16, 16), np.float32)}
    for sync in ("step", "stale(2)", "periodic(4)"):
        rules = [Rule(r"table", P(), transport="sparse", sync=sync),
                 Rule(r"mlp", P(), sync="periodic(2)"), Rule(".*", P())]
        jrules = [jplan.Rule(r.pattern, JP(*r.spec), r.fsdp, r.reason,
                             r.transport, r.sync) for r in rules]
        plan = Plan(rules, mesh=MeshShape(data=8), sparse_density=1 / 64)
        jp = jplan.Plan(jrules, mesh=_jmesh(data=8), sparse_density=1 / 64)
        assert plan.table(tree) == jp.table(tree)
        for fn in ("collective_bytes", "sparse_bytes_saved",
                   "sync_bytes_saved"):
            assert getattr(plan, fn)(tree) == getattr(jp, fn)(tree), fn
        assert plan.has_sparse(tree) and plan.has_relaxed(tree)


# ---------------------------------------------------------------------------
# the ResNet-50 golden table and the live JAX tables of the twins
# ---------------------------------------------------------------------------

def test_golden_resnet50_table():
    """``derive_plan`` at data=8 with the 1 MiB threshold: every row of
    ``tests/fixtures/plan_resnet50.json``, string for string."""
    from bigdl_tpu_torch.models.resnet import ResNet50

    model = ResNet50(class_num=1000, device="cpu")
    table = derive_plan(model, MeshShape(data=8),
                        fsdp_min_bytes=1 << 20).table(model.param_tree())
    with open(os.path.join(FIXTURES, "plan_resnet50.json")) as f:
        want = json.load(f)
    assert table == want
    assert sum(row.endswith("[fsdp]") for row in table.values()) > 0


def _twins(name):
    """(port model, JAX model, FSDP threshold) of one architecture."""
    JRNG().set_seed(1)
    if name == "resnet50":
        from bigdl_tpu.models.resnet import ResNet50 as J
        from bigdl_tpu_torch.models.resnet import ResNet50 as T

        return T(class_num=1000, device="cpu"), J(class_num=1000), 1 << 20
    if name == "transformerlm":
        from bigdl_tpu.models.transformer import TransformerLM as J
        from bigdl_tpu_torch.models.transformer import TransformerLM as T

        kw = dict(embed_dim=64, num_heads=4, num_layers=2, max_len=16)
        return T(50, device="cpu", **kw), J(50, **kw), 8192
    if name == "lenet5":
        from bigdl_tpu.models.lenet import LeNet5 as J
        from bigdl_tpu_torch.models.lenet import LeNet5 as T

        return T(10, device="cpu"), J(10), 4096
    from bigdl_tpu.models.inception import InceptionV1NoAuxClassifier as J
    from bigdl_tpu_torch.models.inception import \
        InceptionV1NoAuxClassifier as T

    return T(1000, device="cpu"), J(1000), 1 << 20


@pytest.fixture(scope="module")
def twins():
    return {}


@pytest.mark.parametrize("fsdp", [None, "threshold"])
@pytest.mark.parametrize("n_data", DATA_SIZES)
@pytest.mark.parametrize("name", ["resnet50", "transformerlm", "lenet5",
                                  "inception_v1"])
def test_derive_plan_table_equals_the_jax_table(twins, name, n_data, fsdp):
    """Every row of the port's table for the port-built model equals the
    JAX package's live table for its twin on a data mesh of the same
    size; so do the collective bytes."""
    if name not in twins:
        twins[name] = _twins(name)
    model, jm, threshold = twins[name]
    min_bytes = threshold if fsdp else None
    tree, jtree = model.param_tree(), jm.param_tree()
    assert {n: tuple(t.shape) for n, t in named_leaves(tree)} == \
        {n: tuple(a.shape) for n, a in jplan.named_leaves(jtree)}
    got = derive_plan(model, MeshShape(data=n_data),
                      fsdp_min_bytes=min_bytes)
    want = jplan.derive_plan(jm, _jmesh(data=n_data),
                             fsdp_min_bytes=min_bytes)
    assert got.table(tree) == want.table(jtree)
    assert got.collective_bytes(tree) == want.collective_bytes(jtree)
    if fsdp and n_data > 1:
        assert got.has_fsdp(tree)


def test_spmd_param_specs_and_slot_specs_match_jax():
    """``param_specs`` of a container with its own parameter (the
    TransformerLM's ``pos``) and ``slot_specs`` of Adam's slots: the JAX
    spec tables."""
    from bigdl_tpu.models.transformer import TransformerLM as J
    from bigdl_tpu.optim import Adam as JAdam
    from bigdl_tpu_torch.models.transformer import TransformerLM as T

    kw = dict(embed_dim=16, num_heads=2, num_layers=1, max_len=8)
    model, jm = T(11, device="cpu", **kw), J(11, **kw)
    specs = spmd.param_specs(model)
    assert spec_table(specs) == jplan.spec_table(jspmd.param_specs(jm))
    plan = derive_plan(model, MeshShape(data=4), fsdp_min_bytes=256)
    jp = jplan.derive_plan(jm, _jmesh(data=4), fsdp_min_bytes=256)
    slots = spmd.slot_specs(optim.Adam().init_state(model.param_tree()),
                            plan.param_specs(model.param_tree()))
    jslots = jspmd.slot_specs(JAdam().init_state(jm.param_tree()),
                              jp.param_specs(jm.param_tree()))
    assert spec_table(slots) == jplan.spec_table(jslots)
    assert spmd.bound_axes(model) == jspmd.bound_axes(jm) == frozenset()


def test_mesh_shape_of_a_device_mesh(group1):
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh("cpu", (1, 1, 1, 1),
                            mesh_dim_names=("data", "model", "seq", "pipe"))
    shape = mesh_shape(mesh)
    assert shape.shape == {"data": 1, "model": 1, "seq": 1, "pipe": 1}
    assert mesh_shape({"data": 2}) == MeshShape(data=2)
    assert MeshShape(data=2, model=4).size == 8


# ---------------------------------------------------------------------------
# routing and refusals (tests/test_sharding_plan.py:478-498)
# ---------------------------------------------------------------------------

@pytest.fixture
def group1(tmp_path):
    from bigdl_tpu_torch.utils.engine import Engine

    Engine.reset()
    Engine.init_distributed(f"file://{tmp_path / 'store'}", 1, 0,
                            device="cpu")
    yield
    Engine.reset()


def test_normalize_mesh_drops_size_one_axes(group1):
    from torch.distributed.device_mesh import init_device_mesh

    from bigdl_tpu_torch.optim.distri_optimizer import normalize_mesh

    m = normalize_mesh(init_device_mesh(
        "cpu", (1, 1, 1, 1), mesh_dim_names=("data", "model", "seq",
                                             "pipe")))
    assert tuple(m.mesh_dim_names) == ("data",) and m.size() == 1
    m3 = normalize_mesh(init_device_mesh("cpu", (1, 1),
                                         mesh_dim_names=("data", "pipe")))
    assert tuple(m3.mesh_dim_names) == ("data",) and m3.size() == 1


def _xor():
    cpu = dict(device="cpu")
    return nn.Sequential(nn.Linear(2, 8, **cpu), nn.Tanh(**cpu),
                         nn.Linear(8, 2, **cpu), nn.LogSoftMax(**cpu))


@pytest.mark.parametrize("sizes,item", [
    (dict(data=2, seq=2, pipe=2), "5d"), (dict(data=2, model=4), "5d"),
    (dict(data=1, pipe=2), "5d")])
def test_non_data_meshes_raise_naming_their_item(sizes, item):
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        compile_step_with_plan(_xor(), nn.ClassNLLCriterion(), optim.SGD(),
                               MeshShape(**sizes))
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        spmd.make_train_step(_xor(), nn.ClassNLLCriterion(), optim.SGD(),
                             MeshShape(**sizes))


@pytest.mark.parametrize("rule", [
    Rule(r"0/weight", P(), transport="sparse"),
    Rule(r"0/weight", P(), sync="periodic(2)"),
    Rule(r"0/weight", P(), transport="sparse", sync="stale(1)")])
def test_engaged_sparse_or_relaxed_rules_raise(rule):
    """On a data axis above 1 a sparse or relaxed rule raises (ROADMAP
    item 5c); on one device the JAX single path clears it, and so does
    the port's."""
    plan = Plan([rule, Rule(".*", P())])
    with pytest.raises(NotImplementedError, match="item 5c"):
        compile_step_with_plan(_xor(), nn.ClassNLLCriterion(), optim.SGD(),
                               MeshShape(data=2), plan=plan)
    eng = compile_step_with_plan(_xor(), nn.ClassNLLCriterion(),
                                 optim.SGD(), None, plan=plan)
    assert eng.single and not eng.has_fsdp


def test_derive_plan_pipe_axis_raises():
    with pytest.raises(NotImplementedError, match="item 5d"):
        derive_plan(_xor(), MeshShape(data=2, pipe=2), pipe_axis="pipe",
                    n_pipe=2)


@pytest.mark.parametrize("knob,arg,item", [
    ("set_sparse_density", 0.1, "5c"), ("set_sync_period", 4, "5c"),
    ("set_sync_staleness", 1, "5c"), ("set_pipeline_microbatch", 2, "5d")])
def test_unported_knobs_raise_on_local_optimizer(knob, arg, item):
    from bigdl_tpu_torch.dataset import Sample, array

    opt = optim.LocalOptimizer(_xor(), array([Sample(
        np.zeros(2, np.float32), 1.0)] * 4), nn.ClassNLLCriterion(),
        batch_size=4)
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        getattr(opt, knob)(arg)


def _local_run(setup=None, steps=3):
    from bigdl_tpu_torch.dataset import Sample, array
    from bigdl_tpu_torch.telemetry import MetricsRegistry, Telemetry
    from bigdl_tpu_torch.utils.rng import RNG

    g = torch.Generator().manual_seed(3)
    cpu = dict(device="cpu", generator=g)
    model = nn.Sequential(nn.Linear(256, 512, **cpu), nn.Tanh(device="cpu"),
                          nn.Linear(512, 2, **cpu),
                          nn.LogSoftMax(device="cpu"))
    rng = np.random.RandomState(0)
    xs = rng.rand(32, 256).astype(np.float32)
    ys = (1 + (xs.sum(1) > 128)).astype(np.float32)
    opt = optim.LocalOptimizer(model, array([Sample(a, b) for a, b in
                                             zip(xs, ys)]),
                               nn.ClassNLLCriterion(), batch_size=32)
    opt.set_optim_method(optim.SGD(0.2)).set_end_when(
        optim.max_iteration(steps))
    tm = Telemetry(registry=MetricsRegistry())
    opt.set_telemetry(tm)
    if setup is not None:
        setup(opt)
    RNG().set_seed(1)
    opt.optimize()
    snap = tm.registry.snapshot()["metrics"]
    gauges = {k: snap[k]["series"][0]["value"] for k in (
        "bigdl_plan_param_bytes_per_device", "bigdl_plan_param_bytes_total",
        "bigdl_perf_collective_bytes")}
    return model, opt, gauges


def test_local_optimizer_derives_reports_and_clears_fsdp():
    """``LocalOptimizer`` with ``set_fsdp`` and a derived plan: the plan
    is derived (the table shows no ``[fsdp]`` row at data 1) and the
    run equals the planless one bit for bit; per-device bytes = total,
    collective bytes 0 (the JAX single-device path)."""
    plain, _, plain_g = _local_run()
    model, opt, gauges = _local_run(
        lambda o: o.set_fsdp(1024).set_sharding_plan(derive_plan(
            o.model, MeshShape(data=8), fsdp_min_bytes=1024)))
    for a, b in zip(plain.parameters(), model.parameters()):
        assert torch.equal(a, b)
    assert not any(r.endswith("[fsdp]") for r in opt.engine.table.values())
    assert opt.engine.single and not opt.engine.has_fsdp
    assert gauges == plain_g
    assert gauges["bigdl_plan_param_bytes_per_device"] == \
        gauges["bigdl_plan_param_bytes_total"] == 4 * (256 * 512 + 512
                                                       + 512 * 2 + 2)
    assert gauges["bigdl_perf_collective_bytes"] == 0
    assert opt.engine.last_grad_norm is not None


def test_make_train_step_and_eval_forward_match_jax():
    """``spmd.make_train_step`` (the plan step, guard and norm off) and
    ``make_eval_forward`` on one device against the JAX entry points on a
    one-device data mesh: one SGD step's loss and parameters, then the
    forward with them."""
    from bigdl_tpu.optim import SGD as JSGD
    from bigdl_tpu_torch.interop import load_param_tree

    JRNG().set_seed(5)
    jm = jnn.Sequential(jnn.Linear(2, 8), jnn.Tanh(), jnn.Linear(8, 2),
                        jnn.LogSoftMax())
    model = load_param_tree(_xor(), jax.tree_util.tree_map(
        np.asarray, jm.param_tree()))
    rng = np.random.RandomState(0)
    x = rng.rand(8, 2).astype(np.float32)
    y = (rng.randint(0, 2, 8) + 1).astype(np.float32)
    mesh = _jmesh(data=1)
    jstep = jspmd.make_train_step(jm, jnn.ClassNLLCriterion(), JSGD(), mesh)
    jparams, jbuf = jm.param_tree(), jm.buffer_tree()
    jloss, jparams, _, _ = jstep(jparams, JSGD().init_state(jparams), jbuf,
                                 0.1, x, y)
    step = spmd.make_train_step(model, nn.ClassNLLCriterion(), optim.SGD(),
                                None)
    params, slots = step.engine.init_state()
    loss, params, _ = step(params, slots, 0.1, torch.from_numpy(x),
                           torch.from_numpy(y))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    want = dict(jplan.named_leaves(jparams))
    for n, got in named_leaves(params):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want[n]),
                                   rtol=1e-5, atol=1e-7, err_msg=n)
    jfwd = jspmd.make_eval_forward(jm, mesh, input_seq_dim=None)
    fwd = spmd.make_eval_forward(model, None)
    np.testing.assert_allclose(
        fwd(params, model.buffer_tree(), torch.from_numpy(x)).numpy(),
        np.asarray(jfwd(jparams, jbuf, x)), rtol=1e-5, atol=1e-6)
