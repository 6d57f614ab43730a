"""The port's work accounting (``bigdl_tpu_torch/telemetry/perf.py`` +
``device_info.py``, the kernels' work reports, the drivers' and the
server's use of them) against the JAX package's, on the CPU.

The JAX package reads XLA's cost model of the lowered step; the port
counts the eager step it runs (``torch.utils.flop_counter``'s products,
each aten op's bytes, each kernel by its shapes).  Mirrored from
``tests/test_perf_accounting.py``: the device table (plus the H100
row), the small step's count, the failure contract, the memory gauges,
the roofline boundaries (equal on both sides), the drivers' MFU family
and step-span attributes, the server's bucket FLOPs and goodput per
chip, the cross-host perf fold and report (equal on both sides), and
the derived-vs-analytic cross-checks for ResNet-50 and the
TransformerLM (the JAX side's own 6ND assertion on XLA's count beside
the port's count: the exact product count, within 5 % of XLA's and of
6 · N · B · T with N less the lookup tables plus attention's products).
Also held: flash attention counts as dense attention, a Linear's bytes
by hand, the block-sparse corrections by ``attention_work`` and
``matmul_work`` (``tests/test_block_sparse.py``'s accountant specs on
both sides), and K5 as the convolution it replaces.

Not mirrored: ``analyze_compiled`` (the port compiles no program to
analyze), the ledger-schema and perf-sentinel specs (``bench.py`` and
``tools/perf_sentinel.py``, the JAX bench's), and the data-parallel
wire estimate, held over 2 gloo ranks in ``tests/test_torch_telemetry.py``.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bigdl_tpu.telemetry as jtel
import bigdl_tpu.telemetry.perf  # noqa: F401 (T.perf below)
import bigdl_tpu_torch.telemetry as ttel
import bigdl_tpu_torch.telemetry.perf  # noqa: F401
from bigdl_tpu.telemetry.perf import cost_from_analysis
from bigdl_tpu_torch.telemetry.device_info import (
    CPU_SPEC, DeviceSpec, current_device_spec, device_spec,
    peak_flops_per_sec)
from bigdl_tpu_torch.telemetry.perf import (PerfAccountant, StepCost,
                                            classify_roofline,
                                            WorkCounter)
from bigdl_tpu_torch.telemetry.registry import MetricsRegistry

torch.set_num_threads(1)

REPO = os.path.join(os.path.dirname(__file__), "..")
PACKAGES = {"jax": jtel, "port": ttel}


def _bench():
    spec = importlib.util.spec_from_file_location(
        "bench", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _both(scenario):
    got = {name: scenario(pkg) for name, pkg in PACKAGES.items()}
    assert got["port"] == got["jax"]
    return got["port"]


# ---------------------------------------------------------------------------
# device_info: the one peak table, with the H100's row
# ---------------------------------------------------------------------------

def test_device_table_lookup_matches_jax_and_adds_h100():
    from bigdl_tpu.telemetry import device_info as jdev

    for kind in ("TPU v5 lite", "TPU v4", "TPU v6e", "v5p", "weird", "cpu",
                 "host", ""):
        assert device_spec(kind) == jdev.device_spec(kind), kind
        assert peak_flops_per_sec(kind) == jdev.peak_flops_per_sec(kind)
    assert peak_flops_per_sec("TPU v5 lite") == 197e12
    assert peak_flops_per_sec("cpu") is None
    assert device_spec("cpu").nominal is True
    h100 = device_spec("NVIDIA H100 80GB HBM3")
    assert h100 == DeviceSpec("h100", 989e12, 80e9, 3.35e12, 900e9)
    assert peak_flops_per_sec("NVIDIA H100 80GB HBM3") == 989e12


def test_device_spec_ridge_point():
    spec = device_spec("TPU v5e")
    assert spec.peak_flops_per_sec == 197e12
    assert spec.hbm_bytes == 16 * 1024 ** 3
    assert 200 < spec.ridge_flops_per_byte < 280
    assert device_spec("NVIDIA H100 80GB HBM3").ridge_flops_per_byte == \
        pytest.approx(989e12 / 3.35e12)
    # the CPU and the default device here (no card) read the nominal row
    for live in (current_device_spec("cpu"), current_device_spec()):
        assert live is CPU_SPEC and live.nominal is True


# ---------------------------------------------------------------------------
# the count of a small step
# ---------------------------------------------------------------------------

def test_count_of_a_small_step_against_xla():
    w, x = np.ones((64, 64), np.float32), np.ones((32, 64), np.float32)
    jcost = jtel.PerfAccountant(registry=jtel.MetricsRegistry(),
                                spec=jtel.device_info.CPU_SPEC).analyze_jitted(
        jax.jit(lambda w, x: jnp.tanh(x @ w).sum()), jnp.asarray(w),
        jnp.asarray(x), label="tiny")
    pa = PerfAccountant(registry=MetricsRegistry(), spec=CPU_SPEC)
    tw, tx = torch.from_numpy(w), torch.from_numpy(x)
    out, cost = pa.analyze_step(lambda: torch.tanh(tx @ tw).sum(),
                                label="tiny")
    assert out.item() == 32 * 64.0 * np.tanh(64.0)
    # the products only (the JAX count adds tanh and the sum)
    assert cost.flops == 2 * 32 * 64 * 64
    assert cost.flops == pytest.approx(jcost.flops, rel=0.05)
    # mm reads x, w, writes y; tanh reads y, writes t; sum reads t
    assert cost.bytes_accessed == 4 * (32 * 64 + 64 * 64 + 32 * 64
                                       + 2 * 32 * 64 + 32 * 64 + 1)
    assert cost.arithmetic_intensity > 0 and cost.source == "counted"
    snap = pa.registry.snapshot()["metrics"]
    series = snap["bigdl_perf_flops_per_step"]["series"]
    assert series == [dict(labels={"program": "tiny"}, value=cost.flops)]
    pa.on_step(0.01)
    snap = pa.registry.snapshot()["metrics"]
    assert snap["bigdl_perf_mfu"]["series"][0]["value"] == pytest.approx(
        cost.flops / 0.01 / CPU_SPEC.peak_flops_per_sec)
    assert snap["bigdl_perf_flops_total"]["series"][0]["value"] == cost.flops


def test_analyze_step_runs_once_and_propagates_the_step_error():
    pa = PerfAccountant(registry=MetricsRegistry(), spec=CPU_SPEC)
    pa.on_step(0.5)   # no program installed: a silent no-op
    assert pa.current_cost is None and pa.flops_total.value == 0.0
    calls = []

    def run():
        calls.append(1)
        return "out"

    assert pa.analyze_step(run, label="p")[0] == "out" and calls == [1]
    assert pa.current_label == "p" and pa.current_cost.flops == 0.0

    def boom():
        raise RuntimeError("step failed")

    with pytest.raises(RuntimeError, match="step failed"):
        pa.analyze_step(boom, label="q")
    assert pa.current_label == "p"


def test_linear_bytes_equal_a_hand_count():
    """A Linear's forward is a matmul and a bias add (W's transpose is a
    view, which moves nothing): the matmul reads x and W and writes xWᵀ,
    the add reads xWᵀ and the bias and writes y."""
    from bigdl_tpu_torch import nn

    B, K, N = 5, 7, 3
    layer = nn.Linear(K, N, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    x = torch.randn(B, K)
    with WorkCounter() as c:
        layer(x)
    assert c.flops == 2 * B * K * N
    assert c.bytes == 4 * ((B * K + K * N + B * N) + (B * N + N + B * N))


# ---------------------------------------------------------------------------
# HBM watermark degradation (the CPU has no memory stats)
# ---------------------------------------------------------------------------

def test_memory_stats_none_on_cpu_does_not_crash():
    pa = PerfAccountant(registry=MetricsRegistry(), spec=CPU_SPEC)
    assert pa.poll_memory_stats() is None
    assert pa.poll_memory_stats(torch.device("cpu")) is None
    snap = pa.registry.snapshot()["metrics"]
    assert snap["bigdl_perf_hbm_peak_bytes"]["series"] == []
    assert pa.last_memory_stats is None


def test_memory_stats_gauges_from_a_reporting_device():
    class FakeDev:
        def memory_stats(self):
            return {"bytes_in_use": 1024, "peak_bytes_in_use": 4096,
                    "bytes_limit": 16 * 1024 ** 3}

    class RaisingDev:
        def memory_stats(self):
            raise RuntimeError("backend quirk")

    def scenario(T):
        pa = T.PerfAccountant(registry=T.MetricsRegistry(),
                              spec=T.device_info.CPU_SPEC)
        stats = pa.poll_memory_stats(device=FakeDev())
        assert stats["peak_bytes_in_use"] == 4096
        snap = pa.registry.snapshot()["metrics"]
        assert snap["bigdl_perf_hbm_peak_bytes"]["series"][0]["value"] == 4096
        assert snap["bigdl_perf_hbm_bytes_in_use"]["series"][0][
            "value"] == 1024
        assert pa.payload()["hbm"]["peak_bytes_in_use"] == 4096
        assert pa.poll_memory_stats(device=RaisingDev()) is None
        return pa.payload()

    _both(scenario)


# ---------------------------------------------------------------------------
# roofline classification boundaries
# ---------------------------------------------------------------------------

def test_roofline_boundaries():
    def scenario(T):
        spec = T.DeviceSpec("test", 100.0, 1000.0, 10.0, 1.0)
        cost = T.StepCost
        cases = [cost(flops=200.0, bytes_accessed=10.0),
                 cost(flops=50.0, bytes_accessed=100.0),
                 cost(flops=50.0, bytes_accessed=100.0,
                      collective_bytes=50.0),
                 cost(flops=0.0, bytes_accessed=0.0),
                 cost(flops=100.0, bytes_accessed=10.0)]
        got = [T.classify_roofline(c, spec) for c in cases]
        assert spec.ridge_flops_per_byte == 10.0
        assert [g["bound"] for g in got[:4]] == ["compute", "hbm",
                                                 "collective", "unknown"]
        assert got[0]["arithmetic_intensity"] == 20.0
        assert got[4]["bound"] in ("compute", "hbm")
        return got

    _both(scenario)
    assert classify_roofline(StepCost(989e12, 1e9),
                             device_spec("H100"))["bound"] == "compute"


# ---------------------------------------------------------------------------
# driver wiring: LocalOptimizer publishes the MFU family
# ---------------------------------------------------------------------------

def _fit_local(telemetry, steps=5):
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import Sample, array
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer, max_iteration

    rng = np.random.RandomState(0)
    x = rng.rand(128, 8).astype(np.float32)
    y = (x @ rng.rand(8, 1).astype(np.float32)).astype(np.float32)
    g = torch.Generator().manual_seed(0)
    model = nn.Sequential(nn.Linear(8, 16, device="cpu", generator=g),
                          nn.Tanh(device="cpu"),
                          nn.Linear(16, 1, device="cpu", generator=g),
                          device="cpu")
    opt = LocalOptimizer(model, array([Sample(a, b) for a, b in zip(x, y)]),
                         nn.MSECriterion(), batch_size=32)
    opt.set_optim_method(SGD(learning_rate=0.05))
    opt.set_end_when(max_iteration(steps))
    opt.set_telemetry(telemetry)
    opt.optimize()


def test_local_optimizer_publishes_mfu_family():
    tm = ttel.Telemetry(registry=MetricsRegistry())
    _fit_local(tm)
    snap = tm.registry.snapshot()["metrics"]
    flops = snap["bigdl_perf_flops_per_step"]["series"][0]
    assert flops["labels"] == {"program": "train_step"}
    # forward 2·32·(8·16 + 16·1); backward the weights' and the hidden
    # input's gradients (the data's is not taken)
    assert flops["value"] == 2 * 32 * (8 * 16 + 16) + 2 * 32 * (
        8 * 16 + 16 + 16)
    assert snap["bigdl_perf_bytes_per_step"]["series"][0]["value"] > 0
    assert snap["bigdl_perf_mfu"]["series"][0]["value"] > 0
    assert snap["bigdl_perf_flops_total"]["series"][0]["value"] == \
        5 * flops["value"]
    perf = tm.payload()["perf"]
    assert perf["programs"]["train_step"]["bound"] in ("compute", "hbm")
    assert perf["device"]["nominal"] is True


def test_step_spans_carry_static_work_attributes():
    tm = ttel.Telemetry(registry=MetricsRegistry())
    _fit_local(tm)
    steps = [s for s in tm.tracer.spans() if s.category == "step"]
    assert len(steps) == 4
    for s in steps:
        assert s.args["flops"] > 0 and s.args["bytes"] > 0
        assert s.args["bound"] in ("compute", "hbm", "collective")
    ev = [e for e in tm.tracer.to_chrome_trace()["traceEvents"]
          if e["cat"] == "step"]
    assert ev and ev[0]["args"]["flops"] > 0


# ---------------------------------------------------------------------------
# serving: per-bucket FLOPs -> goodput-per-chip
# ---------------------------------------------------------------------------

def test_serving_reports_bucket_flops_and_goodput_per_chip():
    """12 classify requests through both packages' servers: the port
    counts each bucket's forward once (2·B·(16·32 + 32·4) FLOPs), and
    its goodput per chip is a number against the nominal CPU row."""
    from bigdl_tpu import nn as jnn
    from bigdl_tpu.serving import InferenceServer as JServer
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.serving import InferenceServer

    g = torch.Generator().manual_seed(0)
    models = {
        "jax": (JServer, jnn.Sequential(jnn.Linear(16, 32), jnn.Tanh(),
                                        jnn.Linear(32, 4), jnn.LogSoftMax())),
        "port": (InferenceServer, nn.Sequential(
            nn.Linear(16, 32, device="cpu", generator=g),
            nn.Tanh(device="cpu"),
            nn.Linear(32, 4, device="cpu", generator=g),
            nn.LogSoftMax(device="cpu"), device="cpu"))}
    snaps = {}
    for name, (server, model) in models.items():
        srv = server(model, max_batch=8, max_queue=32)
        srv.start()
        try:
            rng = np.random.RandomState(0)
            futs = [srv.submit(rng.rand(16).astype(np.float32))
                    for _ in range(12)]
            assert all(f.result(timeout=60).ok for f in futs)
        finally:
            srv.stop(timeout=30)
        snap = srv.metrics.snapshot()
        gpc = srv.metrics.goodput_per_chip()
        assert snap["flops_total"] > 0 and snap["model_flops_per_sec"] >= 0
        assert gpc["flops_total"] == snap["flops_total"]
        if gpc["wall_s"] > 0:
            assert gpc["mfu"] is None or gpc["mfu"] > 0
        snaps[name] = (srv, gpc)
    srv, gpc = snaps["port"]
    buckets = dict(srv.metrics._bucket_flops)
    assert buckets and all(f == 2.0 * b * (16 * 32 + 32 * 4)
                           for b, f in buckets.items())
    assert gpc["nominal_device"] is True and gpc["mfu"] > 0


# ---------------------------------------------------------------------------
# derived vs analytic cross-checks
# ---------------------------------------------------------------------------

def test_resnet50_counted_flops_within_5pct_of_analytic():
    """One ResNet-50 training step at 224² on the CPU (B 1, the count
    is per image): the port's count within 5 % of bench.py's FMA = 2
    train-step convention, 2 × 4.09 GMAC × 3."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.models.resnet import ResNet50
    from bigdl_tpu_torch.utils.tree import tree_leaves

    bench = _bench()
    B = 1
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(B, 3, 224, 224).astype(np.float32))
    y = torch.from_numpy(rng.randint(1, 1001, B).astype(np.int64))
    model = ResNet50(1000, device="cpu",
                     generator=torch.Generator().manual_seed(0))
    params = model.param_tree()
    crit = nn.ClassNLLCriterion()
    with WorkCounter() as c:
        loss = crit._loss(model.apply_fn(params, x), y)
        torch.autograd.grad(loss, tree_leaves(params))
    analytic = (bench.RESNET50_FWD_FLOPS_PER_IMAGE
                * bench.TRAIN_FWD_MULTIPLIER * B)
    assert c.flops == pytest.approx(analytic, rel=0.05)


V, D, L, T, B = 1024, 128, 2, 256, 2


def _lm_step_count(strategy):
    """The port's count of one LocalOptimizer step of the JAX spec's
    TransformerLM (V 1024, D 128, 2 layers of 2 heads, T 256, B 2)."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import Sample, array
    from bigdl_tpu_torch.models.transformer import TransformerLM
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer, max_iteration

    model = TransformerLM(V, embed_dim=D, num_heads=2, num_layers=L,
                          max_len=T, seq_strategy=strategy, output="logits",
                          device="cpu",
                          generator=torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    x = rng.randint(1, V, (B, T)).astype(np.int32)
    y = rng.randint(1, V + 1, (B, T)).astype(np.int32)
    opt = LocalOptimizer(model, array([Sample(a, b) for a, b in zip(x, y)]),
                         nn.TimeDistributedCriterion(
                             nn.CrossEntropyCriterion(), True),
                         batch_size=B)
    opt.set_optim_method(SGD(0.01)).set_end_when(max_iteration(1))
    tm = ttel.Telemetry(registry=MetricsRegistry())
    opt.set_telemetry(tm)
    opt.optimize()
    return tm.perf.current_cost, sum(p.numel() for p in model.parameters())


def test_transformer_lm_counted_flops_against_6nd_and_xla():
    """The JAX spec's own assertion on XLA's count (within 5 % of 6ND
    over every parameter) beside the port's count of the same step: the
    exact product count, 3 × (2·B·T·(12·D²·L + D·V) + 4·B·T²·D·L), the
    same for "flash" as for "dense", within 5 % of XLA's, and within
    5 % of 6 · N · B · T with N less the token and position tables
    (looked up, never multiplied) plus attention's products.  Against
    6ND over every parameter it reads 0.946: XLA reaches 0.965 by
    counting elementwise work too."""
    from bigdl_tpu import nn as jnn
    from bigdl_tpu.models.transformer import TransformerLM as JLM
    from bigdl_tpu.optim import SGD as JSGD

    bench = _bench()
    jmodel = JLM(V, embed_dim=D, num_heads=2, num_layers=L, max_len=T,
                 seq_strategy="dense", output="logits")
    crit = jnn.TimeDistributedCriterion(jnn.CrossEntropyCriterion(), True)
    active = sum(a.size for a in jax.tree_util.tree_leaves(
        jmodel.param_tree()))
    rng = np.random.RandomState(0)
    x = jnp.asarray(rng.randint(1, V, (B, T)).astype(np.float32))
    y = jnp.asarray(rng.randint(1, V + 1, (B, T)).astype(np.float32))
    optim = JSGD(learning_rate=0.01)
    params, buffers = jmodel.param_tree(), jmodel.buffer_tree()
    _, one_step = bench._train_step_fn(jmodel, crit, optim)
    lowered = one_step.lower(params, buffers, optim.init_state(params),
                             jnp.float32(0.01), jax.random.PRNGKey(0), x, y)
    xla = cost_from_analysis(lowered.cost_analysis()).flops
    six_nd = 6.0 * active * B * T
    assert xla == pytest.approx(six_nd, rel=0.05)

    dense, n_params = _lm_step_count("dense")
    flash, _ = _lm_step_count("flash")
    assert n_params == active
    exact = 3 * (2 * B * T * (12 * D * D * L + D * V) + 4 * B * T * T * D * L)
    assert dense.flops == flash.flops == exact
    assert dense.flops == pytest.approx(xla, rel=0.05)
    tables = (V + T) * D
    assert dense.flops == pytest.approx(
        6.0 * (n_params - tables) * B * T + 12.0 * B * T * T * D * L,
        rel=0.05)
    assert dense.flops / six_nd == pytest.approx(0.946, abs=1e-3)


# ---------------------------------------------------------------------------
# kernels counted by their shapes
# ---------------------------------------------------------------------------

def test_k5_counts_as_the_convolution_it_replaces():
    """K5's forward and backward (its plain version on the CPU, dW by
    nine matmuls over padded rows) count the products of the 3×3 conv
    they replace, as ``F.conv2d`` and its backward count them."""
    from bigdl_tpu_torch.ops.conv3x3 import conv3x3_s1_same

    rng = np.random.RandomState(0)
    x = rng.randn(2, 6, 5, 4).astype(np.float32)
    w = rng.randn(3, 3, 4, 8).astype(np.float32)
    g = rng.randn(2, 6, 5, 8).astype(np.float32)
    got = []
    for conv in ("k5", "aten"):
        xt = torch.tensor(x, requires_grad=True)
        wt = torch.tensor(w, requires_grad=True)
        with WorkCounter() as c:
            if conv == "k5":
                y = conv3x3_s1_same(xt, wt)
                y.backward(torch.from_numpy(g))
            else:
                y = torch.nn.functional.conv2d(
                    xt.permute(0, 3, 1, 2), wt.permute(3, 2, 0, 1), padding=1)
                y.backward(torch.from_numpy(g).permute(0, 3, 1, 2))
        got.append(c.flops)
    assert got[0] == got[1] == 3 * 18 * 2 * 6 * 5 * 4 * 8


def test_report_sparse_flops_gauge_payload_and_mfu_basis():
    """``tests/test_block_sparse.py``'s accountant spec on both sides."""
    def scenario(T):
        pa = T.PerfAccountant(registry=T.MetricsRegistry(),
                              spec=T.device_info.CPU_SPEC)
        pa.on_program("bs_step", T.StepCost(flops=100.0, bytes_accessed=10.0,
                                            source="given"))
        pa.report_sparse_flops("bs_step", executed_flops=50.0,
                               dense_equiv_flops=100.0)
        entry = pa.payload()["programs"]["bs_step"]
        assert entry["flops"] == entry["executed_flops"] == 150.0
        assert entry["dense_equivalent_flops"] == 200.0
        assert entry["sparse_flops_skipped"] == 50.0
        pa.report_sparse_flops("bs_step", 80.0, 100.0)
        entry = pa.payload()["programs"]["bs_step"]
        assert entry["flops"] == 180.0 and entry["sparse_flops_skipped"] == 20.0
        pa.on_step(1.0)
        snap = pa.registry.snapshot()["metrics"]
        rate = snap["bigdl_perf_model_flops_per_sec"]["series"][0]["value"]
        assert rate == pytest.approx(180.0)
        pa.on_program("bs_step", T.StepCost(flops=20.0, bytes_accessed=1.0,
                                            source="given"))
        fresh = pa.payload()["programs"]["bs_step"]
        assert fresh["flops"] == 20.0 and "sparse_flops_skipped" not in fresh
        return entry, fresh

    _both(scenario)


def test_block_sparse_corrections_equal_attention_and_matmul_work():
    """A block-sparse attention forward and backward, then a
    block-sparse matmul forward and dX, under ``analyze_step``: the
    count leaves the kernels' dense products out and books
    ``attention_work``'s training numbers plus ``matmul_work``'s (forward
    and dX) through ``report_sparse_flops``; the matmul's dW is a dense
    product outside the kernel and stays in the count."""
    from bigdl_tpu_torch.ops import block_sparse as bs

    rng = np.random.RandomState(0)
    Bq, H, Tq, Dh = 1, 2, 64, 16
    amask = bs.sliding_window_mask(4, 4, window=2, n_global=1)
    amask = bs.BlockMask(amask.mask, 16, 16)
    q, k, v = (torch.tensor(rng.randn(Bq, H, Tq, Dh).astype(np.float32),
                            requires_grad=True) for _ in range(3))
    w = torch.tensor(rng.randn(32, 48).astype(np.float32),
                     requires_grad=True)
    mmask = bs.magnitude_block_mask(w.detach().numpy(), 16, 16, 0.5)
    xm = torch.tensor(rng.randn(10, 32).astype(np.float32),
                      requires_grad=True)

    def step():
        o = bs.block_sparse_attention(q, k, v, amask, causal=True)
        o.sum().backward()
        bs.block_sparse_matmul(xm, w, mmask).sum().backward()

    pa = PerfAccountant(registry=MetricsRegistry(), spec=CPU_SPEC)
    with WorkCounter() as plain:
        step()
    _, cost = pa.analyze_step(step, label="bs")
    attn = bs.attention_work(amask, Bq, H, Dh, causal=True, train=True)
    mm = bs.matmul_work(mmask, 10)
    executed = attn["executed_flops"] + 2 * mm["executed_flops"]
    dense_eq = attn["dense_equivalent_flops"] + 2 * mm[
        "dense_equivalent_flops"]
    # the counter's dense products of the kernels: attention 12·B·H·T²·D,
    # the matmul 2·M·K·N forward and dX
    kernels = 12.0 * Bq * H * Tq * Tq * Dh + 2 * (2.0 * 10 * 32 * 48)
    base = plain.flops - kernels
    entry = pa.payload()["programs"]["bs"]
    assert base == 2.0 * 10 * 32 * 48          # the matmul's dW
    assert entry["flops"] == cost.flops == base + executed
    assert entry["dense_equivalent_flops"] == base + dense_eq
    assert entry["sparse_flops_skipped"] == dense_eq - executed > 0
    assert plain.executed_flops == base + executed


# ---------------------------------------------------------------------------
# cross-host perf fold + run report
# ---------------------------------------------------------------------------

def _payload(host, flops_total, wall, peak=100.0, hbm_peak=None):
    perf = {
        "device": {"kind": "test", "peak_flops_per_sec": peak,
                   "hbm_bytes": 1000.0, "hbm_bytes_per_sec": 10.0,
                   "ici_bytes_per_sec": 1.0, "nominal": False},
        "flops_total": flops_total,
        "programs": {"train_step": {
            "flops": 200.0, "bytes_accessed": 10.0,
            "collective_bytes": 0.0, "arithmetic_intensity": 20.0,
            "bound": "compute", "mfu": 0.5}},
    }
    if hbm_peak is not None:
        perf["hbm"] = {"peak_bytes_in_use": hbm_peak,
                       "bytes_limit": 4 * hbm_peak}
    return {"host": host, "incarnation": 0,
            "goodput": {"wall_s": wall, "seconds": {"productive": wall},
                        "productive_fraction": 1.0,
                        "accounted_fraction": 1.0},
            "metrics": {}, "span_totals": {"step": wall}, "perf": perf}


def test_merge_perf_cluster_mfu_and_report():
    from bigdl_tpu.telemetry import report as jreport
    from bigdl_tpu_torch.telemetry import report as treport

    payloads = {"host0": _payload("host0", 500.0, 10.0, hbm_peak=2048.0),
                "host1": _payload("host1", 300.0, 10.0, hbm_peak=1024.0)}

    def scenario(T):
        render = (treport if T is ttel else jreport).render_report
        perf = T.aggregate.merge_perf(payloads)
        assert perf["flops_total"] == 800.0
        assert perf["cluster_mfu"] == pytest.approx(0.4)
        assert perf["hbm_peak_bytes"] == 2048.0
        assert perf["programs"]["train_step"]["reporting_hosts"] == 2
        cluster = T.merge_cluster(payloads)
        assert cluster["perf"]["flops_total"] == 800.0
        text = render(cluster)
        assert "cluster MFU: 40.0%" in text
        assert "train_step" in text and "compute-bound" in text
        bare = {k: {kk: vv for kk, vv in v.items() if kk != "perf"}
                for k, v in payloads.items()}
        assert T.aggregate.merge_perf(bare) is None
        return perf, cluster, text, render(T.merge_cluster(bare))

    _both(scenario)
