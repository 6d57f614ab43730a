"""The port's training resilience on the CPU: ``LocalOptimizer`` with
validation, verified checkpoints and summaries against the JAX
``LocalOptimizer`` on the same data (weights carried across by
``load_param_tree``); the loss-spike rollback, the corrupt and truncated
checkpoint fallbacks, the injected-exception retry and preemption
(``tests/test_resilience.py``); the background writer's resume and crash
paths (``tests/test_async_overlap.py``); and the bitwise total-state
resume: 4 steps + resume + 4 steps = 8 steps, with the async writer on
and off.
"""
import os
import signal
import zlib

import numpy as np
import pytest
import torch

import jax

from bigdl_tpu import nn as jnn
from bigdl_tpu import optim as joptim
from bigdl_tpu.dataset import Sample as JSample
from bigdl_tpu.dataset.dataset import array as jarray
from bigdl_tpu.models.transformer import TransformerLM as JTransformerLM
from bigdl_tpu.optim.optimizer import LocalOptimizer as JLocalOptimizer
from bigdl_tpu.utils.rng import RNG as JRNG
from bigdl_tpu.visualization import TrainSummary as JTrainSummary
from bigdl_tpu.visualization import ValidationSummary as JValidationSummary
from bigdl_tpu_torch import nn
from bigdl_tpu_torch import optim
from bigdl_tpu_torch.dataset import Sample, SampleToMiniBatch, array
from bigdl_tpu_torch.interop import load_param_tree
from bigdl_tpu_torch.models.transformer import TransformerLM
from bigdl_tpu_torch.optim import optimizer as optimizer_mod
from bigdl_tpu_torch.optim import (SGD, LocalOptimizer, Top1Accuracy,
                                   max_epoch, max_iteration,
                                   several_iteration)
from bigdl_tpu_torch.resilience import (LossSpikeDetector, PreemptionHandler,
                                        RetryPolicy, faults, verify_file)
from bigdl_tpu_torch.resilience.async_checkpoint import AsyncCheckpointError
from bigdl_tpu_torch.utils.rng import RNG
from bigdl_tpu_torch.utils.tree import tree_leaves
from bigdl_tpu_torch.visualization import TrainSummary, ValidationSummary

torch.set_num_threads(1)

_DEVICE_BATCH = optimizer_mod._device_batch
# the trajectory tolerance of tests/test_torch_training.py
TRAJ_RTOL = 2e-3
FAST_RETRY = dict(max_retries=5, backoff_base=0.01)


def xor_arrays(n=256, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, 2).astype(np.float32)
    y = ((x[:, 0] > 0.5) ^ (x[:, 1] > 0.5)).astype(np.float32) + 1
    return x, y


def xor_samples(n=256, seed=0):
    x, y = xor_arrays(n, seed)
    return [Sample(x[i], y[i]) for i in range(n)]


def xor_model(seed=0):
    g = torch.Generator().manual_seed(seed)
    return nn.Sequential(nn.Linear(2, 32, device="cpu", generator=g),
                         nn.Tanh(device="cpu"),
                         nn.Linear(32, 2, device="cpu", generator=g),
                         nn.LogSoftMax(device="cpu"), device="cpu")


def jax_xor_model(seed=1):
    """The XOR classifier with the JAX package's initialization from
    host seed ``seed`` (the init of ``tests/test_resilience.py``)."""
    JRNG().set_seed(seed)
    jm = jnn.Sequential(jnn.Linear(2, 32), jnn.Tanh(), jnn.Linear(32, 2),
                        jnn.LogSoftMax())
    tm = xor_model()
    load_param_tree(tm, jax.tree_util.tree_map(np.asarray, jm.param_tree()))
    return tm


def params_of(model):
    return [t.detach().clone() for t in tree_leaves(model.param_tree())]


def bitwise_equal(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


# ----------------------------------------------------------------------
# the loop with validation, checkpoints and summaries vs the JAX loop
# ----------------------------------------------------------------------

V, T_LEN = 64, 16
LM_KW = dict(embed_dim=32, num_heads=2, num_layers=2, max_len=T_LEN,
             seq_strategy="flash", output="logits")


def _case(kind):
    """(JAX model, port model with its weights, train arrays, held-out
    arrays, batch size, JAX and port criterion and validation methods)."""
    if kind == "xor":
        jm = jnn.Sequential(jnn.Linear(2, 32), jnn.Tanh(), jnn.Linear(32, 2),
                            jnn.LogSoftMax())
        tm = xor_model()
        train, held = xor_arrays(64, 0), xor_arrays(40, 1)
        crits = (jnn.ClassNLLCriterion(), nn.ClassNLLCriterion())
        methods = ([joptim.Top1Accuracy(), joptim.Loss()],
                   [optim.Top1Accuracy(), optim.Loss()])
    else:
        jm = JTransformerLM(V, **LM_KW)
        tm = TransformerLM(V, **LM_KW, device="cpu")
        rng = np.random.RandomState(0)
        ids = lambda n: rng.randint(1, V + 1, size=(n, T_LEN)).astype(
            np.int32)
        train, held = (ids(16), ids(16)), (ids(6), ids(6))
        crits = (jnn.TimeDistributedCriterion(jnn.CrossEntropyCriterion(),
                                              True),
                 nn.TimeDistributedCriterion(nn.CrossEntropyCriterion(),
                                             True))
        methods = ([joptim.Loss(jnn.TimeDistributedCriterion(
            jnn.CrossEntropyCriterion(), True))],
                   [optim.Loss(nn.TimeDistributedCriterion(
                       nn.CrossEntropyCriterion(), True))])
    load_param_tree(tm, jax.tree_util.tree_map(np.asarray, jm.param_tree()))
    return jm, tm, train, held, crits, methods


@pytest.mark.parametrize("kind", ["xor", "lm"])
def test_loop_with_validation_checkpoints_summaries_matches_jax(tmp_path,
                                                                kind):
    jm, tm, (x, y), (hx, hy), (jcrit, tcrit), (jmeth, tmeth) = _case(kind)
    runs = {}
    for pkg in ("jax", "port"):
        S, arr, Opt, rng, om = (
            (JSample, jarray, JLocalOptimizer, JRNG, joptim) if pkg == "jax"
            else (Sample, array, LocalOptimizer, RNG, optim))
        d = tmp_path / pkg
        opt = Opt(jm if pkg == "jax" else tm,
                  arr([S(a, b) for a, b in zip(x, y)]),
                  jcrit if pkg == "jax" else tcrit, batch_size=4)
        opt.set_optim_method(om.SGD(0.1, momentum=0.9))
        opt.set_end_when(om.max_iteration(6))
        opt.set_validation(om.several_iteration(2),
                           arr([S(a, b) for a, b in zip(hx, hy)]),
                           jmeth if pkg == "jax" else tmeth, batch_size=4)
        opt.set_checkpoint(str(d / "ckpt"), om.several_iteration(3))
        TS, VS = ((JTrainSummary, JValidationSummary) if pkg == "jax"
                  else (TrainSummary, ValidationSummary))
        ts, vs = TS(str(d), "app"), VS(str(d), "app")
        opt.set_train_summary(ts).set_validation_summary(vs)
        rng().set_seed(1)
        opt.optimize()
        runs[pkg] = dict(
            names=sorted(os.listdir(d / "ckpt")),
            loss=ts.read_scalar("Loss"),
            val={m.format(): vs.read_scalar(m.format())
                 for m in (jmeth if pkg == "jax" else tmeth)})
        ts.close()
        vs.close()
    j, t = runs["jax"], runs["port"]
    assert t["names"] == j["names"]
    assert "model.6" in t["names"] and ".trainState.3.crc32c" in t["names"]
    assert [s for s, _ in t["loss"]] == [s for s, _ in j["loss"]] == \
        list(range(1, 7))
    np.testing.assert_allclose([v for _, v in t["loss"]],
                               [v for _, v in j["loss"]], rtol=TRAJ_RTOL)
    assert t["val"].keys() == j["val"].keys()
    for name in t["val"]:
        assert [s for s, _ in t["val"][name]] == \
            [s for s, _ in j["val"][name]] == [2, 4, 6]
        if name == "Top1Accuracy":
            assert t["val"][name] == j["val"][name]
        else:
            np.testing.assert_allclose([v for _, v in t["val"][name]],
                                       [v for _, v in j["val"][name]],
                                       rtol=TRAJ_RTOL)
    for name in ("model", "optimMethod", "trainState"):
        assert verify_file(str(tmp_path / "port" / "ckpt" / f"{name}.6"))


# ----------------------------------------------------------------------
# bitwise total-state resume: 4 + resume + 4 = 8
# ----------------------------------------------------------------------

def _recorded_run(monkeypatch, make, ckpt_dir, steps, resume=None,
                  async_ckpt=True):
    """Train ``make()`` (model, dataset, criterion) to ``steps``, with a
    checkpoint every iteration; with ``resume`` restore that step first
    (the host RNG seeded differently, so only the trainState leg can put
    it back).  Returns (losses, crc32 of each batch's input bytes, the
    final params, the final slots)."""
    batches, losses = [], {}

    def recording(batch, device):
        batches.append(zlib.crc32(np.ascontiguousarray(
            batch.get_input()).tobytes()))
        return _DEVICE_BATCH(batch, device)

    monkeypatch.setattr(optimizer_mod, "_device_batch", recording)
    model, ds, crit = make(seed=7 if resume else 0)
    opt = LocalOptimizer(model, ds, crit, batch_size=16)
    opt.set_optim_method(SGD(0.1, momentum=0.9))
    opt.set_async_checkpoint(async_ckpt)
    opt.set_checkpoint(ckpt_dir, several_iteration(1))
    RNG().set_seed(999 if resume else 1)
    if resume is not None:
        assert opt.resume_from_checkpoint(resume) is True
        assert opt.optim_method.state["neval"] == resume + 1

    def record(state):
        if "loss" in state:
            losses[state["neval"] - 1] = state["loss"]
        return state["neval"] > steps

    opt.set_end_when(optim.Trigger(record))
    opt.optimize()
    slots = tree_leaves(opt.optim_method._slots)
    return losses, batches, params_of(model), [s.clone() for s in slots]


def _make_xor(seed):
    return xor_model(seed), array(xor_samples(64)), nn.ClassNLLCriterion()


def _make_lm(seed):
    rng = np.random.RandomState(3)
    x = rng.randint(1, V + 1, size=(64, T_LEN)).astype(np.int32)
    y = rng.randint(1, V + 1, size=(64, T_LEN)).astype(np.int32)
    model = TransformerLM(V, **dict(LM_KW, num_layers=1), device="cpu",
                          generator=torch.Generator().manual_seed(seed))
    return (model, array([Sample(a, b) for a, b in zip(x, y)]),
            nn.TimeDistributedCriterion(nn.CrossEntropyCriterion(), True))


@pytest.mark.parametrize("make,async_ckpt", [(_make_xor, True),
                                             (_make_xor, False),
                                             (_make_lm, True)],
                         ids=["xor-async", "xor-sync", "lm-async"])
def test_resume_is_bitwise_the_uninterrupted_run(tmp_path, monkeypatch,
                                                 make, async_ckpt):
    """64 records at batch 16: an epoch is 4 steps, so step 4 is an
    epoch boundary (after a shuffle) and step 3 is mid-epoch (the cursor
    skips 48 records)."""
    d = str(tmp_path / "ckpt")
    ref = _recorded_run(monkeypatch, make, d, 8, async_ckpt=async_ckpt)
    assert sorted(ref[0]) == list(range(1, 9))
    for k in (4, 3):
        got = _recorded_run(monkeypatch, make, d, 8, resume=k,
                            async_ckpt=async_ckpt)
        assert got[0] == {s: v for s, v in ref[0].items() if s >= k}, \
            f"losses after resume at {k}"
        assert got[1] == ref[1][k:], f"batch order after resume at {k}"
        assert bitwise_equal(got[2], ref[2]), f"params after resume at {k}"
        assert bitwise_equal(got[3], ref[3]), f"slots after resume at {k}"


def test_checkpoint_legs_hold_cpu_trees_and_state(tmp_path):
    from bigdl_tpu_torch.utils import file_io

    model, ds, crit = _make_xor(0)
    opt = LocalOptimizer(model, ds, crit, batch_size=16)
    opt.set_optim_method(SGD(0.1, momentum=0.9))
    opt.set_end_when(max_iteration(2))
    opt.set_checkpoint(str(tmp_path), several_iteration(2))
    opt.optimize()
    leg = file_io.load(str(tmp_path / "model.2"))
    assert set(leg) == {"params", "buffers"}
    assert torch.equal(leg["params"]["2"]["weight"], model[2].weight.detach())
    om = file_io.load(str(tmp_path / "optimMethod.2"))
    assert type(om) is SGD and om.state["neval"] == 3
    assert set(om._slots) == {"velocity"}
    ts = file_io.load(str(tmp_path / "trainState.2"))
    assert ts["records_this_epoch"] == 32 and "rng" in ts
    assert len(opt.checkpoint_stats) == 1
    assert opt.checkpoint_stats[0]["bytes"]["model.2"] == \
        os.path.getsize(tmp_path / "model.2")
    assert opt.checkpoint_writes == 1
    with pytest.raises(NotImplementedError):
        opt.set_checkpoint(str(tmp_path), several_iteration(2),
                           format="orbax")
    with pytest.raises(ValueError):
        opt.set_checkpoint(str(tmp_path), several_iteration(2),
                           format="zip")


# ----------------------------------------------------------------------
# tests/test_resilience.py
# ----------------------------------------------------------------------

def test_loss_spike_detector_k_consecutive():
    det = LossSpikeDetector(k=2, ratio=2.0, warmup=3)
    for _ in range(5):
        assert not det.update(1.0)
    assert not det.update(5.0)
    assert not det.update(1.0)
    assert not det.update(5.0)
    assert det.update(5.0)
    det.reset()
    for _ in range(5):
        det.update(1.0)
    assert not det.update(float("nan"))
    assert det.update(float("nan"))
    with pytest.raises(ValueError):
        LossSpikeDetector(k=0)
    with pytest.raises(ValueError):
        LossSpikeDetector(ratio=1.0)


def test_loss_spike_rollback_to_checkpoint(tmp_path):
    """Two spiked batches trip the detector; the retry restores the last
    good checkpoint and training completes."""
    g = torch.Generator().manual_seed(0)
    model = nn.Sequential(nn.Linear(2, 2, device="cpu", generator=g),
                          nn.LogSoftMax(device="cpu"), device="cpu")
    fault = faults.ScaleInjector(at=257, n=128, scale=100.0)   # 2 batches
    ds = array(xor_samples()) >> fault >> SampleToMiniBatch(64)
    opt = LocalOptimizer(model, ds, nn.ClassNLLCriterion(), batch_size=64)
    opt.set_optim_method(SGD(learning_rate=0.1))
    opt.set_end_when(max_iteration(12))
    opt.set_checkpoint(str(tmp_path), several_iteration(1))
    opt.set_loss_spike_guard(k=2, ratio=2.0, warmup=2)
    opt.set_retry_policy(RetryPolicy(**FAST_RETRY))
    trained = opt.optimize()
    assert fault.fired == 128, "the spike injection never triggered"
    assert opt.rollbacks >= 1, "the spike never triggered a rollback"
    assert trained is model
    assert opt.optim_method.state["neval"] > 12
    assert all(torch.isfinite(p).all() for p in params_of(model))


def test_loss_spike_without_checkpoint_only_logs():
    model, ds, crit = _make_xor(0)
    opt = LocalOptimizer(model, ds, crit, batch_size=16)
    opt.set_end_when(max_iteration(3))
    opt.set_loss_spike_guard(k=1, ratio=1.01, warmup=0)
    opt.spike_detector._ema = 1e-9        # every loss now reads as a spike
    opt.optimize()
    assert opt.rollbacks == 0
    assert opt.optim_method.state["neval"] == 4


def _train_with_checkpoints(tmp_path, iters=4):
    opt = LocalOptimizer(xor_model(), array(xor_samples()),
                         nn.ClassNLLCriterion(), batch_size=64)
    opt.set_optim_method(SGD(learning_rate=0.5))
    opt.set_end_when(max_iteration(iters))
    opt.set_checkpoint(str(tmp_path), several_iteration(1))
    opt.optimize()
    return opt


@pytest.mark.parametrize("damage", ["bit_flip", "truncate"])
def test_damaged_checkpoint_falls_back(tmp_path, damage):
    from bigdl_tpu_torch.utils import file_io

    _train_with_checkpoints(tmp_path)
    steps = sorted(int(f.split(".")[1]) for f in os.listdir(tmp_path)
                   if f.startswith("model."))
    newest, prev = steps[-1], steps[-2]
    victim = str(tmp_path / f"model.{newest}")
    if damage == "bit_flip":
        faults.bit_flip(victim)
    else:
        faults.truncate(victim, keep_fraction=0.5)
    fresh = xor_model(seed=5)
    opt2 = LocalOptimizer(fresh, array(xor_samples()),
                          nn.ClassNLLCriterion(), batch_size=64)
    opt2.set_checkpoint(str(tmp_path), several_iteration(1))
    assert opt2.resume_from_checkpoint() is True
    assert (tmp_path / f"model.{newest}.corrupt").exists()
    good = file_io.load(str(tmp_path / f"model.{prev}"))["params"]
    assert bitwise_equal(tree_leaves(good), params_of(fresh))
    # optimMethod and trainState come from the step the model came from
    assert opt2.optim_method.state["neval"] == prev + 1


def test_atomic_save_writes_verifiable_sidecar(tmp_path):
    from bigdl_tpu_torch.utils import file_io

    p = str(tmp_path / "tree")
    file_io.save({"w": torch.ones(4, 4)}, p, atomic=True, checksum=True)
    assert verify_file(p) is True
    faults.bit_flip(p)
    assert verify_file(p) is False


def test_injected_exception_retries_and_converges(tmp_path):
    """An exception mid-epoch (record 300, iteration 5) rolls back to the
    step-3 checkpoint (mid-epoch: the cursor skips 192 records); with
    total-state resume the recovered run is the clean run bit for bit,
    where the JAX package's test can only ask for the same basin."""
    def run(inject):
        model = jax_xor_model()
        RNG().set_seed(1)
        ds = array(xor_samples())
        fault = None
        if inject:
            fault = faults.ExceptionTransformer(fail_at=300)
            ds = ds >> fault >> SampleToMiniBatch(64)
        opt = LocalOptimizer(model, ds, nn.ClassNLLCriterion(),
                             batch_size=64)
        opt.set_optim_method(SGD(learning_rate=1.0))
        opt.set_end_when(max_epoch(20))
        opt.set_checkpoint(str(tmp_path / ("inj" if inject else "clean")),
                           several_iteration(3))
        sleeps = []
        opt.set_retry_policy(RetryPolicy(max_retries=5, backoff_base=0.01,
                                         sleep=sleeps.append))
        opt.optimize()
        return opt, fault, sleeps, params_of(model)

    opt_i, fault, sleeps, injected = run(inject=True)
    assert fault.fired, "the injected fault never triggered"
    assert opt_i.rollbacks == 1
    assert len(sleeps) == 1 and sleeps[0] > 0, \
        "retry must back off before restoring"
    opt_c, _, _, clean = run(inject=False)
    assert opt_i.optim_method.state["neval"] == \
        opt_c.optim_method.state["neval"] == 81
    assert opt_i.optim_method.state["loss"] == opt_c.optim_method.state["loss"]
    assert bitwise_equal(injected, clean)


def test_error_without_checkpoint_raises_at_once():
    fault = faults.ExceptionTransformer(fail_at=20)
    ds = array(xor_samples(64)) >> fault >> SampleToMiniBatch(16)
    opt = LocalOptimizer(xor_model(), ds, nn.ClassNLLCriterion(),
                         batch_size=16)
    opt.set_end_when(max_iteration(8))
    with pytest.raises(RuntimeError, match="injected failure"):
        opt.optimize()
    assert opt.rollbacks == 0


def test_sigterm_requests_graceful_stop():
    h = PreemptionHandler()
    with h:
        assert not h.should_stop
        os.kill(os.getpid(), signal.SIGTERM)
        for _ in range(100):
            if h.should_stop:
                break
        assert h.should_stop


def test_preemption_checkpoints_and_resumes(tmp_path):
    fault = faults.PreemptTransformer(at=150)           # in iteration 3
    ds = array(xor_samples()) >> fault >> SampleToMiniBatch(64)
    opt = LocalOptimizer(xor_model(), ds, nn.ClassNLLCriterion(),
                         batch_size=64)
    opt.set_optim_method(SGD(learning_rate=1.0))
    opt.set_end_when(max_iteration(600))
    # the trigger never fires on its own: only preemption writes
    opt.set_checkpoint(str(tmp_path), several_iteration(1000))
    opt.set_preemption_handling(True)
    opt.optimize()
    assert fault.fired
    stopped_at = opt.optim_method.state["neval"]
    assert stopped_at < 600, "preemption should have stopped the run early"
    assert any(f.startswith("model.") for f in os.listdir(tmp_path))

    fresh = xor_model(seed=3)
    opt2 = LocalOptimizer(fresh, array(xor_samples()),
                          nn.ClassNLLCriterion(), batch_size=64)
    opt2.set_optim_method(SGD(learning_rate=1.0))
    opt2.set_checkpoint(str(tmp_path), several_iteration(1000))
    assert opt2.resume_from_checkpoint() is True
    assert opt2.optim_method.state["neval"] == stopped_at
    opt2.set_end_when(max_iteration(600))
    trained = opt2.optimize()
    assert opt2.optim_method.state["neval"] - 1 == 600
    (res, _), = trained.evaluate(array(xor_samples(seed=1)),
                                 [Top1Accuracy()])
    assert res.result()[0] > 0.85


# ----------------------------------------------------------------------
# tests/test_async_overlap.py:316-504
# ----------------------------------------------------------------------

def _build_opt(fault=None, async_ckpt=True, seed=0):
    RNG().set_seed(123)
    ds = array(xor_samples())
    if fault is not None:
        ds = ds >> fault >> SampleToMiniBatch(64)
    opt = LocalOptimizer(xor_model(seed), ds, nn.ClassNLLCriterion(),
                         batch_size=64)
    opt.set_optim_method(SGD(learning_rate=0.1))
    opt.set_async_checkpoint(async_ckpt)
    opt.set_retry_policy(RetryPolicy(**FAST_RETRY))
    return opt


def test_async_checkpoint_bytes_equal_sync(tmp_path):
    for mode, flag in (("sync", False), ("async", True)):
        opt = _build_opt(async_ckpt=flag)
        opt.set_end_when(max_iteration(10))
        opt.set_checkpoint(str(tmp_path / mode), several_iteration(6))
        opt.optimize()
    for leg in ("model", "optimMethod", "trainState"):
        a = str(tmp_path / "sync" / f"{leg}.6")
        b = str(tmp_path / "async" / f"{leg}.6")
        assert verify_file(a) is True and verify_file(b) is True
        assert open(a, "rb").read() == open(b, "rb").read(), leg


def test_crash_during_async_checkpoint_previous_survives(tmp_path):
    opt = _build_opt()
    opt.set_end_when(max_iteration(12))
    opt.set_checkpoint(str(tmp_path / "ckpt"), several_iteration(4))
    # the step-8 model leg dies mid-write; the failure raises at the next
    # submit, the retry restores step 4 and reruns 5..12
    with faults.io_faults("model.8", times=1) as fault:
        opt.optimize()
    assert fault["remaining"] == 0, "injected write failure never fired"
    assert opt.rollbacks >= 1
    for n in (4, 8, 12):
        assert verify_file(str(tmp_path / "ckpt" / f"model.{n}")) is True
    opt2 = _build_opt(seed=4)
    opt2.set_checkpoint(str(tmp_path / "ckpt"), several_iteration(4))
    assert opt2.resume_from_checkpoint() is True
    assert opt2.optim_method.state["neval"] == 13


def test_async_write_failure_raises_without_retry_budget(tmp_path):
    opt = _build_opt()
    opt.retry_policy.max_retries = 0
    opt.set_end_when(max_iteration(8))
    opt.set_checkpoint(str(tmp_path / "ckpt"), several_iteration(4))
    with faults.io_faults("model.8", times=10):
        with pytest.raises(AsyncCheckpointError):
            opt.optimize()
    assert verify_file(str(tmp_path / "ckpt" / "model.4")) is True
    assert not os.path.exists(tmp_path / "ckpt" / "model.8")


def test_torn_async_checkpoint_quarantined_and_resume_bitwise(tmp_path):
    opt = _build_opt(async_ckpt=False)
    opt.set_end_when(max_iteration(12))
    ref_model = opt.model
    opt.optimize()
    ref = params_of(ref_model)

    opt = _build_opt()
    opt.set_end_when(max_iteration(12))
    opt.set_checkpoint(str(tmp_path / "ckpt"), several_iteration(4))
    opt.optimize()
    newest = str(tmp_path / "ckpt" / "model.12")
    faults.truncate(newest, keep_fraction=0.3)
    assert verify_file(newest) is False

    RNG().set_seed(999)
    fresh = xor_model(seed=9)
    opt2 = LocalOptimizer(fresh, array(xor_samples()),
                          nn.ClassNLLCriterion(), batch_size=64)
    opt2.set_optim_method(SGD(learning_rate=0.1))
    opt2.set_checkpoint(str(tmp_path / "ckpt"), several_iteration(4))
    assert opt2.resume_from_checkpoint() is True
    assert os.path.exists(newest + ".corrupt"), "torn file quarantined"
    assert opt2.optim_method.state["neval"] == 9
    opt2.set_end_when(max_iteration(12))
    opt2.optimize()
    assert bitwise_equal(params_of(fresh), ref)


def test_preemption_drains_writer_before_resumable_exit(tmp_path):
    fault = faults.PreemptTransformer(at=150)
    opt = _build_opt(fault=fault)
    opt.set_end_when(max_iteration(10))
    opt.set_checkpoint(str(tmp_path / "ckpt"), several_iteration(1000))
    opt.set_preemption_handling(True)
    opt.optimize()
    assert fault.fired
    stopped_at = opt.optim_method.state["neval"] - 1
    for leg in ("model", "optimMethod", "trainState"):
        p = str(tmp_path / "ckpt" / f"{leg}.{stopped_at}")
        assert verify_file(p) is True, f"{leg} not durable at exit"


def test_nan_step_skipped_and_counted_in_the_summary(tmp_path):
    bad = [Sample(np.full(2, np.nan, np.float32), 1.0) for _ in range(64)]
    model = xor_model()
    before = params_of(model)
    opt = LocalOptimizer(model, array(bad), nn.ClassNLLCriterion(),
                         batch_size=64)
    opt.set_optim_method(SGD(learning_rate=0.5))
    opt.set_end_when(max_iteration(1))
    ts = TrainSummary(str(tmp_path), "app")
    opt.set_train_summary(ts)
    opt.optimize()
    assert opt.skipped_steps == 1
    assert bitwise_equal(before, params_of(model))
    assert ts.read_scalar("SkippedSteps") == [(1, 1.0)]
    ts.close()


def test_overwrite_layout_keeps_one_checkpoint_and_resumes(tmp_path):
    model, ds, crit = _make_xor(0)
    opt = LocalOptimizer(model, ds, crit, batch_size=16)
    opt.set_optim_method(SGD(0.1, momentum=0.9))
    opt.set_end_when(max_iteration(5))
    opt.set_checkpoint(str(tmp_path), several_iteration(2))
    opt.overwrite_checkpoint()
    opt.optimize()
    assert sorted(f for f in os.listdir(tmp_path) if not f.startswith(".")) \
        == ["model", "optimMethod", "trainState"]
    fresh = xor_model(seed=8)
    opt2 = LocalOptimizer(fresh, array(xor_samples(64)), crit, batch_size=16)
    opt2.set_checkpoint(str(tmp_path), several_iteration(2))
    assert opt2.resume_from_checkpoint() is True
    assert opt2.optim_method.state["neval"] == 5        # the step-4 write
