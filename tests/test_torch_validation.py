"""The port's validation and summaries against the JAX package on the
CPU: each validation method on the same outputs, ``evaluate_dataset``
with weights carried across by ``load_param_tree`` (a small
TransformerLM and the XOR classifier, each with a last partial batch),
the TensorBoard event bytes, and the event-file writer.
"""
import os
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu import nn as jnn
from bigdl_tpu.dataset import Sample as JSample
from bigdl_tpu.dataset.dataset import array as jarray
from bigdl_tpu.models.transformer import TransformerLM as JTransformerLM
from bigdl_tpu.optim import evaluator as jevaluator
from bigdl_tpu.optim import validation as jvalidation
from bigdl_tpu.visualization import proto as jproto
from bigdl_tpu.visualization import summary as jsummary
from bigdl_tpu.visualization import writer as jwriter
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.dataset import Sample, array
from bigdl_tpu_torch.interop import load_param_tree
from bigdl_tpu_torch.models.transformer import TransformerLM
from bigdl_tpu_torch.optim import evaluator, validation
from bigdl_tpu_torch.optim import optimizer as optimizer_mod
from bigdl_tpu_torch.visualization import (ServingSummary, TrainSummary,
                                           read_scalars)
from bigdl_tpu_torch.visualization import proto, summary
from bigdl_tpu_torch.visualization.summary import scalar_event
from bigdl_tpu_torch.visualization.writer import FileWriter

torch.set_num_threads(1)

LOSS_RTOL = 1e-6
EVAL_RTOL = 1e-5


def _outputs(shape, C, seed):
    rng = np.random.RandomState(seed)
    out = rng.randn(*shape, C).astype(np.float32)
    out = out - np.log(np.exp(out).sum(-1, keepdims=True))   # log-probs
    t = rng.randint(1, C + 1, size=shape).astype(np.int32)
    return out, t


# ----------------------------------------------------------------------
# the methods on the same outputs
# ----------------------------------------------------------------------

@pytest.mark.parametrize("name,C", [("Top1Accuracy", 7), ("Top5Accuracy", 9),
                                    ("Top5Accuracy", 3), ("MAE", 6)])
def test_accuracy_methods_equal_jax(name, C):
    out, t = _outputs((33,), C, seed=C)
    got = getattr(validation, name)()(torch.from_numpy(out),
                                      torch.from_numpy(t))
    want = getattr(jvalidation, name)()(jnp.asarray(out), jnp.asarray(t))
    assert type(got).__name__ == type(want).__name__
    assert got.result() == want.result()
    assert got.count == want.count
    # a sum of batches equals the JAX sum
    got2 = got + getattr(validation, name)()(out[:5], t[:5])
    want2 = want + getattr(jvalidation, name)()(out[:5], t[:5])
    assert got2.result() == want2.result()


@pytest.mark.parametrize("shape", [(12,), (5, 3)])
def test_tree_nn_accuracy_equals_jax(shape):
    out, t = _outputs((4, 6) if shape == (12,) else shape, 4, seed=2)
    got = validation.TreeNNAccuracy()(out, t)
    want = jvalidation.TreeNNAccuracy()(out, t)
    assert got.result() == want.result()
    one = np.random.RandomState(3).rand(4, 5, 1).astype(np.float32)
    assert validation.TreeNNAccuracy()(one, t[:4]).result() == \
        jvalidation.TreeNNAccuracy()(one, t[:4]).result()


@pytest.mark.parametrize("which", ["nll", "time_distributed"])
def test_loss_method_equals_jax(which):
    if which == "nll":
        out, t = _outputs((17,), 5, seed=4)
        mine = validation.Loss()
        theirs = jvalidation.Loss()
    else:
        out, t = _outputs((3, 6), 11, seed=5)
        mine = validation.Loss(nn.TimeDistributedCriterion(
            nn.CrossEntropyCriterion(), True))
        theirs = jvalidation.Loss(jnn.TimeDistributedCriterion(
            jnn.CrossEntropyCriterion(), True))
    got = mine(torch.from_numpy(out), torch.from_numpy(t))
    want = theirs(jnp.asarray(out), jnp.asarray(t))
    assert isinstance(got.loss, float) and got.count == want.count
    np.testing.assert_allclose(got.result()[0], want.result()[0],
                               rtol=LOSS_RTOL)


def test_methods_read_back_only_their_sums(monkeypatch):
    """A method reduces on the output's device: the output itself never
    goes through numpy."""
    out, t = _outputs((8,), 5, seed=6)
    x = torch.from_numpy(out)
    monkeypatch.setattr(torch.Tensor, "numpy", lambda self, *a, **k: (
        _ for _ in ()).throw(AssertionError("output pulled to numpy")))
    for m in (validation.Top1Accuracy(), validation.Top5Accuracy(),
              validation.MAE(), validation.Loss()):
        r = m(x, torch.from_numpy(t))
        assert r.count == 8


# ----------------------------------------------------------------------
# evaluate_dataset against the JAX one
# ----------------------------------------------------------------------

V, T_LEN = 50, 20
LM_KW = dict(embed_dim=64, num_heads=4, num_layers=2, max_len=T_LEN,
             seq_strategy="flash", output="logits")


def _xor(n, seed):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, 2).astype(np.float32)
    y = ((x[:, 0] > 0.5) ^ (x[:, 1] > 0.5)).astype(np.float32) + 1
    return x, y


def _xor_pair():
    jm = jnn.Sequential(jnn.Linear(2, 32), jnn.Tanh(), jnn.Linear(32, 2),
                        jnn.LogSoftMax())
    tm = nn.Sequential(nn.Linear(2, 32, device="cpu"), nn.Tanh(device="cpu"),
                       nn.Linear(32, 2, device="cpu"),
                       nn.LogSoftMax(device="cpu"), device="cpu")
    load_param_tree(tm, jax.tree_util.tree_map(np.asarray, jm.param_tree()))
    return jm, tm


def _lm_pair():
    jm = JTransformerLM(V, **LM_KW)
    tm = TransformerLM(V, **LM_KW, device="cpu")
    load_param_tree(tm, jax.tree_util.tree_map(np.asarray, jm.param_tree()))
    return jm, tm


def _check_results(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.count == w.count
        np.testing.assert_allclose(g.result()[0], w.result()[0],
                                   rtol=EVAL_RTOL)


def _count_batches(monkeypatch):
    """Count the batches evaluate_dataset moves to the device."""
    seen = []
    real = optimizer_mod._device_batch

    def counting(batch, device):
        seen.append(batch.size())
        return real(batch, device)

    monkeypatch.setattr(optimizer_mod, "_device_batch", counting)
    return seen


def test_evaluate_dataset_xor_equals_jax(monkeypatch):
    seen = _count_batches(monkeypatch)
    x, y = _xor(37, seed=1)                    # 37 = 3 x 12 + a partial 1
    jm, tm = _xor_pair()
    methods = lambda m: [m.Top1Accuracy(), m.Top5Accuracy(), m.Loss()]
    want = jevaluator.evaluate_dataset(
        jm, jarray([JSample(a, b) for a, b in zip(x, y)]),
        methods(jvalidation), batch_size=12)
    got = evaluator.evaluate_dataset(
        tm, array([Sample(a, b) for a, b in zip(x, y)]),
        methods(validation), batch_size=12)
    assert seen == [12, 12, 12, 1]
    _check_results(got, want)
    assert got[0].result() == want[0].result()
    assert not tm.training


def test_evaluate_dataset_lm_equals_jax_and_module_evaluate(monkeypatch):
    seen = _count_batches(monkeypatch)
    rng = np.random.RandomState(2)
    x = rng.randint(1, V + 1, size=(10, T_LEN)).astype(np.int32)
    y = rng.randint(1, V + 1, size=(10, T_LEN)).astype(np.int32)
    jm, tm = _lm_pair()
    want = jevaluator.evaluate_dataset(
        jm, jarray([JSample(a, b) for a, b in zip(x, y)]),
        [jvalidation.Loss(jnn.TimeDistributedCriterion(
            jnn.CrossEntropyCriterion(), True))], batch_size=4)
    ds = array([Sample(a, b) for a, b in zip(x, y)])
    crit = nn.TimeDistributedCriterion(nn.CrossEntropyCriterion(), True)
    got = evaluator.evaluate_dataset(tm, ds, [validation.Loss(crit)],
                                     batch_size=4)
    assert seen == [4, 4, 2]
    _check_results(got, want)
    # the module verb routes to the Evaluator
    (res, name), = tm.evaluate(ds, [validation.Loss(crit)], 4)
    assert name == "Loss" and res.result() == got[0].result()
    # over a mesh: a torch.distributed DeviceMesh; DistriValidator's
    # default, a group of this process alone, gives the one-device result
    # (more ranks: tests/test_torch_distri.py)
    with pytest.raises(TypeError):
        evaluator.evaluate_dataset(tm, ds, [validation.Loss(crit)],
                                   mesh=object())
    from bigdl_tpu_torch.utils.engine import Engine

    Engine.reset()
    try:
        (res, name), = evaluator.DistriValidator(tm).test(
            ds, [validation.Loss(crit)], 4)
    finally:
        Engine.reset()
    assert name == "Loss" and res.result() == got[0].result()


# ----------------------------------------------------------------------
# TensorBoard events
# ----------------------------------------------------------------------

@pytest.mark.parametrize("wall,step,tag,value", [
    (1700000000.25, 3, "Loss", 0.693), (0.0, None, "x", 1.0),
    (123.5, 1 << 40, "Top1Accuracy", -2.5e-7)])
def test_event_bytes_equal_jax(monkeypatch, wall, step, tag, value):
    sv = proto.encode_summary_value(tag, simple_value=value)
    assert sv == jproto.encode_summary_value(tag, simple_value=value)
    s = proto.encode_summary([sv])
    assert s == jproto.encode_summary([sv])
    assert proto.encode_event(wall, step=step, summary=s) == \
        jproto.encode_event(wall, step=step, summary=s)
    assert proto.encode_event(wall, file_version="brain.Event:2") == \
        jproto.encode_event(wall, file_version="brain.Event:2")
    monkeypatch.setattr(time, "time", lambda: wall)
    assert summary.scalar_event(tag, value, step or 0) == \
        jsummary.scalar_event(tag, value, step or 0)
    assert summary.histogram_event(tag, [value, 1.0], step or 0) == \
        jsummary.histogram_event(tag, [value, 1.0], step or 0)


def test_read_scalars_cross_packages(tmp_path):
    mine, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    w, jw = FileWriter(mine), jwriter.FileWriter(theirs)
    for i in range(20):
        w.add_event(scalar_event("Loss", 1.0 / (i + 1), i))
        jw.add_event(jsummary.scalar_event("Loss", 1.0 / (i + 1), i))
    w.close()
    jw.close()
    want = [(i, np.float32(1.0 / (i + 1)).item()) for i in range(20)]
    assert read_scalars(mine, "Loss") == want
    assert jsummary.read_scalars(mine, "Loss") == want
    assert read_scalars(theirs, "Loss") == want


# ----------------------------------------------------------------------
# the writer (tests/test_visualization_writer.py)
# ----------------------------------------------------------------------

def test_burst_before_close_all_reaches_disk(tmp_path):
    log_dir = str(tmp_path / "events")
    w = FileWriter(log_dir)
    n = 5000
    for i in range(n):
        w.add_event(scalar_event("Burst", float(i), i))
    w.close()
    got = read_scalars(log_dir, "Burst")
    assert len(got) == n
    assert got[0] == (0, 0.0) and got[-1] == (n - 1, float(n - 1))


def test_close_is_idempotent_and_rejects_late_events(tmp_path):
    w = FileWriter(str(tmp_path / "events"))
    w.add_event(scalar_event("X", 1.0, 1))
    w.close()
    w.close()
    with pytest.raises(ValueError):
        w.add_event(scalar_event("X", 2.0, 2))
    assert read_scalars(str(tmp_path / "events"), "X") == [(1, 1.0)]


def test_flush_still_works_mid_stream(tmp_path):
    w = FileWriter(str(tmp_path / "events"))
    for i in range(100):
        w.add_event(scalar_event("Y", float(i), i))
    w.flush()
    assert len(read_scalars(str(tmp_path / "events"), "Y")) == 100
    w.add_event(scalar_event("Y", 100.0, 100))
    w.close()
    assert len(read_scalars(str(tmp_path / "events"), "Y")) == 101


def test_summary_stream_layout(tmp_path):
    s = ServingSummary(str(tmp_path), "app")
    t = TrainSummary(str(tmp_path), "app")
    s.add_scalar("p99", 1.0, 10)
    t.add_scalar("Loss", 0.5, 10)
    assert s.log_dir == os.path.join(str(tmp_path), "app", "serving")
    assert t.log_dir == os.path.join(str(tmp_path), "app", "train")
    assert s.read_scalar("p99") == [(10, 1.0)]
    assert t.read_scalar("Loss") == [(10, 0.5)]
    with pytest.raises(ValueError):
        t.set_summary_trigger("Nope", None)
    s.close()
    t.close()
