"""One rank of ``tests/test_torch_fsdp.py``'s multi-process runs.

    python tests/_torch_fsdp_child.py RANK WORLD INIT_URL WORKDIR [NAMES]

Joins a gloo group of WORLD processes (``Engine.init_distributed`` over
INIT_URL, a ``file://`` store), runs every scenario of ``SCENARIOS`` (or
those NAMES lists, comma-separated) on the CPU with one intra-op thread,
and pickles what each read to ``WORKDIR/rank<RANK>.pkl`` (a scenario's
traceback under ``"error"`` when one fails).  Each scenario trains one
model twice from the same initial weights (``WORKDIR/inputs.pkl``: numpy
trees drawn by the JAX models the test built): under ``set_fsdp`` and as
plain data parallelism.  Imports neither jax nor the JAX package.
"""
import pickle
import sys
import traceback
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]

MLP_LR, LM_LR, RES_LR, TAIL_LR, XOR_LR = 0.2, 0.05, 0.1, 0.5, 0.1
ADAM_LR = 0.05
LM_V, LM_T, LM_B = 50, 16, 4
LM_KW = dict(embed_dim=64, num_heads=4, num_layers=2, max_len=LM_T,
             seq_strategy="flash", output="logits")
#: FSDP thresholds: the MLP's two wide weights; the LM's embedding and
#: head ([50, 64]: 50 divides by neither 4 nor, as the larger dim, wins
#: over 64 — a dim-1 shard) and its projections; the CIFAR ResNet's
#: 32- and 64-channel convolutions; every weight of the tiny nets
FSDP_BYTES = dict(mlp=64 * 1024, lm=8192, resnet=16 * 1024, tail=256,
                  reg=256, xor=128)
RES_B, RES_HW = 8, 32
#: the record whose pull raises: in the third batch of 16
RETRY_FAIL_AT = 40


# -- data, shared with the test process ---------------------------------
def mlp_arrays():
    rng = np.random.RandomState(0)
    x = rng.rand(64, 256).astype(np.float32)
    y = (1 + (x.sum(1) > 128)).astype(np.float32)
    return x, y


def lm_arrays():
    rng = np.random.RandomState(0)
    x = rng.randint(1, LM_V + 1, size=(LM_B, LM_T)).astype(np.int32)
    y = rng.randint(1, LM_V + 1, size=(LM_B, LM_T)).astype(np.int32)
    return x, y


def resnet_arrays():
    rng = np.random.RandomState(1)
    x = rng.randn(RES_B, 3, RES_HW, RES_HW).astype(np.float32)
    y = (rng.randint(0, 10, RES_B) + 1).astype(np.float32)
    return x, y


def xor_arrays(n, seed):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, 2).astype(np.float32)
    y = ((x[:, 0] > 0.5) ^ (x[:, 1] > 0.5)).astype(np.float32) + 1
    return x, y


def tail_batches(sizes=(16, 16, 9)):
    """Prebuilt batches whose last record count (9) divides by neither 2
    nor 4: the trailing batch trains through pad-and-mask."""
    rng = np.random.RandomState(0)
    n = sum(sizes)
    x = rng.randn(n, 6).astype(np.float32)
    y = (rng.randint(0, 4, n) + 1).astype(np.float32)
    cuts = np.cumsum((0,) + tuple(sizes))
    return [(x[a:b], y[a:b]) for a, b in zip(cuts, cuts[1:])]


def nan_arrays(world):
    """32 XOR records, one NaN feature in the first row rank 1 takes of
    the second batch of 8."""
    x, y = xor_arrays(32, 2)
    x[8 + 8 // world, 0] = np.nan
    return x, y


# -- the port side -------------------------------------------------------
def port_model(name):
    from bigdl_tpu_torch import nn

    cpu = dict(device="cpu")
    if name == "mlp":
        return nn.Sequential(nn.Linear(256, 512, **cpu), nn.Tanh(**cpu),
                             nn.Linear(512, 512, **cpu), nn.Tanh(**cpu),
                             nn.Linear(512, 2, **cpu), nn.LogSoftMax(**cpu))
    if name == "tail":
        return nn.Sequential(nn.Linear(6, 16, **cpu), nn.Tanh(**cpu),
                             nn.Linear(16, 4, **cpu), nn.LogSoftMax(**cpu))
    if name == "reg":
        from bigdl_tpu_torch.optim import L2Regularizer

        head = nn.Linear(16, 4, **cpu).set_scale_w(0.5)
        return nn.Sequential(
            nn.Linear(6, 16, w_regularizer=L2Regularizer(0.1), **cpu),
            nn.Tanh(**cpu), head, nn.LogSoftMax(**cpu))
    if name == "xor":
        return nn.Sequential(nn.Linear(2, 32, **cpu), nn.Tanh(**cpu),
                             nn.Linear(32, 2, **cpu), nn.LogSoftMax(**cpu))
    if name == "resnet":
        from bigdl_tpu_torch.models.resnet import ResNetCifar

        return ResNetCifar(8, 10, **cpu)
    from bigdl_tpu_torch.models.transformer import TransformerLM

    return TransformerLM(LM_V, **LM_KW, **cpu)


def loaded(name, inputs):
    from bigdl_tpu_torch.interop import load_param_tree
    from bigdl_tpu_torch.interop.jax_params import load_buffer_tree

    model = port_model(name)
    load_param_tree(model, inputs[name]["params"])
    if inputs[name].get("buffers"):
        load_buffer_tree(model, inputs[name]["buffers"])
    return model


def samples(x, y):
    from bigdl_tpu_torch.dataset import Sample, array

    return array([Sample(a, b) for a, b in zip(x, y)])


def batches(pairs):
    from bigdl_tpu_torch.dataset import array
    from bigdl_tpu_torch.dataset.sample import MiniBatch

    return array([MiniBatch(a, b) for a, b in pairs])


def numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    return tree.detach().float().cpu().numpy().copy()


def criterion(name):
    from bigdl_tpu_torch import nn

    if name == "lm":
        return nn.TimeDistributedCriterion(nn.CrossEntropyCriterion(), True)
    return nn.ClassNLLCriterion()


def train(name, inputs, data, method, end, batch_size=None, fsdp=None,
          seed=1, setup=None, telemetry=False):
    """``end``'s iterations of DistriOptimizer from host seed ``seed``,
    under ``set_fsdp(fsdp)`` when given: what the run read."""
    from bigdl_tpu_torch import optim
    from bigdl_tpu_torch.telemetry import MetricsRegistry, Telemetry
    from bigdl_tpu_torch.utils.rng import RNG

    model = loaded(name, inputs)
    losses, gnorms = [], []
    opt = optim.DistriOptimizer(model, data, criterion(name),
                                batch_size=batch_size)

    def check(state):
        # a resumed run's state holds the checkpoint's loss before its
        # first step
        if "loss" in state and opt.engine.last_grad_norm is not None:
            losses.append(state["loss"])
            gnorms.append(float(opt.engine.last_grad_norm))
        return end(state)

    opt.set_optim_method(method).set_end_when(optim.Trigger(check))
    tm = None
    if telemetry:
        tm = Telemetry(registry=MetricsRegistry())
        opt.set_telemetry(tm)
    if fsdp is not None:
        opt.set_fsdp(fsdp)
    RNG().set_seed(seed)
    if setup is not None:
        setup(opt)
    opt.optimize()
    out = dict(params=numpy_tree(model.param_tree()),
               buffers=numpy_tree(model.buffer_tree()), losses=losses,
               gnorms=gnorms, skipped=opt.skipped_steps,
               neval=opt.optim_method.state["neval"],
               table=opt.engine.table, has_fsdp=opt.engine.has_fsdp,
               fsdp_dims=dict(opt.engine.fsdp_dims),
               validation=[s["results"] for s in opt.validation_stats])
    if tm is not None:
        snap = tm.registry.snapshot()["metrics"]
        out["gauges"] = {k: snap[k]["series"][0]["value"] for k in (
            "bigdl_plan_param_bytes_per_device",
            "bigdl_plan_param_bytes_total", "bigdl_perf_collective_bytes")}
    return out, opt


def both(name, inputs, data_fn, method_fn, end_fn, batch_size=None,
         **kw):
    """The FSDP run and the plain data-parallel run."""
    fsdp, _ = train(name, inputs, data_fn(), method_fn(), end_fn(),
                    batch_size, fsdp=FSDP_BYTES[name], **kw)
    plain, _ = train(name, inputs, data_fn(), method_fn(), end_fn(),
                     batch_size, **kw)
    return dict(fsdp=fsdp, plain=plain)


# -- the scenarios ---------------------------------------------------------
def mlp(inputs, rank, world, workdir):
    from bigdl_tpu_torch import optim

    return both("mlp", inputs, lambda: samples(*mlp_arrays()),
                lambda: optim.SGD(MLP_LR), lambda: optim.max_iteration(3),
                64, telemetry=True)


def mlp_bf16(inputs, rank, world, workdir):
    """The MLP under ``set_compute_dtype(bfloat16)``, with the dtypes of
    every gather and reduce-scatter the FSDP steps ran."""
    import torch

    from bigdl_tpu_torch import optim
    from bigdl_tpu_torch.parallel import plan

    seen = {"gather": [], "reduce_scatter": []}
    gather, scatter = plan._all_gather, plan._reduce_scatter

    def rec_gather(t, *a):
        seen["gather"].append(str(t.dtype))
        return gather(t, *a)

    def rec_scatter(t, *a):
        seen["reduce_scatter"].append(str(t.dtype))
        return scatter(t, *a)

    plan._all_gather, plan._reduce_scatter = rec_gather, rec_scatter
    try:
        out = both("mlp", inputs, lambda: samples(*mlp_arrays()),
                   lambda: optim.SGD(MLP_LR), lambda: optim.max_iteration(3),
                   64, setup=lambda o: o.set_compute_dtype(torch.bfloat16))
    finally:
        plan._all_gather, plan._reduce_scatter = gather, scatter
    out["dtypes"] = seen
    return out


def lm(inputs, rank, world, workdir):
    from bigdl_tpu_torch import optim

    return both("lm", inputs, lambda: samples(*lm_arrays()),
                lambda: optim.SGD(LM_LR), lambda: optim.max_iteration(3),
                LM_B, telemetry=True)


def resnet(inputs, rank, world, workdir):
    from bigdl_tpu_torch import optim

    return both("resnet", inputs, lambda: samples(*resnet_arrays()),
                lambda: optim.SGD(RES_LR), lambda: optim.max_iteration(3),
                RES_B, telemetry=True)


def masked(inputs, rank, world, workdir):
    from bigdl_tpu_torch import optim

    return both("tail", inputs, lambda: batches(tail_batches()),
                lambda: optim.SGD(TAIL_LR), lambda: optim.max_epoch(2),
                seed=7)


def reg(inputs, rank, world, workdir):
    """The tail net with an L2 penalty on its first weight and
    ``set_scale_w(0.5)`` on its head, both FSDP leaves."""
    from bigdl_tpu_torch import optim

    return both("reg", inputs, lambda: batches(tail_batches()),
                lambda: optim.SGD(TAIL_LR), lambda: optim.max_epoch(1),
                seed=7)


def nan(inputs, rank, world, workdir):
    from bigdl_tpu_torch import optim

    return both("xor", inputs, lambda: samples(*nan_arrays(world)),
                lambda: optim.SGD(XOR_LR), lambda: optim.max_iteration(3), 8)


def trigger(inputs, rank, world, workdir):
    """Validation every 2 iterations inside training."""
    from bigdl_tpu_torch import nn, optim

    def setup(opt):
        opt.set_validation(optim.several_iteration(2),
                           samples(*xor_arrays(10, 9)),
                           [optim.Top1Accuracy(),
                            optim.Loss(nn.ClassNLLCriterion())], 3)

    return both("xor", inputs, lambda: samples(*xor_arrays(32, 3)),
                lambda: optim.SGD(XOR_LR), lambda: optim.max_iteration(4), 8,
                setup=setup)


def resume(inputs, rank, world, workdir):
    """Adam under FSDP, a checkpoint every iteration: 4 iterations
    uninterrupted; then a fresh model and optimizer resumed from the
    checkpoint of iteration 2 trained to 4.  The slots of both runs."""
    from bigdl_tpu_torch import optim

    ckpt = str(workdir / "ckpt")

    def run(resume_step=None):
        def setup(opt):
            opt.set_checkpoint(ckpt, optim.several_iteration(1))
            if resume_step is not None:
                assert opt.resume_from_checkpoint(resume_step)
                opt.set_checkpoint(str(workdir / "ckpt2"),
                                   optim.several_iteration(1))

        out, opt = train("xor", inputs, samples(*xor_arrays(64, 5)),
                         optim.Adam(ADAM_LR), optim.max_iteration(4), 16,
                         fsdp=FSDP_BYTES["xor"], setup=setup)
        out["slots"] = numpy_tree(opt.optim_method._slots)
        return out

    return dict(full=run(), resumed=run(2))


def retry(inputs, rank, world, workdir):
    """Under FSDP, a retryable fault in the third batch, before the
    first checkpoint (every 4 iterations): no checkpoint restores the
    FSDP leaves, which lived only as shards.  What this rank raised and
    the losses it logged before."""
    from bigdl_tpu_torch import optim
    from bigdl_tpu_torch.dataset import SampleToMiniBatch
    from bigdl_tpu_torch.resilience.faults import ExceptionTransformer
    from bigdl_tpu_torch.resilience.retry import RetryPolicy

    fault = ExceptionTransformer(fail_at=RETRY_FAIL_AT)
    data = samples(*xor_arrays(64, 4)) >> fault >> SampleToMiniBatch(16)
    losses, opts = [], []

    def end(state):
        if "loss" in state:
            losses.append(state["loss"])
        return state["neval"] > 6

    def setup(opt):
        opt.set_checkpoint(str(workdir / "retry"), optim.several_iteration(4))
        opt.set_retry_policy(RetryPolicy(backoff_base=0.01))
        opts.append(opt)

    try:
        train("xor", inputs, data, optim.SGD(XOR_LR), optim.Trigger(end),
              fsdp=FSDP_BYTES["xor"], setup=setup)
    except RuntimeError as e:
        return dict(raised=str(e), fired=fault.fired, losses=losses,
                    rollbacks=opts[0].rollbacks,
                    has_fsdp=opts[0].engine.has_fsdp)
    return dict(raised=None, fired=fault.fired, losses=losses)


def bridge(inputs, rank, world, workdir):
    """``TorchOptimMethod`` (one state dict a full parameter) under
    ``set_fsdp``: what the optimizer raised on this rank."""
    import torch

    from bigdl_tpu_torch import optim

    opt = optim.DistriOptimizer(loaded("xor", inputs),
                                samples(*xor_arrays(8, 1)),
                                criterion("xor"), batch_size=8)
    opt.set_optim_method(optim.TorchOptimMethod(torch.optim.SGD, lr=0.1))
    opt.set_fsdp(FSDP_BYTES["xor"]).set_end_when(optim.max_iteration(1))
    try:
        opt.optimize()
    except NotImplementedError as e:
        return str(e)
    return None


SCENARIOS = dict(mlp=mlp, mlp_bf16=mlp_bf16, lm=lm, resnet=resnet,
                 masked=masked, reg=reg, nan=nan, trigger=trigger,
                 resume=resume, retry=retry, bridge=bridge)


def main(argv):
    rank, world, init, workdir = (int(argv[1]), int(argv[2]), argv[3],
                                  Path(argv[4]))
    names = argv[5].split(",") if len(argv) > 5 else list(SCENARIOS)
    sys.path.insert(0, str(REPO))
    import torch

    torch.set_num_threads(1)
    from bigdl_tpu_torch.utils.engine import Engine

    inputs = pickle.loads((workdir / "inputs.pkl").read_bytes())
    Engine.init_distributed(init, world, rank, device="cpu", timeout=60)
    results = {}
    try:
        for name in names:
            results[name] = SCENARIOS[name](inputs, rank, world, workdir)
    except Exception:
        results["error"] = traceback.format_exc()
        raise
    finally:
        (workdir / f"rank{rank}.pkl").write_bytes(pickle.dumps(results))
    Engine.reset()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
