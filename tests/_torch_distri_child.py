"""One rank of ``tests/test_torch_distri.py``'s multi-process runs.

    python tests/_torch_distri_child.py RANK WORLD INIT_URL WORKDIR [NAMES]

Joins a gloo group of WORLD processes (``Engine.init_distributed`` over
INIT_URL, a ``file://`` store), runs every scenario of ``SCENARIOS``
(or those NAMES lists, comma-separated) on the CPU with one intra-op
thread, and pickles what each one read to
``WORKDIR/rank<RANK>.pkl`` (a scenario's traceback under ``"error"``
when one fails).  The initial weights come from the JAX models the test
built (``WORKDIR/inputs.pkl``: numpy trees, loaded by key), so the test
can run the same steps through the JAX package.  Imports neither jax nor
the JAX package.
"""
import pickle
import sys
import traceback
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]

XOR_LR, ADAM_LR, TAIL_LR, BN_LR, LM_LR = 0.1, 0.05, 0.5, 0.1, 0.05
LM_V, LM_T, LM_B = 50, 16, 4
LM_KW = dict(embed_dim=64, num_heads=4, num_layers=2, max_len=LM_T,
             seq_strategy="flash", output="logits")


# -- data, shared with the test process ---------------------------------
def xor_arrays(n, seed):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, 2).astype(np.float32)
    y = ((x[:, 0] > 0.5) ^ (x[:, 1] > 0.5)).astype(np.float32) + 1
    return x, y


def tail_arrays(n):
    """``tests/_multihost_train_child.py``'s records."""
    rng = np.random.RandomState(0)
    x = rng.randn(n, 6).astype(np.float32)
    y = (rng.randint(0, 4, n) + 1).astype(np.float32)
    return x, y


def masked_batches(sizes=(16, 16, 9)):
    """Prebuilt batches whose last record count (9) divides by neither 2
    nor 4: the trailing batch trains through pad-and-mask."""
    x, y = tail_arrays(sum(sizes))
    cuts = np.cumsum((0,) + tuple(sizes))
    return [(x[a:b], y[a:b]) for a, b in zip(cuts, cuts[1:])]


def bn_arrays(n, seed=3):
    rng = np.random.RandomState(seed)
    x = (2.0 * rng.randn(n, 4) + 0.5).astype(np.float32)
    y = (rng.randint(0, 3, n) + 1).astype(np.float32)
    return x, y


def lm_arrays():
    rng = np.random.RandomState(0)
    x = rng.randint(1, LM_V + 1, size=(LM_B, LM_T)).astype(np.int32)
    y = rng.randint(1, LM_V + 1, size=(LM_B, LM_T)).astype(np.int32)
    return x, y


def nan_arrays(world):
    """32 XOR records, one NaN feature in the first row rank 1 takes of
    the second batch of 8 (record 8 + 8 / world)."""
    x, y = xor_arrays(32, 2)
    x[8 + 8 // world, 0] = np.nan
    return x, y


# -- the port side -------------------------------------------------------
def _port():
    import torch

    from bigdl_tpu_torch import nn, optim
    from bigdl_tpu_torch.dataset import Sample, array
    from bigdl_tpu_torch.dataset.sample import MiniBatch

    return torch, nn, optim, Sample, array, MiniBatch


def port_model(name):
    torch, nn, *_ = _port()
    cpu = dict(device="cpu")
    if name == "xor":
        return nn.Sequential(nn.Linear(2, 32, **cpu), nn.Tanh(**cpu),
                             nn.Linear(32, 2, **cpu), nn.LogSoftMax(**cpu))
    if name == "tail":
        return nn.Sequential(nn.Linear(6, 16, **cpu), nn.Tanh(**cpu),
                             nn.Linear(16, 4, **cpu), nn.LogSoftMax(**cpu))
    if name == "bn":
        return nn.Sequential(nn.Linear(4, 8, **cpu),
                             nn.BatchNormalization(8, **cpu), nn.ReLU(**cpu),
                             nn.Linear(8, 3, **cpu), nn.LogSoftMax(**cpu))
    if name == "drop":
        return nn.Sequential(nn.Dropout(0.5, **cpu), nn.Linear(4, 3, **cpu),
                             nn.LogSoftMax(**cpu))
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
    *_, Sample, array, _ = _port()
    return array([Sample(a, b) for a, b in zip(x, y)])


def batches(pairs):
    *_, array, MiniBatch = _port()
    return array([MiniBatch(a, b) for a, b in pairs])


def numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy().copy()


def train(model, data, crit, method, end, batch_size=None, seed=1,
          optimizer=None, setup=None):
    """``end``'s iterations of DistriOptimizer (or ``optimizer``) from
    host seed ``seed``: the optimizer and each iteration's loss."""
    _, _, optim, *_ = _port()
    losses = []

    def check(state):
        if "loss" in state:
            losses.append(state["loss"])
        return end(state)

    from bigdl_tpu_torch.utils.rng import RNG

    opt = (optimizer or optim.DistriOptimizer)(model, data, crit,
                                              batch_size=batch_size)
    opt.set_optim_method(method).set_end_when(optim.Trigger(check))
    if setup is not None:
        setup(opt)
    RNG().set_seed(seed)
    opt.optimize()
    return opt, losses


def trained(opt, losses, model):
    return dict(params=numpy_tree(model.param_tree()),
                buffers=numpy_tree(model.buffer_tree()), losses=losses,
                skipped=opt.skipped_steps,
                neval=opt.optim_method.state["neval"])


# -- the scenarios ---------------------------------------------------------
def allreduce(inputs, rank, world, workdir):
    torch, *_ = _port()
    from bigdl_tpu_torch.parallel import AllReduceParameter, shard_batch
    from bigdl_tpu_torch.utils.engine import Engine

    out = {}
    for compress, seed, width in (("none", 0, 10), ("bf16", 1, 16)):
        rng = np.random.RandomState(seed)
        g = (rng.rand(world, width) if seed == 0
             else rng.randn(world, width)).astype(np.float32)
        arp = AllReduceParameter({"w": torch.zeros(width)}, world,
                                 compress=compress)
        piece = arp.reduce_scatter_gradients({"w": torch.from_numpy(g[rank])})
        full = arp.all_gather_weights(piece)["w"]
        own = arp.my_weight_slice({"w": torch.from_numpy(g[rank])})
        out[compress] = dict(full=full.numpy(), slice=piece.numpy(),
                             own=own.numpy())
    rows = np.arange(world * 3 * 2).reshape(world * 3, 2)
    out["shard"] = {k: v.numpy() for k, v in shard_batch(
        Engine.default_mesh(), {"x": rows, "y": rows[:, 0]}).items()}
    return out


def xor_sgd(inputs, rank, world, workdir):
    _, nn, optim, *_ = _port()
    model = loaded("xor", inputs)
    opt, losses = train(model, samples(*xor_arrays(64, 5)),
                        nn.ClassNLLCriterion(), optim.SGD(XOR_LR),
                        optim.max_iteration(3), batch_size=64)
    return trained(opt, losses, model)


def adam(inputs, rank, world, workdir):
    _, nn, optim, *_ = _port()
    model = loaded("xor", inputs)
    opt, losses = train(model, samples(*xor_arrays(64, 5)),
                        nn.ClassNLLCriterion(), optim.Adam(ADAM_LR),
                        optim.max_iteration(4), batch_size=16)
    out = trained(opt, losses, model)
    out["slots"] = numpy_tree(opt.optim_method._slots)
    return out


def tail40(inputs, rank, world, workdir):
    _, nn, optim, *_ = _port()
    model = loaded("tail", inputs)
    opt, losses = train(model, samples(*tail_arrays(40)),
                        nn.ClassNLLCriterion(), optim.SGD(TAIL_LR),
                        optim.max_epoch(3), batch_size=16, seed=7)
    return trained(opt, losses, model)


def masked(inputs, rank, world, workdir):
    _, nn, optim, *_ = _port()
    model = loaded("tail", inputs)
    opt, losses = train(model, batches(masked_batches()),
                        nn.ClassNLLCriterion(), optim.SGD(TAIL_LR),
                        optim.max_epoch(3), seed=7)
    return trained(opt, losses, model)


def bn(inputs, rank, world, workdir):
    _, nn, optim, *_ = _port()
    out = {}
    for label, n in (("full", 8), ("partial", 5)):
        model = loaded("bn", inputs)
        opt, losses = train(model, batches([bn_arrays(n)]),
                            nn.ClassNLLCriterion(), optim.SGD(BN_LR),
                            optim.max_iteration(1))
        out[label] = trained(opt, losses, model)
    return out


def lm(inputs, rank, world, workdir):
    _, nn, optim, *_ = _port()
    model = loaded("lm", inputs)
    opt, losses = train(model, samples(*lm_arrays()),
                        nn.TimeDistributedCriterion(
                            nn.CrossEntropyCriterion(), True),
                        optim.SGD(LM_LR), optim.max_iteration(3),
                        batch_size=LM_B)
    return trained(opt, losses, model)


def validate(inputs, rank, world, workdir):
    _, nn, optim, *_ = _port()
    from bigdl_tpu_torch.utils.engine import Engine

    model = loaded("xor", inputs)
    mesh = Engine.default_mesh()
    methods = [optim.Top1Accuracy(), optim.Loss(nn.ClassNLLCriterion())]
    out = {}
    for bsz in (3, 4):
        res = optim.DistriValidator(model, mesh).test(
            samples(*xor_arrays(10, 9)), methods, bsz)
        out[f"val{bsz}"] = [(type(r).__name__, vars(r), name)
                            for r, name in res]
    out["predict"] = np.stack(model.predict(samples(*xor_arrays(7, 4)), 3,
                                            mesh=mesh))
    out["predict_class"] = model.predict_class(samples(*xor_arrays(7, 4)),
                                               2, mesh=mesh)
    return out


def trigger(inputs, rank, world, workdir, optimizer=None):
    """Validation every 2 iterations inside training, and a train
    summary per rank (only rank 0's may hold scalars)."""
    _, nn, optim, *_ = _port()
    from bigdl_tpu_torch.visualization import TrainSummary

    model = loaded("xor", inputs)
    summary = TrainSummary(str(workdir / f"logs{rank}"), "xor")

    def setup(opt):
        opt.set_validation(optim.several_iteration(2),
                           samples(*xor_arrays(10, 9)),
                           [optim.Top1Accuracy(),
                            optim.Loss(nn.ClassNLLCriterion())], 3)
        opt.set_train_summary(summary)

    opt, losses = train(model, samples(*xor_arrays(32, 3)),
                        nn.ClassNLLCriterion(), optim.SGD(XOR_LR),
                        optim.max_iteration(4), batch_size=8,
                        optimizer=optimizer, setup=setup)
    out = trained(opt, losses, model)
    out.update(validation=[s["results"] for s in opt.validation_stats],
               summary_losses=summary.read_scalar("Loss"))
    summary.close()
    return out


def retry(inputs, rank, world, workdir):
    _, nn, optim, *_ = _port()
    from bigdl_tpu_torch.dataset import SampleToMiniBatch
    from bigdl_tpu_torch.resilience.faults import ExceptionTransformer
    from bigdl_tpu_torch.resilience.retry import RetryPolicy

    fault = ExceptionTransformer(fail_at=200)
    data = samples(*xor_arrays(256, 0)) >> fault >> SampleToMiniBatch(64)
    model = loaded("xor", inputs)
    ckpt = str(workdir / "ckpt")

    def setup(opt):
        opt.set_checkpoint(ckpt, optim.several_iteration(1))
        opt.set_retry_policy(RetryPolicy(backoff_base=0.01))

    opt, losses = train(model, data, nn.ClassNLLCriterion(),
                        optim.SGD(0.3), optim.max_iteration(10), setup=setup)
    out = trained(opt, losses, model)
    out.update(fired=fault.fired, rollbacks=opt.rollbacks,
               checkpoints=len(opt.checkpoint_stats))
    return out


def nan(inputs, rank, world, workdir):
    _, nn, optim, *_ = _port()
    model = loaded("xor", inputs)
    opt, losses = train(model, samples(*nan_arrays(world)),
                        nn.ClassNLLCriterion(), optim.SGD(XOR_LR),
                        optim.max_iteration(3), batch_size=8)
    return trained(opt, losses, model)


def dropout(inputs, rank, world, workdir):
    """The dropout layer's output on all-ones records, step 1, twice
    from the same host seed."""
    torch, nn, optim, *_ = _port()
    masks = []
    for _ in range(2):
        model = loaded("drop", inputs)
        layer = model[0]
        run = layer._compute
        seen = []

        def record(params, x, _run=run, _seen=seen):
            out = _run(params, x)
            _seen.append(out.detach().clone().numpy())
            return out

        layer._compute = record
        x = np.ones((8, 4), np.float32)
        y = np.ones(8, np.float32)
        train(model, samples(x, y), nn.ClassNLLCriterion(),
              optim.SGD(0.1), optim.max_iteration(1), batch_size=8)
        masks.append(seen[0])
    return dict(first=masks[0], again=masks[1])


def divisibility(inputs, rank, world, workdir):
    _, nn, optim, *_ = _port()
    model = loaded("xor", inputs)
    opt = optim.DistriOptimizer(model, samples(*xor_arrays(8, 1)),
                                nn.ClassNLLCriterion(),
                                batch_size=world + 1)
    try:
        opt.optimize()
    except ValueError as e:
        return str(e)
    return None


def telemetry(inputs, rank, world, workdir):
    """``tests/test_telemetry.py``'s regression MLP, 12 iterations of
    batch 64, with a Telemetry bundle (the default profile interval
    profiles iteration 10), then again without one: what the bundle
    read, and both runs' losses and weights."""
    torch, nn, optim, *_ = _port()
    from bigdl_tpu_torch.telemetry import MetricsRegistry, Telemetry

    rng = np.random.RandomState(0)
    x = rng.rand(256, 4).astype(np.float32)
    w = np.array([[1.5], [-2.0], [0.5], [3.0]], np.float32)
    y = (x @ w + 0.7).astype(np.float32)
    out = {}
    for label in ("telemetry", "plain"):
        g = torch.Generator().manual_seed(0)
        model = nn.Sequential(nn.Linear(4, 8, device="cpu", generator=g),
                              nn.Tanh(device="cpu"),
                              nn.Linear(8, 1, device="cpu", generator=g),
                              device="cpu")
        tm = Telemetry(registry=MetricsRegistry(), host=f"rank{rank}")

        def setup(opt, tm=tm, label=label):
            if label == "telemetry":
                opt.set_telemetry(tm)

        opt, losses = train(model, samples(x, y), nn.MSECriterion(),
                            optim.SGD(0.2), optim.max_iteration(12),
                            batch_size=64, setup=setup)
        got = trained(opt, losses, model)
        if label == "telemetry":
            spans = tm.tracer.spans()
            by_id = {s.id: s for s in spans}
            got.update(
                n_params=sum(p.numel() for p in model.parameters()),
                steps=tm.steps.value, records=tm.records.value,
                compile_count=tm.compile_seconds.count,
                step_count=tm.step_seconds.count,
                phase_source=opt.phase_source,
                span_names=[s.name for s in spans],
                children={s.name: (by_id[s.parent_id].args.get("step"),
                                   s.duration)
                          for s in spans if s.parent_id is not None},
                payload=tm.payload(step=12),
                accounted=tm.ledger.snapshot()["accounted_fraction"])
        out[label] = got
    return out


SCENARIOS = dict(allreduce=allreduce, xor_sgd=xor_sgd, adam=adam,
                 tail40=tail40, masked=masked, bn=bn, lm=lm,
                 validate=validate, trigger=trigger, retry=retry, nan=nan,
                 dropout=dropout,
                 divisibility=divisibility)
#: run only when named (tests/test_torch_telemetry.py)
ON_REQUEST = dict(telemetry=telemetry)


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
            fn = SCENARIOS.get(name) or ON_REQUEST[name]
            results[name] = fn(inputs, rank, world, workdir)
    except Exception:
        results["error"] = traceback.format_exc()
        raise
    finally:
        (workdir / f"rank{rank}.pkl").write_bytes(pickle.dumps(results))
    Engine.reset()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
