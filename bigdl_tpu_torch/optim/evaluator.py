"""Evaluator (counterpart of ``bigdl_tpu/optim/evaluator.py``; reference
optim/Evaluator.scala:37, LocalValidator.scala, DistriValidator.scala:35).

Batches run through the model's forward on its own device, in eval
mode, under ``torch.no_grad()``; each validation method reduces on that
device and reads back only its counts or sums.  Results add as monoids
across batches.

Over a ``("data",)`` mesh (``mesh=``, ``DistriValidator``) every rank of
the process group runs its rows of each batch, the batch padded to the
mesh multiple by repeating its last record and the padded rows left out
of the methods; the ranks' results are then gathered and added, so
every rank returns the one-device result (the reference's driver-side
reduce of per-partition results).
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from ..dataset.sample import MiniBatch, SampleToMiniBatch
from ._sharding_utils import data_mesh, map_batch, pad_batch, round_up, rows_of
from .validation import ValidationMethod, ValidationResult


def _batches(dataset, batch_size: int):
    """The dataset's MiniBatches, Samples batched by ``batch_size`` (the
    last partial batch included)."""
    batcher = SampleToMiniBatch(batch_size)
    pending = []
    for item in dataset.data(train=False):
        if isinstance(item, MiniBatch):
            yield item
        else:
            pending.append(item)
            if len(pending) == batch_size:
                yield batcher.make(pending)
                pending = []
    if pending:
        yield batcher.make(pending)


def mesh_rows(mesh, batch: MiniBatch, device: torch.device, target=None):
    """This rank's rows of ``batch`` padded to ``target`` records (by
    default the mesh multiple) on ``device``: ``(x, y, n_real)`` with
    ``n_real`` the rows of them that are real records."""
    n, size, rank = batch.size(), mesh.size(), mesh.get_local_rank()
    target = round_up(n, size) if target is None else target
    x, y = batch.get_input(), batch.get_target()
    if target != n:
        x, y, _ = pad_batch(x, y, n, target)
    b = target // size
    n_real = max(0, min(b, n - rank * b))
    return (rows_of(x, rank, size, device), rows_of(y, rank, size, device),
            n_real)


def _gathered_sum(results, group) -> list:
    """Every rank's results added in rank order (None: no real rows)."""
    import torch.distributed as dist

    every = [None] * dist.get_world_size(group)
    dist.all_gather_object(every, results, group=group)
    total = [None] * len(results)
    for rank_results in every:
        for i, r in enumerate(rank_results):
            if r is not None:
                total[i] = r if total[i] is None else total[i] + r
    return total


def evaluate_dataset(model, dataset, v_methods: Sequence[ValidationMethod],
                     batch_size: int = 128, mesh=None, params=None
                     ) -> List[ValidationResult]:
    """The evaluation loop; ``dataset`` may yield Samples (batched by
    ``batch_size``, the last partial batch included) or MiniBatches.
    ``params``: the tree to evaluate with (default the model's own).
    ``mesh``: a ``("data",)`` DeviceMesh whose ranks each evaluate their
    rows of every batch; every rank returns the one-device result."""
    from .optimizer import _device_batch

    mesh = data_mesh(mesh)
    model.evaluate()
    if params is None:
        params = model.param_tree()
    results = [None] * len(v_methods)
    with torch.no_grad():
        for batch in _batches(dataset, batch_size):
            if mesh is None:
                x, y = _device_batch(batch, model.device)
            else:
                x, y, n_real = mesh_rows(mesh, batch, model.device)
                if n_real == 0:
                    continue
                cut = lambda a: a[:n_real]  # noqa: E731
                x, y = map_batch(cut, x), map_batch(cut, y)
            out = model.apply_fn(params, x)
            for i, m in enumerate(v_methods):
                r = m(out, y)
                results[i] = r if results[i] is None else results[i] + r
    if mesh is not None:
        results = _gathered_sum(results, mesh.get_group())
    return [r for r in results if r is not None]


class Evaluator:
    """reference optim/Evaluator.scala:37 — model.evaluate(dataset,
    methods)."""

    def __init__(self, model):
        self.model = model

    def test(self, dataset, v_methods, batch_size: int = 128):
        results = evaluate_dataset(self.model, dataset, v_methods,
                                   batch_size)
        return list(zip(results, [m.format() for m in v_methods]))


class LocalValidator(Evaluator):
    """reference optim/LocalValidator.scala:37"""


class DistriValidator(Evaluator):
    """reference optim/DistriValidator.scala:35 — validation over the
    data axis of ``mesh`` (by default the Engine's, which starts a group
    of one on the model's device where there is none)."""

    def __init__(self, model, mesh=None):
        super().__init__(model)
        if mesh is None:
            from ..utils.engine import Engine

            mesh = Engine.default_mesh(device=model.device)
        self.mesh = data_mesh(mesh)

    def test(self, dataset, v_methods, batch_size: int = 128):
        results = evaluate_dataset(self.model, dataset, v_methods,
                                   batch_size, mesh=self.mesh)
        return list(zip(results, [m.format() for m in v_methods]))
