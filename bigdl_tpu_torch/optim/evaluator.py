"""Evaluator (counterpart of ``bigdl_tpu/optim/evaluator.py``; reference
optim/Evaluator.scala:37, LocalValidator.scala).

Batches run through the model's forward on its own device, in eval
mode, under ``torch.no_grad()``; each validation method reduces on that
device and reads back only its counts or sums.  Results add as monoids
across batches.  The mesh-sharded validation of the JAX package
(``mesh=``, ``DistriValidator``) is not ported yet and raises.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from ..dataset.sample import MiniBatch, SampleToMiniBatch
from .validation import ValidationMethod, ValidationResult

def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported to bigdl_tpu_torch "
                               f"yet")


def evaluate_dataset(model, dataset, v_methods: Sequence[ValidationMethod],
                     batch_size: int = 128, mesh=None, params=None
                     ) -> List[ValidationResult]:
    """The evaluation loop; ``dataset`` may yield Samples (batched by
    ``batch_size``, the last partial batch included) or MiniBatches.
    ``params``: the tree to evaluate with (default the model's own)."""
    from .optimizer import _device_batch

    if mesh is not None:
        raise _not_ported("validation over a device mesh")
    model.evaluate()
    if params is None:
        params = model.param_tree()
    batcher = SampleToMiniBatch(batch_size)

    def batches():
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

    results = [None] * len(v_methods)
    with torch.no_grad():
        for batch in batches():
            x, y = _device_batch(batch, model.device)
            out = model.apply_fn(params, x)
            for i, m in enumerate(v_methods):
                r = m(out, y)
                results[i] = r if results[i] is None else results[i] + r
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
    """reference optim/DistriValidator.scala:35 — not ported yet."""

    def __init__(self, model, mesh=None):
        raise _not_ported("DistriValidator (validation over a device mesh)")
