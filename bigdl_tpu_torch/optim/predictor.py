"""Predictor (counterpart of ``bigdl_tpu/optim/predictor.py``, its
single-device part; reference optim/Predictor.scala:34,
LocalPredictor.scala:37).

Batches of the dataset run through the model's forward on its own
device, in eval mode, under ``torch.no_grad()``; the outputs come back
to the host one sample at a time.  The mesh-sharded path of the JAX
package comes with the port's distributed slice and raises.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..dataset.sample import MiniBatch, SampleToMiniBatch
from .evaluator import _not_ported


class Predictor:
    def __init__(self, model, mesh=None):
        if mesh is not None:
            raise _not_ported("prediction over a device mesh")
        self.model = model

    def _batches(self, dataset, batch_size):
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

    def predict(self, dataset, batch_size: int = 32) -> List[np.ndarray]:
        """Each sample's output, in the dataset's order (the
        reference's RDD[Activity])."""
        from .optimizer import _device_batch

        model = self.model.evaluate()
        params = model.param_tree()
        outs = []
        with torch.no_grad():
            for batch in self._batches(dataset, batch_size):
                x, _ = _device_batch(batch, model.device)
                out = model.apply_fn(params, x).float().cpu().numpy()
                outs.extend(out[i] for i in range(out.shape[0]))
        return outs

    def predict_class(self, dataset, batch_size: int = 32) -> List[int]:
        """1-based argmax classes (reference predictClass)."""
        return [int(np.argmax(o)) + 1
                for o in self.predict(dataset, batch_size)]


class LocalPredictor(Predictor):
    """Single-process predictor (reference optim/LocalPredictor.scala:37)."""

    def __init__(self, model):
        super().__init__(model, mesh=None)
