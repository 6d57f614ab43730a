"""Predictor (counterpart of ``bigdl_tpu/optim/predictor.py``; reference
optim/Predictor.scala:34, LocalPredictor.scala:37).

Batches of the dataset run through the model's forward on its own
device, in eval mode, under ``torch.no_grad()``; the outputs come back
to the host one sample at a time.  Over a ``("data",)`` mesh every rank
of the process group predicts its rows of each batch (a trailing batch
padded to the full batch size, rounded up to the mesh multiple, as the
JAX package pads it), the rows are gathered in rank order — the
batch's order — and cut to the real count, so every rank returns every
sample's output.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from ._sharding_utils import data_mesh, round_up
from .evaluator import _batches, mesh_rows


def _gather_rows(out: torch.Tensor, group) -> torch.Tensor:
    """Every rank's rows of ``out`` in rank order."""
    import torch.distributed as dist

    out = out.contiguous()
    every = out.new_empty((dist.get_world_size(group) * out.shape[0],
                           *out.shape[1:]))
    dist.all_gather_into_tensor(every, out, group=group)
    return every


class Predictor:
    def __init__(self, model, mesh=None):
        self.model = model
        self.mesh = data_mesh(mesh)

    def predict(self, dataset, batch_size: int = 32) -> List[np.ndarray]:
        """Each sample's output, in the dataset's order (the
        reference's RDD[Activity])."""
        from .optimizer import _device_batch

        model, mesh = self.model.evaluate(), self.mesh
        params = model.param_tree()
        outs = []
        with torch.no_grad():
            for batch in _batches(dataset, batch_size):
                size = batch.size()
                if mesh is None:
                    x, _ = _device_batch(batch, model.device)
                    out = model.apply_fn(params, x)
                else:
                    target = round_up(max(size, batch_size), mesh.size())
                    x, _, _ = mesh_rows(mesh, batch, model.device, target)
                    out = _gather_rows(model.apply_fn(params, x),
                                       mesh.get_group())[:size]
                out = out.float().cpu().numpy()
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
