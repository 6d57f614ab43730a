"""DistriOptimizer — synchronous data-parallel SGD over the
``torch.distributed`` process group (counterpart of
``bigdl_tpu/optim/distri_optimizer.py``; reference
optim/DistriOptimizer.scala:41-846, SURVEY §3.1).

The reference's iteration is two Spark jobs and a block-manager
all-reduce; the JAX package's is one shard_mapped program over a device
mesh.  Here every process of the group runs the same loop on its own
device (NCCL on the card, gloo on the CPU), the loop of
``LocalOptimizer`` with the data axis of ``optimizer._DataAxis`` and the
plan step of ``parallel/plan.py``:

  reference                                    this step
  ---------                                    ---------
  getWeights (all-gather via BlockManager)  →  replicated parameters,
                                               rank 0's at the start;
                                               FSDP leaves gathered on
                                               use
  forward/backward per core clone           →  this rank's rows of the
                                               global batch
  putGradients + aggregateGradientPartition →  one all_reduce of a flat
                                               f32 buffer, then /N; an
                                               FSDP leaf's reduce-scatter
  optimMethod on owned slice                →  optim.step on every rank
                                               (replicated leaves whole,
                                               FSDP leaves this rank's
                                               shard)

This class only routes: it resolves the mesh (the Engine's, which
starts a group of one on the model's device where there is no group and
no torchrun env), checks the model's device against the group's
backend and the batch size against the data axis, and hands the loop
its data axis.  Failure handling is the reference's driver retry loop
(DistriOptimizer.scala:750-816): on an exception raised on every rank,
each reloads the latest checkpoint rank 0 wrote and resumes.
"""
from __future__ import annotations

import logging
from typing import Optional

from ..utils.engine import Engine, check_device_backend
from ._sharding_utils import data_mesh
from .optimizer import Optimizer, _DataAxis

log = logging.getLogger("bigdl_tpu_torch")


def normalize_mesh(mesh):
    """The ``("data",)`` mesh of ``mesh`` (its size-1 dimensions
    dropped); a mesh with a model axis of more than one raises, as the
    port has the data axis only."""
    return data_mesh(mesh)


class DistriOptimizer(Optimizer):
    """Distributed training driver (reference DistriOptimizer.scala:689)."""

    def __init__(self, model, dataset, criterion,
                 batch_size: Optional[int] = None, end_trigger=None,
                 mesh=None):
        super().__init__(model, dataset, criterion, batch_size, end_trigger)
        self.mesh = mesh
        # retry policy compat aliases (reference
        # DistriOptimizer.scala:750-752); the loop itself is
        # resilience.retry.RetryPolicy's, built in Optimizer.__init__
        self.max_retry = self.retry_policy.max_retries
        self.retry_window = self.retry_policy.window

    def _with_retry(self, fn):
        """A caller-mutated ``max_retry``/``retry_window`` (the compat
        aliases) wins over the policy's property-derived values."""
        self.retry_policy.max_retries = int(self.max_retry)
        self.retry_policy.window = float(self.retry_window)
        return super()._with_retry(fn)

    def optimize(self):
        self._warn_drop_knobs_if_inert()
        self._axis = _DataAxis(self._route_mesh())
        try:
            with self._preemption_scope():
                return self._with_retry(self._loop)
        finally:
            self._abandon_plan()
            self._shutdown_async_writer()

    def _route_mesh(self):
        """Resolve and validate the training mesh: the data axis of the
        given mesh or of the Engine's default one, a group whose backend
        serves the model's device, and the reference's batch-divisibility
        contract."""
        import torch.distributed as dist

        mesh = self.mesh
        if mesh is None:
            started = not dist.is_initialized()
            mesh = Engine.default_mesh(device=self.model.device)
            if started:
                log.info("DistriOptimizer: no process group — started one "
                         "of %d process(es) on %s over %s",
                         dist.get_world_size(), self.model.device,
                         dist.get_backend())
        mesh = normalize_mesh(mesh)
        check_device_backend(self.model.device)
        n_data = mesh.size()
        if self.batch_size is not None and self.batch_size % n_data != 0:
            raise ValueError(
                f"batch size {self.batch_size} must be divisible by the "
                f"mesh's data-axis size {n_data} (reference "
                "Optimizer.scala:417 requires batchSize % nodeNumber == 0)")
        return mesh


def _latest_file(path: str, prefix: str) -> Optional[str]:
    """reference DistriOptimizer.getLatestFile:828-845 — works on any
    registered filesystem scheme (``utils.file_io``)."""
    from ..utils import file_io

    if path is None or not file_io.isdir(path):
        return None
    best, best_n = None, -1
    for f in file_io.listdir(path):
        if f == prefix:
            return file_io.join(path, f)
        if f.startswith(prefix + "."):
            try:
                n = int(f.rsplit(".", 1)[1])
            except ValueError:
                continue
            if n > best_n:
                best, best_n = file_io.join(path, f), n
    return best
