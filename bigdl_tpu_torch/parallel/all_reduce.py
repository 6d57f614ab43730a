"""AllReduceParameter on ``torch.distributed`` collectives (counterpart
of ``bigdl_tpu/parallel/all_reduce.py``; reference
parameters/AllReduceParameter.scala:67-306).

The reference hand-rolls, over Spark's block manager:
  (a) putGradients: fp16-compress the full local gradient, scatter slices
  (b) aggregateGradientPartition: fetch + sum my slice   → reduce-scatter
  (c) OptimMethod on my owned slice                      → sharded update
  (d) sendWeightPartition / getWeights                   → all-gather

Here (a)+(b) are one ``dist.reduce_scatter_tensor`` over a flat, padded
f32 vector and (d) one ``dist.all_gather_into_tensor``: NCCL on the
card, gloo on the CPU.  The fp16 wire codec is a bf16 cast on the
scatter, behind the ``compress`` flag.  Rank r owns the slice
``[r·slice, (r+1)·slice)`` (AllReduceParameter.scala:136-154).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..utils.tree import tree_leaves, tree_map


def padded_size(n: int, num_shards: int) -> int:
    return (n + num_shards - 1) // num_shards * num_shards


class AllReduceParameter:
    """Flat-parameter sharding over the ranks of the process group:
    ``partition_num`` slices of a flat f32 vector of every leaf of
    ``params_template`` in key order, padded with zeros to a multiple of
    ``partition_num``.  ``axis_name`` is kept for the JAX signature: the
    port's data axis is the whole group."""

    def __init__(self, params_template, partition_num: int,
                 axis_name: str = "data", compress: str = "bf16"):
        if compress not in ("bf16", "none"):
            raise ValueError(f"compress {compress!r} not in ('bf16', "
                             "'none')")
        leaves = tree_leaves(params_template)
        self._shapes = [tuple(t.shape) for t in leaves]
        self._dtypes = [t.dtype for t in leaves]
        self._template = params_template
        self.size = sum(t.numel() for t in leaves)
        self.partition_num = int(partition_num)
        self.axis_name = axis_name
        self.compress = compress
        self.padded = padded_size(self.size, self.partition_num)
        self.slice_size = self.padded // self.partition_num

    # -- host helpers ----------------------------------------------------
    def flatten(self, params) -> torch.Tensor:
        """Every leaf as f32, concatenated in key order and zero-padded
        to ``padded``."""
        leaves = tree_leaves(params)
        flat = torch.cat([t.detach().reshape(-1).float() for t in leaves])
        return torch.nn.functional.pad(flat, (0, self.padded - self.size))

    def unflatten(self, flat: torch.Tensor):
        """The tree of ``flat[:size]``, each leaf in its template's shape
        and dtype."""
        parts, at = [], 0
        for shape, dtype in zip(self._shapes, self._dtypes):
            n = 1
            for s in shape:
                n *= s
            parts.append(flat[at:at + n].reshape(shape).to(dtype))
            at += n
        it = iter(parts)
        return tree_map(lambda _: next(it), self._template)

    def init_slices(self, optim_method, params):
        """Optimizer slots for ONE owned slice (the state the reference
        keeps per partition)."""
        leaves = tree_leaves(params)
        zero = torch.zeros(self.slice_size, dtype=torch.float32,
                           device=leaves[0].device)
        return optim_method.init_state(zero)

    # -- collectives -----------------------------------------------------
    def reduce_scatter_gradients(self, grads_tree) -> torch.Tensor:
        """(a)+(b): this rank's gradient tree → its slice of the sum over
        ranks, f32 (summed in bf16 on the wire under ``compress``)."""
        flat = self.flatten(grads_tree)
        if self.compress == "bf16":
            flat = flat.to(torch.bfloat16)
        out = flat.new_empty(self.slice_size)
        dist.reduce_scatter_tensor(out, flat)
        return out.float()

    def all_gather_weights(self, weight_slice: torch.Tensor):
        """(d): this rank's updated slice → the full parameter tree."""
        flat = weight_slice.new_empty(self.padded)
        dist.all_gather_into_tensor(flat, weight_slice.contiguous())
        return self.unflatten(flat)

    def my_weight_slice(self, params_tree) -> torch.Tensor:
        """This rank's slice of the (replicated) flat parameter."""
        r = dist.get_rank()
        return self.flatten(params_tree)[r * self.slice_size:
                                         (r + 1) * self.slice_size]


def shard_batch(mesh, batch_arrays, axis_name: str = "data"):
    """This rank's rows of a global batch (arrays or tensors, or lists,
    tuples and dicts of them, records leading), as tensors on its
    device: the mesh's CUDA device (the current one) or the CPU.  The
    record count must divide by the mesh's ``axis_name`` size."""
    from ..optim._sharding_utils import mesh_device, rows_of

    return rows_of(batch_arrays, mesh.get_local_rank(axis_name),
                   mesh.size(mesh.mesh_dim_names.index(axis_name)),
                   mesh_device(mesh))
