"""Mesh and batch helpers of the training and evaluation drivers
(counterpart of ``bigdl_tpu/optim/_sharding_utils.py``).

A batch here is what a ``MiniBatch`` holds: an array or tensor with the
records leading, or a list, tuple or dict of them.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def data_mesh(mesh):
    """The ``("data",)`` mesh of ``mesh``: itself, or its ``data``
    dimension where every other dimension has size 1.  A mesh with any
    other axis of more than one is not ported and raises."""
    from torch.distributed.device_mesh import DeviceMesh

    if mesh is None:
        return None
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"expected a torch.distributed DeviceMesh, got "
                        f"{type(mesh).__name__}")
    names = tuple(mesh.mesh_dim_names or ())
    if names == ("data",):
        return mesh
    shape = tuple(mesh.mesh.shape)
    other = [f"{n}={s}" for n, s in zip(names, shape) if n != "data" and s > 1]
    if other or "data" not in names:
        raise NotImplementedError(
            f"a mesh with dimensions {dict(zip(names, shape))} is not "
            "ported to bigdl_tpu_torch yet (ROADMAP Queue 1 item 5d: the "
            "model, seq and pipe axes); the port trains over a ('data',) "
            "mesh")
    return mesh["data"]


def round_up(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def map_batch(fn, batch):
    """``fn`` over the record-leading leaves of a batch: lists, tuples
    and dicts recurse, anything else is a leaf."""
    if isinstance(batch, (list, tuple)):
        return type(batch)(map_batch(fn, v) for v in batch)
    if isinstance(batch, dict):
        return {k: map_batch(fn, v) for k, v in batch.items()}
    return fn(batch)


def mesh_device(mesh) -> torch.device:
    """This rank's device on ``mesh``: the current CUDA device, or the
    CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def maskable(y, n_records: int) -> bool:
    """Pad-and-mask weighs each record's loss, so every target leaf must
    be an array with the ``n_records`` records leading."""
    leaves = []
    map_batch(leaves.append, y)
    return bool(leaves) and all(
        hasattr(v, "shape") and len(v.shape) >= 1
        and v.shape[0] == n_records for v in leaves)


def pad_batch(x, y, size: int, target: int):
    """Pad a batch to ``target`` records by repeating the last record
    (padded rows stay numerically valid, e.g. 1-based class labels);
    returns ``(x, y, weight)`` with ``weight`` the float32 1-real/0-pad
    mask over the records (reference DataSet.scala:255-288)."""
    pad = target - size

    def pad_leaf(a):
        if torch.is_tensor(a):
            return torch.cat([a, a[-1:].expand(pad, *a.shape[1:])])
        a = np.asarray(a)
        return np.concatenate([a, np.repeat(a[-1:], pad, axis=0)])

    w = np.concatenate([np.ones(size, np.float32), np.zeros(pad, np.float32)])
    return map_batch(pad_leaf, x), map_batch(pad_leaf, y), w


def rows_of(batch, rank: int, n_shards: int, device: Optional[torch.device]
            = None):
    """Rank ``rank``'s contiguous rows of a batch whose record count
    divides by ``n_shards``, as tensors on ``device``."""
    def take(a):
        n = a.shape[0]
        if n % n_shards:
            raise ValueError(f"{n} records do not divide over {n_shards} "
                             "shards")
        b = n // n_shards
        rows = a[rank * b:(rank + 1) * b]
        t = rows if torch.is_tensor(rows) else torch.as_tensor(
            np.asarray(rows))
        return t if device is None else t.to(device)

    return map_batch(take, batch)
