"""DataSet abstractions (counterpart of ``bigdl_tpu/dataset/dataset.py``,
trimmed to the local path; reference dataset/DataSet.scala:46-557).

``LocalArrayDataSet`` mirrors the reference's in-memory dataset with
index-array shuffling (CachedDistriDataSet.shuffle, DataSet.scala:292)
on the host RNG of ``utils/rng.py``, so one seed gives the JAX
package's epoch order.  ``ShardedDataSet``/``rdd`` keep the
reference's distributed spelling; on one device they are the local
array.
"""
from __future__ import annotations

from typing import Iterator, List, Optional, Sequence

import numpy as np

from ..utils.rng import RNG
from .transformer import Transformer


class AbstractDataSet:
    """reference dataset/DataSet.scala:46"""

    def data(self, train: bool) -> Iterator:
        raise NotImplementedError

    def size(self) -> int:
        raise NotImplementedError

    def shuffle(self):
        raise NotImplementedError

    def transform(self, transformer: Transformer) -> "TransformedDataSet":
        return TransformedDataSet(self, transformer)

    # -- checkpointable pipeline state (docs/determinism.md) -----------
    # Datasets that own ordering/shuffling state override these so the
    # optimizer can capture the input pipeline inside a checkpoint and
    # resume on the exact next batch.  The base contract is "stateless":
    # safe for purely functional sources.
    def state_dict(self) -> dict:
        return {}

    def load_state_dict(self, state: dict):
        return self

    # `ds -> transformer` spelled `ds >> transformer`
    def __rshift__(self, transformer: Transformer):
        return self.transform(transformer)


class LocalArrayDataSet(AbstractDataSet):
    """In-memory dataset with index shuffling (reference DataSet.scala:128)."""

    def __init__(self, data: Sequence):
        self._data = list(data)
        self._index = np.arange(len(self._data))

    def size(self) -> int:
        return len(self._data)

    def shuffle(self):
        RNG().shuffle(self._index)
        return self

    def state_dict(self) -> dict:
        # the live index permutation IS the epoch's record order; the
        # shuffler (the thread-local RNG()) is captured separately by
        # the optimizer's train-state checkpoint
        return {"index": np.array(self._index)}

    def load_state_dict(self, state: dict):
        idx = np.asarray(state.get("index", ()))
        if idx.shape == self._index.shape:
            self._index = idx.copy()
        return self

    def data(self, train: bool) -> Iterator:
        if train:
            # infinite looping iterator (reference DataSet.scala:255-288)
            def gen():
                while True:
                    for i in self._index:
                        yield self._data[i]

            return gen()
        return (self._data[i] for i in range(len(self._data)))


class TransformedDataSet(AbstractDataSet):
    def __init__(self, base: AbstractDataSet, transformer: Transformer):
        self.base = base
        self.transformer = transformer

    def size(self) -> int:
        return self.base.size()

    def shuffle(self):
        self.base.shuffle()
        return self

    def state_dict(self) -> dict:
        return self.base.state_dict()

    def load_state_dict(self, state: dict):
        self.base.load_state_dict(state)
        return self

    def data(self, train: bool) -> Iterator:
        return self.transformer(self.base.data(train))


class ShardedDataSet(LocalArrayDataSet):
    """Distributed-dataset seam (reference DataSet.rdd): the JAX
    DistriOptimizer shards its batches over the mesh's ``data`` axis.
    ``partition_num`` is kept for API parity; on one device the records
    are the local array's."""

    def __init__(self, data: Sequence, partition_num: int = 1):
        super().__init__(data)
        self.partition_num = partition_num


def array(data: Sequence) -> LocalArrayDataSet:
    """reference DataSet.array (DataSet.scala:325)"""
    return LocalArrayDataSet(data)


def rdd(data: Sequence, partition_num: int = 1) -> ShardedDataSet:
    """reference DataSet.rdd (DataSet.scala:348): a host-sharded
    stand-in."""
    return ShardedDataSet(data, partition_num)


def sort_data(samples, ascending: bool = True):
    """Length-sorted batching helper (reference DataSet.sortData:372-400)."""
    return sorted(samples, key=lambda s: np.asarray(s.feature).shape[0],
                  reverse=not ascending)
