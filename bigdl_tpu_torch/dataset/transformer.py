"""Transformer pipeline (counterpart of ``bigdl_tpu/dataset/transformer.py``,
a copy; reference dataset/Transformer.scala:44).

A ``Transformer[A, B]`` maps ``Iterator[A] → Iterator[B]``; stages chain
with ``->`` (here the ``>>`` operator or ``.and_then``) into a
``ChainedTransformer`` (Transformer.scala:86).  Cloning per worker
(reference cloneTransformer) maps to plain deepcopy — transformers stay
host-side; device work starts after batching.
"""
from __future__ import annotations

import copy
from typing import Any, Callable, Iterator


class Transformer:
    def apply(self, it: Iterator) -> Iterator:
        raise NotImplementedError

    def __call__(self, it: Iterator) -> Iterator:
        return self.apply(it)

    def and_then(self, other: "Transformer") -> "ChainedTransformer":
        return ChainedTransformer(self, other)

    # `a >> b` mirrors the reference's `a -> b`
    def __rshift__(self, other: "Transformer") -> "ChainedTransformer":
        return self.and_then(other)

    def clone_transformer(self) -> "Transformer":
        return copy.deepcopy(self)


class ChainedTransformer(Transformer):
    def __init__(self, first: Transformer, last: Transformer):
        self.first, self.last = first, last

    def apply(self, it):
        return self.last(self.first(it))


class FnTransformer(Transformer):
    """Lift a per-element function into a Transformer."""

    def __init__(self, fn: Callable[[Any], Any]):
        self.fn = fn

    def apply(self, it):
        return (self.fn(x) for x in it)


def transformer(fn: Callable[[Any], Any]) -> Transformer:
    return FnTransformer(fn)
