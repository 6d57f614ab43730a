"""Sample / MiniBatch / SampleToMiniBatch (counterpart of
``bigdl_tpu/dataset/sample.py``, a copy; reference dataset/Sample.scala:31,
MiniBatch.scala:33-120, Transformer.scala:309).

MiniBatch holds stacked numpy arrays; the optimizer turns each batch
into tensors on the model's device once (the infeed seam).  Padding
params reproduce the reference's variable-length NLP batching.
"""
from __future__ import annotations

from typing import Iterator, List, Optional, Sequence

import numpy as np

from ..utils.table import Table
from .transformer import Transformer


class Sample:
    """One feature/label pair (reference dataset/Sample.scala:31).
    Multi-tensor features/labels are lists."""

    def __init__(self, feature, label):
        self.feature = feature
        self.label = label

    def feature_shape(self):
        return np.asarray(self.feature).shape

    def label_shape(self):
        return np.asarray(self.label).shape

    def __repr__(self):
        return f"Sample(feature={self.feature_shape()}, label={self.label_shape()})"


class PaddingParam:
    """Padding config (reference dataset/MiniBatch.scala:103-120 PaddingParam).

    ``padding_value``: fill value; ``fixed_length``: pad every batch to
    this length (static shapes for XLA) instead of the batch max.
    """

    def __init__(self, padding_value: float = 0.0,
                 fixed_length: Optional[int] = None):
        self.padding_value = padding_value
        self.fixed_length = fixed_length


class MiniBatch:
    """Stacked batch (reference dataset/MiniBatch.scala:33)."""

    def __init__(self, inputs, targets):
        self.inputs = inputs
        self.targets = targets

    def size(self) -> int:
        first = self.inputs if not isinstance(self.inputs, (list, tuple)) \
            else self.inputs[0]
        return np.asarray(first).shape[0]

    def get_input(self):
        return self.inputs

    def get_target(self):
        return self.targets

    def slice(self, offset: int, length: int) -> "MiniBatch":
        """1-based slice along the batch dim (reference MiniBatch.slice)."""
        s = slice(offset - 1, offset - 1 + length)

        def cut(x):
            if isinstance(x, (list, tuple)):
                return type(x)(cut(v) for v in x)
            return x[s]

        return MiniBatch(cut(self.inputs), cut(self.targets))


def _pad_stack(arrs: Sequence[np.ndarray], param: Optional[PaddingParam]):
    arrs = [np.asarray(a) for a in arrs]
    shapes = {a.shape for a in arrs}
    if len(shapes) == 1 and (param is None or param.fixed_length is None):
        return np.stack(arrs)
    if param is None:
        param = PaddingParam()
    max_dims = [max(a.shape[i] for a in arrs) for i in range(arrs[0].ndim)]
    if param.fixed_length is not None:
        max_dims[0] = max(param.fixed_length, max_dims[0])
    out = np.full([len(arrs)] + max_dims, param.padding_value,
                  dtype=arrs[0].dtype)
    for i, a in enumerate(arrs):
        idx = (i,) + tuple(slice(0, s) for s in a.shape)
        out[idx] = a
    return out


class SampleToMiniBatch(Transformer):
    """Group Samples into MiniBatches (reference Transformer.scala:309),
    with optional feature/label padding (PaddingParam)."""

    def __init__(self, batch_size: int,
                 feature_padding_param: Optional[PaddingParam] = None,
                 label_padding_param: Optional[PaddingParam] = None,
                 partition_num: Optional[int] = None,
                 drop_last: bool = False):
        self.batch_size = batch_size
        self.feature_padding_param = feature_padding_param
        self.label_padding_param = label_padding_param
        self.drop_last = drop_last

    def apply(self, it: Iterator[Sample]) -> Iterator[MiniBatch]:
        buf: List[Sample] = []
        for s in it:
            buf.append(s)
            if len(buf) == self.batch_size:
                yield self.make(buf)
                buf = []
        if buf and not self.drop_last:
            yield self.make(buf)

    def make(self, buf: List[Sample]) -> MiniBatch:
        multi_f = isinstance(buf[0].feature, (list, tuple))
        multi_l = isinstance(buf[0].label, (list, tuple))
        if multi_f:
            feats = [
                _pad_stack([s.feature[i] for s in buf], self.feature_padding_param)
                for i in range(len(buf[0].feature))]
        else:
            feats = _pad_stack([s.feature for s in buf], self.feature_padding_param)
        if multi_l:
            labels = [
                _pad_stack([s.label[i] for s in buf], self.label_padding_param)
                for i in range(len(buf[0].label))]
        else:
            labels = _pad_stack([s.label for s in buf], self.label_padding_param)
        return MiniBatch(feats, labels)

    #: compat alias — ``make`` is public API now (the eval/predict
    #: loops build tail batches directly); old callers keep working
    _make = make


SampleToBatch = SampleToMiniBatch  # reference Transformer.scala:136 alias
