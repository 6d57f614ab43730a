"""TF-compat ops (counterpart of ``bigdl_tpu/nn/tf_ops.py``; reference
nn/tf/Const.scala, Fill.scala, Shape.scala, SplitAndSelect.scala,
StrideSlice.scala) and ``Nms`` (nn/Nms.scala).

They exist so TensorFlow graphs map onto framework layers; plain
PyTorch here, as they are plain ``jnp`` there.  Integer outputs are
int32 and a Python float fills in float32, as in the JAX package (no
x64).  ``Nms`` is a host-side numpy helper, a copy of the JAX
package's.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from .module import AbstractModule, TensorModule


def _dtype_of(value) -> torch.dtype:
    """The dtype ``jnp.asarray(value)`` takes with x64 off."""
    kind = np.asarray(value).dtype.kind
    return {"b": torch.bool, "i": torch.int32,
            "u": torch.int32}.get(kind, torch.float32)


class Const(AbstractModule):
    """Emit a constant whatever the input (reference nn/tf/Const.scala),
    on the module's device."""

    def __init__(self, value, device=None):
        super().__init__(device)
        self.value = torch.as_tensor(np.asarray(value),
                                     dtype=_dtype_of(value)).to(self.device)

    def _compute(self, params, inp):
        return self.value.to(self.device)


class Fill(TensorModule):
    """The input holds a shape; the output is that shape filled with
    ``value``, in the value's dtype (reference nn/tf/Fill.scala)."""

    def __init__(self, value, device=None):
        super().__init__(device)
        self.value = value

    def _compute(self, params, x):
        shape = tuple(int(v) for v in x.reshape(-1).tolist())
        return torch.full(shape, self.value, dtype=_dtype_of(self.value),
                          device=x.device)


class Shape(TensorModule):
    """The input's shape as a 1-D int32 tensor (reference
    nn/tf/Shape.scala)."""

    def _compute(self, params, x):
        return torch.tensor(tuple(x.shape), dtype=torch.int32,
                            device=x.device)


def _dim(d: int, ndim: int) -> int:
    """A 1-based dim (or a negative one from the end) as a 0-based one."""
    return d - 1 if d > 0 else ndim + d


class SplitAndSelect(TensorModule):
    """Split ``dimension`` (1-based) into ``num_split`` equal chunks and
    emit chunk ``index`` (1-based) (reference
    nn/tf/SplitAndSelect.scala)."""

    def __init__(self, dimension: int, index: int, num_split: int,
                 device=None):
        super().__init__(device)
        self.dimension, self.index, self.num_split = (dimension, index,
                                                      num_split)

    def _compute(self, params, x):
        d = _dim(self.dimension, x.dim())
        size = x.shape[d]
        assert size % self.num_split == 0, (
            f"num_split must evenly divide dim size {size}")
        length = size // self.num_split
        return x.narrow(d, (self.index - 1) * length, length)


class StrideSlice(TensorModule):
    """Chained 1-based narrows: specs of (dim, startIdx, endIdx, stride),
    endIdx exclusive, stride 1 only (reference nn/tf/StrideSlice.scala)."""

    def __init__(self, slice_specs: Sequence[Tuple[int, int, int, int]],
                 device=None):
        super().__init__(device)
        assert all(s[3] == 1 for s in slice_specs), "only stride 1 supported"
        self.slice_specs = list(slice_specs)

    def _compute(self, params, x):
        for dim, start, end, _ in self.slice_specs:
            x = x.narrow(_dim(dim, x.dim()), start - 1, end - start)
        return x


class Nms:
    """Greedy non-maximum suppression for detection (reference
    nn/Nms.scala:26): sort by score descending, keep the top box, drop
    the boxes whose IoU with it exceeds ``thresh``, repeat.  Box areas
    use the reference's +1 pixel convention ((x2 − x1 + 1)(y2 − y1 + 1));
    the kept indices are 1-based.  A host-side helper, not a module, as
    in the reference: the greedy data-dependent loop stays on the CPU,
    where post-RPN candidate counts are small."""

    def nms(self, scores, boxes, thresh: float, indices) -> int:
        if isinstance(scores, torch.Tensor):
            scores = scores.detach().cpu().numpy()
        if isinstance(boxes, torch.Tensor):
            boxes = boxes.detach().cpu().numpy()
        scores = np.asarray(scores, np.float32).reshape(-1)
        boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
        n = scores.shape[0]
        if n == 0:
            return 0
        assert len(indices) >= n and boxes.shape[1] == 4
        x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
        areas = (x2 - x1 + 1) * (y2 - y1 + 1)
        order = np.argsort(-scores, kind="stable")
        suppressed = np.zeros(n, bool)
        count = 0
        for i in range(n):
            cur = order[i]
            if suppressed[cur]:
                continue
            indices[count] = cur + 1
            count += 1
            rest = order[i + 1:]
            rest = rest[~suppressed[rest]]
            if rest.size == 0:
                continue
            w = (np.minimum(x2[cur], x2[rest]) - np.maximum(x1[cur], x1[rest])
                 + 1)
            h = (np.minimum(y2[cur], y2[rest]) - np.maximum(y1[cur], y1[rest])
                 + 1)
            inter = np.clip(w, 0, None) * np.clip(h, 0, None)
            inter = np.where((w < 0) | (h < 0), 0.0, inter)
            iou = inter / (areas[cur] + areas[rest] - inter)
            suppressed[rest[iou > thresh]] = True
        return count
