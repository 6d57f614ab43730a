"""Column/RowParallelLinear (counterpart of
``bigdl_tpu/parallel/tensor_parallel.py``) in their unbound form only.

``axis_name=None`` — ``TransformerBlock``'s default — is a plain
single-device linear.  A bound model axis (the row-parallel psum) comes
with the distributed slice and raises here.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..device import DeviceLike
from ..nn.linear import Linear


def _unbound(cls, axis_name):
    if axis_name is not None:
        raise NotImplementedError(
            f"{cls}(axis_name={axis_name!r}): tensor parallelism over a "
            f"mesh axis comes with the distributed slice; pass "
            f"axis_name=None")


class ColumnParallelLinear(Linear):
    """y = x W^T + b; unsharded, exactly ``Linear``."""

    def __init__(self, input_size: int, output_size: int,
                 with_bias: bool = True, axis_name: Optional[str] = None,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        _unbound("ColumnParallelLinear", axis_name)
        self.axis_name = axis_name
        super().__init__(input_size, output_size, with_bias,
                         device=device, generator=generator)


class RowParallelLinear(Linear):
    """y = x W^T + b; unsharded.  Unlike ``Linear`` the JAX layer does
    not cast x to the weight dtype (``jnp.dot`` promotes)."""

    def __init__(self, input_size: int, output_size: int,
                 with_bias: bool = True, axis_name: Optional[str] = None,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        _unbound("RowParallelLinear", axis_name)
        self.axis_name = axis_name
        super().__init__(input_size, output_size, with_bias,
                         device=device, generator=generator)

    def _compute(self, params, x):
        w = params["weight"]
        dt = torch.promote_types(x.dtype, w.dtype)
        y = torch.matmul(x.to(dt), w.to(dt).t())
        return y + params["bias"] if self.with_bias else y
