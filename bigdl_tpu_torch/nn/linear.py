"""Linear-algebra layers (counterpart of ``bigdl_tpu/nn/linear.py``;
reference Linear.scala:44, Bilinear, CMul, CAdd, Mul, Add, MulConstant,
AddConstant, MM, MV, Cosine, Euclidean, LookupTable).  Plain PyTorch,
as the JAX layers are plain ``jnp``; no Pallas kernel computes them."""
from __future__ import annotations

from typing import Optional

import torch

from ..device import DeviceLike
from .initialization import IN_OUT, ONE_D, RandomNormal, RandomUniform
from .module import AbstractModule, TensorModule


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = x W^T + b in the weight's dtype.  The JAX layer accumulates
    f32/bf16 products in f32 and casts the sum to the weight dtype;
    a float32 or bfloat16 matmul does the same here (cuBLAS computes
    bf16 GEMMs with an f32 accumulator)."""
    y = torch.matmul(x.to(weight.dtype), weight.t())
    return y + bias if bias is not None else y


class Linear(TensorModule):
    """y = x W^T + b (reference nn/Linear.scala:44)."""

    def __init__(self, input_size: int, output_size: int,
                 with_bias: bool = True, w_regularizer=None,
                 b_regularizer=None, *, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(device)
        self.input_size = input_size
        self.output_size = output_size
        self.with_bias = with_bias
        self.w_regularizer = w_regularizer
        self.b_regularizer = b_regularizer
        self._register_param("weight", RandomUniform().init(
            (output_size, input_size), IN_OUT, generator),
            RandomUniform(), IN_OUT)
        if with_bias:
            self._register_param("bias", RandomUniform().init(
                (output_size,), ONE_D, generator), RandomUniform(), ONE_D)

    def _compute(self, params, x):
        return linear(x, params["weight"],
                      params["bias"] if self.with_bias else None)


def lookup(ids: torch.Tensor, weight: torch.Tensor,
           padding_value: int = 0) -> torch.Tensor:
    """Rows of ``weight`` at 1-based ``ids`` (Torch convention).
    Out-of-range ids are clamped into [1, n_index], as the JAX layer's
    ``jnp.take`` of a clipped index does; ``padding_value`` rows are
    zeroed when it is non-zero."""
    idx = ids.to(torch.int64) - 1
    out = weight[idx.clamp(0, weight.shape[0] - 1)]
    if padding_value != 0:
        mask = ids.to(torch.int64) == int(padding_value)
        out = out.masked_fill(mask[..., None], 0.0)
    return out


def max_norm_renorm(weight: torch.Tensor, max_norm: float,
                    norm_type: float = 2.0) -> torch.Tensor:
    """Every row whose ``norm_type``-norm exceeds ``max_norm`` scaled to
    ``max_norm`` (over ``norm + 1e-7``), functionally: the JAX layer's
    renorm of the whole table in its forward
    (bigdl_tpu/nn/linear.py:274-277)."""
    norms = torch.linalg.vector_norm(weight, ord=norm_type, dim=1,
                                     keepdim=True)
    return torch.where(norms > max_norm,
                       weight * max_norm / (norms + 1e-7), weight)


class LookupTable(TensorModule):
    """Embedding over 1-based ids (reference nn/LookupTable.scala), with
    the max-norm renorm of rows above ``max_norm``.
    ``should_scale_grad_by_freq`` is kept for the reference's signature;
    the JAX layer does not read it either."""

    def __init__(self, n_index: int, n_output: int, padding_value: float = 0,
                 max_norm: float = float("inf"), norm_type: float = 2.0,
                 should_scale_grad_by_freq: bool = False, w_regularizer=None,
                 *, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(device)
        self.n_index, self.n_output = n_index, n_output
        self.padding_value = padding_value
        self.max_norm = max_norm
        self.norm_type = norm_type
        self.should_scale_grad_by_freq = should_scale_grad_by_freq
        self.w_regularizer = w_regularizer
        self._register_param("weight", RandomNormal(0, 1).init(
            (n_index, n_output), ONE_D, generator), RandomNormal(0, 1),
            ONE_D)

    def _compute(self, params, x):
        w = params["weight"]
        if self.max_norm != float("inf"):
            w = max_norm_renorm(w, self.max_norm, self.norm_type)
        return lookup(x, w, self.padding_value)


class MulConstant(TensorModule):
    """x times a fixed scalar (reference nn/MulConstant.scala).
    ``inplace`` is accepted for the reference's signature."""

    def __init__(self, constant_scalar: float, inplace: bool = False,
                 device: DeviceLike = None):
        super().__init__(device)
        self.constant_scalar = constant_scalar

    def _compute(self, params, x):
        return x * self.constant_scalar


def _param(init, shape, fmt, generator):
    return init.init(shape, fmt, generator), init, fmt


class Bilinear(AbstractModule):
    """y_k = x1^T W_k x2 + b_k over a Table(x1, x2) (reference
    nn/Bilinear.scala)."""

    def __init__(self, input_size1: int, input_size2: int, output_size: int,
                 bias_res: bool = True, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(device)
        self.input_size1, self.input_size2 = input_size1, input_size2
        self.output_size = output_size
        self.bias_res = bias_res
        self._register_param("weight", *_param(
            RandomUniform(), (output_size, input_size1, input_size2), ONE_D,
            generator))
        if bias_res:
            self._register_param("bias", *_param(
                RandomUniform(), (output_size,), ONE_D, generator))

    def _compute(self, params, inp):
        y = torch.einsum("ni,kij,nj->nk", inp[1], params["weight"], inp[2])
        return y + params["bias"] if self.bias_res else y


def _lead_ones(t: torch.Tensor, ndim: int) -> torch.Tensor:
    """t with leading singleton dims up to rank ``ndim``."""
    return t.reshape((1,) * (ndim - t.dim()) + tuple(t.shape)) \
        if t.dim() < ndim else t


class CMul(TensorModule):
    """Learned componentwise scale, broadcast by size (reference
    nn/CMul.scala)."""

    def __init__(self, size, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(device)
        self.size = tuple(size)
        self._register_param("weight", *_param(
            RandomUniform(), self.size, ONE_D, generator))

    def _compute(self, params, x):
        return x * _lead_ones(params["weight"], x.dim())


class CAdd(TensorModule):
    """Learned componentwise bias (reference nn/CAdd.scala)."""

    def __init__(self, size, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(device)
        self.size = tuple(size)
        self._register_param("bias", *_param(
            RandomUniform(), self.size, ONE_D, generator))

    def _compute(self, params, x):
        return x + _lead_ones(params["bias"], x.dim())


class Mul(TensorModule):
    """One learned scalar multiplier (reference nn/Mul.scala)."""

    def __init__(self, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(device)
        self._register_param("weight", *_param(
            RandomUniform(), (1,), ONE_D, generator))

    def _compute(self, params, x):
        return x * params["weight"][0]


class Add(TensorModule):
    """Learned bias vector added to the input (reference nn/Add.scala)."""

    def __init__(self, input_size: int, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(device)
        self.input_size = input_size
        self._register_param("bias", *_param(
            RandomUniform(), (input_size,), ONE_D, generator))

    def _compute(self, params, x):
        return x + params["bias"]


class AddConstant(TensorModule):
    """x plus a fixed scalar (reference nn/AddConstant.scala)."""

    def __init__(self, constant_scalar: float, inplace: bool = False,
                 device: DeviceLike = None):
        super().__init__(device)
        self.constant_scalar = constant_scalar

    def _compute(self, params, x):
        return x + self.constant_scalar


class MM(AbstractModule):
    """Matrix product of a Table(a, b), batched over leading dims
    (reference nn/MM.scala)."""

    def __init__(self, trans_a: bool = False, trans_b: bool = False,
                 device: DeviceLike = None):
        super().__init__(device)
        self.trans_a, self.trans_b = trans_a, trans_b

    def _compute(self, params, inp):
        a, b = inp[1], inp[2]
        if self.trans_a:
            a = a.transpose(-1, -2)
        if self.trans_b:
            b = b.transpose(-1, -2)
        return torch.matmul(a, b)


class MV(AbstractModule):
    """Matrix-vector product of Table(mat, vec) (reference nn/MV.scala)."""

    def __init__(self, trans: bool = False, device: DeviceLike = None):
        super().__init__(device)
        self.trans = trans

    def _compute(self, params, inp):
        m, v = inp[1], inp[2]
        if self.trans:
            m = m.transpose(-1, -2)
        return torch.matmul(m, v.unsqueeze(-1)).squeeze(-1)


class Cosine(TensorModule):
    """Cosine similarity against learned weight rows (reference
    nn/Cosine.scala)."""

    def __init__(self, input_size: int, output_size: int,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(device)
        self.input_size, self.output_size = input_size, output_size
        self._register_param("weight", *_param(
            RandomUniform(), (output_size, input_size), IN_OUT, generator))

    def _compute(self, params, x):
        w = params["weight"]
        xn = x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-12)
        wn = w / (torch.linalg.vector_norm(w, dim=-1, keepdim=True) + 1e-12)
        return torch.matmul(xn, wn.t())


class Euclidean(TensorModule):
    """||x - w_j|| for each column j of the (input, output) weight
    (reference nn/Euclidean.scala)."""

    def __init__(self, input_size: int, output_size: int,
                 fast_backward: bool = True, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(device)
        self.input_size, self.output_size = input_size, output_size
        self._register_param("weight", *_param(
            RandomUniform(), (input_size, output_size), ONE_D, generator))

    def _compute(self, params, x):
        diff = x[..., :, None] - params["weight"][None, :, :]
        return torch.sqrt((diff * diff).sum(dim=-2) + 1e-12)
