"""Torch-semantics Tensor facade over ``torch.Tensor`` (counterpart of
``bigdl_tpu/tensor/tensor.py``; reference tensor/Tensor.scala:36,
DenseTensor.scala, TensorMath.scala).

The compute path of the port is raw ``torch.Tensor`` trees through the
layers' ``apply_fn``; this class is the user-facing adapter that keeps
the reference API's semantics: 1-based ``select``/``narrow``/``index``,
``view``, ``transpose(d1, d2)``, and the TensorMath surface (add, mul,
addmm, addmv, max/min with a dim returning 1-based indices, sum, topk,
unfold, gather/scatter, fill/zero/copy, the bf16 round trip).

Unlike the JAX facade, whose arrays are immutable, this one has Torch's
storage semantics: ``select``, ``narrow``, ``transpose``, ``t``,
``view``, ``expand``, ``split`` and ``unfold`` return views, and the
in-place verbs (``add``, ``mul``, ``fill``, ``copy``, …) write through
them into the storage they share.

Every tensor lives on an explicit device: the card unless the caller
passes ``device="cpu"`` (a wrapped ``torch.Tensor`` keeps its own).
``rand``/``randn``/``bernoulli`` draw from a ``torch.Generator`` when one
is given, else from the host stream ``utils.rng.RNG()`` — the JAX
facade's, so one seed gives the same numbers there.
"""
from __future__ import annotations

import operator
from typing import Optional, Union

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..utils.rng import RNG

Number = Union[int, float]


def _raw(x):
    return x.data if isinstance(x, Tensor) else x


def _sizes(sizes):
    if len(sizes) == 1 and isinstance(sizes[0], (tuple, list, torch.Size)):
        return tuple(sizes[0])
    return tuple(sizes)


class Tensor:
    """Dense tensor with a Torch-style (1-based) API over torch."""

    def __init__(self, *sizes, data=None, dtype=None,
                 device: DeviceLike = None):
        if data is not None:
            data = _raw(data)
            if isinstance(data, torch.Tensor):
                t = data if device is None else data.to(resolve_device(device))
                self._t = t if dtype is None else t.to(dtype)
            else:   # a copy, as Torch's constructors copy their data
                self._t = torch.tensor(np.asarray(data), dtype=dtype,
                                       device=resolve_device(device))
        else:
            self._t = torch.zeros(_sizes(sizes), dtype=dtype or torch.float32,
                                  device=resolve_device(device))

    def _new(self, t: torch.Tensor) -> "Tensor":
        return Tensor(data=t)

    # -- raw access ------------------------------------------------------
    @property
    def data(self) -> torch.Tensor:
        return self._t

    @data.setter
    def data(self, value):
        self._t = torch.as_tensor(_raw(value), device=self._t.device)

    def numpy(self) -> np.ndarray:
        t = self._t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    @property
    def dtype(self):
        return self._t.dtype

    @property
    def device(self) -> torch.device:
        return self._t.device

    # -- shape surface (Tensor.scala:100-180) ----------------------------
    def dim(self) -> int:
        return self._t.dim()

    def n_dimension(self) -> int:
        return self._t.dim()

    def size(self, dim: Optional[int] = None):
        """1-based ``size(d)``; no argument: the whole shape."""
        if dim is None:
            return tuple(self._t.shape)
        return self._t.shape[dim - 1]

    @property
    def shape(self):
        return tuple(self._t.shape)

    def n_element(self) -> int:
        return self._t.numel()

    def is_empty(self) -> bool:
        return self._t.numel() == 0

    def is_scalar(self) -> bool:
        return self._t.dim() == 0

    def is_contiguous(self) -> bool:
        return self._t.is_contiguous()

    # -- shape ops (Tensor.scala:336-539) --------------------------------
    def view(self, *sizes) -> "Tensor":
        return self._new(self._t.view(_sizes(sizes)))

    def reshape(self, *sizes) -> "Tensor":
        return self._new(self._t.reshape(_sizes(sizes)))

    def resize(self, *sizes) -> "Tensor":
        """Resize in place to ``sizes``, keeping the leading elements and
        zero-filling any new ones."""
        sizes = _sizes(sizes)
        n = int(np.prod(sizes)) if sizes else 1
        flat = self._t.reshape(-1)
        if flat.numel() < n:
            flat = torch.cat([flat, flat.new_zeros(n - flat.numel())])
        self._t = flat[:n].reshape(sizes)
        return self

    def resize_as(self, other: "Tensor") -> "Tensor":
        return self.resize(*other.shape)

    def select(self, dim: int, index: int) -> "Tensor":
        """1-based select: the view without dimension ``dim`` at slice
        ``index``."""
        return self._new(self._t.select(dim - 1, index - 1))

    def narrow(self, dim: int, index: int, size: int) -> "Tensor":
        """1-based narrow: the view of ``size`` slices of ``dim`` from
        ``index``."""
        return self._new(self._t.narrow(dim - 1, index - 1, size))

    def t(self) -> "Tensor":
        return self.transpose(1, 2)

    def transpose(self, dim1: int, dim2: int) -> "Tensor":
        return self._new(self._t.transpose(dim1 - 1, dim2 - 1))

    def contiguous(self) -> "Tensor":
        return self._new(self._t.contiguous())

    def clone(self) -> "Tensor":
        return self._new(self._t.clone())

    def squeeze(self, dim: Optional[int] = None) -> "Tensor":
        if dim is None:
            self._t = self._t.squeeze()
        elif self._t.shape[dim - 1] == 1:
            self._t = self._t.squeeze(dim - 1)
        return self

    def unsqueeze(self, dim: int) -> "Tensor":
        self._t = self._t.unsqueeze(dim - 1)
        return self

    def expand(self, *sizes) -> "Tensor":
        return self._new(self._t.expand(_sizes(sizes)))

    def expand_as(self, other: "Tensor") -> "Tensor":
        return self.expand(*other.shape)

    def repeat_tensor(self, *sizes) -> "Tensor":
        return self._new(self._t.repeat(_sizes(sizes)))

    def unfold(self, dim: int, size: int, step: int) -> "Tensor":
        """Sliding windows of ``size`` every ``step`` along ``dim``, the
        window as a new last dim (a view)."""
        return self._new(self._t.unfold(dim - 1, size, step))

    def split(self, size: int, dim: int = 1):
        return [self._new(v) for v in self._t.split(size, dim - 1)]

    def index_select(self, dim: int, indices) -> "Tensor":
        idx = torch.as_tensor(_raw(indices), device=self._t.device)
        return self._new(self._t.index_select(
            dim - 1, idx.to(torch.int64).reshape(-1) - 1))

    def masked_select(self, mask) -> "Tensor":
        m = torch.as_tensor(_raw(mask), device=self._t.device)
        return self._new(torch.masked_select(self._t, m.to(torch.bool)))

    def gather(self, dim: int, index) -> "Tensor":
        """Torch gather with 1-based indices: the output has the index's
        shape."""
        idx = torch.as_tensor(_raw(index), device=self._t.device)
        return self._new(self._t.gather(dim - 1, idx.to(torch.int64) - 1))

    def scatter(self, dim: int, index, src) -> "Tensor":
        """In place: ``src``'s values at the 1-based ``index`` along
        ``dim``."""
        idx = torch.as_tensor(_raw(index), device=self._t.device)
        src = torch.as_tensor(_raw(src), device=self._t.device,
                              dtype=self._t.dtype)
        self._t.scatter_(dim - 1, idx.to(torch.int64) - 1, src)
        return self

    # -- element access (1-based) ----------------------------------------
    def value_at(self, *indices) -> float:
        return float(self._t[tuple(i - 1 for i in indices)])

    def set_value(self, *args) -> "Tensor":
        *indices, value = args
        self._t[tuple(i - 1 for i in indices)] = value
        return self

    def __getitem__(self, key):
        """Python's 0-based indexing of the raw tensor."""
        return self._new(self._t[key])

    # -- fill / init -----------------------------------------------------
    def fill(self, value: Number) -> "Tensor":
        self._t.fill_(value)
        return self

    def zero(self) -> "Tensor":
        self._t.zero_()
        return self

    def _host_draw(self, values) -> "Tensor":
        self._t.copy_(torch.as_tensor(np.asarray(values)))
        return self

    def rand(self, a=0.0, b=1.0,
             generator: Optional[torch.Generator] = None) -> "Tensor":
        if generator is None:
            return self._host_draw(RNG().uniform(a, b, self.shape))
        self._t.uniform_(a, b, generator=generator)
        return self

    def randn(self, mean=0.0, stdv=1.0,
              generator: Optional[torch.Generator] = None) -> "Tensor":
        if generator is None:
            return self._host_draw(RNG().normal(mean, stdv, self.shape))
        self._t.normal_(mean, stdv, generator=generator)
        return self

    def bernoulli(self, p: float,
                  generator: Optional[torch.Generator] = None) -> "Tensor":
        if generator is None:
            return self._host_draw(RNG().bernoulli(p, self.shape))
        self._t.bernoulli_(p, generator=generator)
        return self

    def copy(self, other) -> "Tensor":
        src = torch.as_tensor(_raw(other))
        self._t.copy_(src.reshape(self._t.shape))
        return self

    def apply1(self, fn) -> "Tensor":
        """Elementwise host map (reference DenseTensorApply)."""
        return self._host_draw(np.vectorize(fn)(self.numpy()).astype(
            self.numpy().dtype))

    # -- arithmetic (TensorMath.scala surface) ---------------------------
    def _binop(self, other, op) -> "Tensor":
        return self._new(op(self._t, _raw(other)))

    def __add__(self, o):
        return self._binop(o, operator.add)

    __radd__ = __add__

    def __sub__(self, o):
        return self._binop(o, operator.sub)

    def __rsub__(self, o):
        return self._new(_raw(o) - self._t)

    def __mul__(self, o):
        return self._binop(o, operator.mul)

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binop(o, operator.truediv)

    def __neg__(self):
        return self._new(-self._t)

    def add(self, *args) -> "Tensor":
        """In place: ``add(value)``, ``add(other)`` or ``add(alpha,
        other)``."""
        if len(args) == 1:
            self._t.add_(_raw(args[0]))
        else:
            alpha, other = args
            self._t.add_(alpha * _raw(other))
        return self

    def sub(self, *args) -> "Tensor":
        if len(args) == 1:
            self._t.sub_(_raw(args[0]))
        else:
            alpha, other = args
            self._t.sub_(alpha * _raw(other))
        return self

    def mul(self, other) -> "Tensor":
        self._t.mul_(_raw(other))
        return self

    def div(self, other) -> "Tensor":
        self._t.div_(_raw(other))
        return self

    def cmul(self, other) -> "Tensor":
        return self.mul(other)

    def cdiv(self, other) -> "Tensor":
        return self.div(other)

    def cmax(self, other) -> "Tensor":
        torch.maximum(self._t, torch.as_tensor(_raw(other)).to(self._t),
                      out=self._t)
        return self

    def cmin(self, other) -> "Tensor":
        torch.minimum(self._t, torch.as_tensor(_raw(other)).to(self._t),
                      out=self._t)
        return self

    def pow(self, n: Number) -> "Tensor":
        self._t.pow_(n)
        return self

    def sqrt(self) -> "Tensor":
        self._t.sqrt_()
        return self

    def square(self) -> "Tensor":
        self._t.square_()
        return self

    def log(self) -> "Tensor":
        self._t.log_()
        return self

    def log1p(self) -> "Tensor":
        self._t.log1p_()
        return self

    def exp(self) -> "Tensor":
        self._t.exp_()
        return self

    def abs(self) -> "Tensor":
        self._t.abs_()
        return self

    def tanh(self) -> "Tensor":
        self._t.tanh_()
        return self

    def sigmoid(self) -> "Tensor":
        self._t.sigmoid_()
        return self

    def floor(self) -> "Tensor":
        self._t.floor_()
        return self

    def ceil(self) -> "Tensor":
        self._t.ceil_()
        return self

    def clamp(self, min_v, max_v) -> "Tensor":
        self._t.clamp_(min_v, max_v)
        return self

    def sign(self) -> "Tensor":
        self._t.sign_()
        return self

    def negative(self) -> "Tensor":
        self._t.neg_()
        return self

    def addcmul(self, value, t1, t2) -> "Tensor":
        self._t.addcmul_(_raw(t1), _raw(t2), value=value)
        return self

    def addcdiv(self, value, t1, t2) -> "Tensor":
        self._t.addcdiv_(_raw(t1), _raw(t2), value=value)
        return self

    def axpy(self, alpha, x) -> "Tensor":
        """BLAS axpy: self += alpha * x (reference TensorNumeric
        vsaxpy)."""
        self._t.add_(_raw(x), alpha=alpha)
        return self

    def scal(self, alpha) -> "Tensor":
        self._t.mul_(alpha)
        return self

    # -- BLAS level (DenseTensorMath / DenseTensorBLAS) ------------------
    def dot(self, other) -> float:
        return float(torch.dot(self._t.reshape(-1),
                               _raw(other).reshape(-1)))

    def addmm(self, *args) -> "Tensor":
        """``addmm(beta, M, alpha, mat1, mat2)`` or ``addmm(mat1, mat2)``
        (reference DenseTensorMath.addmm:443): self = beta M + alpha
        mat1 mat2."""
        if len(args) == 2:
            beta, m, alpha, m1, m2 = 1.0, self, 1.0, *args
        elif len(args) == 5:
            beta, m, alpha, m1, m2 = args
        else:
            raise ValueError("addmm expects 2 or 5 args")
        self._t.copy_(torch.addmm(_raw(m), _raw(m1), _raw(m2), beta=beta,
                                  alpha=alpha))
        return self

    def mm(self, m1, m2) -> "Tensor":
        self._t = torch.matmul(_raw(m1), _raw(m2))
        return self

    def addmv(self, beta, alpha, mat, vec) -> "Tensor":
        self._t.copy_(torch.addmv(self._t, _raw(mat), _raw(vec), beta=beta,
                                  alpha=alpha))
        return self

    def mv(self, mat, vec) -> "Tensor":
        self._t = torch.mv(_raw(mat), _raw(vec))
        return self

    def addr(self, *args) -> "Tensor":
        """Outer-product update ``addr(alpha, vec1, vec2)`` or
        ``addr(vec1, vec2)``."""
        alpha, v1, v2 = (1.0, *args) if len(args) == 2 else args
        self._t.add_(torch.outer(_raw(v1), _raw(v2)), alpha=alpha)
        return self

    def baddbmm(self, beta, alpha, b1, b2) -> "Tensor":
        self._t.copy_(torch.baddbmm(self._t, _raw(b1), _raw(b2), beta=beta,
                                    alpha=alpha))
        return self

    def bmm(self, b1, b2) -> "Tensor":
        self._t = torch.bmm(_raw(b1), _raw(b2))
        return self

    # -- reductions ------------------------------------------------------
    def sum(self, dim: Optional[int] = None):
        if dim is None:
            return float(self._t.sum())
        return self._new(self._t.sum(dim=dim - 1, keepdim=True))

    def mean(self, dim: Optional[int] = None):
        if dim is None:
            return float(self._t.mean())
        return self._new(self._t.mean(dim=dim - 1, keepdim=True))

    def std(self) -> float:
        return float(self._t.std())

    def _arg(self, fn, dim):
        vals, idx = fn(self._t, dim=dim - 1, keepdim=True)
        return self._new(vals), self._new((idx + 1).to(torch.float32))

    def max(self, dim: Optional[int] = None):
        """No argument: the largest value.  With a dim: (values,
        1-based indices)."""
        if dim is None:
            return float(self._t.max())
        return self._arg(torch.max, dim)

    def min(self, dim: Optional[int] = None):
        if dim is None:
            return float(self._t.min())
        return self._arg(torch.min, dim)

    def topk(self, k: int, dim: Optional[int] = None, increase: bool = True):
        """(values, 1-based indices).  ``increase`` (the default): the k
        smallest, ascending — the Torch topk semantics the reference
        follows (TensorMath.topk)."""
        d = (dim - 1) if dim is not None else self._t.dim() - 1
        vals, idx = torch.topk(self._t, k, dim=d, largest=not increase,
                               sorted=True)
        return self._new(vals), self._new((idx + 1).to(torch.float32))

    def norm(self, p: Number = 2) -> float:
        if p == 1:
            return float(self._t.abs().sum())
        return float((self._t.abs() ** p).sum() ** (1.0 / p))

    def dist(self, other, p: Number = 2) -> float:
        return (self - other).norm(p)

    def prod(self) -> float:
        return float(self._t.prod())

    def argmax_1based(self, dim: int) -> "Tensor":
        return self._new((self._t.argmax(dim=dim - 1) + 1).to(torch.float32))

    # -- comparisons -----------------------------------------------------
    def _cmp(self, other, op) -> "Tensor":
        return self._new(op(self._t, _raw(other)).to(self._t.dtype))

    def eq_tensor(self, other) -> "Tensor":
        return self._cmp(other, operator.eq)

    def gt(self, other) -> "Tensor":
        return self._cmp(other, operator.gt)

    def lt(self, other) -> "Tensor":
        return self._cmp(other, operator.lt)

    def ge(self, other) -> "Tensor":
        return self._cmp(other, operator.ge)

    def le(self, other) -> "Tensor":
        return self._cmp(other, operator.le)

    def almost_equal(self, other, tolerance: float = 1e-5) -> bool:
        o = _raw(other)
        return bool(torch.allclose(self._t.float(), o.float(),
                                   atol=tolerance, rtol=tolerance))

    def __eq__(self, other):
        if isinstance(other, Tensor):
            return (self.shape == other.shape
                    and bool(torch.equal(self._t, other._t)))
        return NotImplemented

    def __hash__(self):
        return id(self)

    def __repr__(self):
        return (f"Tensor(shape={self.shape}, dtype={self._t.dtype}, "
                f"device={self._t.device})\n{self.numpy()}")

    # -- dtype -----------------------------------------------------------
    def to_bf16(self) -> "Tensor":
        return self._new(self._t.to(torch.bfloat16))

    def to_f32(self) -> "Tensor":
        return self._new(self._t.to(torch.float32))

    def astype(self, dtype) -> "Tensor":
        return self._new(self._t.to(dtype))


# ---------------------------------------------------------------------------
# Factory surface (object Tensor, Tensor.scala:685-986)
# ---------------------------------------------------------------------------
def tensor(data, dtype=torch.float32, device: DeviceLike = None) -> Tensor:
    return Tensor(data=data, dtype=dtype, device=device)


def zeros(*sizes, dtype=torch.float32, device: DeviceLike = None) -> Tensor:
    return Tensor(*sizes, dtype=dtype, device=device)


def ones(*sizes, dtype=torch.float32, device: DeviceLike = None) -> Tensor:
    return Tensor(*sizes, dtype=dtype, device=device).fill(1)


def rand(*sizes, dtype=torch.float32, device: DeviceLike = None,
         generator: Optional[torch.Generator] = None) -> Tensor:
    return Tensor(*sizes, dtype=dtype, device=device).rand(
        generator=generator)


def randn(*sizes, dtype=torch.float32, device: DeviceLike = None,
          generator: Optional[torch.Generator] = None) -> Tensor:
    return Tensor(*sizes, dtype=dtype, device=device).randn(
        generator=generator)


def arange(start: Number, end: Number, step: Number = 1,
           device: DeviceLike = None) -> Tensor:
    """Inclusive range like Torch's ``torch.range`` (Tensor.scala range)."""
    n = int(np.floor((end - start) / step)) + 1
    dev = resolve_device(device)
    return Tensor(data=start + torch.arange(n, dtype=torch.float32,
                                            device=dev) * step)


def range_(start, end, step=1, device: DeviceLike = None) -> Tensor:
    return arange(start, end, step, device)
