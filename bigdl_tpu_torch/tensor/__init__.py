"""bigdl_tpu_torch.tensor — the 1-based Torch-style Tensor facade."""
from .tensor import Tensor, arange, ones, rand, randn, range_, tensor, zeros
