"""bigdl_tpu_torch.nn — the layers and criterions of the serving and
training slices."""
from .attention import MultiHeadAttention, rope_rotate
from .criterion import (AbstractCriterion, ClassNLLCriterion,
                        CrossEntropyCriterion, TimeDistributedCriterion)
from .linear import Linear, LookupTable
from .module import AbstractModule, Container, TensorModule
from .normalization import LayerNorm, RMSNorm
