"""bigdl_tpu_torch.nn — the layers and criterions of the serving,
training and conv slices."""
from .activations import LogSoftMax, ReLU, Tanh
from .attention import MultiHeadAttention, rope_rotate
from .containers import Concat, ConcatTable, Identity, Sequential
from .conv import SpatialConvolution
from .criterion import (AbstractCriterion, ClassNLLCriterion,
                        CrossEntropyCriterion, TimeDistributedCriterion)
from .linear import Linear, LookupTable, MulConstant
from .module import AbstractModule, Container, TensorModule
from .normalization import (BatchNormalization, LayerNorm, RMSNorm,
                            SpatialBatchNormalization)
from .pooling import SpatialAveragePooling, SpatialMaxPooling
from .shape_ops import Reshape, View
from .table_ops import CAddTable
