"""bigdl_tpu_torch.nn — the layers of the serving slice."""
from .attention import MultiHeadAttention, rope_rotate
from .linear import Linear, LookupTable
from .module import AbstractModule, Container, TensorModule
from .normalization import LayerNorm, RMSNorm
