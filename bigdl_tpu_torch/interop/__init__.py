"""bigdl_tpu_torch.interop — weights carried across from the JAX package."""
from .jax_params import load_param_tree, param_tree_numpy
