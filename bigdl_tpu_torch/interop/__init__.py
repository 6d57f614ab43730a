"""bigdl_tpu_torch.interop — weights and state carried across from the
JAX package."""
from .jax_params import load_buffer_tree, load_param_tree, param_tree_numpy
