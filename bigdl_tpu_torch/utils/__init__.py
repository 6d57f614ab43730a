"""bigdl_tpu_torch.utils — the host RNG, Table and param-tree helpers."""
from .rng import RNG, RandomGenerator, set_global_seed
from .table import T, Table
from .tree import tree_leaves, tree_map
