"""bigdl_tpu_torch.parallel — see the modules."""
from .all_reduce import AllReduceParameter, padded_size, shard_batch
from .moe import MoEFFN, aux_loss_term, collect_aux_paths

__all__ = ["AllReduceParameter", "MoEFFN", "aux_loss_term",
           "collect_aux_paths", "padded_size", "shard_batch"]
