"""bigdl_tpu_torch.parallel — see the modules."""
from .moe import MoEFFN, aux_loss_term, collect_aux_paths

__all__ = ["MoEFFN", "aux_loss_term", "collect_aux_paths"]
