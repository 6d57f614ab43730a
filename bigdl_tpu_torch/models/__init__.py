"""bigdl_tpu_torch.models — the TransformerLM and its generator."""
from .generate import cached_generate, make_generate
from .transformer import TransformerBlock, TransformerLM
