"""TransformerLM (counterpart of ``bigdl_tpu/models/transformer.py``).

Ported: ``ln|rms`` norms, ``gelu|swiglu`` MLPs, learned positions or
rope, GQA, the ``dense``, ``flash``, ``block`` and ``blocksparse``
attention strategies (``blocksparse={...}`` passes ``pattern``,
``window``, ``globals``, ``stride`` and ``block`` to each block's mask
builder), residual dropout and ``remat``.  MoE comes with a later slice
and raises.

``remat=True`` recomputes each block's forward in the backward pass
(the JAX ``jax.checkpoint`` of each block, HBM for FLOPs):
``torch.utils.checkpoint`` without re-entry, which
``torch.autograd.grad`` (the training step's) needs.  A block's dropout
draws from the forward's generator (``nn/module.py``), which the
checkpoint's RNG preservation does not cover (it saves the default CPU
and CUDA generators only), so the block saves that generator's state
before its forward and its recompute draws from that state again, under
the same scope (the backward may run on another thread): the
recomputed masks are the forward's.  Where no gradient is taken (under
``torch.no_grad()``, or with no parameter requiring one) a block runs
once, as without remat.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import nn
from ..device import DeviceLike
from ..nn.dropout import dropout
from ..nn.module import Container, current_generator, rng_scope
from ..parallel.tensor_parallel import ColumnParallelLinear, RowParallelLinear
from ..utils.tree import tree_leaves


def gelu(x):
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def _norm_factory(norm: str, norm_eps, device):
    """One policy for both the blocks and the final norm: the norm
    class and its eps default (rms 1e-6 / ln 1e-5, HF's conventions)."""
    eps = norm_eps if norm_eps is not None else (
        1e-6 if norm == "rms" else 1e-5)
    if norm == "rms":
        return lambda d: nn.RMSNorm(d, eps=eps, device=device)
    return lambda d: nn.LayerNorm(d, eps=eps, device=device)


def _unported(moe_experts: int):
    if moe_experts:
        raise NotImplementedError("moe_experts > 0 is not ported yet")


def _remat_block(block, params, h):
    """``block.apply_fn(params, h)`` with its activations recomputed in
    the backward pass; the recompute draws the forward's dropout masks
    (see the module docstring)."""
    gen = (current_generator(h.device)
           if block.dropout > 0.0 and block.training else None)
    start = gen.get_state() if gen is not None else None
    calls = []

    def run(h_):
        if gen is None:
            return block.apply_fn(params, h_)
        if not calls:                       # the forward
            calls.append(True)
            return block.apply_fn(params, h_)
        after = gen.get_state()             # the recompute
        gen.set_state(start)
        try:
            with rng_scope(gen):
                return block.apply_fn(params, h_)
        finally:
            gen.set_state(after)

    return checkpoint(run, h, use_reentrant=False, preserve_rng_state=False)


class TransformerBlock(Container):
    """Pre-norm residual block: x + drop(MHA(LN(x))); x + drop(MLP(LN(x))).

    ``dropout`` > 0 zeroes each element of the attention branch and of
    the MLP branch before its residual add with that probability (the
    kept ones scaled by 1 / (1 - dropout)), in training only, as the JAX
    block does (bigdl_tpu/models/transformer.py:133-176).  The masks
    come from the forward's generator (``nn/module.py``), attention's
    first, block by block."""

    def __init__(self, embed_dim: int, num_heads: int, mlp_dim: int,
                 causal: bool = True, seq_strategy: str = "dense",
                 model_axis: Optional[str] = None, moe_experts: int = 0,
                 dropout: float = 0.0, norm: str = "ln", mlp: str = "gelu",
                 num_kv_heads: Optional[int] = None, rope: bool = False,
                 rope_theta: float = 10000.0,
                 attn_bias: Optional[bool] = None,
                 mlp_bias: Optional[bool] = None,
                 norm_eps: Optional[float] = None,
                 blocksparse: Optional[dict] = None,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        if norm not in ("ln", "rms"):
            raise ValueError(f"norm {norm!r} not in ('ln', 'rms')")
        if mlp not in ("gelu", "swiglu"):
            raise ValueError(f"mlp {mlp!r} not in ('gelu', 'swiglu')")
        _unported(moe_experts)
        Norm = _norm_factory(norm, norm_eps, device)
        # llama convention: bias-free attention (and swiglu) projections
        with_bias = (attn_bias if attn_bias is not None
                     else not (rope or norm == "rms"))
        bs = dict(blocksparse or {})
        mods = [
            Norm(embed_dim),
            nn.MultiHeadAttention(embed_dim, num_heads, causal=causal,
                                  seq_strategy=seq_strategy,
                                  num_kv_heads=num_kv_heads, rope=rope,
                                  rope_theta=rope_theta,
                                  with_bias=with_bias,
                                  sparse_pattern=bs.get("pattern", "sliding"),
                                  sparse_window=bs.get("window", 2),
                                  sparse_globals=bs.get("globals", 1),
                                  sparse_stride=bs.get("stride", 4),
                                  sparse_block=bs.get("block"),
                                  device=device, generator=generator),
            Norm(embed_dim),
        ]
        if mlp == "swiglu":
            mb = mlp_bias if mlp_bias is not None else with_bias
            mods += [ColumnParallelLinear(embed_dim, mlp_dim, with_bias=mb,
                                          axis_name=model_axis,
                                          device=device, generator=generator),
                     ColumnParallelLinear(embed_dim, mlp_dim, with_bias=mb,
                                          axis_name=model_axis,
                                          device=device, generator=generator),
                     RowParallelLinear(mlp_dim, embed_dim, with_bias=mb,
                                       axis_name=model_axis,
                                       device=device, generator=generator)]
        else:
            mods += [ColumnParallelLinear(embed_dim, mlp_dim,
                                          axis_name=model_axis,
                                          device=device, generator=generator),
                     RowParallelLinear(mlp_dim, embed_dim,
                                       axis_name=model_axis,
                                       device=device, generator=generator)]
        super().__init__(*mods, device=device)
        self.mlp_kind = mlp
        self.dropout = float(dropout)

    def _drop(self, v):
        if self.dropout <= 0.0 or not self.training:
            return v
        return dropout(v, self.dropout, current_generator(v.device))

    def mlp(self, params, h):
        """The MLP on the ln2 output (gelu or swiglu), no residual."""
        if self.mlp_kind == "swiglu":
            g = self[3].apply_fn(params["3"], h)
            u = self[4].apply_fn(params["4"], h)
            return self[5].apply_fn(params["5"], F.silu(g) * u)
        mid = self[3].apply_fn(params["3"], h)
        return self[4].apply_fn(params["4"], gelu(mid))

    def apply_fn(self, params, x):
        h = self[0].apply_fn(params["0"], x)
        x = x + self._drop(self[1].apply_fn(params["1"], h))
        h = self[2].apply_fn(params["2"], x)
        return x + self._drop(self.mlp(params, h))


class TransformerLM(Container):
    """Decoder-only causal LM over 1-based token ids [batch, seq].

    Output is log-probs [batch, seq, vocab] (``output="logits"`` skips
    the final log_softmax).  Children: ``"0"`` the LookupTable, then the
    blocks, the final norm and the vocab head; ``"pos"`` the learned
    positional table (absent under rope)."""

    def __init__(self, vocab_size: int, embed_dim: int = 256,
                 num_heads: int = 8, mlp_dim: Optional[int] = None,
                 num_layers: int = 4, max_len: int = 2048,
                 causal: bool = True, seq_strategy: str = "dense",
                 model_axis: Optional[str] = None, remat: bool = False,
                 output: str = "log_probs", moe_experts: int = 0,
                 dropout: float = 0.0, norm: str = "ln", mlp: str = "gelu",
                 num_kv_heads: Optional[int] = None, rope: bool = False,
                 rope_theta: float = 10000.0,
                 attn_bias: Optional[bool] = None,
                 mlp_bias: Optional[bool] = None, head_bias: bool = True,
                 norm_eps: Optional[float] = None,
                 blocksparse: Optional[dict] = None,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        if output not in ("log_probs", "logits"):
            raise ValueError(f"output {output!r} not in (log_probs, logits)")
        _unported(moe_experts)
        mlp_dim = mlp_dim or 4 * embed_dim
        blocks = [TransformerBlock(embed_dim, num_heads, mlp_dim, causal,
                                   seq_strategy, model_axis,
                                   dropout=dropout, norm=norm,
                                   mlp=mlp, num_kv_heads=num_kv_heads,
                                   rope=rope, rope_theta=rope_theta,
                                   attn_bias=attn_bias, mlp_bias=mlp_bias,
                                   norm_eps=norm_eps,
                                   blocksparse=blocksparse, device=device,
                                   generator=generator)
                  for _ in range(num_layers)]
        Norm = _norm_factory(norm, norm_eps, device)
        super().__init__(
            nn.LookupTable(vocab_size, embed_dim, device=device,
                           generator=generator),
            *blocks,
            Norm(embed_dim),
            nn.Linear(embed_dim, vocab_size, with_bias=head_bias,
                      device=device, generator=generator),
            device=device)
        self._output_mode = output
        self.vocab_size = vocab_size
        self.embed_dim = embed_dim
        self.max_len = max_len
        self.seq_strategy = seq_strategy
        self.remat = bool(remat)
        # rope models carry no learned positional table — positions
        # live in the per-layer q/k rotation
        self.use_rope = bool(rope)
        if not self.use_rope:
            self._register_param("pos", 0.02 * torch.empty(
                max_len, embed_dim).normal_(
                    generator=generator if generator is not None
                    else torch.default_generator))

    @property
    def blocks(self):
        return [self[i] for i in range(1, len(self) - 2)]

    def apply_fn(self, params, x):
        h = self[0].apply_fn(params["0"], x)
        if not self.use_rope:
            T = h.shape[1]
            if T > self.max_len:
                raise ValueError(f"sequence length {T} exceeds "
                                 f"max_len {self.max_len}")
            h = h + params["pos"][:T]
        remat = self.remat and torch.is_grad_enabled() and any(
            getattr(t, "requires_grad", False) for t in tree_leaves(params))
        for i in range(1, len(self)):
            m = self[i]
            if remat and isinstance(m, TransformerBlock):
                h = _remat_block(m, params[str(i)], h)
            else:
                h = m.apply_fn(params[str(i)], h)
        if self._output_mode == "logits":
            return h
        return torch.log_softmax(h, dim=-1)

    def generate(self, prompt_ids, max_new: int, generator=None,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, compute_dtype=None,
                 eos_id=None, pad_id=None):
        """Autoregressive decode with a KV cache (models/generate.py);
        the generator is cached per (max_len, compute_dtype)."""
        from .generate import cached_generate

        return cached_generate(self, compute_dtype)(
            self.param_tree(), prompt_ids, max_new, generator=generator,
            temperature=temperature, top_k=top_k, top_p=top_p,
            eos_id=eos_id, pad_id=pad_id)
