"""Autoregressive generation for TransformerLM — KV-cache decode
(counterpart of ``bigdl_tpu/models/generate.py``).

Same structure as the JAX module: a batched prefill (the whole prompt
in one causal pass through kernel K1, filling the per-layer KV caches
``[B, Hkv, T_max, Dh]``), then one token per step against the caches.
The JAX package compiles the step loop into one ``lax.scan``; here it
is an eager Python loop, and the caches are written in place.

Ported: greedy and temperature / top-k / top-p sampling on an explicit
``torch.Generator``, eos/pad, GQA and rope.  Beam search, the int8 KV
cache (``kv_dtype``) and the paged machinery come with later slices.

Token ids are 1-based: a greedy step emits ``argmax + 1``.  Finished
rows emit ``pad``; ``eos_id=None`` becomes the sentinel 0, which no
1-based id matches.
"""
from __future__ import annotations

import math
import weakref
from typing import Optional

import numpy as np
import torch

from ..nn.attention import proj, rope_rotate
from ..ops.flash_attention import flash_attention

# generators per model instance (weak: dies with the model), keyed by
# build config — avoids rebuilding the machinery per request
_GEN_CACHE = weakref.WeakKeyDictionary()


def _check_model(model):
    from .transformer import TransformerLM

    if not isinstance(model, TransformerLM):
        raise TypeError(
            f"generation supports TransformerLM (got "
            f"{type(model).__name__})")
    return 1, len(model) - 3


def _check_len(model, max_len):
    """The decode window may not outgrow the positional table."""
    T_max = int(max_len or model.max_len)
    if T_max > model.max_len:
        raise ValueError(
            f"max_len {T_max} exceeds the model's positional table "
            f"({model.max_len}); the decode window cannot outgrow "
            f"the positions the model was built with")
    return T_max


def _eos_pad(model, eos_id, pad_id):
    """``eos_id=None`` disables early stop (sentinel 0 — ids are
    1-based); ``pad_id`` defaults to the eos itself.  Out-of-vocabulary
    ids are rejected."""
    for name, v in (("eos_id", eos_id), ("pad_id", pad_id)):
        if v is not None and not 1 <= int(v) <= model.vocab_size:
            raise ValueError(
                f"{name}={v} outside the 1-based vocabulary "
                f"[1, {model.vocab_size}]")
    eos = int(eos_id or 0)
    pad = int(pad_id) if pad_id is not None else eos
    return eos, pad


def _cast_floats(tree, dtype):
    """Cast every floating leaf of a param tree to ``dtype`` — positions
    and norm weights included, as the JAX package's bf16 serving does."""
    if isinstance(tree, dict):
        return {k: _cast_floats(v, dtype) for k, v in tree.items()}
    return tree.detach().to(dtype) if tree.is_floating_point() \
        else tree.detach()


def _gqa_attend(q, k_cache, v_cache, pos: int, H: int, Hkv: int, Dh: int):
    """Causal attention of Tq queries (absolute positions
    pos..pos+Tq-1) against a dense ``[B, Hkv, Tm, Dh]`` cache.  Scores
    in q's dtype scaled by ``1/sqrt(Dh)`` cast to it, softmax in f32.
    GQA contracts the query groups against the UN-repeated cache.  Only
    the filled slots [0, pos+Tq) are read: the JAX function scores the
    whole cache and masks the rest to -inf, which adds exact zeros."""
    Tq = q.shape[2]
    Tm = min(k_cache.shape[2], pos + Tq)
    k_cache, v_cache = k_cache[:, :, :Tm], v_cache[:, :, :Tm]
    scale = float(torch.tensor(1.0 / math.sqrt(Dh),
                               dtype=torch.float32).to(q.dtype))
    qpos = pos + torch.arange(Tq, device=q.device)
    keep = torch.arange(Tm, device=q.device)[None, :] <= qpos[:, None]
    if Hkv == H:
        scores = torch.matmul(q, k_cache.transpose(-1, -2)) * scale
        scores = scores.masked_fill(~keep, float("-inf"))
        probs = torch.softmax(scores.float(), dim=-1)
        return torch.matmul(probs.to(q.dtype), v_cache)
    B = q.shape[0]
    qg = q.reshape(B, Hkv, H // Hkv, Tq, Dh)
    scores = torch.matmul(qg, k_cache[:, :, None].transpose(-1, -2)) * scale
    scores = scores.masked_fill(~keep, float("-inf"))
    probs = torch.softmax(scores.float(), dim=-1)
    o = torch.matmul(probs.to(q.dtype), v_cache[:, :, None])
    return o.reshape(B, H, Tq, Dh)


def _ffn_sublayer(block, bp, h):
    """ln2 + the block's MLP with the residual add — the post-attention
    half of a block."""
    return h + block.mlp(bp, block[2].apply_fn(bp["2"], h))


def _decode_machinery(model, first, count, T_max):
    """The cached-attention forward, built once per generator from the
    model structure.  Every function takes the (already cast) param
    tree ``pc`` explicitly."""
    blocks = [model[first + i] for i in range(count)]
    ln_f = model[first + count]
    head = model[first + count + 1]
    embed = model[0]
    mha0 = blocks[0][1]
    H, Dh = mha0.num_heads, mha0.head_dim
    Hkv = mha0.num_kv_heads
    use_rope = model.use_rope
    rope_theta = mha0.rope_theta

    def _split(x, B, h=H):
        return x.reshape(B, -1, h, Dh).transpose(1, 2)

    def _rep(kv):
        """The Hkv kv heads repeated to the H query heads — only for
        the prompt-length prefill tensors."""
        if Hkv == H:
            return kv
        return kv.repeat_interleave(H // Hkv, dim=1)

    def _block_step(block, bp, h, cache, pos: int):
        """One block on Tq tokens (prefill: Tq=T0 at pos 0; decode:
        Tq=1) against its cache, which it writes in place."""
        mha = block[1]
        B, Tq = h.shape[0], h.shape[1]
        ln1 = block[0].apply_fn(bp["0"], h)
        ap = bp["1"]
        q = _split(proj(ln1, ap, "wq", "bq", mha.with_bias), B)
        k = _split(proj(ln1, ap, "wk", "bk", mha.with_bias), B, Hkv)
        v = _split(proj(ln1, ap, "wv", "bv", mha.with_bias), B, Hkv)
        if use_rope:
            # rotate at ABSOLUTE positions; the cache stores rotated keys
            qpos = pos + torch.arange(Tq, device=h.device)
            q = rope_rotate(q, qpos, rope_theta)
            k = rope_rotate(k, qpos, rope_theta)
        kc, vc = cache
        kc[:, :, pos:pos + Tq] = k
        vc[:, :, pos:pos + Tq] = v
        if pos == 0:
            # prefill: causal attention over the PROMPT only (K1)
            o = flash_attention(q, _rep(k), _rep(v), causal=True)
        else:
            o = _gqa_attend(q, kc, vc, pos, H, Hkv, Dh)
        o = o.transpose(1, 2).reshape(B, Tq, H * Dh)
        h = h + proj(o, ap, "wo", "bo", mha.with_bias)
        return _ffn_sublayer(block, bp, h)

    def _embed_at(pc, tok, pos: int, Tq: int):
        h = embed.apply_fn(pc["0"], tok)
        if use_rope:  # positions live in the per-layer q/k rotation
            return h
        return h + pc["pos"][pos:pos + Tq]

    def prefill(pc, prompt, dt):
        """The whole prompt in one causal pass; returns (h [B,T0,D],
        caches) with positions [0, T0) filled."""
        B, T0 = prompt.shape
        h = _embed_at(pc, prompt, 0, T0)
        caches = []
        for bi, block in enumerate(blocks):
            cache = (torch.zeros((B, Hkv, T_max, Dh), dtype=dt,
                                 device=h.device),
                     torch.zeros((B, Hkv, T_max, Dh), dtype=dt,
                                 device=h.device))
            h = _block_step(block, pc[str(first + bi)], h, cache, 0)
            caches.append(cache)
        return h, caches

    def decode_token(pc, tok, caches, pos: int):
        """One token [B, 1] at absolute position ``pos``; returns
        h [B,1,D] (the caches advance in place)."""
        h = _embed_at(pc, tok, pos, 1)
        for bi, block in enumerate(blocks):
            h = _block_step(block, pc[str(first + bi)], h, caches[bi], pos)
        return h

    def logits_last(pc, h):
        """Head on the LAST position of h only -> [B, V] f32."""
        h = h[:, -1:, :].contiguous()
        h = ln_f.apply_fn(pc[str(first + count)], h)
        h = head.apply_fn(pc[str(first + count + 1)], h)
        return h[:, 0, :].float()

    return prefill, decode_token, logits_last


def _sample(logits, temperature: float, top_k: int, top_p: float,
            generator: Optional[torch.Generator]):
    """0-based next ids [B]: greedy argmax at temperature 0; else a
    categorical draw (Gumbel-max on ``generator``) over
    ``logits/temperature``, optionally within ``top_k`` and/or the
    ``top_p`` nucleus."""
    if temperature <= 0:
        return logits.argmax(dim=-1)
    if top_k:
        kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    scaled = logits / max(temperature, 1e-6)
    if 0 < top_p < 1:
        # keep ranks whose PRECEDING mass < top_p (always keeps rank 0)
        probs = torch.softmax(scaled, dim=-1)
        order = torch.argsort(-probs, dim=-1, stable=True)
        csum = torch.cumsum(torch.gather(probs, -1, order), dim=-1)
        keep_sorted = torch.cat([torch.zeros_like(csum[:, :1]),
                                 csum[:, :-1]], dim=-1) < top_p
        keep = torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)
        scaled = scaled.masked_fill(~keep, float("-inf"))
    u = torch.rand(scaled.shape, generator=generator,
                   device=generator.device).to(scaled.device)
    return (scaled - torch.log(-torch.log(u))).argmax(dim=-1)


def make_generate(model, max_len: Optional[int] = None,
                  compute_dtype: Optional[torch.dtype] = None,
                  kv_dtype: Optional[str] = None):
    """Build ``generate(params, prompt_ids, max_new, generator=None,
    temperature=0.0, top_k=0, top_p=1.0, eos_id=None, pad_id=None) ->
    [B, prompt+max_new] int32 ids`` on the model's device.

    ``params`` is ``model.param_tree()``; ``compute_dtype`` (e.g.
    ``torch.bfloat16``) casts every float leaf for the run.  ``max_len``
    bounds prompt+generated (default: the model's positional table)."""
    if kv_dtype is not None:
        raise NotImplementedError(
            f"kv_dtype {kv_dtype!r}: the int8 KV cache is not ported yet")
    first, count = _check_model(model)
    T_max = _check_len(model, max_len)
    prefill, decode_token, logits_last = _decode_machinery(
        model, first, count, T_max)

    @torch.no_grad()
    def generate(params, prompt_ids, max_new: int,
                 generator: Optional[torch.Generator] = None,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, eos_id: Optional[int] = None,
                 pad_id: Optional[int] = None):
        if temperature > 0 and generator is None:
            raise ValueError(
                "temperature > 0 requires an explicit torch.Generator — "
                "a fixed default would return the identical sample "
                "every call")
        eos, pad = _eos_pad(model, eos_id, pad_id)
        prompt = torch.as_tensor(np.asarray(prompt_ids, np.int32),
                                 device=model.device)
        B, T0 = prompt.shape
        max_new = int(max_new)
        if T0 + max_new > T_max:
            raise ValueError(
                f"prompt {T0} + max_new {max_new} exceeds max_len {T_max}")
        pc = _cast_floats(params, compute_dtype) if compute_dtype \
            else params
        dt = compute_dtype or model[0].weight.dtype

        h, caches = prefill(pc, prompt, dt)
        nxt = _sample(logits_last(pc, h), temperature, top_k, top_p,
                      generator) + 1   # 1-based ids
        # finished rows keep decoding but emit `pad` (static work:
        # max_new steps either way, as in the JAX package)
        done = (nxt == eos) & (eos > 0)
        ids = torch.zeros((B, T0 + max_new), dtype=torch.int32,
                          device=prompt.device)
        ids[:, :T0] = prompt
        ids[:, T0] = nxt.to(torch.int32)
        for pos in range(T0, T0 + max_new - 1):
            h = decode_token(pc, ids[:, pos:pos + 1], caches, pos)
            nxt = _sample(logits_last(pc, h), temperature, top_k, top_p,
                          generator) + 1
            nxt = torch.where(done, torch.full_like(nxt, pad), nxt)
            done = done | ((nxt == eos) & (eos > 0))
            ids[:, pos + 1] = nxt.to(torch.int32)
        return ids

    return generate


@torch.no_grad()
def last_logits(model, prompt_ids, compute_dtype=None) -> torch.Tensor:
    """Logits [B, V] (f32) at the last prompt position, through the same
    prefill and head the generator runs — what a reference holds the
    first generated token against."""
    first, count = _check_model(model)
    prompt = torch.as_tensor(np.asarray(prompt_ids, np.int32),
                             device=model.device)
    prefill, _, logits_last = _decode_machinery(
        model, first, count, _check_len(model, prompt.shape[1]))
    params = model.param_tree()
    pc = _cast_floats(params, compute_dtype) if compute_dtype else params
    h, _ = prefill(pc, prompt, compute_dtype or model[0].weight.dtype)
    return logits_last(pc, h)


def cached_generate(model, compute_dtype=None, kv_dtype=None,
                    max_len: Optional[int] = None):
    """The per-model generator, built once per (max_len, compute_dtype,
    kv_dtype) config and weakly cached."""
    cfg = (max_len or model.max_len, compute_dtype, kv_dtype)
    slot = _GEN_CACHE.setdefault(model, {})
    if cfg not in slot:
        slot[cfg] = make_generate(model, max_len=max_len,
                                  compute_dtype=compute_dtype,
                                  kv_dtype=kv_dtype)
    return slot[cfg]
