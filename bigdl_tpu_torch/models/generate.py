"""Autoregressive generation for TransformerLM — KV-cache decode
(counterpart of ``bigdl_tpu/models/generate.py``).

Same structure as the JAX module: a batched prefill (the whole prompt
in one causal pass through kernel K1, filling the per-layer KV caches
``[B, Hkv, T_max, Dh]``), then one token per step against the caches.
The JAX package compiles the step loop into one ``lax.scan``; here it
is an eager Python loop, and the caches are written in place.

Ported: greedy and temperature / top-k / top-p sampling on an explicit
``torch.Generator``, eos/pad, GQA and rope; the int8 KV cache
(``kv_dtype="int8"``); beam search (:func:`make_beam_search`); the
paged decode against a ``serving.kvpool.KVPagePool`` arena
(:class:`PagedDecoder`), whose prefill runs K1, or K6 over the
page-granular sliding-window block mask when ``page_window`` binds; and
MoE blocks, which decode through the capacity-free top-k dispatch
(:func:`_moe_ffn_nodrop`), with :func:`capacity_bind_report` measuring
how often the training dispatch's capacity would have dropped.

Token ids are 1-based: a greedy step emits ``argmax + 1``.  Finished
rows emit ``pad``; ``eos_id=None`` becomes the sentinel 0, which no
1-based id matches.
"""
from __future__ import annotations

import math
import threading
import weakref
from typing import Optional

import numpy as np
import torch

from ..nn.attention import proj, rope_rotate
from ..ops.block_sparse import block_sparse_attention, sliding_window_mask
from ..ops.flash_attention import flash_attention
from ..parallel.moe import top_choices
from ..utils.tree import tree_leaves

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


def _gqa_attend(q, k_cache, v_cache, pos: int, H: int, Hkv: int, Dh: int,
                k_pos: Optional[torch.Tensor] = None):
    """Causal attention of Tq queries (absolute positions
    pos..pos+Tq-1) against a dense ``[B, Hkv, Tm, Dh]`` cache view.
    Scores in q's dtype scaled by ``1/sqrt(Dh)`` cast to it, softmax in
    f32.  GQA contracts the query groups against the UN-repeated cache.
    Shared by the dense-cache machinery and the paged decode, so the two
    cannot drift numerically.  Without ``k_pos`` slot i holds position
    i and only the filled slots [0, pos+Tq) are read: the JAX function
    scores the whole cache and masks the rest to -inf, which adds exact
    zeros.  ``k_pos`` [Tm] gives each slot's absolute position when the
    view is not contiguous from 0 (the page window gathers only the live
    pages); slots past the query are masked to -inf."""
    Tq = q.shape[2]
    qpos = pos + torch.arange(Tq, device=q.device)
    if k_pos is None:
        Tm = min(k_cache.shape[2], pos + Tq)
        k_cache, v_cache = k_cache[:, :, :Tm], v_cache[:, :, :Tm]
        k_pos = torch.arange(Tm, device=q.device)
    scale = float(torch.tensor(1.0 / math.sqrt(Dh),
                               dtype=torch.float32).to(q.dtype))
    keep = k_pos[None, :] <= qpos[:, None]
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


# capacity-bind capture: while a list is installed on this thread,
# every _moe_ffn_nodrop call appends the share of its routing
# assignments that the TRAINING dispatch's static capacity would have
# dropped (capacity_bind_report's side channel; absent during decode)
_BIND_TLS = threading.local()


def _moe_ffn_nodrop(moe, params, x):
    """Capacity-free top-k dispatch for decode: each token through its
    chosen experts' MLPs, mixed by the (top-1 raw / top-k renormalised)
    gates in x's dtype, [B, Tq, D] -> [B, Tq, D] — the JAX function
    (``bigdl_tpu/models/generate.py:117-147``).  Where the JAX function
    gathers each token's ``[D, H]`` weights, the tokens are grouped by
    expert through the layer's own dispatch at capacity N: an expert
    takes a token at most once, so slot ``e·N + n`` is each assignment's
    own and every one is kept, and each expert runs its tokens' rows,
    padded to N, in one product.  Nothing is read back to the host, so
    the decode step stays free of syncs; the experts compute E·N rows
    for the N·K assignments."""
    B, Tq, D = x.shape
    N, K = B * Tq, moe.top_k
    x2 = x.reshape(N, D)
    logits = torch.matmul(x2, params["router_w"].t()) + params["router_b"]
    probs = torch.softmax(logits.float(), dim=-1)
    gk, idxk = top_choices(probs, K)                     # [N, K]
    capture = getattr(_BIND_TLS, "capture", None)
    if capture is not None:
        # the training dispatch's keep rule, through the layer's own
        # helper (capacity from THIS call's token count, the choices in
        # order), over all N·K routing assignments
        kept, counts = 0.0, None
        for c in range(K):
            oh = torch.nn.functional.one_hot(idxk[:, c], moe.n_experts)
            _, keep, counts = moe.keep_mask(oh.float(), counts)
            kept = kept + keep.float().sum()
        capture.append(1.0 - kept / (N * K))
    slot = idxk.t() * N + torch.arange(N, device=x.device)
    rows = moe.dispatch(params, x2, slot, None, N)       # [K, N, D]
    y = 0.0
    for c in range(K):
        y = y + gk[:, c, None].to(x.dtype) * rows[c]
    return y.reshape(B, Tq, D)


def _ffn_sublayer(block, bp, h):
    """ln2 + the block's MLP (gelu, swiglu or the capacity-free MoE
    dispatch) with the residual add — the post-attention half of a
    block, shared by the dense-cache and paged machineries."""
    ln2 = block[2].apply_fn(bp["2"], h)
    if block.mlp_kind == "moe":
        return h + _moe_ffn_nodrop(block[3], bp["3"], ln2)
    return h + block.mlp(bp, ln2)


def _quant_kv(x):
    """absmax int8 over the head dim: x ≈ q * s, q int8, s [..., 1]
    f32 — the JAX function's arithmetic (scale + 1e-12; ``torch.round``
    rounds half to even, as ``jnp.round`` does)."""
    xf = x.float()
    s = xf.abs().amax(dim=-1, keepdim=True) / 127.0 + 1e-12
    return torch.round(xf / s).to(torch.int8), s


def _decode_machinery(model, first, count, T_max, kv_int8: bool = False):
    """The cached-attention forward shared by the sampling decoder and
    beam search, built once per generator from the model structure.
    Every function takes the (already cast) param tree ``pc``
    explicitly.

    ``kv_int8`` stores the caches as int8 with an f32 scale per (batch,
    head, position): absmax rounding over the head dim.  The prompt's
    own prefill attention stays full-precision (only the decode steps
    read the quantized cache), so the first generated token is the full
    cache's.  Lossy by construction: an approximation knob, off by
    default."""
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

    def _cache_init(B, dt, device):
        shape = (B, Hkv, T_max, Dh)
        if kv_int8:
            scale = (B, Hkv, T_max, 1)
            return (torch.zeros(shape, dtype=torch.int8, device=device),
                    torch.zeros(scale, dtype=torch.float32, device=device),
                    torch.zeros(shape, dtype=torch.int8, device=device),
                    torch.zeros(scale, dtype=torch.float32, device=device))
        return (torch.zeros(shape, dtype=dt, device=device),
                torch.zeros(shape, dtype=dt, device=device))

    def _cache_write(cache, k, v, pos: int):
        """Write positions [pos, pos+Tq) in place."""
        Tq = k.shape[2]
        if kv_int8:
            kq, ks, vq, vs = cache
            for (cq, cs), x in (((kq, ks), k), ((vq, vs), v)):
                qx, sx = _quant_kv(x)
                cq[:, :, pos:pos + Tq] = qx
                cs[:, :, pos:pos + Tq] = sx
        else:
            kc, vc = cache
            kc[:, :, pos:pos + Tq] = k
            vc[:, :, pos:pos + Tq] = v

    def _cache_kv(cache, dt, n: int):
        """(k, v) views of the cache's first ``n`` slots in ``dt`` — for
        int8 dequantized as ``q.to(dt) * s.to(dt)``, as the JAX
        function does over its whole cache."""
        if kv_int8:
            kq, ks, vq, vs = cache
            return (kq[:, :, :n].to(dt) * ks[:, :, :n].to(dt),
                    vq[:, :, :n].to(dt) * vs[:, :, :n].to(dt))
        return cache[0][:, :, :n], cache[1][:, :, :n]

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
        _cache_write(cache, k, v, pos)
        if pos == 0:
            # prefill: causal attention over the PROMPT only (K1), on
            # the full-precision k/v even under kv_int8
            o = flash_attention(q, _rep(k), _rep(v), causal=True)
        else:
            o = _gqa_attend(q, *_cache_kv(cache, q.dtype, pos + Tq), pos,
                            H, Hkv, Dh)
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
            cache = _cache_init(B, dt, h.device)
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


def _kv_int8(kv_dtype) -> bool:
    if kv_dtype in (None, "int8"):
        return kv_dtype == "int8"
    raise ValueError(f"kv_dtype {kv_dtype!r} not in (None, 'int8')")


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
    bounds prompt+generated (default: the model's positional table).
    ``kv_dtype="int8"`` stores the decode caches as int8 (see
    :func:`_decode_machinery`)."""
    first, count = _check_model(model)
    T_max = _check_len(model, max_len)
    prefill, decode_token, logits_last = _decode_machinery(
        model, first, count, T_max, kv_int8=_kv_int8(kv_dtype))

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


# prefill machinery per model instance and sequence length (the
# _GEN_CACHE pattern): the report is meant to run on every batch a
# generator produces
_BIND_CACHE = weakref.WeakKeyDictionary()


@torch.no_grad()
def capacity_bind_report(model, params, ids):
    """How far MoE decode departs from the trained function: per MoE
    block, the share of ``ids``'s routing assignments (``N·top_k``; for
    top-1 the tokens) that the TRAINING dispatch's static capacity
    (``parallel/moe.py``: ``C = ceil(f·N/E)`` at this batch's token
    count, the choices in order, one cumsum over all ``B·T`` tokens)
    would have dropped.  Decode routes capacity-free, so a model whose
    capacity binds decodes through another function than it was trained
    on; this measures how often.  A teacher-forced replay of ``ids``
    through the decode machinery's prefill (capacity-free MoE, so the
    hidden states are exactly the decode path's).

    Returns ``{block_index: share}`` over the model's MoE blocks plus
    ``"overall"`` (their mean); ``{}`` for a dense model."""
    first, count = _check_model(model)
    moe_idx = [first + bi for bi in range(count)
               if model[first + bi].is_moe]
    if not moe_idx:
        return {}
    ids = torch.as_tensor(np.asarray(ids, np.int32), device=model.device)
    T = int(ids.shape[1])
    if T > model.max_len:
        raise ValueError(f"sequence length {T} exceeds max_len "
                         f"{model.max_len}")
    slot = _BIND_CACHE.setdefault(model, {})
    if T not in slot:
        slot[T] = _decode_machinery(model, first, count, T)[0]
    _BIND_TLS.capture = []
    try:
        slot[T](params, ids, tree_leaves(params)[0].dtype)
        fracs = [float(f) for f in _BIND_TLS.capture]
    finally:
        _BIND_TLS.capture = None
    report = dict(zip(moe_idx, fracs))
    report["overall"] = sum(fracs) / len(fracs)
    return report


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


def _top_k(x, k: int):
    """The ``k`` largest entries of each row of ``x`` and their indices,
    ties broken by the lower index first (``lax.top_k``'s order;
    ``torch.topk`` leaves it undefined): a stable descending sort."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def make_beam_search(model, max_len: Optional[int] = None,
                     compute_dtype: Optional[torch.dtype] = None,
                     kv_dtype: Optional[str] = None):
    """Build ``beam_search(params, prompt_ids, max_new, num_beams=4,
    eos_id=None, pad_id=None) -> (ids [B, prompt+max_new] int32,
    scores [B] f32)`` on the model's device.

    Each step expands every beam over the vocabulary and keeps the top
    ``num_beams`` by cumulative log-probability (ties to the lower
    index, as the JAX function's ``lax.top_k``); the KV caches are
    replicated per beam and gathered along the beam dim
    (``index_select``) to follow their parents.  ``scores`` are total
    log-probs.  With ``eos_id``, a beam that emits eos FINISHES: its
    score freezes and its only continuation is ``pad_id`` (default the
    eos) at zero cost, so finished beams compete with live ones.  No
    length penalty.

    When ``num_beams`` exceeds the vocabulary, the surplus first-step
    beams start dead (-inf) and are claimed by real expansions at later
    depths, so ``num_beams=1`` is greedy and, with enough beams to hold
    every prefix, beam search is exhaustive.  Shares
    :func:`_decode_machinery` with the sampling decoder."""
    first, count = _check_model(model)
    T_max = _check_len(model, max_len)
    prefill, decode_token, logits_last = _decode_machinery(
        model, first, count, T_max, kv_int8=_kv_int8(kv_dtype))

    @torch.no_grad()
    def beam_search(params, prompt_ids, max_new: int, num_beams: int = 4,
                    eos_id: Optional[int] = None,
                    pad_id: Optional[int] = None):
        if num_beams < 1:
            raise ValueError(f"num_beams must be >= 1, got {num_beams}")
        eos, pad = _eos_pad(model, eos_id, pad_id)
        prompt = torch.as_tensor(np.asarray(prompt_ids, np.int32),
                                 device=model.device)
        B, T0 = prompt.shape
        kk, max_new = int(num_beams), int(max_new)
        if T0 + max_new > T_max:
            raise ValueError(
                f"prompt {T0} + max_new {max_new} exceeds max_len {T_max}")
        pc = _cast_floats(params, compute_dtype) if compute_dtype \
            else params
        dt = compute_dtype or model[0].weight.dtype
        dev = prompt.device

        h, caches = prefill(pc, prompt, dt)
        logp0 = torch.log_softmax(logits_last(pc, h), dim=-1)   # [B, V]
        V = logp0.shape[-1]
        # the first expansion has only V candidates: surplus beams start
        # dead (-inf), keeping the beam width at kk throughout
        k0 = min(kk, V)
        scores, first_tok = _top_k(logp0, k0)                  # [B, k0]
        if k0 < kk:
            scores = torch.cat([scores, torch.full(
                (B, kk - k0), float("-inf"), device=dev)], dim=1)
            first_tok = torch.cat([first_tok, torch.zeros(
                (B, kk - k0), dtype=first_tok.dtype, device=dev)], dim=1)
        done = ((first_tok + 1) == eos) & (eos > 0)            # [B, kk]
        ids = torch.zeros((B, kk, T0 + max_new), dtype=torch.int32,
                          device=dev)
        ids[:, :, :T0] = prompt[:, None, :]
        ids[:, :, T0] = (first_tok + 1).to(torch.int32)
        # caches replicate per beam: [B, ...] -> [B*kk, ...] (the int8
        # cache carries quantized values and scales alike)
        caches = [tuple(c.repeat_interleave(kk, dim=0) for c in cache)
                  for cache in caches]
        # a finished beam's one legal continuation: pad at zero cost
        pad_row = torch.full((V,), float("-inf"), device=dev)
        if pad > 0:
            pad_row[pad - 1] = 0.0
        beam_base = (torch.arange(B, device=dev) * kk)[:, None]
        for pos in range(T0, T0 + max_new - 1):
            tok = ids.reshape(B * kk, -1)[:, pos:pos + 1]
            h = decode_token(pc, tok, caches, pos)
            logp = torch.log_softmax(logits_last(pc, h), dim=-1)
            logp = torch.where(done[:, :, None], pad_row,
                               logp.reshape(B, kk, V))
            cand = scores[:, :, None] + logp
            scores, idx = _top_k(cand.reshape(B, kk * V), kk)
            parent = idx // V                                  # [B, kk]
            tok_next = idx % V + 1
            done = (torch.gather(done, 1, parent)
                    | ((tok_next == eos) & (eos > 0)))
            # beams follow their parents: reorder ids and caches
            ids = torch.gather(ids, 1, parent[:, :, None].expand_as(ids))
            ids[:, :, pos + 1] = tok_next.to(torch.int32)
            rows = (parent + beam_base).reshape(-1)
            caches = [tuple(c.index_select(0, rows) for c in cache)
                      for cache in caches]
        best = scores.argmax(dim=-1)                           # [B]
        out = ids[torch.arange(B, device=dev), best]
        return out, scores[torch.arange(B, device=dev), best]

    return beam_search


# --------------------------------------------------------------------------
# Paged decode: page-table KV through a shared KVPagePool arena
# --------------------------------------------------------------------------

def _paged_machinery(model, first, count, page_size: int,
                     page_window: Optional[int] = None,
                     page_globals: int = 1):
    """The paged twin of :func:`_decode_machinery`: K/V live in a
    shared ``[num_pages, layers, Hkv, page_size, Dh]`` arena, written in
    place, and each request addresses its positions through a page
    table ``pt`` (page ids, bucket-padded).  Attention gathers the
    request's pages into a dense view and runs the SAME
    :func:`_gqa_attend` the unpaged decode runs, on the same filled
    slots, so the paged token stream is the unpaged stream.

    ``page_window`` turns on the page-granular block mask: each decode
    step gathers and attends only the first ``page_globals`` anchor
    pages plus the last ``page_window`` pages.  The prefill applies the
    same rule through the block-sparse kernel K6 at block = page size
    (``ops/block_sparse``) when the window binds.  A window wide enough
    to cover the whole bucket is exactly the dense paged path.
    """
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
        if Hkv == H:
            return kv
        return kv.repeat_interleave(H // Hkv, dim=1)

    def _embed_at(pc, tok, pos: int, Tq: int):
        h = embed.apply_fn(pc["0"], tok)
        if use_rope:
            return h
        return h + pc["pos"][pos:pos + Tq]

    def _qkv(block, ap, ln1, pos_ids):
        mha = block[1]
        B = ln1.shape[0]
        q = _split(proj(ln1, ap, "wq", "bq", mha.with_bias), B)
        k = _split(proj(ln1, ap, "wk", "bk", mha.with_bias), B, Hkv)
        v = _split(proj(ln1, ap, "wv", "bv", mha.with_bias), B, Hkv)
        if use_rope:
            q = rope_rotate(q, pos_ids, rope_theta)
            k = rope_rotate(k, pos_ids, rope_theta)
        return q, k, v

    def logits_last(pc, h):
        h = h[:, -1:, :].contiguous()
        h = ln_f.apply_fn(pc[str(first + count)], h)
        h = head.apply_fn(pc[str(first + count + 1)], h)
        return h[:, 0, :].float()

    def _prefill_mask(T0: int):
        """The page-window block mask of a prompt of ``T0`` tokens, or
        None where the prefill runs full causal flash: no window, a
        window that does not bind, or a ragged last page (which the
        block granularity cannot express)."""
        n_pages = -(-T0 // page_size)
        if page_window is None or n_pages <= page_window + page_globals \
                or T0 % page_size:
            return None
        return sliding_window_mask(n_pages, n_pages, page_window,
                                   n_global=page_globals, causal=True,
                                   block_q=page_size, block_k=page_size)

    def prefill(pc, prompt, pt, arena_k, arena_v):
        """The whole prompt [1, T0] in one causal pass (K1, or K6 under
        the page window), its K/V scattered into the request's pages
        ``pt[:ceil(T0 / page_size)]``.  Returns the last position's
        logits [1, V] f32."""
        B, T0 = prompt.shape
        n_pages = -(-T0 // page_size)
        pages = pt[:n_pages]
        mask = _prefill_mask(T0)
        pos_ids = torch.arange(T0, device=prompt.device) if use_rope \
            else None
        h = _embed_at(pc, prompt, 0, T0)

        def paged_view(x):   # [1, Hkv, T0, Dh] -> [n, Hkv, ps, Dh]
            xp = torch.nn.functional.pad(
                x[0], (0, 0, 0, n_pages * page_size - T0))
            return xp.reshape(Hkv, n_pages, page_size, Dh).transpose(0, 1)

        for bi, block in enumerate(blocks):
            bp = pc[str(first + bi)]
            ln1 = block[0].apply_fn(bp["0"], h)
            q, k, v = _qkv(block, bp["1"], ln1, pos_ids)
            arena_k[pages, bi] = paged_view(k).to(arena_k.dtype)
            arena_v[pages, bi] = paged_view(v).to(arena_v.dtype)
            if mask is None:
                o = flash_attention(q, _rep(k), _rep(v), causal=True)
            else:
                o = block_sparse_attention(q, _rep(k), _rep(v), mask,
                                           causal=True)
            o = o.transpose(1, 2).reshape(B, T0, H * Dh)
            h = h + proj(o, bp["1"], "wo", "bo", block[1].with_bias)
            h = _ffn_sublayer(block, bp, h)
        return logits_last(pc, h)

    def _page_view(arena, pages, bi: int, dt):
        """Gather ``pages`` (a page-id tensor) of layer ``bi`` into a
        dense [1, Hkv, len * page_size, Dh] view."""
        n = pages.shape[0]
        return arena[pages, bi].transpose(0, 1).reshape(
            Hkv, n * page_size, Dh)[None].to(dt)

    def decode(pc, tok, pos: int, pt, arena_k, arena_v):
        """One token [1, 1] at absolute position ``pos``: write its K/V
        into page ``pt[pos // page_size]`` slot ``pos % page_size``,
        attend over the gathered page view.  Under a binding page
        window only the anchor + window pages are gathered: dead pages
        cost no gather, no bytes, no score columns.  ``pt`` is the
        bucket-padded page table, a host list.  Returns the logits
        [1, V] f32."""
        P = len(pt)
        dev = tok.device
        page, slot = pt[pos // page_size], pos % page_size
        if page_window is not None and P > page_window + page_globals:
            # the G anchor pages + the W pages ending at the current
            # one; ``start`` clamps to G so anchors never duplicate, and
            # window slots not yet written carry k_pos > pos
            G, W = page_globals, page_window
            start = max(pos // page_size - (W - 1), G)
            page_ids = list(range(G)) + list(range(start, start + W))
            view = torch.as_tensor([pt[i] for i in page_ids], device=dev)
            k_pos = (torch.as_tensor(page_ids, device=dev)[:, None]
                     * page_size + torch.arange(page_size, device=dev)
                     ).reshape(-1)
        else:
            # the whole bucket; positions past ``pos`` (padding pages,
            # other requests' bytes) are never read
            view = torch.as_tensor(pt, device=dev)
            k_pos = None
        pos_ids = pos + torch.arange(1, device=dev) if use_rope else None
        h = _embed_at(pc, tok, pos, 1)
        for bi, block in enumerate(blocks):
            bp = pc[str(first + bi)]
            ln1 = block[0].apply_fn(bp["0"], h)
            q, k, v = _qkv(block, bp["1"], ln1, pos_ids)
            arena_k[page, bi, :, slot, :] = k[0, :, 0, :].to(arena_k.dtype)
            arena_v[page, bi, :, slot, :] = v[0, :, 0, :].to(arena_v.dtype)
            kc = _page_view(arena_k, view, bi, q.dtype)
            vc = _page_view(arena_v, view, bi, q.dtype)
            o = _gqa_attend(q, kc, vc, pos, H, Hkv, Dh, k_pos=k_pos)
            o = o.transpose(1, 2).reshape(1, 1, H * Dh)
            h = h + proj(o, bp["1"], "wo", "bo", block[1].with_bias)
            h = _ffn_sublayer(block, bp, h)
        return logits_last(pc, h)

    return prefill, decode


class _PagedFns:
    """The paged prefill and decode of one (model, page_size,
    compute_dtype, page window) config: the param cast to the compute
    dtype (kept while the parameters are unchanged), argmax + 1, and the
    static shapes dispatched."""

    def __init__(self, model, first, count, page_size, compute_dtype,
                 page_window, page_globals):
        self._prefill, self._decode = _paged_machinery(
            model, first, count, page_size, page_window=page_window,
            page_globals=page_globals)
        self.compute_dtype = compute_dtype
        self._cast = None          # (leaves, versions, cast tree)
        #: (prompt_len, bucket) pairs and buckets dispatched
        self.prefill_shapes: set = set()
        self.decode_shapes: set = set()

    def cast(self, params):
        if not self.compute_dtype:
            return params
        leaves = tuple(tree_leaves(params))
        versions = tuple(t._version for t in leaves)
        held = self._cast
        if held is not None and len(held[0]) == len(leaves) \
                and all(a is b for a, b in zip(held[0], leaves)) \
                and held[1] == versions:
            return held[2]
        pc = _cast_floats(params, self.compute_dtype)
        self._cast = (leaves, versions, pc)
        return pc

    def prefill(self, params, prompt, pt, arena_k, arena_v) -> int:
        self.prefill_shapes.add((int(prompt.shape[1]), len(pt)))
        pt_dev = torch.as_tensor(pt, device=prompt.device)
        logits = self._prefill(self.cast(params), prompt, pt_dev, arena_k,
                               arena_v)
        return int(logits.argmax(dim=-1)[0]) + 1

    def decode(self, params, tok, pos: int, pt, arena_k, arena_v) -> int:
        self.decode_shapes.add(len(pt))
        logits = self._decode(self.cast(params), tok, pos, pt, arena_k,
                              arena_v)
        return int(logits.argmax(dim=-1)[0]) + 1


# paged programs per model instance, keyed by (page_size, compute_dtype,
# page window): shared across every pool with that geometry
_PAGED_FN_CACHE = weakref.WeakKeyDictionary()


def _paged_fns(model, first, count, page_size, compute_dtype,
               page_window=None, page_globals=1) -> _PagedFns:
    slot = _PAGED_FN_CACHE.setdefault(model, {})
    key = (int(page_size), compute_dtype,
           None if page_window is None else int(page_window),
           int(page_globals))
    if key not in slot:
        slot[key] = _PagedFns(model, first, count, page_size,
                              compute_dtype, page_window, page_globals)
    return slot[key]


class PagedSequence:
    """Host-side state of one in-flight paged decode: the page lease,
    the next write position, and the last emitted (1-based) token."""

    __slots__ = ("lease", "pos", "last", "prompt_len")

    def __init__(self, lease, pos: int, last: int, prompt_len: int):
        self.lease = lease
        self.pos = int(pos)
        self.last = int(last)
        self.prompt_len = int(prompt_len)

    def release(self):
        self.lease.release()


class PagedDecoder:
    """Per-request paged greedy decode against a shared
    :class:`~bigdl_tpu_torch.serving.kvpool.KVPagePool` on the model's
    device (a pool on another device raises).

    ``start`` leases pages for the prompt, prefills them, and returns
    the first generated token inside a :class:`PagedSequence`;
    ``step`` advances one token, extending the lease (one page at a
    time) as the decode crosses page boundaries — a failed extension
    raises :class:`~bigdl_tpu_torch.serving.kvpool.PoolExhausted` and
    the caller sheds typed.  Greedy only.

    Shape accounting: the JAX package compiles ONE prefill per
    (prompt_len, page bucket) and ONE decode per page bucket.  The port
    runs eagerly and compiles nothing; ``compile_stats()`` keeps the
    reference's keys and counts the distinct static shapes dispatched,
    (prompt_len, bucket) for prefill and bucket for decode — the
    contract the reference's tests pin, and the keys a CUDA-graph
    capture of the decode step would be built on.
    """

    def __init__(self, model, pool, compute_dtype=None,
                 max_len: Optional[int] = None,
                 page_window: Optional[int] = None,
                 page_globals: int = 1):
        if page_window is not None and page_window < 1:
            raise ValueError(f"page_window must be >= 1 pages, got "
                             f"{page_window}")
        first, count = _check_model(model)
        mha0 = model[first][1]
        Hkv = mha0.num_kv_heads
        if (pool.layers, pool.num_kv_heads, pool.head_dim) != \
                (count, Hkv, mha0.head_dim):
            raise ValueError(
                f"pool geometry (layers={pool.layers}, "
                f"Hkv={pool.num_kv_heads}, Dh={pool.head_dim}) does "
                f"not match the model (layers={count}, Hkv={Hkv}, "
                f"Dh={mha0.head_dim})")
        if pool.device != model.device:
            raise ValueError(f"pool on {pool.device}, model on "
                             f"{model.device}: the arena must be on the "
                             f"model's device")
        self.model = model
        self.pool = pool
        #: decode window cap: the positional table AND the arena both
        #: bound how long any one request may grow
        self.T_max = min(_check_len(model, max_len), pool.max_positions)
        self.max_pages = pool.pages_for_tokens(self.T_max)
        self.page_window = page_window
        self.page_globals = int(page_globals)
        self._fns = _paged_fns(model, first, count, pool.page_size,
                               compute_dtype, page_window=page_window,
                               page_globals=page_globals)

    def _padded_table(self, lease):
        from ..serving.kvpool import page_bucket_for

        bucket = page_bucket_for(len(lease.pages), self.max_pages)
        return lease.pages + [0] * (bucket - len(lease.pages))

    @torch.no_grad()
    def start(self, params, prompt_ids) -> PagedSequence:
        """Prefill one 1-D prompt into freshly leased pages; the
        returned sequence's ``last`` is the first generated token.
        Raises ``PoolExhausted`` (shed typed upstream) when the pool
        cannot back the prompt."""
        prompt = np.asarray(prompt_ids, np.int32)
        if prompt.ndim != 1:
            raise ValueError(f"prompt_ids must be 1-D, got shape "
                             f"{prompt.shape}")
        T0 = int(prompt.shape[0])
        if T0 + 1 > self.T_max:
            raise ValueError(
                f"prompt {T0} leaves no decode room in max_len "
                f"{self.T_max}")
        lease = self.pool.alloc(self.pool.pages_for_tokens(T0))
        try:
            pt = self._padded_table(lease)
            prompt_t = torch.as_tensor(prompt, device=self.pool.device)
            with self.pool.arena_lock:
                ak, av = self.pool.arena
                tok = self._fns.prefill(params, prompt_t[None], pt, ak, av)
                self.pool.set_arena(ak, av)
            return PagedSequence(lease, pos=T0, last=tok, prompt_len=T0)
        except BaseException:
            lease.release()
            raise

    @torch.no_grad()
    def step(self, params, seq: PagedSequence) -> int:
        """Advance one greedy token (writes the previous token's K/V
        at ``seq.pos``).  May raise ``PoolExhausted`` on a failed page
        extension — the sequence's pages stay held so the caller can
        resolve it typed before releasing."""
        if seq.lease.released:
            raise RuntimeError("sequence already released")
        if seq.pos + 1 > self.T_max:
            raise ValueError(f"decode window exhausted at pos "
                             f"{seq.pos} (max_len {self.T_max})")
        need = seq.pos // self.pool.page_size + 1
        if need > len(seq.lease.pages):
            seq.lease.extend(need - len(seq.lease.pages))
        pt = self._padded_table(seq.lease)
        tok = torch.full((1, 1), seq.last, dtype=torch.int32,
                         device=self.pool.device)
        with self.pool.arena_lock:
            ak, av = self.pool.arena
            nxt = self._fns.decode(params, tok, seq.pos, pt, ak, av)
            self.pool.set_arena(ak, av)
        seq.pos += 1
        seq.last = nxt
        return nxt

    def compile_stats(self) -> dict:
        """The static-shape contract: decode entries ≤ page buckets
        used, prefill entries ≤ distinct (prompt_len, bucket) pairs
        (counted shapes: the port compiles nothing)."""
        return {
            "prefill_cache_size": len(self._fns.prefill_shapes),
            "decode_cache_size": len(self._fns.decode_shapes),
        }


# paged decoders per model instance (the _GEN_CACHE pattern); the inner
# key carries the pool's identity — another pool builds another decoder
_PAGED_CACHE = weakref.WeakKeyDictionary()


def cached_paged_decoder(model, pool, compute_dtype=None,
                         max_len: Optional[int] = None,
                         page_window: Optional[int] = None,
                         page_globals: int = 1) -> PagedDecoder:
    cfg = (id(pool), compute_dtype, max_len or model.max_len,
           page_window, int(page_globals))
    slot = _PAGED_CACHE.setdefault(model, {})
    if cfg not in slot:
        slot[cfg] = PagedDecoder(model, pool,
                                 compute_dtype=compute_dtype,
                                 max_len=max_len,
                                 page_window=page_window,
                                 page_globals=page_globals)
    return slot[cfg]
