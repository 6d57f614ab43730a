"""Mixture-of-Experts FFN (counterpart of ``bigdl_tpu/parallel/moe.py``)
on one device.

Switch routing (``top_k=1``: one expert per token, its raw softmax
gate) or GShard's top-2 (``top_k=2``: the two gates renormalised to sum
1), with a static per-expert capacity ``C = ceil(f·N/E)`` from the token
count N of the call; tokens over capacity are dropped (they contribute
exactly zero and ride the block's residual).  Capacity is granted in
token order, b-major over the flattened batch, and for top-k in choice
order: every choice-c assignment queues behind all choice-(c-1) ones
(:meth:`MoEFFN.keep_mask`, which ``models/generate.py``'s
``capacity_bind_report`` re-applies at decode time).

The JAX package dispatches by dense one-hot ``[N, E, C]`` dispatch and
combine tensors contracted by einsum, the form XLA's static shapes want.
The port computes the same function by index: each kept assignment's
token is written to its slot of a zeroed ``[E, C, D]`` buffer
(``index_put``), the expert MLPs run as two ``torch.bmm`` over it, and
each token gathers its slots' outputs back, times its gates.  Each slot
holds one token and each output is one product a choice, so in f32 the
result is the einsum's.  :func:`onehot_forward` keeps the JAX form as a
yardstick; no model path runs it.

The Switch auxiliary loss ``E · Σ_e f_e · P_e`` (f_e the share of tokens
first-choice routed to e before capacity, P_e the mean router
probability, the softmax in f32) is enabled by ``aux_loss_coef > 0``.
The JAX layer returns it in its buffer tree, which the training step
reads inside the differentiated loss.  Here the layer writes its value
to the f32 ``aux_loss`` buffer (training mode only, like BatchNorm's
statistics) and, inside :func:`capture_aux`, hands the live term with
its autograd graph to the training step, which adds ``coef · aux`` to
the criterion's loss (``optim/optimizer.py``).  A recompute under
``remat`` runs outside that scope, so no term counts twice.

Expert parallelism (``axis_name``, ``stat_axes``: the ``all_to_all``
dispatch over a mesh axis) comes with the distributed slice and raises.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..device import DeviceLike
from ..nn.initialization import IN_OUT, ONE_D, Xavier, Zeros
from ..nn.module import Container, TensorModule, current_generator

_LIVE = threading.local()


@contextlib.contextmanager
def capture_aux():
    """Within, every forward of an ``MoEFFN`` with ``aux_loss_coef > 0``
    on this thread appends ``(coef, aux)`` to the yielded list, ``aux``
    the live f32 scalar with its autograd graph."""
    prev = getattr(_LIVE, "terms", None)
    _LIVE.terms = []
    try:
        yield _LIVE.terms
    finally:
        _LIVE.terms = prev


def _expert_parallel(what: str, value):
    if value:
        raise NotImplementedError(
            f"MoEFFN({what}={value!r}): expert parallelism over a mesh "
            f"axis comes with the distributed slice (ROADMAP Queue 1 item "
            f"5); pass {what}=None")


def top_choices(probs: torch.Tensor, k: int):
    """(gates [N, k], experts [N, k]) of each row of ``probs``, ties to
    the lower expert as ``lax.top_k``: the first maximum for top-1, a
    stable descending sort otherwise.  Top-k gates renormalise to sum
    1; top-1 keeps the raw gate."""
    if k == 1:
        idx = torch.argmax(probs, dim=-1, keepdim=True)
        return probs.gather(-1, idx), idx
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gk, idxk = vals[:, :k], idx[:, :k]
    return gk / gk.sum(dim=-1, keepdim=True), idxk


class MoEFFN(TensorModule):
    """Switch-style MoE feed-forward over [batch, seq, embed]: ``n_experts``
    expert MLPs (``embed -> hidden -> embed``, tanh gelu) behind a linear
    router.  Parameters as the JAX layer's: ``router_w`` [E, D],
    ``router_b`` [E], ``wi`` [E, D, H], ``bi`` [E, H], ``wo`` [E, H, D],
    ``bo`` [E, D].  ``jitter`` multiplies the router logits by uniform
    noise in [1 - jitter, 1 + jitter] in training, drawn from the
    forward's generator (``nn/module.py``)."""

    def __init__(self, embed_dim: int, hidden_dim: int, n_experts: int,
                 capacity_factor: float = 1.25, jitter: float = 0.0,
                 axis_name: Optional[str] = None,
                 aux_loss_coef: float = 0.0, stat_axes: tuple = (),
                 top_k: int = 1, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        _expert_parallel("axis_name", axis_name)
        _expert_parallel("stat_axes", stat_axes)
        super().__init__(device)
        if n_experts < 1:
            raise ValueError(f"n_experts must be >= 1, got {n_experts}")
        if not 1 <= top_k <= n_experts:
            raise ValueError(
                f"top_k must be in [1, n_experts={n_experts}], got {top_k}")
        self.embed_dim = embed_dim
        self.hidden_dim = hidden_dim
        self.n_experts = n_experts
        self.top_k = int(top_k)
        self.capacity_factor = float(capacity_factor)
        self.jitter = float(jitter)
        self.aux_loss_coef = float(aux_loss_coef)
        E, D, H = n_experts, embed_dim, hidden_dim
        for name, shape in (("router_w", (E, D)), ("router_b", (E,)),
                            ("wi", (E, D, H)), ("bi", (E, H)),
                            ("wo", (E, H, D)), ("bo", (E, D))):
            self._register_param(name, torch.zeros(shape))
        if self.aux_loss_coef > 0.0:
            # registered only when enabled, as in the JAX layer
            self._register_buffer("aux_loss",
                                  torch.zeros((), dtype=torch.float32))
        self.reset(generator)

    def reset(self, generator: Optional[torch.Generator] = None):
        """Router Xavier [E, D], its bias zero; each expert's ``wi`` and
        ``wo`` the transpose of a Xavier draw of a Linear's [out, in]
        weight, their biases zero (the JAX layer's ``reset``)."""
        w_init = self._init_methods.get("weight", Xavier())
        b_init = self._init_methods.get("bias", Zeros())
        E, D, H = self.n_experts, self.embed_dim, self.hidden_dim
        draws = {
            "router_w": w_init.init((E, D), IN_OUT, generator),
            "router_b": b_init.init((E,), ONE_D, generator),
            "wi": torch.stack([w_init.init((H, D), IN_OUT, generator).t()
                               for _ in range(E)]),
            "wo": torch.stack([w_init.init((D, H), IN_OUT, generator).t()
                               for _ in range(E)]),
            "bi": torch.zeros(E, H), "bo": torch.zeros(E, D)}
        with torch.no_grad():
            for name, value in draws.items():
                p = getattr(self, name)
                p.copy_(value.to(p.device, p.dtype))
        return self

    # -- routing ---------------------------------------------------------
    def _capacity(self, n_tokens: int) -> int:
        return max(1, int(np.ceil(self.capacity_factor * n_tokens
                                  / self.n_experts)))

    def keep_mask(self, onehot: torch.Tensor, counts=None,
                  capacity: Optional[int] = None):
        """The dispatch's keep rule, shared with diagnostics: first-come
        slots by the 1-based position-in-expert cumsum over the token
        order, capacity from the token count (or ``capacity``).
        ``counts`` [E] offsets the stream for later routing choices.
        ``onehot`` [N, E] f32 → (pos [N, E] 1-based, keep [N, E] bool,
        new_counts [E]).

        The cumsum runs once over the flattened ``[E, N]`` transpose (a
        one-dimensional scan; a scan down the N rows of ``[N, E]`` runs
        one thread an expert, 2.5 ms at 16384 tokens on the card), each
        expert's row then less the total before it; the counts are
        integers below 2^24, so the f32 sums are exact."""
        oh_t = onehot.t().contiguous()                        # [E, N]
        flat = torch.cumsum(oh_t.reshape(-1), dim=0).view_as(oh_t)
        ends = flat[:, -1]
        starts = torch.cat([ends.new_zeros(1), ends[:-1]])
        pos = (flat - starts[:, None]).t() * onehot           # 1-based
        if counts is not None:
            pos = (pos + counts[None, :]) * onehot
        C = capacity if capacity is not None \
            else self._capacity(onehot.shape[0])
        new_counts = (ends - starts) + (counts if counts is not None
                                        else 0.0)
        return pos, (pos <= C) & (onehot > 0), new_counts

    def route(self, params, x2d: torch.Tensor):
        """(gates [N, K] f32, experts [N, K], probs [N, E] f32): the router
        in x's dtype, jitter in training, the softmax in f32."""
        logits = torch.matmul(x2d, params["router_w"].t()) \
            + params["router_b"]
        if self.training and self.jitter > 0.0:
            gen = current_generator(x2d.device)
            noise = torch.empty(logits.shape, dtype=torch.float32,
                                device=gen.device).uniform_(
                1.0 - self.jitter, 1.0 + self.jitter, generator=gen)
            logits = logits * noise.to(logits.device, logits.dtype)
        probs = torch.softmax(logits.float(), dim=-1)
        gk, idxk = top_choices(probs, self.top_k)
        return gk, idxk, probs

    def slots(self, idxk: torch.Tensor):
        """Each assignment's slot: (slot [K, N] in [0, E·C), keep [K, N]
        bool, C), choice by choice in capacity order; a dropped
        assignment's slot is clamped in range and masked by ``keep``."""
        N = idxk.shape[0]
        C = self._capacity(N)
        slot, keep, counts = [], [], None
        for c in range(idxk.shape[1]):
            oh = F.one_hot(idxk[:, c], self.n_experts).float()
            pos, kp, counts = self.keep_mask(oh, counts, C)
            pos_c = pos.gather(1, idxk[:, c:c + 1])[:, 0].long()
            keep.append(kp.gather(1, idxk[:, c:c + 1])[:, 0])
            slot.append(idxk[:, c] * C + (pos_c - 1).clamp(0, C - 1))
        return torch.stack(slot), torch.stack(keep), C

    def aux_term(self, idxk: torch.Tensor, probs: torch.Tensor):
        """E · Σ_e f_e · P_e before capacity, f over first choices."""
        f_vec = F.one_hot(idxk[:, 0], self.n_experts).float().mean(dim=0)
        return self.n_experts * torch.sum(f_vec * probs.mean(dim=0))

    # -- experts ---------------------------------------------------------
    def expert_mlp(self, params, inp: torch.Tensor) -> torch.Tensor:
        """inp [E, C, D] through each expert's MLP, in inp's dtype."""
        dt = inp.dtype
        h = torch.bmm(inp, params["wi"].to(dt)) + params["bi"].to(dt)[:, None]
        h = F.gelu(h, approximate="tanh")
        return torch.bmm(h, params["wo"].to(dt)) + params["bo"].to(dt)[:, None]

    def _compute(self, params, x):
        B, T, D = x.shape
        x2d = x.reshape(B * T, D)
        gk, idxk, probs = self.route(params, x2d)
        if self.aux_loss_coef > 0.0:
            aux = self.aux_term(idxk, probs)
            if self.training:
                with torch.no_grad():
                    self.aux_loss.copy_(aux.detach())
            terms = getattr(_LIVE, "terms", None)
            if terms is not None:
                terms.append((self.aux_loss_coef, aux))
        slot, keep, C = self.slots(idxk)
        rows = self.dispatch(params, x2d, slot, keep, C)
        # the gates in x's dtype (the JAX combine tensor's), the products
        # summed in f32 and rounded once, as the combine einsum does; a
        # dropped assignment adds exactly 0
        gates = gk.to(x.dtype).float()
        y = torch.zeros((B * T, D), dtype=torch.float32, device=x.device)
        for c in range(self.top_k):
            y = y + torch.where(keep[c][:, None],
                                gates[:, c:c + 1] * rows[c].float(), 0.0)
        return y.to(x.dtype).view(B, T, D)

    def dispatch(self, params, x2d: torch.Tensor, slot: torch.Tensor,
                 keep: Optional[torch.Tensor], C: int) -> torch.Tensor:
        """Each assignment's expert output [K, N, D]: the kept tokens
        written to their slots of a zeroed ``[E, C, D]`` buffer (the
        dropped ones to a spare row past the E·C slots, which no expert
        reads), the experts over it, each slot's output gathered back
        (a dropped assignment's row is any slot's; ``keep`` masks it).
        ``keep=None``: every assignment has a slot of its own."""
        E, K, (N, D) = self.n_experts, slot.shape[0], x2d.shape
        dest = (slot if keep is None
                else torch.where(keep, slot, E * C)).reshape(-1)
        buf = x2d.new_zeros(E * C + 1, D).index_put(
            (dest,), x2d if K == 1 else x2d.repeat(K, 1))
        out = self.expert_mlp(params, buf[:E * C].view(E, C, D))
        return out.reshape(E * C, D).index_select(
            0, slot.reshape(-1)).view(K, N, D)


def onehot_forward(moe: MoEFFN, params, x: torch.Tensor) -> torch.Tensor:
    """The JAX layer's dense dispatch transliterated (``_route`` /
    ``_apply``): one-hot ``[N, E, C]`` dispatch and gate-weighted combine
    tensors, contracted by einsum, in x's dtype.  A yardstick for the
    index dispatch of :meth:`MoEFFN._compute`; eval mode (no jitter),
    no aux.  At N tokens it holds 2·N·E·C elements."""
    B, T, D = x.shape
    x2d = x.reshape(B * T, D)
    logits = torch.matmul(x2d, params["router_w"].t()) + params["router_b"]
    probs = torch.softmax(logits.float(), dim=-1)
    gk, idxk = top_choices(probs, moe.top_k)
    N, C = x2d.shape[0], moe._capacity(x2d.shape[0])
    disp = torch.zeros((N, moe.n_experts, C), dtype=torch.float32,
                       device=x.device)
    comb = torch.zeros_like(disp)
    counts = None
    for c in range(moe.top_k):
        oh = F.one_hot(idxk[:, c], moe.n_experts).float()
        pos, keep, counts = moe.keep_mask(oh, counts)
        slot = (F.one_hot((pos - 1).clamp(0, C - 1).long(), C).float()
                * keep[..., None])
        disp = disp + slot
        comb = comb + gk[:, c, None, None] * slot
    expert_in = torch.einsum("nec,nd->ecd", disp.to(x.dtype), x2d)
    out_e = moe.expert_mlp(params, expert_in)
    y = torch.einsum("nec,ecd->nd", comb.to(x.dtype), out_e)
    return y.view(B, T, D)


def collect_aux_paths(module, prefix=()):
    """Yield (buffer_tree_path, coef) for every MoEFFN with
    ``aux_loss_coef > 0``, in ``buffer_tree``'s addressing (children
    keyed by str(index))."""
    if isinstance(module, MoEFFN):
        if module.aux_loss_coef > 0.0:
            yield prefix + ("aux_loss",), module.aux_loss_coef
    elif isinstance(module, Container):
        for key, child in module.named_children():
            yield from collect_aux_paths(child, prefix + (key,))


def aux_loss_term(buffers, paths):
    """Sum ``coef * buffers[path]`` over collected aux paths (on
    ``model.buffer_tree()``: the terms of the last training forward)."""
    total = 0.0
    for path, coef in paths:
        node = buffers
        for k in path:
            node = node[k]
        total = total + coef * node
    return total


__all__ = ["MoEFFN", "aux_loss_term", "capture_aux", "collect_aux_paths",
           "onehot_forward", "top_choices"]
