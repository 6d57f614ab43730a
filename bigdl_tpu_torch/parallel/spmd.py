"""The host half of ``bigdl_tpu/parallel/spmd.py``: per-module partition
specs, the axes a model is built for, axis resolution, the MoE checks
and the slot specs, plus ``make_train_step``/``make_eval_forward`` over
the plan step on a ``("data",)`` mesh.

The port's bound layers (Column/RowParallelLinear with an ``axis_name``,
``MoEFFN(axis_name=...)``, ``ShardedEmbedding``) still raise at
construction (ROADMAP Queue 1 items 5d, 5e and 10), so their branches
here answer for a module that cannot exist yet.  ``survivor_mesh``
belongs to elastic training (item 7) and is not ported.
"""
from __future__ import annotations

import logging
from typing import Optional

from .plan import P, _map_named, _slot_tree_like, mesh_shape

log = logging.getLogger("bigdl_tpu_torch")


def param_specs(module, model_axis: str = "model"):
    """Spec tree matching ``module.param_tree()``: Column/RowParallel
    weights shard over ``model_axis``; a bound ``MoEFFN``'s expert
    stacks over its own ``axis_name``; every other parameter is
    replicated."""
    from ..nn.module import Container
    from .moe import MoEFFN
    from .tensor_parallel import ColumnParallelLinear, RowParallelLinear

    tree = module.param_tree()
    if isinstance(module, ColumnParallelLinear) and module.axis_name:
        specs = {"weight": P(model_axis, None)}
        if "bias" in tree:
            specs["bias"] = P(model_axis)
        return specs
    if isinstance(module, RowParallelLinear) and module.axis_name:
        specs = {"weight": P(None, model_axis)}
        if "bias" in tree:
            specs["bias"] = P()
        return specs
    if isinstance(module, MoEFFN) and getattr(module, "axis_name", None):
        ax = module.axis_name
        return {"router_w": P(), "router_b": P(),
                "wi": P(ax), "bi": P(ax), "wo": P(ax), "bo": P(ax)}
    if isinstance(module, Container):
        specs = {key: param_specs(m, model_axis)
                 for key, m in module.named_children()}
        for k in tree:  # module-own params (e.g. TransformerLM "pos")
            if k not in specs:
                specs[k] = P()
        return specs
    return _map_named(lambda _, __: P(), tree)


def bound_axes(model) -> frozenset:
    """Mesh axis names the model's modules are BUILT for (bound TP
    layers, expert-parallel MoE, a ring/ulysses sequence strategy)."""
    from .moe import MoEFFN
    from .tensor_parallel import ColumnParallelLinear, RowParallelLinear

    bound = set()
    for m in model.modules_iter():
        if isinstance(m, (ColumnParallelLinear, RowParallelLinear)) \
                and m.axis_name:
            bound.add(m.axis_name)
        if isinstance(m, MoEFFN) and getattr(m, "axis_name", None):
            bound.add(m.axis_name)
    if getattr(model, "seq_strategy", None) in ("ring", "ulysses"):
        bound.add(getattr(model, "seq_axis", "seq"))
    return frozenset(bound)


def _resolve_axes(mesh, data_axis, seq_axis, model_axis,
                  bound=frozenset()):
    """Keep only the axes the mesh has; a dropped axis the model is
    BOUND to is named in a warning."""
    mesh = mesh_shape(mesh)
    axes = set(mesh.axis_names)
    for axis in (data_axis, seq_axis, model_axis):
        if axis is not None and axis not in axes and axis in bound:
            log.warning(
                "mesh %s lacks axis %r which this model is built for — "
                "the axis is dropped and its layers run replicated/"
                "degraded; pass a mesh with a %r axis or rebuild the "
                "model without it", tuple(mesh.axis_names), axis, axis)
    return (data_axis if data_axis in axes else None,
            seq_axis if seq_axis in axes else None,
            model_axis if model_axis in axes else None)


def _check_moe(model, mesh, data_axis, seq_axis):
    """Expert-parallel constraints, checked at build time: every bound
    ``MoEFFN`` rides the mesh's data axis and divides its experts over
    it; on a >1 seq mesh it carries the seq axis in ``stat_axes``."""
    from .moe import MoEFFN

    mesh = mesh_shape(mesh)
    moe = [m for m in model.modules_iter()
           if isinstance(m, MoEFFN) and getattr(m, "axis_name", None)]
    for m in moe:
        if m.axis_name not in mesh.axis_names:
            raise ValueError(
                f"MoEFFN is bound to mesh axis {m.axis_name!r} which the "
                f"mesh {mesh.axis_names} does not have; build with "
                "axis_name=None for dense (single-shard) MoE")
        if m.axis_name != data_axis:
            raise ValueError(
                f"expert parallelism rides the token-sharding axis: "
                f"MoEFFN.axis_name {m.axis_name!r} must equal the data "
                f"axis {data_axis!r}")
        if mesh.shape[m.axis_name] > 1 and m.n_experts % mesh.shape[
                m.axis_name] != 0:
            raise ValueError(
                f"n_experts {m.n_experts} not divisible by the "
                f"{m.axis_name!r} axis size {mesh.shape[m.axis_name]}")
        if (seq_axis is not None and mesh.shape[seq_axis] > 1
                and seq_axis not in m.stat_axes):
            raise ValueError(
                f"MoE on a >1 {seq_axis!r} mesh needs the seq axis in "
                f"MoEFFN.stat_axes (got {m.stat_axes}) so the aux-loss "
                "routing statistics stay global")


def slot_specs(slots, pspecs):
    """Optimizer-state specs: subtrees shaped like the param tree inherit
    the param specs (momentum/Adam moments shard with their params);
    every other leaf (step counters) replicates."""
    return _slot_tree_like(slots, pspecs, P())


def _data_only(mesh, data_axis):
    from .plan import _check_mesh

    if mesh is not None:
        _check_mesh(mesh)
    if data_axis not in (None, "data"):
        raise NotImplementedError(
            f"data_axis {data_axis!r}: the port's data axis is 'data'")


def make_train_step(model, criterion, optim, mesh,
                    data_axis: Optional[str] = "data", compute_dtype=None):
    """The plan step over ``mesh`` (a ``("data",)`` ``DeviceMesh``, or
    None for one device), with the guard and the gradient norm off, as
    the JAX entry point builds it.  Returns ``step(params, slots, lr, x,
    y, weight=None) -> (loss, params, slots)`` over the trees of
    ``step.engine.init_state()`` (``x``/``y`` this rank's rows), with
    ``.param_specs``, ``.slot_specs`` and ``.engine`` attached.  Any
    other axis above 1 raises (ROADMAP Queue 1 item 5d).  The JAX
    entry point's seq, model and donation arguments belong to those
    axes and are not taken."""
    from .plan import compile_step_with_plan

    _data_only(mesh, data_axis)
    eng = compile_step_with_plan(model, criterion, optim, mesh,
                                 compute_dtype=compute_dtype, guard=False,
                                 with_gnorm=False)

    def step(params, slots, lr, x, y, weight=None):
        loss, _ok, slots = eng.step(params, slots, x, y, lr, weight=weight)
        return loss, params, slots

    step.param_specs = eng.param_specs
    step.slot_specs = slot_specs(optim.init_state(model.param_tree()),
                                 eng.param_specs)
    step.engine = eng
    return step


def make_eval_forward(model, mesh, data_axis: Optional[str] = "data",
                      model_axis: Optional[str] = "model",
                      compute_dtype=None):
    """Validation forward over a ``("data",)`` mesh: ``fwd(params,
    buffers, x) -> out`` over this rank's rows (the full parameter tree,
    :meth:`CompiledPlanStep.eval_params`), cast as the training step
    casts.  Any other axis above 1 raises (ROADMAP Queue 1 item 5d); as
    in :func:`make_train_step` the seq arguments are not taken."""
    import torch

    from ..optim.optimizer import cast_floats

    _data_only(mesh, data_axis)

    def fwd(params, buf, x):
        with torch.no_grad():
            p, xx = params, x
            if compute_dtype is not None:
                p, xx = cast_floats(p, compute_dtype), cast_floats(
                    x, compute_dtype)
            out = model.apply_fn(p, xx)
            if compute_dtype is not None:
                out = cast_floats(out, torch.float32)
            return out

    fwd.param_specs = param_specs(model, model_axis or "model")
    return fwd
