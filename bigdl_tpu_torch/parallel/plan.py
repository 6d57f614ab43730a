"""The sharding-plan engine (counterpart of ``bigdl_tpu/parallel/plan.py``)
on the data axis.

Two pieces, as in the JAX package:

* :class:`Plan` — ordered regex rules mapping the param tree's
  ``/``-joined path names to partition specs (:class:`P`).
  :func:`derive_plan` generates the default rule set from module
  introspection (``spmd.param_specs``) plus a replicate catch-all, and
  the FSDP threshold rule shards a large otherwise-replicated parameter
  over the ``data`` axis on its largest divisible dim, gathered on use.
  Each rule also carries a gradient transport (``"dense"`` /
  ``"sparse"``) and a synchrony (``"step"`` / ``"periodic(k)"`` /
  ``"stale(s)"``), so the plan's table, its collective-bytes estimate
  and its sparse and sync sizing are the JAX plan's.  The plan reads
  only axis names and sizes: it binds to a :class:`MeshShape` (a
  ``DeviceMesh``'s dimension names and sizes, or sizes given directly),
  so a ``data=8`` or a ``data=2 × model=4`` plan needs no process group.

* :func:`compile_step_with_plan` — the training step every driver runs
  (:class:`CompiledPlanStep`), here for the flat layout over a
  ``("data",)`` mesh of ``torch.distributed`` ranks, one device each:

  - a replicated leaf's gradient, the loss and, for a full batch, the
    floating buffers ride one flat f32 ``all_reduce(SUM)``, then ``/N``
    (a padded batch's weighted sums stay sums);
  - an FSDP leaf (``[fsdp]`` in the table) is held between steps as
    this rank's shard: rows ``[r·s, (r+1)·s)`` of its data-axis dim,
    the slice the JAX ``NamedSharding`` gives device r, and so are its
    optimizer slots (:func:`slot_specs`' structural rule).  The step
    casts the shard to the compute dtype, then gathers it
    (``all_gather_into_tensor`` along that dim); the gather's backward
    reduce-scatters the compute-dtype cotangent (``reduce_scatter_tensor``,
    SUM), the cast's backward upcasts it, and a full batch divides by N
    (``bigdl_tpu/parallel/plan.py:1392-1431``, ``:1502-1519``);
  - the regularizers' gradient and ``set_scale_w``/``set_scale_b``
    apply after the reduction; the gradient norm adds each leaf's sum of
    squares and all-reduces the sharded group's only; the guard's finite
    check covers the shards and is agreed by ``all_reduce(MIN)``; the
    optimizer steps on the shards.

  One rank, or a model with no data axis (``LocalOptimizer``), runs the
  single-device step of the JAX package (``plan.py:1217-1235``): no
  collective, and FSDP cleared, as it is a no-op over one device.

The module's own parameters: a replicated leaf IS the module's
parameter, written in place each step.  An FSDP leaf's parameter gives
up its storage while the loop runs (its shard is the truth) and gets the
gathered tensor back from :meth:`CompiledPlanStep.sync_to_model`, at a
checkpoint and at the end of the loop.  A loop that raises leaves it
NaN, for a resume from a checkpoint to overwrite.

Not ported, and refused when engaged: the sparse gradient transport and
relaxed synchrony (ROADMAP Queue 1 item 5c), the ``model``, ``seq`` and
``pipe`` axes and the pipeline layout (item 5d).
"""
from __future__ import annotations

import logging
import re
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

log = logging.getLogger("bigdl_tpu_torch")

__all__ = ["P", "MeshShape", "mesh_shape", "Rule", "Plan", "TRANSPORTS",
           "SYNCS", "derive_plan", "named_leaves", "match_partition_rules",
           "compile_step_with_plan", "CompiledPlanStep", "spec_table"]


# ---------------------------------------------------------------------------
# partition specs and mesh shapes
# ---------------------------------------------------------------------------

class P(tuple):
    """A partition spec: one entry a dim, each an axis name, ``None``
    (not sharded) or a tuple of axis names (``jax.sharding.PartitionSpec``
    in the JAX package).  Equality is the tuple's: ``P(None) != P()``,
    as the JAX spec compares."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return "P" + (tuple.__repr__(self) if len(self) != 1
                      else f"({self[0]!r})")


class MeshShape:
    """The axis names and sizes a :class:`Plan` binds to: ``MeshShape(
    data=8)``, ``MeshShape(data=2, model=4)`` or :func:`mesh_shape` of a
    ``DeviceMesh``.  ``axis_names`` keeps the given order; ``shape`` maps
    each name to its size."""

    def __init__(self, *pairs, **sizes):
        items = list(pairs[0].items()) if pairs else list(sizes.items())
        self.axis_names: Tuple[str, ...] = tuple(str(k) for k, _ in items)
        self.shape: Dict[str, int] = {str(k): int(v) for k, v in items}

    @property
    def size(self) -> int:
        return int(np.prod(list(self.shape.values()) or [1]))

    def __eq__(self, other):
        return isinstance(other, MeshShape) and \
            list(self.shape.items()) == list(other.shape.items())

    def __hash__(self):
        return hash(tuple(self.shape.items()))

    def __repr__(self):
        return "MeshShape(" + ", ".join(
            f"{k}={v}" for k, v in self.shape.items()) + ")"


def mesh_shape(mesh) -> Optional[MeshShape]:
    """The :class:`MeshShape` of ``mesh``: a ``MeshShape`` itself, a
    mapping of axis name to size, or a ``DeviceMesh`` (its
    ``mesh_dim_names`` and ``mesh.shape``); None stays None."""
    if mesh is None or isinstance(mesh, MeshShape):
        return mesh
    if isinstance(mesh, dict):
        return MeshShape(mesh)
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    sizes = tuple(int(s) for s in mesh.mesh.shape)
    if len(names) != len(sizes):
        raise ValueError(f"mesh {mesh} has no dimension names")
    return MeshShape(dict(zip(names, sizes)))


# ---------------------------------------------------------------------------
# path-named tree traversal
# ---------------------------------------------------------------------------

def named_leaves(tree, sep: str = "/", is_leaf=None):
    """``(name, leaf)`` with dict keys / sequence indices / NamedTuple
    fields joined by ``sep`` — the names the regex rules match against."""
    out = []

    def rec(node, prefix):
        if (is_leaf is not None and is_leaf(node)) or isinstance(node, P):
            out.append((sep.join(prefix), node))
        elif isinstance(node, dict):
            for k in node:
                rec(node[k], prefix + (str(k),))
        elif isinstance(node, tuple) and hasattr(node, "_fields"):
            for k, v in zip(node._fields, node):
                rec(v, prefix + (str(k),))
        elif isinstance(node, (tuple, list)):
            for i, v in enumerate(node):
                rec(v, prefix + (str(i),))
        else:
            out.append((sep.join(prefix), node))

    rec(tree, ())
    return out


def _map_named(fn, tree, sep: str = "/", is_leaf=None):
    """Structure-preserving map of ``fn(name, leaf)`` over ``tree``."""
    def rec(node, prefix):
        if (is_leaf is not None and is_leaf(node)) or isinstance(node, P):
            return fn(sep.join(prefix), node)
        if isinstance(node, dict):
            return {k: rec(node[k], prefix + (str(k),)) for k in node}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(rec(v, prefix + (str(k),))
                                for k, v in zip(node._fields, node)))
        if isinstance(node, (tuple, list)):
            return type(node)(rec(v, prefix + (str(i),))
                              for i, v in enumerate(node))
        return fn(sep.join(prefix), node)

    return rec(tree, ())


def _structure(tree):
    """A hashable description of a tree's nesting (the pytree treedef:
    dict keys sorted, sequences by type and length, ``P`` a leaf)."""
    if isinstance(tree, P):
        return "*"
    if isinstance(tree, dict):
        return ("dict", tuple((k, _structure(tree[k])) for k in sorted(tree)))
    if isinstance(tree, (tuple, list)):
        return (type(tree).__name__, tuple(_structure(v) for v in tree))
    return "*"


def _slot_tree_like(slots, per_param, default):
    """:func:`spmd.slot_specs`' structural rule for any per-param
    annotation tree: slot subtrees structured like the param tree
    inherit ``per_param`` (momentum/Adam moments follow their params);
    everything else (step counters) gets ``default``."""
    want = _structure(per_param)

    def rec(s):
        if _structure(s) == want:
            return per_param
        if isinstance(s, dict):
            return {k: rec(v) for k, v in s.items()}
        if isinstance(s, tuple) and hasattr(s, "_fields"):
            return type(s)(*(rec(v) for v in s))
        if isinstance(s, (tuple, list)):
            return type(s)(rec(v) for v in s)
        return default

    return rec(slots)


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(int(d) for d in (getattr(leaf, "shape", ()) or ()))


def _itemsize(leaf) -> int:
    if torch.is_tensor(leaf):
        return leaf.element_size()
    return np.dtype(getattr(leaf, "dtype", np.float32)).itemsize


def _nbytes(leaf) -> float:
    return float(int(np.prod(_shape(leaf) or (1,))) * _itemsize(leaf))


# ---------------------------------------------------------------------------
# rules + plan
# ---------------------------------------------------------------------------

#: gradient-transport vocabulary a :class:`Rule` may carry: "dense" =
#: the all-reduce; "sparse" = ``(row_indices, row_values)`` over the
#: data axis (Parallax, arxiv 1808.02621).  Anything else is rejected at
#: plan construction.  The port plans the sparse wire and refuses to
#: train it (ROADMAP Queue 1 item 5c).
TRANSPORTS = ("dense", "sparse")

#: synchrony vocabulary a :class:`Rule` may carry: ``"step"`` = lockstep;
#: ``"periodic(k)"`` = local SGD averaging every k steps; ``"stale(s)"``
#: = bounded-staleness sparse updates.  The port plans the relaxed ones
#: and refuses to train them (ROADMAP Queue 1 item 5c).
SYNCS = ("step", "periodic(k)", "stale(s)")

_SYNC_RE = re.compile(r"^(?:step|periodic\((\d+)\)|stale\((\d+)\))$")

#: (table name, mesh shape) pairs whose degrade-to-replica warning has
#: already fired (cleared wholesale at capacity)
_WARNED_REPLICA_TABLES: set = set()


def _parse_sync(sync: str):
    """``"step" | "periodic(k)" | "stale(s)"`` -> ``(kind, n)``; raises
    on anything outside the :data:`SYNCS` vocabulary."""
    m = _SYNC_RE.match(str(sync))
    if m is None:
        raise ValueError(
            f"unknown synchrony {sync!r} — expected one of {SYNCS} "
            "(docs/distributed.md \"Synchrony\")")
    if m.group(1) is not None:
        k = int(m.group(1))
        if k < 1:
            raise ValueError(f"periodic({k}) needs a period >= 1")
        return ("periodic", k)
    if m.group(2) is not None:
        s = int(m.group(2))
        if s < 1:
            raise ValueError(f"stale({s}) needs a staleness bound >= 1")
        return ("stale", s)
    return ("step", 0)


class Rule(NamedTuple):
    """One ordered partition rule: the first ``re.search`` match wins.

    ``spec`` is the leaf's :class:`P`; ``fsdp=True`` marks the rule's
    leaves for data-axis sharding with gather-on-use; ``reason`` says
    where the rule came from ("introspection", "fsdp", "user",
    "default"); ``transport`` and ``sync`` pick the gradient wire and the
    synchrony (:data:`TRANSPORTS`, :data:`SYNCS`)."""

    pattern: str
    spec: P
    fsdp: bool = False
    reason: str = ""
    transport: str = "dense"
    sync: str = "step"


class _Entry(NamedTuple):
    spec: P
    fsdp: bool
    rule: Optional[Rule]
    transport: str = "dense"
    sync: str = "step"


def _is_entry(x) -> bool:
    return isinstance(x, _Entry)


def _spec_axes(spec) -> Tuple[str, ...]:
    axes = []
    for part in spec:
        if part is None:
            continue
        for a in (part if isinstance(part, tuple) else (part,)):
            axes.append(a)
    return tuple(axes)


def match_partition_rules(rules: Sequence[Rule], tree, sep: str = "/"):
    """Tree of specs for ``tree`` under the ordered rules.  Scalar and
    single-element leaves are never partitioned; an unmatched name
    raises — append a catch-all ``Rule(".*", P())`` for permissive
    plans."""
    plan = Plan(rules)
    return _map_named(lambda _, e: e.spec, plan.entries(tree, sep=sep),
                      is_leaf=_is_entry)


class Plan:
    """Ordered regex partition rules over param-tree path names.

    Mesh-shape-agnostic until bound: rules name axes
    (``data``/``seq``/``model``/``pipe``); :meth:`bind` resolves them
    against a mesh shape (axes it lacks degrade to replication, with a
    warning; FSDP rules learn the data axis' size for divisibility)."""

    def __init__(self, rules: Sequence[Rule], *, mesh=None,
                 fsdp_min_bytes: Optional[int] = None,
                 data_axis: str = "data",
                 sparse_density: Optional[float] = None):
        self.rules = tuple(Rule(*r) for r in rules)
        for r in self.rules:
            if r.transport not in TRANSPORTS:
                raise ValueError(
                    f"rule {r.pattern!r} names unknown gradient "
                    f"transport {r.transport!r} — expected one of "
                    f"{TRANSPORTS}")
            if r.transport == "sparse" and r.fsdp:
                raise ValueError(
                    f"rule {r.pattern!r} combines transport='sparse' "
                    "with fsdp=True — FSDP gradients already ride the "
                    "gather's reduce-scatter transpose; sparse "
                    "transport applies to data-replicated tables only")
            kind, _ = _parse_sync(r.sync)  # rejects unknown values
            if kind != "step" and r.fsdp:
                raise ValueError(
                    f"rule {r.pattern!r} combines sync={r.sync!r} with "
                    "fsdp=True — an FSDP leaf has exactly one copy "
                    "sharded over the data axis, so there are no "
                    "replicas to run local SGD on; relaxed synchrony "
                    "applies to data-replicated leaves only")
            if kind == "stale" and r.transport != "sparse":
                raise ValueError(
                    f"rule {r.pattern!r} asks for sync={r.sync!r} on "
                    f"transport={r.transport!r} — stale(s) is the "
                    "bounded-staleness SPARSE update path (Parallax); "
                    "use sync='periodic(k)' for dense leaves")
        self.mesh = mesh_shape(mesh)
        self.fsdp_min_bytes = fsdp_min_bytes
        self.data_axis = data_axis
        if sparse_density is None:
            from ..utils.engine import get_property

            sparse_density = float(get_property(
                "bigdl.sparse.density", 1.0 / 16))
        if not 0.0 < float(sparse_density) <= 1.0:
            raise ValueError(
                f"sparse_density must be in (0, 1], got {sparse_density}")
        self.sparse_density = float(sparse_density)

    # -- binding ---------------------------------------------------------
    def bind(self, mesh) -> "Plan":
        return Plan(self.rules, mesh=mesh,
                    fsdp_min_bytes=self.fsdp_min_bytes,
                    data_axis=self.data_axis,
                    sparse_density=self.sparse_density)

    def _mesh_size(self, axis: Optional[str]) -> int:
        if self.mesh is None or axis is None:
            return 1
        return int(self.mesh.shape.get(axis, 1))

    def _degrade(self, spec: P) -> P:
        """Drop axes the bound mesh lacks (size-1 axes stay — they are
        valid spec entries)."""
        if self.mesh is None:
            return spec
        names = set(self.mesh.axis_names)

        def part(p):
            if p is None:
                return None
            if isinstance(p, tuple):
                kept = tuple(a for a in p if a in names)
                return kept if kept else None
            return p if p in names else None

        out = tuple(part(p) for p in spec)
        dropped = set(_spec_axes(spec)) - set(_spec_axes(P(*out)))
        if dropped:
            log.warning(
                "sharding plan: axis %s not in mesh %s — the rule's "
                "leaves run replicated over the missing axis (check the "
                "mesh shape if this model was built for it)",
                sorted(dropped), tuple(self.mesh.axis_names))
        return P(*out)

    # -- matching --------------------------------------------------------
    def entry_for(self, name: str, leaf) -> _Entry:
        shape = _shape(leaf)
        if len(shape) == 0 or int(np.prod(shape)) == 1:
            return _Entry(P(), False, None)  # never partition scalars
        for rule in self.rules:
            if re.search(rule.pattern, name) is None:
                continue
            spec = self._degrade(rule.spec)
            if rule.transport == "sparse" and not self._fits(spec, shape):
                # a sharded table whose rows stop dividing falls back to
                # a full replica; warned once per (table, mesh)
                key = (name,
                       tuple(sorted(self.mesh.shape.items()))
                       if self.mesh is not None else None)
                if key not in _WARNED_REPLICA_TABLES:
                    if len(_WARNED_REPLICA_TABLES) >= 1024:
                        _WARNED_REPLICA_TABLES.clear()
                    _WARNED_REPLICA_TABLES.add(key)
                    log.warning(
                        "sharding plan: %s (%s) does not divide over "
                        "spec %s — the table runs replicated (sparse "
                        "transport still applies to its gradient)",
                        name, shape, _spec_str(spec))
                spec = self._strip_unfit(spec, shape)
            fsdp = rule.fsdp and self.data_axis in _spec_axes(spec)
            if fsdp and not self._fits(spec, shape):
                spec = P(*(self._strip_data(p) for p in spec))
                fsdp = False
            sync = self._effective_sync(name, rule.sync, spec)
            if not fsdp and rule.transport != "sparse" and sync == "step":
                # sparse and relaxed leaves keep their replica; any other
                # leaf may be claimed by the FSDP threshold rule
                spec = self._maybe_auto_fsdp(spec, leaf)
                fsdp = self.data_axis in _spec_axes(spec) and \
                    spec != self._degrade(rule.spec)
                if fsdp:
                    return _Entry(spec, True, rule, "dense", "step")
            return _Entry(spec, fsdp, rule, rule.transport, sync)
        raise ValueError(
            f"no partition rule matched param {name!r} — append a "
            "catch-all Rule('.*', P()) for replicate-by-default plans")

    def _effective_sync(self, name: str, sync: str, spec: P) -> str:
        """A leaf sharded over the data axis has one copy of each
        element: ``periodic``/``stale`` degrade to ``"step"`` with a
        warning."""
        kind, _ = _parse_sync(sync)
        if kind == "step":
            return "step"
        if self.data_axis in _spec_axes(spec):
            log.warning(
                "sharding plan: %s asks for sync=%r but is sharded "
                "over the data axis (%s) — each element has exactly "
                "one copy, so the leaf runs sync='step' (relaxed "
                "synchrony applies to data-replicated leaves)",
                name, sync, _spec_str(spec))
            return "step"
        return sync

    def _strip_unfit(self, spec: P, shape) -> P:
        """Drop every spec dim whose combined axis size does not divide
        the dim extent."""
        parts = []
        for dim, part in enumerate(spec):
            if part is None or dim >= len(shape):
                parts.append(part)
                continue
            n = 1
            for a in (part if isinstance(part, tuple) else (part,)):
                n *= self._mesh_size(a)
            parts.append(part if n <= 1 or shape[dim] % n == 0 else None)
        while parts and parts[-1] is None:  # P(None) == P() (cosmetic)
            parts.pop()
        return P(*parts)

    def _strip_data(self, part):
        if part == self.data_axis:
            return None
        if isinstance(part, tuple):
            kept = tuple(a for a in part if a != self.data_axis)
            return kept if kept else None
        return part

    def _fits(self, spec: P, shape) -> bool:
        """Every sharded dim extent divides its axes' total size."""
        if self.mesh is None:
            return True
        for dim, part in enumerate(spec):
            if part is None or dim >= len(shape):
                continue
            n = 1
            for a in (part if isinstance(part, tuple) else (part,)):
                n *= self._mesh_size(a)
            if n > 1 and shape[dim] % n != 0:
                return False
        return True

    def _maybe_auto_fsdp(self, spec: P, leaf) -> P:
        """FSDP threshold rule: a leaf of at least ``fsdp_min_bytes``
        left replicated over the data axis gets its largest free dim
        that divides by the axis sharded over it."""
        if self.fsdp_min_bytes is None:
            return spec
        n_data = self._mesh_size(self.data_axis)
        if n_data <= 1 or self.data_axis in _spec_axes(spec):
            return spec
        shape = _shape(leaf)
        nbytes = int(np.prod(shape)) * _itemsize(leaf)
        if nbytes < self.fsdp_min_bytes:
            return spec
        parts = list(spec) + [None] * (len(shape) - len(spec))
        best = None
        for dim, ext in enumerate(shape):
            if parts[dim] is not None or ext % n_data != 0:
                continue
            if best is None or ext > shape[best]:
                best = dim
        if best is None:
            return spec  # no divisible free dim — stays replicated
        parts[best] = self.data_axis
        return P(*parts)

    def entries(self, tree, sep: str = "/"):
        return _map_named(lambda n, leaf: self.entry_for(n, leaf), tree,
                          sep=sep)

    def _field(self, tree, field: str):
        return _map_named(lambda _, e: getattr(e, field),
                          self.entries(tree), is_leaf=_is_entry)

    def param_specs(self, tree):
        return self._field(tree, "spec")

    def fsdp_tree(self, tree):
        return self._field(tree, "fsdp")

    def has_fsdp(self, tree) -> bool:
        return any(v for _, v in named_leaves(self.fsdp_tree(tree)))

    def transport_tree(self, tree):
        """Per-leaf gradient transport (``"dense"``/``"sparse"``)."""
        return self._field(tree, "transport")

    def has_sparse(self, tree) -> bool:
        return any(t == "sparse"
                   for _, t in named_leaves(self.transport_tree(tree)))

    def sync_tree(self, tree):
        """Per-leaf effective synchrony."""
        return self._field(tree, "sync")

    def has_relaxed(self, tree) -> bool:
        """True when any leaf's effective sync is not ``"step"``."""
        return any(s != "step"
                   for _, s in named_leaves(self.sync_tree(tree)))

    def named_entries(self, tree):
        return named_leaves(self.entries(tree), is_leaf=_is_entry)

    def table(self, tree) -> dict:
        """``{path name: "spec | transport | sync [markers]"}`` — the
        golden-test view (``tests/fixtures/plan_*.json``)."""
        return {name: (_spec_str(e.spec) + " | " + e.transport
                       + " | " + e.sync
                       + (" [fsdp]" if e.fsdp else ""))
                for name, e in self.named_entries(tree)}

    # -- sparse-transport sizing ----------------------------------------
    def sparse_budget(self, leaf) -> int:
        """(index, row) slots one shard ships per step for a
        sparse-transport leaf: ``ceil(rows * sparse_density)``."""
        rows = int(_shape(leaf)[0])
        return max(1, int(np.ceil(rows * self.sparse_density)))

    _INDEX_BYTES = 4  # int32 row ids on the wire

    def _row_bytes(self, leaf) -> float:
        shape = _shape(leaf)
        width = int(np.prod(shape[1:])) if len(shape) > 1 else 1
        return float(width * _itemsize(leaf))

    def sparse_wire_bytes(self, leaf) -> float:
        """Bytes the sparse exchange moves a step: every shard
        all-gathers its K ``(int32 index, row)`` pairs to the n_d - 1
        peers."""
        n_d = self._mesh_size(self.data_axis)
        k = self.sparse_budget(leaf)
        return (n_d - 1) * k * (self._row_bytes(leaf) + self._INDEX_BYTES)

    def _dense_data_wire(self, leaf, local_bytes: float) -> float:
        """The dense comparator: all-reduce of the leaf's local slice
        over the data axis (reduce-scatter + all-gather ring)."""
        n_d = self._mesh_size(self.data_axis)
        if n_d <= 1:
            return 0.0
        return 2.0 * (n_d - 1) / n_d * local_bytes

    def _local_bytes(self, leaf, spec) -> float:
        shard_n = 1
        for a in _spec_axes(spec):
            shard_n *= self._mesh_size(a)
        return _nbytes(leaf) / max(shard_n, 1)

    def sparse_engaged(self, leaf, entry: _Entry) -> bool:
        """The density-threshold fallback: the sparse wire is taken only
        for a data-replicated leaf whose budgeted bytes beat the dense
        all-reduce."""
        if entry.transport != "sparse" or entry.fsdp:
            return False
        if _parse_sync(entry.sync)[0] == "periodic":
            return False
        if self.data_axis in _spec_axes(entry.spec):
            return False
        if self._mesh_size(self.data_axis) <= 1:
            return False
        if len(_shape(leaf)) < 1:
            return False
        return self.sparse_wire_bytes(leaf) < self._dense_data_wire(
            leaf, self._local_bytes(leaf, entry.spec))

    def _other_axes_wire(self, axes, sharded, local) -> float:
        r = 1
        for a in axes:
            if a not in sharded and a != self.data_axis:
                r *= self._mesh_size(a)
        return 2.0 * (r - 1) / r * local if r > 1 else 0.0

    # -- collective accounting -------------------------------------------
    def collective_bytes(self, tree) -> float:
        """Estimated collective wire bytes ONE training step moves for
        this plan's parameter/gradient traffic (the telemetry
        ``bigdl_perf_collective_bytes`` gauge), per leaf in its own
        dtype: an FSDP leaf ``2(n_d-1)/n_d × full bytes`` (gather plus
        reduce-scatter) plus the slice's all-reduce over any other
        replicated axes; a dense leaf ``2(R-1)/R × local slice bytes``
        over the axes it is replicated on; an engaged sparse leaf its
        index+value wire; a ``periodic(k)`` leaf the averaging ring over
        k.  Neither the loss nor the buffers are counted."""
        if self.mesh is None:
            return 0.0
        axes = [a for a in self.mesh.axis_names if self._mesh_size(a) > 1]
        total = 0.0
        leaves = dict(named_leaves(tree))
        for name, entry in self.named_entries(tree):
            leaf = leaves[name]
            sharded = set(_spec_axes(entry.spec))
            local = self._local_bytes(leaf, entry.spec)
            if entry.fsdp:
                n_d = self._mesh_size(self.data_axis)
                total += 2.0 * (n_d - 1) / n_d * _nbytes(leaf)
                total += self._other_axes_wire(axes, sharded, local)
            elif self.sparse_engaged(leaf, entry):
                total += self.sparse_wire_bytes(leaf)
                total += self._other_axes_wire(axes, sharded, local)
            elif _parse_sync(entry.sync)[0] == "periodic" \
                    and self.data_axis in axes \
                    and self.data_axis not in sharded:
                k = _parse_sync(entry.sync)[1]
                total += self._dense_data_wire(leaf, local) / k
                total += self._other_axes_wire(axes, sharded, local)
            else:
                r = 1
                for a in axes:
                    if a not in sharded:
                        r *= self._mesh_size(a)
                if r > 1:
                    total += 2.0 * (r - 1) / r * local
        return total

    def sparse_bytes_saved(self, tree) -> float:
        """Wire bytes a step does NOT move because sparse transport
        replaced the dense all-reduce (per engaged leaf)."""
        if self.mesh is None:
            return 0.0
        saved = 0.0
        leaves = dict(named_leaves(tree))
        for name, entry in self.named_entries(tree):
            leaf = leaves[name]
            if not self.sparse_engaged(leaf, entry):
                continue
            saved += self._dense_data_wire(
                leaf, self._local_bytes(leaf, entry.spec)) \
                - self.sparse_wire_bytes(leaf)
        return saved

    def sync_bytes_saved(self, tree) -> float:
        """Wire bytes a step does NOT move because ``periodic(k)``
        replaced the lockstep data-axis reduction."""
        if self.mesh is None:
            return 0.0
        saved = 0.0
        leaves = dict(named_leaves(tree))
        for name, entry in self.named_entries(tree):
            kind, k = _parse_sync(entry.sync)
            if kind != "periodic":
                continue
            if self.data_axis in _spec_axes(entry.spec) or entry.fsdp:
                continue
            if self._mesh_size(self.data_axis) <= 1:
                continue
            leaf = leaves[name]
            dense = self._dense_data_wire(
                leaf, self._local_bytes(leaf, entry.spec))
            step_entry = entry._replace(sync="step")
            step_wire = (self.sparse_wire_bytes(leaf)
                         if self.sparse_engaged(leaf, step_entry)
                         else dense)
            saved += max(0.0, step_wire - dense / k)
        return saved


def _spec_str(spec: P) -> str:
    if not tuple(spec):
        return "replicated"

    def part(p):
        if p is None:
            return "-"
        if isinstance(p, tuple):
            return "(" + ",".join(p) + ")"
        return str(p)

    return "(" + ", ".join(part(p) for p in spec) + ")"


def spec_table(specs) -> dict:
    """``{path name: spec string}`` for a plain spec tree."""
    return {name: _spec_str(s) for name, s in named_leaves(specs)}


# ---------------------------------------------------------------------------
# default rule derivation (module introspection)
# ---------------------------------------------------------------------------

def _sparse_param_info(module, prefix=()):
    """'/'-joined param-tree names whose owning module opted into sparse
    gradient transport (``sparse_grads = True``), mapped to the module's
    own ``sync_staleness`` override.  No module of the port sets it yet
    (``ShardedEmbedding`` is ROADMAP Queue 1 item 10)."""
    from ..nn.module import Container

    out = {}
    if getattr(module, "sparse_grads", False):
        stale = getattr(module, "sync_staleness", None)
        for name, _ in named_leaves(module.param_tree()):
            out["/".join(prefix + (name,)) if name
                else "/".join(prefix)] = stale
    elif isinstance(module, Container):
        for key, child in module.named_children():
            out.update(_sparse_param_info(child, prefix + (str(key),)))
    return out


def derive_plan(model, mesh, *, model_axis: Optional[str] = "model",
                pipe_axis: Optional[str] = None,
                n_pipe: Optional[int] = None,
                fsdp_min_bytes: Optional[int] = None,
                sparse_density: Optional[float] = None,
                sync_period: Optional[int] = None,
                sync_staleness: Optional[int] = None,
                extra_rules: Sequence[Rule] = ()) -> Plan:
    """The default :class:`Plan` for ``model`` on ``mesh`` (a
    ``DeviceMesh``, a :class:`MeshShape` or a mapping of axis sizes).

    Module introspection (``spmd.param_specs``) generates one exact-path
    rule per non-replicated or sparse parameter plus a replicate
    catch-all; ``extra_rules`` go first; ``fsdp_min_bytes`` arms the
    FSDP threshold rule; ``sparse_grads`` modules' rules are stamped
    ``transport="sparse"`` and, when replicated, take ``stale(s)`` or
    ``periodic(k)`` from ``sync_staleness``/``sync_period`` (the
    ``bigdl.sync.*`` properties by default), as the JAX plan does.  The
    pipeline layout (``pipe_axis``) is ROADMAP Queue 1 item 5d."""
    from ..utils.engine import get_property
    from .spmd import param_specs as module_specs

    mesh = mesh_shape(mesh)
    if sync_period is None:
        _sp = get_property("bigdl.sync.period")
        sync_period = int(_sp) if _sp else None
    if sync_staleness is None:
        _ss = get_property("bigdl.sync.staleness")
        sync_staleness = int(_ss) if _ss else None
    model_axis = (model_axis if model_axis is not None
                  and model_axis in mesh.axis_names else None)
    rules = list(extra_rules)
    sparse_info = _sparse_param_info(model)
    sparse_names = set(sparse_info)
    if pipe_axis is not None:
        raise NotImplementedError(
            "the pipeline layout (derive_plan(pipe_axis=...), "
            "pack_params) is not ported to bigdl_tpu_torch yet (ROADMAP "
            "Queue 1 item 5d)")
    spec_tree = module_specs(model, model_axis)
    for name, spec in named_leaves(spec_tree):
        if not isinstance(spec, P):
            continue
        transport = "sparse" if name in sparse_names else "dense"
        sync = "step"
        if transport == "sparse" and not tuple(spec):
            stale = sparse_info.get(name) or sync_staleness
            if stale:
                sync = f"stale({int(stale)})"
            elif sync_period:
                sync = f"periodic({int(sync_period)})"
        if tuple(spec) or transport == "sparse":
            rules.append(Rule("^" + re.escape(name) + "$", spec,
                              reason="introspection",
                              transport=transport, sync=sync))
    rules.append(Rule(".*", P(), reason="default"))
    return Plan(rules, mesh=mesh, fsdp_min_bytes=fsdp_min_bytes,
                sparse_density=sparse_density)


# ---------------------------------------------------------------------------
# gather-on-use over torch.distributed
# ---------------------------------------------------------------------------

def _all_gather(shard: torch.Tensor, dim: int, n: int, group):
    """The full tensor from every rank's ``shard`` along ``dim`` (rank
    order)."""
    import torch.distributed as dist

    src = shard.movedim(dim, 0).contiguous()
    out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=group)
    return out.movedim(0, dim).contiguous()


def _reduce_scatter(full: torch.Tensor, dim: int, n: int, group):
    """This rank's rows along ``dim`` of the sum over ranks of ``full``."""
    import torch.distributed as dist

    src = full.movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
    dist.reduce_scatter_tensor(out, src, op=dist.ReduceOp.SUM, group=group)
    return out.movedim(0, dim).contiguous()


class _GatherOnUse(torch.autograd.Function):
    """Forward: the all-gather of an FSDP shard; backward: the
    reduce-scatter (SUM) of the cotangent, in its own dtype — ZeRO-3's
    wire, the transpose JAX's ``lax.all_gather`` gets from AD."""

    @staticmethod
    def forward(ctx, shard, dim, n, group):
        ctx.dim, ctx.n, ctx.group = dim, n, group
        return _all_gather(shard, dim, n, group)

    @staticmethod
    def backward(ctx, grad):
        return _reduce_scatter(grad, ctx.dim, ctx.n, ctx.group), None, \
            None, None


def _data_dim(spec: P, axis: str) -> int:
    return next(i for i, part in enumerate(spec)
                if part is not None and axis in
                ((part,) if not isinstance(part, tuple) else part))


# ---------------------------------------------------------------------------
# the training step
# ---------------------------------------------------------------------------

class CompiledPlanStep:
    """The step every driver loop runs (``bigdl_tpu/parallel/plan.py``'s
    ``CompiledPlanStep``, flat layout, data axis): :meth:`init_state`
    gives the loop its parameter and slot trees (FSDP leaves as this
    rank's shards), :meth:`step` trains one batch, :meth:`sync_to_model`
    writes the full trees back, :meth:`eval_params` gives validation the
    full parameters.  Built by :func:`compile_step_with_plan`."""

    def __init__(self, model, criterion, optim, mesh, plan, *,
                 compute_dtype=None, guard=True, with_gnorm=True,
                 single=False):
        from ..utils.tree import tree_leaves

        self.model, self.criterion, self.optim = model, criterion, optim
        self.mesh, self.plan = mesh, plan
        self.compute_dtype, self.guard = compute_dtype, guard
        self.with_gnorm = with_gnorm
        self.single = single
        if single:
            self.group, self.n_data, self.rank = None, 1, 0
        else:
            self.group = mesh.get_group()
            self.n_data = mesh.size()
            self.rank = mesh.get_local_rank()
        host = model.param_tree()
        self.names = [n for n, _ in named_leaves(host)]
        entries = dict(plan.named_entries(host))
        self.param_specs = plan.param_specs(host)
        # FSDP over one device is a no-op; never gather
        self.fsdp_dims = {} if single else {
            n: _data_dim(entries[n].spec, plan.data_axis)
            for n in self.names if entries[n].fsdp}
        self.has_fsdp = bool(self.fsdp_dims)
        self.fsdp_flags = [n in self.fsdp_dims for n in self.names]
        self.collective_bytes = plan.collective_bytes(host)
        self.table = plan.table(host)
        self.total_param_bytes = sum(_nbytes(t) for t in tree_leaves(host))
        self._shapes = {n: tuple(t.shape) for n, t in named_leaves(host)}
        self._released = False
        self.last_grad_norm: Optional[torch.Tensor] = None
        from ..optim.optax_bridge import TorchOptimMethod

        if self.has_fsdp and isinstance(optim, TorchOptimMethod):
            raise NotImplementedError(
                "TorchOptimMethod keeps one state dict a full parameter, "
                "not a slot tree shaped like the parameters, so its state "
                "cannot shard with an FSDP leaf; train it without FSDP")

    # -- state ------------------------------------------------------------
    def _module_params(self) -> Dict[str, torch.Tensor]:
        return dict(named_leaves(self.model.param_tree()))

    def _shard(self, name: str, full: torch.Tensor) -> torch.Tensor:
        dim = self.fsdp_dims[name]
        s = full.shape[dim] // self.n_data
        return full.detach().narrow(dim, self.rank * s, s).clone()

    def init_state(self):
        """(params, slots) for the loop: a replicated leaf is the
        module's own parameter; an FSDP leaf this rank's shard (a copy,
        requiring grad), its module parameter's storage released; the
        slots (the optim method's saved slots when their shapes match a
        fresh init, else fresh) sharded by the structural rule."""
        from ..optim.optimizer import _resume_slots
        from ..utils.tree import tree_map

        live = self.model.param_tree()
        slots = _resume_slots(self.optim, tree_map(torch.Tensor.detach,
                                                   live))
        if not self.has_fsdp:
            return live, slots
        params = _map_named(
            lambda n, t: (self._shard(n, t).requires_grad_(True)
                          if n in self.fsdp_dims else t), live)
        slots = self._map_slots(self._shard, slots, live)
        self.release()
        return params, slots

    def _map_slots(self, fn, slots, params):
        """``fn(param name, slot leaf)`` over the slot leaves that follow
        an FSDP param of ``params`` (the structural rule); every other
        slot leaf passes."""
        names = _map_named(lambda n, _: n, params)
        tagged = _slot_tree_like(slots, names, "")
        by_path = dict(named_leaves(tagged))
        return _map_named(
            lambda path, t: (fn(by_path[path], t)
                             if by_path.get(path) in self.fsdp_dims
                             else t), slots)

    def release(self):
        """Give up the module's storage of every FSDP parameter (its
        shard holds the value while the loop runs)."""
        if not self.has_fsdp or self._released:
            return
        for n, p in self._module_params().items():
            if n in self.fsdp_dims:
                p.data = p.data.new_empty(0)
        self.optim._slots = None  # the full slots a sync left behind
        self._released = True

    def abandon(self) -> bool:
        """After a loop that raised: every released parameter full-size
        again, NaN, and the optim method's slots dropped — the shards are
        gone, a resume overwrites both.  True when a parameter was
        released (its value is lost)."""
        if not self._released:
            return False
        for n, p in self._module_params().items():
            if n in self.fsdp_dims:
                p.data = torch.full(self._shapes[n], float("nan"),
                                    dtype=p.dtype, device=p.device)
        self.optim._slots = None
        self._released = False
        return True

    def _gather(self, name: str, shard: torch.Tensor) -> torch.Tensor:
        return _all_gather(shard.detach(), self.fsdp_dims[name],
                           self.n_data, self.group)

    def eval_params(self, params):
        """The whole parameter tree, for validation and the module: FSDP
        shards gathered (collective: every rank calls it at the same
        point)."""
        if not self.has_fsdp:
            return params
        return _map_named(lambda n, t: (self._gather(n, t)
                                        if n in self.fsdp_dims else t),
                          params)

    def sync_to_model(self, params, slots):
        """The full trees into the module (its FSDP parameters' storage
        back, gathered) and ``optim._slots`` (gathered)."""
        if not self.has_fsdp:
            self.optim._slots = slots
            return
        full = dict(named_leaves(self.eval_params(params)))
        for n, p in self._module_params().items():
            if n in self.fsdp_dims:
                p.data = full[n]
        self._released = False
        self.optim._slots = self._map_slots(self._gather, slots, params)

    def param_bytes_by_device(self, params) -> dict:
        """Bytes of the parameter state this rank holds, by device (an
        FSDP leaf's shard, every other leaf whole)."""
        from ..utils.tree import tree_leaves

        by_dev = {}
        for t in tree_leaves(params):
            key = str(t.device)
            by_dev[key] = by_dev.get(key, 0) + t.numel() * t.element_size()
        return by_dev

    # -- the step ---------------------------------------------------------
    def _gather_fsdp(self, p_c):
        return _map_named(
            lambda n, t: (_GatherOnUse.apply(t, self.fsdp_dims[n],
                                             self.n_data, self.group)
                          if n in self.fsdp_dims else t), p_c)

    def _reduce(self, grads, leaves, loss, buffers, masked: bool):
        """One ``all_reduce(SUM)`` of a flat f32 buffer of the replicated
        leaves' gradients, the loss and, for a full batch, the floating
        buffers (BatchNorm statistics), then ``/N`` for a full batch; an
        FSDP gradient (already summed by the reduce-scatter) ``/N`` for
        a full batch.  A padded batch's weighted gradients and losses
        are sums already (``plan.py:1392-1431``, ``:1612-1626``)."""
        import torch.distributed as dist

        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, leaves)]
        repl = [i for i, f in enumerate(self.fsdp_flags) if not f]
        synced = [] if masked else [b for b in buffers
                                    if b.is_floating_point()]
        parts = [grads[i] for i in repl] + [loss.detach()] + synced
        flat = torch.cat([t.reshape(-1).float() for t in parts])
        dist.all_reduce(flat, group=self.group)
        if not masked:
            flat.div_(self.n_data)
        out, at = [], 0
        for t in parts:
            out.append(flat[at:at + t.numel()].view(t.shape).to(t.dtype))
            at += t.numel()
        for b, v in zip(synced, out[len(repl) + 1:]):
            b.copy_(v)
        for i, g in zip(repl, out):
            grads[i] = g
        if not masked:
            for i, f in enumerate(self.fsdp_flags):
                if f:
                    grads[i] = grads[i] / self.n_data
        return grads, out[len(repl)]

    def _agree(self, ok: torch.Tensor) -> torch.Tensor:
        """The guard's decision, the same on every rank
        (``plan.py:1629-1638``)."""
        import torch.distributed as dist

        flag = ok.to(torch.int32).reshape(1)
        dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=self.group)
        return flag[0] > 0

    def _gnorm(self, grads) -> torch.Tensor:
        """‖global grad‖: the sum of each leaf's squared norm (one
        multi-tensor pass), the FSDP group's all-reduced, the replicated
        group's local (``plan.py:1540-1554``)."""
        import torch.distributed as dist

        total = None
        for sharded in (False, True):
            group = [g for g, f in zip(grads, self.fsdp_flags)
                     if f == sharded]
            if not group:
                continue
            ss = torch.stack(torch._foreach_norm(group)).float().pow(2).sum()
            if sharded:
                ss = ss.reshape(1)
                dist.all_reduce(ss, group=self.group)
                ss = ss[0]
            total = ss if total is None else total + ss
        return torch.zeros(()) if total is None else total.sqrt()

    def step(self, params, slots, x, y, lr: float, reg_paths=(),
             scales=None, weight=None):
        """One training step; returns (loss, ok, new_slots) with loss
        and ok still on the device, the new parameters written into
        ``params`` in place.  ``reg_paths``: the model's regularizers;
        ``scales``: the leaves of its gradient scale tree, or None when
        all are 1.  Over a data axis ``x``/``y`` are this rank's rows;
        ``weight``, for a trailing batch padded to the axis multiple, is
        ``(w, n_real)``: this rank's 1-real/0-pad record weights and the
        global real count."""
        from ..optim.optimizer import _weighted_loss, cast_floats
        from ..optim.regularizer import regularizer_loss
        from ..resilience.guards import tree_finite, where_tree
        from ..utils.tree import tree_leaves, tree_map
        from .moe import capture_aux

        model, crit, dtype = self.model, self.criterion, self.compute_dtype
        axis = not self.single
        masked = weight is not None
        leaves = tree_leaves(params)
        buffers = tree_leaves(model.buffer_tree())
        if self.guard or masked:
            old_buffers = [b.clone() for b in buffers]
        with torch.enable_grad():
            p_c, x_c = params, x
            if dtype is not None:
                p_c, x_c = cast_floats(params, dtype), cast_floats(x, dtype)
            if self.has_fsdp:
                # cast, then gather: the gather moves compute-dtype bytes
                # and its backward reduce-scatters the compute-dtype
                # cotangent before the cast's backward upcasts it
                p_c = self._gather_fsdp(p_c)
            with capture_aux() as aux_terms:
                out = model.apply_fn(p_c, x_c)
            if dtype is not None \
                    and not getattr(crit, "accepts_low_precision", False):
                out = cast_floats(out, torch.float32)
            if masked:
                # each record's loss weighted 1-real/0-pad over the
                # global real count; the ranks' sums add to the mean
                # (bigdl_tpu/parallel/plan.py:1578-1588)
                loss = _weighted_loss(crit, out, y, *weight)
                for coef, aux in aux_terms:
                    loss = loss + coef * aux / self.n_data
            else:
                loss = crit._loss(out, y)
                for coef, aux in aux_terms:
                    loss = loss + coef * aux
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            if axis:
                with torch.no_grad():
                    grads, loss = self._reduce(grads, leaves, loss, buffers,
                                               masked)
            # the penalty on the f32 masters (an FSDP leaf's on its
            # shard), after the reduction over the data axis: each
            # rank's penalty gradient is already its whole one
            reg = regularizer_loss(params, reg_paths)
            if torch.is_tensor(reg):
                reg_g = torch.autograd.grad(reg, leaves, allow_unused=True)
                grads = [r if g is None else g if r is None else g + r
                         for g, r in zip(grads, reg_g)]
                reg = reg.detach()
                if self.has_fsdp:
                    # the logged penalty is the ranks' mean, as the JAX
                    # step's pmean of the loss makes it
                    import torch.distributed as dist

                    reg = reg.reshape(1).clone()
                    dist.all_reduce(reg, group=self.group)
                    reg = reg[0] / self.n_data
                loss = loss + reg
        with torch.no_grad():
            grads = [torch.zeros_like(p) if g is None else g
                     for g, p in zip(grads, leaves)]
            if scales is not None:
                grads = [g if s == 1.0 else g * s
                         for g, s in zip(grads, scales)]
            if self.with_gnorm:
                self.last_grad_norm = self._gnorm(grads)
            it = iter(grads)
            grads = tree_map(lambda _: next(it), params)
            old = tree_map(torch.Tensor.detach, params)
            new_params, new_slots = self.optim.step(grads, old, slots, lr)
            if masked:
                # padded rows would pollute the batch statistics: the
                # trailing batch keeps the buffers from before the step
                for b, b_old in zip(buffers, old_buffers):
                    b.copy_(b_old)
            if self.guard:
                ok = tree_finite(grads) & torch.isfinite(loss)
                if axis:
                    ok = self._agree(ok)
                new_params = where_tree(ok, new_params, old)
                new_slots = where_tree(ok, new_slots, slots)
                for b, b_old in zip(buffers, old_buffers):
                    b.copy_(torch.where(ok, b, b_old))
            else:
                ok = torch.ones((), dtype=torch.bool, device=loss.device)
            for p, n in zip(leaves, tree_leaves(new_params)):
                p.copy_(n)
        return loss.detach(), ok, new_slots


def _check_mesh(mesh):
    """A ``("data",)`` mesh, or raise for the axes not ported yet."""
    shape = mesh_shape(mesh)
    other = {a: n for a, n in shape.shape.items() if a != "data" and n > 1}
    if "pipe" in other:
        raise NotImplementedError(
            f"a mesh with a pipe axis {shape} is not ported to "
            "bigdl_tpu_torch yet (the pipeline layout, ROADMAP Queue 1 "
            "item 5d)")
    if other:
        raise NotImplementedError(
            f"a mesh with axes {other} besides data is not ported to "
            "bigdl_tpu_torch yet (the model and seq axes, ROADMAP Queue 1 "
            "item 5d); the port trains over a ('data',) mesh")
    return shape


def compile_step_with_plan(model, criterion, optim, mesh,
                           plan: Optional[Plan] = None, *,
                           compute_dtype=None, guard: bool = True,
                           with_gnorm: bool = True,
                           fsdp_min_bytes: Optional[int] = None
                           ) -> CompiledPlanStep:
    """The training step of ``model`` over ``mesh`` (a ``("data",)``
    ``DeviceMesh``; None for one device without a process group).

    ``plan`` (re-bound to ``mesh``) or, by default, :func:`derive_plan`
    with ``fsdp_min_bytes``.  One rank, or no mesh, is the single-device
    step: no collective, FSDP cleared.  A plan whose engaged leaves
    carry the sparse transport or a relaxed synchrony raises (ROADMAP
    Queue 1 item 5c)."""
    from .spmd import _check_moe, _resolve_axes, bound_axes

    shape = _check_mesh(mesh) if mesh is not None else MeshShape(data=1)
    d_ax, s_ax, _m_ax = _resolve_axes(shape, "data", "seq", "model",
                                      bound=bound_axes(model))
    single = shape.size == 1 and not bound_axes(model)
    if single:
        d_ax = s_ax = None
    _check_moe(model, shape, d_ax, s_ax)
    if plan is None:
        plan = derive_plan(model, shape, fsdp_min_bytes=fsdp_min_bytes)
    else:
        plan = plan.bind(shape)
    host = model.param_tree()
    if not single:
        if plan.has_sparse(host):
            raise NotImplementedError(
                "the sparse gradient transport (a transport='sparse' rule "
                "on a data axis above 1) is not ported to bigdl_tpu_torch "
                "yet (ROADMAP Queue 1 item 5c)")
        if plan.has_relaxed(host):
            raise NotImplementedError(
                "relaxed synchrony (a sync='periodic(k)'/'stale(s)' rule "
                "on a data axis above 1) is not ported to bigdl_tpu_torch "
                "yet (ROADMAP Queue 1 item 5c)")
    return CompiledPlanStep(model, criterion, optim, mesh, plan,
                            compute_dtype=compute_dtype, guard=guard,
                            with_gnorm=with_gnorm, single=single)
