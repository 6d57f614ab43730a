"""AbstractModule — the layer protocol over ``torch.nn.Module``
(counterpart of ``bigdl_tpu/nn/module.py``).

The JAX package computes every layer as one pure function of an
explicit parameter tree.  The port keeps that shape:

    apply_fn(params, x) -> output

where ``params`` is a nested dict of tensors with the JAX package's
keys (``param_tree()``), and ``forward(x)`` is
``apply_fn(self.param_tree(), x)``.  Subclasses implement
``_compute(params, x)`` — the JAX package's ``_apply``; the name
differs because ``torch.nn.Module._apply`` is PyTorch's own hook that
``.to()`` and ``.cuda()`` run through.  Likewise the JAX package's
``training()`` verb is ``train()`` here: ``training`` is the mode flag
of every ``torch.nn.Module``; and its ``parameters()`` pair of lists is
``weights_and_grads()``: ``parameters()`` stays PyTorch's iterator, which
every torch utility walks.

Parameters and children are registered under the JAX package's keys
(``"weight"``, ``"wq"``, ``"pos"``, children ``"0"``, ``"1"``, …), so a
``state_dict`` key is the JAX ``param_tree()`` path joined with dots.

State (the JAX package's buffer tree, BatchNorm's running statistics)
lives in torch buffers under the JAX keys (``"running_mean"``,
``"running_var"``), float32 whatever the compute dtype: the parameter
tree that ``apply_fn`` takes never holds them, so the bf16 cast of the
training step never reaches them.  A layer with state reads
``self.training`` and, in training mode, updates its buffers in place
under ``torch.no_grad()`` — the JAX ``apply_fn`` returns the new
buffer tree instead.  ``buffer_tree``/``set_buffer_tree`` carry that
state in and out.

**The Torch-style verbs** (reference AbstractModule.scala:213-268):
``forward`` (timed; keeps ``output``), ``backward``,
``update_grad_input``, ``acc_grad_parameters``, ``zero_grad_parameters``
and ``update_parameters``.  The gradient store is each parameter's
``.grad``; ``acc_grad_parameters`` and ``backward`` add to it times the
owning layer's ``scale_w``/``scale_b``.  A verbs ``forward`` in grad
mode keeps autograd's graph where a parameter requires a gradient (with
each float input made a leaf, so the input gradient exists), and
``backward`` with the forward's own input runs autograd over that graph
once, which frees its saved tensors and drops the forward's record: a
verbs step runs one forward.  The graph lives until that ``backward``
or the layer's next forward, as the reference keeps ``output``.  Where
that graph is gone (a second backward, another input,
``update_grad_input``/``acc_grad_parameters``, a forward under
``no_grad`` or of a layer without parameters), ``backward`` replays the
forward from ``inp`` under the generator state the forward drew from
and takes ``torch.autograd.grad`` of the replay — the JAX package's vjp
of a re-run forward under its cached key — with every buffer restored
after the replay.  Either way the dropout masks and RReLU slopes of the
backward are the forward's.

``module(x)`` on an activity is PyTorch's call, not the verbs (on
graph nodes it wires a graph, as the reference's ``__call__`` does;
``nn/graph.py``): the same forward, but it makes no
input a leaf and keeps neither the output nor the graph — only the
generator state, so a later ``backward`` replays the same masks.  A
torch-idiom loop (``crit(model(x)).backward()``) thus computes no input
gradient and holds nothing past the caller's own references.

**Random draws.**  A forward's random layers (Dropout, RReLU, the
transformer block's residual dropout) draw, in a fixed order, from one
``torch.Generator`` on the module's device: the one of an enclosing
``rng_scope(generator)`` (the training loop opens one a step, seeded
from ``utils.rng.next_step_seed``), else one that the forward seeds
from that host stream at its first draw — the JAX package draws a
key from it every forward.  A forward that draws nothing takes nothing
from the host stream.  Never the global RNG.
"""
from __future__ import annotations

import contextlib
import copy
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..utils.table import Table
from ..utils.tree import tree_leaves, tree_map
from .initialization import DEFAULT_FORMAT, InitializationMethod

Activity = Any  # torch.Tensor | Table | list/tuple of activities


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported to bigdl_tpu_torch "
                               f"yet")


# --------------------------------------------------------------------------
# activities: tensors, Tables and lists/tuples of them
# --------------------------------------------------------------------------

def activity_map(fn, x):
    """``fn`` over every tensor of an activity, keeping its structure."""
    if isinstance(x, Table):
        out = Table()
        for k, v in x.items():
            out[k] = activity_map(fn, v)
        return out
    if isinstance(x, (list, tuple)):
        return type(x)(activity_map(fn, v) for v in x)
    if isinstance(x, torch.Tensor):
        return fn(x)
    return x


def activity_leaves(x) -> List[torch.Tensor]:
    """The tensors of an activity, in the order ``activity_map`` visits
    them."""
    out = []
    activity_map(out.append, x)
    return out


def to_activity(x, device: Optional[torch.device] = None):
    """Unwrap the Tensor facade, numpy arrays and Python numbers into
    torch tensors (numpy ones on ``device``) — the JAX package's
    ``to_array`` at the API boundary."""
    from ..tensor.tensor import Tensor

    if isinstance(x, Tensor):
        return x.data
    if isinstance(x, Table):
        out = Table()
        for k, v in x.items():
            out[k] = to_activity(v, device)
        return out
    if isinstance(x, (list, tuple)):
        return type(x)(to_activity(v, device) for v in x)
    if isinstance(x, (np.ndarray, np.generic, float, int)):
        return torch.as_tensor(x, device=device)
    return x


def _is_float(t: torch.Tensor) -> bool:
    return t.is_floating_point() or t.is_complex()


def _grad_leaves(x):
    """x with each float tensor that does not already require a gradient
    replaced by a leaf that does (``detach`` shares storage and strides:
    nothing is copied)."""
    return activity_map(
        lambda t: t.detach().requires_grad_()
        if _is_float(t) and not t.requires_grad else t, x)


# --------------------------------------------------------------------------
# the generator of the forward in progress
# --------------------------------------------------------------------------

_local = threading.local()


class _RngScope:
    """The generator of one forward: explicit, restored from a saved
    state (a replay), or seeded from the host stream at the first draw."""

    def __init__(self, device: torch.device,
                 generator: Optional[torch.Generator] = None,
                 state: Optional[torch.Tensor] = None):
        self.device = device
        self.generator = generator
        self.state = state
        self.initial_state = None

    def get(self) -> torch.Generator:
        if self.generator is None:
            g = torch.Generator(device=self.device)
            if self.state is not None:
                g.set_state(self.state)
            else:
                from ..utils.rng import next_step_seed

                g.manual_seed(next_step_seed())
            self.generator = g
        if self.initial_state is None:
            self.initial_state = self.generator.get_state()
        return self.generator

    def snapshot(self) -> Optional[torch.Tensor]:
        return None if self.generator is None else self.generator.get_state()


@contextlib.contextmanager
def _use(scope: Optional[_RngScope]):
    prev = getattr(_local, "scope", None)
    _local.scope = scope
    try:
        yield scope
    finally:
        _local.scope = prev


@contextlib.contextmanager
def rng_scope(generator: torch.Generator):
    """Every random draw of the forwards run inside comes from
    ``generator``, in the order the forwards make them."""
    with _use(_RngScope(generator.device, generator=generator)) as scope:
        yield scope


def current_generator(device: torch.device) -> torch.Generator:
    """The generator a random layer draws from: the forward's (see
    ``rng_scope``); outside any forward, a fresh one seeded from the
    host stream."""
    scope = getattr(_local, "scope", None)
    if scope is None:
        scope = _RngScope(device)
    return scope.get()


def _graph_nodes(args) -> Optional[Tuple]:
    """The graph nodes of a call's arguments (one node, one list of
    nodes, or several nodes), or None where they are not all nodes."""
    from .graph import ModuleNode

    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        args = tuple(args[0])
    if args and all(isinstance(a, ModuleNode) for a in args):
        return tuple(args)
    return None


class _ForwardRecord:
    """What ``backward`` needs of the last forward: its input, leaves
    and output, whose graph it may run once (None after that, or for a
    ``module(x)`` call), and the generator state its random draws
    started from."""

    __slots__ = ("inp", "leaves", "output", "rng_state")

    def __init__(self, inp, leaves, output, rng_state):
        self.inp, self.leaves, self.output = inp, leaves, output
        self.rng_state = rng_state

    def release(self):
        self.inp = self.leaves = self.output = None


class _ParamBox:
    """A parameter in a pickle: its value and ``requires_grad``
    (``utils.file_io``'s pickler keeps tensors' values only)."""

    def __init__(self, value: torch.Tensor, requires_grad: bool):
        self.value, self.requires_grad = value, requires_grad


class AbstractModule(torch.nn.Module):
    """Base layer.  Subclasses register parameters with
    ``_register_param`` and implement ``_compute(params, x)``."""

    def __init__(self, device: DeviceLike = None):
        super().__init__()
        self._device = resolve_device(device)
        self.output = None
        self.grad_input = None
        self.forward_time = 0.0
        self.backward_time = 0.0
        self.scale_w = 1.0
        self.scale_b = 1.0
        self._init_methods: Dict[str, InitializationMethod] = {}
        self._param_inits: Dict[str, Tuple] = {}
        self._fwd: Optional[_ForwardRecord] = None

    @property
    def device(self) -> torch.device:
        return self._device

    def _register_param(self, name: str, value: torch.Tensor,
                        init: Optional[InitializationMethod] = None,
                        fmt=DEFAULT_FORMAT):
        """Register ``value`` as parameter ``name``; ``init`` (and its
        variable format) is what ``reset`` re-draws it with when no
        ``set_init_method`` overrides it."""
        self.register_parameter(
            name, torch.nn.Parameter(value.to(self._device)))
        if init is not None:
            self._param_inits[name] = (init, fmt)

    def _register_buffer(self, name: str, value: torch.Tensor):
        self.register_buffer(name, value.to(self._device))

    def set_name(self, name: str):
        self.name = name
        return self

    def get_name(self) -> str:
        return getattr(self, "name", None) or type(self).__name__

    # ------------------------------------------------------------------
    # functional core
    # ------------------------------------------------------------------
    def _compute(self, params: Dict, x):
        raise NotImplementedError(
            f"{type(self).__name__} must implement _compute")

    def apply_fn(self, params: Dict, x):
        """The forward over an explicit parameter tree (the cast tree
        of bf16 serving, or ``param_tree()``)."""
        return self._compute(params, x)

    # ------------------------------------------------------------------
    # Torch-style verbs (AbstractModule.scala:213-268)
    # ------------------------------------------------------------------
    def update_output(self, inp: Activity) -> Activity:
        """The forward without the timing: ``apply_fn`` over the live
        parameters, the output kept in ``output``."""
        return self._run(inp, verbs=True)

    def _run(self, inp: Activity, verbs: bool) -> Activity:
        # the last forward's graph goes before this one is built
        self._fwd = self.output = None
        inp = to_activity(inp, self._device)
        outer = getattr(_local, "scope", None)
        scope = outer if outer is not None else _RngScope(self._device)
        start = scope.snapshot()
        # where autograd records the forward anyway (a parameter needs a
        # gradient), a verbs forward makes the float inputs leaves too,
        # so ``backward`` can take the input gradient from this graph
        builds_graph = verbs and torch.is_grad_enabled() and any(
            p.requires_grad for p in self.parameters())
        x = _grad_leaves(inp) if builds_graph else inp
        with _use(scope):
            out = self.apply_fn(self.param_tree(), x)
        state = start if start is not None else scope.initial_state
        if verbs:
            self._fwd = _ForwardRecord(inp, x, out, state)
            self.output = out
        else:
            self._fwd = _ForwardRecord(None, None, None, state)
        return out

    def forward(self, inp: Activity) -> Activity:
        """``update_output`` timed into ``forward_time``.  Run by
        ``module(x)``, it keeps no graph (see ``__call__``)."""
        verbs = not getattr(_local, "torch_call", False)
        _local.torch_call = False
        t0 = time.time()
        out = self._run(inp, verbs)
        self.forward_time += time.time() - t0
        return out

    def __call__(self, *args, **kwargs):
        """``module(node)``, ``module([n1, n2])`` or ``module(n1, n2)``
        with graph nodes wires a graph (``inputs``, as the JAX package's
        ``__call__`` does); anything else is PyTorch's call: ``forward``
        without the verbs' record (no input leaves, no graph or output
        kept)."""
        nodes = _graph_nodes(args)
        if nodes is not None and not kwargs:
            return self.inputs(*nodes)
        _local.torch_call = True
        try:
            return super().__call__(*args, **kwargs)
        finally:
            _local.torch_call = False

    def inputs(self, *nodes):
        """A graph node for this module, fed by ``nodes`` in their order
        (reference ``inputs(...)``, AbstractModule.scala:539)."""
        from .graph import ModuleNode

        node = ModuleNode(self)
        for n in nodes:
            n.add_edge(node)
        return node

    def _replay(self, inp: Activity):
        """Re-run the forward from ``inp`` with autograd on, under the
        generator state the last forward drew from; every buffer is
        restored afterwards, so a replay moves no running statistic."""
        inp = to_activity(inp, self._device)
        state = self._fwd.rng_state if self._fwd is not None else None
        buffers = [b.clone() for b in self.buffers()]
        x = _grad_leaves(inp)
        with torch.enable_grad(), _use(_RngScope(self._device, state=state)):
            out = self.apply_fn(self.param_tree(), x)
        with torch.no_grad():
            for b, saved in zip(self.buffers(), buffers):
                b.copy_(saved)
        return x, out

    def _graph(self, inp: Activity, reuse: bool):
        """(input leaves, output) with a graph to differentiate: the last
        forward's when ``reuse`` and it ran on ``inp`` with grad on and
        was not used yet (the record then lets it go), else a replay."""
        rec = self._fwd
        if (reuse and rec is not None and rec.inp is not None
                and rec.inp is inp
                and any(t.requires_grad
                        for t in activity_leaves(rec.output))
                and all(t.requires_grad for t in activity_leaves(rec.leaves)
                        if _is_float(t))):
            x, out = rec.leaves, rec.output
            rec.release()
            return x, out
        return self._replay(inp)

    def _grads(self, inp, grad_output, reuse: bool, want_params: bool):
        x, out = self._graph(inp, reuse)
        params = [p for p in self.parameters() if p.requires_grad] \
            if want_params else []
        x_leaves = [t for t in activity_leaves(x) if t.requires_grad]
        pairs = [(o, g) for o, g in zip(
            activity_leaves(out),
            activity_leaves(to_activity(grad_output, self._device)))
            if o.requires_grad]
        targets = x_leaves + params
        if pairs and targets:
            grads = torch.autograd.grad([o for o, _ in pairs],
                                        targets, [g.to(o.dtype) for o, g
                                                  in pairs],
                                        allow_unused=True)
        else:
            grads = [None] * len(targets)
        by_leaf = dict(zip(map(id, x_leaves), grads[:len(x_leaves)]))

        def grad_in(t):
            if not _is_float(t):
                return torch.zeros_like(t)
            g = by_leaf.get(id(t))
            return torch.zeros_like(t) if g is None else g

        gi = activity_map(grad_in, x)
        return gi, dict(zip(map(id, params), grads[len(x_leaves):]))

    def update_grad_input(self, inp: Activity,
                          grad_output: Activity) -> Activity:
        """The gradient with respect to ``inp``, from a replay."""
        gi, _ = self._grads(inp, grad_output, reuse=False,
                            want_params=False)
        self.grad_input = gi
        return gi

    def acc_grad_parameters(self, inp: Activity, grad_output: Activity):
        """Add the parameters' gradients, from a replay, to their
        ``.grad`` times ``scale_w``/``scale_b``."""
        _, gp = self._grads(inp, grad_output, reuse=False, want_params=True)
        self._accumulate(gp)

    def backward(self, inp: Activity, grad_output: Activity) -> Activity:
        """gradInput and the parameters' gradients from one autograd pass
        (reference AbstractModule.scala:231): over the forward's graph
        when it can, else over a replay."""
        t0 = time.time()
        gi, gp = self._grads(inp, grad_output, reuse=True, want_params=True)
        self._accumulate(gp)
        self.grad_input = gi
        self.backward_time += time.time() - t0
        return gi

    def _accumulate(self, grads_by_param: Dict[int, torch.Tensor]):
        """Add each parameter's gradient, times its leaf of
        ``gradient_scale_tree()``, to its ``.grad``."""
        scales = zip(tree_leaves(self.param_tree()),
                     tree_leaves(self.gradient_scale_tree()))
        with torch.no_grad():
            for p, s in scales:
                g = grads_by_param.get(id(p))
                if g is None:
                    continue
                if s != 1.0:
                    g = g * s
                if p.grad is None:
                    p.grad = g.detach().clone()
                else:
                    p.grad.add_(g)

    def gradient_scale_tree(self) -> Dict:
        """Per-leaf gradient scales in ``param_tree``'s layout (the
        reference's setScaleW/setScaleB, AbstractModule.scala:70-101):
        this module's ``scale_b`` for a leaf whose key holds "bias",
        else its ``scale_w``.  A ``Container`` gives each child's own
        tree instead (its own parameters, as TransformerLM's ``"pos"``,
        take its scales), so the scales that count are those of the
        modules a container holds, not of the tensors' owners below
        them: the JAX package's rule (bigdl_tpu/nn/module.py:205-214,
        :499-501)."""
        def scale_of(node, key=""):
            if isinstance(node, dict):
                return {k: scale_of(v, k) for k, v in node.items()}
            return self.scale_b if "bias" in key else self.scale_w

        return scale_of(self.param_tree())

    # ------------------------------------------------------------------
    # parameter surface (AbstractModule.scala:284-310)
    # ------------------------------------------------------------------
    def grad_tree(self) -> Dict:
        """Each parameter's accumulated gradient (zeros where none
        was), in ``param_tree``'s layout."""
        return tree_map(lambda p: p.grad if p.grad is not None
                        else torch.zeros_like(p), self.param_tree())

    def set_grad_tree(self, tree: Dict):
        for p, g in zip(tree_leaves(self.param_tree()), tree_leaves(tree)):
            p.grad = torch.as_tensor(g).to(device=p.device,
                                           dtype=p.dtype).clone()
        return self

    def weights_and_grads(self) -> Tuple[List[torch.Tensor],
                                         List[torch.Tensor]]:
        """(weights, gradWeights) as flat lists in ``param_tree`` order —
        the JAX package's ``parameters()``."""
        return (tree_leaves(self.param_tree()),
                tree_leaves(self.grad_tree()))

    def get_weights(self) -> List[np.ndarray]:
        """Weights as numpy arrays in ``param_tree`` order (each layer's
        registration order: weight, then bias — reference pyspark
        Layer.get_weights, nn/layer.py:308)."""
        return [p.detach().cpu().numpy()
                for p in tree_leaves(self.param_tree())]

    def set_weights(self, weights):
        """Assign weights from arrays in ``get_weights`` order (reference
        pyspark Layer.set_weights, nn/layer.py:263)."""
        leaves = tree_leaves(self.param_tree())
        if len(weights) != len(leaves):
            raise ValueError(
                f"expected {len(leaves)} weight arrays, got {len(weights)}")
        for p, w in zip(leaves, weights):
            w = torch.as_tensor(np.asarray(w))
            if tuple(w.shape) != tuple(p.shape):
                raise ValueError(f"weight shape {tuple(w.shape)} != "
                                 f"expected {tuple(p.shape)}")
        with torch.no_grad():
            for p, w in zip(leaves, weights):
                p.copy_(torch.as_tensor(np.asarray(w)).to(p.device, p.dtype))
        return self

    def update_parameters(self, learning_rate: float):
        """In-place SGD step from the accumulated gradients (reference
        pyspark Layer.update_parameters, nn/layer.py:201: for debugging;
        ``optimize()`` is the training loop)."""
        with torch.no_grad():
            for p in self.parameters():
                if p.grad is not None:
                    p.sub_(learning_rate * p.grad)
        return self

    def get_parameters(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(weights, gradients) each flattened into one 1-D tensor
        (reference Module.flatten:80).  The storage is not aliased:
        ``set_flat_parameters`` writes a flat vector back."""
        w, g = self.weights_and_grads()
        if not w:
            empty = torch.zeros(0, device=self._device)
            return empty, empty
        return (torch.cat([t.detach().reshape(-1) for t in w]),
                torch.cat([t.reshape(-1) for t in g]))

    def set_flat_parameters(self, flat_w):
        flat = torch.as_tensor(flat_w)
        leaves = tree_leaves(self.param_tree())
        n = sum(p.numel() for p in leaves)
        if flat.numel() != n:
            raise ValueError(f"flat parameters hold {flat.numel()} "
                             f"values, the model {n}")
        with torch.no_grad():
            at = 0
            for p in leaves:
                p.copy_(flat[at:at + p.numel()].reshape(p.shape).to(
                    p.device, p.dtype))
                at += p.numel()
        return self

    def n_parameters(self) -> int:
        return sum(p.numel() for p in tree_leaves(self.param_tree()))

    def zero_grad_parameters(self):
        for p in self.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            else:
                p.grad.zero_()
        return self

    def test(self, dataset, batch_size: int = 128, v_methods=None):
        """Model-quality benchmark (reference pyspark Layer.test):
        ``evaluate(dataset, v_methods, batch_size)``."""
        if not v_methods:
            raise ValueError(
                "test() needs at least one ValidationMethod (e.g. "
                "[Top1Accuracy()]) — an empty list would run the full "
                "eval forward and return no metrics")
        return self.evaluate(dataset, v_methods, batch_size)

    # ------------------------------------------------------------------
    # parameter / buffer trees
    # ------------------------------------------------------------------
    def param_tree(self) -> Dict:
        """Own parameters plus each child's tree under its key — the
        JAX package's ``param_tree()`` layout, holding the live
        parameters."""
        tree = dict(self.named_parameters(recurse=False))
        for key, child in self.named_children():
            tree[key] = child.param_tree()
        return tree

    def set_param_tree(self, tree: Dict, _path: str = ""):
        """Copy ``tree`` (nested dicts of tensors) into the parameters
        in place, each cast to the parameter's dtype and device.  Raises
        ``KeyError`` on a missing or extra key and ``ValueError`` on a
        shape mismatch, naming the dotted path."""
        return self._copy_tree(tree, "param", _path)

    def _copy_tree(self, tree: Dict, kind: str, _path: str):
        own = dict(self.named_parameters(recurse=False) if kind == "param"
                   else self.named_buffers(recurse=False))
        children = dict(self.named_children())
        expected = set(own) | set(children)
        missing = sorted(expected - set(tree))
        extra = sorted(set(tree) - expected)
        if missing or extra:
            raise KeyError(
                f"{kind} tree at {_path or '<root>'}: missing "
                f"{[_path + k for k in missing]}, extra "
                f"{[_path + k for k in extra]}")
        for key, p in own.items():
            value = torch.as_tensor(tree[key])
            if tuple(value.shape) != tuple(p.shape):
                raise ValueError(
                    f"{kind} {_path + key}: shape {tuple(value.shape)} != "
                    f"expected {tuple(p.shape)}")
            with torch.no_grad():
                p.copy_(value.to(device=p.device, dtype=p.dtype))
        for key, child in children.items():
            child._copy_tree(tree[key], kind, f"{_path}{key}.")
        return self

    def buffer_tree(self) -> Dict:
        """Own buffers plus each child's tree under its key — the JAX
        package's ``buffer_tree()`` layout, holding the live buffers."""
        tree = dict(self.named_buffers(recurse=False))
        for key, child in self.named_children():
            tree[key] = child.buffer_tree()
        return tree

    def set_buffer_tree(self, tree: Dict, _path: str = ""):
        """Copy ``tree`` into the buffers in place, each cast to the
        buffer's dtype and device; the key and shape checks of
        ``set_param_tree``."""
        return self._copy_tree(tree, "buffer", _path)

    # ------------------------------------------------------------------
    # mode / init (AbstractModule.scala:317-380)
    # ------------------------------------------------------------------
    def evaluate(self, *args, **kwargs):
        """No arguments: switch to eval mode (the JAX package's no-arg
        ``evaluate``).  With a dataset and validation methods: run them
        (``optim.evaluator.Evaluator(self).test``)."""
        if not args and not kwargs:
            self.eval()
            return self
        from ..optim.evaluator import Evaluator

        return Evaluator(self).test(*args, **kwargs)

    def train(self, mode: bool = True):
        """Switch to training mode: the JAX package's ``training()``,
        spelled as PyTorch's verb, since ``training`` is a bool
        attribute of every ``torch.nn.Module``.  Training also makes
        every parameter require a gradient.  ``train(False)`` is
        ``eval()``, as in PyTorch."""
        super().train(mode)
        if mode:
            for p in self.parameters():
                p.requires_grad_(True)
        return self

    def set_init_method(self, weight_init: Optional[InitializationMethod]
                        = None, bias_init: Optional[InitializationMethod]
                        = None, generator: Optional[torch.Generator] = None):
        """Set the init methods of ``weight`` and ``bias`` and ``reset``
        (drawing from ``generator``)."""
        if weight_init is not None:
            self._init_methods["weight"] = weight_init
        if bias_init is not None:
            self._init_methods["bias"] = bias_init
        return self.reset(generator)

    def set_scale_w(self, w: float):
        self.scale_w = w
        return self

    def set_scale_b(self, b: float):
        self.scale_b = b
        return self

    def reset(self, generator: Optional[torch.Generator] = None):
        """Re-draw every parameter that has an init method (its
        ``set_init_method`` one, else the layer's default) from
        ``generator``, then reset each child."""
        for name, p in self.named_parameters(recurse=False):
            init, fmt = self._param_inits.get(name, (None, DEFAULT_FORMAT))
            init = self._init_methods.get(name, init)
            if init is None:
                continue
            with torch.no_grad():
                p.copy_(init.init(tuple(p.shape), fmt, generator).to(
                    p.device, p.dtype))
        for child in self.children():
            if isinstance(child, AbstractModule):
                child.reset(generator)
        return self

    # ------------------------------------------------------------------
    # traversal / timing (Container.getTimes analogue)
    # ------------------------------------------------------------------
    def modules_iter(self):
        yield self
        for child in self.children():
            yield from child.modules_iter()

    def get_times(self):
        return [(m.get_name(), m.forward_time, m.backward_time)
                for m in self.modules_iter()]

    def reset_times(self):
        for m in self.modules_iter():
            m.forward_time = 0.0
            m.backward_time = 0.0
        return self

    def find_module(self, name: str):
        for m in self.modules_iter():
            if m.get_name() == name:
                return m
        return None

    # ------------------------------------------------------------------
    # clone / save / predict
    # ------------------------------------------------------------------
    def clone_module(self) -> "AbstractModule":
        return copy.deepcopy(self)

    def save(self, path: str, overwrite: bool = False):
        """Pickle the module (tensors as CPU values) to ``path``;
        ``load_module`` reads it back."""
        from ..utils.file_io import save as _save

        _save(self, path, overwrite)
        return self

    def save_torch(self, path: str, overwrite: bool = False):
        raise _not_ported("save_torch (Torch7 .t7 files)")

    def save_caffe(self, prototxt_path: str, model_path: str,
                   use_v2: bool = True, overwrite: bool = False):
        raise _not_ported("save_caffe (Caffe interop)")

    def save_tf(self, input_shape, path: str, **kwargs):
        raise _not_ported("save_tf (TensorFlow interop)")

    def save_weights(self, path: str, overwrite: bool = False):
        from ..utils.file_io import save as _save

        _save(self.param_tree(), path, overwrite)
        return self

    def load_weights(self, path: str):
        from ..utils.file_io import load as _load

        return self.set_param_tree(_load(path))

    def predict(self, dataset, batch_size: int = 32, mesh=None):
        """Per-sample outputs over ``dataset`` (optim/predictor.py)."""
        from ..optim.predictor import Predictor

        return Predictor(self, mesh=mesh).predict(dataset, batch_size)

    def predict_class(self, dataset, batch_size: int = 32, mesh=None):
        from ..optim.predictor import Predictor

        return Predictor(self, mesh=mesh).predict_class(dataset, batch_size)

    def _place(self, device: torch.device):
        """Move every parameter and buffer to ``device`` and make it the
        device of this module and its children."""
        self.to(device)
        for m in self.modules():
            if isinstance(m, AbstractModule):
                m._device = device
        return self

    # -- pickling: parameters travel as (value, requires_grad); the last
    # forward's tensors and graph do not travel
    def __getstate__(self):
        state = super().__getstate__()
        state["_parameters"] = {
            k: None if p is None else _ParamBox(p.detach(), p.requires_grad)
            for k, p in state["_parameters"].items()}
        state["output"] = state["grad_input"] = state["_fwd"] = None
        return state

    def __setstate__(self, state):
        state["_parameters"] = {
            k: v if not isinstance(v, _ParamBox) else torch.nn.Parameter(
                torch.as_tensor(v.value), requires_grad=v.requires_grad)
            for k, v in state["_parameters"].items()}
        super().__setstate__(state)

    def __repr__(self):
        return self.get_name()


def load_module(path: str, device: DeviceLike = None) -> AbstractModule:
    """A module written by ``AbstractModule.save``, on ``device`` (the
    card unless the caller names the CPU)."""
    from ..utils.file_io import load as _load

    return _load(path)._place(resolve_device(device))


class TensorModule(AbstractModule):
    """Module whose input and output are single tensors."""


class Container(AbstractModule):
    """Base container: children registered under ``"0"``, ``"1"``, …;
    on its first child's device unless ``device`` is given."""

    def __init__(self, *modules: AbstractModule, device: DeviceLike = None):
        if device is None and modules:
            device = modules[0].device
        super().__init__(device)
        for m in modules:
            self.add(m)

    def add(self, module: AbstractModule):
        self.add_module(str(len(self)), module)
        return self

    def __len__(self):
        return len(self._modules)

    def __getitem__(self, i: int) -> AbstractModule:
        return self._modules[str(i % len(self))]

    def get(self, i: int) -> AbstractModule:
        """1-based accessor (the reference's ``get``)."""
        return self._modules[str(i - 1)]

    def __repr__(self):
        inner = "\n".join("  " + repr(m).replace("\n", "\n  ")
                          for m in self.children())
        return f"{self.get_name()} {{\n{inner}\n}}"

    def gradient_scale_tree(self) -> Dict:
        tree = {name: self.scale_b if "bias" in name else self.scale_w
                for name, _ in self.named_parameters(recurse=False)}
        for key, child in self.named_children():
            tree[key] = child.gradient_scale_tree()
        return tree
