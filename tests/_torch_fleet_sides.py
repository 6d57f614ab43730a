"""The JAX package's serving fleet and the port's, side by side, for the
port's fleet, request-trace, tenant and continuous-loop specs.

A :class:`Side` names one package's modules under the same attribute
names, so a scenario written once runs on either: ``scenario(JAX)`` and
``scenario(PORT)`` get the same request stream (numpy seeds), the same
fault schedule and the same weights — the port's models load the JAX
models' parameters through ``interop.jax_params.load_param_tree``.
:func:`both` runs a scenario on each side and holds their readings
equal: typed statuses, counts and greedy tokens exactly, float outputs
within ``OUTPUT_ATOL`` (the tolerance ``tests/test_torch_serving.py``
holds the port's server to against the JAX package).

:class:`SpecDeadline` gives each spec that starts threads a deadline of
its own: past it, every fleet registered with it is hard-stopped (its
queued requests resolve CANCELLED, so every bounded wait returns) and
the spec fails.
"""
import importlib
import threading

import numpy as np
import pytest
import torch

import jax

from bigdl_tpu.utils.rng import RNG as JRNG
from bigdl_tpu_torch.interop import load_param_tree

#: classify outputs, port against JAX (rtol 0): the tolerance of
#: ``tests/test_torch_serving.py::test_inference_server_matches_jax``
OUTPUT_ATOL = 1e-4

_MODULES = ("nn", "dataset", "optim", "telemetry", "loop",
            "resilience.faults", "resilience.elastic", "serving",
            "serving.router", "serving.registry", "serving.swap",
            "serving.fleet", "serving.kvpool", "serving.pools",
            "serving.request_trace", "serving.autoscale",
            "serving.health", "telemetry.trace_context",
            "telemetry.metric_names", "telemetry.slo",
            "models.transformer", "utils.file_io")


class Side:
    """One package's serving stack under common names (``side.serving``,
    ``side.faults``, ``side.router``, ...) plus model builders that give
    both sides the same weights."""

    def __init__(self, name: str, root: str):
        self.name = name
        self.root = root
        for mod in _MODULES:
            attr = mod.split(".")[-1]
            setattr(self, attr, importlib.import_module(f"{root}.{mod}"))

    @property
    def is_port(self) -> bool:
        return self.name == "port"

    # ---------------------------------------------------------- models
    def _from_jax(self, jmodel, port_model):
        if not self.is_port:
            return jmodel
        load_param_tree(port_model, jax.tree_util.tree_map(
            np.asarray, jmodel.param_tree()))
        return port_model

    def small_model(self, seed: int = 0):
        """The reference specs' ``small_model()``: Linear(4, 8) · Tanh ·
        Linear(8, 3) · LogSoftMax, weights drawn by the JAX package."""
        JRNG().set_seed(seed)
        from bigdl_tpu import nn as jnn

        jm = jnn.Sequential(jnn.Linear(4, 8), jnn.Tanh(), jnn.Linear(8, 3),
                            jnn.LogSoftMax())
        nn = self.nn
        pm = nn.Sequential(nn.Linear(4, 8, device="cpu"),
                           nn.Tanh(device="cpu"),
                           nn.Linear(8, 3, device="cpu"),
                           nn.LogSoftMax(device="cpu"),
                           device="cpu") if self.is_port else None
        return self._from_jax(jm, pm)

    def regressor(self, seed: int = 0):
        """The continuous-loop specs' Linear(8, 8) · Tanh · Linear(8, 1)."""
        JRNG().set_seed(seed)
        from bigdl_tpu import nn as jnn

        jm = jnn.Sequential(jnn.Linear(8, 8), jnn.Tanh(), jnn.Linear(8, 1))
        nn = self.nn
        pm = nn.Sequential(nn.Linear(8, 8, device="cpu"),
                           nn.Tanh(device="cpu"),
                           nn.Linear(8, 1, device="cpu"),
                           device="cpu") if self.is_port else None
        return self._from_jax(jm, pm)

    def lm(self, vocab: int, seed: int = 4, **kw):
        """A tiny TransformerLM (the reference specs' embed 16, 1 layer)."""
        JRNG().set_seed(seed)
        from bigdl_tpu.models.transformer import TransformerLM as JLM

        jm = JLM(vocab, **kw)
        pm = self.transformer.TransformerLM(vocab, **kw, device="cpu") \
            if self.is_port else None
        return self._from_jax(jm, pm)

    def forward(self, model, x) -> np.ndarray:
        """The model's forward on a numpy batch, as numpy.  A JAX forward
        draws from the package's host RNG, which the JAX optimizer's
        epoch shuffle also reads; the draw is undone so that a probe
        leaves the training stream as the port's (which draws nothing)."""
        if not self.is_port:
            state = JRNG().state_dict()
            try:
                return np.asarray(model.forward(np.asarray(x)))
            finally:
                JRNG().load_state_dict(state)
        with torch.no_grad():
            return model.evaluate().forward(
                torch.as_tensor(np.asarray(x))).detach().numpy()

    def save_params(self, model, path: str):
        """A crc32c-sidecarred checkpoint of ``model`` that the side's
        ``load_verified_params`` reads back as its param tree."""
        if self.is_port:
            self.file_io.save({"params": model.param_tree(),
                               "buffers": model.buffer_tree()}, path,
                              atomic=True, checksum=True)
        else:
            self.file_io.save(model, path, atomic=True, checksum=True)


JAX = Side("jax", "bigdl_tpu")
PORT = Side("port", "bigdl_tpu_torch")
SIDES = (JAX, PORT)


def assert_same(jax_reading, port_reading, atol: float = OUTPUT_ATOL,
                path: str = "reading"):
    """The two sides' readings are equal: containers item by item,
    floats and float arrays within ``atol``, everything else exactly."""
    a, b = jax_reading, port_reading
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, a, b)
        for k in a:
            assert_same(a[k], b[k], atol, f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), \
            (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, atol, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, (path, a.shape, b.shape)
        if a.dtype.kind == "f" or b.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=0, atol=atol,
                                       err_msg=path)
        else:
            np.testing.assert_array_equal(b, a, err_msg=path)
    elif isinstance(a, float) and not isinstance(b, bool):
        assert b == pytest.approx(a, rel=0, abs=atol), (path, a, b)
    else:
        assert a == b, (path, a, b)


def both(scenario, atol: float = OUTPUT_ATOL):
    """Run ``scenario(side)`` on the JAX package and on the port; their
    readings must be equal (:func:`assert_same`).  Returns the port's."""
    got = {side.name: scenario(side) for side in SIDES}
    assert_same(got["jax"], got["port"], atol)
    return got["port"]


def statuses(results) -> list:
    return [r.status.value for r in results]


def outputs(results) -> list:
    return [None if r.output is None else np.asarray(r.output)
            for r in results]


class SpecDeadline:
    """A spec's own deadline (see the module docstring)::

        with SpecDeadline(60) as dl:
            fl = dl.add(make_fleet(...))
    """

    def __init__(self, seconds: float):
        self.seconds = float(seconds)
        self.expired = False
        self._fleets = []
        self._timer = threading.Timer(self.seconds, self._expire)
        self._timer.daemon = True

    def add(self, fleet):
        self._fleets.append(fleet)
        return fleet

    def _expire(self):
        self.expired = True
        for fl in self._fleets:
            try:
                fl.stop(timeout=2)
            except Exception:
                pass

    def __enter__(self):
        self._timer.start()
        return self

    def __exit__(self, *exc):
        self._timer.cancel()
        if self.expired:
            pytest.fail(f"spec ran past its {self.seconds:.0f} s deadline")
        return False
