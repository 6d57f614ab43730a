"""Perturbation gradient checker (counterpart of
``bigdl_tpu/utils/gradient_checker.py``; reference
dl/src/test/.../nn/GradientChecker.scala — SURVEY §4.1).

It holds a layer's ``update_grad_input`` and ``acc_grad_parameters`` —
the verbs, so whatever backward the layer has — against central finite
differences of the sum of its forward, on a float64 copy of the layer on
the CPU in eval mode.  The layer itself is not touched.
"""
from __future__ import annotations

import numpy as np
import torch

from .tree import tree_leaves


class GradientChecker:
    def __init__(self, perturbation: float = 1e-3, precision: float = 1e-3):
        self.perturbation = perturbation
        self.precision = precision

    @staticmethod
    def _f64_copy(module):
        m = module.clone_module()._place(torch.device("cpu")).double()
        m.evaluate()
        return m

    @staticmethod
    def _sum_out(m, params, x) -> float:
        with torch.no_grad():
            return float(m.apply_fn(params, x).sum())

    def check_layer(self, module, x, epsilon: float = None) -> bool:
        """d(sum of the output)/d(input) from ``update_grad_input``
        against finite differences."""
        eps = epsilon or self.perturbation
        m = self._f64_copy(module)
        x = torch.as_tensor(np.asarray(x), dtype=torch.float64)
        out = m.forward(x)
        analytic = m.update_grad_input(x, torch.ones_like(out))
        params = m.param_tree()
        numeric = np.zeros(x.numel())
        flat = x.reshape(-1)
        for i in range(flat.numel()):
            orig = float(flat[i])
            flat[i] = orig + eps
            plus = self._sum_out(m, params, x)
            flat[i] = orig - eps
            minus = self._sum_out(m, params, x)
            flat[i] = orig
            numeric[i] = (plus - minus) / (2 * eps)
        return self._close(analytic.reshape(-1).numpy(), numeric)

    def check_weight(self, module, x, epsilon: float = None) -> bool:
        """d(sum of the output)/d(parameters) from
        ``acc_grad_parameters`` against finite differences."""
        eps = epsilon or self.perturbation
        m = self._f64_copy(module)
        x = torch.as_tensor(np.asarray(x), dtype=torch.float64)
        out = m.forward(x)
        m.zero_grad_parameters()
        m.acc_grad_parameters(x, torch.ones_like(out))
        leaves = tree_leaves(m.param_tree())
        analytic = np.concatenate([p.grad.reshape(-1).numpy()
                                   for p in leaves])
        numeric = []
        params = m.param_tree()
        for p in leaves:
            flat = p.data.reshape(-1)
            for i in range(flat.numel()):
                orig = float(flat[i])
                flat[i] = orig + eps
                plus = self._sum_out(m, params, x)
                flat[i] = orig - eps
                minus = self._sum_out(m, params, x)
                flat[i] = orig
                numeric.append((plus - minus) / (2 * eps))
        return self._close(analytic, np.asarray(numeric))

    def _close(self, analytic, numeric) -> bool:
        denom = np.maximum(np.abs(numeric), 1.0)
        err = np.max(np.abs(analytic - numeric) / denom)
        return bool(err < self.precision)
