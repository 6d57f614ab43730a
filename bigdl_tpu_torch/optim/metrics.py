"""Metrics — named training-phase counters (counterpart of
``bigdl_tpu/optim/metrics.py``, a copy; reference optim/Metrics.scala:31).

The reference backs these with Spark accumulators; here they are
host-side aggregates fed from per-step timing, keeping the same metric
names the reference logs ("computing time average", "aggregate gradient
time", "get weights average" — DistriOptimizer.scala:146-151) so
dashboards/logs stay comparable.
"""
from __future__ import annotations

import threading
from typing import Dict, List


class Metrics:
    def __init__(self):
        self._scalars: Dict[str, List[float]] = {}
        self._lock = threading.Lock()

    def set(self, name: str, value: float, parallel: int = 1):
        with self._lock:
            self._scalars[name] = [float(value), float(parallel)]

    def add(self, name: str, value: float):
        with self._lock:
            if name not in self._scalars:
                self._scalars[name] = [0.0, 1.0]
            self._scalars[name][0] += float(value)

    def get(self, name: str):
        v = self._scalars.get(name)
        return None if v is None else v[0] / v[1]

    def summary(self, unit: str = "s", scale: float = 1.0) -> str:
        """Pretty-printable table (reference Metrics.summary:103-121)."""
        lines = ["========== Metrics Summary =========="]
        for name, (value, parallel) in sorted(self._scalars.items()):
            lines.append(f"{name} : {value / parallel / scale} {unit}")
        lines.append("=====================================")
        return "\n".join(lines)
