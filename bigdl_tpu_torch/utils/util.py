"""Small host-side helpers (reference utils/Util.scala,
LoggerFilter.scala; counterpart of ``bigdl_tpu/utils/util.py``, a copy).

``kth_largest`` backs the straggler-drop threshold computation in the
reference driver (DistriOptimizer.scala:302-330) — kept for the parity
knob even though a synchronous TPU step has no stragglers.
"""
from __future__ import annotations

import logging
import os
from typing import Optional, Sequence


def kth_largest(values: Sequence, k: int):
    """k-th largest element, k is 1-based (reference utils/Util.scala:20,
    quickselect there; sorting is fine at driver scale)."""
    ordered = sorted(values, reverse=True)
    return ordered[k - 1]


class LoggerFilter:
    """Tame framework/jax log noise and optionally tee INFO logs to a
    file (reference utils/LoggerFilter.scala:34 —
    ``redirectSparkInfoLogs`` sends verbose engine INFO to
    ``bigdl.log`` and keeps the console at ERROR for those loggers).
    """

    NOISY = ("jax", "absl", "orbax")

    @staticmethod
    def redirect_engine_logs(path: Optional[str] = None):
        path = path or os.path.join(os.getcwd(), "bigdl.log")
        handler = logging.FileHandler(path)
        handler.setLevel(logging.INFO)
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s %(name)s: %(message)s"))
        console = logging.StreamHandler()
        console.setLevel(logging.ERROR)
        for name in LoggerFilter.NOISY:
            lg = logging.getLogger(name)
            lg.setLevel(logging.INFO)
            lg.addHandler(handler)
            lg.addHandler(console)
            lg.propagate = False
        root = logging.getLogger("bigdl_tpu")
        root.setLevel(logging.INFO)
        root.addHandler(handler)
        return path
