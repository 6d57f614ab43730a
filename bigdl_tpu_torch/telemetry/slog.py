"""Structured logging entry points for the library.

Library modules must never configure the root logger at import time
(module-level ``logging.basicConfig`` hijacks the embedding
application's logging — the print/basicConfig lint in
tests/test_determinism.py enforces this); they call
:func:`get_logger` and leave configuration to the application.
:func:`configure_logging` is the one sanctioned knob: applications
(and the package's own examples/bench entry points) call it once, and
it respects any handlers the host process already installed.
"""
from __future__ import annotations

import logging

__all__ = ["configure_logging", "get_logger"]

_FORMAT = "%(asctime)s %(levelname)s %(name)s: %(message)s"


def get_logger(name: str = "bigdl_tpu") -> logging.Logger:
    """The library logger (children via ``get_logger("bigdl_tpu.x")``)."""
    return logging.getLogger(name)


def configure_logging(level: int = logging.INFO,
                      force: bool = False) -> bool:
    """Install a basic stderr handler + format on the root logger —
    unless the application already configured one (``force=True``
    overrides).  Returns True when configuration was applied."""
    root = logging.getLogger()
    if root.handlers and not force:
        return False
    logging.basicConfig(level=level, format=_FORMAT, force=force)
    return True
