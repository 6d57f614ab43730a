"""Hot model swap: verified load, canary, install between batches
(counterpart of ``bigdl_tpu/serving/swap.py``).

New parameters enter the serving path only through the crc32c-verified
checkpoint machinery (:mod:`bigdl_tpu_torch.resilience.checkpoint`): a
corrupt file is quarantined and the swap refused, as a training restore
would.  The candidate then faces a canary (``InferenceServer
.swap_params``) before the server copies it into the model's
parameters under its model lock, between batches.
"""
from __future__ import annotations

import logging
from typing import Any

from ..resilience.checkpoint import CorruptCheckpointError, verified_load

log = logging.getLogger("bigdl_tpu")


class SwapRejected(RuntimeError):
    """The candidate params failed verification or the canary; the
    server keeps serving the previous params."""


class DeployInFlight(RuntimeError):
    """A rolling deploy (or an alert-driven rollback) is already in
    flight; the new attempt is refused, typed, before any replica is
    touched."""


def load_verified_params(path: str, device=None) -> Any:
    """Load a checkpoint file for serving, refusing corrupt bytes: it
    must pass its crc32c sidecar check when it has one (a mismatch
    quarantines it) and unpickle.  A model leg written by the training
    loop (``{"params": ..., "buffers": ...}``) is unwrapped to its param
    tree; a pickled bare param tree passes as it is.  Tensors land on
    ``device``."""
    try:
        obj = verified_load(path, device=device)
    except CorruptCheckpointError as e:
        raise SwapRejected(str(e))
    if isinstance(obj, dict) and set(obj) == {"params", "buffers"}:
        return obj["params"]
    return obj
