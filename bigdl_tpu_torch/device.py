"""The default-device rule.

Every entry point takes a ``device`` argument.  ``None`` means the
current CUDA device; with no CUDA device that is an error, never a
silent run on the CPU.  The CPU is used only when the caller names it
(the CPU tests pass ``device="cpu"``).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on.  Raises ``RuntimeError`` when
    CUDA is asked for, explicitly or by default, and there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; bigdl_tpu_torch runs on "
                "the GPU by default — pass device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but no CUDA device is "
                f"available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r} "
                         f"(cuda or cpu)")
    return dev
