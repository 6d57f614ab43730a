"""Phase split of a profiled step from ``torch.profiler`` (counterpart of
``bigdl_tpu/optim/profiling.py``).

The reference attributes each iteration's wall time to named phases via
Spark accumulators ("computing time average", "aggregate gradient time"
— Metrics.scala:103-121, DistriOptimizer.scala:146-151).  The JAX
package reads the split from a ``jax.profiler`` trace of the fused step;
the port reads it from a ``torch.profiler`` trace of the eager step:

* on the card, the device time of the CUDA kernels the step launched,
  the kernels named ``nccl*`` counted as collective, every other one as
  compute;
* on the CPU, the self time of the host ops, the gloo and c10d
  collectives (``gloo:*``, ``c10d::*``, ``nccl:*`` and the like) counted
  as collective, every other op as compute.

``DistriOptimizer`` does this on profiling iterations; a trace with
nothing parsable gives None, and the driver keeps its last split.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch


class PhaseSplit(NamedTuple):
    """Device-time attribution of one profiled step.  A NamedTuple so
    every ``compute_s, collective_s = split`` unpacking keeps working
    while new callers (the telemetry tracer's compute/collective
    children) get named fields."""

    compute_s: float
    collective_s: float

    @property
    def total_s(self) -> float:
        return self.compute_s + self.collective_s

    @property
    def compute_fraction(self) -> float:
        return self.compute_s / max(self.total_s, 1e-12)


#: name prefixes of collective work: NCCL's kernels on the card, the
#: process-group ops (and their record_function ranges) on the host
_COLLECTIVE_PREFIXES = ("nccl", "gloo:", "c10d::", "c10d:", "record_param_comms")
#: host ranges that span whole steps or other ops (counting their self
#: time would count the profiler's own bookkeeping)
_SKIP_PREFIXES = ("profilerstep", "[memory]")


def _classify(name: str) -> Optional[str]:
    n = name.lower()
    if n.startswith(_SKIP_PREFIXES):
        return None
    if n.startswith(_COLLECTIVE_PREFIXES):
        return "collective"
    return "compute"


def _self_us(event, on_card: bool) -> float:
    if on_card:
        us = getattr(event, "self_device_time_total", None)
        return event.self_cuda_time_total if us is None else us
    return event.self_cpu_time_total


def split_from_profile(prof, on_card: bool) -> PhaseSplit:
    """Sum (compute_s, collective_s) over a finished ``torch.profiler``
    session: CUDA kernels on the card, host ops on the CPU."""
    want = (torch.autograd.DeviceType.CUDA if on_card
            else torch.autograd.DeviceType.CPU)
    compute_us = collective_us = 0.0
    for e in prof.key_averages():
        if e.device_type != want:
            continue
        kind = _classify(e.key)
        if kind == "compute":
            compute_us += _self_us(e, on_card)
        elif kind == "collective":
            collective_us += _self_us(e, on_card)
    return PhaseSplit(compute_us / 1e6, collective_us / 1e6)


def trace_phase_split(run: Callable[[], None], device=None
                      ) -> Optional[PhaseSplit]:
    """Run ``run()`` under ``torch.profiler``; return the (compute_s,
    collective_s) split of ``device``'s time (``device``: the step's
    ``torch.device``, default the card when there is one), or None when
    the trace has no classifiable time (the caller keeps its last
    split).

    ``run`` ALWAYS executes exactly once, and its exceptions propagate —
    the driver's failure-retry loop depends on seeing training errors.
    Only the profiling machinery itself is allowed to fail silently."""
    from torch.profiler import ProfilerActivity, profile

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    on_card = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    prof, started = None, False
    try:
        prof = profile(activities=activities)
        prof.__enter__()
        started = True
    except Exception:  # no profiler on this build: just run
        pass
    try:
        run()
    finally:
        if started:
            try:
                prof.__exit__(None, None, None)
            except Exception:
                started = False
    if not started:
        return None
    try:
        split = split_from_profile(prof, on_card)
    except Exception:  # unparsable trace
        return None
    return split if split.compute_s > 0.0 else None
