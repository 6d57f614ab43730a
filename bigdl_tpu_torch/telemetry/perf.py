"""Performance accounting: the work of the step the driver runs
(counterpart of ``bigdl_tpu/telemetry/perf.py``).

The telemetry spine (registry/tracer/goodput) accounts *time*; this
module accounts *work*: per-step FLOPs and bytes, counted while the
step runs once under :class:`WorkCounter` (a ``TorchDispatchMode``), plus
live device-memory watermarks from ``torch.cuda.memory_stats()``
polled at step boundaries.  From those it publishes the MFU family as
registry metrics and classifies every analyzed program against the
device roofline (compute-bound vs HBM-bound vs collective-bound, peaks
from :mod:`.device_info`).

The JAX package reads XLA's cost model of the lowered program; the port
has no such model, so it counts the step as eager PyTorch runs it:

* FLOPs from ``torch.utils.flop_counter``'s formulas (mm, addmm, bmm,
  baddbmm, convolution and its backward, the SDPA ops): products only,
  as that counter counts; elementwise work counts no FLOPs;
* bytes as the sum, over every aten op, of the distinct tensors it
  reads or writes (views and allocations move nothing and are skipped):
  what eager execution moves, unfused.

A hand-written kernel is counted by its shapes, not by its
implementation: the counter sees nothing inside a ctypes or Triton
launch, so each kernel wrapper reports the dense-equivalent products of
the plain math it replaces and the bytes it reads and writes once
(:func:`kernel_work`), from its CUDA branch and its plain CPU branch
alike, and the plain branch's own aten ops are not counted a second
time.  A step's count is therefore the same on the card and on the CPU,
and the same for the flash kernels as for dense attention at equal
shapes.  The block-sparse kernels also report their executed FLOPs
beside the dense equivalent; :meth:`PerfAccountant.analyze_step` books
them through :meth:`PerfAccountant.report_sparse_flops`, as the JAX
package's caller does.

Every entry point degrades to a no-op on failure — perf accounting must
never take down a training step (``memory_stats`` on the CPU is the
normal None, not an error).
"""
from __future__ import annotations

import logging
import threading
from typing import Dict, List, NamedTuple, Optional

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)
from torch.utils.flop_counter import flop_registry

from .device_info import CPU_SPEC, DeviceSpec, current_device_spec
from .registry import MetricsRegistry, default_registry

log = logging.getLogger("bigdl_tpu")

__all__ = ["PerfAccountant", "StepCost", "WorkCounter", "classify_roofline",
           "kernel_work"]

#: roofline verdicts (``unknown`` = not enough device/byte data)
ROOFLINE_BOUNDS = ("compute", "hbm", "collective", "unknown")


class StepCost(NamedTuple):
    """Cost of one step, as :class:`WorkCounter` counted it."""

    flops: float
    bytes_accessed: float
    #: caller-supplied estimate (the op counts do not attribute
    #: collective wire bytes); 0.0 = single-device step
    collective_bytes: float = 0.0
    #: not counted by the port (no compiled program to analyze): None
    peak_bytes: Optional[float] = None
    argument_bytes: Optional[float] = None
    output_bytes: Optional[float] = None
    temp_bytes: Optional[float] = None
    #: "counted": one eager run under :class:`WorkCounter`
    source: str = "counted"

    @property
    def arithmetic_intensity(self) -> Optional[float]:
        if not self.bytes_accessed:
            return None
        return self.flops / self.bytes_accessed


class WorkCounter(TorchDispatchMode):
    """Counts the FLOPs and bytes of the aten ops run under it (see the
    module docstring), plus the work kernel wrappers report through
    :func:`kernel_work`: ``with WorkCounter() as c: step()`` leaves
    ``c.flops`` and ``c.bytes``.  ``sparse`` lists each block-sparse
    kernel call's (dense-equivalent FLOPs counted, executed FLOPs, dense
    equivalent FLOPs)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.sparse: List[tuple] = []
        self._hold = 0
        self._lock = threading.Lock()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self._hold:
            try:
                self._count(func, args, kwargs, out)
            except Exception as e:  # a formula's quirk never fails a step
                log.debug("perf: could not count %s: %s", func, e)
        return out

    def _count(self, func, args, kwargs, out):
        if func.is_view or func._overloadpacket in _MOVES_NOTHING:
            return
        formula = flop_registry.get(func._overloadpacket)
        flops = (float(formula(*args, **kwargs, out_val=out))
                 if formula is not None else 0.0)
        seen, nbytes = set(), 0
        for t in _tensors((args, kwargs, out)):
            if id(t) not in seen:
                seen.add(id(t))
                nbytes += t.numel() * t.element_size()
        with self._lock:
            self.flops += flops
            self.bytes += nbytes

    @property
    def executed_flops(self) -> float:
        """The count with each block-sparse kernel's dense equivalent
        replaced by its executed FLOPs."""
        return self.flops + sum(e - f for f, e, _ in self.sparse)

    def report(self, flops: float, nbytes: float, sparse=None):
        with self._lock:
            self.flops += float(flops)
            self.bytes += float(nbytes)
            if sparse is not None:
                self.sparse.append((float(flops), float(sparse[0]),
                                    float(sparse[1])))


#: allocations and metadata: no bytes move
_MOVES_NOTHING = frozenset(
    getattr(torch.ops.aten, n) for n in (
        "empty", "empty_like", "empty_strided", "new_empty",
        "new_empty_strided", "lift_fresh", "_local_scalar_dense",
        "sym_size", "sym_stride", "sym_numel", "sym_storage_offset")
    if hasattr(torch.ops.aten, n))


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)


def _active_counters() -> List[WorkCounter]:
    """The work counters of this thread's dispatch-mode stack (autograd
    carries the stack to the threads it runs a backward on)."""
    return [m for m in _get_current_dispatch_mode_stack()
            if isinstance(m, WorkCounter)]


class kernel_work:
    """A kernel wrapper's work report: ``with kernel_work(flops, bytes):``
    around the wrapper's launch (or its plain version) adds ``flops``
    and ``bytes`` to each active counter once and counts none of the
    aten ops the block runs.  ``sparse`` = (executed, dense-equivalent)
    FLOPs of a block-sparse kernel.  Without an active counter it costs
    one look at the mode stack."""

    __slots__ = ("flops", "nbytes", "sparse", "counters")

    def __init__(self, flops: float, nbytes: float, sparse=None):
        self.flops, self.nbytes, self.sparse = flops, nbytes, sparse

    def __enter__(self):
        self.counters = _active_counters()
        for c in self.counters:
            c.report(self.flops, self.nbytes, self.sparse)
            c._hold += 1

    def __exit__(self, *exc):
        for c in self.counters:
            c._hold -= 1
        return False


def nbytes(*tensors) -> int:
    """Bytes of the given tensors (None skipped): what a kernel reads
    or writes once."""
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def classify_roofline(cost: StepCost, spec: DeviceSpec) -> dict:
    """Which wall does this program lean on?

    Attainable-time comparison: ``flops/peak`` vs ``bytes/hbm_bw`` vs
    ``collective_bytes/ici_bw`` — the largest lower bound names the
    binding resource.  The compute-vs-HBM half is equivalent to
    comparing arithmetic intensity against the device ridge point
    (``peak_flops / hbm_bw``); stating it as times lets the collective
    leg join the same comparison.  Returns the classification plus the
    inputs it was made from, so reports can show their work.
    """
    ai = cost.arithmetic_intensity
    ridge = spec.ridge_flops_per_byte
    times = {}
    if spec.peak_flops_per_sec:
        times["compute"] = cost.flops / spec.peak_flops_per_sec
    if spec.hbm_bytes_per_sec and cost.bytes_accessed:
        times["hbm"] = cost.bytes_accessed / spec.hbm_bytes_per_sec
    if spec.ici_bytes_per_sec and cost.collective_bytes:
        times["collective"] = (cost.collective_bytes
                               / spec.ici_bytes_per_sec)
    bound = max(times, key=times.get) if times else "unknown"
    if "hbm" not in times and bound == "compute" and not cost.flops:
        bound = "unknown"
    return {
        "bound": bound,
        "arithmetic_intensity": ai,
        "ridge_flops_per_byte": ridge,
        "attainable_seconds": times,
        "nominal_device": spec.nominal,
    }


class PerfAccountant:
    """Derives work metrics for the steps a driver runs.

    One accountant per process side (training driver, serving server).
    ``analyze_step`` runs the first step of every attempt under the
    counter; ``on_step`` is called once per step.  Publishes into the
    registry:

    * ``bigdl_perf_flops_per_step`` / ``bigdl_perf_bytes_per_step`` /
      ``bigdl_perf_collective_bytes`` gauges, labeled by ``program``;
    * ``bigdl_perf_arithmetic_intensity`` gauge per program;
    * ``bigdl_perf_mfu`` gauge per program (rolling mean over the
      last observed step times) + ``bigdl_perf_model_flops_per_sec``;
    * ``bigdl_perf_flops_total`` counter — the cross-host foldable
      total (counters sum in the cluster merge);
    * ``bigdl_perf_hbm_{bytes_in_use,peak_bytes,limit_bytes}`` gauges
      from ``torch.cuda.memory_stats()`` and the device's total memory,
      polled every ``memory_poll_every`` steps (the CPU has no memory
      stats and leaves them untouched).

    ``device`` (a ``torch.device``, default ``cuda:0``) names the device
    whose peak and memory are read; the drivers bind the model's with
    :meth:`bind_device`.  An explicit ``spec`` overrides its row.
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 spec: Optional[DeviceSpec] = None,
                 memory_poll_every: int = 16, device=None):
        self.registry = registry if registry is not None \
            else default_registry()
        self._spec = spec
        self._spec_given = spec is not None
        self.device = None if device is None else torch.device(device)
        self.memory_poll_every = max(1, int(memory_poll_every))
        self._programs: Dict[str, StepCost] = {}
        self._current: Optional[str] = None
        self._steps_seen = 0
        self._ema_flops_per_sec: Dict[str, float] = {}
        self.last_memory_stats: Optional[dict] = None
        r = self.registry
        self.flops_per_step = r.gauge(
            "bigdl_perf_flops_per_step",
            "counted FLOPs of one step (kernels by their shapes)",
            labels=("program",))
        self.bytes_per_step = r.gauge(
            "bigdl_perf_bytes_per_step",
            "counted bytes moved by one step (eager, unfused)",
            labels=("program",))
        self.collective_bytes = r.gauge(
            "bigdl_perf_collective_bytes",
            "estimated collective wire bytes per step (sparse-transport "
            "leaves accounted as actual index+value bytes)",
            labels=("program",))
        self.sparse_bytes_saved = r.gauge(
            "bigdl_perf_sparse_bytes_saved",
            "collective wire bytes per step NOT moved because sparse "
            "gradient transport replaced the dense all-reduce",
            labels=("program",))
        self.sync_bytes_saved = r.gauge(
            "bigdl_perf_sync_bytes_saved",
            "collective wire bytes per step NOT moved because relaxed "
            "synchrony (periodic(k) local SGD) replaced the lockstep "
            "per-step reduction with amortized k-step averaging",
            labels=("program",))
        self.sparse_flops_skipped_gauge = r.gauge(
            "bigdl_perf_sparse_flops_skipped",
            "dense-equivalent MXU FLOPs per step NOT executed because "
            "block-sparse kernels skipped masked blocks (kernel-"
            "reported: the op counter cannot see inside a kernel "
            "launch)",
            labels=("program",))
        #: kernel-reported sparse corrections per program — the
        #: uncorrected cost is retained so repeated reports replace,
        #: never compound
        self._sparse_flops: Dict[str, dict] = {}
        self._uncorrected: Dict[str, StepCost] = {}
        self.intensity = r.gauge(
            "bigdl_perf_arithmetic_intensity",
            "flops / bytes accessed of one step",
            labels=("program",))
        self.mfu = r.gauge(
            "bigdl_perf_mfu",
            "model flops utilization vs the device peak "
            "(per analyzed program; rolling over recent steps)",
            labels=("program",))
        self.model_flops_per_sec = r.gauge(
            "bigdl_perf_model_flops_per_sec",
            "achieved model FLOP/s (per analyzed program)",
            labels=("program",))
        self.flops_total = r.counter(
            "bigdl_perf_flops_total",
            "counted FLOPs executed (sums across hosts)")
        self.hbm_in_use = r.gauge(
            "bigdl_perf_hbm_bytes_in_use",
            "device memory in use at the last poll")
        self.hbm_peak = r.gauge(
            "bigdl_perf_hbm_peak_bytes",
            "device memory high-watermark at the last poll")
        self.hbm_limit = r.gauge(
            "bigdl_perf_hbm_limit_bytes",
            "device memory capacity reported by the device")

    # -- device ----------------------------------------------------------
    def bind_device(self, device) -> "PerfAccountant":
        """Read the peak and the memory of ``device`` (the model's);
        an explicit ``spec`` given at construction is kept."""
        self.device = torch.device(device)
        if not self._spec_given:
            self._spec = None
        return self

    @property
    def spec(self) -> DeviceSpec:
        if self._spec is None:
            try:
                self._spec = current_device_spec(self.device)
            except Exception:  # no card: nominal denominator
                self._spec = CPU_SPEC
        return self._spec

    # -- step analysis ---------------------------------------------------
    def analyze_step(self, run, label: str = "train_step",
                     collective_bytes: float = 0.0,
                     sparse_bytes_saved: float = 0.0,
                     sync_bytes_saved: float = 0.0):
        """Run ``run()`` once under :class:`WorkCounter` and install its
        count as program ``label``; returns ``(run's result, StepCost)``.
        ``run`` always executes exactly once and its exceptions
        propagate; the cost is None when counting itself failed.
        Block-sparse kernels' executed FLOPs replace their dense
        equivalent through :meth:`report_sparse_flops`, as the JAX
        package's caller books them; the op counter runs the step a
        little slower, so the driver books this step as compile."""
        with WorkCounter() as counter:
            result = run()
        try:
            dense_sparse = sum(f for f, _, _ in counter.sparse)
            cost = StepCost(flops=counter.flops - dense_sparse,
                            bytes_accessed=counter.bytes,
                            collective_bytes=max(0.0, float(
                                collective_bytes or 0.0)))
            cost = self.on_program(label, cost,
                                   sparse_bytes_saved=sparse_bytes_saved,
                                   sync_bytes_saved=sync_bytes_saved)
            if counter.sparse:
                cost = self.report_sparse_flops(
                    label, sum(e for _, e, _ in counter.sparse),
                    sum(d for _, _, d in counter.sparse))
        except Exception as e:
            log.debug("perf: step analysis failed for %r: %s: %s",
                      label, type(e).__name__, e)
            return result, None
        return result, cost

    def on_program(self, label: str, cost: StepCost,
                   sparse_bytes_saved: float = 0.0,
                   sync_bytes_saved: float = 0.0) -> StepCost:
        """Install an analyzed program: publish its static gauges and
        make it the one ``on_step`` attributes work to."""
        label = str(label)
        self._programs[label] = cost
        # a fresh analysis supersedes any kernel-reported sparse
        # correction (the caller re-reports after re-analyzing)
        self._uncorrected.pop(label, None)
        self._sparse_flops.pop(label, None)
        self._current = label
        self.flops_per_step.labels(program=label).set(cost.flops)
        self.bytes_per_step.labels(program=label).set(
            cost.bytes_accessed)
        self.collective_bytes.labels(program=label).set(
            cost.collective_bytes)
        if sparse_bytes_saved:
            self.sparse_bytes_saved.labels(program=label).set(
                float(sparse_bytes_saved))
        if sync_bytes_saved:
            self.sync_bytes_saved.labels(program=label).set(
                float(sync_bytes_saved))
        if cost.arithmetic_intensity is not None:
            self.intensity.labels(program=label).set(
                cost.arithmetic_intensity)
        self.poll_memory_stats()
        return cost

    def report_sparse_flops(self, label: str, executed_flops: float,
                            dense_equiv_flops: float) -> Optional[StepCost]:
        """Kernel-reported effective-FLOPs correction for a program
        whose block-sparse kernels SKIP work.

        The program's count leaves those kernels out (as XLA counts a
        Pallas call as zero), so their skipped blocks would be
        invisible: without this correction a 2x wall-clock win at 50%
        density reads as an MFU regression.  The caller
        (:meth:`analyze_step`, from the kernels' own reports) gives the
        kernels' ``executed`` FLOPs and the ``dense equivalent``; the
        program's accounted FLOPs become ``counted + executed`` (MFU/model_flops_per_sec rate on
        EXECUTED work), the dense equivalent is recorded alongside in
        the payload, and the difference lands in the
        ``bigdl_perf_sparse_flops_skipped`` gauge.  Repeated reports
        for one program replace (never compound) the correction."""
        label = str(label)
        executed = max(0.0, float(executed_flops))
        dense_eq = max(executed, float(dense_equiv_flops))
        base = self._uncorrected.get(label)
        if base is None:
            base = self._programs.get(label, StepCost(0.0, 0.0))
            self._uncorrected[label] = base
        skipped = dense_eq - executed
        corrected = base._replace(flops=base.flops + executed)
        self._programs[label] = corrected
        self._sparse_flops[label] = {
            "executed_flops": base.flops + executed,
            "dense_equivalent_flops": base.flops + dense_eq,
            "sparse_flops_skipped": skipped,
        }
        self.sparse_flops_skipped_gauge.labels(program=label).set(
            skipped)
        self.flops_per_step.labels(program=label).set(corrected.flops)
        if corrected.arithmetic_intensity is not None:
            self.intensity.labels(program=label).set(
                corrected.arithmetic_intensity)
        return corrected

    @property
    def current_cost(self) -> Optional[StepCost]:
        return self._programs.get(self._current) \
            if self._current else None

    @property
    def current_label(self) -> Optional[str]:
        return self._current

    # -- per-step accounting ---------------------------------------------
    def on_step(self, seconds: float, compiled: bool = False,
                label: Optional[str] = None):
        """One step of the current (or named) analyzed program
        completed in ``seconds``.  Compile steps still count their
        FLOPs (the work ran) but are excluded from the MFU rate — the
        first step of an attempt builds kernels and runs under the op
        counter."""
        label = label or self._current
        cost = self._programs.get(label) if label else None
        if cost is None:
            return
        self.flops_total.inc(cost.flops)
        seconds = float(seconds)
        if seconds > 0 and not compiled:
            rate = cost.flops / seconds
            # EMA over recent steps: one outlier step must not own the
            # published MFU, one gauge read must not require history
            prev = self._ema_flops_per_sec.get(label)
            rate = rate if prev is None else (0.8 * prev + 0.2 * rate)
            self._ema_flops_per_sec[label] = rate
            self.model_flops_per_sec.labels(program=label).set(rate)
            peak = self.spec.peak_flops_per_sec
            if peak:
                self.mfu.labels(program=label).set(rate / peak)
        self._steps_seen += 1
        if self._steps_seen % self.memory_poll_every == 0:
            self.poll_memory_stats()

    # -- HBM watermarks --------------------------------------------------
    def poll_memory_stats(self, device=None) -> Optional[dict]:
        """Read the device's memory into the HBM gauges:
        ``torch.cuda.memory_stats()`` (``allocated_bytes.all.current``,
        ``.peak``) and the device's ``total_memory``, under the JAX
        package's keys (``bytes_in_use``, ``peak_bytes_in_use``,
        ``bytes_limit``).  ``device`` defaults to the bound one (else
        ``cuda:0``); an object with a ``memory_stats()`` method is read
        as is.  The CPU has no memory stats: None, never an
        exception."""
        try:
            stats = _memory_stats(device if device is not None
                                  else self.device)
        except Exception as e:
            log.debug("perf: memory_stats unavailable: %s", e)
            return None
        if not stats:
            return None
        self.last_memory_stats = dict(stats)
        if "bytes_in_use" in stats:
            self.hbm_in_use.set(float(stats["bytes_in_use"]))
        if "peak_bytes_in_use" in stats:
            self.hbm_peak.set(float(stats["peak_bytes_in_use"]))
        if "bytes_limit" in stats:
            self.hbm_limit.set(float(stats["bytes_limit"]))
        return self.last_memory_stats

    # -- roofline + export -----------------------------------------------
    def roofline(self, label: Optional[str] = None) -> Optional[dict]:
        cost = self._programs.get(label or self._current or "")
        if cost is None:
            return None
        return classify_roofline(cost, self.spec)

    def span_args(self) -> dict:
        """Work attributes of the current program — attached to every
        step span so Perfetto traces carry intensity annotations even in
        unprofiled runs."""
        cost = self.current_cost
        if cost is None:
            return {}
        out = {"flops": cost.flops, "bytes": cost.bytes_accessed}
        if cost.collective_bytes:
            out["collective_bytes"] = cost.collective_bytes
        if cost.arithmetic_intensity is not None:
            out["intensity"] = round(cost.arithmetic_intensity, 3)
        rf = self.roofline()
        if rf is not None:
            out["bound"] = rf["bound"]
        return out

    def payload(self) -> dict:
        """The ``perf`` section of the telemetry payload (what the
        cross-host merge folds and the run report renders)."""
        programs = {}
        for label, cost in self._programs.items():
            entry = dict(cost._asdict())
            entry["arithmetic_intensity"] = cost.arithmetic_intensity
            rf = classify_roofline(cost, self.spec)
            entry["bound"] = rf["bound"]
            # kernel-reported sparse correction: executed-basis flops
            # with the dense equivalent recorded alongside
            if label in self._sparse_flops:
                entry.update(self._sparse_flops[label])
            rate = self._ema_flops_per_sec.get(label)
            if rate is not None:
                entry["model_flops_per_sec"] = rate
                if self.spec.peak_flops_per_sec:
                    entry["mfu"] = rate / self.spec.peak_flops_per_sec
            programs[label] = entry
        out = {
            "device": self.spec.to_dict(),
            "flops_total": self.flops_total.value,
            "programs": programs,
        }
        if self.last_memory_stats is not None:
            out["hbm"] = {
                k: self.last_memory_stats[k]
                for k in ("bytes_in_use", "peak_bytes_in_use",
                          "bytes_limit")
                if k in self.last_memory_stats}
        return out


def _memory_stats(device) -> Optional[dict]:
    if device is not None and callable(getattr(device, "memory_stats",
                                               None)):
        return device.memory_stats()
    device = torch.device("cuda:0" if device is None else device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return None
    stats = torch.cuda.memory_stats(device)
    return {"bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.get_device_properties(
                device).total_memory}
