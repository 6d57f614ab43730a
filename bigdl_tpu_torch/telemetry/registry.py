"""Metrics registry — thread-safe counters, gauges, mergeable histograms.

The reference attributed cluster time through named Spark accumulators
("computing time average", Metrics.scala:31); our reproduction grew
four siloed counter bags instead (optim.Metrics, ServingMetrics,
ElasticContext counters, FlightRecorder tallies).  This registry is the
one spine they all land on:

* :class:`Counter` / :class:`Gauge` / :class:`Histogram` with label
  sets, addressed through a :class:`MetricsRegistry` by name — the
  prometheus data model, because it is the one every scraper already
  understands.
* Histograms use **fixed log-spaced buckets** so two histograms with
  the same bucket geometry merge by adding counts — the property the
  cross-host aggregation (:mod:`.aggregate`) depends on.  An optional
  bounded sample window gives *exact* quantiles for local consumers
  (the serving p50/p99 contract); merged histograms fall back to
  bucket interpolation.
* Snapshots export as plain JSON (:meth:`MetricsRegistry.snapshot`)
  and as Prometheus text exposition (:meth:`MetricsRegistry
  .to_prometheus`).
* The clock is injectable so snapshot timestamps are deterministic in
  tests.

Library subsystems (retry, breaker, watchdog, elastic) record into the
process-wide :func:`default_registry`; a
:class:`~bigdl_tpu_torch.telemetry.Telemetry` facade built without an
explicit registry shares it, so resilience counters land in the same
snapshot as the training metrics.
"""
from __future__ import annotations

import bisect
import math
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "default_buckets", "default_registry", "reset_default_registry",
]


def default_buckets(start: float = 1e-6, factor: float = 4.0,
                    count: int = 20) -> Tuple[float, ...]:
    """Fixed log-spaced upper bounds: ``start * factor**i``.  The
    default ladder spans 1µs … ~1100s in 20 buckets — wide enough for
    both a histogram of step times and one of whole-run recoveries."""
    if start <= 0 or factor <= 1 or count < 1:
        raise ValueError("need start > 0, factor > 1, count >= 1")
    return tuple(start * factor ** i for i in range(count))


class Counter:
    """Monotonically increasing count (one labeled series)."""

    def __init__(self, lock: threading.RLock):
        self._lock = lock
        self._value = 0.0

    def inc(self, n: float = 1.0):
        if n < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self._value += float(n)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def _data(self) -> dict:
        return {"value": self.value}


class Gauge:
    """Set-to-current-value metric (one labeled series)."""

    def __init__(self, lock: threading.RLock):
        self._lock = lock
        self._value = 0.0

    def set(self, v: float):
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0):
        with self._lock:
            self._value += float(n)

    def dec(self, n: float = 1.0):
        self.inc(-n)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def _data(self) -> dict:
        return {"value": self.value}


class Histogram:
    """Fixed log-bucket histogram (one labeled series), mergeable.

    ``bounds`` are cumulative upper bounds (le semantics, +inf bucket
    implicit).  Two histograms with identical bounds merge by adding
    bucket counts / count / sum — associatively, which is what lets the
    cross-host leader fold snapshots in any order.

    ``window`` > 0 additionally keeps the most recent raw observations
    for **exact** quantiles (numpy-percentile semantics over the
    window) — the serving p50/p99 contract.  The window never merges
    (exactness does not compose); a merged histogram answers quantiles
    from its buckets by linear interpolation.
    """

    def __init__(self, bounds: Optional[Sequence[float]] = None,
                 window: int = 0,
                 lock: Optional[threading.RLock] = None):
        self.bounds: Tuple[float, ...] = tuple(
            float(b) for b in (bounds if bounds is not None
                               else default_buckets()))
        if list(self.bounds) != sorted(set(self.bounds)):
            raise ValueError("bucket bounds must be strictly increasing")
        self._lock = lock or threading.RLock()
        self.buckets = [0] * (len(self.bounds) + 1)  # + the +inf bucket
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self._window = int(window)
        self._samples: List[float] = []
        # bucket index -> {"value", "trace_id"}: the newest exemplar
        # per bucket (the Prometheus/OpenMetrics exemplar model) —
        # what links a latency bucket to a kept distributed trace
        self._exemplars: Dict[int, dict] = {}

    def observe(self, v: float, exemplar: Optional[str] = None):
        """Record one observation; ``exemplar`` optionally attaches a
        trace id to the covering bucket (newest wins per bucket; the
        wall-clock ``ts`` stamp is what lets the cross-host merge keep
        the newest exemplar per bucket ACROSS hosts)."""
        v = float(v)
        with self._lock:
            idx = bisect.bisect_left(self.bounds, v)
            self.buckets[idx] += 1
            self.count += 1
            self.sum += v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)
            if exemplar is not None:
                self._exemplars[idx] = {"value": v,
                                        "trace_id": str(exemplar),
                                        "ts": time.time()}
            if self._window > 0:
                self._samples.append(v)
                if len(self._samples) > self._window:
                    del self._samples[:len(self._samples) - self._window]

    def exemplars(self) -> Dict[int, dict]:
        with self._lock:
            return {i: dict(e) for i, e in self._exemplars.items()}

    # -- quantiles ------------------------------------------------------
    def quantile(self, q: float) -> Optional[float]:
        """Quantile estimate, ``q`` in [0, 1].  Exact (numpy ``linear``
        interpolation over the bounded sample window) when a window is
        kept; bucket-interpolated otherwise.  None when empty."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} not in [0, 1]")
        with self._lock:
            if self._samples:
                return _exact_quantile(self._samples, q)
            if self.count == 0:
                return None
            return self._bucket_quantile(q)

    def _bucket_quantile(self, q: float) -> float:
        """Prometheus-style interpolation inside the covering bucket,
        clamped to the observed min/max so tails stay honest."""
        rank = q * self.count
        cum = 0
        for i, c in enumerate(self.buckets):
            if c == 0:
                continue
            if cum + c >= rank:
                lo = self.bounds[i - 1] if i > 0 else min(
                    0.0, self.min if self.min is not None else 0.0)
                hi = (self.bounds[i] if i < len(self.bounds)
                      else (self.max if self.max is not None else lo))
                frac = (rank - cum) / c
                v = lo + (hi - lo) * max(0.0, min(1.0, frac))
                return float(min(max(v, self.min), self.max))
            cum += c
        return float(self.max)

    @property
    def mean(self) -> Optional[float]:
        with self._lock:
            return self.sum / self.count if self.count else None

    # -- merging --------------------------------------------------------
    def merge(self, other: "Histogram") -> "Histogram":
        """A NEW histogram holding both inputs' bucket state.  Requires
        identical bucket geometry; windows do not carry over (exact
        quantiles do not compose — the merged histogram interpolates)."""
        if self.bounds != other.bounds:
            raise ValueError(
                f"cannot merge histograms with different bucket bounds "
                f"({len(self.bounds)} vs {len(other.bounds)} buckets)")
        out = Histogram(self.bounds)
        with self._lock, other._lock:
            out.buckets = [a + b for a, b in zip(self.buckets,
                                                 other.buckets)]
            out.count = self.count + other.count
            out.sum = self.sum + other.sum
            mins = [m for m in (self.min, other.min) if m is not None]
            maxs = [m for m in (self.max, other.max) if m is not None]
            out.min = min(mins) if mins else None
            out.max = max(maxs) if maxs else None
        return out

    def _data(self) -> dict:
        with self._lock:
            out = {
                "count": self.count, "sum": self.sum,
                "min": self.min, "max": self.max,
                "bounds": list(self.bounds),
                "buckets": list(self.buckets),
                "p50": self.quantile(0.5) if self.count else None,
                "p99": self.quantile(0.99) if self.count else None,
            }
            if self._exemplars:
                # JSON object keys are strings; keep the snapshot
                # round-trippable
                out["exemplars"] = {str(i): dict(e)
                                    for i, e in self._exemplars.items()}
            return out


def _exact_quantile(samples: Sequence[float], q: float) -> float:
    """numpy.percentile(..., interpolation='linear') without numpy —
    the registry must stay importable before jax/numpy init."""
    s = sorted(samples)
    if len(s) == 1:
        return float(s[0])
    pos = q * (len(s) - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(s) - 1)
    return float(s[lo] + (s[hi] - s[lo]) * (pos - lo))


class _Family:
    """One named metric family: label-tuple → child instance."""

    _KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}

    def __init__(self, name: str, kind: str, help: str,
                 label_names: Sequence[str], lock: threading.RLock,
                 **child_kw):
        self.name = name
        self.kind = kind
        self.help = help
        self.label_names = tuple(label_names)
        self._lock = lock
        self._child_kw = child_kw
        self._children: Dict[Tuple[str, ...], object] = {}

    def labels(self, **kv):
        if set(kv) != set(self.label_names):
            raise ValueError(
                f"{self.name}: expected labels {self.label_names}, "
                f"got {tuple(kv)}")
        key = tuple(str(kv[n]) for n in self.label_names)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                if self.kind == "histogram":
                    child = Histogram(lock=self._lock, **self._child_kw)
                else:
                    child = self._KINDS[self.kind](self._lock)
                self._children[key] = child
            return child

    # unlabeled families act as their single child
    def _default(self):
        if self.label_names:
            raise ValueError(f"{self.name} requires labels "
                             f"{self.label_names}")
        return self.labels()

    def inc(self, n: float = 1.0):
        self._default().inc(n)

    def set(self, v: float):
        self._default().set(v)

    def dec(self, n: float = 1.0):
        self._default().dec(n)

    def observe(self, v: float, exemplar: Optional[str] = None):
        self._default().observe(v, exemplar=exemplar)

    def quantile(self, q: float):
        return self._default().quantile(q)

    @property
    def value(self):
        return self._default().value

    @property
    def count(self):
        return self._default().count

    @property
    def sum(self):
        return self._default().sum

    @property
    def mean(self):
        return self._default().mean

    @property
    def min(self):
        return self._default().min

    @property
    def max(self):
        return self._default().max

    def series(self) -> List[Tuple[Dict[str, str], object]]:
        with self._lock:
            return [(dict(zip(self.label_names, key)), child)
                    for key, child in sorted(self._children.items())]


class MetricsRegistry:
    """Name → metric family, with get-or-create semantics (a second
    registration with the same name returns the existing family, and a
    conflicting kind/labels raises — two subsystems cannot silently
    split one name)."""

    def __init__(self, clock: Callable[[], float] = time.time):
        self._lock = threading.RLock()
        self._clock = clock
        self._families: Dict[str, _Family] = {}

    # -- registration ---------------------------------------------------
    def _register(self, name: str, kind: str, help: str,
                  labels: Sequence[str], **child_kw) -> _Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind or fam.label_names != tuple(labels):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.kind}{fam.label_names}, cannot re-register "
                        f"as {kind}{tuple(labels)}")
                return fam
            fam = _Family(name, kind, help, labels, self._lock,
                          **child_kw)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> _Family:
        return self._register(name, "counter", help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> _Family:
        return self._register(name, "gauge", help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (),
                  bounds: Optional[Sequence[float]] = None,
                  window: int = 0) -> _Family:
        return self._register(name, "histogram", help, labels,
                              bounds=bounds, window=window)

    def get(self, name: str) -> Optional[_Family]:
        with self._lock:
            return self._families.get(name)

    # -- export ---------------------------------------------------------
    def snapshot(self) -> dict:
        """JSON-serializable view of every family and series."""
        with self._lock:
            fams = list(self._families.values())
        out = {"ts": self._clock(), "metrics": {}}
        for fam in fams:
            out["metrics"][fam.name] = {
                "type": fam.kind, "help": fam.help,
                "series": [{"labels": labels, **child._data()}
                           for labels, child in fam.series()],
            }
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (0.0.4): HELP/TYPE plus
        one line per series; histograms expand to cumulative
        ``_bucket{le=...}`` lines and ``_sum``/``_count``."""
        lines: List[str] = []
        with self._lock:
            fams = list(self._families.values())
        for fam in fams:
            if fam.help:
                lines.append(f"# HELP {fam.name} "
                             f"{_esc_help(fam.help)}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            for labels, child in fam.series():
                if fam.kind == "histogram":
                    cum = 0
                    exemplars = child.exemplars()
                    for i, (bound, c) in enumerate(zip(
                            list(child.bounds) + [float("inf")],
                            child.buckets)):
                        cum += c
                        le = dict(labels, le=_fmt_float(bound))
                        line = (f"{fam.name}_bucket"
                                f"{_label_str(le)} {cum}")
                        ex = exemplars.get(i)
                        if ex is not None:
                            # OpenMetrics exemplar syntax: the bucket
                            # links to a kept distributed trace
                            line += (' # {trace_id="%s"} %s'
                                     % (ex["trace_id"],
                                        _fmt_float(ex["value"])))
                        lines.append(line)
                    lines.append(f"{fam.name}_sum{_label_str(labels)} "
                                 f"{_fmt_float(child.sum)}")
                    lines.append(f"{fam.name}_count"
                                 f"{_label_str(labels)} {child.count}")
                else:
                    lines.append(f"{fam.name}{_label_str(labels)} "
                                 f"{_fmt_float(child.value)}")
        return "\n".join(lines) + "\n"


def _fmt_float(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    return repr(float(v))


def _esc_help(s: str) -> str:
    return s.replace("\\", r"\\").replace("\n", r"\n")


def _label_str(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    body = ",".join(
        '{}="{}"'.format(k, str(v).replace("\\", r"\\")
                         .replace('"', r"\"").replace("\n", r"\n"))
        for k, v in sorted(labels.items()))
    return "{" + body + "}"


# ---------------------------------------------------------------------------
# the process-wide registry library subsystems record into
# ---------------------------------------------------------------------------

_default_lock = threading.Lock()
_default: Optional[MetricsRegistry] = None


def default_registry() -> MetricsRegistry:
    """The process-wide registry.  Resilience/serving internals count
    into it unconditionally (counters are cheap); a Telemetry facade
    built without an explicit registry adopts it, so one snapshot
    carries the whole process."""
    global _default
    with _default_lock:
        if _default is None:
            _default = MetricsRegistry()
        return _default


def reset_default_registry() -> MetricsRegistry:
    """Swap in a fresh default registry (tests isolate with this)."""
    global _default
    with _default_lock:
        _default = MetricsRegistry()
        return _default
