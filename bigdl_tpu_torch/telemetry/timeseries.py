"""Bounded in-memory metric time-series — what the SLO engine reads.

The registry (:mod:`.registry`) answers "what is the value NOW"; an
online health verdict needs "how has it been MOVING": a shed counter
is only alarming as a *rate*, a loss gauge as a *slope*, a p99 as a
*windowed* read over fresh traffic.  The :class:`MetricRecorder`
closes that gap without a database: it samples metric families at a
cadence into bounded per-series ring buffers and answers windowed
reductions over them.

* **Sources** — three, composing: :meth:`MetricRecorder.sample` walks
  a live :class:`~.registry.MetricsRegistry`; :meth:`sample_metrics`
  walks any snapshot-shaped dict — including the CLUSTER view the
  existing cross-host fold produces
  (:func:`~.aggregate.merge_metrics`), so a leader records cluster
  series with zero new transport; :meth:`observe` is the direct feed
  control loops use (the autoscaler feeds per-pool signals, the fleet
  health monitor per-replica signals).
* **Counter→rate conversion** — reset-tolerant, prometheus-style: a
  sample smaller than its predecessor reads as a counter reset and
  contributes its own value, never a negative increment.
* **Staleness** — every series remembers when it was last fed;
  :meth:`age`/:meth:`fresh` generalize the autoscaler's "no fresh
  traffic" gate: a signal nobody refreshed is stale history, not an
  actionable value, and the SLO engine renders NO verdict over it.
* **Windowed reducers** — ``last``/``min``/``max``/``mean``/``delta``/
  ``rate``/``ewma``/``p<q>`` window-percentile/robust ``slope``
  (Theil–Sen)/``mad_score`` (median-absolute-deviation anomaly
  score)/``frac_of_max``/``frac_of_min`` — the vocabulary SLO rules
  are written in.

The clock is injectable; tests (and the bench's chaos scenarios)
drive it by hand for deterministic detection latencies.
"""
from __future__ import annotations

import json
import math
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

__all__ = ["MetricRecorder", "Series", "REDUCERS"]


class Series:
    """One bounded (t, value) ring buffer.  ``kind`` decides delta
    semantics: ``counter`` series reduce reset-tolerantly, ``gauge``
    series literally."""

    __slots__ = ("kind", "_samples", "_lock")

    def __init__(self, kind: str = "gauge", capacity: int = 512):
        if kind not in ("gauge", "counter"):
            raise ValueError(f"series kind {kind!r} not gauge|counter")
        self.kind = kind
        self._samples: deque = deque(maxlen=max(2, int(capacity)))
        self._lock = threading.Lock()

    def add(self, t: float, v: float):
        with self._lock:
            self._samples.append((float(t), float(v)))

    def last(self) -> Optional[Tuple[float, float]]:
        with self._lock:
            return self._samples[-1] if self._samples else None

    def window(self, since: float) -> List[Tuple[float, float]]:
        """Samples with t >= since, oldest first — plus the one sample
        immediately BEFORE the window when the series is a counter
        (the increase across the window boundary is real traffic)."""
        with self._lock:
            samples = list(self._samples)
        out = [s for s in samples if s[0] >= since]
        if self.kind == "counter":
            before = [s for s in samples if s[0] < since]
            if before:
                out.insert(0, before[-1])
        return out

    def __len__(self):
        with self._lock:
            return len(self._samples)


# ---------------------------------------------------------------------------
# reducers
# ---------------------------------------------------------------------------

def _increase(samples: Sequence[Tuple[float, float]]) -> float:
    """Reset-tolerant counter increase over ordered samples: a drop
    reads as a reset (the new value IS the increment since it)."""
    inc = 0.0
    for (_, prev), (_, cur) in zip(samples, samples[1:]):
        inc += cur - prev if cur >= prev else cur
    return inc


def _percentile(values: Sequence[float], q: float) -> float:
    s = sorted(values)
    if len(s) == 1:
        return float(s[0])
    pos = q * (len(s) - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(s) - 1)
    return float(s[lo] + (s[hi] - s[lo]) * (pos - lo))


def _median(values: Sequence[float]) -> float:
    return _percentile(values, 0.5)


def _slope(samples: Sequence[Tuple[float, float]]) -> Optional[float]:
    """Robust slope (value per second): Theil–Sen — the median of
    pairwise slopes, so one outlier sample cannot fake a trend.  The
    pair count is capped by even subsampling (the reducer runs inside
    control loops)."""
    if len(samples) < 2:
        return None
    pts = list(samples)
    if len(pts) > 32:
        stride = len(pts) / 32.0
        pts = [pts[int(i * stride)] for i in range(32)]
        if pts[-1] != samples[-1]:
            pts.append(samples[-1])
    slopes = []
    for i in range(len(pts)):
        for j in range(i + 1, len(pts)):
            dt = pts[j][0] - pts[i][0]
            if dt > 0:
                slopes.append((pts[j][1] - pts[i][1]) / dt)
    return _median(slopes) if slopes else None


def _mad_score(values: Sequence[float]) -> Optional[float]:
    """Signed robust anomaly score of the NEWEST value against the
    window: (last - median) / (1.4826 * MAD).  A zero MAD (constant
    window) scores 0 when the last value matches and ±inf when it
    broke away — exactly the "flat line just jumped" case."""
    if len(values) < 3:
        return None
    med = _median(values)
    mad = _median([abs(v - med) for v in values])
    dev = values[-1] - med
    if mad <= 0.0:
        return 0.0 if dev == 0.0 else math.copysign(math.inf, dev)
    return dev / (1.4826 * mad)


def _ewma(samples: Sequence[Tuple[float, float]],
          half_life_s: float) -> Optional[float]:
    if not samples:
        return None
    t_end = samples[-1][0]
    num = den = 0.0
    for t, v in samples:
        w = 0.5 ** ((t_end - t) / max(half_life_s, 1e-9))
        num += w * v
        den += w
    return num / den if den > 0 else None


#: reducer name -> callable(series, samples, **kw).  ``p<q>`` (e.g.
#: ``p99``) is parsed dynamically.
REDUCERS = (
    "last", "min", "max", "mean", "delta", "rate", "ewma", "slope",
    "mad_score", "frac_of_max", "frac_of_min",
)


class MetricRecorder:
    """Cadence-samples metric families into bounded per-series rings
    and answers windowed reductions — see the module docstring.

    Parameters
    ----------
    registry : optional :class:`~.registry.MetricsRegistry` that
        :meth:`sample` walks (families registered later are picked up
        automatically — the walk is by name).
    capacity : ring size per series (512 samples at a 5 s cadence is
        ~42 minutes of history).
    histogram_fields : which derived fields a sampled histogram series
        records (each becomes its own ring: ``count``/``sum`` are
        counter-kind, quantiles/mean gauge-kind).
    """

    def __init__(self, registry=None, capacity: int = 512,
                 clock: Callable[[], float] = time.monotonic,
                 histogram_fields: Sequence[str] = ("count", "sum",
                                                    "p50", "p99")):
        self.registry = registry
        self.capacity = int(capacity)
        self.clock = clock
        self.histogram_fields = tuple(histogram_fields)
        self._series: Dict[Tuple[str, str, str], Series] = {}
        self._lock = threading.Lock()
        self.samples_taken = 0

    # ------------------------------------------------------------ feeding
    @staticmethod
    def _labels_key(labels: Optional[dict]) -> str:
        return json.dumps({k: str(v) for k, v in (labels or {}).items()},
                          sort_keys=True)

    def _get_series(self, family: str, labels: Optional[dict],
                    field: str, kind: str) -> Series:
        key = (str(family), self._labels_key(labels), str(field))
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = self._series[key] = Series(kind=kind,
                                               capacity=self.capacity)
            return s

    def observe(self, family: str, value: float,
                labels: Optional[dict] = None, kind: str = "gauge",
                field: str = "value", now: Optional[float] = None):
        """Direct feed — the control-loop source (no registry walk).
        ``kind`` only matters on first touch of a series."""
        now = self.clock() if now is None else now
        self._get_series(family, labels, field, kind).add(now,
                                                          float(value))

    def sample(self, now: Optional[float] = None):
        """One cadence tick over the live registry: every family's
        every series lands one sample per field."""
        if self.registry is None:
            raise ValueError("recorder built without a registry — use "
                             "observe()/sample_metrics()")
        self.sample_metrics(self.registry.snapshot()["metrics"],
                            now=now)

    def sample_metrics(self, metrics: dict,
                       now: Optional[float] = None):
        """One cadence tick over any snapshot-shaped metrics dict —
        including the merged cluster view
        (:func:`~.aggregate.merge_metrics` output): the cross-host
        series merge rides the existing aggregate fold, not a second
        transport."""
        now = self.clock() if now is None else now
        for name, fam in (metrics or {}).items():
            kind = fam.get("type")
            for series in fam.get("series", ()):
                labels = series.get("labels") or {}
                if kind in ("counter", "gauge"):
                    v = series.get("value")
                    if v is not None:
                        self._get_series(name, labels, "value",
                                         kind).add(now, float(v))
                elif kind == "histogram":
                    for field in self.histogram_fields:
                        v = series.get(field)
                        if v is None:
                            continue
                        fkind = ("counter" if field in ("count", "sum")
                                 else "gauge")
                        self._get_series(name, labels, field,
                                         fkind).add(now, float(v))
        self.samples_taken += 1

    # ------------------------------------------------------------ reading
    def series(self, family: str, labels: Optional[dict] = None,
               field: str = "value") -> Optional[Series]:
        key = (str(family), self._labels_key(labels), str(field))
        with self._lock:
            return self._series.get(key)

    def series_labels(self, family: str,
                      field: str = "value") -> List[dict]:
        """Every label set a family has been fed under (the engine's
        per-replica rule discovery)."""
        with self._lock:
            return [json.loads(lk) for (fam, lk, f) in self._series
                    if fam == family and f == field]

    def age(self, family: str, labels: Optional[dict] = None,
            field: str = "value",
            now: Optional[float] = None) -> Optional[float]:
        """Seconds since the series was last fed; None when it has
        never been fed at all."""
        s = self.series(family, labels, field)
        last = s.last() if s is not None else None
        if last is None:
            return None
        now = self.clock() if now is None else now
        return max(0.0, now - last[0])

    def fresh(self, family: str, labels: Optional[dict] = None,
              field: str = "value", max_age_s: float = 60.0,
              now: Optional[float] = None) -> bool:
        age = self.age(family, labels, field, now=now)
        return age is not None and age <= max_age_s

    def reduce(self, family: str, reducer: str,
               labels: Optional[dict] = None, field: str = "value",
               window_s: float = 60.0, now: Optional[float] = None,
               half_life_s: Optional[float] = None,
               min_samples: int = 1) -> Optional[float]:
        """One windowed reduction; None when the series is missing or
        the window holds fewer than ``min_samples`` samples (no data
        is NO verdict, never a zero)."""
        s = self.series(family, labels, field)
        if s is None:
            return None
        now = self.clock() if now is None else now
        samples = s.window(now - float(window_s))
        if len(samples) < max(1, int(min_samples)):
            return None
        values = [v for _, v in samples]
        if reducer == "last":
            return values[-1]
        if reducer == "min":
            return min(values)
        if reducer == "max":
            return max(values)
        if reducer == "mean":
            return sum(values) / len(values)
        if reducer == "delta":
            if len(samples) < 2:
                return None
            return (_increase(samples) if s.kind == "counter"
                    else values[-1] - values[0])
        if reducer == "rate":
            if len(samples) < 2:
                return None
            dt = samples[-1][0] - samples[0][0]
            if dt <= 0:
                return None
            inc = (_increase(samples) if s.kind == "counter"
                   else values[-1] - values[0])
            return inc / dt
        if reducer == "ewma":
            return _ewma(samples, half_life_s
                         if half_life_s is not None
                         else float(window_s) / 4.0)
        if reducer == "slope":
            return _slope(samples)
        if reducer == "mad_score":
            return _mad_score(values)
        if reducer == "frac_of_max":
            top = max(values)
            return values[-1] / top if top > 0 else None
        if reducer == "frac_of_min":
            bot = min(values)
            return values[-1] / bot if bot > 0 else None
        if reducer.startswith("p") and reducer[1:].isdigit():
            q = int(reducer[1:]) / 100.0
            if not 0.0 <= q <= 1.0:
                raise ValueError(f"percentile {reducer!r} out of range")
            return _percentile(values, q)
        raise ValueError(f"unknown reducer {reducer!r}; one of "
                         f"{REDUCERS} or p<0-100>")

    def snapshot(self) -> dict:
        """Bounded JSON view: per-series sample counts + newest value
        + age (debug/report surface, not a data export)."""
        now = self.clock()
        out = {}
        with self._lock:
            items = list(self._series.items())
        for (fam, lk, field), s in sorted(items):
            last = s.last()
            out.setdefault(fam, []).append({
                "labels": json.loads(lk), "field": field,
                "kind": s.kind, "samples": len(s),
                "last": last[1] if last else None,
                "age_s": (now - last[0]) if last else None,
            })
        return {"series": out, "samples_taken": self.samples_taken}
