"""Structured step tracer — nested spans into a bounded ring buffer,
exported as Chrome-trace JSON (the format Perfetto / chrome://tracing
load directly).

Where the registry answers "how many / how long on average", the
tracer answers "what was the wall clock doing at second 83": every
driver iteration records a ``step`` span whose children attribute the
time to an explicit category — ``data_wait`` (input pipeline),
``host_to_device`` (infeed), ``compile`` (an attempt's first step),
``compute`` / ``collective`` (the torch.profiler phase split of a
profiled step, optim/profiling.py), ``checkpoint``, ``recovery``.  The buffer is a
ring: a week-long run keeps the most recent ``capacity`` spans instead
of growing without bound.

Spans nest two ways:

* :meth:`Tracer.span` — a context manager pushing onto a thread-local
  stack; children opened inside it are linked to it and cannot
  outlive it (closing the parent closes abandoned children).
* :meth:`Tracer.record` — retroactive insertion with explicit
  ``start``/``duration`` (and optionally an explicit ``parent``), for
  timings that are only known after the fact — e.g. the profiler's
  compute/collective split of a step that already ended.  Children
  recorded under a parent are clamped into the parent's interval, so
  the no-child-outlives-its-parent invariant holds for exports.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from .trace_context import REQUEST_CATEGORIES

__all__ = ["CATEGORIES", "STEP_CATEGORIES", "Span", "Tracer"]

#: the training-side vocabulary — everything the goodput ledger can
#: attribute a second of wall clock to, plus the profiled split of
#: on-device time
STEP_CATEGORIES = (
    "step", "data_wait", "host_to_device", "compile", "compute",
    "collective", "checkpoint", "recovery", "idle", "other",
)

#: the closed vocabulary of span categories: the training table above
#: plus the request-path table (ONE shared constant source —
#: ``telemetry.trace_context.REQUEST_CATEGORIES`` — so router, server
#: and tracer can never drift; a vocabulary lint enforces it)
CATEGORIES = STEP_CATEGORIES + REQUEST_CATEGORIES


class Span:
    __slots__ = ("id", "name", "category", "start", "end", "tid",
                 "parent_id", "args")

    def __init__(self, id: int, name: str, category: str, start: float,
                 tid: int, parent_id: Optional[int],
                 args: Optional[dict]):
        self.id = id
        self.name = name
        self.category = category
        self.start = start
        self.end: Optional[float] = None
        self.tid = tid
        self.parent_id = parent_id
        self.args = args

    @property
    def duration(self) -> float:
        return (self.end - self.start) if self.end is not None else 0.0

    def __repr__(self):
        return (f"Span({self.name!r}, cat={self.category!r}, "
                f"dur={self.duration:.6f}s)")

    def to_dict(self) -> dict:
        """JSON-serializable form — what trace fragments and telemetry
        payloads publish over the KV transport."""
        out = {"id": self.id, "name": self.name, "cat": self.category,
               "start": self.start, "dur": self.duration,
               "tid": self.tid}
        if self.parent_id is not None:
            out["parent_id"] = self.parent_id
        if self.args:
            out["args"] = dict(self.args)
        return out


class _SpanCtx:
    """Context manager for one open span (returned by Tracer.span)."""

    __slots__ = ("_tracer", "span")

    def __init__(self, tracer: "Tracer", span: Span):
        self._tracer = tracer
        self.span = span

    def __enter__(self) -> Span:
        return self.span

    def __exit__(self, exc_type, exc, tb):
        self._tracer._close(self.span)
        return False


class Tracer:
    def __init__(self, capacity: int = 8192,
                 clock: Callable[[], float] = time.perf_counter,
                 enabled: bool = True):
        self.capacity = int(capacity)
        self._clock = clock
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        self._done: deque = deque(maxlen=self.capacity)
        self._local = threading.local()
        self._next_id = 0
        self.dropped = 0  # spans evicted from the ring

    # -- internals ------------------------------------------------------
    def _stack(self) -> List[Span]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _alloc_id(self) -> int:
        with self._lock:
            self._next_id += 1
            return self._next_id

    def _finish(self, span: Span):
        with self._lock:
            if len(self._done) == self._done.maxlen:
                self.dropped += 1
            self._done.append(span)

    # -- recording ------------------------------------------------------
    def span(self, name: str, category: str = "other",
             **args) -> _SpanCtx:
        """Open a nested span: ``with tracer.span("step", "step") as s``.
        Children opened on the same thread while it is open are linked
        to it."""
        _check_category(category)
        stack = self._stack()
        parent = stack[-1] if stack else None
        s = Span(self._alloc_id(), str(name), category, self._clock(),
                 threading.get_ident(),
                 parent.id if parent else None, args or None)
        if self.enabled:
            stack.append(s)
        else:
            s.end = s.start  # disabled: a zero-width tombstone, not kept
        return _SpanCtx(self, s)

    def _close(self, span: Span):
        if not self.enabled and span.end is not None:
            return
        now = self._clock()
        stack = self._stack()
        # close abandoned children first (an exception can unwind past
        # a child's __exit__ only through re-entrancy bugs; be safe)
        while stack and stack[-1] is not span:
            child = stack.pop()
            child.end = now
            self._finish(child)
        if stack and stack[-1] is span:
            stack.pop()
        span.end = now
        self._finish(span)

    def record(self, name: str, category: str, start: float,
               duration: float, parent: Optional[Span] = None,
               **args) -> Optional[Span]:
        """Retroactively insert a completed span.  With ``parent``, the
        interval is clamped into the parent's so no child outlives it
        (profiler-derived children are estimates, not clock truths)."""
        if not self.enabled:
            return None
        _check_category(category)
        start = float(start)
        end = start + max(0.0, float(duration))
        if parent is not None and parent.end is not None:
            start = min(max(start, parent.start), parent.end)
            end = min(max(end, start), parent.end)
        tid = threading.get_ident()
        # one lock round trip (id alloc + ring append) — retroactive
        # records run on serving hot paths
        with self._lock:
            self._next_id += 1
            s = Span(self._next_id, str(name), category, start, tid,
                     parent.id if parent else None, args or None)
            s.end = end
            if len(self._done) == self._done.maxlen:
                self.dropped += 1
            self._done.append(s)
        return s

    @property
    def clock(self) -> Callable[[], float]:
        return self._clock

    # -- export ---------------------------------------------------------
    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._done)

    def clear(self):
        with self._lock:
            self._done.clear()

    def export_spans(self, limit: Optional[int] = None) -> List[dict]:
        """The newest ``limit`` completed spans as JSON-serializable
        dicts (all of them when ``limit`` is None) — what
        ``Telemetry.payload`` publishes for the cluster timeline."""
        spans = self.spans()
        if limit is not None and len(spans) > int(limit):
            spans = spans[-int(limit):]
        return [s.to_dict() for s in spans]

    def category_totals(self) -> Dict[str, float]:
        """Seconds per category, summed over completed spans.  ``step``
        spans count their SELF time (step minus attributed children),
        so a step with profiled compute/collective children does not
        double-report."""
        spans = self.spans()
        child_sum: Dict[int, float] = {}
        for s in spans:
            if s.parent_id is not None:
                child_sum[s.parent_id] = (child_sum.get(s.parent_id, 0.0)
                                          + s.duration)
        out: Dict[str, float] = {}
        for s in spans:
            dur = s.duration
            if s.category == "step":
                dur = max(0.0, dur - child_sum.get(s.id, 0.0))
            out[s.category] = out.get(s.category, 0.0) + dur
        return out

    def to_chrome_trace(self) -> dict:
        """Chrome-trace ("Trace Event Format") JSON dict — load it in
        Perfetto (ui.perfetto.dev) or chrome://tracing.  Complete
        ("ph":"X") events, microsecond timestamps."""
        pid = os.getpid()
        events = []
        for s in self.spans():
            ev = {
                "name": s.name, "cat": s.category, "ph": "X",
                "ts": s.start * 1e6, "dur": s.duration * 1e6,
                "pid": pid, "tid": s.tid,
            }
            args = dict(s.args or {})
            args["span_id"] = s.id
            if s.parent_id is not None:
                args["parent_id"] = s.parent_id
            ev["args"] = args
            events.append(ev)
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def export_json(self, path: str):
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)


_CATEGORY_SET = frozenset(CATEGORIES)


def _check_category(category: str):
    if category not in _CATEGORY_SET:
        raise ValueError(f"unknown span category {category!r}; one of "
                         f"{CATEGORIES}")
