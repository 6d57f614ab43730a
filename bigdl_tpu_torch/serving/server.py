"""In-process inference server (counterpart of ``bigdl_tpu/serving/server.py``).

One worker thread owns the device: it pulls admitted requests off a
bounded queue, coalesces them into bucket shapes
(:class:`.batcher.MicroBatcher`) and runs ONE batch at a time —
classification through the model's forward, token generation through
the KV-cache generator (``models.generate.cached_generate``).  The
kernels launch on the worker thread's current CUDA stream.

Request lifecycle (every path ends in a typed
:class:`~.status.ServeResult`; nothing hangs, nothing drops silently)::

    submit ──► admission ──► queue ──► batch ──► device step ──► OK
                  │            │         │            │
                  │ full       │ expired │ breaker    │ step raised
                  ▼            ▼         ▼ open       ▼
              OVERLOADED   DEADLINE_  UNAVAILABLE  INTERNAL_ERROR
              (shed)       EXCEEDED   (reject fast) (+ breaker count)

With a ``kv_pool`` (``serving.kvpool.KVPagePool``) generation serves
through the paged decoder instead: one continuous loop advances every
in-flight request a token per round, each holding pages only for the
positions it has filled; pool exhaustion sheds typed OVERLOADED.  A
``role`` of ``"prefill"`` or ``"decode"`` splits the two phases across
servers (``submit_prefill`` returns a crc-sealed KV handoff blob that
``submit_decode`` continues from, ``serving/pools.py``).

``swap_params`` installs new parameters between batches: a candidate
from a checkpoint file is crc32c-verified (a corrupt file is
quarantined and refused), then faces a canary (the last good
classification batch on the live forward, or a finiteness check of the
params before any has been served); the install copies it into the
model's parameters under the model lock, which the worker holds for
each whole batch, so a batch in flight finishes on the old parameters
and the next one sees the new.  ``resilience.faults.check_serving_fault``
runs before every batch step and before the canary.

With a ``trace_sink`` (``serving.request_trace.ReplicaTraceSink``) a
request that carries a trace context records its phases — queue wait,
batch formation, the device step (``execute``, or ``prefill`` and
``decode`` on the paged path), KV-page export and import, swap windows
and typed failures — as spans under the router's attempt span.  A
phase's span ends once its outputs are on the host, never at a kernel
launch.  A ``model_name`` makes the server one tenant of a multi-model
fleet: it advertises (model, version) in ``health()`` and labels its
phase samples with the request's tenant.

Ported: start/drain/stop, admission, deadlines, the circuit breaker,
micro-batching, ``submit`` and ``submit_generate``, the paged KV pool
with its page window, the prefill/decode roles, the hot swap, request
tracing and tenants.  Not ported yet, and raising when asked for: a
device mesh.
"""
from __future__ import annotations

import collections
import logging
import threading
import time
from contextlib import nullcontext
from typing import Optional

import numpy as np
import torch

from ..resilience import faults as _faults
from ..resilience.guards import tree_finite
from ..resilience.preemption import PreemptionHandler
from ..resilience.retry import RetryPolicy
from ..utils.tree import tree_map
from .batcher import MicroBatcher
from .breaker import OPEN, PROBE, REJECT, CircuitBreaker
from .metrics import ServingMetrics
from .status import Request, ServeFuture, ServeResult, Status

log = logging.getLogger("bigdl_tpu")


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not ported to bigdl_tpu_torch yet")


def _shapes(tree, prefix: str = "") -> dict:
    """Dotted path -> shape of every leaf of a param tree."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tuple(torch.as_tensor(tree).shape)}


class _BoundedQueue:
    """Deque + condition: reject-fast ``try_put``, front requeue for
    the breaker's half-open probe leftovers, and atomic drain."""

    def __init__(self, maxsize: int):
        self.maxsize = int(maxsize)
        self._d: collections.deque = collections.deque()
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)

    def try_put(self, item) -> bool:
        with self._lock:
            if len(self._d) >= self.maxsize:
                return False
            self._d.append(item)
            self._not_empty.notify()
            return True

    def put_front(self, items) -> None:
        """Requeue in original order ahead of newer arrivals (bound
        intentionally not enforced — these were already admitted)."""
        with self._lock:
            for item in reversed(list(items)):
                self._d.appendleft(item)
            self._not_empty.notify()

    def get(self, timeout: float):
        with self._lock:
            if not self._d:
                self._not_empty.wait(timeout)
            return self._d.popleft() if self._d else None

    def get_nowait(self):
        with self._lock:
            return self._d.popleft() if self._d else None

    def drain_all(self) -> list:
        with self._lock:
            items = list(self._d)
            self._d.clear()
            return items


class InferenceServer:
    """See the module docstring for the full request lifecycle.

    Parameters
    ----------
    model : the module to serve, on its device.  Classification runs its
        forward; ``submit_generate`` additionally requires a
        ``TransformerLM``.
    max_batch : largest micro-batch (top of the bucket ladder).
    max_queue : admission bound; a full queue sheds with OVERLOADED.
    batch_window_s : how long the worker waits to coalesce more
        requests after the first one arrives.
    default_deadline_s : per-request deadline when ``submit`` gives
        none (``None`` = no deadline).
    breaker / policy / metrics : injectable for tests; defaults are a
        3-failure threshold breaker and ``RetryPolicy.from_properties``
        classification.
    generate_dtype : compute dtype for the generation path (e.g.
        ``torch.bfloat16``); ``None`` serves in the params' dtype.
    kv_pool : a ``KVPagePool`` on the model's device: generation serves
        through the paged decode path (see the module docstring).
    role : ``"both"`` (default), ``"prefill"`` or ``"decode"`` — which
        generation phase(s) this server serves, advertised in
        ``health()``; a split role requires a ``kv_pool``.
    kv_page_window, kv_page_globals : the page-granular block mask of
        long paged decodes: attend only the first ``kv_page_globals``
        anchor pages + the last ``kv_page_window`` pages (the prefill
        through kernel K6); ``None`` = dense over the page table.
    trace_sink : a ``ReplicaTraceSink``: traced requests record their
        phase spans into it (``None`` = no tracing, one None check a
        request).
    model_name, model_version : the (model, version) this server
        advertises in a multi-tenant fleet; ``None`` = a single-model
        server.
    """

    def __init__(self, model, mesh=None, max_batch: int = 32,
                 max_queue: int = 256, batch_window_s: float = 0.002,
                 default_deadline_s: Optional[float] = None,
                 breaker: Optional[CircuitBreaker] = None,
                 policy: Optional[RetryPolicy] = None,
                 metrics: Optional[ServingMetrics] = None,
                 generate_dtype: Optional[torch.dtype] = None,
                 name: Optional[str] = None, kv_pool=None,
                 role: str = "both",
                 kv_page_window: Optional[int] = None,
                 kv_page_globals: int = 1, trace_sink=None,
                 model_name: Optional[str] = None,
                 model_version: str = "v1"):
        from .pools import ROLES

        if mesh is not None:
            raise _not_ported("serving over a device mesh")
        if role not in ROLES:
            raise ValueError(f"role {role!r} not in {ROLES}")
        if role != "both" and kv_pool is None:
            raise ValueError(
                f"role {role!r} requires a kv_pool (the prefill/"
                f"decode split moves KV pages between pools)")
        if kv_pool is not None and kv_pool.device != model.device:
            raise ValueError(f"kv_pool on {kv_pool.device}, model on "
                             f"{model.device}: the arena must be on the "
                             f"model's device")
        self.name = name
        self.model = model
        #: multi-tenant identity, advertised in ``health()`` for the
        #: router's registry routing; None = a single-model server
        self.model_name = model_name
        self.model_version = str(model_version)
        self.role = role
        #: request tracing (``serving.request_trace.ReplicaTraceSink``);
        #: None = no tracing
        self.trace_sink = trace_sink
        #: paged KV arena: when set, generation serves through the
        #: paged decode path and pool exhaustion sheds typed OVERLOADED
        self.kv_pool = kv_pool
        if kv_pool is not None and model_name is not None \
                and kv_pool.default_owner is None:
            # decoder-internal page allocs charge this model's tenant
            kv_pool.default_owner = model_name
        self.kv_page_window = kv_page_window
        self.kv_page_globals = int(kv_page_globals)
        self.batcher = MicroBatcher(max_batch)
        self.metrics = metrics or ServingMetrics()
        self.metrics.device = model.device
        self.breaker = breaker or CircuitBreaker()
        self.policy = policy or RetryPolicy.from_properties(
            prefix="bigdl.serving")
        self.generate_dtype = generate_dtype
        self._queue = _BoundedQueue(max_queue)
        self._batch_window_s = float(batch_window_s)
        self._default_deadline_s = default_deadline_s
        self._poll_s = 0.02
        # held by the worker for each whole batch and by a swap's
        # install: a batch runs on one set of parameters
        self._model_lock = threading.Lock()
        self._feature_shape = None  # pinned by the first classify submit
        # the last good classification batch: the hot swap's canary
        self._canary_x: Optional[torch.Tensor] = None
        # classify buckets whose forward was already counted (one
        # counted forward per bucket and feature shape, ever)
        self._costed_buckets: set = set()
        #: seconds of the last swap: (verify, canary, install)
        self.last_swap_s: Optional[tuple] = None
        self._worker: Optional[threading.Thread] = None
        self._started = False
        self._draining = False
        self._hard_stop = False
        self._drained = threading.Event()
        self._preemption: Optional[PreemptionHandler] = None

    @property
    def device(self) -> torch.device:
        return self.model.device

    # ------------------------------------------------------------ lifecycle
    def start(self, install_signal_handler: bool = False
              ) -> "InferenceServer":
        """Put the model in eval mode and start the worker.
        ``install_signal_handler=True`` additionally routes SIGTERM/
        SIGINT to a graceful drain (main thread only; off the main
        thread the process-wide ``request_preemption()`` flag still
        drains)."""
        if self._started:
            raise RuntimeError("server already started")
        self.model.evaluate()
        signals = None if install_signal_handler else ()
        self._preemption = PreemptionHandler(
            **({} if signals is None else {"signals": signals}),
            on_request=self._note_drain)
        self._preemption.__enter__()
        self._started = True
        self._draining = False
        self._hard_stop = False
        self._drained.clear()
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="bigdl-serving-worker")
        self._worker.start()
        return self

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Graceful shutdown: stop admission, finish everything already
        admitted, then stop the worker.  Returns True when the worker
        exited within ``timeout``."""
        self._draining = True
        done = self._drained.wait(timeout) if self._worker else True
        if self._worker is not None:
            self._worker.join(timeout)
            done = done and not self._worker.is_alive()
        if self._preemption is not None:
            self._preemption.__exit__(None, None, None)
            self._preemption = None
        self._started = False
        return done

    def stop(self, timeout: Optional[float] = None) -> bool:
        """Hard shutdown: still-queued requests resolve CANCELLED (the
        in-flight batch, if any, completes first)."""
        self._hard_stop = True
        return self.drain(timeout)

    # ------------------------------------------------------------ health
    def healthy(self) -> bool:
        """Liveness: the worker thread is running."""
        return bool(self._started and self._worker
                    and self._worker.is_alive())

    def ready(self) -> bool:
        """Readiness: accepting requests with headroom — started, not
        draining, breaker not open, queue below its bound."""
        return (self.healthy() and not self._draining
                and not self._should_drain()
                and self.breaker.state != OPEN
                and len(self._queue) < self._queue.maxsize)

    def health(self) -> dict:
        out = {
            "healthy": self.healthy(),
            "ready": self.ready(),
            "draining": bool(self._draining or self._should_drain()),
            "queue_depth": len(self._queue),
            "breaker": self.breaker.snapshot(),
            "role": self.role,
        }
        if self.model_name is not None:
            out["model"] = self.model_name
            out["model_version"] = self.model_version
        if self.kv_pool is not None:
            out["kv"] = self.kv_pool.stats()
        return out

    # ------------------------------------------------------------ admission
    def _admit(self, req: Request) -> ServeFuture:
        now = time.monotonic()
        if not self._started or self._draining or self._should_drain():
            self._resolve(req, ServeResult(
                Status.UNAVAILABLE,
                error="server draining" if self._started
                else "server not started"))
            return req.future
        if req.expired(now):
            self._resolve(req, ServeResult(
                Status.DEADLINE_EXCEEDED, error="expired on arrival"))
            return req.future
        self.metrics.record_depth(len(self._queue))
        if not self._queue.try_put(req):
            # load shedding: reject fast, count it, never queue forever
            self._resolve(req, ServeResult(
                Status.OVERLOADED,
                error=f"queue full ({self._queue.maxsize})"))
        return req.future

    def _deadline(self, deadline_s: Optional[float],
                  now: float) -> Optional[float]:
        if deadline_s is None:
            deadline_s = self._default_deadline_s
        return None if deadline_s is None else now + float(deadline_s)

    def _fast_fail_expired(self, deadline: Optional[float],
                           now: float) -> Optional[ServeFuture]:
        """A request whose remaining budget is already <= 0 resolves
        DEADLINE_EXCEEDED before admission, before the queue."""
        if deadline is None or deadline > now:
            return None
        fut = ServeFuture()
        result = ServeResult(Status.DEADLINE_EXCEEDED,
                             error="deadline budget exhausted before "
                                   "admission")
        self.metrics.record(result.status, 0.0, 0.0)
        fut._resolve(result)
        return fut

    @staticmethod
    def _parse_trace(trace):
        """Wire dict (or TraceContext) → TraceContext; malformed
        contexts degrade to untraced, never fail the request."""
        if trace is None:
            return None
        from ..telemetry.trace_context import TraceContext

        return TraceContext.from_wire(trace)

    def _trace(self, req: Request, name: str, category: str,
               start: float, duration: float, **args):
        """Record one request-phase span for a traced request (no-op
        without a sink or context)."""
        if self.trace_sink is not None and req.trace is not None:
            self.trace_sink.record(req.trace, name, category, start,
                                   duration, **args)

    def submit(self, feature, deadline_s: Optional[float] = None,
               trace=None) -> ServeFuture:
        """One classification/regression request: ``feature`` is a
        single record (no batch dim); the result's ``output`` is the
        model's output row for it, as numpy."""
        feature = np.asarray(feature)
        # shape-check at admission: one malformed request must fail ITS
        # caller synchronously, not poison whole batches
        if self._feature_shape is None:
            self._feature_shape = feature.shape
        elif feature.shape != self._feature_shape:
            raise ValueError(
                f"feature shape {feature.shape} does not match this "
                f"server's pinned shape {self._feature_shape}")
        now = time.monotonic()
        deadline = self._deadline(deadline_s, now)
        fast = self._fast_fail_expired(deadline, now)
        if fast is not None:
            return fast
        return self._admit(Request(
            kind="classify", payload=feature,
            future=ServeFuture(), submitted_at=now, deadline=deadline,
            trace=self._parse_trace(trace)))

    def submit_generate(self, prompt_ids, max_new: int,
                        eos_id: Optional[int] = None,
                        pad_id: Optional[int] = None,
                        deadline_s: Optional[float] = None,
                        trace=None) -> ServeFuture:
        """One greedy-decode generation request; the result's
        ``output`` is the generated id row (``max_new`` tokens,
        eos-then-pad per ``models.generate``).  Requests are micro-
        batched with others sharing (prompt_len, max_new, eos, pad)."""
        prompt = np.asarray(prompt_ids, np.int32)
        if prompt.ndim != 1:
            raise ValueError(f"prompt_ids must be 1-D, got shape "
                             f"{prompt.shape}")
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        now = time.monotonic()
        deadline = self._deadline(deadline_s, now)
        fast = self._fast_fail_expired(deadline, now)
        if fast is not None:
            return fast
        return self._admit(Request(
            kind="generate", payload=prompt, future=ServeFuture(),
            submitted_at=now, deadline=deadline,
            opts=(int(max_new), eos_id, pad_id),
            trace=self._parse_trace(trace)))

    def _require_pool(self, what: str):
        if self.kv_pool is None:
            raise RuntimeError(
                f"{what} requires a kv_pool (paged serving); this "
                f"server has none")

    def submit_prefill(self, prompt_ids,
                       deadline_s: Optional[float] = None,
                       trace=None) -> ServeFuture:
        """Prefill-only dispatch for the disaggregated path: run the
        prompt pass, produce the first token, and return a crc-sealed
        KV handoff blob (``result.output``) a decode server can
        continue from.  The prefill server's pages are released as soon
        as the blob is exported."""
        self._require_pool("submit_prefill")
        prompt = np.asarray(prompt_ids, np.int32)
        if prompt.ndim != 1:
            raise ValueError(f"prompt_ids must be 1-D, got shape "
                             f"{prompt.shape}")
        now = time.monotonic()
        deadline = self._deadline(deadline_s, now)
        fast = self._fast_fail_expired(deadline, now)
        if fast is not None:
            return fast
        return self._admit(Request(
            kind="prefill", payload=prompt, future=ServeFuture(),
            submitted_at=now, deadline=deadline,
            trace=self._parse_trace(trace)))

    def submit_decode(self, handoff: bytes, max_new: int,
                      eos_id: Optional[int] = None,
                      pad_id: Optional[int] = None,
                      deadline_s: Optional[float] = None,
                      trace=None) -> ServeFuture:
        """Decode-only dispatch for the disaggregated path: verify
        ``handoff`` (crc32c + geometry), import its pages into this
        server's pool, and stream the remaining ``max_new - 1`` tokens
        (the first one was produced by prefill and rides the handoff).
        The result's ``output`` holds those remaining tokens; a corrupt
        blob resolves INTERNAL_ERROR, a full pool sheds OVERLOADED."""
        self._require_pool("submit_decode")
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        now = time.monotonic()
        deadline = self._deadline(deadline_s, now)
        fast = self._fast_fail_expired(deadline, now)
        if fast is not None:
            return fast
        ctx = self._parse_trace(trace)
        if ctx is None:
            # the context also rides the sealed blob itself (handoff
            # extras), so a decode dispatched outside the router still
            # joins its trace
            from .pools import peek_handoff_trace

            ctx = self._parse_trace(peek_handoff_trace(handoff))
        return self._admit(Request(
            kind="decode", payload=handoff, future=ServeFuture(),
            submitted_at=now, deadline=deadline,
            opts=(int(max_new), eos_id, pad_id), trace=ctx))

    # ------------------------------------------------------------ hot swap
    def swap_params(self, params=None, path: Optional[str] = None,
                    buffers=None, outcome: str = "installed",
                    version: Optional[str] = None) -> bool:
        """Install new params between batches; True on install.

        ``path`` loads through the crc32c-verified checkpoint path
        (:func:`.swap.load_verified_params`): a corrupt file is
        quarantined and the swap refused.  The candidate then faces the
        canary — the last good ``submit`` batch on the live forward, or
        ``tree_finite(params)`` when none has been served; a canary that
        raises or gives non-finite outputs raises :class:`SwapRejected`
        and the server keeps its params.  ``outcome`` names the success
        leg of the swap counter (``"rolled_back"`` for a rollback)."""
        from ..utils.file_io import to_device
        from .swap import SwapRejected, load_verified_params

        if (params is None) == (path is None):
            raise ValueError("pass exactly one of params/path")
        t0 = time.perf_counter()
        t_swap = time.monotonic()

        def note_swap(outcome: str):
            # traced requests overlapping this window see it as a
            # swap_window span in their stitched timeline
            if self.trace_sink is not None:
                self.trace_sink.record_swap_window(
                    t_swap, time.monotonic() - t_swap, outcome)

        try:
            if path is not None:
                params = load_verified_params(path, device=self.device)
            else:
                params = to_device(params, self.device)
            t1 = time.perf_counter()
            # the install copies leaf by leaf: a tree that does not fit
            # the model is refused before any parameter is touched
            want, got = _shapes(self.model.param_tree()), _shapes(params)
            if want != got:
                moved = [k for k in want if k in got and want[k] != got[k]]
                raise SwapRejected(
                    f"candidate params do not fit the model: missing "
                    f"{sorted(set(want) - set(got))[:4]}, extra "
                    f"{sorted(set(got) - set(want))[:4]}, shapes "
                    f"{moved[:4]}")
            canary = self._canary_x
            _faults.check_serving_fault(self.name)
            if canary is not None:
                with torch.no_grad():
                    out = self.model.apply_fn(params, canary)
                if not bool(tree_finite(out)):
                    raise SwapRejected(
                        "canary batch produced non-finite outputs")
            elif not bool(tree_finite(params)):
                raise SwapRejected("candidate params are non-finite")
            t2 = time.perf_counter()
        except SwapRejected:
            self.metrics.record_swap(installed=False)
            note_swap("rejected")
            raise
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception as e:
            self.metrics.record_swap(installed=False)
            note_swap("rejected")
            raise SwapRejected(f"canary batch failed "
                               f"({type(e).__name__}: {e})")
        with self._model_lock:
            self.model.set_param_tree(params)
            if buffers is not None:
                self.model.set_buffer_tree(buffers)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        self.last_swap_s = (t1 - t0, t2 - t1, time.perf_counter() - t2)
        if version is not None:
            self.model_version = str(version)
        self.metrics.record_swap(outcome=outcome)
        note_swap(outcome)
        log.info("serving params hot-swapped%s%s",
                 f" from {path}" if path else "",
                 " (rollback)" if outcome == "rolled_back" else "")
        return True

    def current_params(self):
        """Copies of the (params, buffers) trees now serving — what a
        rollback re-installs."""
        with self._model_lock:
            return (tree_map(lambda t: t.detach().clone(),
                             self.model.param_tree()),
                    tree_map(lambda t: t.detach().clone(),
                             self.model.buffer_tree()))

    # ------------------------------------------------------------ worker
    def _note_drain(self):
        self._draining = True

    def _should_drain(self) -> bool:
        return self._preemption is not None \
            and self._preemption.should_stop

    def _tenant_of(self, req: Request) -> Optional[str]:
        """The tenant a request's phase/latency samples attribute to:
        the trace's tenant when the router stamped one, else this
        server's model (one model ≈ one tenant), else None (untagged
        single-model servers pay no tenant series)."""
        tenant = getattr(req.trace, "tenant", None) \
            if req.trace is not None else None
        return tenant if tenant is not None else self.model_name

    def _resolve(self, req: Request, result: ServeResult):
        now = time.monotonic()
        result.latency_s = now - req.submitted_at
        self.metrics.record(result.status, result.latency_s,
                            result.queued_s,
                            tenant=self._tenant_of(req))
        if req.trace is not None:
            result.trace_id = req.trace.trace_id
            if result.status is not Status.OK:
                # typed failure span: the stitched trace shows WHAT
                # failed on WHICH replica, not just a missing interval
                self._trace(req, f"fail:{req.kind}", "error",
                            req.submitted_at, result.latency_s,
                            status=result.status.value,
                            error=(result.error or "")[:200])
            if self.trace_sink is not None:
                self.trace_sink.finish(req.trace)
        req.future._resolve(result)

    def _gather(self, limit: int) -> list:
        """Block briefly for the first request, then coalesce whatever
        arrives inside the batch window."""
        first = self._queue.get(timeout=self._poll_s)
        if first is None:
            return []
        batch = [first]
        window_end = time.monotonic() + self._batch_window_s
        while len(batch) < limit:
            remaining = window_end - time.monotonic()
            nxt = self._queue.get_nowait() if remaining <= 0 else \
                self._queue.get(timeout=remaining)
            if nxt is None:
                break
            batch.append(nxt)
        return batch

    def _run(self):
        # the kernels launch on THIS thread's current stream of the
        # model's device
        dev = self.device
        ctx = torch.cuda.device(dev) if dev.type == "cuda" \
            else nullcontext()
        try:
            with ctx, torch.no_grad():
                while True:
                    if self._hard_stop:
                        break
                    if self._draining or self._should_drain():
                        self._draining = True
                        if len(self._queue) == 0:
                            break
                    batch = self._gather(self.batcher.max_batch)
                    if not batch:
                        continue
                    # expired-in-queue requests resolve typed, pre-device
                    now = time.monotonic()
                    live = []
                    for r in batch:
                        if r.expired(now):
                            self._resolve(r, ServeResult(
                                Status.DEADLINE_EXCEEDED,
                                error="deadline expired in queue",
                                queued_s=now - r.submitted_at))
                        else:
                            live.append(r)
                    if not live:
                        continue
                    verdict = self.breaker.acquire()
                    if verdict == REJECT:
                        for r in live:
                            self._resolve(r, ServeResult(
                                Status.UNAVAILABLE,
                                error="circuit breaker open"))
                        continue
                    if verdict == PROBE and len(live) > 1:
                        # half-open admits ONE request; the rest requeue
                        self._queue.put_front(live[1:])
                        live = live[:1]
                    for kind, group in self._group(live):
                        # one batch on one set of parameters: a swap
                        # installs between batches
                        with self._model_lock:
                            self._run_group(kind, group)
        finally:
            # hard stop (or a worker crash — nothing may hang): every
            # queued request resolves
            for r in self._queue.drain_all():
                self._resolve(r, ServeResult(
                    Status.CANCELLED, error="server stopped"))
            self._drained.set()

    @staticmethod
    def _group(reqs):
        """Classify requests coalesce together; generate requests group
        by (prompt_len, opts); the paged kinds (prefill / decode) each
        form one group — the continuous paged loop drives them per
        request, whatever their shapes."""
        groups: dict = {}
        for r in reqs:
            if r.kind == "classify":
                key = ("classify",)
            elif r.kind in ("prefill", "decode"):
                key = (r.kind,)
            else:
                key = ("generate", r.payload.shape[0], r.opts)
            groups.setdefault(key, []).append(r)
        for key, group in groups.items():
            yield key[0], group

    def _run_group(self, kind: str, reqs: list):
        if kind in ("prefill", "decode") or (
                kind == "generate" and self.kv_pool is not None):
            return self._run_paged_group(kind, reqs)
        t_batch = time.monotonic()
        queued = [t_batch - r.submitted_at for r in reqs]
        for r, q in zip(reqs, queued):
            self._trace(r, "admission_queue", "queue", r.submitted_at, q)
        x = None
        try:
            _faults.check_serving_fault(self.name)
            if kind == "classify":
                x, bucket = self.batcher.coalesce(
                    [r.payload for r in reqs])
                x = torch.as_tensor(x, device=self.device)
                t_exec = time.monotonic()
                out = self._classify_forward(bucket, x)
                # the host copy doubles as the execution barrier —
                # device-side failures surface here, inside the try
                out_np = out.float().cpu().numpy()
            else:
                t_exec = time.monotonic()
                out_np, bucket = self._run_generate(reqs)
            # the outputs are on the host: the span ends at the card's
            # finish, not at the launch
            t_done = time.monotonic()
            for r in reqs:
                self._trace(r, "batch_form", "batch", t_batch,
                            t_exec - t_batch, batch=len(reqs),
                            bucket=bucket)
                self._trace(r, f"execute:{kind}", "execute", t_exec,
                            t_done - t_exec, bucket=bucket,
                            batch=len(reqs))
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception as e:
            fatal = self.policy.classify(e) == "fatal"
            self.breaker.record_failure(fatal=fatal)
            err = f"{type(e).__name__}: {e}"
            log.warning("serving step failed (%s, %s): %s",
                        "fatal" if fatal else "retryable",
                        self.breaker.state, err)
            for r, q in zip(reqs, queued):
                self._resolve(r, ServeResult(
                    Status.INTERNAL_ERROR, error=err, queued_s=q))
            return
        self.breaker.record_success()
        if x is not None:
            self._canary_x = x
        self.metrics.record_batch(len(reqs), bucket)
        for i, (r, q) in enumerate(zip(reqs, queued)):
            self._resolve(r, ServeResult(
                Status.OK, output=out_np[i], queued_s=q, bucket=bucket))

    def _classify_forward(self, bucket: int, x: torch.Tensor):
        """The batch's forward; the first batch of each bucket (and
        feature shape) runs under the work counter, whose FLOPs go to
        ``record_bucket_cost``, so ``snapshot()`` can report goodput
        per chip (served model-FLOP/s over the device's peak; counterpart
        of the JAX server's ``_account_bucket_cost``).  Counting failing
        never fails the batch."""
        key = (int(bucket), tuple(x.shape[1:]))
        if key in self._costed_buckets:
            return self.model(x)
        self._costed_buckets.add(key)
        from ..telemetry.perf import WorkCounter

        with WorkCounter() as counter:
            out = self.model(x)
        if counter.executed_flops > 0:
            self.metrics.record_bucket_cost(bucket, counter.executed_flops)
        return out

    # ------------------------------------------------------- paged decode
    def _import_handoff(self, blob):
        """Verify a KV handoff blob and materialize it as a live
        PagedSequence in THIS server's pool (crc + geometry checked;
        pages leased here, scattered from the blob)."""
        from ..models.generate import PagedSequence
        from .pools import HandoffCorrupt, deserialize_handoff

        h = deserialize_handoff(blob)
        pool = self.kv_pool
        geometry = (h["layers"], h["num_kv_heads"], h["page_size"],
                    h["head_dim"])
        expect = (pool.layers, pool.num_kv_heads, pool.page_size,
                  pool.head_dim)
        if geometry != expect:
            raise HandoffCorrupt(
                f"handoff geometry {geometry} does not match this "
                f"pool {expect}")
        lease = pool.alloc(int(h["k_pages"].shape[0]))
        try:
            pool.write_pages(lease.pages, h["k_pages"], h["v_pages"],
                             wire_dtype=h.get("kv_dtype"))
        except BaseException:
            lease.release()
            raise
        return PagedSequence(lease, pos=int(h["pos"]),
                             last=int(h["first_token"]),
                             prompt_len=int(h["pos"]))

    def _run_paged_group(self, kind: str, reqs: list):
        """Continuous paged generation: one host loop interleaves every
        in-flight sequence a token at a time, so a long decode never
        blocks a short one and a stop or deadline mid-stream resolves
        typed WITH its pages released.  Outcomes:

        * pool exhaustion (at start or on a mid-decode page extension)
          → typed OVERLOADED shed;
        * a corrupt or mismatched handoff → INTERNAL_ERROR (refused
          before any K/V byte is trusted);
        * deadline mid-decode → DEADLINE_EXCEEDED;
        * hard stop mid-decode → CANCELLED;
        * everything else finishes OK with the unpaged path's
          eos-then-pad emission convention.
        """
        from ..models.generate import _eos_pad, cached_paged_decoder
        from .kvpool import PoolExhausted
        from .pools import serialize_handoff

        pool = self.kv_pool
        decoder = cached_paged_decoder(
            self.model, pool, compute_dtype=self.generate_dtype,
            page_window=self.kv_page_window,
            page_globals=self.kv_page_globals)
        params = self.model.param_tree()

        def fail(req, queued_s, exc):
            fatal = self.policy.classify(exc) == "fatal"
            self.breaker.record_failure(fatal=fatal)
            err = f"{type(exc).__name__}: {exc}"
            log.warning("paged serving %s failed (%s, %s): %s",
                        req.kind, "fatal" if fatal else "retryable",
                        self.breaker.state, err)
            self._resolve(req, ServeResult(Status.INTERNAL_ERROR,
                                           error=err, queued_s=queued_s))

        def entry(req, seq, toks, target, queued_s):
            max_new, eos_id, pad_id = req.opts
            eos, pad = _eos_pad(self.model, eos_id, pad_id)
            return {"req": req, "seq": seq, "toks": toks,
                    "target": target, "eos": eos, "pad": pad,
                    "queued_s": queued_s,
                    "done": eos > 0 and seq.last == eos,
                    "t_decode": time.monotonic(), "steps": 0}

        live = []
        for req in reqs:
            queued_s = time.monotonic() - req.submitted_at
            self._trace(req, "admission_queue", "queue",
                        req.submitted_at, queued_s)
            seq = None
            try:
                _faults.check_serving_fault(self.name)
                if req.kind == "decode":
                    t_g = time.monotonic()
                    seq = self._import_handoff(req.payload)
                    self._trace(req, "kv_import", "kv_gather", t_g,
                                time.monotonic() - t_g,
                                pages=len(seq.lease.pages))
                    # the first token rode the handoff: this dispatch
                    # owes the remaining max_new - 1
                    live.append(entry(req, seq, [], req.opts[0] - 1,
                                      queued_s))
                    continue
                t0 = time.monotonic()
                # the first token comes back as a host int: the span
                # ends when the card has finished the prompt pass
                seq = decoder.start(params, req.payload)
                prefill_s = time.monotonic() - t0
                tenant = self._tenant_of(req)
                self.metrics.record_phase("prefill", prefill_s,
                                          tenant=tenant)
                self.metrics.record_ttft(time.monotonic()
                                         - req.submitted_at, tenant=tenant)
                self._trace(req, "prefill", "prefill", t0, prefill_s,
                            prompt_len=int(req.payload.shape[0]),
                            pages=len(seq.lease.pages))
                if req.kind == "generate":
                    live.append(entry(req, seq, [seq.last], req.opts[0],
                                      queued_s))
                    continue
                t_g = time.monotonic()
                k_pages, v_pages = pool.read_pages(seq.lease.pages)
                extras = {}
                if pool.wire_dtype:
                    extras["kv_dtype"] = pool.wire_dtype
                if req.trace is not None:
                    from ..telemetry.trace_context import TRACE_WIRE_KEY

                    # the context rides the sealed blob: the decode
                    # server joins the trace even when the dispatch
                    # path loses the kwarg
                    extras[TRACE_WIRE_KEY] = req.trace.to_wire()
                blob = serialize_handoff(k_pages, v_pages, seq.last,
                                         seq.pos, pool.page_size,
                                         extras=extras or None)
                self._trace(req, "kv_export", "kv_gather", t_g,
                            time.monotonic() - t_g,
                            pages=len(seq.lease.pages),
                            blob_bytes=len(blob))
                seq.release()
                self.breaker.record_success()
                self.metrics.record_batch(1, 1)
                self._resolve(req, ServeResult(
                    Status.OK, output=blob, queued_s=queued_s, bucket=1))
            except PoolExhausted as e:
                # admission control, not failure: shed typed (the
                # breaker must not trip on a full pool)
                self._resolve(req, ServeResult(
                    Status.OVERLOADED, error=f"KV pool exhausted: {e}",
                    queued_s=queued_s))
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception as e:
                if seq is not None:
                    seq.release()
                fail(req, queued_s, e)
        self.metrics.set_kv_pool(pool.stats())

        def finish(e):
            e["seq"].release()
            # every token is a host int by now: the span ends at the
            # card's last step
            decode_s = time.monotonic() - e["t_decode"]
            tenant = self._tenant_of(e["req"])
            self.metrics.record_phase("decode", decode_s, tenant=tenant)
            if e["steps"]:
                self.metrics.record_tpot(decode_s / e["steps"],
                                         tenant=tenant)
            self._trace(e["req"], "decode", "decode", e["t_decode"],
                        decode_s, steps=e["steps"], tokens=len(e["toks"]))
            self.breaker.record_success()
            self.metrics.record_batch(1, 1)
            self._resolve(e["req"], ServeResult(
                Status.OK, output=np.asarray(e["toks"], np.int32),
                queued_s=e["queued_s"], bucket=1))

        def abort(e, result: ServeResult):
            e["seq"].release()
            self._trace(e["req"], "decode", "decode", e["t_decode"],
                        time.monotonic() - e["t_decode"],
                        steps=e["steps"], aborted=True)
            result.queued_s = e["queued_s"]
            self._resolve(e["req"], result)

        # round-robin continuous decode: every live sequence advances
        # one token per round, so a long decode never starves a short
        # one and page pressure tracks actual lengths
        while live:
            if self._hard_stop:
                for e in live:
                    abort(e, ServeResult(
                        Status.CANCELLED,
                        error="server stopped mid-decode"))
                break
            nxt = []
            for e in live:
                if len(e["toks"]) >= e["target"]:
                    finish(e)
                    continue
                if e["done"]:
                    # eos already emitted: pad-fill (the unpaged path's
                    # convention) without spending device steps
                    e["toks"].extend(
                        [e["pad"]] * (e["target"] - len(e["toks"])))
                    nxt.append(e)
                    continue
                if e["req"].expired(time.monotonic()):
                    abort(e, ServeResult(
                        Status.DEADLINE_EXCEEDED,
                        error="deadline expired mid-decode"))
                    continue
                try:
                    _faults.check_serving_fault(self.name)
                    tok = decoder.step(params, e["seq"])
                except PoolExhausted as exc:
                    abort(e, ServeResult(
                        Status.OVERLOADED,
                        error=f"KV pool exhausted mid-decode: {exc}"))
                    continue
                except (KeyboardInterrupt, SystemExit):
                    raise
                except Exception as exc:
                    e["seq"].release()
                    fail(e["req"], e["queued_s"], exc)
                    continue
                e["steps"] += 1
                e["toks"].append(tok)
                if e["eos"] > 0 and tok == e["eos"]:
                    e["done"] = True
                nxt.append(e)
            live = nxt
        self.metrics.set_kv_pool(pool.stats())

    def _run_generate(self, reqs):
        """One generator call per (bucket, prompt_len, max_new): prompts
        stack along the batch dim and pad up to the bucket by repeating
        the last row."""
        from ..models.generate import cached_generate

        max_new, eos_id, pad_id = reqs[0].opts
        prompts = np.stack([r.payload for r in reqs])
        n = prompts.shape[0]
        bucket = self.batcher.bucket_for(n)
        if n < bucket:
            prompts = np.concatenate(
                [prompts, np.repeat(prompts[-1:], bucket - n, axis=0)],
                axis=0)
        self.batcher.buckets_dispatched.add(
            ("gen", bucket, prompts.shape[1], max_new))
        gen = cached_generate(self.model, compute_dtype=self.generate_dtype)
        params = self.model.param_tree()
        ids = gen(params, prompts, max_new, eos_id=eos_id, pad_id=pad_id)
        out = ids.cpu().numpy()[:, prompts.shape[1]:]  # generated tail
        return out, bucket
