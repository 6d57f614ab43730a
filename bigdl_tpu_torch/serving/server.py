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

Ported: start/drain/stop, admission, deadlines, the circuit breaker,
micro-batching, ``submit`` and ``submit_generate`` on the non-paged
path.  Not ported yet, and raising when asked for: the paged KV pool
and the disaggregated prefill/decode roles, ``swap_params``, request
tracing, tenants, and a device mesh.
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

from ..resilience.preemption import PreemptionHandler
from ..resilience.retry import RetryPolicy
from .batcher import MicroBatcher
from .breaker import OPEN, PROBE, REJECT, CircuitBreaker
from .metrics import ServingMetrics
from .status import Request, ServeFuture, ServeResult, Status

log = logging.getLogger("bigdl_tpu")


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not ported to bigdl_tpu_torch yet")


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
    """

    def __init__(self, model, mesh=None, max_batch: int = 32,
                 max_queue: int = 256, batch_window_s: float = 0.002,
                 default_deadline_s: Optional[float] = None,
                 breaker: Optional[CircuitBreaker] = None,
                 policy: Optional[RetryPolicy] = None,
                 metrics: Optional[ServingMetrics] = None,
                 generate_dtype: Optional[torch.dtype] = None,
                 name: Optional[str] = None, kv_pool=None,
                 role: str = "both", trace_sink=None,
                 model_name: Optional[str] = None):
        if mesh is not None:
            raise _not_ported("serving over a device mesh")
        if kv_pool is not None or role != "both":
            raise _not_ported("the paged KV pool / prefill-decode roles")
        if trace_sink is not None:
            raise _not_ported("request tracing")
        if model_name is not None:
            raise _not_ported("multi-tenant serving")
        self.name = name
        self.model = model
        self.role = role
        self.batcher = MicroBatcher(max_batch)
        self.metrics = metrics or ServingMetrics()
        self.breaker = breaker or CircuitBreaker()
        self.policy = policy or RetryPolicy.from_properties(
            prefix="bigdl.serving")
        self.generate_dtype = generate_dtype
        self._queue = _BoundedQueue(max_queue)
        self._batch_window_s = float(batch_window_s)
        self._default_deadline_s = default_deadline_s
        self._poll_s = 0.02
        self._model_lock = threading.Lock()
        self._feature_shape = None  # pinned by the first classify submit
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
        return {
            "healthy": self.healthy(),
            "ready": self.ready(),
            "draining": bool(self._draining or self._should_drain()),
            "queue_depth": len(self._queue),
            "breaker": self.breaker.snapshot(),
            "role": self.role,
        }

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

    def submit(self, feature, deadline_s: Optional[float] = None,
               trace=None) -> ServeFuture:
        """One classification/regression request: ``feature`` is a
        single record (no batch dim); the result's ``output`` is the
        model's output row for it, as numpy."""
        if trace is not None:
            raise _not_ported("request tracing")
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
            future=ServeFuture(), submitted_at=now, deadline=deadline))

    def submit_generate(self, prompt_ids, max_new: int,
                        eos_id: Optional[int] = None,
                        pad_id: Optional[int] = None,
                        deadline_s: Optional[float] = None,
                        trace=None) -> ServeFuture:
        """One greedy-decode generation request; the result's
        ``output`` is the generated id row (``max_new`` tokens,
        eos-then-pad per ``models.generate``).  Requests are micro-
        batched with others sharing (prompt_len, max_new, eos, pad)."""
        if trace is not None:
            raise _not_ported("request tracing")
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
            opts=(int(max_new), eos_id, pad_id)))

    def submit_prefill(self, *args, **kwargs):
        raise _not_ported("disaggregated prefill (submit_prefill)")

    def submit_decode(self, *args, **kwargs):
        raise _not_ported("disaggregated decode (submit_decode)")

    def swap_params(self, *args, **kwargs):
        raise _not_ported("hot param swap (swap_params)")

    # ------------------------------------------------------------ worker
    def _note_drain(self):
        self._draining = True

    def _should_drain(self) -> bool:
        return self._preemption is not None \
            and self._preemption.should_stop

    def _resolve(self, req: Request, result: ServeResult):
        now = time.monotonic()
        result.latency_s = now - req.submitted_at
        self.metrics.record(result.status, result.latency_s,
                            result.queued_s)
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
        by (prompt_len, opts)."""
        groups: dict = {}
        for r in reqs:
            if r.kind == "classify":
                key = ("classify",)
            else:
                key = ("generate", r.payload.shape[0], r.opts)
            groups.setdefault(key, []).append(r)
        for key, group in groups.items():
            yield key[0], group

    def _run_group(self, kind: str, reqs: list):
        t_batch = time.monotonic()
        queued = [t_batch - r.submitted_at for r in reqs]
        try:
            if kind == "classify":
                x, bucket = self.batcher.coalesce(
                    [r.payload for r in reqs])
                out = self.model(torch.as_tensor(x, device=self.device))
                # the host copy doubles as the execution barrier —
                # device-side failures surface here, inside the try
                out_np = out.float().cpu().numpy()
            else:
                out_np, bucket = self._run_generate(reqs)
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
        self.metrics.record_batch(len(reqs), bucket)
        for i, (r, q) in enumerate(zip(reqs, queued)):
            self._resolve(r, ServeResult(
                Status.OK, output=out_np[i], queued_s=q, bucket=bucket))

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
        with self._model_lock:
            params = self.model.param_tree()
        ids = gen(params, prompts, max_new, eos_id=eos_id, pad_id=pad_id)
        out = ids.cpu().numpy()[:, prompts.shape[1]:]  # generated tail
        return out, bucket
