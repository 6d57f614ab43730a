"""Background snapshot-then-write checkpointing (counterpart of
``bigdl_tpu/resilience/async_checkpoint.py``).

The training loop serializes a checkpoint's legs at the step boundary
(``utils.file_io.serialize``: tensors copied to the host, pickled) —
after that instant the bytes are fixed, so a resume from an
async-written checkpoint is bitwise the one from a synchronous write.
One writer thread then does the atomic tmp + fsync + rename + crc32c
sidecar write (``utils.file_io.save_bytes``) off the step's path.

* one writer thread: jobs commit in submission order;
* a bounded queue (default depth 1): a submit while the queue is full
  blocks, and returns the seconds it blocked (back-pressure);
* a background failure is stored and raised on the training thread at
  the next ``submit``/``drain`` as :class:`AsyncCheckpointError`, which
  the retry loop treats as a failed synchronous write would be;
* :meth:`AsyncCheckpointWriter.drain` is the barrier the loop runs at
  its exit, before every restore, and on preemption.
"""
from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Callable, Optional, Sequence, Tuple

log = logging.getLogger("bigdl_tpu")

__all__ = ["AsyncCheckpointError", "AsyncCheckpointWriter"]


class AsyncCheckpointError(IOError):
    """A background checkpoint write failed; raised on the training
    thread at the next submit/drain."""


class AsyncCheckpointWriter:
    """One daemon writer thread over a bounded job queue.  A job is a
    sequence of ``(path, bytes)`` files (written in order through
    ``file_io.save_bytes``, atomic + crc32c) and/or a zero-argument
    callable.  The thread starts at the first submit."""

    def __init__(self, queue_depth: int = 1,
                 name: str = "bigdl-ckpt-writer"):
        self.queue_depth = max(1, int(queue_depth))
        self._name = name
        self._cv = threading.Condition(threading.Lock())
        self._jobs: deque = deque()
        self._pending = 0          # queued + in-flight jobs
        self._error: Optional[BaseException] = None
        self._error_step: Optional[int] = None
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        self.writes = 0            # jobs fully committed
        self.write_seconds = 0.0   # background wall seconds writing
        self.blocked_seconds = 0.0  # submit back-pressure, summed

    def _ensure_thread(self):
        if self._thread is None or not self._thread.is_alive():
            self._stop = False
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name=self._name)
            self._thread.start()

    def _run(self):
        while True:
            with self._cv:
                while not self._jobs and not self._stop:
                    self._cv.wait()
                if self._stop and not self._jobs:
                    return
                step, files, fn = self._jobs.popleft()
                self._cv.notify_all()
            t0 = time.monotonic()
            try:
                self._write(files, fn)
                with self._cv:
                    self.writes += 1
                    self.write_seconds += time.monotonic() - t0
            except BaseException as e:  # noqa: BLE001 — raised on the
                #                         training thread by _raise_pending
                log.error("async checkpoint write for step %s failed: "
                          "%s: %s", step, type(e).__name__, e)
                with self._cv:
                    if self._error is None:
                        self._error, self._error_step = e, step
            finally:
                with self._cv:
                    self._pending -= 1
                    self._cv.notify_all()

    @staticmethod
    def _write(files: Sequence[Tuple[str, bytes]],
               fn: Optional[Callable[[], None]]):
        from ..utils import file_io

        for path, data in files or ():
            file_io.save_bytes(data, path, atomic=True, checksum=True)
        if fn is not None:
            fn()

    def _raise_pending(self):
        with self._cv:
            err, step = self._error, self._error_step
            self._error = self._error_step = None
        if err is not None:
            raise AsyncCheckpointError(
                f"background checkpoint write for step {step} failed: "
                f"{type(err).__name__}: {err}") from err

    def submit(self, step: int,
               files: Sequence[Tuple[str, bytes]] = (),
               fn: Optional[Callable[[], None]] = None) -> float:
        """Queue one checkpoint's bytes for the background write.  Blocks
        while the queue is at depth and returns the seconds blocked.
        Raises :class:`AsyncCheckpointError` first if an earlier write
        failed."""
        self._raise_pending()
        self._ensure_thread()
        t0 = time.monotonic()
        with self._cv:
            while self._pending >= self.queue_depth and not self._stop:
                self._cv.wait(0.05)
            self._jobs.append((int(step), tuple(files or ()), fn))
            self._pending += 1
            self._cv.notify_all()
        blocked = time.monotonic() - t0
        with self._cv:
            self.blocked_seconds += blocked
        return blocked

    def drain(self, timeout: Optional[float] = None,
              raise_errors: bool = True) -> bool:
        """Block until every submitted job has committed or failed;
        False on timeout.  With ``raise_errors`` a stored failure is
        raised here."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while self._pending > 0:
                remaining = None if deadline is None \
                    else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return False
                self._cv.wait(remaining if remaining is not None else 0.5)
        if raise_errors:
            self._raise_pending()
        return True

    def close(self, timeout: float = 30.0):
        """Drain and stop the writer thread (idempotent); a stored
        failure still raises."""
        drained = self.drain(timeout=timeout, raise_errors=False)
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=5.0)
        self._thread = None
        if not drained:
            log.warning("async checkpoint writer closed with writes "
                        "still pending after %.0fs", timeout)
        self._raise_pending()

    @property
    def pending(self) -> int:
        with self._cv:
            return self._pending

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False
