"""Event-file writers (counterpart of ``bigdl_tpu/visualization/writer.py``,
a copy on the port's native crc32c; reference
visualization/tensorboard/FileWriter.scala:30, EventWriter.scala:31,
RecordWriter.scala): TFRecord framing + async queue."""
from __future__ import annotations

import os
import queue
import struct
import threading
import time

from .crc32c import masked_crc32c
from .proto import encode_event


class RecordWriter:
    """TFRecord framing: len | crc(len) | data | crc(data)
    (reference RecordWriter.scala + Crc32c.java)."""

    def __init__(self, path: str):
        self._f = open(path, "ab")

    def write(self, data: bytes):
        header = struct.pack("<Q", len(data))
        self._f.write(header)
        self._f.write(struct.pack("<I", masked_crc32c(header)))
        self._f.write(data)
        self._f.write(struct.pack("<I", masked_crc32c(data)))

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()


class EventWriter:
    """One events file; writes the version header event first
    (reference EventWriter.scala:31)."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        fname = f"events.out.tfevents.{int(time.time())}.bigdl_tpu"
        self.path = os.path.join(log_dir, fname)
        self._rw = RecordWriter(self.path)
        self._rw.write(encode_event(time.time(), file_version="brain.Event:2"))
        self._rw.flush()

    def write_event(self, event: bytes):
        self._rw.write(event)

    def flush(self):
        self._rw.flush()

    def close(self):
        self._rw.flush()
        self._rw.close()


#: queue sentinel: everything enqueued before it is on disk once the
#: drain thread reaches it (FIFO), so close() never races a timeout
#: against in-flight events
_CLOSE = None


class FileWriter:
    """Async queued writer (reference FileWriter.scala:30): producers
    enqueue encoded events, a daemon thread drains to disk.

    ``close()`` drains deterministically: a sentinel is enqueued behind
    every pending event and the drain thread exits when it reaches it —
    a burst of events written immediately before ``close()`` is on disk
    when ``close()`` returns, not dropped by a join timeout."""

    def __init__(self, log_dir: str, flush_secs: float = 2.0):
        self._writer = EventWriter(log_dir)
        self._q: "queue.Queue" = queue.Queue()
        self._closed = False
        self._flush_secs = flush_secs
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def add_event(self, event: bytes):
        if self._closed:
            raise ValueError("FileWriter is closed")
        self._q.put(event)
        return self

    def _run(self):
        last_flush = time.time()
        while True:
            try:
                ev = self._q.get(timeout=0.2)
            except queue.Empty:
                if time.time() - last_flush > self._flush_secs:
                    self._writer.flush()
                    last_flush = time.time()
                continue
            try:
                if ev is _CLOSE:
                    return
                self._writer.write_event(ev)
            finally:
                self._q.task_done()
            if time.time() - last_flush > self._flush_secs:
                self._writer.flush()
                last_flush = time.time()

    def flush(self):
        # join() waits for dequeued-but-unwritten events too (an
        # empty() poll would race the writer thread mid-write)
        self._q.join()
        self._writer.flush()

    def close(self):
        if self._closed:
            return
        self._closed = True
        self._q.put(_CLOSE)
        self._thread.join(timeout=30)
        # belt and braces: if the drain thread died (disk error) or the
        # join timed out, write whatever is still queued on this thread
        # rather than dropping it silently
        while True:
            try:
                ev = self._q.get_nowait()
            except queue.Empty:
                break
            try:
                if ev is not _CLOSE:
                    self._writer.write_event(ev)
            finally:
                self._q.task_done()
        self._writer.close()
