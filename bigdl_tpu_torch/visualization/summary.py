"""Train/Validation/Serving/Telemetry summaries (counterpart of
``bigdl_tpu/visualization/summary.py``, trimmed to the train,
validation, serving and telemetry streams; reference
visualization/Summary.scala:32, TrainSummary.scala:32,
ValidationSummary.scala) — scalar + histogram
events, TensorBoard-compatible, with trigger control per tag.  The
elastic and integrity streams are not ported yet."""
from __future__ import annotations

import os
import struct
import time
from typing import Dict, List, Tuple

import numpy as np

from .proto import (
    decode_fields, encode_event, encode_histogram, encode_summary,
    encode_summary_value,
)
from .writer import FileWriter


def scalar_event(tag: str, value: float, step: int) -> bytes:
    return encode_event(time.time(), step=step, summary=encode_summary(
        [encode_summary_value(tag, simple_value=float(value))]))


def histogram_event(tag: str, values, step: int) -> bytes:
    """Histogram with TF's exponential bucketing (reference Summary.scala:108)."""
    v = np.asarray(values, np.float64).reshape(-1)
    if v.size == 0:
        v = np.zeros(1)
    limits: List[float] = []
    cur = 1e-12
    while cur < 1e20:
        limits.append(cur)
        cur *= 1.1
    limits = sorted(set([-x for x in limits] + [0.0] + limits))
    counts, _ = np.histogram(v, bins=[-np.inf] + limits[1:] + [np.inf])
    histo = encode_histogram(
        float(v.min()), float(v.max()), float(v.size), float(v.sum()),
        float((v * v).sum()), limits, counts.astype(float).tolist())
    return encode_event(time.time(), step=step, summary=encode_summary(
        [encode_summary_value(tag, histo=histo)]))


class Summary:
    def __init__(self, log_dir: str, app_name: str):
        self.log_dir = os.path.join(log_dir, app_name)
        self.writer = FileWriter(self.log_dir)
        self.triggers: Dict[str, object] = {}

    def add_scalar(self, tag: str, value: float, step: int):
        self.writer.add_event(scalar_event(tag, value, step))
        return self

    def add_histogram(self, tag: str, values, step: int):
        self.writer.add_event(histogram_event(tag, values, step))
        return self

    def read_scalar(self, tag: str) -> List[Tuple[int, float]]:
        self.writer.flush()
        return read_scalars(self.log_dir, tag)

    def close(self):
        self.writer.close()


class TrainSummary(Summary):
    """reference TrainSummary.scala:32 — Loss+Throughput every iteration
    by default; LearningRate/Parameters opt-in via set_summary_trigger."""

    def __init__(self, log_dir: str, app_name: str):
        super().__init__(log_dir, os.path.join(app_name, "train"))

    def set_summary_trigger(self, name: str, trigger):
        if name not in ("Loss", "Throughput", "LearningRate", "Parameters"):
            raise ValueError(f"unsupported summary tag {name}")
        self.triggers[name] = trigger
        return self


class ValidationSummary(Summary):
    """reference ValidationSummary.scala"""

    def __init__(self, log_dir: str, app_name: str):
        super().__init__(log_dir, os.path.join(app_name, "validation"))


class ServingSummary(Summary):
    """Serving-path metrics stream (``<app>/serving``) — the export
    target of ``serving.metrics.ServingMetrics.to_summary`` (per-
    request p50/p99 latency, queue depth, shed/timeout/trip counts),
    so serving health lands next to the train/validation curves in
    the same tensorboard layout."""

    def __init__(self, log_dir: str, app_name: str):
        super().__init__(log_dir, os.path.join(app_name, "serving"))


class TelemetrySummary(Summary):
    """Telemetry stream (``<app>/telemetry``) — the export target of
    :meth:`bigdl_tpu_torch.telemetry.Telemetry.to_summary`: the goodput
    ledger (``telemetry/goodput_fraction``, ``telemetry/accounted_
    fraction``, per-category seconds) and headline counters
    (``telemetry/steps_total``, ``telemetry/recovery_windows``), so
    "where did the wall clock go" lands next to the train/validation
    curves in the same tensorboard layout."""

    def __init__(self, log_dir: str, app_name: str):
        super().__init__(log_dir, os.path.join(app_name, "telemetry"))


def read_scalars(log_dir: str, tag: str) -> List[Tuple[int, float]]:
    """Read scalar events back (reference tensorboard/FileReader —
    serves the python ``summary_read_scalar`` API)."""
    out = []
    if not os.path.isdir(log_dir):
        return out
    for fname in sorted(os.listdir(log_dir)):
        if "tfevents" not in fname:
            continue
        with open(os.path.join(log_dir, fname), "rb") as f:
            data = f.read()
        pos = 0
        while pos + 12 <= len(data):
            (length,) = struct.unpack("<Q", data[pos:pos + 8])
            pos += 12  # len + len-crc
            record = data[pos:pos + length]
            pos += length + 4  # data + data-crc
            step, summary = 0, None
            for field, wire, val in decode_fields(record):
                if field == 2 and wire == 0:
                    step = val
                elif field == 5 and wire == 2:
                    summary = val
            if summary is None:
                continue
            for field, wire, val in decode_fields(summary):
                if field == 1 and wire == 2:
                    vtag, vval = None, None
                    for f2, w2, v2 in decode_fields(val):
                        if f2 == 1 and w2 == 2:
                            vtag = v2.decode("utf-8")
                        elif f2 == 2 and w2 == 5:
                            vval = v2
                    if vtag == tag and vval is not None:
                        out.append((step, vval))
    return out
