"""Device capability table — the ONE copy of per-device peaks
(counterpart of ``bigdl_tpu/telemetry/device_info.py``).

The PerfAccountant's MFU and roofline math, the server's goodput per
chip and ``chip_smoke.py``'s kernel bounds all read it.  The port adds
the H100 row, matched against ``torch.cuda.get_device_name()``; the TPU
rows stay as the reference's table, and no number of the port is taken
from them.

Numbers are public spec-sheet figures per **device**:

* ``peak_flops_per_sec`` — dense bf16 peak, multiply-add counted as
  2 FLOPs (the MFU denominator convention).
* ``hbm_bytes`` / ``hbm_bytes_per_sec`` — HBM capacity and bandwidth
  (the roofline's memory axis; the ridge point is
  ``peak_flops / hbm_bw``).
* ``ici_bytes_per_sec`` — aggregate inter-chip interconnect
  bandwidth.  Interconnect counting conventions vary between spec
  sheets (per-link vs aggregate, per-direction vs bidirectional);
  these are order-of-magnitude figures for roofline *classification*
  (is this program collective-bound?), not for bandwidth accounting.

The CPU row is **nominal** (``nominal=True``): a placeholder peak so
MFU-family metrics stay computable (and testable) on the CPU backend;
absolute CPU MFU values are not meaningful.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

__all__ = [
    "DEVICE_SPECS", "DeviceSpec", "PEAK_FLOPS_TABLE",
    "current_device_spec", "device_kind", "device_spec",
    "peak_flops_per_sec",
]

GiB = 1024 ** 3


class DeviceSpec(NamedTuple):
    """Per-chip capability row (see module docstring for units)."""

    kind: str
    peak_flops_per_sec: float
    hbm_bytes: Optional[float]
    hbm_bytes_per_sec: Optional[float]
    ici_bytes_per_sec: Optional[float]
    nominal: bool = False

    @property
    def ridge_flops_per_byte(self) -> Optional[float]:
        """The roofline ridge point: arithmetic intensity above which
        the chip is compute-bound rather than HBM-bound."""
        if not self.hbm_bytes_per_sec:
            return None
        return self.peak_flops_per_sec / self.hbm_bytes_per_sec

    def to_dict(self) -> dict:
        return dict(self._asdict())


# substring-matched against the device kind (lowercased), first hit
# wins.  H100 SXM ("NVIDIA H100 80GB HBM3"): NVIDIA H100 Tensor Core GPU
# datasheet (SXM5 column): dense BF16 Tensor Core 989 TFLOP/s (1979
# with sparsity), 80 GB HBM3 at 3.35 TB/s, NVLink 900 GB/s.
DEVICE_SPECS = (
    DeviceSpec("h100", 989e12, 80e9, 3.35e12, 900e9),
    DeviceSpec("v6e", 918e12, 32 * GiB, 1640e9, 900e9),
    DeviceSpec("trillium", 918e12, 32 * GiB, 1640e9, 900e9),
    DeviceSpec("v5p", 459e12, 95 * GiB, 2765e9, 1200e9),
    DeviceSpec("v5e", 197e12, 16 * GiB, 819e9, 400e9),
    DeviceSpec("v5litepod", 197e12, 16 * GiB, 819e9, 400e9),
    DeviceSpec("v5 lite", 197e12, 16 * GiB, 819e9, 400e9),
    DeviceSpec("v4", 275e12, 32 * GiB, 1228e9, 1200e9),
    DeviceSpec("v3", 123e12, 32 * GiB, 900e9, 656e9),
    DeviceSpec("v2", 45e12, 16 * GiB, 700e9, 496e9),
)

#: nominal CPU row: ~a few f32 GEMM cores' worth of peak and one
#: DDR channel group of bandwidth — keeps MFU/roofline math exercised
#: on the CPU backend without pretending to measure the host
CPU_SPEC = DeviceSpec("cpu", 100e9, None, 20e9, None, nominal=True)

#: (kind substring, bf16 peak FLOP/s) — the shape bench.py always had
PEAK_FLOPS_TABLE = tuple(
    (s.kind, s.peak_flops_per_sec) for s in DEVICE_SPECS)


def peak_flops_per_sec(device_kind: str) -> Optional[float]:
    """bf16 peak FLOP/s per device for a ``device_kind`` string, or
    None when unknown (the bench.py contract: a CPU/unknown device has
    no honest peak and reports no MFU)."""
    spec = device_spec(device_kind)
    return None if spec is None or spec.nominal \
        else spec.peak_flops_per_sec


def device_spec(device_kind: str) -> Optional[DeviceSpec]:
    """Capability row for a ``device_kind`` string: substring match
    against the table, the nominal CPU row for cpu/host kinds, None
    for anything else."""
    k = (device_kind or "").lower()
    for spec in DEVICE_SPECS:
        if spec.kind in k:
            return spec
    if "cpu" in k or "host" in k or "interpreter" in k:
        return CPU_SPEC
    return None


def device_kind(device=None) -> str:
    """The kind string of a ``torch.device`` (default ``cuda:0``, the
    CPU where there is no card): the CUDA device's name, or ``"cpu"``."""
    import torch

    if device is None:
        device = "cuda:0" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def current_device_spec(device=None) -> DeviceSpec:
    """Spec for a ``torch.device`` (default ``cuda:0``, the CPU where
    there is no card; ``cpu`` gives the nominal CPU row).  Unknown accelerators degrade to the nominal
    CPU row rather than None — the accountant always has *a*
    denominator, flagged ``nominal`` when it is not a measured-peak
    claim."""
    return device_spec(device_kind(device)) or CPU_SPEC
