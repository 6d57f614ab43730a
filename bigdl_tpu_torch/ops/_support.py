"""What the kernel wrappers share: launch counters, the device check
and the build of the CUDA C++ sources.

CUDA sources under ``ops/csrc/`` are compiled with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, loaded with
``ctypes``: one ``.cu`` file per library, which may include the shared
``*.cuh`` headers beside it.  The build happens at first use, into
``.torch_kernels/`` at the root of the checkout, keyed by a hash of the
source, the headers and the flags, so a changed source rebuilds and an
unchanged one loads.  Libraries build in parallel (one ``nvcc`` each).
Nothing is built or imported when a module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / ".torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class LaunchCounter:
    """How many times a wrapper launched its kernel.  Only the CUDA
    branch of a wrapper adds to it, once per launch."""

    def __init__(self, name: str):
        self.name = name
        self._n = 0
        self._lock = threading.Lock()

    def add(self):
        with self._lock:
            self._n += 1

    def reset(self):
        with self._lock:
            self._n = 0

    @property
    def count(self) -> int:
        return self._n


def split_bf16x3(src: torch.Tensor, out: torch.Tensor) -> None:
    """Writes the three bf16 pieces of the f32 tensor ``src`` into
    ``out[0]``, ``out[1]``, ``out[2]`` (each of src's shape, any strides):
    p1 = bf16(src), p2 = bf16(src − p1), p3 = bf16(src − p1 − p2), each
    rounded to nearest even; the differences are exact in f32, so p1 + p2
    + p3 = src exactly (for |src| above 2^-102).  The f32 kernels on split
    products (K5, K9) read one operand's pieces so, split once per call."""
    out[0].copy_(src)
    rest = src - out[0]
    out[1].copy_(rest)
    rest -= out[1]
    out[2].copy_(rest)


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (the wrapper then takes
    the plain version); False when every one lies on one CUDA device
    (the wrapper launches the kernel).  Anything else raises."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return False


_LIBS: Dict[str, ctypes.CDLL] = {}
_LIB_LOCKS: Dict[str, threading.Lock] = {}
_LOCKS_LOCK = threading.Lock()
#: per library: (build seconds, nvcc's ptxas report), or (0.0, "") on a
#: load of an earlier build
BUILD_INFO: Dict[str, tuple] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin)")


def _source_digest(src: Path) -> str:
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def load_cuda_library(name: str) -> ctypes.CDLL:
    """Build (once per source hash) and load ``csrc/<name>.cu``."""
    with _LOCKS_LOCK:
        lock = _LIB_LOCKS.setdefault(name, threading.Lock())
    with lock:
        if name in _LIBS:
            return _LIBS[name]
        src = CSRC / f"{name}.cu"
        so = BUILD_DIR / f"lib{name}-{_source_digest(src)}.so"
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            t0 = time.perf_counter()
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed for {src.name}:\n{proc.stderr[-4000:]}")
            os.replace(tmp, so)
            BUILD_INFO[name] = (time.perf_counter() - t0, proc.stderr)
        else:
            BUILD_INFO.setdefault(name, (0.0, ""))
        _LIBS[name] = ctypes.CDLL(str(so))
        return _LIBS[name]


def load_cuda_libraries(*names: str) -> Dict[str, ctypes.CDLL]:
    """Build and load several libraries at once, one ``nvcc`` each,
    all started together.  Raises the first build failure."""
    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        libs = list(pool.map(load_cuda_library, names))
    return dict(zip(names, libs))
