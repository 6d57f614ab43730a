"""The port's native host code (counterpart of the crc32c part of
``bigdl_tpu/native`` and ``native/bigdl_tpu_native.cc``).

``crc32c.cc`` is built with ``g++ -O3 -shared`` at first use into
``.torch_kernels/`` at the root of the checkout, keyed by a hash of the
source and the flags (as ``ops/_support.load_cuda_library`` keys the
CUDA libraries), and loaded with ``ctypes``.  A build that fails raises
with the compiler's message: there is no quiet fallback to the
pure-Python table, which would make a checkpoint's crc cost minutes.
Nothing is built when the package is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "crc32c.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / ".torch_kernels"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def _gxx() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found: it builds the native crc32c")
    return found


def library_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libbigdl_native-{h.hexdigest()[:16]}.so"


def load() -> ctypes.CDLL:
    """Build (once per source hash) and load the native library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = library_path()
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
            proc = subprocess.run(
                [_gxx(), *CXX_FLAGS, "-o", str(tmp), str(SRC)],
                capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"building {SRC.name} failed:\n{proc.stderr[-4000:]}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        lib.bigdl_crc32c.restype = ctypes.c_uint32
        lib.bigdl_crc32c.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                     ctypes.c_uint32]
        _lib = lib
        return lib


def crc32c(data, crc: int = 0) -> int:
    """crc32c of ``data`` (any object with the buffer protocol: bytes,
    bytearray, memoryview, a contiguous numpy array), continuing from
    ``crc``.  The bytes are read in place, not copied."""
    lib = load()
    arr = np.frombuffer(memoryview(data).cast("B"), dtype=np.uint8)
    return lib.bigdl_crc32c(arr.ctypes.data if arr.size else None,
                            arr.size, crc & 0xFFFFFFFF)
