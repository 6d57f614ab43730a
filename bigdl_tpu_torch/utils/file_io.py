"""Save/load of trees, optim methods and checkpoint legs (counterpart of
``bigdl_tpu/utils/file_io.py``; reference utils/File.scala:67-160).

Paths carry an optional scheme the way the reference's Hadoop-path seam
does: ``scheme://...`` routes through a backend registered with
:func:`register_filesystem`; bare (or ``file://``) paths use the local
filesystem; any other scheme falls back to fsspec (``memory://``,
``gs://``, ``s3://`` where their fsspec packages are installed), as in
the JAX package.  ``fsspec`` is imported only when such a path is
used; without it, or for a protocol it does not know, the path raises
``ValueError`` naming ``register_filesystem``.

Serialization is pickle (protocol 5).  :func:`serialize` moves every
tensor to the CPU first and pickles it as its dtype, shape and raw
bytes, so the result owns no device memory (a background writer may
hold it while training overwrites the parameters it came from) and
unpickles in a process without a card.  :func:`load` puts the tensors
on the caller's device.
"""
from __future__ import annotations

import io
import os
import pickle
from typing import Any, Dict, List, Optional

import torch

# --------------------------------------------------------------------------
# Filesystem seam (reference File.scala getFileSystem/saveToHdfs:67-160)
# --------------------------------------------------------------------------


class FileSystemBackend:
    """The filesystem surface the checkpoint layer needs; custom schemes
    plug in with :func:`register_filesystem`."""

    def open(self, path: str, mode: str):
        raise NotImplementedError

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def makedirs(self, path: str):
        raise NotImplementedError

    def listdir(self, path: str) -> List[str]:
        """Base names of the directory's entries."""
        raise NotImplementedError

    def isdir(self, path: str) -> bool:
        raise NotImplementedError


def _strip_file_scheme(path: str) -> str:
    return path[len("file://"):] if path.startswith("file://") else path


class _LocalBackend(FileSystemBackend):
    def open(self, path, mode):
        return open(_strip_file_scheme(path), mode)

    def exists(self, path):
        return os.path.exists(_strip_file_scheme(path))

    def makedirs(self, path):
        os.makedirs(_strip_file_scheme(path), exist_ok=True)

    def listdir(self, path):
        return os.listdir(_strip_file_scheme(path))

    def isdir(self, path):
        return os.path.isdir(_strip_file_scheme(path))


class _FsspecBackend(FileSystemBackend):
    """Adapter over an fsspec filesystem instance."""

    def __init__(self, scheme: str):
        import fsspec

        self.fs = fsspec.filesystem(scheme)

    def open(self, path, mode):
        return self.fs.open(path, mode)

    def exists(self, path):
        return self.fs.exists(path)

    def makedirs(self, path):
        self.fs.makedirs(path, exist_ok=True)

    def listdir(self, path):
        return [p.rstrip("/").rsplit("/", 1)[-1]
                for p in self.fs.ls(path, detail=False)]

    def isdir(self, path):
        return self.fs.isdir(path)


_FILESYSTEMS: Dict[str, FileSystemBackend] = {}
_LOCAL = _LocalBackend()


def register_filesystem(scheme: str, backend: FileSystemBackend):
    """Plug a backend for ``scheme://`` paths (reference File.scala's
    Hadoop-FileSystem-by-URI dispatch)."""
    _FILESYSTEMS[scheme] = backend


def _scheme_of(path: str) -> str:
    return path.split("://", 1)[0] if "://" in path else ""


def filesystem_for(path: str) -> FileSystemBackend:
    scheme = _scheme_of(path)
    if not scheme or scheme == "file":
        return _LOCAL
    if scheme not in _FILESYSTEMS:
        try:
            _FILESYSTEMS[scheme] = _FsspecBackend(scheme)
        except Exception as e:  # no fsspec / unknown protocol
            raise ValueError(
                f"no filesystem backend for scheme {scheme!r} "
                f"(register one with register_filesystem): {e}")
    return _FILESYSTEMS[scheme]


def _dirname(path: str) -> str:
    if "://" in path:
        scheme, rest = path.split("://", 1)
        d = rest.rsplit("/", 1)[0] if "/" in rest else ""
        return f"{scheme}://{d}" if d else ""
    return os.path.dirname(path)


def exists(path: str) -> bool:
    return filesystem_for(path).exists(path)


def isdir(path: str) -> bool:
    return filesystem_for(path).isdir(path)


def listdir(path: str) -> List[str]:
    return filesystem_for(path).listdir(path)


def join(path: str, *parts: str) -> str:
    if "://" in path:
        return "/".join([path.rstrip("/"), *parts])
    return os.path.join(path, *parts)


# --------------------------------------------------------------------------
# serialization
# --------------------------------------------------------------------------

def _rebuild_tensor(buf, dtype: str, shape):
    """Unpickle half of a tensor: a CPU tensor over ``buf``'s bytes."""
    dt = getattr(torch, dtype)
    if len(buf) == 0:
        return torch.empty(shape, dtype=dt)
    flat = torch.frombuffer(buf, dtype=torch.uint8)
    return flat.view(dt).reshape(shape)


class _CpuPickler(pickle.Pickler):
    """Pickles every tensor as its CPU bytes (``_rebuild_tensor``); a
    tensor on the card is copied to the host first.  Gradients, hooks
    and ``Parameter``-ness are not kept: a checkpoint holds values."""

    def reducer_override(self, obj):
        if isinstance(obj, torch.Tensor):
            t = obj.detach().to("cpu").contiguous()
            raw = t.reshape(-1).view(torch.uint8).numpy()
            return _rebuild_tensor, (pickle.PickleBuffer(raw),
                                     str(t.dtype).split(".")[-1],
                                     tuple(t.shape))
        return NotImplemented


def serialize(obj: Any) -> bytes:
    """Pickle ``obj`` with every tensor moved to the CPU — the snapshot
    half of a snapshot-then-write checkpoint.  The bytes own no device
    memory and no storage of the live tensors."""
    out = io.BytesIO()
    _CpuPickler(out, protocol=5).dump(obj)
    return out.getvalue()


def to_device(obj: Any, device: Optional[torch.device]):
    """``obj`` with every tensor in its dicts, lists and tuples moved to
    ``device`` (``None``: left where it is)."""
    if device is None:
        return obj
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, dict):
        return type(obj)((k, to_device(v, device)) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_device(v, device) for v in obj)
    return obj


def _fsync_dir(path: str):
    """fsync a directory so a just-renamed entry survives power loss;
    best-effort (not every filesystem gives a directory a descriptor)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def save_bytes(data: bytes, path: str, *, atomic: bool = True,
               checksum: bool = True):
    """The write half of a snapshot-then-write checkpoint: ``data`` at
    ``path`` through a temp file in the target directory, fsync, rename
    and the directory's fsync (local backends), plus the ``.<name>
    .crc32c`` sidecar.  Safe on a background thread: it touches nothing
    but its arguments."""
    from ..resilience import faults

    faults.check_io_fault(path)
    fs = filesystem_for(path)
    d = _dirname(path)
    if d:
        fs.makedirs(d)
    if atomic and isinstance(fs, _LocalBackend):
        p = _strip_file_scheme(path)
        tmp = f"{p}.tmp-{os.getpid()}"
        try:
            with open(tmp, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, p)
            _fsync_dir(os.path.dirname(p) or ".")
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    else:
        with fs.open(path, "wb") as f:
            f.write(data)
    if checksum:
        from ..resilience.checkpoint import write_sidecar
        from ..visualization.crc32c import crc32c

        write_sidecar(path, crc32c(data), len(data))


def save(obj: Any, path: str, overwrite: bool = False, *,
         atomic: bool = False, checksum: bool = False):
    """Pickle ``obj`` (tensors on the CPU) to ``path``.  ``atomic``:
    temp file, fsync, rename; ``checksum``: the crc32c sidecar that
    ``resilience.checkpoint.verify_file`` checks on restore."""
    fs = filesystem_for(path)
    if fs.exists(path) and not overwrite:
        raise FileExistsError(f"{path} exists and overwrite=False "
                              "(reference File.save isOverwrite contract)")
    data = serialize(obj)
    if not (atomic or checksum):
        d = _dirname(path)
        if d:
            fs.makedirs(d)
        with fs.open(path, "wb") as f:
            f.write(data)
        return
    save_bytes(data, path, atomic=atomic, checksum=checksum)


def load(path: str, device=None) -> Any:
    """Unpickle ``path``; tensors in its dicts, lists and tuples go to
    ``device`` (``None``: the CPU, where they were pickled).  numpy
    payloads (the JAX package's) come back as numpy."""
    with filesystem_for(path).open(path, "rb") as f:
        obj = pickle.loads(f.read())
    return to_device(obj, None if device is None else torch.device(device))

