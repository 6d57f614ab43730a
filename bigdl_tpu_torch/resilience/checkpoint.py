"""Verified checkpoints: crc32c sidecars, walk-back restore, quarantine
(counterpart of ``bigdl_tpu/resilience/checkpoint.py``).

The pickle checkpoints (``model.N``/``optimMethod.N``/``trainState.N``)
are written atomically by ``utils.file_io.save_bytes`` with a hidden
``.<name>.crc32c`` sidecar holding the payload's crc32c and size, in the
JAX package's format: a file and sidecar written by either package
verify under the other.  This module owns the read side: verify a file
against its sidecar, quarantine corrupt files (rename to
``<file>.corrupt``, never delete: the bytes are evidence), and walk back
through a directory to the newest file that verifies and unpickles.
The CRC is the native slicing-by-8 one, streamed 1 MiB at a time.
"""
from __future__ import annotations

import logging
import os
from typing import Any, List, Optional, Tuple

from ..visualization.crc32c import crc32c

log = logging.getLogger("bigdl_tpu")

CRC_SUFFIX = ".crc32c"
QUARANTINE_SUFFIX = ".corrupt"
_CHUNK = 1 << 20


def stream_crc32c(path: str) -> Tuple[int, int]:
    """(crc32c, size) of a file's bytes, read 1 MiB at a time."""
    from ..utils import file_io

    crc, size = 0, 0
    with file_io.filesystem_for(path).open(path, "rb") as f:
        while True:
            chunk = f.read(_CHUNK)
            if not chunk:
                break
            crc = crc32c(chunk, crc)
            size += len(chunk)
    return crc, size


def sidecar_path(path: str) -> str:
    """``<dir>/.<name>.crc32c`` — hidden, so scans by prefix
    (``model.*``) never take a sidecar for a checkpoint."""
    if "://" in path or "/" in path:
        sep = "/" if "://" in path else os.sep
        d, _, base = path.rpartition(sep)
        return f"{d}{sep}.{base}{CRC_SUFFIX}"
    return f".{path}{CRC_SUFFIX}"


def write_sidecar(path: str, crc: int, size: int):
    """Write ``<path>``'s sidecar = "<crc hex> <size>\\n"."""
    from ..utils import file_io

    with file_io.filesystem_for(path).open(sidecar_path(path), "wb") as f:
        f.write(f"{crc:08x} {size}\n".encode())


def read_sidecar(path: str) -> Optional[Tuple[int, int]]:
    from ..utils import file_io

    side = sidecar_path(path)
    fs = file_io.filesystem_for(path)
    if not fs.exists(side):
        return None
    try:
        with fs.open(side, "rb") as f:
            crc_hex, size = f.read().split()
        return int(crc_hex, 16), int(size)
    except (ValueError, OSError):
        return None  # unreadable sidecar: the file is unverifiable


def verify_file(path: str) -> Optional[bool]:
    """True: sidecar present and crc + size match.  False: sidecar
    present and a mismatch (the file is corrupt).  None: no readable
    sidecar — a legacy file; the caller decides (a restore still tries
    the unpickle, which catches gross truncation)."""
    expected = read_sidecar(path)
    if expected is None:
        return None
    try:
        actual = stream_crc32c(path)
    except OSError:
        return False
    return actual == expected


def quarantine(path: str) -> str:
    """Move a corrupt checkpoint (and its sidecar) out of the restore
    set: ``<path>`` → ``<path>.corrupt``.  Returns the new path."""
    dst = path + QUARANTINE_SUFFIX
    try:
        os.replace(path, dst)
    except OSError:
        log.warning("could not quarantine %s in place", path)
        return path
    side = sidecar_path(path)
    if os.path.exists(side):
        try:
            os.replace(side, side + QUARANTINE_SUFFIX)
        except OSError:
            pass
    log.warning("quarantined corrupt checkpoint %s -> %s", path, dst)
    return dst


class CorruptCheckpointError(IOError):
    """A checkpoint named on its own failed crc32c verification or would
    not unpickle.  The walk-back restore falls back to an older file; a
    caller naming ONE file (the serving hot swap) has none, so the
    corruption surfaces as this typed error."""


def verified_load(path: str, device=None) -> Any:
    """Verify ``path`` against its sidecar and unpickle it (tensors on
    ``device``).  A crc mismatch quarantines the file and raises
    :class:`CorruptCheckpointError`; a missing sidecar still tries the
    unpickle."""
    from ..utils import file_io

    if verify_file(path) is False:
        quarantine(path)
        raise CorruptCheckpointError(
            f"{path} failed crc32c verification (quarantined)")
    try:
        return file_io.load(path, device=device)
    except (KeyboardInterrupt, SystemExit):
        raise
    except Exception as e:
        raise CorruptCheckpointError(
            f"{path} failed to load ({type(e).__name__}: {e})")


# ---------------------------------------------------------------------------
# walk-back restore
# ---------------------------------------------------------------------------

def candidate_files(directory: str, prefix: str,
                    max_step: Optional[int] = None) -> List[str]:
    """Every ``<prefix>``/``<prefix>.N`` file under ``directory``, newest
    step first by number (``model.32`` before ``model.8``; a bare
    ``<prefix>``, the overwrite layout, first of all).  With
    ``max_step`` only steps at or below it qualify."""
    from ..utils import file_io

    if directory is None or not file_io.isdir(directory):
        return []
    steps = []
    for f in file_io.listdir(directory):
        if f == prefix:
            steps.append((float("inf"), f))
        elif f.startswith(prefix + ".") and not f.endswith(
                (CRC_SUFFIX, QUARANTINE_SUFFIX)):
            try:
                steps.append((int(f.rsplit(".", 1)[1]), f))
            except ValueError:
                continue
    if max_step is not None:
        steps = [t for t in steps if t[0] <= max_step]
    steps.sort(key=lambda t: t[0], reverse=True)
    return [file_io.join(directory, f) for _, f in steps]


def verify_and_load_latest(directory: str, prefix: str,
                           max_step: Optional[int] = None, device=None
                           ) -> Tuple[Optional[Any], Optional[str]]:
    """Walk the ``<prefix>.N`` files newest first; return ``(object,
    path)`` for the first one that passes crc32c verification AND
    unpickles (tensors on ``device``).  Corrupt candidates are
    quarantined and the walk goes on.  ``(None, None)`` when nothing
    survives."""
    from ..utils import file_io

    for path in candidate_files(directory, prefix, max_step=max_step):
        if verify_file(path) is False:
            quarantine(path)
            continue
        try:
            return file_io.load(path, device=device), path
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception as e:
            log.warning("checkpoint %s failed to load (%s: %s)",
                        path, type(e).__name__, e)
            quarantine(path)
            continue
    return None, None
