"""Crash-safe file writes shared by every save path of the port
(counterpart of ``paddle_tpu/io/atomic.py``).

The durability contract (the Go pserver's checkpoint discipline,
go/pserver/service.go:346: verified payload, atomic meta update):

  * a reader never observes a half-written file: content lands in a tmp
    file in the SAME directory and appears through ``os.replace``;
  * the content is on stable storage before the rename makes it
    visible: the payload is fsync'd, then the directory entry, so a
    power loss can lose the new file but never publish a torn one;
  * verification is cheap: ``sha256_file`` gives the checksum a
    checkpoint manifest records per payload.

Checkpoint snapshots (``io/checkpoint.py``) and parameter tars
(``trainer.SGD.save_parameter_to_tar``) route through here, so a SIGKILL
mid-save can only cost the snapshot in progress.
"""

from __future__ import annotations

import hashlib
import os
import stat as _stat
import tempfile
from typing import Callable

# read once at import (single-threaded): os.umask can only be read by
# setting it, and that is process-global; racing it per call could leak
# a 0 umask to a concurrent open()
_UMASK = os.umask(0o077)
os.umask(_UMASK)


def fsync_dir(path: str) -> None:
    """fsync a directory so a just-renamed entry survives power loss.
    Best effort: some filesystems refuse an O_RDONLY directory fsync."""
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


def fsync_file(path: str) -> None:
    """fsync an already-written file by path (payloads written by writers
    that closed the handle, such as ``np.savez``)."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def atomic_write_file(path: str, write_fn: Callable, *,
                      fsync: bool = True) -> str:
    """Write ``path`` atomically: ``write_fn(f)`` receives a binary file
    object for a tmp file in the same directory; on success the tmp is
    fsync'd, renamed over ``path`` and the directory entry fsync'd.  On
    any failure the tmp is removed and ``path`` is untouched."""
    path = os.fspath(path)
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d,
                               prefix="." + os.path.basename(path) + ".tmp-")
    try:
        with os.fdopen(fd, "wb") as f:
            write_fn(f)
            if fsync:
                f.flush()
                os.fsync(f.fileno())
        # mkstemp creates 0600: keep an existing file's mode, else the
        # umask default, as a plain open() write would have
        try:
            mode = _stat.S_IMODE(os.stat(path).st_mode)
        except OSError:
            mode = 0o666 & ~_UMASK
        os.chmod(tmp, mode)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    if fsync:
        fsync_dir(d)
    return path


def sha256_file(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(chunk), b""):
            h.update(block)
    return h.hexdigest()
