"""Crash-consistent writes (the part of the reference ``utils/durability.py``
that checkpoints and replay persistence use; host-only, copied).

- ``atomic_write`` — tmp file in the destination directory + flush +
  fsync + ``os.replace`` + directory fsync: a crash at any point leaves
  either the old file or the new file at the path, never a torn one.
- ``savez_bytes`` — an npz built in memory, for callers that need the
  bytes before they write them.

The reference's ``atomic_write`` also calls a chaos hook (``_maybe_tear``,
the ``torn=`` fault of ``rpc/faultinject.py``) between the write and the
fsync. The port has no fault injector yet (ROADMAP slice 6c), so it writes
without the hook. ``crc32c`` and ``GenerationStore`` come with the replay
server in the same slice: nothing here calls them.
"""

from __future__ import annotations

import io
import os
import tempfile
from collections.abc import Callable
from typing import Any, BinaryIO

import numpy as np


def _fsync_dir(dirpath: str) -> None:
    """Persist a rename: fsync the containing directory (POSIX)."""
    try:
        fd = os.open(dirpath, os.O_RDONLY)
    except OSError:
        return  # platform without directory fds — best effort
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def atomic_write(path: str,
                 data: bytes | memoryview | Callable[[BinaryIO], Any],
                 ) -> None:
    """Write ``data`` to ``path`` atomically: tmp file in the same
    directory, flush + fsync, ``os.replace``, directory fsync. A crash at
    any point leaves either the previous file or the complete new one at
    ``path`` — never a torn write.

    ``data`` is bytes-like, or a callable that writes the contents into
    the open binary tmp file it is given: a multi-GB npz then streams to
    disk instead of being built in memory first (the bytes on disk are
    the same)."""
    path = os.fspath(path)
    dirpath = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(prefix=os.path.basename(path) + ".",
                               suffix=".tmp", dir=dirpath)
    try:
        with os.fdopen(fd, "wb") as f:
            if callable(data):
                data(f)
            else:
                f.write(memoryview(data))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        tmp = None
        _fsync_dir(dirpath)
    finally:
        if tmp is not None:
            try:
                os.unlink(tmp)
            except OSError:
                pass


def savez_bytes(**arrays: Any) -> bytes:
    """Serialize arrays/scalars to npz bytes in memory — the capture/
    serialize split that lets callers checksum and ``atomic_write`` the
    result instead of ``np.savez``-ing straight to a final path."""
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()
