"""Columnar ingest staging (the reference ``replay/columnar.py``'s
``ColumnStage``, numpy path; the reference's optional C++ memcpy core and
its background drain thread are not ported)."""

from __future__ import annotations

import numpy as np


class ColumnStage:
    """Preallocated columnar staging for one replay shard.

    ``columns`` is a list of ``(tail_shape, dtype)`` — column 0 is the
    in-shard row index, the rest are the replay's staged payload columns.
    Buffers grow by doubling. Not thread-safe: callers serialize appends
    and takes.
    """

    def __init__(self, columns, depth: int = 4096):
        self._columns = [(tuple(tail), np.dtype(dt)) for tail, dt in columns]
        self._depth = max(int(depth), 1)
        self._rows = 0
        self._bufs = [np.zeros((self._depth,) + tail, dt)
                      for tail, dt in self._columns]

    def __len__(self) -> int:
        return self._rows

    def _grow(self, need: int) -> None:
        while self._depth < need:
            self._depth *= 2
        grown = []
        for buf, (tail, dt) in zip(self._bufs, self._columns):
            new = np.zeros((self._depth,) + tail, dt)
            new[:self._rows] = buf[:self._rows]
            grown.append(new)
        self._bufs = grown

    def append(self, *cols) -> None:
        """Append one segment (same row count per column) at the cursor,
        each column coerced to its declared dtype first."""
        n = len(cols[0])
        if self._rows + n > self._depth:
            self._grow(self._rows + n)
        for buf, c, (tail, dt) in zip(self._bufs, cols, self._columns):
            buf[self._rows:self._rows + n] = np.asarray(c, dt).reshape(
                (n,) + tail)
        self._rows += n

    def take(self, k: int, outs: list, li: int) -> int:
        """Drain up to ``k`` oldest rows into flush planes:
        ``outs[c][li, :take]`` receives column ``c``'s head and the
        remainder compacts to the front (FIFO order preserved)."""
        take = min(self._rows, k)
        if take == 0:
            return 0
        rem = self._rows - take
        for out, buf in zip(outs, self._bufs):
            out[li, :take] = buf[:take]
            if rem:
                buf[:rem] = buf[take:self._rows]
        self._rows = rem
        return take
