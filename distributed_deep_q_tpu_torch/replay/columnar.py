"""Zero-copy columnar ingest staging + batched host→device drain (a copy
of the reference ``replay/columnar.py``).

- ``ColumnStage`` — per-shard, per-column preallocated staging buffers.
  Decoded flush payloads land with ONE memcpy per column
  (``native/replay_core.cpp::staged_append``; the numpy slice-assign
  version is the bit-identical reference), and the flush drains
  contiguous column slices instead of walking a FIFO of tuples. Not
  thread-safe by itself: callers serialize appends and takes under the
  replay lock.
- ``IngestDrain`` — a background transfer thread that batches staged
  columns into the device ring (``replay.flush()``, or the ring's own work
  unit, under the shared lock) whenever a full write chunk is pending, so
  writer threads pay a cursor bump + condition notify and never the
  device dispatch. A death of the thread surfaces on ``counters()`` and
  ``close()``.

The drain shares the caller's replay lock (same mutual exclusion as an
inline flush); its own bookkeeping lives under ``_cv``.
"""

from __future__ import annotations

import threading

import numpy as np

from distributed_deep_q_tpu_torch import native, tracing


class ColumnStage:
    """Preallocated columnar staging for one replay shard.

    ``columns`` is a list of ``(tail_shape, dtype)`` — column 0 is the
    in-shard row index, the rest are the replay's staged payload
    columns. Buffers grow by doubling (staged depth is a starting size,
    not a cap: the backpressure plane bounds occupancy in practice, and
    the legacy FIFO this replaces was unbounded too).

    The staged rows are ``[_head, _rows)`` of each buffer: ``take``
    advances the head, and the rows left move to the front only when an
    append needs the room. (The reference compacts the remainder on every
    take, which makes draining a backlog of R rows in rounds of k cost
    O(R²/k) row copies under the replay lock: ~3 ms a round at 84×84 and
    a 2,000-row backlog.)
    """

    def __init__(self, columns, depth: int = 4096,
                 use_native: bool = True):
        self._columns = [(tuple(tail), np.dtype(dt)) for tail, dt in columns]
        self._depth = max(int(depth), 1)
        self._head = 0
        self._rows = 0
        self._bufs = [np.zeros((self._depth,) + tail, dt)
                      for tail, dt in self._columns]
        self._row_bytes = np.asarray(
            [dt.itemsize * int(np.prod(tail, dtype=np.int64))
             for tail, dt in self._columns], np.int64)
        self._lib = native.load() if use_native else None

    def __len__(self) -> int:
        return self._rows - self._head

    def staged(self) -> list[np.ndarray]:
        """Each column's staged rows, oldest first (views)."""
        return [buf[self._head:self._rows] for buf in self._bufs]

    def _make_room(self, n: int) -> None:
        """Move the staged rows to the front, then grow the buffers by
        doubling until ``n`` more rows fit behind them."""
        live = self._rows - self._head
        if self._head:
            for buf in self._bufs:
                buf[:live] = buf[self._head:self._rows]
            self._head, self._rows = 0, live
        if live + n <= self._depth:
            return
        while self._depth < live + n:
            self._depth *= 2
        grown = []
        for buf, (tail, dt) in zip(self._bufs, self._columns):
            new = np.zeros((self._depth,) + tail, dt)
            new[:live] = buf[:live]
            grown.append(new)
        self._bufs = grown

    def append(self, *cols) -> None:
        """Append one segment (same row count per column) at the cursor.

        Each column is coerced to its declared dtype/contiguity first so
        the native memcpy and the numpy fallback see identical bytes.
        """
        n = len(cols[0])
        if self._rows + n > self._depth:
            self._make_room(n)
        segs = [np.ascontiguousarray(c, dt).reshape((n,) + tail)
                for c, (tail, dt) in zip(cols, self._columns)]
        if self._lib is not None:
            self._rows = self._lib.staged_append(
                native.uint8_pp([native.as_uint8_p(b) for b in self._bufs]),
                native.uint8_pp([native.as_uint8_p(s) for s in segs]),
                native.as_int64_p(self._row_bytes), len(segs),
                self._rows, n)
        else:  # reference semantics — must stay bit-identical
            for buf, seg in zip(self._bufs, segs):
                buf[self._rows:self._rows + n] = seg
            self._rows += n

    def take(self, k: int, outs: list, li: int) -> int:
        """Drain up to ``k`` oldest rows into flush planes.

        ``outs[c][li, :take]`` receives column ``c``'s head; the rest stay
        staged in order (FIFO, the same as the legacy per-flush queue's
        split-preserving partial takes).
        """
        take = min(len(self), k)
        if take == 0:
            return 0
        h = self._head
        for out, buf in zip(outs, self._bufs):
            out[li, :take] = buf[h:h + take]
        self._head = h + take
        if self._head == self._rows:
            self._head = self._rows = 0
        return take


class IngestDrain:
    """Batched host→device transfer thread for a device replay ring.

    Waits until the backlog reaches ``min_rows``, then runs the work
    unit under the SHARED replay lock — one traced ``ingest_drain``
    hold per batch, off the writer threads. Writers call ``notify()``
    (cheap) instead of flushing inline.

    The work unit is ``replay.flush()`` (the full host→device dispatch,
    which the device rings enqueue on the learner's stream) with the
    staged-row delta as its progress count, at one learner process and
    at several alike. The reference's multi-host variant (a pluggable
    host-only work unit, ``prepare_rounds``) serves its collective flush;
    the port's flush writes only its own process's tensors and has none
    (``replay/device_ring.py``).
    """

    def __init__(self, replay, lock, min_rows: int, poll_s: float = 0.05):
        self._replay = replay
        self._lock = lock
        self._min = max(int(min_rows), 1)
        self._poll_s = float(poll_s)
        self._cv = threading.Condition()
        self._stop = False
        self._drained_rows = 0
        self._drain_flushes = 0
        self._err: BaseException | None = None
        self._thread = threading.Thread(
            target=self._run, name="ingest-drain", daemon=True)
        self._thread.start()

    def notify(self) -> None:
        with self._cv:
            self._cv.notify()

    def counters(self) -> dict[str, int]:
        with self._cv:
            if self._err is not None:
                raise RuntimeError("ingest drain thread died") from self._err
            return {"rows": self._drained_rows,
                    "flushes": self._drain_flushes}

    def _do_work(self) -> int:
        """One work unit under the replay lock; returns rows moved."""
        before = self._replay.pending_rows()
        self._replay.flush()
        return before - self._replay.pending_rows()

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._stop and \
                        self._replay._staged_rows() < self._min:
                    self._cv.wait(timeout=self._poll_s)
                if self._stop:
                    return
            try:
                with tracing.locked(self._lock):
                    with tracing.span("ingest_drain"):
                        drained = self._do_work()
            except BaseException as e:  # surfaced on counters()/close()
                with self._cv:
                    self._err = e
                return
            with self._cv:
                self._drained_rows += drained
                self._drain_flushes += 1

    def close(self) -> None:
        """Stop the thread and run one final work unit under the lock, so
        no staged rows are stranded below the chunk threshold. A death the
        thread recorded is re-raised instead (the final unit is skipped:
        the work that killed the thread would run again)."""
        with self._cv:
            self._stop = True
            self._cv.notify()
        self._thread.join(timeout=10)
        with self._cv:
            if self._err is not None:
                raise RuntimeError("ingest drain thread died") from self._err
        with tracing.locked(self._lock):
            self._do_work()
