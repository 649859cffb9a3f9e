"""Host→device staging: double-buffered batch prefetch (the torch twin of
the reference ``replay/staging.py``).

A background thread samples host batches and starts their transfer to the
device while the learner's previous step runs, so the learner's ``get()``
returns a batch whose copy is already queued (or landed) instead of paying
the host→device transfer inline.

On the card each array is copied into a fresh pinned block and sent with a
non-blocking copy on a side stream; an event recorded after the copies is
what ``get()`` makes the consumer's stream wait on, so the step never reads
a batch before its bytes have arrived. PyTorch's pinned allocator hands a
pinned block out again only after the copy that reads it has run, so the
thread never refills a buffer still being read. The device tensors were
allocated on the side stream; ``get()`` marks them used on the consumer's
stream (``record_stream``) so their memory is not reused while the step
still reads it. On the CPU the arrays become tensors without a copy.

Host-only bookkeeping keys (``index``, ``_sampled_at``) ride along as numpy
so PER priority write-back still works. Depth 2 is true double buffering:
one batch being consumed, one in flight.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable

import numpy as np
import torch

from distributed_deep_q_tpu_torch import tracing

HOST_KEYS = ("index", "_sampled_at")


class DeviceStager:
    """Background sampler → device transfer pipeline.

    ``sample_fn()`` produces a host batch dict; batches appear on the
    internal queue already on their way to ``device`` (host-only keys kept
    as numpy). Call ``get()`` in the learner loop; ``close()`` joins the
    thread. The queue is bounded (``depth``), so sampling backpressures
    when the learner falls behind rather than buffering stale batches —
    this bounds PER priority staleness to ``depth`` steps.
    """

    def __init__(self, sample_fn: Callable[[], dict[str, Any]],
                 device: torch.device | str = "cpu", depth: int = 2,
                 lock: threading.Lock | None = None):
        """``lock`` serializes ``sample_fn`` against writers that mutate the
        same replay from other threads (PER ``update_priorities``, RPC
        ``add_batch``) — the SumTree is not internally synchronized, so PER
        callers MUST pass the lock they use for priority write-back."""
        self._sample_fn = sample_fn
        self._device = torch.device(device)
        self._stream = (torch.cuda.Stream(self._device)
                        if self._device.type == "cuda" else None)
        self._lock = lock if lock is not None else threading.Lock()
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._err: BaseException | None = None
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="replay-stager")
        self._thread.start()

    def _stage(self, batch: dict[str, Any]):
        """(batch with device tensors and host keys, copy event or None)."""
        with tracing.span("stage_batch"):
            host = {k: batch.pop(k) for k in HOST_KEYS if k in batch}
            arrays = {k: torch.from_numpy(np.ascontiguousarray(v))
                      for k, v in batch.items()}
            ready = None
            with tracing.span("device_put"):
                if self._stream is None:
                    dev = arrays
                else:
                    with torch.cuda.stream(self._stream):
                        dev = {k: t.pin_memory().to(self._device,
                                                    non_blocking=True)
                               for k, t in arrays.items()}
                        ready = torch.cuda.Event()
                        ready.record(self._stream)
            dev.update(host)
            return dev, ready

    def _run(self) -> None:
        try:
            while not self._stop.is_set():
                # lock_wait (contention) and sample (work under the
                # lock) surface as separate stages in the attribution
                with tracing.locked(self._lock):
                    with tracing.span("sample"):
                        batch = self._sample_fn()
                staged = self._stage(batch)
                while not self._stop.is_set():
                    try:
                        self._q.put(staged, timeout=0.1)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # surfaced on the consumer's next get()
            self._err = e

    @property
    def lock(self) -> threading.Lock:
        """The sampler lock; hold it for any replay mutation (priority
        write-back, adds) done outside this stager's thread."""
        return self._lock

    def get(self, timeout: float = 30.0) -> dict[str, Any]:
        """Next batch, its device tensors safe to use on the caller's
        current stream (blocks until the pipeline has one)."""
        deadline = timeout
        while True:
            if self._err is not None:
                raise RuntimeError("staging thread failed") from self._err
            try:
                batch, ready = self._q.get(timeout=min(deadline, 0.5))
                break
            except queue.Empty:
                deadline -= 0.5
                if deadline <= 0:
                    raise TimeoutError(
                        "DeviceStager.get(): no batch produced in time")
        if ready is not None:
            consumer = torch.cuda.current_stream(self._device)
            consumer.wait_event(ready)
            for v in batch.values():
                if isinstance(v, torch.Tensor):
                    v.record_stream(consumer)
        return batch

    def close(self) -> None:
        self._stop.set()
        # drain so a blocked put() can observe the stop flag
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)
