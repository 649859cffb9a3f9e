"""Per-phase step timing for the training loop (the reference
``profiling.py``'s ``StepTimer``)."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Iterator

import torch

from distributed_deep_q_tpu_torch.metrics import Histogram


class StepTimer:
    """Accumulates per-phase wall time across train-loop steps.

    ``summary()`` returns mean milliseconds per phase since the last call
    (keys ``time_<phase>_ms``) plus ``time_step_ms`` (mean wall time per
    step, measured step_done→step_done), and p50/p99 per phase.
    """

    def __init__(self) -> None:
        self._acc: dict[str, float] = defaultdict(float)
        self._hists: dict[str, Histogram] = {}
        self._steps = 0
        self._last_step_t: float | None = None
        self._step_total = 0.0

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self._acc[name] += dt
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram()
            h.observe(1e3 * dt)

    def measure_device(self, output: torch.Tensor) -> None:
        """Wait for the device work behind ``output`` and attribute the
        wait to the ``device`` phase. Call on logging steps only — this
        synchronizes the stream."""
        with self.phase("device"):
            if output.is_cuda:
                torch.cuda.synchronize(output.device)

    def step_done(self) -> None:
        now = time.perf_counter()
        if self._last_step_t is not None:
            self._step_total += now - self._last_step_t
        self._last_step_t = now
        self._steps += 1

    def summary(self, reset: bool = True) -> dict[str, float]:
        n = max(self._steps, 1)
        out = {f"time_{k}_ms": 1e3 * v / n for k, v in self._acc.items()}
        # device is measured once per summary window, not per step
        if "time_device_ms" in out:
            out["time_device_ms"] = 1e3 * self._acc["device"]
        if self._steps > 1:
            out["time_step_ms"] = 1e3 * self._step_total / (self._steps - 1)
        for name, h in self._hists.items():
            if h.count:
                out[f"time_{name}_p50_ms"] = h.percentile(0.50)
                out[f"time_{name}_p99_ms"] = h.percentile(0.99)
        if reset:
            self._acc.clear()
            self._hists.clear()
            self._steps = 0
            self._step_total = 0.0
            self._last_step_t = None
        return out
