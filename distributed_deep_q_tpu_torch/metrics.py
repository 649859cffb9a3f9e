"""Structured metrics (copy of the reference ``metrics.py``'s training half).

``Metrics`` keeps named counters with rates (grad-steps/s, env-steps/s)
and gauges, and writes JSONL records; ``MovingAverage`` is the
episode-return window; ``Histogram`` is the streaming log-bucketed
histogram the step timer keeps its per-phase percentiles in.
"""

from __future__ import annotations

import json
import math
import time
from collections import deque
from typing import IO, Any


class Histogram:
    """Streaming histogram over fixed log-spaced buckets ([lo, hi) with
    ``per_decade`` buckets per factor of 10, plus under- and overflow).
    Percentiles interpolate within the winning bucket, clamped to the
    observed min/max."""

    def __init__(self, lo: float = 1e-3, hi: float = 1e5,
                 per_decade: int = 10):
        if not (0 < lo < hi):
            raise ValueError(f"need 0 < lo < hi, got lo={lo} hi={hi}")
        self._lo = float(lo)
        self._log_lo = math.log(lo)
        self._scale = per_decade / math.log(10.0)
        n_interior = int(math.ceil((math.log(hi) - self._log_lo)
                                   * self._scale))
        self._counts = [0] * (n_interior + 2)
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def _edge(self, i: int) -> float:
        return math.exp(self._log_lo + (i - 1) / self._scale)

    def observe(self, value: float) -> None:
        v = float(value)
        if math.isnan(v):
            return
        self.count += 1
        self.total += v
        self.vmin = min(self.vmin, v)
        self.vmax = max(self.vmax, v)
        if v < self._lo:
            idx = 0
        else:
            idx = 1 + int((math.log(v) - self._log_lo) * self._scale)
            idx = min(idx, len(self._counts) - 1)
        self._counts[idx] += 1

    def percentile(self, q: float) -> float:
        if self.count == 0:
            return float("nan")
        target = q * self.count
        cum = 0
        for i, c in enumerate(self._counts):
            cum += c
            if cum >= target and c > 0:
                if i == 0:
                    est = self._lo
                elif i == len(self._counts) - 1:
                    est = self.vmax
                else:
                    frac = 1.0 - (cum - target) / c
                    left, right = self._edge(i), self._edge(i + 1)
                    est = left + frac * (right - left)
                return min(max(est, self.vmin), self.vmax)
        return self.vmax


class Metrics:
    def __init__(self, jsonl_path: str | None = None):
        self._fh: IO[str] | None = open(jsonl_path, "a") if jsonl_path else None
        self._t0 = time.monotonic()
        self._counters: dict[str, int] = {}
        self._marks: dict[str, tuple[float, int]] = {}
        self._gauges: dict[str, float] = {}

    def count(self, name: str, inc: int = 1) -> None:
        self._counters[name] = self._counters.get(name, 0) + inc

    def gauge(self, name: str, value: float) -> None:
        """Set a point-in-time value (queue depth, ...)."""
        self._gauges[name] = float(value)

    def telemetry(self) -> dict[str, float]:
        """The gauges, by name."""
        return dict(self._gauges)

    def rate(self, name: str) -> float:
        """Rate of a counter since the last time rate() was called on it."""
        now = time.monotonic()
        cur = self._counters.get(name, 0)
        t_prev, c_prev = self._marks.get(name, (self._t0, 0))
        self._marks[name] = (now, cur)
        dt = max(now - t_prev, 1e-9)
        return (cur - c_prev) / dt

    def log(self, step: int, **scalars: Any) -> None:
        rec = {"step": int(step), "t": round(time.monotonic() - self._t0, 3)}
        for k, v in scalars.items():
            rec[k] = float(v) if isinstance(v, (int, float)) else v
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()

    def close(self) -> None:
        if self._fh:
            self._fh.close()


class MovingAverage:
    def __init__(self, window: int = 100):
        self._q: deque = deque(maxlen=window)

    def add(self, x: float) -> None:
        self._q.append(float(x))

    @property
    def value(self) -> float:
        return sum(self._q) / len(self._q) if self._q else float("nan")

    def __len__(self) -> int:
        return len(self._q)
