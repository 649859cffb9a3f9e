"""Structured metrics (SURVEY.md §5.5).

A copy of the reference ``metrics.py`` (host only), its imports rewritten
to this package.

The reference logs via stdout prints + Spark UI [R]; here metrics are
structured counters written as JSONL (machine-readable for the bench
harness) with optional TensorBoard mirroring. The north-star counters —
grad-steps/sec, env-steps/sec, eval return [M] — are first-class.

Telemetry layer (observability spine): ``Histogram`` is a streaming
log-bucketed histogram (fixed bucket edges, O(1) observe, p50/p95/p99
summaries) used for latency/size distributions across the distributed
seams — RPC method latency, θ-pull round trips, per-phase step times.
``Metrics`` additionally holds named gauges (point-in-time values such
as queue depths — the signal an ingest OOM lacked) and named
histograms; ``telemetry()`` flattens both into scalar keys for the same
JSONL/TensorBoard sinks that carry the counters.
"""

from __future__ import annotations

import json
import math
import time
from collections import deque
from typing import Any, IO

_PCTS = (("p50", 0.50), ("p95", 0.95), ("p99", 0.99))


class Histogram:
    """Streaming histogram over fixed log-spaced buckets.

    Values land in geometric buckets spanning [lo, hi) with
    ``per_decade`` buckets per factor of 10, plus an underflow and an
    overflow bucket — O(1) memory regardless of observation count, so
    it is safe on hot paths (RPC dispatch, per-step phase timing).
    Percentile estimates interpolate within the winning bucket and are
    clamped to the observed min/max, so single-value histograms report
    that value exactly.
    """

    def __init__(self, lo: float = 1e-3, hi: float = 1e5,
                 per_decade: int = 10):
        if not (0 < lo < hi):
            raise ValueError(f"need 0 < lo < hi, got lo={lo} hi={hi}")
        self._lo = float(lo)
        self._log_lo = math.log(lo)
        self._scale = per_decade / math.log(10.0)
        # interior buckets + underflow [0] + overflow [-1]
        n_interior = int(math.ceil((math.log(hi) - self._log_lo)
                                   * self._scale))
        self._counts = [0] * (n_interior + 2)
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def _edge(self, i: int) -> float:
        """Lower edge of interior bucket i (1-based in self._counts)."""
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

    def observe_many(self, values) -> None:
        for v in values:
            self.observe(v)

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
                    # interpolate inside the bucket by rank fraction
                    frac = 1.0 - (cum - target) / c
                    left, right = self._edge(i), self._edge(i + 1)
                    est = left + frac * (right - left)
                return min(max(est, self.vmin), self.vmax)
        return self.vmax

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else float("nan")

    def summary(self, prefix: str = "") -> dict[str, float]:
        """Flat scalar summary: ``{prefix}_count/mean/max/p50/p95/p99``
        (empty dict while no observations — absent beats NaN in JSONL)."""
        if self.count == 0:
            return {}
        sep = "_" if prefix else ""
        out = {f"{prefix}{sep}count": self.count,
               f"{prefix}{sep}mean": self.mean,
               f"{prefix}{sep}max": self.vmax}
        for name, q in _PCTS:
            out[f"{prefix}{sep}{name}"] = self.percentile(q)
        return out

    def reset(self) -> None:
        self._counts = [0] * len(self._counts)
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    # -- merge / snapshot / delta (health plane) ------------------
    def _same_geometry(self, other: "Histogram") -> bool:
        return (self._lo == other._lo and self._scale == other._scale
                and len(self._counts) == len(other._counts))

    def merge(self, other: "Histogram") -> "Histogram":
        """Fold ``other`` into self (cross-shard / cross-process
        aggregation). Bucket geometry must match exactly: counts add
        elementwise (underflow/overflow included), ``vmin``/``vmax``
        take min/max — so a merge of disjoint streams is bitwise equal
        to one histogram that observed every value, and percentiles of
        the merge are IDENTICAL to single-stream percentiles (pinned by
        tests). Returns self for chaining."""
        if not self._same_geometry(other):
            raise ValueError(
                f"histogram geometry mismatch: lo={self._lo}/{other._lo} "
                f"scale={self._scale}/{other._scale} "
                f"buckets={len(self._counts)}/{len(other._counts)}")
        for i, c in enumerate(other._counts):
            self._counts[i] += c
        self.count += other.count
        self.total += other.total
        self.vmin = min(self.vmin, other.vmin)
        self.vmax = max(self.vmax, other.vmax)
        return self

    def snapshot(self) -> "Histogram":
        """Cheap point-in-time copy (no __init__ re-derivation) — the
        cumulative state a later ``delta()`` subtracts to produce a
        sliding-window view."""
        s = Histogram.__new__(Histogram)
        s._lo = self._lo
        s._log_lo = self._log_lo
        s._scale = self._scale
        s._counts = list(self._counts)
        s.count = self.count
        s.total = self.total
        s.vmin = self.vmin
        s.vmax = self.vmax
        return s

    def delta(self, prev: "Histogram") -> "Histogram":
        """Windowed view: observations in self but not in ``prev`` (an
        earlier snapshot of the SAME cumulative histogram). Counts and
        totals subtract per bucket; ``vmin``/``vmax`` keep the cumulative
        extremes — window extrema are unrecoverable from bucket counts,
        so percentile clamping stays conservative (documented semantics,
        pinned by tests). If the source was reset since ``prev`` (count
        went backwards) the full current state is returned instead of a
        nonsense negative window."""
        if not self._same_geometry(prev):
            raise ValueError("histogram geometry mismatch in delta()")
        if self.count < prev.count:
            return self.snapshot()
        d = Histogram.__new__(Histogram)
        d._lo = self._lo
        d._log_lo = self._log_lo
        d._scale = self._scale
        d._counts = [a - b for a, b in zip(self._counts, prev._counts)]
        d.count = self.count - prev.count
        d.total = self.total - prev.total
        d.vmin = self.vmin
        d.vmax = self.vmax
        return d


class Metrics:
    def __init__(self, jsonl_path: str | None = None,
                 tensorboard_dir: str | None = None):
        self._fh: IO[str] | None = open(jsonl_path, "a") if jsonl_path else None
        self._tb = None
        if tensorboard_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(tensorboard_dir)
            except Exception as e:
                # JSONL is the primary sink; TB mirroring is optional
                # (torch absent, unwritable dir, ...) — warn with the cause
                # instead of silently dropping the request or crashing the
                # run over a mirror sink
                import warnings
                warnings.warn(
                    f"tensorboard_dir requested but the TensorBoard writer "
                    f"is unavailable ({type(e).__name__}: {e}); metrics go "
                    f"to JSONL only", RuntimeWarning, stacklevel=2)
        self._t0 = time.monotonic()
        self._counters: dict[str, int] = {}
        self._marks: dict[str, tuple[float, int]] = {}
        self._gauges: dict[str, float] = {}
        self._hists: dict[str, Histogram] = {}

    # -- counters with rates (grad-steps/sec, env-steps/sec) ---------------
    def count(self, name: str, inc: int = 1) -> None:
        self._counters[name] = self._counters.get(name, 0) + inc

    # -- gauges + histograms (telemetry spine) ------------------------------
    def gauge(self, name: str, value: float) -> None:
        """Set a point-in-time value (queue depth, version lag, ...)."""
        self._gauges[name] = float(value)

    def histogram(self, name: str, lo: float = 1e-3, hi: float = 1e5,
                  per_decade: int = 10) -> Histogram:
        """Get-or-create the named histogram (custom range on creation)."""
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = Histogram(lo, hi, per_decade)
        return h

    def observe(self, name: str, value: float) -> None:
        """Record one observation into the named histogram."""
        self.histogram(name).observe(value)

    def observe_many(self, name: str, values) -> None:
        """Record a batch of observations (array-like) into the named
        histogram — one bucket pass instead of N ``observe`` calls
        (lineage ``time_to_learn`` samples arrive per training batch)."""
        self.histogram(name).observe_many(values)

    def telemetry(self) -> dict[str, float]:
        """Flatten gauges + histogram summaries into scalar keys for
        ``log()``: gauges pass through by name, each histogram ``h``
        contributes ``h_count/mean/max/p50/p95/p99``."""
        out = dict(self._gauges)
        for name, h in self._hists.items():
            out.update(h.summary(prefix=name))
        return out

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
        if self._tb:
            for k, v in scalars.items():
                if isinstance(v, (int, float)):
                    self._tb.add_scalar(k, v, step)

    def close(self) -> None:
        if self._fh:
            self._fh.close()
        if self._tb:
            self._tb.close()


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
