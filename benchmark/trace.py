"""The traced stretch: a ``torch.profiler`` window over a few steady
dispatches inside a ``--trace 1`` run, read into device intervals.

The stretch opens and closes on a synchronize, so it holds exactly the
work enqueued inside it. Right after the opening synchronize a marker
kernel is launched: it is the stretch's first device event, which ties the
profiler's clock to the host's, so the host spans the harness records can
say what the host was doing in each idle gap of the device.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from collections import defaultdict

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Stretch:
    """``start()`` and ``close()`` around a steady stretch, ``collect()``
    after it: ``events`` then holds its device operations (name, start µs
    on the host's clock, µs), whose union, gaps and per-kernel times the
    readers take."""

    def __init__(self):
        self._prof = None
        self.t0 = self.t1 = 0.0
        self._mark = 0.0
        self.events: list = []

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()
        torch.cuda.synchronize()
        self.t0 = time.perf_counter()
        torch.cuda._sleep(1000)     # the marker
        self._mark = self.t0

    def close(self) -> None:
        """The stretch's end: everything enqueued in it has run."""
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()

    def collect(self) -> None:
        """Stop the profiler and read its device events up to the end
        (slow: outside any lock the writers need)."""
        self._prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                raw = json.load(f)
        finally:
            os.unlink(path)
        self._prof = None
        evs = [e for e in raw.get("traceEvents", [])
               if e.get("ph") == "X"
               and str(e.get("cat", "")).lower() in DEVICE_CATS]
        if not evs:
            raise RuntimeError("the profiler recorded no device event in "
                               "the traced stretch")
        evs.sort(key=lambda e: float(e["ts"]))
        # the marker is the first device event: its start is the host's
        # launch time, to within the launch latency
        off = float(evs[0]["ts"]) - 1e6 * self._mark
        end = 1e6 * self.t1
        self.events = [(e["name"], float(e["ts"]) - off, float(e["dur"]))
                       for e in evs[1:] if float(e["ts"]) - off < end]

    def busy_s(self) -> float:
        """Seconds in which some device operation ran (their union)."""
        busy, end = 0.0, None
        for _, ts, dur in self.events:
            if end is None or ts > end:
                busy += dur
                end = ts + dur
            elif ts + dur > end:
                busy += ts + dur - end
                end = ts + dur
        return busy / 1e6

    def window_s(self) -> float:
        return self.t1 - self.t0

    def gaps(self) -> list:
        """(start s, length s) of each stretch of the window in which no
        device operation ran, on the host's clock."""
        out, cur = [], 1e6 * self.t0
        for _, ts, dur in self.events:
            if ts > cur:
                out.append((cur / 1e6, (ts - cur) / 1e6))
            cur = max(cur, ts + dur)
        if 1e6 * self.t1 > cur:
            out.append((cur / 1e6, self.t1 - cur / 1e6))
        return out

    def kernel_times(self, needle: str) -> list:
        """Seconds of every device operation whose name holds ``needle``."""
        return [dur / 1e6 for name, _, dur in self.events if needle in name]

    def top_ops(self, n: int = 10) -> list:
        by = defaultdict(float)
        for name, _, dur in self.events:
            by[name[:160]] += dur / 1e6
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:n]


def label_gaps(gaps: list, spans: list, n: int = 10) -> list:
    """The ``n`` longest idle gaps, each named by the host span of the
    learner thread that covers its middle (``spans``: (name, t0, t1))."""
    out = []
    for t, length in sorted(gaps, key=lambda g: -g[1])[:n]:
        mid = t + length / 2
        name = next((s for s, a, b in spans if a <= mid < b), "loop")
        out.append([f"learner:{name}", length])
    return out
