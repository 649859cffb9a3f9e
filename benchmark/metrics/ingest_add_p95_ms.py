"""The 95th percentile, over every writer chunk sent in the window, of the
milliseconds from when the chunk was due to when the flush that landed
its last row returned (``replay/columnar.py``'s ``IngestDrain`` or the
learner's pre-dispatch flush)."""

import numpy as np

from benchmark.traffic import chunk_latencies


def read(ctx):
    lat = chunk_latencies(ctx.out)
    if len(lat) < 20:
        return None
    return 1e3 * float(np.percentile(lat, 95))
