"""The per-layer readers on a made-up run: what each reads, and that a
reader with nothing to read returns nothing."""

from __future__ import annotations

import json
from types import SimpleNamespace

import pytest

from benchmark import peaks, system, traffic
from benchmark.trace import Stretch, label_gaps

with open(system.BENCH_DIR / "configs" / "apex.json") as f:
    APEX = json.load(f)
COUNTS = system.load_module("counts", "apex")
READERS = ["dispatch_host_ms", "device_idle_pct", "step_mfu",
           "gather_windows_roofline", "scatter_rows_roofline",
           "ingest_add_p95_ms", "learner_lock_hold_ms"]


def ctx(out):
    return SimpleNamespace(out=out, cfg=APEX, chain=32, counts=COUNTS,
                           flops=COUNTS.flops_per_step(APEX), peaks=peaks)


def stretch() -> Stretch:
    """A 10 ms stretch from t = 100 s: a B1 launch of 1 ms, a 2 ms gap, a
    B2 launch of 0.5 ms, then idle to the end."""
    st = Stretch()
    st.t0, st.t1 = 100.0, 100.010
    st.events = [("gather_windows_kernel(...)", 100.001e6, 1000.0),
                 ("scatter_rows_kernel(...)", 100.004e6, 500.0)]
    return st


@pytest.mark.parametrize("name", READERS)
def test_nothing_to_read_reads_nothing(name):
    out = traffic.Outcome()
    assert system.load_module("metrics", name).read(ctx(out)) is None


def test_readers_on_a_made_up_run():
    out = traffic.Outcome()
    out.dispatch_s = [0.32, 0.32]
    out.lock_hold_s = [0.2, 0.3]
    out.outside = (640, 5.0)
    out.stretch = stretch()
    out.stretch_landed = (1000, 1128)
    out.writers = SimpleNamespace(chunks=[], chunk=64)
    c = ctx(out)

    def read(name):
        return system.load_module("metrics", name).read(c)

    assert read("dispatch_host_ms") == pytest.approx(10.0)
    assert read("learner_lock_hold_ms") == pytest.approx(250.0)
    assert read("device_idle_pct") == pytest.approx(85.0)
    ideal = 44_530_401_280.0 / peaks.FLOPS["bf16"]
    assert read("step_mfu") == pytest.approx(100 * ideal / (5.0 / 640))
    b1 = COUNTS.gather_bytes(APEX, 32) / peaks.HBM_BYTES_PER_S
    assert read("gather_windows_roofline") == pytest.approx(100 * b1 / 1e-3)
    b2 = 128 * 2 * 84 * 84 / peaks.HBM_BYTES_PER_S
    assert read("scatter_rows_roofline") == pytest.approx(100 * b2 / 5e-4)


def test_gaps_and_their_host_spans():
    st = stretch()
    assert st.busy_s() == pytest.approx(1.5e-3)
    gaps = st.gaps()
    assert [round(g[1] * 1e3, 6) for g in gaps] == [1.0, 2.0, 5.5]
    spans = [("dispatch", 100.0, 100.0035), ("lock_wait", 100.0035, 101)]
    assert label_gaps(gaps, spans, 2) == [
        ["learner:lock_wait", pytest.approx(5.5e-3)],
        ["learner:dispatch", pytest.approx(2e-3)]]


def test_chunk_latency_is_due_to_landing():
    out = traffic.Outcome()
    out.t_open, out.t_close = 10.0, 20.0
    out.writers = SimpleNamespace(chunks=[
        (0, 9.0, 9.5, 64),       # sent before the window: not counted
        (1, 11.0, 11.1, 128),
        (2, 12.0, 12.2, 192)], chunk=64)
    out.flushes = [(9.6, 64), (11.5, 150), (13.0, 192)]
    assert traffic.chunk_latencies(out) == [pytest.approx(0.5),
                                            pytest.approx(1.0)]
    assert traffic.window_chunks(out) == 2
