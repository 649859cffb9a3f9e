"""Port vs reference: the telemetry and profiling planes.

Tolerance: none unless stated — the same numpy-seeded inputs go through
both packages and the results are compared with ``==``:

- the health plane: the same gauge and histogram series through both
  ``HealthMonitor``s give equal wire verdicts at every tick;
- tracing: the export schema, ``self_times``/``attribution_table`` of the
  same events and the NTP skew estimates;
- ``Histogram.merge``/``snapshot``/``delta`` and ``Metrics``' histograms;
- ``TokenBucket``/``FlowController`` credits, admissions and shed hints
  under an injected clock;
- ``MFUMeter``'s gauges.

And the port's own profiling half: ``TraceWindow`` writes a
``torch.profiler`` trace on the CPU, ``fused_train_flops`` counts a fused
dispatch without touching the solver or the replay, ``train.profile_dir``
runs through both loops while ``train.profile_port`` is refused by name.
"""

import dataclasses
import json
import math
import os

import numpy as np
import pytest
import torch

from distributed_deep_q_tpu import health as ref_health
from distributed_deep_q_tpu import metrics as ref_metrics
from distributed_deep_q_tpu import profiling as ref_profiling
from distributed_deep_q_tpu import tracing as ref_tracing
from distributed_deep_q_tpu.rpc import flowcontrol as ref_flow

from distributed_deep_q_tpu_torch import health, metrics, profiling, tracing
from distributed_deep_q_tpu_torch.rpc import flowcontrol as flow

PAIRS = ((health, metrics), (ref_health, ref_metrics))


@pytest.fixture(autouse=True)
def _clean_planes():
    for m in (health, ref_health):
        m.reset()
    for t in (tracing, ref_tracing):
        t.reset()
    yield
    for m in (health, ref_health):
        m.reset()
    for t in (tracing, ref_tracing):
        t.disable()
        t.reset()


# -- health ----------------------------------------------------------------


def _health_series(seed: int, ticks: int = 120):
    """Gauges with a healthy stretch, a storm and a recovery, plus a
    latency histogram's observations per tick."""
    rng = np.random.default_rng(seed)
    out = []
    staged = 100.0
    for t in range(ticks):
        storm = 40 <= t < 75
        staged = staged * (1.3 if storm else 0.9) + rng.random() * 5
        gauges = {
            "queue/staged_rows": staged,
            "rpc/checksum_errors": float(t // 7 if storm else 3),
            "flow/credit_starvation": float(rng.random() * (0.9 if storm
                                                           else 0.1)),
            "flow/shed_total": float(t if storm else 0),
            "rpc/dispatch_errors": 0.0,
            "flow/degraded": float(storm),
            "fleet/actors_seen": 4.0,
            "unwatched/key": rng.random(),
        }
        lat = rng.exponential(400.0 if storm else 5.0, 50)
        out.append((float(t), gauges, lat))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_health_monitors_give_equal_verdicts(seed):
    series = _health_series(seed)
    verdicts = []
    for hmod, mmod in PAIRS:
        hmod.configure(enabled=True, fast_window_s=10.0, slow_window_s=30.0)
        mon = hmod.HealthMonitor(rules=hmod.default_server_rules(),
                                 trends=hmod.default_server_trends(),
                                 name="replay")
        h = mmod.Histogram(1e-3, 1e5)
        got = []
        for t, gauges, lat in series:
            h.observe_many(lat)
            got.append(mon.scrape(
                gauges=gauges,
                hists={"rpc/add_transitions_ms": h.snapshot()}, t=t))
        verdicts.append(got)
    port, ref = verdicts
    assert port == ref
    statuses = {v["status"] for v in port}
    assert len(statuses) > 1, statuses       # the storm moved the verdict
    for i in (30, 60, 100):
        assert dataclasses.asdict(health.verdict_from_wire(port[i])) == \
            dataclasses.asdict(ref_health.verdict_from_wire(ref[i]))


def test_fleet_health_and_disabled_singletons():
    for hmod, _ in PAIRS:
        assert hmod.HealthMonitor().scrape(gauges={"k": 1.0}) == \
            hmod.verdict_to_wire(hmod.NULL_VERDICT)
    fleet_out = []
    for hmod, _ in PAIRS:
        hmod.configure(enabled=True)
        fleet = hmod.FleetHealth()
        mon = hmod.HealthMonitor(rules=hmod.default_server_rules())
        for t in range(40):
            mon.sample({"rpc/checksum_errors": float(t)}, t=float(t))
        fleet.register("replay", lambda m=mon: m.verdict(t=39.0))
        fleet_out.append(hmod.verdict_to_wire(fleet.scrape(t=39.0)))
    assert fleet_out[0] == fleet_out[1]


# -- tracing -----------------------------------------------------------------


def _record(tmod, path):
    tmod.configure(enabled=True, sample_rate=1.0, lineage_rate=1.0,
                   export_dir=path)
    with tmod.span("flush"):
        with tmod.span("rpc_call"):
            tmod.instant("retry", attempt=1)
        with tmod.span("bucket_wait"):
            pass
    with tmod.span("ingest_drain"):
        pass
    return tmod.export()


def test_tracing_export_schema_is_the_references(tmp_path):
    docs = []
    for tmod, sub in ((tracing, "port"), (ref_tracing, "ref")):
        path = _record(tmod, str(tmp_path / sub))
        with open(path) as f:
            docs.append(json.load(f))
    port, ref = docs
    assert set(port) == set(ref)
    assert set(port["otherData"]) == set(ref["otherData"])

    def shape(doc):
        return sorted((e["ph"], e["name"], tuple(sorted(e)),
                       tuple(sorted(e.get("args", {}))))
                      for e in doc["traceEvents"])
    assert shape(port) == shape(ref)
    assert tracing.STAGES == ref_tracing.STAGES
    assert tracing.EVENTS == ref_tracing.EVENTS
    for key in ("KEY_TRACE", "KEY_SPAN", "KEY_SENT_AT", "KEY_RECV_AT",
                "KEY_DONE_AT", "KEY_BIRTH"):
        assert getattr(tracing, key) == getattr(ref_tracing, key)


def test_self_times_attribution_and_skew_are_equal(tmp_path):
    path = _record(tracing, str(tmp_path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    rng = np.random.default_rng(3)
    for e in events:                      # deterministic times for both
        if e["ph"] == "X":
            e["ts"] = float(rng.integers(0, 1000))
            e["dur"] = float(rng.integers(1, 500))
    assert tracing.self_times(events) == ref_tracing.self_times(events)
    assert tracing.attribution_table(events, wall_s=1e-3) == \
        ref_tracing.attribution_table(events, wall_s=1e-3)
    for _ in range(20):
        t1 = float(rng.random() * 100)
        t2 = t1 + float(rng.random())
        t3 = t2 + float(rng.random() * 0.1)
        t4 = t3 + float(rng.random())
        assert tracing.estimate_skew(t1, t2, t3, t4) == \
            ref_tracing.estimate_skew(t1, t2, t3, t4)
    for tmod in (tracing, ref_tracing):
        tmod.configure(enabled=True)
        for off, rtt in ((0.5, 0.2), (0.1, 0.05), (0.3, 0.4)):
            tmod.record_skew(off, rtt)
    assert tracing.skew_s() == ref_tracing.skew_s() == 0.1


# -- histograms and metrics ---------------------------------------------------


def _hist_state(h):
    return (list(h._counts), h.count, h.total, h.vmin, h.vmax,
            [h.percentile(q) for q in (0.5, 0.9, 0.99)], h.summary("x"))


def test_histogram_merge_snapshot_delta_are_equal():
    rng = np.random.default_rng(4)
    a_vals, b_vals, c_vals = (rng.lognormal(0, 3, 500) for _ in range(3))
    out = []
    for mmod in (metrics, ref_metrics):
        a, b = mmod.Histogram(), mmod.Histogram()
        a.observe_many(a_vals)
        b.observe_many(b_vals)
        snap = a.snapshot()
        a.observe_many(c_vals)
        window = a.delta(snap)
        merged = a.snapshot().merge(b)
        reset = b.snapshot()
        reset.reset()
        out.append([_hist_state(x) for x in (a, snap, window, merged)]
                   + [_hist_state(a.delta(merged)), reset.count,
                      math.isnan(reset.mean)])
        with pytest.raises(ValueError):
            a.merge(mmod.Histogram(1.0, 10.0))
    assert out[0] == out[1]


def test_metrics_histograms_and_telemetry(tmp_path):
    recs = []
    for mmod, name in ((metrics, "port"), (ref_metrics, "ref")):
        path = str(tmp_path / f"{name}.jsonl")
        m = mmod.Metrics(path)
        m.gauge("queue/replay_size", 7)
        m.observe("lat_ms", 3.0)
        m.observe_many("lat_ms", [1.0, 2.0, 40.0])
        m.histogram("size", 1.0, 1e6, per_decade=5).observe(1234.0)
        m.log(1, **m.telemetry())
        m.close()
        with open(path) as f:
            rec = json.loads(f.read())
        rec.pop("t")
        recs.append(rec)
    assert recs[0] == recs[1]


# -- flow control under an injected clock --------------------------------------


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


class _FakeReplay:
    def __init__(self, capacity=10_000, size=0, pending=0):
        self.capacity, self.size, self.pending = capacity, size, pending

    def __len__(self):
        return self.size

    def pending_rows(self):
        return self.pending

    def flush(self):
        self.pending = 0


def _flow_script(fmod, seed: int) -> list:
    rng = np.random.default_rng(seed)
    clock = _Clock()
    replay = _FakeReplay(capacity=50_000)
    fc = fmod.FlowController(
        fmod.FlowConfig(staged_high_watermark=2_000, shed_policy="fair",
                        ingest_factor=2.0, rate_halflife_s=1.0),
        replay=replay, clock=clock)
    tb = fmod.TokenBucket(burst_s=1.0, max_wait_s=5.0, clock=clock)
    out = []
    for step in range(300):
        clock.t += 0.05
        replay.size = min(replay.size + 40, replay.capacity)
        replay.pending = int(rng.integers(0, 3_000))
        fc.note_consumed(int(rng.integers(0, 50)))
        actor = int(rng.integers(0, 4))
        rows = int(rng.integers(1, 200))
        admitted, retry = fc.admit(actor, rows)
        if admitted:
            fc.on_ingest(actor, rows)
        credits = fc.grant(actor)
        tb.grant(credits)
        out.append((admitted, retry, credits, tb.reserve(rows)))
        if step % 50 == 49:
            fc.set_degraded(step % 100 == 49)
    c = fc.counters()
    out.append({k: (round(v, 9) if isinstance(v, float) else v)
                for k, v in c.items()})
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_flow_control_decisions_are_equal(seed):
    got, want = _flow_script(flow, seed), _flow_script(ref_flow, seed)
    assert got == want
    assert any(not a for a, *_ in got[:-1])     # some flushes shed
    assert any(a for a, *_ in got[:-1])


# -- profiling ---------------------------------------------------------------


def test_mfu_meter_gauges_are_equal():
    rows = []
    for mod in (profiling, ref_profiling):
        m = mod.MFUMeter(flops_per_step=4.5e10, peak_flops=989.4e12)
        none = mod.MFUMeter(flops_per_step=None, peak_flops=None)
        seq = [m.update(0, t=0.0), m.update(100, t=2.0),
               m.update(250, t=3.5, ingest_rate=4000.0, consume_rate=512.0),
               m.update(250, t=4.0, ingest_rate=0.0, consume_rate=1.0),
               none.update(0, t=0.0), none.update(10, t=1.0)]
        rows.append(seq)
    assert rows[0] == rows[1]
    assert "train/mfu" in rows[0][1] and "train/mfu" not in rows[0][5]


def test_peak_flops_is_the_cards_only():
    assert profiling.peak_flops_for("cpu") is None
    assert profiling.PEAK_FLOPS["NVIDIA H100 80GB HBM3"] == 989.4e12
    if not torch.cuda.is_available():
        assert profiling.peak_flops_for() is None


def test_trace_window_writes_a_trace_on_the_cpu(tmp_path):
    logdir = str(tmp_path / "trace")
    w = profiling.TraceWindow(logdir, start_step=3, num_steps=4)
    x = torch.randn(64, 64)
    for step in range(1, 12):
        x = torch.tanh(x @ x.T / 64)
        w.on_step(step)
    assert not w._active and w._done
    files = os.listdir(logdir)
    assert files and any(f.endswith(".json") for f in files)
    census = w.census(steps=4)
    assert census["kernel_launches_per_grad_step"] == 0   # no card here
    assert census["wall_ms_per_grad_step"] > 0
    # off when no directory is given; stop() ends a window early
    off = profiling.TraceWindow("", start_step=0)
    off.on_step(5)
    assert not off._active
    early = profiling.TraceWindow(str(tmp_path / "early"), 0, 1000)
    early.on_step(0)
    early.close()
    assert os.listdir(tmp_path / "early")


def test_launch_census_counts_calls(tmp_path):
    calls = []
    census = profiling.launch_census(lambda: calls.append(1), steps=6,
                                     calls=3)
    assert len(calls) == 3
    assert set(census) >= {"wall_ms_per_grad_step", "device_busy_share",
                           "kernel_launches_per_grad_step",
                           "top_kernels_ms_per_grad_step", "port_kernels"}


def test_fused_train_flops_counts_without_side_effects():
    from distributed_deep_q_tpu_torch.config import pong_config
    from distributed_deep_q_tpu_torch.replay.device_per import (
        DevicePERFrameReplay)
    from distributed_deep_q_tpu_torch.solver import Solver

    torch.set_num_threads(1)
    cfg = pong_config()
    cfg.mesh.backend = "cpu"
    cfg.net.frame_shape = (36, 36)
    cfg.net.compute_dtype = "float32"
    cfg.net.num_actions = 4
    cfg.replay.capacity, cfg.replay.batch_size = 2048, 16
    solver = Solver(cfg)
    replay = DevicePERFrameReplay(cfg.replay, "cpu", (36, 36), stack=4,
                                  write_chunk=16)
    rng = np.random.default_rng(0)
    n = 400
    replay.add_batch({"frame": rng.integers(0, 255, (n, 36, 36), np.uint8),
                      "action": rng.integers(0, 4, n).astype(np.int32),
                      "reward": rng.random(n).astype(np.float32),
                      "done": (np.arange(n) % 50) == 49})
    replay.flush()
    before = {k: v.clone() for k, v in solver.state.net.state_dict().items()}
    prio = replay.dstate["prio"].clone()
    samples, keys = replay._samples, solver._fused_key_base
    flops = profiling.fused_train_flops(solver, replay, chain=1)
    # the Nature CNN over 16 stacks at 36×36: 28.5 MFLOP per forward (θ on
    # s, θ⁻ on s'; the preset has no Double DQN) and a backward through θ
    # (grad weights for every layer, grad inputs past conv1)
    assert flops and 9e7 < flops < 1.1e8, flops
    for k, v in solver.state.net.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert torch.equal(replay.dstate["prio"], prio)
    assert (replay._samples, solver._fused_key_base) == (samples, keys)
    assert int(solver.state.step) == 0


def _cartpole_argv(*extra):
    return ["train", "--preset", "cartpole", "--backend", "cpu",
            "--log-every", "50", "--set", "train.total_steps=400",
            "replay.learn_start=100", *extra]


def test_profile_dir_traces_both_loops_and_profile_port_is_refused(
        tmp_path, capsys):
    from distributed_deep_q_tpu_torch.config import r2d2_config
    from distributed_deep_q_tpu_torch.main import main
    from distributed_deep_q_tpu_torch.train import train_recurrent

    torch.set_num_threads(1)
    prof = str(tmp_path / "prof")
    assert main(_cartpole_argv(f"train.profile_dir={prof}",
                               "train.profile_start_step=10",
                               "train.profile_num_steps=5")) == 0
    capsys.readouterr()
    assert os.listdir(prof)
    cfg = r2d2_config()
    cfg.mesh.backend = "cpu"
    cfg.env.kind, cfg.env.id = "signal_atari", "signal"
    cfg.env.frame_shape = cfg.net.frame_shape = (36, 36)
    cfg.net.compute_dtype, cfg.net.lstm_size = "float32", 16
    cfg.replay.capacity, cfg.replay.batch_size = 2048, 4
    cfg.replay.sequence_length, cfg.replay.burn_in = 16, 4
    cfg.replay.learn_start, cfg.train.total_steps = 160, 300
    cfg.train.train_every, cfg.train.eval_episodes = 16, 1
    rprof = str(tmp_path / "rprof")
    cfg.train.profile_dir = rprof
    cfg.train.profile_start_step, cfg.train.profile_num_steps = 1, 2
    out = train_recurrent(cfg)
    assert out["grad_steps"] > 3 and os.listdir(rprof)
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        main(_cartpole_argv("train.profile_port=6006"))
