"""Fleet scale and writer-vs-sampler stress through the port: twins of the
four ``@pytest.mark.slow`` tests of ``tests/test_fleet_scale.py`` (marked
slow as there, with the reference's sizes and floors), and a short case of
each (8 streams or writers, about a second of run time) that the tier-1
run covers.

The fleet harness is the port's ``fleet_smoke.py`` on the CPU
(``device="cpu"``; its default is the card). The stress tests drive the
port's device rings on the CPU: ``DeviceFrameReplay`` with writers against
the host sampler, ``DevicePERFrameReplay`` with writers against the fused
sampler, all under one lock as the server holds it. Every test carries a
SIGALRM deadline of its own, so a hung thread fails fast.
"""

from __future__ import annotations

import signal
import threading
import time

import numpy as np
import pytest

from distributed_deep_q_tpu_torch import fleet_smoke

TIMEOUT_S = 240


@pytest.fixture(autouse=True)
def _deadline():
    def expire(signum, frame):
        raise TimeoutError(f"test exceeded its {TIMEOUT_S} s deadline")

    prev = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, TIMEOUT_S)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, prev)


# -- the fleet over the wire ---------------------------------------------------


@pytest.mark.slow
def test_fleet_64_streams_liveness_and_rates():
    """64 actor streams over the real socket protocol: every stream
    delivers, the learner keeps stepping under concurrent ingest (the
    reference's floors)."""
    r = fleet_smoke.run_fleet_smoke(num_actors=64, fill_s=4.0, measure_s=6.0,
                                    device="cpu")
    assert r["errors"] == []
    assert r["streams_seen"] == 64
    assert r["env_steps"] > 0 and r["replay_size"] > 5_000
    assert r["ingest_capacity_tps"] > 10_000, r
    assert r["ingest_transitions_per_s"] > 2_000, r
    assert r["learner_idle_steps_per_s"] > 1
    assert r["contention_ratio"] > 0.1, r
    assert r["theta_pull_mb_per_s"] > 0
    print(r)


def test_fleet_8_streams_short():
    """The same harness at 8 streams and about 1 s per phase: every stream
    delivers, θ pulls move, the learner steps alone and under ingest."""
    r = fleet_smoke.run_fleet_smoke(num_actors=8, fill_s=1.0, measure_s=1.0,
                                    device="cpu")
    assert r["errors"] == []
    assert r["streams_seen"] == 8
    assert r["env_steps"] == r["replay_size"] > 5_000
    assert r["ingest_capacity_tps"] > 0 and r["ingest_transitions_per_s"] > 0
    assert r["learner_idle_steps_per_s"] > 1
    assert r["learner_concurrent_steps_per_s"] > 1
    assert r["theta_pull_mb_per_s"] > 0


@pytest.mark.slow
def test_pixel_fleet_64_streams_fused_per():
    """64 socket actors stream frame chunks into the fused device-PER
    replay (one sub-ring per stream) while the fused learner steps (the
    reference's floors)."""
    r = fleet_smoke.run_pixel_fleet_smoke(num_actors=64, fill_s=5.0,
                                          measure_s=6.0, device="cpu")
    assert r["errors"] == []
    assert r["streams_seen"] == 64
    assert r["pixel_burst_ingest_tps"] > 5_000, r
    assert r["ingest_transitions_per_s"] > 1_000, r
    assert r["learner_idle_steps_per_s"] > 1
    assert r["contention_ratio"] > 0.1, r
    print(r)


def test_pixel_fleet_8_streams_short():
    """The pixel harness at 8 streams and about 1 s per phase: every stream
    delivers into its own sub-ring and the fused learner steps alone and
    under ingest. (On the CPU a fused step holds the replay lock for its
    whole compute, so the paced writers may land nothing while the learner
    runs: paced ingest is not held here.)"""
    r = fleet_smoke.run_pixel_fleet_smoke(num_actors=8, fill_s=1.0,
                                          measure_s=1.0, device="cpu")
    assert r["errors"] == []
    assert r["streams_seen"] == 8
    assert r["env_steps"] == r["replay_size"] >= 3_000
    assert r["pixel_burst_ingest_tps"] > 0
    assert r["learner_idle_steps_per_s"] > 1
    assert r["learner_concurrent_steps_per_s"] > 1


def test_fleet_smoke_refuses_cuda_without_a_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for run in (fleet_smoke.run_fleet_smoke,
                fleet_smoke.run_pixel_fleet_smoke):
        with pytest.raises(RuntimeError, match=r"is_available\(\) is false"):
            run(num_actors=1, device="cuda")


# -- writers against the samplers ----------------------------------------------


def _ring_stress(writers: int, chunks: int, chunk: int, samples_min: int):
    """Writer threads hammer ``add_batch`` on the port's host-sampled
    device ring while a sampler loops ``sample`` + ``update_priorities``
    under one lock: no exception, every row accounted, no slot
    overfilled, and the ring still samples cleanly after the storm."""
    from distributed_deep_q_tpu_torch.config import ReplayConfig
    from distributed_deep_q_tpu_torch.replay.device_ring import (
        DeviceFrameReplay)

    cfg = ReplayConfig(capacity=8192, batch_size=64, n_step=2,
                       prioritized=True, write_chunk=32)
    dev = DeviceFrameReplay(cfg, "cpu", (8, 8), stack=4, gamma=0.99, seed=0,
                            num_streams=writers)
    lock = threading.Lock()
    errors: list[str] = []
    samples = [0]
    writers_done = threading.Event()

    def writer(i: int) -> None:
        try:
            rng = np.random.default_rng(i)
            for t in range(chunks):
                done = np.zeros(chunk, bool)
                done[-1] = t % 3 == 2
                batch = {
                    "frame": rng.integers(0, 255, (chunk, 8, 8), np.uint8),
                    "action": rng.integers(0, 4, chunk).astype(np.int32),
                    "reward": rng.standard_normal(chunk).astype(np.float32),
                    "done": done,
                }
                with lock:
                    idx = dev.add_batch(batch, stream=i)
                assert len(idx) == chunk
        except Exception as e:
            errors.append(f"writer {i}: {type(e).__name__}: {e}")

    def sampler() -> None:
        try:
            rng = np.random.default_rng(99)
            while not writers_done.is_set() or samples[0] < samples_min:
                with lock:
                    if dev.ready(1_000):
                        b = dev.sample(64)
                        sa = b.pop("_sampled_at")
                        assert np.isfinite(b["weight"]).all()
                        assert (b["index"] >= 0).all()
                        assert (b["index"] < dev.capacity).all()
                        dev.update_priorities(
                            b["index"], np.abs(rng.standard_normal(64)),
                            sampled_at=sa)
                        samples[0] += 1
                time.sleep(0)
        except Exception as e:
            errors.append(f"sampler: {type(e).__name__}: {e}")

    ths = [threading.Thread(target=writer, args=(i,)) for i in range(writers)]
    st = threading.Thread(target=sampler)
    st.start()
    for th in ths:
        th.start()
    for th in ths:
        th.join(timeout=120)
    writers_done.set()
    st.join(timeout=120)

    assert errors == [], errors
    assert samples[0] >= samples_min
    total = writers * chunks * chunk
    assert dev.steps_added == total
    assert len(dev) == min(total, dev.capacity)
    for slot in dev.slots:
        assert len(slot) <= dev.slot_cap
    dev.flush()
    b = dev.sample(64)
    assert np.isfinite(b["weight"]).all()


@pytest.mark.slow
def test_writer_vs_sampler_stress_device_ring():
    _ring_stress(writers=8, chunks=120, chunk=16, samples_min=20)


def test_writer_vs_sampler_stress_device_ring_short():
    _ring_stress(writers=8, chunks=12, chunk=16, samples_min=5)


def _fused_stress(writers: int, chunks: int, chunk: int, steps_min: int):
    """The same storm on the fused path: writers hammer ``add_batch``
    (staging and the padded flush) while a learner thread runs fused
    sample + train + priority-update steps, all under one lock. No
    exception, every row counted, live priorities."""
    from distributed_deep_q_tpu_torch.config import (
        Config, MeshConfig, NetConfig, ReplayConfig)
    from distributed_deep_q_tpu_torch.replay.device_per import (
        DevicePERFrameReplay)
    from distributed_deep_q_tpu_torch.solver import Solver

    cfg = Config()
    cfg.mesh = MeshConfig(backend="cpu", dp=2)
    cfg.net = NetConfig(kind="nature_cnn", num_actions=4,
                        frame_shape=(36, 36))
    cfg.replay = ReplayConfig(capacity=4096, batch_size=16, n_step=2,
                              prioritized=True, device_per=True,
                              write_chunk=16)
    solver = Solver(cfg)
    dev = DevicePERFrameReplay(cfg.replay, solver.device, (36, 36), stack=4,
                               gamma=0.99, seed=0, write_chunk=16,
                               num_streams=writers,
                               num_shards=solver.num_shards)
    lock = threading.Lock()
    errors: list[str] = []
    steps = [0]
    writers_done = threading.Event()

    def writer(i: int) -> None:
        try:
            rng = np.random.default_rng(i)
            for t in range(chunks):
                done = np.zeros(chunk, bool)
                done[-1] = t % 3 == 2
                with lock:
                    dev.add_batch({
                        "frame": rng.integers(0, 255, (chunk, 36, 36),
                                              np.uint8),
                        "action": rng.integers(0, 4, chunk).astype(np.int32),
                        "reward": rng.standard_normal(chunk).astype(
                            np.float32),
                        "done": done,
                    }, stream=i)
        except Exception as e:
            errors.append(f"writer {i}: {type(e).__name__}: {e}")

    def learner() -> None:
        try:
            m = None
            while not writers_done.is_set() or steps[0] < steps_min:
                with lock:
                    if dev.ready(600):
                        m = solver.train_step_device_per(dev)
                        steps[0] += 1
                time.sleep(0)
            assert np.isfinite(float(m["loss"]))
        except Exception as e:
            errors.append(f"learner: {type(e).__name__}: {e}")

    ths = [threading.Thread(target=writer, args=(i,)) for i in range(writers)]
    lt = threading.Thread(target=learner)
    lt.start()
    for th in ths:
        th.start()
    for th in ths:
        th.join(timeout=180)
    writers_done.set()
    lt.join(timeout=180)

    assert errors == [], errors
    assert steps[0] >= steps_min
    assert dev.steps_added == writers * chunks * chunk
    dev.flush()
    prio = dev.dstate["prio"].numpy()
    assert np.isfinite(prio).all() and (prio > 0).sum() > 0


@pytest.mark.slow
def test_writer_vs_fused_sampler_stress_device_per():
    _fused_stress(writers=4, chunks=60, chunk=16, steps_min=10)


def test_writer_vs_fused_sampler_stress_device_per_short():
    _fused_stress(writers=8, chunks=10, chunk=16, steps_min=3)
