"""Fleet-scale smoke harness: a learner host serving an Ape-X-scale
actor fleet.

The port's copy of the reference's ``scripts/fleet_smoke.py`` (port tools
live in the port package), with the same result keys. The learner runs on
``device``: the card by default, which raises when there is none; the
tests pass ``"cpu"``. The timed loops end in a synchronize of the
learner's device, where the reference blocks until θ is ready.

Measures the learner host's capacity to serve an Ape-X-scale actor fleet:
N actor THREADS (one real socket connection each — the production wire
protocol, ``rpc/protocol.py``) stream n-step transition chunks into a
``ReplayFeedServer`` and pull θ periodically, while the learner loop
samples and steps under the production ``replay_lock`` discipline.

Thread actors, not processes: the RPC boundary (sockets + serialization +
server lock) is what scales with fleet size and is exactly what this
measures; env simulation cost is per-actor-host and irrelevant to the
learner-side question "does ingest at fleet scale starve the learner?".
On a 1-core container 64 OS processes would measure only timeshare
thrash; on a many-core actor host run ``actor_main`` processes instead
(actors/supervisor.py) — same protocol, same server path.

Phases: (A) fill/burst — actors stream UNTHROTTLED, measuring the server's
raw ingest capacity; (B) idle learner — actors paused, solo grad-step
rate; (C) concurrent — actors PACED to a realistic per-actor env rate
(flooding writers on a shared box measure GIL starvation, not the
production regime where each actor emits at env speed) + learner
together. Reported: burst ingest capacity, paced achieved ingest, idle vs
concurrent grad-steps/s (the contention ratio), θ-pull MB/s, distinct
streams seen, per-thread errors.

Run: ``python -m distributed_deep_q_tpu_torch.fleet_smoke [num_actors]
[vector|pixel] [--device cpu]`` → one JSON line (``pixel`` = frame streams
into the fused device-PER replay).

NOTE: ``run_pixel_fleet_smoke`` intentionally mirrors (rather than
parameterizes) this harness's phase scaffolding — the two measure
different replay/learner stacks and keeping each linear keeps the
measurement auditable; sync fixes to the pacing/phase logic in both.
"""

from __future__ import annotations

import json
import sys
import threading
import time

import numpy as np


def _sync(dev) -> None:
    """Wait for the learner's queued device work (a no-op on the CPU)."""
    if dev.type == "cuda":
        import torch
        torch.cuda.synchronize(dev)


def run_fleet_smoke(num_actors: int = 64, fill_s: float = 4.0,
                    measure_s: float = 6.0, obs_dim: int = 8,
                    batch: int = 64, send_batch: int = 32,
                    pull_every: int = 10,
                    rate_per_actor: float = 256.0,
                    device: str = "cuda") -> dict:
    from distributed_deep_q_tpu_torch.config import Config, NetConfig
    from distributed_deep_q_tpu_torch.replay.replay_memory import ReplayMemory
    from distributed_deep_q_tpu_torch.rpc.replay_server import (
        ReplayFeedClient, ReplayFeedServer)
    from distributed_deep_q_tpu_torch.solver import Solver, select_device

    dev = select_device(device)
    cfg = Config()
    cfg.net = NetConfig(kind="mlp", num_actions=4, hidden=(64, 64))
    cfg.mesh.backend = dev.type
    cfg.replay.batch_size = batch
    solver = Solver(cfg, obs_dim=obs_dim)

    replay = ReplayMemory(262_144, (obs_dim,), np.float32, seed=0)
    server = ReplayFeedServer(replay)
    server.publish_params(solver.get_weights())
    host, port = server.address

    stop = threading.Event()
    actors_live = threading.Event()
    actors_live.set()
    burst = threading.Event()  # set = unthrottled (capacity measurement)
    burst.set()
    sent = [0] * num_actors
    theta_bytes = [0] * num_actors
    errors: list[str] = []

    def actor(i: int) -> None:
        try:
            rng = np.random.default_rng(i)
            client = ReplayFeedClient(host, port, actor_id=i)
            chunk = {
                "obs": rng.standard_normal(
                    (send_batch, obs_dim)).astype(np.float32),
                "action": rng.integers(0, 4, send_batch).astype(np.int32),
                "reward": rng.standard_normal(send_batch).astype(np.float32),
                "next_obs": rng.standard_normal(
                    (send_batch, obs_dim)).astype(np.float32),
                "discount": np.full(send_batch, 0.99, np.float32),
            }
            t = 0
            interval = send_batch / rate_per_actor
            next_due = time.perf_counter()
            while not stop.is_set():
                if not actors_live.is_set():
                    next_due = time.perf_counter()
                    time.sleep(0.01)
                    continue
                if not burst.is_set():
                    delay = next_due - time.perf_counter()
                    if delay > 0:
                        time.sleep(delay)
                    next_due = max(next_due + interval, time.perf_counter())
                client.add_transitions(**chunk)
                sent[i] += send_batch
                t += 1
                if t % pull_every == 0:
                    _, w = client.get_params(have_version=-1)
                    if w is not None:
                        theta_bytes[i] += sum(x.nbytes for x in w)
            client.close()
        except Exception as e:  # liveness assertion surface
            errors.append(f"actor {i}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=actor, args=(i,), daemon=True)
               for i in range(num_actors)]
    t_spawn = time.perf_counter()
    for th in threads:
        th.start()

    def learner_steps(duration: float) -> float:
        n = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < duration:
            with server.replay_lock:
                b = replay.sample(batch)
            solver.train_step(b)
            n += 1
        _sync(solver.device)
        return n / (time.perf_counter() - t0)

    # phase A: fill at full burst — the raw ingest-capacity number
    while len(replay) < 5_000 and time.perf_counter() - t_spawn < 60:
        time.sleep(0.05)
    a0 = sum(sent)
    ta = time.perf_counter()
    time.sleep(max(0.5, fill_s - (ta - t_spawn)))
    burst_tps = (sum(sent) - a0) / (time.perf_counter() - ta)
    burst.clear()  # phase C runs paced

    # phase B: idle learner (actors paused)
    actors_live.clear()
    time.sleep(0.2)
    solver.train_step(replay.sample(batch))  # compile outside timing
    idle_sps = learner_steps(measure_s / 2)

    # phase C: concurrent
    actors_live.set()
    sent_before = sum(sent)
    theta_before = sum(theta_bytes)
    t0 = time.perf_counter()
    conc_sps = learner_steps(measure_s)
    dt = time.perf_counter() - t0
    ingest_tps = (sum(sent) - sent_before) / dt
    theta_mb_s = (sum(theta_bytes) - theta_before) / dt / 2**20
    server.publish_params(solver.get_weights())  # exercise re-publish

    stop.set()
    for th in threads:
        th.join(timeout=10)
    streams_seen = len(server.last_seen)
    server.close()
    return {
        "num_actors": num_actors,
        "streams_seen": streams_seen,
        "ingest_capacity_tps": round(burst_tps, 1),
        "ingest_target_tps": round(rate_per_actor * num_actors, 1),
        "ingest_transitions_per_s": round(ingest_tps, 1),
        "learner_idle_steps_per_s": round(idle_sps, 2),
        "learner_concurrent_steps_per_s": round(conc_sps, 2),
        "contention_ratio": round(conc_sps / max(idle_sps, 1e-9), 3),
        "theta_pull_mb_per_s": round(theta_mb_s, 3),
        "replay_size": len(replay),
        "env_steps": server.env_steps,
        "errors": errors,
    }


def run_pixel_fleet_smoke(num_actors: int = 64, fill_s: float = 5.0,
                          measure_s: float = 6.0, batch: int = 32,
                          send_batch: int = 16,
                          rate_per_actor: float = 128.0,
                          frame_hw: int = 36, device: str = "cuda",
                          capacity: int = 65_536,
                          compute_dtype: str = "float32") -> dict:
    """The Ape-X fleet's REAL data path at fleet scale: socket actors
    stream FRAME chunks into the fused device-PER replay (one stream per
    actor → its own sub-ring) while the learner runs zero-readback fused
    steps under the server lock. Same phase structure as
    ``run_fleet_smoke``. The defaults are the reference's; the Pong
    preset's geometry is ``frame_hw=84, batch=512, capacity=1_000_000,
    compute_dtype="bfloat16"``.
    """
    from distributed_deep_q_tpu_torch.config import Config, NetConfig, ReplayConfig
    from distributed_deep_q_tpu_torch.replay.device_per import DevicePERFrameReplay
    from distributed_deep_q_tpu_torch.rpc.replay_server import (
        ReplayFeedClient, ReplayFeedServer)
    from distributed_deep_q_tpu_torch.solver import Solver, select_device

    dev = select_device(device)
    cfg = Config()
    cfg.mesh.backend = dev.type
    cfg.net = NetConfig(kind="nature_cnn", num_actions=4,
                        frame_shape=(frame_hw, frame_hw),
                        compute_dtype=compute_dtype)
    cfg.replay = ReplayConfig(capacity=capacity, batch_size=batch, n_step=2,
                              prioritized=True, device_per=True,
                              write_chunk=64)
    solver = Solver(cfg)
    replay = DevicePERFrameReplay(cfg.replay, solver.device,
                                  (frame_hw, frame_hw), stack=4,
                                  gamma=0.99, seed=0, write_chunk=64,
                                  num_streams=num_actors)
    server = ReplayFeedServer(replay)
    server.publish_params(solver.get_weights())
    host, port = server.address

    stop = threading.Event()
    actors_live = threading.Event()
    actors_live.set()
    burst = threading.Event()
    burst.set()
    sent = [0] * num_actors
    errors: list[str] = []

    def actor(i: int) -> None:
        try:
            rng = np.random.default_rng(i)
            client = ReplayFeedClient(host, port, actor_id=i)
            client.call("reset_stream")
            frames = rng.integers(0, 255, (send_batch, frame_hw, frame_hw),
                                  dtype=np.uint8)
            t = 0
            interval = send_batch / rate_per_actor
            next_due = time.perf_counter()
            while not stop.is_set():
                if not actors_live.is_set():
                    next_due = time.perf_counter()
                    time.sleep(0.01)
                    continue
                if not burst.is_set():
                    delay = next_due - time.perf_counter()
                    if delay > 0:
                        time.sleep(delay)
                    next_due = max(next_due + interval, time.perf_counter())
                done = np.zeros(send_batch, bool)
                done[-1] = t % 4 == 3
                client.add_transitions(
                    frame=frames, action=np.zeros(send_batch, np.int32),
                    reward=np.ones(send_batch, np.float32), done=done,
                    boundary=done)
                sent[i] += send_batch
                t += 1
            client.close()
        except Exception as e:
            errors.append(f"actor {i}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=actor, args=(i,), daemon=True)
               for i in range(num_actors)]
    t_spawn = time.perf_counter()
    for th in threads:
        th.start()

    def learner_steps(duration: float) -> float:
        n = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < duration:
            with server.replay_lock:
                solver.train_step_device_per(replay)
            n += 1
        _sync(solver.device)
        return n / (time.perf_counter() - t0)

    # phase A: burst fill → raw pixel ingest capacity
    while not replay.ready(3_000) and time.perf_counter() - t_spawn < 120:
        time.sleep(0.05)
    a0, ta = sum(sent), time.perf_counter()
    time.sleep(max(0.5, fill_s - (ta - t_spawn)))
    burst_tps = (sum(sent) - a0) / (time.perf_counter() - ta)
    burst.clear()

    # phase B: idle fused learner
    actors_live.clear()
    time.sleep(0.2)
    with server.replay_lock:
        solver.train_step_device_per(replay)  # compile outside timing
    idle_sps = learner_steps(measure_s / 2)

    # phase C: concurrent paced ingest + fused learner
    actors_live.set()
    sent_before = sum(sent)
    t0 = time.perf_counter()
    conc_sps = learner_steps(measure_s)
    ingest_tps = (sum(sent) - sent_before) / (time.perf_counter() - t0)

    stop.set()
    for th in threads:
        th.join(timeout=10)
    streams_seen = len(server.last_seen)
    server.close()
    return {
        "num_actors": num_actors,
        "streams_seen": streams_seen,
        "pixel_burst_ingest_tps": round(burst_tps, 1),
        "ingest_target_tps": round(rate_per_actor * num_actors, 1),
        "ingest_transitions_per_s": round(ingest_tps, 1),
        "learner_idle_steps_per_s": round(idle_sps, 2),
        "learner_concurrent_steps_per_s": round(conc_sps, 2),
        "contention_ratio": round(conc_sps / max(idle_sps, 1e-9), 3),
        "replay_size": len(replay),
        "env_steps": server.env_steps,
        "errors": errors,
    }


if __name__ == "__main__":
    n, mode, device = 64, "vector", "cuda"
    args = sys.argv[1:]
    if "--device" in args:
        i = args.index("--device")
        device = args[i + 1]
        del args[i:i + 2]
    for arg in args:
        if arg.isdigit():
            n = int(arg)
        elif arg in ("vector", "pixel"):
            mode = arg
        else:
            sys.exit(f"usage: fleet_smoke [num_actors] [vector|pixel] "
                     f"[--device cpu] (got {arg!r})")
    run = run_pixel_fleet_smoke if mode == "pixel" else run_fleet_smoke
    print(json.dumps(run(num_actors=n, device=device)))
