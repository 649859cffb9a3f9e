"""Chaos smoke — prove the RPC fault-tolerance stack end to end.

The port's copy of the reference's ``scripts/chaos_smoke.py`` (port tools
live in the port package): the same command line, modes, defaults, fault
specs and verdict keys. The host-only modes (default, ``overload``,
``health``, ``learn``, ``durability``, ``churn``) are copies with the
imports rewritten. The modes that run device code (``ingest``,
``inference``, ``vector``, ``tenants``, ``train``) run on the card unless
the caller passes ``device="cpu"`` (on the command line ``--device cpu``);
a CUDA device without a card raises, and nothing falls back to the CPU.
Each of them also takes the sizes it runs at, so the card runs them at
the Pong preset's width (``chip_smoke.py`` phase 17); the defaults are the
reference's CPU sizes. Their verdicts carry the reference's keys and a
few of their own (``device``; the inference reply latencies).

On the card the inference oracles stay exact: the served policy records
the bucket each observation was served at, and the oracle, the same θ on
the same device with cuDNN deterministic, forwards the observation padded
to that bucket (cuBLAS and cuDNN pick their algorithm per batch shape, so
a forward at another shape may differ in its low bits and flip a
near-tie).

As in the reference, no mode runs on a tree its static-analysis gate
rejects: ``main`` first runs the port's gate (``python -m
distributed_deep_q_tpu_torch.analysis``) over the port package and, on
any finding, prints them to stderr and exits 2 (``_require_clean_gate``).

Eleven modes:

``python -m distributed_deep_q_tpu_torch.chaos_smoke [num_actors] [spec]`` (default)
    Threaded actor fleet over the production wire protocol: resilient
    clients stream LABELED transitions into a ``ReplayFeedServer`` while
    the chaos shim drops and truncates connections on both sides, and the
    learner is killed and warm-rebooted from its snapshot mid-run on the
    same port. Prints one JSON verdict line; exit status 1 if any
    transition was lost or duplicated. Fast (seconds), CPU-only, no device —
    runnable on any box as a release gate for the resilience plane. The
    run is traced end to end (sample_rate=1), and the verdict also gates
    on causal integrity: zero orphan spans, retry cycles visible as
    ``retry`` instants (overload mode: sheds visible as ``shed``).

``python -m distributed_deep_q_tpu_torch.chaos_smoke overload [spec]``
    Overload acceptance: a producer fleet deliberately outruns a
    rate-capped consumer, so the server's admission controller must shed —
    the gate is *shed but never lost*: every transition lands exactly once
    (the shed flush re-stages under its original ``flush_seq``), sheds
    actually fired, and the clients' token buckets paced to the granted
    credits. Chaos delays compose on top via the optional spec.

``python -m distributed_deep_q_tpu_torch.chaos_smoke ingest [spec]``
    Ingest-saturation acceptance: a producer fleet streams
    LABELED pixel frames into a device replay ring through the full
    columnar path — wire decode → ``ColumnStage`` staged-append →
    ``IngestDrain`` batched flush — faster than a rate-capped consumer,
    so the admission controller must shed. The gate is the overload
    contract held at saturation through the NEW staging plane: sheds
    fired, the drain (not the writers) carried the flushes, and every
    frame landed in the HBM ring exactly once (ids decoded back out of
    the ring rows).

``python -m distributed_deep_q_tpu_torch.chaos_smoke inference [spec]``
    Inference-plane acceptance: a client fleet streams
    deterministic labeled observations at an ``InferenceServer`` while
    the chaos shim drops, truncates, delays, and bit-flips connections.
    Every reply's action is checked against the local argmax of the SAME
    θ for that exact observation — the gate is zero wrong, zero missing,
    zero duplicated actions despite reconnects and shed/retry cycles
    (``infer`` is pure in (θ, obs), so retries need no dedup; a wrong
    action would mean a slicing/padding/batching bug under fault load).

``python -m distributed_deep_q_tpu_torch.chaos_smoke vector [spec]``
    Vector-actor acceptance: the vectorized acting loop's
    ε-greedy tick (``select_actions`` over labeled observation batches)
    drives the production ``_RemoteInference`` retry path while the
    chaos shim drops/truncates the wire AND the inference server is
    hard-killed mid-run, then rebooted with the same θ on the same
    port. The gate: the loop rode out the outage through shed/retry
    with zero wrong, zero duplicated, and zero missing actions — every
    tick's action vector matches a local same-seed oracle replay of the
    identical ε-stream, so the greedy-subset batching (only non-explore
    rows ride the RPC) never crossed rows under fault load.

``python -m distributed_deep_q_tpu_torch.chaos_smoke health [spec]``
    Health-plane acceptance: clean traffic streams into a
    ``ReplayFeedServer`` whose ``health`` RPC a supervisor-side
    ``FleetHealth`` scrapes on every tick, with the SLO windows shrunk
    to fractions of a second. Mid-run, ``corrupt=`` wire chaos is
    installed: CRC-rejected frames move ``rpc/checksum_errors``, whose
    rate_above(0) burn-rate rule must flip the FLEET verdict ok →
    degraded with the finding naming ``wire_integrity``; after the
    chaos is uninstalled the hysteresis clear must bring it back to ok.
    The gate: the full ok → degraded → ok arc, ZERO critical flaps
    (every default rule is degraded-severity — a wire fault must never
    page as critical), and the per-tick ``health/verdict`` JSONL the
    run writes passes ``telemetry_report``'s strict SLO checks after
    recovery.

``python -m distributed_deep_q_tpu_torch.chaos_smoke learn [spike]``
    Learning-divergence acceptance: a synthetic learner
    feeds learning-dynamics planes (``learning.py`` layout) through the
    unmodified production read path — ``LearnAccumulator`` fold,
    ``learn/*`` gauges, divergence ``TrendRule``s, ``FleetHealth``. A
    mid-run lr spike (multiplicative loss/grad-norm growth per step)
    must flip the fleet verdict ok → degraded with ``loss_divergence``
    named; restoring the lr must walk it back to a STABLE ok. The gate:
    the full arc, zero critical flaps, schema-valid verdict JSONL, and
    ``telemetry_report``'s strict learn gate still catching the
    recovered divergence.

``python -m distributed_deep_q_tpu_torch.chaos_smoke durability [cycles] [spec]``
    Crash-recovery acceptance: the server is hard-killed at
    random points across the snapshot cadence over ≥ 20 cycles — before,
    during (async dump in flight), and after commits — under ``torn=``
    disk damage and ``corrupt=`` wire flips, with fabricated
    crashed-before-commit generation directories thrown in. The gate:
    every warm boot lands exactly on the newest generation that verifies
    clean (checked against an independent pre-boot probe), and after
    actors replay their full labeled history through the flush-seq dedup
    there are zero lost, zero duplicated, and zero corrupt rows.

``python -m distributed_deep_q_tpu_torch.chaos_smoke churn``
    Elastic-fleet acceptance: two learner hosts serve a
    hash-assigned actor fleet through the membership registry; mid-run
    one host gracefully retires (replay shard exported through the
    GenerationStore handoff) and a fresh host imports the shard and
    joins. The gate: the fleet verdict walks ok → degraded
    (``member_unreachable`` named) → ok with zero critical flaps, the
    autoscaler's shrink/grow decisions land lineage-traceable in the
    run JSONL, remapped actors reconnect (``rpc/mass_reconnects``
    moves) with in-flight flushes exactly-once across the handoff, and
    the labeled-frame ledger over the union of surviving shards shows
    zero lost, zero duplicated transitions and zero wrong actions.

``python -m distributed_deep_q_tpu_torch.chaos_smoke tenants``
    Closed-control-loop acceptance, two arcs on one JSONL.
    Arc 1 — multi-tenant serving: one ``InferenceServer`` serves a
    primary θ, an A/B arm, and a mirror-only shadow tenant to a
    hash-split client fleet under wire chaos while a forward-latency
    stall overloads the queue; the degrade ladder must shed strictly
    shadow → ab → primary, shadow replies must never reach a client,
    per-tenant SLO rules must name ``tenant/*`` findings, and every
    reply must carry the RIGHT arm's action and θ version (per-arm
    oracle replay: zero lost, duplicated, or wrong). Arc 2 — autoscale
    executor: a spawned actor fleet streams labeled transitions while a
    burst producer forces ``ingest_shed``; the health-driven autoscaler
    must shrink, the executor must drain + retire a REAL process
    (eviction of its exactly-once dedup stamp included, terminations
    counted separately from kill escalations), and the recovery streak
    must grow it back — with every applied action lineage-traceable to
    a named Decision and ``telemetry_report``'s strict SLO + elastic
    gates passing on the run JSONL.

``python -m distributed_deep_q_tpu_torch.chaos_smoke train [--preset NAME] [cfg.overrides ...]``
    The full distributed trainer (spawned actor processes, the learner on
    the card) on CartPole (or the named preset) with chaos enabled via ``cfg.actors.chaos`` — the env-var
    propagation path the fleet uses in production. Slower (a torch import
    per spawned child); prints the run summary with the robustness counters
    (restarts, kill escalations, dispatch errors, duplicate flushes).

Thread actors in the default mode for the same reason as
``fleet_smoke.py``: the RPC boundary is what's under test, and labeled
payloads make loss/duplication decidable exactly.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import sys
import tempfile
import threading
import time

import numpy as np



def _trace_begin():
    """Turn the tracer fully on for a chaos run (every span, no
    sampling): the run doubles as the causal-integrity acceptance —
    faults must not orphan spans or lose SHED/retry events."""
    from distributed_deep_q_tpu_torch import tracing

    tracing.reset()
    tracing.configure(enabled=True, sample_rate=1.0, lineage_rate=1.0,
                      buffer_spans=1 << 17)
    return tracing


def _trace_verdict(tracing) -> dict:
    """Drain the traced run and check causal integrity. An orphan is an
    event whose ``parent`` span id was never recorded — under chaos that
    would mean a dropped/torn context, so the count gates ``ok``."""
    events = tracing.drain()
    dropped = tracing.drop_count()
    tracing.disable()
    ids = {e["args"]["span"] for e in events if e.get("ph") == "X"}
    ids.add(0)
    orphans = [e for e in events if e["args"].get("parent", 0) not in ids]
    instants: dict[str, int] = {}
    for e in events:
        if e.get("ph") == "i":
            instants[e["name"]] = instants.get(e["name"], 0) + 1
    return {"spans": sum(1 for e in events if e.get("ph") == "X"),
            "orphan_spans": len(orphans),
            "span_drops": dropped,
            "instants": instants}


def _cudnn_deterministic(mode):
    """Run ``mode`` with cuDNN deterministic (the served forward and its
    oracle then pick the same algorithm for the same shape); the previous
    flags come back on return."""

    @functools.wraps(mode)
    def run(*args, **kwargs):
        import torch

        b = torch.backends.cudnn
        prev = (b.deterministic, b.benchmark)
        b.deterministic, b.benchmark = True, False
        try:
            return mode(*args, **kwargs)
        finally:
            b.deterministic, b.benchmark = prev

    return run


def _recording(policy_cls):
    """``policy_cls`` that records, for every observation row it serves,
    the bucket its forward padded to (``served``: row bytes → buckets)."""

    class Recording(policy_cls):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.served: dict[bytes, set] = {}
            self._served_lock = threading.Lock()

        def forward(self, obs, params=None, bucket=None):
            obs = np.asarray(obs)
            if len(obs) <= self.buckets[-1]:
                b = bucket or self.bucket_for(len(obs))
                with self._served_lock:
                    for row in obs:
                        self.served.setdefault(row.tobytes(), set()).add(b)
            return super().forward(obs, params=params, bucket=bucket)

    return Recording


def _oracle_actions(oracle, served: dict, obs: np.ndarray) -> list[set]:
    """The right actions of each row of ``obs``: the oracle's argmax at
    every bucket the row was served at (one bucket but for a re-sent
    request that two microbatches served), each forward the row alone
    padded with zeros to that bucket, as the server pads."""
    out = []
    for row in np.asarray(obs):
        buckets = served.get(row.tobytes()) or {oracle.bucket_for(1)}
        out.append({int(oracle.forward(row[None], bucket=b)[0][0])
                    for b in sorted(buckets)})
    return out


def _obs_shape(net, obs_dim: int) -> tuple:
    """One observation row's shape for ``net``: an MLP's float vector, or
    a pixel net's uint8 frame stack."""
    if net.kind == "mlp":
        return (obs_dim,)
    return tuple(net.frame_shape) + (net.stack,)


def _labeled_obs(seed: int, shape: tuple, rows: int | None = None):
    """A deterministic observation (batch) per seed: standard normal
    float32 for an MLP, uniform uint8 frames for a pixel net."""
    r = np.random.default_rng(seed)
    full = shape if rows is None else (rows,) + shape
    if len(shape) == 1:
        return r.standard_normal(full).astype(np.float32)
    return r.integers(0, 256, full).astype(np.uint8)


def run_chaos_smoke(num_actors: int = 4, flushes: int = 120, rows: int = 8,
                    spec: str = "drop=0.03,truncate=0.02,seed=11",
                    deadline: float = 120.0) -> dict:
    from distributed_deep_q_tpu_torch.replay.replay_memory import ReplayMemory
    from distributed_deep_q_tpu_torch.rpc import faultinject
    from distributed_deep_q_tpu_torch.rpc.replay_server import ReplayFeedServer
    from distributed_deep_q_tpu_torch.rpc.resilience import (
        ResilientReplayFeedClient, RetryPolicy)

    trc = _trace_begin()
    plan = faultinject.install(spec)
    snap = tempfile.mktemp(prefix="chaos_smoke_")
    total = num_actors * flushes * rows
    replay = ReplayMemory(max(2 * total, 1024), (2,), np.float32, seed=0)
    server = ReplayFeedServer(replay)
    host, port = server.address
    policy = RetryPolicy(base_delay=0.01, max_delay=0.2, deadline=deadline)
    errors: list[str] = []
    retries = [0] * num_actors

    def actor(aid: int) -> None:
        try:
            c = ResilientReplayFeedClient.connect(
                host, port, actor_id=aid, policy=policy, seed=100 + aid)
            for f in range(flushes):
                ids = aid * 1_000_000 + f * 1_000 + np.arange(
                    rows, dtype=np.float32)
                obs = np.stack([ids, ids], axis=1)
                c.add_transitions(
                    obs=obs, action=np.zeros(rows, np.int32),
                    reward=np.zeros(rows, np.float32), next_obs=obs,
                    discount=np.ones(rows, np.float32))
                time.sleep(0.001)
            retries[aid] = c.retries
            c.close()
        except Exception as e:  # noqa: BLE001 — reported in the verdict
            errors.append(f"actor {aid}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=actor, args=(a,), daemon=True)
               for a in range(num_actors)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()

    # kill + warm-reboot the learner once about half the traffic landed
    t_end = time.monotonic() + deadline / 2
    while server.counters()["env_steps"] < total // 2 \
            and time.monotonic() < t_end:
        time.sleep(0.01)
    server.shutdown(snap)
    replay2 = ReplayMemory(max(2 * total, 1024), (2,), np.float32, seed=0)
    server = ReplayFeedServer(replay2, host=host, port=port,
                              snapshot_path=snap)

    for t in threads:
        t.join(timeout=deadline)
    hung = sum(t.is_alive() for t in threads)
    wall = time.perf_counter() - t0
    rpc = server.telemetry.robustness_counters()

    expected = {a * 1_000_000 + f * 1_000 + r for a in range(num_actors)
                for f in range(flushes) for r in range(rows)}
    observed = replay2.obs[:len(replay2), 0].astype(np.int64).tolist()
    lost = len(expected) - len(set(observed))
    duplicated = len(observed) - len(set(observed))
    verdict = {
        "ok": not errors and not hung and lost == 0 and duplicated == 0,
        "num_actors": num_actors,
        "transitions_sent": total,
        "transitions_stored": len(observed),
        "lost": lost,
        "duplicated": duplicated,
        "chaos_spec": spec,
        "faults_fired": dict(sorted(plan.counters.items())),
        "client_retries": sum(retries),
        "duplicate_flushes_absorbed": rpc["duplicate_flushes"],
        "dispatch_errors": rpc["dispatch_errors"],
        "hung_actors": hung,
        "errors": errors,
        "wall_s": round(wall, 2),
    }
    server.close()
    faultinject.uninstall()
    trace = _trace_verdict(trc)
    verdict["trace"] = trace
    # causal integrity under drop/truncate chaos: no orphaned spans, and
    # every client retry cycle left a visible "retry" instant
    verdict["ok"] = (verdict["ok"] and trace["orphan_spans"] == 0
                     and (sum(retries) == 0
                          or trace["instants"].get("retry", 0) > 0))
    return verdict


def run_overload_smoke(num_actors: int = 3, flushes: int = 40, rows: int = 16,
                       spec: str = "delay=0.05:20,seed=13",
                       consume_rate: float = 300.0,
                       deadline: float = 120.0) -> dict:
    """Producer fleet ~10× faster than a rate-capped consumer: the server
    MUST shed, and the gate is shed-but-never-lost — exactly-once delivery
    of every labeled transition despite admission control plus chaos."""
    from distributed_deep_q_tpu_torch.replay.replay_memory import ReplayMemory
    from distributed_deep_q_tpu_torch.rpc import faultinject
    from distributed_deep_q_tpu_torch.rpc.flowcontrol import FlowConfig
    from distributed_deep_q_tpu_torch.rpc.replay_server import ReplayFeedServer
    from distributed_deep_q_tpu_torch.rpc.resilience import (
        ResilientReplayFeedClient, RetryPolicy)

    trc = _trace_begin()
    plan = faultinject.install(spec) if spec else None
    total = num_actors * flushes * rows
    replay = ReplayMemory(max(2 * total, 1024), (2,), np.float32, seed=0)
    # tight ingest_factor so the mismatch branch trips as soon as the
    # consumer's rate is observable; floor small enough to actually pace
    flow = FlowConfig(ingest_factor=1.5, flush_credit_floor=8,
                      rate_halflife_s=0.5)
    server = ReplayFeedServer(replay, flow=flow)
    host, port = server.address
    policy = RetryPolicy(base_delay=0.01, max_delay=0.2, deadline=deadline)
    errors: list[str] = []
    stop = threading.Event()
    clients: list = [None] * num_actors

    def consumer() -> None:
        # rate-capped learner stand-in: sample under the server's lock,
        # feed the flow controller's consumption EWMA
        batch = 32
        while not stop.is_set():
            with server.replay_lock:
                ready = len(replay) >= batch
                if ready:
                    replay.sample(batch)
            if ready:
                server.note_consumed(batch)
                time.sleep(batch / consume_rate)
            else:
                time.sleep(0.005)

    def actor(aid: int) -> None:
        try:
            c = ResilientReplayFeedClient.connect(
                host, port, actor_id=aid, policy=policy, seed=200 + aid)
            clients[aid] = c
            for f in range(flushes):  # no pacing: outrun the consumer
                ids = aid * 1_000_000 + f * 1_000 + np.arange(
                    rows, dtype=np.float32)
                obs = np.stack([ids, ids], axis=1)
                c.add_transitions(
                    obs=obs, action=np.zeros(rows, np.int32),
                    reward=np.zeros(rows, np.float32), next_obs=obs,
                    discount=np.ones(rows, np.float32))
            c.close()
        except Exception as e:  # noqa: BLE001 — reported in the verdict
            errors.append(f"actor {aid}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=actor, args=(a,), daemon=True)
               for a in range(num_actors)]
    drain = threading.Thread(target=consumer, daemon=True)
    t0 = time.perf_counter()
    drain.start()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=deadline)
    hung = sum(t.is_alive() for t in threads)
    stop.set()
    drain.join(timeout=5)
    wall = time.perf_counter() - t0

    rpc = server.telemetry.robustness_counters()
    fc = server.flow_counters()
    expected = {a * 1_000_000 + f * 1_000 + r for a in range(num_actors)
                for f in range(flushes) for r in range(rows)}
    observed = replay.obs[:len(replay), 0].astype(np.int64).tolist()
    lost = len(expected) - len(set(observed))
    duplicated = len(observed) - len(set(observed))
    client_sheds = sum(c.sheds for c in clients if c is not None)
    throttled = sum(c.throttled_s for c in clients if c is not None)
    verdict = {
        # the acceptance: overload produced sheds AND nothing was lost or
        # duplicated — backpressure is explicit cooperation, not data loss
        "ok": (not errors and not hung and lost == 0 and duplicated == 0
               and rpc["shed_flushes"] > 0),
        "num_actors": num_actors,
        "transitions_sent": total,
        "transitions_stored": len(observed),
        "lost": lost,
        "duplicated": duplicated,
        "shed_flushes": rpc["shed_flushes"],
        "client_sheds": client_sheds,
        "client_throttled_s": round(throttled, 3),
        "duplicate_flushes_absorbed": rpc["duplicate_flushes"],
        "degraded_trips": fc["degraded_trips"],
        "consume_rate_cap": consume_rate,
        "chaos_spec": spec,
        "faults_fired": dict(sorted(plan.counters.items())) if plan else {},
        "hung_actors": hung,
        "errors": errors,
        "wall_s": round(wall, 2),
    }
    server.close()
    faultinject.uninstall()
    trace = _trace_verdict(trc)
    verdict["trace"] = trace
    # sheds are cooperation, not loss — and they must be VISIBLE: every
    # client shed/re-stage cycle leaves a distinct "shed" instant
    verdict["ok"] = (verdict["ok"] and trace["orphan_spans"] == 0
                     and (client_sheds == 0
                          or trace["instants"].get("shed", 0) > 0))
    return verdict


def _ring_ids(replay) -> np.ndarray:
    """The id (first four pixel bytes, as uint32) of every row a ring can
    hold, read back from the device. The host-sampled ring holds one frame
    per row; the fused ring's padded int32 plane holds each sub-ring's
    ``slot_cap`` rows, then its ghost rows (copies of its first rows),
    then one scratch row per shard, so only the sub-rings' own rows are
    read."""
    if not hasattr(replay, "dstate"):
        ring = replay.ring.cpu().numpy()            # [capacity, H·W] uint8
        return np.ascontiguousarray(ring[:, :4]).view(np.uint32).ravel()
    frames = replay.dstate["frames"].view(-1, replay.rowp)[:, 0]
    first = frames.cpu().numpy().view(np.uint32)
    rows = [first[li * replay.shard_rows + sub * replay.slot_pad:
                  li * replay.shard_rows + sub * replay.slot_pad
                  + replay.slot_cap]
            for li in range(len(replay.local_shards))
            for sub in range(replay.subs_per_shard)]
    return np.concatenate(rows)


def run_ingest_saturation_smoke(num_actors: int = 3, flushes: int = 40,
                                rows: int = 16,
                                spec: str = "delay=0.05:20,seed=17",
                                consume_rate: float = 300.0,
                                deadline: float = 120.0,
                                device: str = "cuda",
                                frame_shape: tuple = (8, 8),
                                capacity: int = 6144,
                                device_per: bool = False,
                                learner=None) -> dict:
    """Overload contract at saturation through the columnar ingest path.

    Same shed-but-never-lost acceptance as ``overload``, but the replay
    is a DEVICE ring fed through the full columnar ingest plane: frame
    batches decode off the wire, staged-append into per-shard
    ``ColumnStage`` buffers under the replay lock, and the ``IngestDrain``
    thread (which the server attaches at boot) batches the host-to-device
    flushes. Every frame carries its id in its first four pixel bytes, so
    after shutdown the device ring itself answers lost/duplicated exactly
    — a dedup slip or a drain/staging race would surface as a wrong
    multiset of ids.

    The reference's sizes are the defaults (the host-sampled
    ``DeviceFrameReplay``, 8×8 frames). ``device_per`` feeds the fused
    ring (``DevicePERFrameReplay``), whose flush is the ``scatter_rows``
    kernel; ``learner`` (a ``Solver`` on the same device) then takes the
    consumer's place at the same capped rate with fused grad steps on the
    ring under the replay lock. The ids are read only after the server
    has stopped the drain and the device has finished every write."""
    from distributed_deep_q_tpu_torch.config import ReplayConfig
    from distributed_deep_q_tpu_torch.replay.device_per import (
        DevicePERFrameReplay)
    from distributed_deep_q_tpu_torch.replay.device_ring import (
        DeviceFrameReplay)
    from distributed_deep_q_tpu_torch.rpc import faultinject
    from distributed_deep_q_tpu_torch.rpc.flowcontrol import FlowConfig
    from distributed_deep_q_tpu_torch.rpc.replay_server import (
        ReplayFeedServer)
    from distributed_deep_q_tpu_torch.rpc.resilience import (
        ResilientReplayFeedClient, RetryPolicy)
    from distributed_deep_q_tpu_torch.solver import select_device

    dev = select_device(device)
    trc = _trace_begin()
    plan = faultinject.install(spec) if spec else None
    total = num_actors * flushes * rows
    # capacity sized so no slot wraps (exactly-once stays decidable from
    # final ring contents); one stream slot per actor
    batch = learner.config.replay.batch_size if learner is not None else 32
    if learner is not None and not device_per:
        raise ValueError("a learner steps on the fused ring: device_per=True")
    if device_per:
        cfg = (ReplayConfig(capacity=capacity, batch_size=batch,
                            prioritized=True, device_per=True,
                            priority_alpha=0.0) if learner is None
               else dataclasses.replace(learner.config.replay,
                                        capacity=capacity))
        replay = DevicePERFrameReplay(cfg, dev, tuple(frame_shape), stack=4,
                                      gamma=0.99, seed=0,
                                      write_chunk=64,
                                      num_streams=num_actors)
    else:
        cfg = ReplayConfig(capacity=capacity, batch_size=batch,
                           prioritized=False)
        replay = DeviceFrameReplay(cfg, dev, tuple(frame_shape), stack=4,
                                   gamma=0.99, seed=0,
                                   write_chunk=64,
                                   num_streams=num_actors)
    flow = FlowConfig(ingest_factor=1.5, flush_credit_floor=8,
                      rate_halflife_s=0.5)
    server = ReplayFeedServer(replay, flow=flow)
    host, port = server.address
    policy = RetryPolicy(base_delay=0.01, max_delay=0.2, deadline=deadline)
    errors: list[str] = []
    stop = threading.Event()
    clients: list = [None] * num_actors
    grad_steps = [0]
    frame_len = int(np.prod(frame_shape))

    def consumer() -> None:
        # rate-capped learner stand-in: only the consumption EWMA matters
        # here, unless a learner was given, which steps on the ring
        try:
            while not stop.is_set():
                if learner is not None:
                    with server.replay_lock:
                        if replay.ready(4 * batch):
                            learner.train_step_device_per(replay)
                            grad_steps[0] += 1
                server.note_consumed(batch)
                time.sleep(batch / consume_rate)
        except Exception as e:  # noqa: BLE001 — reported in the verdict
            errors.append(f"learner: {type(e).__name__}: {e}")

    def frame_ids(aid: int, f: int) -> np.ndarray:
        # non-zero ids (unwritten ring rows read back as zeros)
        return ((aid + 1) * 1_000_000 + f * 1_000
                + np.arange(rows, dtype=np.uint32))

    def actor(aid: int) -> None:
        try:
            c = ResilientReplayFeedClient.connect(
                host, port, actor_id=aid, policy=policy, seed=300 + aid)
            clients[aid] = c
            for f in range(flushes):  # no pacing: outrun the consumer
                frames = np.zeros((rows,) + tuple(frame_shape), np.uint8)
                frames.reshape(rows, frame_len)[:, :4] = \
                    frame_ids(aid, f).view(np.uint8).reshape(rows, 4)
                c.add_transitions(
                    frame=frames, action=np.zeros(rows, np.int32),
                    reward=np.zeros(rows, np.float32),
                    done=np.zeros(rows, bool),
                    boundary=np.zeros(rows, bool))
            c.close()
        except Exception as e:  # noqa: BLE001 — reported in the verdict
            errors.append(f"actor {aid}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=actor, args=(a,), daemon=True)
               for a in range(num_actors)]
    pacer = threading.Thread(target=consumer, daemon=True)
    t0 = time.perf_counter()
    pacer.start()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=deadline)
    hung = sum(t.is_alive() for t in threads)
    stop.set()
    pacer.join(timeout=30)
    wall = time.perf_counter() - t0

    rpc = server.telemetry.robustness_counters()
    drained = server.telemetry_summary()
    server.close()  # stops the drain; its shutdown flush lands stragglers
    if plan:
        faultinject.uninstall()

    # the drain has stopped; the ring is read once the device has run
    # every write queued before that
    if dev.type == "cuda":
        import torch
        torch.cuda.synchronize(dev)
    expected = {int(i) for a in range(num_actors) for f in range(flushes)
                for i in frame_ids(a, f)}
    ids = _ring_ids(replay)
    observed = ids[ids > 0].astype(np.int64).tolist()
    lost = len(expected - set(observed))
    duplicated = len(observed) - len(set(observed))
    corrupt = len(set(observed) - expected)
    client_sheds = sum(c.sheds for c in clients if c is not None)
    verdict = {
        # the acceptance: saturation produced sheds, the drain thread
        # carried the flushes, and the ring holds every id exactly once
        "ok": (not errors and not hung and lost == 0 and duplicated == 0
               and corrupt == 0 and rpc["shed_flushes"] > 0
               and drained.get("ingest/drain_flushes", 0) > 0
               and replay.pending_rows() == 0
               and (learner is None or grad_steps[0] > 0)),
        "num_actors": num_actors,
        "transitions_sent": total,
        "transitions_stored": len(observed),
        "lost": lost,
        "duplicated": duplicated,
        "corrupt_rows": corrupt,
        "shed_flushes": rpc["shed_flushes"],
        "client_sheds": client_sheds,
        "drained_rows": drained.get("ingest/drained_rows", 0),
        "drain_flushes": drained.get("ingest/drain_flushes", 0),
        "rows_left_staged": replay.pending_rows(),
        "duplicate_flushes_absorbed": rpc["duplicate_flushes"],
        "consume_rate_cap": consume_rate,
        "chaos_spec": spec,
        "faults_fired": dict(sorted(plan.counters.items())) if plan else {},
        "hung_actors": hung,
        "errors": errors,
        "wall_s": round(wall, 2),
        "device": str(dev),
        "learner_grad_steps": grad_steps[0],
    }
    trace = _trace_verdict(trc)
    verdict["trace"] = trace
    verdict["ok"] = (verdict["ok"] and trace["orphan_spans"] == 0
                     and (client_sheds == 0
                          or trace["instants"].get("shed", 0) > 0))
    return verdict


@_cudnn_deterministic
def run_inference_chaos_smoke(
        num_clients: int = 4, requests: int = 100,
        spec: str = "drop=0.03,truncate=0.02,corrupt=0.01,seed=29",
        deadline: float = 120.0, device: str = "cuda", net=None,
        obs_dim: int = 8, buckets: tuple | None = None) -> dict:
    """Remote-inference fleet under wire chaos: every action must be
    RIGHT, not just delivered.

    Each client sends labeled single-row observations (deterministic in
    ``(client, i)``) through the resilient retry idiom — reconnect on
    transport failure, back off on shed — and records the action the
    server returned. The oracle is a second ``BatchedPolicy`` built from
    the same seed on the same device, forwarding each observation at the
    bucket the server served it at (the module docstring). Zero
    mismatches proves the microbatcher's pad/slice/concat machinery never
    crossed wires between concurrent clients, even while chaos forced
    partial batches and re-sends.

    ``net`` defaults to the reference's MLP (``obs_dim`` inputs);
    ``buckets`` to ``InferenceConfig``'s. The verdict adds the clients'
    reply latency (the call that returned the counted reply, ms)."""
    from distributed_deep_q_tpu_torch.config import InferenceConfig, NetConfig
    from distributed_deep_q_tpu_torch.models.policy import BatchedPolicy
    from distributed_deep_q_tpu_torch.rpc import faultinject
    from distributed_deep_q_tpu_torch.rpc.flowcontrol import FlowConfig
    from distributed_deep_q_tpu_torch.rpc.inference_server import (
        InferenceClient, InferenceServer)
    from distributed_deep_q_tpu_torch.solver import select_device

    dev = select_device(device)
    icfg = InferenceConfig()
    if net is None:
        net = NetConfig(kind="mlp", hidden=(32, 32), num_actions=4)
    buckets = tuple(buckets or icfg.buckets)
    shape = _obs_shape(net, obs_dim)
    trc = _trace_begin()
    plan = faultinject.install(spec) if spec else None
    policy = _recording(BatchedPolicy)(net, seed=7, obs_dim=obs_dim,
                                       buckets=buckets, device=dev)
    server = InferenceServer(policy, max_batch=icfg.max_batch,
                             cutoff_us=icfg.cutoff_us,
                             flow=FlowConfig(flush_credit_floor=8))
    host, port = server.address

    def make_obs(aid: int, i: int) -> np.ndarray:
        # labeled: the observation IS the identity — a unique
        # deterministic vector per (client, request)
        return _labeled_obs(1_000 * (aid + 1) + i, shape)

    errors: list[str] = []
    sheds = [0] * num_clients
    got: list[dict[int, int]] = [{} for _ in range(num_clients)]
    reply_ms: list[float] = []

    def client(aid: int) -> None:
        c = None
        try:
            for i in range(requests):
                obs = make_obs(aid, i)[None]
                for _ in range(400):
                    try:
                        if c is None:
                            c = InferenceClient(host, port, actor_id=aid,
                                                timeout=5.0)
                        t_call = time.perf_counter()
                        resp = c.call("infer", obs=obs, seq=i)
                    except Exception:  # noqa: BLE001 — chaos; reconnect
                        try:
                            if c is not None:
                                c.close()
                        except Exception:  # noqa: BLE001
                            pass
                        c = None
                        time.sleep(0.005)
                        continue
                    if resp.get("error"):
                        time.sleep(0.005)
                        continue
                    if resp.get("shed"):
                        sheds[aid] += 1
                        trc.instant("shed", plane="inference")
                        time.sleep(
                            max(resp.get("retry_after_ms", 10), 1) / 1e3)
                        continue
                    # infer is idempotent in (θ, obs): a retried request
                    # may land twice server-side, but the client keeps
                    # exactly one action per i — overwrite would only
                    # matter if replies disagreed, which mismatch catches
                    if i in got[aid]:
                        errors.append(f"client {aid}: duplicate reply "
                                      f"recorded for request {i}")
                    got[aid][i] = int(np.asarray(resp["actions"])[0])
                    reply_ms.append(1e3 * (time.perf_counter() - t_call))
                    break
                else:
                    errors.append(
                        f"client {aid}: request {i} never landed")
                    return
        except Exception as e:  # noqa: BLE001 — reported in the verdict
            errors.append(f"client {aid}: {type(e).__name__}: {e}")
        finally:
            try:
                if c is not None:
                    c.close()
            except Exception:  # noqa: BLE001
                pass

    threads = [threading.Thread(target=client, args=(a,), daemon=True)
               for a in range(num_clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=deadline)
    hung = sum(t.is_alive() for t in threads)
    wall = time.perf_counter() - t0
    tm = server.telemetry_summary()
    server.close()
    if plan:
        faultinject.uninstall()

    # oracle AFTER the run so its forwards never interleave with the
    # server's batcher mid-chaos
    oracle = BatchedPolicy(net, seed=7, obs_dim=obs_dim, buckets=buckets,
                           device=dev)
    wrong = missing = 0
    for aid in range(num_clients):
        for i in range(requests):
            if i not in got[aid]:
                missing += 1
                continue
            want = _oracle_actions(oracle, policy.served,
                                   make_obs(aid, i)[None])[0]
            if got[aid][i] not in want:
                wrong += 1
    total_sheds = sum(sheds)
    verdict = {
        "ok": (not errors and not hung and wrong == 0 and missing == 0),
        "num_clients": num_clients,
        "requests_sent": num_clients * requests,
        "replies": sum(len(g) for g in got),
        "wrong_actions": wrong,
        "missing_actions": missing,
        "client_sheds": total_sheds,
        "server_requests": tm.get("inference/requests", 0),
        "server_sheds": tm.get("inference/sheds", 0),
        "server_wire_errors": tm.get("inference/wire_errors", 0),
        "compiled_buckets": tm.get("inference/compiled_buckets", 0),
        "chaos_spec": spec,
        "faults_fired": dict(sorted(plan.counters.items())) if plan else {},
        "hung_clients": hung,
        "errors": errors,
        "wall_s": round(wall, 2),
        "device": str(dev),
        "reply_ms_p50": (float(np.percentile(reply_ms, 50))
                         if reply_ms else None),
        "reply_ms_p99": (float(np.percentile(reply_ms, 99))
                         if reply_ms else None),
        "served_buckets": sorted({b for s in policy.served.values()
                                  for b in s}),
    }
    trace = _trace_verdict(trc)
    verdict["trace"] = trace
    # shed/retry cycles must be VISIBLE as instants, and faults must not
    # orphan the infer_wait/infer_batch/infer_forward span tree
    verdict["ok"] = (verdict["ok"] and trace["orphan_spans"] == 0
                     and (total_sheds == 0
                          or trace["instants"].get("shed", 0) > 0))
    return verdict


@_cudnn_deterministic
def run_vector_chaos_smoke(
        num_envs: int = 8, ticks: int = 60,
        spec: str = "drop=0.02,truncate=0.01,seed=31",
        deadline: float = 120.0, device: str = "cuda", net=None) -> dict:
    """Vectorized actor vs a dying inference server.

    One vector acting loop — the production ``select_actions`` ε-split
    over the production ``_RemoteInference`` stub — ticks labeled
    observation batches (deterministic in ``(tick, row)``) while wire
    chaos drops/truncates connections and, at the half-way tick, the
    ``InferenceServer`` is hard-killed and then rebooted with the SAME
    seed θ on the SAME port. Because ``infer`` is pure in (θ, obs) and θ
    survives the reboot, every action has exactly one right answer, so
    the oracle is a same-seed local replay: fresh rngs with the run's
    seeds re-consume the identical ε-stream against a same-seed
    ``BatchedPolicy`` on the same device, each greedy row forwarded at the
    bucket it was served at (the module docstring), and any divergence —
    a crossed row in the greedy subset, a stale retry landing on the wrong
    tick, an ε draw consumed twice — shows up as a wrong action, exactly.

    ``net`` defaults to the reference's MLP over 10×10×2 frame stacks; a
    pixel net takes its own frame shape, stack and action count.
    """
    from distributed_deep_q_tpu_torch.actors.supervisor import (
        _RemoteInference, actor_epsilon)
    from distributed_deep_q_tpu_torch.actors.vector import select_actions
    from distributed_deep_q_tpu_torch.config import Config, NetConfig
    from distributed_deep_q_tpu_torch.models.policy import BatchedPolicy
    from distributed_deep_q_tpu_torch.rpc import faultinject
    from distributed_deep_q_tpu_torch.rpc.inference_server import (
        InferenceServer)
    from distributed_deep_q_tpu_torch.solver import select_device

    dev = select_device(device)
    if net is None:
        net = NetConfig(kind="mlp", hidden=(32, 32), num_actions=4,
                        frame_shape=(10, 10), stack=2)
    hw, stack, n_act = tuple(net.frame_shape), net.stack, net.num_actions
    obs_dim = hw[0] * hw[1] * stack
    cfg = Config()
    cfg.net = net
    cfg.inference.enabled = True
    # tight backoff so the mid-run outage is ridden out in milliseconds,
    # not the production half-second ladder
    cfg.actors.rpc_retry_base = 0.01
    cfg.actors.rpc_retry_max = 0.2
    cfg.actors.rpc_retry_deadline = deadline
    served: dict[bytes, set] = {}   # one record across both boots
    trc = _trace_begin()
    plan = faultinject.install(spec) if spec else None

    def build_server():
        # SAME seed every boot: θ is identical across the kill, which is
        # what makes "wrong action" decidable through the reboot
        pol = _recording(BatchedPolicy)(net, seed=7, obs_dim=obs_dim,
                                        buckets=cfg.inference.buckets,
                                        device=dev)
        pol.served = served
        return InferenceServer(pol, host=cfg.inference.host,
                               port=cfg.inference.port,
                               max_batch=cfg.inference.max_batch,
                               cutoff_us=cfg.inference.cutoff_us)

    server = build_server()
    cfg.inference.host, cfg.inference.port = server.address
    stop = threading.Event()
    remote = _RemoteInference(cfg, stop, actor_id=0, gid=0)

    def make_obs(t: int) -> np.ndarray:
        # labeled: the batch IS its identity — one deterministic uint8
        # frame stack per (tick, row), the vector loop's exact obs shape
        rows = [np.random.default_rng(1_000 * (t + 1) + j)
                .integers(0, 256, hw + (stack,)).astype(np.uint8)
                for j in range(num_envs)]
        return np.stack(rows)

    def make_rngs():
        return [np.random.default_rng(7777 * (j + 1))
                for j in range(num_envs)]

    epsilons = [actor_epsilon(j, num_envs, 0.4, 7.0)
                for j in range(num_envs)]
    got: dict[int, np.ndarray] = {}
    errors: list[str] = []
    duplicated = [0]
    progress = [0]

    def loop() -> None:
        rngs = make_rngs()
        try:
            for t in range(ticks):
                acts = select_actions(make_obs(t), rngs, epsilons, n_act,
                                      remote.actions)
                if t in got:
                    duplicated[0] += 1
                got[t] = acts
                progress[0] = t + 1
        except Exception as e:  # noqa: BLE001 — reported in the verdict
            errors.append(f"vector loop: {type(e).__name__}: {e}")

    th = threading.Thread(target=loop, daemon=True)
    t0 = time.perf_counter()
    th.start()
    # hard-kill the inference plane mid-run; the loop must shed/retry
    # through the outage, never skip or re-order a tick
    t_end = time.monotonic() + deadline / 2
    while progress[0] < ticks // 2 and time.monotonic() < t_end:
        time.sleep(0.005)
    kill_tick = progress[0]
    server.close()
    time.sleep(0.2)  # let in-flight calls hit the dead port
    server = build_server()  # same seed, same host:port — warm reboot
    th.join(timeout=deadline)
    hung = int(th.is_alive())
    stop.set()
    wall = time.perf_counter() - t0
    tm = server.telemetry_summary()
    remote.close()
    server.close()
    if plan:
        faultinject.uninstall()

    # oracle AFTER the run: replay the identical ε-stream against the
    # same θ and demand bitwise agreement; a greedy row's right actions
    # are the oracle's at the bucket(s) it was served at
    oracle = BatchedPolicy(net, seed=7, obs_dim=obs_dim,
                           buckets=cfg.inference.buckets, device=dev)
    orngs = make_rngs()
    wrong = missing = 0
    for t in range(ticks):
        greedy: dict[bytes, set] = {}

        def greedy_fn(rows):
            cands = _oracle_actions(oracle, served, rows)
            for row, c in zip(rows, cands):
                greedy[row.tobytes()] = c
            return [min(c) for c in cands]

        obs = make_obs(t)
        want = select_actions(obs, orngs, epsilons, n_act, greedy_fn)
        if t not in got:
            missing += num_envs
            continue
        for j in range(num_envs):
            right = greedy.get(obs[j].tobytes(), {int(want[j])})
            wrong += int(int(got[t][j]) not in right)
    trace = _trace_verdict(trc)
    # the outage must be VISIBLE in the causal record: the resilient
    # stub's retry cycles and/or reconnects, plus any shed instants
    retry_events = (trace["instants"].get("retry", 0)
                    + trace["instants"].get("reconnect", 0))
    verdict = {
        "ok": (not errors and not hung and wrong == 0 and missing == 0
               and duplicated[0] == 0 and retry_events > 0
               and trace["orphan_spans"] == 0
               and (remote.sheds == 0
                    or trace["instants"].get("shed", 0) > 0)),
        "num_envs": num_envs,
        "ticks": ticks,
        "actions_checked": ticks * num_envs,
        "wrong_actions": wrong,
        "missing_actions": missing,
        "duplicated_ticks": duplicated[0],
        "kill_tick": kill_tick,
        "client_sheds": remote.sheds,
        "retry_events": retry_events,
        "reboot_server_requests": tm.get("inference/requests", 0),
        "chaos_spec": spec,
        "faults_fired": dict(sorted(plan.counters.items())) if plan else {},
        "hung": hung,
        "errors": errors,
        "wall_s": round(wall, 2),
        "trace": trace,
        "device": str(dev),
        "served_buckets": sorted({b for s in served.values() for b in s}),
    }
    return verdict


def run_health_smoke(spec: str = "corrupt=0.35,seed=41",
                     deadline: float = 45.0) -> dict:
    """Injected wire fault drives the fleet verdict ok → degraded → ok.

    Every flush and every fleet scrape opens a FRESH connection — the
    chaos shim wraps sockets at connect time, so installing/uninstalling
    the plan at phase boundaries takes effect within one tick. The SLO
    windows are shrunk to fractions of a second (production keeps
    minutes); the burn-rate math is identical."""
    from distributed_deep_q_tpu_torch import health
    from distributed_deep_q_tpu_torch.metrics import Metrics
    from distributed_deep_q_tpu_torch.replay.replay_memory import ReplayMemory
    from distributed_deep_q_tpu_torch.rpc import faultinject
    from distributed_deep_q_tpu_torch.rpc.replay_server import (
        ReplayFeedClient, ReplayFeedServer)

    from distributed_deep_q_tpu_torch.telemetry_report import load_records, slo_problems

    health.configure(enabled=True, fast_window_s=0.5, slow_window_s=1.5,
                     clear_ratio=0.5)
    jsonl = tempfile.mktemp(prefix="health_smoke_", suffix=".jsonl")
    metrics = Metrics(jsonl_path=jsonl)
    replay = ReplayMemory(1 << 16, (2,), np.float32, seed=0)
    server = ReplayFeedServer(replay)
    host, port = server.address
    fleet = health.FleetHealth()

    def scrape_rpc() -> dict:
        c = ReplayFeedClient(host, port, actor_id=99, timeout=5.0)
        try:
            return c.health()
        finally:
            c.close()

    fleet.register("replay", scrape_rpc)

    seq = [0]

    def push_one() -> None:
        # stimulus traffic; under corrupt chaos a flush may need several
        # tries (CRC reject → error reply) or never land — both fine,
        # the traffic only exists to exercise the wire
        rows = 8
        ids = seq[0] * 1_000 + np.arange(rows, dtype=np.float32)
        obs = np.stack([ids, ids], axis=1)
        for _ in range(20):
            c = None
            try:
                c = ReplayFeedClient(host, port, actor_id=0, timeout=5.0)
                resp = c.call(
                    "add_transitions", flush_seq=seq[0], obs=obs,
                    next_obs=obs, action=np.zeros(rows, np.int32),
                    reward=np.zeros(rows, np.float32),
                    discount=np.ones(rows, np.float32))
            except Exception:  # noqa: BLE001 — chaos; retry fresh
                time.sleep(0.002)
                continue
            finally:
                if c is not None:
                    try:
                        c.close()
                    except Exception:  # noqa: BLE001
                        pass
            if resp.get("error") or resp.get("shed"):
                time.sleep(0.002)
                continue
            seq[0] += 1
            return

    step = [0]
    statuses: list[str] = []
    critical_flaps = [0]
    rules_fired: set[str] = set()

    def tick(collect_rules: bool = False) -> None:
        push_one()
        v = fleet.scrape()
        statuses.append(v.status)
        if v.status == "critical":
            critical_flaps[0] += 1
        if collect_rules and v.status != "ok":
            rules_fired.update(f.rule for f in v.findings)
        metrics.log(step[0], **{**fleet.gauges(),
                                "health/verdict": v.to_jsonable()})
        step[0] += 1
        time.sleep(0.03)

    def run_until(pred, min_s: float = 0.0, max_s: float = 15.0,
                  collect_rules: bool = False) -> bool:
        t0 = time.monotonic()
        while True:
            tick(collect_rules)
            elapsed = time.monotonic() - t0
            if elapsed >= min_s and pred():
                return True
            if elapsed > max_s:
                return False

    t0 = time.perf_counter()
    max_s = deadline / 3
    # phase A: clean traffic must settle on ok with warmed rings
    phase_a_ok = run_until(lambda: statuses[-1] == "ok",
                           min_s=1.0, max_s=max_s)
    # phase B: corrupt wire — CRC rejects burn wire_integrity's budget.
    # A failed scrape already degrades the verdict (member_unreachable),
    # so the phase gate demands the burn-rate rule ITSELF: degraded with
    # wire_integrity named in the findings
    plan = faultinject.install(spec)
    degraded_reached = run_until(
        lambda: statuses[-1] == "degraded"
        and "wire_integrity" in rules_fired,
        max_s=max_s, collect_rules=True)
    # phase C: recovery — the fast window cools, hysteresis clears
    faultinject.uninstall()
    recovered = run_until(
        lambda: len(statuses) >= 3 and statuses[-3:] == ["ok"] * 3,
        min_s=0.5, max_s=max_s)
    wall = time.perf_counter() - t0

    checksum_errors = \
        server.telemetry.robustness_counters()["checksum_errors"]
    metrics.close()
    server.close()
    health.reset()

    # the run JSONL must carry schema-valid aggregated verdicts and pass
    # the report's strict SLO checks now that the run ended ok
    records = load_records(jsonl)
    verdicts = [r["health/verdict"] for r in records
                if isinstance(r.get("health/verdict"), dict)]
    schema_ok = bool(verdicts) and all(
        v.get("status") in ("ok", "degraded", "critical")
        and isinstance(v.get("ok"), bool)
        and isinstance(v.get("findings"), list)
        and all(isinstance(f, dict) and "rule" in f and "key" in f
                and "severity" in f for f in v["findings"])
        for v in verdicts)
    slo = slo_problems(records)

    verdict = {
        "ok": (phase_a_ok and degraded_reached and recovered
               and critical_flaps[0] == 0
               and "wire_integrity" in rules_fired
               and schema_ok and not slo),
        "phase_a_ok": phase_a_ok,
        "degraded_reached": degraded_reached,
        "recovered": recovered,
        "critical_flaps": critical_flaps[0],
        "rules_fired": sorted(rules_fired),
        "wire_checksum_rejections": checksum_errors,
        "faults_fired": dict(sorted(plan.counters.items())),
        "scrapes": step[0],
        "jsonl_records": len(records),
        "verdicts_logged": len(verdicts),
        "verdict_schema_ok": schema_ok,
        "slo_problems": slo,
        "chaos_spec": spec,
        "wall_s": round(wall, 2),
    }
    return verdict


def run_learn_divergence_smoke(spike: float = 3.0,
                               deadline: float = 45.0) -> dict:
    """Simulated lr spike drives the learner verdict ok → degraded
    (``loss_divergence`` named) → ok, with hysteresis and no
    false-critical flaps.

    The learning-dynamics plane is synthesized host-side in exactly the
    layout the device returns (``learning.py``; TD counts bucketed by a
    real ``metrics.Histogram`` so the geometry twin is exercised, not
    re-derived): a stable learner, then a mid-run lr spike modeled as
    multiplicative loss/grad-norm growth per grad step — the signature
    of a step size past the stability edge — then recovery. The full
    production read path runs unmodified: ``LearnAccumulator`` fold →
    ``learn/*`` gauges → ``HealthMonitor`` divergence trends →
    ``FleetHealth`` aggregation → JSONL verdicts → the telemetry
    report's strict learn gate. Windows are shrunk to fractions of a
    second (production keeps minutes); the trend math is identical."""
    from distributed_deep_q_tpu_torch import health, learning
    from distributed_deep_q_tpu_torch.metrics import Histogram, Metrics

    from distributed_deep_q_tpu_torch.telemetry_report import (
        learn_problems, load_records, slo_problems)

    health.configure(enabled=True, fast_window_s=0.5, slow_window_s=1.5,
                     clear_ratio=0.5)
    jsonl = tempfile.mktemp(prefix="learn_smoke_", suffix=".jsonl")
    metrics = Metrics(jsonl_path=jsonl)
    acc = learning.LearnAccumulator()
    monitor = health.HealthMonitor(rules=health.default_learn_rules(),
                                   trends=health.default_learn_trends(),
                                   name="learner")
    fleet = health.FleetHealth()
    fleet.register("learner", learning.learn_scrape_fn(acc, monitor))

    rng = np.random.default_rng(7)
    state = {"loss": 1.0, "gnorm": 2.0}

    def synth_plane() -> np.ndarray:
        td = rng.lognormal(mean=0.0, sigma=0.5, size=64)
        w = rng.uniform(0.3, 1.0, 64)
        prio = (td + 1e-6) ** 0.6
        h = Histogram(learning.TD_LO, learning.TD_HI,
                      learning.TD_PER_DECADE)
        h.observe_many(td)
        p = np.zeros(learning.PLANE_SIZE)
        p[:learning.N_HIST] = h._counts
        p[learning.I_TD_SUM] = td.sum()
        p[learning.I_PRIO_SUM] = prio.sum()
        p[learning.I_ISW_SUM] = w.sum()
        p[learning.I_SAMPLES] = td.size
        p[learning.I_LOSS_SUM] = state["loss"]
        p[learning.I_GNORM_SUM] = state["gnorm"]
        p[learning.I_GNORM_CLIP_SUM] = min(state["gnorm"], 10.0)
        p[learning.I_QMEAN_SUM] = 0.5
        p[learning.I_STEPS] = 1.0
        p[learning.I_TD_MAX] = td.max()
        p[learning.I_Q_MAX] = 1.0
        p[learning.I_PRIO_MAX] = prio.max()
        p[learning.I_ISW_MIN] = w.min()
        p[learning.I_TD_MIN] = td.min()
        return p

    step = [0]
    statuses: list[str] = []
    critical_flaps = [0]
    rules_fired: set[str] = set()

    def tick(collect_rules: bool = False) -> None:
        acc.ingest(synth_plane())
        v = fleet.scrape()
        statuses.append(v.status)
        if v.status == "critical":
            critical_flaps[0] += 1
        if collect_rules and v.status != "ok":
            rules_fired.update(f.rule for f in v.findings)
        metrics.log(step[0], **{**fleet.gauges(), **acc.gauges(),
                                "health/verdict": v.to_jsonable()})
        step[0] += 1
        time.sleep(0.03)

    def run_until(pred, min_s: float = 0.0, max_s: float = 15.0,
                  collect_rules: bool = False, pre=None) -> bool:
        t0 = time.monotonic()
        while True:
            if pre is not None:
                pre()
            tick(collect_rules)
            elapsed = time.monotonic() - t0
            if elapsed >= min_s and pred():
                return True
            if elapsed > max_s:
                return False

    t0 = time.perf_counter()
    max_s = deadline / 3
    # phase A: a healthy learner must settle on ok with warmed rings
    phase_a_ok = run_until(lambda: statuses[-1] == "ok",
                           min_s=1.0, max_s=max_s)

    # phase B: the lr spike — loss and grad norm grow multiplicatively
    # per grad step. The phase gate demands the drift rule ITSELF:
    # degraded with loss_divergence named in the findings.
    def spiked() -> None:
        state["loss"] = min(state["loss"] * spike, 1e6)
        state["gnorm"] = min(state["gnorm"] * spike, 1e6)

    degraded_reached = run_until(
        lambda: statuses[-1] == "degraded"
        and "loss_divergence" in rules_fired,
        max_s=max_s, collect_rules=True, pre=spiked)

    # phase C: lr restored — loss returns to scale, the trend windows
    # cool, and the verdict must walk back to a STABLE ok (three
    # consecutive ok ticks, so a flapping clear fails the phase)
    state["loss"], state["gnorm"] = 1.0, 2.0
    recovered = run_until(
        lambda: len(statuses) >= 3 and statuses[-3:] == ["ok"] * 3,
        min_s=0.5, max_s=max_s)
    wall = time.perf_counter() - t0

    metrics.close()
    health.reset()

    # JSONL must carry schema-valid verdicts; the run ended ok so the
    # generic SLO gate passes — but the STRICT learn gate must still
    # catch the transient divergence (recovered-but-diverged is not a
    # clean training run)
    records = load_records(jsonl)
    verdicts = [r["health/verdict"] for r in records
                if isinstance(r.get("health/verdict"), dict)]
    schema_ok = bool(verdicts) and all(
        v.get("status") in ("ok", "degraded", "critical")
        and isinstance(v.get("ok"), bool)
        and isinstance(v.get("findings"), list)
        and all(isinstance(f, dict) and "rule" in f and "key" in f
                and "severity" in f for f in v["findings"])
        for v in verdicts)
    slo = slo_problems(records)
    strict = learn_problems(records)
    strict_catches = any("loss_divergence" in p for p in strict)

    verdict = {
        "ok": (phase_a_ok and degraded_reached and recovered
               and critical_flaps[0] == 0
               and "loss_divergence" in rules_fired
               and schema_ok and not slo and strict_catches),
        "phase_a_ok": phase_a_ok,
        "degraded_reached": degraded_reached,
        "recovered": recovered,
        "critical_flaps": critical_flaps[0],
        "rules_fired": sorted(rules_fired),
        "strict_gate_catches_divergence": strict_catches,
        "learn_planes_folded": acc.planes,
        "scrapes": step[0],
        "jsonl_records": len(records),
        "verdicts_logged": len(verdicts),
        "verdict_schema_ok": schema_ok,
        "slo_problems": slo,
        "lr_spike_factor": spike,
        "wall_s": round(wall, 2),
    }
    return verdict


def run_durability_smoke(cycles: int = 20, num_actors: int = 3,
                         flushes_per_cycle: int = 4, rows: int = 8,
                         spec: str = "torn=0.35,corrupt=0.03,seed=23",
                         keep: int = 4) -> dict:
    """Kill/warm-boot loop under torn-write + wire-corruption chaos.

    Single-threaded by design: every flush is sequenced by the harness
    itself (manual ``flush_seq`` per actor), so "what must be in replay"
    is exact. After each hard kill the actors re-send their FULL history
    in original order — the flush-seq dedup absorbs everything the
    restored generation already holds, the gap lands exactly once, and
    any divergence is a real durability bug, not harness noise."""
    from distributed_deep_q_tpu_torch.replay.replay_memory import ReplayMemory
    from distributed_deep_q_tpu_torch.rpc import faultinject
    from distributed_deep_q_tpu_torch.rpc.replay_server import (
        ReplayFeedClient, ReplayFeedServer)
    from distributed_deep_q_tpu_torch.utils.durability import GenerationStore

    plan = faultinject.install(spec)
    rng = np.random.default_rng(23)
    snap = tempfile.mktemp(prefix="durability_smoke_")
    total = cycles * num_actors * flushes_per_cycle * rows
    cap = max(2 * total, 1024)

    history: dict[int, list] = {a: [] for a in range(num_actors)}
    expected: set[int] = set()
    errors: list[str] = []
    boot_mismatches: list[str] = []
    quarantined_total = checksum_total = snapshots_landed = 0

    replay = ReplayMemory(cap, (2,), np.float32, seed=0)
    server = ReplayFeedServer(replay, snapshot_path=snap, snapshot_keep=keep)

    def clients() -> list:
        host, port = server.address
        return [ReplayFeedClient(host, port, actor_id=a, timeout=5.0)
                for a in range(num_actors)]

    def push(c, seq: int, obs: np.ndarray) -> None:
        n = len(obs)
        for _ in range(200):
            try:
                resp = c.call(
                    "add_transitions", flush_seq=seq, obs=obs, next_obs=obs,
                    action=np.zeros(n, np.int32),
                    reward=np.zeros(n, np.float32),
                    discount=np.ones(n, np.float32))
            except Exception:  # noqa: BLE001 — chaos; reconnect + retry
                time.sleep(0.005)
                continue
            if resp.get("error") or resp.get("shed"):
                time.sleep(0.01)
                continue
            return
        raise RuntimeError(f"flush seq {seq} never landed")

    def probe_newest_valid():
        """Side-effect-free answer to "which generation SHOULD the next
        warm boot restore?" — same verification the server runs, but
        without quarantining, so it cannot influence the boot it checks."""
        store = GenerationStore(snap, keep=keep)
        for gen in reversed(store.generations()):
            try:
                _, meta = store.verify(gen)
                return gen, meta
            except Exception:  # noqa: BLE001 — damaged gen, keep walking
                continue
        return None

    seqs = [0] * num_actors
    t0 = time.perf_counter()
    for cycle in range(cycles):
        cs = clients()
        for _ in range(flushes_per_cycle):
            for a, c in enumerate(cs):
                seq = seqs[a]
                ids = (a * 1_000_000 + seq * 1_000
                       + np.arange(rows, dtype=np.float32))
                obs = np.stack([ids, ids], axis=1)
                push(c, seq, obs)
                history[a].append((seq, obs))
                expected.update(int(i) for i in ids)
                seqs[a] += 1
        # kill point roulette: after a sync commit / racing an async dump
        # / before any snapshot this cycle ran
        roll = rng.random()
        if roll < 0.45:
            server.snapshot(snap)
            snapshots_landed += 1
        elif roll < 0.75:
            if server.snapshot_async(snap):
                snapshots_landed += 1
            if rng.random() < 0.5:
                time.sleep(float(rng.random()) * 0.02)
        if rng.random() < 0.3:
            # crash-before-commit: a generation directory with payload
            # bytes but no manifest must be skipped by restore
            store = GenerationStore(snap, keep=keep)
            gens = store.generations()
            part = os.path.join(
                snap, f"gen-{(gens[-1] + 1 if gens else 0):08d}")
            os.makedirs(part, exist_ok=True)
            with open(os.path.join(part, "server.npz"), "wb") as f:
                f.write(bytes(rng.integers(0, 256, 64, dtype=np.uint8)))
        for c in cs:
            c.close()
        server.close()  # hard kill (no shutdown-snapshot)
        server._snap_lock.acquire()  # join any in-flight async write
        server._snap_lock.release()
        checksum_total += \
            server.telemetry.robustness_counters()["checksum_errors"]

        pick = probe_newest_valid()
        replay = ReplayMemory(cap, (2,), np.float32, seed=0)
        server = ReplayFeedServer(replay, snapshot_path=snap,
                                  snapshot_keep=keep)
        quarantined_total += \
            server.telemetry.robustness_counters()["snapshot_quarantined"]
        got = server.counters()["env_steps"]
        want = int(pick[1]["env_steps"]) if pick else 0
        if got != want or (pick and server._restored_generation != pick[0]):
            boot_mismatches.append(
                f"cycle {cycle}: booted env_steps={got} "
                f"gen={server._restored_generation}, probe says {pick}")

        cs = clients()
        for a, c in enumerate(cs):
            for seq, obs in history[a]:
                push(c, seq, obs)
        observed = replay.obs[:len(replay), 0].astype(np.int64).tolist()
        lost = len(expected - set(observed))
        duplicated = len(observed) - len(set(observed))
        corrupt_rows = len(set(observed) - expected)
        if lost or duplicated or corrupt_rows:
            errors.append(f"cycle {cycle}: lost={lost} dup={duplicated} "
                          f"corrupt_rows={corrupt_rows}")
        for c in cs:
            c.close()

    wall = time.perf_counter() - t0
    server.close()
    faultinject.uninstall()
    verdict = {
        "ok": not errors and not boot_mismatches,
        "cycles": cycles,
        "num_actors": num_actors,
        "transitions_sent": total,
        "snapshots_landed": snapshots_landed,
        "generations_quarantined": quarantined_total,
        "wire_checksum_rejections": checksum_total,
        "torn_writes_fired": plan.counters.get("file/torn", 0),
        "boot_mismatches": boot_mismatches,
        "errors": errors,
        "chaos_spec": spec,
        "wall_s": round(wall, 2),
    }
    return verdict


def run_train_chaos(argv: list[str], device: str = "cuda",
                    preset: str = "cartpole", metrics=None,
                    log_every: int = 1_000) -> dict:
    """``train_distributed`` under the fleet's own chaos path: the spec in
    ``cfg.actors.chaos`` reaches every spawned actor through its
    environment. The reference's CartPole run by default (4,000 grad steps
    from learn_start 500, one actor); ``preset`` names another preset,
    run at its own settings; ``argv`` overrides either (``key=value``).
    The learner runs on ``device``; the actors on the host, as always."""
    from distributed_deep_q_tpu_torch.config import PRESETS, apply_overrides
    from distributed_deep_q_tpu_torch.solver import select_device

    dev = select_device(device)
    cfg = PRESETS[preset]()
    cfg.mesh.backend = dev.type
    if preset == "cartpole":
        cfg.train.total_steps = 4_000
        cfg.replay.learn_start = 500
        cfg.actors.num_actors = 1
    cfg.actors.chaos = "drop=0.005,truncate=0.003,seed=5"
    cfg.train.server_snapshot_path = tempfile.mktemp(prefix="chaos_train_")
    apply_overrides(cfg, argv)
    for arg in argv:
        print(f"override {arg}")

    from distributed_deep_q_tpu_torch.actors.supervisor import (
        train_distributed)
    from distributed_deep_q_tpu_torch.rpc import faultinject

    # the supervisor hands the spec to its actors through this process's
    # environment, which also puts the learner's own sockets under it;
    # both are restored on the way out, so the caller's process goes on
    # without chaos
    prev = os.environ.get(faultinject.ENV_VAR)
    try:
        out = train_distributed(cfg, metrics=metrics, log_every=log_every)
    finally:
        if prev is None:
            os.environ.pop(faultinject.ENV_VAR, None)
        else:
            os.environ[faultinject.ENV_VAR] = prev
        faultinject.uninstall()
    return {
        "env_steps": out.get("env_steps"),
        "final_return_avg100": out.get("final_return_avg100"),
        "actor_restarts": out.get("actor_restarts"),
        "actor_kill_escalations": out.get("actor_kill_escalations"),
        "rpc_dispatch_errors": out.get("rpc_dispatch_errors"),
        "rpc_duplicate_flushes": out.get("rpc_duplicate_flushes"),
    }


def run_churn_smoke(num_actors: int = 6, flushes: int = 150, rows: int = 8,
                    deadline: float = 90.0) -> dict:
    """Elastic-fleet acceptance: kill a learner host mid-run,
    add a fresh one, lose nothing.

    Two learner hosts serve a hash-assigned actor fleet; the membership
    registry rides host-0's wire. Mid-run host-1 is gracefully retired —
    its replay shard exports through the GenerationStore handoff — and a
    fresh host-2 imports the shard and joins. The fleet verdict must
    walk ok → degraded (``member_unreachable`` named) → ok with zero
    critical flaps; the health-driven autoscaler must emit
    lineage-traceable decisions into the run JSONL (shrink on the lost
    member, grow on recovery); remapped actors must reconnect through
    the resilient client (``rpc/mass_reconnects`` moves) with their
    in-flight flushes staying exactly-once across the handoff. The
    ledger gate: every labeled transition lands exactly once across the
    union of surviving shards, with zero wrong actions."""
    from distributed_deep_q_tpu_torch import health
    from distributed_deep_q_tpu_torch.actors import membership as ms
    from distributed_deep_q_tpu_torch.actors.assignment import assign_fleet
    from distributed_deep_q_tpu_torch.actors.autoscaler import (
        RECOVERY_RULE, Autoscaler)
    from distributed_deep_q_tpu_torch.metrics import Metrics
    from distributed_deep_q_tpu_torch.replay.replay_memory import ReplayMemory
    from distributed_deep_q_tpu_torch.rpc import resilience
    from distributed_deep_q_tpu_torch.rpc.replay_server import (
        ReplayFeedClient, ReplayFeedServer)
    from distributed_deep_q_tpu_torch.rpc.resilience import (
        ResilientReplayFeedClient, RetryPolicy)

    from distributed_deep_q_tpu_torch.telemetry_report import (
        elastic_problems, load_records, slo_problems)

    health.configure(enabled=True, fast_window_s=0.5, slow_window_s=1.5,
                     clear_ratio=0.5)
    jsonl = tempfile.mktemp(prefix="churn_smoke_", suffix=".jsonl")
    metrics = Metrics(jsonl_path=jsonl)
    total = num_actors * flushes * rows
    cap = max(2 * total, 1024)
    mass_base = resilience.mass_reconnects()

    # two learner hosts; host-0 carries the membership registry
    registry = ms.MembershipRegistry()
    replay0 = ReplayMemory(cap, (2,), np.float32, seed=0)
    server0 = ReplayFeedServer(replay0)
    server0.attach_membership(registry)
    registry.join("host-0", *server0.address)
    replay1 = ReplayMemory(cap, (2,), np.float32, seed=1)
    server1 = ReplayFeedServer(replay1)

    admin = ReplayFeedClient(*server0.address, actor_id=990, timeout=10.0)
    admin.call("fleet_join", token="host-1", host=server1.address[0],
               port=server1.address[1])
    admin.call("fleet_lease", token="host-0")  # seed host renews too
    view = admin.call("fleet_view")
    tokens = ms.view_tokens(view)
    assignment = assign_fleet(num_actors, tokens)
    owner0 = {g: t for t, gids in assignment.items() for g in gids}

    # fleet health scrapes both hosts over fresh wire connections (a
    # dead host must read as member_unreachable, not a cached verdict)
    fleet = health.FleetHealth()

    def scrape_at(addr):
        def scrape() -> dict:
            c = ReplayFeedClient(addr[0], addr[1], actor_id=991,
                                 timeout=5.0)
            try:
                return c.health()
            finally:
                c.close()
        return scrape

    fleet.register("host-0", scrape_at(server0.address))
    fleet.register("host-1", scrape_at(server1.address))

    autoscaler = Autoscaler(min_actors=2, max_actors=num_actors, step=2,
                            cooldown_s=0.5, recover_ticks=3)

    policy = RetryPolicy(base_delay=0.01, max_delay=0.3,
                         deadline=deadline)
    errors: list[str] = []
    clients: list = [None] * num_actors
    act_mod = 7  # expected action for (gid, f) is (gid*31 + f) % 7

    def actor(gid: int) -> None:
        try:
            addr = ms.view_address(view, owner0[gid])
            c = ResilientReplayFeedClient.connect(
                addr[0], addr[1], actor_id=gid, policy=policy,
                seed=200 + gid)
            clients[gid] = c
            for f in range(flushes):
                ids = gid * 1_000_000 + f * 1_000 + np.arange(
                    rows, dtype=np.float32)
                obs = np.stack([ids, ids], axis=1)
                c.add_transitions(
                    obs=obs,
                    action=np.full(rows, (gid * 31 + f) % act_mod,
                                   np.int32),
                    reward=np.zeros(rows, np.float32), next_obs=obs,
                    discount=np.ones(rows, np.float32))
                time.sleep(0.02)
            c.close()
        except Exception as e:  # noqa: BLE001 — reported in the verdict
            errors.append(f"actor {gid}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=actor, args=(g,), daemon=True)
               for g in range(num_actors)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()

    step = [0]
    statuses: list[str] = []
    critical_flaps = [0]
    rules_fired: set[str] = set()
    decisions: list[dict] = []

    def tick(collect_rules: bool = False) -> None:
        v = fleet.scrape()
        statuses.append(v.status)
        if v.status == "critical":
            critical_flaps[0] += 1
        if collect_rules and v.status != "ok":
            rules_fired.update(f.rule for f in v.findings)
        ds = [d.to_jsonable() for d in autoscaler.observe(v)]
        decisions.extend(ds)
        rec = {**fleet.gauges(), **registry.gauges(),
               **autoscaler.gauges(),
               "rpc/mass_reconnects":
                   float(resilience.mass_reconnects() - mass_base),
               "health/verdict": v.to_jsonable()}
        if ds:
            rec["autoscale/decision"] = ds
        metrics.log(step[0], **rec)
        step[0] += 1
        time.sleep(0.03)

    def run_until(pred, min_s: float = 0.0, max_s: float = 15.0,
                  collect_rules: bool = False) -> bool:
        t1 = time.monotonic()
        while True:
            tick(collect_rules)
            elapsed = time.monotonic() - t1
            if elapsed >= min_s and pred():
                return True
            if elapsed > max_s:
                return False

    max_s = deadline / 4
    # phase A: two-host steady state settles on ok
    phase_a_ok = run_until(lambda: statuses[-1] == "ok",
                           min_s=1.0, max_s=max_s)

    # phase B: retire host-1 — graceful drain + manifest-committed shard
    # export. Its scrape now fails, so the verdict must degrade with
    # member_unreachable named, and the autoscaler must shrink on it
    shard = tempfile.mktemp(prefix="churn_shard_")
    export = ms.export_shard(server1, shard)
    degraded_reached = run_until(
        lambda: statuses[-1] == "degraded"
        and "member_unreachable" in rules_fired,
        max_s=max_s, collect_rules=True)

    # phase C: host-2 imports the shard (warm boot: rows, PER state, and
    # the flush-seq dedup map all restore) and joins; host-1 leaves with
    # its shard lineage recorded. Actors re-run assign_fleet against the
    # new epoch and reconnect; in-flight resend floors come from the
    # shard's current holder so nothing double-lands
    replay2 = ReplayMemory(cap, (2,), np.float32, seed=2)
    server2, imported = ms.import_shard(replay2, shard)
    admin.call("fleet_join", token="host-2", host=server2.address[0],
               port=server2.address[1])
    admin.call("fleet_leave", token="host-1", importer="host-2")
    fleet.deregister("host-1")
    fleet.register("host-2", scrape_at(server2.address))
    handoff_lost = max(0, export["rows"] - imported["rows"])
    metrics.log(step[0], **{
        "fleet/handoff_ms": export["export_ms"] + imported["import_ms"],
        "fleet/handoff_rows": float(imported["rows"]),
        "fleet/handoff_lost_rows": float(handoff_lost)})
    step[0] += 1

    view2 = admin.call("fleet_view")
    tokens2 = ms.view_tokens(view2)
    owner2 = {g: t for t, gids in
              assign_fleet(num_actors, tokens2).items() for g in gids}
    remapped = 0
    for gid in range(num_actors):
        if owner2[gid] == owner0[gid] or clients[gid] is None:
            continue
        holder = ms.resolve_importer(view2, owner0[gid])
        if holder:
            floor = ms.resend_floor(
                *ms.view_address(view2, holder), actor_id=gid)
            clients[gid].resend_floor = max(
                clients[gid].resend_floor, floor)
        clients[gid].rehost(*ms.view_address(view2, owner2[gid]),
                            remap=True)
        remapped += 1

    # phase D: the fleet heals — stable ok, then the autoscaler's
    # recovery streak grows actor capacity back (cooldown permitting)
    recovered = run_until(
        lambda: len(statuses) >= 3 and statuses[-3:] == ["ok"] * 3,
        min_s=0.5, max_s=max_s, collect_rules=True)
    grew_back = run_until(
        lambda: any(d["action"] == "grow_actors" for d in decisions),
        max_s=max_s)

    for t in threads:
        t.join(timeout=deadline)
    hung = sum(t.is_alive() for t in threads)
    wall = time.perf_counter() - t0
    mass = resilience.mass_reconnects() - mass_base

    # labeled-frame ledger across the union of surviving shards: every
    # id exactly once, and every stored action matches its id's formula
    # (row integrity through the handoff, not just row count)
    expected = {g * 1_000_000 + f * 1_000 + r for g in range(num_actors)
                for f in range(flushes) for r in range(rows)}
    observed: list[int] = []
    wrong_actions = 0
    for rep in (replay0, replay2):
        n = len(rep)
        ids = rep.obs[:n, 0].astype(np.int64)
        observed.extend(ids.tolist())
        gids = ids // 1_000_000
        fs = (ids % 1_000_000) // 1_000
        want = (gids * 31 + fs) % act_mod
        wrong_actions += int(np.sum(rep.action[:n] != want))
    lost = len(expected) - len(set(observed))
    duplicated = len(observed) - len(set(observed))

    metrics.close()
    server0.close()
    server2.close()
    admin.close()
    health.reset()

    records = load_records(jsonl)
    slo = slo_problems(records)
    elastic = elastic_problems(records)
    shrink_named = any(d["action"] == "shrink_actors"
                       and d["rule"] == "member_unreachable"
                       for d in decisions)
    grow_named = any(d["action"] == "grow_actors"
                     and d["rule"] == RECOVERY_RULE for d in decisions)
    skipped = sum(c.resends_skipped for c in clients if c is not None)
    verdict = {
        "ok": (not errors and not hung and lost == 0 and duplicated == 0
               and wrong_actions == 0 and phase_a_ok and degraded_reached
               and recovered and grew_back and critical_flaps[0] == 0
               and handoff_lost == 0 and remapped > 0 and mass >= remapped
               and shrink_named and grow_named
               and "flush_p99" not in rules_fired
               and not slo and not elastic),
        "phase_a_ok": phase_a_ok,
        "degraded_reached": degraded_reached,
        "recovered": recovered,
        "grew_back": grew_back,
        "critical_flaps": critical_flaps[0],
        "rules_fired": sorted(rules_fired),
        "transitions_sent": total,
        "transitions_stored": len(observed),
        "lost": lost,
        "duplicated": duplicated,
        "wrong_actions": wrong_actions,
        "handoff_rows": imported["rows"],
        "handoff_lost_rows": handoff_lost,
        "handoff_ms": round(export["export_ms"]
                            + imported["import_ms"], 2),
        "restored_generation": imported["generation"],
        "actors_remapped": remapped,
        "mass_reconnects": mass,
        "resends_skipped": skipped,
        "decisions": decisions,
        "shrink_on_member_unreachable": shrink_named,
        "grow_on_recovery": grow_named,
        "fleet_epoch": registry.epoch(),
        "slo_problems": slo,
        "elastic_problems": elastic,
        "hung_actors": hung,
        "errors": errors,
        "wall_s": round(wall, 2),
    }
    return verdict


def _tenant_fleet_worker(cfg, host, port, i, stop) -> None:
    """Spawn target for the tenants-mode actor fleet (module level so
    the mp 'spawn' context can pickle it by name): stream labeled
    4-row flushes through the resilient client until told to stop.
    Column 0 carries ``f*1e3 + r`` (exact in float32 up to f≈16k —
    packing gid into the same scalar overflows after 1000 flushes),
    column 1 the actor gid, column 2 a per-process salt — a regrown
    actor reusing the gid re-labels its rows, so the parent's ledger
    can tell incarnations apart."""
    from distributed_deep_q_tpu_torch.rpc import faultinject
    from distributed_deep_q_tpu_torch.rpc.resilience import (
        ResilientReplayFeedClient, RetryPolicy)

    if cfg.actors.chaos:
        faultinject.install(cfg.actors.chaos)
    rows = 4
    salt = float(os.getpid() % 65536)
    c = ResilientReplayFeedClient.connect(
        host, port, actor_id=i,
        policy=RetryPolicy(base_delay=0.01, max_delay=0.2, deadline=30.0),
        seed=300 + i)
    f = 0
    while not stop.is_set():
        ids = f * 1_000 + np.arange(rows, dtype=np.float32)
        obs = np.stack([ids, np.full(rows, float(i), np.float32),
                        np.full(rows, salt, np.float32)], axis=1)
        c.add_transitions(
            obs=obs, action=np.full(rows, (i * 31 + f) % 7, np.int32),
            reward=np.zeros(rows, np.float32), next_obs=obs,
            discount=np.ones(rows, np.float32))
        f += 1
        if stop.wait(0.08):
            break
    c.close()


def _wire_retry(do, mk, tries: int = 80):
    """Land one wire call against a fresh connection per attempt —
    under chaos a drop/truncation surfaces as a transport exception
    here, and the verbs this harness sends this way are idempotent."""
    last: Exception | None = None
    for _ in range(tries):
        c = mk()
        try:
            return do(c)
        except Exception as e:  # noqa: BLE001 — chaos; retry fresh
            last = e
            time.sleep(0.02)
        finally:
            try:
                c.close()
            except Exception:  # noqa: BLE001
                pass
    raise RuntimeError(f"wire call never landed: {last}")


@_cudnn_deterministic
def run_tenants_smoke(deadline: float = 240.0, device: str = "cuda",
                      net=None, obs_dim: int = 8) -> dict:
    """Close the control loop: multi-tenant degrade ladder +
    autoscaler executor, both against live process/wire state.

    See the module docstring's ``tenants`` entry for the full gate
    list. Both arcs write one JSONL, audited afterwards with
    ``telemetry_report``'s strict SLO and elastic-lineage checks.

    Arc 1's tenants serve on ``device``; ``net`` defaults to the
    reference's MLP over ``obs_dim`` inputs. Every arc-1 microbatch is one
    request of 8 rows at bucket 8, the oracles' shape, under cuDNN
    deterministic. Arc 2's actor processes stay on the host."""

    from distributed_deep_q_tpu_torch import health
    from distributed_deep_q_tpu_torch.actors.autoscaler import (
        RECOVERY_RULE, Autoscaler)
    from distributed_deep_q_tpu_torch.actors.executor import ScaleExecutor
    from distributed_deep_q_tpu_torch.actors.supervisor import ActorSupervisor
    from distributed_deep_q_tpu_torch.config import Config, NetConfig
    from distributed_deep_q_tpu_torch.metrics import Metrics
    from distributed_deep_q_tpu_torch.models.policy import BatchedPolicy
    from distributed_deep_q_tpu_torch.replay.replay_memory import ReplayMemory
    from distributed_deep_q_tpu_torch.rpc import faultinject
    from distributed_deep_q_tpu_torch.rpc.flowcontrol import FlowConfig
    from distributed_deep_q_tpu_torch.rpc.inference_server import (
        TENANT_PRIMARY, InferenceClient, InferenceServer, arm_for)
    from distributed_deep_q_tpu_torch.rpc.replay_server import (
        ReplayFeedClient, ReplayFeedServer)

    from distributed_deep_q_tpu_torch.telemetry_report import (
        elastic_problems, load_records, slo_problems, validate_records)
    from distributed_deep_q_tpu_torch.solver import select_device

    dev = select_device(device)
    health.configure(enabled=True, fast_window_s=0.5, slow_window_s=1.5,
                     clear_ratio=0.5)
    jsonl = tempfile.mktemp(prefix="tenants_smoke_", suffix=".jsonl")
    metrics = Metrics(jsonl_path=jsonl)
    trc = _trace_begin()
    # parent-wide wire chaos: inference clients, the burst producer, and
    # BOTH servers' accepted sockets all ride it for the whole run
    plan = faultinject.install("drop=0.015,truncate=0.01,seed=43")
    step = [0]
    t0 = time.perf_counter()
    errors: list[str] = []

    # ---- arc 1: multi-tenant inference under the degrade ladder ----------
    AB, SHADOW = "ab:cand", "shadow:next"
    arms = (TENANT_PRIMARY, AB)
    rows1, requests = 8, 120
    if net is None:
        net = NetConfig(kind="mlp", hidden=(32, 32), num_actions=4)
    shape = _obs_shape(net, obs_dim)

    class _StallPolicy(BatchedPolicy):
        # forward-latency lever: with `stall` set every microbatch pays
        # stall_s, so queue occupancy climbs and the ladder must walk
        # shadow → ab → primary without any synthetic shed injection
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.stall = threading.Event()
            self.stall_s = 0.35

        def forward(self, obs, params=None, bucket=None):
            if self.stall.is_set():
                time.sleep(self.stall_s)
            return super().forward(obs, params=params, bucket=bucket)

    policy1 = _StallPolicy(net, seed=7, obs_dim=obs_dim, buckets=(8,),
                           device=dev)
    ab_src = BatchedPolicy(net, seed=8, obs_dim=obs_dim, buckets=(8,),
                           device=dev)
    shadow_src = BatchedPolicy(net, seed=9, obs_dim=obs_dim, buckets=(1,),
                               device=dev)
    server1 = InferenceServer(
        policy1, max_batch=rows1, cutoff_us=2000,
        flow=FlowConfig(staged_high_watermark=80, ingest_factor=100.0,
                        flush_credit_floor=8),
        tenants=(AB, SHADOW), shed_shadow_frac=0.3, shed_ab_frac=0.55,
        ladder_burn_s=0.2)
    host1, port1 = server1.address
    server1.set_params(policy1.get_weights(), version=7)
    server1.set_params(ab_src.get_weights(), version=101, tenant=AB)
    server1.set_params(shadow_src.get_weights(), version=201, tenant=SHADOW)

    fleet1 = health.FleetHealth()
    fleet1.register("inference", server1.health_scrape)
    statuses1: list[str] = []
    critical_flaps = [0]
    tenant_slo_hits: set = set()

    def tick1(collect: bool = False) -> None:
        v = fleet1.scrape()
        statuses1.append(v.status)
        if v.status == "critical":
            critical_flaps[0] += 1
        if collect and v.status != "ok":
            for f in v.findings:
                if f.rule in ("tenant_shed", "tenant_latency") \
                        and f.key.startswith("tenant/"):
                    tenant_slo_hits.add((f.rule, f.key))
        metrics.log(step[0], **{**fleet1.gauges(),
                                **server1.telemetry_summary(),
                                "health/verdict": v.to_jsonable()})
        step[0] += 1
        time.sleep(0.05)

    def run_until1(pred, min_s: float = 0.0, max_s: float = 15.0,
                   collect: bool = False) -> bool:
        t1 = time.monotonic()
        while True:
            tick1(collect)
            elapsed = time.monotonic() - t1
            if elapsed >= min_s and pred():
                return True
            if elapsed > max_s:
                return False

    def make_obs(aid: int, i: int) -> np.ndarray:
        # labeled: a unique deterministic batch per (client, request)
        return _labeled_obs(1_000 * (aid + 1) + i, shape, rows1)

    split_aids = list(range(7))        # hash split over (primary, ab)
    # the overload wave, pinned to the primary: 12 clients (the reference
    # has 8). The primary sheds only past the watermark, 10 queued
    # requests of 8 rows, and once the A/B rung sheds, the primary's
    # requests alone must fill it: 8 pinned plus the split's primary
    # share (3 or 4 of 7) reach it only when wire chaos leaves orphaned
    # requests queued, so the reference's wave may not reach it at all
    pinned_aids = list(range(100, 112))
    got: dict[int, dict] = {a: {} for a in split_aids + pinned_aids}
    sheds1: dict[int, int] = {a: 0 for a in split_aids + pinned_aids}

    def client1(aid: int, n_req: int, tenant: str = "") -> None:
        c = None
        try:
            for i in range(n_req):
                obs = make_obs(aid, i)
                for _ in range(900):
                    try:
                        if c is None:
                            c = InferenceClient(host1, port1, actor_id=aid,
                                                timeout=5.0)
                        resp = c.infer(obs, seq=i, tenant=tenant)
                    except Exception:  # noqa: BLE001 — chaos; reconnect
                        try:
                            if c is not None:
                                c.close()
                        except Exception:  # noqa: BLE001
                            pass
                        c = None
                        time.sleep(0.01)
                        continue
                    if resp.get("error"):
                        time.sleep(0.02)
                        continue
                    if resp.get("shed"):
                        sheds1[aid] += 1
                        trc.instant("shed", plane="inference")
                        time.sleep(min(
                            resp.get("retry_after_ms", 10), 50) / 1e3)
                        continue
                    if i in got[aid]:
                        errors.append(f"client {aid}: duplicate reply "
                                      f"recorded for request {i}")
                    got[aid][i] = (
                        tuple(int(a) for a in np.asarray(resp["actions"])),
                        int(resp.get("version", -1)),
                        str(resp.get("tenant", "")))
                    break
                else:
                    errors.append(f"client {aid}: request {i} never landed")
                    return
                time.sleep(0.01)
        except Exception as e:  # noqa: BLE001 — reported in the verdict
            errors.append(f"client {aid}: {type(e).__name__}: {e}")
        finally:
            try:
                if c is not None:
                    c.close()
            except Exception:  # noqa: BLE001
                pass

    threads1 = [threading.Thread(target=client1, args=(a, requests),
                                 daemon=True) for a in split_aids]
    pinned = [threading.Thread(target=client1,
                               args=(a, 40, TENANT_PRIMARY), daemon=True)
              for a in pinned_aids]
    for t in threads1:
        t.start()

    def shadow_req_count() -> float:
        return server1.telemetry.summary().get(
            f"tenant/{SHADOW}/shadow_requests", 0.0)

    # phase 1a: healthy split traffic mirrors onto the shadow tenant
    warmed = run_until1(lambda: shadow_req_count() > 0, max_s=15.0)

    # a direct request AT the shadow tenant must be refused — its
    # replies exist server-side only, they never reach an actor
    def probe_shadow(c) -> dict:
        return c.call("infer", obs=make_obs(60, 0), seq=0, tenant=SHADOW)

    rej = _wire_retry(probe_shadow,
                      lambda: InferenceClient(host1, port1, actor_id=60,
                                              timeout=5.0), tries=200)
    shadow_rejected = "mirror-only" in str(rej.get("error", ""))

    # phase 1b: stall forwards — occupancy climbs and the ladder starts
    # shedding at the bottom (shadow). The split load alone plateaus
    # around the A/B fraction, so level 2 is reached by the pinned wave
    # below; the ledger-order gate still demands shadow → ab → primary
    policy1.stall.set()
    lvl_up = run_until1(lambda: server1.ladder_level() >= 1, max_s=20.0,
                        collect=True)
    time.sleep(1.0)  # let the in-flight microbatch finish mirroring
    s1 = shadow_req_count()

    # phase 1c: a pinned-primary overload wave pushes the queue over the
    # watermark — the PRIMARY class itself must shed, completing the
    # strict ladder order. The wave ramps up one client per 0.15 s (+0.1
    # occupancy each): started all at once, it can overflow the watermark
    # inside the A/B rung's 0.2 s burn, and the primary's own controller
    # then sheds before the ladder reaches the A/B rung
    for t in pinned:
        t.start()
        time.sleep(0.15)
    prim_shed = run_until1(
        lambda: any(e["class"] == "primary"
                    for e in server1.ladder_ledger()),
        max_s=20.0, collect=True)
    s2 = shadow_req_count()

    # phase 1d: release the stall; the fleet must walk back to ok and
    # the ladder back to level 0 under a light primary probe
    policy1.stall.clear()
    for t in threads1 + pinned:
        t.join(timeout=deadline / 2)
    hung1 = sum(t.is_alive() for t in threads1 + pinned)
    ladder_cleared = False
    pc = None
    t_end = time.monotonic() + 10.0
    i_probe = 0
    while time.monotonic() < t_end:
        try:
            if pc is None:
                pc = InferenceClient(host1, port1, actor_id=50, timeout=5.0)
            pc.infer(make_obs(50, i_probe), seq=i_probe,
                     tenant=TENANT_PRIMARY)
            i_probe += 1
        except Exception:  # noqa: BLE001 — chaos; reconnect
            try:
                if pc is not None:
                    pc.close()
            except Exception:  # noqa: BLE001
                pass
            pc = None
        if server1.ladder_level() == 0:
            ladder_cleared = True
            break
        time.sleep(0.05)
    if pc is not None:
        try:
            pc.close()
        except Exception:  # noqa: BLE001
            pass
    recovered1 = run_until1(lambda: statuses1[-1] == "ok", min_s=0.5,
                            max_s=20.0, collect=True)

    tm1 = server1.telemetry_summary()
    ledger = server1.ladder_ledger()
    server1.close()

    # per-arm oracle replay: every reply must carry the RIGHT arm's
    # action and θ version for that exact observation
    oracle_p = BatchedPolicy(net, seed=7, obs_dim=obs_dim, buckets=(8,),
                             device=dev)
    wrong = missing = tenant_mm = version_mm = 0
    for aid in got:
        arm = TENANT_PRIMARY if aid >= 100 else arm_for(aid, arms)
        oracle = oracle_p if arm == TENANT_PRIMARY else ab_src
        want_ver = 7 if arm == TENANT_PRIMARY else 101
        n_req = 40 if aid >= 100 else requests
        for i in range(n_req):
            rec = got[aid].get(i)
            if rec is None:
                missing += 1
                continue
            acts, ver, ten = rec
            if ten != arm:
                tenant_mm += 1
            if ver != want_ver:
                version_mm += 1
            want, _ = oracle.forward(make_obs(aid, i))
            if acts != tuple(int(a) for a in np.asarray(want)):
                wrong += 1

    # ---- arc 2: autoscaler executor closes the loop on processes ---------
    replay2 = ReplayMemory(65536, (3,), np.float32, seed=0)
    rserver = ReplayFeedServer(
        replay2, flow=FlowConfig(ingest_factor=1.5, flush_credit_floor=8,
                                 rate_halflife_s=0.5,
                                 max_retry_after_s=0.05))
    host2, port2 = rserver.address

    consumer_stop = threading.Event()

    def consumer() -> None:
        # rate-capped learner stand-in: consumption rate is what the
        # admission controller's ingest_factor is measured against
        while not consumer_stop.is_set():
            with rserver.replay_lock:
                if len(replay2) >= 32:
                    replay2.sample(32)
                    sampled = True
                else:
                    sampled = False
            if sampled:
                rserver.note_consumed(32)
            time.sleep(32 / 600.0)

    consumer_t = threading.Thread(target=consumer, daemon=True)
    consumer_t.start()

    cfg2 = Config()
    cfg2.actors.num_actors = 3
    cfg2.actors.chaos = "drop=0.03,delay=0.05:30,seed=11"
    sup = ActorSupervisor(cfg2, host2, port2, heartbeat_timeout=30.0,
                          spawn_grace=60.0, target=_tenant_fleet_worker)
    sup.start()

    fleet2 = health.FleetHealth()
    fleet2.register("replay", rserver.health_scrape)
    autoscaler2 = Autoscaler(min_actors=2, max_actors=3, step=1,
                             cooldown_s=0.3, recover_ticks=2)
    executor = ScaleExecutor(
        sup, rate_limit_s=0.25, drain_s=1.0, spawn_grace_s=30.0,
        heartbeat_ok=lambda i: (rserver.last_seen.get(i, 0.0)
                                > sup.spawned_at.get(i, float("inf"))),
        stream_seq=rserver.stream_seq_of,
        retire_stream=rserver.retire_stream)

    statuses2: list[str] = []
    rules2: set[str] = set()
    decisions2: list[dict] = []
    applied_all: list[dict] = []

    def tick2(collect: bool = False) -> None:
        v = fleet2.scrape()
        statuses2.append(v.status)
        if v.status == "critical":
            critical_flaps[0] += 1
        if collect and v.status != "ok":
            rules2.update(f.rule for f in v.findings)
        ds = autoscaler2.observe(v)
        applied = executor.apply(ds)
        ds_j = [d.to_jsonable() for d in ds]
        decisions2.extend(ds_j)
        rec = {**fleet2.gauges(), **autoscaler2.gauges(),
               **executor.gauges(), "health/verdict": v.to_jsonable()}
        if ds_j:
            rec["autoscale/decision"] = ds_j
        if applied:
            rec["autoscale/applied"] = applied
            applied_all.extend(applied)
        metrics.log(step[0], **rec)
        step[0] += 1
        time.sleep(0.05)

    def run_until2(pred, min_s: float = 0.0, max_s: float = 30.0,
                   collect: bool = False) -> bool:
        t1 = time.monotonic()
        while True:
            tick2(collect)
            elapsed = time.monotonic() - t1
            if elapsed >= min_s and pred():
                return True
            if elapsed > max_s:
                return False

    # phase 2a: the spawned fleet comes up and lands flushes
    booted = run_until2(
        lambda: statuses2[-1] == "ok"
        and all(rserver.stream_seq_of(i) >= 0 for i in range(3)),
        min_s=0.5, max_s=60.0)

    # phase 2b: a burst producer outruns the consumer — ingest_shed
    # burns, the autoscaler shrinks, and the executor retires a REAL
    # process (drain, terminate, dedup-stamp eviction)
    burst_stop = threading.Event()
    burst_sheds = [0]

    def burst() -> None:
        # the raw stub, on purpose: the resilient client's credit token
        # bucket paces a producer to its fair share, so a "burst" riding
        # it reaches equilibrium and never trips admission. This loop
        # ignores credits and hammers; it still resends the SAME
        # flush_seq until the server acks (ok or duplicate), so the
        # server-side dedup stamp keeps the ledger exactly-once
        c: ReplayFeedClient | None = None
        f = 0
        sheds = 0
        while not burst_stop.is_set():
            ids = f * 1_000 + np.arange(256, dtype=np.float32)
            obs = np.stack([ids, np.full(256, 9.0, np.float32),
                            np.zeros(256, np.float32)], axis=1)
            while not burst_stop.is_set():
                try:
                    if c is None:
                        c = ReplayFeedClient(host2, port2, actor_id=9,
                                             timeout=5.0)
                    resp = c.call(
                        "add_transitions", flush_seq=f, obs=obs,
                        action=np.full(256, (9 * 31 + f) % 7, np.int32),
                        reward=np.zeros(256, np.float32), next_obs=obs,
                        discount=np.ones(256, np.float32))
                except Exception:  # noqa: BLE001 — chaos; resend same f
                    if c is not None:
                        try:
                            c.close()
                        except Exception:  # noqa: BLE001
                            pass
                        c = None
                    continue
                if resp.get("shed"):
                    sheds += 1
                    trc.instant("shed", plane="replay")
                    time.sleep(0.05)
                    continue
                if resp.get("error"):
                    time.sleep(0.02)
                    continue
                break
            f += 1
        burst_sheds[0] = sheds
        if c is not None:
            try:
                c.close()
            except Exception:  # noqa: BLE001
                pass

    burst_t = threading.Thread(target=burst, daemon=True)
    burst_t.start()
    shrunk = run_until2(
        lambda: any(a["action"] == "retire" and a["applied"]
                    for a in applied_all),
        max_s=40.0, collect=True)
    burst_stop.set()
    burst_t.join(timeout=60.0)
    retired_ok = (sup.fleet_size() == 2
                  and rserver.stream_seq_of(2) == -1
                  and sup.executor_terminations == 1
                  and sup.kill_escalations == 0)

    # the eviction verb itself must be resend-safe on the wire: two
    # literal retire_stream calls, each on a fresh chaos-wrapped
    # connection, must both land as the same no-op
    def mk2():
        return ReplayFeedClient(host2, port2, actor_id=2, timeout=5.0)

    r1 = _wire_retry(lambda c: c.call("retire_stream"), mk2)
    r2 = _wire_retry(lambda c: c.call("retire_stream"), mk2)
    evict_idempotent = (bool(r1.get("ok")) and bool(r2.get("ok"))
                        and rserver.stream_seq_of(2) == -1)

    # phase 2c: the pressure is gone — the recovery streak must grow
    # the retired slot back and the fleet must land converged
    regrew = run_until2(
        lambda: any(a["action"] == "grow" and a["applied"]
                    for a in applied_all),
        max_s=60.0, collect=True)
    settled = run_until2(
        lambda: sup.fleet_size() == 3 and rserver.stream_seq_of(2) >= 0
        and statuses2[-1] == "ok",
        min_s=0.5, max_s=60.0)

    sup.stop()
    consumer_stop.set()
    consumer_t.join(timeout=10.0)
    shed_flushes = rserver.telemetry_summary().get("rpc/shed_flushes", 0.0)
    rollbacks = executor.gauges()["autoscale/rollbacks"]
    rserver.close()
    metrics.close()
    health.reset()
    faultinject.uninstall()
    wall = time.perf_counter() - t0

    # labeled ledger over the replay ring: exactly-once per (id, salt)
    # incarnation, every stored action matching its id's formula. No
    # loss gate — the workers are open-ended and one was deliberately
    # terminated mid-stream
    n = len(replay2)
    ids = replay2.obs[:n, 0].astype(np.int64)
    gids = replay2.obs[:n, 1].astype(np.int64)
    salts = replay2.obs[:n, 2].astype(np.int64)
    pairs = list(zip(ids.tolist(), gids.tolist(), salts.tolist()))
    duplicated = len(pairs) - len(set(pairs))
    fs = ids // 1_000
    wrong2 = int(np.sum(replay2.action[:n] != (gids * 31 + fs) % 7))

    records = load_records(jsonl)
    slo = slo_problems(records)
    elastic = elastic_problems(records)
    invalid = validate_records(records)
    shrink_named = any(d["action"] == "shrink_actors"
                       and d["rule"] == "ingest_shed" for d in decisions2)
    grow_named = any(d["action"] == "grow_actors"
                     and d["rule"] == RECOVERY_RULE for d in decisions2)
    retire_applied = any(a["action"] == "retire" and a["applied"]
                         and a["actor_id"] == 2 for a in applied_all)
    grow_applied = any(a["action"] == "grow" and a["applied"]
                       and a["actor_id"] == 2 for a in applied_all)
    ledger_classes = [e["class"] for e in ledger]
    total_sheds1 = sum(sheds1.values())
    verdict = {
        "ok": (not errors and hung1 == 0 and wrong == 0 and missing == 0
               and tenant_mm == 0 and version_mm == 0
               and warmed and lvl_up and prim_shed and shadow_rejected
               and s1 > 0 and s2 == s1
               and ledger_classes == ["shadow", "ab", "primary"]
               and ladder_cleared and recovered1
               and len(tenant_slo_hits) > 0
               and tm1.get("inference/compiled_buckets", 0) <= 1
               and booted and shrunk and retired_ok and evict_idempotent
               and regrew and settled and shrink_named and grow_named
               and retire_applied and grow_applied and rollbacks == 0
               and duplicated == 0 and wrong2 == 0
               and critical_flaps[0] == 0
               and not slo and not elastic and not invalid),
        # arc 1 — multi-tenant serving
        "replies": sum(len(g) for g in got.values()),
        "wrong_actions": wrong,
        "missing_actions": missing,
        "tenant_mismatches": tenant_mm,
        "version_mismatches": version_mm,
        "client_sheds": total_sheds1,
        "ladder_ledger": ledger,
        "ladder_cleared": ladder_cleared,
        "shadow_requests": s1,
        "shadow_frozen_under_shed": s2 == s1,
        "shadow_direct_rejected": shadow_rejected,
        "tenant_slo_findings": sorted(map(list, tenant_slo_hits)),
        "compiled_buckets": tm1.get("inference/compiled_buckets", 0),
        "tenants_served": tm1.get("tenant/served", 0),
        "inference_recovered": recovered1,
        # the phase gates the reference folds into "ok" unnamed
        "warmed": warmed,
        "ladder_rose": lvl_up,
        "primary_shed": prim_shed,
        # arc 2 — autoscaler executor
        "booted": booted,
        "shrunk": shrunk,
        "regrew": regrew,
        "settled": settled,
        "shrink_on_ingest_shed": shrink_named,
        "grow_on_recovery": grow_named,
        "retire_applied": retire_applied,
        "grow_applied": grow_applied,
        "retired_ok": retired_ok,
        "evict_idempotent": evict_idempotent,
        "executor_terminations": sup.executor_terminations,
        "kill_escalations": sup.kill_escalations,
        "rollbacks": rollbacks,
        "burst_sheds": burst_sheds[0],
        "shed_flushes": shed_flushes,
        "rules_fired": sorted(rules2),
        "decisions": decisions2,
        "applied": applied_all,
        "transitions_stored": n,
        "duplicated": duplicated,
        "wrong_stored_actions": wrong2,
        # shared gates
        "critical_flaps": critical_flaps[0],
        "slo_problems": slo,
        "elastic_problems": elastic,
        "invalid_records": invalid,
        "faults_fired": dict(sorted(plan.counters.items())),
        "hung_clients": hung1,
        "errors": errors,
        "wall_s": round(wall, 2),
    }
    trace = _trace_verdict(trc)
    verdict["trace"] = trace
    verdict["ok"] = (verdict["ok"] and trace["orphan_spans"] == 0
                     and (total_sheds1 == 0
                          or trace["instants"].get("shed", 0) > 0))
    return verdict


def _require_clean_gate() -> None:
    """Chaos results must never be reported for code with known race
    findings — refuse to run unless the static-analysis gate is clean."""
    from distributed_deep_q_tpu_torch.analysis import run_all

    findings = run_all()
    if findings:
        for f in findings:
            print(f, file=sys.stderr)
        print(f"chaos_smoke: REFUSING to run — analysis gate failed with "
              f"{len(findings)} finding(s); fix or suppress them first "
              "(python -m distributed_deep_q_tpu_torch.analysis)",
              file=sys.stderr)
        sys.exit(2)


def main(argv: list[str] | None = None) -> int:
    """The reference's command line; ``--device DEV`` (anywhere) sets the
    device modes' device (the card by default), and the ``train`` mode
    takes ``--preset NAME`` before its overrides. Refuses to run on a tree
    the analysis gate rejects (exit 2)."""
    _require_clean_gate()
    args = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    if "--device" in args:
        i = args.index("--device")
        device = args[i + 1]
        del args[i:i + 2]
    if args and args[0] == "train":
        rest, preset = args[1:], "cartpole"
        if rest[:1] == ["--preset"]:
            preset, rest = rest[1], rest[2:]
        print(json.dumps(run_train_chaos(rest, device=device, preset=preset),
                         default=str))
        return 0
    if args and args[0] in ("health", "--health"):
        verdict = run_health_smoke(
            spec=args[1] if len(args) > 1 else "corrupt=0.35,seed=41")
    elif args and args[0] in ("learn", "--learn", "divergence"):
        kwargs = {}
        if len(args) > 1:
            kwargs["spike"] = float(args[1])
        verdict = run_learn_divergence_smoke(**kwargs)
    elif args and args[0] in ("churn", "--churn", "elastic"):
        kwargs = {}
        if len(args) > 1 and args[1].isdigit():
            kwargs["num_actors"] = int(args[1])
        verdict = run_churn_smoke(**kwargs)
    elif args and args[0] in ("tenants", "--tenants"):
        verdict = run_tenants_smoke(device=device)
    elif args and args[0] in ("durability", "--durability"):
        kwargs = {}
        if len(args) > 1 and args[1].isdigit():
            kwargs["cycles"] = int(args[1])
        if len(args) > 2:
            kwargs["spec"] = args[2]
        verdict = run_durability_smoke(**kwargs)
    elif args and args[0] in ("vector", "--vector"):
        verdict = run_vector_chaos_smoke(
            spec=args[1] if len(args) > 1
            else "drop=0.02,truncate=0.01,seed=31", device=device)
    elif args and args[0] in ("inference", "--inference"):
        verdict = run_inference_chaos_smoke(
            spec=args[1] if len(args) > 1
            else "drop=0.03,truncate=0.02,corrupt=0.01,seed=29",
            device=device)
    elif args and args[0] in ("ingest", "--ingest", "saturation"):
        verdict = run_ingest_saturation_smoke(
            spec=args[1] if len(args) > 1 else "delay=0.05:20,seed=17",
            device=device)
    elif args and args[0] in ("overload", "--overload"):
        verdict = run_overload_smoke(
            spec=args[1] if len(args) > 1 else "delay=0.05:20,seed=13")
    else:
        n, spec = 4, "drop=0.03,truncate=0.02,seed=11"
        for arg in args:
            if arg.isdigit():
                n = int(arg)
            else:
                spec = arg
        verdict = run_chaos_smoke(num_actors=n, spec=spec)
    print(json.dumps(verdict, default=str))
    return 0 if verdict["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
