"""Elasticity bench: shard-handoff wall time and remap churn, and the
multi-tenant serving and executor control paths.

    python -m distributed_deep_q_tpu_torch.bench_elasticity [--rows 4096]
        [--repeats 5] [--fleet 64] [--tenant-repeats 3]

The port's copy of the reference's ``scripts/bench_elasticity.py`` (port
tools live in the port package), on the port's
``actors/membership.py``, ``actors/assignment.py``, ``ReplayMemory``,
``BatchedPolicy``, ``InferenceServer`` and ``ScaleExecutor``. It is host
only: the shard handoff moves a host replay through the wire and the
durability plane, and the tenants' policy runs on the CPU, so it needs no
card and launches no kernel.

- **Handoff wall time**: a live ``ReplayFeedServer`` holding a labeled
  replay shard is retired through ``membership.export_shard`` (drain,
  then a manifest-committed ``GenerationStore`` snapshot) and a fresh
  server warm-boots it through ``membership.import_shard``. Export and
  import are timed separately over ``--repeats`` rounds; the line carries
  the medians and the larger relative spread. Every exported row must
  land in the importing replay, once (the reference checks the count).
- **Remap fraction**: the share of the acting fleet whose owner changes
  across 2→4 (grow) and 4→2 (shrink) host-set steps of ``assign_fleet``.
  Deterministic given the ring: a change here is a ring-layout change.
- **Tenants**: θ swap latency on a live server, the shadow mirror's toll
  on the primary's reply latency, and the ``ScaleExecutor`` apply path
  against an inert fleet stub.

Output is one JSON line on stdout, under the reference's keys
(``bench_diff``-ready).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

import numpy as np

from distributed_deep_q_tpu_torch.actors import membership as ms
from distributed_deep_q_tpu_torch.actors.assignment import (
    assign_fleet, host_tokens)
from distributed_deep_q_tpu_torch.replay.replay_memory import ReplayMemory
from distributed_deep_q_tpu_torch.rpc.replay_server import (
    ReplayFeedClient, ReplayFeedServer)


def _fill(server: ReplayFeedServer, rows: int) -> None:
    """Feed ``rows`` labeled transitions through the real wire path so
    the exported shard is what production would hand off."""
    host, port = server.address
    client = ReplayFeedClient(host, port, actor_id=1)
    try:
        chunk = 512
        seq = 0
        for start in range(0, rows, chunk):
            n = min(chunk, rows - start)
            ids = np.arange(start, start + n, dtype=np.float32)
            obs = np.stack([ids, ids], axis=1)
            seq += 1
            client.call("add_transitions", flush_seq=seq, obs=obs,
                        action=np.zeros(n, np.int32),
                        reward=np.zeros(n, np.float32), next_obs=obs,
                        discount=np.ones(n, np.float32))
    finally:
        client.close()


def bench_handoff(rows: int, repeats: int, tmp: str) -> dict:
    exports, imports = [], []
    # round 0 is a discarded warmup: it pays the lazy persistence-module
    # imports and filesystem cache faults that production hosts paid at
    # boot, which would otherwise dominate the recorded spread
    for r in range(repeats + 1):
        replay = ReplayMemory(max(rows, 1), (2,))
        server = ReplayFeedServer(replay)
        _fill(server, rows)
        path = f"{tmp}/handoff-{r}"
        export = ms.export_shard(server, path)
        replay2 = ReplayMemory(max(rows, 1), (2,))
        server2, imported = ms.import_shard(replay2, path)
        server2.close()
        if imported["rows"] != rows or export["rows"] != rows:
            raise SystemExit(
                f"handoff lost rows: exported {export['rows']}, "
                f"imported {imported['rows']}, expected {rows}")
        landed = np.sort(replay2.obs[:len(replay2), 0])
        if not np.array_equal(landed, np.arange(rows, dtype=np.float32)):
            raise SystemExit(
                f"handoff round {r}: the imported replay does not hold "
                f"each of the {rows} exported rows once")
        if r > 0:
            exports.append(export["export_ms"])
            imports.append(imported["import_ms"])

    def spread(xs: list[float]) -> float:
        m = statistics.median(xs)
        return (max(xs) - min(xs)) / m if m else 0.0

    return {
        "handoff_export_ms": round(statistics.median(exports), 3),
        "handoff_import_ms": round(statistics.median(imports), 3),
        "handoff_rows": rows,
        "elasticity_spread": round(max(spread(exports), spread(imports)), 4),
    }


def bench_remap(fleet: int) -> dict:
    """Owner-change fraction across 2→4 (grow) and 4→2 (shrink)."""

    def owners(hosts):
        return {g: h for h, v in assign_fleet(fleet, hosts).items()
                for g in v}

    o2, o4 = owners(host_tokens(2)), owners(host_tokens(4))
    moved_grow = sum(o2[g] != o4[g] for g in range(fleet))
    moved_shrink = sum(o4[g] != o2[g] for g in range(fleet))
    return {
        "fleet_size": fleet,
        "remap_fraction_grow": round(moved_grow / fleet, 4),
        "remap_fraction_shrink": round(moved_shrink / fleet, 4),
    }


def bench_tenants(repeats: int) -> dict:
    """Multi-tenant serving + executor control-path costs: θ swap latency on a live server, the shadow mirror's
    toll on primary reply latency, and the ScaleExecutor apply path
    against an inert fleet stub (control-plane bookkeeping only — child
    boot time is the supervisor's spawn cost, benched nowhere because
    it is dominated by the child's interpreter start)."""
    import time

    from distributed_deep_q_tpu_torch.actors.autoscaler import Decision
    from distributed_deep_q_tpu_torch.actors.executor import ScaleExecutor
    from distributed_deep_q_tpu_torch.config import NetConfig
    from distributed_deep_q_tpu_torch.models.policy import BatchedPolicy
    from distributed_deep_q_tpu_torch.rpc.inference_server import (
        InferenceClient, InferenceServer)

    net = NetConfig(kind="mlp", hidden=(32, 32), num_actions=5)
    obs = np.random.default_rng(0).standard_normal((8, 6)).astype(np.float32)

    def drive(tenants: tuple, n: int = 150) -> tuple[float, float]:
        """-> (median primary reply ms, median set_params µs)."""
        # on the host: the bench measures the control path, not a card
        policy = BatchedPolicy(net, seed=0, obs_dim=6, buckets=(8,),
                               device="cpu")
        server = InferenceServer(policy, max_batch=8, cutoff_us=100,
                                 tenants=tenants)
        w = policy.get_weights()
        server.set_params(w, version=1)
        for tag in tenants:
            server.set_params(w, version=1, tenant=tag)
        host, port = server.address
        client = InferenceClient(host, port, actor_id=0)
        try:
            for _ in range(20):  # warmup: compile + socket caches
                client.infer(obs)
            lat = []
            for _ in range(n):
                t0 = time.perf_counter()
                client.infer(obs)
                lat.append(1e3 * (time.perf_counter() - t0))
            swaps = []
            version = 2
            for _ in range(64):
                t0 = time.perf_counter()
                server.set_params(w, version=version)
                swaps.append(1e6 * (time.perf_counter() - t0))
                version += 1
        finally:
            client.close()
            server.close()
        return statistics.median(lat), statistics.median(swaps)

    class _StubFleet:
        def __init__(self):
            self.n = 4

        def fleet_size(self):
            return self.n

        def actor_ids(self):
            return list(range(self.n))

        def grow(self):
            self.n += 1
            return self.n - 1

        def retire(self, i):
            self.n -= 1
            return True

        def reap_actor(self, i):
            return self.retire(i)

    plain, shadowed, swap_us, apply_us = [], [], [], []
    for _ in range(repeats):
        ms_plain, _ = drive(())
        ms_shadow, sw = drive(("shadow:cand",))
        plain.append(ms_plain)
        shadowed.append(ms_shadow)
        swap_us.append(sw)
        fleet = _StubFleet()
        ex = ScaleExecutor(fleet, rate_limit_s=0.0, drain_s=0.0)
        t0 = time.perf_counter()
        ex.apply([Decision("grow_actors", "capacity_recovered", "", "",
                           1.0, 1.0, 0.0, 0.0, 4, 5, 0.0)])
        ex.apply([Decision("shrink_actors", "ingest_shed", "k", "m",
                           9.0, 0.0, 2.0, 1.5, 5, 4, 0.0)])
        apply_us.append(1e6 * (time.perf_counter() - t0) / 2)

    def spread(xs: list[float]) -> float:
        m = statistics.median(xs)
        return (max(xs) - min(xs)) / m if m else 0.0

    pl, sh = statistics.median(plain), statistics.median(shadowed)
    return {
        "tenant_swap_us": round(statistics.median(swap_us), 1),
        "shadow_overhead_pct": round(1e2 * (sh - pl) / pl, 2) if pl else 0.0,
        "executor_apply_us": round(statistics.median(apply_us), 1),
        "tenant_spread": round(max(spread(plain), spread(shadowed),
                                   spread(swap_us)), 4),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m distributed_deep_q_tpu_torch.bench_elasticity",
        description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=4096)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--fleet", type=int, default=64)
    ap.add_argument("--tenant-repeats", type=int, default=3)
    args = ap.parse_args(argv)
    import tempfile
    with tempfile.TemporaryDirectory(prefix="bench-elasticity-") as tmp:
        out = bench_handoff(args.rows, args.repeats, tmp)
    out.update(bench_remap(args.fleet))
    out.update(bench_tenants(args.tenant_repeats))
    print(json.dumps(out, sort_keys=True), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
