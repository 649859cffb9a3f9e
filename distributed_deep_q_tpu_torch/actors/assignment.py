"""Consistent-hash actor→host assignment (port of the reference
``actors/assignment.py``; host-only, no torch).

Each learner host owns a full local data plane: a replay shard fed only
by its slice of the actor fleet (FireCaffe's lesson, PAPERS.md
arXiv:1511.00175 — make the gradient allreduce the *only* cross-host
traffic; In-Network Experience Sampling, arXiv:2110.13506 — sample
where the data lands). The slice comes from a consistent-hash ring so
the mapping is

- **a pure function of (fleet, hosts)** — an actor restarting with the
  same global id lands on the same host, so churn never reshuffles the
  fleet (replay stream identity survives restarts, and the supervisor's
  restart path needs no coordination);
- **minimal-remap on host join/leave** — only ~fleet/hosts actors move
  when the host set changes, everyone else keeps their shard (classic
  ring property; the bounded-load cap below perturbs it only at the
  margin);
- **balanced by construction** — plain consistent hashing can leave a
  host with an empty slice, which here is not a latency blip but a
  DEADLOCK: the cross-host learn gate AND-reduces ``replay.ready()``
  and an unfed shard never fills. Assignment therefore walks the ring
  under a load cap of ``ceil(fleet/hosts)`` (bounded-load consistent
  hashing) and a deterministic rebalance pass lifts any host below
  ``floor(fleet/hosts)``, so every host owns between floor and ceil
  actors.

Hosts are identified by stable TOKENS (``host-<pid>``), not network
addresses: a host changing address keeps its token, so its actor slice
is unchanged and the move is just a reconnect through
``ResilientReplayFeedClient`` — exactly the seam the membership registry (``actors/membership.py``) relies on.
"""

from __future__ import annotations

import bisect
import hashlib
from typing import Sequence

#: virtual nodes per host on the ring — enough that per-host arc length
#: concentrates (stddev ~ 1/sqrt(replicas)) without making ring
#: construction a cost (the ring is rebuilt per call; assignment runs
#: once at spawn, not on a hot path)
REPLICAS = 64


def stable_hash(token: str) -> int:
    """64-bit hash that is stable across processes and runs.

    ``hash()`` is salted per-process (PYTHONHASHSEED); every host must
    compute the identical ring, so use a keyed-nothing blake2b digest.
    """
    return int.from_bytes(
        hashlib.blake2b(token.encode(), digest_size=8).digest(), "big")


def host_tokens(num_hosts: int) -> tuple[str, ...]:
    """Canonical host tokens for a multi-controller learner: one per
    learner process (``mesh.process_id``). Tokens, not addresses — see module docstring."""
    return tuple(f"host-{i}" for i in range(num_hosts))


def _ring(hosts: Sequence[str],
          replicas: int) -> tuple[list[int], list[str]]:
    pts = sorted(
        (stable_hash(f"{h}#{r}"), h)
        for h in hosts for r in range(replicas))
    return [p for p, _ in pts], [h for _, h in pts]


def owner_host(gid: int, hosts: Sequence[str],
               replicas: int = REPLICAS) -> str:
    """Unbounded ring lookup: the host whose virtual node first follows
    the actor's hash point clockwise. This is the raw ring preference
    ``assign_fleet`` starts from before load bounding."""
    points, owners = _ring(hosts, replicas)
    i = bisect.bisect_right(points, stable_hash(f"actor-{gid}"))
    return owners[i % len(owners)]


def assign_fleet(fleet_size: int, hosts: Sequence[str],
                 replicas: int = REPLICAS) -> dict[str, list[int]]:
    """host token → sorted actor gids, covering ``range(fleet_size)``.

    Bounded-load walk: each gid starts at its ring point and takes the
    first host under the ``ceil(fleet/hosts)`` cap. A deterministic
    rebalance pass then moves actors from the most- to the least-loaded
    host until every host holds at least ``floor(fleet/hosts)`` — an
    empty shard would deadlock the cross-host learn gate (module
    docstring). Pure function of its arguments.
    """
    hosts = list(hosts)
    if not hosts:
        raise ValueError("assign_fleet needs at least one host")
    if len(set(hosts)) != len(hosts):
        raise ValueError(f"duplicate host tokens: {hosts}")
    points, owners = _ring(hosts, replicas)
    n = len(points)
    cap = -(-fleet_size // len(hosts))
    load = {h: 0 for h in hosts}
    out: dict[str, list[int]] = {h: [] for h in hosts}
    for gid in range(fleet_size):
        i = bisect.bisect_right(points, stable_hash(f"actor-{gid}")) % n
        h = next(owners[(i + s) % n] for s in range(n)
                 if load[owners[(i + s) % n]] < cap)
        load[h] += 1
        out[h].append(gid)

    floor = fleet_size // len(hosts)
    while True:
        short = [h for h in hosts if load[h] < floor]
        if not short:
            break
        # deterministic donor/recipient: extreme load, host order breaks
        # ties — every process computes the identical move sequence
        h_to = min(short, key=lambda h: (load[h], hosts.index(h)))
        h_from = max(hosts, key=lambda h: (load[h], -hosts.index(h)))
        out[h_to].append(out[h_from].pop())
        load[h_from] -= 1
        load[h_to] += 1
    return {h: sorted(v) for h, v in out.items()}


def local_slice(fleet_size: int, num_hosts: int,
                host_index: int, replicas: int = REPLICAS) -> list[int]:
    """The actor gids host ``host_index`` of ``num_hosts`` owns — the
    supervisor-facing entry point (canonical tokens, one call)."""
    tokens = host_tokens(num_hosts)
    return assign_fleet(fleet_size, tokens, replicas)[tokens[host_index]]
