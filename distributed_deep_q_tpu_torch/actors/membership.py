"""Elastic fleet membership — live host join/leave with shard handoff.

A copy of the reference ``actors/membership.py`` (host only), its imports rewritten
to this package.

ROADMAP item 4 names the gap this closes: `actors/assignment.py`
guarantees minimal remap on host churn, but the host SET itself was
fixed at boot. This module makes membership a first-class, runtime
object:

``MembershipRegistry``
    An epoch-numbered host set served over the existing v4 CRC wire.
    The registry rides inside one ``ReplayFeedServer`` (the seed host
    attaches it via ``attach_membership``) and answers four verbs —
    ``fleet_join`` / ``fleet_leave`` / ``fleet_lease`` / ``fleet_view``
    — so any host or actor can observe and mutate the fleet with the
    same resilient client it already holds. Every membership change
    bumps the epoch; actors watch the epoch and re-run
    ``assign_fleet``/``owner_host`` against the new token set.

Liveness is LEASE-based, deliberately distinct from the per-actor
heartbeats: a heartbeat says "this actor thread is alive", a lease says
"this HOST is still a legitimate shard owner". A host that stops
renewing past ``lease_s`` is expired by ``expire()`` — same epoch bump
as a voluntary leave, so the actor-side remap path is identical.

Shard handoff (the departing-host protocol) reuses the durability plane
(``utils/durability.py``) end to end:

- export: ``export_shard`` drains the departing server and snapshots
  through ``GenerationStore`` — payload files first, ``MANIFEST.json``
  last, so the handoff commit point is atomic. The snapshot carries the
  replay rows, the PER tree/RNG state, AND the ``(actor_id, flush_seq)``
  dedup map.
- import: ``import_shard`` warm-boots a fresh ``ReplayFeedServer`` from
  that store. A torn handoff (crash mid-export) fails CRC verification,
  is quarantined, and the importer falls back to the previous good
  generation — never a half-shard.

Exactly-once through the remap: an actor's un-acked in-flight flush may
have LANDED on the departed host before the ack was lost. Its stamp is
inside the exported dedup map, so a resend to the IMPORTER dedups
server-side. For the one remaining hole — the actor remaps to a host
that is NOT the importer — ``resend_floor`` asks the importer (found
via the registry's departed→importer lineage) for the actor's highest
landed seq; the resilient client skips any resend at or below that
floor (``ResilientReplayFeedClient.resend_floor``).
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any

FLEET_METHODS = ("fleet_join", "fleet_leave", "fleet_lease", "fleet_view")

DEFAULT_LEASE_S = 30.0


class MembershipRegistry:
    """Epoch-numbered fleet host set with lease-based liveness.

    Thread-safe: every field moves under ``_fleet_lock`` (serve threads
    answering fleet verbs race the supervisor's gauge reads and the
    lease sweeper).
    """

    def __init__(self, lease_s: float = DEFAULT_LEASE_S):
        self._fleet_lock = threading.Lock()
        # token → {"host": str, "port": int, "lease": monotonic deadline}
        self._fleet_members: dict[str, dict[str, Any]] = {}
        self._fleet_epoch = 0
        # departed token → importing token (shard lineage for resend_floor)
        self._fleet_lineage: dict[str, str] = {}
        self._fleet_stats = {"joins": 0, "leaves": 0,
                             "lease_expired": 0, "handoffs": 0}
        self.lease_s = float(lease_s)

    # -- membership verbs ---------------------------------------------------

    def join(self, token: str, host: str, port: int) -> int:
        """Admit (or re-address) a host; returns the new epoch.

        Tokens are the stable hash-ring identities from
        ``assignment.host_tokens`` — re-joining with a new address is a
        reconnect, not a remap (the ring never sees the address)."""
        if not token:
            raise ValueError("membership token must be non-empty")
        now = time.monotonic()
        with self._fleet_lock:
            self._fleet_members[token] = {
                "host": str(host), "port": int(port),
                "lease": now + self.lease_s,
            }
            # a re-join supersedes any departed-lineage entry: the token
            # owns its shard again, floors resolve against it directly
            self._fleet_lineage.pop(token, None)
            self._fleet_epoch += 1
            self._fleet_stats["joins"] += 1
            return self._fleet_epoch

    def leave(self, token: str, importer: str = "") -> int:
        """Retire a host; returns the new epoch.

        ``importer`` names the token that imported the departing host's
        replay shard (may be empty for a shard-less drain). The lineage
        entry lets remapped actors resolve their resend floor against
        whoever actually holds their landed flushes."""
        with self._fleet_lock:
            self._fleet_members.pop(token, None)
            if importer:
                self._fleet_lineage[token] = str(importer)
                self._fleet_stats["handoffs"] += 1
            self._fleet_epoch += 1
            self._fleet_stats["leaves"] += 1
            return self._fleet_epoch

    def renew(self, token: str) -> bool:
        """Extend a member's lease; False if the token is not a member
        (expired or never joined — the caller should re-join)."""
        with self._fleet_lock:
            entry = self._fleet_members.get(token)
            if entry is None:
                return False
            entry["lease"] = time.monotonic() + self.lease_s
            return True

    def expire(self, now: float | None = None) -> tuple[str, ...]:
        """Sweep lapsed leases; returns the expired tokens. Each
        expiry bumps the epoch exactly like a voluntary leave (no
        importer — the shard is recovered out of band)."""
        now = time.monotonic() if now is None else now
        with self._fleet_lock:
            lapsed = tuple(t for t, e in self._fleet_members.items()
                           if e["lease"] < now)
            for token in lapsed:
                self._fleet_members.pop(token, None)
                self._fleet_epoch += 1
                self._fleet_stats["lease_expired"] += 1
            return lapsed

    def epoch(self) -> int:
        with self._fleet_lock:
            return self._fleet_epoch

    def view(self) -> dict[str, Any]:
        """Flat wire-friendly snapshot: epoch + member table + lineage.

        Nested data rides as JSON strings (the ``findings_json``
        precedent from the health plane — the v4 wire stays a flat
        scalar/bytes dict, no format version bump)."""
        with self._fleet_lock:
            members = {t: [e["host"], e["port"]]
                       for t, e in self._fleet_members.items()}
            return {
                "ok": True,
                "epoch": self._fleet_epoch,
                "members_json": json.dumps(members, sort_keys=True),
                "lineage_json": json.dumps(self._fleet_lineage,
                                           sort_keys=True),
            }

    # -- wire dispatch (delegated from ReplayFeedServer._dispatch) ----------

    def _dispatch(self, req: dict[str, Any]) -> dict[str, Any]:
        method = req.get("method")
        if method == "fleet_join":
            epoch = self.join(str(req.get("token", "")),
                              str(req.get("host", "")),
                              int(req.get("port", 0)))
            return {"ok": True, "epoch": epoch}
        if method == "fleet_leave":
            epoch = self.leave(str(req.get("token", "")),
                               importer=str(req.get("importer", "")))
            return {"ok": True, "epoch": epoch}
        if method == "fleet_lease":
            ok = self.renew(str(req.get("token", "")))
            return {"ok": ok, "epoch": self.epoch()}
        if method == "fleet_view":
            return self.view()
        return {"error": f"unknown fleet method {method!r}"}

    def gauges(self) -> dict[str, float]:
        """``fleet/*`` gauges for the supervisor's metrics tick."""
        with self._fleet_lock:
            return {
                "fleet/epoch": float(self._fleet_epoch),
                "fleet/members": float(len(self._fleet_members)),
                "fleet/joins": float(self._fleet_stats["joins"]),
                "fleet/leaves": float(self._fleet_stats["leaves"]),
                "fleet/lease_expired":
                    float(self._fleet_stats["lease_expired"]),
                "fleet/handoffs": float(self._fleet_stats["handoffs"]),
            }


# -- view helpers (client side) ----------------------------------------------


def view_tokens(view: dict[str, Any]) -> tuple[str, ...]:
    """Sorted member tokens from a ``fleet_view`` reply — the exact
    host tuple to feed ``assign_fleet`` (sorted so every observer of
    the same epoch computes the same assignment)."""
    return tuple(sorted(json.loads(view["members_json"])))


def view_address(view: dict[str, Any], token: str) -> tuple[str, int]:
    """(host, port) for a member token in a ``fleet_view`` reply."""
    host, port = json.loads(view["members_json"])[token]
    return str(host), int(port)


def resolve_importer(view: dict[str, Any], token: str) -> str:
    """Follow the departed→importer lineage transitively: the member
    that currently holds ``token``'s shard (may be ``token`` itself if
    it never left, or "" if the chain dead-ends outside the fleet)."""
    members = json.loads(view["members_json"])
    lineage = json.loads(view["lineage_json"])
    seen: set[str] = set()
    cur = token
    while cur not in members:
        if cur in seen or cur not in lineage:
            return ""
        seen.add(cur)
        cur = lineage[cur]
    return cur


def resend_floor(host: str, port: int, actor_id: int,
                 timeout: float = 10.0) -> int:
    """Ask a server for ``actor_id``'s highest landed flush_seq.

    Called during a remap, BEFORE releasing the actor's in-flight retry
    to its new owner: if the floor covers the in-flight seq, the flush
    already landed on the departed host (and traveled inside the
    exported shard) — the resilient client skips the resend instead of
    double-inserting."""
    from distributed_deep_q_tpu_torch.rpc.replay_server import ReplayFeedClient

    client = ReplayFeedClient(host, port, actor_id=actor_id,
                              timeout=timeout)
    try:
        reply = client.call("stream_seq")
        return int(reply.get("seq", -1))
    finally:
        client.close()


# -- shard handoff (GenerationStore round trip) ------------------------------


def export_shard(server, path: str,
                 drain_timeout: float = 5.0) -> dict[str, Any]:
    """Gracefully retire a server, exporting its replay shard.

    ``shutdown`` closes the listener, drains in-flight dispatches to
    zero, then snapshots through ``GenerationStore`` — payload files
    first, manifest last, so the handoff either committed completely or
    (torn) fails CRC at import and falls back. Returns the handoff
    receipt the churn gate and PERF bench consume."""
    t0 = time.perf_counter()
    with server.replay_lock:
        rows = len(server.replay) if server.replay is not None else 0
    server.shutdown(path, drain_timeout=drain_timeout)
    return {
        "rows": int(rows),
        "export_ms": (time.perf_counter() - t0) * 1e3,
        "path": path,
    }


def import_shard(replay, path: str, host: str = "127.0.0.1",
                 port: int = 0, flow=None,
                 snapshot_keep: int = 3) -> tuple[Any, dict[str, Any]]:
    """Warm-boot a fresh server from an exported shard.

    The generational restore runs before the listener opens (so no
    actor ever sees a half-restored dedup map), quarantining any torn
    generation and falling back to the previous good one. Returns
    ``(server, receipt)``; ``receipt["generation"]`` is -1 when nothing
    restorable was found (fresh-empty fallback)."""
    from distributed_deep_q_tpu_torch.rpc.replay_server import ReplayFeedServer

    t0 = time.perf_counter()
    server = ReplayFeedServer(replay, host=host, port=port,
                              snapshot_path=path, flow=flow,
                              snapshot_keep=snapshot_keep)
    with server.replay_lock:
        rows = len(server.replay) if server.replay is not None else 0
    return server, {
        "rows": int(rows),
        "import_ms": (time.perf_counter() - t0) * 1e3,
        "generation": int(server._restored_generation),
        "path": path,
    }
