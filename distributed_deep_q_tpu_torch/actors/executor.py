"""Autoscaler executor — the acting half of the control loop (port of the
reference's ``actors/executor.py``; stdlib only).

``actors/autoscaler.py`` closed the sensing loop: health verdicts in,
lineage-traceable ``Decision``s out. Until now nobody acted on them —
the scaler moved ``autoscale/target_*`` gauges and the fleet stayed
put. ``ScaleExecutor`` consumes actor-dimension decisions and drives
the ``ActorSupervisor``'s spawn/retire machinery to make the fleet
MATCH the target, with the guard rails a process-touching control loop
needs:

- **Rate limit.** At most one applied action per ``rate_limit_s`` —
  a floor on top of the autoscaler's own per-dimension cooldown, so a
  burst of decisions (e.g. after a cooldown expiry) cannot churn the
  fleet faster than spawned actors can come up.
- **Dry run.** ``dry_run=True`` walks the whole path — selection,
  rate limiting, findings — without touching a process; every finding
  says so (``dry_run: 1``), so an operator can audit what the loop
  WOULD do before arming it.
- **Graceful retirement.** A shrink picks the highest-id actor, waits
  up to ``drain_s`` for its replay flush seq to go quiet (two stable
  polls — an in-flight flush completes and bumps the seq), terminates
  it through the supervisor's ``retire`` (counted separately from
  crash-kill escalations), and finally evicts the actor's exactly-once
  dedup stamp from the replay server so scale-down churn cannot grow
  the ``(actor_id, flush_seq)`` map unboundedly.
- **Rollback.** A grow is provisional: if the new actor has not
  heartbeated within ``spawn_grace_s`` the executor reaps it and
  releases the slot — a decision cannot leak half-alive processes.
- **Lineage.** Every applied (or skipped) action is a JSONL finding
  under ``autoscale/applied`` naming the triggering decision's rule,
  and ``autoscale/applied_actors`` rides next to the scaler's
  ``autoscale/target_actors`` gauge — ``telemetry_report.elastic_problems``
  fails a run where the two disagree at the end or an applied action
  lost its provenance.

Inference-dimension decisions have no executor yet (replicating the
serving plane is a topology change, not a process start) — they are
acknowledged with an explicit skip finding rather than dropped.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable

from distributed_deep_q_tpu_torch.actors.autoscaler import Decision

log = logging.getLogger(__name__)

__all__ = ["ScaleExecutor"]


class ScaleExecutor:
    """Applies actor-dimension ``Decision``s through an
    ``ActorSupervisor``-shaped object (``fleet_size``/``actor_ids``/
    ``grow``/``retire``/``reap_actor``).

    ``heartbeat_ok(actor_id)`` reports whether a grown actor has made
    contact since its spawn (wired to the replay server's ``last_seen``
    map); ``stream_seq(actor_id)`` reads the actor's replay flush seq
    for the retirement drain; ``retire_stream(actor_id)`` evicts the
    dedup stamp after a drain. All three default to inert stubs so the
    executor stays testable without a live RPC plane.
    """

    def __init__(self, sup, *, rate_limit_s: float = 5.0,
                 drain_s: float = 5.0, spawn_grace_s: float = 20.0,
                 dry_run: bool = False,
                 heartbeat_ok: Callable[[int], bool] | None = None,
                 stream_seq: Callable[[int], int] | None = None,
                 retire_stream: Callable[[int], Any] | None = None,
                 clock: Callable[[], float] = time.monotonic):
        self.sup = sup
        self.rate_limit_s = max(float(rate_limit_s), 0.0)
        self.drain_s = max(float(drain_s), 0.0)
        self.spawn_grace_s = max(float(spawn_grace_s), 0.0)
        self.dry_run = bool(dry_run)
        self._heartbeat_ok = heartbeat_ok or (lambda i: True)
        self._stream_seq = stream_seq or (lambda i: -1)
        self._retire_stream = retire_stream or (lambda i: None)
        self._clock = clock
        # mutable executor state, one lock: counters the gauges export,
        # the rate-limit stamp, and grows still inside their grace window
        self._ex_lock = threading.Lock()
        self._ex_counts = {"applied_actions": 0, "rollbacks": 0,
                           "retirements": 0, "rate_limited": 0,
                           "skipped": 0}
        self._ex_last_apply = -1e18
        self._ex_pending_grows: dict[int, float] = {}  # actor_id → t_spawn

    # -- the apply path ------------------------------------------------------

    def apply(self, decisions: list[Decision]) -> list[dict[str, Any]]:
        """Act on a tick's decisions; returns one finding dict per
        action taken, skipped, or rolled back — the supervisor logs the
        list under ``autoscale/applied``. Rollback checks run every
        call, so a grace-window miss surfaces even on decision-free
        ticks."""
        findings = self._check_rollbacks()
        for d in decisions or ():
            if not d.action.endswith("_actors"):
                findings.append(self._skip(
                    d, "no executor for the inference dimension"))
                continue
            now = self._clock()
            with self._ex_lock:
                limited = now - self._ex_last_apply < self.rate_limit_s
                if limited:
                    self._ex_counts["rate_limited"] += 1
                else:
                    self._ex_last_apply = now
            if limited:
                findings.append(self._skip(d, "rate limited"))
                continue
            if d.action.startswith("grow"):
                findings.append(self._grow(d))
            else:
                findings.append(self._shrink(d))
        return findings

    def _finding(self, d: Decision, action: str, applied: bool,
                 reason: str = "", actor_id: int = -1) -> dict[str, Any]:
        return {"action": action, "rule": d.rule, "decision_t": d.t,
                "from_n": d.from_n, "to_n": d.to_n,
                "actor_id": actor_id, "applied": int(applied),
                "dry_run": int(self.dry_run), "reason": reason,
                "t": self._clock()}

    def _skip(self, d: Decision, reason: str) -> dict[str, Any]:
        with self._ex_lock:
            self._ex_counts["skipped"] += 1
        return self._finding(d, "skip", False, reason)

    def _grow(self, d: Decision) -> dict[str, Any]:
        if self.sup.fleet_size() >= d.to_n:
            return self._skip(d, "fleet already at or above target")
        if self.dry_run:
            return self._finding(d, "grow", False, "dry run")
        i = self.sup.grow()
        with self._ex_lock:
            self._ex_counts["applied_actions"] += 1
            self._ex_pending_grows[i] = self._clock()
        log.info("autoscale executor: grew actor %d (rule %s)", i, d.rule)
        return self._finding(d, "grow", True, actor_id=i)

    def _shrink(self, d: Decision) -> dict[str, Any]:
        ids = self.sup.actor_ids()
        if len(ids) <= d.to_n or not ids:
            return self._skip(d, "fleet already at or below target")
        i = ids[-1]  # retire the highest id: boot actors live longest
        if self.dry_run:
            return self._finding(d, "retire", False, "dry run", actor_id=i)
        self._drain(i)
        if not self.sup.retire(i):
            return self._skip(d, f"actor {i} vanished before retirement")
        # the stamp eviction AFTER terminate: the actor can no longer
        # send, so the (actor_id, flush_seq) entry is provably dead
        try:
            self._retire_stream(i)
        except Exception as e:  # noqa: BLE001 — eviction is hygiene,
            # never worth failing the scale action over
            log.warning("retire_stream(%d) failed: %s: %s",
                        i, type(e).__name__, e)
        with self._ex_lock:
            self._ex_counts["applied_actions"] += 1
            self._ex_counts["retirements"] += 1
            self._ex_pending_grows.pop(i, None)
        log.info("autoscale executor: retired actor %d (rule %s)", i, d.rule)
        return self._finding(d, "retire", True, actor_id=i)

    def _drain(self, i: int) -> None:
        """Wait (bounded by ``drain_s``) for the actor's replay flush
        seq to hold still across two polls — an in-flight flush lands
        and bumps the seq; quiet means nothing is mid-wire."""
        deadline = self._clock() + self.drain_s
        try:
            last = self._stream_seq(i)
        except Exception:  # noqa: BLE001 — a dead plane means no drain
            return
        while self._clock() < deadline:
            time.sleep(min(0.2, self.drain_s or 0.2))
            try:
                cur = self._stream_seq(i)
            except Exception:  # noqa: BLE001
                return
            if cur == last:
                return
            last = cur

    def _check_rollbacks(self) -> list[dict[str, Any]]:
        """Reap grown actors that missed their spawn-grace heartbeat
        window and release their slots."""
        now = self._clock()
        with self._ex_lock:
            due = [i for i, t0 in self._ex_pending_grows.items()
                   if now - t0 >= self.spawn_grace_s]
            fresh = [i for i in self._ex_pending_grows if i not in due]
        out: list[dict[str, Any]] = []
        for i in due:
            if self._heartbeat_ok(i):
                with self._ex_lock:
                    self._ex_pending_grows.pop(i, None)
                continue
            self.sup.reap_actor(i)
            with self._ex_lock:
                self._ex_pending_grows.pop(i, None)
                self._ex_counts["rollbacks"] += 1
            log.warning("autoscale executor: rolled back actor %d "
                        "(no heartbeat within %.0fs)", i, self.spawn_grace_s)
            out.append({"action": "rollback", "rule": "spawn_grace",
                        "decision_t": 0.0, "from_n": 0, "to_n": 0,
                        "actor_id": i, "applied": 1,
                        "dry_run": int(self.dry_run),
                        "reason": "no heartbeat within spawn grace",
                        "t": now})
        # actors that heartbeated early graduate out of the pending set
        for i in fresh:
            if self._heartbeat_ok(i):
                with self._ex_lock:
                    self._ex_pending_grows.pop(i, None)
        return out

    # -- export --------------------------------------------------------------

    def gauges(self) -> dict[str, float]:
        out = {"autoscale/applied_actors": float(self.sup.fleet_size())}
        with self._ex_lock:
            for k, v in self._ex_counts.items():
                out[f"autoscale/{k}"] = float(v)
        return out
