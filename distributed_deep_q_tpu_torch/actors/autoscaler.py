"""Health-driven autoscaler — the control loop on the health plane (port
of the reference's ``actors/autoscaler.py``; stdlib only).

The health plane reduces fleet state to one machine-readable
``HealthVerdict``. This module closes the loop:
``Autoscaler.observe(verdict)`` consumes the verdict's findings — rule
name, key, value/target, fast/slow burn rates — and emits grow/shrink
``Decision``s for actor and inference capacity.

The mapping is deliberately small and legible (the README table is
generated from these tuples):

- ingest pressure (``ingest_shed``, ``credit_starvation``,
  ``flush_p99``, ``staged_growth``, ``ingest_collapse``) or a lost
  member (``member_unreachable``) → SHRINK the actor fleet toward
  ``min_actors``: fewer producers protect the surviving ingest path
  while the fleet heals.
- inference pressure (``infer_latency``, ``infer_queue_growth``,
  ``infer_shed``) → GROW inference capacity toward ``max_inference``.
- a sustained-ok streak (``recover_ticks`` consecutive ok verdicts) →
  GROW actors back toward ``max_actors`` and relax inference toward
  ``min_inference`` (rule name ``capacity_recovered``).

Two dampers stop decision flapping, mirroring the hysteresis already
inside the health rules themselves:

- per-dimension COOLDOWN: after any decision on a dimension, further
  decisions on it are blocked for ``cooldown_s`` (counted in
  ``autoscale/cooldown_blocked``).
- recovery HYSTERESIS: growth requires ``recover_ticks`` consecutive
  ok verdicts; one degraded tick resets the streak.

Every decision is lineage-traceable: ``Decision.to_jsonable()`` names
the rule and carries the exact burn numbers that triggered it, and the
supervisor writes the list into the run JSONL under
``autoscale/decision`` — ``telemetry_report.elastic_problems`` flags any run
where a decision fired without that provenance.

The scaler only DECIDES; executing a decision is the operator's (or the
churn harness's) job — the same boundary the health plane draws between
verdict and remediation.
"""

from __future__ import annotations

import math
import threading
import time
from dataclasses import dataclass
from typing import Any

SHRINK_ACTOR_RULES = ("ingest_shed", "credit_starvation", "flush_p99",
                      "staged_growth", "ingest_collapse",
                      "member_unreachable")
GROW_INFERENCE_RULES = ("infer_latency", "infer_queue_growth", "infer_shed")
RECOVERY_RULE = "capacity_recovered"


def _num(v: Any) -> float:
    try:
        f = float(v)
    except (TypeError, ValueError):
        return 0.0
    return f if math.isfinite(f) else 0.0


@dataclass(frozen=True)
class Decision:
    """One grow/shrink decision with full provenance."""

    action: str      # grow_actors | shrink_actors | grow_inference | ...
    rule: str        # health rule (or RECOVERY_RULE) that triggered it
    key: str         # metric key the rule watched ("" for recovery)
    member: str      # fleet member the finding came from ("" if fleet-wide)
    value: float     # observed value / streak length
    target: float    # rule target / required streak
    burn_fast: float
    burn_slow: float
    from_n: int
    to_n: int
    t: float

    def to_jsonable(self) -> dict[str, Any]:
        return {
            "action": self.action, "rule": self.rule, "key": self.key,
            "member": self.member, "value": self.value,
            "target": self.target, "burn_fast": self.burn_fast,
            "burn_slow": self.burn_slow, "from_n": self.from_n,
            "to_n": self.to_n, "t": self.t,
        }


class Autoscaler:
    """Verdict → capacity decisions with hysteresis and cooldown.

    Thread-safe: all state moves under ``_as_lock`` (the supervisor's
    health tick calls ``observe`` while gauge readers race it)."""

    def __init__(self, min_actors: int = 1, max_actors: int = 1,
                 min_inference: int = 0, max_inference: int = 0,
                 step: int = 1, cooldown_s: float = 30.0,
                 recover_ticks: int = 3):
        if min_actors > max_actors:
            raise ValueError("min_actors exceeds max_actors")
        if min_inference > max_inference:
            raise ValueError("min_inference exceeds max_inference")
        self.min_actors = int(min_actors)
        self.max_actors = int(max_actors)
        self.min_inference = int(min_inference)
        self.max_inference = int(max_inference)
        self.step = max(1, int(step))
        self.cooldown_s = float(cooldown_s)
        self.recover_ticks = max(1, int(recover_ticks))
        # RLock: the decide/cooldown helpers re-acquire under observe()
        self._as_lock = threading.RLock()
        # start at full capacity: the boot fleet IS max until the health
        # plane says otherwise
        self._as_target_actors = self.max_actors
        self._as_target_inference = self.min_inference
        self._as_ok_streak = 0
        self._as_last_at = {"actors": float("-inf"),
                            "inference": float("-inf")}
        self._as_counts = {"decisions": 0, "grow": 0, "shrink": 0,
                           "cooldown_blocked": 0}

    # -- internals (call with _as_lock held) --------------------------------

    def _cooled(self, dim: str, t: float) -> bool:
        with self._as_lock:
            if t - self._as_last_at[dim] >= self.cooldown_s:
                return True
            self._as_counts["cooldown_blocked"] += 1
            return False

    def _decide(self, dim: str, action: str, to_n: int, finding,
                streak: int, t: float) -> Decision:
        with self._as_lock:
            self._as_last_at[dim] = t
            self._as_counts["decisions"] += 1
            self._as_counts["grow" if action.startswith("grow") else
                            "shrink"] += 1
            from_n = (self._as_target_actors if dim == "actors"
                      else self._as_target_inference)
            if dim == "actors":
                self._as_target_actors = to_n
            else:
                self._as_target_inference = to_n
        if finding is None:  # recovery path: provenance is the streak
            return Decision(action=action, rule=RECOVERY_RULE, key="",
                            member="", value=float(streak),
                            target=float(self.recover_ticks),
                            burn_fast=0.0, burn_slow=0.0,
                            from_n=from_n, to_n=to_n, t=t)
        return Decision(action=action, rule=finding.rule,
                        key=finding.key, member=finding.member or "",
                        value=_num(finding.value),
                        target=_num(finding.target),
                        burn_fast=_num(finding.burn_fast),
                        burn_slow=_num(finding.burn_slow),
                        from_n=from_n, to_n=to_n, t=t)

    # -- public surface -----------------------------------------------------

    def observe(self, verdict, t: float | None = None) -> list[Decision]:
        """Fold one fleet verdict into the targets; returns the
        decisions (possibly empty) this tick produced."""
        t = time.monotonic() if t is None else float(t)
        findings = list(getattr(verdict, "findings", ()) or ())
        shrink_f = next((f for f in findings
                         if f.rule in SHRINK_ACTOR_RULES), None)
        infer_f = next((f for f in findings
                        if f.rule in GROW_INFERENCE_RULES), None)
        out: list[Decision] = []
        with self._as_lock:
            if getattr(verdict, "ok", False):
                self._as_ok_streak += 1
            else:
                self._as_ok_streak = 0
            recovered = self._as_ok_streak >= self.recover_ticks
            # actor dimension
            if shrink_f is not None:
                to_n = max(self.min_actors,
                           self._as_target_actors - self.step)
                if to_n < self._as_target_actors and self._cooled(
                        "actors", t):
                    out.append(self._decide("actors", "shrink_actors",
                                            to_n, shrink_f, 0, t))
            elif recovered and self._as_target_actors < self.max_actors:
                to_n = min(self.max_actors,
                           self._as_target_actors + self.step)
                if self._cooled("actors", t):
                    out.append(self._decide("actors", "grow_actors", to_n,
                                            None, self._as_ok_streak, t))
            # inference dimension
            if infer_f is not None:
                to_n = min(self.max_inference,
                           self._as_target_inference + self.step)
                if to_n > self._as_target_inference and self._cooled(
                        "inference", t):
                    out.append(self._decide(
                        "inference", "grow_inference", to_n, infer_f,
                        0, t))
            elif recovered and \
                    self._as_target_inference > self.min_inference:
                to_n = max(self.min_inference,
                           self._as_target_inference - self.step)
                if self._cooled("inference", t):
                    out.append(self._decide(
                        "inference", "shrink_inference", to_n, None,
                        self._as_ok_streak, t))
        return out

    def targets(self) -> tuple[int, int]:
        with self._as_lock:
            return self._as_target_actors, self._as_target_inference

    def gauges(self) -> dict[str, float]:
        """``autoscale/*`` gauges for the supervisor's metrics tick."""
        with self._as_lock:
            return {
                "autoscale/target_actors": float(self._as_target_actors),
                "autoscale/target_inference":
                    float(self._as_target_inference),
                "autoscale/decisions":
                    float(self._as_counts["decisions"]),
                "autoscale/grow": float(self._as_counts["grow"]),
                "autoscale/shrink": float(self._as_counts["shrink"]),
                "autoscale/cooldown_blocked":
                    float(self._as_counts["cooldown_blocked"]),
            }
