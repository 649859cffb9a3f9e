"""Port: the health-driven autoscaler, its executor and the run-JSONL
provenance gate (``actors/autoscaler.py``, ``actors/executor.py``,
``telemetry_report.elastic_problems``).

Twin of ``tests/test_autoscaler.py`` on the port's copies (stdlib only):
verdict findings map to grow/shrink decisions, damped by per-dimension
cooldown and a recovery-streak hysteresis; every decision names its rule
and burn numbers, which ``elastic_problems`` gates on (both directions);
the executor's rate limit, dry run, graceful retirement, rollback and
skips against an ``ActorSupervisor``-shaped stub.

Added: one executor run against a real ``ActorSupervisor`` (spawned
lightweight workers through its ``target`` hook) and a real
``ReplayFeedServer``, wired by the supervisor's ``_bring_up_autoscaler``:
a grow graduates on heartbeat, a silent spawn rolls back, and a shrink
retires the highest id and evicts its dedup stamp. Every test carries a
deadline of its own.
"""

from __future__ import annotations

import signal
import time

import numpy as np
import pytest

from distributed_deep_q_tpu_torch import config as port_config
from distributed_deep_q_tpu_torch import health
from distributed_deep_q_tpu_torch.actors import supervisor as sup_mod
from distributed_deep_q_tpu_torch.actors.autoscaler import (
    RECOVERY_RULE, Autoscaler, Decision)
from distributed_deep_q_tpu_torch.actors.executor import ScaleExecutor
from distributed_deep_q_tpu_torch.health import HealthFinding, HealthVerdict
from distributed_deep_q_tpu_torch.replay.replay_memory import ReplayMemory
from distributed_deep_q_tpu_torch.rpc.replay_server import ReplayFeedServer
from distributed_deep_q_tpu_torch.telemetry_report import elastic_problems

TIMEOUT_S = 120


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


def _degraded(rule: str, **kw) -> HealthVerdict:
    f = HealthFinding(rule=rule, key=kw.pop("key", "k"),
                      value=kw.pop("value", 9.0),
                      target=kw.pop("target", 1.0),
                      burn_fast=kw.pop("burn_fast", 2.0),
                      burn_slow=kw.pop("burn_slow", 1.5), **kw)
    return HealthVerdict(status="degraded", findings=(f,))


OK = HealthVerdict()


def test_ingest_pressure_shrinks_actors_with_provenance():
    a = Autoscaler(min_actors=2, max_actors=8, step=2, cooldown_s=0.0)
    ds = a.observe(_degraded("member_unreachable", key="host-1",
                             member="host-1"), t=0.0)
    assert len(ds) == 1
    d = ds[0]
    assert d.action == "shrink_actors" and d.rule == "member_unreachable"
    assert (d.from_n, d.to_n) == (8, 6)
    assert d.member == "host-1"
    assert a.targets() == (6, 0)
    # the full SLO-pressure family maps to the same shrink verb
    for rule in ("ingest_shed", "credit_starvation", "flush_p99",
                 "staged_growth", "ingest_collapse"):
        ds = a.observe(_degraded(rule), t=100.0)
        assert ds and ds[0].action == "shrink_actors"
        assert ds[0].rule == rule
        a = Autoscaler(min_actors=2, max_actors=8, step=2, cooldown_s=0.0)


def test_shrink_clamps_at_min_actors():
    a = Autoscaler(min_actors=4, max_actors=5, step=3, cooldown_s=0.0)
    ds = a.observe(_degraded("ingest_shed"), t=0.0)
    assert ds[0].to_n == 4  # clamped, not 5 - 3
    # already at the floor: pressure produces NO decision (nothing to do)
    assert a.observe(_degraded("ingest_shed"), t=1.0) == []


def test_inference_pressure_grows_inference():
    a = Autoscaler(min_actors=1, max_actors=1, min_inference=1,
                   max_inference=4, cooldown_s=0.0)
    for i, rule in enumerate(("infer_latency", "infer_queue_growth",
                              "infer_shed")):
        ds = a.observe(_degraded(rule), t=float(i))
        assert ds and ds[0].action == "grow_inference"
        assert ds[0].rule == rule
    assert a.targets()[1] == 4  # clamped at max after three grows


def test_recovery_requires_consecutive_ok_streak():
    """Hysteresis: growth back needs ``recover_ticks`` CONSECUTIVE ok
    verdicts; one degraded tick resets the streak."""
    a = Autoscaler(min_actors=2, max_actors=8, step=2, cooldown_s=0.0,
                   recover_ticks=3)
    a.observe(_degraded("ingest_shed"), t=0.0)
    assert a.targets()[0] == 6
    assert a.observe(OK, t=1.0) == []
    assert a.observe(OK, t=2.0) == []
    a.observe(_degraded("ingest_shed"), t=3.0)  # streak reset + shrink
    assert a.targets()[0] == 4
    assert a.observe(OK, t=4.0) == []
    assert a.observe(OK, t=5.0) == []
    ds = a.observe(OK, t=6.0)  # third consecutive ok: grow
    assert len(ds) == 1
    d = ds[0]
    assert d.action == "grow_actors" and d.rule == RECOVERY_RULE
    assert (d.from_n, d.to_n) == (4, 6)
    assert d.value == 3.0 and d.target == 3.0  # provenance = the streak


def test_recovery_relaxes_inference_too():
    a = Autoscaler(min_actors=1, max_actors=1, min_inference=1,
                   max_inference=4, cooldown_s=0.0, recover_ticks=2)
    a.observe(_degraded("infer_shed"), t=0.0)
    assert a.targets() == (1, 2)
    a.observe(OK, t=1.0)
    ds = a.observe(OK, t=2.0)
    assert [d.action for d in ds] == ["shrink_inference"]
    assert a.targets() == (1, 1)


def test_cooldown_blocks_and_counts():
    a = Autoscaler(min_actors=1, max_actors=8, step=1, cooldown_s=10.0)
    assert a.observe(_degraded("ingest_shed"), t=0.0)  # fires
    assert a.observe(_degraded("ingest_shed"), t=5.0) == []  # blocked
    assert a.gauges()["autoscale/cooldown_blocked"] == 1.0
    assert a.observe(_degraded("ingest_shed"), t=10.0)  # cooldown over
    g = a.gauges()
    assert g["autoscale/decisions"] == 2.0 and g["autoscale/shrink"] == 2.0


def test_invalid_bounds_rejected():
    with pytest.raises(ValueError, match="min_actors"):
        Autoscaler(min_actors=5, max_actors=2)
    with pytest.raises(ValueError, match="min_inference"):
        Autoscaler(min_inference=3, max_inference=1)


def test_decision_jsonable_names_rule_and_burns():
    a = Autoscaler(min_actors=1, max_actors=4, cooldown_s=0.0)
    d = a.observe(_degraded("flush_p99", burn_fast=3.25,
                            burn_slow=1.75), t=2.0)[0].to_jsonable()
    assert d["rule"] == "flush_p99"
    assert d["burn_fast"] == 3.25 and d["burn_slow"] == 1.75
    assert d["action"] == "shrink_actors"
    assert d["from_n"] == 4 and d["to_n"] == 3 and d["t"] == 2.0


# -- elastic_problems: the provenance gate -----------------------------------


def _decision_dict(**over) -> dict:
    base = Decision(action="shrink_actors", rule="ingest_shed", key="k",
                    member="", value=1.0, target=0.5, burn_fast=2.0,
                    burn_slow=1.0, from_n=4, to_n=3, t=0.0).to_jsonable()
    base.update(over)
    return base


def test_elastic_problems_clean_run_passes():
    records = [
        {"step": 0, "fleet/handoff_lost_rows": 0.0},
        {"step": 1, "autoscale/decision": [_decision_dict()]},
    ]
    assert elastic_problems(records) == []


def test_elastic_problems_flags_lost_handoff_rows():
    probs = elastic_problems([{"step": 0,
                               "fleet/handoff_lost_rows": 3.0}])
    assert len(probs) == 1 and "lost 3" in probs[0]


def test_elastic_problems_flags_unnamed_decision():
    probs = elastic_problems(
        [{"step": 0, "autoscale/decision": [_decision_dict(rule="")]}])
    assert len(probs) == 1 and "without a named rule" in probs[0]


def test_elastic_problems_flags_missing_burn_numbers():
    probs = elastic_problems(
        [{"step": 0,
          "autoscale/decision": [_decision_dict(burn_fast=None)]}])
    assert len(probs) == 1 and "missing burn numbers" in probs[0]


# -- ScaleExecutor: the acting half of the loop -------------------------------

class _FakeFleet:
    """ActorSupervisor-shaped stub: an id set, no processes."""

    def __init__(self, n: int):
        self.ids = list(range(n))
        self.reaped: list[int] = []

    def fleet_size(self) -> int:
        return len(self.ids)

    def actor_ids(self) -> list[int]:
        return sorted(self.ids)

    def grow(self) -> int:
        i = max(self.ids) + 1 if self.ids else 0
        self.ids.append(i)
        return i

    def retire(self, i: int) -> bool:
        if i not in self.ids:
            return False
        self.ids.remove(i)
        return True

    def reap_actor(self, i: int) -> bool:
        self.reaped.append(i)
        return self.retire(i)


def _dec(action: str, from_n: int, to_n: int,
         rule: str = "ingest_shed", t: float = 1.0) -> Decision:
    return Decision(action=action, rule=rule, key="rpc/shed_flushes",
                    member="replay", value=9.0, target=0.0,
                    burn_fast=2.0, burn_slow=1.5,
                    from_n=from_n, to_n=to_n, t=t)


def test_executor_shrink_retires_highest_and_evicts_stamp():
    sup = _FakeFleet(3)
    evicted: list[int] = []
    seqs: list[int] = []

    def seq_of(i: int) -> int:
        seqs.append(i)
        return 7  # quiet stream: first re-poll matches, drain exits

    ex = ScaleExecutor(sup, rate_limit_s=0.0, drain_s=0.3,
                       stream_seq=seq_of, retire_stream=evicted.append)
    out = ex.apply([_dec("shrink_actors", 3, 2)])
    assert len(out) == 1
    f = out[0]
    assert f["action"] == "retire" and f["applied"] == 1
    assert f["actor_id"] == 2 and f["rule"] == "ingest_shed"
    assert f["decision_t"] == 1.0  # provenance back to the Decision
    assert sup.actor_ids() == [0, 1]
    assert evicted == [2]  # dedup stamp evicted AFTER the terminate
    assert seqs.count(2) >= 2  # drained: seq polled until stable
    g = ex.gauges()
    assert g["autoscale/applied_actors"] == 2.0
    assert g["autoscale/retirements"] == 1.0


def test_executor_rate_limits_action_bursts():
    sup = _FakeFleet(4)
    ex = ScaleExecutor(sup, rate_limit_s=60.0, drain_s=0.0)
    out = ex.apply([_dec("shrink_actors", 4, 3),
                    _dec("shrink_actors", 3, 2)])
    assert [f["action"] for f in out] == ["retire", "skip"]
    assert out[1]["reason"] == "rate limited"
    assert sup.fleet_size() == 3  # only the first action moved the fleet
    assert ex.gauges()["autoscale/rate_limited"] == 1.0


def test_executor_dry_run_touches_nothing():
    sup = _FakeFleet(3)
    ex = ScaleExecutor(sup, rate_limit_s=0.0, drain_s=0.0, dry_run=True)
    out = ex.apply([_dec("shrink_actors", 3, 2),
                    _dec("grow_actors", 3, 4, rule=RECOVERY_RULE)])
    assert all(f["dry_run"] == 1 and f["applied"] == 0 for f in out)
    assert sup.actor_ids() == [0, 1, 2]
    assert ex.gauges()["autoscale/applied_actions"] == 0.0


def test_executor_grow_rolls_back_silent_spawn():
    sup = _FakeFleet(2)
    now = [0.0]
    ex = ScaleExecutor(sup, rate_limit_s=0.0, drain_s=0.0,
                       spawn_grace_s=10.0, heartbeat_ok=lambda i: False,
                       clock=lambda: now[0])
    out = ex.apply([_dec("grow_actors", 2, 3, rule=RECOVERY_RULE)])
    assert out[0]["action"] == "grow" and out[0]["applied"] == 1
    assert sup.fleet_size() == 3
    now[0] = 11.0  # grace window expires with no heartbeat
    out = ex.apply([])
    assert [f["action"] for f in out] == ["rollback"]
    assert out[0]["rule"] == "spawn_grace" and out[0]["actor_id"] == 2
    assert sup.reaped == [2] and sup.fleet_size() == 2
    assert ex.gauges()["autoscale/rollbacks"] == 1.0


def test_executor_grow_graduates_on_heartbeat():
    sup = _FakeFleet(2)
    now = [0.0]
    ex = ScaleExecutor(sup, rate_limit_s=0.0, drain_s=0.0,
                       spawn_grace_s=10.0, heartbeat_ok=lambda i: True,
                       clock=lambda: now[0])
    ex.apply([_dec("grow_actors", 2, 3, rule=RECOVERY_RULE)])
    now[0] = 11.0
    assert ex.apply([]) == []  # heartbeated: no rollback finding
    assert sup.fleet_size() == 3
    assert ex.gauges()["autoscale/rollbacks"] == 0.0


def test_executor_skips_satisfied_and_foreign_decisions():
    sup = _FakeFleet(3)
    ex = ScaleExecutor(sup, rate_limit_s=0.0, drain_s=0.0)
    out = ex.apply([_dec("grow_actors", 2, 3, rule=RECOVERY_RULE),
                    _dec("grow_inference", 1, 2)])
    assert [f["action"] for f in out] == ["skip", "skip"]
    assert "at or above target" in out[0]["reason"]
    assert "inference" in out[1]["reason"]
    assert sup.fleet_size() == 3
    assert ex.gauges()["autoscale/skipped"] == 2.0


# -- the executor against a real supervisor and replay server ----------------

SILENT_ID = 3  # the one worker that never makes contact


def _feeding_worker(cfg, host, port, actor_id, stop):
    """A light stand-in for ``actor_main`` (the supervisor's ``target``
    hook): lands one stamped flush on its stream, then heartbeats until
    its private stop event is set. Worker ``SILENT_ID`` never connects."""
    if actor_id == SILENT_ID:
        stop.wait(60)
        return
    from distributed_deep_q_tpu_torch.rpc.resilience import (
        ResilientReplayFeedClient)

    client = ResilientReplayFeedClient.connect(
        host, port, actor_id=actor_id, timeout=10.0,
        should_abort=stop.is_set, seed=actor_id)
    try:
        rows = np.full((4, 4), actor_id, np.float32)
        client.add_transitions(obs=rows, action=np.zeros(4, np.int32),
                               reward=np.ones(4, np.float32),
                               next_obs=rows,
                               discount=np.full(4, 0.99, np.float32))
        while not stop.wait(0.1):
            client.call("heartbeat")
    except (ConnectionError, OSError):
        pass
    finally:
        client.close()


def _wait_for(pred, what: str, timeout: float = 60.0) -> None:
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.05)


def test_executor_drives_a_real_supervisor_and_replay_server():
    cfg = port_config.cartpole_config()
    cfg.actors.num_actors = 2
    cfg.health.enabled = True
    cfg.autoscale.enabled = True
    cfg.autoscale.execute = True
    cfg.autoscale.rate_limit_s = 0.0
    cfg.autoscale.drain_s = 0.5
    cfg.autoscale.spawn_grace_s = 10.0
    server = ReplayFeedServer(ReplayMemory(1024, (4,), np.float32))
    host, port = server.address
    sup = sup_mod.ActorSupervisor(cfg, host, port, target=_feeding_worker)
    health.configure_from(cfg.health)
    now = [0.0]
    try:
        sup.start()
        scaler, ex = sup_mod._bring_up_autoscaler(cfg, sup, server)
        assert isinstance(scaler, Autoscaler)
        ex._clock = lambda: now[0]   # the grace window on a test clock
        _wait_for(lambda: all(server.stream_seq_of(i) >= 0 for i in (0, 1)),
                  "the boot workers' flushes")

        # a grow graduates once the new worker heartbeats
        out = ex.apply([_dec("grow_actors", 2, 3, rule=RECOVERY_RULE)])
        assert [f["action"] for f in out] == ["grow"]
        assert out[0]["actor_id"] == 2 and out[0]["applied"] == 1
        _wait_for(lambda: server.stream_seq_of(2) >= 0,
                  "the grown worker's flush")
        _wait_for(lambda: server.last_seen.get(2, 0.0)
                  > sup.spawned_at[2], "the grown worker's heartbeat")
        now[0] = 11.0
        assert ex.apply([]) == []            # graduated: no rollback
        assert sup.actor_ids() == [0, 1, 2]

        # a silent spawn rolls back when its grace window runs out
        out = ex.apply([_dec("grow_actors", 3, 4, rule=RECOVERY_RULE,
                             t=11.0)])
        assert out[0]["action"] == "grow" and out[0]["actor_id"] == SILENT_ID
        silent = sup.procs[SILENT_ID]
        now[0] = 22.0
        out = ex.apply([])
        assert [f["action"] for f in out] == ["rollback"]
        assert out[0]["rule"] == "spawn_grace"
        assert out[0]["actor_id"] == SILENT_ID
        assert sup.actor_ids() == [0, 1, 2] and not silent.is_alive()
        assert ex.gauges()["autoscale/rollbacks"] == 1.0

        # a shrink retires the highest id and evicts its dedup stamp
        victim = sup.procs[2]
        out = ex.apply([_dec("shrink_actors", 3, 2, t=22.0)])
        assert [f["action"] for f in out] == ["retire"]
        assert out[0]["actor_id"] == 2 and out[0]["applied"] == 1
        assert sup.actor_ids() == [0, 1] and not victim.is_alive()
        assert server.stream_seq_of(2) == -1
        assert server.stream_seq_of(0) >= 0 and server.stream_seq_of(1) >= 0
        assert sup.executor_terminations == 2   # the rollback and the retire
        assert sup.kill_escalations == 0 and sup.restarts == 0
        g = ex.gauges()
        assert g["autoscale/applied_actors"] == 2.0
        assert g["autoscale/retirements"] == 1.0
        assert g["autoscale/applied_actions"] == 3.0
    finally:
        health.disable()
        sup.stop()
        server.close()
    assert not any(p.is_alive() for p in sup.procs.values())
