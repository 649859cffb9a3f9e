"""The port's chaos tool (``distributed_deep_q_tpu_torch/chaos_smoke.py``)
against the reference's ``scripts/chaos_smoke.py``.

- Every one of the 11 modes runs on the CPU at the reference's sizes (the
  functions' defaults; the ``train`` mode's run cut to 300 grad steps by
  its own overrides) and its verdict is ``ok``. The device modes take
  ``device="cpu"``.
- The host-only modes' verdicts carry exactly the reference's keys, the
  reference run at the same size; the device modes' carry the reference's
  keys and a few of their own.
- The two packages' wires interoperate under chaos: the reference's
  resilient clients under the reference's chaos plan stream into the
  port's server, and the port's clients into the reference's; both
  ledgers are exactly-once.
- Three planted faults each turn their gate to not-ok: the flush-seq
  dedup bypassed (default mode: duplicated), a staged row dropped at the
  flush (``ingest``: lost), one served row's action crossed
  (``inference``: wrong).
- The device modes refuse a CUDA device without a card.

The chaos shim, the health plane's module settings and the tracer are
process globals: every test resets them in a ``finally`` (the autouse
fixture), so a mode cannot leak into the next test on the same worker.
Every test has a SIGALRM deadline of its own; the modes that spawn
processes (``tenants`` arc 2, ``train``) stop them before they return.
"""

from __future__ import annotations

import importlib.util
import os
import signal
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from distributed_deep_q_tpu_torch import chaos_smoke

REPO = Path(__file__).resolve().parent.parent
TIMEOUT_S = 240


def _load_reference():
    spec = importlib.util.spec_from_file_location(
        "_ref_chaos_smoke", REPO / "scripts" / "chaos_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reset_globals() -> None:
    from distributed_deep_q_tpu import health as ref_health
    from distributed_deep_q_tpu import tracing as ref_tracing
    from distributed_deep_q_tpu.rpc import faultinject as ref_fi

    from distributed_deep_q_tpu_torch import health, tracing
    from distributed_deep_q_tpu_torch.rpc import faultinject

    for fi in (faultinject, ref_fi):
        fi.uninstall()
    for h in (health, ref_health):
        h.reset()
    for t in (tracing, ref_tracing):
        t.reset()
        t.disable()


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    """A deadline per test, and the process globals reset after it."""
    from distributed_deep_q_tpu.rpc import faultinject as ref_fi

    from distributed_deep_q_tpu_torch.rpc import faultinject

    for fi in (faultinject, ref_fi):
        monkeypatch.delenv(fi.ENV_VAR, raising=False)

    def expire(signum, frame):
        raise TimeoutError(f"test exceeded its {TIMEOUT_S} s deadline")

    prev = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, TIMEOUT_S)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, prev)
        _reset_globals()


HOST_ONLY = {
    "default": "run_chaos_smoke",
    "overload": "run_overload_smoke",
    "health": "run_health_smoke",
    "learn": "run_learn_divergence_smoke",
    "durability": "run_durability_smoke",
    "churn": "run_churn_smoke",
}


# a smaller size per host-only mode, for the key comparison (both packages
# run it): the keys do not depend on the size, the run time does. The
# overload mode runs at the reference's 40 flushes: its ``ok`` needs a
# shed, and at 10 flushes a loaded host can land every row before the
# consumer reports the rate that the shed rule reads
SMALL = {"default": dict(flushes=20), "overload": dict(flushes=40),
         "health": {}, "learn": {}, "durability": dict(cycles=3),
         "churn": dict(flushes=40)}


# modes whose ``ok`` rests on how the threads of one interpreter
# interleave run through their command line, in an interpreter of their
# own: the overload mode's sheds need an actor to flush out of turn, and
# the threads earlier tests leave in a worker serialize its actors into
# turns, which the "fair" policy never sheds (ROADMAP §C, C6)
OWN_INTERPRETER = {"overload"}


def _verdict_in_own_interpreter(cmd: list[str]) -> dict:
    """Run a chaos tool's command line in a fresh interpreter and return
    its one JSON verdict line."""
    import json
    import subprocess

    proc = subprocess.run(
        [sys.executable] + cmd, capture_output=True, text=True,
        timeout=TIMEOUT_S - 20, cwd=REPO,
        env={**os.environ, "OMP_NUM_THREADS": "2"})
    lines = proc.stdout.strip().splitlines()
    assert lines, proc.stderr[-3000:]
    return json.loads(lines[-1])


@pytest.mark.parametrize("mode", sorted(HOST_ONLY))
def test_host_only_mode_ok_at_the_references_size(mode):
    """The host-only modes at the reference's sizes: ``ok``, and nothing
    lost, duplicated or wrong."""
    if mode in OWN_INTERPRETER:
        v = _verdict_in_own_interpreter(
            ["-m", "distributed_deep_q_tpu_torch.chaos_smoke", mode])
    else:
        v = getattr(chaos_smoke, HOST_ONLY[mode])()
    assert v["ok"], v
    for key in ("lost", "duplicated", "wrong_actions", "critical_flaps"):
        if key in v:
            assert v[key] == 0, (key, v)


@pytest.mark.parametrize("mode", sorted(HOST_ONLY))
def test_host_only_mode_keys_equal_the_references(mode):
    """The host-only modes' verdicts carry exactly the reference's keys,
    both packages run at the same size."""
    fn, kw = HOST_ONLY[mode], SMALL[mode]
    if mode in OWN_INTERPRETER:
        # the command lines run the functions' defaults, this case's size
        assert kw == {"flushes": 40}
        got = _verdict_in_own_interpreter(
            ["-m", "distributed_deep_q_tpu_torch.chaos_smoke", mode])
        want = _verdict_in_own_interpreter(
            [str(REPO / "scripts" / "chaos_smoke.py"), mode])
    else:
        got = getattr(chaos_smoke, fn)(**kw)
        _reset_globals()
        want = getattr(_load_reference(), fn)(**kw)
    assert got["ok"] and want["ok"], (got, want)
    assert set(got) == set(want), set(got) ^ set(want)


# the reference's keys of each device mode, as its source returns them
# (the reference's device modes run jax, so they are not run here)
DEVICE_KEYS = {
    "run_ingest_saturation_smoke": {
        "ok", "num_actors", "transitions_sent", "transitions_stored", "lost",
        "duplicated", "corrupt_rows", "shed_flushes", "client_sheds",
        "drained_rows", "drain_flushes", "rows_left_staged",
        "duplicate_flushes_absorbed", "consume_rate_cap", "chaos_spec",
        "faults_fired", "hung_actors", "errors", "wall_s", "trace"},
    "run_inference_chaos_smoke": {
        "ok", "num_clients", "requests_sent", "replies", "wrong_actions",
        "missing_actions", "client_sheds", "server_requests", "server_sheds",
        "server_wire_errors", "compiled_buckets", "chaos_spec",
        "faults_fired", "hung_clients", "errors", "wall_s", "trace"},
    "run_vector_chaos_smoke": {
        "ok", "num_envs", "ticks", "actions_checked", "wrong_actions",
        "missing_actions", "duplicated_ticks", "kill_tick", "client_sheds",
        "retry_events", "reboot_server_requests", "chaos_spec",
        "faults_fired", "hung", "errors", "wall_s", "trace"},
}


# the device modes run in an interpreter of their own, by their command
# line's mode: the ingest mode's sheds need an actor out of turn, as the
# overload mode's do (``OWN_INTERPRETER``; ROADMAP §C, C6)
DEVICE_OWN_INTERPRETER = {"run_ingest_saturation_smoke": "ingest"}


@pytest.mark.parametrize("fn", sorted(DEVICE_KEYS))
def test_device_mode_ok_on_the_cpu(fn):
    if fn in DEVICE_OWN_INTERPRETER:
        v = _verdict_in_own_interpreter(
            ["-m", "distributed_deep_q_tpu_torch.chaos_smoke",
             DEVICE_OWN_INTERPRETER[fn], "--device", "cpu"])
    else:
        v = getattr(chaos_smoke, fn)(device="cpu")
    assert v["ok"], v
    assert DEVICE_KEYS[fn] <= set(v), DEVICE_KEYS[fn] - set(v)
    assert v["device"] == "cpu"
    for key in ("lost", "duplicated", "corrupt_rows", "wrong_actions",
                "missing_actions", "duplicated_ticks"):
        if key in v:
            assert v[key] == 0, (key, v)


def test_device_mode_keys_are_the_references():
    """``DEVICE_KEYS`` is what the reference's source returns: every key
    literal of each function's verdict dict, read from its text."""
    import ast

    tree = ast.parse((REPO / "scripts" / "chaos_smoke.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and node.name in DEVICE_KEYS:
            keys = set()
            for sub in ast.walk(node):
                if isinstance(sub, ast.Dict) and any(
                        isinstance(k, ast.Constant) and k.value == "ok"
                        for k in sub.keys):
                    keys |= {k.value for k in sub.keys
                             if isinstance(k, ast.Constant)}
                if isinstance(sub, ast.Subscript) and isinstance(
                        sub.value, ast.Name) and sub.value.id == "verdict" \
                        and isinstance(sub.slice, ast.Constant):
                    keys.add(sub.slice.value)
            assert keys == DEVICE_KEYS[node.name], (
                node.name, keys ^ DEVICE_KEYS[node.name])


def test_tenants_mode_ok_on_the_cpu():
    """Both arcs: the degrade ladder in strict order with every reply the
    right arm's action, then the executor retiring and regrowing a real
    actor process, exactly-once.

    The mode runs in an interpreter of its own (its command line), so
    the threads and the heap that earlier tests leave in this worker
    share neither its interpreter lock nor its collections: its SLO
    windows time its own servers only (ROADMAP §C, C5)."""
    import json
    import subprocess

    proc = subprocess.run(
        [sys.executable, "-m", "distributed_deep_q_tpu_torch.chaos_smoke",
         "tenants", "--device", "cpu"], capture_output=True, text=True,
        timeout=TIMEOUT_S - 20, cwd=REPO,
        env={**os.environ, "OMP_NUM_THREADS": "2"})
    lines = proc.stdout.strip().splitlines()
    assert lines, proc.stderr[-3000:]
    v = json.loads(lines[-1])
    assert v["ok"], {k: v[k] for k in v if k not in ("decisions",
                                                     "applied")}
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert [e["class"] for e in v["ladder_ledger"]] == [
        "shadow", "ab", "primary"]
    assert v["wrong_actions"] == v["duplicated"] == 0
    assert v["executor_terminations"] == 1 and v["kill_escalations"] == 0


def test_tenants_mode_runs_with_the_inherited_heap_frozen():
    """``_frozen_heap`` freezes the heap before the mode and thaws it
    after, also when the mode raises; a heap frozen before stays frozen;
    the tenants mode carries it."""
    import gc

    seen = []

    @chaos_smoke._frozen_heap
    def mode(fail: bool):
        seen.append(gc.get_freeze_count())
        if fail:
            raise RuntimeError("planted")
        return "ran"

    gc.unfreeze()
    try:
        assert mode(False) == "ran"
        with pytest.raises(RuntimeError, match="planted"):
            mode(True)
        assert len(seen) == 2 and min(seen) > 0
        assert gc.get_freeze_count() == 0
        # frozen objects leave the count as they are freed, so a heap
        # frozen before reads as "still frozen", not as a count
        gc.freeze()
        assert mode(False) == "ran"
        assert gc.get_freeze_count() > 0
    finally:
        gc.unfreeze()
    assert chaos_smoke.run_tenants_smoke.__wrapped__.__wrapped__.__name__ \
        == "run_tenants_smoke"


def test_train_mode_on_the_cpu(capsys):
    """``train_distributed`` on CartPole under the fleet's wire chaos
    (the reference's spec and configuration, 300 grad steps): the
    reference's robustness counters, no kill escalation."""
    pytest.importorskip("gymnasium")
    out = chaos_smoke.run_train_chaos(
        ["train.total_steps=300", "replay.learn_start=200"], device="cpu")
    assert set(out) == {"env_steps", "final_return_avg100",
                        "actor_restarts", "actor_kill_escalations",
                        "rpc_dispatch_errors", "rpc_duplicate_flushes"}
    assert out["env_steps"] > 200
    assert out["actor_kill_escalations"] == 0
    assert "override train.total_steps=300" in capsys.readouterr().out
    # the spec reached the fleet through this process's environment,
    # which the mode restores: nothing after it runs under chaos
    from distributed_deep_q_tpu_torch.rpc import faultinject
    import os
    assert faultinject.ENV_VAR not in os.environ
    assert faultinject.active() is None


@pytest.mark.parametrize("fn", ["run_ingest_saturation_smoke",
                                "run_inference_chaos_smoke",
                                "run_vector_chaos_smoke",
                                "run_tenants_smoke"])
def test_device_modes_refuse_cuda_without_a_card(fn, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=r"is_available\(\) is false"):
        getattr(chaos_smoke, fn)(device="cuda")


def test_train_mode_refuses_cuda_without_a_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=r"is_available\(\) is false"):
        chaos_smoke.run_train_chaos([], device="cuda")


# -- the wires of the two packages under chaos -------------------------------


def _stream_into(server_mod, replay_mod, client_mod, fi_mod, spec: str,
                 num_actors: int = 3, flushes: int = 40, rows: int = 8):
    """``num_actors`` resilient clients of ``client_mod`` under
    ``fi_mod``'s chaos plan stream labeled rows into a server of
    ``server_mod``; returns (lost, duplicated, faults fired)."""
    replay = replay_mod.ReplayMemory(4096, (2,), np.float32, seed=0)
    server = server_mod.ReplayFeedServer(replay)
    plan = fi_mod.install(spec)
    host, port = server.address
    errors: list[str] = []

    def actor(aid: int) -> None:
        try:
            c = client_mod.ResilientReplayFeedClient.connect(
                host, port, actor_id=aid, seed=100 + aid,
                policy=client_mod.RetryPolicy(base_delay=0.01, max_delay=0.2,
                                              deadline=60.0))
            for f in range(flushes):
                ids = aid * 1_000_000 + f * 1_000 + np.arange(
                    rows, dtype=np.float32)
                obs = np.stack([ids, ids], axis=1)
                c.add_transitions(obs=obs, action=np.zeros(rows, np.int32),
                                  reward=np.zeros(rows, np.float32),
                                  next_obs=obs,
                                  discount=np.ones(rows, np.float32))
            c.close()
        except Exception as e:  # noqa: BLE001 — asserted below
            errors.append(f"actor {aid}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=actor, args=(a,), daemon=True)
               for a in range(num_actors)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    fi_mod.uninstall()
    server.close()
    assert not errors and not any(t.is_alive() for t in threads), errors
    expected = {a * 1_000_000 + f * 1_000 + r for a in range(num_actors)
                for f in range(flushes) for r in range(rows)}
    observed = replay.obs[:len(replay), 0].astype(np.int64).tolist()
    return (len(expected - set(observed)),
            len(observed) - len(set(observed)), dict(plan.counters))


@pytest.mark.parametrize("clients", ["reference", "port"])
def test_wires_interoperate_exactly_once_under_chaos(clients):
    from distributed_deep_q_tpu.replay import replay_memory as ref_rm
    from distributed_deep_q_tpu.rpc import faultinject as ref_fi
    from distributed_deep_q_tpu.rpc import replay_server as ref_srv
    from distributed_deep_q_tpu.rpc import resilience as ref_res

    from distributed_deep_q_tpu_torch.replay import replay_memory as rm
    from distributed_deep_q_tpu_torch.rpc import faultinject as fi
    from distributed_deep_q_tpu_torch.rpc import replay_server as srv
    from distributed_deep_q_tpu_torch.rpc import resilience as res

    spec = "drop=0.03,truncate=0.02,seed=11"   # the default mode's plan
    if clients == "reference":
        lost, dup, fired = _stream_into(srv, rm, ref_res, ref_fi, spec)
    else:
        lost, dup, fired = _stream_into(ref_srv, ref_rm, res, fi, spec)
    assert sum(fired.values()) > 0, fired
    assert lost == 0 and dup == 0, (lost, dup)


# -- planted faults -------------------------------------------------------------


class _Forgetful(dict):
    """A flush-seq map that never remembers a seq: the dedup bypassed."""

    def get(self, key, default=None):
        return default


def test_planted_dedup_bypass_fails_the_default_gate(monkeypatch):
    from distributed_deep_q_tpu_torch.rpc.replay_server import (
        ReplayFeedServer)

    monkeypatch.setattr(ReplayFeedServer, "_flush_seq", property(
        lambda self: self.__dict__["_fs"],
        lambda self, v: self.__dict__.__setitem__("_fs", _Forgetful(v))),
        raising=False)
    v = chaos_smoke.run_chaos_smoke()
    assert not v["ok"] and v["duplicated"] > 0, v


def test_planted_dropped_row_fails_the_ingest_gate(monkeypatch):
    from distributed_deep_q_tpu_torch.replay.device_ring import (
        DeviceFrameReplay)

    orig = DeviceFrameReplay._apply_write
    dropped = []

    def drop_one(self, idx, cols):
        real = np.argwhere(idx < self.cap_local)
        if not dropped and len(real):
            s, j = real[0]
            idx = idx.copy()
            idx[s, j] = self.cap_local      # the lane becomes padding
            dropped.append((int(s), int(j)))
        return orig(self, idx, cols)

    monkeypatch.setattr(DeviceFrameReplay, "_apply_write", drop_one)
    v = chaos_smoke.run_ingest_saturation_smoke(device="cpu")
    assert dropped
    assert not v["ok"] and v["lost"] == 1, v


def test_planted_crossed_row_fails_the_inference_gate(monkeypatch):
    """One labelled row, (client 0, request 0), gets another row's action
    in every forward that serves it: the wire chaos may drop the reply
    that carried the cross and the client re-send it, and the re-sent
    row is crossed too, so the one reply the client records for it is
    always wrong. The oracle (a plain ``BatchedPolicy``, which records
    nothing) is left alone."""
    from distributed_deep_q_tpu_torch.models.policy import BatchedPolicy

    orig = BatchedPolicy.forward
    planted = chaos_smoke._labeled_obs(1_000, (8,)).tobytes()
    crossed = []

    def cross_row(self, obs, params=None, bucket=None):
        a, q = orig(self, obs, params=params, bucket=bucket)
        if not hasattr(self, "served"):
            return a, q
        for j, row in enumerate(np.asarray(obs)):
            if row.tobytes() == planted:
                a = a.copy()
                a[j] = (a[j] + 1) % q.shape[1]   # another row's answer
                crossed.append(j)
        return a, q

    monkeypatch.setattr(BatchedPolicy, "forward", cross_row)
    v = chaos_smoke.run_inference_chaos_smoke(device="cpu")
    assert crossed
    assert not v["ok"] and v["wrong_actions"] == 1, v


def test_command_line_runs_a_mode():
    """``python -m distributed_deep_q_tpu_torch.chaos_smoke learn``: one
    JSON verdict line, exit 0."""
    import json
    import subprocess

    proc = subprocess.run(
        [sys.executable, "-m", "distributed_deep_q_tpu_torch.chaos_smoke",
         "learn"], capture_output=True, text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    v = json.loads(proc.stdout.strip().splitlines()[-1])
    assert v["ok"] and v["critical_flaps"] == 0


def test_trace_verdict_counts_orphans():
    """``_trace_verdict`` gates on orphan spans: an event whose parent was
    never recorded is counted."""
    trc = chaos_smoke._trace_begin()
    with trc.span("outer"):
        trc.instant("retry")
    v = chaos_smoke._trace_verdict(trc)
    assert v["orphan_spans"] == 0 and v["instants"] == {"retry": 1}
    assert v["spans"] == 1
    trc = chaos_smoke._trace_begin()
    trc.instant("retry", parent=12345)
    time.sleep(0)
    assert chaos_smoke._trace_verdict(trc)["orphan_spans"] == 1


def _fair_sheds(flow_mod, streams: list[int], seconds: float = 60.0,
                wait_s: float = 5.0) -> dict[int, int]:
    """The tenants mode's overload wave against a primary's "fair"
    controller, on a simulated clock: each stream is a synchronous client
    (an admitted request comes back ``wait_s`` later, behind the stalled
    forwards; a shed one 50 ms later) and the queue stays over the
    watermark throughout. Sheds per actor id."""
    import heapq

    now = [0.0]

    class Queue:
        def pending_rows(self):
            return 120  # 15 requests of 8 rows, the watermark is 80

    flow = flow_mod.FlowController(
        flow_mod.FlowConfig(staged_high_watermark=80, ingest_factor=100.0,
                            flush_credit_floor=8),
        None, Queue(), clock=lambda: now[0])
    events = [(0.01 * i, i, aid) for i, aid in enumerate(streams)]
    heapq.heapify(events)
    sheds: dict[int, int] = {}
    while events[0][0] <= seconds:
        t, i, aid = heapq.heappop(events)
        now[0] = t
        admitted, _ = flow.admit(aid, 8)
        if admitted:
            flow.on_ingest(aid, 8)
        else:
            sheds[aid] = sheds.get(aid, 0) + 1
        heapq.heappush(events, (t + (wait_s if admitted else 0.05), i, aid))
    return sheds


@pytest.mark.parametrize("package", ["reference", "port"])
def test_fair_primary_sheds_the_waves_greedy_actor_only(package):
    """The tenants mode's greedy actor: with a primary over its watermark,
    the "fair" controller sheds the actor on four streams, at or above its
    share of the fleet's rate, and none of the sixteen synchronous clients
    beside it. Both packages' controllers decide alike. (A fleet of equal
    synchronous clients alone is the policy's open blind spot, ROADMAP §C
    C4; the tenants mode bounds that wave by the ladder instead.)"""
    if package == "reference":
        from distributed_deep_q_tpu.rpc import flowcontrol as flow_mod
    else:
        from distributed_deep_q_tpu_torch.rpc import flowcontrol as flow_mod
    equal = list(range(16))
    sheds = _fair_sheds(flow_mod, equal + [112] * 4)
    assert set(sheds) == {112} and sheds[112] > 0, sheds


def _overload_sheds(flow_mod, order: list[int], ingest_rate: float,
                    seconds: float = 6.0) -> dict[int, int]:
    """The overload mode's controller (its ``FlowConfig``) on a simulated
    clock: a consumer noting 32 rows every 32/300 s (the mode's
    ``consume_rate``), and 16-row flushes at ``ingest_rate`` rows/s from
    the actors of ``order``, repeated. Sheds per actor id."""
    now = [0.0]
    flow = flow_mod.FlowController(
        flow_mod.FlowConfig(ingest_factor=1.5, flush_credit_floor=8,
                            rate_halflife_s=0.5),
        None, None, clock=lambda: now[0])
    t_consume = t_flush = 0.0
    k = 0
    sheds: dict[int, int] = {}
    while t_flush < seconds:
        if t_consume <= t_flush:
            now[0] = t_consume
            flow.note_consumed(32)
            t_consume += 32 / 300.0
            continue
        now[0] = t_flush
        aid = order[k % len(order)]
        admitted, _ = flow.admit(aid, 16)
        if admitted:
            flow.on_ingest(aid, 16)
        else:
            sheds[aid] = sheds.get(aid, 0) + 1
        k += 1
        t_flush += 16 / ingest_rate
    return sheds


@pytest.mark.parametrize("package", ["reference", "port"])
def test_overload_sheds_only_an_actor_out_of_turn(package):
    """Why the overload and ingest modes run in an interpreter of their
    own (ROADMAP §C, C6): under their "fair" controller three equal actors flushing in strict
    turns are never shed, at 3 and at 10 times the consumer's rate, since
    the asking actor's rate has always decayed the longest of the three;
    the same fleet with actor 0 flushing once out of turn every seven
    flushes is shed, actor 0 only. Both packages' controllers decide
    alike."""
    if package == "reference":
        from distributed_deep_q_tpu.rpc import flowcontrol as flow_mod
    else:
        from distributed_deep_q_tpu_torch.rpc import flowcontrol as flow_mod
    turns = [0, 1, 2]
    assert _overload_sheds(flow_mod, turns, 900.0) == {}
    assert _overload_sheds(flow_mod, turns, 3000.0) == {}
    sheds = _overload_sheds(flow_mod, [0, 1, 2, 0, 0, 1, 2], 900.0)
    assert set(sheds) == {0} and sheds[0] > 0, sheds
