"""Port vs reference: the actor processes, their comms and their supervisor.

Actor against actor, across packages: the reference's and the port's
``actor_main`` run in threads, each against a server, with the same seed,
the same config and the same θ published (the reference ``QNet``'s
initial leaves), for a few hundred env steps. The rows that land in the
replays are bitwise equal: CartPole's n-step transitions (obs, action,
reward, next_obs, discount) and SignalAtari's frames at 36×36 in float32
(frame, action, reward, done, boundary). The greedy actions come from two
float32 forwards that agree within 1e-5, not bitwise, so a near-tie could
flip one argmax: where the actions first differ, the test shows that the
reference's top two Q-values there lie within 1e-5 and compares the rows
before it. The recurrent actor (``_recurrent_actor_loop``, the small r2d2
CartPole configuration) ships sequences: bitwise, with the stored carries
``(init_c, init_h)`` within 1e-5 (they come out of the two LSTMs).

Each package's actor also feeds the other package's server, and its rows
land as they do on its own (ROADMAP's acceptance for slice 6d).

Also ported, as twins of the reference's own tests: the three liveness
cases of ``_ActorComms`` (``tests/test_rpc.py``), the supervisor's
liveness matrix, spawn-grace floor and kill escalation
(``tests/test_faults.py``), and the supervisor restarting a killed actor
process (``tests/test_rpc.py::test_supervisor_restarts_killed_actor``).
Sockets bind 127.0.0.1, port 0; every test carries a deadline of its own.
"""

import functools
import signal
import threading
import time

import numpy as np
import pytest
import torch

from distributed_deep_q_tpu import config as ref_config
from distributed_deep_q_tpu.actors import supervisor as ref_sup
from distributed_deep_q_tpu.models.qnet import QNet as RefQNet
from distributed_deep_q_tpu.replay import replay_memory as ref_mem
from distributed_deep_q_tpu.replay import sequence as ref_seq
from distributed_deep_q_tpu.rpc import replay_server as ref_rs

from distributed_deep_q_tpu_torch import config as port_config
from distributed_deep_q_tpu_torch.actors import game
from distributed_deep_q_tpu_torch.actors import supervisor as sup_mod
from distributed_deep_q_tpu_torch.replay import replay_memory as mem
from distributed_deep_q_tpu_torch.replay import sequence as seq
from distributed_deep_q_tpu_torch.rpc import replay_server as rs

TIMEOUT_S = 120
Q_TIE = 1e-5
STEPS = 300

PKG = {"port": (port_config, sup_mod, mem, seq, rs),
       "reference": (ref_config, ref_sup, ref_mem, ref_seq, ref_rs)}

# the small r2d2 CartPole configuration of tests/test_rpc_r2d2.py:17-38
R2D2_SMALL = ["env.id=CartPole-v1", "env.kind=gym", "env.stack=1",
              "env.reward_clip=0", "net.torso=mlp", "net.hidden=32",
              "net.lstm_size=16", "net.compute_dtype=float32",
              "replay.sequence_length=8", "replay.burn_in=4",
              "replay.batch_size=8", "replay.capacity=2048",
              "replay.learn_start=48", "actors.num_actors=2",
              "actors.send_batch=8", "actors.param_sync_period=20"]
CASES = {
    "cartpole": ("cartpole", []),
    "signal": ("pong", ["env.kind=signal_atari", "env.id=signal",
                        "env.frame_shape=36,36", "net.frame_shape=36,36",
                        "net.compute_dtype=float32"]),
    "r2d2": ("r2d2", R2D2_SMALL),
}
# every actor pulls θ once, at step 0, and sends 20-row batches
COMMON = ["actors.param_sync_period=1000000", "actors.send_batch=20",
          "actors.heartbeat_period=0.5"]


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


def _cfg(pkg: str, case: str):
    config = PKG[pkg][0]
    preset, overrides = CASES[case]
    cfg = config.PRESETS[preset]()
    cfg.mesh.backend = "cpu"
    return config.apply_overrides(cfg, overrides + COMMON)


def _server_replay(pkg: str, case: str, obs_shape):
    _, _, memory, sequence, _ = PKG[pkg]
    if case == "cartpole":
        return memory.ReplayMemory(4096, obs_shape, np.float32)
    if case == "signal":
        return memory.FrameStackReplay(4096, obs_shape, 4, 1, 0.99)
    return sequence.SequenceReplay(512, 8, obs_shape, np.float32,
                                   lstm_size=16)


def _theta(case: str):
    """The reference QNet's initial leaves for this case's net."""
    cfg = _cfg("reference", case)
    env = game.make_env(port_config.apply_overrides(
        port_config.PRESETS[CASES[case][0]](), CASES[case][1]).env, seed=0)
    cfg.net.num_actions = env.num_actions
    return RefQNet(cfg.net, seed=7, obs_dim=int(np.prod(env.obs_shape))), \
        env.obs_shape


def _fields(case: str, replay) -> dict:
    n = len(replay)
    if case == "cartpole":
        keys = ("obs", "action", "reward", "next_obs", "discount")
    elif case == "signal":
        keys = ("frames", "action", "reward", "done", "boundary")
    else:
        keys = ("obs", "action", "reward", "discount", "mask", "init_c",
                "init_h")
    return {k: np.array(getattr(replay, k)[:n]) for k in keys}


@functools.lru_cache(maxsize=None)
def _rows(actor: str, server: str, case: str):
    """The rows one actor (package ``actor``) lands in a server (package
    ``server``) in STEPS env steps, with the reference's θ published."""
    qnet, obs_shape = _theta(case)
    replay = _server_replay(server, case, obs_shape)
    srv = PKG[server][4].ReplayFeedServer(replay)
    srv.publish_params(qnet.get_weights())
    host, port = srv.address
    stop = threading.Event()
    t = threading.Thread(target=PKG[actor][1].actor_main,
                         args=(_cfg(actor, case), host, port, 0, stop, STEPS),
                         daemon=True)
    try:
        torch.set_num_threads(1)
        t.start()
        t.join(timeout=90)
        assert not t.is_alive(), "the actor did not finish its steps"
        if case != "cartpole":   # CartPole's rows are n-step emissions
            assert srv.counters()["env_steps"] == STEPS
        return _fields(case, replay)
    finally:
        stop.set()
        srv.close()


def _stack_at(frames, boundary, k):
    """The actor's stacked observation at row k, rebuilt from the rows."""
    stacker = game.FrameStacker(frames.shape[1:], 4)
    obs = stacker.reset(frames[0])
    for t in range(1, k + 1):
        obs = (stacker.reset(frames[t]) if boundary[t - 1]
               else stacker.push(frames[t]))
    return np.array(obs)


def _tie_gap(case: str, rows: dict, k: int) -> float:
    """The reference's gap between its top two Q-values at the step where
    the actions first differ (row k; for sequences, the flat step index)."""
    qnet, _ = _theta(case)
    if case == "cartpole":
        q = np.asarray(qnet.forward(rows["obs"][k]))
    elif case == "signal":
        q = np.asarray(qnet.forward(_stack_at(rows["frames"],
                                              rows["boundary"], k)))
    else:
        s, i = divmod(k, rows["action"].shape[1])
        q, _ = qnet.forward(rows["obs"][s:s + 1, :i + 1],
                            (rows["init_c"][s:s + 1],
                             rows["init_h"][s:s + 1]))
        q = np.asarray(q)[0, i]
    top = np.sort(q.ravel())[-2:]
    return float(top[1] - top[0])


def _assert_rows_agree(case: str, want: dict, got: dict) -> None:
    """Bitwise rows (carries within 1e-5) up to the first argmax flip,
    which must be a near-tie of the reference's Q-values."""
    n = min(len(want["action"]), len(got["action"]))
    a_want = want["action"][:n].reshape(-1)
    a_got = got["action"][:n].reshape(-1)
    flips = np.flatnonzero(a_want != a_got)
    if flips.size == 0:
        assert len(want["action"]) == len(got["action"])
    else:
        k = int(flips[0])
        assert _tie_gap(case, want, k) <= Q_TIE, (
            f"actions differ at step {k} and the reference's top two "
            "Q-values there are not a near-tie")
        # the rows before the flip; an n-step row looks n - 1 steps ahead
        if case == "r2d2":
            n = k // want["action"].shape[1]
        else:
            n = max(k - (3 if case == "cartpole" else 1), 0)
    assert n >= 20, f"only {n} rows to compare"
    for key, a in want.items():
        if key in ("init_c", "init_h"):
            np.testing.assert_allclose(got[key][:n], a[:n], rtol=Q_TIE,
                                       atol=Q_TIE, err_msg=key)
        else:
            np.testing.assert_array_equal(got[key][:n], a[:n], err_msg=key)


@pytest.mark.parametrize("case", list(CASES))
def test_port_actor_lands_the_reference_actors_rows(case):
    """Each package's actor on its own package's server."""
    _assert_rows_agree(case, _rows("reference", "reference", case),
                       _rows("port", "port", case))


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("actor,server", [("port", "reference"),
                                          ("reference", "port")])
def test_an_actor_feeds_the_other_packages_server(case, actor, server):
    _assert_rows_agree(case, _rows(actor, actor, case),
                       _rows(actor, server, case))


# -- _ActorComms: the reference's three liveness cases ----------------------


def _liveness_cfg(**actors):
    cfg = port_config.cartpole_config()
    cfg.actors.send_batch = 10**9        # data traffic can never trigger
    cfg.actors.param_sync_period = 10**9
    cfg.actors.heartbeat_period = 0.05
    for k, v in actors.items():
        setattr(cfg.actors, k, v)
    return cfg


def _start_actor(cfg, replay):
    server = rs.ReplayFeedServer(replay)
    host, port = server.address
    stop = threading.Event()
    t = threading.Thread(target=sup_mod.actor_main,
                         args=(cfg, host, port, 0, stop), daemon=True)
    t.start()
    deadline = time.monotonic() + 30
    while 0 not in server.last_seen and time.monotonic() < deadline:
        time.sleep(0.01)
    assert 0 in server.last_seen, "actor never reached the server"
    return server, stop, t, deadline


def _distinct_stamps(server, n, deadline) -> int:
    stamps = set()
    while len(stamps) < n and time.monotonic() < deadline:
        stamps.add(server.last_seen[0])
        time.sleep(0.05)
    return len(stamps)


def test_actor_heartbeats_without_data_traffic():
    """An actor whose env never fills a send_batch still advances the
    server's liveness stamp through heartbeats."""
    replay = mem.ReplayMemory(256, (4,), np.float32)
    server, stop, t, deadline = _start_actor(_liveness_cfg(), replay)
    try:
        assert _distinct_stamps(server, 3, deadline) >= 3, \
            "liveness stamp frozen — heartbeats not flowing"
        assert len(replay) == 0, "no data traffic was supposed to happen"
    finally:
        stop.set()
        t.join(timeout=20)
        server.close()


class _StallEnv:
    num_actions = 2
    obs_shape = (4,)
    obs_dtype = np.float32

    def __init__(self, stall_s):
        self.stall_s = stall_s

    def reset(self):
        return np.zeros(4, np.float32)

    def step(self, action):
        time.sleep(self.stall_s)
        return np.zeros(4, np.float32), 0.0, False, False


def test_heartbeats_survive_a_blocking_env_step(monkeypatch):
    """The beat runs on its own thread: an actor stuck inside one long
    ``env.step()`` keeps its stamp fresh."""
    monkeypatch.setattr(game, "make_env", lambda *a, **k: _StallEnv(0.8))
    server, stop, t, deadline = _start_actor(
        _liveness_cfg(), mem.ReplayMemory(256, (4,), np.float32))
    try:
        assert _distinct_stamps(server, 4, deadline) >= 4, \
            "liveness stamp froze during an in-step stall"
    finally:
        stop.set()
        t.join(timeout=20)
        server.close()


def test_beat_goes_silent_past_the_stall_budget(monkeypatch):
    """Once the env loop makes no progress for longer than
    ``env_stall_budget``, the beat stops, so a wedged env still trips the
    supervisor's heartbeat timeout."""
    monkeypatch.setattr(game, "make_env", lambda *a, **k: _StallEnv(600))
    cfg = _liveness_cfg(env_stall_budget=0.5)
    server, stop, t, _ = _start_actor(
        cfg, mem.ReplayMemory(256, (4,), np.float32))
    try:
        time.sleep(cfg.actors.env_stall_budget + 0.3)
        frozen = server.last_seen[0]
        time.sleep(0.5)  # several heartbeat periods
        assert server.last_seen[0] == frozen, \
            "beat kept flowing past the stall budget"
    finally:
        stop.set()
        server.close()  # the actor thread stays parked in its hung step


# -- the supervisor's liveness policy ---------------------------------------


def _mk_sup(**kw):
    return sup_mod.ActorSupervisor(port_config.Config(), "127.0.0.1", 0,
                                   **kw)


def test_is_silent_liveness_matrix():
    sup = _mk_sup(heartbeat_timeout=10.0, spawn_grace=30.0)
    now = 1000.0
    # contacted since spawn → plain heartbeat timeout
    assert not sup._is_silent(now, now - 5, now - 100)
    assert sup._is_silent(now, now - 11, now - 100)
    # never contacted → spawn-grace deadline
    assert not sup._is_silent(now, 0.0, now - 29)
    assert sup._is_silent(now, 0.0, now - 31)
    # a stale stamp from a previous incarnation counts as no contact
    assert not sup._is_silent(now, now - 200, now - 29)
    assert sup._is_silent(now, now - 200, now - 31)


def test_spawn_grace_never_below_heartbeat_timeout():
    assert _mk_sup(heartbeat_timeout=50.0, spawn_grace=1.0).spawn_grace \
        == 50.0


class _FakeProc:
    """Duck-typed mp.Process: optionally shrugs off SIGTERM."""

    def __init__(self, stubborn: bool):
        self.stubborn = stubborn
        self.terminated = self.killed = False
        self._alive = True

    def is_alive(self):
        return self._alive

    def terminate(self):
        self.terminated = True
        if not self.stubborn:
            self._alive = False

    def kill(self):
        self.killed = True
        self._alive = False

    def join(self, timeout=None):
        pass


def test_reap_escalates_to_kill_for_stubborn_children():
    sup = _mk_sup()
    stubborn = _FakeProc(stubborn=True)
    sup._reap(stubborn)
    assert stubborn.terminated and stubborn.killed
    assert sup.kill_escalations == 1
    polite = _FakeProc(stubborn=False)
    sup._reap(polite)
    assert polite.terminated and not polite.killed
    assert sup.kill_escalations == 1  # no escalation for a clean exit


def test_supervisor_restarts_killed_actor():
    """Kill an actor's process: the supervisor respawns it (a fresh
    interpreter importing torch and the port) and rows flow again."""
    cfg = port_config.cartpole_config()
    cfg.mesh.backend = "cpu"
    cfg.actors.num_actors = 1
    cfg.actors.send_batch = 8
    replay = mem.ReplayMemory(10_000, (4,), np.float32)
    server = rs.ReplayFeedServer(replay)
    host, port = server.address
    sup = sup_mod.ActorSupervisor(cfg, host, port)
    try:
        sup.start()
        sup.watch(server.last_seen, poll_period=0.2)
        deadline = time.monotonic() + 40
        while len(replay) < 50 and time.monotonic() < deadline:
            time.sleep(0.1)
        assert len(replay) >= 50, "actor never fed the buffer"

        first = sup.procs[0]
        first.kill()
        deadline = time.monotonic() + 20
        while sup.procs[0] is first and time.monotonic() < deadline:
            time.sleep(0.1)
        assert sup.restarts >= 1, "supervisor never restarted the dead actor"
        assert sup.procs[0] is not first and sup.procs[0].is_alive()

        size_after_restart = len(replay)
        deadline = time.monotonic() + 40
        while len(replay) <= size_after_restart + 20 \
                and time.monotonic() < deadline:
            time.sleep(0.1)
        assert len(replay) > size_after_restart + 20
    finally:
        sup.stop()
        server.close()
    assert not any(p.is_alive() for p in sup.procs.values())


def _idle_worker(cfg, host, port, actor_id, stop):
    """A light stand-in for ``actor_main`` (the supervisor's ``target``
    hook): waits on its private stop event."""
    stop.wait(60)


def test_supervisor_grow_and_retire_with_a_light_target():
    """The elastic surface: a retired actor is stopped (its private event
    first), counted apart from crash kills and never respawned by the
    watch loop; the next grow reuses its slot."""
    cfg = port_config.cartpole_config()
    cfg.actors.num_actors = 2
    sup = sup_mod.ActorSupervisor(cfg, "127.0.0.1", 0, target=_idle_worker)
    last_seen: dict[int, float] = {}
    try:
        sup.start()
        sup.watch(last_seen, poll_period=0.1)
        assert sup.actor_ids() == [0, 1]
        victim = sup.procs[1]
        assert sup.retire(1)
        # exit 0 when the child was already waiting on its event; SIGTERM
        # when it was still importing (the escalation ladder's first rung)
        assert not victim.is_alive()
        assert victim.exitcode in (0, -signal.SIGTERM)
        assert sup.executor_terminations == 1 and sup.kill_escalations == 0
        assert sup.actor_ids() == [0] and sup.retired == {1}
        time.sleep(0.5)   # several watch polls
        assert sup.restarts == 0 and sup.fleet_size() == 1
        assert not sup.retire(1)   # already gone
        assert sup.grow() == 1 and sup.actor_ids() == [0, 1]
        assert sup.grow() == 2 and sup.fleet_size() == 3
    finally:
        sup.stop()
    assert not any(p.is_alive() for p in sup.procs.values())
    assert sup.restarts == 0

