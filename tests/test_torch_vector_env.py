"""Port vs reference: the vectorized acting plane (``actors/vector.py``).

Twin of ``tests/test_vector_env.py``. The module is numpy only, so every
pin is bitwise:

- the port's ``VectorEnv`` against the reference's and against N
  sequential port envs, frame for frame across auto-reset boundaries, on
  all four synthetic env kinds;
- the port's ``VectorFrameStacker`` against the reference's and against
  per-env ``FrameStacker`` rows, a mid-stream row reset included;
- the latency wrapper times the whole tick (one sample per tick);
- the port's ``VectorActing`` tick against the reference's on the same
  seeds and the same greedy function (frames, rewards, dones, overs and
  actions), and against N sequential port actors on both torsos;
- ``train_distributed`` refuses a non-pixel env with ``vector_envs > 1``
  before any actor is spawned.

Inputs come from numpy seeds; every test carries a deadline of its own.
"""

import signal

import numpy as np
import pytest

from distributed_deep_q_tpu.actors import game as ref_game
from distributed_deep_q_tpu.actors import vector as ref_vector
from distributed_deep_q_tpu.config import EnvConfig as RefEnvConfig

from distributed_deep_q_tpu_torch import config as port_config
from distributed_deep_q_tpu_torch.actors import game
from distributed_deep_q_tpu_torch.actors import supervisor as sup_mod
from distributed_deep_q_tpu_torch.actors.vector import (
    VectorActing, VectorEnv, VectorFrameStacker, VectorStepLatencyEnv,
    make_vector_env)
from distributed_deep_q_tpu_torch.config import (
    EnvConfig, NetConfig, env_for_actor)
from distributed_deep_q_tpu_torch.models.qnet import QNet

TIMEOUT_S = 60
SEEDS = [5, 6, 7]
ROLLS = ("frame", "action", "reward", "done", "boundary")


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


def _env_cfgs(env_id: str, kind: str, frame_shape=(10, 10), stack=2):
    kw = dict(id=env_id, kind=kind, frame_shape=frame_shape, stack=stack)
    return EnvConfig(**kw), RefEnvConfig(**kw)


@pytest.mark.parametrize("env_id,kind", [
    ("fake", "fake_atari"),
    ("signal", "signal_atari"),
    ("signal-h", "signal_atari"),
    ("signal-vel", "signal_atari"),
])
def test_vector_env_matches_reference_and_sequential_envs(env_id, kind):
    """Port ``VectorEnv`` == reference ``VectorEnv`` == N sequential port
    envs, across episode boundaries (auto-reset rows return the NEW
    episode's first frame)."""
    cfg, ref_cfg = _env_cfgs(env_id, kind)
    venv = VectorEnv(game.make_envs(cfg, SEEDS))
    ref = ref_vector.VectorEnv(ref_game.make_envs(ref_cfg, SEEDS))
    singles = game.make_envs(cfg, SEEDS)
    arng = np.random.default_rng(0)
    first = venv.reset()
    np.testing.assert_array_equal(first, ref.reset())
    np.testing.assert_array_equal(
        first, np.stack([e.reset() for e in singles]))
    overs_seen = 0
    for _ in range(75):  # episode_len 10 (fake) / 32 (signal): crosses
        acts = arng.integers(venv.num_actions, size=len(SEEDS))
        fv, rv, dv, ov = venv.step(acts)
        for got, want in zip((fv, rv, dv, ov), ref.step(acts)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
        for j, env in enumerate(singles):
            f, r, d, o = env.step(int(acts[j]))
            if o:
                f = env.reset()
            np.testing.assert_array_equal(fv[j], f)
            assert rv[j] == np.float32(r)
            assert bool(dv[j]) == bool(d) and bool(ov[j]) == bool(o)
        overs_seen += int(ov.sum())
    assert overs_seen > 0, "no auto-reset boundary was exercised"


def test_vector_frame_stacker_matches_reference_and_per_env_rows():
    rng = np.random.default_rng(3)
    n, shape, stack = 3, (6, 6), 4
    vec = VectorFrameStacker(n, shape, stack)
    ref = ref_vector.VectorFrameStacker(n, shape, stack)
    singles = [game.FrameStacker(shape, stack) for _ in range(n)]
    frames = rng.integers(0, 256, (n,) + shape, dtype=np.uint8)
    out = vec.reset(frames)
    np.testing.assert_array_equal(out, ref.reset(frames))
    np.testing.assert_array_equal(
        out, np.stack([s.reset(frames[j]) for j, s in enumerate(singles)]))
    for t in range(9):
        frames = rng.integers(0, 256, (n,) + shape, dtype=np.uint8)
        out = vec.push(frames)
        np.testing.assert_array_equal(out, ref.push(frames))
        for j, s in enumerate(singles):
            np.testing.assert_array_equal(out[j], s.push(frames[j]))
        if t == 4:  # mid-stream per-row reset (episode boundary)
            f = rng.integers(0, 256, shape, dtype=np.uint8)
            vec.reset_row(1, f)
            ref.reset_row(1, f)
            singles[1].reset(f)
            np.testing.assert_array_equal(vec.obs[1], singles[1].obs)
            np.testing.assert_array_equal(vec.obs, ref.obs)


@pytest.mark.parametrize("build", ["wrapper", "make_vector_env"])
def test_vector_latency_wrapper_times_whole_tick_and_passes_through(build):
    cfg, _ = _env_cfgs("signal", "signal_atari")
    if build == "wrapper":
        venv = VectorStepLatencyEnv(VectorEnv(game.make_envs(cfg, SEEDS)))
    else:
        venv = make_vector_env(cfg, SEEDS, latency=True)
    assert venv.num_envs == len(SEEDS)          # __getattr__ passthrough
    assert venv.num_actions == 4
    venv.reset()
    venv.step(np.zeros(len(SEEDS), np.int64))
    ms = venv.drain_step_ms()
    assert len(ms) == 1 and ms[0] > 0.0         # one sample per TICK
    assert venv.drain_step_ms() == []


def _setup(kind, frame_shape, train_seed=11, n=3):
    """A port ``QNet`` and the per-row identities the vector actor uses:
    env configs, env seeds, ε rngs' seeds and the ε ladder."""
    env_cfg, _ = _env_cfgs("signal", "signal_atari", frame_shape)
    net_cfg = NetConfig(kind=kind, num_actions=4, hidden=(32, 32),
                        frame_shape=frame_shape, stack=2,
                        compute_dtype="float32")
    qnet = QNet(net_cfg, seed=train_seed,
                obs_dim=int(np.prod(frame_shape)) * 2)
    gids = list(range(n))
    eps = [sup_mod.actor_epsilon(g, n, 0.4, 7.0) for g in gids]
    return env_cfg, qnet, gids, eps


def _batched_greedy(qnet):
    return lambda rows: np.argmax(np.asarray(qnet.forward(rows)), axis=-1)


def _tick_rows(acting, greedy, n, ticks):
    out = [{k: [] for k in ROLLS} for _ in range(n)]
    for _ in range(ticks):
        frames, actions, rewards, dones, overs = acting.tick(greedy)
        for j in range(n):
            for k, v in zip(ROLLS, (frames[j], int(actions[j]),
                                    np.float32(rewards[j]), bool(dones[j]),
                                    bool(overs[j]))):
                out[j][k].append(v)
    return out


@pytest.mark.parametrize("kind,frame_shape", [
    ("mlp", (10, 10)),
    ("nature_cnn", (36, 36)),
])
def test_vector_acting_matches_the_reference_tick(kind, frame_shape):
    """The port's tick against the reference's: the same seeds, the same
    greedy function (the port ``QNet``'s batched forward) → the same
    frames, actions, rewards, dones and overs, and the same completed
    episode returns."""
    train_seed, n, ticks = 11, 3, 40
    env_cfg, qnet, gids, eps = _setup(kind, frame_shape, train_seed, n)
    _, ref_env_cfg = _env_cfgs("signal", "signal_atari", frame_shape)
    env_seeds = [train_seed + 1000 * (g + 1) for g in gids]

    def rngs():
        return [np.random.default_rng(train_seed + 7777 * (g + 1))
                for g in gids]

    port = VectorActing(VectorEnv(game.make_envs(
        [env_for_actor(env_cfg, g) for g in gids], env_seeds)),
        env_cfg.stack, rngs(), eps)
    ref = ref_vector.VectorActing(ref_vector.VectorEnv(ref_game.make_envs(
        ref_env_cfg, env_seeds)), ref_env_cfg.stack, rngs(), eps)
    greedy = _batched_greedy(qnet)
    got = _tick_rows(port, greedy, n, ticks)
    want = _tick_rows(ref, greedy, n, ticks)
    assert port.auto_resets == ref.auto_resets > 0
    assert port.drain_completed() == ref.drain_completed()
    for j in range(n):
        for k in ROLLS:
            np.testing.assert_array_equal(np.asarray(got[j][k]),
                                          np.asarray(want[j][k]), err_msg=k)


def _sequential_rollout(env_cfg, gid, train_seed, fleet, greedy, ticks):
    """The single-env actor loop's transition semantics (pre-step frame
    appended, post-step frame discarded on episode end) with the fleet's
    seeding discipline."""
    env = game.make_env(env_for_actor(env_cfg, gid),
                        seed=train_seed + 1000 * (gid + 1))
    rng = np.random.default_rng(train_seed + 7777 * (gid + 1))
    eps = sup_mod.actor_epsilon(gid, fleet, 0.4, 7.0)
    stacker = game.FrameStacker(env.obs_shape, env_cfg.stack)
    frame = env.reset()
    obs = stacker.reset(frame)
    rec = {k: [] for k in ROLLS}
    for _ in range(ticks):
        if rng.random() < eps:
            a = int(rng.integers(env.num_actions))
        else:
            a = greedy(np.asarray(obs))
        nf, r, d, o = env.step(a)
        for k, v in zip(ROLLS, (frame, a, np.float32(r), bool(d), bool(o))):
            rec[k].append(v)
        frame = nf
        obs = stacker.push(frame)
        if o:
            frame = env.reset()
            obs = stacker.reset(frame)
    return rec


@pytest.mark.parametrize("kind,frame_shape", [
    ("mlp", (10, 10)),
    ("nature_cnn", (36, 36)),   # smallest shape the VALID conv stack takes
])
def test_vector_acting_matches_sequential_port_actors(kind, frame_shape):
    """Twin of the reference's acceptance pin: same seeds → same actions
    → same transitions, the vector tick (one batched forward) against N
    independent per-env actor loops (batch-1 forwards), both on the
    port's ``QNet``."""
    train_seed, n, ticks = 11, 3, 40
    env_cfg, qnet, gids, eps = _setup(kind, frame_shape, train_seed, n)
    venv = VectorEnv(game.make_envs(
        [env_for_actor(env_cfg, g) for g in gids],
        [train_seed + 1000 * (g + 1) for g in gids]))
    rngs = [np.random.default_rng(train_seed + 7777 * (g + 1))
            for g in gids]
    acting = VectorActing(venv, env_cfg.stack, rngs, eps)
    vec = _tick_rows(acting, _batched_greedy(qnet), n, ticks)
    assert acting.auto_resets > 0, "no episode boundary was exercised"

    def single_greedy(obs):
        return int(np.argmax(np.asarray(qnet.forward(obs[None]))[0]))

    for j, g in enumerate(gids):
        ref = _sequential_rollout(env_cfg, g, train_seed, n, single_greedy,
                                  ticks)
        assert vec[j]["action"] == ref["action"]
        for k in ROLLS:
            np.testing.assert_array_equal(np.asarray(vec[j][k]),
                                          np.asarray(ref[k]), err_msg=k)


def test_vector_mode_rejects_non_pixel_env_before_spawning(monkeypatch):
    """``VectorActing`` refuses float32 observations at construction, but
    that happens inside the actor process, and the learner would then
    wait at learn_start forever: ``train_distributed`` refuses it first."""
    def spawn(self, i):
        raise AssertionError("an actor was spawned before the refusal")

    monkeypatch.setattr(sup_mod.ActorSupervisor, "_spawn", spawn)
    cfg = port_config.cartpole_config()
    cfg.mesh.backend = "cpu"
    cfg.actors.vector_envs = 4
    with pytest.raises(ValueError, match="pixel acting path"):
        sup_mod.train_distributed(cfg)
    with pytest.raises(ValueError, match="the pixel path"):
        VectorActing(VectorEnv(game.make_envs(cfg.env, [0, 1])), 1,
                     [np.random.default_rng(0)] * 2, [0.1, 0.1])
