"""Port vs reference: the moving-band env (``VelocitySignalAtari``, the
``-vel`` ids), ``StepLatencyEnv`` and ``make_envs``.

The env is host numpy code copied from the reference, and its RNG draw
order is the contract (``_redraw`` draws the velocity, then the position),
so frames, rewards and done flags are pinned byte for byte against the
reference under the same seeds and actions. Then the port's counterparts of
the reference's fast velocity tests (``tests/test_velocity_signal.py``):
two frames decode the reward, one frame cannot. The three motion gates
(the frame-stack CNN over the device ring and over the fused device-PER
path, and R2D2 at stack 1 through the device sequence ring) train through
the port, marked ``slow``, each from the reference's initial weights for
its configuration (the reference's own gate, run through the port: the
same weights, env, replay and actor draws; the port's initializer matches
Flax's in distribution only, and at seed 0 its own R2D2 draw fell below
the bar on the CPU, 15.7, where other seeds and the reference's draw
cleared it).
"""

import numpy as np
import pytest
import torch

from distributed_deep_q_tpu import config as ref_config
from distributed_deep_q_tpu.actors import game as ref_game
from distributed_deep_q_tpu.config import EnvConfig as RefEnvConfig

from distributed_deep_q_tpu_torch import config as port_config
from distributed_deep_q_tpu_torch.actors.game import (
    SignalAtari, StepLatencyEnv, VelocitySignalAtari, make_env, make_envs)
from distributed_deep_q_tpu_torch.config import EnvConfig

FRAME = (36, 36)
A = 4


def _rollout(env, actions):
    out = [(env.reset(), 0.0, False)]
    for a in actions:
        frame, r, done, over = env.step(int(a))
        assert done == over
        out.append((frame, r, done))
        if over:
            out.append((env.reset(), 0.0, False))
    return out


@pytest.mark.parametrize("orientation", ["v", "h"])
@pytest.mark.parametrize("segment", [0, 8])
@pytest.mark.parametrize("seed", [0, 7, 123])
def test_velocity_env_matches_reference_bytewise(orientation, segment, seed):
    """Frames, rewards and done flags over 200 steps (six episodes, resets
    included), actions drawn from their own generator."""
    kw = dict(frame_shape=FRAME, seed=seed, orientation=orientation,
              segment=segment)
    ref = ref_game.VelocitySignalAtari(**kw)
    port = VelocitySignalAtari(**kw)
    assert port.velocities == ref.velocities
    assert port.band_width == ref.band_width and port.segment == ref.segment
    actions = np.random.default_rng(seed + 1).integers(0, A, 200)
    got, want = _rollout(port, actions), _rollout(ref, actions)
    assert len(got) == len(want)
    for (f1, r1, d1), (f2, r2, d2) in zip(got, want):
        assert f1.dtype == f2.dtype == np.uint8
        np.testing.assert_array_equal(f1, f2)
        assert r1 == r2 and d1 == d2
    assert sum(r for _, r, _ in got) > 0


@pytest.mark.parametrize("env_id, cls, orientation, constant", [
    ("signal", SignalAtari, "v", None),
    ("signal-h", SignalAtari, "h", None),
    ("signal-vel", VelocitySignalAtari, "v", False),
    ("signal-vel-h", VelocitySignalAtari, "h", False),
    ("signal-vel-ep", VelocitySignalAtari, "v", True),
    ("signal-vel-ep-h", VelocitySignalAtari, "h", True),
])
def test_make_env_ids_match_reference(env_id, cls, orientation, constant):
    """The ``-h`` suffix picks the orientation, ``-vel`` the moving band and
    ``-ep`` the episode-constant velocity, as in the reference; the two
    packages' envs then give the same frames."""
    port = make_env(EnvConfig(id=env_id, kind="signal_atari",
                              frame_shape=FRAME), seed=3)
    ref = ref_game.make_env(RefEnvConfig(id=env_id, kind="signal_atari",
                                         frame_shape=FRAME), seed=3)
    assert type(port) is cls and type(ref).__name__ == cls.__name__
    assert port.orientation == ref.orientation == orientation
    if constant is not None:
        assert (port.segment > port.episode_len) is constant
    actions = np.arange(40) % A
    for (f1, r1, d1), (f2, r2, d2) in zip(_rollout(port, actions),
                                          _rollout(ref, actions)):
        np.testing.assert_array_equal(f1, f2)
        assert (r1, d1) == (r2, d2)


def test_step_latency_env_delegates_and_bounds_its_buffer():
    inner = VelocitySignalAtari(frame_shape=FRAME, seed=2)
    bare = VelocitySignalAtari(frame_shape=FRAME, seed=2)
    env = StepLatencyEnv(inner, maxlen=5)
    assert env.num_actions == A and env.obs_shape == FRAME
    assert env.velocities == bare.velocities         # attribute delegation
    np.testing.assert_array_equal(env.reset(), bare.reset())
    for a in range(8):
        got, want = env.step(a % A), bare.step(a % A)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]
    ms = env.drain_step_ms()
    assert len(ms) == 5 and all(m >= 0 for m in ms)   # the oldest 3 fell off
    assert env.drain_step_ms() == []
    env.step(0)
    assert len(env.drain_step_ms()) == 1


def test_make_envs_seeds_rows_like_make_env_and_checks_lengths():
    vel = EnvConfig(id="signal-vel", kind="signal_atari", frame_shape=FRAME)
    sig = EnvConfig(id="signal-h", kind="signal_atari", frame_shape=FRAME)
    seeds = [5, 6, 9]
    for cfgs in (vel, [vel, sig, vel]):
        envs = make_envs(cfgs, seeds)
        rows = cfgs if isinstance(cfgs, list) else [cfgs] * 3
        assert len(envs) == 3
        for env, c, s in zip(envs, rows, seeds):
            alone = make_env(c, seed=s)
            assert type(env) is type(alone)
            np.testing.assert_array_equal(env.reset(), alone.reset())
            for a in range(10):
                np.testing.assert_array_equal(env.step(a % A)[0],
                                              alone.step(a % A)[0])
    ref = ref_game.make_envs(RefEnvConfig(id="signal-vel", kind="signal_atari",
                                          frame_shape=FRAME), seeds)
    for env, r in zip(make_envs(vel, seeds), ref):
        np.testing.assert_array_equal(env.reset(), r.reset())
    with pytest.raises(ValueError, match="2 env configs vs 3 seeds"):
        make_envs([vel, sig], seeds)


# -- the reference's fast velocity tests, through the port ------------------


def _band_pos(frame: np.ndarray, env: VelocitySignalAtari) -> int:
    """Recover the band's start offset via circular box correlation."""
    axis = 1 if env.orientation == "v" else 0
    profile = frame.mean(axis=1 - axis).astype(np.float64)
    n, bw = len(profile), env.band_width
    scores = [profile[(np.arange(bw) + p) % n].sum() for p in range(n)]
    return int(np.argmax(scores))


def _decode_velocity(prev, cur, env) -> int:
    """Two-frame decoder: circular displacement → nearest velocity index."""
    n = env._axis
    d = (_band_pos(cur, env) - _band_pos(prev, env) + n // 2) % n - n // 2
    return int(np.argmin([abs(d - v) for v in env.velocities]))


@pytest.mark.parametrize("orientation", ["v", "h"])
def test_two_frame_decoder_hits_ceiling(orientation):
    env = VelocitySignalAtari(episode_len=64, frame_shape=FRAME, seed=5,
                              orientation=orientation)
    prev = env.reset()
    cur, _, _, _ = env.step(0)
    total = 0.0
    for _ in range(62):
        nxt, r, _, _ = env.step(_decode_velocity(prev, cur, env))
        total += r
        prev, cur = cur, nxt
    assert total >= 0.75 * 62, total


def test_single_frame_carries_no_reward_signal():
    env = VelocitySignalAtari(episode_len=32, frame_shape=FRAME, seed=11)
    counts = np.zeros((6, A), np.int64)     # position bucket × velocity
    for _ in range(600):
        frame = env.reset()
        counts[_band_pos(frame, env) * 6 // env._axis, env._v_idx] += 1
    for b in range(6):
        n = counts[b].sum()
        assert n >= 50
        assert counts[b].max() / n < 0.45, (b, counts[b])


def test_velocity_random_policy_baseline():
    env = VelocitySignalAtari(episode_len=32, frame_shape=FRAME, seed=0)
    rng = np.random.default_rng(0)
    rewards = []
    for _ in range(30):
        env.reset()
        rewards.append(sum(env.step(int(rng.integers(A)))[1]
                           for _ in range(32)))
    assert 4.0 < np.mean(rewards) < 13.0


def test_episode_constant_variant():
    env = make_env(EnvConfig(id="signal-vel-ep", kind="signal_atari",
                             frame_shape=FRAME), seed=3)
    assert env.segment > env.episode_len
    prev = env.reset()
    cur, _, _, _ = env.step(0)
    a = _decode_velocity(prev, cur, env)
    total, done = 0.0, False
    for _ in range(env.episode_len - 1):
        _, r, done, _ = env.step(a)
        total += r
    assert total == float(env.episode_len - 1) and done


# -- the motion gates, through the port (the reference's configurations) ----


def _pixel_cfg(mod, total_steps: int = 6000, **replay_kw):
    cfg = mod.Config()
    cfg.mesh.backend = "cpu"
    cfg.env = mod.EnvConfig(id="signal-vel", kind="signal_atari",
                            frame_shape=FRAME, stack=4, reward_clip=0.0)
    cfg.net = mod.NetConfig(kind="nature_cnn", num_actions=A,
                            frame_shape=FRAME, stack=4,
                            compute_dtype="float32")
    cfg.replay = mod.ReplayConfig(capacity=8192, batch_size=32,
                                  learn_start=500, n_step=1, write_chunk=64,
                                  **replay_kw)
    cfg.train = mod.TrainConfig(lr=1e-3, adam_eps=1e-8, gamma=0.99,
                                target_tau=0.01, double_dqn=True,
                                total_steps=total_steps, train_every=2,
                                eval_episodes=10, seed=0)
    cfg.actors.eps_decay_steps = total_steps // 2
    cfg.actors.eps_end = 0.05
    cfg.actors.eval_eps = 0.0
    return cfg


def r2d2_gate_config(mod=port_config):
    """The reference's R2D2 memory gate (``signal-vel-ep``, stack 1, 16-step
    sequences with 4 of burn-in, LSTM 128): the previous band position can
    only live in the LSTM carry."""
    cfg = mod.Config()
    cfg.mesh.backend = "cpu"
    cfg.env = mod.EnvConfig(id="signal-vel-ep", kind="signal_atari",
                            frame_shape=FRAME, stack=1, reward_clip=0.0)
    cfg.net = mod.NetConfig(kind="r2d2", num_actions=A, frame_shape=FRAME,
                            stack=1, lstm_size=128, compute_dtype="float32")
    cfg.replay = mod.ReplayConfig(capacity=16384, batch_size=16,
                                  learn_start=640, sequence_length=16,
                                  burn_in=4)
    cfg.train = mod.TrainConfig(lr=1e-3, adam_eps=1e-8, gamma=0.99,
                                target_tau=0.01, double_dqn=True,
                                total_steps=8000, train_every=2,
                                eval_episodes=10, seed=0)
    cfg.actors.eps_decay_steps = 4000
    cfg.actors.eps_end = 0.05
    cfg.actors.eval_eps = 0.0
    return cfg


def _start_from_reference_weights(monkeypatch, ref_cfg) -> None:
    """Every solver the port's loop builds starts from the reference's
    initial train state for ``ref_cfg`` (``load_flax_state``). Both
    packages then run the gate from the same weights and the same env,
    replay and actor draws; the port's own initializer matches Flax's in
    distribution, not in bits."""
    import jax

    from distributed_deep_q_tpu.parallel.learner import _locate_adam_state
    from distributed_deep_q_tpu.parallel.sequence_learner import (
        SequenceSolver as RefSequenceSolver)
    from distributed_deep_q_tpu.solver import Solver as RefSolver

    from distributed_deep_q_tpu_torch import train

    recurrent = ref_cfg.net.kind == "r2d2"
    ref_cfg.mesh.dp = 1
    ref = (RefSequenceSolver if recurrent else RefSolver)(ref_cfg)
    st = jax.tree.map(np.asarray, ref.state)
    adam, _ = _locate_adam_state(st.opt_state)
    name = "SequenceSolver" if recurrent else "Solver"
    base = getattr(train, name)

    class FromReference(base):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.load_flax_state(st.params, st.target_params, adam.count,
                                 adam.mu, adam.nu, st.step)

    monkeypatch.setattr(train, name, FromReference)


@pytest.mark.slow
@pytest.mark.parametrize("replay_kw", [
    pytest.param(dict(device_resident=True), id="device_ring"),
    pytest.param(dict(prioritized=True, device_per=True),
                 id="fused_device_per")])
def test_velocity_learns_through_the_frame_stack_paths(replay_kw,
                                                       monkeypatch):
    """Motion gates 1 and 2: the frame-stack CNN must read displacement
    across stack channels — ≥ 2× random (≈ 8)."""
    from distributed_deep_q_tpu_torch.train import train_single_process

    torch.set_num_threads(1)
    _start_from_reference_weights(monkeypatch,
                                  _pixel_cfg(ref_config, **replay_kw))
    summary = train_single_process(_pixel_cfg(port_config, **replay_kw),
                                   log_every=500)
    assert summary["eval_return"] >= 16.0, summary["eval_return"]


@pytest.mark.slow
def test_velocity_learns_through_r2d2_stack1(monkeypatch):
    """Motion gate 3: R2D2 at stack 1 through the device sequence ring."""
    from distributed_deep_q_tpu_torch.train import train_recurrent

    torch.set_num_threads(1)
    _start_from_reference_weights(monkeypatch, r2d2_gate_config(ref_config))
    summary = train_recurrent(r2d2_gate_config(), log_every=500)
    assert summary["eval_return"] >= 16.0, summary["eval_return"]
