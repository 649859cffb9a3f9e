"""Port vs reference: the Atari preprocessing stack (``actors/game.py``'s
``AtariEnv`` and ``_resize_area``), with no ALE.

Twins of the reference's ``tests/test_atari_env.py`` (its scripted
gymnasium-style raw env with RGB frames, rewards and a ``lives`` counter)
and of ``tests/test_eval_parity_kit.py::test_preprocessing_golden_checksums``
(the full stack over 210×160 procedural frames against the frozen hashes
in ``tests/fixtures/atari_golden.npz``). Each twin drives the port's
class and the reference's over the same raw env and seed: the port's
observations, rewards, done/over flags and the raw actions it issued are
equal to the reference's, bitwise, and the reference test's own checks
hold on the port.
"""

import hashlib
import signal

import numpy as np
import pytest

from distributed_deep_q_tpu.actors.game import AtariEnv as RefAtariEnv
from distributed_deep_q_tpu.actors.game import _resize_area as ref_resize
from distributed_deep_q_tpu.config import EnvConfig as RefEnvConfig

from distributed_deep_q_tpu_torch.actors.game import AtariEnv, _resize_area
from distributed_deep_q_tpu_torch.config import EnvConfig

from test_atari_env import StubALE
from test_eval_parity_kit import FIXTURE, N_STEPS, _ScriptedRaw


@pytest.fixture(autouse=True)
def _deadline():
    """Each test gets 60 s; a hang fails it instead of the run."""
    def expire(*_):
        raise TimeoutError("test exceeded its 60 s deadline")
    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(60)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def _cfg(mod=EnvConfig, **kw):
    base = dict(id="stub", kind="atari", frame_shape=(10, 10), frame_skip=4,
                reward_clip=1.0, terminal_on_life_loss=True, noop_max=5)
    base.update(kw)
    return mod(**base)


def _pair(stub_kw=None, seed=0, **cfg_kw):
    """(port env, its stub, reference env, its stub) over two identical
    scripted raw envs."""
    stubs = [StubALE(**(stub_kw or {})) for _ in range(2)]
    return (AtariEnv(_cfg(**cfg_kw), seed=seed, env=stubs[0]), stubs[0],
            RefAtariEnv(_cfg(RefEnvConfig, **cfg_kw), seed=seed,
                        env=stubs[1]), stubs[1])


def _same(port_out, ref_out):
    """One reset or step's outputs, bitwise (observations as bytes)."""
    if isinstance(port_out, tuple):
        obs, *rest = port_out
        ref_obs, *ref_rest = ref_out
        assert rest == ref_rest
    else:
        obs, ref_obs = port_out, ref_out
    assert obs.dtype == ref_obs.dtype == np.uint8
    np.testing.assert_array_equal(obs, ref_obs)
    return port_out


def test_resize_area_golden():
    img = (np.arange(16, dtype=np.uint8) * 16).reshape(4, 4)
    out = _resize_area(img, (2, 2))
    np.testing.assert_array_equal(out, [[40, 72], [168, 200]])
    np.testing.assert_array_equal(_resize_area(img, (4, 4)), img)
    # and the reference's kernel, on an odd-shaped frame
    rng = np.random.default_rng(0)
    frame = rng.integers(0, 256, (210, 160), dtype=np.uint8)
    for shape in ((84, 84), (2, 2), (105, 80), (210, 160)):
        np.testing.assert_array_equal(_resize_area(frame, shape),
                                      ref_resize(frame, shape))


def test_grayscale_weights():
    for channel, weight in ((0, 0.299), (1, 0.587), (2, 0.114)):
        rgb = [0, 0, 0]
        rgb[channel] = 200
        env, _, ref, _ = _pair({"frame_fn": lambda t: tuple(rgb)})
        obs = _same(env.reset(), ref.reset())
        assert obs.shape == (10, 10) and obs[0, 0] == int(200 * weight)


def test_two_frame_max():
    kw = {"frame_fn": lambda t: ((100, 100, 100) if t % 2 else
                                 (50, 50, 50))}
    env, _, ref, _ = _pair(kw)
    _same(env.reset(), ref.reset())
    obs, *_ = _same(env.step(0), ref.step(0))
    assert obs[0, 0] == 100


def test_frame_skip_count():
    env, stub, ref, ref_stub = _pair()
    _same(env.reset(), ref.reset())
    before = stub.t
    _same(env.step(3), ref.step(3))
    assert stub.t - before == 4
    assert stub.actions[-4:] == [3, 3, 3, 3]
    assert stub.actions == ref_stub.actions


def test_reward_summed_then_clipped():
    for value, clip, want in ((0.7, 1.0, 1.0), (-0.7, 1.0, -1.0),
                              (0.7, 0.0, 2.8)):
        env, _, ref, _ = _pair({"reward_fn": lambda t: value},
                               reward_clip=clip)
        _same(env.reset(), ref.reset())
        _, r, *_ = _same(env.step(0), ref.step(0))
        assert r == pytest.approx(want)


def test_life_loss_done_but_not_over():
    kw = {"lives_fn": lambda t: 3 if t < 6 else 2}
    env, stub, ref, _ = _pair(kw)
    _same(env.reset(), ref.reset())
    done = False
    while not done:
        _, _, done, over = _same(env.step(0), ref.step(0))
    assert done and not over and stub.n_resets == 1
    env2, _, ref2, _ = _pair(kw, terminal_on_life_loss=False)
    _same(env2.reset(), ref2.reset())
    for _ in range(4):
        _, _, done2, over2 = _same(env2.step(0), ref2.step(0))
        assert not done2 and not over2


def test_termination_sets_done_and_over():
    env, _, ref, _ = _pair({"terminate_at": 30}, noop_max=1)
    _same(env.reset(), ref.reset())
    done = over = False
    steps = 0
    while not over:
        _, _, done, over = _same(env.step(0), ref.step(0))
        steps += 1
    assert done and over and steps <= 30


def test_noop_starts():
    env, stub, ref, ref_stub = _pair(seed=7, noop_max=5)
    _same(env.reset(), ref.reset())
    n1 = len(stub.actions)
    assert 1 <= n1 <= 5 and all(a == 0 for a in stub.actions)
    _same(env.reset(), ref.reset())
    assert 1 <= len(stub.actions) - n1 <= 5
    assert stub.actions == ref_stub.actions


def test_observation_resizes_to_frame_shape():
    env, _, ref, _ = _pair({"hw": (20, 16)}, frame_shape=(10, 10))
    assert _same(env.reset(), ref.reset()).shape == (10, 10)
    obs, *_ = _same(env.step(1), ref.step(1))
    assert obs.shape == (10, 10)


def test_episode_step_cap_truncates_not_terminates():
    env, _, ref, _ = _pair(noop_max=1, max_episode_steps=5)
    _same(env.reset(), ref.reset())
    for i in range(4):
        _, _, done, over = _same(env.step(0), ref.step(0))
        assert not done and not over, f"capped early at step {i + 1}"
    _, _, done, over = _same(env.step(0), ref.step(0))
    assert over and not done
    _same(env.reset(), ref.reset())
    _, _, done, over = _same(env.step(0), ref.step(0))
    assert not over


def _digest(obs) -> str:
    return hashlib.sha256(np.ascontiguousarray(obs).tobytes()).hexdigest()


def test_preprocessing_golden_checksums():
    """The full stack (≤ 30 no-op starts, frame skip 4, 2-frame max, luma,
    84×84 area resize, reward sum and clip, life-loss done/over) through
    the port's class over the kit's 210×160 procedural frames: every
    observation's SHA-256, reward, done and over equal the frozen
    fixture's."""
    cfg = EnvConfig(id="golden", kind="atari", frame_shape=(84, 84),
                    frame_skip=4, reward_clip=1.0,
                    terminal_on_life_loss=True, noop_max=30)
    env = AtariEnv(cfg, seed=123, env=_ScriptedRaw())
    hashes = [_digest(env.reset())]
    rewards, dones, overs = [], [], []
    for i in range(N_STEPS):
        obs, r, done, over = env.step(i % 6)
        hashes.append(_digest(obs))
        rewards.append(r)
        dones.append(done)
        overs.append(over)
        if over:
            hashes.append(_digest(env.reset()))
    z = np.load(FIXTURE, allow_pickle=False)
    np.testing.assert_array_equal(np.asarray(hashes),
                                  z["hashes"].astype(str))
    np.testing.assert_array_equal(np.asarray(rewards, np.float32),
                                  z["rewards"])
    np.testing.assert_array_equal(np.asarray(dones), z["dones"])
    np.testing.assert_array_equal(np.asarray(overs), z["overs"])
