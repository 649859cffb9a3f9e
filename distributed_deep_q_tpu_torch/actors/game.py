"""Environments + actor-side helpers (copy of the reference ``actors/game.py``).

Host-only numpy code, copied with its imports rewritten. The port's slice
needs the pixel envs and the frame stacker:

- ``SignalAtari`` — reward is a function of what's on screen (the
  learnability probe for the CNN + device-ring path).
- ``FakeAtari`` — deterministic counter frames for byte-exact replay tests.
- ``FrameStacker`` — the rolling ``[H, W, stack]`` uint8 observation.

``GymEnv`` and ``AtariEnv`` import ``gymnasium`` / ``ale_py`` only when they
are built, and raise a clear ``ImportError`` when the package is missing.

Truncation semantics: ``step`` returns ``(obs, reward, terminated,
episode_over)``; bootstrap discount is cut only on true termination.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Protocol

import numpy as np

from distributed_deep_q_tpu_torch.config import EnvConfig


class Env(Protocol):
    num_actions: int
    obs_shape: tuple[int, ...]
    obs_dtype: Any

    def reset(self) -> np.ndarray: ...
    def step(self, action: int) -> tuple[np.ndarray, float, bool, bool]: ...


class GymEnv:
    """Vector-observation gymnasium adapter (classic control)."""

    def __init__(self, env_id: str = "CartPole-v1", seed: int = 0,
                 reward_clip: float = 0.0):
        try:
            import gymnasium
        except ImportError as e:
            raise ImportError(
                "env.kind='gym' needs the gymnasium package, which is not "
                "installed; use env.kind=signal_atari or fake_atari") from e

        self._env = gymnasium.make(env_id)
        self._seed = seed
        self._n_resets = 0
        self._reward_clip = float(reward_clip)
        self.num_actions = int(self._env.action_space.n)
        self.obs_shape = tuple(self._env.observation_space.shape)
        self.obs_dtype = np.float32

    def reset(self) -> np.ndarray:
        obs, _ = self._env.reset(seed=self._seed + self._n_resets)
        self._n_resets += 1
        return np.asarray(obs, np.float32)

    def step(self, action: int):
        obs, reward, terminated, truncated, _ = self._env.step(int(action))
        reward = float(reward)
        if self._reward_clip > 0:
            reward = float(np.clip(reward, -self._reward_clip,
                                   self._reward_clip))
        return (np.asarray(obs, np.float32), reward,
                bool(terminated), bool(terminated or truncated))


class FakeAtari:
    """Deterministic frame env: pixel values count up with the step index.

    Episode length and rewards are fixed functions of the step counter, so
    replay contents are byte-predictable.
    """

    def __init__(self, episode_len: int = 10, num_actions: int = 4,
                 frame_shape: tuple[int, int] = (84, 84)):
        self.episode_len = episode_len
        self.num_actions = num_actions
        self.obs_shape = tuple(frame_shape)
        self.obs_dtype = np.uint8
        self._t = 0          # within-episode step
        self._global = 0     # global frame counter (mod 256)

    def _frame(self) -> np.ndarray:
        return np.full(self.obs_shape, self._global % 256, np.uint8)

    def reset(self) -> np.ndarray:
        self._t = 0
        self._global += 1
        return self._frame()

    def step(self, action: int):
        self._t += 1
        self._global += 1
        done = self._t >= self.episode_len
        reward = 1.0 if self._t % 3 == 0 else 0.0
        return self._frame(), reward, done, done


class SignalAtari:
    """Pixel env whose reward is a function of what's ON SCREEN.

    Each observation shows one bright band (out of ``num_actions`` bands;
    vertical or horizontal per ``orientation``) on a dark background; acting
    with the band's index pays +1, anything else 0, and a new band is drawn
    uniformly each step. The policy must read the pixels to beat the
    1/num_actions random-policy return.
    """

    def __init__(self, episode_len: int = 32, num_actions: int = 4,
                 frame_shape: tuple[int, int] = (84, 84), seed: int = 0,
                 orientation: str = "v"):
        assert orientation in ("v", "h")
        self.episode_len = int(episode_len)
        self.num_actions = int(num_actions)
        self.obs_shape = tuple(frame_shape)
        self.obs_dtype = np.uint8
        self.orientation = orientation
        self._rng = np.random.default_rng(seed)
        self._t = 0
        self._target = 0

    def _frame(self) -> np.ndarray:
        f = np.full(self.obs_shape, 20, np.uint8)
        h, w = self.obs_shape
        if self.orientation == "v":
            band = w // self.num_actions
            f[:, self._target * band:(self._target + 1) * band] = 220
        else:
            band = h // self.num_actions
            f[self._target * band:(self._target + 1) * band, :] = 220
        return f

    def reset(self) -> np.ndarray:
        self._t = 0
        self._target = int(self._rng.integers(self.num_actions))
        return self._frame()

    def step(self, action: int):
        self._t += 1
        reward = 1.0 if int(action) == self._target else 0.0
        self._target = int(self._rng.integers(self.num_actions))
        done = self._t >= self.episode_len
        return self._frame(), reward, done, done


# ---------------------------------------------------------------------------
# Atari (ALE) with canonical DQN preprocessing
# ---------------------------------------------------------------------------


def _resize_area(img: np.ndarray, out_hw: tuple[int, int]) -> np.ndarray:
    """Bilinear sampling at pixel centres in pure numpy — the one resize
    used everywhere, fixed for eval comparability."""
    h, w = img.shape
    oh, ow = out_hw
    ys = (np.arange(oh) + 0.5) * h / oh - 0.5
    xs = (np.arange(ow) + 0.5) * w / ow - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    wy = np.clip(ys - y0, 0.0, 1.0)[:, None]
    wx = np.clip(xs - x0, 0.0, 1.0)[None, :]
    f = img.astype(np.float32)
    top = f[y0][:, x0] * (1 - wx) + f[y0][:, x1] * wx
    bot = f[y1][:, x0] * (1 - wx) + f[y1][:, x1] * wx
    return ((1 - wy) * top + wy * bot).astype(np.uint8)


class AtariEnv:
    """ALE-backed Atari with Nature-DQN preprocessing (frame_skip=4, max
    over the last 2 raw frames, 84×84 grayscale, reward clip ±1,
    terminal-on-life-loss, ≤30 random noops at reset)."""

    def __init__(self, cfg: EnvConfig, seed: int = 0, env=None):
        """``env`` injects a pre-built gymnasium-compatible raw env."""
        if env is None:
            try:
                import ale_py  # noqa: F401
                import gymnasium
            except ImportError as e:
                raise ImportError(
                    "env.kind='atari' needs ale_py, gymnasium and the Atari "
                    "ROMs, which are not installed; use "
                    "env.kind=signal_atari or fake_atari") from e
            kwargs = ({"full_action_space": True}
                      if cfg.full_action_space else {})
            env = gymnasium.make(cfg.id, frameskip=1,
                                 repeat_action_probability=0.0, **kwargs)
        self.cfg = cfg
        self._env = env
        self._seed = seed
        self._n_resets = 0
        self._rng = np.random.default_rng(seed)
        self.num_actions = int(self._env.action_space.n)
        self.obs_shape = tuple(cfg.frame_shape)
        self.obs_dtype = np.uint8
        self._lives = 0
        self._steps = 0
        self._raw = deque(maxlen=2)

    def _observe(self) -> np.ndarray:
        maxed = np.max(np.stack(self._raw), axis=0) if len(self._raw) > 1 \
            else self._raw[-1]
        gray = (0.299 * maxed[..., 0] + 0.587 * maxed[..., 1]
                + 0.114 * maxed[..., 2]).astype(np.uint8)
        return _resize_area(gray, self.cfg.frame_shape)

    def reset(self) -> np.ndarray:
        obs, info = self._env.reset(seed=self._seed + self._n_resets)
        self._n_resets += 1
        self._steps = 0
        self._raw.clear()
        self._raw.append(obs)
        for _ in range(int(self._rng.integers(1, self.cfg.noop_max + 1))):
            obs, _, term, trunc, info = self._env.step(0)
            self._raw.append(obs)
            if term or trunc:
                obs, info = self._env.reset()
                self._raw.clear()
                self._raw.append(obs)
        self._lives = info.get("lives", 0)
        return self._observe()

    def step(self, action: int):
        total = 0.0
        terminated = truncated = False
        for _ in range(self.cfg.frame_skip):
            obs, r, terminated, truncated, info = self._env.step(int(action))
            self._raw.append(obs)
            total += float(r)
            if terminated or truncated:
                break
        life_lost = False
        if self.cfg.terminal_on_life_loss:
            lives = info.get("lives", self._lives)
            life_lost = 0 < lives < self._lives
            self._lives = lives
        if self.cfg.reward_clip > 0:
            total = float(np.clip(total, -self.cfg.reward_clip,
                                  self.cfg.reward_clip))
        self._steps += 1
        if self.cfg.max_episode_steps > 0 \
                and self._steps >= self.cfg.max_episode_steps:
            truncated = True
        done = terminated or life_lost          # cuts bootstrap
        over = terminated or truncated          # needs env.reset()
        return self._observe(), total, done, over


def make_env(cfg: EnvConfig, seed: int = 0) -> Env:
    if cfg.kind == "gym":
        return GymEnv(cfg.id, seed, reward_clip=cfg.reward_clip)
    if cfg.kind == "atari":
        return AtariEnv(cfg, seed)
    if cfg.kind == "fake_atari":
        return FakeAtari(frame_shape=cfg.frame_shape)
    if cfg.kind == "signal_atari":
        # id "signal" = vertical bands, "signal-h" = horizontal
        if "-vel" in cfg.id:
            raise NotImplementedError(
                "the moving-band SignalAtari ids (-vel) are not ported yet "
                "(ROADMAP A6)")
        orientation = "h" if cfg.id.endswith("-h") else "v"
        return SignalAtari(frame_shape=cfg.frame_shape, seed=seed,
                           orientation=orientation)
    raise ValueError(f"unknown env kind {cfg.kind!r}")


class FrameStacker:
    """Maintains the rolling [H, W, stack] uint8 observation for pixel envs
    (zero-fill at episode start, newest frame in the last channel)."""

    def __init__(self, frame_shape: tuple[int, int], stack: int):
        self._buf = np.zeros(tuple(frame_shape) + (stack,), np.uint8)

    def reset(self, frame: np.ndarray) -> np.ndarray:
        self._buf[:] = 0
        self._buf[..., -1] = frame
        return self._buf

    def push(self, frame: np.ndarray) -> np.ndarray:
        self._buf = np.roll(self._buf, -1, axis=-1)
        self._buf[..., -1] = frame
        return self._buf

    @property
    def obs(self) -> np.ndarray:
        return self._buf
