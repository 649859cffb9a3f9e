"""Environments + actor-side helpers (copy of the reference ``actors/game.py``).

Host-only numpy code, copied with its imports rewritten:

- ``SignalAtari`` — reward is a function of what's on screen (the
  learnability probe for the CNN + device-ring path).
- ``VelocitySignalAtari`` — reward is a function of the band's MOTION (the
  ``-vel`` ids): the temporal-integration probe for frame stacks and the
  recurrent net's memory.
- ``FakeAtari`` — deterministic counter frames for byte-exact replay tests.
- ``GymEnv`` — classic-control vector envs (the CartPole preset).
- ``FrameStacker`` — the rolling ``[H, W, stack]`` uint8 observation.
- ``NStepAccumulator`` — n-step transitions for the explicit-transition
  ``ReplayMemory`` (non-pixel envs).
- ``StepLatencyEnv`` and ``make_envs`` — the actor processes' step timer
  and per-row env builder.

``GymEnv`` and ``AtariEnv`` import ``gymnasium`` / ``ale_py`` only when they
are built, and raise a clear ``ImportError`` when the package is missing.

Truncation semantics: ``step`` returns ``(obs, reward, terminated,
episode_over)``; bootstrap discount is cut only on true termination.
"""

from __future__ import annotations

import time
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


class VelocitySignalAtari:
    """Pixel env whose reward is a function of MOTION, not appearance — the
    temporal-integration probe.

    One bright band drifts across the screen with a velocity drawn from
    ``num_actions`` distinct values; acting with the velocity's index pays
    +1. The band's POSITION is redrawn uniformly at every segment start,
    independent of the velocity, so a single frame carries zero reward
    information — Q* is constant over single frames. Beating random
    requires comparing at least two consecutive frames: the frame-stack
    path must read displacement across stack channels, and the stack=1
    recurrent path must carry the previous position in LSTM state. That is
    exactly the capability ``SignalAtari`` (static band ⇒ single-frame
    pattern matching) cannot test.

    Velocity changes every ``segment`` steps (with a fresh position), so
    ~1/segment of steps — plus the first step after reset, when the stack
    holds no prior same-segment frame — are unreadable even for a perfect
    decoder; the achievable ceiling is ≈ (1 - 1/segment) + 1/(segment·A)
    reward per step (~0.91 at segment=8, A=4) vs the 1/A = 0.25 random
    floor.

    Orientation "v": vertical band (spans all rows) drifting horizontally;
    "h": horizontal band drifting vertically — two distinct "games" for
    multi-game fleets, like SignalAtari's pair.
    """

    def __init__(self, episode_len: int = 32, num_actions: int = 4,
                 frame_shape: tuple[int, int] = (84, 84), seed: int = 0,
                 orientation: str = "v", segment: int = 8):
        """``segment=0`` holds the velocity for the WHOLE episode (only the
        reset redraws) — the easiest memory variant: read the motion once,
        carry the answer. Positive ``segment`` redraws velocity+position
        every that many steps."""
        assert orientation in ("v", "h")
        self.episode_len = int(episode_len)
        self.num_actions = int(num_actions)
        self.obs_shape = tuple(frame_shape)
        self.obs_dtype = np.uint8
        self.orientation = orientation
        self.segment = int(segment) if segment else self.episode_len + 1
        h, w = frame_shape
        self._axis = w if orientation == "v" else h
        self.band_width = max(3, self._axis // 8)
        # symmetric speeds, zero excluded (a parked band needs no temporal
        # integration to identify — it would reintroduce the single-frame
        # shortcut this env exists to remove): A=4 → (-2, -1, 1, 2) × u px
        u = max(2, self._axis // 16)
        half = self.num_actions // 2
        units = list(range(-half, 0)) + \
            list(range(1, self.num_actions - half + 1))
        self.velocities = tuple(int(u * m) for m in units)
        self._rng = np.random.default_rng(seed)
        self._t = 0
        self._v_idx = 0
        self._pos = 0

    def _redraw(self) -> None:
        self._v_idx = int(self._rng.integers(self.num_actions))
        self._pos = int(self._rng.integers(self._axis))

    def _frame(self) -> np.ndarray:
        f = np.full(self.obs_shape, 20, np.uint8)
        idx = (self._pos + np.arange(self.band_width)) % self._axis
        if self.orientation == "v":
            f[:, idx] = 220
        else:
            f[idx, :] = 220
        return f

    def reset(self) -> np.ndarray:
        self._t = 0
        self._redraw()
        return self._frame()

    def step(self, action: int):
        # reward keys on the velocity in effect over the frames the agent
        # just observed
        reward = 1.0 if int(action) == self._v_idx else 0.0
        self._t += 1
        if self._t % self.segment == 0:
            self._redraw()      # fresh velocity AND position: the new
            #                     position is independent of both the old
            #                     and new velocity, so boundary frames leak
            #                     nothing
        else:
            self._pos = (self._pos + self.velocities[self._v_idx]) \
                % self._axis
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


class StepLatencyEnv:
    """Transparent env wrapper timing each ``step()`` call (wall ms).

    The remote actor loops drain the buffer into the ``tm_env_step_ms``
    telemetry channel on every transition flush, giving the learner-side
    ``fleet/env_step_ms`` histogram its samples. The buffer is bounded so
    an actor that stops flushing (server gone, long episode) cannot grow
    it without limit — old samples fall off, which is the right bias for
    a latency distribution. Everything else delegates to the wrapped env.
    """

    def __init__(self, env: Env, maxlen: int = 512):
        self._env = env
        self._step_ms: deque = deque(maxlen=maxlen)

    def step(self, action: int):
        t0 = time.perf_counter()
        out = self._env.step(action)
        self._step_ms.append(1e3 * (time.perf_counter() - t0))
        return out

    def reset(self) -> np.ndarray:
        return self._env.reset()

    def drain_step_ms(self) -> list[float]:
        out = list(self._step_ms)
        self._step_ms.clear()
        return out

    def __getattr__(self, name: str):
        return getattr(self._env, name)


def make_env(cfg: EnvConfig, seed: int = 0) -> Env:
    if cfg.kind == "gym":
        return GymEnv(cfg.id, seed, reward_clip=cfg.reward_clip)
    if cfg.kind == "atari":
        return AtariEnv(cfg, seed)
    if cfg.kind == "fake_atari":
        return FakeAtari(frame_shape=cfg.frame_shape)
    if cfg.kind == "signal_atari":
        # id "signal" = vertical bands, "signal-h" = horizontal — two
        # distinct fake "games" for multi-game fleet tests; the "-vel"
        # ids select the moving-band temporal-integration variant
        orientation = "h" if cfg.id.endswith("-h") else "v"
        if "-vel" in cfg.id:
            # "-ep" holds velocity for the whole episode (memory-gate
            # difficulty tier); default redraws every 8 steps
            return VelocitySignalAtari(frame_shape=cfg.frame_shape,
                                       seed=seed, orientation=orientation,
                                       segment=0 if "-ep" in cfg.id else 8)
        return SignalAtari(frame_shape=cfg.frame_shape, seed=seed,
                           orientation=orientation)
    raise ValueError(f"unknown env kind {cfg.kind!r}")


def make_envs(cfgs, seeds) -> list[Env]:
    """Vector-aware ``make_env``: one env per (cfg, seed) row.

    ``cfgs`` is one EnvConfig (replicated across rows) or a per-row
    sequence (multi-game fleets pass ``env_for_actor`` output per
    global id). Building rows HERE keeps the per-row seeding discipline
    identical to the per-process fleet, which is what the bitwise-parity
    guarantee rides on.
    """
    if not isinstance(cfgs, (list, tuple)):
        cfgs = [cfgs] * len(seeds)
    if len(cfgs) != len(seeds):
        raise ValueError(f"{len(cfgs)} env configs vs {len(seeds)} seeds")
    return [make_env(c, seed=int(s)) for c, s in zip(cfgs, seeds)]


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


class NStepAccumulator:
    """Rolls (s, a, r) history into n-step transitions at the actor.

    Emits (obs, action, R_n, next_obs, discount) where R_n = Σ γᵏ r and
    discount = γⁿ·(1-done); on episode end, flushes the partial tail with
    the remaining horizon. Keeps the replay storage-agnostic about n.
    """

    def __init__(self, n_step: int, gamma: float):
        self.n = int(n_step)
        self.gamma = float(gamma)
        self._buf: deque = deque()

    def push(self, obs, action, reward, next_obs, done: bool):
        """Returns a list of matured transitions (possibly empty)."""
        out = []
        self._buf.append([obs, action, reward])
        if len(self._buf) >= self.n:
            out.append(self._compose(next_obs, done))
            self._buf.popleft()
        if done:
            while self._buf:
                out.append(self._compose(next_obs, True))
                self._buf.popleft()
        return out

    def flush_truncated(self, next_obs):
        """Flush the buffered tail at a time-limit truncation.

        Unlike episode termination, truncation keeps the bootstrap: each
        emitted transition gets discount γᵏ over its (shortened) horizon
        with ``next_obs`` = the final observed state.
        """
        out = []
        while self._buf:
            out.append(self._compose(next_obs, False))
            self._buf.popleft()
        return out

    def _compose(self, next_obs, done: bool):
        r, g = 0.0, 1.0
        for _, _, rew in self._buf:
            r += g * rew
            g *= self.gamma
        obs, action, _ = self._buf[0]
        return (obs, action, np.float32(r), next_obs,
                np.float32(0.0 if done else g))

    def reset(self) -> None:
        self._buf.clear()
