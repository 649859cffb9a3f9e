"""Replay memory — host-RAM transition ring buffers (copy of the reference
``replay/replay_memory.py``; host numpy only).

Two storage strategies, same ``add``/``sample``/``__len__`` surface:

- ``ReplayMemory`` — explicit transitions: stores obs and next_obs as given.
  Right for vector envs (CartPole), where no temporal adjacency is assumed.

- ``FrameStackReplay`` — memory-optimal Atari mode: stores ONE frame per
  step plus (action, reward, done) and composes the frame stack, the
  n-step return and the next-state stack at sample time from ring
  adjacency (Nature-DQN storage trick). Requires a single temporally-
  contiguous writer stream. With ``store_frames=False`` it keeps only the
  metadata: the mode the device replays' per-slot rings use, where frames
  live on the device.

``sample`` returns a dict batch with keys
``obs, action, reward, next_obs, discount, weight, index`` where
``reward`` is the n-step-summed return, ``discount`` = γⁿ·(1-done) ready for
``targets = reward + discount * max_a Q⁻(next_obs)``, ``weight`` the
importance weight (ones for uniform), and ``index`` the slot indices for
PER priority updates (``replay/prioritized.py``).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np


class ReplayMemory:
    """Uniform ring buffer over explicit (s, a, r, s', discount) transitions."""

    prioritized = False  # uniform sampling; PER wraps via replay/prioritized.py

    def ready(self, learn_start: int) -> bool:
        return len(self) >= learn_start

    def __init__(
        self,
        capacity: int,
        obs_shape: tuple[int, ...],
        obs_dtype: np.dtype = np.float32,
        seed: int = 0,
    ):
        self.capacity = int(capacity)
        self.obs = np.zeros((capacity,) + tuple(obs_shape), obs_dtype)
        self.next_obs = np.zeros_like(self.obs)
        self.action = np.zeros(capacity, np.int32)
        self.reward = np.zeros(capacity, np.float32)
        self.discount = np.zeros(capacity, np.float32)
        self._cursor = 0
        self._size = 0
        self._steps_added = 0
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self._size

    @property
    def steps_added(self) -> int:
        return self._steps_added

    def add(self, obs, action, reward, next_obs, discount) -> int:
        """Add one transition; returns the slot index it landed in."""
        i = self._cursor
        self.obs[i] = obs
        self.next_obs[i] = next_obs
        self.action[i] = action
        self.reward[i] = reward
        self.discount[i] = discount
        self._cursor = (i + 1) % self.capacity
        self._size = min(self._size + 1, self.capacity)
        self._steps_added += 1
        return i

    def add_batch(self, batch: Mapping[str, np.ndarray]) -> np.ndarray:
        """Vectorized add of a transition batch; returns slot indices."""
        n = len(batch["action"])
        idx = (self._cursor + np.arange(n)) % self.capacity
        self.obs[idx] = batch["obs"]
        self.next_obs[idx] = batch["next_obs"]
        self.action[idx] = batch["action"]
        self.reward[idx] = batch["reward"]
        self.discount[idx] = batch["discount"]
        self._cursor = int((self._cursor + n) % self.capacity)
        self._size = min(self._size + n, self.capacity)
        self._steps_added += n
        return idx

    def gather(self, idx: np.ndarray) -> dict[str, np.ndarray]:
        return {
            "obs": self.obs[idx],
            "action": self.action[idx],
            "reward": self.reward[idx],
            "next_obs": self.next_obs[idx],
            "discount": self.discount[idx],
            "weight": np.ones(len(idx), np.float32),
            "index": idx.astype(np.int32),
        }

    def sample(self, batch_size: int) -> dict[str, np.ndarray]:
        assert self._size > 0, "sample() from empty ReplayMemory"
        idx = self._rng.integers(0, self._size, size=batch_size)
        return self.gather(idx)


class FrameStackReplay:
    """Single-frame ring with stack + n-step composition at sample time.

    Stores per step: frame uint8 [H, W], action, reward, done, boundary.
    ``done`` cuts the bootstrap (true termination); ``boundary`` marks any
    episode end including time-limit truncation — frame stacks never cross a
    boundary, and candidate transitions whose n-step window crosses a
    truncation-only boundary (boundary & ~done: no valid next state, but
    bootstrapping is still correct in principle) are excluded from sampling
    rather than corrupting Bellman targets. A sampled transition at slot
    ``i`` is:

      obs      = frames[i-stack+1 .. i]   (zeroed before episode start)
      reward   = Σ_{k<m} γᵏ r_{i+k}       (m = steps until first done, ≤ n)
      discount = γᵐ if no done in window else 0
      next_obs = frames[i+n-stack+1 .. i+n]

    Requires adds to be temporally contiguous (single writer stream).
    """

    prioritized = False

    def ready(self, learn_start: int) -> bool:
        return (len(self) >= max(learn_start, self.stack + self.n_step + 1)
                and self.valid_fraction() > 0)

    def __init__(
        self,
        capacity: int,
        frame_shape: tuple[int, int] = (84, 84),
        stack: int = 4,
        n_step: int = 1,
        gamma: float = 0.99,
        seed: int = 0,
        store_frames: bool = True,
    ):
        """``store_frames=False`` keeps only metadata (action/reward/done/
        boundary + ring indices) — the mode used by the device-resident
        replay (``replay/device_ring.py``), where frames live on the device
        and this class supplies index/validity/n-step composition via
        ``gather_meta``."""
        self.capacity = int(capacity)
        self.stack = int(stack)
        self.n_step = int(n_step)
        self.gamma = float(gamma)
        self.frames = (np.zeros((capacity,) + tuple(frame_shape), np.uint8)
                       if store_frames else None)
        self.action = np.zeros(capacity, np.int32)
        self.reward = np.zeros(capacity, np.float32)
        self.done = np.zeros(capacity, bool)       # cuts bootstrap
        self.boundary = np.zeros(capacity, bool)   # episode end incl. truncation
        self._cursor = 0
        self._size = 0
        self._steps_added = 0
        self._rng = np.random.default_rng(seed)
        # γ^k lookup for the n-step return
        self._gammas = gamma ** np.arange(n_step + 1, dtype=np.float32)

    def __len__(self) -> int:
        return self._size

    @property
    def steps_added(self) -> int:
        return self._steps_added

    def add(self, frame, action, reward, done, boundary=None) -> int:
        i = self._cursor
        if self.frames is not None:
            self.frames[i] = frame
        self.action[i] = action
        self.reward[i] = reward
        self.done[i] = done
        self.boundary[i] = done if boundary is None else boundary
        self._cursor = (i + 1) % self.capacity
        self._size = min(self._size + 1, self.capacity)
        self._steps_added += 1
        return i

    def add_batch(self, batch: Mapping[str, np.ndarray]) -> np.ndarray:
        n = len(batch["action"])
        idx = (self._cursor + np.arange(n)) % self.capacity
        if self.frames is not None:
            self.frames[idx] = batch["frame"]
        self.action[idx] = batch["action"]
        self.reward[idx] = batch["reward"]
        self.done[idx] = batch["done"]
        self.boundary[idx] = batch.get("boundary", batch["done"])
        self._cursor = int((self._cursor + n) % self.capacity)
        self._size = min(self._size + n, self.capacity)
        self._steps_added += n
        return idx

    def seal_stream(self) -> None:
        """Mark an episode boundary on the last written row.

        Called when the writer stream changes identity mid-episode: without
        the seal, sampled stacks and n-step windows could straddle two
        writers' episodes. ``done`` stays False — the truncation-only
        boundary excludes straddling windows from sampling rather than
        faking a terminal.
        """
        if self._size:
            self.boundary[(self._cursor - 1) % self.capacity] = True

    # -- sampling ----------------------------------------------------------

    def _invalid(self, idx: np.ndarray) -> np.ndarray:
        """True where a candidate slot can't form a full transition.

        A slot is invalid when its [i-stack+1, i+n] window crosses the write
        cursor (frames from two different epochs of the ring), falls off
        either end before the ring is full, or its n-step window crosses a
        truncation-only boundary (episode ended by time limit: no valid
        next state stored, so the transition cannot form a correct target).
        """
        if self._size < self.capacity:
            bad = (idx < self.stack - 1) | (idx + self.n_step >= self._size)
        else:
            # distance from the cursor going backwards; the (stack-1 + n)
            # slots straddling the cursor are unusable
            back = (idx - self._cursor) % self.capacity
            bad = (back >= self.capacity - self.n_step) | (back < self.stack - 1)
        steps = (idx[:, None] + np.arange(self.n_step)[None, :]) % self.capacity
        trunc_only = self.boundary[steps] & ~self.done[steps]
        return bad | trunc_only.any(axis=1)

    def valid_fraction(self) -> float:
        if self._size == 0:
            return 0.0
        window = self.stack - 1 + self.n_step
        return max(0.0, 1.0 - window / max(self._size, 1))

    def sample_indices(self, batch_size: int) -> np.ndarray:
        assert self._size > self.stack + self.n_step, "replay too small to sample"
        idx = self._rng.integers(0, self._size, size=batch_size)
        bad = self._invalid(idx)
        tries = 0
        while bad.any():
            idx[bad] = self._rng.integers(0, self._size, size=int(bad.sum()))
            bad = self._invalid(idx)
            tries += 1
            if tries > 1000:  # e.g. every stored episode truncated + tiny ring
                raise RuntimeError(
                    f"FrameStackReplay: no sampleable transition found after "
                    f"{tries} rounds (size={self._size}, stack={self.stack}, "
                    f"n_step={self.n_step}); buffer likely contains only "
                    f"truncated episodes shorter than stack-1+n_step")
        return idx

    def _stack_indices(self, idx: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(frame indices [B, stack] oldest-first, validity mask [B, stack]).

        A frame at offset k is valid iff no episode boundary lies between it
        and the anchor frame; invalid frames are zero-filled (episode-start
        padding), matching ``FrameStacker.reset`` semantics.
        """
        b, cap = len(idx), self.capacity
        offs = np.arange(self.stack - 1, -1, -1)
        oidx = (idx[:, None] - offs[None, :]) % cap          # [B, stack]
        prev_done = self.boundary[(oidx - 1) % cap]          # boundary before frame
        # valid[b, j]: product over frames newer than j of (no boundary
        # before them), computed right-to-left (newest frame always valid).
        valid = np.ones((b, self.stack), bool)
        for j in range(self.stack - 2, -1, -1):
            valid[:, j] = valid[:, j + 1] & ~prev_done[:, j + 1]
        return oidx, valid

    def gather_meta(self, idx: np.ndarray) -> dict[str, np.ndarray]:
        """Everything ``gather`` needs except the frame pixels themselves:
        stack indices + validity masks for s and s', the n-step return, and
        the bootstrap discount. This is the host side of the device-resident
        replay split — frames are gathered on the device from these
        indices."""
        b, cap, n = len(idx), self.capacity, self.n_step

        oidx, valid = self._stack_indices(idx)

        steps = (idx[:, None] + np.arange(n)[None, :]) % cap  # [B, n]
        d = self.done[steps]                                   # [B, n]
        # continuing[b, k] = no done strictly before step k in the window
        continuing = np.ones((b, n), bool)
        if n > 1:
            continuing[:, 1:] = ~np.cumsum(d[:, :-1], axis=1).astype(bool)
        rewards = self.reward[steps] * continuing
        reward = (rewards * self._gammas[:n][None, :]).sum(axis=1)
        any_done = (d & continuing).any(axis=1)
        discount = np.where(any_done, 0.0, self._gammas[n]).astype(np.float32)

        noidx, nvalid = self._stack_indices((idx + n) % cap)
        return {
            "oidx": oidx.astype(np.int32),
            "valid": valid,
            "noidx": noidx.astype(np.int32),
            "nvalid": nvalid,
            "action": self.action[idx],
            "reward": reward.astype(np.float32),
            "discount": discount,
            "weight": np.ones(b, np.float32),
            "index": idx.astype(np.int32),
        }

    def gather(self, idx: np.ndarray) -> dict[str, np.ndarray]:
        assert self.frames is not None, \
            "gather() needs stored frames; metadata-only rings use gather_meta()"
        m = self.gather_meta(idx)
        obs = self.frames[m.pop("oidx")] \
            * m.pop("valid")[..., None, None].astype(np.uint8)
        next_obs = self.frames[m.pop("noidx")] \
            * m.pop("nvalid")[..., None, None].astype(np.uint8)
        # frames-last layout for the CNN: [B, H, W, stack]
        m["obs"] = np.moveaxis(obs, 1, -1)
        m["next_obs"] = np.moveaxis(next_obs, 1, -1)
        return m

    def sample(self, batch_size: int) -> dict[str, np.ndarray]:
        return self.gather(self.sample_indices(batch_size))
