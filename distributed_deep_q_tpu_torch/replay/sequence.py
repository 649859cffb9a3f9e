"""Sequence replay for recurrent (R2D2) Q-learning — config 5 [M] (a copy
of the reference's ``replay/sequence.py``; numpy only).

The reference has no sequence capability; the BASELINE.json config matrix
mandates "R2D2 recurrent (LSTM) Q-net, sequence replay" as the stretch
target. Design per Kapturowski et al. 2019:

- Fixed-length sequences of ``seq_len`` steps (``burn_in`` prefix + train
  window), stored with the **LSTM state at sequence start** (the
  "stored-state" strategy; staleness is tolerated because burn-in refreshes
  the carry before any gradient step — SURVEY §7.3 item 3).
- Adjacent sequences from one episode overlap by ``burn_in`` steps
  (R2D2's period = seq_len − burn_in emission schedule).
- Episode tails shorter than ``seq_len`` are zero-padded and masked; the
  mask also excludes burn-in steps from the loss (handled in the learner).
- Optional per-sequence PER with the R2D2 mixed max/mean |TD| priority
  (``ops/losses.sequence_dqn_loss``).

``SequenceBuilder`` is the actor-side window assembler: it tracks per-step
carries and emits ready sequences; ``SequenceReplay`` is the learner-side
store with the reference ``add``/``sample``/``__len__`` surface shape.
"""

from __future__ import annotations

from collections import deque
from typing import Any

import numpy as np

from distributed_deep_q_tpu_torch.replay.prioritized import (
    SumTree, beta_at, filter_stale)


class SequenceReplay:
    """Ring buffer of fixed-length sequences with optional PER."""

    def __init__(
        self,
        capacity: int,
        seq_len: int,
        obs_shape: tuple[int, ...],
        obs_dtype=np.float32,
        lstm_size: int = 512,
        prioritized: bool = False,
        alpha: float = 0.9,
        beta0: float = 0.6,
        beta_steps: int = 1_000_000,
        eps: float = 1e-6,
        seed: int = 0,
        use_native: bool = True,
    ):
        self.capacity = int(capacity)
        self.seq_len = int(seq_len)
        t = self.seq_len
        self.obs = np.zeros((capacity, t + 1) + tuple(obs_shape), obs_dtype)
        self.action = np.zeros((capacity, t), np.int32)
        self.reward = np.zeros((capacity, t), np.float32)
        self.discount = np.zeros((capacity, t), np.float32)
        self.mask = np.zeros((capacity, t), np.float32)
        self.init_c = np.zeros((capacity, lstm_size), np.float32)
        self.init_h = np.zeros((capacity, lstm_size), np.float32)
        self._cursor = 0
        self._size = 0
        self._seqs_added = 0
        self._rng = np.random.default_rng(seed)

        self.prioritized = bool(prioritized)
        self.alpha, self.beta0 = float(alpha), float(beta0)
        self.beta_steps, self.eps = int(beta_steps), float(eps)
        self.tree = (SumTree(capacity, use_native=use_native)
                     if prioritized else None)
        self.max_priority = 1.0
        self._samples = 0

    def __len__(self) -> int:
        return self._size

    @property
    def steps_added(self) -> int:
        return self._seqs_added

    def ready(self, learn_start: int) -> bool:
        """``learn_start`` counts *sequences* in the recurrent pipeline."""
        return self._size >= max(learn_start, 1)

    @property
    def beta(self) -> float:
        return beta_at(self._samples, self.beta0, self.beta_steps)

    # -- write --------------------------------------------------------------

    def add_sequence(self, seq: dict[str, np.ndarray]) -> int:
        i = self._cursor
        self.obs[i] = seq["obs"]
        self.action[i] = seq["action"]
        self.reward[i] = seq["reward"]
        self.discount[i] = seq["discount"]
        self.mask[i] = seq["mask"]
        self.init_c[i] = seq["init_c"]
        self.init_h[i] = seq["init_h"]
        if self.prioritized:
            self.tree.set(np.asarray([i]),
                          np.asarray([self.max_priority ** self.alpha]))
        self._cursor = (i + 1) % self.capacity
        self._size = min(self._size + 1, self.capacity)
        self._seqs_added += 1
        return i

    def add_batch(self, batch: dict[str, np.ndarray]) -> np.ndarray:
        """Batch of sequences (RPC path): leading dim = sequence count."""
        n = len(batch["action"])
        return np.asarray([
            self.add_sequence({k: v[j] for k, v in batch.items()})
            for j in range(n)], np.int64)

    # -- sample -------------------------------------------------------------

    def sample(self, batch_size: int) -> dict[str, Any]:
        assert self._size > 0, "sample() from empty SequenceReplay"
        self._samples += 1
        if self.prioritized:
            idx = self.tree.sample_stratified(batch_size, self._rng)
            p = self.tree.get(idx)
            probs = np.maximum(p / max(self.tree.total, 1e-12), 1e-12)
            w = (self._size * probs) ** (-self.beta)
            weight = (w / w.max()).astype(np.float32)
        else:
            idx = self._rng.integers(0, self._size, size=batch_size)
            weight = np.ones(batch_size, np.float32)
        return {
            "obs": self.obs[idx],
            "action": self.action[idx],
            "reward": self.reward[idx],
            "discount": self.discount[idx],
            "mask": self.mask[idx],
            "init_c": self.init_c[idx],
            "init_h": self.init_h[idx],
            "weight": weight,
            "index": idx.astype(np.int32),
            "_sampled_at": self._seqs_added,
        }

    def update_priorities(self, idx: np.ndarray, priority: np.ndarray,
                          sampled_at: int | None = None) -> None:
        """Per-sequence priorities from the learner's mixed max/mean |TD|."""
        if not self.prioritized:
            return
        idx = np.asarray(idx, np.int64)
        p = np.abs(np.asarray(priority, np.float64)) + self.eps
        if sampled_at is not None:
            idx, p = filter_stale(idx, p, self._seqs_added, sampled_at,
                                  self.capacity)
            if idx.size == 0:
                return
        self.tree.set(idx, p ** self.alpha)
        self.max_priority = max(self.max_priority, float(p.max()))


class SequenceBuilder:
    """Actor-side sliding-window sequence assembler.

    Call ``on_step`` with each transition and the LSTM carry the policy held
    *before* consuming ``obs``; sequences of ``seq_len`` steps are emitted
    every ``seq_len − burn_in`` steps (overlapping windows) and at episode
    end (zero-padded + masked). The emitted dict matches
    ``SequenceReplay.add_sequence``.
    """

    def __init__(self, seq_len: int, burn_in: int,
                 obs_shape: tuple[int, ...], obs_dtype=np.float32,
                 lstm_size: int = 512, gamma: float = 0.99):
        assert 0 <= burn_in < seq_len
        self.seq_len, self.burn_in = int(seq_len), int(burn_in)
        self.period = self.seq_len - self.burn_in
        self.obs_shape, self.obs_dtype = tuple(obs_shape), obs_dtype
        self.lstm_size = int(lstm_size)
        self.gamma = float(gamma)
        # each entry: (obs, action, reward, done, (c, h) before the step)
        self._steps: deque = deque(maxlen=seq_len)
        self._since_emit = 0

    def reset(self) -> None:
        self._steps.clear()
        self._since_emit = 0

    def _emit(self, final_obs: np.ndarray) -> dict[str, np.ndarray]:
        t = self.seq_len
        n = len(self._steps)
        seq = {
            "obs": np.zeros((t + 1,) + self.obs_shape, self.obs_dtype),
            "action": np.zeros(t, np.int32),
            "reward": np.zeros(t, np.float32),
            "discount": np.zeros(t, np.float32),
            "mask": np.zeros(t, np.float32),
            "init_c": np.zeros(self.lstm_size, np.float32),
            "init_h": np.zeros(self.lstm_size, np.float32),
        }
        c, h = self._steps[0][4]
        seq["init_c"], seq["init_h"] = np.asarray(c), np.asarray(h)
        for j, (obs, a, r, done, _) in enumerate(self._steps):
            seq["obs"][j] = obs
            seq["action"][j] = a
            seq["reward"][j] = r
            seq["discount"][j] = 0.0 if done else self.gamma
            seq["mask"][j] = 1.0
        seq["obs"][n] = final_obs
        return seq

    def on_step(self, obs, action, reward, done: bool, carry,
                next_obs) -> list[dict[str, np.ndarray]]:
        """Returns emitted sequences (possibly empty). ``carry`` is the
        (c, h) the policy held before acting on ``obs``."""
        c, h = carry
        self._steps.append((np.asarray(obs), int(action), float(reward),
                            bool(done), (np.asarray(c).reshape(-1),
                                         np.asarray(h).reshape(-1))))
        self._since_emit += 1
        out = []
        if len(self._steps) == self.seq_len and (
                self._since_emit >= self.period or done):
            out.append(self._emit(np.asarray(next_obs)))
            self._since_emit = 0
        elif done and self._steps:
            out.append(self._emit(np.asarray(next_obs)))
            self._since_emit = 0
        if done:
            self._steps.clear()
        return out

    def flush_truncated(self, final_obs) -> list[dict[str, np.ndarray]]:
        """Emit the pending window at a time-limit truncation.

        Unlike termination, truncation keeps the bootstrap: the last step's
        discount stays γ and ``final_obs`` fills the bootstrap slot, so the
        tail of every truncated episode still reaches replay (the sequence
        analogue of ``NStepAccumulator.flush_truncated``). A no-op when the
        window was just emitted (nothing new since).
        """
        out = []
        if self._steps and self._since_emit > 0:
            out.append(self._emit(np.asarray(final_obs)))
        self._steps.clear()
        self._since_emit = 0
        return out
