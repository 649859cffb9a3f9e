"""Per-slot replay metadata ring (port of the reference ``FrameStackReplay``
in its ``store_frames=False`` mode, the one the device replay's slots use).

Stores per step the action, reward, ``done`` (cuts the bootstrap) and
``boundary`` (any episode end, truncation included); frames live on the
device (``replay/device_per.py``). The ring's host side answers the
questions the device replay asks of a slot: its write cursor, its fill and
whether it can sample yet. Host numpy only, copied from the reference.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np


class FrameStackReplay:
    """Single-writer metadata ring: a sampled transition at slot ``i`` is
    the stack ``[i-stack+1 .. i]``, the n-step return over
    ``[i .. i+n-1]`` and the next stack ending at ``i+n``; windows never
    cross a boundary or the write cursor."""

    def __init__(self, capacity: int, stack: int = 4, n_step: int = 1):
        self.capacity = int(capacity)
        self.stack = int(stack)
        self.n_step = int(n_step)
        self.action = np.zeros(capacity, np.int32)
        self.reward = np.zeros(capacity, np.float32)
        self.done = np.zeros(capacity, bool)       # cuts bootstrap
        self.boundary = np.zeros(capacity, bool)   # episode end incl. truncation
        self._cursor = 0
        self._size = 0

    def __len__(self) -> int:
        return self._size

    def add(self, frame, action, reward, done, boundary=None) -> int:
        """Append one step (``frame`` is ignored: frames live on device)."""
        i = self._cursor
        self.action[i] = action
        self.reward[i] = reward
        self.done[i] = done
        self.boundary[i] = done if boundary is None else boundary
        self._cursor = (i + 1) % self.capacity
        self._size = min(self._size + 1, self.capacity)
        return i

    def add_batch(self, batch: Mapping[str, np.ndarray]) -> np.ndarray:
        n = len(batch["action"])
        idx = (self._cursor + np.arange(n)) % self.capacity
        self.action[idx] = batch["action"]
        self.reward[idx] = batch["reward"]
        self.done[idx] = batch["done"]
        self.boundary[idx] = batch.get("boundary", batch["done"])
        self._cursor = int((self._cursor + n) % self.capacity)
        self._size = min(self._size + n, self.capacity)
        return idx

    def valid_fraction(self) -> float:
        if self._size == 0:
            return 0.0
        window = self.stack - 1 + self.n_step
        return max(0.0, 1.0 - window / max(self._size, 1))
