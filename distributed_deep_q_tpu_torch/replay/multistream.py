"""Host-RAM multi-stream pixel replay — the ``device_resident=False``
fallback for the distributed pixel topology.

``FrameStackReplay`` (replay/replay_memory.py) requires one temporally
contiguous writer stream; the RPC fleet interleaves many. This wrapper gives
each actor stream its own ``FrameStackReplay`` shard (capacity split
evenly), preserving the adjacency invariant per shard — the host-side
analogue of the device ring's slot layout (replay/device_ring.py), with
pixels gathered on host and shipped as full minibatches (the path the
reference's Caffe blob loads took, SURVEY §3.1). A copy of the reference
``replay/multistream.py``; host only.

Uniform sampling only: PER over cross-shard global indices belongs to the
device ring; the distributed entry point rejects the
``prioritized && !device_resident`` combination explicitly.
"""

from __future__ import annotations

import numpy as np

from distributed_deep_q_tpu_torch.replay.prioritized import allocate_proportional
from distributed_deep_q_tpu_torch.replay.replay_memory import FrameStackReplay


class MultiStreamFrameReplay:
    """N per-stream ``FrameStackReplay`` shards behind one buffer surface."""

    prioritized = False

    def __init__(
        self,
        capacity: int,
        frame_shape: tuple[int, int] = (84, 84),
        stack: int = 4,
        n_step: int = 1,
        gamma: float = 0.99,
        num_streams: int = 1,
        seed: int = 0,
    ):
        self.num_streams = max(int(num_streams), 1)
        per = int(capacity) // self.num_streams
        assert per > stack + n_step + 2, (
            f"capacity {capacity} too small for {num_streams} streams")
        self.shard_cap = per
        self.capacity = per * self.num_streams
        self.shards = [
            FrameStackReplay(per, frame_shape, stack, n_step, gamma,
                             seed=seed + i)
            for i in range(self.num_streams)]
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return sum(len(s) for s in self.shards)

    @property
    def steps_added(self) -> int:
        return sum(s.steps_added for s in self.shards)

    def _sampleable(self, i: int) -> int:
        s = self.shards[i]
        window = s.stack + s.n_step + 1
        if len(s) <= window or s.valid_fraction() <= 0:
            return 0
        return len(s) - window

    def ready(self, learn_start: int) -> bool:
        return (len(self) >= learn_start
                and any(self._sampleable(i) for i in range(self.num_streams)))

    # -- write ---------------------------------------------------------------

    def add(self, frame, action, reward, done, boundary=None) -> int:
        return self.shards[0].add(frame, action, reward, done,
                                  boundary=boundary)

    def add_batch(self, batch, stream: int = 0) -> np.ndarray:
        assert 0 <= stream < self.num_streams
        return self.shards[stream].add_batch(batch) + stream * self.shard_cap

    def reset_stream(self, stream: int) -> None:
        """Seal at a writer identity change (see FrameStackReplay.seal_stream)."""
        if 0 <= stream < self.num_streams:
            self.shards[stream].seal_stream()

    # -- sample --------------------------------------------------------------

    def sample(self, batch_size: int) -> dict[str, np.ndarray]:
        masses = [float(self._sampleable(i)) for i in range(self.num_streams)]
        assert sum(masses) > 0, "sample() before ready()"
        counts = allocate_proportional(batch_size, masses)
        parts = []
        for i, c in enumerate(counts):
            if c == 0:
                continue
            part = self.shards[i].sample(c)
            part["index"] = (part["index"] + i * self.shard_cap).astype(
                np.int32)
            parts.append(part)
        batch = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
        batch["_sampled_at"] = tuple(s.steps_added for s in self.shards)
        return batch
