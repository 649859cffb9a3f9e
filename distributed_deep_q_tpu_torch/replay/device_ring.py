"""Device-resident replay: host bookkeeping (port of the reference
``replay/device_ring.py``'s ``DeviceFrameReplay``).

Frames live in device memory; the host keeps per-slot metadata rings and
stages fresh rows, which ``flush`` writes to the device in fixed-size
chunks. Layout — shards and stream slots, as in the reference:

    device shard s owns ring rows [s·cap_local, (s+1)·cap_local)
    each shard is split into ``subs_per_shard`` SLOTS of ``slot_cap`` rows
    slot g (global id) lives on shard g % D at sub-ring g // D

Frame stacking relies on temporal adjacency, so every slot has exactly ONE
writer stream at a time: stream i owns the slots {g : g % num_streams == i}
and cycles through them at episode boundaries. The port runs on one device,
so D = 1 (one shard); the bookkeeping stays generic over slots.

This base class is the host half only. ``DevicePERFrameReplay``
(``replay/device_per.py``) supplies the device ring and its write program;
the reference's host-sampled variant (``device_per=False``) is not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from distributed_deep_q_tpu_torch.config import ReplayConfig
from distributed_deep_q_tpu_torch.replay.columnar import ColumnStage
from distributed_deep_q_tpu_torch.replay.prioritized import beta_at
from distributed_deep_q_tpu_torch.replay.replay_memory import FrameStackReplay


class DeviceFrameReplay:
    """Slot bookkeeping, staging and the chunked flush of a device frame
    ring. Subclasses implement ``_alloc_ring``, ``_stage`` and
    ``_apply_write``."""

    def __init__(
        self,
        cfg: ReplayConfig,
        device: torch.device | str,
        frame_shape: tuple[int, int] = (84, 84),
        stack: int = 4,
        write_chunk: int = 64,
        num_streams: int = 1,
    ):
        if not getattr(cfg, "staging_columnar", True):
            raise NotImplementedError(
                "replay.staging_columnar=false (the legacy staging FIFO) is "
                "not ported (ROADMAP A10)")
        self.device = torch.device(device)
        d = self.num_shards = 1          # one device, one shard
        self.local_shards = [0]
        self.num_streams = max(int(num_streams), 1)
        self.subs_per_shard = -(-max(self.num_streams, d) // d)  # ceil
        g = self.num_slots = self.subs_per_shard * d
        self.slot_cap = int(cfg.capacity) // g
        assert self.slot_cap > 0 and cfg.batch_size % d == 0, (
            f"capacity {cfg.capacity} must split over {g} stream slots and "
            f"batch {cfg.batch_size} over {d} shards")
        # one flush chunk must never wrap a sub-ring (duplicate targets in
        # one scatter would leave stale pixels under fresh metadata)
        write_chunk = min(int(write_chunk), self.slot_cap)
        self.cap_local = self.slot_cap * self.subs_per_shard
        self.capacity = self.cap_local * d
        self.stack = int(stack)
        self.frame_shape = tuple(frame_shape)
        self.write_chunk = int(write_chunk)
        self._cfg = cfg

        # per-slot metadata rings (single writer each → adjacency holds)
        self.slots = [FrameStackReplay(self.slot_cap, stack, cfg.n_step)
                      for _ in range(g)]
        self._samples = 0

        # stream i owns every num_streams-th slot
        self._slot_cycle = [
            [s for j, s in enumerate(range(g)) if j % self.num_streams == i]
            for i in range(self.num_streams)]
        self._stream_pos = [0] * self.num_streams

        self._row_len = int(np.prod(self.frame_shape))
        self._alloc_ring()

        # host staging: one ColumnStage per shard; _stage_columns describes
        # the staged payload columns' (tail shape, dtype) — subclasses widen
        # it with metadata columns
        self._stage_columns: list[tuple[tuple[int, ...], type]] = [
            ((self._row_len,), np.uint8)]
        self._staging_depth = int(getattr(cfg, "staging_depth", 4096))
        self._stages: list | None = None  # built lazily: subclasses widen
        self._pending_rows = [0] * d

    def _alloc_ring(self) -> None:
        raise NotImplementedError

    def _stage(self, slot: int, local: np.ndarray, frames: np.ndarray) -> None:
        raise NotImplementedError

    def _apply_write(self, idx: np.ndarray, cols: list) -> None:
        raise NotImplementedError

    # -- layout helpers -----------------------------------------------------

    def _slot_base(self, slot: int) -> tuple[int, int]:
        """(shard, in-shard base offset) of a slot's sub-ring."""
        return slot % self.num_shards, (slot // self.num_shards) * self.slot_cap

    def _global_index(self, slot: int, local: np.ndarray) -> np.ndarray:
        shard, base = self._slot_base(slot)
        return shard * self.cap_local + base + local

    # -- bookkeeping --------------------------------------------------------

    def __len__(self) -> int:
        return sum(len(m) for m in self.slots)

    def pending_rows(self) -> int:
        """Rows staged but not yet flushed to the device."""
        return sum(self._pending_rows)

    def _sampleable(self, slot: int) -> int:
        """Sampleable transition mass of a slot (0 until it can sample)."""
        m = self.slots[slot]
        window = m.stack + m.n_step + 1
        if len(m) <= window or m.valid_fraction() <= 0:
            return 0
        return len(m) - window

    def ready(self, learn_start: int) -> bool:
        """True when the aggregate fill reached ``learn_start`` AND every
        shard has at least one slot with sampleable transitions."""
        if len(self) < learn_start:
            return False
        per_shard = {s: 0 for s in self.local_shards}
        for g in range(self.num_slots):
            per_shard[g % self.num_shards] += self._sampleable(g)
        return all(mass > 0 for mass in per_shard.values())

    @property
    def beta(self) -> float:
        return beta_at(self._samples, self._cfg.priority_beta0,
                       self._cfg.priority_beta_steps)

    # -- write path ---------------------------------------------------------

    def _stage_rows(self, shard: int, idx: np.ndarray, cols: tuple) -> None:
        """Append one staged segment (in-shard offsets + payload columns)
        to the shard's column stage."""
        if self._stages is None:
            self._stages = [None] * self.num_shards
        st = self._stages[shard]
        if st is None:
            st = self._stages[shard] = ColumnStage(
                [((), np.int32)] + list(self._stage_columns),
                depth=self._staging_depth)
        st.append(idx, *cols)
        self._pending_rows[shard] += len(idx)

    def add(self, frame, action, reward, done, boundary=None) -> int:
        """Single-stream add (in-process training loop)."""
        cycle = self._slot_cycle[0]
        slot = cycle[self._stream_pos[0] % len(cycle)]
        i = self.slots[slot].add(None, action, reward, done, boundary=boundary)
        self._stage(slot, np.asarray([i]),
                    np.asarray(frame, np.uint8).reshape(1, -1))
        if done if boundary is None else boundary:
            # episode finished → move this stream to its next slot
            self._stream_pos[0] += 1
        self._flush_if_full()
        return int(self._global_index(slot, np.asarray(i)))

    def add_batch(self, batch, stream: int = 0) -> np.ndarray:
        """Contiguous chunk from one stream; rows route to the stream's
        current slot, which advances at each episode boundary, so the chunk
        splits into boundary-delimited segments."""
        assert 0 <= stream < self.num_streams, \
            f"stream {stream} outside configured num_streams={self.num_streams}"
        n = len(batch["action"])
        done = np.asarray(batch["done"], bool)
        boundary = np.asarray(batch.get("boundary", batch["done"]), bool)
        frames = np.ascontiguousarray(
            np.asarray(batch["frame"], np.uint8).reshape(n, -1))
        action = np.asarray(batch["action"])
        reward = np.asarray(batch["reward"])
        out = np.empty(n, np.int64)
        cuts = np.flatnonzero(boundary) + 1  # segment ends (exclusive)
        if len(cuts) == 0 or cuts[-1] != n:
            cuts = np.append(cuts, n)
        s0 = 0
        for s1 in cuts:
            cycle = self._slot_cycle[stream]
            slot = cycle[self._stream_pos[stream] % len(cycle)]
            m = self.slots[slot]
            # cap one metadata insert at slot_cap rows so a single call can
            # never wrap its own sub-ring
            for p0 in range(s0, s1, self.slot_cap):
                p1 = min(p0 + self.slot_cap, s1)
                li = m.add_batch({
                    "action": action[p0:p1], "reward": reward[p0:p1],
                    "done": done[p0:p1], "boundary": boundary[p0:p1]})
                self._stage(slot, li, frames[p0:p1])
                out[p0:p1] = self._global_index(slot, li)
            if boundary[s1 - 1]:
                self._stream_pos[stream] += 1
            s0 = s1
        self._flush_if_full()
        return out

    def _flush_if_full(self) -> None:
        """Chunk-boundary flush gate."""
        if max(self._pending_rows) >= self.write_chunk:
            self.flush()

    def _assemble_round(self) -> tuple[np.ndarray, list, int]:
        """Build ONE padded write round from staging: ``write_chunk`` lanes
        per shard, missing rows padded with out-of-range indices the write
        drops. Returns (idx, cols, rows_taken)."""
        k = self.write_chunk
        shards = self.local_shards
        dl = len(shards)
        idx = np.full((dl, k), self.cap_local, np.int32)  # OOB = drop
        cols = [np.zeros((dl, k) + tail, dt)
                for tail, dt in self._stage_columns]
        rows = 0
        for li, s in enumerate(shards):
            st = self._stages[s] if self._stages is not None else None
            if st is not None:
                taken = st.take(k, [idx] + cols, li)
                self._pending_rows[s] -= taken
                rows += taken
        return idx, cols, rows

    def flush(self) -> None:
        """Push all staged rows to the device in fixed-shape chunks."""
        rounds = -(-max(self._pending_rows) // self.write_chunk)
        for _ in range(rounds):
            idx, cols, _ = self._assemble_round()
            self._apply_write(idx, cols)
