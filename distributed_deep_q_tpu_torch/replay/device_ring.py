"""Device-resident replay: frames on the device, metadata on the host (port
of the reference ``replay/device_ring.py``'s ``DeviceFrameReplay``).

Frames enter device memory once, at actor rate: a uint8 ring
``[capacity, H·W]`` (one flattened frame per row), written in fixed-size
chunks. The host keeps per-slot metadata rings and, when prioritized,
per-slot sum trees; it samples *indices*, composes n-step returns and
validity masks from the metadata, and ships only ``[B, stack]`` int32
indices plus a few ``[B]`` scalars. The train step gathers and stacks the
frames on the device (``compose_stacks``). Layout — shards and stream
slots, as in the reference:

    device shard s owns ring rows [s·cap_local, (s+1)·cap_local)
    each shard is split into ``subs_per_shard`` SLOTS of ``slot_cap`` rows
    slot g (global id) lives on shard g % D at sub-ring g // D

Frame stacking relies on temporal adjacency, so every slot has exactly ONE
writer stream at a time: stream i owns every ``num_streams``-th of the
process's slots and cycles through them at episode boundaries. The
reference's D shards are its mesh devices; the port keeps them on one
device (``parallel/mesh.py``), so shard s is the block of ring rows above,
and ``sample`` draws B/D rows per shard as the reference does, with
shard-local stack indices (``global_stack_rows`` places them in the ring).

More than one learner process (``parallel/multihost.py``): each process
owns the contiguous block ``local_shards`` of the D shards, its streams
cycle over the slots of those shards only, and its device state holds
only them. The geometry (``subs_per_shard``, ``slot_cap``, capacity) comes
from the stream count over every process, so it is the same in each; slot
ids, shard ids and the rows ``add`` returns stay global. The reference
defers each process's flush to the chunk boundary and agrees its round
count by MAX across processes, because its flush is one collective
program over every process's devices. The port's flush writes only its
own process's tensors, and the solver flushes every staged row before
each dispatch, so every process keeps the one immediate flush path: the
write order is the staged order, and a dispatch draws the same rows.

``DevicePERFrameReplay`` (``replay/device_per.py``) replaces the ring, its
writer and the sampler with the fused device-PER ones.

Host staging has two interchangeable backends, as in the reference: the
columnar ``ColumnStage`` (default) and the legacy per-shard FIFO of array
tuples behind ``replay.staging_columnar=false``, which the columnar one is
pinned bit for bit against. Either is drained by ``flush``: inline when a
writer crosses a chunk boundary, or by a background ``IngestDrain`` thread
once ``start_drain`` attached one (the replay server does).

**Streams.** Every device write of a ring (flushes and seals) is enqueued
on one CUDA stream: the stream current on the thread that called
``start_drain``, which must be the learner's. Writers (the server's serve
threads, the drain thread) and the learner hold the replay lock while they
enqueue, so their work reaches that one stream in the order in which they
took the lock, and no sample can overtake the flush it depends on.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from distributed_deep_q_tpu_torch import tracing
from distributed_deep_q_tpu_torch.config import ReplayConfig
from distributed_deep_q_tpu_torch.replay.columnar import (
    ColumnStage, IngestDrain)
from distributed_deep_q_tpu_torch.replay.prioritized import (
    SumTree, allocate_proportional, beta_at, filter_stale,
    sample_valid_from_tree)
from distributed_deep_q_tpu_torch.replay.replay_memory import FrameStackReplay


def to_device(a: np.ndarray, device: torch.device,
              out: torch.Tensor | None = None) -> torch.Tensor:
    """Host array → device tensor (into ``out``, of its shape and dtype,
    where given). On the card the copy goes through pinned memory and
    does not block the host behind queued device work: the array is
    copied into a fresh pinned block first, so the caller may reuse it at
    once, and PyTorch's pinned allocator hands that block out again only
    after the copy that reads it has run."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if out is not None:
        if out.shape != t.shape or out.dtype != t.dtype:
            raise ValueError(f"a {t.dtype} {tuple(t.shape)} array cannot "
                             f"fill a {out.dtype} {tuple(out.shape)} tensor")
        if out.device.type == "cuda":
            t = t.pin_memory()
        return out.copy_(t, non_blocking=out.device.type == "cuda")
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.clone()


def global_stack_rows(batch: dict, num_shards: int, cap_local: int) -> dict:
    """An index batch from ``DeviceFrameReplay.sample`` with its stack
    indices moved from shard-local to ring rows: row r of the batch is
    shard ``r // (B/D)``'s, whose rows start at ``s · cap_local``. The
    batch itself is left as it was."""
    if num_shards == 1:
        return batch
    b = len(batch["oidx"])
    off = (np.arange(b) // (b // num_shards) * cap_local)[:, None]
    return dict(batch, oidx=(batch["oidx"] + off).astype(np.int32),
                noidx=(batch["noidx"] + off).astype(np.int32))


def compose_stacks(ring: torch.Tensor, oidx: torch.Tensor,
                   valid: torch.Tensor,
                   frame_shape: tuple[int, int] = (84, 84)) -> torch.Tensor:
    """``[cap, H·W]`` ring + ``[B, stack]`` row indices/validity →
    ``[B, stack, H, W]`` uint8. Frames before an episode start (invalid)
    are zeroed, matching ``FrameStackReplay.gather``.

    The reference returns ``[B, H, W, stack]`` (its CNN's layout); the
    port's nets take ``[B, stack, H, W]`` (``forward_nchw``), so the stack
    stays where the gather puts it and no transpose is needed."""
    frames = ring[oidx.long()]                              # [B, S, H·W]
    frames = frames * valid[..., None].to(torch.uint8)
    return frames.view(frames.shape[:2] + tuple(frame_shape))


class DeviceFrameReplay:
    """Device frame ring + host metadata/priorities, one logical buffer:
    ``add`` / ``add_batch`` / ``sample`` / ``__len__`` plus
    ``update_priorities``. ``sample`` returns an *index batch* whose pixels
    the learner's ring train step composes on the device."""

    prioritized: bool

    def __init__(
        self,
        cfg: ReplayConfig,
        device: torch.device | str,
        frame_shape: tuple[int, int] = (84, 84),
        stack: int = 4,
        gamma: float = 0.99,
        seed: int = 0,
        write_chunk: int = 64,
        num_streams: int = 1,
        num_shards: int = 1,
        local_shards: list[int] | None = None,
    ):
        self.device = torch.device(device)
        d = self.num_shards = int(num_shards)   # over every process
        # this process's block of shards (all of them at one process)
        self.local_shards = (list(range(d)) if local_shards is None
                             else [int(s) for s in local_shards])
        dl = len(self.local_shards)
        assert dl and d % dl == 0 and self.local_shards == list(range(
            self.local_shards[0], self.local_shards[0] + dl)), (
            f"local shards {self.local_shards} must be a contiguous block "
            f"of D/processes of the {d} shards")
        self._pc = d // dl                      # learner processes
        self.num_streams = max(int(num_streams), 1)
        total_streams = self.num_streams * self._pc
        self.subs_per_shard = -(-max(total_streams, d) // d)  # ceil
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
        # the rows this process's device state holds: its shards only
        self.local_capacity = self.cap_local * dl
        self.stack = int(stack)
        self.frame_shape = tuple(frame_shape)
        self.write_chunk = int(write_chunk)
        self.prioritized = bool(cfg.prioritized)
        self._cfg = cfg
        self._rng = np.random.default_rng(seed)

        # per-slot metadata rings (single writer each → adjacency holds)
        self.slots = [
            FrameStackReplay(self.slot_cap, frame_shape, stack, cfg.n_step,
                             gamma, seed=seed + i, store_frames=False)
            for i in range(g)]
        # per-slot priority trees with SHARED max-priority/β bookkeeping
        self.trees = ([SumTree(self.slot_cap, use_native=cfg.use_native)
                       for _ in range(g)]
                      if self.prioritized else None)
        self.max_priority = 1.0
        self._samples = 0

        # stream i owns every num_streams-th slot of this process's shards
        # (every num_streams-th slot at one process)
        local_set = set(self.local_shards)
        local_slots = [s for s in range(g) if s % d in local_set]
        self._slot_cycle = [
            [s for j, s in enumerate(local_slots)
             if j % self.num_streams == i]
            for i in range(self.num_streams)]
        self._stream_pos = [0] * self.num_streams

        self._row_len = int(np.prod(self.frame_shape))
        self._alloc_ring()

        # host staging: _stage_columns describes the staged payload
        # columns' (tail shape, dtype) — subclasses widen it with metadata
        # columns. Columnar: one ColumnStage per shard; legacy: a FIFO of
        # (in-shard offsets, *columns) tuples per shard
        self._stage_columns: list[tuple[tuple[int, ...], type]] = [
            ((self._row_len,), np.uint8)]
        self._columnar = bool(getattr(cfg, "staging_columnar", True))
        self._staging_depth = int(getattr(cfg, "staging_depth", 4096))
        self._stages: list | None = None  # built lazily: subclasses widen
        self._pending: list[list[tuple]] = [[] for _ in range(d)]
        self._pending_rows = [0] * d
        self._drain: IngestDrain | None = None   # start_drain attaches one
        self._drain_enabled = bool(getattr(cfg, "ingest_drain", True))
        self._drain_min = int(getattr(cfg, "drain_min_rows", 0))
        self._stream = None   # the learner's CUDA stream, from start_drain

    def _alloc_ring(self) -> None:
        """The device frame plane: ``[capacity, H·W]`` uint8, one flattened
        frame per row (7.06 GB at 1M × 84×84). ``DevicePERFrameReplay``
        overrides this with its padded int32 ring. The host-sampled ring
        is single-process, as in the reference: more than one process
        runs the fused ring or a host replay."""
        if self._pc > 1:
            raise ValueError(
                "DeviceFrameReplay's host-sampled path is single-process; "
                "more than one learner process needs the fused ring "
                "(replay.prioritized=true replay.device_per=true) or "
                "replay.device_resident=false")
        self.ring = torch.zeros((self.capacity, self._row_len),
                                dtype=torch.uint8, device=self.device)

    # -- layout helpers -----------------------------------------------------

    def _slot_base(self, slot: int) -> tuple[int, int]:
        """(shard, in-shard base offset) of a slot's sub-ring."""
        return slot % self.num_shards, (slot // self.num_shards) * self.slot_cap

    def _global_index(self, slot: int, local: np.ndarray) -> np.ndarray:
        shard, base = self._slot_base(slot)
        return shard * self.cap_local + base + local

    def _slot_of_global(self, gidx: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """global ring row → (slot id, slot-local index)."""
        shard, rem = gidx // self.cap_local, gidx % self.cap_local
        sub, local = rem // self.slot_cap, rem % self.slot_cap
        return sub * self.num_shards + shard, local

    # -- bookkeeping --------------------------------------------------------

    def __len__(self) -> int:
        return sum(len(m) for m in self.slots)

    def pending_rows(self) -> int:
        """Rows staged but not yet flushed to the device."""
        return sum(self._pending_rows)

    def _staged_rows(self) -> int:
        """Rows still in staging: the ``IngestDrain``'s backlog. The same
        as ``pending_rows``: no flush plane is assembled ahead of its
        dispatch (the reference's multi-host ``prepare_rounds``; see the
        module docstring for why the port has none)."""
        return sum(self._pending_rows)

    def _device_row(self, gidx):
        """A global ring row → its row in this process's device state."""
        return gidx - self.local_shards[0] * self.cap_local

    @property
    def steps_added(self) -> int:
        return sum(m.steps_added for m in self.slots)

    def stream_rows(self, stream: int) -> int:
        """Rows stream ``stream`` has added, over every slot it cycles
        through (a slot's wraps included)."""
        return sum(self.slots[s].steps_added
                   for s in self._slot_cycle[stream])

    def _sampleable(self, slot: int) -> int:
        """Sampleable transition mass of a slot (0 until it can sample)."""
        m = self.slots[slot]
        window = m.stack + m.n_step + 1
        if len(m) <= window or m.valid_fraction() <= 0:
            return 0
        return len(m) - window

    def ready(self, learn_start: int) -> bool:
        """True when the aggregate fill reached ``learn_start`` AND every
        shard of this process has at least one slot with sampleable
        transitions (across processes the caller ANDs it:
        ``multihost.all_processes_ready``)."""
        if len(self) < learn_start:
            return False
        per_shard = {s: 0 for s in self.local_shards}
        for g in range(self.num_slots):
            if g % self.num_shards in per_shard:
                per_shard[g % self.num_shards] += self._sampleable(g)
        return all(mass > 0 for mass in per_shard.values())

    @property
    def beta(self) -> float:
        return beta_at(self._samples, self._cfg.priority_beta0,
                       self._cfg.priority_beta_steps)

    # -- write path ---------------------------------------------------------

    def _stage_rows(self, shard: int, idx: np.ndarray, cols: tuple) -> None:
        """Append one staged segment (in-shard offsets + payload columns)
        to the shard's staging backend. Columnar: one memcpy per column
        into the preallocated stage (``staged_append``); legacy: FIFO of
        array tuples. Callers hold the replay lock."""
        if self._columnar:
            if self._stages is None:
                self._stages = [None] * self.num_shards
            st = self._stages[shard]
            if st is None:
                st = self._stages[shard] = ColumnStage(
                    [((), np.int32)] + list(self._stage_columns),
                    depth=self._staging_depth,
                    use_native=self._cfg.use_native)
            with tracing.span("staged_append"):
                st.append(idx, *cols)
        else:
            # copies, as the columnar stage's memcpy is: a caller may reuse
            # its frame buffer before the flush
            self._pending[shard].append(
                (idx,) + tuple(np.array(c) for c in cols))
        self._pending_rows[shard] += len(idx)

    def _stage(self, slot: int, local: np.ndarray, frames: np.ndarray) -> None:
        """Queue (slot-local rows, flat frames) for the device write and set
        their fresh-row priorities."""
        if self.prioritized:
            self.trees[slot].set(
                local, np.full(len(local),
                               self.max_priority ** self._cfg.priority_alpha))
        shard, base = self._slot_base(slot)
        self._stage_rows(shard, (base + local).astype(np.int32), (frames,))

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
        self._flush_or_notify()
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
        self._flush_or_notify()
        return out

    def _flush_or_notify(self) -> None:
        """Chunk-boundary flush gate. With an ``IngestDrain`` attached the
        writer only nudges the drain thread (the flush happens there, off
        the writer's lock hold); otherwise the flush runs here."""
        if max(self._pending_rows) < self.write_chunk:
            return
        if self._drain is not None:
            self._drain.notify()
        else:
            self.flush()

    def start_drain(self, lock, min_rows: int | None = None):
        """Attach a background staging→device drain thread sharing
        ``lock`` (the caller's replay lock: mutual exclusion with writers
        and the sampler is unchanged). Returns the drain, or None when
        ``replay.ingest_drain`` is off. The drain waits for
        ``min_rows`` staged rows (default: the larger of a write chunk
        and ``replay.drain_min_rows``).

        Call it from the learner's thread: on the card, the stream current
        there becomes the stream every device write of this ring is
        enqueued on (see the module docstring)."""
        if self._drain is not None:
            return self._drain
        if not self._drain_enabled:
            return None
        if self.device.type == "cuda":
            self._stream = torch.cuda.current_stream(self.device)
        min_r = min_rows or max(self.write_chunk, self._drain_min)
        self._drain = IngestDrain(self, lock, min_r)
        return self._drain

    def stop_drain(self) -> None:
        """Stop the drain thread after one last flush; re-raises a death
        the thread recorded."""
        drain, self._drain = self._drain, None
        if drain is not None:
            drain.close()

    def write_event(self):
        """A CUDA event recorded on the stream the ring's device writes
        go to, after every write enqueued there so far; None on the CPU.
        Take it under the replay lock and ``synchronize`` it after
        releasing the lock: the wait then covers those writes (and the
        learner's work queued before them on the same stream) without
        holding up the writers, the drain or the stream itself."""
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record(self._stream if self._stream is not None
                  else torch.cuda.current_stream(self.device))
        return ev

    def _writer_stream(self):
        """The context every device write of the ring runs in: the
        learner's stream once ``start_drain`` recorded it."""
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def reset_stream(self, stream: int) -> None:
        """Seal the stream's current slot at a writer identity change (an
        actor restart reusing the stream id): the slot's last written row
        gets a truncation boundary, so no sampled stack or n-step window
        straddles the dead actor's half-episode and the replacement's
        first episode."""
        if not (0 <= stream < self.num_streams):
            return
        cycle = self._slot_cycle[stream]
        slot = cycle[self._stream_pos[stream] % len(cycle)]
        self.slots[slot].seal_stream()

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
            if self._columnar:
                st = self._stages[s] if self._stages is not None else None
                if st is not None:
                    taken = st.take(k, [idx] + cols, li)
                    self._pending_rows[s] -= taken
                    rows += taken
                continue
            fill = 0
            while self._pending[s] and fill < k:
                entry = self._pending[s][0]
                i_arr = entry[0]
                take = min(len(i_arr), k - fill)
                idx[li, fill:fill + take] = i_arr[:take]
                for col, arr in zip(cols, entry[1:]):
                    col[li, fill:fill + take] = arr[:take]
                fill += take
                self._pending_rows[s] -= take
                rows += take
                if take == len(i_arr):
                    self._pending[s].pop(0)
                else:  # split the entry, preserving FIFO write order
                    self._pending[s][0] = tuple(a[take:] for a in entry)
        return idx, cols, rows

    def flush(self) -> None:
        """Push all staged rows to the device in fixed-shape chunks, on the
        learner's stream (``_writer_stream``)."""
        rounds = -(-max(self._pending_rows) // self.write_chunk)
        with self._writer_stream():
            for _ in range(rounds):
                idx, cols, _ = self._assemble_round()
                self._apply_write(idx, cols)

    def _apply_write(self, idx: np.ndarray, cols: list) -> None:
        """One padded write round (``[D, k]`` planes) → the device ring.
        The reference's scatter drops its padding lanes (index
        ``cap_local``) on the device; here they are dropped on the host, so
        ``index_copy_`` only sees real rows (distinct: a chunk never wraps
        a sub-ring)."""
        ok = idx < self.cap_local
        if not ok.any():
            return
        rows = (np.arange(self.num_shards)[:, None] * self.cap_local + idx)
        self.ring.index_copy_(
            0, to_device(rows[ok].astype(np.int64), self.device),
            to_device(cols[0][ok], self.device))

    # -- sample path --------------------------------------------------------

    def _allocate(self, quota: int, masses: list[float]) -> list[int]:
        """Split ``quota`` draws across slots ∝ mass (largest remainder)."""
        return allocate_proportional(quota, masses)

    def sample(self, batch_size: int) -> dict[str, np.ndarray]:
        """Index batch (no pixels): per-shard draws concatenated in shard
        order; ``oidx``/``noidx`` local to each row's shard, as the
        reference's are (``global_stack_rows``), ``index`` global."""
        self.flush()
        d = self.num_shards
        per = batch_size // d
        parts: list[dict[str, np.ndarray]] = []
        self._samples += 1
        for s in range(d):
            shard_slots = [g for g in range(self.num_slots)
                           if g % d == s]
            if self.prioritized:
                masses = [self.trees[g].total if self._sampleable(g) else 0.0
                          for g in shard_slots]
            else:
                masses = [float(self._sampleable(g)) for g in shard_slots]
            counts = self._allocate(per, masses)
            assert sum(counts) == per, \
                f"shard {s} has no sampleable slot (gate on ready())"
            for g, c in zip(shard_slots, counts):
                if c == 0:
                    continue
                meta = self.slots[g]
                if self.prioritized:
                    local = sample_valid_from_tree(
                        self.trees[g], meta, c, self._rng)
                    p = self.trees[g].get(local)
                else:
                    local = meta.sample_indices(c)
                    p = np.ones(c)
                m = meta.gather_meta(local)
                _, base = self._slot_base(g)
                for key in ("oidx", "noidx"):
                    m[key] = (m[key] + base).astype(np.int32)
                m["index"] = self._global_index(g, local).astype(np.int64)
                m["_slot"] = np.full(c, g, np.int32)
                m["_p"] = p
                parts.append(m)
        batch = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}

        if self.prioritized:
            # IS weights for the REALIZED stratified distribution: each
            # shard contributes exactly batch/D draws (proportional within
            # the shard), so P(i) = p_i / (D · mass_shard(i)). Only
            # SAMPLEABLE slots count: the allocation above zeroes
            # unsampleable ones, so their mass is not part of the realized
            # distribution either.
            shard_mass = np.zeros(d)
            for g in range(self.num_slots):
                if self._sampleable(g):
                    shard_mass[g % d] += self.trees[g].total
            owner_shard = batch.pop("_slot") % d
            n = len(self)
            pr = np.maximum(
                batch.pop("_p")
                / np.maximum(d * shard_mass[owner_shard], 1e-12), 1e-12)
            w = (n * pr) ** (-self.beta)
            batch["weight"] = (w / w.max()).astype(np.float32)
        else:
            batch.pop("_p")
            batch.pop("_slot")
            batch["weight"] = np.ones(batch_size, np.float32)
        batch["valid"] = batch["valid"].astype(np.uint8)
        batch["nvalid"] = batch["nvalid"].astype(np.uint8)
        batch["index"] = batch["index"].astype(np.int32)
        batch["_sampled_at"] = tuple(m.steps_added for m in self.slots)
        return batch

    # -- learner feedback ---------------------------------------------------

    def update_priorities(self, idx: np.ndarray, td_abs: np.ndarray,
                          sampled_at=None) -> None:
        if not self.prioritized:
            return
        gidx = np.asarray(idx, np.int64)
        td = np.abs(np.asarray(td_abs, np.float64)) + self._cfg.priority_eps
        slot_ids, local = self._slot_of_global(gidx)
        for g in np.unique(slot_ids):
            pick = slot_ids == g
            li, lt = local[pick], td[pick]
            if sampled_at is not None:
                li, lt = filter_stale(li, lt, self.slots[g].steps_added,
                                      sampled_at[g], self.slot_cap)
                if li.size == 0:
                    continue
            self.trees[g].set(li, lt ** self._cfg.priority_alpha)
            self.max_priority = max(self.max_priority, float(lt.max()))
