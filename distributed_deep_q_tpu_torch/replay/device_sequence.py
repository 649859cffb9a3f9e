"""Device-resident sequence replay: R2D2 pixels, metadata and priorities
on the card (port of the reference ``replay/device_sequence.py``).

Each sequence stores its UNSTACKED frame stream once: ``W = (stack-1) +
(T+1)`` rows (the stack-1 prefix seeding the first observation, then one
newest frame per step), ``stack×`` smaller than the host store's stacked
observations. The stream lives in ONE flat int32 ring, rows padded to
``rowb`` bytes (``ops/ring_gather.py``'s layout, kept so ring bytes compare
with the reference's one for one): sequence slot ``i`` owns frame rows
``[i·W, (i+1)·W)``, so sampling a sequence is ONE window of the
``gather_windows`` kernel and flushing one is ONE row of the
``scatter_rows`` kernel (a "row" there is the whole ``W·rowb``-byte slot).
A scratch slot after each shard's slots absorbs the flush's padding lanes.

The host keeps the metadata and, when prioritized, a sum tree for the
per-step ``sample()`` path; the device keeps twins of the metadata and a
per-sequence priority row (``dmeta``, ``dmaxp``) for the chained fused
path (``SequenceLearner.train_steps_fused``). A training loop drives one
of the two.

The reference's D shards (its mesh devices) are a leading shard axis on
the port's device: each shard owns ``caps_local + 1`` ring slots, the
last its scratch slot. With more than one learner process
(``parallel/multihost.py``) a process owns the contiguous block
``local_shards`` and its device ring and twins hold those shards only;
sequences go round-robin over them. The reference's flush there is a
collective that waits for the dispatch; the port's writes only this
process's tensors, so it flushes as one process does. The host sample
path stays single-process, as the reference's does.

The reference refuses a per-shard plane of 2³¹ elements or more, a limit
of Mosaic's 32-bit index math; the r2d2 preset's plane is 12,501 × 84 ×
2048 = 2.15·10⁹ int32, and the port's kernels compute every offset in 64
bits, so the port has no such limit.
"""

from __future__ import annotations

import numpy as np
import torch

from distributed_deep_q_tpu_torch.ops.ring_gather import (
    padded_row_bytes, scatter_rows)
from distributed_deep_q_tpu_torch.replay.device_ring import to_device
from distributed_deep_q_tpu_torch.replay.prioritized import (
    SumTree, beta_at, filter_stale)

META_KEYS = ("action", "reward", "discount", "mask", "init_c", "init_h")


def compose_sequence_rows(ring: torch.Tensor, seq_local: torch.Tensor,
                          n_valid: torch.Tensor, seq_len: int,
                          stack: int) -> torch.Tensor:
    """The gather twin of ``compose_sequence_block`` over a 2-D ``[rows,
    H·W]`` stream store: ``[b]`` slots → ``[b, T+1, stack, H·W]`` uint8
    (``obs[t]`` plane j = stream row t+j; steps past ``n_valid`` zeroed,
    matching the host store's zero tail)."""
    W = (stack - 1) + (seq_len + 1)
    dev = ring.device
    t = torch.arange(seq_len + 1, device=dev)
    j = torch.arange(stack, device=dev)
    rel = t[:, None] + j[None, :]                          # [T+1, stack]
    rows = seq_local.long()[:, None, None] * W + rel[None]
    out = ring[rows.reshape(-1)].reshape(rows.shape + (-1,))
    keep = t[None, :] <= n_valid.long()[:, None]           # [b, T+1]
    return out * keep[..., None, None].to(torch.uint8)


def compose_sequence_block(block: torch.Tensor, mask: torch.Tensor,
                           seq_len: int, stack: int,
                           row_len: int) -> torch.Tensor:
    """The production composition: ``[b, W, rowp]`` int32 windows (one
    ``gather_windows`` window per sequence) → ``[b, T+1, stack, row_len]``
    uint8 by an int32 → uint8 view and ``stack`` static slices; ``mask``
    ``[b, T]`` gives n_valid = Σ mask for the tail zeroing."""
    b, W, rowp = block.shape
    pix = block.view(torch.uint8).view(b, W, rowp * 4)[:, :, :row_len]
    obs = torch.stack([pix[:, j:j + seq_len + 1] for j in range(stack)],
                      dim=2)                               # [b, T+1, S, row]
    n_valid = mask.sum(dim=1).to(torch.int32)
    keep = (torch.arange(seq_len + 1, device=block.device)[None, :]
            <= n_valid[:, None])
    return obs * keep[..., None, None].to(torch.uint8)


def stream_from_stacked_obs(obs: np.ndarray, n_valid: int,
                            stack: int) -> np.ndarray:
    """Host-side inverse of stacking: ``[T+1, H, W, S] → [(S-1)+(T+1),
    H·W]`` newest-frame stream. Row k<S-1 comes from the first
    observation's older stack planes (already zero where the episode
    started inside the stack); row (S-1)+t is obs[t]'s newest plane. Rows
    past ``(S-1)+n_valid`` stay zero, mirroring the host store's tail."""
    t1 = obs.shape[0]
    flat = obs.reshape(t1, -1, obs.shape[-1])         # [T+1, H·W, S]
    W = (stack - 1) + t1
    out = np.zeros((W, flat.shape[1]), np.uint8)
    out[:stack - 1] = np.moveaxis(flat[0, :, :stack - 1], -1, 0)
    n = min(int(n_valid) + 1, t1)                     # real obs rows
    out[stack - 1:stack - 1 + n] = flat[:n, :, -1]
    return out


class DeviceSequenceReplay:
    """Sequence replay with pixels, metadata and priorities on the device.

    Host surface of ``SequenceReplay`` (``add_sequence`` / ``add_batch`` /
    ``sample`` / ``update_priorities`` / ``ready``); ``sample`` returns the
    sequence metadata plus slot indices (``seq_local``, local to each row's
    shard) whose pixels the ring step gathers on the device. The fused path
    never calls it: it samples on the device from ``dmeta``.

    Shards, as the reference's: sequences go round-robin over the D shards
    (``_next_shard``), each with its own cursor, size, add count (its
    staleness clock), sum tree and ``caps_local`` slots. Host metadata and
    the device twins are indexed by global slot ``s · caps_local + local``;
    the pixel ring holds ``slots_local = caps_local + 1`` slots per shard
    (the last its scratch slot), shard-major.
    """

    prioritized: bool

    def __init__(
        self,
        capacity: int,
        seq_len: int,
        obs_shape: tuple[int, ...],      # (H, W, S) stacked: pixels only
        device: torch.device | str,
        lstm_size: int = 512,
        prioritized: bool = False,
        alpha: float = 0.9,
        beta0: float = 0.6,
        beta_steps: int = 1_000_000,
        eps: float = 1e-6,
        seed: int = 0,
        use_native: bool = True,
        write_chunk: int = 4,
        num_shards: int = 1,
        local_shards: list[int] | None = None,
    ):
        if len(obs_shape) != 3:
            raise ValueError("DeviceSequenceReplay is the pixel path: "
                             f"obs_shape = (H, W, S), got {obs_shape}")
        self.device = torch.device(device)
        d = self.num_shards = int(num_shards)   # over every process
        self.local_shards = (list(range(d)) if local_shards is None
                             else [int(s) for s in local_shards])
        dl = len(self.local_shards)
        assert dl and d % dl == 0 and self.local_shards == list(range(
            self.local_shards[0], self.local_shards[0] + dl)), (
            f"local shards {self.local_shards} must be a contiguous block "
            f"of D/processes of the {d} shards")
        self.seq_len = int(seq_len)
        self.stack = int(obs_shape[-1])
        self.frame_shape = tuple(obs_shape[:2])
        self._row_len = int(np.prod(self.frame_shape))
        self.W = (self.stack - 1) + (self.seq_len + 1)  # rows per sequence
        self.caps_local = max(int(capacity) // d, 1)
        self.capacity = self.caps_local * d               # sequences
        self.local_capacity = self.caps_local * dl        # on this device
        self.lstm_size = int(lstm_size)
        t, cap = self.seq_len, self.capacity

        # host metadata, by global sequence slot (the per-step sample path)
        self.action = np.zeros((cap, t), np.int32)
        self.reward = np.zeros((cap, t), np.float32)
        self.discount = np.zeros((cap, t), np.float32)
        self.mask = np.zeros((cap, t), np.float32)
        self.init_c = np.zeros((cap, lstm_size), np.float32)
        self.init_h = np.zeros((cap, lstm_size), np.float32)
        self.n_valid = np.zeros(cap, np.int32)  # real steps (mask sum)
        # per-shard cursors, sizes and add counts (sequence slots)
        self._cursor = np.zeros(d, np.int64)
        self._sizes = np.zeros(d, np.int64)
        self._added = np.zeros(d, np.int64)
        self._next_shard = 0
        self._seqs_added = 0
        self._rng = np.random.default_rng(seed)

        self.prioritized = bool(prioritized)
        self.alpha, self.beta0 = float(alpha), float(beta0)
        self.beta_steps, self.eps = int(beta_steps), float(eps)
        self.trees = ([SumTree(self.caps_local, use_native=use_native)
                       for _ in range(d)] if prioritized else None)
        self.max_priority = 1.0
        self._samples = 0

        if write_chunk > self.caps_local:
            raise ValueError(
                f"write_chunk={write_chunk} sequences must fit one shard's "
                f"ring ({self.caps_local}): duplicate targets in one flush "
                "are forbidden")
        self.write_chunk = max(int(write_chunk), 1)
        self.rowb = padded_row_bytes(self._row_len)  # bytes per frame row
        self.rowp = self.rowb // 4
        self.seq_bytes = self.W * self.rowb           # bytes per slot
        self.slots_local = self.caps_local + 1        # + the scratch slot
        dev = self.device
        self.ring = torch.zeros(dl * self.slots_local * self.W * self.rowp,
                                dtype=torch.int32, device=dev)
        # device twins of the metadata and the per-sequence priority row
        # (the fused path), and the running max pre-α priority; this
        # process's shards only
        cap = self.local_capacity
        self.dmeta: dict[str, torch.Tensor] = {
            "action": torch.zeros((cap, t), dtype=torch.int32, device=dev),
            "reward": torch.zeros((cap, t), device=dev),
            "discount": torch.zeros((cap, t), device=dev),
            "mask": torch.zeros((cap, t), device=dev),
            "init_c": torch.zeros((cap, lstm_size), device=dev),
            "init_h": torch.zeros((cap, lstm_size), device=dev),
            "prio": torch.zeros(cap, device=dev),
        }
        self.dmaxp = torch.ones((), device=dev)
        # a flush's source lanes for j shards: staged slot c for lane c
        self._scatter_src: dict[int, torch.Tensor] = {}
        self._pending: list[list[tuple]] = [[] for _ in range(d)]

    # -- bookkeeping --------------------------------------------------------

    def __len__(self) -> int:
        return int(self._sizes.sum())

    @property
    def steps_added(self) -> int:
        return self._seqs_added

    def pending_rows(self) -> int:
        return sum(len(p) for p in self._pending)

    def ready(self, learn_start: int) -> bool:
        """``learn_start`` counts sequences; every shard of this process
        must hold one (each draws B/D; across processes the caller ANDs
        it: ``multihost.all_processes_ready``)."""
        return len(self) >= max(learn_start, 1) and bool(
            (self._sizes[self.local_shards] > 0).all())

    @property
    def beta(self) -> float:
        return beta_at(self._samples, self.beta0, self.beta_steps)

    def next_betas(self, n: int) -> np.ndarray:
        """β for the next ``n`` fused steps (the anneal advances before
        each read, as on the host path)."""
        out = np.empty(n, np.float32)
        for i in range(n):
            self._samples += 1
            out[i] = self.beta
        return out

    def device_inputs(self) -> np.ndarray:
        """Each of this process's shards' filled-slot count ``[Dl]`` int32
        for the fused sampler."""
        return self._sizes[self.local_shards].astype(np.int32)

    def ring_slot(self, li, local):
        """The pixel ring's slot of sequence slot ``local`` of this
        process's ``li``-th shard."""
        return li * self.slots_local + local

    # -- write --------------------------------------------------------------

    def add_sequence(self, seq: dict[str, np.ndarray]) -> int:
        """A ``SequenceBuilder`` emission (stacked obs): the stream is
        derived here, so actors hand over what they hand the host store.
        Sequences go round-robin over this process's shards. Returns the
        global slot."""
        s = self.local_shards[self._next_shard % len(self.local_shards)]
        self._next_shard += 1
        local = int(self._cursor[s])
        self._cursor[s] = (local + 1) % self.caps_local
        self._sizes[s] = min(int(self._sizes[s]) + 1, self.caps_local)
        self._added[s] += 1
        g = s * self.caps_local + local
        n_valid = int(np.asarray(seq["mask"]).sum())
        obs = np.asarray(seq["obs"], np.uint8)
        for key in META_KEYS:
            getattr(self, key)[g] = seq[key]
        self.n_valid[g] = n_valid
        if self.prioritized:
            self.trees[s].set(np.asarray([local]),
                              np.asarray([self.max_priority ** self.alpha]))
        stream = stream_from_stacked_obs(obs, n_valid, self.stack)
        padded = np.zeros((self.W, self.rowb), np.uint8)
        padded[:, :self._row_len] = stream
        self._pending[s].append((local, padded))
        self._seqs_added += 1
        if max(len(p) for p in self._pending) >= self.write_chunk:
            self.flush()
        return g

    def add_batch(self, batch: dict[str, np.ndarray]) -> np.ndarray:
        """Sequence batches (leading dim = sequence count)."""
        n = len(batch["action"])
        return np.asarray([
            self.add_sequence({k: v[j] for k, v in batch.items()})
            for j in range(n)], np.int64)

    def flush(self) -> None:
        """Push the staged sequences to the device, ``write_chunk`` per
        shard per round, the shards that have any in one launch: ONE
        ``scatter_rows`` row per sequence (its whole slot) plus the
        metadata scatters; a short shard's padding lanes aim at shard 0's
        scratch slot, which the kernel skips (``skip_row``). Fresh
        sequences' device priorities are seeded from the device max."""
        k, dev = self.write_chunk, self.device
        skip = self.caps_local                  # shard 0's scratch slot
        s0 = self.local_shards[0]
        while any(self._pending):
            live = [s for s in self.local_shards if self._pending[s]]
            j = len(live)
            idx = np.full((j, k), skip, np.int64)
            staged = np.zeros((j, k, self.W, self.rowb), np.uint8)
            real = []
            for r, s in enumerate(live):
                chunk = self._pending[s][:k]
                self._pending[s] = self._pending[s][k:]
                for c, (local, padded) in enumerate(chunk):
                    idx[r, c] = self.ring_slot(s - s0, local)
                    staged[r, c] = padded
                    real.append(s * self.caps_local + local)
            if j not in self._scatter_src:
                self._scatter_src[j] = to_device(
                    np.arange(j * k, dtype=np.int32), dev)
            scatter_rows(self._scatter_src[j],
                         to_device(idx.reshape(-1).astype(np.int32), dev),
                         to_device(staged.view(np.int32).reshape(-1), dev),
                         self.ring, n=j * k, rowb=self.seq_bytes,
                         skip_row=skip)
            real = np.asarray(real, np.int64)
            ridx = to_device(real - s0 * self.caps_local, dev)
            for key in META_KEYS:
                self.dmeta[key][ridx] = to_device(getattr(self, key)[real],
                                                  dev)
            self.dmeta["prio"][ridx] = self.dmaxp ** self.alpha

    # -- sample (per-step host path) ----------------------------------------

    def sample(self, batch_size: int) -> dict[str, np.ndarray]:
        """An index batch: B/D slots drawn on the host per shard,
        concatenated in shard order; pixels composed on the device from
        ``seq_local`` (``SequenceLearner``'s ring step)."""
        if len(self.local_shards) < self.num_shards:
            raise ValueError(
                "the device sequence ring's host-sampled path is "
                "single-process; more than one learner process needs the "
                "fused ring (replay.prioritized=true replay.device_per=true)"
                " or replay.device_resident=false")
        self.flush()
        d = self.num_shards
        if batch_size % d:
            raise ValueError(f"batch {batch_size} must split over {d} "
                             "shards")
        per = batch_size // d
        self._samples += 1
        locs, weights, gids = [], [], []
        for s in range(d):
            size = int(self._sizes[s])
            if size <= 0:
                raise RuntimeError("sample() before every shard of the "
                                   "DeviceSequenceReplay holds a sequence")
            if self.prioritized:
                li = self.trees[s].sample_stratified(per, self._rng)
                li = np.minimum(li, size - 1)
                p = self.trees[s].get(li)
                mass = max(self.trees[s].total, 1e-12)
                # realized stratified draw: P(i) = p_i / (D · mass_s)
                probs = np.maximum(p / (d * mass), 1e-12)
                w = (len(self) * probs) ** (-self.beta)
            else:
                li = self._rng.integers(0, size, size=per)
                w = np.ones(per)
            locs.append(li)
            weights.append(w)
            gids.append(s * self.caps_local + li)
        gidx = np.concatenate(gids)
        w = np.concatenate(weights)
        return {
            "seq_local": np.concatenate(locs).astype(np.int32),
            "n_valid": self.n_valid[gidx],
            "action": self.action[gidx],
            "reward": self.reward[gidx],
            "discount": self.discount[gidx],
            "mask": self.mask[gidx],
            "init_c": self.init_c[gidx],
            "init_h": self.init_h[gidx],
            "weight": (w / w.max()).astype(np.float32),
            "index": gidx.astype(np.int32),
            "_sampled_at": tuple(int(v) for v in self._added),
        }

    # -- learner feedback ---------------------------------------------------

    def update_priorities(self, idx: np.ndarray, priority: np.ndarray,
                          sampled_at=None) -> None:
        if not self.prioritized:
            return
        gidx = np.asarray(idx, np.int64)
        p = np.abs(np.asarray(priority, np.float64)) + self.eps
        shard, local = gidx // self.caps_local, gidx % self.caps_local
        for s in np.unique(shard):
            pick = shard == s
            li, lp = local[pick], p[pick]
            if sampled_at is not None:
                # each shard's staleness clock: drop updates for slots it
                # has overwritten since the sample was drawn
                li, lp = filter_stale(li, lp, int(self._added[s]),
                                      sampled_at[int(s)], self.caps_local)
                if li.size == 0:
                    continue
            self.trees[int(s)].set(li, lp ** self.alpha)
            # the running max takes every reported priority, stale ones
            # too, as the reference's does
            self.max_priority = max(self.max_priority, float(p.max()))
