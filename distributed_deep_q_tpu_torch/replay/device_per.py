"""Device-resident prioritized replay with sampling fused into the train
step (port of the reference ``replay/device_per.py``).

The frame ring, the per-row metadata (action, reward, done, boundary) and
the priority row ``p^α`` all live on the device; the host ships per-slot
cursors/sizes, β values and sampling uniforms per dispatch and reads back
nothing. Per dispatch (``Learner.train_steps_device_per``):

- build the validity mask from the cursors/sizes, mask the priorities,
  take each shard's CDF and mass (``fused_sample_prep``) and the per-row
  metadata pack (``build_meta_pack``) — capacity-sized, once per chunk;
- draw ``chain × B/D`` indices per shard by inverse CDF from that shard's
  uniforms, read their metadata off the pack and compute IS weights
  normalized over every shard (``fused_sample_draw_packed``); the batch is
  the shards' draws concatenated in shard order;
- copy each sample's obs+next-obs pixel window with ONE kernel launch
  (``ops/ring_gather.gather_windows``);
- train, and scatter ``(|TD|+ε)^α`` back into the priority row
  (``scatter_priorities``).

Shards: the reference runs the sample stage per mesh shard under
``shard_map``. The port keeps a process's shards as a leading axis of the
device state on its device, laid out shard-major as ``np.asarray``
assembles the reference's ``P('dp')`` arrays: metadata and priorities
``[Dl · cap_local]``, the padded frame plane ``Dl × shard_rows`` rows (each
shard's padded slots, then its scratch row), Dl = D at one process. What
the reference reduces over ``dp`` is reduced over that axis and then, with
more than one learner process, over the processes
(``parallel/multihost.py``): the sampleable count is summed (``psum``),
the IS weights' max and the running max priority are taken over every
shard (``pmax``). Each shard draws with its GLOBAL shard's keys, so a
shard draws the same rows whichever process holds it.

Randomness: the reference draws ``jax.random.uniform(key, (B/D,))`` per
shard from raw ``uint32[2]`` keys; ``uniforms_for_keys`` draws the same
numbers bit for bit (``ops/threefry.py``), so a port run and a reference run
from one seed sample the same rows. The draw functions take the uniforms
as an argument, so a test may still feed in its own. A ``chain=k`` chunk
draws exactly what k single-step dispatches draw.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from distributed_deep_q_tpu_torch.ops import threefry
from distributed_deep_q_tpu_torch.parallel import multihost
from distributed_deep_q_tpu_torch.ops.ring_gather import (
    padded_row_bytes, scatter_rows)
from distributed_deep_q_tpu_torch.replay.device_ring import (
    DeviceFrameReplay, to_device)


def uniforms_for_keys(keys: np.ndarray, per_shard: int,
                      device: torch.device) -> torch.Tensor:
    """``jax.random.uniform(key, (per_shard,))`` for every key of ``keys``
    (``[..., 2]`` uint32): float32 ``[..., per_shard]`` in [0, 1) on
    ``device``, bitwise the reference's draws. The hash is integer
    arithmetic, so where it runs does not change the numbers; it runs by
    numpy on the host, then one pinned copy, which the card measured
    cheaper than its ~170 elementwise launches there (PERF.md §6)."""
    u = torch.from_numpy(threefry.uniforms_host(keys, per_shard))
    if device.type == "cuda":
        return u.pin_memory().to(device, non_blocking=True)
    return u


def valid_mask(done: torch.Tensor, boundary: torch.Tensor,
               cursors: torch.Tensor, sizes: torch.Tensor, slot_cap: int,
               stack: int, n_step: int) -> torch.Tensor:
    """Per-row sampleability: a row is sampleable iff its
    ``[i-stack+1, i+n]`` window neither crosses the write cursor nor falls
    off the filled region, and its n-step window crosses no
    truncation-only boundary. ``cursors``/``sizes`` are ``[subs]``."""
    L = slot_cap
    d = done.view(-1, L).bool()
    b = boundary.view(-1, L).bool()
    idx = torch.arange(L, device=done.device)[None, :]     # [1, L]
    size = sizes.long()[:, None]                           # [subs, 1]
    cur = cursors.long()[:, None]
    partial = (idx < stack - 1) | (idx + n_step >= size)
    back = (idx - cur) % L
    full = (back >= L - n_step) | (back < stack - 1)
    bad = torch.where(size < L, partial, full)
    trunc = b & ~d
    cross = torch.zeros_like(trunc)
    for k in range(n_step):
        cross = cross | torch.roll(trunc, -k, dims=1)
    return (~(bad | cross)).reshape(-1)


def build_cdf(prio_masked: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Each shard's (inclusive CDF, total mass) over its masked priorities
    ``[D, cap_local]`` — built once per chunk (sampling sees chunk-start
    priorities)."""
    cdf = torch.cumsum(prio_masked, -1)
    return cdf, cdf[:, -1]


def draw_from_cdf(u: torch.Tensor, cdf: torch.Tensor,
                  prio_masked: torch.Tensor, mass: torch.Tensor,
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Inverse-CDF draws ∝ p, each shard from its own CDF: ``cdf`` and
    ``prio_masked`` ``[D, L]``, ``mass`` ``[D]``, uniforms ``u`` ``[D,
    ...]``. Returns (shard-local row indices, p_i/mass), both shaped like
    ``u``."""
    d = cdf.shape[0]
    x = (u * mass.view((d,) + (1,) * (u.dim() - 1))).reshape(d, -1)
    idx = torch.searchsorted(cdf, x, right=True)
    idx = idx.clamp(0, prio_masked.shape[-1] - 1)
    p = torch.gather(prio_masked, 1, idx) / torch.clamp(
        mass, min=1e-12)[:, None]
    return idx.view(u.shape), p.view(u.shape)


def stack_rows_to_obs(rows: torch.Tensor,
                      frame_shape: tuple[int, int]) -> torch.Tensor:
    """[B, stack, H·W] gathered rows → [B, H, W, stack] (the reference's
    CNN input layout). The fused train step skips this: its windows are
    already NCHW, which the port's nets take directly."""
    rows = rows.reshape(rows.shape[:2] + tuple(frame_shape))
    return torch.movedim(rows, 1, -1)


def fused_sample_prep(shard_rows: dict[str, torch.Tensor],
                      cursors: torch.Tensor, sizes: torch.Tensor,
                      slot_cap: int, stack: int, n_step: int,
                      num_shards: int = 1):
    """The capacity-sized part of a fused sample, once per chunk: validity
    mask → masked priorities ``[D, cap_local]`` → each shard's CDF and mass
    ``[D]`` → the sampleable count summed over shards and over processes
    (the reference's ``psum``). ``num_shards`` counts this process's shards.
    Returns (pm, cdf, mass, n_glob)."""
    mask = valid_mask(shard_rows["done"], shard_rows["boundary"], cursors,
                      sizes, slot_cap, stack, n_step)
    pm = (shard_rows["prio"] * mask).view(num_shards, -1)
    cdf, mass = build_cdf(pm)
    n_glob = multihost.all_reduce_(mask.sum(dtype=torch.float32))
    return pm, cdf, mass, n_glob


def stratified_is_weights(p: torch.Tensor, mass: torch.Tensor,
                          n_glob: torch.Tensor, betas: torch.Tensor,
                          num_shards: int) -> torch.Tensor:
    """IS weights for the realized per-shard stratified draw, normalized
    per chain row: P(i) = p_i/(D·mass_s), N = the sampleable count. ``p``
    ``[Dl, chain, B/D]`` for this process's Dl shards, ``mass`` ``[Dl]``,
    ``betas`` [chain]; ``num_shards`` is D over every process. A shard
    with zero mass gets zero weights (its priority scatter is pointed out
    of range); that mask comes before the max, which runs over every
    shard of every process (the reference's ``pmax``), so a dead shard
    cannot crush the live ones' weights."""
    pr = torch.clamp(p / num_shards, min=1e-12)
    w = (n_glob * pr) ** (-betas[:, None])
    w = torch.where(mass[:, None, None] > 0, w, torch.zeros_like(w))
    w_max = multihost.all_reduce_(w.amax(dim=(0, 2), keepdim=True), "max")
    return (w / torch.clamp(w_max, min=1e-12)).float()


def build_meta_pack(action: torch.Tensor, reward: torch.Tensor,
                    done: torch.Tensor, boundary: torch.Tensor, slot_cap: int,
                    stack: int, n_step: int, gamma: float) -> torch.Tensor:
    """Per-row composed sample metadata for ALL rows at once. Returns
    ``[cap_local, 3 + stack]`` float32: lane 0 action, 1 n-step return,
    2 bootstrap discount, 3.. the obs stack-validity bits of the row as
    anchor (oldest-first). Rolls wrap within each sub-ring after the
    ``[subs, L]`` reshape."""
    L = slot_cap
    a2 = action.view(-1, L).float()
    r2 = reward.view(-1, L).float()
    d2 = done.view(-1, L).bool()
    b2 = boundary.view(-1, L).bool()
    rn = r2
    any_done = d2
    cont = ~d2
    for k in range(1, n_step):
        dk = torch.roll(d2, -k, dims=1)
        rn = rn + torch.roll(r2, -k, dims=1) * cont * (gamma ** k)
        any_done = any_done | (dk & cont)
        cont = cont & ~dk
    disc = torch.where(any_done, torch.zeros_like(r2),
                       torch.full_like(r2, gamma ** n_step))
    # obs stack-validity bits, right to left: the anchor frame is always
    # valid; older frames stay valid while no boundary sits between them
    # and the anchor
    vs: list = [None] * stack
    vs[stack - 1] = torch.ones_like(d2)
    for j in range(stack - 2, -1, -1):
        pb = torch.roll(b2, stack - 1 - j, dims=1)
        vs[j] = vs[j + 1] & ~pb
    lanes = [a2, rn, disc] + [v.float() for v in vs]
    return torch.stack(lanes, dim=-1).reshape(-1, 3 + stack)


def to_batch_order(x: torch.Tensor) -> torch.Tensor:
    """``[D, chain, B/D, ...]`` per-shard draws → ``[chain, B, ...]``: the
    shards' draws concatenated in shard order, the batch the reference's
    mesh order gives."""
    return x.transpose(0, 1).reshape((x.shape[1], -1) + x.shape[3:])


def fused_sample_draw_packed(u: torch.Tensor, pack: torch.Tensor,
                             pm: torch.Tensor, cdf: torch.Tensor,
                             mass: torch.Tensor, n_glob: torch.Tensor,
                             per_shard: int, slot_cap: int, slot_pad: int,
                             stack: int, n_step: int, betas: torch.Tensor,
                             num_shards: int):
    """Inverse-CDF draws for all ``chain`` steps of every shard of this
    process (``u`` ``[Dl, chain, B/D]``, ``pm``/``cdf`` ``[Dl, cap_local]``,
    ``mass`` ``[Dl]``), metadata from two row gathers per sample off the
    pack, and the pixel-window START rows for ``gather_windows``.
    ``num_shards`` is D over every process (the IS weights' P(i)); the
    rows, windows and indices are this process's, Dl = D at one process.

    Returns, in batch order ``[chain, B]`` (``to_batch_order``): the meta
    dict incl. ``weight`` and the validity planes ``ovalid``/``nvalid``
    ``[chain, B, stack]`` uint8; window-start rows ``ws`` in the padded
    frame plane (shard s starts at row ``s · shard_rows``, so a window
    never leaves its shard: each shard's ghost rows close its own slots);
    sampled row indices in the process's real coordinates, set to its
    capacity ``Dl · cap_local`` (out of range) on a shard whose mass is 0.
    """
    d, cap_local = pm.shape
    chain = u.shape[1]
    li, p = draw_from_cdf(u, cdf, pm, mass)             # [D, chain, b]
    shard = torch.arange(d, device=u.device).view(d, 1, 1)
    sub, local = li // slot_cap, li % slot_cap
    idx = shard * cap_local + li
    anchor2 = shard * cap_local + sub * slot_cap + (local + n_step) % slot_cap
    shard_rows = (cap_local // slot_cap) * slot_pad + 1
    # window start (padded coords): rows [local-stack+1 .. local+n_step]
    # are contiguous there thanks to the ghost rows
    ws = shard * shard_rows + sub * slot_pad + (local - (stack - 1)) % slot_cap
    w = stratified_is_weights(p, mass, n_glob, betas, num_shards)
    idx = to_batch_order(idx)
    lanes = pack.shape[-1]
    mp = pack[idx.reshape(-1)].reshape(chain, d * per_shard, lanes)
    mp2 = pack[to_batch_order(anchor2).reshape(-1)].reshape(
        chain, d * per_shard, lanes)
    meta = {
        "action": mp[..., 0].to(torch.int32),
        "reward": mp[..., 1],
        "discount": mp[..., 2],
        "ovalid": mp[..., 3:3 + stack].to(torch.uint8),
        "nvalid": mp2[..., 3:3 + stack].to(torch.uint8),
        "weight": to_batch_order(w),
    }
    dead = to_batch_order((~(mass > 0)).view(d, 1, 1).expand(li.shape))
    idx = torch.where(dead, torch.full_like(idx, d * cap_local), idx)
    return meta, to_batch_order(ws).to(torch.int32), idx.to(torch.int32)


def scatter_priorities(prio: torch.Tensor, maxp: torch.Tensor,
                       idx: torch.Tensor, td_abs: torch.Tensor, alpha: float,
                       eps: float) -> torch.Tensor:
    """Same-step priority write-back: ``prio[idx] ← (|TD|+ε)^α`` IN PLACE,
    and returns the new running pre-α max. Indices at the capacity (a
    zero-mass draw — all lanes of the batch at once) write nothing: they
    are redirected to row 0 with its own value."""
    td = td_abs.abs() + eps
    ok = idx < prio.shape[0]
    safe = torch.where(ok, idx, torch.zeros_like(idx)).long()
    prio[safe] = torch.where(ok, td ** alpha, prio[safe])
    return torch.maximum(maxp, td.max())


def insert_meta_pack(staged_u8: torch.Tensor, maxp: torch.Tensor, *, k: int,
                     row_len: int, rowb: int,
                     alpha: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Device-side insert pack for one staged chunk: pad ``[k, row_len]``
    u8 rows to the ``rowb`` stride, pack the bytes 4 per int32
    (little-endian, the reference's bitcast) and seed the fresh-row
    priority ``maxp ** α``. Returns (flat packed rows ``[k · rowb/4]``
    int32, priority seed)."""
    rows = staged_u8.reshape(k, row_len)
    rows = F.pad(rows, (0, rowb - row_len))
    return rows.view(torch.int32).reshape(-1), maxp ** alpha


class DeviceReplayState(NamedTuple):
    """The device rows of a ``DevicePERFrameReplay`` as the reference's
    ``DeviceReplayState``: the padded frame plane, the metadata and
    priority rows, and the running max priority. The tensors are the
    replay's own (a view, not a copy); the Anakin runner owns them while
    ``replay.dstate`` is None (``take_device_state``)."""

    frames: torch.Tensor
    action: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
    boundary: torch.Tensor
    prio: torch.Tensor
    maxp: torch.Tensor


def take_device_state(replay) -> DeviceReplayState:
    """Hand ``replay``'s device rows to one new owner: returns them as a
    ``DeviceReplayState`` and sets ``replay.dstate = None`` until
    ``give_device_state`` puts them back (the single-owner handoff)."""
    if replay.dstate is None:
        raise RuntimeError("the replay's device rows are already owned "
                           "elsewhere (replay.dstate is None)")
    ds = DeviceReplayState(**replay.dstate)
    replay.dstate = None
    return ds


def give_device_state(replay, ds: DeviceReplayState) -> None:
    """Put device rows back into ``replay`` (the end of the handoff)."""
    replay.dstate = ds._asdict()


# ---------------------------------------------------------------------------
# The replay object
# ---------------------------------------------------------------------------


class DevicePERFrameReplay(DeviceFrameReplay):
    """Frame ring + metadata + priorities all on the device; sampling and
    priority updates happen inside the fused learner step, so per step the
    host ships per-slot cursors/sizes and reads back nothing.

    Frame-plane layout (kept from the reference, so ring bytes compare one
    for one):

    - frames live in ONE flat int32 tensor (pixel bytes packed 4 per
      element); each frame row is padded to ``rowb`` bytes (a multiple of
      4096).
    - each sub-ring holds ``slot_pad = slot_cap + window - 1`` rows, where
      ``window = stack + n_step``: the last ``window - 1`` rows are GHOST
      rows mirroring rows ``0..window-2`` (the flush writes those rows
      twice), so every sample's obs+next-obs window is ONE contiguous run.
    - one extra SCRATCH row after each shard's slots (``shard_rows =
      cap_local_pad + 1`` rows per shard, the reference's layout); the
      flush's padding lanes, every shard's, aim at shard 0's, which the
      ``scatter_rows`` kernel skips (``skip_row``).

    Metadata/priority rows stay in REAL (unpadded) coordinates
    ``[capacity]``, shard s at ``[s·cap_local, (s+1)·cap_local)``; only the
    pixel plane is padded and ghosted. The device state is the dict
    ``dstate`` with keys frames, action, reward, done, boundary, prio and
    maxp (the running max pre-α priority, a 0-d tensor, global).
    """

    def __init__(self, cfg, device, frame_shape=(84, 84), stack: int = 4,
                 gamma: float = 0.99, seed: int = 0, write_chunk: int = 64,
                 num_streams: int = 1, num_shards: int = 1,
                 local_shards: list[int] | None = None):
        # host trees off: the priorities live on the device
        super().__init__(dataclasses.replace(cfg, prioritized=False), device,
                         frame_shape, stack, gamma, seed, write_chunk,
                         num_streams, num_shards, local_shards)
        self.prioritized = True
        self._cfg = cfg
        self.n_step, self.gamma = cfg.n_step, gamma
        self._alpha = float(cfg.priority_alpha)
        # staged columns: raw frame rows (padded/packed on device by
        # insert_meta_pack), then action, reward, done, boundary
        self._stage_columns += [
            ((), np.int32), ((), np.float32), ((), np.uint8), ((), np.uint8)]
        self._di_cache: tuple[np.ndarray, np.ndarray] | None = None
        cap, dev = self.local_capacity, self.device
        # a flush's source lanes for j shards: staged rows s·k .. s·k+k-1 of
        # each for its main lanes, again for its ghost lanes; constant per
        # j, so each is shipped once
        self._scatter_src: dict[int, torch.Tensor] = {}
        self.dstate: dict[str, torch.Tensor] = {
            "frames": self._frames,
            "action": torch.zeros(cap, dtype=torch.int32, device=dev),
            "reward": torch.zeros(cap, dtype=torch.float32, device=dev),
            "done": torch.zeros(cap, dtype=torch.uint8, device=dev),
            "boundary": torch.zeros(cap, dtype=torch.uint8, device=dev),
            "prio": torch.zeros(cap, dtype=torch.float32, device=dev),
            "maxp": torch.ones((), dtype=torch.float32, device=dev),
        }
        del self._frames  # the frames now live in dstate (single owner)

    # -- padded frame plane --------------------------------------------------

    def _alloc_ring(self) -> None:
        """Flat padded int32 ring (see the class docstring). Runs inside
        ``super().__init__``; geometry derives from attributes the base set
        before the call."""
        cfg = self._cfg
        self.window = self.stack + int(cfg.n_step)
        assert self.slot_cap >= self.window, (
            f"slot capacity {self.slot_cap} must hold one sample window "
            f"(stack {self.stack} + n_step {cfg.n_step})")
        self.slot_pad = self.slot_cap + self.window - 1
        self.rowb = padded_row_bytes(self._row_len)   # bytes per frame row
        self.rowp = self.rowb // 4                    # int32 per frame row
        self.cap_local_pad = self.subs_per_shard * self.slot_pad
        self.shard_rows = self.cap_local_pad + 1      # +1 scratch row
        # no 2³¹ cap on the ring (the reference's assert guarded Mosaic's
        # 32-bit index math): the kernels compute offsets in 64 bits
        shape = (len(self.local_shards) * self.shard_rows * self.rowp,)
        self._frames = torch.zeros(shape, dtype=torch.int32,
                                   device=self.device)

    # -- write plumbing ------------------------------------------------------

    def _stage(self, slot: int, local, frames_arr) -> None:
        """Stage (rows, raw frames, action, reward, done, boundary); the
        metadata comes from the host slot arrays the rows were just
        written to."""
        m = self.slots[slot]
        shard, base_off = self._slot_base(slot)
        self._stage_rows(shard, (base_off + local).astype(np.int32), (
            frames_arr, m.action[local], m.reward[local],
            m.done[local].astype(np.uint8),
            m.boundary[local].astype(np.uint8)))
        self._di_cache = None  # cursors/sizes moved

    def _apply_write(self, idx, cols) -> None:
        """One padded round (``[D, k]`` planes) → the device, for the shards
        it holds rows of: their frame rows through ONE ``scatter_rows``
        launch (padded coords, ghost duplicates, padding lanes → the skipped
        scratch row) and the metadata scatters (real coords; fresh rows'
        priorities seeded from the device max). Padding lanes of the
        metadata scatter are dropped on the host."""
        k = self.write_chunk
        ok = idx < self.cap_local          # [D, k], in-shard real coords
        live = np.flatnonzero(ok.any(axis=1))
        if len(live) == 0:
            return
        i2, ok = idx[live], ok[live]
        j = len(live)
        sub = np.where(ok, i2 // self.slot_cap, 0)
        local = np.where(ok, i2 % self.slot_cap, 0)
        scratch = self.cap_local_pad       # shard 0's scratch row
        base = (live * self.shard_rows)[:, None] + sub * self.slot_pad
        main = np.where(ok, base + local, scratch)
        ghost = np.where(ok & (local < self.window - 1),
                         base + self.slot_cap + local, scratch)
        didx = np.concatenate([main, ghost], axis=1).astype(np.int32)
        dev, st = self.device, self.dstate
        if j not in self._scatter_src:
            src = np.arange(j * k, dtype=np.int32).reshape(j, k)
            self._scatter_src[j] = to_device(
                np.concatenate([src, src], axis=1).reshape(-1), dev)
        staged, new_p = insert_meta_pack(
            to_device(cols[0][live], dev), st["maxp"], k=j * k,
            row_len=self._row_len, rowb=self.rowb, alpha=self._alpha)
        scatter_rows(self._scatter_src[j], to_device(didx.reshape(-1), dev),
                     staged, st["frames"], n=2 * j * k, rowb=self.rowb,
                     skip_row=scratch)
        rows = (live[:, None] * self.cap_local + i2)[ok]
        midx = to_device(rows.astype(np.int64), dev)
        for name, col in zip(("action", "reward", "done", "boundary"),
                             cols[1:]):
            st[name][midx] = to_device(col[live][ok], dev)
        st["prio"][midx] = new_p

    def reset_stream(self, stream: int) -> None:
        """Seal the stream's current slot on the host AND on the device: the
        fused sampler reads the device boundary ring, so a host-only seal
        would let sampled windows straddle the dead writer's seam. Staged
        rows flush first: they carry their pre-seal boundary values, and a
        later flush would scatter them over the seal."""
        if not (0 <= stream < self.num_streams):
            return
        self.flush()
        cycle = self._slot_cycle[stream]
        slot = cycle[self._stream_pos[stream] % len(cycle)]
        m = self.slots[slot]
        super().reset_stream(stream)
        if len(m) == 0:
            return
        row = int(self._device_row(
            self._global_index(slot, (m._cursor - 1) % self.slot_cap)))
        with self._writer_stream():
            self.dstate["boundary"][row] = 1

    # -- learner-side inputs -------------------------------------------------

    def next_betas(self, k: int) -> np.ndarray:
        """β values for the next ``k`` fused steps, advancing the anneal
        BEFORE each read."""
        out = np.empty(k, np.float32)
        for i in range(k):
            self._samples += 1
            out[i] = self.beta
        return out

    def device_inputs(self) -> tuple[np.ndarray, np.ndarray]:
        """(cursors, sizes) int32 host arrays for this process's shards,
        shard-major ``[Dl·subs]``; cached between writes."""
        if self._di_cache is None:
            d, subs = self.num_shards, self.subs_per_shard
            dl = len(self.local_shards)
            cursors = np.zeros(dl * subs, np.int32)
            sizes = np.zeros(dl * subs, np.int32)
            for li, s in enumerate(self.local_shards):
                for sub in range(subs):
                    m = self.slots[sub * d + s]
                    cursors[li * subs + sub] = m._cursor
                    sizes[li * subs + sub] = len(m)
            self._di_cache = (cursors, sizes)
        return self._di_cache
