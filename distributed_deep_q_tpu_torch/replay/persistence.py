"""Optional replay persistence — npz dump/load of every replay tier the port
has (port of the reference ``replay/persistence.py``).

One ``.npz`` file carries the complete sampling state of a buffer — ring
contents, cursors, priority trees, the β-anneal counter and the numpy RNG
states — so a restored buffer's next ``sample()`` (or fused dispatch) is
byte-identical to what the saved one would have drawn. It is what
``replay.persist_path`` saves beside each learner checkpoint and restores
on ``train.resume``.

The key space and ``SCHEMA`` are the reference's, so a file written by
either package loads into the other at the same shard count D:

- the device tiers flush their staged rows first, download their rings
  once at save (``dev_*`` keys) and upload them onto the replay's own
  device at load; the port's device planes are laid out shard-major, as
  ``np.asarray`` assembles the reference's ``P('dp')`` arrays, so they
  map on without a relayout;
- ``DeviceSequenceReplay`` keeps its cursor, size and add count per
  shard, its round-robin shard counter (``next_shard``) and one sum tree
  per shard (``tree0`` …), as the reference's does;
- a file loads only into a replay of its own shard count; another count
  is refused with both named. The file does not record D: the sequence
  ring has one size per shard, the fused ring one scratch row per shard
  after its slots, and a host-sampled ``DeviceFrameReplay`` a slot count
  that each D fits or not (``ceil(streams / D) · D`` slots). Where that
  count fits several D, the reference's own checks (capacity and slots)
  are all there is, here as there.

Format: flat npz keys. Scalars ride as 0-d arrays; RNG states as JSON
strings. ``meta_kind`` + geometry keys guard against loading a file into a
mismatched buffer.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from distributed_deep_q_tpu_torch.replay.device_per import DevicePERFrameReplay
from distributed_deep_q_tpu_torch.replay.device_ring import DeviceFrameReplay
from distributed_deep_q_tpu_torch.replay.device_sequence import (
    DeviceSequenceReplay)
from distributed_deep_q_tpu_torch.replay.prioritized import PrioritizedReplay
from distributed_deep_q_tpu_torch.replay.replay_memory import (
    FrameStackReplay, ReplayMemory)
from distributed_deep_q_tpu_torch.replay.sequence import SequenceReplay
from distributed_deep_q_tpu_torch.utils.durability import atomic_write

SCHEMA = 1
_SEQ_META = ("action", "reward", "discount", "mask", "init_c", "init_h")
_PER_PLANES = ("frames", "action", "reward", "done", "boundary", "prio",
               "maxp")


# -- rng state (json round-trip keeps npz dtype-clean) -----------------------


def _rng_dump(rng: np.random.Generator) -> str:
    return json.dumps(rng.bit_generator.state)


def _rng_load(rng: np.random.Generator, s: str) -> None:
    rng.bit_generator.state = json.loads(s)


def _str(v) -> str:
    """npz round-trips str as 0-d ``<U`` arrays."""
    return str(np.asarray(v)[()]) if not isinstance(v, str) else v


def _download(t: torch.Tensor) -> np.ndarray:
    """A device tensor's owned host copy (a CPU tensor is copied too)."""
    return t.detach().to("cpu", copy=True).numpy()


def _upload(dst: torch.Tensor, src: np.ndarray, name: str) -> None:
    """``dst ← src`` in place, on ``dst``'s device, after a layout check."""
    want = (tuple(dst.shape), str(dst.dtype).removeprefix("torch."))
    got = (tuple(src.shape), str(src.dtype))
    if want != got:
        raise ValueError(
            f"{name}: file has {got[1]}{got[0]}, buffer expects "
            f"{want[1]}{want[0]} (saved by an incompatible version or "
            "geometry)")
    dst.copy_(torch.from_numpy(src))


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise ValueError(what)


def _check_shards(file_shards, replay) -> None:
    """Refuse a file of another shard count than ``replay``'s.
    ``file_shards`` is the file's D, or the set of counts its slot layout
    fits."""
    fits = (file_shards if isinstance(file_shards, (set, frozenset))
            else {file_shards})
    if replay.num_shards not in fits:
        saved = (f"{min(fits)}" if len(fits) == 1 else
                 " or ".join(str(v) for v in sorted(fits)))
        raise ValueError(
            f"the replay file was saved from {saved} shard(s); this replay "
            f"has {replay.num_shards} (mesh.dp): load it into a replay of "
            "the same shard count")


def _ring_shards(slots: int, streams: int) -> set[int]:
    """The shard counts D a frame ring of ``slots`` slots for ``streams``
    writer streams can have: ``ceil(max(streams, D) / D) · D == slots``."""
    return {d for d in range(1, slots + 1)
            if -(-max(streams, d) // d) * d == slots}


# -- per-tier (de)serializers -------------------------------------------------


def _frame_stack_state(m, prefix: str) -> dict:
    d = {
        f"{prefix}action": m.action, f"{prefix}reward": m.reward,
        f"{prefix}done": m.done, f"{prefix}boundary": m.boundary,
        f"{prefix}cursor": m._cursor, f"{prefix}size": m._size,
        f"{prefix}steps_added": m._steps_added,
        f"{prefix}rng": _rng_dump(m._rng),
    }
    if m.frames is not None:
        d[f"{prefix}frames"] = m.frames
    return d


def _frame_stack_restore(m, z, prefix: str) -> None:
    _require(int(z[f"{prefix}size"]) <= m.capacity,
             "capacity shrank under file")
    m.action[:] = z[f"{prefix}action"]
    m.reward[:] = z[f"{prefix}reward"]
    m.done[:] = z[f"{prefix}done"]
    m.boundary[:] = z[f"{prefix}boundary"]
    m._cursor = int(z[f"{prefix}cursor"])
    m._size = int(z[f"{prefix}size"])
    m._steps_added = int(z[f"{prefix}steps_added"])
    _rng_load(m._rng, _str(z[f"{prefix}rng"]))
    if m.frames is not None:
        m.frames[:] = z[f"{prefix}frames"]


def _state(replay) -> dict:
    """``replay``'s sampling state as flat npz keys. Host arrays are the
    replay's own (views); ``dev_*`` arrays are fresh downloads."""
    d: dict = {"meta_schema": SCHEMA}

    if isinstance(replay, SequenceReplay):
        d["meta_kind"] = "sequence"
        d["meta_capacity"] = replay.capacity
        d["meta_seq_len"] = replay.seq_len
        for k in _SEQ_META + ("obs",):
            d[k] = getattr(replay, k)
        d["cursor"] = replay._cursor
        d["size"] = replay._size
        d["seqs_added"] = replay._seqs_added
        d["samples"] = replay._samples
        d["max_priority"] = replay.max_priority
        d["rng"] = _rng_dump(replay._rng)
        if replay.prioritized:
            d["tree"] = replay.tree.tree
        return d

    if isinstance(replay, DeviceSequenceReplay):
        replay.flush()  # staged sequences must be in the state we dump
        d["meta_kind"] = "device_sequence"
        d["meta_capacity"] = replay.capacity
        d["meta_seq_len"] = replay.seq_len
        d["meta_W"] = replay.W
        for k in _SEQ_META + ("n_valid",):
            d[k] = getattr(replay, k)
        d["cursor"] = replay._cursor
        d["sizes"] = replay._sizes
        d["added"] = replay._added
        d["next_shard"] = replay._next_shard
        d["seqs_added"] = replay._seqs_added
        d["samples"] = replay._samples
        d["max_priority"] = replay.max_priority
        d["rng"] = _rng_dump(replay._rng)
        if replay.prioritized:
            for i, t in enumerate(replay.trees):
                d[f"tree{i}"] = t.tree
        d["dev_ring"] = _download(replay.ring)
        for k, v in replay.dmeta.items():
            d[f"dev_{k}"] = _download(v)
        d["dev_maxp"] = _download(replay.dmaxp)
        return d

    if isinstance(replay, PrioritizedReplay):
        d["meta_kind"] = "prioritized"
        d["tree"] = replay.tree.tree
        d["max_priority"] = replay.max_priority
        d["samples"] = replay._samples
        d["per_rng"] = _rng_dump(replay._rng)
        base, inner = replay.base, "base_"
    else:
        base, inner = replay, ""

    if isinstance(replay, DeviceFrameReplay):  # incl. DevicePERFrameReplay
        replay.flush()  # staged rows must be in the device state we dump
        per = isinstance(replay, DevicePERFrameReplay)
        d["meta_kind"] = "device_per" if per else "device_ring"
        d["meta_capacity"] = replay.capacity
        d["meta_num_slots"] = replay.num_slots
        d["meta_num_streams"] = replay.num_streams
        d["stream_pos"] = np.asarray(replay._stream_pos, np.int64)
        d["max_priority"] = replay.max_priority
        d["samples"] = replay._samples
        d["ring_rng"] = _rng_dump(replay._rng)
        for i, m in enumerate(replay.slots):
            d.update(_frame_stack_state(m, f"slot{i}_"))
        if per:
            for k in _PER_PLANES:
                d[f"dev_{k}"] = _download(replay.dstate[k])
        else:
            d["dev_frames"] = _download(replay.ring)
            if replay.prioritized:
                for i, t in enumerate(replay.trees):
                    d[f"tree{i}"] = t.tree
    elif isinstance(base, FrameStackReplay):
        d.setdefault("meta_kind", "frame_stack")
        d["meta_capacity"] = base.capacity
        d.update(_frame_stack_state(base, inner))
    elif isinstance(base, ReplayMemory):
        d.setdefault("meta_kind", "memory")
        d["meta_capacity"] = base.capacity
        d.update({
            f"{inner}obs": base.obs, f"{inner}next_obs": base.next_obs,
            f"{inner}action": base.action, f"{inner}reward": base.reward,
            f"{inner}discount": base.discount,
            f"{inner}cursor": base._cursor, f"{inner}size": base._size,
            f"{inner}steps_added": base._steps_added,
            f"{inner}rng": _rng_dump(base._rng),
        })
    else:
        raise TypeError(f"no persistence for {type(replay).__name__}")
    return d


def replay_state(replay) -> dict:
    """Capture ``replay``'s complete sampling state as a flat dict (the
    npz key space of ``save_replay``). Every array is owned by the
    result, so a caller can serialize it while the replay keeps
    mutating."""
    return {k: np.array(v) if isinstance(v, np.ndarray)
            and not k.startswith("dev_") else v
            for k, v in _state(replay).items()}


def save_replay(replay, path: str) -> None:
    """Dump ``replay``'s complete sampling state to ``path`` atomically
    (tmp + fsync + rename — ``np.savez`` straight to the final path
    leaves a torn file on crash). The npz streams into the tmp file, so
    the host holds one copy of a device ring, not two. Mirrors np.savez's
    naming: ``.npz`` is appended when ``path`` lacks it."""
    path = os.fspath(path)
    if not path.endswith(".npz"):
        path += ".npz"
    state = _state(replay)
    atomic_write(path, lambda f: np.savez(f, **state))


def _load_frame_ring(replay, z, kind: str) -> None:
    per = isinstance(replay, DevicePERFrameReplay)
    expect = "device_per" if per else "device_ring"
    _require(kind == expect, f"file holds {kind!r}, buffer is {expect!r}")
    slots = int(z["meta_num_slots"])
    frames = z["dev_frames"]    # each read of an npz key reads the file
    if per and slots == replay.num_slots:
        # the fused ring keeps one scratch row per shard after its slots
        _check_shards(frames.size // replay.rowp - slots * replay.slot_pad,
                      replay)
    else:
        _check_shards(_ring_shards(slots, int(z["meta_num_streams"])),
                      replay)
    _require(int(z["meta_capacity"]) == replay.capacity
             and int(z["meta_num_slots"]) == replay.num_slots,
             "ring geometry mismatch (capacity / slot layout)")
    # rows staged before the load would flush over the file's state
    replay._stages, replay._pending_rows = None, [0] * replay.num_shards
    replay._pending = [[] for _ in range(replay.num_shards)]
    replay._stream_pos = [int(v) for v in z["stream_pos"]]
    replay.max_priority = float(z["max_priority"])
    replay._samples = int(z["samples"])
    _rng_load(replay._rng, _str(z["ring_rng"]))
    for i, m in enumerate(replay.slots):
        _frame_stack_restore(m, z, f"slot{i}_")
    if per:
        _upload(replay.dstate["frames"], frames, "dev_frames")
        for k in _PER_PLANES[1:]:
            _upload(replay.dstate[k], z[f"dev_{k}"], f"dev_{k}")
        replay._di_cache = None   # cursors/sizes came from the file
    else:
        _upload(replay.ring, frames, "dev_frames")
        if replay.prioritized:
            for i, t in enumerate(replay.trees):
                t.set(np.arange(t.size), z[f"tree{i}"][t.size: 2 * t.size])


def _load_device_sequence(replay, z, kind: str) -> None:
    _require(kind == "device_sequence", f"file holds {kind!r}")
    sizes = z["sizes"]
    _check_shards(len(sizes), replay)
    _require(int(z["meta_capacity"]) == replay.capacity
             and int(z["meta_seq_len"]) == replay.seq_len
             and int(z["meta_W"]) == replay.W, "geometry mismatch")
    _require(("tree0" in z) == replay.prioritized,
             "prioritized-ness mismatch: file was saved with prioritized="
             f"{'tree0' in z}, buffer is prioritized={replay.prioritized}")
    # staged sequences would flush over the file's
    replay._pending = [[] for _ in range(replay.num_shards)]
    _upload(replay.ring, z["dev_ring"], "dev_ring")
    for k in replay.dmeta:
        _upload(replay.dmeta[k], z[f"dev_{k}"], f"dev_{k}")
    _upload(replay.dmaxp, z["dev_maxp"], "dev_maxp")
    for k in _SEQ_META + ("n_valid",):
        getattr(replay, k)[:] = z[k]
    replay._cursor[:] = z["cursor"]
    replay._sizes[:] = sizes
    replay._added[:] = z["added"]
    replay._next_shard = int(z["next_shard"])
    replay._seqs_added = int(z["seqs_added"])
    replay._samples = int(z["samples"])
    replay.max_priority = float(z["max_priority"])
    _rng_load(replay._rng, _str(z["rng"]))
    if replay.prioritized:
        for i, t in enumerate(replay.trees):
            t.set(np.arange(t.size), z[f"tree{i}"][t.size: 2 * t.size])


def _load_sequence(replay, z, kind: str) -> None:
    _require(kind == "sequence", f"file holds {kind!r}")
    _require(int(z["meta_capacity"]) == replay.capacity
             and int(z["meta_seq_len"]) == replay.seq_len,
             "geometry mismatch")
    _require(("tree" in z) == replay.prioritized,
             "prioritized-ness mismatch: file was saved with prioritized="
             f"{'tree' in z}, buffer is prioritized={replay.prioritized}")
    obs = z["obs"]
    _require(obs.shape == replay.obs.shape and obs.dtype == replay.obs.dtype,
             "obs store mismatch")
    replay.obs[:] = obs
    for k in _SEQ_META:
        getattr(replay, k)[:] = z[k]
    replay._cursor = int(z["cursor"])
    replay._size = int(z["size"])
    replay._seqs_added = int(z["seqs_added"])
    replay._samples = int(z["samples"])
    replay.max_priority = float(z["max_priority"])
    _rng_load(replay._rng, _str(z["rng"]))
    if replay.prioritized:
        t = replay.tree
        t.set(np.arange(t.size), z["tree"][t.size: 2 * t.size])


def load_replay(replay, path: str) -> None:
    """Restore state saved by ``save_replay`` (this package's or the
    reference's) into a geometry-matched ``replay`` (same class, capacity,
    slot layout, shard count); the device planes land on the replay's own
    device. The file's state replaces the buffer's, rows it had staged
    included. Raises ``ValueError`` on a mismatch."""
    with np.load(path, allow_pickle=False) as z:
        _require(int(z["meta_schema"]) == SCHEMA,
                 f"replay file schema {int(z['meta_schema'])}, expected "
                 f"{SCHEMA}")
        kind = _str(z["meta_kind"])
        if isinstance(replay, SequenceReplay):
            return _load_sequence(replay, z, kind)
        if isinstance(replay, DeviceSequenceReplay):
            return _load_device_sequence(replay, z, kind)
        if isinstance(replay, DeviceFrameReplay):
            return _load_frame_ring(replay, z, kind)
        if isinstance(replay, PrioritizedReplay):
            _require(kind == "prioritized", f"file holds {kind!r}")
            t = replay.tree
            t.set(np.arange(t.size), z["tree"][t.size: 2 * t.size])
            replay.max_priority = float(z["max_priority"])
            replay._samples = int(z["samples"])
            _rng_load(replay._rng, _str(z["per_rng"]))
            base, inner = replay.base, "base_"
        else:
            expect = ("frame_stack" if isinstance(replay, FrameStackReplay)
                      else "memory")
            _require(kind == expect,
                     f"file holds {kind!r}, buffer is {expect!r}")
            base, inner = replay, ""
        if isinstance(base, FrameStackReplay):
            _require(int(z["meta_capacity"]) == base.capacity,
                     "capacity mismatch")
            _frame_stack_restore(base, z, inner)
        elif isinstance(base, ReplayMemory):
            _require(int(z["meta_capacity"]) == base.capacity,
                     "capacity mismatch")
            base.obs[:] = z[f"{inner}obs"]
            base.next_obs[:] = z[f"{inner}next_obs"]
            base.action[:] = z[f"{inner}action"]
            base.reward[:] = z[f"{inner}reward"]
            base.discount[:] = z[f"{inner}discount"]
            base._cursor = int(z[f"{inner}cursor"])
            base._size = int(z[f"{inner}size"])
            base._steps_added = int(z[f"{inner}steps_added"])
            _rng_load(base._rng, _str(z[f"{inner}rng"]))
        else:
            raise TypeError(f"no persistence for {type(replay).__name__}")
