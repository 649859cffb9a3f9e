"""Port vs reference: replay persistence (``replay/persistence.py``) on every
replay tier the port has.

Each tier is filled by one stream, sampled and (where prioritized) given
new priorities, then fed more rows (the device tiers then hold staged rows
that the save must flush). For each tier:

- round trip: the port saves, a port buffer built from another seed loads,
  and its next sample is bitwise the one the saved buffer draws next;
- reference → port: the reference saves with its ``save_replay``, the port
  loads, and the port's next sample equals the reference's;
- port → reference: the same, the other way.

"Next sample" is ``sample()`` (indices, gathered frames or index batches,
IS weights, snapshots) for the host-sampled tiers; for the fused
``DevicePERFrameReplay`` it is the dispatch's sample stage (sampled rows,
window starts, the ``gather_windows`` windows, metadata and IS weights)
drawn from the reference's own uniforms, at α = 0 as the Pong preset runs
it (the pin slice 1 holds). The device planes (rings, metadata and
priority rows) are compared as bytes. A geometry mismatch and a file of
another kind are refused, and so is a file saved from another shard
count; a file from two shards crosses between the packages' two-shard
replays, its next draws bitwise.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from distributed_deep_q_tpu.compat import shard_map
from distributed_deep_q_tpu.config import MeshConfig
from distributed_deep_q_tpu.config import ReplayConfig as RefReplayConfig
from distributed_deep_q_tpu.ops.ring_gather import (
    gather_windows as ref_gather_windows)
from distributed_deep_q_tpu.parallel.mesh import make_mesh
from distributed_deep_q_tpu.replay import device_per as ref_dp
from distributed_deep_q_tpu.replay import device_ring as ref_ring
from distributed_deep_q_tpu.replay import device_sequence as ref_ds
from distributed_deep_q_tpu.replay import persistence as ref_persist
from distributed_deep_q_tpu.replay import prioritized as ref_per
from distributed_deep_q_tpu.replay import replay_memory as ref_mem
from distributed_deep_q_tpu.replay import sequence as ref_seq

from distributed_deep_q_tpu_torch.config import ReplayConfig
from distributed_deep_q_tpu_torch.parallel.learner import fused_sample
from distributed_deep_q_tpu_torch.replay import device_per as port_dp
from distributed_deep_q_tpu_torch.replay import device_ring as ring
from distributed_deep_q_tpu_torch.replay import device_sequence as ds
from distributed_deep_q_tpu_torch.replay import persistence
from distributed_deep_q_tpu_torch.replay import prioritized as per
from distributed_deep_q_tpu_torch.replay import replay_memory as mem
from distributed_deep_q_tpu_torch.replay import sequence as seq
from distributed_deep_q_tpu_torch.solver import sample_key_schedule

FRAME, STACK, N_STEP, GAMMA = (8, 8), 4, 2, 0.99
SEQ_LEN, LSTM = 8, 4
BATCH, CHAIN = 16, 2

TIERS = ["memory", "memory_per", "frame_stack", "frame_stack_per",
         "device_ring", "device_ring_trees", "device_per", "sequence",
         "sequence_per", "device_sequence", "device_sequence_per"]


def _mesh(dp=1):
    return make_mesh(MeshConfig(backend="cpu", num_fake_devices=8, dp=dp))


def _ring_cfg(ref: bool, prioritized: bool, device_per: bool, alpha=0.6):
    kw = dict(capacity=256, batch_size=BATCH, n_step=N_STEP,
              prioritized=prioritized, priority_alpha=alpha,
              device_per=device_per, write_chunk=16)
    return (RefReplayConfig if ref else ReplayConfig)(**kw)


def _build(tier: str, ref: bool, seed: int, dp: int = 1):
    """The tier's buffer in the reference (one-shard CPU mesh unless
    ``dp``) or the port (on the CPU, ``dp`` shards)."""
    m_mem, m_per, m_seq = ((ref_mem, ref_per, ref_seq) if ref
                           else (mem, per, seq))
    if tier in ("memory", "memory_per"):
        base = m_mem.ReplayMemory(128, (4,), np.float32, seed=seed)
        return (m_per.PrioritizedReplay(base, alpha=0.6, seed=seed + 1)
                if tier == "memory_per" else base)
    if tier in ("frame_stack", "frame_stack_per"):
        base = m_mem.FrameStackReplay(256, FRAME, STACK, N_STEP, GAMMA,
                                      seed=seed)
        return (m_per.PrioritizedReplay(base, alpha=0.6, seed=seed + 1)
                if tier == "frame_stack_per" else base)
    if tier in ("sequence", "sequence_per"):
        return m_seq.SequenceReplay(16, SEQ_LEN, (6, 6, 3), np.uint8,
                                    lstm_size=LSTM, alpha=0.6,
                                    prioritized=tier == "sequence_per",
                                    seed=seed)
    if tier in ("device_sequence", "device_sequence_per"):
        kw = dict(lstm_size=LSTM, alpha=0.6, seed=seed, write_chunk=3,
                  prioritized=tier == "device_sequence_per")
        if ref:
            return ref_ds.DeviceSequenceReplay(16, SEQ_LEN, (6, 6, 3),
                                               _mesh(dp), **kw)
        return ds.DeviceSequenceReplay(16, SEQ_LEN, (6, 6, 3), "cpu",
                                       num_shards=dp, **kw)
    if tier == "device_per":
        cfg = _ring_cfg(ref, True, True, alpha=0.0)
        if ref:
            return ref_dp.DevicePERFrameReplay(
                cfg, _mesh(dp), FRAME, STACK, GAMMA, seed=seed,
                write_chunk=16, num_streams=2)
        return port_dp.DevicePERFrameReplay(cfg, "cpu", FRAME, STACK, GAMMA,
                                       seed=seed, write_chunk=16,
                                       num_streams=2, num_shards=dp)
    prioritized = tier == "device_ring_trees"
    streams = 1 if prioritized else 2
    cfg = _ring_cfg(ref, prioritized, False)
    if ref:
        return ref_ring.DeviceFrameReplay(cfg, _mesh(dp), FRAME, STACK,
                                          GAMMA, seed=seed, write_chunk=16,
                                          num_streams=streams)
    return ring.DeviceFrameReplay(cfg, "cpu", FRAME, STACK, GAMMA,
                                  seed=seed, write_chunk=16,
                                  num_streams=streams, num_shards=dp)


def _sequences(n, seed):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        mask = (np.arange(SEQ_LEN) < rng.integers(4, SEQ_LEN + 1)
                ).astype(np.float32)
        yield {
            "obs": rng.integers(0, 255, (SEQ_LEN + 1, 6, 6, 3),
                                dtype=np.uint8),
            "action": rng.integers(0, 4, SEQ_LEN).astype(np.int32),
            "reward": rng.standard_normal(SEQ_LEN).astype(np.float32),
            "discount": np.full(SEQ_LEN, 0.99, np.float32) * mask,
            "mask": mask,
            "init_c": rng.standard_normal(LSTM).astype(np.float32),
            "init_h": rng.standard_normal(LSTM).astype(np.float32)}


def _feed(tier: str, replays, n: int, seed: int) -> None:
    """The same ``n`` rows (or sequences) into every buffer."""
    rng = np.random.default_rng(seed)
    if tier.startswith("memory"):
        for i in range(n):
            o, o2 = rng.standard_normal(4), rng.standard_normal(4)
            a, r = int(rng.integers(2)), float(rng.standard_normal())
            for rep in replays:
                rep.add(o, a, r, o2, 0.0 if i % 17 == 16 else 0.99)
        return
    if "sequence" in tier:
        for s in _sequences(n, seed):
            for rep in replays:
                rep.add_sequence(s)
        return
    streams = 2 if tier in ("device_ring", "device_per") else 1
    if streams == 1:
        for i in range(n):
            f = rng.integers(0, 255, FRAME, dtype=np.uint8)
            a, r = int(rng.integers(4)), float(rng.standard_normal())
            trunc = i % 29 == 28
            for rep in replays:
                rep.add(f, a, r, i % 13 == 12, boundary=i % 13 == 12 or trunc)
        return
    for c in range(n // 20):
        done = np.zeros(20, bool)
        done[-1] = c % 2 == 1
        batch = {"frame": rng.integers(0, 255, (20,) + FRAME, np.uint8),
                 "action": rng.integers(0, 4, 20).astype(np.int32),
                 "reward": rng.standard_normal(20).astype(np.float32),
                 "done": done}
        for rep in replays:
            rep.add_batch(batch, stream=c % 2)


def _ref_fused_draw(ref, keys, betas):
    """The reference's packed draw (prep + pack + draw) and its
    ``gather_windows`` under a one-shard ``shard_map``."""
    d = ref.dstate
    cursors, sizes = ref.device_inputs()

    def f(keys, action, reward, done, boundary, prio, cursors, sizes, betas):
        rows = dict(action=action, reward=reward, done=done,
                    boundary=boundary, prio=prio)
        pm, cdf, mass, n_glob = ref_dp.fused_sample_prep(
            rows, cursors, sizes, ref.slot_cap, STACK, N_STEP)
        pack = ref_dp.build_meta_pack(action, reward, done, boundary,
                                      ref.slot_cap, STACK, N_STEP, GAMMA)
        return ref_dp.fused_sample_draw_packed(
            keys, pack, pm, cdf, mass, n_glob, BATCH, ref.slot_cap,
            ref.slot_pad, STACK, N_STEP, betas, 1)

    S = P("dp")
    g = jax.jit(shard_map(f, mesh=ref.mesh,
                          in_specs=(P(),) + (S,) * 7 + (P(),),
                          out_specs=P(), check_vma=False))
    meta, ws, idx = jax.tree.map(np.asarray, g(
        jnp.asarray(keys), d.action, d.reward, d.done, d.boundary, d.prio,
        jnp.asarray(cursors), jnp.asarray(sizes), jnp.asarray(betas)))
    win = np.asarray(ref_gather_windows(
        jnp.asarray(ws.reshape(-1)), d.frames, n=CHAIN * BATCH,
        w=STACK + N_STEP, rowb=ref.rowb, interpret=True))
    return {"idx": idx, "ws": ws, "win": win,
            **{f"meta_{k}": v for k, v in meta.items()}}


def _port_fused_draw(port, keys, u):
    cursors, sizes = port.device_inputs()
    betas = port.next_betas(CHAIN)
    spec = (port.slot_cap, port.slot_pad, port.rowb, port._row_len, STACK,
            N_STEP, GAMMA, FRAME, BATCH, 0.0, 1e-6, 1)
    meta, win, idx, ws = fused_sample(
        port.dstate, torch.from_numpy(cursors), torch.from_numpy(sizes),
        torch.from_numpy(betas), torch.from_numpy(u), spec)
    return {"idx": idx.numpy(), "ws": ws.numpy(), "win": win.numpy(),
            **{f"meta_{k}": v.numpy() for k, v in meta.items()}}


def _keys_and_uniforms(step: int):
    keys = sample_key_schedule(seed=0, start_step=step, num_shards=1,
                               chain=CHAIN)[0]
    u = np.stack([np.asarray(jax.random.uniform(jnp.asarray(k), (BATCH,)))
                  for k in keys])
    return keys, u


def _next_sample(tier: str, replay, ref: bool) -> dict:
    """What the buffer draws next, as numpy arrays."""
    if tier == "device_per":
        keys, u = _keys_and_uniforms(replay._samples)
        if ref:
            betas = replay.next_betas(CHAIN)
            return _ref_fused_draw(replay, keys, betas)
        return _port_fused_draw(replay, keys, u)
    b = dict(replay.sample(BATCH))
    if "_sampled_at" in b:
        b["_sampled_at"] = np.asarray(b["_sampled_at"])
    return b


def _device_planes(tier: str, replay, ref: bool) -> dict:
    if tier == "device_per":
        st = replay.dstate
        get = (lambda k: getattr(st, k)) if ref else (lambda k: st[k])
        return {k: np.asarray(get(k)) for k in persistence._PER_PLANES}
    if tier.startswith("device_ring"):
        return {"ring": np.asarray(replay.ring)}
    if tier.startswith("device_sequence"):
        out = {"ring": np.asarray(replay.ring),
               "maxp": np.asarray(replay.dmaxp)}
        out.update({k: np.asarray(v) for k, v in replay.dmeta.items()})
        return out
    return {}


def _prepare(tier: str, replay, ref: bool) -> None:
    """Fill, sample, write priorities, fill more (rows staged again)."""
    n = {"memory": 90, "sequence": 20, "device_sequence": 20}.get(
        tier.removesuffix("_per").removesuffix("_trees"), 200)
    _feed(tier, [replay], n, seed=1)
    if tier == "device_per":
        _next_sample(tier, replay, ref)
    else:
        b = replay.sample(BATCH)
        if getattr(replay, "prioritized", False):
            replay.update_priorities(
                b["index"], np.linspace(0.1, 3.0, BATCH),
                b.get("_sampled_at"))
    _feed(tier, [replay], 7 if "sequence" in tier else 40, seed=2)


def _assert_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      err_msg=k)


@pytest.mark.parametrize("tier", TIERS)
def test_round_trip_next_sample_is_bitwise(tier, tmp_path):
    torch.set_num_threads(1)
    path = str(tmp_path / "replay")        # ".npz" appended, as np.savez
    a = _build(tier, ref=False, seed=0)
    _prepare(tier, a, ref=False)
    persistence.save_replay(a, path)
    b = _build(tier, ref=False, seed=999)   # the file sets every RNG
    persistence.load_replay(b, path + ".npz")
    _assert_equal(_device_planes(tier, b, False),
                  _device_planes(tier, a, False))
    assert len(a) == len(b) and a.steps_added == b.steps_added
    _assert_equal(_next_sample(tier, b, False), _next_sample(tier, a, False))


@pytest.mark.parametrize("tier", TIERS)
def test_reference_file_loads_into_the_port(tier, tmp_path):
    torch.set_num_threads(1)
    path = str(tmp_path / "ref.npz")
    r = _build(tier, ref=True, seed=0)
    _prepare(tier, r, ref=True)
    ref_persist.save_replay(r, path)
    p = _build(tier, ref=False, seed=999)
    persistence.load_replay(p, path)
    _assert_equal(_device_planes(tier, p, False),
                  _device_planes(tier, r, True))
    _assert_equal(_next_sample(tier, p, False), _next_sample(tier, r, True))


@pytest.mark.parametrize("tier", TIERS)
def test_port_file_loads_into_the_reference(tier, tmp_path):
    torch.set_num_threads(1)
    path = str(tmp_path / "port.npz")
    p = _build(tier, ref=False, seed=0)
    _prepare(tier, p, ref=False)
    persistence.save_replay(p, path)
    r = _build(tier, ref=True, seed=999)
    ref_persist.load_replay(r, path)
    _assert_equal(_device_planes(tier, r, True),
                  _device_planes(tier, p, False))
    _assert_equal(_next_sample(tier, r, True), _next_sample(tier, p, False))


def test_replay_state_owns_its_arrays():
    """``replay_state``'s host arrays are copies: the buffer keeps
    changing under a captured state."""
    r = _build("frame_stack", ref=False, seed=0)
    _feed("frame_stack", [r], 50, seed=1)
    state = persistence.replay_state(r)
    before = state["frames"].copy()
    _feed("frame_stack", [r], 50, seed=2)
    np.testing.assert_array_equal(state["frames"], before)
    assert not np.array_equal(r.frames, before)


@pytest.mark.parametrize("tier, other, match", [
    ("frame_stack", lambda: mem.FrameStackReplay(128, FRAME, STACK, N_STEP,
                                                 GAMMA), "capacity"),
    ("memory", lambda: mem.FrameStackReplay(128, FRAME, STACK, N_STEP,
                                            GAMMA), "file holds"),
    ("device_per", lambda: port_dp.DevicePERFrameReplay(
        _ring_cfg(False, True, True, 0.0), "cpu", FRAME, STACK, GAMMA,
        write_chunk=16, num_streams=1), "geometry"),
    ("device_ring", lambda: port_dp.DevicePERFrameReplay(
        _ring_cfg(False, True, True, 0.0), "cpu", FRAME, STACK, GAMMA,
        write_chunk=16, num_streams=2), "'device_ring', buffer"),
    ("device_sequence_per", lambda: ds.DeviceSequenceReplay(
        16, SEQ_LEN + 1, (6, 6, 3), "cpu", LSTM, prioritized=True),
     "geometry"),
    ("device_sequence_per", lambda: ds.DeviceSequenceReplay(
        16, SEQ_LEN, (6, 6, 3), "cpu", LSTM, prioritized=False),
     "prioritized-ness"),
])
def test_mismatched_buffers_are_refused(tier, other, match, tmp_path):
    path = str(tmp_path / "r.npz")
    r = _build(tier, ref=False, seed=0)
    _feed(tier, [r], 60 if "sequence" not in tier else 5, seed=1)
    persistence.save_replay(r, path)
    with pytest.raises(ValueError, match=match):
        persistence.load_replay(other(), path)


SHARDED = ["device_ring_trees", "device_per", "device_sequence_per"]


@pytest.mark.parametrize("tier", SHARDED)
def test_multi_shard_files_are_refused(tier, tmp_path):
    """A reference file from a two-shard mesh loads only into a two-shard
    replay (``test_multi_shard_files_cross_at_their_shard_count``): into
    the port at one shard it is refused, both counts named."""
    path = str(tmp_path / "r2.npz")
    r = _build(tier, ref=True, seed=0, dp=2)
    _feed(tier, [r], 80 if "sequence" not in tier else 6, seed=1)
    ref_persist.save_replay(r, path)
    with pytest.raises(ValueError, match="saved from 2 shard.*has 1"):
        persistence.load_replay(_build(tier, ref=False, seed=0), path)


def _sharded_next_sample(tier: str, replay, ref: bool) -> dict:
    """What a two-shard buffer draws next: ``sample()``, or for the fused
    ring its sample stage from the shared key schedule with no uniforms
    injected (indices and window starts in the port's global
    coordinates)."""
    if tier != "device_per":
        return _next_sample(tier, replay, ref)
    keys = sample_key_schedule(seed=0, start_step=replay._samples,
                               num_shards=2, chain=CHAIN)
    betas = replay.next_betas(CHAIN)
    if ref:
        from test_torch_sharded_replay import _ref_draw, _to_global
        meta, ws, idx, win = _ref_draw(replay, keys, betas)
        idx, ws = _to_global(replay, idx, ws)
    else:
        from test_torch_sharded_replay import _port_draw
        meta, win, idx, ws = _port_draw(replay, keys, betas)
        meta = {k: v.numpy() for k, v in meta.items()}
        idx, ws, win = idx.numpy(), ws.numpy(), win.numpy()
    return {"idx": idx, "ws": ws, "win": np.asarray(win).reshape(-1),
            **{f"meta_{k}": np.asarray(v) for k, v in meta.items()}}


@pytest.mark.parametrize("from_ref", [True, False])
@pytest.mark.parametrize("tier", SHARDED)
def test_multi_shard_files_cross_at_their_shard_count(tier, from_ref,
                                                      tmp_path):
    """A dp=2 file saved by either package loads into the other's
    two-shard replay: the device planes bitwise, and the next sampled rows
    (and, on the fused ring, windows and IS weights) bitwise."""
    torch.set_num_threads(1)
    path = str(tmp_path / "d2.npz")
    src = _build(tier, ref=from_ref, seed=0, dp=2)
    n = 80 if "sequence" not in tier else 6
    _feed(tier, [src], n, seed=1)
    if tier == "device_per":
        _feed(tier, [src], 100, seed=3)      # stream 1 too: both shards
    (ref_persist if from_ref else persistence).save_replay(src, path)
    dst = _build(tier, ref=not from_ref, seed=999, dp=2)
    (persistence if from_ref else ref_persist).load_replay(dst, path)
    got, want = ((dst, src) if from_ref else (src, dst))
    if tier == "device_per":
        plane = {k: np.asarray(got.dstate[k]) for k in ("action", "prio")}
        ref_plane = {k: np.asarray(getattr(want.dstate, k))
                     for k in ("action", "prio")}
        _assert_equal(plane, ref_plane)
        rows = got.dstate["frames"].numpy().reshape(2, got.shard_rows, -1)
        np.testing.assert_array_equal(
            rows[:, :-1], np.asarray(want.dstate.frames).reshape(
                2, got.shard_rows, -1)[:, :-1])
    else:
        _assert_equal(_device_planes(tier, got, False),
                      _device_planes(tier, want, True))
    _assert_equal(_sharded_next_sample(tier, got, False),
                  _sharded_next_sample(tier, want, True))
