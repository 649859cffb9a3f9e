"""Port vs reference: the host replay — sum tree, PER, the two ring
buffers, the n-step accumulator, the delayed priority write-back, and the
host-sampled ``DeviceFrameReplay`` — byte for byte under the same seeds.

Every structure here is host numpy on both sides (the port's copies), so
every pin is bitwise: sampled indices, gathered frames and metadata, IS
weights, and sum-tree nodes after priority updates. The one device piece,
the ``DeviceFrameReplay`` ring, is compared as bytes, and the port's
``compose_stacks`` against the reference's (whose ``[B, H, W, stack]``
output the port keeps as ``[B, stack, H, W]``).
"""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_deep_q_tpu.actors.game import (
    NStepAccumulator as RefNStep)
from distributed_deep_q_tpu.config import MeshConfig
from distributed_deep_q_tpu.config import ReplayConfig as RefReplayConfig
from distributed_deep_q_tpu.parallel.mesh import make_mesh
from distributed_deep_q_tpu.replay import device_ring as ref_ring
from distributed_deep_q_tpu.replay import prioritized as ref_per
from distributed_deep_q_tpu.replay import replay_memory as ref_mem

from distributed_deep_q_tpu_torch import native
from distributed_deep_q_tpu_torch.actors.game import NStepAccumulator
from distributed_deep_q_tpu_torch.config import ReplayConfig
from distributed_deep_q_tpu_torch.replay import device_ring as port_ring
from distributed_deep_q_tpu_torch.replay import prioritized as port_per
from distributed_deep_q_tpu_torch.replay import replay_memory as port_mem

FRAME, STACK, N_STEP, GAMMA = (8, 8), 4, 3, 0.99


def _assert_batches_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        if isinstance(want[k], (int, tuple)):
            assert got[k] == want[k], k
        else:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _pixel_stream(n, seed=0, episode_len=13):
    """Random frames/actions/rewards, episode ends every ``episode_len``
    steps and a truncation-only boundary every 29."""
    rng = np.random.default_rng(seed)
    t = 0
    for _ in range(n):
        frame = rng.integers(0, 255, FRAME, dtype=np.uint8)
        a, r = int(rng.integers(0, 4)), float(rng.standard_normal())
        t += 1
        done = t % episode_len == 0
        trunc = (not done) and (t % 29 == 0)
        yield frame, a, r, done, done or trunc
        if done or trunc:
            t = 0


@pytest.mark.parametrize("use_native", [False, True])
def test_sum_tree_matches_reference(use_native):
    """Batched sets (duplicates: last write wins) and stratified draws; the
    port's native and numpy paths also agree with each other."""
    if use_native and shutil.which("g++"):
        assert native.load() is not None
    rng = np.random.default_rng(0)
    port = port_per.SumTree(1000, use_native=use_native)
    ref = ref_per.SumTree(1000, use_native=use_native)
    numpy_twin = port_per.SumTree(1000, use_native=False)
    draw_p, draw_r = np.random.default_rng(1), np.random.default_rng(1)
    for _ in range(20):
        idx = rng.integers(0, 1000, 64)
        p = rng.random(64) ** 2
        for tree in (port, ref, numpy_twin):
            tree.set(idx, p)
        np.testing.assert_array_equal(port.tree, ref.tree)
        np.testing.assert_array_equal(port.tree, numpy_twin.tree)
        np.testing.assert_array_equal(port.sample_stratified(32, draw_p),
                                      ref.sample_stratified(32, draw_r))
    with pytest.raises(IndexError):
        port.set(np.asarray([port.size]), np.asarray([1.0]))


def test_nstep_accumulator_matches_reference():
    rng = np.random.default_rng(2)
    port, ref = NStepAccumulator(3, GAMMA), RefNStep(3, GAMMA)
    out_p, out_r = [], []
    for t in range(200):
        obs = rng.normal(size=4).astype(np.float32)
        nxt = rng.normal(size=4).astype(np.float32)
        a, r = int(rng.integers(2)), float(rng.normal())
        done = t % 17 == 16
        out_p += port.push(obs, a, r, nxt, done)
        out_r += ref.push(obs, a, r, nxt, done)
        if t % 23 == 22:           # a truncation: flush with bootstrap
            out_p += port.flush_truncated(nxt)
            out_r += ref.flush_truncated(nxt)
            port.reset()
            ref.reset()
    assert len(out_p) == len(out_r) > 150
    for tp, tr in zip(out_p, out_r):
        for x, y in zip(tp, tr):
            np.testing.assert_array_equal(x, y)
            assert type(x) is type(y)


def _cartpole_like(replays, n, seed=3):
    rng = np.random.default_rng(seed)
    accs = [NStepAccumulator(N_STEP, GAMMA) for _ in replays]
    for t in range(n):
        obs = rng.normal(size=4).astype(np.float32)
        nxt = rng.normal(size=4).astype(np.float32)
        a, r, done = int(rng.integers(2)), 1.0, t % 37 == 36
        for rep, acc in zip(replays, accs):
            for tr in acc.push(obs, a, r, nxt, done):
                rep.add(*tr)


@pytest.mark.parametrize("prioritized", [False, True])
def test_replay_memory_matches_reference(prioritized):
    """ReplayMemory (uniform, or wrapped in PER through ``maybe_prioritize``)
    over a wrapped ring: samples, weights, snapshots and — after stale and
    fresh priority updates — every tree node."""
    kw = dict(capacity=300, batch_size=32, prioritized=prioritized)
    port = port_per.maybe_prioritize(
        port_mem.ReplayMemory(300, (4,), np.float32, seed=5),
        ReplayConfig(**kw), seed=5)
    ref = ref_per.maybe_prioritize(
        ref_mem.ReplayMemory(300, (4,), np.float32, seed=5),
        RefReplayConfig(**kw), seed=5)
    _cartpole_like([port, ref], 400)
    rng = np.random.default_rng(4)
    for step in range(6):
        bp, br = port.sample(32), ref.sample(32)
        _assert_batches_equal(bp, br)
        # rows written after the snapshot must be filtered as stale
        _cartpole_like([port, ref], 25, seed=10 + step)
        if prioritized:
            td = rng.normal(size=32).astype(np.float32)
            port.update_priorities(bp["index"], td, bp["_sampled_at"])
            ref.update_priorities(br["index"], td, br["_sampled_at"])
            np.testing.assert_array_equal(port.tree.tree, ref.tree.tree)
            assert port.max_priority == ref.max_priority


@pytest.mark.parametrize("prioritized", [False, True])
def test_frame_stack_replay_matches_reference(prioritized):
    """The frame-storing FrameStackReplay: stacks (zeroed before episode
    starts), n-step returns, discounts, validity redraws around the cursor
    and truncations — the sampled pixel batches equal byte for byte."""
    kw = dict(capacity=200, batch_size=16, prioritized=prioritized,
              n_step=N_STEP)
    port = port_per.maybe_prioritize(port_mem.FrameStackReplay(
        200, FRAME, STACK, N_STEP, GAMMA, seed=7), ReplayConfig(**kw),
        seed=7)
    ref = ref_per.maybe_prioritize(ref_mem.FrameStackReplay(
        200, FRAME, STACK, N_STEP, GAMMA, seed=7), RefReplayConfig(**kw),
        seed=7)
    stream = _pixel_stream(400)
    for _ in range(260):
        f, a, r, d, b = next(stream)
        port.add(f, a, r, d, boundary=b)
        ref.add(f, a, r, d, boundary=b)
    assert port.ready(100) and ref.ready(100)
    rng = np.random.default_rng(8)
    for _ in range(5):
        bp, br = port.sample(16), ref.sample(16)
        _assert_batches_equal(bp, br)
        assert bp["obs"].shape == (16, *FRAME, STACK)
        if prioritized:
            td = rng.normal(size=16).astype(np.float32)
            port.update_priorities(bp["index"], td, bp["_sampled_at"])
            ref.update_priorities(br["index"], td, br["_sampled_at"])
            np.testing.assert_array_equal(port.tree.tree, ref.tree.tree)
        for _ in range(20):
            f, a, r, d, b = next(stream)
            port.add(f, a, r, d, boundary=b)
            ref.add(f, a, r, d, boundary=b)
    port.base.seal_stream() if prioritized else port.seal_stream()
    ref.base.seal_stream() if prioritized else ref.seal_stream()
    base_p = port.base if prioritized else port
    base_r = ref.base if prioritized else ref
    np.testing.assert_array_equal(base_p.boundary, base_r.boundary)


def test_delayed_writeback_matches_reference():
    """Priorities pushed as tensors reach the tree ``depth`` steps later,
    the same as the reference's pushes of host arrays; ``drain`` applies
    the tail."""
    kw = dict(capacity=300, batch_size=32, prioritized=True,
              priority_writeback_delay=3)
    port = port_per.maybe_prioritize(
        port_mem.ReplayMemory(300, (4,), np.float32, seed=1),
        ReplayConfig(**kw), seed=1)
    ref = ref_per.maybe_prioritize(
        ref_mem.ReplayMemory(300, (4,), np.float32, seed=1),
        RefReplayConfig(**kw), seed=1)
    _cartpole_like([port, ref], 350)
    wb_p = port_per.make_writeback(port, ReplayConfig(**kw))
    wb_r = ref_per.make_writeback(ref, RefReplayConfig(**kw))
    rng = np.random.default_rng(6)
    for step in range(7):
        bp, br = port.sample(32), ref.sample(32)
        _assert_batches_equal(bp, br)
        td = rng.normal(size=32).astype(np.float32)
        wb_p.push(bp["index"], torch.from_numpy(td), bp["_sampled_at"])
        wb_r.push(br["index"], td, br["_sampled_at"])
        assert len(wb_p._q) == min(step + 1, 3)
        np.testing.assert_array_equal(port.tree.tree, ref.tree.tree)
        _cartpole_like([port, ref], 40, seed=20 + step)
    wb_p.drain()
    wb_r.drain()
    assert not wb_p._q
    np.testing.assert_array_equal(port.tree.tree, ref.tree.tree)


def _device_frame_replays(prioritized, num_streams):
    kw = dict(capacity=256, batch_size=32, n_step=N_STEP,
              prioritized=prioritized, device_per=False, write_chunk=16)
    mesh = make_mesh(MeshConfig(backend="cpu", num_fake_devices=8, dp=1))
    ref = ref_ring.DeviceFrameReplay(RefReplayConfig(**kw), mesh, FRAME,
                                     STACK, GAMMA, seed=3, write_chunk=16,
                                     num_streams=num_streams)
    port = port_ring.DeviceFrameReplay(ReplayConfig(**kw), "cpu", FRAME,
                                       STACK, GAMMA, seed=3, write_chunk=16,
                                       num_streams=num_streams)
    return ref, port


def _feed(replays, n, num_streams, seed):
    """``n`` rows per stream as 20-row chunks (``add_batch``), the streams
    interleaved, so every stream slot fills and the sub-rings wrap."""
    streams = [_pixel_stream(n, seed=seed + s) for s in range(num_streams)]
    for _ in range(n // 20):
        for s, stream in enumerate(streams):
            rows = [next(stream) for _ in range(20)]
            batch = {"frame": np.stack([r[0] for r in rows]),
                     "action": np.asarray([r[1] for r in rows], np.int32),
                     "reward": np.asarray([r[2] for r in rows], np.float32),
                     "done": np.asarray([r[3] for r in rows]),
                     "boundary": np.asarray([r[4] for r in rows])}
            for rep in replays:
                rep.add_batch(batch, stream=s)


@pytest.mark.parametrize("prioritized", [False, True])
@pytest.mark.parametrize("num_streams", [1, 2])
def test_device_frame_replay_host_sample_matches_reference(prioritized,
                                                           num_streams):
    """The host-sampled device ring: ring bytes, index batches (slot
    allocation, draws, metadata, IS weights, snapshots), the per-slot trees
    after write-backs (stale rows filtered), and the composed stacks."""
    ref, port = _device_frame_replays(prioritized, num_streams)
    _feed([ref, port], 160 * 2 // num_streams, num_streams, seed=0)
    rng = np.random.default_rng(9)
    for step in range(4):
        bp, br = port.sample(32), ref.sample(32)
        _assert_batches_equal(bp, br)
        np.testing.assert_array_equal(port.ring.numpy(),
                                      np.asarray(ref.ring))
        obs = port_ring.compose_stacks(port.ring, torch.from_numpy(bp["oidx"]),
                                       torch.from_numpy(bp["valid"]), FRAME)
        want = ref_ring.compose_stacks(ref.ring, jnp.asarray(br["oidx"]),
                                       jnp.asarray(br["valid"]), FRAME)
        np.testing.assert_array_equal(obs.permute(0, 2, 3, 1).numpy(),
                                      np.asarray(want))
        td = rng.normal(size=32).astype(np.float32)
        # rows written after the snapshot must be filtered as stale
        _feed([ref, port], 20 * num_streams, num_streams, seed=50 + step)
        port.update_priorities(bp["index"], td, bp["_sampled_at"])
        ref.update_priorities(br["index"], td, br["_sampled_at"])
        if prioritized:
            for tp, tr in zip(port.trees, ref.trees):
                np.testing.assert_array_equal(tp.tree, tr.tree)
            assert port.max_priority == ref.max_priority
    assert port.steps_added == ref.steps_added
