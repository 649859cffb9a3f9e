"""Port vs reference: the R2D2 sequence replays, byte for byte.

One actor-side stream (a real ``SequenceBuilder`` and ``FrameStacker``,
random frames, short episodes, a time-limit truncation) feeds the
reference and the port. Pinned bitwise:

- ``SequenceBuilder``'s emissions, truncation included;
- ``SequenceReplay``'s samples and priority updates under one seed;
- ``DeviceSequenceReplay`` (the reference on a one-shard CPU mesh, its
  flush in Pallas interpret mode; the port through the kernels' plain
  versions): the ring bytes outside the scratch slot, the host metadata,
  the device metadata and priority twins, and ``sample()`` after the slots
  wrap, with priority updates between samples;
- ``compose_sequence_block`` (the production composition) against the
  reference's ``compose_sequence_rows``, and the port's twin against it.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_deep_q_tpu.actors.game import FrameStacker
from distributed_deep_q_tpu.config import MeshConfig
from distributed_deep_q_tpu.parallel.mesh import make_mesh
from distributed_deep_q_tpu.replay import device_sequence as ref_ds
from distributed_deep_q_tpu.replay import sequence as ref_seq

from distributed_deep_q_tpu_torch.replay import device_sequence as ds
from distributed_deep_q_tpu_torch.replay import sequence as seq

SEQ_LEN, BURN, STACK, HW, LSTM = 8, 4, 3, (6, 6), 4


def _drive(builders, n_steps, episode_len=11, truncate_at=27, seed=0):
    """One pixel stream into every builder; returns each builder's
    emissions. Episodes end every ``episode_len`` steps; the episode
    running at step ``truncate_at`` is cut by a time limit there."""
    rng = np.random.default_rng(seed)
    stacker = FrameStacker(HW, STACK)
    outs = [[] for _ in builders]
    obs = stacker.reset(rng.integers(0, 255, HW, dtype=np.uint8))
    t_in_ep = 0
    for t in range(n_steps):
        carry = (rng.standard_normal(LSTM).astype(np.float32),
                 rng.standard_normal(LSTM).astype(np.float32))
        t_in_ep += 1
        done = t_in_ep >= episode_len
        truncated = not done and t == truncate_at
        next_obs = stacker.push(rng.integers(0, 255, HW, dtype=np.uint8))
        a, r = t % 4, float(rng.standard_normal())
        for b, out in zip(builders, outs):
            out.extend(b.on_step(obs, a, r, done, carry, next_obs))
            if truncated:
                out.extend(b.flush_truncated(next_obs))
            if done or truncated:
                b.reset()
        obs = next_obs
        if done or truncated:
            t_in_ep = 0
            obs = stacker.reset(rng.integers(0, 255, HW, dtype=np.uint8))
    return outs


def _builders():
    shape = HW + (STACK,)
    return (ref_seq.SequenceBuilder(SEQ_LEN, BURN, shape, np.uint8, LSTM),
            seq.SequenceBuilder(SEQ_LEN, BURN, shape, np.uint8, LSTM))


def test_sequence_builder_emissions_match_reference():
    ref_out, out = _drive(_builders(), 120)
    assert len(out) == len(ref_out) >= 15
    masks = {int(s["mask"].sum()) for s in out}
    assert SEQ_LEN in masks and len(masks) > 1     # full and padded windows
    for a, b in zip(ref_out, out):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("prioritized", [False, True])
def test_sequence_replay_samples_and_priorities_match_reference(prioritized):
    """A 12-slot store fed ~25 sequences (it wraps); three samples with
    priority updates between them, stale ones included."""
    _, emitted = _drive(_builders(), 220, seed=1)
    kw = dict(lstm_size=LSTM, prioritized=prioritized, alpha=0.6, seed=3)
    shape = HW + (STACK,)
    ref = ref_seq.SequenceReplay(12, SEQ_LEN, shape, np.uint8, **kw)
    port = seq.SequenceReplay(12, SEQ_LEN, shape, np.uint8, **kw)
    rng = np.random.default_rng(4)
    for i, s in enumerate(emitted):
        assert ref.add_sequence(s) == port.add_sequence(s)
        if i % 9 == 8:
            a, b = ref.sample(6), port.sample(6)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            prio = rng.uniform(0, 3, 6)
            at = a["_sampled_at"] - (2 if i == 17 else 0)   # stale at 17
            ref.update_priorities(a["index"], prio, sampled_at=at)
            port.update_priorities(b["index"], prio, sampled_at=at)
    if prioritized:
        np.testing.assert_array_equal(port.tree.tree, ref.tree.tree)
        assert port.max_priority == ref.max_priority


def _device_pair(prioritized, capacity=10, write_chunk=3):
    mesh = make_mesh(MeshConfig(backend="cpu", num_fake_devices=8, dp=1))
    kw = dict(lstm_size=LSTM, prioritized=prioritized, alpha=0.6, seed=5,
              write_chunk=write_chunk)
    shape = HW + (STACK,)
    ref = ref_ds.DeviceSequenceReplay(capacity, SEQ_LEN, shape, mesh, **kw)
    port = ds.DeviceSequenceReplay(capacity, SEQ_LEN, shape, "cpu", **kw)
    return ref, port


@pytest.mark.parametrize("prioritized", [False, True])
def test_device_sequence_replay_matches_reference(prioritized):
    """Ring bytes (outside the scratch slot), host metadata, the device
    metadata and priority twins, and ``sample()`` after the 10 slots wrap
    twice, with priority updates between samples."""
    _, emitted = _drive(_builders(), 260, seed=2)
    assert len(emitted) > 25
    ref, port = _device_pair(prioritized)
    rng = np.random.default_rng(6)
    for i, s in enumerate(emitted):
        assert ref.add_sequence(s) == port.add_sequence(s)
        if i % 7 == 6 and i > 12:
            a, b = ref.sample(5), port.sample(5)
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            prio = rng.uniform(0, 3, 5)
            ref.update_priorities(a["index"], prio, a["_sampled_at"])
            port.update_priorities(b["index"], prio, b["_sampled_at"])
    ref.flush()
    port.flush()
    seq_elems = port.W * port.rowp
    np.testing.assert_array_equal(port.ring.numpy()[:-seq_elems],
                                  np.asarray(ref.ring)[:-seq_elems])
    for k in ds.META_KEYS + ("n_valid",):
        np.testing.assert_array_equal(getattr(port, k), getattr(ref, k),
                                      err_msg=k)
    for k in ds.META_KEYS + ("prio",):
        np.testing.assert_array_equal(port.dmeta[k].numpy(),
                                      np.asarray(ref.dmeta[k]), err_msg=k)
    if prioritized:
        np.testing.assert_array_equal(port.trees[0].tree, ref.trees[0].tree)
        assert port.max_priority == ref.max_priority
    assert len(port) == len(ref) == 10
    assert port.steps_added == ref.steps_added == len(emitted)


def test_device_sequence_plane_has_no_2_31_limit():
    """The reference refuses a per-shard plane of 2³¹ elements or more
    (Mosaic's index range); the port builds the r2d2 preset's 12,500-slot
    plane of 2.15·10⁹ int32 (on the ``meta`` device here, which allocates
    nothing: the real one is 8.6 GB)."""
    mesh = make_mesh(MeshConfig(backend="cpu", num_fake_devices=8, dp=1))
    with pytest.raises(AssertionError, match="32-bit"):
        ref_ds.DeviceSequenceReplay(12_500, 80, (84, 84, 4), mesh)
    port = ds.DeviceSequenceReplay(12_500, 80, (84, 84, 4), "meta")
    assert port.W == 84 and port.seq_bytes == 84 * 8192
    assert port.ring.numel() == 12_501 * 84 * 2048 >= 2**31


def test_compose_sequence_block_matches_reference_rows():
    """The ring step's composition: one ``[b, W, rowp]`` window per
    sequence → stacks by static slices, against the reference's gather
    composition over the ring's ``[rows, H·W]`` view (tail steps past
    n_valid zeroed). The port's gather twin agrees too."""
    _, emitted = _drive(_builders(), 150, seed=7)
    _, port = _device_pair(False, capacity=32, write_chunk=4)
    for s in emitted:
        port.add_sequence(s)
    port.flush()
    rng = np.random.default_rng(8)
    slots = rng.integers(0, len(port), 12).astype(np.int32)
    mask = port.mask[slots]
    n_valid = port.n_valid[slots]
    ring_rows = port.ring.view(torch.uint8).view(-1, port.rowb)[
        :, :port._row_len]
    want = ref_ds.compose_sequence_rows(
        jnp.asarray(ring_rows.numpy()), jnp.asarray(slots),
        jnp.asarray(n_valid), SEQ_LEN, STACK)
    W, rowp = port.W, port.rowp
    block = port.ring.view(-1, W, rowp)[torch.from_numpy(slots).long()]
    got = ds.compose_sequence_block(block, torch.from_numpy(mask), SEQ_LEN,
                                    STACK, port._row_len)
    assert got.shape == (12, SEQ_LEN + 1, STACK, port._row_len)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    twin = ds.compose_sequence_rows(ring_rows, torch.from_numpy(slots),
                                    torch.from_numpy(n_valid), SEQ_LEN, STACK)
    np.testing.assert_array_equal(twin.numpy(), np.asarray(want))
    # and they are the stacked observations the builder emitted
    assert len(emitted) <= 32 and int((n_valid < SEQ_LEN).sum()) > 0
    for k, slot in enumerate(slots):
        obs = got[k].numpy().reshape((SEQ_LEN + 1, STACK) + HW)
        np.testing.assert_array_equal(np.moveaxis(obs, 1, -1),
                                      emitted[slot]["obs"])


def test_stream_from_stacked_obs_matches_reference():
    _, emitted = _drive(_builders(), 90, seed=9)
    for s in emitted:
        n = int(s["mask"].sum())
        np.testing.assert_array_equal(
            ds.stream_from_stacked_obs(s["obs"], n, STACK),
            ref_ds.stream_from_stacked_obs(s["obs"], n, STACK))
