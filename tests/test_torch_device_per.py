"""Port vs reference: the device-PER replay's write path and sample stage.

One transition stream feeds the reference ``DevicePERFrameReplay`` (on a
one-shard CPU mesh, its frame scatter in Pallas interpret mode) and the
port's (on the CPU, through the kernels' plain versions). Then:

- bitwise: ring bytes (excluding the scratch row, where padding lanes race
  by contract), the metadata and priority rings, ``valid_mask``, the meta
  pack's lanes 0, 2 and 3+, and — from the REFERENCE's uniforms — the
  sampled indices, window starts, pixel windows, validity planes and the
  IS weights at α = 0;
- the pack's n-step return lane (and the sampled rewards) within 1e-6: the
  sum runs as the same float32 ops, but XLA may fuse them differently.
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

from distributed_deep_q_tpu_torch.config import ReplayConfig
from distributed_deep_q_tpu_torch.parallel.learner import fused_sample
from distributed_deep_q_tpu_torch.replay import device_per as dp
from distributed_deep_q_tpu_torch.solver import sample_key_schedule

FRAME, STACK, N_STEP, GAMMA = (8, 8), 4, 3, 0.99
CAP, BATCH, CHAIN = 256, 32, 3


def _stream(replays, n_steps, episode_len=13, seed=0):
    """The reference tests' stream: random frames, actions and rewards,
    episode ends every ``episode_len`` steps and a truncation-only boundary
    every 29."""
    rng = np.random.default_rng(seed)
    t = 0
    for _ in range(n_steps):
        frame = rng.integers(0, 255, FRAME, dtype=np.uint8)
        a, r = int(rng.integers(0, 4)), float(rng.standard_normal())
        t += 1
        done = t % episode_len == 0
        trunc = (not done) and (t % 29 == 0)
        for rep in replays:
            rep.add(frame, a, r, done, boundary=done or trunc)
        if done or trunc:
            t = 0


def _replays(n_fill):
    kw = dict(capacity=CAP, batch_size=BATCH, n_step=N_STEP,
              prioritized=True, priority_alpha=0.0, device_per=True,
              write_chunk=16)
    mesh = make_mesh(MeshConfig(backend="cpu", num_fake_devices=8, dp=1))
    ref = ref_dp.DevicePERFrameReplay(RefReplayConfig(**kw), mesh, FRAME,
                                      stack=STACK, gamma=GAMMA, seed=0,
                                      write_chunk=16)
    port = dp.DevicePERFrameReplay(ReplayConfig(**kw), "cpu", FRAME,
                                   stack=STACK, gamma=GAMMA, write_chunk=16)
    _stream([ref, port], n_fill)
    ref.flush()
    port.flush()
    return ref, port


def _ref_draw(ref, keys, betas):
    """The reference's packed draw (prep + pack + draw) under a one-shard
    ``shard_map``."""
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
    return g(jnp.asarray(keys), d.action, d.reward, d.done, d.boundary,
             d.prio, jnp.asarray(cursors), jnp.asarray(sizes),
             jnp.asarray(betas))


@pytest.mark.parametrize("n_fill", [200, 300])   # partial fill, wrapped
def test_write_path_matches_reference_bitwise(n_fill):
    torch.set_num_threads(1)
    ref, port = _replays(n_fill)
    assert (port.rowb, port.slot_pad, port.shard_rows) == (
        ref.rowb, ref.slot_pad, ref.shard_rows)
    rowp = port.rowp
    ring_ref = np.asarray(ref.dstate.frames)
    ring = port.dstate["frames"].numpy()
    assert ring.shape == ring_ref.shape
    # the scratch row (the last) takes the padding lanes' racing writes
    np.testing.assert_array_equal(ring[:-rowp], ring_ref[:-rowp])
    for name in ("action", "reward", "done", "boundary", "prio", "maxp"):
        np.testing.assert_array_equal(
            port.dstate[name].numpy(), np.asarray(getattr(ref.dstate, name)),
            err_msg=name)
    for a, b in zip(port.device_inputs(), ref.device_inputs()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n_fill", [240, 254])
def test_small_flush_matches_reference_bitwise(n_fill):
    """The flush before a dispatch: 4 rows staged after a full flush, so 60
    main lanes and (clear of the sub-ring's first rows) all 64 ghost lanes
    are padding, skipped by the port's kernel; and at 254 the same 4 rows
    wrap the sub-ring (rows 254, 255, 0, 1, two of them with ghost
    mirrors). Ring bytes but the scratch row, the metadata and the
    priorities equal the reference's."""
    torch.set_num_threads(1)
    ref, port = _replays(n_fill)
    _stream([ref, port], 4, seed=1)
    assert port.pending_rows() == 4
    ref.flush()
    port.flush()
    rowp = port.rowp
    ring_ref = np.asarray(ref.dstate.frames)
    ring = port.dstate["frames"].numpy()
    np.testing.assert_array_equal(ring[:-rowp], ring_ref[:-rowp])
    for name in ("action", "reward", "done", "boundary", "prio", "maxp"):
        np.testing.assert_array_equal(
            port.dstate[name].numpy(), np.asarray(getattr(ref.dstate, name)),
            err_msg=name)
    for a, b in zip(port.device_inputs(), ref.device_inputs()):
        np.testing.assert_array_equal(a, b)
    # the rows just flushed are there, mirrors included when they wrapped
    rows = ring.reshape(-1, rowp)
    first = n_fill % port.slot_cap
    assert rows[first].any()
    if n_fill + 4 > port.slot_cap:
        np.testing.assert_array_equal(rows[port.slot_cap], rows[0])


@pytest.mark.parametrize("n_fill", [200, 300])
def test_mask_and_meta_pack_match_reference(n_fill):
    torch.set_num_threads(1)
    ref, port = _replays(n_fill)
    cursors, sizes = ref.device_inputs()
    d, st = ref.dstate, port.dstate
    mask_ref = np.asarray(ref_dp.valid_mask(
        d.done, d.boundary, jnp.asarray(cursors), jnp.asarray(sizes),
        ref.slot_cap, STACK, N_STEP))
    mask = dp.valid_mask(st["done"], st["boundary"],
                         torch.from_numpy(cursors), torch.from_numpy(sizes),
                         port.slot_cap, STACK, N_STEP).numpy()
    np.testing.assert_array_equal(mask, mask_ref)
    assert 0 < mask.sum() < CAP
    pack_ref = np.asarray(ref_dp.build_meta_pack(
        d.action, d.reward, d.done, d.boundary, ref.slot_cap, STACK, N_STEP,
        GAMMA))
    pack = dp.build_meta_pack(st["action"], st["reward"], st["done"],
                              st["boundary"], port.slot_cap, STACK, N_STEP,
                              GAMMA).numpy()
    np.testing.assert_array_equal(pack[:, 0], pack_ref[:, 0])
    np.testing.assert_array_equal(pack[:, 2:], pack_ref[:, 2:])
    np.testing.assert_allclose(pack[:, 1], pack_ref[:, 1], rtol=0, atol=1e-6)


def test_sample_stage_matches_reference_from_its_uniforms():
    """The port's sample stage fed the reference's own uniforms
    (``jax.random.uniform`` on the ``sample_key_schedule`` keys) draws the
    reference's rows bit for bit."""
    torch.set_num_threads(1)
    ref, port = _replays(300)
    keys = sample_key_schedule(seed=0, start_step=0, num_shards=1,
                               chain=CHAIN)[0]
    betas = np.asarray([0.4, 0.5, 0.6], np.float32)
    u_ref = np.stack([np.asarray(jax.random.uniform(jnp.asarray(k), (BATCH,)))
                      for k in keys])
    meta_r, ws_r, idx_r = jax.tree.map(np.asarray,
                                       _ref_draw(ref, keys, betas))
    win_r = np.asarray(ref_gather_windows(
        jnp.asarray(ws_r.reshape(-1)), ref.dstate.frames, n=CHAIN * BATCH,
        w=STACK + N_STEP, rowb=ref.rowb, interpret=True))

    cursors, sizes = port.device_inputs()
    spec = (port.slot_cap, port.slot_pad, port.rowb, port._row_len, STACK,
            N_STEP, GAMMA, FRAME, BATCH, 0.0, 1e-6, 1)
    meta, win, idx, ws = fused_sample(
        port.dstate, torch.from_numpy(cursors), torch.from_numpy(sizes),
        torch.from_numpy(betas), torch.from_numpy(u_ref), spec)
    np.testing.assert_array_equal(idx.numpy(), idx_r)
    np.testing.assert_array_equal(ws.numpy(), ws_r)
    np.testing.assert_array_equal(win.numpy(), win_r)
    for name in ("action", "discount", "ovalid", "nvalid", "weight"):
        np.testing.assert_array_equal(meta[name].numpy(), meta_r[name],
                                      err_msg=name)
    np.testing.assert_allclose(meta["reward"].numpy(), meta_r["reward"],
                               rtol=0, atol=1e-6)
    # α = 0: every sampleable row is equally likely and the weights are 1
    np.testing.assert_array_equal(meta["weight"].numpy(), 1.0)
    # the windows' first `stack` rows, as the reference's NHWC CNN input
    rows = win.view(torch.uint8).view(CHAIN * BATCH, STACK + N_STEP,
                                      port.rowb)[:, :STACK, :64]
    np.testing.assert_array_equal(
        dp.stack_rows_to_obs(rows, FRAME).numpy(),
        np.asarray(ref_dp.stack_rows_to_obs(jnp.asarray(rows.numpy()),
                                            FRAME)))


def test_uniforms_for_keys_chain_matches_single_draws():
    """A chain of keys draws row by row what separate single-key calls
    draw, so a chain=k chunk samples what k single-step dispatches do."""
    keys = sample_key_schedule(7, 100, 1, 4)[0]
    chained = dp.uniforms_for_keys(keys, 64, torch.device("cpu"))
    for i in range(4):
        single = dp.uniforms_for_keys(keys[i:i + 1], 64, torch.device("cpu"))
        torch.testing.assert_close(chained[i], single[0], rtol=0, atol=0)
    assert float(chained.min()) >= 0.0 and float(chained.max()) < 1.0


def test_scatter_priorities_drops_zero_mass_lanes():
    """Indices at the capacity (a zero-mass draw) write nothing; real ones
    write (|TD|+ε)^α and raise the running max."""
    prio = torch.full((8,), 0.5)
    maxp = torch.tensor(1.0)
    td = torch.tensor([2.0, 3.0])
    out = dp.scatter_priorities(prio, maxp, torch.tensor([8, 8]), td, 0.5,
                                1e-6)
    torch.testing.assert_close(prio, torch.full((8,), 0.5), rtol=0, atol=0)
    assert float(out) == pytest.approx(3.0 + 1e-6)
    dp.scatter_priorities(prio, maxp, torch.tensor([1, 5]), td, 0.5, 1e-6)
    assert float(prio[1]) == pytest.approx((2.0 + 1e-6) ** 0.5)
    assert float(prio[5]) == pytest.approx((3.0 + 1e-6) ** 0.5)
