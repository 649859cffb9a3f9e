"""Port vs reference: the device replays at D = 2 shards (``mesh.dp=2``).

The reference holds its replays on a two-device CPU mesh, one shard per
device, its Pallas ring kernels in interpret mode. The port holds the same
two shards as a leading shard axis on its one device (the CPU here, every
kernel through its plain version). The same rows go into both. Then,
bitwise:

- the padded frame plane (each shard's real and ghost rows; a shard's
  scratch row takes padding lanes, unspecified by contract), the metadata
  and priority rows and the per-shard cursors and sizes;
- each shard's validity mask, CDF and mass;
- a chain-2 fused dispatch's sample stage with no uniforms injected (the
  port draws ``jax.random.uniform``'s numbers itself): indices, window
  starts, B1 windows, metadata and IS weights. The weights are held
  bitwise where every live shard's mass is equal (each weight is then
  exactly 1 or 0); with unequal masses the two packages' float32 ``pow``
  round the same (n·p)^-β differently in the last bit now and then, so
  the weights are held within 2 ulp there;
- the dead shard (a twin of ``tests/test_device_per.py``'s zero-mass
  case): zero weights, out-of-range indices (the global capacity) whose
  priority scatter writes nothing;
- a window on a shard's last row, which must read that shard's ghost rows
  and never the next shard's first rows;
- the host-sampled ``DeviceFrameReplay`` at dp=2: its index batches and
  composed stacks, and the training loop on it (a twin of
  ``tests/test_device_ring.py``'s dp=2 run).
"""

import signal

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

from distributed_deep_q_tpu_torch.config import ReplayConfig
from distributed_deep_q_tpu_torch.ops.ring_gather import gather_windows
from distributed_deep_q_tpu_torch.parallel.learner import fused_sample
from distributed_deep_q_tpu_torch.replay import device_per as dp
from distributed_deep_q_tpu_torch.replay import device_ring as ring
from distributed_deep_q_tpu_torch.solver import sample_key_schedule

FRAME, STACK, N_STEP, GAMMA = (8, 8), 4, 3, 0.99
D, CAP, BATCH, CHAIN = 2, 256, 16, 2
PER = BATCH // D


@pytest.fixture(autouse=True)
def _deadline():
    """Each test gets 120 s; a hang fails it instead of the run."""
    def expire(*_):
        raise TimeoutError("test exceeded its 120 s deadline")
    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(120)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def _mesh():
    return make_mesh(MeshConfig(backend="cpu", num_fake_devices=8, dp=D))


def _per_pair(streams=2, alpha=0.0):
    kw = dict(capacity=CAP, batch_size=BATCH, n_step=N_STEP,
              prioritized=True, priority_alpha=alpha, device_per=True,
              write_chunk=16)
    ref = ref_dp.DevicePERFrameReplay(RefReplayConfig(**kw), _mesh(), FRAME,
                                      stack=STACK, gamma=GAMMA,
                                      write_chunk=16, num_streams=streams)
    port = dp.DevicePERFrameReplay(ReplayConfig(**kw), "cpu", FRAME,
                                   stack=STACK, gamma=GAMMA, write_chunk=16,
                                   num_streams=streams, num_shards=D)
    return ref, port


def _feed(replays, chunks, streams, seed=0, only_stream=None):
    """``chunks`` 20-row chunks, round-robin over the streams (or all to
    ``only_stream``); an episode ends every third chunk."""
    rng = np.random.default_rng(seed)
    for c in range(chunks):
        done = np.zeros(20, bool)
        done[-1] = c % 3 == 2
        batch = {"frame": rng.integers(0, 255, (20,) + FRAME, np.uint8),
                 "action": rng.integers(0, 4, 20).astype(np.int32),
                 "reward": rng.standard_normal(20).astype(np.float32),
                 "done": done}
        stream = c % streams if only_stream is None else only_stream
        for rep in replays:
            rep.add_batch(batch, stream=stream)
    for rep in replays:
        rep.flush()


def _real_rows(frames, port):
    """[D, shard_rows - 1, rowp]: every shard's plane but its scratch
    row."""
    return np.asarray(frames).reshape(D, port.shard_rows, port.rowp)[:, :-1]


def _ref_draw(ref, keys, betas):
    """The reference's sample stage (prep, pack, packed draw, B1) under its
    dp=2 ``shard_map``: per shard ``keys[s]``, B/D draws, the outputs
    assembled in mesh order as its learner's are."""
    stack, n_step = ref.stack, ref.n_step

    def f(keys, frames, action, reward, done, boundary, prio, cursors, sizes,
          betas):
        rows = dict(action=action, reward=reward, done=done,
                    boundary=boundary, prio=prio)
        pm, cdf, mass, n_glob = ref_dp.fused_sample_prep(
            rows, cursors, sizes, ref.slot_cap, stack, n_step)
        pack = ref_dp.build_meta_pack(action, reward, done, boundary,
                                      ref.slot_cap, stack, n_step, ref.gamma)
        meta, ws, idx = ref_dp.fused_sample_draw_packed(
            keys[0], pack, pm, cdf, mass, n_glob, PER, ref.slot_cap,
            ref.slot_pad, stack, n_step, betas, D)
        win = ref_gather_windows(ws.reshape(-1), frames, n=CHAIN * PER,
                                 w=stack + n_step, rowb=ref.rowb,
                                 interpret=True)
        return meta, ws, idx, win.reshape(CHAIN, PER, -1)

    S, SK, SK3 = P("dp"), P(None, "dp"), P(None, "dp", None)
    metas = {"action": SK, "reward": SK, "discount": SK, "weight": SK,
             "ovalid": SK3, "nvalid": SK3}
    g = jax.jit(shard_map(f, mesh=ref.mesh, in_specs=(S,) * 9 + (P(),),
                          out_specs=(metas, SK, SK, SK3), check_vma=False))
    d = ref.dstate
    cursors, sizes = ref.device_inputs()
    return jax.tree.map(np.asarray, g(
        jnp.asarray(keys), d.frames, d.action, d.reward, d.done, d.boundary,
        d.prio, jnp.asarray(cursors), jnp.asarray(sizes),
        jnp.asarray(betas)))


def _port_draw(port, keys, betas):
    spec = (port.slot_cap, port.slot_pad, port.rowb, port._row_len,
            port.stack, port.n_step, port.gamma, port.frame_shape, PER, 0.0,
            1e-6, D)
    cursors, sizes = port.device_inputs()
    u = dp.uniforms_for_keys(keys.reshape(-1, 2), PER, torch.device("cpu"))
    return fused_sample(port.dstate, torch.from_numpy(cursors),
                        torch.from_numpy(sizes), torch.from_numpy(betas), u,
                        spec)


def _to_global(port, idx_r, ws_r):
    """The reference's shard-local indices and window starts in the port's
    global coordinates (row r of the batch is shard r // (B/D)'s)."""
    shard = np.arange(BATCH) // PER
    idx = np.where(idx_r == port.cap_local, port.capacity,
                   shard * port.cap_local + idx_r)
    return idx, shard * port.shard_rows + ws_r


@pytest.mark.parametrize("chunks", [10, 17])   # partial fill, wrapped
def test_write_path_matches_reference_bitwise(chunks):
    torch.set_num_threads(1)
    ref, port = _per_pair()
    _feed([ref, port], chunks, streams=2)
    assert (port.shard_rows, port.cap_local, port.capacity) == (
        ref.shard_rows, ref.cap_local, ref.capacity)
    assert port.dstate["frames"].shape == ref.dstate.frames.shape
    np.testing.assert_array_equal(_real_rows(port.dstate["frames"], port),
                                  _real_rows(ref.dstate.frames, port))
    for name in ("action", "reward", "done", "boundary", "prio", "maxp"):
        np.testing.assert_array_equal(
            port.dstate[name].numpy(), np.asarray(getattr(ref.dstate, name)),
            err_msg=name)
    for a, b in zip(port.device_inputs(), ref.device_inputs()):
        np.testing.assert_array_equal(a, b)
    # both shards hold rows
    assert (port.device_inputs()[1] > 0).all()


def test_each_shards_mask_cdf_and_mass_match_reference():
    torch.set_num_threads(1)
    ref, port = _per_pair(streams=1, alpha=0.6)
    _feed([ref, port], 14, streams=1)

    def f(done, boundary, prio, cursors, sizes):
        rows = dict(done=done, boundary=boundary, prio=prio)
        pm, cdf, mass, n_glob = ref_dp.fused_sample_prep(
            rows, cursors, sizes, ref.slot_cap, STACK, N_STEP)
        return pm, cdf, mass[None], n_glob

    S = P("dp")
    g = jax.jit(shard_map(f, mesh=ref.mesh, in_specs=(S,) * 5,
                          out_specs=(S, S, S, P()), check_vma=False))
    d = ref.dstate
    cursors, sizes = ref.device_inputs()
    pm_r, cdf_r, mass_r, n_r = jax.tree.map(np.asarray, g(
        d.done, d.boundary, d.prio, jnp.asarray(cursors),
        jnp.asarray(sizes)))
    st = port.dstate
    c, s = port.device_inputs()
    pm, cdf, mass, n_glob = dp.fused_sample_prep(
        st, torch.from_numpy(c), torch.from_numpy(s), port.slot_cap, STACK,
        N_STEP, D)
    assert pm.shape == cdf.shape == (D, port.cap_local)
    np.testing.assert_array_equal(pm.numpy().reshape(-1), pm_r)
    np.testing.assert_array_equal(cdf.numpy().reshape(-1), cdf_r)
    np.testing.assert_array_equal(mass.numpy(), mass_r)
    assert float(n_glob) == float(n_r)
    # one stream cycling over both shards' slots: unequal masses
    assert mass[0] != mass[1] and (mass > 0).all()


@pytest.mark.parametrize("streams", [2, 1])
def test_chain2_dispatch_draws_match_reference(streams):
    """No uniforms injected on either side. Two streams fill the shards
    alike (equal masses); one stream fills them by episode, unequally."""
    torch.set_num_threads(1)
    ref, port = _per_pair(streams=streams)
    _feed([ref, port], 14, streams=streams)
    keys = sample_key_schedule(seed=0, start_step=5, num_shards=D,
                               chain=CHAIN)
    betas = np.asarray([0.4, 0.5], np.float32)
    meta_r, ws_r, idx_r, win_r = _ref_draw(ref, keys, betas)
    meta, win, idx, ws = _port_draw(port, keys, betas)
    want_idx, want_ws = _to_global(port, idx_r, ws_r)
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    np.testing.assert_array_equal(ws.numpy(), want_ws)
    np.testing.assert_array_equal(win.numpy(), win_r.reshape(-1))
    for name in ("action", "discount", "ovalid", "nvalid"):
        np.testing.assert_array_equal(meta[name].numpy(), meta_r[name],
                                      err_msg=name)
    np.testing.assert_allclose(meta["reward"].numpy(), meta_r["reward"],
                               rtol=0, atol=1e-6)
    w, w_r = meta["weight"].numpy(), meta_r["weight"]
    sizes = port.device_inputs()[1]
    if streams == 2:
        assert sizes[0] == sizes[1]
        np.testing.assert_array_equal(w, w_r)
    else:
        assert sizes[0] != sizes[1]
        np.testing.assert_array_max_ulp(w, w_r, maxulp=2)
        assert (w < 1).any()      # the weights are not all trivially 1
    # each half of the batch is its shard's draws
    assert (idx.numpy()[:, :PER] < port.cap_local).all()
    assert (idx.numpy()[:, PER:] >= port.cap_local).all()


def test_dead_shard_gets_zero_weights_and_writes_no_priority():
    """Twin of the reference's zero-mass shard case, on real rings: only
    shard 0 holds rows, so shard 1's lanes carry weight 0 and the global
    capacity as their index; the live shard's weights are normalized
    among themselves (the mask precedes the max) and the priority
    scatter writes only the live lanes."""
    torch.set_num_threads(1)
    ref, port = _per_pair(streams=2)
    _feed([ref, port], 8, streams=2, only_stream=0)
    assert list(port.device_inputs()[1]) == [port.slot_cap, 0]
    keys = sample_key_schedule(seed=1, start_step=0, num_shards=D,
                               chain=CHAIN)
    betas = np.asarray([0.4, 0.4], np.float32)
    meta_r, ws_r, idx_r, win_r = _ref_draw(ref, keys, betas)
    meta, win, idx, ws = _port_draw(port, keys, betas)
    want_idx, want_ws = _to_global(port, idx_r, ws_r)
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    np.testing.assert_array_equal(ws.numpy(), want_ws)
    np.testing.assert_array_equal(win.numpy(), win_r.reshape(-1))
    np.testing.assert_array_equal(meta["weight"].numpy(), meta_r["weight"])
    w = meta["weight"].numpy()
    assert (w[:, PER:] == 0).all() and (w[:, :PER] == 1).all()
    assert (idx.numpy()[:, PER:] == port.capacity).all()
    prio = port.dstate["prio"].clone()
    td = torch.full((BATCH,), 2.0)
    dp.scatter_priorities(prio, torch.tensor(1.0), idx[0], td, 0.6, 1e-6)
    assert torch.equal(prio[port.cap_local:],
                       port.dstate["prio"][port.cap_local:])
    assert not torch.equal(prio[:port.cap_local],
                           port.dstate["prio"][:port.cap_local])


def test_window_on_a_shards_last_row_stays_in_its_shard():
    """The window of shard 0's last real row runs into shard 0's ghost
    rows (the mirrors of its sub-ring's first rows), never into the
    scratch row or shard 1's first rows. Read through the port's B1 and
    the reference's, from the same start."""
    torch.set_num_threads(1)
    ref, port = _per_pair(streams=2)
    _feed([ref, port], 17, streams=2)           # every sub-ring wrapped
    w = STACK + N_STEP
    sub = port.subs_per_shard - 1
    local = port.slot_cap - 1
    start = sub * port.slot_pad + (local - (STACK - 1)) % port.slot_cap
    assert start + w > sub * port.slot_pad + port.slot_cap   # ghosts read
    got = gather_windows(torch.tensor([start], dtype=torch.int32),
                         port.dstate["frames"], n=1, w=w, rowb=port.rowb)
    want = np.asarray(ref_gather_windows(
        jnp.asarray([start], jnp.int32),
        jnp.asarray(np.asarray(ref.dstate.frames).reshape(
            D, -1)[0]), n=1, w=w, rowb=ref.rowb, interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)
    rows = got.view(w, port.rowp).numpy()
    plane = port.dstate["frames"].view(D, port.shard_rows, port.rowp).numpy()
    base = sub * port.slot_pad
    for j in range(w):
        real = (local - (STACK - 1) + j) % port.slot_cap
        np.testing.assert_array_equal(rows[j], plane[0, base + real])
    for other in (plane[0, -1], plane[1, 0]):
        assert not any(np.array_equal(r, other) for r in rows[STACK:])


def _ring_pair(prioritized):
    kw = dict(capacity=CAP, batch_size=BATCH, n_step=N_STEP,
              prioritized=prioritized, priority_alpha=0.6, write_chunk=16)
    ref = ref_ring.DeviceFrameReplay(RefReplayConfig(**kw), _mesh(), FRAME,
                                     STACK, GAMMA, seed=0, write_chunk=16,
                                     num_streams=2)
    port = ring.DeviceFrameReplay(ReplayConfig(**kw), "cpu", FRAME, STACK,
                                  GAMMA, seed=0, write_chunk=16,
                                  num_streams=2, num_shards=D)
    return ref, port


@pytest.mark.parametrize("prioritized", [False, True])
def test_host_sampled_ring_matches_reference(prioritized):
    """The Breakout preset's host-sampled path at dp=2: the ring bytes,
    three index batches (B/D per shard, shard-local stack indices, IS
    weights over both shards) with priority updates between them, and
    the stacks composed from them, against the reference's per-shard
    ``compose_stacks``."""
    torch.set_num_threads(1)
    ref, port = _ring_pair(prioritized)
    _feed([ref, port], 14, streams=2)
    np.testing.assert_array_equal(port.ring.numpy(), np.asarray(ref.ring))
    assert port.ready(100) and ref.ready(100)
    rng = np.random.default_rng(3)
    for _ in range(3):
        a, b = ref.sample(BATCH), port.sample(BATCH)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]),
                                          np.asarray(b[k]), err_msg=k)
        td = rng.uniform(0, 3, BATCH)
        ref.update_priorities(a["index"], td, a["_sampled_at"])
        port.update_priorities(b["index"], td, b["_sampled_at"])
    rows = ring.global_stack_rows(b, D, port.cap_local)
    got = ring.compose_stacks(port.ring, torch.from_numpy(rows["oidx"]),
                              torch.from_numpy(b["valid"]), FRAME)
    shards = np.asarray(ref.ring).reshape(D, port.cap_local, -1)
    for s in range(D):
        part = slice(s * PER, (s + 1) * PER)
        want = np.asarray(ref_ring.compose_stacks(
            jnp.asarray(shards[s]), jnp.asarray(a["oidx"][part]),
            jnp.asarray(a["valid"][part]), FRAME))
        np.testing.assert_array_equal(
            np.moveaxis(got.numpy()[part], 1, -1), want)


@pytest.mark.parametrize("prioritized", [False, True])
def test_host_sampled_ring_trains_at_dp2(prioritized):
    """Twin of ``tests/test_device_ring.py``'s dp=2 run: the Pong preset
    on the device ring (uniform and PER), two shards, finite losses."""
    from distributed_deep_q_tpu_torch.config import pong_config
    from distributed_deep_q_tpu_torch.train import train_single_process

    torch.set_num_threads(1)
    cfg = pong_config()
    cfg.mesh.backend = "cpu"
    cfg.mesh.dp = 2
    cfg.env.id, cfg.env.kind = "fake", "fake_atari"
    cfg.env.frame_shape = cfg.net.frame_shape = (36, 36)
    cfg.net.compute_dtype = "float32"
    cfg.replay = ReplayConfig(capacity=2048, batch_size=16, learn_start=200,
                              n_step=2, prioritized=prioritized,
                              write_chunk=16)
    cfg.train.total_steps = 400
    cfg.train.train_every = 8
    cfg.train.target_update_period = 10
    cfg.train.eval_episodes = 1
    summary = train_single_process(cfg, log_every=10)
    assert np.isfinite(summary["loss"])
    assert summary["replay"].num_shards == 2
    assert summary["solver"].step == pytest.approx(25, abs=1)
