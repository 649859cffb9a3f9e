"""Anakin mode (``parallel/anakin.py``): the mode-not-a-fork pins, at the
reference test's configuration (``tests/test_anakin.py``: 16 envs on
10×10×2 signal frames, MLP 32×32, batch 16, chain 2, 8 ticks, capacity
256), on one shard.

1. The superstep equals its host-driven twin BITWISE: the batched
   ``act_tick`` driven one tick at a time from the host over all envs
   (actions depend on the batch they are computed in, so the twin keeps
   the superstep's batch), the rows through the public
   ``add_batch(stream=g)``, and the fused chain
   (``train_steps_device_per``). Every real and ghost ring row, action,
   reward, done, boundary, priority and ``maxp``, θ and θ⁻ — over three
   supersteps that wrap every sub-ring.
2. The port's runner against the reference's ``AnakinRunner`` on one
   shard, from the same weights, the port drawing the reference's
   uniforms: the frame plane and the done/boundary rows bitwise (the
   signal env's frames do not depend on the actions), every action equal
   unless the row's top two Q-values lie within twice its Q error (the
   margin rule of ``tests/test_torch_policy.py``; Q within 1e-5 here), and
   θ within 1e-5.
   With no uniforms injected, the first superstep of each samples the
   same rows bitwise.
3. ``train.learn_metrics`` off is bitwise the gate on; it trains
   (the twin of the reference's learning smoke); the construction
   refusals.
"""

import numpy as np
import pytest
import torch

import jax

from distributed_deep_q_tpu import config as ref_config

from distributed_deep_q_tpu_torch import config as port_config
from distributed_deep_q_tpu_torch import learning
from distributed_deep_q_tpu_torch.actors.supervisor import actor_epsilon
from distributed_deep_q_tpu_torch.ops import threefry
from distributed_deep_q_tpu_torch.ops.device_envs import make_device_env
from distributed_deep_q_tpu_torch.parallel import anakin as anakin_mod
from distributed_deep_q_tpu_torch.parallel.anakin import (
    AnakinRunner, act_tick, run_anakin)
from distributed_deep_q_tpu_torch.replay import device_per as dp_mod
from distributed_deep_q_tpu_torch.replay.device_per import (
    DevicePERFrameReplay)
from distributed_deep_q_tpu_torch.solver import Solver, sample_key_schedule

FRAME, STACK = (10, 10), 2


def _anakin_config(mod=port_config, n_envs=16, ticks=8, capacity=256,
                   learn=False):
    return mod.Config(
        env=mod.EnvConfig(id="signal", kind="signal_atari",
                          frame_shape=FRAME, stack=STACK),
        net=mod.NetConfig(kind="mlp", num_actions=4, hidden=(32, 32),
                          frame_shape=FRAME, stack=STACK),
        replay=mod.ReplayConfig(capacity=capacity, batch_size=16,
                                fused_chain=2, n_step=1, learn_start=0,
                                device_resident=True, write_chunk=32,
                                prioritized=True, device_per=True),
        train=mod.TrainConfig(optimizer="adam", seed=3, stack_forwards="on",
                              learn_metrics=learn),
        actors=mod.ActorConfig(anakin_envs=n_envs, anakin_ticks=ticks),
        mesh=mod.MeshConfig(backend="cpu", dp=1, num_fake_devices=1),
    )


def _host_twin(cfg, supersteps):
    """The superstep driven from the host: batched ``act_tick`` tick by
    tick, ``add_batch(stream=g)``, ``train_steps_device_per``. With D
    shards the env at position p = s·E + e is stream g = e·D + s."""
    n, ticks = cfg.actors.anakin_envs, cfg.actors.anakin_ticks
    solver = Solver(cfg, obs_dim=FRAME[0] * FRAME[1] * STACK)
    d = solver.num_shards
    replay = DevicePERFrameReplay(cfg.replay, solver.device, FRAME, STACK,
                                  cfg.train.gamma, seed=cfg.train.seed,
                                  write_chunk=cfg.replay.write_chunk,
                                  num_streams=n, num_shards=d)
    reset_fn, step_fn = make_device_env(cfg.env)
    base = threefry.prng_key(cfg.train.seed)
    e_per = n // d
    gids = [(p % e_per) * d + p // e_per for p in range(n)]
    g = torch.tensor(gids)
    st, frames = reset_fn(threefry.fold_in(base, 1000 * (g + 1)))
    buf = torch.zeros((n, STACK, FRAME[0] * FRAME[1]), dtype=torch.uint8)
    buf[:, -1] = frames.reshape(n, -1)
    akeys = threefry.fold_in(base, 7777 * (g + 1))
    eps = torch.tensor([actor_epsilon(i, n, cfg.actors.eps_base,
                                      cfg.actors.eps_alpha)
                        for i in gids], dtype=torch.float32)
    for _ in range(supersteps):
        recs = []
        for _t in range(ticks):
            st, buf, akeys, rec = act_tick(solver.state.net, step_fn, FRAME,
                                           eps, st, buf, akeys)
            recs.append({k: v.numpy().copy() for k, v in rec.items()})
        for s in range(n):
            done = np.array([r["done"][s] for r in recs], bool)
            replay.add_batch({
                "frame": np.stack([r["frame"][s].reshape(FRAME)
                                   for r in recs]),
                "action": np.array([r["action"][s] for r in recs], np.int64),
                "reward": np.array([r["reward"][s] for r in recs],
                                   np.float32),
                "done": done, "boundary": done}, stream=gids[s])
        solver.train_steps_device_per(replay, cfg.replay.fused_chain)
    return solver, replay


def _real_rows(replay, frames):
    return frames.view(-1, replay.rowp)[:replay.cap_local_pad]


def test_superstep_matches_batched_host_twin():
    torch.set_num_threads(1)
    cfg = _anakin_config()
    runner = AnakinRunner(cfg)
    assert runner.replay.slot_cap == 16       # the wrap depends on it
    assert runner.replay.dstate is None       # the runner owns the ring
    for _ in range(3):
        runner.superstep()
    runner.sync_solver()
    solver, replay = _host_twin(cfg, 3)
    a, h = runner.replay.dstate, replay.dstate
    # the scratch row takes the padding lanes (unspecified on both paths)
    assert torch.equal(_real_rows(replay, a["frames"]),
                       _real_rows(replay, h["frames"]))
    for field in ("action", "reward", "done", "boundary", "prio", "maxp"):
        assert torch.equal(a[field], h[field]), field
    assert int(runner.solver.state.step) == int(solver.state.step) == 6
    for x, y in ((runner.solver.state.net, solver.state.net),
                 (runner.solver.state.target_net, solver.state.target_net)):
        for (name, p), (_, q) in zip(x.named_parameters(),
                                     y.named_parameters()):
            assert torch.equal(p, q), name
    for key in ("mu", "nu"):
        for name, t in runner.solver.state.opt_state[key].items():
            assert torch.equal(t, solver.state.opt_state[key][name]), name


def _ref_uniforms(keys, per_shard, device):
    u = np.stack([np.asarray(jax.random.uniform(jax.numpy.asarray(k),
                                                (per_shard,)))
                  for k in keys])
    return torch.from_numpy(u).to(device)


def test_runner_matches_reference_runner(monkeypatch):
    from distributed_deep_q_tpu.parallel.anakin import (
        AnakinRunner as RefRunner)
    from distributed_deep_q_tpu.parallel.learner import _locate_adam_state

    torch.set_num_threads(1)
    ref = RefRunner(_anakin_config(ref_config))
    runner = AnakinRunner(_anakin_config())
    st = jax.tree.map(np.asarray, ref.solver.state)
    adam, _ = _locate_adam_state(st.opt_state)
    runner.solver.load_flax_state(st.params, st.target_params, adam.count,
                                  adam.mu, adam.nu, st.step)
    runner.solver.draw_uniforms = _ref_uniforms
    qs = []   # each tick's acting Q [n, A], for the margin rule

    def recording_tick(net, step_fn, frame_shape, eps, env_state, buf,
                       akeys):
        with torch.no_grad():
            qs.append(net.forward_nchw(buf.view(buf.shape[0], STACK,
                                                *FRAME)).numpy())
        return act_tick(net, step_fn, frame_shape, eps, env_state, buf,
                        akeys)

    monkeypatch.setattr(anakin_mod, "act_tick", recording_tick)
    for _ in range(3):
        ref.superstep()
        runner.superstep()
    ref.sync_solver()
    runner.sync_solver()
    ds_r, ds_p = ref.dstate, runner.replay.dstate
    rp = runner.replay
    shape = (1, rp.shard_rows, rp.rowp)
    np.testing.assert_array_equal(
        np.asarray(ds_r.frames).reshape(shape)[0, :rp.cap_local_pad],
        _real_rows(rp, ds_p["frames"]).numpy())
    for field in ("done", "boundary"):
        np.testing.assert_array_equal(np.asarray(getattr(ds_r, field)),
                                      ds_p[field].numpy(), err_msg=field)
    # ticks 8..23 are in the ring (slot_cap 16): row e·16 + (τ mod 16)
    for row in np.flatnonzero(np.asarray(ds_r.action)
                              != ds_p["action"].numpy()):
        e, local = divmod(int(row), rp.slot_cap)
        tau = local if local >= 8 else local + 16
        top2 = np.sort(qs[tau][e])[-2:]
        assert top2[1] - top2[0] < 2e-5, (row, qs[tau][e])
    got = runner.solver.flax_state()
    for name, want in (("params", ref.solver.state.params),
                       ("target_params", ref.solver.state.target_params)):
        for path, leaf in jax.tree_util.tree_leaves_with_path(want):
            g = got[name]
            for p in path:
                g = g[p.key]
            np.testing.assert_allclose(g, np.asarray(leaf), rtol=0,
                                       atol=1e-5, err_msg=name)
    assert got["step"] == int(ref.solver.state.step) == 6


def _recording_ref_sample_stage(monkeypatch, record):
    """Record, per superstep and shard, what the reference superstep's
    sample stage drew (indices, IS weights) and gathered (B1 windows):
    host callbacks traced into its program."""
    from jax import lax

    from distributed_deep_q_tpu.parallel import anakin as ref_anakin

    draw, gather = (ref_anakin.fused_sample_draw_packed,
                    ref_anakin.gather_windows)

    def put(kind, **arrays):
        record.setdefault(kind, []).append(
            {k: np.asarray(a) for k, a in arrays.items()})

    def recording_draw(keys, *args, **kw):
        meta, ws, idx = draw(keys, *args, **kw)
        jax.debug.callback(
            lambda s, k, i, w, ws: put("draw", shard=s, keys=k, idx=i,
                                       weight=w, ws=ws),
            lax.axis_index("dp"), keys, idx, meta["weight"], ws)
        return meta, ws, idx

    def recording_gather(ws, *args, **kw):
        win = gather(ws, *args, **kw)
        jax.debug.callback(lambda w0, w: put("win", ws=w0, win=w), ws, win)
        return win

    monkeypatch.setattr(ref_anakin, "fused_sample_draw_packed",
                        recording_draw)
    monkeypatch.setattr(ref_anakin, "gather_windows", recording_gather)


def test_superstep_draws_the_references_rows(monkeypatch):
    """No uniforms injected: the first superstep of each package, from the
    same weights, samples the same rows (``ops/threefry.py`` draws
    ``jax.random.uniform``'s own numbers from the shared key schedule).
    Indices, IS weights and the B1 windows: bitwise. (The first
    superstep's priorities are all ``maxp^α`` = 1; later ones follow each
    package's |TD|, which agree within tolerance, not bitwise.)"""
    from distributed_deep_q_tpu.parallel.anakin import (
        AnakinRunner as RefRunner)
    from distributed_deep_q_tpu.parallel.learner import _locate_adam_state

    torch.set_num_threads(1)
    record: dict = {}
    _recording_ref_sample_stage(monkeypatch, record)
    ref = RefRunner(_anakin_config(ref_config))
    runner = AnakinRunner(_anakin_config())
    assert runner.solver.draw_uniforms is dp_mod.uniforms_for_keys
    st = jax.tree.map(np.asarray, ref.solver.state)
    adam, _ = _locate_adam_state(st.opt_state)
    runner.solver.load_flax_state(st.params, st.target_params, adam.count,
                                  adam.mu, adam.nu, st.step)
    drawn, fused_sample = [], anakin_mod.fused_sample

    def recording_sample(*args):
        out = fused_sample(*args)
        drawn.append(out)
        return out

    monkeypatch.setattr(anakin_mod, "fused_sample", recording_sample)
    ref.superstep()
    runner.superstep()
    jax.effects_barrier()
    meta, win, idx, _ = drawn[0]
    (r,), (rw,) = record["draw"], record["win"]
    np.testing.assert_array_equal(idx.numpy(), r["idx"])
    np.testing.assert_array_equal(meta["weight"].numpy(), r["weight"])
    np.testing.assert_array_equal(win.numpy(), rw["win"].reshape(-1))


def _shard_rows(replay, frames):
    """Every shard's real and ghost rows (its scratch row left out)."""
    return frames.reshape(replay.num_shards, replay.shard_rows,
                          replay.rowp)[:, :replay.cap_local_pad]


def test_superstep_matches_batched_host_twin_at_dp2():
    """Two shards of 8 envs each: the superstep against its host-driven
    twin, bitwise as at one shard — every real and ghost row, the
    metadata, priorities, maxp, θ, θ⁻ and Adam."""
    torch.set_num_threads(1)
    cfg = _anakin_config()
    cfg.mesh.dp = 2
    runner = AnakinRunner(cfg)
    assert (runner.num_shards, runner.envs_per_shard) == (2, 8)
    for _ in range(3):
        runner.superstep()
    runner.sync_solver()
    solver, replay = _host_twin(cfg, 3)
    a, h = runner.replay.dstate, replay.dstate
    assert torch.equal(_shard_rows(replay, a["frames"]),
                       _shard_rows(replay, h["frames"]))
    for field in ("action", "reward", "done", "boundary", "prio", "maxp"):
        assert torch.equal(a[field], h[field]), field
    assert int(runner.solver.state.step) == int(solver.state.step) == 6
    for x, y in ((runner.solver.state.net, solver.state.net),
                 (runner.solver.state.target_net, solver.state.target_net)):
        for (name, p), (_, q) in zip(x.named_parameters(),
                                     y.named_parameters()):
            assert torch.equal(p, q), name
    for key in ("mu", "nu"):
        for name, t in runner.solver.state.opt_state[key].items():
            assert torch.equal(t, solver.state.opt_state[key][name]), name


def test_runner_matches_reference_runner_at_dp2(monkeypatch):
    """The reference's runner on its dp=2 mesh against the port's at
    D = 2, from the same weights, no uniforms injected: the first
    superstep's draws per shard (indices, IS weights, B1 windows)
    bitwise; after three supersteps the frame plane and done/boundary
    rows bitwise, every action equal unless the row's top two Q-values
    lie within 2e-5, θ within 1e-5 (as at one shard)."""
    from distributed_deep_q_tpu.parallel.anakin import (
        AnakinRunner as RefRunner)
    from distributed_deep_q_tpu.parallel.learner import _locate_adam_state

    torch.set_num_threads(1)
    record: dict = {}
    _recording_ref_sample_stage(monkeypatch, record)
    rcfg, pcfg = _anakin_config(ref_config), _anakin_config()
    rcfg.mesh.dp = pcfg.mesh.dp = 2
    ref = RefRunner(rcfg)
    runner = AnakinRunner(pcfg)
    st = jax.tree.map(np.asarray, ref.solver.state)
    adam, _ = _locate_adam_state(st.opt_state)
    runner.solver.load_flax_state(st.params, st.target_params, adam.count,
                                  adam.mu, adam.nu, st.step)
    qs, drawn = [], []
    fused_sample = anakin_mod.fused_sample

    def recording_tick(net, step_fn, frame_shape, eps, env_state, buf,
                       akeys):
        with torch.no_grad():
            qs.append(net.forward_nchw(buf.view(buf.shape[0], STACK,
                                                *FRAME)).numpy())
        return act_tick(net, step_fn, frame_shape, eps, env_state, buf,
                        akeys)

    def recording_sample(*args):
        out = fused_sample(*args)
        drawn.append(out)
        return out

    monkeypatch.setattr(anakin_mod, "act_tick", recording_tick)
    monkeypatch.setattr(anakin_mod, "fused_sample", recording_sample)
    for _ in range(3):
        ref.superstep()
        runner.superstep()
    ref.sync_solver()
    runner.sync_solver()
    jax.effects_barrier()
    rp = runner.replay
    per = 8
    meta, win, idx, _ = drawn[0]
    # the first superstep's draws: shard s's are the ones from its keys
    keys = sample_key_schedule(pcfg.train.seed, 0, 2, runner.chain)
    for s in range(2):
        r, = [r for r in record["draw"] if int(r["shard"]) == s
              and np.array_equal(r["keys"], keys[s])]
        rw, = [rw for rw in record["win"]
               if np.array_equal(rw["ws"], r["ws"].reshape(-1))]
        part = slice(s * per, (s + 1) * per)
        want = np.where(r["idx"] == rp.cap_local, rp.capacity,
                        s * rp.cap_local + r["idx"])
        np.testing.assert_array_equal(idx.numpy()[:, part], want)
        np.testing.assert_array_equal(meta["weight"].numpy()[:, part],
                                      r["weight"])
        np.testing.assert_array_equal(
            win.view(2, 16, -1).numpy()[:, part].reshape(-1),
            rw["win"].reshape(-1))
    ds_r, ds_p = ref.dstate, rp.dstate
    np.testing.assert_array_equal(
        _shard_rows(rp, np.asarray(ds_r.frames)),
        _shard_rows(rp, ds_p["frames"]).numpy())
    for field in ("done", "boundary"):
        np.testing.assert_array_equal(np.asarray(getattr(ds_r, field)),
                                      ds_p[field].numpy(), err_msg=field)
    # ticks 8..23 are in the ring (slot_cap 16): shard s's row
    # e·16 + (τ mod 16) is env s·8 + e's
    for row in np.flatnonzero(np.asarray(ds_r.action)
                              != ds_p["action"].numpy()):
        s, rem = divmod(int(row), rp.cap_local)
        e, local = divmod(rem, rp.slot_cap)
        tau = local if local >= 8 else local + 16
        top2 = np.sort(qs[tau][s * 8 + e])[-2:]
        assert top2[1] - top2[0] < 2e-5, (row, qs[tau][s * 8 + e])
    got = runner.solver.flax_state()
    for name, want in (("params", ref.solver.state.params),
                       ("target_params", ref.solver.state.target_params)):
        for path, leaf in jax.tree_util.tree_leaves_with_path(want):
            g = got[name]
            for p in path:
                g = g[p.key]
            np.testing.assert_allclose(g, np.asarray(leaf), rtol=0,
                                       atol=1e-5, err_msg=name)
    assert got["step"] == int(ref.solver.state.step) == 6


def test_gate_off_is_bitwise_gate_on():
    torch.set_num_threads(1)
    on = AnakinRunner(_anakin_config(learn=True))
    off = AnakinRunner(_anakin_config(learn=False))
    for _ in range(2):
        m_on, m_off = on.superstep(), off.superstep()
    assert "learn_plane" not in m_off
    p = m_on.pop("learn_plane").numpy()
    assert p[learning.I_STEPS] == on.chain
    assert p[learning.I_SAMPLES] == on.chain * 16
    assert p[:learning.N_HIST].sum() == p[learning.I_SAMPLES]
    for k in m_off:
        assert torch.equal(m_on[k], m_off[k]), k
    for field in ("frames", "action", "reward", "prio", "maxp"):
        assert torch.equal(getattr(on.ring, field), getattr(off.ring, field))
    for (name, a), (_, b) in zip(on.solver.state.net.named_parameters(),
                                 off.solver.state.net.named_parameters()):
        assert torch.equal(a, b), name


def test_anakin_trains_signal_end_to_end():
    """Twin of the reference's learning smoke: reward above chance on
    signal_atari, finite losses, and a solver state the rest of the
    system can use (through the entry point, ``run_anakin``)."""
    torch.set_num_threads(1)
    cfg = _anakin_config(capacity=2048)
    cfg.train.lr = 3e-3
    out = run_anakin(cfg, 40)
    runner = out["runner"]
    assert all(np.isfinite(out[k]).all() for k in ("loss", "q_mean",
                                                   "grad_norm"))
    assert out["loss"].shape == (runner.chain,)
    # signal_atari pays 1 for reading the current frame: chance is 1/4
    assert out["act_reward"] > 0.30, out["act_reward"]
    assert runner.env_steps == 40 * 8 * 16
    assert runner.grad_steps == 40 * runner.chain
    assert int(runner.solver.state.step) == runner.grad_steps
    assert runner.replay.dstate is not None   # handed back
    q = runner.solver.q_values(np.zeros((2,) + FRAME + (STACK,), np.uint8))
    assert q.shape == (2, 4) and np.isfinite(q).all()


@pytest.mark.parametrize("change, error, match", [
    ({"env": "fake_atari"}, ValueError, "no JAX port"),
    ({"ticks": 17}, AssertionError, "within one sub-ring"),
    ({"optimizer": "rmsprop"}, AssertionError, "requires adam"),
    ({"dp": 2}, None, None),
    ({"dp": 2, "envs": 15}, AssertionError, "divide over 2 dp shards"),
])
def test_anakin_rejects_unsupported_shapes(change, error, match):
    """The mode is explicit and guarded: what the superstep cannot run
    fails at construction, the reference's dividing-envs case included.
    Two shards (``mesh.dp=2``), refused until the port had them (ROADMAP
    A14a), run: one superstep over both shards' 8 envs each."""
    cfg = _anakin_config(n_envs=change.get("envs", 16),
                         ticks=change.get("ticks", 8))
    if "env" in change:
        cfg.env = port_config.EnvConfig(id="fake", kind=change["env"],
                                        frame_shape=FRAME, stack=STACK)
    if "optimizer" in change:
        cfg.train.optimizer = change["optimizer"]
    if "dp" in change:
        cfg.mesh.dp = change["dp"]
    if error is None:
        torch.set_num_threads(1)
        runner = AnakinRunner(cfg)
        assert runner.num_shards == 2 and runner.envs_per_shard == 8
        m = runner.superstep()
        assert np.isfinite(m["loss"].numpy()).all()
        return
    with pytest.raises(error, match=match):
        AnakinRunner(cfg)


def test_slice_modules_import_with_jax_blocked():
    """``learning``, ``ops/threefry``, ``ops/device_envs`` and
    ``parallel/anakin`` import in a process where jax and the reference
    package cannot be imported."""
    import subprocess
    import sys
    from pathlib import Path

    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'flax', 'optax',\n"
            "          'distributed_deep_q_tpu'):\n"
            "    sys.modules[m] = None\n"
            "import distributed_deep_q_tpu_torch.learning\n"
            "import distributed_deep_q_tpu_torch.ops.threefry\n"
            "import distributed_deep_q_tpu_torch.ops.device_envs\n"
            "import distributed_deep_q_tpu_torch.parallel.anakin\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=Path(__file__).resolve().parents[1])
