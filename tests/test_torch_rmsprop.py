"""Port vs reference: ``train.optimizer=rmsprop`` — optax's centered
RMSProp (``decay=0.95, eps=1e-2``) behind the reference's ``clip_grads``,
applied as its ``_step_core``'s non-Adam branch applies it (the clip, the
chain's own ``clip_by_global_norm`` again when the clip is on, the moments,
the update, then ``refresh_target``).

- The optimizer alone (``rmsprop_target_step``) against the reference's
  functions on the same gradients, ten steps: θ, θ⁻, ``mu`` and ``nu``
  within 1e-6 relative, with 1e-6 of the leaf's largest magnitude as the
  absolute floor (XLA contracts multiply-adds into FMAs and its ``rsqrt``
  and global norms round their own way, so a few elements differ in their
  last bits; most are bitwise).
- The four learners — host batch, ring, fused chain, R2D2 sequence —
  against the reference's, one step and then ten, from the same weights
  and batches, with the clip on and off and τ on and off. The gradients
  themselves differ between the packages by float rounding (sums in other
  orders), and the moments carry them. θ and θ⁻ within 1e-6 relative plus
  1e-4·lr per step taken (one step moves an element by at most ≈4.5·lr,
  so that is 2e-5 of a step); ``mu`` and ``nu`` within 1e-4 relative plus
  1e-5 of the leaf's largest magnitude (an element whose gradient sums
  nearly cancel moves further, relative to itself, than the leaf does).
- ``convert.py`` both ways against optax's own tree, with the clip and
  without; a checkpoint round trip under RMSProp, and the refusal to
  restore it into an Adam state (or the reverse).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from distributed_deep_q_tpu import config as ref_config
from distributed_deep_q_tpu.parallel import learner as ref_learner
from distributed_deep_q_tpu.replay import device_per as ref_dp
from distributed_deep_q_tpu.replay import device_ring as ref_ring
from distributed_deep_q_tpu.replay import replay_memory as ref_mem
from distributed_deep_q_tpu.solver import Solver as RefSolver

from distributed_deep_q_tpu_torch import config as port_config
from distributed_deep_q_tpu_torch import convert
from distributed_deep_q_tpu_torch.parallel.learner import (
    global_norm, init_opt_state, rmsprop_target_step)
from distributed_deep_q_tpu_torch.replay.device_per import (
    DevicePERFrameReplay)
from distributed_deep_q_tpu_torch.replay.device_ring import DeviceFrameReplay
from distributed_deep_q_tpu_torch.solver import Solver
from distributed_deep_q_tpu_torch.utils.checkpoint import Checkpointer

CLIP_TAU = [(10.0, 0.0), (0.0, 0.0), (0.5, 0.01), (0.0, 0.01)]
FRAME, STACK, BATCH = (10, 10), 2, 16


def _train_cfg(mod, clip, tau, lr=1e-3):
    return mod.TrainConfig(optimizer="rmsprop", lr=lr, grad_clip_norm=clip,
                           target_tau=tau, target_update_period=3,
                           double_dqn=True, seed=0)


@pytest.mark.parametrize("clip, tau", CLIP_TAU)
def test_rmsprop_step_matches_reference_optimizer(clip, tau):
    rng = np.random.default_rng(0)
    shapes = {"a.weight": (7, 5), "a.bias": (7,), "b.weight": (3, 7)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    rcfg, pcfg = _train_cfg(ref_config, clip, tau), _train_cfg(
        port_config, clip, tau)
    opt = ref_learner.make_optimizer(rcfg)
    rp = {k: jnp.asarray(v) for k, v in params.items()}
    rt, rs = dict(rp), opt.init(rp)
    pp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    pt = {k: v.detach().clone() for k, v in pp.items()}
    state = {"name": "rmsprop",
             "mu": {k: torch.zeros_like(v) for k, v in pp.items()},
             "nu": {k: torch.zeros_like(v) for k, v in pp.items()}}
    for i in range(10):
        g = {k: (rng.standard_normal(s) * (0.1 + i)).astype(np.float32)
             for k, s in shapes.items()}
        rg = {k: jnp.asarray(v) for k, v in g.items()}
        gnorm = optax.global_norm(rg)
        rg, _ = ref_learner.clip_grads(rcfg, rg, gnorm)
        upd, rs = opt.update(rg, rs, rp)
        rp = optax.apply_updates(rp, upd)
        rt = ref_learner.refresh_target(rcfg, rp, rt, jnp.int32(i + 1))
        tg = {k: torch.from_numpy(v) for k, v in g.items()}
        rmsprop_target_step(pcfg, tg, state, pp, pt, global_norm(tg),
                            torch.tensor(i + 1, dtype=torch.int32))
    inner = rs[1][0] if clip > 0 else rs[0]
    for k in shapes:
        for got, want in ((pp[k].detach(), rp[k]), (pt[k], rt[k]),
                          (state["mu"][k], inner.mu[k]),
                          (state["nu"][k], inner.nu[k])):
            want = np.asarray(want)
            np.testing.assert_allclose(
                got.numpy(), want, rtol=1e-6,
                atol=1e-6 * float(np.abs(want).max()), err_msg=k)


# -- the learners -----------------------------------------------------------------

def _cfg(mod, path, clip, tau):
    cfg = mod.Config()
    cfg.mesh.backend = "cpu"
    cfg.mesh.dp = 1
    cfg.train = _train_cfg(mod, clip, tau)
    if path == "sequence":
        cfg.net = mod.NetConfig(kind="r2d2", torso="mlp", hidden=(24,),
                                num_actions=4, lstm_size=8,
                                frame_shape=FRAME, stack=STACK,
                                dueling=True, compute_dtype="float32")
        cfg.replay = mod.ReplayConfig(capacity=64, batch_size=4,
                                      sequence_length=6, burn_in=2)
        return cfg
    cfg.net = mod.NetConfig(kind="mlp", num_actions=4, hidden=(32, 32),
                            frame_shape=FRAME, stack=STACK,
                            dueling=path == "host")
    cfg.replay = mod.ReplayConfig(capacity=256, batch_size=BATCH, n_step=2,
                                  prioritized=path == "fused",
                                  device_per=path == "fused",
                                  priority_alpha=0.6, write_chunk=16,
                                  fused_chain=1)
    return cfg


def _load(port, ref):
    """The reference's θ, θ⁻ and RMSProp state into the port
    (``convert.opt_state_from_optax_leaves``)."""
    st = jax.tree.map(np.asarray, ref.state)
    port.load_flax_state(st.params, st.target_params, None, st.params,
                         st.params, st.step)
    named = {k: p.detach().numpy()
             for k, p in port.state.net.named_parameters()}
    port.load_opt_state(convert.opt_state_from_optax_leaves(
        jax.tree_util.tree_leaves(st.opt_state), "rmsprop", named,
        FRAME))


def _close(port, ref, steps):
    got = port.flax_state()
    st = jax.tree.map(np.asarray, ref.state)
    assert got["step"] == int(st.step) == steps
    assert got["optimizer"] == "rmsprop" and "count" not in got
    leaves = jax.tree_util.tree_leaves(st.opt_state)
    want_opt = convert.opt_state_from_optax_leaves(
        leaves, "rmsprop", {k: p.detach().numpy() for k, p in
                            port.state.net.named_parameters()}, FRAME)
    for name, got_t, want_t, rtol in (
            ("params", got["params"], st.params, 1e-6),
            ("target", got["target_params"], st.target_params, 1e-6)):
        for path, leaf in jax.tree_util.tree_leaves_with_path(want_t):
            g = got_t
            for p in path:
                g = g[p.key]
            np.testing.assert_allclose(
                g, leaf, rtol=rtol, atol=1e-4 * port.config.train.lr * steps,
                err_msg=f"{name}{jax.tree_util.keystr(path)}")
    for key in ("mu", "nu"):
        for name, t in port.state.opt_state[key].items():
            want = want_opt[key][name]
            np.testing.assert_allclose(
                t.numpy(), want, rtol=1e-4,
                atol=1e-5 * float(np.abs(want).max()), err_msg=f"{key} {name}")


def _mlp_stream(n, seed):
    rng = np.random.default_rng(seed)
    for i in range(n):
        yield (rng.integers(0, 255, FRAME, dtype=np.uint8),
               int(rng.integers(4)), float(rng.standard_normal()),
               i % 11 == 10)


def _ref_uniforms(keys, per_shard, device):
    u = np.stack([np.asarray(jax.random.uniform(jnp.asarray(k), (per_shard,)))
                  for k in keys])
    return torch.from_numpy(u).to(device)


def _sequence_batch(rng, b, t, lstm):
    return {
        "obs": rng.integers(0, 255, (b, t + 1) + FRAME + (STACK,),
                            dtype=np.uint8),
        "action": rng.integers(0, 4, (b, t)).astype(np.int32),
        "reward": rng.standard_normal((b, t)).astype(np.float32),
        "discount": np.full((b, t), 0.99, np.float32),
        "mask": (rng.uniform(size=(b, t)) < 0.9).astype(np.float32),
        "init_c": rng.standard_normal((b, lstm)).astype(np.float32) * 0.3,
        "init_h": rng.standard_normal((b, lstm)).astype(np.float32) * 0.3,
        "weight": rng.uniform(0.5, 1.0, b).astype(np.float32),
    }


@pytest.mark.parametrize("clip, tau", CLIP_TAU)
@pytest.mark.parametrize("path", ["host", "ring", "fused", "sequence"])
def test_learner_rmsprop_matches_reference(path, clip, tau):
    torch.set_num_threads(1)
    obs_dim = FRAME[0] * FRAME[1] * STACK
    rcfg, pcfg = _cfg(ref_config, path, clip, tau), _cfg(port_config, path,
                                                         clip, tau)
    if path == "sequence":
        from distributed_deep_q_tpu.parallel.sequence_learner import (
            SequenceSolver as RefSeq)
        from distributed_deep_q_tpu_torch.parallel.sequence_learner import (
            SequenceSolver)
        ref = RefSeq(rcfg, obs_dim=obs_dim)
        port = SequenceSolver(pcfg, obs_dim=obs_dim, backend="cpu")
    else:
        ref = RefSolver(rcfg, obs_dim=obs_dim)
        port = Solver(pcfg, obs_dim=obs_dim, backend="cpu")
    _load(port, ref)
    rng = np.random.default_rng(1)
    if path == "host":
        mem = ref_mem.ReplayMemory(256, (obs_dim,), np.float32, seed=0)
        for t in range(300):
            mem.add(rng.normal(size=obs_dim).astype(np.float32),
                    int(rng.integers(4)), float(rng.normal()),
                    rng.normal(size=obs_dim).astype(np.float32),
                    0.0 if t % 19 == 18 else 0.99 ** 2)
    elif path == "ring":
        ref_rep = ref_ring.DeviceFrameReplay(rcfg.replay, ref.mesh, FRAME,
                                             STACK, 0.99, seed=0,
                                             write_chunk=16)
        port_rep = DeviceFrameReplay(pcfg.replay, "cpu", FRAME, STACK, 0.99,
                                     seed=0, write_chunk=16)
    elif path == "fused":
        ref_rep = ref_dp.DevicePERFrameReplay(rcfg.replay, ref.mesh, FRAME,
                                              stack=STACK, gamma=0.99,
                                              write_chunk=16)
        port_rep = DevicePERFrameReplay(pcfg.replay, "cpu", FRAME,
                                        stack=STACK, gamma=0.99,
                                        write_chunk=16)
        port.draw_uniforms = _ref_uniforms
    if path in ("ring", "fused"):
        for f, a, r, d in _mlp_stream(300, seed=0):
            ref_rep.add(f, a, r, d)
            port_rep.add(f, a, r, d)
    for step in range(1, 11):
        if path == "host":
            batch = mem.sample(BATCH)
            batch.pop("_sampled_at", None)
            mr, mp = ref.train_step(dict(batch)), port.train_step(batch)
        elif path == "ring":
            batch = ref_rep.sample(BATCH)
            batch.pop("_sampled_at")
            port_rep.flush()
            mr = ref.train_step_from_ring(ref_rep.ring, batch, FRAME)
            mp = port.train_step_from_ring(port_rep.ring, batch, FRAME)
        elif path == "fused":
            mr = ref.train_step_device_per(ref_rep)
            mp = port.train_step_device_per(port_rep)
        else:
            batch = _sequence_batch(rng, 4, 6, 8)
            mr, mp = ref.train_step(dict(batch)), port.train_step(batch)
        np.testing.assert_allclose(float(mp["loss"]), float(mr["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(mp["grad_norm"]),
                                   float(mr["grad_norm"]), rtol=1e-5)
        if step in (1, 10):
            _close(port, ref, step)


# -- conversion and checkpoints -------------------------------------------------

@pytest.mark.parametrize("clip", [10.0, 0.0])
def test_convert_rmsprop_state_both_ways(clip):
    """``(EmptyState, (ScaleByRStdDevState(mu, nu), EmptyState,
    EmptyState))`` with the clip, its inner tuple without: the port's
    state goes to optax's own tree and comes back unchanged."""
    cfg = _cfg(ref_config, "ring", clip, 0.0)
    ref = RefSolver(cfg, obs_dim=FRAME[0] * FRAME[1] * STACK)
    tree = ref.state.opt_state
    inner = tree[1][0] if clip > 0 else tree[0]
    assert isinstance(inner, optax.ScaleByRStdDevState)
    rng = np.random.default_rng(2)
    noisy = jax.tree.map(
        lambda a: rng.standard_normal(np.shape(a)).astype(np.float32), tree)
    port = Solver(_cfg(port_config, "ring", clip, 0.0),
                  obs_dim=FRAME[0] * FRAME[1] * STACK, backend="cpu")
    named = {k: p.detach().numpy() for k, p in
             port.state.net.named_parameters()}
    opt = convert.opt_state_from_optax_leaves(
        jax.tree_util.tree_leaves(noisy), "rmsprop", named, FRAME)
    port.load_opt_state(opt)
    back = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(tree),
        convert.optax_opt_leaves(
            {"name": "rmsprop",
             "mu": {k: v.numpy() for k, v in port.state.opt_state["mu"]
                    .items()},
             "nu": {k: v.numpy() for k, v in port.state.opt_state["nu"]
                    .items()}}, FRAME))
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(noisy)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with pytest.raises(ValueError, match="leaves for a adam state"):
        convert.opt_state_from_optax_leaves(
            jax.tree_util.tree_leaves(noisy), "adam", named, FRAME)


def _trained(optimizer, steps=3):
    cfg = _cfg(port_config, "fused", 10.0, 0.0)
    cfg.train.optimizer = optimizer
    solver = Solver(cfg, obs_dim=FRAME[0] * FRAME[1] * STACK, backend="cpu")
    rep = DevicePERFrameReplay(cfg.replay, "cpu", FRAME, stack=STACK,
                               gamma=0.99, write_chunk=16)
    for f, a, r, d in _mlp_stream(200, seed=3):
        rep.add(f, a, r, d)
    for _ in range(steps):
        solver.train_step_device_per(rep)
    return solver


def test_checkpoint_round_trips_rmsprop_and_refuses_a_mismatch(tmp_path):
    a = _trained("rmsprop")
    ck = Checkpointer(str(tmp_path / "rms"))
    ck.save(a.state, wait=True)
    b = _trained("rmsprop", steps=0)
    ck.restore(b.state)
    assert int(b.state.step) == 3 and b.state.opt_state["name"] == "rmsprop"
    assert "count" not in b.state.opt_state
    for (n, pa), (_, pb) in zip(
            list(a.state.net.named_parameters())
            + list(a.state.target_net.named_parameters()),
            list(b.state.net.named_parameters())
            + list(b.state.target_net.named_parameters())):
        assert torch.equal(pa, pb), n
    for key in ("mu", "nu"):
        for n, t in a.state.opt_state[key].items():
            assert torch.equal(t, b.state.opt_state[key][n]), n
    adam = _trained("adam", steps=0)
    with pytest.raises(ValueError, match="rmsprop .*adam"):
        ck.restore(adam.state)
    ck2 = Checkpointer(str(tmp_path / "adam"))
    ck2.save(_trained("adam").state, wait=True)
    with pytest.raises(ValueError, match="adam .*rmsprop"):
        ck2.restore(_trained("rmsprop", steps=0).state)


def test_init_opt_state_is_optax_init():
    """A fresh RMSProp state is optax's: zero ``mu`` and ``nu`` (initial
    scale 0) of the params' dtypes, no count."""
    cfg = _train_cfg(port_config, 0.0, 0.0)
    net = torch.nn.Linear(3, 2)
    st = init_opt_state(cfg, net, torch.device("cpu"))
    assert st["name"] == "rmsprop" and set(st) == {"name", "mu", "nu"}
    for key in ("mu", "nu"):
        assert all(not t.any() and t.dtype == torch.float32
                   for t in st[key].values())


def test_rmsprop_trains_through_main_train_distributed():
    """``train.optimizer=rmsprop`` through ``main train --distributed``:
    two actor processes feed the fused path; the learner trains under
    RMSProp."""
    import signal

    from distributed_deep_q_tpu_torch.actors import supervisor as sup_mod
    from test_torch_distributed import PIXEL, _cfg, _check

    def expire(signum, frame):
        raise TimeoutError("the distributed run exceeded its 150 s deadline")

    prev = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, 150)
    try:
        torch.set_num_threads(2)
        cfg = _cfg("pong", PIXEL + ["train.optimizer=rmsprop"])
        summary = sup_mod.train_distributed(cfg, log_every=20)
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, prev)
    _check(summary, cfg)
    assert summary["solver"].state.opt_state["name"] == "rmsprop"
