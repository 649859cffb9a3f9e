"""Port vs reference: the fused device-PER train dispatch, the slice as a
whole.

The reference ``Solver`` (one-shard CPU mesh, ``stack_forwards="off"``)
and the port's ``Solver`` start from the same weights and Adam state
(``convert.py``), take the same transition stream (52×52 frames, so
conv3's output is 3×3 and the flatten order matters; a ring small enough
to wrap), and run two chained dispatches of 3 grad steps, more rows being
streamed in between. The port draws from the reference's own uniforms.

Pins and their reasons:

- ring bytes: bitwise;
- priorities: bitwise at α = 0 (every written priority is exactly 1). At
  α = 0.6 they follow |TD|, so within 1e-4 relative; positions sampled
  twice in one step are left out, because which lane's write wins is
  unspecified on both sides;
- loss and q_mean per step: rtol 1e-5 — float32 on both sides, sums in
  other orders (XLA vs oneDNN convolutions and reductions);
- θ, θ⁻, and Adam's ``mu``/``nu``: Adam's first steps move each parameter
  by ≈ sign(g)·lr, so an element whose gradient is near 0 lands 2·lr away
  when the two sides round g to opposite signs: θ and θ⁻ within 2·lr.
  ``mu`` (≈ a few g's) and ``nu`` (≈ g²) differ as the gradients do:
  within 1e-3 relative plus 1e-4 of the leaf's largest magnitude.
  (Measured on this input: |Δθ| ≤ 1.5e-8 = 1.5e-4·lr, and mu/nu within
  2.2e-6 of their leaves' largest magnitude — no sign flip occurs.)

Also: with no uniforms injected the port samples the reference's rows
bit for bit; the port's chain=3 dispatch equals three chain=1 dispatches
bitwise.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_deep_q_tpu import config as ref_config
from distributed_deep_q_tpu.parallel.learner import _locate_adam_state
from distributed_deep_q_tpu.replay.device_per import (
    DevicePERFrameReplay as RefReplay)
from distributed_deep_q_tpu.solver import Solver as RefSolver

from distributed_deep_q_tpu_torch import config as port_config
from distributed_deep_q_tpu_torch.parallel import learner as learner_mod
from distributed_deep_q_tpu_torch.replay import device_per as dp_mod
from distributed_deep_q_tpu_torch.replay.device_per import (
    DevicePERFrameReplay)
from distributed_deep_q_tpu_torch.solver import Solver

FRAME, LR, STEPS = (52, 52), 1e-4, 6


def _cfg(mod, alpha=0.0, pallas=False):
    cfg = mod.Config()
    cfg.mesh.backend = "cpu"
    cfg.mesh.dp = 1
    cfg.net = mod.NetConfig(kind="nature_cnn", num_actions=4,
                            frame_shape=FRAME, compute_dtype="float32")
    cfg.replay = mod.ReplayConfig(capacity=256, batch_size=16, n_step=2,
                                  prioritized=True, priority_alpha=alpha,
                                  device_per=True, write_chunk=16,
                                  fused_chain=3)
    cfg.train = mod.TrainConfig(lr=LR, double_dqn=True,
                                target_update_period=2, stack_forwards="off",
                                use_pallas_loss=pallas, seed=0)
    return cfg


def _stream(replays, n, seed):
    rng = np.random.default_rng(seed)
    for i in range(n):
        frame = rng.integers(0, 255, FRAME, dtype=np.uint8)
        a, r = int(rng.integers(4)), float(rng.standard_normal())
        done = i % 11 == 10
        for rep in replays:
            rep.add(frame, a, r, done)


def _ref_uniforms(keys, per_shard, device):
    u = np.stack([np.asarray(jax.random.uniform(jnp.asarray(k), (per_shard,)))
                  for k in keys])
    return torch.from_numpy(u).to(device)


def _port_from(ref_solver, alpha, pallas=False):
    cfg = _cfg(port_config, alpha, pallas)
    solver = Solver(cfg, backend="cpu")
    st = jax.tree.map(np.asarray, ref_solver.state)
    adam, _ = _locate_adam_state(st.opt_state)
    solver.load_flax_state(st.params, st.target_params, adam.count, adam.mu,
                           adam.nu, st.step)
    return solver


def _port_replay(cfg):
    return DevicePERFrameReplay(cfg.replay, "cpu", FRAME, stack=4,
                                gamma=0.99, write_chunk=16)


def _assert_tree_close(got, ref, name, rtol, atol_rel=0.0, atol=0.0):
    for path, leaf in jax.tree_util.tree_leaves_with_path(ref):
        g = got
        for p in path:
            g = g[p.key]
        tol = atol + atol_rel * float(np.abs(leaf).max())
        np.testing.assert_allclose(g, leaf, rtol=rtol, atol=tol,
                                   err_msg=f"{name}{jax.tree_util.keystr(path)}")


def _within_step_duplicates(idxs: list[torch.Tensor]) -> np.ndarray:
    """Rows drawn more than once within one grad step."""
    dup = []
    for chunk in idxs:
        for step in chunk.numpy():
            rows, counts = np.unique(step, return_counts=True)
            dup.extend(rows[counts > 1])
    return np.asarray(dup, np.int64)


@pytest.mark.parametrize("alpha", [0.0, 0.6])
def test_fused_dispatch_matches_reference(alpha, monkeypatch):
    _check_fused_dispatch(alpha, False, monkeypatch)


def test_fused_dispatch_with_fused_loss_matches_reference(monkeypatch):
    """``train.use_pallas_loss=true`` on the fused path: the reference's
    Pallas loss kernels (interpret mode) against the port's plain B3/B4,
    with the same pins."""
    _check_fused_dispatch(0.6, True, monkeypatch)


def _check_fused_dispatch(alpha, pallas, monkeypatch):
    torch.set_num_threads(1)
    ref = RefSolver(_cfg(ref_config, alpha, pallas))
    ref_rep = RefReplay(ref.config.replay, ref.mesh, FRAME, stack=4,
                        gamma=0.99, seed=0, write_chunk=16)
    port = _port_from(ref, alpha, pallas)
    port.draw_uniforms = _ref_uniforms
    rep = _port_replay(port.config)
    # record the port's sampled rows (the reference's are the same: both
    # draw from the reference's uniforms)
    drawn, fused_sample = [], learner_mod.fused_sample

    def recording_sample(*args):
        out = fused_sample(*args)
        drawn.append(out[2])
        return out

    monkeypatch.setattr(learner_mod, "fused_sample", recording_sample)

    _stream([ref_rep, rep], 300, seed=0)     # wraps the 256-row ring
    m_ref = [ref.train_steps_device_per(ref_rep, chain=3)]
    m = [port.train_steps_device_per(rep, chain=3)]
    _stream([ref_rep, rep], 40, seed=1)      # flushed inside the dispatch
    m_ref.append(ref.train_steps_device_per(ref_rep, chain=3))
    m.append(port.train_steps_device_per(rep, chain=3))

    rowp = rep.rowp
    np.testing.assert_array_equal(rep.dstate["frames"].numpy()[:-rowp],
                                  np.asarray(ref_rep.dstate.frames)[:-rowp])
    prio, prio_ref = rep.dstate["prio"].numpy(), np.asarray(ref_rep.dstate.prio)
    if alpha == 0.0:
        np.testing.assert_array_equal(prio, prio_ref)
    else:
        keep = np.ones(prio.shape, bool)
        keep[_within_step_duplicates(drawn)] = False
        assert keep.sum() > 0.9 * keep.size
        np.testing.assert_allclose(prio[keep], prio_ref[keep], rtol=1e-4)
    for key in ("loss", "q_mean"):
        got = np.concatenate([x[key].numpy() for x in m])
        want = np.concatenate([np.asarray(x[key]) for x in m_ref])
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=key)

    got = port.flax_state()
    st = jax.tree.map(np.asarray, ref.state)
    adam, _ = _locate_adam_state(st.opt_state)
    assert got["step"] == int(st.step) == STEPS
    assert got["count"] == int(adam.count) == STEPS
    _assert_tree_close(got["params"], st.params, "params", rtol=0,
                       atol=2 * LR)
    _assert_tree_close(got["target_params"], st.target_params, "target",
                       rtol=0, atol=2 * LR)
    _assert_tree_close(got["mu"], adam.mu, "mu", rtol=1e-3, atol_rel=1e-4)
    _assert_tree_close(got["nu"], adam.nu, "nu", rtol=1e-3, atol_rel=1e-4)


def _recording_ref_sample(monkeypatch, learner, record):
    """Record every (metas, windows, indices) the reference learner's
    sample program returns."""
    build = learner._build_device_per_step

    def wrapped(spec, chain, donate=True):
        sample, train = build(spec, chain, donate)

        def recording(*args):
            out = sample(*args)
            record.append(jax.tree.map(np.asarray, out))
            return out
        return recording, train

    monkeypatch.setattr(learner, "_build_device_per_step", wrapped)


def test_fused_dispatch_draws_the_references_rows(monkeypatch):
    """No uniforms injected: the port draws ``jax.random.uniform``'s own
    numbers from the shared key schedule (``ops/threefry.py``), so two
    chained dispatches of each package from the same seed and state sample
    the same rows. Indices, IS weights (α = 0, the Pong preset's: every
    weight is exactly 1) and the B1 windows: bitwise."""
    torch.set_num_threads(1)
    ref = RefSolver(_cfg(ref_config))
    ref_rep = RefReplay(ref.config.replay, ref.mesh, FRAME, stack=4,
                        gamma=0.99, seed=0, write_chunk=16)
    port = _port_from(ref, 0.0)
    assert port.draw_uniforms is dp_mod.uniforms_for_keys
    rep = _port_replay(port.config)
    drawn_ref, drawn = [], []
    _recording_ref_sample(monkeypatch, ref.learner, drawn_ref)
    fused_sample = learner_mod.fused_sample

    def recording_sample(*args):
        out = fused_sample(*args)
        drawn.append(out)
        return out

    monkeypatch.setattr(learner_mod, "fused_sample", recording_sample)
    _stream([ref_rep, rep], 300, seed=0)
    ref.train_steps_device_per(ref_rep, chain=3)
    port.train_steps_device_per(rep, chain=3)
    _stream([ref_rep, rep], 40, seed=1)
    ref.train_steps_device_per(ref_rep, chain=3)
    port.train_steps_device_per(rep, chain=3)
    assert len(drawn) == len(drawn_ref) == 2
    for (meta, win, idx, _), (meta_r, win_r, idx_r) in zip(drawn, drawn_ref):
        np.testing.assert_array_equal(idx.numpy(), idx_r)
        np.testing.assert_array_equal(meta["weight"].numpy(),
                                      meta_r["weight"])
        np.testing.assert_array_equal(win.numpy(), win_r.reshape(-1))
        for name in ("action", "discount", "ovalid", "nvalid"):
            np.testing.assert_array_equal(meta[name].numpy(), meta_r[name],
                                          err_msg=name)


def test_port_chain3_equals_three_single_dispatches_bitwise():
    """α = 0: sampling ignores priorities, so one chain=3 dispatch and three
    chain=1 dispatches (same keys) run the same three steps bit for bit."""
    torch.set_num_threads(1)
    cfg = _cfg(port_config)
    a, b = Solver(cfg, backend="cpu"), Solver(copy.deepcopy(cfg),
                                              backend="cpu")
    ra, rb = _port_replay(a.config), _port_replay(b.config)
    _stream([ra, rb], 300, seed=0)
    for _ in range(3):
        a.train_step_device_per(ra)
    b.train_steps_device_per(rb, chain=3)
    for (na, pa), (nb, pb) in zip(
            list(a.state.net.named_parameters())
            + list(a.state.target_net.named_parameters()),
            list(b.state.net.named_parameters())
            + list(b.state.target_net.named_parameters())):
        assert na == nb
        torch.testing.assert_close(pa, pb, rtol=0, atol=0)
    for key in ("mu", "nu"):
        for name, t in a.state.opt_state[key].items():
            torch.testing.assert_close(t, b.state.opt_state[key][name],
                                       rtol=0, atol=0)
    assert int(a.state.step) == int(b.state.step) == 3
    torch.testing.assert_close(ra.dstate["prio"], rb.dstate["prio"],
                               rtol=0, atol=0)


@pytest.mark.parametrize("setting, value", [
    ("learn_metrics", True), ("optimizer", "rmsprop")])
def test_out_of_slice_train_settings_are_refused(setting, value):
    """Both settings were refused until the port had them (ROADMAP A4,
    A12); now each runs through the same fused dispatch. Under this
    file's ``stack_forwards=off`` the reference takes its tree body,
    which returns no learning-dynamics plane, and neither does the port
    (``tests/test_torch_learning.py`` holds the plane where it appears;
    ``tests/test_torch_rmsprop.py`` RMSProp against optax)."""
    cfg = _cfg(port_config)
    setattr(cfg.train, setting, value)
    solver = Solver(cfg, backend="cpu")
    rep = _port_replay(solver.config)
    _stream([rep], 300, seed=0)
    m = solver.train_step_device_per(rep)
    assert "learn_plane" not in m
    assert torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])
    assert solver.state.opt_state["name"] == cfg.train.optimizer
    assert int(solver.state.step) == 1
