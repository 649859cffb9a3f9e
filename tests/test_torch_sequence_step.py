"""Port vs reference: the R2D2 sequence learner on both device-ring paths,
and the slice end to end.

The reference ``SequenceSolver`` (one-shard CPU mesh; its ring gather and
flush in Pallas interpret mode) and the port's start from the same weights
and Adam state (``convert.py``) and take the same sequences (a real
``SequenceBuilder`` over random 36×36 frames with 4-frame stacks, short
episodes so windows are padded and masked, random stored carries). Then
three grad steps:

- the ring step (``train_step_from_ring``): each side samples its own
  replay (the samples are equal bit for bit, ``test_torch_sequence_replay``)
  and both write back the REFERENCE's priorities, so the three steps see
  the same batches;
- the chained fused dispatch (``train_steps_device_per``, chain 3), the
  port drawing from the reference's own uniforms; and, with nothing
  injected, the same dispatch sampling the reference's sequences bitwise.

Tolerances are the ones the reference holds its dp=1 and dp=8 runs to
(``tests/test_sequence.py``): the loss within 1e-5 relative, the
priorities within 1e-4 relative, θ and θ⁻ within 2e-4 relative plus 1e-6.
Adam's moments follow the gradients: ``mu`` and ``nu`` within 1e-3
relative plus 1e-4 of the leaf's largest magnitude (``nu`` ≈ g², so a
relative error of the gradient doubles in it).
"""

import json
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_deep_q_tpu import config as ref_config
from distributed_deep_q_tpu.actors.game import FrameStacker
from distributed_deep_q_tpu.parallel.learner import _locate_adam_state
from distributed_deep_q_tpu.parallel.sequence_learner import (
    SequenceSolver as RefSolver)
from distributed_deep_q_tpu.replay import device_sequence as ref_ds
from distributed_deep_q_tpu.replay.sequence import SequenceBuilder

from distributed_deep_q_tpu_torch import config as port_config
from distributed_deep_q_tpu_torch.main import main
from distributed_deep_q_tpu_torch.parallel import (
    sequence_learner as seq_learner_mod)
from distributed_deep_q_tpu_torch.parallel.sequence_learner import (
    SequenceSolver)
from distributed_deep_q_tpu_torch.replay import device_sequence as ds

FRAME, STACK, SEQ_LEN, BURN, LSTM, BATCH, CAP = (36, 36), 4, 8, 4, 16, 8, 24


def _cfg(mod, device_per=False):
    cfg = mod.Config()
    cfg.mesh.backend = "cpu"
    cfg.mesh.dp = 1
    cfg.net = mod.NetConfig(kind="r2d2", num_actions=4, lstm_size=LSTM,
                            frame_shape=FRAME, stack=STACK, dueling=True,
                            compute_dtype="float32")
    cfg.replay = mod.ReplayConfig(
        capacity=CAP * SEQ_LEN, batch_size=BATCH, sequence_length=SEQ_LEN,
        burn_in=BURN, prioritized=True, priority_alpha=0.6,
        device_per=device_per, fused_chain=3)
    cfg.train = mod.TrainConfig(lr=1e-3, double_dqn=True,
                                target_update_period=2, seed=0)
    return cfg


def _sequences(n_steps=260, seed=0):
    """Emissions of a real builder over a random pixel stream: 11-step
    episodes (a full window at step 8, a padded one at the episode's end)."""
    rng = np.random.default_rng(seed)
    builder = SequenceBuilder(SEQ_LEN, BURN, FRAME + (STACK,), np.uint8,
                              LSTM)
    stacker = FrameStacker(FRAME, STACK)
    obs = stacker.reset(rng.integers(0, 255, FRAME, dtype=np.uint8))
    out, t_in_ep = [], 0
    for t in range(n_steps):
        carry = (rng.standard_normal(LSTM).astype(np.float32) * 0.5,
                 rng.standard_normal(LSTM).astype(np.float32) * 0.5)
        t_in_ep += 1
        done = t_in_ep >= 11
        next_obs = stacker.push(rng.integers(0, 255, FRAME, dtype=np.uint8))
        out.extend(builder.on_step(obs, int(rng.integers(4)),
                                   float(rng.standard_normal() * 3), done,
                                   carry, next_obs))
        obs = next_obs
        if done:
            t_in_ep = 0
            builder.reset()
            obs = stacker.reset(rng.integers(0, 255, FRAME, dtype=np.uint8))
    return out


def _pair(device_per):
    ref = RefSolver(_cfg(ref_config, device_per))
    port = SequenceSolver(_cfg(port_config, device_per), backend="cpu")
    st = jax.tree.map(np.asarray, ref.state)
    adam, _ = _locate_adam_state(st.opt_state)
    port.load_flax_state(st.params, st.target_params, adam.count, adam.mu,
                         adam.nu, st.step)
    kw = dict(lstm_size=LSTM, prioritized=True, alpha=0.6, seed=0,
              write_chunk=4)
    shape = FRAME + (STACK,)
    ref_rep = ref_ds.DeviceSequenceReplay(CAP, SEQ_LEN, shape, ref.mesh, **kw)
    port_rep = ds.DeviceSequenceReplay(CAP, SEQ_LEN, shape, "cpu", **kw)
    for s in _sequences():                  # ~46 sequences: the slots wrap
        ref_rep.add_sequence(s)
        port_rep.add_sequence(s)
    return ref, port, ref_rep, port_rep


def _assert_tree_close(got, ref, name, rtol, atol=0.0, atol_rel=0.0):
    for path, leaf in jax.tree_util.tree_leaves_with_path(ref):
        g = got
        for p in path:
            g = g[p.key]
        tol = atol + atol_rel * float(np.abs(leaf).max())
        np.testing.assert_allclose(g, leaf, rtol=rtol, atol=tol,
                                   err_msg=f"{name}{jax.tree_util.keystr(path)}")


def _assert_states_close(port, ref, steps):
    got = port.flax_state()
    st = jax.tree.map(np.asarray, ref.state)
    adam, _ = _locate_adam_state(st.opt_state)
    assert got["step"] == int(st.step) == steps
    assert got["count"] == int(adam.count) == steps
    _assert_tree_close(got["params"], st.params, "params", rtol=2e-4,
                       atol=1e-6)
    _assert_tree_close(got["target_params"], st.target_params, "target",
                       rtol=2e-4, atol=1e-6)
    _assert_tree_close(got["mu"], adam.mu, "mu", rtol=1e-3, atol_rel=1e-4)
    _assert_tree_close(got["nu"], adam.nu, "nu", rtol=1e-3, atol_rel=1e-4)


def test_ring_step_matches_reference():
    torch.set_num_threads(1)
    ref, port, ref_rep, port_rep = _pair(device_per=False)
    for _ in range(3):
        a, b = ref_rep.sample(BATCH), port_rep.sample(BATCH)
        np.testing.assert_array_equal(a["seq_local"], b["seq_local"])
        at_a, at_b = a.pop("_sampled_at"), b.pop("_sampled_at")
        m_ref = ref.train_step_from_ring(ref_rep, a)
        m = port.train_step_from_ring(port_rep, b)
        np.testing.assert_allclose(float(m["loss"]), float(m_ref["loss"]),
                                   rtol=1e-5)
        prio_ref = np.asarray(m_ref["td_abs"])
        np.testing.assert_allclose(m["td_abs"].numpy(), prio_ref, rtol=1e-4)
        ref_rep.update_priorities(a["index"], prio_ref, at_a)
        port_rep.update_priorities(b["index"], prio_ref, at_b)
    _assert_states_close(port, ref, 3)


def _ref_uniforms(keys, per_shard, device):
    u = np.stack([np.asarray(jax.random.uniform(jnp.asarray(k), (per_shard,)))
                  for k in keys])
    return torch.from_numpy(u).to(device)


def test_fused_chained_steps_match_reference():
    """One chain=3 dispatch: the same draws (the reference's uniforms),
    windows gathered once, three steps each scattering its priorities."""
    torch.set_num_threads(1)
    ref, port, ref_rep, port_rep = _pair(device_per=True)
    port.draw_uniforms = _ref_uniforms
    m_ref = ref.train_steps_device_per(ref_rep, chain=3)
    m = port.train_steps_device_per(port_rep, chain=3)
    np.testing.assert_allclose(m["loss"].numpy(), np.asarray(m_ref["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(port_rep.dmeta["prio"].numpy(),
                               np.asarray(ref_rep.dmeta["prio"]), rtol=1e-4)
    np.testing.assert_allclose(float(port_rep.dmaxp),
                               float(np.asarray(ref_rep.dmaxp)), rtol=1e-4)
    _assert_states_close(port, ref, 3)


def test_fused_chained_dispatch_draws_the_references_sequences(monkeypatch):
    """No uniforms injected: one chain=3 dispatch of each package from the
    same sequences and weights samples the same slots (``ops/threefry.py``
    draws ``jax.random.uniform``'s own numbers). Slots, IS weights (every
    fresh priority is the same, so each weight is exactly 1) and the B1
    windows: bitwise."""
    torch.set_num_threads(1)
    ref, port, ref_rep, port_rep = _pair(device_per=True)
    drawn_ref, drawn = [], []
    build = ref.learner._build_fused_steps

    def wrapped(spec, chain):
        sample, train = build(spec, chain)

        def recording(*args):
            out = sample(*args)
            drawn_ref.append(jax.tree.map(np.asarray, out))
            return out
        return recording, train

    monkeypatch.setattr(ref.learner, "_build_fused_steps", wrapped)
    sample = seq_learner_mod.fused_sequence_sample

    def recording_sample(*args):
        out = sample(*args)
        drawn.append(out)
        return out

    monkeypatch.setattr(seq_learner_mod, "fused_sequence_sample",
                        recording_sample)
    ref.train_steps_device_per(ref_rep, chain=3)
    port.train_steps_device_per(port_rep, chain=3)
    (meta, win, idx), = drawn
    (meta_r, win_r, idx_r), = drawn_ref
    np.testing.assert_array_equal(idx.numpy(), idx_r)
    np.testing.assert_array_equal(meta["weight"].numpy(), meta_r["weight"])
    np.testing.assert_array_equal(win.numpy(), win_r)
    for name in ds.META_KEYS:
        np.testing.assert_array_equal(meta[name].numpy(), meta_r[name],
                                      err_msg=name)


def test_host_batch_step_matches_reference():
    """``train_step`` on a host batch of stacked observations (the host
    ``SequenceReplay``'s path), mlp torso: one step."""
    torch.set_num_threads(1)
    ref_cfg, cfg = _cfg(ref_config), _cfg(port_config)
    for c in (ref_cfg, cfg):
        c.net.torso, c.net.hidden = "mlp", (24,)
    obs_dim = int(np.prod(FRAME)) * STACK
    ref = RefSolver(ref_cfg, obs_dim=obs_dim)
    port = SequenceSolver(cfg, obs_dim=obs_dim, backend="cpu")
    st = jax.tree.map(np.asarray, ref.state)
    adam, _ = _locate_adam_state(st.opt_state)
    port.load_flax_state(st.params, st.target_params, adam.count, adam.mu,
                         adam.nu, st.step)
    seqs = _sequences(90, seed=1)[:BATCH]
    batch = {k: np.stack([s[k] for s in seqs]) for k in seqs[0]}
    batch["weight"] = np.linspace(0.5, 1.0, BATCH).astype(np.float32)
    m_ref = ref.train_step(dict(batch))
    m = port.train_step(dict(batch))
    np.testing.assert_allclose(float(m["loss"]), float(m_ref["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(m["td_abs"].numpy(),
                               np.asarray(m_ref["td_abs"]), rtol=1e-4)
    _assert_states_close(port, ref, 1)


def test_act_advances_the_carry_on_random_actions():
    """ε = 1: every action is random, and the carry still moves (the
    stored-state burn-in needs what the net saw); the numpy draw order is
    the reference's (q first, then the ε draw)."""
    solver = SequenceSolver(_cfg(port_config), backend="cpu")
    rng, rng2 = np.random.default_rng(0), np.random.default_rng(0)
    carry = solver.initial_state(1)
    obs = np.random.default_rng(1).integers(0, 255, FRAME + (STACK,),
                                            dtype=np.uint8)
    a, carry2 = solver.act(obs, carry, 1.0, rng)
    assert rng2.random() < 1.0 and a == int(rng2.integers(4))
    assert carry2[0].shape == (1, LSTM) and np.abs(carry2[1]).sum() > 0
    q, carry3 = solver.q_values(obs[None], carry)
    np.testing.assert_array_equal(carry3[1], carry2[1])
    assert q.shape == (1, 4)


# -- the slice through the CLI -------------------------------------------------

R2D2_SMALL = ["env.kind=signal_atari", "env.id=signal",
              "env.frame_shape=36,36", "net.frame_shape=36,36",
              "net.compute_dtype=float32", "net.lstm_size=16",
              "replay.capacity=2048", "replay.batch_size=8",
              "replay.sequence_length=16", "replay.burn_in=4",
              "replay.learn_start=256", "train.total_steps=600",
              "train.train_every=16", "train.target_update_period=10",
              "train.eval_episodes=1"]


def _run(argv, capsys):
    rc = main(argv)
    return rc, json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("path", ["replay.device_per=false",
                                  "replay.device_per=true"])
def test_cli_trains_r2d2_preset_on_cpu(path, capsys):
    """``train --preset r2d2 --backend cpu`` at a small size on both device
    ring paths. A 32-step SignalAtari episode gives three 16-step
    sequences (at its steps 16 and 28, every 12 = 16 − 4 steps, and at
    its end), so the 16 sequences of ``learn_start`` are in at env step
    5·32 + 16 = 176, and every 16th step from there trains."""
    torch.set_num_threads(1)
    rc, summary = _run(["train", "--preset", "r2d2", "--backend", "cpu",
                        "--log-every", "3", "--set", *R2D2_SMALL, path,
                        "replay.fused_chain=4"], capsys)
    assert rc == 0 and summary["grad_steps"] == (600 - 176) // 16 + 1
    assert math.isfinite(summary["loss"])
    assert 0 <= summary["eval_return"] <= 32


def test_cli_trains_r2d2_mlp_torso_cartpole_through_host_replay(capsys):
    """The host ``SequenceReplay`` path: an mlp-torso R2D2 on CartPole."""
    torch.set_num_threads(1)
    rc, summary = _run([
        "train", "--preset", "cartpole", "--backend", "cpu", "--log-every",
        "50", "--set", "net.kind=r2d2", "net.torso=mlp", "net.hidden=32",
        "net.lstm_size=16", "replay.batch_size=8",
        "replay.sequence_length=10", "replay.burn_in=4",
        "replay.learn_start=400", "replay.prioritized=true",
        "train.total_steps=1000", "train.train_every=4",
        "train.target_update_period=50", "train.eval_episodes=2"], capsys)
    assert rc == 0 and summary["grad_steps"] > 100
    assert math.isfinite(summary["loss"])


def test_cli_evaluates_r2d2_preset_on_cpu(capsys):
    rc, summary = _run(["eval", "--preset", "r2d2", "--backend", "cpu",
                        "--set", *R2D2_SMALL], capsys)
    assert rc == 0 and 0 <= summary["eval_return"] <= 32


@pytest.mark.parametrize("setting, value", [
    ("learn_metrics", True), ("optimizer", "rmsprop")])
def test_out_of_slice_r2d2_settings_are_refused(setting, value, capsys):
    """Both settings were refused until the port had them (ROADMAP A4,
    A12); now the r2d2 preset trains with each through ``main train`` on
    the chained fused path (the plane's values against the reference's
    are in ``tests/test_torch_learning.py``, RMSProp's in
    ``tests/test_torch_rmsprop.py``)."""
    torch.set_num_threads(1)
    rc, summary = _run(["train", "--preset", "r2d2", "--backend", "cpu",
                        "--log-every", "3", "--set", *R2D2_SMALL,
                        "replay.device_per=true", "replay.fused_chain=4",
                        f"train.{setting}={str(value).lower()}"], capsys)
    assert rc == 0 and summary["grad_steps"] == (600 - 176) // 16 + 1
    assert math.isfinite(summary["loss"])
