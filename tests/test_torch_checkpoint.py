"""Checkpoints of the port's train state (``utils/checkpoint.py``).

- A round trip is bitwise: θ, θ⁻, Adam's count, μ and ν, and the step, for
  the feed-forward nets and the recurrent one (whose zero ``bias_ih``
  stays a zero buffer), onto a solver built from another seed.
- A snapshot is the state at ``save``: a step taken while the background
  writer runs does not reach it.
- ``extra`` keeps int, float and bool apart; retention keeps the newest.
- 10 straight steps equal 5 steps, save, restore into a solver of another
  seed, and 5 more — bitwise on the CPU.
- Across packages: the reference trains 5 steps, saves through Orbax and
  restores through its own ``Checkpointer``; its state goes into the port
  through ``Solver.load_flax_state``, and both take the same 5 steps,
  compared with the host-step parity tests' tolerances
  (``tests/test_torch_host_step.py``).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax

from distributed_deep_q_tpu import config as ref_config
from distributed_deep_q_tpu.parallel.learner import _locate_adam_state
from distributed_deep_q_tpu.solver import Solver as RefSolver
from distributed_deep_q_tpu.utils.checkpoint import (
    Checkpointer as RefCheckpointer)

from distributed_deep_q_tpu_torch import config as port_config
from distributed_deep_q_tpu_torch.parallel.sequence_learner import (
    SequenceSolver)
from distributed_deep_q_tpu_torch.solver import Solver
from distributed_deep_q_tpu_torch.utils.checkpoint import (
    Checkpointer, maybe_checkpointer)

LR, B, SEQ, LSTM = 1e-3, 8, 6, 8


def _cfg(mod, kind, seed=0, mu_dtype="float32"):
    cfg = mod.Config()
    cfg.mesh.backend = "cpu"
    cfg.mesh.dp = 1
    if kind == "mlp":
        cfg.net = mod.NetConfig(kind="mlp", num_actions=2, hidden=(16,))
    elif kind == "nature_cnn":
        cfg.net = mod.NetConfig(kind="nature_cnn", num_actions=4,
                                frame_shape=(36, 36),
                                compute_dtype="float32")
    else:
        cfg.net = mod.NetConfig(kind="r2d2", num_actions=3, torso="mlp",
                                hidden=(16,), lstm_size=LSTM, dueling=True)
        cfg.replay = mod.ReplayConfig(sequence_length=SEQ, burn_in=2,
                                      batch_size=B)
    cfg.train = mod.TrainConfig(lr=LR, seed=seed, target_update_period=3,
                                double_dqn=True, adam_mu_dtype=mu_dtype)
    return cfg


def _solver(kind, seed=0, mu_dtype="float32"):
    cfg = _cfg(port_config, kind, seed, mu_dtype)
    if kind == "r2d2":
        return SequenceSolver(cfg, obs_dim=4, backend="cpu")
    return Solver(cfg, obs_dim=4, backend="cpu")


def _batch(kind, rng):
    if kind == "r2d2":
        mask = np.ones((B, SEQ), np.float32)
        mask[: B // 2, SEQ - 2:] = 0.0
        return {
            "obs": rng.standard_normal((B, SEQ + 1, 4)).astype(np.float32),
            "action": rng.integers(0, 3, (B, SEQ)).astype(np.int32),
            "reward": rng.standard_normal((B, SEQ)).astype(np.float32),
            "discount": np.full((B, SEQ), 0.99, np.float32) * mask,
            "mask": mask,
            "init_c": rng.standard_normal((B, LSTM)).astype(np.float32),
            "init_h": rng.standard_normal((B, LSTM)).astype(np.float32),
            "weight": np.linspace(0.5, 1, B).astype(np.float32)}
    if kind == "nature_cnn":
        obs = rng.integers(0, 255, (B, 36, 36, 4), dtype=np.uint8)
        nxt = rng.integers(0, 255, (B, 36, 36, 4), dtype=np.uint8)
        na = 4
    else:
        obs = rng.standard_normal((B, 4)).astype(np.float32)
        nxt = rng.standard_normal((B, 4)).astype(np.float32)
        na = 2
    return {"obs": obs, "next_obs": nxt,
            "action": rng.integers(0, na, B).astype(np.int32),
            "reward": rng.standard_normal(B).astype(np.float32),
            "discount": np.full(B, 0.99, np.float32),
            "weight": np.ones(B, np.float32)}


def _leaves(solver) -> dict[str, torch.Tensor]:
    st = solver.state
    out = {f"params/{k}": p for k, p in st.net.named_parameters()}
    out.update({f"target/{k}": p for k, p in st.target_net.named_parameters()})
    for key in ("mu", "nu"):
        out.update({f"{key}/{k}": t for k, t in st.opt_state[key].items()})
    out["count"] = st.opt_state["count"]
    out["step"] = st.step
    return out


def _assert_states_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert la.keys() == lb.keys()
    for k in la:
        assert la[k].dtype == lb[k].dtype, k
        assert torch.equal(la[k], lb[k]), k


@pytest.mark.parametrize("kind, mu_dtype", [
    ("mlp", "float32"), ("mlp", "bfloat16"), ("nature_cnn", "float32"),
    ("r2d2", "float32")])
def test_checkpoint_roundtrip_is_bitwise(tmp_path, kind, mu_dtype):
    torch.set_num_threads(1)
    s = _solver(kind, mu_dtype=mu_dtype)
    rng = np.random.default_rng(0)
    for _ in range(4):
        s.train_step(_batch(kind, rng))
    ckpt = Checkpointer(str(tmp_path / "ck"))
    assert ckpt.save(s.state, extra={"env_steps": 123}, wait=True) == 4
    assert sorted(os.listdir(tmp_path / "ck" / "4")) == ["extra.json",
                                                         "state.pt"]

    s2 = _solver(kind, seed=99, mu_dtype=mu_dtype)  # must be overwritten
    assert not torch.equal(next(s2.state.net.parameters()),
                           next(s.state.net.parameters()))
    state, extra = ckpt.restore(s2.state)
    assert state is s2.state and extra == {"env_steps": 123}
    assert s2.step == 4 and int(s2.state.opt_state["count"]) == 4
    _assert_states_equal(s, s2)
    if kind == "r2d2":
        names = dict(s2.state.net.named_parameters())
        buffers = dict(s2.state.net.named_buffers())
        assert "lstm.bias_ih" not in names and "lstm.bias_ih" in buffers
        assert not buffers["lstm.bias_ih"].any()
    # the restored solver trains on as the saved one does
    b = _batch(kind, np.random.default_rng(5))
    ma, mb = s.train_step(dict(b)), s2.train_step(dict(b))
    assert torch.equal(ma["loss"], mb["loss"])


def test_snapshot_is_taken_at_save(tmp_path):
    """Adam steps in place; a step taken before the background write ends
    must not reach the snapshot."""
    torch.set_num_threads(1)
    s = _solver("mlp")
    rng = np.random.default_rng(0)
    s.train_step(_batch("mlp", rng))
    before = {k: v.clone() for k, v in _leaves(s).items()}
    ckpt = Checkpointer(str(tmp_path / "ck"))
    ckpt.save(s.state)                       # returns before the write
    for _ in range(3):
        s.train_step(_batch("mlp", rng))
    assert ckpt.latest_step() == 1           # waits for the writer
    s2 = _solver("mlp", seed=7)
    ckpt.restore(s2.state)
    after = _leaves(s2)
    for k, v in before.items():
        assert torch.equal(after[k], v), k


def test_extra_preserves_scalar_kinds(tmp_path):
    s = _solver("mlp")
    ckpt = Checkpointer(str(tmp_path / "ck"))
    ckpt.save(s.state, extra={
        "env_steps": 123, "big": 2**53 + 1, "lr": 6.25e-5,
        "np_int": np.int64(77), "np_float": np.float32(0.5), "flag": True,
    }, wait=True)
    _, extra = ckpt.restore(s.state)
    assert extra["env_steps"] == 123 and type(extra["env_steps"]) is int
    assert extra["big"] == 2**53 + 1 and type(extra["big"]) is int
    assert extra["lr"] == pytest.approx(6.25e-5) and type(extra["lr"]) is float
    assert extra["np_int"] == 77 and type(extra["np_int"]) is int
    assert extra["np_float"] == 0.5 and type(extra["np_float"]) is float
    assert extra["flag"] is True
    with open(tmp_path / "ck" / "0" / "extra.json") as f:
        assert json.load(f)["flag"] is True


def test_keep_retention(tmp_path):
    torch.set_num_threads(1)
    s = _solver("mlp")
    rng = np.random.default_rng(0)
    ckpt = Checkpointer(str(tmp_path / "ck"), keep=2)
    for _ in range(4):
        s.train_step(_batch("mlp", rng))
        ckpt.save(s.state)
    assert ckpt.latest_step() == 4
    assert sorted(os.listdir(tmp_path / "ck")) == ["3", "4"]
    # a fresh checkpointer on the same directory sees the same snapshots
    assert Checkpointer(str(tmp_path / "ck")).latest_step() == 4


def test_restore_refusals_and_writer_errors(tmp_path):
    ckpt = Checkpointer(str(tmp_path / "ck"))
    assert ckpt.latest_step() is None
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        ckpt.restore(_solver("mlp").state)
    ckpt.save(_solver("mlp").state, wait=True)
    with pytest.raises(ValueError, match="do not match the net"):
        ckpt.restore(_solver("nature_cnn").state)
    # a failed background write surfaces on the caller's next wait
    blocker = Checkpointer(str(tmp_path / "ck2"))
    open(tmp_path / "ck2" / "0", "w").close()   # a file where the dir goes
    blocker.save(_solver("mlp").state)
    with pytest.raises(OSError):
        blocker.wait()
    blocker.wait()                               # reported once


def test_maybe_checkpointer_needs_a_dir_and_a_cadence(tmp_path):
    train = port_config.TrainConfig()
    assert maybe_checkpointer(train) is None
    train.checkpoint_dir = str(tmp_path / "ck")
    assert maybe_checkpointer(train) is None          # checkpoint_every 0
    train.checkpoint_every = 10
    assert isinstance(maybe_checkpointer(train), Checkpointer)


@pytest.mark.parametrize("kind", ["mlp", "r2d2"])
def test_resume_continues_identically(tmp_path, kind):
    """10 straight steps == 5 steps → save → restore → 5 more, bitwise."""
    torch.set_num_threads(1)
    rng = np.random.default_rng(7)
    batches = [_batch(kind, rng) for _ in range(10)]
    a = _solver(kind)
    for b in batches:
        a.train_step(dict(b))

    b1 = _solver(kind)
    for b in batches[:5]:
        b1.train_step(dict(b))
    ckpt = Checkpointer(str(tmp_path / "ck"))
    ckpt.save(b1.state, wait=True)
    b2 = _solver(kind, seed=42)
    b2.state, _ = ckpt.restore(b2.state)
    for b in batches[5:]:
        b2.train_step(dict(b))
    assert b2.step == 10
    _assert_states_equal(a, b2)


def _ref_leaves(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_tree_close(got, ref, name, rtol, atol_rel=0.0, atol=0.0):
    for path, leaf in jax.tree_util.tree_leaves_with_path(ref):
        g = got
        for p in path:
            g = g[p.key]
        tol = atol + atol_rel * float(np.abs(leaf).max())
        np.testing.assert_allclose(
            g, leaf, rtol=rtol, atol=tol,
            err_msg=f"{name}{jax.tree_util.keystr(path)}")


def test_reference_checkpoint_continues_in_the_port(tmp_path):
    """The reference: 5 steps, an Orbax save, a restore into a solver of
    another seed. The port takes that state (``load_flax_state``); both
    then take the same 5 steps."""
    torch.set_num_threads(1)
    rng = np.random.default_rng(3)
    batches = [_batch("mlp", rng) for _ in range(10)]
    ref = RefSolver(_cfg(ref_config, "mlp"), obs_dim=4)
    for b in batches[:5]:
        ref.train_step(dict(b))
    ckpt = RefCheckpointer(str(tmp_path / "ref_ck"))
    ckpt.save(ref.state, wait=True)
    ref2 = RefSolver(_cfg(ref_config, "mlp", seed=99), obs_dim=4)
    ref2.state, _ = ckpt.restore(ref2.state)
    ckpt.close()
    assert ref2.step == 5

    port = _solver("mlp", seed=42)
    st = _ref_leaves(ref2.state)
    adam, _ = _locate_adam_state(st.opt_state)
    port.load_flax_state(st.params, st.target_params, adam.count, adam.mu,
                         adam.nu, st.step)
    for b in batches[5:]:
        mr, mp = ref2.train_step(dict(b)), port.train_step(dict(b))
        for key in ("loss", "q_mean"):
            np.testing.assert_allclose(float(mp[key]), float(mr[key]),
                                       rtol=1e-5, err_msg=key)
    got = port.flax_state()
    st = _ref_leaves(ref2.state)
    adam, _ = _locate_adam_state(st.opt_state)
    assert got["step"] == int(st.step) == 10
    assert got["count"] == int(adam.count) == 10
    _assert_tree_close(got["params"], st.params, "params", 0, atol=2 * LR)
    _assert_tree_close(got["target_params"], st.target_params, "target", 0,
                       atol=2 * LR)
    _assert_tree_close(got["mu"], adam.mu, "mu", 1e-3, atol_rel=1e-4)
    _assert_tree_close(got["nu"], adam.nu, "nu", 1e-3, atol_rel=1e-4)
