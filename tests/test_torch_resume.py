"""Resume through the port's loops and CLI: checkpoints
(``utils/checkpoint.py``) and replay persistence (``replay/persistence.py``)
wired into ``train_single_process``, ``train_recurrent`` and ``main``.

- A resumed run continues an unbroken one: k dispatches, a save of the
  train state and the replay, a restore into a scrambled solver and a
  replay built from another seed, and n − k more dispatches give the
  n-dispatch run's state bit for bit (the fused key schedule anchors on
  the restored step; β and the sampler RNGs come from the file). Pinned for the fused
  device-PER dispatch, the r2d2 chained fused path and its ring step.
- The reference's loop tests, through the port: CartPole checkpoint and
  resume (``tests/test_checkpoint.py``), fused device-PER persist and
  resume and the recurrent loop's (``tests/test_persistence.py``), and an
  r2d2 train → eval → play round trip (``tests/test_cli.py``).
- ``main train`` with a checkpoint dir and a persist path, then
  ``train.resume=true``, on every replay path the port has; ``main eval``
  reports the restored step and ``main play`` runs.
"""

import contextlib
import io
import json
import math
import os

import numpy as np
import pytest
import torch

from distributed_deep_q_tpu_torch import config as port_config
from distributed_deep_q_tpu_torch.main import main
from distributed_deep_q_tpu_torch.parallel.sequence_learner import (
    SequenceSolver)
from distributed_deep_q_tpu_torch.replay.device_per import (
    DevicePERFrameReplay)
from distributed_deep_q_tpu_torch.replay.device_sequence import (
    DeviceSequenceReplay)
from distributed_deep_q_tpu_torch.replay.persistence import (
    load_replay, save_replay)
from distributed_deep_q_tpu_torch.solver import Solver
from distributed_deep_q_tpu_torch.train import (
    train_recurrent, train_single_process)
from distributed_deep_q_tpu_torch.utils.checkpoint import Checkpointer

FRAME = (36, 36)


# -- a resumed run continues an unbroken one --------------------------------


def _fused_cfg(seed):
    cfg = port_config.Config()
    cfg.mesh.backend = "cpu"
    cfg.net = port_config.NetConfig(kind="nature_cnn", num_actions=4,
                                    frame_shape=FRAME,
                                    compute_dtype="float32")
    cfg.replay = port_config.ReplayConfig(
        capacity=256, batch_size=16, n_step=2, prioritized=True,
        priority_alpha=0.6, device_per=True, write_chunk=16)
    cfg.train = port_config.TrainConfig(lr=1e-4, double_dqn=True,
                                        target_update_period=2, seed=seed)
    return cfg


def _r2d2_cfg(seed):
    cfg = port_config.Config()
    cfg.mesh.backend = "cpu"
    cfg.net = port_config.NetConfig(kind="r2d2", num_actions=4, lstm_size=8,
                                    frame_shape=FRAME, stack=4,
                                    compute_dtype="float32")
    cfg.replay = port_config.ReplayConfig(
        batch_size=8, sequence_length=8, burn_in=2, prioritized=True,
        priority_alpha=0.6)
    cfg.train = port_config.TrainConfig(lr=1e-3, double_dqn=True,
                                        target_update_period=2, seed=seed)
    return cfg


def _pair(path, seed):
    """(solver, replay) for ``path``, filled by the same stream whatever
    the replay's seed. The train seed is the run's (the fused key
    schedule derives from it), so it stays 0."""
    rng = np.random.default_rng(0)
    if path == "fused_per":
        s = Solver(_fused_cfg(0), backend="cpu")
        r = DevicePERFrameReplay(s.config.replay, "cpu", FRAME, 4, 0.99,
                                 seed=seed, write_chunk=16)
        for i in range(300):
            r.add(rng.integers(0, 255, FRAME, dtype=np.uint8),
                  int(rng.integers(4)), float(rng.standard_normal()),
                  i % 11 == 10)
        return s, r
    s = SequenceSolver(_r2d2_cfg(0), backend="cpu")
    r = DeviceSequenceReplay(20, 8, FRAME + (4,), "cpu", 8, prioritized=True,
                             alpha=0.6, seed=seed, write_chunk=3)
    for _ in range(24):
        mask = (np.arange(8) < rng.integers(3, 9)).astype(np.float32)
        r.add_sequence({
            "obs": rng.integers(0, 255, (9,) + FRAME + (4,), dtype=np.uint8),
            "action": rng.integers(0, 4, 8).astype(np.int32),
            "reward": rng.standard_normal(8).astype(np.float32),
            "discount": np.full(8, 0.99, np.float32) * mask, "mask": mask,
            "init_c": rng.standard_normal(8).astype(np.float32) * 0.1,
            "init_h": rng.standard_normal(8).astype(np.float32) * 0.1})
    return s, r


def _dispatch(path, solver, replay):
    if path == "r2d2_ring":
        batch = replay.sample(8)
        at = batch.pop("_sampled_at")
        m = solver.train_step_from_ring(replay, batch)
        replay.update_priorities(m["index"], m["td_abs"].numpy(), at)
    else:
        solver.train_steps_device_per(replay, chain=1)


def _device_state(path, replay):
    if path == "fused_per":
        return {k: replay.dstate[k] for k in ("prio", "maxp")}
    return {"prio": replay.dmeta["prio"], "maxp": replay.dmaxp}


@pytest.mark.parametrize("path", ["fused_per", "r2d2_fused", "r2d2_ring"])
def test_resumed_dispatches_continue_an_unbroken_run(path, tmp_path):
    torch.set_num_threads(1)
    a, ra = _pair(path, seed=0)
    for _ in range(4):
        _dispatch(path, a, ra)

    b, rb = _pair(path, seed=0)
    for _ in range(2):
        _dispatch(path, b, rb)
    Checkpointer(str(tmp_path / "ck")).save(b.state, wait=True)
    save_replay(rb, str(tmp_path / "r.npz"))
    c, rc = _pair(path, seed=7)
    with torch.no_grad():           # the restore must overwrite all of it
        for p in c.state.net.parameters():
            p.normal_()
        for t in c.state.opt_state["mu"].values():
            t.fill_(0.5)
    Checkpointer(str(tmp_path / "ck")).restore(c.state)
    load_replay(rc, str(tmp_path / "r.npz"))
    for _ in range(2):
        _dispatch(path, c, rc)

    assert c.step == a.step == 4
    for (na, pa), (nc, pc) in zip(
            list(a.state.net.named_parameters())
            + list(a.state.target_net.named_parameters()),
            list(c.state.net.named_parameters())
            + list(c.state.target_net.named_parameters())):
        assert na == nc and torch.equal(pa, pc), na
    for key in ("mu", "nu"):
        for name, t in a.state.opt_state[key].items():
            assert torch.equal(t, c.state.opt_state[key][name]), name
    for k, v in _device_state(path, ra).items():
        assert torch.equal(v, _device_state(path, rc)[k]), k
    if path == "r2d2_ring":
        np.testing.assert_array_equal(ra.tree.tree, rc.tree.tree)


# -- the reference's loop tests, through the port ---------------------------


def test_train_loop_checkpoint_and_resume(tmp_path):
    """CartPole (``tests/test_checkpoint.py``): run with checkpoint_every,
    then ``resume`` restarts from the snapshot step."""
    torch.set_num_threads(1)
    cfg = port_config.Config()
    cfg.mesh.backend = "cpu"
    cfg.net = port_config.NetConfig(kind="mlp", num_actions=2, hidden=(16,))
    cfg.replay = port_config.ReplayConfig(capacity=2000, batch_size=16,
                                          learn_start=100)
    cfg.train = port_config.TrainConfig(
        total_steps=300, train_every=1, target_update_period=50,
        checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=100)
    s1 = train_single_process(cfg, log_every=100)
    assert s1["solver"].step == 201   # 300 env steps - 100 warmup + final
    assert Checkpointer(str(tmp_path / "ck")).latest_step() == 201

    cfg.train.resume = True
    cfg.train.total_steps = 100
    s2 = train_single_process(cfg, log_every=100)
    assert s2["solver"].step == 201 + 1   # the warm-up refills the replay
    assert s2["grad_steps"] == 202


def _fused_loop_cfg(path, ckdir):
    cfg = port_config.Config()
    cfg.mesh.backend = "cpu"
    cfg.env = port_config.EnvConfig(id="signal", kind="signal_atari",
                                    frame_shape=FRAME, stack=4,
                                    reward_clip=0.0)
    cfg.net = port_config.NetConfig(kind="nature_cnn", num_actions=4,
                                    frame_shape=FRAME,
                                    compute_dtype="float32")
    cfg.replay = port_config.ReplayConfig(
        capacity=2048, batch_size=16, learn_start=200, n_step=2,
        prioritized=True, device_per=True, write_chunk=16, persist_path=path)
    cfg.train = port_config.TrainConfig(
        lr=1e-3, total_steps=300, train_every=8, target_update_period=10,
        seed=0, checkpoint_dir=ckdir, checkpoint_every=10, eval_episodes=1)
    return cfg


def test_fused_train_loop_persist_and_resume(tmp_path):
    """Fused device-PER (``tests/test_persistence.py``): persist, then
    resume with fewer env steps than ``learn_start`` — it trains only
    because the ring came back."""
    torch.set_num_threads(1)
    path = str(tmp_path / "ring.npz")
    cfg = _fused_loop_cfg(path, str(tmp_path / "ck"))
    s1 = train_single_process(cfg, log_every=50)
    assert os.path.exists(path)
    assert len(s1["replay"]) == 300

    cfg.train.resume = True
    cfg.train.total_steps = 50
    s2 = train_single_process(cfg, log_every=1)
    assert math.isfinite(s2["loss"])
    assert s2["solver"].step == s1["solver"].step + 50 // 8
    assert len(s2["replay"]) == 350


def test_recurrent_train_loop_persist_and_resume(tmp_path):
    """The recurrent loop (``tests/test_persistence.py``): the sequence
    buffer comes back full instead of warm-refilling."""
    torch.set_num_threads(1)
    path = str(tmp_path / "r2d2_replay.npz")
    cfg = port_config.Config()
    cfg.mesh.backend = "cpu"
    cfg.env = port_config.EnvConfig(id="signal", kind="signal_atari",
                                    frame_shape=FRAME, stack=4,
                                    reward_clip=0.0)
    cfg.net = port_config.NetConfig(kind="r2d2", num_actions=4,
                                    frame_shape=FRAME, stack=4, lstm_size=8,
                                    compute_dtype="float32")
    cfg.replay = port_config.ReplayConfig(
        capacity=2048, batch_size=8, learn_start=200, sequence_length=16,
        burn_in=4, prioritized=True, persist_path=path)
    cfg.train = port_config.TrainConfig(
        lr=1e-3, total_steps=300, train_every=16, target_update_period=10,
        seed=0, eval_episodes=1, checkpoint_every=5,
        checkpoint_dir=str(tmp_path / "ck"), resume=True)
    s1 = train_recurrent(cfg, log_every=5)
    assert os.path.exists(path)
    size_before = len(s1["replay"])
    assert size_before > 0
    s2 = train_recurrent(cfg, log_every=5)
    assert len(s2["replay"]) >= size_before
    assert math.isfinite(s2["loss"])
    assert s2["solver"].step > s1["solver"].step


def _cli(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    lines = out.getvalue().strip().splitlines()
    return rc, json.loads(lines[-1]), lines


R2D2_TINY = [
    "net.torso=mlp", "net.lstm_size=16", "net.hidden=32",
    "replay.sequence_length=8", "replay.burn_in=2", "replay.batch_size=8",
    "replay.capacity=2000", "replay.learn_start=64",
    "replay.prioritized=false", "train.total_steps=250",
    "train.eval_episodes=2", "env.id=CartPole-v1", "env.kind=gym",
    "env.stack=1", "actors.num_actors=1"]


def test_r2d2_checkpoint_roundtrips_through_cli(tmp_path):
    """``tests/test_cli.py``: an r2d2 checkpoint written by train mode is
    evaluable and playable."""
    torch.set_num_threads(1)
    common = ["--preset", "r2d2", "--backend", "cpu", "--set", *R2D2_TINY,
              f"train.checkpoint_dir={tmp_path / 'ckpt'}",
              "train.checkpoint_every=100"]
    rc, out, _ = _cli(["train", *common])
    assert rc == 0 and out["mode"] == "train"
    rc, out, _ = _cli(["eval", *common])
    assert rc == 0 and out["mode"] == "eval"
    assert out["restored_step"] is not None and out["restored_step"] > 0
    assert out["eval_return"] >= 0.0
    rc, out, lines = _cli(["play", *common])
    assert rc == 0 and out["mode"] == "play" and out["steps"] > 0
    assert len(lines) == out["steps"] + 1 and lines[0].startswith("t=1 ")


# -- main train → resume → eval → play on every replay path ------------------

PIXELS = ["env.kind=signal_atari", "env.id=signal", "env.frame_shape=36,36",
          "net.frame_shape=36,36", "net.compute_dtype=float32",
          "train.eval_episodes=1"]
PATHS = {
    # (preset, overrides, env steps of the first run, of the resumed run)
    "fused_device_per": ("pong", PIXELS + [
        "replay.capacity=2048", "replay.batch_size=16",
        "replay.learn_start=300", "replay.write_chunk=16",
        "train.train_every=4"], 400, 100),
    "device_ring_sum_trees": ("breakout", PIXELS + [
        "replay.capacity=2048", "replay.batch_size=16",
        "replay.learn_start=300", "replay.write_chunk=16",
        "replay.device_per=false", "train.train_every=4",
        "train.use_pallas_loss=true"], 400, 100),
    "host_frame_stack": ("breakout", PIXELS + [
        "replay.capacity=2048", "replay.batch_size=16",
        "replay.learn_start=300", "replay.device_resident=false",
        "train.train_every=4"], 400, 100),
    "cartpole": ("cartpole", [
        "replay.learn_start=300", "train.eval_every=0",
        "train.eval_episodes=1", "replay.batch_size=32"], 400, 100),
    "r2d2_ring": ("r2d2", PIXELS + [
        "net.lstm_size=16", "replay.capacity=2048", "replay.batch_size=8",
        "replay.sequence_length=16", "replay.burn_in=4",
        "replay.learn_start=256", "train.train_every=16",
        "train.target_update_period=10"], 400, 100),
    "r2d2_fused": ("r2d2", PIXELS + [
        "net.lstm_size=16", "replay.capacity=2048", "replay.batch_size=8",
        "replay.sequence_length=16", "replay.burn_in=4",
        "replay.learn_start=256", "train.train_every=16",
        "train.target_update_period=10", "replay.device_per=true",
        "replay.fused_chain=4"], 400, 100),
}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_cli_train_resume_eval_play(path, tmp_path):
    """The first run checkpoints and persists; the resumed run has fewer
    env steps than ``learn_start`` needs, so it trains only because the
    replay came back, and continues from the first run's final step."""
    torch.set_num_threads(1)
    preset, overrides, n1, n2 = PATHS[path]
    ck, npz = tmp_path / "ck", tmp_path / "replay.npz"
    common = ["--preset", preset, "--backend", "cpu", "--log-every", "5",
              "--set", *overrides, f"train.checkpoint_dir={ck}",
              "train.checkpoint_every=10", f"replay.persist_path={npz}"]
    rc, first, _ = _cli(["train", *common, f"train.total_steps={n1}"])
    assert rc == 0 and first["grad_steps"] > 0 and npz.exists()
    step1 = Checkpointer(str(ck)).latest_step()
    assert step1 == first["grad_steps"]

    rc, second, _ = _cli(["train", *common, f"train.total_steps={n2}",
                          "train.resume=true"])
    assert rc == 0 and second["grad_steps"] > step1
    assert math.isfinite(second["loss"])
    assert Checkpointer(str(ck)).latest_step() == second["grad_steps"]

    rc, ev, _ = _cli(["eval", *common])
    assert rc == 0 and ev["restored_step"] == second["grad_steps"]
    rc, play, _ = _cli(["play", *common])
    assert rc == 0 and play["mode"] == "play" and play["steps"] > 0
