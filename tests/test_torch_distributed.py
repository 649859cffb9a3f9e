"""``train_distributed`` end to end on the CPU: spawned actor processes
feed the learner over the v4 wire (``--backend cpu``, small shapes).

One run per replay branch the reference's loop has, each with 2 actors:

- ``cartpole`` — the CLI (``main train --distributed --preset
  cartpole``): a uniform ``ReplayMemory`` through the ``DeviceStager``;
- ``fused_per`` — the Pong preset on SignalAtari at 36×36 in float32:
  ``DevicePERFrameReplay`` on the fused stream (the fused loss's plain
  versions on the CPU), two stream sub-rings;
- ``ring_multigame`` — the twin of the reference's
  ``tests/test_multigame.py:69-97``: two games across the fleet,
  ``DeviceFrameReplay`` with host PER (locked sample and dispatch, the
  write-back under the server's lock); ``eval_per_game`` has both games;
- ``host_multistream`` — ``replay.device_resident=false``:
  ``MultiStreamFrameReplay`` through the ``DeviceStager``;
- ``r2d2_cartpole`` — the small r2d2 CartPole configuration of
  ``tests/test_rpc_r2d2.py:17-38``: ``SequenceReplay`` with PER;
- ``r2d2_ring`` and ``r2d2_fused`` — the r2d2 preset on SignalAtari at
  36×36: ``DeviceSequenceReplay`` by the ring step, and by the chained
  fused dispatch (``replay.device_per=true``).

Each run checks what the reference's end-to-end tests check: the learner
took exactly ``total_steps`` grad steps, the loss is finite, the fleet
delivered at least ``learn_start`` env steps, no actor was restarted and
no frame failed its checksum. The refusals (settings the port's topology
does not run) raise by name before any actor process is spawned. Every
test carries a deadline of its own.
"""

import contextlib
import io
import json
import math
import signal

import numpy as np
import pytest
import torch

from distributed_deep_q_tpu_torch import config as port_config
from distributed_deep_q_tpu_torch.actors import supervisor as sup_mod
from distributed_deep_q_tpu_torch.main import main

TIMEOUT_S = 150
SIGNAL36 = ["env.kind=signal_atari", "env.id=signal", "env.frame_shape=36,36",
            "net.frame_shape=36,36", "net.compute_dtype=float32",
            "train.eval_episodes=2", "actors.num_actors=2"]
PIXEL = SIGNAL36 + ["replay.capacity=4096", "replay.batch_size=16",
                    "replay.learn_start=300", "replay.n_step=2",
                    "replay.write_chunk=16", "train.total_steps=60",
                    "train.target_update_period=10", "actors.send_batch=20",
                    "actors.param_sync_period=25"]
R2D2_SMALL = ["env.id=CartPole-v1", "env.kind=gym", "env.stack=1",
              "env.reward_clip=0", "net.torso=mlp", "net.hidden=32",
              "net.lstm_size=16", "net.compute_dtype=float32",
              "replay.sequence_length=8", "replay.burn_in=4",
              "replay.batch_size=8", "replay.capacity=2048",
              "replay.learn_start=48", "actors.num_actors=2",
              "actors.send_batch=8", "actors.param_sync_period=20",
              "train.total_steps=40", "train.eval_episodes=2"]
R2D2_PIXEL = SIGNAL36 + ["net.lstm_size=16", "replay.sequence_length=16",
                         "replay.burn_in=4", "replay.batch_size=8",
                         "replay.capacity=2048", "replay.learn_start=256",
                         "train.total_steps=40", "actors.send_batch=24",
                         "actors.param_sync_period=20"]
RUNS = {
    "fused_per": ("pong", PIXEL + ["train.use_pallas_loss=true"]),
    "ring_multigame": ("pong", PIXEL + ["replay.device_per=false",
                                        "replay.priority_alpha=0.6"]),
    "host_multistream": ("breakout", PIXEL + [
        "replay.device_resident=false", "replay.prioritized=false"]),
    "r2d2_cartpole": ("r2d2", R2D2_SMALL),
    "r2d2_ring": ("r2d2", R2D2_PIXEL),
    "r2d2_fused": ("r2d2", R2D2_PIXEL + ["replay.device_per=true",
                                         "replay.fused_chain=4"]),
}
BRANCH = {"fused_per": "DevicePERFrameReplay",
          "ring_multigame": "DeviceFrameReplay",
          "host_multistream": "MultiStreamFrameReplay",
          "r2d2_cartpole": "SequenceReplay",
          "r2d2_ring": "DeviceSequenceReplay",
          "r2d2_fused": "DeviceSequenceReplay"}


@pytest.fixture(autouse=True)
def _deadline():
    def expire(signum, frame):
        raise TimeoutError(f"test exceeded its {TIMEOUT_S} s deadline")

    prev = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, TIMEOUT_S)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, prev)


def _cfg(preset, overrides):
    cfg = port_config.PRESETS[preset]()
    cfg.mesh.backend = "cpu"
    return port_config.apply_overrides(cfg, overrides)


def _check(summary, cfg):
    assert summary["grad_steps"] == cfg.train.total_steps
    assert math.isfinite(summary["loss"])
    assert summary["env_steps"] >= cfg.replay.learn_start
    assert summary["actor_restarts"] == 0
    assert summary["rpc_checksum_errors"] == 0
    assert summary["rpc_dispatch_errors"] == 0
    assert math.isfinite(summary["eval_return"])
    assert summary["env_steps_per_s"] > 0


@pytest.mark.parametrize("run", list(RUNS))
def test_train_distributed_end_to_end(run):
    torch.set_num_threads(2)
    cfg = _cfg(*RUNS[run])
    if run == "ring_multigame":
        # (``--set`` cannot fill an empty tuple field)
        cfg.env.games = ("signal", "signal-h")
    summary = sup_mod.train_distributed(cfg, log_every=20)
    _check(summary, cfg)
    assert summary["solver"].step == cfg.train.total_steps
    assert type(summary["replay"]).__name__ == BRANCH[run]
    if run == "ring_multigame":
        assert set(summary["eval_per_game"]) == {"signal", "signal-h"}
        assert all(np.isfinite(v) for v in summary["eval_per_game"].values())


def test_cli_trains_cartpole_distributed():
    """``main train --distributed --preset cartpole --backend cpu`` (the
    flag the port used to refuse): the summary line keeps the reference's
    keys."""
    torch.set_num_threads(2)
    overrides = ["train.total_steps=150", "replay.learn_start=200",
                 "replay.batch_size=32", "actors.num_actors=2",
                 "actors.send_batch=16", "actors.param_sync_period=50",
                 "train.eval_episodes=2"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(["train", "--distributed", "--preset", "cartpole",
                   "--backend", "cpu", "--log-every", "50", "--set",
                   *overrides])
    assert rc == 0
    summary = json.loads(out.getvalue().strip().splitlines()[-1])
    assert summary["mode"] == "train"
    for key in ("env_steps", "actor_restarts", "actor_kill_escalations",
                "rpc_dispatch_errors", "rpc_duplicate_flushes",
                "rpc_shed_flushes", "rpc_checksum_errors",
                "flow_degraded_trips", "eval_return"):
        assert key in summary, key
    _check(summary, _cfg("cartpole", overrides))


def test_evaluate_per_game_single_and_multi():
    """Twin of the reference's ``tests/test_multigame.py`` case."""
    from distributed_deep_q_tpu_torch.solver import Solver
    from distributed_deep_q_tpu_torch.train import evaluate_per_game

    cfg = port_config.Config()
    cfg.mesh.backend = "cpu"
    cfg.env = port_config.EnvConfig(id="signal", kind="signal_atari",
                                    games=("signal", "signal-h"),
                                    frame_shape=(36, 36), stack=4)
    cfg.net = port_config.NetConfig(kind="nature_cnn", num_actions=4,
                                    frame_shape=(36, 36),
                                    compute_dtype="float32")
    cfg.train.eval_episodes = 2
    solver = Solver(cfg)
    out = evaluate_per_game(solver, cfg)
    assert set(out) == {"signal", "signal-h"}
    assert all(np.isfinite(v) for v in out.values())
    cfg.env.games = ()
    assert set(evaluate_per_game(solver, cfg)) == {"signal"}


@pytest.mark.parametrize("override,name", [
    ("inference.enabled=true", "inference.enabled"),
    ("actors.vector_envs=4", "actors.vector_envs"),
    ("autoscale.enabled=true", "autoscale.enabled"),
    ("train.learn_metrics=true", "train.learn_metrics"),
    ("replay.persist_path=replay.npz", "replay.persist_path"),
    ("mesh.num_processes=2", "ROADMAP A14"),
])
@pytest.mark.parametrize("preset", ["pong", "r2d2"])
def test_refusals_come_before_any_actor_is_spawned(override, name, preset,
                                                   monkeypatch):
    def spawn(self, i):
        raise AssertionError("an actor was spawned before the refusal")

    monkeypatch.setattr(sup_mod.ActorSupervisor, "_spawn", spawn)
    cfg = _cfg(preset, SIGNAL36 + [override])
    with pytest.raises((NotImplementedError, ValueError), match=name):
        sup_mod.train_distributed(cfg)
