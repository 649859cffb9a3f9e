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
  fused dispatch (``replay.device_per=true``);
- ``fused_per_served`` — ``fused_per`` with ``inference.enabled=true
  actors.vector_envs=2``: two vectorized actor processes whose greedy
  actions come from the learner's ``InferenceServer`` (its
  ``BatchedPolicy`` on the CPU here), four replay streams;
- ``fused_per_vector`` — ``vector_envs=2`` with local inference;
- ``fused_per_autoscale`` — the health plane on and the autoscaler with
  its executor in ``dry_run``.

Each run checks what the reference's end-to-end tests check: the learner
took exactly ``total_steps`` grad steps, the loss is finite, the fleet
delivered at least ``learn_start`` env steps, no actor was restarted and
no frame failed its checksum; with the inference plane up, the fleet
made ``infer`` requests and pulled no θ. The refusals (settings the
port's topology does not run) raise by name before any actor process is
spawned; the settings the port used to refuse (``inference.enabled``,
``actors.vector_envs``, ``autoscale.enabled``) bring their planes up on
the Pong preset and leave the recurrent actors acting locally on r2d2,
as the reference does. Every test carries a deadline of its own.
"""

import contextlib
import io
import json
import math
import signal
import threading

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
    "fused_per_served": ("pong", PIXEL + ["train.use_pallas_loss=true",
                                          "inference.enabled=true",
                                          "actors.vector_envs=2"]),
    "fused_per_vector": ("pong", PIXEL + ["actors.vector_envs=2"]),
    "fused_per_autoscale": ("pong", PIXEL + [
        "health.enabled=true", "autoscale.enabled=true",
        "autoscale.execute=true", "autoscale.dry_run=true"]),
}
BRANCH = {"fused_per": "DevicePERFrameReplay",
          "fused_per_served": "DevicePERFrameReplay",
          "fused_per_vector": "DevicePERFrameReplay",
          "fused_per_autoscale": "DevicePERFrameReplay",
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


@pytest.fixture(autouse=True)
def _restore_health_plane(monkeypatch):
    # train_distributed switches the process-wide health plane on or off
    # from its cfg; put it back for the next test
    monkeypatch.setattr(sup_mod.health, "ENABLED", sup_mod.health.ENABLED)


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
    if not run.startswith("r2d2"):   # one replay stream per env row
        assert summary["replay"].num_streams == 2 * max(
            int(cfg.actors.vector_envs), 1)
    if cfg.inference.enabled:
        assert summary["inference_requests"] > 0
        assert summary["inference_param_pulls"] == 0
        assert 1 <= summary["inference_compiled_buckets"] <= len(
            cfg.inference.buckets)
    else:
        assert "inference_requests" not in summary
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
    # no longer refused (ROADMAP A12): the first thing to stop this run is
    # the patched spawn, so nothing refused it before the fleet came up
    ("train.learn_metrics=true", "an actor was spawned"),
    ("replay.persist_path=replay.npz", "replay.persist_path"),
    # more than one process runs now (ROADMAP A14b), but only in a
    # process that joined their group: never as one process
    ("mesh.num_processes=2", "initialize_multihost"),
    ("mesh.model=2", "model axis"),
])
@pytest.mark.parametrize("preset", ["pong", "r2d2"])
def test_refusals_come_before_any_actor_is_spawned(override, name, preset,
                                                   monkeypatch):
    def spawn(self, i):
        raise AssertionError("an actor was spawned before the refusal")

    monkeypatch.setattr(sup_mod.ActorSupervisor, "_spawn", spawn)
    cfg = _cfg(preset, SIGNAL36 + [override])
    with pytest.raises((NotImplementedError, ValueError, AssertionError),
                       match=name):
        sup_mod.train_distributed(cfg)


class _Gate(Exception):
    """Raised at the learn gate: the planes are up, nothing trained."""


def _bring_up(preset, overrides, monkeypatch):
    """``train_distributed`` up to its learn gate, no actor spawned; what
    came up: the replay, the inference server (and its port when the
    fleet would have been spawned) and the autoscaler. The planes are
    torn down on the way out, as after a run."""
    seen = {"spawned_with_port": []}
    real_rpc = sup_mod._bring_up_rpc_plane
    real_auto = sup_mod._bring_up_autoscaler

    def spawn(self, i):
        seen["spawned_with_port"].append(self.cfg.inference.port)

    def rpc(cfg, replay, *args, **kwargs):
        server, sup, infer = real_rpc(cfg, replay, *args, **kwargs)
        seen.update(replay=replay, infer_server=infer)
        return server, sup, infer

    def auto(*args):
        seen["scaler"], seen["executor"] = real_auto(*args)
        return seen["scaler"], seen["executor"]

    def gate(*args):
        raise _Gate

    monkeypatch.setattr(sup_mod.ActorSupervisor, "_spawn", spawn)
    monkeypatch.setattr(sup_mod, "_bring_up_rpc_plane", rpc)
    monkeypatch.setattr(sup_mod, "_bring_up_autoscaler", auto)
    monkeypatch.setattr(sup_mod, "_wait_for_fill", gate)
    cfg = _cfg(preset, SIGNAL36 + overrides)
    with pytest.raises(_Gate):
        sup_mod.train_distributed(cfg)
    return cfg, seen


def _actor_branch(cfg, monkeypatch) -> list[str]:
    """Which acting path ``actor_main`` takes under ``cfg`` (one actor in
    this thread, its loops stubbed, against a small replay server)."""
    from distributed_deep_q_tpu_torch.replay.replay_memory import (
        ReplayMemory)
    from distributed_deep_q_tpu_torch.rpc.replay_server import (
        ReplayFeedServer)

    taken: list[str] = []

    class _Remote:
        def __init__(self, *args, **kwargs):
            taken.append("remote inference")

        def action(self, obs):
            raise ConnectionError("stubbed")

        def close(self):
            pass

    monkeypatch.setattr(sup_mod, "_RemoteInference", _Remote)
    monkeypatch.setattr(sup_mod, "_vector_actor_loop",
                        lambda *a, **k: taken.append("vector"))
    monkeypatch.setattr(sup_mod, "_recurrent_actor_loop",
                        lambda *a, **k: taken.append("recurrent"))
    server = ReplayFeedServer(ReplayMemory(64, (4,), np.float32))
    try:
        sup_mod.actor_main(cfg, *server.address, 0, threading.Event(),
                           max_env_steps=64)
    finally:
        server.close()
    return taken


@pytest.mark.parametrize("override", ["inference.enabled=true",
                                      "actors.vector_envs=4",
                                      "autoscale.enabled=true"])
@pytest.mark.parametrize("preset", ["pong", "r2d2"])
def test_lifted_settings_bring_their_planes_up(preset, override,
                                              monkeypatch):
    """In place of the refusals the port used to raise: on Pong each
    setting brings its plane up (the autoscaler only with the health plane
    on); on r2d2 the inference and vector planes stay down and recurrent
    actors act locally, while the autoscaler comes up as on Pong."""
    cfg, seen = _bring_up(preset, [override], monkeypatch)
    infer = seen["infer_server"]
    if override.startswith("inference") and preset == "pong":
        assert type(infer).__name__ == "InferenceServer"
        assert infer.policy.device.type == "cpu"   # the solver's device
        # the fleet learns the bound address through the pickled cfg
        assert seen["spawned_with_port"] == [infer.address[1]] * 2
        assert infer._closed                      # torn down with the run
    else:
        assert infer is None
    v = int(cfg.actors.vector_envs)
    if preset == "pong":
        assert seen["replay"].num_streams == 2 * max(v, 1)
    if override.startswith("autoscale"):
        assert seen["scaler"] is None              # the health plane is off
        _, seen = _bring_up(preset, [override, "health.enabled=true"],
                            monkeypatch)
        assert type(seen["scaler"]).__name__ == "Autoscaler"
        assert seen["executor"] is None            # autoscale.execute off
        return
    branch = _actor_branch(cfg, monkeypatch)
    if preset == "r2d2":
        assert branch == ["recurrent"]
    elif override.startswith("inference"):
        assert branch == ["remote inference"]
    else:
        assert branch == ["vector"]


def test_vector_envs_on_cartpole_refused_before_any_spawn(monkeypatch):
    def spawn(self, i):
        raise AssertionError("an actor was spawned before the refusal")

    monkeypatch.setattr(sup_mod.ActorSupervisor, "_spawn", spawn)
    cfg = _cfg("cartpole", ["actors.vector_envs=2"])
    with pytest.raises(ValueError, match="pixel acting path"):
        sup_mod.train_distributed(cfg)
