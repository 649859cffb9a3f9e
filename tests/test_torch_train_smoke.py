"""The port's CLI end to end on the CPU (the Pong preset's fused path, the
CartPole preset, the Breakout preset's host-sampled paths), its device
switch, its refusals, and the rule that it imports nothing of JAX or the
reference package."""

import ast
import contextlib
import io
import json
import math
from pathlib import Path

import pytest
import torch

from distributed_deep_q_tpu_torch.main import main

REPO = Path(__file__).resolve().parents[1]

# the verify recipe's fused device-PER overrides (36×36 frames, small ring)
RECIPE = ["env.kind=signal_atari", "env.id=signal", "env.frame_shape=36,36",
          "net.frame_shape=36,36", "net.compute_dtype=float32",
          "replay.capacity=4096", "replay.batch_size=16",
          "replay.learn_start=300", "replay.write_chunk=16",
          "train.target_update_period=20", "actors.eps_decay_steps=400"]


def _run(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, json.loads(out.getvalue().strip().splitlines()[-1])


def test_cli_trains_pong_preset_on_cpu():
    """``train --preset pong --backend cpu``: 800 env steps, 125 grad
    steps of the fused device-PER dispatch; prints one JSON summary."""
    torch.set_num_threads(1)
    rc, summary = _run(["train", "--preset", "pong", "--backend", "cpu",
                        "--log-every", "25", "--set", *RECIPE,
                        "train.total_steps=800", "train.train_every=4"])
    assert rc == 0 and summary["mode"] == "train"
    assert summary["grad_steps"] == (800 - 300) // 4 + 1
    for key in ("loss", "q_mean", "grad_steps_per_s", "env_steps_per_s",
                "eval_return"):
        assert math.isfinite(summary[key]), key
    assert summary["eval_return"] >= 0


def test_cli_eval_on_cpu():
    torch.set_num_threads(1)
    rc, out = _run(["eval", "--preset", "pong", "--backend", "cpu", "--set",
                    *RECIPE, "train.eval_episodes=2"])
    assert rc == 0 and out["mode"] == "eval" and out["episodes"] == 2
    assert 0 <= out["eval_return"] <= 32


def test_backend_cuda_raises_without_a_card():
    """No CPU fallback: ``--backend cuda`` on a machine without a card
    raises. (Where a card is present this case has nothing to check.)"""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="backend cuda"):
        main(["train", "--preset", "pong", "--backend", "cuda", "--set",
              *RECIPE, "train.total_steps=10"])


@pytest.mark.parametrize("override", [
    # r2d2 runs; its learner refuses the settings the port leaves out
    pytest.param("net.kind=r2d2 train.learn_metrics=true",
                 id="net.kind=r2d2"),
    "train.profile_port=6006", "mesh.num_processes=2", "mesh.dp=2",
    "train.optimizer=rmsprop", "train.learn_metrics=true"])
def test_out_of_slice_configs_are_refused(override):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        main(["train", "--preset", "pong", "--backend", "cpu", "--set",
              *RECIPE, "train.total_steps=10", *override.split()])


def test_train_recurrent_checks_the_slice_when_called_directly():
    """``train_recurrent`` is an entry point of its own (the reference's
    R2D2 tests call it directly): it refuses what the port leaves out
    before it builds anything."""
    from distributed_deep_q_tpu_torch.config import r2d2_config
    from distributed_deep_q_tpu_torch.train import train_recurrent

    cfg = r2d2_config()
    cfg.mesh.backend = "cpu"
    cfg.env.kind, cfg.env.id = "signal_atari", "signal"
    cfg.train.profile_port = 6006
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        train_recurrent(cfg)


def test_cli_trains_cartpole_preset_on_cpu():
    """``train --preset cartpole --backend cpu`` (the CLI's default preset):
    a dueling MLP on the host ``ReplayMemory`` with 3-step transitions,
    1,499 grad steps (the replay holds 500 transitions from env step 502
    on: 3-step transitions mature two steps late); its greedy eval beats
    the random policy (≈ 9.3)."""
    torch.set_num_threads(1)
    rc, summary = _run(["train", "--preset", "cartpole", "--backend", "cpu",
                        "--log-every", "500", "--set",
                        "train.total_steps=2000", "replay.learn_start=500",
                        "actors.eps_decay_steps=1000"])
    assert rc == 0 and summary["grad_steps"] == 2000 - 502 + 1
    assert math.isfinite(summary["loss"])
    assert summary["eval_return"] > 50, summary


@pytest.mark.parametrize("replay_override", [
    "replay.device_per=false", "replay.device_resident=false",
    "replay.prioritized=false"])
def test_cli_trains_host_sampled_breakout_on_cpu(replay_override):
    """The Breakout preset's host-sampled paths on ``fake_atari`` at 36×36,
    with the fused TD loss: the device ring with per-slot sum trees
    (``device_per=false``), the host ``FrameStackReplay``
    (``device_resident=false``), and uniform sampling from the device ring
    (``prioritized=false``)."""
    torch.set_num_threads(1)
    rc, summary = _run(["train", "--preset", "breakout", "--backend", "cpu",
                        "--log-every", "25", "--set",
                        "env.kind=fake_atari", "env.frame_shape=36,36",
                        "net.frame_shape=36,36", "net.compute_dtype=float32",
                        "replay.capacity=2048", "replay.batch_size=16",
                        "replay.learn_start=300", "replay.write_chunk=16",
                        "train.total_steps=500", "train.train_every=4",
                        "train.use_pallas_loss=true", replay_override])
    assert rc == 0 and summary["grad_steps"] == (500 - 300) // 4 + 1
    for key in ("loss", "q_mean", "grad_steps_per_s", "eval_return"):
        assert math.isfinite(summary[key]), key


def test_cli_evals_cartpole_preset_on_cpu():
    torch.set_num_threads(1)
    rc, out = _run(["eval", "--preset", "cartpole", "--backend", "cpu",
                    "--set", "train.eval_episodes=2"])
    assert rc == 0 and out["episodes"] == 2 and out["eval_return"] > 0


@pytest.mark.slow
def test_cli_cartpole_preset_reaches_500():
    """The preset's own bar: 500/500 within its 30k steps."""
    torch.set_num_threads(1)
    rc, summary = _run(["train", "--preset", "cartpole", "--backend", "cpu",
                        "--log-every", "2500"])
    assert rc == 0 and summary["eval_return"] >= 500, summary


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_imports_no_jax_and_no_reference_package():
    """Walks the sources (not ``sys.modules``: another test may already
    have imported jax in this process)."""
    files = sorted((REPO / "distributed_deep_q_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    names = {str(f.relative_to(REPO)) for f in files}
    for module in ("utils/checkpoint.py", "utils/durability.py",
                   "replay/persistence.py", "actors/game.py", "main.py"):
        assert f"distributed_deep_q_tpu_torch/{module}" in names, module
    banned = {"jax", "jaxlib", "flax", "optax", "distributed_deep_q_tpu"}
    for f in files:
        assert not (_imported_roots(f) & banned), f
