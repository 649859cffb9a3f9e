"""Single-process training loop (port of the reference ``train.py``'s
``train_single_process`` and ``evaluate``).

One process hosts actor + replay + learner on one device. The env steps on
the host; what happens to a transition depends on the env and the replay
settings, as in the reference:

- pixel env, ``replay.device_resident`` and ``prioritized`` and
  ``device_per``: frames go to the device ring in chunks and every
  ``train_every`` env steps the fused device-PER dispatch
  (``FusedStepStream``) samples, trains and updates priorities on the
  device;
- pixel env, ``device_resident`` otherwise: frames go to the device ring,
  the host samples index batches (uniform, or from per-slot sum trees) and
  the step gathers the stacks on the device (``train_step_from_ring``);
- pixel env, ``device_resident=false``: frames stay in a host
  ``FrameStackReplay``, and whole pixel batches go to the device
  (``train_step``);
- vector env (CartPole): n-step transitions in a host ``ReplayMemory``
  (``train_step``).

Host-sampled prioritized replay gets its priorities back through a
``DelayedPriorityWriteback``. Configurations outside the port are refused
with the ROADMAP item that will port them.
"""

from __future__ import annotations

import numpy as np
import torch

from distributed_deep_q_tpu_torch.actors.game import (
    FrameStacker, NStepAccumulator, make_env)
from distributed_deep_q_tpu_torch.config import Config
from distributed_deep_q_tpu_torch.metrics import Metrics, MovingAverage
from distributed_deep_q_tpu_torch.profiling import StepTimer
from distributed_deep_q_tpu_torch.replay.device_per import DevicePERFrameReplay
from distributed_deep_q_tpu_torch.replay.device_ring import DeviceFrameReplay
from distributed_deep_q_tpu_torch.replay.prioritized import (
    make_writeback, maybe_prioritize)
from distributed_deep_q_tpu_torch.replay.replay_memory import (
    FrameStackReplay, ReplayMemory)
from distributed_deep_q_tpu_torch.solver import FusedStepStream, Solver


def epsilon_at(step: int, cfg) -> float:
    """Linear ε anneal (Nature-DQN style single-actor schedule)."""
    frac = min(step / max(cfg.eps_decay_steps, 1), 1.0)
    return cfg.eps_start + frac * (cfg.eps_end - cfg.eps_start)


def evaluate(solver: Solver, cfg: Config, episodes: int | None = None,
             seed: int = 10_000) -> float:
    """Greedy-policy rollouts (ε=eval_eps) → mean episode return."""
    env = make_env(cfg.env, seed=seed)
    rng = np.random.default_rng(seed)
    episodes = episodes or cfg.train.eval_episodes
    pixel_env = env.obs_dtype == np.uint8
    stacker = FrameStacker(env.obs_shape, cfg.env.stack) if pixel_env else None
    returns = []
    for _ in range(episodes):
        obs, ep_ret, over = env.reset(), 0.0, False
        if stacker:
            obs = stacker.reset(obs)
        while not over:
            a = solver.act(obs, cfg.actors.eval_eps, rng)
            frame, r, _, over = env.step(a)
            obs = stacker.push(frame) if stacker else frame
            ep_ret += r
        returns.append(ep_ret)
    return float(np.mean(returns))


def check_slice(cfg: Config) -> None:
    """Refuse, by name, the settings this port does not run yet."""
    refusals = [
        (cfg.net.kind == "r2d2", "net.kind=r2d2 (ROADMAP A13: R2D2)"),
        (bool(cfg.train.checkpoint_dir) or cfg.train.resume,
         "checkpoints (train.checkpoint_dir/resume; ROADMAP A7)"),
        (bool(cfg.replay.persist_path),
         "replay persistence (replay.persist_path; ROADMAP A10)"),
        (bool(cfg.train.profile_dir) or bool(cfg.train.profile_port),
         "profiling (train.profile_dir/profile_port; ROADMAP A9)"),
    ]
    for refused, what in refusals:
        if refused:
            raise NotImplementedError(f"not ported yet: {what}")


def make_replay(cfg: Config, env, device: torch.device):
    """The replay the reference builds for this env and these settings
    (see the module docstring)."""
    seed = cfg.train.seed
    if env.obs_dtype != np.uint8:
        return maybe_prioritize(ReplayMemory(
            cfg.replay.capacity, env.obs_shape, np.float32, seed=seed),
            cfg.replay, seed=seed)
    if not cfg.replay.device_resident:
        return maybe_prioritize(FrameStackReplay(
            cfg.replay.capacity, env.obs_shape, cfg.env.stack,
            cfg.replay.n_step, cfg.train.gamma, seed=seed),
            cfg.replay, seed=seed)
    kind = (DevicePERFrameReplay
            if cfg.replay.prioritized and cfg.replay.device_per
            else DeviceFrameReplay)
    return kind(cfg.replay, device, env.obs_shape, cfg.env.stack,
                cfg.train.gamma, seed=seed,
                write_chunk=cfg.replay.write_chunk)


def train_single_process(cfg: Config, metrics: Metrics | None = None,
                         log_every: int = 1_000) -> dict:
    """Run the in-process loop; returns final summary metrics (and the
    solver under ``"solver"``)."""
    check_slice(cfg)
    metrics = metrics or Metrics()
    env = make_env(cfg.env, seed=cfg.train.seed)
    cfg.net.num_actions = env.num_actions
    obs_dim = int(np.prod(env.obs_shape))
    solver = Solver(cfg, obs_dim=obs_dim)
    rng = np.random.default_rng(cfg.train.seed)
    replay = make_replay(cfg, env, solver.device)
    pixel_env = env.obs_dtype == np.uint8
    if pixel_env:
        stacker = FrameStacker(env.obs_shape, cfg.env.stack)
    else:
        nstep = NStepAccumulator(cfg.replay.n_step, cfg.train.gamma)

    frame = env.reset()
    obs = stacker.reset(frame) if pixel_env else frame
    ep_ret, ep_returns = 0.0, MovingAverage(100)
    summary: dict = {}
    fused_per = isinstance(replay, DevicePERFrameReplay)
    writeback = (make_writeback(replay, cfg.replay)
                 if replay.prioritized and not fused_per else None)
    learn_live = False
    gsteps = 0
    best_eval, best_params = float("-inf"), None
    timer = StepTimer()
    fused_stream = (FusedStepStream(solver, replay, cfg.replay.fused_chain,
                                    timer=timer) if fused_per else None)

    for t in range(1, cfg.train.total_steps + 1):
        eps = epsilon_at(t, cfg.actors)
        a = solver.act(obs, eps, rng)
        next_frame, r, done, over = env.step(a)
        ep_ret += r
        if pixel_env:
            # frame (pre-action), action, reward, done; boundary marks any
            # episode end incl. truncation so stacks/windows never cross it
            replay.add(frame, a, r, done, boundary=over)
            frame = next_frame
            obs = stacker.push(frame)
        else:
            for tr in nstep.push(obs, a, r, next_frame, done):
                replay.add(*tr)
            obs = next_frame
        metrics.count("env_steps")

        if over:
            if not pixel_env and not done:
                # time-limit truncation: flush the n-step tail with
                # bootstrap instead of discarding the episode's end
                for tr in nstep.flush_truncated(next_frame):
                    replay.add(*tr)
            ep_returns.add(ep_ret)
            ep_ret = 0.0
            frame = env.reset()
            if pixel_env:
                obs = stacker.reset(frame)
            else:
                obs = frame
                nstep.reset()

        if t % cfg.train.train_every == 0 and not learn_live:
            learn_live = replay.ready(cfg.replay.learn_start)
        if learn_live and t % cfg.train.train_every == 0:
            # learn phase: j minibatches per k env steps; the fused path
            # chains up to fused_chain of them per dispatch
            for j in range(cfg.train.grad_steps_per_train):
                if fused_per:
                    m = fused_stream.next(cfg.train.grad_steps_per_train - j)
                else:
                    with timer.phase("sample"):
                        batch = replay.sample(cfg.replay.batch_size)
                    sampled_at = batch.pop("_sampled_at",
                                           replay.steps_added)
                    with timer.phase("dispatch"):
                        if isinstance(replay, DeviceFrameReplay):
                            m = solver.train_step_from_ring(
                                replay.ring, batch, replay.frame_shape)
                        else:
                            m = solver.train_step(batch)
                gsteps += 1
                timer.step_done()
                if writeback is not None:
                    # |TD| is copied to the host at dispatch and applied
                    # depth steps later: the loop never waits on it
                    with timer.phase("writeback"):
                        writeback.push(m["index"], m["td_abs"], sampled_at)
                metrics.count("grad_steps")
                if gsteps % log_every == 0:
                    timer.measure_device(m["loss"])
                    summary = {
                        "loss": float(m["loss"]),
                        "q_mean": float(m["q_mean"]),
                        "return_avg100": ep_returns.value, "epsilon": eps,
                        "grad_steps_per_s": metrics.rate("grad_steps"),
                        "env_steps_per_s": metrics.rate("env_steps"),
                    }
                    metrics.gauge("queue/replay_size", len(replay))
                    pending = getattr(replay, "pending_rows", None)
                    if pending is not None:
                        metrics.gauge("queue/staged_rows", pending())
                    metrics.log(gsteps, **summary, **timer.summary(),
                                **metrics.telemetry())

        if cfg.train.eval_every and t % cfg.train.eval_every == 0:
            ret = evaluate(solver, cfg)
            metrics.log(gsteps, eval_return=ret)
            if cfg.train.keep_best_eval and ret > best_eval:
                best_eval = ret
                best_params = [w.copy() for w in solver.get_weights()]

    if writeback is not None:
        writeback.drain()  # apply the depth-queued priority tail
    summary["final_return_avg100"] = ep_returns.value
    summary["grad_steps"] = gsteps
    final_ret = evaluate(solver, cfg)
    if best_params is not None and best_eval > final_ret:
        # model selection: the best-eval snapshot beats the final params
        solver.update(best_params)
        final_ret = evaluate(solver, cfg)
    summary["eval_return"] = final_ret
    summary["solver"] = solver
    if solver.device.type == "cuda":
        torch.cuda.synchronize(solver.device)
    return summary
