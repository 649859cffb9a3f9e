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
  (``train_step``);
- ``net.kind=r2d2``: the recurrent loop ``train_recurrent`` (sequences
  from a ``SequenceBuilder`` into a ``DeviceSequenceReplay`` for pixels,
  or a host ``SequenceReplay``).

Host-sampled prioritized replay gets its priorities back through a
``DelayedPriorityWriteback``. Both loops checkpoint the train state every
``train.checkpoint_every`` grad steps and at the end
(``utils/checkpoint.py``), save the replay beside it when
``replay.persist_path`` is set (``replay/persistence.py``), and restore
both before the first step on ``train.resume``. Configurations outside the
port are refused with the ROADMAP item that will port them.

More than one learner process (``mesh.num_processes``,
``parallel/multihost.py``): every process runs the same loop, its own env
(seed offset ``131·process_id``) feeding its own replay, sampling its
``B / num_processes`` rows into a train step whose gradient mean spans the
processes. The learn gate opens on every process at once
(``all_processes_ready``); only process 0 keeps metrics sinks and writes
checkpoints; each process persists its replay to ``{path}.proc{pid}``.
Pixel runs need a host replay there (``replay.device_resident=false``),
and the device sequence ring is not persisted, both as in the reference.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from distributed_deep_q_tpu_torch import learning
from distributed_deep_q_tpu_torch.actors.game import (
    FrameStacker, NStepAccumulator, make_env)
from distributed_deep_q_tpu_torch.config import Config
from distributed_deep_q_tpu_torch.metrics import Metrics, MovingAverage
from distributed_deep_q_tpu_torch.parallel import mesh
from distributed_deep_q_tpu_torch.parallel.multihost import (
    all_processes_ready, local_rows)
from distributed_deep_q_tpu_torch.parallel.sequence_learner import (
    SequenceSolver)
from distributed_deep_q_tpu_torch.profiling import (
    StepTimer, TraceWindow, check_profile_port)
from distributed_deep_q_tpu_torch.replay.device_per import DevicePERFrameReplay
from distributed_deep_q_tpu_torch.replay.device_ring import DeviceFrameReplay
from distributed_deep_q_tpu_torch.replay.device_sequence import (
    DeviceSequenceReplay)
from distributed_deep_q_tpu_torch.replay.persistence import (
    load_replay, save_replay)
from distributed_deep_q_tpu_torch.replay.prioritized import (
    make_writeback, maybe_prioritize)
from distributed_deep_q_tpu_torch.replay.replay_memory import (
    FrameStackReplay, ReplayMemory)
from distributed_deep_q_tpu_torch.replay.sequence import (
    SequenceBuilder, SequenceReplay)
from distributed_deep_q_tpu_torch.solver import FusedStepStream, Solver
from distributed_deep_q_tpu_torch.utils.checkpoint import maybe_checkpointer


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


def evaluate_per_game(solver, cfg: Config, episodes: int | None = None,
                      seed: int = 10_000, recurrent: bool = False,
                      ) -> dict[str, float]:
    """Greedy eval on every configured game (multi-game fleets):
    ``{game_id: mean return}``; single-game configs return one entry."""
    fn = evaluate_recurrent if recurrent else evaluate
    out = {}
    for g in (cfg.env.games or (cfg.env.id,)):
        gcfg = cfg.replace(env=dataclasses.replace(cfg.env, id=g))
        out[g] = fn(solver, gcfg, episodes, seed)
    return out


def log_final_eval(solver, cfg: Config, metrics: Metrics, summary: dict,
                   recurrent: bool = False) -> float:
    """Final greedy eval across all configured games: fills ``summary``
    (``eval_return`` mean, ``eval_per_game`` when multi-game) and logs
    per-game metrics. Shared by the distributed loops."""
    per_game = evaluate_per_game(solver, cfg, recurrent=recurrent)
    summary["eval_return"] = float(np.mean(list(per_game.values())))
    if len(per_game) > 1:
        summary["eval_per_game"] = per_game
        metrics.log(cfg.train.total_steps,
                    **{f"eval_return/{g}": v for g, v in per_game.items()})
    return summary["eval_return"]


def check_slice(cfg: Config) -> None:
    """Refuse, by name, the settings this port does not run."""
    check_profile_port(cfg.train.profile_port)


def trace_window(cfg: Config) -> TraceWindow:
    """The loop's ``torch.profiler`` window (off unless
    ``train.profile_dir`` is set), stepped once per grad step."""
    return TraceWindow(cfg.train.profile_dir, cfg.train.profile_start_step,
                       cfg.train.profile_num_steps)


def persist_path(cfg: Config) -> str:
    """Where this process persists its replay: ``replay.persist_path``, or
    ``{path}.proc{pid}`` with more than one process (a shared path would
    race on save and clone one process's replay onto every process on
    resume)."""
    persist = cfg.replay.persist_path
    if persist and cfg.mesh.num_processes > 1:
        persist = f"{persist}.proc{cfg.mesh.process_id}"
    return persist


def restore_for_resume(cfg: Config, solver, replay, persist: str):
    """The resume points both loops share: the newest checkpoint into
    ``solver`` (on every process, then made process 0's bit for bit) and
    the persisted replay at ``persist`` into ``replay``, each only on
    ``train.resume`` and when there is one. Returns (the checkpointer or
    None, the grad-step count to continue from)."""
    gsteps = 0
    ckpt = maybe_checkpointer(cfg.train)
    if ckpt and cfg.train.resume and ckpt.latest_step() is not None:
        # extra (env steps) is read and dropped, as in the reference: the
        # ε schedule and the actor's RNG restart
        solver.state, _ = ckpt.restore(solver.state)
        solver.replicate_state()
        gsteps = solver.step
    if persist and cfg.train.resume and os.path.exists(persist):
        # restore the buffer's exact sampling state instead of
        # warm-refilling
        load_replay(replay, persist)
    return ckpt, gsteps


def save_checkpoint(cfg: Config, ckpt, solver, env_steps: int,
                    wait: bool = False) -> None:
    """Save the train state; process 0 alone writes it (every process
    holds the same state, and one directory takes one writer)."""
    if cfg.mesh.process_id == 0:
        ckpt.save(solver.state, extra={"env_steps": env_steps}, wait=wait)


def make_replay(cfg: Config, env, device: torch.device,
                seed: int | None = None):
    """The replay the reference builds for this env and these settings
    (see the module docstring), its host RNGs seeded from ``seed``
    (default ``train.seed``)."""
    seed = cfg.train.seed if seed is None else seed
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
                write_chunk=cfg.replay.write_chunk,
                num_shards=mesh.num_shards(cfg.mesh),
                local_shards=mesh.local_shards(cfg.mesh))


def train_single_process(cfg: Config, metrics: Metrics | None = None,
                         log_every: int = 1_000) -> dict:
    """Run the in-process loop; returns final summary metrics (and the
    solver and the replay under ``"solver"`` and ``"replay"``)."""
    if cfg.net.kind == "r2d2":
        return train_recurrent(cfg, metrics, log_every)
    check_slice(cfg)
    metrics = metrics or Metrics()
    env = make_env(cfg.env, seed=cfg.train.seed)
    cfg.net.num_actions = env.num_actions
    obs_dim = int(np.prod(env.obs_shape))
    solver = Solver(cfg, obs_dim=obs_dim)
    # the Solver refused a batch that does not split across the processes
    pc, pid = cfg.mesh.num_processes, cfg.mesh.process_id
    local_batch = solver.local_batch
    if pc > 1:
        # decorrelate the processes' experience streams
        env = make_env(cfg.env, seed=cfg.train.seed + 131 * pid)
        if pid != 0:
            metrics = Metrics()  # file sinks live on process 0 only
    seed = cfg.train.seed + 131 * pid
    rng = np.random.default_rng(seed)
    pixel_env = env.obs_dtype == np.uint8
    if pixel_env and cfg.replay.device_resident and pc > 1:
        raise ValueError(
            "replay.device_resident=True is single-controller only (the "
            "host writes frames into a sharded device ring); multi-host "
            "pixel runs need replay.device_resident=false")
    replay = make_replay(cfg, env, solver.device, seed)
    if pixel_env:
        stacker = FrameStacker(env.obs_shape, cfg.env.stack)
    else:
        nstep = NStepAccumulator(cfg.replay.n_step, cfg.train.gamma)

    frame = env.reset()
    obs = stacker.reset(frame) if pixel_env else frame
    ep_ret, ep_returns = 0.0, MovingAverage(100)
    summary: dict = {}
    fused_per = isinstance(replay, DevicePERFrameReplay)
    # with more than one process each writes back its own rows only
    writeback = (make_writeback(replay, cfg.replay,
                                to_host=local_rows if pc > 1 else None)
                 if replay.prioritized and not fused_per else None)
    learn_live = False
    best_eval, best_params = float("-inf"), None
    timer = StepTimer()
    fused_stream = (FusedStepStream(solver, replay, cfg.replay.fused_chain,
                                    timer=timer) if fused_per else None)
    # the learning-dynamics plane: the fused chunks' planes fold into
    # learn/* gauges at log cadence (the health-plane registration is the
    # distributed learner's)
    learn_acc = (learning.LearnAccumulator()
                 if cfg.train.learn_metrics and fused_per else None)
    trace = trace_window(cfg)
    # a resumed fused run draws the keys an unbroken run would: the key
    # schedule anchors on the restored step at the first dispatch
    persist = persist_path(cfg)
    ckpt, gsteps = restore_for_resume(cfg, solver, replay, persist)

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
            # every process's replay warm: a collective AND, at the same
            # loop point on every process (no process steps alone)
            learn_live = all_processes_ready(
                replay.ready(cfg.replay.learn_start))
        if learn_live and t % cfg.train.train_every == 0:
            # learn phase: j minibatches per k env steps; the fused path
            # chains up to fused_chain of them per dispatch
            for j in range(cfg.train.grad_steps_per_train):
                if fused_per:
                    m = fused_stream.next(cfg.train.grad_steps_per_train - j)
                else:
                    with timer.phase("sample"):
                        batch = replay.sample(local_batch)
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
                trace.on_step(gsteps)
                if writeback is not None:
                    # |TD| is copied to the host at dispatch and applied
                    # depth steps later: the loop never waits on it
                    with timer.phase("writeback"):
                        writeback.push(m["index"], m["td_abs"], sampled_at)
                metrics.count("grad_steps")
                if ckpt and gsteps % cfg.train.checkpoint_every == 0:
                    save_checkpoint(cfg, ckpt, solver, t)
                    if persist:
                        save_replay(replay, persist)
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
                    if learn_acc is not None:
                        learning.publish_planes(
                            learn_acc, fused_stream.drain_planes(), metrics)
                    metrics.log(gsteps, **summary, **timer.summary(),
                                **metrics.telemetry(),
                                **solver.dispatch_counters())

        if cfg.train.eval_every and t % cfg.train.eval_every == 0:
            ret = evaluate(solver, cfg)
            metrics.log(gsteps, eval_return=ret)
            if cfg.train.keep_best_eval and ret > best_eval:
                best_eval = ret
                best_params = [w.copy() for w in solver.get_weights()]

    trace.close()
    if writeback is not None:
        writeback.drain()  # apply the depth-queued priority tail
    summary["final_return_avg100"] = ep_returns.value
    summary["grad_steps"] = gsteps
    final_ret = evaluate(solver, cfg)
    if best_params is not None and best_eval > final_ret:
        # model selection: the best-eval snapshot beats the final params;
        # restored BEFORE the final checkpoint, so what is on disk is what
        # eval_return reports
        solver.update(best_params)
        final_ret = evaluate(solver, cfg)
    if ckpt:
        save_checkpoint(cfg, ckpt, solver, cfg.train.total_steps, wait=True)
    if persist:
        save_replay(replay, persist)
    summary["eval_return"] = final_ret
    summary["solver"] = solver
    summary["replay"] = replay
    if solver.device.type == "cuda":
        torch.cuda.synchronize(solver.device)
    return summary


# ---------------------------------------------------------------------------
# The recurrent (R2D2) loop
# ---------------------------------------------------------------------------


def evaluate_recurrent(solver, cfg: Config, episodes: int | None = None,
                       seed: int = 10_000) -> float:
    """Greedy rollouts (ε = eval_eps) threading the LSTM carry through
    each episode → mean episode return."""
    env = make_env(cfg.env, seed=seed)
    rng = np.random.default_rng(seed)
    episodes = episodes or cfg.train.eval_episodes
    pixel = env.obs_dtype == np.uint8
    stacker = FrameStacker(env.obs_shape, cfg.env.stack) if pixel else None
    returns = []
    for _ in range(episodes):
        obs, ep_ret, over = env.reset(), 0.0, False
        if stacker:
            obs = stacker.reset(obs)
        carry = solver.initial_state(1)
        while not over:
            a, carry = solver.act(np.asarray(obs), carry,
                                  cfg.actors.eval_eps, rng)
            frame, r, _, over = env.step(a)
            obs = stacker.push(frame) if stacker else frame
            ep_ret += r
        returns.append(ep_ret)
    return float(np.mean(returns))


def make_sequence_replay(cfg: Config, obs_shape: tuple[int, ...], obs_dtype,
                         device: torch.device):
    """The sequence replay ``train_recurrent`` builds: a
    ``DeviceSequenceReplay`` for (stacked) pixels with
    ``replay.device_resident``, else a host ``SequenceReplay``. Its
    capacity counts sequences: capacity ÷ sequence_length, at least 64."""
    seq_len = cfg.replay.sequence_length
    seq_capacity = max(cfg.replay.capacity // seq_len, 64)
    per = dict(prioritized=cfg.replay.prioritized,
               alpha=cfg.replay.priority_alpha,
               beta0=cfg.replay.priority_beta0,
               beta_steps=cfg.replay.priority_beta_steps,
               eps=cfg.replay.priority_eps, seed=cfg.train.seed,
               use_native=cfg.replay.use_native)
    if obs_dtype == np.uint8 and cfg.replay.device_resident:
        return DeviceSequenceReplay(seq_capacity, seq_len, obs_shape, device,
                                    cfg.net.lstm_size,
                                    num_shards=mesh.num_shards(cfg.mesh),
                                    local_shards=mesh.local_shards(cfg.mesh),
                                    **per)
    return SequenceReplay(seq_capacity, seq_len, obs_shape, obs_dtype,
                          cfg.net.lstm_size, **per)


def train_recurrent(cfg: Config, metrics: Metrics | None = None,
                    log_every: int = 1_000) -> dict:
    """R2D2 loop: recurrent actor → ``SequenceBuilder`` → sequence replay →
    ``SequenceSolver``. Sequence counts derive from the transition-counted
    fields (capacity and learn_start ÷ sequence_length), as in the
    reference. Pixel envs keep their sequences in a
    ``DeviceSequenceReplay`` (``replay.device_resident``) and train by the
    ring step, or, with ``replay.device_per`` and ``prioritized``, by the
    chained fused dispatch; otherwise a host ``SequenceReplay`` ships
    whole sequence batches."""
    check_slice(cfg)
    metrics = metrics or Metrics()
    env = make_env(cfg.env, seed=cfg.train.seed)
    cfg.net.num_actions = env.num_actions
    obs_dim = int(np.prod(env.obs_shape))
    solver = SequenceSolver(cfg, obs_dim=obs_dim)
    if cfg.mesh.process_id != 0:
        metrics = Metrics()  # file sinks live on process 0 only
    rng = np.random.default_rng(cfg.train.seed)

    pixel = env.obs_dtype == np.uint8
    stacker = FrameStacker(env.obs_shape, cfg.env.stack) if pixel else None
    obs_shape = (tuple(env.obs_shape) + (cfg.env.stack,)) if pixel \
        else tuple(env.obs_shape)
    obs_dtype = np.uint8 if pixel else np.float32

    seq_len = cfg.replay.sequence_length
    replay = make_sequence_replay(cfg, obs_shape, obs_dtype, solver.device)
    device_seq = isinstance(replay, DeviceSequenceReplay)
    builder = SequenceBuilder(seq_len, cfg.replay.burn_in, obs_shape,
                              obs_dtype, cfg.net.lstm_size, cfg.train.gamma)
    learn_start_seqs = max(cfg.replay.learn_start // seq_len, 2)

    # the chained fused path samples from the device priority row, so it
    # runs prioritized only, as in the reference
    fused_seq = (device_seq and cfg.replay.device_per
                 and cfg.replay.prioritized)
    timer = StepTimer()
    stream = (FusedStepStream(solver, replay, cfg.replay.fused_chain,
                              timer=timer) if fused_seq else None)
    writeback = (make_writeback(replay, cfg.replay)
                 if replay.prioritized and not fused_seq else None)
    trace = trace_window(cfg)

    frame = env.reset()
    obs = stacker.reset(frame) if pixel else frame
    carry = solver.initial_state(1)
    ep_ret, ep_returns = 0.0, MovingAverage(100)
    summary: dict = {}
    persist = persist_path(cfg)
    if persist and cfg.mesh.num_processes > 1 and device_seq:
        # each process's file would hold its own shards only, and a resume
        # would rebuild a buffer whose sampling state no longer matches
        raise ValueError(
            "replay.persist_path is not supported with a device-resident "
            "DeviceSequenceReplay under multi-process (num_processes="
            f"{cfg.mesh.num_processes}); set replay.device_resident=false "
            "or drop persist_path")
    ckpt, gsteps = restore_for_resume(cfg, solver, replay, persist)
    learn_live = False
    for t in range(1, cfg.train.total_steps + 1):
        eps = epsilon_at(t, cfg.actors)
        carry_before = carry
        a, carry = solver.act(np.asarray(obs), carry, eps, rng)
        next_frame, r, done, over = env.step(a)
        next_obs = stacker.push(next_frame) if pixel else next_frame
        ep_ret += r
        for seq in builder.on_step(obs, a, r, done,
                                   (carry_before[0][0], carry_before[1][0]),
                                   next_obs):
            replay.add_sequence(seq)
        obs = next_obs
        metrics.count("env_steps")

        if over:
            if not done:
                # time-limit truncation: emit the pending window with its
                # bootstrap instead of discarding the episode's tail
                for seq in builder.flush_truncated(next_obs):
                    replay.add_sequence(seq)
            ep_returns.add(ep_ret)
            ep_ret = 0.0
            builder.reset()
            frame = env.reset()
            obs = stacker.reset(frame) if pixel else frame
            carry = solver.initial_state(1)

        if t % cfg.train.train_every == 0 and not learn_live:
            # every process's replay warm: a collective AND, at the same
            # loop point on every process, until it first holds (the fill
            # only grows, so it holds from then on)
            learn_live = all_processes_ready(replay.ready(learn_start_seqs))
        if learn_live and t % cfg.train.train_every == 0:
            if fused_seq:
                remaining = ((cfg.train.total_steps - t)
                             // cfg.train.train_every + 1)
                m = stream.next(remaining)
            else:
                with timer.phase("sample"):
                    batch = replay.sample(solver.local_batch)
                sampled_at = batch.pop("_sampled_at")
                with timer.phase("dispatch"):
                    if device_seq:
                        m = solver.train_step_from_ring(replay, batch)
                    else:
                        m = solver.train_step(batch)
            gsteps += 1
            timer.step_done()
            trace.on_step(gsteps)
            if writeback is not None:
                with timer.phase("writeback"):
                    writeback.push(m["index"], m["td_abs"], sampled_at)
            metrics.count("grad_steps")
            if ckpt and gsteps % cfg.train.checkpoint_every == 0:
                save_checkpoint(cfg, ckpt, solver, t)
                if persist:
                    save_replay(replay, persist)
            if gsteps % log_every == 0:
                timer.measure_device(m["loss"])
                summary = {
                    "loss": float(m["loss"]), "q_mean": float(m["q_mean"]),
                    "return_avg100": ep_returns.value, "epsilon": eps,
                    "grad_steps_per_s": metrics.rate("grad_steps"),
                    "env_steps_per_s": metrics.rate("env_steps"),
                }
                metrics.gauge("queue/replay_size", len(replay))
                pending = getattr(replay, "pending_rows", None)
                if pending is not None:
                    metrics.gauge("queue/staged_rows", pending())
                metrics.log(gsteps, **summary, **timer.summary(),
                            **metrics.telemetry(),
                            **solver.dispatch_counters())

    trace.close()
    if writeback is not None:
        writeback.drain()
    if ckpt:
        save_checkpoint(cfg, ckpt, solver, cfg.train.total_steps, wait=True)
    if persist:
        # an end-of-run save without checkpointing too, as in the
        # reference: the buffer must not go stale against the final θ
        save_replay(replay, persist)
    summary["final_return_avg100"] = ep_returns.value
    summary["grad_steps"] = gsteps
    summary["eval_return"] = evaluate_recurrent(solver, cfg)
    summary["solver"] = solver
    summary["replay"] = replay
    if solver.device.type == "cuda":
        torch.cuda.synchronize(solver.device)
    return summary
