"""CLI entry point of the PyTorch/CUDA port (the reference ``main.py``'s
train, eval and play modes).

Examples:
    python -m distributed_deep_q_tpu_torch.main train --preset pong --backend cuda \\
        --set env.kind=signal_atari env.id=signal
    python -m distributed_deep_q_tpu_torch.main train --preset breakout --backend cuda \\
        --set env.kind=signal_atari env.id=signal replay.device_per=false \\
        train.use_pallas_loss=true
    python -m distributed_deep_q_tpu_torch.main train --preset r2d2 --backend cuda \\
        --set env.kind=signal_atari env.id=signal
    python -m distributed_deep_q_tpu_torch.main train --preset cartpole --backend cpu
    python -m distributed_deep_q_tpu_torch.main train --distributed --preset pong \\
        --backend cuda --set env.kind=signal_atari env.id=signal
    python -m distributed_deep_q_tpu_torch.main eval --preset pong --backend cpu \\
        --set env.kind=signal_atari env.id=signal
    python -m distributed_deep_q_tpu_torch.main train --preset cartpole --backend cpu \\
        --set train.checkpoint_dir=ckpt train.checkpoint_every=500 \\
        replay.persist_path=replay.npz
    python -m distributed_deep_q_tpu_torch.main train --preset cartpole --backend cpu \\
        --set train.checkpoint_dir=ckpt train.checkpoint_every=500 \\
        replay.persist_path=replay.npz train.resume=true
    python -m distributed_deep_q_tpu_torch.main play --preset cartpole --backend cpu \\
        --set train.checkpoint_dir=ckpt
    # two learner processes (run once per process_id, 0 and 1)
    python -m distributed_deep_q_tpu_torch.main train --preset cartpole --backend cpu \\
        --set mesh.coordinator=127.0.0.1:29500 mesh.num_processes=2 \\
        mesh.process_id=0

``--backend`` defaults to ``cuda`` and raises without a card; ``--backend
cpu`` runs on the host. ``--distributed`` runs the learner on the backend
and the actors as spawned processes on the host CPU (by design: they never
touch the card). ``eval`` and ``play`` restore the newest checkpoint
under ``train.checkpoint_dir`` when there is one. With
``mesh.num_processes`` > 1 every process runs the same command with its own
``mesh.process_id``; only process 0 writes ``--metrics-jsonl``.
"""

from __future__ import annotations

import argparse
import json
import sys

from distributed_deep_q_tpu_torch.config import (
    add_config_flags, config_from_args)


def _maybe_restore(solver, cfg) -> int | None:
    """Load the newest checkpoint into ``solver`` when a checkpoint dir is
    configured; returns the restored step (None if nothing to restore)."""
    if not cfg.train.checkpoint_dir:
        return None
    from distributed_deep_q_tpu_torch.utils.checkpoint import Checkpointer
    ckpt = Checkpointer(cfg.train.checkpoint_dir)
    if ckpt.latest_step() is None:
        return None
    solver.state, _ = ckpt.restore(solver.state)
    return solver.step


def _build_solver(cfg, env):
    """Solver for eval/play: ``SequenceSolver`` for recurrent (r2d2) nets,
    the feed-forward ``Solver`` otherwise — a train-mode r2d2 checkpoint
    must be evaluable and playable from the CLI."""
    import numpy as np
    obs_dim = int(np.prod(env.obs_shape))
    if cfg.net.kind == "r2d2":
        from distributed_deep_q_tpu_torch.parallel.sequence_learner import (
            SequenceSolver)
        return SequenceSolver(cfg, obs_dim=obs_dim)
    from distributed_deep_q_tpu_torch.solver import Solver
    return Solver(cfg, obs_dim=obs_dim)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="distributed_deep_q_tpu_torch")
    parser.add_argument("mode", choices=["train", "eval", "play"],
                        help="train: run the training loop; eval: greedy "
                             "rollouts; play: single greedy episode with "
                             "per-step printout")
    add_config_flags(parser)
    parser.add_argument("--metrics-jsonl", default="",
                        help="write structured metrics to this JSONL file")
    parser.add_argument("--log-every", type=int, default=1_000,
                        help="grad steps between metric records (the last "
                             "record's rates go into the summary)")
    parser.add_argument("--distributed", action="store_true",
                        help="train: the actor/learner RPC topology "
                             "(spawned CPU actor processes feed the "
                             "learner over the v4 wire)")
    args = parser.parse_args(argv)
    cfg = config_from_args(args)
    # join the other learner processes before anything touches the card
    # (a no-op at one process)
    from distributed_deep_q_tpu_torch.parallel.multihost import (
        initialize_multihost, shutdown)
    initialize_multihost(cfg.mesh)
    try:
        return _run(args, cfg)
    finally:
        shutdown()   # leave the group on the way out, success or error


def _run(args, cfg) -> int:
    # imported past flag parsing so --help stays cheap
    from distributed_deep_q_tpu_torch.metrics import Metrics
    from distributed_deep_q_tpu_torch.train import (
        check_slice, evaluate, evaluate_recurrent, train_single_process)

    if args.mode == "train":
        train = train_single_process
        if args.distributed:
            from distributed_deep_q_tpu_torch.actors.supervisor import (
                train_distributed as train)
        summary = train(cfg, metrics=Metrics(args.metrics_jsonl or None),
                        log_every=args.log_every)
        summary.pop("solver", None)
        summary.pop("replay", None)
        print(json.dumps({"mode": "train", **{
            k: v for k, v in summary.items()
            if isinstance(v, (int, float, str))}}))
        return 0

    import numpy as np

    from distributed_deep_q_tpu_torch.actors.game import (
        FrameStacker, make_env)
    check_slice(cfg)
    env = make_env(cfg.env, seed=cfg.train.seed)
    cfg.net.num_actions = env.num_actions
    solver = _build_solver(cfg, env)
    restored = _maybe_restore(solver, cfg)
    recurrent = cfg.net.kind == "r2d2"

    if args.mode == "eval":
        ret = (evaluate_recurrent if recurrent else evaluate)(solver, cfg)
        print(json.dumps({"mode": "eval", "eval_return": ret,
                          "episodes": cfg.train.eval_episodes,
                          "restored_step": restored}))
        return 0

    # play: one greedy episode, a line per step
    rng = np.random.default_rng(cfg.train.seed)
    carry = solver.initial_state(1) if recurrent else None
    stacker = (FrameStacker(env.obs_shape, cfg.env.stack)
               if env.obs_dtype == np.uint8 else None)
    obs, over, t, ep_ret = env.reset(), False, 0, 0.0
    if stacker:
        obs = stacker.reset(obs)
    while not over:
        if recurrent:
            a, carry = solver.act(np.asarray(obs), carry,
                                  cfg.actors.eval_eps, rng)
        else:
            a = solver.act(obs, cfg.actors.eval_eps, rng)
        frame, r, _, over = env.step(a)
        obs = stacker.push(frame) if stacker else frame
        ep_ret += r
        t += 1
        print(f"t={t} a={a} r={r:+.1f} R={ep_ret:.1f}")
    print(json.dumps({"mode": "play", "steps": t, "return": ep_ret}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
