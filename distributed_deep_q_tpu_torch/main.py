"""CLI entry point of the PyTorch/CUDA port (the reference ``main.py``'s
train and eval modes).

Examples:
    python -m distributed_deep_q_tpu_torch.main train --preset pong --backend cuda \\
        --set env.kind=signal_atari env.id=signal
    python -m distributed_deep_q_tpu_torch.main train --preset breakout --backend cuda \\
        --set env.kind=signal_atari env.id=signal replay.device_per=false \\
        train.use_pallas_loss=true
    python -m distributed_deep_q_tpu_torch.main train --preset r2d2 --backend cuda \\
        --set env.kind=signal_atari env.id=signal
    python -m distributed_deep_q_tpu_torch.main train --preset cartpole --backend cpu
    python -m distributed_deep_q_tpu_torch.main eval --preset pong --backend cpu \\
        --set env.kind=signal_atari env.id=signal

``--backend`` defaults to ``cuda`` and raises without a card; ``--backend
cpu`` runs on the host.
"""

from __future__ import annotations

import argparse
import json
import sys

from distributed_deep_q_tpu_torch.config import (
    add_config_flags, config_from_args)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="distributed_deep_q_tpu_torch")
    parser.add_argument("mode", choices=["train", "eval"],
                        help="train: run the training loop; eval: greedy "
                             "rollouts")
    add_config_flags(parser)
    parser.add_argument("--metrics-jsonl", default="",
                        help="write structured metrics to this JSONL file")
    parser.add_argument("--log-every", type=int, default=1_000,
                        help="grad steps between metric records (the last "
                             "record's rates go into the summary)")
    parser.add_argument("--distributed", action="store_true",
                        help="the actor/learner RPC topology (not ported)")
    args = parser.parse_args(argv)
    cfg = config_from_args(args)

    if args.distributed:
        raise NotImplementedError(
            "--distributed (the actor/learner RPC topology) is not ported "
            "yet (ROADMAP A10)")

    # imported past flag parsing so --help stays cheap
    from distributed_deep_q_tpu_torch.metrics import Metrics
    from distributed_deep_q_tpu_torch.train import (
        check_slice, evaluate, evaluate_recurrent, train_single_process)

    if args.mode == "train":
        summary = train_single_process(
            cfg, metrics=Metrics(args.metrics_jsonl or None),
            log_every=args.log_every)
        summary.pop("solver", None)
        print(json.dumps({"mode": "train", **{
            k: v for k, v in summary.items()
            if isinstance(v, (int, float, str))}}))
        return 0

    import numpy as np

    from distributed_deep_q_tpu_torch.actors.game import make_env
    from distributed_deep_q_tpu_torch.parallel.sequence_learner import (
        SequenceSolver)
    from distributed_deep_q_tpu_torch.solver import Solver
    check_slice(cfg)
    env = make_env(cfg.env, seed=cfg.train.seed)
    cfg.net.num_actions = env.num_actions
    obs_dim = int(np.prod(env.obs_shape))
    if cfg.net.kind == "r2d2":
        ret = evaluate_recurrent(SequenceSolver(cfg, obs_dim=obs_dim), cfg)
    else:
        ret = evaluate(Solver(cfg, obs_dim=obs_dim), cfg)
    print(json.dumps({"mode": "eval", "eval_return": ret,
                      "episodes": cfg.train.eval_episodes,
                      "restored_step": None}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
