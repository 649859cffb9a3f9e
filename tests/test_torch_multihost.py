"""More than one learner process in the port (``parallel/multihost.py``),
two processes on this machine over ``gloo``, held against one process and
against the reference.

The twin of ``tests/test_multihost.py``. The reference spawns JAX
processes; here the reference runs in the test process, as ONE process at
``mesh.dp = D`` on the conftest's 8 CPU devices: the reference's own
``test_two_process_matches_single_process`` pins its 2-process run to that
single-process run, so no JAX process is spawned. The port's workers are
this file run as a script (``python tests/test_torch_multihost.py MODE PID
NPROC PORT OUT ...``): its top level imports no jax, so a worker imports
only the port. Every spawn has its own deadline and its workers are
killed when it expires; a port taken between the probe and the bind is
retried once on a fresh one.

Bars:

- θ, θ⁻ and the Adam moments: 2 processes × D/2 shards against 1 process
  × D shards, and against the reference at dp = D, within 1e-6 (the
  reference's own 1-vs-2-process bar); the two ranks' θ bitwise equal.
- the fused sample (slot-keyed ring content, so the ring is the same in
  every layout): the drawn rows, the IS weights, the composed metadata and
  the ring bytes, reassembled in shard order, bitwise against the
  1-process port; against the reference bitwise, the weights within 2 ulp
  where shard masses differ (torch's and XLA's float32 ``pow``).
- the fused chain with the learning-dynamics plane: the plane's counts
  exact, its sums and extrema within 1e-5 relative (each process's rows go
  through a batch half the size, so the float order of the step differs
  after the first), θ within 1e-6.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

STEPS, GLOBAL_B, OBS_DIM, ACTIONS = 5, 16, 6, 3
SAMPLE_D, SAMPLE_B, CHAIN, FRAME = 8, 32, 2, (36, 36)
SPAWN_TIMEOUT_S = 240
REC_STEPS, REC_EVERY = 480, 16


# ---------------------------------------------------------------------------
# spawning
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(argv_for, nproc: int, timeout: float = SPAWN_TIMEOUT_S):
    """Run ``nproc`` workers (``argv_for(pid, port)`` each) to their end;
    returns their stdouts. Kills them all when ``timeout`` expires; retries
    once on a fresh port when the first one was taken."""
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["OMP_NUM_THREADS"] = "1"
    for attempt in range(2):
        port = _free_port()
        procs = [subprocess.Popen(argv_for(pid, port), cwd=REPO, env=env,
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE)
                 for pid in range(nproc)]
        deadline = time.monotonic() + timeout
        outs = []
        try:
            for p in procs:
                left = max(deadline - time.monotonic(), 1.0)
                outs.append(p.communicate(timeout=left))
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            for p in procs:
                p.communicate()
            raise AssertionError(f"workers exceeded their {timeout} s")
        errs = [se.decode() for _, se in outs]
        if attempt == 0 and any(
                p.returncode and ("EADDRINUSE" in e
                                  or "Address already in use" in e)
                for p, e in zip(procs, errs)):
            continue
        for pid, (p, (so, se)) in enumerate(zip(procs, outs)):
            assert p.returncode == 0, (
                f"worker {pid} failed rc={p.returncode}\n"
                f"stdout:{so.decode()[-2000:]}\nstderr:{se.decode()[-3000:]}")
        return [so.decode() for so, _ in outs]
    raise AssertionError("no free port after a retry")


def _run_workers(mode: str, nproc: int, tmp_path, *extra,
                 timeout: float = SPAWN_TIMEOUT_S) -> list[dict]:
    """This file as ``nproc`` workers in ``mode``; returns each rank's
    npz contents."""
    outs = [str(tmp_path / f"{mode}_{nproc}_{pid}.npz")
            for pid in range(nproc)]
    _spawn(lambda pid, port: [sys.executable, os.path.abspath(__file__),
                              mode, str(pid), str(nproc), str(port),
                              outs[pid], *map(str, extra)],
           nproc, timeout)
    return [dict(np.load(o)) for o in outs]


def _flatten(tree, prefix="") -> dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "/"))
        else:
            out[key] = np.asarray(v)
    return out


def _unflatten(flat: dict, prefix: str) -> dict:
    out: dict = {}
    for k, v in flat.items():
        if not k.startswith(prefix + "/"):
            continue
        node = out
        parts = k[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


STATE_KEYS = ("params", "target_params", "mu", "nu")


def _state_leaves(d: dict) -> dict[str, np.ndarray]:
    return {k: v for k, v in d.items() if k.split("/")[0] in STATE_KEYS}


def _assert_states(got: dict, want: dict, atol: float, what: str) -> None:
    a, b = _state_leaves(got), _state_leaves(want)
    assert set(a) == set(b) and a, (sorted(a), sorted(b))
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=atol,
                                   err_msg=f"{what}: {k}")


def _assert_ranks_bitwise(ranks: list[dict]) -> None:
    first = _state_leaves(ranks[0])
    for r in ranks[1:]:
        for k, v in first.items():
            np.testing.assert_array_equal(r[k], v, err_msg=f"ranks: {k}")


# ---------------------------------------------------------------------------
# the workers (run as a script: no jax here)
# ---------------------------------------------------------------------------


def _join(pid: int, nproc: int, port: str, **mesh):
    from distributed_deep_q_tpu_torch.config import MeshConfig
    from distributed_deep_q_tpu_torch.parallel.multihost import (
        initialize_multihost)
    import torch
    torch.set_num_threads(1)
    m = MeshConfig(backend="cpu", coordinator=f"127.0.0.1:{port}",
                   num_processes=nproc, process_id=pid, **mesh)
    initialize_multihost(m)
    return m


def synthetic_batch(rng: np.random.Generator, b: int) -> dict:
    """The reference worker's batches (``tests/_multihost_worker.py``)."""
    return {
        "obs": rng.standard_normal((b, OBS_DIM)).astype(np.float32),
        "action": rng.integers(0, ACTIONS, b).astype(np.int32),
        "reward": rng.standard_normal(b).astype(np.float32),
        "next_obs": rng.standard_normal((b, OBS_DIM)).astype(np.float32),
        "discount": np.full(b, 0.99, np.float32),
        "weight": np.ones(b, np.float32),
    }


def _mlp_cfg(mod, pallas: bool, dp: int):
    cfg = mod.Config()
    cfg.mesh.backend = "cpu"
    cfg.mesh.dp = dp
    cfg.net = mod.NetConfig(kind="mlp", num_actions=ACTIONS, hidden=(32, 32),
                            dueling=True)
    cfg.train = mod.TrainConfig(lr=1e-3, double_dqn=True,
                                target_update_period=3,
                                use_pallas_loss=pallas, seed=0)
    cfg.replay.batch_size = GLOBAL_B
    return cfg


def _worker_mlp(pid, nproc, port, out, pallas, init):
    """STEPS host-batch steps on this process's rows of the reference
    worker's global batches, from the reference's initial state."""
    from distributed_deep_q_tpu_torch import config as pc
    from distributed_deep_q_tpu_torch.parallel.multihost import local_rows
    from distributed_deep_q_tpu_torch.solver import Solver

    cfg = _mlp_cfg(pc, pallas == "1", 8)
    cfg.mesh = _join(pid, nproc, port, dp=8)
    solver = Solver(cfg, obs_dim=OBS_DIM)
    z = dict(np.load(init))
    solver.load_flax_state(_unflatten(z, "params"),
                           _unflatten(z, "target_params"), z["count"],
                           _unflatten(z, "mu"), _unflatten(z, "nu"),
                           z["step"])
    bl = GLOBAL_B // nproc
    rng = np.random.default_rng(0)   # the same stream in every process
    for _ in range(STEPS):
        batch = synthetic_batch(rng, GLOBAL_B)
        m = solver.train_step({k: v[pid * bl:(pid + 1) * bl]
                               for k, v in batch.items()})
        assert local_rows(m["td_abs"]).shape == (bl,)
    np.savez(out, loss=float(m["loss"]), **_flatten(solver.flax_state()))


def _feed_slot_keyed(replay, pid: int, streams: int, rows: int) -> None:
    """Each stream's rows depend only on its GLOBAL slot (one slot per
    stream), so every layout writes the same bytes into the same slots."""
    for s in range(streams):
        rng = np.random.default_rng(2000 + pid * streams + s)
        replay.add_batch({
            "frame": rng.integers(0, 255, (rows,) + FRAME, dtype=np.uint8),
            "action": rng.integers(0, 4, rows).astype(np.int32),
            "reward": rng.standard_normal(rows).astype(np.float32),
            "done": (np.arange(rows) % 7 == 6),
        }, stream=s)


def _pixel_cfg(mod, d: int, batch: int, **train):
    cfg = mod.Config()
    cfg.mesh.backend = "cpu"
    cfg.mesh.dp = d
    cfg.net = mod.NetConfig(kind="nature_cnn", num_actions=4,
                            frame_shape=FRAME, compute_dtype="float32")
    cfg.replay = mod.ReplayConfig(capacity=512, batch_size=batch, n_step=2,
                                  prioritized=True, device_per=True,
                                  write_chunk=16)
    cfg.train = mod.TrainConfig(lr=1e-3, double_dqn=True,
                                target_update_period=2, seed=0, **train)
    return cfg


def _port_fused_replay(cfg, solver, pid, nproc, rows):
    from distributed_deep_q_tpu_torch.replay.device_per import (
        DevicePERFrameReplay)
    d = cfg.mesh.dp
    streams = d // nproc                     # 1:1 stream ↔ slot
    replay = DevicePERFrameReplay(
        cfg.replay, solver.device, FRAME, stack=4, gamma=0.99, seed=0,
        write_chunk=16, num_streams=streams, num_shards=d,
        local_shards=solver.local_shards)
    assert replay.num_slots == d
    for s in range(streams):
        assert replay._slot_cycle[s] == [pid * streams + s]
    _feed_slot_keyed(replay, pid, streams, rows)
    replay.flush()
    return replay


def _worker_sample(pid, nproc, port, out):
    """The fused sample stage alone, at D = 8 split over the processes."""
    import torch
    from distributed_deep_q_tpu_torch import config as pc
    from distributed_deep_q_tpu_torch.parallel.learner import fused_sample
    from distributed_deep_q_tpu_torch.replay.device_per import (
        uniforms_for_keys)
    from distributed_deep_q_tpu_torch.solver import (
        Solver, fused_spec, next_fused_keys)

    cfg = _pixel_cfg(pc, SAMPLE_D, SAMPLE_B)
    cfg.mesh = _join(pid, nproc, port, dp=SAMPLE_D)
    solver = Solver(cfg)
    replay = _port_fused_replay(cfg, solver, pid, nproc, 40)
    spec = fused_spec(cfg, replay)
    cursors, sizes = replay.device_inputs()
    betas = replay.next_betas(CHAIN)
    keys = next_fused_keys(solver, SAMPLE_D, CHAIN)[replay.local_shards]
    u = uniforms_for_keys(keys.reshape(-1, 2), spec[8], solver.device)
    metas, _, idx, _ = fused_sample(
        replay.dstate, torch.from_numpy(cursors), torch.from_numpy(sizes),
        torch.from_numpy(betas), u, spec)
    # rows back in global coordinates (dead draws stay out of range)
    idx = idx.numpy().astype(np.int64)
    live = idx < replay.local_capacity
    idx = np.where(live, idx + replay.local_shards[0] * replay.cap_local,
                   replay.capacity)
    np.savez(out, frames=replay.dstate["frames"].numpy(),
             prio=replay.dstate["prio"].numpy(), idx=idx,
             cap_local=replay.cap_local,
             **{k: v.numpy() for k, v in metas.items()})


def _worker_chain(pid, nproc, port, out, optimizer, pallas="0"):
    """Two chain-2 dispatches of the fused step at D = 2 with the learning
    plane."""
    from distributed_deep_q_tpu_torch import config as pc
    from distributed_deep_q_tpu_torch.solver import Solver

    cfg = _pixel_cfg(pc, 2, 16, optimizer=optimizer, learn_metrics=True,
                     stack_forwards="on", use_pallas_loss=pallas == "1")
    cfg.replay.priority_alpha = 0.6
    cfg.mesh = _join(pid, nproc, port, dp=2)
    solver = Solver(cfg)
    replay = _port_fused_replay(cfg, solver, pid, nproc, 90)
    planes, losses = [], []
    for _ in range(2):
        m = solver.train_steps_device_per(replay, chain=CHAIN)
        if "learn_plane" in m:
            planes.append(m.pop("learn_plane").numpy())
        losses.append(m["loss"].numpy())
    st = solver.flax_state()
    np.savez(out, loss=np.concatenate(losses),
             planes=np.asarray(planes, np.float32),
             prio=replay.dstate["prio"].numpy(),
             maxp=replay.dstate["maxp"].numpy(),
             **_flatten(st))


SEQ = dict(frame=(36, 36), stack=4, seq_len=8, burn=2, lstm=16, batch=8,
           caps=16)


def _seq_cfg(mod, d: int):
    cfg = mod.Config()
    cfg.mesh.backend = "cpu"
    cfg.mesh.dp = d
    cfg.net = mod.NetConfig(kind="r2d2", num_actions=4,
                            lstm_size=SEQ["lstm"], frame_shape=SEQ["frame"],
                            stack=SEQ["stack"], dueling=True,
                            compute_dtype="float32")
    cfg.replay = mod.ReplayConfig(
        capacity=SEQ["caps"] * d * SEQ["seq_len"], batch_size=SEQ["batch"],
        sequence_length=SEQ["seq_len"], burn_in=SEQ["burn"],
        prioritized=True, priority_alpha=0.6, device_per=True,
        fused_chain=CHAIN)
    cfg.train = mod.TrainConfig(lr=1e-3, double_dqn=True,
                                target_update_period=2, seed=0,
                                learn_metrics=True)
    return cfg


def _sequence(shard: int, k: int) -> dict:
    """Sequence k of a shard, its content a function of (shard, k) only."""
    rng = np.random.default_rng(5000 + 97 * shard + k)
    t, lstm = SEQ["seq_len"], SEQ["lstm"]
    n = t if k % 3 else t - 3                 # a padded tail now and then
    mask = (np.arange(t) < n).astype(np.float32)
    obs = rng.integers(0, 255, (t + 1,) + SEQ["frame"] + (SEQ["stack"],),
                       dtype=np.uint8)
    obs[n + 1:] = 0
    return {"obs": obs,
            "action": (rng.integers(0, 4, t) * mask).astype(np.int32),
            "reward": (rng.standard_normal(t) * mask).astype(np.float32),
            "discount": (0.99 * mask).astype(np.float32), "mask": mask,
            "init_c": rng.standard_normal(lstm).astype(np.float32) * 0.5,
            "init_h": rng.standard_normal(lstm).astype(np.float32) * 0.5}


def _worker_seq(pid, nproc, port, out):
    """Two chain-2 fused sequence dispatches at D = 2: each process feeds
    its own shard the sequences a 1-process run routes there."""
    from distributed_deep_q_tpu_torch import config as pc
    from distributed_deep_q_tpu_torch.parallel.sequence_learner import (
        SequenceSolver)
    from distributed_deep_q_tpu_torch.train import make_sequence_replay

    d = 2
    cfg = _seq_cfg(pc, d)
    cfg.mesh = _join(pid, nproc, port, dp=d)
    solver = SequenceSolver(cfg)
    replay = make_sequence_replay(
        cfg, SEQ["frame"] + (SEQ["stack"],), np.uint8, solver.device)
    for k in range(SEQ["caps"] - 4):
        for s in range(d):             # round-robin over the shards
            if s in replay.local_shards:
                replay.add_sequence(_sequence(s, k))
    planes, losses = [], []
    for _ in range(2):
        m = solver.train_steps_device_per(replay, chain=CHAIN)
        planes.append(m.pop("learn_plane").numpy())
        losses.append(m["loss"].numpy())
    np.savez(out, loss=np.concatenate(losses),
             planes=np.asarray(planes, np.float32),
             prio=replay.dmeta["prio"].numpy(),
             ring=replay.ring.numpy(), maxp=replay.dmaxp.numpy(),
             **_flatten(solver.flax_state()))


def _worker_collectives(pid, nproc, port, out):
    import torch
    from distributed_deep_q_tpu_torch.parallel import multihost

    _join(pid, nproc, port)
    res = {
        "multiprocess": multihost.is_multiprocess(),
        "count": multihost.process_count(),
        "rank": multihost.process_index(),
        "and_mixed": multihost.all_processes_ready(pid == 0),
        "and_all": multihost.all_processes_ready(True),
        "max": multihost.all_reduce_(
            torch.tensor([5.0 * pid + 3, -pid]), "max").tolist(),
        "min": multihost.all_reduce_(
            torch.tensor([5.0 * pid + 3, -pid]), "min").tolist(),
        "rows": multihost.local_rows(torch.arange(4.0) + pid).tolist(),
    }
    t = torch.full((3,), float(pid + 1))
    multihost.put_replicated([t])
    res["replicated"] = t.tolist()
    with open(out, "w") as f:
        json.dump(res, f)


def _worker_dist(pid, nproc, port, out, mode, steps):
    """``train_distributed`` on this process's slice (the twin of
    ``tests/_multihost_distributed_worker.py``)."""
    import dataclasses
    import hashlib
    import multiprocessing as mp
    import threading

    import torch
    from distributed_deep_q_tpu_torch import config as pc
    from distributed_deep_q_tpu_torch.actors.supervisor import (
        train_distributed)

    cfg = {"cartpole": pc.cartpole_config, "pixel_fused": pc.pong_config,
           "r2d2_fused": pc.r2d2_config}[mode]()
    cfg.mesh = _join(pid, nproc, port)
    steps = int(steps)
    cfg.train.total_steps = steps
    cfg.train.eval_every = 0
    cfg.train.keep_best_eval = False
    cfg.train.eval_episodes = 1
    cfg.replay.learn_start = 120
    cfg.replay.batch_size = 32
    cfg.actors.num_actors = 2 * nproc         # two per process
    cfg.actors.send_batch = 16
    cfg.actors.param_sync_period = 20
    if mode == "pixel_fused":
        cfg.env = dataclasses.replace(cfg.env, id="signal",
                                      kind="signal_atari",
                                      frame_shape=(36, 36))
        cfg.net.frame_shape = (36, 36)
        cfg.net.compute_dtype = "float32"
        cfg.replay = dataclasses.replace(
            cfg.replay, capacity=4096, batch_size=16, learn_start=300,
            n_step=2, prioritized=True, device_per=True, write_chunk=16,
            fused_chain=4, priority_alpha=0.6)
        cfg.actors.num_actors = nproc         # one per process
        cfg.train.target_update_period = 10
    if mode == "r2d2_fused":
        cfg.env = dataclasses.replace(cfg.env, id="signal",
                                      kind="signal_atari",
                                      frame_shape=(36, 36))
        cfg.net.frame_shape = (36, 36)
        cfg.net.lstm_size = 8
        cfg.net.compute_dtype = "float32"
        cfg.replay = dataclasses.replace(
            cfg.replay, capacity=4096, batch_size=8, learn_start=192,
            sequence_length=12, burn_in=2, prioritized=True,
            device_resident=True, device_per=True, write_chunk=2,
            fused_chain=4)
        cfg.actors.num_actors = nproc         # one per process
        cfg.actors.send_batch = 26
        cfg.train.target_update_period = 10
    if mode == "cartpole" and pid == 0:
        def assassin() -> None:
            # once this process's slice feeds, kill one of its actors: its
            # supervisor must respawn it
            deadline = time.monotonic() + 120
            while time.monotonic() < deadline:
                kids = [p for p in mp.active_children()
                        if p.name.startswith("actor-")]
                if kids:
                    time.sleep(1.0)
                    kids[0].kill()
                    return
                time.sleep(0.2)

        threading.Thread(target=assassin, daemon=True).start()
    summary = train_distributed(cfg, log_every=max(steps // 2, 1))
    solver, replay = summary["solver"], summary["replay"]
    theta = hashlib.sha256(b"".join(
        p.detach().numpy().tobytes()
        for p in solver.state.net.parameters())).hexdigest()
    res = {"pid": pid, "env_steps": int(summary["env_steps"]),
           "actor_restarts": int(summary["actor_restarts"]),
           "grad_steps": solver.step, "theta": theta,
           "finite": bool(np.isfinite(summary["loss"])),
           "streams": getattr(replay, "num_streams", None)}
    if mode != "cartpole":
        if mode == "pixel_fused":
            ring, prio = replay.dstate["frames"], replay.dstate["prio"]
        else:
            ring, prio = replay.ring, replay.dmeta["prio"]
        prio = prio.numpy()
        seeded = prio[prio > 0]
        res["ring_nonzero"] = bool((ring != 0).any())
        res["prio_moved"] = bool(len(seeded) and
                                 (~np.isclose(seeded, seeded.max())).any())
    with open(out, "w") as f:
        json.dump(res, f)


def _worker_recurrent(pid, nproc, port, out):
    """``train_recurrent`` (the in-process r2d2 loop) on the fused
    sequence ring, small; records the learn gate's collectives."""
    import dataclasses

    from distributed_deep_q_tpu_torch import config as pc
    from distributed_deep_q_tpu_torch.parallel import multihost
    from distributed_deep_q_tpu_torch.train import train_recurrent

    cfg = pc.r2d2_config()
    cfg.mesh = _join(pid, nproc, port)
    cfg.env = dataclasses.replace(cfg.env, id="signal", kind="signal_atari",
                                  frame_shape=(36, 36))
    cfg.net.frame_shape = (36, 36)
    cfg.net.lstm_size = 8
    cfg.net.compute_dtype = "float32"
    cfg.replay = dataclasses.replace(
        cfg.replay, capacity=2048, batch_size=8, learn_start=192,
        sequence_length=12, burn_in=2, prioritized=True,
        device_resident=True, device_per=True, write_chunk=2,
        fused_chain=2)
    cfg.train = dataclasses.replace(
        cfg.train, total_steps=REC_STEPS, train_every=REC_EVERY,
        target_update_period=10, eval_every=0, keep_best_eval=False,
        eval_episodes=1)
    summary = train_recurrent(cfg, log_every=10_000)
    with open(out, "w") as f:
        json.dump({"grad_steps": int(summary["grad_steps"]),
                   "step": summary["solver"].step,
                   "gate_calls": multihost.STATS["gate"]["calls"]}, f)


def _worker_alone(pid, nproc, port, out):
    """Process ``pid`` of ``nproc`` whose peers never come: joining must
    raise (no single-process fallback)."""
    from distributed_deep_q_tpu_torch.config import MeshConfig
    from distributed_deep_q_tpu_torch.parallel import multihost

    multihost.JOIN_TIMEOUT_S = 3.0
    try:
        multihost.initialize_multihost(MeshConfig(
            backend="cpu", coordinator=f"127.0.0.1:{port}",
            num_processes=nproc, process_id=pid))
    except Exception as e:  # what torch.distributed raises on a timeout
        with open(out, "w") as f:
            json.dump({"raised": type(e).__name__}, f)
        return
    raise AssertionError("joined a group whose peer never came")


def _worker_orphan(pid, nproc, port, out, victim, then):
    """Join, make one collective, then process ``victim`` kills itself;
    the survivor waits a moment and then ``then`` (a collective, or the
    teardown itself), recording what that raised and how long it took."""
    import signal

    import torch
    from distributed_deep_q_tpu_torch.parallel import multihost

    multihost.JOIN_TIMEOUT_S = ORPHAN_TIMEOUT_S
    _join(pid, nproc, port)
    multihost.all_reduce_(torch.ones(1))
    if pid == int(victim):
        os.kill(os.getpid(), signal.SIGKILL)
    time.sleep(1.0)
    t0 = time.monotonic()
    raised = None
    try:
        if then == "collective":
            multihost.all_processes_ready(True)
        else:
            multihost.shutdown()
    except Exception as e:  # what gloo raises on a closed connection
        raised = type(e).__name__
    with open(out, "w") as f:
        json.dump({"raised": raised, "seconds": time.monotonic() - t0}, f)


WORKERS = {"alone": _worker_alone, "orphan": _worker_orphan, "mlp": _worker_mlp, "sample": _worker_sample,
           "chain": _worker_chain, "seq": _worker_seq,
           "collectives": _worker_collectives, "dist": _worker_dist,
           "recurrent": _worker_recurrent}


# ---------------------------------------------------------------------------
# the tests (jax imports inside them)
# ---------------------------------------------------------------------------


def _reference_mlp(tmp_path, pallas: bool):
    """The reference at dp = 8, one process: its initial state (saved for
    the workers) and its state after STEPS global-batch steps."""
    import jax

    from distributed_deep_q_tpu import config as rc
    from distributed_deep_q_tpu.parallel.learner import _locate_adam_state
    from distributed_deep_q_tpu.solver import Solver as RefSolver

    ref = RefSolver(_mlp_cfg(rc, pallas, 8), obs_dim=OBS_DIM)

    def state():
        st = jax.tree.map(np.asarray, ref.state)
        adam, _ = _locate_adam_state(st.opt_state)
        return {**_flatten({"params": st.params,
                            "target_params": st.target_params,
                            "mu": adam.mu, "nu": adam.nu}),
                "count": np.asarray(adam.count),
                "step": np.asarray(st.step)}

    init = str(tmp_path / "init.npz")
    np.savez(init, **state())
    rng = np.random.default_rng(0)
    for _ in range(STEPS):
        ref.train_step(synthetic_batch(rng, GLOBAL_B))
    return init, state()


def _two_against_one(tmp_path, pallas: bool) -> None:
    init, ref = _reference_mlp(tmp_path, pallas)
    one, = _run_workers("mlp", 1, tmp_path, int(pallas), init)
    two = _run_workers("mlp", 2, tmp_path, int(pallas), init)
    _assert_ranks_bitwise(two)
    _assert_states(two[0], one, 1e-6, "2 processes vs 1")
    _assert_states(two[0], ref, 1e-6, "2 processes vs the reference")
    _assert_states(one, ref, 1e-6, "1 process vs the reference")
    assert int(two[0]["step"]) == int(one["step"]) == STEPS


def test_two_process_matches_single_process(tmp_path):
    """2 processes × 4 shards == 1 process × 8 shards == the reference at
    dp = 8: MLP, dueling, Double DQN, 5 steps, global batch 16."""
    _two_against_one(tmp_path, pallas=False)


def test_fused_loss_batch_scale_two_process(tmp_path):
    """``train.use_pallas_loss``: the fused TD loss divides by the rows it
    sees, the process's B/2, and the all-reduce mean then gives the mean
    over B, as the reference divides per shard and pmeans. On the CPU the
    wrappers take the kernels' plain versions; the reference runs its
    Pallas kernels in interpret mode."""
    _two_against_one(tmp_path, pallas=True)


def _reference_sample():
    """The reference worker's fused sample stage at dp = 8, one process
    (``tests/_shard_sampling_worker.py``)."""
    from distributed_deep_q_tpu import config as rc
    from distributed_deep_q_tpu.replay.device_per import (
        DevicePERFrameReplay as RefReplay)
    from distributed_deep_q_tpu.solver import Solver as RefSolver
    from distributed_deep_q_tpu.solver import next_fused_keys as ref_keys

    cfg = _pixel_cfg(rc, SAMPLE_D, SAMPLE_B)
    cfg.mesh.num_fake_devices = SAMPLE_D
    solver = RefSolver(cfg)
    replay = RefReplay(cfg.replay, solver.mesh, FRAME, stack=4, gamma=0.99,
                       seed=0, write_chunk=16, num_streams=SAMPLE_D)
    _feed_slot_keyed(replay, 0, SAMPLE_D, 40)
    replay.flush()
    learner = solver.learner
    spec = (replay.slot_cap, replay.slot_pad, replay.rowb, replay._row_len,
            replay.stack, replay.n_step, replay.gamma,
            tuple(replay.frame_shape), SAMPLE_B // SAMPLE_D,
            float(cfg.replay.priority_alpha), float(cfg.replay.priority_eps),
            SAMPLE_D, replay._interpret)
    sample, _ = learner._build_device_per_step(spec, CHAIN)
    cursors, sizes = replay.device_inputs()
    rows = replay.dstate
    metas, _, idx = sample(
        ref_keys(solver, SAMPLE_D, CHAIN), rows.frames, rows.action,
        rows.reward, rows.done, rows.boundary, rows.prio,
        np.asarray(cursors), np.asarray(sizes),
        np.asarray(replay.next_betas(CHAIN), np.float32))
    return ({"frames": np.asarray(rows.frames), "prio": np.asarray(rows.prio),
             "idx": np.asarray(idx)},
            {k: np.asarray(v) for k, v in metas.items()})


def _ulp_diff(a: np.ndarray, b: np.ndarray) -> int:
    return int(np.abs(a.astype(np.float32).view(np.int32).astype(np.int64)
                      - b.astype(np.float32).view(np.int32)).max())


def test_shard_local_sampling_bitwise_two_process(tmp_path):
    """With the ring content fixed by slot-keyed feeding, re-partitioning
    the 8 shards from one process to two leaves every drawn row, IS
    weight, composed metadata row and ring byte unchanged: each shard
    draws with its global shard's keys and reads only its own rows."""
    one, = _run_workers("sample", 1, tmp_path)
    two = _run_workers("sample", 2, tmp_path)
    axis = {"frames": 0, "prio": 0, "idx": 1, "weight": 1, "action": 1,
            "reward": 1, "discount": 1, "ovalid": 1, "nvalid": 1}
    got = {k: np.concatenate([d[k] for d in two], axis=ax)
           for k, ax in axis.items()}
    for k in axis:
        np.testing.assert_array_equal(got[k], one[k], err_msg=k)

    ref, metas = _reference_sample()
    cap_local = int(one["cap_local"])
    np.testing.assert_array_equal(got["frames"], ref["frames"])
    np.testing.assert_array_equal(got["prio"], ref["prio"])
    np.testing.assert_array_equal(got["idx"] % cap_local, ref["idx"])
    for k in ("action", "reward", "discount", "ovalid", "nvalid"):
        np.testing.assert_array_equal(got[k], metas[k], err_msg=k)
    assert _ulp_diff(got["weight"], metas["weight"]) <= 2


def test_one_shard_process_ring_and_draws_match_its_shard():
    """A process holding shard 1 of D = 2 flushes as one process does: at
    each chunk boundary and before a dispatch, in the staged order. The
    ring it leaves, and what a dispatch draws from it with shard 1's keys,
    are bitwise shard 1 of one process holding both shards, whose own
    draws the reference's match (the two-process test above)."""
    import torch

    from distributed_deep_q_tpu_torch import config as pc
    from distributed_deep_q_tpu_torch.parallel.learner import fused_sample
    from distributed_deep_q_tpu_torch.replay.device_per import (
        DevicePERFrameReplay, uniforms_for_keys)
    from distributed_deep_q_tpu_torch.solver import (
        fused_spec, sample_key_schedule)

    cfg = _pixel_cfg(pc, 2, 16)
    cpu = torch.device("cpu")

    def replay(streams, local):
        return DevicePERFrameReplay(cfg.replay, cpu, FRAME, stack=4,
                                    gamma=0.99, seed=0, write_chunk=16,
                                    num_streams=streams, num_shards=2,
                                    local_shards=local)

    both, half = replay(2, None), replay(1, [1])
    assert half._slot_cycle == [[1]] and both._slot_cycle == [[0], [1]]
    def rows(slot, start):
        rng = np.random.default_rng(2000 + 100 * slot + start)
        return {"frame": rng.integers(0, 255, (30,) + FRAME, dtype=np.uint8),
                "action": rng.integers(0, 4, 30).astype(np.int32),
                "reward": rng.standard_normal(30).astype(np.float32),
                "done": (np.arange(start, start + 30) % 7 == 6)}

    for start in range(0, 90, 30):
        both.add_batch(rows(0, start), stream=0)
        both.add_batch(rows(1, start), stream=1)
        half.add_batch(rows(1, start), stream=0)
    # each add crossed a chunk boundary and flushed inline
    assert half.pending_rows() == 0 and both.pending_rows() == 0
    # every row of shard 1 but its scratch row, whose contents are
    # unspecified (the kernel skips it; the plain version writes padding
    # lanes there, last round last)
    rows_b = both.dstate["frames"].numpy().reshape(-1, both.rowp)
    rows_h = half.dstate["frames"].numpy().reshape(-1, half.rowp)
    np.testing.assert_array_equal(rows_h[:-1],
                                  rows_b[half.shard_rows:-1])
    cap = half.local_capacity
    for k in ("action", "reward", "done", "boundary", "prio"):
        np.testing.assert_array_equal(half.dstate[k].numpy(),
                                      both.dstate[k].numpy()[cap:], k)
    cb, sb = both.device_inputs()
    ch, sh = half.device_inputs()
    np.testing.assert_array_equal(ch, cb[len(ch):])
    np.testing.assert_array_equal(sh, sb[len(sh):])

    spec = fused_spec(cfg, both)
    keys = sample_key_schedule(0, 0, 2, CHAIN)
    betas = torch.full((CHAIN,), 0.4)
    draws = []
    for r, k in ((both, keys), (half, keys[1:])):
        c, z = (torch.from_numpy(a) for a in r.device_inputs())
        u = uniforms_for_keys(k.reshape(-1, 2), spec[8], cpu)
        metas, win, idx, _ = fused_sample(r.dstate, c, z, betas, u, spec)
        draws.append((metas, win, idx))
    (mb, wb, ib), (mh, wh, ih) = draws
    per = spec[8]
    np.testing.assert_array_equal(ih.numpy() + cap, ib.numpy()[:, per:])
    np.testing.assert_array_equal(
        wh.numpy(), wb.view(CHAIN, 2, per, -1)[:, 1].reshape(-1).numpy())
    for k in mh:
        np.testing.assert_array_equal(mh[k].numpy(),
                                      mb[k].numpy()[:, per:], k)


def _plane_parts(planes: np.ndarray):
    from distributed_deep_q_tpu_torch import learning as lm
    counts = np.concatenate([planes[:, :lm.N_HIST],
                             planes[:, [lm.I_SAMPLES, lm.I_REFRESH,
                                        lm.I_NONFINITE, lm.I_STEPS]]], 1)
    rest = np.concatenate([planes[:, lm.N_HIST:lm.I_SAMPLES],
                           planes[:, lm.I_LOSS_SUM:lm.I_REFRESH],
                           planes[:, lm._MAX:]], 1)
    return counts, rest


@pytest.mark.parametrize("optimizer", ["adam", "rmsprop"])
def test_fused_chain_two_process_matches_one(optimizer, tmp_path):
    """Two chain-2 fused dispatches at D = 2, one shard per process,
    against one process holding both: θ within 1e-6, the ranks bitwise;
    with Adam the learning plane rides along (RMSProp runs no plane, as
    in the reference): its counts exact, the rest within 1e-5."""
    one, = _run_workers("chain", 1, tmp_path, optimizer)
    two = _run_workers("chain", 2, tmp_path, optimizer)
    _assert_ranks_bitwise(two)
    _assert_states(two[0], one, 1e-6, optimizer)
    np.testing.assert_allclose(two[0]["loss"], one["loss"], rtol=1e-5)
    np.testing.assert_allclose(
        np.concatenate([d["prio"] for d in two]), one["prio"], rtol=1e-5)
    assert two[0]["maxp"] == two[1]["maxp"]
    np.testing.assert_allclose(two[0]["maxp"], one["maxp"], rtol=1e-5)
    if optimizer == "adam":
        assert one["planes"].shape == two[0]["planes"].shape
        assert len(one["planes"]) == 2
        np.testing.assert_array_equal(two[0]["planes"], two[1]["planes"])
        c2, r2 = _plane_parts(two[0]["planes"])
        c1, r1 = _plane_parts(one["planes"])
        np.testing.assert_array_equal(c2, c1)
        np.testing.assert_allclose(r2, r1, rtol=1e-5, atol=1e-7)
    else:
        assert one["planes"].size == two[0]["planes"].size == 0


def test_sequence_chain_two_process_matches_one(tmp_path):
    """The sequence ring's fused chain at D = 2, one shard per process,
    against one process holding both: the sum of the filled count and the
    max of Q max cross the processes. The rings bitwise, θ within 1e-6,
    the plane's counts exact."""
    one, = _run_workers("seq", 1, tmp_path)
    two = _run_workers("seq", 2, tmp_path)
    _assert_ranks_bitwise(two)
    np.testing.assert_array_equal(
        np.concatenate([d["ring"] for d in two]), one["ring"])
    _assert_states(two[0], one, 1e-6, "sequence chain")
    np.testing.assert_allclose(two[0]["loss"], one["loss"], rtol=1e-5)
    np.testing.assert_allclose(
        np.concatenate([d["prio"] for d in two]), one["prio"], rtol=1e-5)
    c2, r2 = _plane_parts(two[0]["planes"])
    c1, r1 = _plane_parts(one["planes"])
    np.testing.assert_array_equal(c2, c1)
    np.testing.assert_allclose(r2, r1, rtol=1e-5, atol=1e-7)


def test_recurrent_loop_gate_latches_two_process(tmp_path):
    """``train_recurrent`` on two processes: the learn gate is a collective
    only until it first holds, as in ``train_single_process``; every tick
    after it is a grad step, the same on both ranks."""
    outs = [str(tmp_path / f"r{pid}.json") for pid in range(2)]
    _spawn(lambda pid, port: [sys.executable, os.path.abspath(__file__),
                              "recurrent", str(pid), "2", str(port),
                              outs[pid]], 2)
    res = []
    for o in outs:
        with open(o) as f:
            res.append(json.load(f))
    ticks = REC_STEPS // REC_EVERY
    for r in res:
        assert r["grad_steps"] > 0 and r["gate_calls"] >= 1
        # the last gate call opened the gate, and its tick stepped
        assert r["gate_calls"] - 1 + r["grad_steps"] == ticks, r
    assert res[0] == res[1]


def test_initialize_multihost_noop_single_process():
    """One process: a no-op that leaves no process group, so single-process
    entry points call it unconditionally; ``local_rows`` gives every row,
    in order."""
    import torch

    from distributed_deep_q_tpu_torch.config import MeshConfig
    from distributed_deep_q_tpu_torch.parallel import multihost

    multihost.initialize_multihost(MeshConfig(backend="cpu",
                                              num_processes=1))
    assert not torch.distributed.is_initialized()
    assert not multihost.is_multiprocess()
    x = np.arange(16, dtype=np.float32)
    np.testing.assert_array_equal(multihost.local_rows(torch.from_numpy(x)),
                                  x)
    assert multihost.all_processes_ready(True)
    t = torch.tensor([7.0])
    assert multihost.all_reduce_(t, "max") is t and t.item() == 7.0


@pytest.mark.parametrize("mesh, match", [
    (dict(num_fake_devices=8, num_processes=3, coordinator="127.0.0.1:1"),
     "divide evenly"),
    (dict(dp=3, num_processes=2, coordinator="127.0.0.1:1"),
     "divide evenly"),
    (dict(num_processes=2), "mesh.coordinator")])
def test_uneven_device_split_rejected(mesh, match):
    """The reference's split refusals, by its message, before any
    connection is tried; and no coordinator, no group."""
    from distributed_deep_q_tpu_torch.config import MeshConfig
    from distributed_deep_q_tpu_torch.parallel.multihost import (
        initialize_multihost)

    with pytest.raises(ValueError, match=match):
        initialize_multihost(MeshConfig(backend="cpu", **mesh))


def test_batch_split_refused():
    """``replay.batch_size`` that does not split across the processes is
    refused by the reference's message, by the ``Solver`` that every loop
    builds first (before the process-group check, so no group is needed
    here); so is a fleet that does not split, by the supervisor."""
    from distributed_deep_q_tpu_torch import config as pc
    from distributed_deep_q_tpu_torch.actors.supervisor import (
        _split_fleet_across_processes)
    from distributed_deep_q_tpu_torch.solver import Solver

    cfg = pc.pong_config()
    cfg.mesh = pc.MeshConfig(backend="cpu", num_processes=2, process_id=0,
                             coordinator="127.0.0.1:1")
    cfg.replay.batch_size = 33
    with pytest.raises(ValueError, match="must divide across 2 processes"):
        Solver(cfg)
    cfg.replay.batch_size = 32
    cfg.actors.num_actors = 3
    with pytest.raises(ValueError, match="must divide across 2 processes"):
        _split_fleet_across_processes(cfg, True, None, "ring", True)


def test_anakin_refused_at_two_processes():
    """Anakin stays a one-process mode (no reference test or preset runs it
    on more than one), refused by name before it builds anything."""
    from distributed_deep_q_tpu_torch import config as pc
    from distributed_deep_q_tpu_torch.parallel.anakin import AnakinRunner

    cfg = pc.pong_config()
    cfg.mesh = pc.MeshConfig(backend="cpu", num_processes=2, process_id=0,
                             coordinator="127.0.0.1:1")
    with pytest.raises(NotImplementedError, match="Anakin at mesh"):
        AnakinRunner(cfg)


@pytest.mark.parametrize("pid", [0, 1])
def test_missing_peer_raises(pid, tmp_path):
    """Process 0 (the store's host) and process 1 each alone: the join
    raises once its timeout passes; nothing carries on as one process."""
    out = str(tmp_path / "alone.json")
    _spawn(lambda _, port: [sys.executable, os.path.abspath(__file__),
                            "alone", str(pid), "2", str(port), out], 1, 120)
    with open(out) as f:
        assert json.load(f)["raised"]


def test_collectives_two_process(tmp_path):
    """``all_processes_ready`` (AND), ``all_reduce_`` (MAX, MIN),
    ``put_replicated`` (rank 0's values), and the identity ``local_rows``,
    at two processes."""
    res = []
    outs = [str(tmp_path / f"c{pid}.json") for pid in range(2)]
    _spawn(lambda pid, port: [sys.executable, os.path.abspath(__file__),
                              "collectives", str(pid), "2", str(port),
                              outs[pid]], 2)
    for o in outs:
        with open(o) as f:
            res.append(json.load(f))
    for pid, r in enumerate(res):
        assert r["multiprocess"] and r["count"] == 2 and r["rank"] == pid
        assert r["and_mixed"] is False and r["and_all"] is True
        assert r["max"] == [8.0, 0.0] and r["min"] == [3.0, -1.0]
        assert r["rows"] == [float(i + pid) for i in range(4)]
        assert r["replicated"] == [1.0, 1.0, 1.0]


def test_collectives_concurrent_pairs_exit_cleanly(tmp_path):
    """The teardown under load: 6 pairs of the ``collectives`` worker at
    once, twice, and every process exits 0 with its results right. Before
    ``shutdown`` left the group at exit, about 1 process in 24 aborted in
    its C++ teardown at this load (rc 134, after writing its results)."""
    import concurrent.futures as cf

    def pair(tag: str) -> None:
        outs = [str(tmp_path / f"{tag}_{pid}.json") for pid in range(2)]
        _spawn(lambda pid, port: [sys.executable, os.path.abspath(__file__),
                                  "collectives", str(pid), "2", str(port),
                                  outs[pid]], 2, 120)
        for pid, o in enumerate(outs):
            with open(o) as f:
                r = json.load(f)
            assert r["rank"] == pid and r["replicated"] == [1.0] * 3, r

    for rnd in range(2):
        with cf.ThreadPoolExecutor(6) as ex:
            list(ex.map(pair, [f"r{rnd}p{i}" for i in range(6)]))


ORPHAN_TIMEOUT_S = 20.0


@pytest.mark.parametrize("then", ["collective", "shutdown"])
@pytest.mark.parametrize("victim", [0, 1])
def test_peer_killed_after_join_does_not_hang(victim, then, tmp_path):
    """A peer killed after the join: the survivor's next collective, or
    its teardown, raises within the group's timeout (gloo sees the closed
    connection), and the survivor exits; it never hangs at exit. Rank 0,
    which hosts the group's store, and rank 1 each take both roles."""
    port = _free_port()
    outs = [str(tmp_path / f"o{pid}.json") for pid in range(2)]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "orphan", str(pid), "2",
         str(port), outs[pid], str(victim), then], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE) for pid in range(2)]
    survivor = 1 - victim
    try:
        procs[survivor].communicate(timeout=ORPHAN_TIMEOUT_S + 40)
        procs[victim].communicate(timeout=10)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert procs[victim].returncode == -9
    with open(outs[survivor]) as f:
        r = json.load(f)
    assert r["raised"] and r["seconds"] < ORPHAN_TIMEOUT_S, r


def test_shutdown_without_a_group_is_a_noop():
    """``shutdown`` in a process that joined no group does nothing, so the
    entry points call it unconditionally, and twice is harmless."""
    import torch

    from distributed_deep_q_tpu_torch.parallel import multihost

    multihost.shutdown()
    multihost.shutdown()
    assert not torch.distributed.is_initialized()


def _cli(pid: int, port: int, preset: str, *sets: str) -> list[str]:
    return [sys.executable, "-m", "distributed_deep_q_tpu_torch.main",
            "train", "--preset", preset, "--backend", "cpu", "--set",
            f"mesh.coordinator=127.0.0.1:{port}", "mesh.num_processes=2",
            f"mesh.process_id={pid}", "train.eval_every=0",
            "train.keep_best_eval=false", *sets]


def test_cli_train_two_process():
    """``main train`` on two processes, the same command but the process
    id: CartPole, each process its own env and replay, the gradient mean
    across them, the learn gate shared. The summary is process 0's."""
    pytest.importorskip("gymnasium")
    outs = _spawn(lambda pid, port: _cli(
        pid, port, "cartpole", "train.total_steps=300",
        "replay.learn_start=150", "train.eval_episodes=1",
        "replay.batch_size=64"), 2)
    summary = json.loads(outs[0].strip().splitlines()[-1])
    assert summary["mode"] == "train" and "eval_return" in summary
    assert summary["grad_steps"] > 0


def test_cli_train_two_process_pixel_per():
    """``main train`` on two processes with pixels: SignalAtari 36×36, a
    host frame replay with PER on each process, whose priorities come back
    through ``local_rows``."""
    outs = _spawn(lambda pid, port: _cli(
        pid, port, "pong", "env.kind=signal_atari", "env.id=signal",
        "env.frame_shape=36,36", "net.frame_shape=36,36",
        "net.compute_dtype=float32", "replay.device_resident=false",
        "replay.prioritized=true", "replay.device_per=false",
        "replay.capacity=4096", "replay.batch_size=16",
        "replay.learn_start=300", "replay.write_chunk=16",
        "train.total_steps=600", "train.train_every=4",
        "train.target_update_period=20", "train.eval_episodes=1"), 2)
    summaries = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    assert summaries[0]["mode"] == "train" and "eval_return" in summaries[0]
    assert summaries[0]["grad_steps"] == summaries[1]["grad_steps"] > 0


def test_cli_device_resident_pixels_refused_two_process():
    """The in-process loop's device frame ring is single-process, refused
    at two processes by the reference's message."""
    outs = []
    with pytest.raises(AssertionError, match="device_resident=false"):
        outs = _spawn(lambda pid, port: _cli(
            pid, port, "pong", "env.kind=signal_atari", "env.id=signal",
            "env.frame_shape=36,36", "net.frame_shape=36,36",
            "net.compute_dtype=float32", "train.total_steps=10"), 2, 120)
    assert not outs


def _dist(tmp_path, mode: str, steps: int) -> list[dict]:
    outs = [str(tmp_path / f"d{pid}.json") for pid in range(2)]
    _spawn(lambda pid, port: [sys.executable, os.path.abspath(__file__),
                              "dist", str(pid), "2", str(port), outs[pid],
                              mode, str(steps)], 2, 300)
    res = []
    for o in outs:
        with open(o) as f:
            res.append(json.load(f))
    for r in res:
        assert r["finite"], r
        assert r["env_steps"] > 0, f"process {r['pid']}'s slice never fed"
        assert r["grad_steps"] == steps
    assert res[0]["theta"] == res[1]["theta"]
    return res


def test_distributed_fused_per_two_process(tmp_path):
    """``--distributed`` on two processes × 1 actor, the fused PER ring:
    both processes' shards fed with pixels, priorities moved off the
    fresh-row seed, grad steps exact, θ equal on both."""
    for r in _dist(tmp_path, "pixel_fused", 24):
        assert r["streams"] == 1          # this process's one actor
        assert r["ring_nonzero"] and r["prio_moved"], r


def test_distributed_recurrent_fused_two_process(tmp_path):
    """The r2d2 fused sequence ring under ``--distributed`` on two
    processes × 1 actor."""
    for r in _dist(tmp_path, "r2d2_fused", 12):
        assert r["ring_nonzero"] and r["prio_moved"], r


def test_distributed_rpc_fleet_two_process(tmp_path):
    """Two processes × 2 CartPole actors; process 0 kills one of its
    actors mid-run and its supervisor respawns it."""
    pytest.importorskip("gymnasium")
    res = _dist(tmp_path, "cartpole", 400)
    by_pid = {r["pid"]: r for r in res}
    assert by_pid[0]["actor_restarts"] >= 1


if __name__ == "__main__":
    mode, pid, nproc, port, out, *rest = sys.argv[1:]
    WORKERS[mode](int(pid), int(nproc), port, out, *rest)
