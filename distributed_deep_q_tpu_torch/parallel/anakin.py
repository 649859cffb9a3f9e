"""Anakin mode — acting, replay insert and training in one superstep on the
card (port of the reference ``parallel/anakin.py``).

The Podracer paper's Anakin endpoint puts the environment on the
accelerator: the ``signal_atari`` family has a tensor port
(``ops/device_envs.py``), so the whole act → insert → learn loop runs on
the device and the host only issues it. This is a MODE of the system, not
a fork:

- the replay ring is the SAME ``DevicePERFrameReplay`` allocation the
  fused path trains from (padded frame plane, ghost rows, metadata and
  priority rows, inserted through ``insert_meta_pack`` + the ``scatter_rows``
  kernel); only the cursor/size bookkeeping moves from the host slot
  objects onto the device;
- the train stage is the learner's fused chain (``fused_sample`` → one
  ``gather_windows`` launch → ``Learner._train_chain``);
- the sampling keys and β come from the fused path's own schedules
  (``next_fused_keys``, ``next_betas``), so an Anakin run and a host-driven
  run of the same config draw the same samples.

Superstep, in order, issued eagerly on the device's stream::

    act (T ticks):  batched ε-greedy forward through θ as it stood at the
                    superstep's start, then the batched env step
    ring insert:    T·E rows → one meta pack + ONE scatter_rows launch
                    (main, ghost and scratch lanes), the metadata and
                    priority rows, the device cursors and sizes
    sample:         chunk CDF + pack + all-chain draws + ONE gather_windows
    train (chain):  the fused chain's grad steps + priority scatters, and
                    the learning-dynamics plane under train.learn_metrics

Env↔slot identity: with ``num_envs == num_slots`` every env owns one
sub-ring, so ``cursor = (cursor + T) % slot_cap``. The D shards
(``mesh.dp``) hold ``E = num_envs / D`` envs each: env ``p = s·E + e`` is
shard s's sub-ring e, which is stream ``e·D + s`` (the reference's ``gid``),
the routing ``add_batch(stream=gid)`` follows. The reference inserts shard
by shard; the port inserts every shard's rows with one launch.

Nothing is read back inside a superstep: the metrics and ``act_reward``
stay device tensors the caller reads at its own cadence.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from distributed_deep_q_tpu_torch import tracing
from distributed_deep_q_tpu_torch.config import Config
from distributed_deep_q_tpu_torch.ops import threefry
from distributed_deep_q_tpu_torch.ops.device_envs import make_device_env
from distributed_deep_q_tpu_torch.ops.ring_gather import scatter_rows
from distributed_deep_q_tpu_torch.parallel.learner import (
    TrainState, fused_sample)
from distributed_deep_q_tpu_torch.replay.device_per import (
    DeviceReplayState, give_device_state, insert_meta_pack,
    take_device_state)
from distributed_deep_q_tpu_torch.replay.device_ring import to_device
from distributed_deep_q_tpu_torch.solver import (
    Solver, fused_spec, next_fused_keys)


@torch.no_grad()
def act_tick(net, step_fn, frame_shape, eps: torch.Tensor, env_state,
             buf: torch.Tensor, akeys: torch.Tensor):
    """One batched ε-greedy acting tick over ``n`` co-resident envs — the
    one copy of the per-tick acting math, shared by the superstep and its
    host-driven twin.

    ``buf`` is the batched frame stacker ``[n, stack, H·W]`` u8 (newest
    frame last); ``akeys`` the per-env action keys ``[n, 2]``; ``eps`` the
    per-env ε ladder ``[n]``. The env auto-resets inside ``step_fn`` and the
    stacker row restarts from the new episode's first frame (zeros + that
    frame).

    Returns ``(env_state, buf, akeys, record)``: ``record`` is the row the
    host actor would flush — the PRE-step frame, the action, the reward and
    the done flag (the signal envs end on their step cap, so done is also
    the episode boundary).
    """
    n, stack = buf.shape[0], buf.shape[1]
    h, w = frame_shape
    q = net.forward_nchw(buf.view(n, stack, h, w))
    greedy = q.argmax(dim=-1).to(torch.int32)
    k3 = threefry.split(akeys, 3)
    akeys, ku, kr = k3[:, 0], k3[:, 1], k3[:, 2]
    u = threefry.uniform(ku)
    ra = threefry.randint(kr, 0, q.shape[-1])
    action = torch.where(u < eps, ra, greedy)
    env_state, frame, reward, done = step_fn(env_state, action)
    frow = frame.reshape(n, 1, -1)
    pushed = torch.cat([buf[:, 1:], frow], dim=1)
    fresh = torch.cat([torch.zeros_like(buf[:, 1:]), frow], dim=1)
    record = {"frame": buf[:, -1], "action": action,
              "reward": reward.float(), "done": done}
    buf = torch.where(done[:, None, None], fresh, pushed)
    return env_state, buf, akeys, record


class AnakinRunner:
    """Owner of the Anakin superstep: the device state, the issue of each
    superstep, and the seam back into the ``Solver`` and the replay.

    Construction derives everything from the config the fused path reads:
    ``actors.anakin_envs`` co-resident envs (0 = one per shard),
    ``actors.anakin_ticks`` env ticks per superstep, ``replay.fused_chain``
    grad steps per superstep, and the Ape-X ε ladder from
    ``eps_base``/``eps_alpha`` keyed by stream id. All envs run ``cfg.env``.

    While the runner lives it owns the replay's device rows
    (``replay.dstate`` is None); ``sync_solver()`` hands them back, with
    θ, θ⁻, the Adam state and the step already in ``solver.state`` (the
    runner trains that state in place), so checkpoints, ``q_values`` and
    weight publishing keep working — the mode seam.
    """

    def __init__(self, cfg: Config, solver: Solver | None = None,
                 replay=None):
        from distributed_deep_q_tpu_torch.actors.supervisor import (
            actor_epsilon)
        from distributed_deep_q_tpu_torch.replay.device_per import (
            DevicePERFrameReplay)

        if cfg.mesh.num_processes > 1:
            # no reference test or preset runs Anakin on more than one
            # process; its superstep owns one device's ring
            raise NotImplementedError(
                f"Anakin at mesh.num_processes={cfg.mesh.num_processes}: "
                "the superstep runs in one learner process (ROADMAP, the "
                "refusals still in the port)")
        self.cfg = cfg
        h, w = cfg.env.frame_shape
        stack = int(cfg.env.stack)
        self.frame_shape = (h, w)
        self.solver = solver or Solver(cfg, obs_dim=h * w * stack)
        dev = self.device = self.solver.device
        assert cfg.train.optimizer == "adam", (
            "Anakin reuses the plane-carry train body, which requires "
            "adam and no model-parallel axis (learner.py use_plane)")
        d = self.solver.num_shards
        n = int(cfg.actors.anakin_envs) or d
        assert n % d == 0, f"anakin_envs={n} must divide over {d} dp shards"
        self.num_envs, self.num_shards = n, d
        self.envs_per_shard = n // d
        self._reset_fn, self._step_fn = make_device_env(cfg.env)
        self.replay = replay or DevicePERFrameReplay(
            cfg.replay, dev, self.frame_shape, stack, cfg.train.gamma,
            seed=cfg.train.seed, write_chunk=cfg.replay.write_chunk,
            num_streams=n, num_shards=d)
        rp = self.replay
        assert rp.num_slots == n and rp.subs_per_shard == n // d, (
            "env↔slot identity needs one slot per env: raise anakin_envs "
            "to a multiple of the dp shard count")
        self.ticks = int(cfg.actors.anakin_ticks)
        assert 0 < self.ticks <= rp.slot_cap, (
            f"anakin_ticks={self.ticks} must stay within one sub-ring "
            f"(slot_cap={rp.slot_cap}) so a superstep's row targets are "
            "distinct")
        self.chain = max(int(cfg.replay.fused_chain), 1)
        assert cfg.replay.batch_size % d == 0
        self._spec = fused_spec(cfg, rp)

        # env at plane position p = shard·E + e is stream e·D + shard —
        # the routing add_batch(stream=gid) follows (the identity at D = 1)
        e_per = self.envs_per_shard
        self.stream_ids = np.array(
            [(p % e_per) * d + (p // e_per) for p in range(n)], np.int64)
        self._eps = to_device(np.array(
            [actor_epsilon(int(g), n, cfg.actors.eps_base,
                           cfg.actors.eps_alpha) for g in self.stream_ids],
            np.float32), dev)

        # per-env key streams: env 1000·(gid+1), ε 7777·(gid+1), as the
        # reference derives them (bitwise jax.random's, ops/threefry.py)
        base = threefry.prng_key(cfg.train.seed, dev)
        gids = torch.as_tensor(self.stream_ids, device=dev)
        env_keys = threefry.fold_in(base, 1000 * (gids + 1))
        self.act_keys0 = threefry.fold_in(base, 7777 * (gids + 1))
        env_state, frames = self._reset_fn(env_keys)
        buf = torch.zeros((n, stack, rp._row_len), dtype=torch.uint8,
                          device=dev)
        buf[:, -1] = frames.reshape(n, -1)
        self._env = (env_state, buf, self.act_keys0.clone())
        self._cursors = torch.zeros(n, dtype=torch.int32, device=dev)
        self._sizes = torch.zeros(n, dtype=torch.int32, device=dev)
        # the insert's constant lanes: source rows 0..k-1 twice (main,
        # ghost), the tick offsets, and each env's first metadata row and
        # first padded frame row (shard s, sub-ring e)
        k = self.ticks * n
        self._sidx = torch.arange(k, dtype=torch.int32,
                                  device=dev).repeat(2)
        self._t_i = torch.arange(self.ticks, dtype=torch.int32,
                                 device=dev)[:, None]
        p = np.arange(n)
        shard, e = p // e_per, p % e_per
        self._row0 = to_device(
            (shard * rp.cap_local + e * rp.slot_cap)[None, :].astype(
                np.int64), dev)
        self._pad0 = to_device(
            (shard * rp.shard_rows + e * rp.slot_pad)[None, :].astype(
                np.int32), dev)
        if self.solver._fused_key_base is None:
            # anchor the key schedule now (its one read of the step), so
            # no superstep reads the device
            next_fused_keys(self.solver, d, 0)
        self.ring: DeviceReplayState | None = take_device_state(rp)
        self.last_metrics: dict[str, Any] | None = None
        self.last_act_reward: torch.Tensor | None = None
        self.supersteps_run = 0

    # -- the superstep -----------------------------------------------------

    def _act(self):
        """T ticks against θ as it stands (the train stage runs after all
        of them, so θ is frozen for the superstep). Returns the records
        stacked ``[T, E, ...]``."""
        net = self.solver.state.net
        env_state, buf, akeys = self._env
        recs = []
        for _ in range(self.ticks):
            env_state, buf, akeys, rec = act_tick(
                net, self._step_fn, self.frame_shape, self._eps, env_state,
                buf, akeys)
            recs.append(rec)
        self._env = (env_state, buf, akeys)  # ddq: allow(purity.captured-write) — superstep state rebound to new tensors: a CUDA graph needs it copied into static buffers (ROADMAP item 8)
        return {key: torch.stack([r[key] for r in recs]) for key in recs[0]}

    def _insert(self, recs) -> None:
        """The device twin of the flush: T·N rows through one meta pack and
        ONE ``scatter_rows`` launch (main lanes, ghost lanes where
        ``local < window − 1``, the rest aimed at shard 0's scratch row),
        then the metadata, priority, cursor and size updates."""
        rp, ds = self.replay, self.ring
        slot_cap, window, scratch = rp.slot_cap, rp.window, rp.cap_local_pad
        k = self.ticks * self.num_envs
        local = (self._cursors[None, :] + self._t_i) % slot_cap     # [T, N]
        midx = (self._row0 + local).reshape(-1)
        main = self._pad0 + local
        ghost = torch.where(local < window - 1, main + slot_cap,
                            torch.full_like(local, scratch))
        didx = torch.cat([main.reshape(-1), ghost.reshape(-1)])
        packed, new_p = insert_meta_pack(
            recs["frame"].reshape(-1), ds.maxp, k=k, row_len=rp._row_len,
            rowb=rp.rowb, alpha=rp._alpha)
        scatter_rows(self._sidx, didx.to(torch.int32), packed, ds.frames,
                     n=2 * k, rowb=rp.rowb, skip_row=scratch)
        dn = recs["done"].reshape(-1).to(torch.uint8)
        ds.action[midx] = recs["action"].reshape(-1).to(torch.int32)
        ds.reward[midx] = recs["reward"].reshape(-1)
        ds.done[midx] = dn
        ds.boundary[midx] = dn
        ds.prio[midx] = new_p
        self._cursors = (self._cursors + self.ticks) % slot_cap  # ddq: allow(purity.captured-write) — superstep state rebound to new tensors: a CUDA graph needs it copied into static buffers (ROADMAP item 8)
        self._sizes = torch.clamp(self._sizes + self.ticks, max=slot_cap)  # ddq: allow(purity.captured-write) — superstep state rebound to new tensors: a CUDA graph needs it copied into static buffers (ROADMAP item 8)

    def superstep(self) -> dict[str, torch.Tensor]:
        """One act + insert + sample + train superstep, issued on the
        device's stream. Returns the chain's metrics ``[chain]`` (device
        tensors; ``learn_plane`` under ``train.learn_metrics``)."""
        solver, chain, spec = self.solver, self.chain, self._spec
        if self.ring is None:   # handed back by sync_solver: take it again
            self.ring = take_device_state(self.replay)
        keys = next_fused_keys(solver, self.num_shards, chain)
        u = solver.draw_uniforms(keys.reshape(-1, 2), spec[8], self.device)
        betas = to_device(self.replay.next_betas(chain), self.device)
        # the span times the host's issue of the superstep, not the device
        with tracing.span("anakin_superstep"):
            recs = self._act()
            self._insert(recs)
            rows = self.ring._asdict()
            metas, win, idxs, _ = fused_sample(
                rows, self._cursors, self._sizes, betas, u, spec)
            maxp, metrics = solver.learner._train_chain(
                solver.state, rows, metas, win, idxs, spec,
                bool(self.cfg.train.learn_metrics))
        self.ring = self.ring._replace(maxp=maxp)
        self.last_metrics = metrics
        self.last_act_reward = recs["reward"].mean()
        self.supersteps_run += 1
        return metrics

    def run(self, supersteps: int) -> dict[str, np.ndarray]:
        """``supersteps`` supersteps back to back, then ``sync_solver``.
        Returns the last chain's metrics on the host (the one read, at
        the end)."""
        for _ in range(int(supersteps)):
            self.superstep()
        self.sync_solver()
        return {k: v.detach().cpu().numpy()
                for k, v in (self.last_metrics or {}).items()}

    @property
    def env_steps(self) -> int:
        return self.supersteps_run * self.ticks * self.num_envs

    @property
    def grad_steps(self) -> int:
        return self.supersteps_run * self.chain

    def sync_solver(self) -> TrainState:
        """Hand the ring back to the replay. θ, θ⁻, the Adam state and the
        step were trained in place in ``solver.state``, so they are
        already there; a later superstep takes the ring again."""
        if self.ring is not None:
            give_device_state(self.replay, self.ring)
            self.ring = None
        return self.solver.state


def run_anakin(cfg: Config, supersteps: int) -> dict[str, Any]:
    """Entry point: build a runner, train, return the last chain's metrics
    with the acting reward folded in (``act_reward``) and the runner under
    ``runner`` (its ``solver`` holds the trained state). Anakin is selected
    explicitly, not inferred (the reference has no CLI entry for it, and
    neither does the port)."""
    runner = AnakinRunner(cfg)
    out: dict[str, Any] = runner.run(supersteps)
    out["act_reward"] = float(runner.last_act_reward)
    out["runner"] = runner
    return out
