"""The recurrent (R2D2) sequence learner and its solver (port of the
reference ``parallel/sequence_learner.py``).

One grad step (``SequenceLearner._step_core``):

1. the torso once per net over all ``B·(T+1)`` frames, burn-in included
   (``R2d2QNet.features``), as the reference's stacked route computes it;
2. burn-in: each net's LSTM advances the STORED carry over the first
   ``burn_in`` steps; the online carry is detached, so burn-in trains
   nothing;
3. the train window: θ, then θ⁻, unroll over the remaining steps;
4. per-step Double-DQN targets with value rescaling, the masked loss and
   the per-sequence priority η·max|TD| + (1−η)·mean|TD|;
5. autograd, the global norm, and the optimizer + target refresh of
   ``parallel/learner.py`` (clip + Adam, or the clipped RMSProp).

Three ways in, as in the reference: a host batch of stacked observations
(``train_step``), an index batch into the device sequence ring whose
windows one ``gather_windows`` launch copies (``train_step_from_ring``),
and the chained fused path (``train_steps_fused``): sampling, metadata,
pixels and priorities all on the device, ``chain`` steps per dispatch,
one ``gather_windows`` launch for all of their windows. With
``train.learn_metrics`` the fused path also carries the learning-dynamics
plane (``learning.py``) across the chain, fed with the per-sequence
priority as |TD| (the reference's R2D2 chain has no ``use_plane`` gate).

The reference's ``stack_forwards`` route changes XLA's op schedule only;
the port computes the same function one net at a time. The reference's D
shards each step over B/D sequences and ``pmean`` the gradients; the port
draws per shard, then steps once over all of the process's sequences (the
same mean at equal B/D per shard, up to float order). With more than one
learner process (``parallel/multihost.py``) the step's gradients, loss and
Q mean are averaged over the processes in one all-reduce, the fused
sample's filled count is summed and its IS weights' max taken over them,
and, under ``train.learn_metrics``, the step's Q max too.
"""

from __future__ import annotations

from collections.abc import Callable
from typing import Any

import numpy as np
import torch

from distributed_deep_q_tpu_torch import learning, tracing
from distributed_deep_q_tpu_torch.config import Config
from distributed_deep_q_tpu_torch.models.qnet import R2d2QNet
from distributed_deep_q_tpu_torch.ops.losses import (
    sequence_bellman_targets, sequence_dqn_loss)
from distributed_deep_q_tpu_torch.ops.ring_gather import gather_windows
from distributed_deep_q_tpu_torch.parallel import multihost
from distributed_deep_q_tpu_torch.parallel.learner import (
    Learner, TrainState, apply_optimizer, global_norm)
from distributed_deep_q_tpu_torch.replay.device_per import (
    build_cdf, draw_from_cdf, scatter_priorities, stratified_is_weights,
    to_batch_order)
from distributed_deep_q_tpu_torch.replay.device_ring import to_device
from distributed_deep_q_tpu_torch.replay.device_sequence import (
    META_KEYS, compose_sequence_block)
from distributed_deep_q_tpu_torch.solver import (
    Solver, _strip_host_keys, next_fused_keys)


def fused_sequence_sample(replay, batch_size: int, sizes: torch.Tensor,
                          betas: torch.Tensor, u: torch.Tensor):
    """The sample stage of a fused sequence dispatch: per shard of this
    process, draw every step's B/D sequences from that shard's chunk-start
    priorities by inverse CDF over its uniforms (``u`` ``[Dl, chain,
    B/D]``; a ``[chain, B]`` at one shard reads the same), gather their
    metadata and IS weights (normalized over every shard of every
    process), and copy all their windows with ONE ``gather_windows``
    launch. ``batch_size`` is this process's rows (``Dl · B/D``). Returns,
    in batch order (the shards' draws concatenated), (metas [chain,
    batch_size, ...] with ``weight``, windows ``[chain, batch_size, W,
    rowp]`` int32, sampled slots of this process's device rows [chain,
    batch_size], set to its capacity (out of range) on a shard whose mass
    is 0)."""
    d, caps = len(replay.local_shards), replay.caps_local
    dmeta, W = replay.dmeta, replay.W
    chain, dev = betas.shape[0], u.device
    u = u.reshape(d, chain, batch_size // d)
    filled = (torch.arange(caps, device=dev)[None, :]
              < sizes.view(d, 1)).float()                 # [Dl, caps]
    pm = dmeta["prio"].view(d, caps) * filled
    cdf, mass = build_cdf(pm)
    n_glob = multihost.all_reduce_(filled.sum())          # the psum
    li, p = draw_from_cdf(u, cdf, pm, mass)               # [Dl, chain, b]
    shard = torch.arange(d, device=dev).view(d, 1, 1)
    flat = to_batch_order(shard * caps + li).reshape(-1)
    metas = {key: dmeta[key][flat].reshape(
        (chain, batch_size) + dmeta[key].shape[1:]) for key in META_KEYS}
    metas["weight"] = to_batch_order(
        stratified_is_weights(p, mass, n_glob, betas, replay.num_shards))
    slots = to_batch_order(replay.ring_slot(shard, li)).reshape(-1)
    win = gather_windows((slots * W).to(torch.int32), replay.ring,
                         n=chain * batch_size, w=W, rowb=replay.rowb)
    win = win.view(chain, batch_size, W, replay.rowp)
    # a zero-mass draw writes no priority (scatter_priorities drops it)
    dead = to_batch_order((~(mass > 0)).view(d, 1, 1).expand(li.shape))
    idx = flat.view(chain, batch_size)
    idx = torch.where(dead, torch.full_like(idx, replay.local_capacity), idx)
    return metas, win, idx


class SequenceLearner(Learner):
    """Owns the R2D2 train step on one device."""

    def __init__(self, config: Config, device: torch.device):
        super().__init__(config.train, device)
        self.burn_in = int(config.replay.burn_in)

    def _step_core(self, state: TrainState, batch: dict[str, torch.Tensor],
                   features: Callable[[R2d2QNet, torch.Tensor],
                                      torch.Tensor]):
        """Burn-in + train-window unroll + masked loss + optimizer on one
        batch on the device. ``features(net, obs)`` is the torso method
        for ``obs``'s layout (``R2d2QNet.features_stacked`` for the ring's
        ``[B, T+1, stack, H·W]`` planes, ``R2d2QNet.features`` for a host
        batch). Updates ``state`` in place; returns (metrics, per-sequence
        priority). The three spans time the host's enqueue of each pass,
        as ``Learner._step_core``'s do."""
        cfg, burn = self.cfg, self.burn_in
        net, target = state.net, state.target_net
        obs = batch["obs"]
        carry0 = (batch["init_c"], batch["init_h"])
        with tracing.span("step_forward"):  # ddq: allow(purity.time) — the host enqueue's span: a CUDA graph over this path must drop or hoist it (ROADMAP D1)
            f_on = features(net, obs)
            with torch.no_grad():
                f_tg = features(target, obs)
                if burn > 0:
                    # the online carry is cut at the burn-in seam
                    carry_on = net.burn_carry(f_on[:, :burn], carry0)
                    carry_tg = target.burn_carry(f_tg[:, :burn], carry0)
                else:
                    carry_on = carry_tg = carry0
            q_all, _ = net.recur(f_on[:, burn:], carry_on)
            with torch.no_grad():
                q_tgt_all, _ = target.recur(f_tg[:, burn:], carry_tg)
            q = q_all[:, :-1]                              # [B, T, A]
            targets = sequence_bellman_targets(
                batch["reward"][:, burn:], batch["discount"][:, burn:],
                q_tgt_all[:, 1:], q_all[:, 1:].detach(),
                double=cfg.double_dqn, rescale=cfg.value_rescale)
            loss, priority = sequence_dqn_loss(
                q, batch["action"][:, burn:], targets,
                batch["mask"][:, burn:], batch["weight"], cfg.huber_delta,
                eta=cfg.priority_eta)
        params = dict(net.named_parameters())
        with tracing.span("step_backward"):  # ddq: allow(purity.time) — the host enqueue's span: a CUDA graph over this path must drop or hoist it (ROADMAP D1)
            grads = dict(zip(params, torch.autograd.grad(
                loss, list(params.values()))))
            # the reference's pmean of grads, loss and Q mean, before the
            # clip
            grads, (loss, q_mean) = multihost.mean_grads_and_scalars(
                grads, [loss.detach(), q.detach().mean()])
            gnorm = global_norm(grads)
        with tracing.span("step_optimizer"):  # ddq: allow(purity.time) — the host enqueue's span: a CUDA graph over this path must drop or hoist it (ROADMAP D1)
            state.step = state.step + 1
            apply_optimizer(cfg, grads, state.opt_state, params,
                            dict(target.named_parameters()), gnorm,
                            state.step)
        metrics = {"loss": loss, "q_mean": q_mean, "grad_norm": gnorm}
        if cfg.learn_metrics:
            # the recurrent step's Q extreme, the plane's q input, as the
            # reference pmaxes it
            metrics["q_max"] = multihost.all_reduce_(q.detach().max(), "max")
        return metrics, priority

    def train_step(self, state: TrainState, batch: dict[str, Any]):
        """One step on a host batch: ``obs [B, T+1, ...]`` in the
        reference's layout plus the sequence metadata. Returns (metrics,
        per-sequence priority [B])."""
        return self._step_core(state, self._to_device(batch),
                               R2d2QNet.features)

    def train_step_from_ring(self, state: TrainState, replay,
                             batch: dict[str, Any]):
        """One step on an index batch into ``replay``'s device ring
        (``DeviceSequenceReplay.sample``, B/D rows per shard in shard
        order, slots local to their shard): ONE ``gather_windows`` launch
        copies each sequence's ``W`` contiguous rows, the stacks are static
        slices of them. Returns (metrics, per-sequence priority [B])."""
        b = len(batch["seq_local"])
        shard = np.arange(b) // (b // replay.num_shards)
        slots = replay.ring_slot(shard, np.asarray(batch["seq_local"]))
        win = gather_windows(to_device((slots * replay.W).astype(np.int32),
                                       self.device),
                             replay.ring, n=b, w=replay.W, rowb=replay.rowb)
        meta = self._to_device({k: v for k, v in batch.items()
                                if k not in ("seq_local", "n_valid")})
        meta["obs"] = compose_sequence_block(
            win.view(b, replay.W, replay.rowp), meta["mask"], replay.seq_len,
            replay.stack, replay._row_len)
        return self._step_core(state, meta, R2d2QNet.features_stacked)

    def train_steps_fused(self, state: TrainState, replay, batch_size: int,
                          sizes: torch.Tensor, betas: torch.Tensor,
                          u: torch.Tensor):
        """``len(betas)`` fused sequence steps: the sample stage
        (``fused_sequence_sample``) from the chunk-start priorities and
        the uniforms ``u`` [chain, B], then the steps in order, each
        scattering its priorities into ``replay.dmeta["prio"]`` in place.
        Returns (new running max priority, metrics stacked over
        ``[chain]``, with the dispatch's ``learn_plane`` under
        ``learn_metrics``)."""
        # the spans time the host's enqueue of the sample stage and of the
        # train stage, as Learner's do
        with tracing.span("sample"):  # ddq: allow(purity.time) — the host enqueue's span: a CUDA graph over this path must drop or hoist it (ROADMAP D1)
            metas, win, idx = fused_sequence_sample(replay, batch_size,
                                                    sizes, betas, u)
        with tracing.span("train_step"):  # ddq: allow(purity.time) — the host enqueue's span: a CUDA graph over this path must drop or hoist it (ROADMAP D1)
            prio, maxp = replay.dmeta["prio"], replay.dmaxp
            lmp = (learning.lm_init(self.device) if self.cfg.learn_metrics
                   else None)
            steps = []
            for i in range(betas.shape[0]):
                batch = {key: metas[key][i] for key in metas}
                batch["obs"] = compose_sequence_block(
                    win[i], batch["mask"], replay.seq_len, replay.stack,
                    replay._row_len)
                metrics, priority = self._step_core(
                    state, batch, R2d2QNet.features_stacked)
                maxp = scatter_priorities(prio, maxp, idx[i], priority,
                                          replay.alpha, replay.eps)
                if lmp is not None:
                    learning.lm_update(
                        lmp, cfg=self.cfg, td_abs=priority,
                        weight=batch["weight"], loss=metrics["loss"],
                        q=metrics["q_max"], q_mean=metrics["q_mean"],
                        gnorm=metrics["grad_norm"], step=state.step,
                        alpha=replay.alpha, eps=replay.eps)
                steps.append(metrics)
            # the running max over processes, once per dispatch (see
            # Learner._train_chain)
            maxp = multihost.all_reduce_(maxp, "max")
            stacked = {k: torch.stack([m[k] for m in steps])
                       for k in steps[0]}
            if lmp is not None:
                stacked["learn_plane"] = learning.lm_finalize(
                    lmp, replay.num_shards)
            return maxp, stacked


class SequenceSolver(Solver):
    """``Solver`` for recurrent (r2d2) nets: the three train steps of
    ``SequenceLearner``, and the recurrent actor path, whose carry is a
    host ``(c, h)`` pair of float32 arrays ``[B, H]`` (what the
    ``SequenceBuilder`` stores). Weight IO and the reference-layout train
    state are ``Solver``'s."""

    def __init__(self, config: Config, obs_dim: int = 4,
                 backend: str | None = None):
        if config.net.kind != "r2d2":
            raise ValueError("SequenceSolver is for r2d2 nets")
        self._setup(config, obs_dim, backend, SequenceLearner)

    def train_step(self, batch: dict[str, Any]) -> dict[str, Any]:
        """One step on a host sequence batch (``SequenceReplay.sample``);
        ``td_abs`` is the per-sequence priority."""
        metrics, priority = self.learner.train_step(self.state,
                                                    _strip_host_keys(batch))
        return self._with_feedback(metrics, priority, batch)

    def train_step_from_ring(self, replay, batch: dict[str, Any],
                             ) -> dict[str, Any]:
        """One step on an index batch into a ``DeviceSequenceReplay``."""
        metrics, priority = self.learner.train_step_from_ring(
            self.state, replay, _strip_host_keys(batch))
        return self._with_feedback(metrics, priority, batch)

    def train_steps_eager(self, replay,
                          chain: int | None = None) -> dict[str, Any]:
        """``chain`` fused sequence steps in one dispatch (the protocol of
        ``Solver.train_steps_device_per``, so ``FusedStepStream`` drives
        either). Returns metrics stacked ``[chain]``."""
        chain = chain or max(int(self.config.replay.fused_chain), 1)
        dev, b = self.device, self.local_batch
        with tracing.span("dispatch_inputs"):
            if replay.pending_rows():
                replay.flush()
            sizes = to_device(replay.device_inputs(), dev)
            betas = to_device(replay.next_betas(chain), dev)
            # each of this process's shards draws with its global shard's
            # keys
            keys = next_fused_keys(self, replay.num_shards, chain)[
                replay.local_shards]
            u = self.draw_uniforms(keys.reshape(-1, 2),
                                   b // len(replay.local_shards), dev)
        replay.dmaxp, metrics = self.learner.train_steps_fused(
            self.state, replay, b, sizes, betas, u)
        self.dispatch_counts["eager_dispatches"] += 1
        return metrics

    # the sequence dispatch is never captured: it always runs eagerly
    train_steps_device_per = train_steps_eager

    # -- recurrent actor path ----------------------------------------------

    def initial_state(self, batch_size: int = 1):
        z = np.zeros((batch_size, self.config.net.lstm_size), np.float32)
        return (z, z.copy())

    @torch.no_grad()
    def q_values(self, obs: np.ndarray, carry):
        """``obs [B, ...]``, one step → (q ``[B, A]``, next carry), both on
        the host (one copy back for the three)."""
        dev = self.device
        x = torch.from_numpy(np.ascontiguousarray(obs)[:, None]).to(dev)
        c, h = (torch.from_numpy(np.asarray(v, np.float32)).to(dev)
                for v in carry)
        q, (c2, h2) = self.state.net(x, (c, h))
        a, hsz = q.shape[-1], c2.shape[-1]
        out = torch.cat([q[:, 0], c2, h2], dim=1).cpu().numpy()
        return out[:, :a], (out[:, a:a + hsz], out[:, a + hsz:])

    def act(self, obs: np.ndarray, carry, epsilon: float,
            rng: np.random.Generator):
        """ε-greedy with recurrent state → (action, next carry). The carry
        always advances, a random action included, so the stored actor
        state is what the net saw (the stored-state burn-in needs it)."""
        q, carry = self.q_values(np.asarray(obs)[None], carry)
        if rng.random() < epsilon:
            return int(rng.integers(self.config.net.num_actions)), carry
        return int(np.argmax(q[0])), carry
