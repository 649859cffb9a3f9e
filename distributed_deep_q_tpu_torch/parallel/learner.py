"""The learner: loss, gradients, fused clip+Adam+target refresh, and its
three train steps (port of the reference ``parallel/learner.py``): on a
host batch (``train_step``), on index batches into the device frame ring
(``train_step_from_ring``), and the fused device-PER dispatch
(``train_steps_device_per``).

The reference compiles each step into one XLA program under ``shard_map``
over a ``dp`` mesh: each shard takes the mean loss of its B/D rows and the
gradients are ``pmean``'d. The port runs eagerly on one device per
process and takes one step over the process's rows, its shards' draws
concatenated: at equal B/D per shard that is the same mean, up to float
order. With more than one process (``parallel/multihost.py``) each takes
the mean over its ``B/pc`` rows, and the gradients, the loss and the Q
mean are then averaged over the processes in one all-reduce, before the
clip, as the reference's ``pmean`` does. The
train state is two ``nn.Module``s (θ, θ⁻) plus plain dicts of tensors (the
Adam state) and a step counter, all updated in place.

What the port computes differently from the reference, on purpose:

- The forwards run one net at a time. The reference's ``stack_forwards``
  and ``fuse_double_forward`` change XLA's op schedule, not the function,
  and at the Pong batch (512 per shard > 128) it takes this unstacked path
  too.
- The optimizer is the reference's tree-form ``fused_adam_target_step``;
  its flat "plane-carry" variant is an XLA op-schedule device (it computes
  the same per-element update) and is not ported. Which body the reference
  would have taken still matters in one place: only its plane-carry body
  emits the learning-dynamics plane (``plane_gate``).
- ``train.optimizer=rmsprop`` is optax's centered RMSProp behind the
  reference's ``clip_grads``, written out in the same order
  (``rmsprop_target_step``).
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
from typing import Any

import numpy as np
import torch
from torch import nn

from distributed_deep_q_tpu_torch import learning, tracing
from distributed_deep_q_tpu_torch.config import TrainConfig
from distributed_deep_q_tpu_torch.ops.cuda_build import launch_tally
from distributed_deep_q_tpu_torch.ops.fused_loss import FusedDqnLoss
from distributed_deep_q_tpu_torch.ops.losses import bellman_targets, dqn_loss
from distributed_deep_q_tpu_torch.ops.ring_gather import gather_windows
from distributed_deep_q_tpu_torch.parallel import multihost
from distributed_deep_q_tpu_torch.replay.device_per import (
    build_meta_pack, fused_sample_draw_packed, fused_sample_prep,
    scatter_priorities)
from distributed_deep_q_tpu_torch.replay.device_ring import (
    compose_stacks, to_device)

ADAM_B1, ADAM_B2 = 0.9, 0.999
# optax.rmsprop(lr, decay=0.95, eps=1e-2, centered=True): the reference's
# make_optimizer
RMSPROP_DECAY, RMSPROP_EPS = 0.95, 1e-2
OPTIMIZERS = ("adam", "rmsprop")
_INT32_MAX = 2**31 - 1


@dataclasses.dataclass
class TrainState:
    """θ and θ⁻ as modules; the optimizer state keyed like
    ``net.named_parameters()`` with the optimizer's name beside it —
    ``{"name": "adam", "count": int32 [], "mu": {...}, "nu": {...}}``
    (optax's ``ScaleByAdamState``) or ``{"name": "rmsprop", "mu": {...},
    "nu": {...}}`` (its ``ScaleByRStdDevState``); ``step`` an int32 []
    tensor."""

    net: nn.Module
    target_net: nn.Module
    opt_state: dict[str, Any]
    step: torch.Tensor


def state_tensors(state: TrainState) -> list[torch.Tensor]:
    """Every tensor of a train state: θ, θ⁻, the optimizer's moments (and
    Adam's count) and the step."""
    out = [p.data for p in state.net.parameters()]
    out += [p.data for p in state.target_net.parameters()]
    opt = state.opt_state
    out += list(opt["mu"].values()) + list(opt["nu"].values())
    if "count" in opt:
        out.append(opt["count"])
    return out + [state.step]


def safe_increment(count: torch.Tensor) -> torch.Tensor:
    """``count + 1``, saturating at the int32 maximum (optax's rule)."""
    return torch.where(count < _INT32_MAX, count + 1, count)


def global_norm(grads: dict[str, torch.Tensor]) -> torch.Tensor:
    """√Σ‖g‖² over the leaves, summed leaf by leaf."""
    total = sum(g.square().sum() for g in grads.values())
    return torch.sqrt(total)


@torch.no_grad()
def fused_adam_target_step(cfg: TrainConfig, grads: dict[str, torch.Tensor],
                           opt_state: dict[str, Any],
                           params: dict[str, torch.Tensor],
                           target_params: dict[str, torch.Tensor] | None,
                           gnorm: torch.Tensor,
                           step: torch.Tensor | None) -> None:
    """Clip + Adam + parameter update + target refresh, IN PLACE on
    ``params``, ``target_params`` and ``opt_state`` — the reference's tree
    form, written out in its order: ``g*scale``, ``m2``, ``v2``,
    ``(m2/bc1)/(sqrt(v2/bc2)+eps)``, ``p - lr*upd``. The target refresh is
    Polyak ``τ·p₂ + (1−τ)·t`` when ``target_tau`` > 0, else
    ``where(step % C == 0, p₂, t)`` with ``step`` already incremented.
    Every tensor of the state keeps its storage (a CUDA graph replays its
    address). (``torch.optim.Adam`` takes ``sqrt(v)/sqrt(bc2)`` and
    rounds elsewhere, so it is not used.)"""
    b1, b2 = ADAM_B1, ADAM_B2
    count = safe_increment(opt_state["count"])
    c = count.float()
    bc1 = 1.0 - torch.pow(b1, c)
    bc2 = 1.0 - torch.pow(b2, c)
    scale = clip_scale(cfg, gnorm)
    lr, eps = cfg.lr, cfg.adam_eps
    refresh = None
    if target_params is not None and cfg.target_tau <= 0:
        refresh = step % cfg.target_update_period == 0
    mu, nu = opt_state["mu"], opt_state["nu"]
    for name, p in params.items():
        g = grads[name] * scale
        # the moments are written in place, each with the value a new
        # tensor would hold: a float32 μ and ν by the add itself, a
        # lower-precision μ by a rounding copy of the float32 m2
        mu_n = mu[name]
        m2 = torch.add(b1 * mu_n.float(), (1.0 - b1) * g,
                       out=mu_n if mu_n.dtype == torch.float32 else None)
        v2 = torch.add(b2 * nu[name], (1.0 - b2) * g.square(),
                       out=nu[name])
        upd = (m2 / bc1) / (torch.sqrt(v2 / bc2) + eps)
        p2 = p - lr * upd
        if m2 is not mu_n:
            mu_n.copy_(m2)
        p.copy_(p2)
        if target_params is not None:
            t = target_params[name]
            if refresh is None:
                tau = cfg.target_tau
                t.copy_(tau * p2 + (1.0 - tau) * t)
            else:
                t.copy_(torch.where(refresh, p2, t))
    opt_state["count"].copy_(count)


def clip_scale(cfg: TrainConfig, gnorm: torch.Tensor):
    """``min(1, clip/max(gnorm, 1e-12))``, or 1 with the clip off."""
    if cfg.grad_clip_norm > 0:
        return torch.clamp(cfg.grad_clip_norm / torch.clamp(gnorm, min=1e-12),
                           max=1.0)
    return 1.0


def refresh_target(cfg: TrainConfig, params: dict[str, torch.Tensor],
                   target_params: dict[str, torch.Tensor],
                   step: torch.Tensor) -> None:
    """θ⁻ update IN PLACE: Polyak ``τ·p + (1−τ)·t`` every step when
    ``target_tau`` > 0, else the copy ``where(step % C == 0, p, t)`` with
    ``step`` already incremented."""
    if cfg.target_tau > 0:
        tau = cfg.target_tau
        for name, t in target_params.items():
            t.copy_(tau * params[name] + (1.0 - tau) * t)
        return
    refresh = step % cfg.target_update_period == 0
    for name, t in target_params.items():
        t.copy_(torch.where(refresh, params[name], t))


@torch.no_grad()
def rmsprop_target_step(cfg: TrainConfig, grads: dict[str, torch.Tensor],
                        opt_state: dict[str, Any],
                        params: dict[str, torch.Tensor],
                        target_params: dict[str, torch.Tensor],
                        gnorm: torch.Tensor, step: torch.Tensor) -> None:
    """The reference's non-Adam step, IN PLACE, in its order:

    1. ``clip_grads``: g·min(1, clip/max(gnorm, 1e-12)) from the norm the
       caller computed (the reported ``grad_norm`` is that, pre-clip);
    2. with the clip on, the optimizer chain's own
       ``clip_by_global_norm`` again, on the clipped tree:
       ``select(norm < clip, t, (t / norm)·clip)``;
    3. centered RMSProp: ``mu ← (1−d)·g + d·mu``, ``nu ← (1−d)·g² + d·nu``
       (each written into its own storage by the add),
       ``u = rsqrt(nu − mu² + eps)·g``, ``u·(−lr)``, ``p + u``;
    4. ``refresh_target`` on the updated θ.
    """
    scale = clip_scale(cfg, gnorm)
    grads = {k: g * scale for k, g in grads.items()}
    clip = cfg.grad_clip_norm
    if clip > 0:
        norm = global_norm(grads)
        keep = norm < clip
        grads = {k: torch.where(keep, g, (g / norm) * clip)
                 for k, g in grads.items()}
    d, eps, neg_lr = RMSPROP_DECAY, RMSPROP_EPS, -1 * cfg.lr
    mu, nu = opt_state["mu"], opt_state["nu"]
    for name, p in params.items():
        g = grads[name]
        torch.add((1 - d) * g, d * mu[name], out=mu[name])
        torch.add((1 - d) * g.square(), d * nu[name], out=nu[name])
        u = torch.rsqrt(nu[name] - mu[name].square() + eps) * g
        p.copy_(p + u * neg_lr)
    refresh_target(cfg, params, target_params, step)


def apply_optimizer(cfg: TrainConfig, grads: dict[str, torch.Tensor],
                    opt_state: dict[str, Any], params: dict[str, torch.Tensor],
                    target_params: dict[str, torch.Tensor],
                    gnorm: torch.Tensor, step: torch.Tensor) -> None:
    """The optimizer + target refresh of ``_step_core`` for either
    optimizer, in place."""
    if opt_state["name"] == "adam":
        fused_adam_target_step(cfg, grads, opt_state, params, target_params,
                               gnorm, step)
    else:
        rmsprop_target_step(cfg, grads, opt_state, params, target_params,
                            gnorm, step)


def init_opt_state(cfg: TrainConfig, net: nn.Module,
                   device: torch.device) -> dict[str, Any]:
    """A fresh optimizer state for ``net`` (see ``TrainState``)."""
    params = dict(net.named_parameters())
    if cfg.optimizer == "rmsprop":
        # optax's scale_by_stddev: mu zeros, nu at initial_scale = 0
        return {"name": "rmsprop",
                "mu": {k: torch.zeros_like(p) for k, p in params.items()},
                "nu": {k: torch.zeros_like(p) for k, p in params.items()}}
    mu_dtype = getattr(torch, cfg.adam_mu_dtype)
    return {"name": "adam",
            "count": torch.zeros((), dtype=torch.int32, device=device),
            "mu": {k: torch.zeros_like(p, dtype=mu_dtype)
                   for k, p in params.items()},
            "nu": {k: torch.zeros_like(p) for k, p in params.items()}}


def plane_gate(cfg: TrainConfig, per_shard: int) -> bool:
    """Whether the reference's fused chain returns a learning-dynamics
    plane: only its plane-carry body does, which it takes with stacked
    forwards (``stack_forwards=on``, or ``auto`` at a per-shard batch of
    at most 128), Adam and no model axis (the port has none). Its tree
    body, taken otherwise, never calls ``lm_update``."""
    stacked = (cfg.stack_forwards == "on"
               or (cfg.stack_forwards == "auto" and per_shard <= 128))
    return bool(cfg.learn_metrics) and stacked and cfg.optimizer == "adam"


def q_step_loss(cfg: TrainConfig, q: torch.Tensor,
                q_next_o: torch.Tensor | None, q_next_t: torch.Tensor,
                batch: dict[str, torch.Tensor]):
    """Bellman targets + weighted Huber: the fused kernels
    (``ops/fused_loss.py``) with ``use_pallas_loss``, else the plain tensor
    loss. Returns (loss, |TD|)."""
    targets = bellman_targets(batch["reward"], batch["discount"], q_next_t,
                              q_next_o, cfg.double_dqn)
    if cfg.use_pallas_loss:
        return FusedDqnLoss.apply(q, batch["action"], targets.detach(),
                                  batch["weight"], float(cfg.huber_delta))
    return dqn_loss(q, batch["action"], targets, batch["weight"],
                    cfg.huber_delta)


def fused_sample(rows: dict[str, torch.Tensor], cursors: torch.Tensor,
                 sizes: torch.Tensor, betas: torch.Tensor, u: torch.Tensor,
                 spec: tuple):
    """The sample stage of a fused dispatch, against the priorities as of
    chunk start: prep + meta pack + ``chain × B/D`` draws per shard of this
    process from its uniforms (``u`` ``[Dl, chain, B/D]``, any shape of
    that size: a ``[chain, B]`` at one shard reads the same) + ONE
    ``gather_windows`` launch for every sample's obs+next-obs window.
    ``spec``'s shard count is D over every process; this process's Dl
    follows from ``u``. Returns, in batch order (the shards' draws
    concatenated), (meta dict [chain, Dl·B/D, ...], windows ``[chain ·
    Dl·B/D · window · rowb/4]`` int32, sampled row indices [chain, Dl·B/D],
    window-start rows [chain, Dl·B/D])."""
    (slot_cap, slot_pad, rowb, row_len, stack, n_step, gamma,
     frame_shape, per_shard, alpha, eps, num_shards) = spec
    u = u.reshape(-1, betas.shape[0], per_shard)
    pm, cdf, mass, n_glob = fused_sample_prep(
        rows, cursors, sizes, slot_cap, stack, n_step, u.shape[0])
    pack = build_meta_pack(rows["action"], rows["reward"], rows["done"],
                           rows["boundary"], slot_cap, stack, n_step, gamma)
    metas, ws, idxs = fused_sample_draw_packed(
        u, pack, pm, cdf, mass, n_glob, per_shard, slot_cap, slot_pad,
        stack, n_step, betas, num_shards)
    win = gather_windows(ws.reshape(-1), rows["frames"],
                         n=ws.numel(), w=stack + n_step, rowb=rowb)
    return metas, win, idxs, ws


def no_span(name: str):
    """A span that records nothing, for the enqueue a CUDA graph captures:
    a replay stamps no host clock, so the owner opens one span around it
    (``dispatch_replay``) instead."""
    del name
    return contextlib.nullcontext()


class Learner:
    """Owns the train step for feed-forward Q-nets on one device."""

    def __init__(self, cfg: TrainConfig, device: torch.device):
        if cfg.optimizer not in OPTIMIZERS:
            raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
        self.cfg = cfg
        self.device = device

    # -- state -------------------------------------------------------------

    def init_state(self, net: nn.Module) -> TrainState:
        target = copy.deepcopy(net).requires_grad_(False)
        return TrainState(
            net=net,
            target_net=target,
            opt_state=init_opt_state(self.cfg, net, self.device),
            step=torch.zeros((), dtype=torch.int32, device=self.device))

    # -- train step --------------------------------------------------------

    def _step_core(self, state: TrainState, batch: dict[str, torch.Tensor],
                   forward: str = "forward_nchw", spans=tracing.span):
        """Loss + gradients + optimizer + target refresh on one batch on the
        device. ``forward`` names the nets' method for ``obs``/``next_obs``:
        ``forward_nchw`` for ``[B, stack, H, W]`` frames (the ring paths),
        ``forward`` for the reference's layouts (a host batch). Updates
        ``state`` in place, every tensor in its own storage; returns
        (metrics, |TD|, the online Q ``[B, A]``). ``spans`` opens the
        three spans that time the host's enqueue of each pass
        (``tracing.span``; ``no_span`` under a CUDA graph's capture)."""
        cfg = self.cfg
        net, target = state.net, state.target_net
        with spans("step_forward"):
            q = getattr(net, forward)(batch["obs"])
            with torch.no_grad():
                # action selection must not backprop into the online net
                q_next_o = (getattr(net, forward)(batch["next_obs"])
                            if cfg.double_dqn else None)
                q_next_t = getattr(target, forward)(batch["next_obs"])
            loss, td_abs = q_step_loss(cfg, q, q_next_o, q_next_t, batch)
        params = dict(net.named_parameters())
        with spans("step_backward"):
            grads = dict(zip(params, torch.autograd.grad(
                loss, list(params.values()))))
            # the reference's pmean of grads, loss and Q mean, before the
            # clip
            grads, (loss, q_mean) = multihost.mean_grads_and_scalars(
                grads, [loss.detach(), q.detach().mean()])
            gnorm = global_norm(grads)
        with spans("step_optimizer"):
            state.step.add_(1)
            apply_optimizer(cfg, grads, state.opt_state, params,
                            dict(target.named_parameters()), gnorm,
                            state.step)
        metrics = {"loss": loss, "q_mean": q_mean, "grad_norm": gnorm}
        return metrics, td_abs, q.detach()

    def _to_device(self, batch: dict[str, Any]) -> dict[str, torch.Tensor]:
        """Host arrays through ``to_device``; tensors (a ``DeviceStager``
        batch, already on the device) pass through."""
        return {k: (v.to(self.device) if isinstance(v, torch.Tensor)
                    else to_device(np.asarray(v), self.device))
                for k, v in batch.items()}

    def train_step(self, state: TrainState, batch: dict[str, Any]):
        """One gradient step on a host batch (numpy ``obs``, ``action``,
        ``reward``, ``next_obs``, ``discount``, ``weight``; pixel ``obs`` in
        the reference's ``[B, H, W, stack]``). Returns (metrics, |TD|).
        The ``train_step`` span times the host's enqueue, not the device."""
        with tracing.span("train_step"):
            return self._step_core(state, self._to_device(batch),
                                   forward="forward")[:2]

    def train_step_from_ring(self, state: TrainState, ring: torch.Tensor,
                             batch: dict[str, Any],
                             frame_shape: tuple[int, int] = (84, 84)):
        """One gradient step on an index batch into the device frame ring
        (``DeviceFrameReplay.sample``): the stacks are gathered on the
        device (``compose_stacks``). Returns (metrics, |TD|)."""
        b = self._to_device(batch)
        composed = {
            "obs": compose_stacks(ring, b["oidx"], b["valid"], frame_shape),
            "next_obs": compose_stacks(ring, b["noidx"], b["nvalid"],
                                       frame_shape),
            "action": b["action"],
            "reward": b["reward"],
            "discount": b["discount"],
            "weight": b["weight"],
        }
        return self._step_core(state, composed)[:2]

    def train_steps_device_per(self, state: TrainState,
                               rows: dict[str, torch.Tensor],
                               cursors: torch.Tensor, sizes: torch.Tensor,
                               betas: torch.Tensor, u: torch.Tensor,
                               spec: tuple, spans=tracing.span):
        """``len(betas)`` fused sample+train+priority-update steps: the
        device work of one dispatch, as the eager path runs it and a
        ``DispatchGraph`` captures it.

        Sampling happens once for the whole chunk (``fused_sample``), then
        the chain's optimizer steps and priority scatters run strictly in
        order (staleness within a chunk ≤ chain steps, as in the
        reference). ``spans`` time the host's enqueue of the sample stage
        and of the train stage, not device execution (nothing here
        synchronizes; ``no_span`` under a capture).

        Updates ``state`` and ``rows["prio"]`` in place. Returns (new
        running max priority, metrics stacked over ``[chain]``, with the
        dispatch's ``learn_plane`` where ``plane_gate`` holds)."""
        with spans("sample"):
            metas, win, idxs, _ = fused_sample(rows, cursors, sizes, betas,
                                               u, spec)
        with spans("train_step"):
            return self._train_chain(state, rows, metas, win, idxs, spec,
                                     plane_gate(self.cfg, spec[8]),
                                     spans=spans)

    def _train_chain(self, state: TrainState, rows: dict[str, torch.Tensor],
                     metas: dict[str, torch.Tensor], win: torch.Tensor,
                     idxs: torch.Tensor, spec: tuple, with_plane: bool,
                     spans=tracing.span):
        """The train stage of a fused dispatch: ``len(idxs)`` optimizer
        steps and priority scatters, in order, and, ``with_plane``, the
        learning-dynamics plane carried across them. ``spans`` opens each
        step's spans (``_step_core``)."""
        (_, _, rowb, row_len, stack, n_step, _, frame_shape, _,
         alpha, eps, num_shards) = spec
        lmp = learning.lm_init(win.device) if with_plane else None
        chain, batch_rows = idxs.shape
        # unpack int32 → pixel bytes, drop the row padding: [chain, B, w,
        # H·W] uint8, already the nets' NCHW order along (window, pixels)
        pix = win.view(torch.uint8).view(chain, batch_rows, stack + n_step,
                                         rowb)[..., :row_len]

        # the train stage
        prio, maxp = rows["prio"], rows["maxp"]
        steps = []
        for i in range(chain):
            ov = metas["ovalid"][i][..., None]
            nv = metas["nvalid"][i][..., None]
            batch = {
                "obs": (pix[i, :, :stack] * ov).view(
                    batch_rows, stack, *frame_shape),
                "next_obs": (pix[i, :, n_step:n_step + stack] * nv).view(
                    batch_rows, stack, *frame_shape),
                "action": metas["action"][i],
                "reward": metas["reward"][i],
                "discount": metas["discount"][i],
                "weight": metas["weight"][i],
            }
            metrics, td_abs, q = self._step_core(state, batch, spans=spans)
            maxp = scatter_priorities(prio, maxp, idxs[i], td_abs, alpha,
                                      eps)
            if lmp is not None:
                learning.lm_update(
                    lmp, cfg=self.cfg, td_abs=td_abs,
                    weight=batch["weight"], loss=metrics["loss"], q=q,
                    q_mean=metrics["q_mean"], gnorm=metrics["grad_norm"],
                    step=state.step, alpha=alpha, eps=eps)
            steps.append(metrics)
        # the reference pmaxes the running max priority every step; a max
        # of maxima is exact, and nothing in the chain reads it, so the
        # port reduces it once per dispatch
        maxp = multihost.all_reduce_(maxp, "max")
        stacked = {k: torch.stack([m[k] for m in steps]) for k in steps[0]}
        if lmp is not None:
            stacked["learn_plane"] = learning.lm_finalize(lmp, num_shards)
        return maxp, stacked


def dispatch_key(cfg: TrainConfig, state: TrainState,
                 rows: dict[str, torch.Tensor], chain: int,
                 spec: tuple) -> tuple:
    """What a captured fused dispatch froze: the train settings, the chain
    and the ring's geometry, and the address of every tensor of the train
    state and of the replay's rows."""
    ptrs = tuple(t.data_ptr() for t in state_tensors(state))
    ptrs += tuple(t.data_ptr() for t in rows.values())
    return (copy.copy(cfg), int(chain), spec, ptrs)


class DispatchGraph:
    """One fused dispatch captured as a CUDA graph, then replayed: the
    sample stage, the chain's grad steps and priority scatters, and the
    running max priority written back into ``rows["maxp"]``
    (``Learner.train_steps_device_per``).

    A replay runs on the device addresses the capture saw. So the
    host-made inputs (cursors, sizes, β, uniforms) reach it through static
    buffers (``load``, enqueued on the stream the replay runs on), every
    tensor a dispatch carries to the next is written in place, and ``key``
    (``dispatch_key``) says what the capture froze: an owner whose key has
    changed builds a new graph, so a stale one is never replayed. Each
    replay hands out its own copy of the per-step metrics, and advances
    the kernel wrappers' launch counters by the launches it holds."""

    def __init__(self, learner: Learner, state: TrainState,
                 rows: dict[str, torch.Tensor], spec: tuple, inputs: tuple,
                 key: tuple):
        self.key = key
        self._learner, self._state, self._rows = learner, state, rows
        self._spec = spec
        dev = rows["prio"].device
        self.inputs = tuple(torch.empty_like(torch.as_tensor(a), device=dev)
                            for a in inputs)
        self._graph: torch.cuda.CUDAGraph | None = None
        self._outputs: dict[str, torch.Tensor] = {}
        self._launches: dict = {}

    def load(self, *inputs) -> None:
        """One dispatch's (cursors, sizes, betas, u) into the static
        buffers, on the current stream: host arrays through
        ``to_device``'s pinned copy, a device tensor by a device copy."""
        for buf, a in zip(self.inputs, inputs):
            if isinstance(a, torch.Tensor):
                buf.copy_(a, non_blocking=True)
            else:
                to_device(a, buf.device, out=buf)

    def _capture(self) -> None:
        """Capture the dispatch on the loaded inputs, without advancing
        anything: one eager dispatch first sets up what a capture cannot
        (cuBLAS and cuDNN handles and workspaces, autograd's device
        thread), on the real state and priorities, which are then put
        back in place from a copy. The next ``replay`` computes what an
        eager dispatch would."""
        learner, state, rows, spec = (self._learner, self._state,
                                      self._rows, self._spec)
        side = torch.cuda.Stream(rows["prio"].device)
        side.wait_stream(torch.cuda.current_stream(side.device))
        touched = state_tensors(state) + [rows["prio"], rows["maxp"]]
        with torch.cuda.stream(side):
            with torch.no_grad():
                saved = [t.clone() for t in touched]
            learner.train_steps_device_per(state, rows, *self.inputs,
                                           spec, spans=no_span)
            with torch.no_grad():
                for t, s in zip(touched, saved):
                    t.copy_(s)
        torch.cuda.current_stream(side.device).wait_stream(side)
        del saved
        graph = torch.cuda.CUDAGraph()
        with launch_tally() as tally:
            with torch.cuda.graph(graph, stream=side,
                                  capture_error_mode="thread_local"):
                maxp, outputs = learner.train_steps_device_per(
                    state, rows, *self.inputs, spec, spans=no_span)
                rows["maxp"].copy_(maxp)
        self._graph, self._outputs = graph, outputs
        self._launches = dict(tally)

    def replay(self) -> dict[str, torch.Tensor]:
        """Run the dispatch on the loaded inputs, on the current stream
        (the first call captures it); returns a copy of its per-step
        metrics (the next replay overwrites the graph's)."""
        if self._graph is None:
            self._capture()
        self._graph.replay()
        for wrapper, n in self._launches.items():
            wrapper.launches += n
        return {k: v.clone() for k, v in self._outputs.items()}
