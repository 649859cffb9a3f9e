"""``Solver`` — the train-step owner behind the ``--backend`` switch (port of
the reference ``solver.py``).

The backend is a torch device: ``cuda`` (CUDA device 0; raises without a
card) or ``cpu``. The port runs one process on one device.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import numpy as np
import torch

from distributed_deep_q_tpu_torch.config import Config
from distributed_deep_q_tpu_torch.convert import (
    params_from_flax, params_to_flax, train_state_from_flax,
    train_state_to_flax)
from distributed_deep_q_tpu_torch.models.qnet import build_qnet
from distributed_deep_q_tpu_torch.parallel.learner import Learner, TrainState
from distributed_deep_q_tpu_torch.replay.device_per import uniforms_for_keys
from distributed_deep_q_tpu_torch.replay.device_ring import to_device


def select_device(backend: str) -> torch.device:
    """``cuda`` → CUDA device 0, raising when there is none (no CPU
    fallback); ``cpu`` → the host."""
    if backend == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "--backend cuda was requested but torch.cuda.is_available() "
                "is false (no NVIDIA card or no CUDA build of torch); pass "
                "--backend cpu to run on the host")
        return torch.device("cuda", 0)
    if backend == "cpu":
        return torch.device("cpu")
    raise ValueError(f"unknown backend {backend!r} (cuda | cpu)")


def check_single_device(config: Config) -> None:
    """Refuse mesh settings the port does not run: it is one process on
    one device, so one shard and no model axis."""
    m = config.mesh
    if m.num_processes > 1 or m.coordinator:
        raise NotImplementedError(
            "multi-process training is not ported yet (ROADMAP A14)")
    if m.dp > 1 or m.model > 1:
        raise NotImplementedError(
            f"mesh.dp={m.dp}, mesh.model={m.model}: the port runs one shard "
            "on one device; more shards are not ported yet (ROADMAP A14)")


def sample_key_schedule(seed: int, start_step: int, num_shards: int,
                        chain: int) -> np.ndarray:
    """Device-sampling keys ``[D, chain, 2]`` for grad steps
    ``start_step .. start_step+chain``: key (i, s) is a pure function of
    (seed, global step index, shard), so a chain=k chunk draws
    byte-identical keys to k single-step dispatches, a resumed run
    continues the sequence instead of replaying it, and two replay
    geometries never correlate. One vectorized splitmix64 pass (the r4
    code built a Philox ``Generator`` per step in a Python loop)."""
    steps = start_step + np.arange(chain, dtype=np.uint64)
    lane = (steps[None, :] * np.uint64(num_shards)
            + np.arange(num_shards, dtype=np.uint64)[:, None])
    with np.errstate(over="ignore"):
        x = lane + np.uint64(seed) * np.uint64(0x9E3779B97F4A7C15)
        x = (x + np.uint64(0x9E3779B97F4A7C15))
        x ^= x >> np.uint64(30)
        x *= np.uint64(0xBF58476D1CE4E5B9)
        x ^= x >> np.uint64(27)
        x *= np.uint64(0x94D049BB133111EB)
        x ^= x >> np.uint64(31)
    out = np.empty((num_shards, chain, 2), np.uint32)
    out[..., 0] = (x >> np.uint64(32)).astype(np.uint32)
    out[..., 1] = (x & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return out


def next_fused_keys(owner, num_shards: int, chain: int) -> np.ndarray:
    """``sample_key_schedule`` with the owner's anchoring bookkeeping:
    anchored once at the train step the fused path first ran from (one
    device read), so a resumed run continues the key sequence."""
    if owner._fused_key_base is None:
        owner._fused_key_base = int(owner.state.step)
        owner._fused_steps_issued = 0
    out = sample_key_schedule(
        owner.config.train.seed,
        owner._fused_key_base + owner._fused_steps_issued,
        num_shards, chain)
    owner._fused_steps_issued += chain
    return out


def _tree_leaves(tree) -> list[np.ndarray]:
    """The leaves of a nested dict in ``jax.tree_util.tree_leaves`` order:
    keys sorted at every level."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tree_leaves(tree[k])]
    return [np.asarray(tree)]


def _tree_unflatten(skeleton, leaves):
    """Rebuild ``skeleton``'s nesting from ``leaves`` (an iterator in
    ``_tree_leaves`` order)."""
    if isinstance(skeleton, dict):
        return {k: _tree_unflatten(skeleton[k], leaves)
                for k in sorted(skeleton)}
    return np.asarray(next(leaves), skeleton.dtype)


def _strip_host_keys(batch: dict[str, Any]) -> dict[str, Any]:
    """Drop host-only bookkeeping (slot indices, sample snapshots) before a
    batch goes to the device."""
    return {k: v for k, v in batch.items()
            if k not in ("index", "_sampled_at")}


class Solver:
    """Facade over (net, learner, state) on one device.

    - ``train_step(batch)`` — one step on a host batch (``ReplayMemory``,
      host ``FrameStackReplay``);
    - ``train_step_from_ring(ring, batch, frame_shape)`` — one step on an
      index batch into a ``DeviceFrameReplay`` ring;
    - ``train_steps_device_per(replay, chain)`` — the fused device-PER
      dispatch;
    - ``q_values(obs)`` / ``act(obs, ε, rng)`` — the actor-side forward;
    - ``get_weights()`` / ``update(weights)`` — numpy weight IO in the
      reference's layout and leaf order (the ``θ`` wire);
    - ``load_flax_state(...)`` / ``flax_state()`` — the train state in the
      reference's layout (``convert.py``).

    ``draw_uniforms(keys, per_shard, device)`` makes each dispatch's
    sampling uniforms from its keys (``uniforms_for_keys``); tests replace
    it to feed the reference's uniforms.
    """

    def __init__(self, config: Config, obs_dim: int = 4,
                 backend: str | None = None):
        if config.net.kind == "r2d2":
            raise ValueError("r2d2 nets train through SequenceSolver "
                             "(parallel/sequence_learner.py)")
        self._setup(config, obs_dim, backend,
                    lambda cfg, dev: Learner(cfg.train, dev))
        self._dp_spec: tuple | None = None
        self._dp_spec_replay = None

    def _setup(self, config: Config, obs_dim: int, backend: str | None,
               make_learner) -> None:
        """Device, net, learner and train state: what every solver of the
        port builds the same way."""
        if backend is not None:
            config = dataclasses.replace(
                config, mesh=dataclasses.replace(config.mesh, backend=backend))
        check_single_device(config)
        self.config = config
        self.backend = config.mesh.backend
        self.device = select_device(self.backend)
        if self.device.type == "cuda":
            # float32 configs compute in full float32, as the reference does
            # on the CPU; the bf16 presets are unaffected
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        net = build_qnet(config.net, obs_dim, config.train.seed)
        self.learner = make_learner(config, self.device)
        self.state: TrainState = self.learner.init_state(net.to(self.device))
        self.draw_uniforms = uniforms_for_keys
        self._fused_key_base: int | None = None
        self._fused_steps_issued = 0

    # -- training ----------------------------------------------------------

    @property
    def step(self) -> int:
        return int(self.state.step)

    def train_step(self, batch: dict[str, np.ndarray]) -> dict[str, Any]:
        """One gradient step on a host batch. Returns the metrics as device
        scalars plus the per-sample ``td_abs`` (a device tensor, for PER
        priorities) and the sampled ``index``; nothing here waits on the
        device."""
        metrics, td_abs = self.learner.train_step(self.state,
                                                  _strip_host_keys(batch))
        return self._with_feedback(metrics, td_abs, batch)

    def train_step_from_ring(self, ring: torch.Tensor, batch: dict[str, Any],
                             frame_shape: tuple[int, int] | None = None,
                             ) -> dict[str, Any]:
        """One gradient step on an index batch into the device frame ring
        (``replay/device_ring.py``): ``batch`` carries indices, masks and
        scalars; frames are gathered on the device. ``frame_shape`` decodes
        the ring's flat rows (defaults to the net config's). Returns what
        ``train_step`` returns."""
        metrics, td_abs = self.learner.train_step_from_ring(
            self.state, ring, _strip_host_keys(batch),
            frame_shape=tuple(frame_shape or self.config.net.frame_shape))
        return self._with_feedback(metrics, td_abs, batch)

    @staticmethod
    def _with_feedback(metrics, td_abs, batch) -> dict[str, Any]:
        out: dict[str, Any] = dict(metrics)
        out["td_abs"] = td_abs
        if "index" in batch:
            out["index"] = batch["index"]
        return out

    def train_step_device_per(self, replay) -> dict[str, Any]:
        """One fused prioritized step; metrics as device scalars."""
        m = self.train_steps_device_per(replay, chain=1)
        return {k: v[0] for k, v in m.items()}

    def train_steps_device_per(self, replay,
                               chain: int | None = None) -> dict[str, Any]:
        """``chain`` fused prioritized steps in one dispatch (see
        ``Learner.train_steps_device_per``). Host cost per chunk: a flush
        of staged rows, (cached) cursor/size arrays, the chunk's keys and
        uniforms. Returns metrics stacked ``[chain]`` (device tensors —
        convert only when logging)."""
        chain = chain or max(int(self.config.replay.fused_chain), 1)
        if replay.pending_rows():
            # device rows must cover everything the host bookkeeping
            # (cursors/sizes below) claims is written
            replay.flush()
        cursors, sizes = replay.device_inputs()
        betas = replay.next_betas(chain)
        spec = self._dp_spec
        if spec is None or self._dp_spec_replay is not replay:
            spec = (replay.slot_cap, replay.slot_pad, replay.rowb,
                    replay._row_len, replay.stack, replay.n_step,
                    replay.gamma, tuple(replay.frame_shape),
                    self.config.replay.batch_size // replay.num_shards,
                    float(self.config.replay.priority_alpha),
                    float(self.config.replay.priority_eps),
                    replay.num_shards)
            self._dp_spec, self._dp_spec_replay = spec, replay
        keys = next_fused_keys(self, replay.num_shards, chain)
        u = self.draw_uniforms(keys[0], spec[8], self.device)
        dev = self.device
        maxp, metrics = self.learner.train_steps_device_per(
            self.state, replay.dstate, to_device(cursors, dev),
            to_device(sizes, dev), to_device(betas, dev), u, spec)
        replay.dstate["maxp"] = maxp
        return metrics

    # -- inference (actor path) -------------------------------------------

    @torch.no_grad()
    def q_values(self, obs: np.ndarray) -> np.ndarray:
        if obs.ndim == 1 or (self.config.net.kind != "mlp" and obs.ndim == 3):
            obs = obs[None]
        x = torch.from_numpy(np.ascontiguousarray(obs)).to(self.device)
        return self.state.net(x).cpu().numpy()

    def act(self, obs: np.ndarray, epsilon: float,
            rng: np.random.Generator) -> int:
        """ε-greedy action (same numpy draw order as the reference)."""
        if rng.random() < epsilon:
            return int(rng.integers(self.config.net.num_actions))
        return int(np.argmax(self.q_values(obs)[0]))

    # -- weight IO ----------------------------------------------------------

    def _flax_params(self) -> dict:
        """θ as the reference's Flax param tree (numpy, Flax layouts)."""
        return params_to_flax(
            {k: p.detach().float().cpu().numpy()
             for k, p in self.state.net.named_parameters()},
            tuple(self.config.net.frame_shape))

    def get_weights(self) -> list[np.ndarray]:
        """θ as the reference's ``get_weights`` gives it: the leaves of the
        Flax param tree in ``jax.tree_util.tree_leaves`` order (dict keys
        sorted at every level), in Flax layouts. This is the ``θ`` wire
        layout (``ReplayFeedServer.publish_params``), so a port learner
        and a reference actor, or the reverse, exchange parameters."""
        return _tree_leaves(self._flax_params())

    @torch.no_grad()
    def update(self, weights: list[np.ndarray]) -> None:
        """Install new online parameters given in ``get_weights`` order and
        layout (the reference's ``Solver.update``)."""
        skeleton = self._flax_params()
        leaves = list(weights)
        if len(leaves) != len(_tree_leaves(skeleton)):
            raise ValueError(f"got {len(leaves)} weights, the net has "
                             f"{len(_tree_leaves(skeleton))} leaves")
        tree = _tree_unflatten(skeleton, iter(leaves))
        named = params_from_flax(tree, tuple(self.config.net.frame_shape))
        for name, p in self.state.net.named_parameters():
            w = named[name]
            if tuple(w.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {tuple(w.shape)} against "
                                 f"the net's {tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.ascontiguousarray(w)))

    @torch.no_grad()
    def load_flax_state(self, params, target_params, count, mu, nu,
                        step) -> None:
        """Install a reference train state (Flax-layout numpy trees)."""
        fs = tuple(self.config.net.frame_shape)
        s = train_state_from_flax(params, target_params, count, mu, nu, step,
                                  fs)
        dev, st = self.device, self.state
        for module, tree in ((st.net, s["params"]),
                             (st.target_net, s["target_params"])):
            for name, p in module.named_parameters():
                p.copy_(torch.from_numpy(tree[name]))
        for key in ("mu", "nu"):
            for name, t in st.opt_state[key].items():
                st.opt_state[key][name] = torch.from_numpy(
                    s["opt_state"][key][name]).to(dev, t.dtype)
        st.opt_state["count"] = torch.tensor(int(count), dtype=torch.int32,
                                             device=dev)
        st.step = torch.tensor(int(step), dtype=torch.int32, device=dev)

    def flax_state(self) -> dict:
        """The train state in the reference's layout (numpy trees): keys
        params, target_params, count, mu, nu, step."""
        st = self.state

        def host(module):
            return {k: p.detach().float().cpu().numpy()
                    for k, p in module.named_parameters()}

        state = {
            "params": host(st.net),
            "target_params": host(st.target_net),
            "opt_state": {
                "count": int(st.opt_state["count"]),
                "mu": {k: v.float().cpu().numpy()
                       for k, v in st.opt_state["mu"].items()},
                "nu": {k: v.cpu().numpy()
                       for k, v in st.opt_state["nu"].items()}},
            "step": int(st.step),
        }
        return train_state_to_flax(state, tuple(self.config.net.frame_shape))


class FusedStepStream:
    """Per-grad-step metrics from chained fused-PER dispatches: dispatch a
    chunk of ``min(chain, steps_left)`` steps whenever the previous chunk
    is exhausted, then hand out its stacked metrics row by row.
    ``timer`` is the train loop's ``StepTimer`` (dispatch phase)."""

    def __init__(self, solver: Solver, replay, chain: int, timer=None):
        self._solver = solver
        self._replay = replay
        self.chain = max(int(chain), 1)
        self._timer = timer
        self._chunk: dict[str, Any] | None = None
        self._len = 0
        self._pending = 0

    def next(self, steps_left: int) -> dict[str, Any]:
        """Metrics for one grad step; dispatches a fresh chunk as needed.
        ``steps_left`` counts THIS step."""
        if self._pending == 0:
            assert int(steps_left) >= 1, (
                f"steps_left={steps_left}: dispatching with a non-positive "
                "budget would silently run an extra optimizer step")
            self._len = min(self.chain, int(steps_left))
            phase = (self._timer.phase("dispatch") if self._timer
                     else contextlib.nullcontext())
            with phase:
                self._chunk = self._solver.train_steps_device_per(
                    self._replay, chain=self._len)
            self._pending = self._len
        m = {k: v[self._len - self._pending]
             for k, v in self._chunk.items()}
        self._pending -= 1
        return m
