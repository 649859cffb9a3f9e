"""``Solver`` — the train-step owner behind the ``--backend`` switch (port of
the reference ``solver.py``).

The backend is a torch device: ``cuda`` (raises without a card) or
``cpu``. Each process runs on one device; ``mesh.dp`` sets the replay's
shard count D (``parallel/mesh.py``). With more than one learner process
(``parallel/multihost.py``) every process holds the whole train state,
made equal to process 0's at init and at restore (``replicate_state``),
and trains on its ``B / num_processes`` rows (``local_batch``).

The fused device-PER dispatch at the configured chain, on a card and in a
process alone, is captured once as a CUDA graph and replayed
(``graph_engages``, ``parallel/learner.py::DispatchGraph``); every other
dispatch runs the same code eagerly. ``dispatch_counters`` says which ran.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import numpy as np
import torch

from distributed_deep_q_tpu_torch import tracing
from distributed_deep_q_tpu_torch.config import Config
from distributed_deep_q_tpu_torch.convert import (
    flax_leaves, load_flax_leaves, train_state_from_flax,
    train_state_to_flax)
from distributed_deep_q_tpu_torch.models.qnet import build_qnet
from distributed_deep_q_tpu_torch.parallel.learner import (
    DispatchGraph, Learner, TrainState, dispatch_key, state_tensors)
from distributed_deep_q_tpu_torch.parallel import mesh, multihost
from distributed_deep_q_tpu_torch.replay.device_per import uniforms_for_keys
from distributed_deep_q_tpu_torch.replay.device_ring import (
    global_stack_rows, to_device)


def select_device(backend: str, process_id: int = 0) -> torch.device:
    """``cuda`` → CUDA device ``process_id % device_count`` (device 0 at
    one process), raising when there is none (no CPU fallback); ``cpu`` →
    the host."""
    if backend == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "--backend cuda was requested but torch.cuda.is_available() "
                "is false (no NVIDIA card or no CUDA build of torch); pass "
                "--backend cpu to run on the host")
        return torch.device("cuda",
                            int(process_id) % torch.cuda.device_count())
    if backend == "cpu":
        return torch.device("cpu")
    raise ValueError(f"unknown backend {backend!r} (cuda | cpu)")


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


def fused_spec(config: Config, replay) -> tuple:
    """The static geometry of a fused dispatch on ``replay``: (slot_cap,
    slot_pad, rowb, row_len, stack, n_step, gamma, frame_shape, per-shard
    batch, α, ε, shards)."""
    return (replay.slot_cap, replay.slot_pad, replay.rowb, replay._row_len,
            replay.stack, replay.n_step, replay.gamma,
            tuple(replay.frame_shape),
            config.replay.batch_size // replay.num_shards,
            float(config.replay.priority_alpha),
            float(config.replay.priority_eps), replay.num_shards)


def graph_engages(device: torch.device, chain: int, configured: int) -> bool:
    """Whether a fused dispatch of ``chain`` steps runs as a CUDA graph:
    on a CUDA device, in a process alone (with more, the all-reduces run on
    the host, over gloo, where a graph cannot hold them) and at the
    configured chain (a shorter tail chunk runs eagerly)."""
    return (device.type == "cuda" and not multihost.is_multiprocess()
            and int(chain) == int(configured))


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
      dispatch, replayed as a CUDA graph where ``graph_engages`` holds;
      ``train_steps_eager`` runs it eagerly whatever the rule says;
    - ``q_values(obs)`` / ``act(obs, ε, rng)`` — the actor-side forward;
    - ``get_weights()`` / ``update(weights)`` — numpy weight IO in the
      reference's layout and leaf order (the ``θ`` wire);
    - ``load_flax_state(...)`` / ``flax_state()`` — the train state in the
      reference's layout (``convert.py``).

    ``draw_uniforms(keys, per_shard, device)`` makes each dispatch's
    sampling uniforms from its keys, ``[D·chain, 2]`` → ``[D·chain, B/D]``
    (``uniforms_for_keys``, the reference's own draws); a test may replace
    it to feed in other uniforms. ``num_shards`` is D (``mesh.dp``).
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
        pc = max(int(config.mesh.num_processes), 1)
        if config.replay.batch_size % pc:
            raise ValueError(f"replay.batch_size={config.replay.batch_size} "
                             f"must divide across {pc} processes")
        mesh.check_mesh(config.mesh)
        self.config = config
        self.backend = config.mesh.backend
        self.device = select_device(self.backend, config.mesh.process_id)
        if self.device.type == "cuda":
            # float32 configs compute in full float32, as the reference does
            # on the CPU; the bf16 presets are unaffected
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        net = build_qnet(config.net, obs_dim, config.train.seed)
        self.learner = make_learner(config, self.device)
        self.state: TrainState = self.learner.init_state(net.to(self.device))
        self.num_shards = mesh.num_shards(config.mesh)
        self.local_shards = mesh.local_shards(config.mesh)
        # this process's rows of every step (all of them at one process)
        self.local_batch = config.replay.batch_size // pc
        self.replicate_state()
        self.draw_uniforms = uniforms_for_keys
        self._fused_key_base: int | None = None
        self._fused_steps_issued = 0
        self.fused_chain = max(int(config.replay.fused_chain), 1)
        self._graph: DispatchGraph | None = None
        self.dispatch_counts = {"graph_captures": 0, "graph_replays": 0,
                                "eager_dispatches": 0}

    # -- training ----------------------------------------------------------

    @property
    def step(self) -> int:
        return int(self.state.step)

    def replicate_state(self) -> None:
        """Make this process's train state process 0's, bit for bit
        (``multihost.put_replicated``): at init and after a restore. A
        no-op at one process."""
        multihost.put_replicated(state_tensors(self.state))

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
        rows = global_stack_rows(_strip_host_keys(batch), self.num_shards,
                                 ring.shape[0] // self.num_shards)
        metrics, td_abs = self.learner.train_step_from_ring(
            self.state, ring, rows,
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
        # the learning-dynamics plane is per dispatch (no chain axis): it
        # must not be sliced like the per-step rows
        plane = m.pop("learn_plane", None)
        out = {k: v[0] for k, v in m.items()}
        if plane is not None:
            out["learn_plane"] = plane
        return out

    def train_steps_device_per(self, replay,
                               chain: int | None = None) -> dict[str, Any]:
        """``chain`` fused prioritized steps in one dispatch (see
        ``Learner.train_steps_device_per``): where ``graph_engages`` holds,
        a replay of the dispatch captured as one CUDA graph (captured at
        the first such dispatch, and again whenever ``dispatch_key``
        changes), else ``train_steps_eager``; the same device work either
        way. Host cost per chunk: a flush of staged rows, (cached)
        cursor/size arrays, the chunk's keys and uniforms and their copies
        into the graph's static inputs, the replay's launch. Returns
        metrics stacked ``[chain]``, this dispatch's own device tensors
        (convert only when logging). The ``dispatch_inputs`` span times the
        host's part before the replay, ``dispatch_replay`` the replay (and,
        the first time, the capture)."""
        chain = chain or self.fused_chain
        if not graph_engages(self.device, chain, self.fused_chain):
            return self.train_steps_eager(replay, chain)
        with tracing.span("dispatch_inputs"):
            spec, inputs = self._dispatch_inputs(replay, chain)
            key = dispatch_key(self.learner.cfg, self.state, replay.dstate,
                               chain, spec)
            if self._graph is None or self._graph.key != key:
                # the old graph's memory goes back before the new capture
                self._graph = None
                self._graph = DispatchGraph(self.learner, self.state,
                                            replay.dstate, spec, inputs, key)
                self.dispatch_counts["graph_captures"] += 1
            graph = self._graph
            graph.load(*inputs)
        with tracing.span("dispatch_replay"):
            metrics = graph.replay()
        self.dispatch_counts["graph_replays"] += 1
        return metrics

    def train_steps_eager(self, replay,
                          chain: int | None = None) -> dict[str, Any]:
        """The fused dispatch of ``train_steps_device_per``, run eagerly:
        the body a CUDA graph captures, with the tracer's spans inside it.
        The ``dispatch_inputs`` span times the host's part before the
        learner's call."""
        chain = chain or self.fused_chain
        with tracing.span("dispatch_inputs"):
            spec, (cursors, sizes, betas, u) = self._dispatch_inputs(
                replay, chain)
            dev = self.device
            inputs = (to_device(cursors, dev), to_device(sizes, dev),
                      to_device(betas, dev), u)
        maxp, metrics = self.learner.train_steps_device_per(
            self.state, replay.dstate, *inputs, spec)
        replay.dstate["maxp"].copy_(maxp)
        self.dispatch_counts["eager_dispatches"] += 1
        return metrics

    def _dispatch_inputs(self, replay, chain: int) -> tuple:
        """The host's part of a fused dispatch: (spec, (cursors, sizes,
        betas, u)), the first three host arrays, ``u`` the uniforms."""
        if replay.pending_rows():
            # device rows must cover everything the host bookkeeping
            # (cursors/sizes below) claims is written
            replay.flush()
        cursors, sizes = replay.device_inputs()
        betas = replay.next_betas(chain)
        spec = self._dp_spec
        if spec is None or self._dp_spec_replay is not replay:
            spec = fused_spec(self.config, replay)
            self._dp_spec, self._dp_spec_replay = spec, replay
        # each of this process's shards draws with its global shard's keys
        keys = next_fused_keys(self, replay.num_shards, chain)[
            replay.local_shards]
        u = self.draw_uniforms(keys.reshape(-1, 2), spec[8], self.device)
        return spec, (cursors, sizes, betas, u)

    def dispatch_counters(self) -> dict[str, float]:
        """The fused dispatches so far by how they ran, for the metrics the
        train loops log: CUDA graph captures, replays, eager dispatches."""
        c = self.dispatch_counts
        return {"learner/graph_captures": float(c["graph_captures"]),
                "learner/graph_replays": float(c["graph_replays"]),
                "learner/eager_dispatches": float(c["eager_dispatches"])}

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

    def get_weights(self) -> list[np.ndarray]:
        """θ as the reference's ``get_weights`` gives it (``flax_leaves``:
        Flax leaves in ``jax.tree_util.tree_leaves`` order, Flax layouts),
        so a port learner and a reference actor, or the reverse, exchange
        parameters."""
        return flax_leaves(self.state.net, tuple(self.config.net.frame_shape))

    def update(self, weights: list[np.ndarray]) -> None:
        """Install new online parameters given in ``get_weights`` order and
        layout (the reference's ``Solver.update``)."""
        load_flax_leaves(self.state.net, weights,
                         tuple(self.config.net.frame_shape))

    @torch.no_grad()
    def load_flax_state(self, params, target_params, count, mu, nu,
                        step) -> None:
        """Install a reference train state (Flax-layout numpy trees; the
        moments are the optimizer's, ``count`` Adam's and ignored for
        RMSProp)."""
        fs = tuple(self.config.net.frame_shape)
        st = self.state
        s = train_state_from_flax(params, target_params, count, mu, nu, step,
                                  fs, optimizer=st.opt_state["name"])
        for module, tree in ((st.net, s["params"]),
                             (st.target_net, s["target_params"])):
            for name, p in module.named_parameters():
                p.copy_(torch.from_numpy(tree[name]))
        self.load_opt_state(s["opt_state"])
        st.step.fill_(int(step))

    @torch.no_grad()
    def load_opt_state(self, opt: dict) -> None:
        """Install an optimizer-state dict of numpy arrays in the port's
        layouts (``convert.opt_state_from_flax`` or
        ``opt_state_from_optax_leaves``) into the state's tensors, in
        place (in their dtypes)."""
        st = self.state
        if opt["name"] != st.opt_state["name"]:
            raise ValueError(f"a {opt['name']} optimizer state cannot be "
                             f"installed into a {st.opt_state['name']} one")
        for key in ("mu", "nu"):
            for name, t in st.opt_state[key].items():
                src = torch.from_numpy(np.asarray(opt[key][name]))
                if src.shape != t.shape:
                    raise ValueError(f"{key}[{name!r}] is {tuple(src.shape)}"
                                     f", the state's is {tuple(t.shape)}")
                t.copy_(src.to(t.device, t.dtype))
        if "count" in st.opt_state:
            st.opt_state["count"].fill_(int(opt["count"]))

    def flax_state(self) -> dict:
        """The train state in the reference's layout (numpy trees): keys
        params, target_params, optimizer, mu, nu, step, and count for
        Adam."""
        st = self.state

        def host(tensors):
            return {k: p.detach().float().cpu().numpy()
                    for k, p in tensors.items()}

        opt = {"name": st.opt_state["name"],
               "mu": host(st.opt_state["mu"]), "nu": host(st.opt_state["nu"])}
        if "count" in st.opt_state:
            opt["count"] = int(st.opt_state["count"])
        state = {
            "params": host(dict(st.net.named_parameters())),
            "target_params": host(dict(st.target_net.named_parameters())),
            "opt_state": opt,
            "step": int(st.step),
        }
        return train_state_to_flax(state, tuple(self.config.net.frame_shape))


class FusedStepStream:
    """Per-grad-step metrics from chained fused-PER dispatches: dispatch a
    chunk of ``min(chain, steps_left)`` steps whenever the previous chunk
    is exhausted, then hand out its stacked metrics row by row. Each
    dispatch's metrics are its own tensors, which later dispatches (a CUDA
    graph's replays among them) leave as they are. Where ``graph_engages``
    holds, a full chunk replays the solver's graph and a shorter tail runs
    eagerly.

    ``dispatch_lock`` (optional, e.g. the ``ReplayFeedServer``'s
    ``replay_lock``) is held across the dispatch only: the drain's and the
    serve threads' writes into the ring (B2) and this dispatch's reads of
    it (B1) are enqueued on one stream in lock order, and writers get the
    lock back while the chunk runs on the device. ``timer`` is the train
    loop's ``StepTimer`` (dispatch phase)."""

    def __init__(self, solver: Solver, replay, chain: int,
                 dispatch_lock=None, timer=None):
        self._solver = solver
        self._replay = replay
        self.chain = max(int(chain), 1)
        self._lock = dispatch_lock or contextlib.nullcontext()
        self._timer = timer
        self._chunk: dict[str, Any] | None = None
        self._len = 0
        self._pending = 0
        self._planes: list[torch.Tensor] = []

    def drain_planes(self) -> list[torch.Tensor]:
        """Hand back (and clear) the planes kept so far — still device
        tensors; ``LearnAccumulator.ingest`` copies them to the host."""
        out, self._planes = self._planes, []
        return out

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
            with self._lock, phase:
                self._chunk = self._solver.train_steps_device_per(
                    self._replay, chain=self._len)
            plane = self._chunk.pop("learn_plane", None)
            if plane is not None:
                self._planes.append(plane)
            self._pending = self._len
        m = {k: v[self._len - self._pending]
             for k, v in self._chunk.items()}
        self._pending -= 1
        return m
