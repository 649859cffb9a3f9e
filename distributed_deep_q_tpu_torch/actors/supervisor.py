"""Actor fleet + distributed training topology (port of the reference
``actors/supervisor.py``).

Process shape: one learner process (``train_distributed``) hosting the
device, the replay buffer and the in-process ``ReplayFeedServer``; N actor
*processes* (``actor_main``), each running env + ε-greedy policy against a
locally pulled θ on the host CPU and pushing transition chunks over the v4
wire. Actors never touch the card: each builds its ``QNet`` on
``torch.device("cpu")`` and never calls into ``torch.cuda``, so a fleet of
16–256 actors holds no CUDA context and no card memory. This is the
design, not a fallback. The supervisor thread restarts a dead or silent
actor (actors are stateless).

With ``inference.enabled`` the learner process also serves actions: an
``InferenceServer`` whose ``BatchedPolicy`` runs on the learner's card
answers every greedy action of the fleet (``_RemoteInference``), and the
actors pull no θ. With ``actors.vector_envs > 1`` each actor process
steps that many envs behind one batched policy call per tick
(``_vector_actor_loop``), one replay stream per env row. With
``autoscale.enabled`` (and the health plane on) the health verdict is
folded through an ``Autoscaler`` and, with ``autoscale.execute``, its
``ScaleExecutor`` grows and retires actors.

Ape-X ε ladder: actor i uses ε_i = base^(1 + i·α/(N-1)), a fixed spread of
exploration rates across the fleet.

With ``train.learn_metrics`` on the fused device-PER path the learner folds
each chunk's learning-dynamics plane (``learning.py``) into ``learn/*``
gauges at log cadence and registers itself as the fleet-health member
``"learner"`` (``default_learn_rules``/``default_learn_trends``).

More than one learner process (``mesh.num_processes``,
``parallel/multihost.py``): every process runs this same topology, its own
``ReplayFeedServer``, its slice of the actor fleet and its block of replay
shards (``_split_fleet_across_processes``); only the train step's
collectives cross processes. The learn gate opens on every process at once
(``all_processes_ready``), host-batch paths sample synchronously (no
``DeviceStager``), and each process writes priorities back into its own
replay only.

Refused by name, before any process is spawned (``check_distributed``):
a model axis, and ``replay.persist_path`` (the distributed topology
warm-refills from its fleet, as in the reference); vector acting on an env
that is not pixels (``train_distributed``, as in the reference); and, with
more than one process, an uneven split of the batch or the fleet and the
host-sampled device rings, as in the reference.
"""

from __future__ import annotations

import dataclasses
import logging
import multiprocessing as mp
import threading
import time
from collections import deque
from typing import Any

import numpy as np
import torch

from distributed_deep_q_tpu_torch import health, learning, tracing
from distributed_deep_q_tpu_torch.actors import game
from distributed_deep_q_tpu_torch.config import Config, env_for_actor
from distributed_deep_q_tpu_torch.metrics import Metrics
from distributed_deep_q_tpu_torch.parallel.multihost import (
    all_processes_ready, local_rows)


def actor_epsilon(i: int, n: int, base: float, alpha: float) -> float:
    if n <= 1:
        return base
    return float(base ** (1.0 + i * alpha / (n - 1)))


def _probe_envs(cfg: Config):
    """Probe every configured game once: verifies the fleet shares ONE
    action space (a single Q-head serves all games) and returns the first
    game's probe env for shape/dtype discovery."""
    games = cfg.env.games or (cfg.env.id,)
    counts: dict[str, int] = {}
    first = None
    for i, g in enumerate(games):
        e = game.make_env(env_for_actor(cfg.env, i), seed=cfg.train.seed)
        if first is None:
            first = e
        counts[g] = e.num_actions
        if e is not first:
            close = getattr(e, "close", None)
            if close:
                close()
    if len(set(counts.values())) != 1:
        raise ValueError(
            f"multi-game fleet requires one shared action space, got "
            f"{counts}; set env.full_action_space=true for ALE games")
    return first


def _split_fleet_across_processes(cfg: Config, pixel: bool, metrics,
                                  ring_desc: str, fused_ok: bool = False):
    """Each learner process's share of the run: its own server, actor
    slice and replay shards; each samples its ``B/pc`` rows into the train
    step, whose gradient mean spans the processes. Local actor ids
    ``0..k-1`` double as the process's replay streams; global identity (ε
    ladder, env seeds, multi-game assignment) comes from
    ``actor_id_offset`` or, under ``actors.assignment="hash"``, from the
    consistent-hash slice (``actors/assignment.py``). ``ring_desc`` names
    the host-sampled device ring in the refusal. The batch split is the
    ``Solver``'s (``local_batch``), which is built first and refuses a
    batch that does not divide.

    Returns (cfg, metrics, pc, pid): the metrics swapped for a sink-less
    instance on processes other than 0."""
    pc, pid = int(cfg.mesh.num_processes), int(cfg.mesh.process_id)
    if pc > 1:
        if cfg.actors.num_actors % pc:
            raise ValueError(f"actors.num_actors={cfg.actors.num_actors} "
                             f"must divide across {pc} processes")
        if pixel and cfg.replay.device_resident and not (
                fused_ok and cfg.replay.prioritized
                and cfg.replay.device_per):
            raise ValueError(
                f"the {ring_desc}'s host-sampled path is single-controller; "
                "multi-host --distributed pixel runs need either the FUSED "
                "ring (replay.prioritized=true + replay.device_per=true) or "
                "replay.device_resident=false")
        k = cfg.actors.num_actors // pc
        if cfg.actors.assignment == "hash":
            from distributed_deep_q_tpu_torch.actors.assignment import (
                local_slice)
            gids = local_slice(cfg.actors.num_actors, pc, pid)
            cfg = cfg.replace(actors=dataclasses.replace(
                cfg.actors, num_actors=k, actor_id_offset=0,
                actor_gids=tuple(gids),
                fleet_size=cfg.actors.num_actors))
        else:
            cfg = cfg.replace(actors=dataclasses.replace(
                cfg.actors, num_actors=k, actor_id_offset=pid * k,
                fleet_size=cfg.actors.num_actors))
        if pid != 0:
            metrics = Metrics()  # file sinks live on process 0 only
    return cfg, metrics, pc, pid


def check_distributed(cfg: Config) -> None:
    """Refuse, by name, the settings the port's distributed topology does
    not run. Called before any process is spawned."""
    from distributed_deep_q_tpu_torch.parallel.mesh import check_mesh
    from distributed_deep_q_tpu_torch.train import check_slice

    if cfg.replay.persist_path:
        raise ValueError(
            "replay.persist_path covers the single-process transition-"
            "replay paths; the distributed topology warm-refills from its "
            "actor fleet on restart (the reference behavior) — unset it "
            "for --distributed runs")
    check_mesh(cfg.mesh)
    check_slice(cfg)


class _ActorComms:
    """θ-pull + liveness policy, shared by both actor loop bodies.

    Heartbeats run on their OWN daemon thread, so liveness is independent
    of the env loop: a single ``env.step()`` (or a blocking RPC) stalling
    longer than the supervisor's ``heartbeat_timeout`` must not get a
    healthy actor respawned. The beat is PROGRESS-AWARE: once the loop's
    watermark (advanced by ``maybe_pull``, called every iteration) is
    older than ``actors.env_stall_budget``, beating stops, so a
    permanently wedged env still goes silent and gets replaced. The client
    stub is thread-safe (one lock serializes wire frames). θ pulls stay ON
    the env loop — they install weights into the qnet the loop is reading
    — and are phase-jittered per actor so a fleet never pulls in lockstep.
    """

    # after HB_WARN_AFTER consecutive heartbeat failures, log a warning at
    # most every HB_WARN_PERIOD seconds
    HB_WARN_AFTER = 8
    HB_WARN_PERIOD = 30.0

    def __init__(self, cfg: Config, client, qnet, rng):
        self._client = client
        self._qnet = qnet
        self._period = max(cfg.actors.param_sync_period, 1)
        self._phase = int(rng.integers(self._period))
        self._version = -1
        # telemetry buffers, drained into tm_* arrays on each transition
        # flush (bounded); appended from the env loop (_pull_ms) and the
        # beat thread (_hb_ms) — deque ops are atomic under the GIL
        self._pull_ms: deque = deque(maxlen=64)
        self._hb_ms: deque = deque(maxlen=64)
        self._hb_failures = 0
        self._hb_last_warn = 0.0
        # the beat paces on a PROCESS-LOCAL event, never on the shared
        # multiprocessing stop event: a thread parked in mp.Event.wait()
        # registers as a sleeper on the event's shared Condition, and a
        # SIGKILL'd actor dies still registered — the supervisor's next
        # stop_event.set() then blocks forever in notify_all()
        self._local_stop = threading.Event()
        self._stall_budget = float(cfg.actors.env_stall_budget)
        self._watermark = time.monotonic()
        # staleness guard: the newest published θ version rides back on
        # every flush reply (note_published); once the pulled version
        # trails it by more than max_param_lag, the next maybe_pull blocks
        # on a fresh pull regardless of the period
        self._max_lag = int(getattr(cfg.actors, "max_param_lag", 0))
        self._published = -1
        self.lag_blocks = 0  # pulls forced by the staleness guard
        hb = cfg.actors.heartbeat_period
        if hb:
            threading.Thread(target=self._beat, args=(float(hb),),
                             name="actor-heartbeat", daemon=True).start()

    def _beat(self, period: float) -> None:
        # a network hiccup must NOT kill the beat thread: retry with
        # exponential backoff while the loop is alive; only a non-network
        # error ends the thread, loudly. Single-attempt sends: the beat's
        # period IS its retry cadence
        call = getattr(self._client, "call_once", self._client.call)
        backoff = period
        while not self._local_stop.wait(backoff):
            if (self._stall_budget
                    and time.monotonic() - self._watermark
                    > self._stall_budget):
                backoff = period
                continue  # loop wedged past the budget: go silent (the
                #           supervisor respawns); resume if it recovers
            try:
                t0 = time.perf_counter()
                call("heartbeat")
                self._hb_ms.append(1e3 * (time.perf_counter() - t0))
                self._hb_failures = 0
                backoff = period
            except (ConnectionError, OSError, ValueError):
                backoff = min(backoff * 2, period * 8)
                self._hb_failures += 1
                now = time.monotonic()
                if (self._hb_failures >= self.HB_WARN_AFTER
                        and now - self._hb_last_warn > self.HB_WARN_PERIOD):
                    self._hb_last_warn = now
                    logging.getLogger(__name__).warning(
                        "heartbeat: %d consecutive failures (server "
                        "unreachable?); retrying every %.1fs",
                        self._hb_failures, backoff)
            except Exception as e:  # noqa: BLE001 — protocol desync etc.
                logging.getLogger(__name__).warning(
                    "heartbeat thread exiting on %s: %s",
                    type(e).__name__, e)
                return

    def close(self) -> None:
        self._local_stop.set()

    def touch(self) -> None:
        """Advance the liveness watermark for INTENTIONAL waits (credit
        pacing, a SHED wait), so a backpressured actor reads as alive."""
        self._watermark = time.monotonic()

    def note_published(self, version) -> None:
        """Record the newest θ version the server advertised on a flush
        reply (env-loop only)."""
        if version is not None and int(version) > self._published:
            self._published = int(version)

    def stale(self) -> bool:
        """True when the pulled θ trails the published version by more
        than ``actors.max_param_lag``."""
        return (self._max_lag > 0 and self._version >= 0
                and self._published - self._version > self._max_lag)

    def maybe_pull(self, steps: int) -> None:
        self._watermark = time.monotonic()  # loop progress (beat gate)
        due = steps == 0 or (steps + self._phase) % self._period == 0
        stale = self.stale()
        if not (due or stale):
            return
        if stale and not due:
            self.lag_blocks += 1
        t0 = time.perf_counter()
        with tracing.span("param_pull"):
            version, weights = self._client.get_params(
                have_version=self._version)
            # time the full round trip incl. installing fresh weights
            if weights is not None:
                self._qnet.set_weights(weights)
                self._version = version
        self._pull_ms.append(1e3 * (time.perf_counter() - t0))

    def drain_telemetry(self) -> dict[str, np.ndarray]:
        """Buffered latency samples as ``tm_*`` wire arrays (cleared on
        read); the server folds them into its fleet histograms."""
        out: dict[str, np.ndarray] = {}
        for key, q in (("tm_param_pull_ms", self._pull_ms),
                       ("tm_heartbeat_rtt_ms", self._hb_ms)):
            if q:
                samples = [q.popleft() for _ in range(len(q))]
                out[key] = np.asarray(samples, np.float32)
        return out


class _RemoteInference:
    """Exploit-action source for remote inference: the actor ships
    observations to the ``InferenceServer`` and receives argmax actions —
    zero steady-state θ pulls, staleness gone by construction (every
    action is computed against the server's live θ). ε-greedy stays OUT
    of this class, on the actor's own seeded rng, so the exploration
    stream is bitwise identical to local inference. Nothing here touches
    ``torch``.

    Transport rides the resilient wrapper (reconnect/backoff, credit
    grants feed its token bucket) and honors explicit shed replies with
    the server's retry hint. An infer is a pure function of (θ, obs), so
    a re-send after a shed or an ambiguous transport failure is
    idempotent for free — no flush_seq machinery needed."""

    def __init__(self, cfg: Config, stop_event, actor_id: int, gid: int,
                 touch=None):
        from distributed_deep_q_tpu_torch.rpc.inference_server import (
            InferenceClient)
        from distributed_deep_q_tpu_torch.rpc.resilience import (
            ResilientReplayFeedClient, RetryPolicy)

        policy = RetryPolicy(base_delay=cfg.actors.rpc_retry_base,
                             max_delay=cfg.actors.rpc_retry_max,
                             deadline=cfg.actors.rpc_retry_deadline)
        # retries on the INITIAL connect too: the inference server comes
        # up with the rest of the learner plane, maybe after this child
        seed = cfg.train.seed + 60217 * (gid + 1)
        rng = np.random.default_rng(seed)
        stub = policy.run(
            lambda: InferenceClient(cfg.inference.host, cfg.inference.port,
                                    actor_id=actor_id,
                                    timeout=cfg.actors.rpc_call_timeout),
            rng=rng, should_abort=stop_event.is_set)
        self._client = ResilientReplayFeedClient(
            stub, policy, should_abort=stop_event.is_set, seed=seed)
        self._client.on_backpressure = touch
        self._rng = rng
        self._seq = 0
        self.version = -1
        self.sheds = 0

    def action(self, obs) -> int:
        """One remote argmax action for a single observation."""
        return int(self.actions(np.asarray(obs)[None])[0])

    def actions(self, obs) -> np.ndarray:
        """Batched remote argmax actions: ONE ``infer`` RPC for a whole
        row batch — the vector actor's one-RPC-per-tick path. A shed sheds
        the WHOLE batch (the server admits whole requests only), so retry
        keeps the rows together and row order is preserved end to end. A
        server that answers it is closing (a restart) is retried like a
        dropped connection, under the stub's retry deadline. Any other
        ``error`` reply (a failed forward) raises ``RPCError``."""
        from distributed_deep_q_tpu_torch.rpc.inference_server import (
            CLOSING)
        from distributed_deep_q_tpu_torch.rpc.resilience import (
            RPCError, ServerClosing)

        batch = np.ascontiguousarray(np.asarray(obs))
        seq = self._seq
        self._seq += 1

        def refuse_closing(resp: dict) -> None:
            if resp.get("error") == CLOSING:
                raise ServerClosing(f"infer rejected: {CLOSING}")

        while True:
            with tracing.span("rpc_call"):
                resp = self._client.call("infer", reply_check=refuse_closing,
                                         obs=batch, seq=seq)
            if resp.get("error"):
                raise RPCError(f"infer rejected: {resp['error']}")
            if resp.get("shed"):
                self.sheds += 1
                tracing.instant(
                    "shed", plane="inference",
                    retry_after_ms=float(resp.get("retry_after_ms", 0)))
                delay = max(float(resp.get("retry_after_ms", 100)),
                            10.0) / 1e3
                # decorrelate the fleet's re-sends a little
                delay *= 1.0 + 0.25 * float(self._rng.random())
                self._client._sleep_backpressure(delay)
                continue
            self._client._note_reply(resp)
            if resp.get("version") is not None:
                self.version = int(resp["version"])
            return np.asarray(resp["actions"]).astype(np.int64)

    def close(self) -> None:
        self._client.close()


# ---------------------------------------------------------------------------
# Actor process
# ---------------------------------------------------------------------------


def actor_main(cfg: Config, host: str, port: int, actor_id: int,
               stop_event, max_env_steps: int = 0) -> None:
    """One CPU actor: play with ε-greedy policy, ship transitions, pull θ.

    Runs in a spawned process on the host: its ``QNet`` lives on the CPU
    and nothing here touches ``torch.cuda``. A spawned actor pins torch's
    intra-op pool to one thread (a batch-1 forward gains nothing from
    more, and a fleet would otherwise claim every core N times over); a
    caller running it in a thread keeps its own pool. All communication
    goes through the ``ReplayFeed`` boundary.
    """
    if mp.parent_process() is not None:
        torch.set_num_threads(1)
    # tracing config rides the pickled cfg into the spawned child; spans
    # from this process export as their own shard (trace-<pid>.json)
    tracing.configure_from(cfg.trace)
    if int(cfg.actors.vector_envs) > 1 and cfg.net.kind != "r2d2":
        # this process drives vector_envs stacked env copies behind one
        # batched step — same identities, same wire path, V streams
        _vector_actor_loop(cfg, host, port, actor_id, stop_event,
                           max_env_steps)
        return
    from distributed_deep_q_tpu_torch.models.qnet import QNet
    from distributed_deep_q_tpu_torch.rpc.resilience import (
        ResilientReplayFeedClient, RetryPolicy)

    # seeding and the ε ladder use the fleet-global id
    gid = (cfg.actors.actor_gids[actor_id] if cfg.actors.actor_gids
           else actor_id + cfg.actors.actor_id_offset)
    fleet = cfg.actors.fleet_size or cfg.actors.num_actors
    env = game.StepLatencyEnv(game.make_env(
        env_for_actor(cfg.env, gid), seed=cfg.train.seed + 1000 * (gid + 1)))
    cfg.net.num_actions = env.num_actions
    qnet = QNet(cfg.net, seed=cfg.train.seed,
                obs_dim=int(np.prod(env.obs_shape)), device="cpu")
    # resilient stub: transient server outages are absorbed by retry/
    # backoff with idempotent flush_seq stamping
    client = ResilientReplayFeedClient.connect(
        host, port, actor_id=actor_id,
        policy=RetryPolicy(base_delay=cfg.actors.rpc_retry_base,
                           max_delay=cfg.actors.rpc_retry_max,
                           deadline=cfg.actors.rpc_retry_deadline),
        timeout=cfg.actors.rpc_call_timeout,
        should_abort=stop_event.is_set,
        seed=cfg.train.seed + 31337 * (gid + 1))
    # announce a fresh writer on this stream id: the server seals the
    # previous writer's slot so no sampled window straddles a restart seam
    client.call("reset_stream")
    rng = np.random.default_rng(cfg.train.seed + 7777 * (gid + 1))
    eps = actor_epsilon(gid, fleet, cfg.actors.eps_base,
                        cfg.actors.eps_alpha)

    if cfg.net.kind == "r2d2":
        _recurrent_actor_loop(cfg, env, qnet, client, rng, eps, stop_event,
                              max_env_steps)
        return

    pixel = env.obs_dtype == np.uint8
    stacker = (game.FrameStacker(env.obs_shape, cfg.env.stack) if pixel
               else None)
    nstep = (None if pixel else
             game.NStepAccumulator(cfg.replay.n_step, cfg.train.gamma))

    chunk: dict[str, list] = {k: [] for k in
                              ("frame", "action", "reward", "done", "boundary",
                               "obs", "next_obs", "discount")}
    ep_returns: list[float] = []
    # per-row birth stamps (lineage plane) — only while tracing is on
    births: list[float] = []
    episodes = 0
    steps = 0

    def flush() -> None:
        nonlocal episodes
        if not chunk["action"]:
            return
        if pixel:
            payload = {
                "frame": np.stack(chunk["frame"]).astype(np.uint8),
                "action": np.asarray(chunk["action"], np.int32),
                "reward": np.asarray(chunk["reward"], np.float32),
                "done": np.asarray(chunk["done"], bool),
                "boundary": np.asarray(chunk["boundary"], bool),
            }
        else:
            payload = {
                "obs": np.stack(chunk["obs"]).astype(np.float32),
                "action": np.asarray(chunk["action"], np.int32),
                "reward": np.asarray(chunk["reward"], np.float32),
                "next_obs": np.stack(chunk["next_obs"]).astype(np.float32),
                "discount": np.asarray(chunk["discount"], np.float32),
            }
        payload["episodes"] = episodes
        payload["ep_returns"] = np.asarray(ep_returns, np.float32)
        payload.update(comms.drain_telemetry())
        step_ms = env.drain_step_ms()
        if step_ms:
            payload["tm_env_step_ms"] = np.asarray(step_ms, np.float32)
        if births:
            if tracing.lineage_sample():
                # birth stamps ship pre-corrected to the SERVER clock
                payload[tracing.KEY_BIRTH] = tracing.to_server_clock(
                    np.asarray(births, np.float64))
            births.clear()
        resp = client.add_transitions(**payload)
        comms.note_published(resp.get("params_version"))
        for v in chunk.values():
            v.clear()
        ep_returns.clear()
        episodes = 0

    frame = env.reset()
    obs = stacker.reset(frame) if pixel else frame
    ep_ret = 0.0
    # θ refresh over the RPC boundary + background liveness beat
    comms = _ActorComms(cfg, client, qnet, rng)
    # credit throttling / SHED waits advance the liveness watermark
    client.on_backpressure = comms.touch
    remote = None
    if cfg.inference.enabled:
        # exploit actions come from the batched inference plane; this
        # actor never pulls θ
        remote = _RemoteInference(cfg, stop_event, actor_id, gid,
                                  touch=comms.touch)
    try:
        while not stop_event.is_set():
            if max_env_steps and steps >= max_env_steps:
                break
            if remote is None:
                comms.maybe_pull(steps)
            else:
                comms.touch()  # loop progress for the heartbeat gate
            # ε-greedy stays local either way: the SAME rng draws in the
            # SAME order, so the exploration stream is bitwise identical
            # between local and remote inference
            if rng.random() < eps:
                a = int(rng.integers(env.num_actions))
            elif remote is not None:
                with tracing.span_sampled("remote_infer"):
                    a = remote.action(obs)
            else:
                a = qnet.argmax_action(np.asarray(obs))
            with tracing.span_sampled("env_step"):
                next_frame, r, done, over = env.step(a)
            ep_ret += r
            steps += 1

            if pixel:
                chunk["frame"].append(frame)
                chunk["action"].append(a)
                chunk["reward"].append(r)
                chunk["done"].append(done)
                chunk["boundary"].append(over)
                if tracing.ENABLED:
                    births.append(tracing.now())
                frame = next_frame
                obs = stacker.push(frame)
            else:
                emitted = nstep.push(obs, a, r, next_frame, done)
                if over and not done:
                    emitted += nstep.flush_truncated(next_frame)
                for (o, ac, rw, no, disc) in emitted:
                    chunk["obs"].append(o)
                    chunk["action"].append(ac)
                    chunk["reward"].append(rw)
                    chunk["next_obs"].append(no)
                    chunk["discount"].append(disc)
                    if tracing.ENABLED:
                        births.append(tracing.now())
                obs = next_frame

            if over:
                ep_returns.append(ep_ret)
                episodes += 1
                ep_ret = 0.0
                frame = env.reset()
                if pixel:
                    obs = stacker.reset(frame)
                else:
                    obs = frame
                    nstep.reset()

            if len(chunk["action"]) >= cfg.actors.send_batch:
                flush()
        flush()
    except (ConnectionError, OSError):
        pass  # learner gone; supervisor owns our lifecycle
    finally:
        comms.close()
        if remote is not None:
            remote.close()
        client.close()
        if tracing.ENABLED:
            tracing.export()


def _liveness_id(cfg: Config, actor_id: int) -> int:
    """The ``last_seen`` key an actor's heartbeat lane uses.

    With vectorized acting the replay STREAM ids are ``process*V + row``,
    so process p's row-r stream would alias process ``p*V + r``'s liveness
    key — a live process 0 could mask a dead process 1 forever. The
    heartbeat client therefore signs in on a lane BEYOND the stream range
    (``num_actors*V + process``); with one env per process the lane is the
    actor id."""
    v = max(int(cfg.actors.vector_envs), 1)
    return cfg.actors.num_actors * v + actor_id if v > 1 else actor_id


def _vector_actor_loop(cfg: Config, host: str, port: int, actor_id: int,
                       stop_event, max_env_steps: int = 0) -> None:
    """Vectorized actor process body (the Sebulba half of the Podracer
    split): V stacked envs, one batched policy call per wall tick — a
    local CPU ``QNet`` forward, or ONE ``infer`` RPC to the learner's card
    with ``inference.enabled`` — and V per-row replay streams down the
    columnar wire path. Nothing here touches the card.

    Identity discipline is what makes this a MODE and not a fork: row j
    of process i plays fleet-global id ``base*V + j`` (``base`` = this
    process's gid), with exactly the per-env fleet's seeds — env seed
    ``seed + 1000*(gid+1)``, ε rng ``seed + 7777*(gid+1)``, ε ladder
    slot ``gid`` of ``num_actors*V`` — and ships on replay stream
    ``actor_id*V + j``. Same seeds → same actions → same transitions
    (``tests/test_torch_vector_env.py`` pins it on both torsos).
    """
    from distributed_deep_q_tpu_torch.actors.vector import (
        VectorActing, VectorEnv, VectorStepLatencyEnv)
    from distributed_deep_q_tpu_torch.models.qnet import QNet
    from distributed_deep_q_tpu_torch.rpc.resilience import (
        ResilientReplayFeedClient, RetryPolicy)

    v = int(cfg.actors.vector_envs)
    base = (cfg.actors.actor_gids[actor_id] if cfg.actors.actor_gids
            else actor_id + cfg.actors.actor_id_offset)
    gids = [base * v + j for j in range(v)]
    fleet = cfg.actors.fleet_size or cfg.actors.num_actors * v
    venv = VectorStepLatencyEnv(VectorEnv(game.make_envs(
        [env_for_actor(cfg.env, g) for g in gids],
        [cfg.train.seed + 1000 * (g + 1) for g in gids])))
    cfg.net.num_actions = venv.num_actions
    # ONE shared θ copy: every per-env actor seeds its QNet with
    # cfg.train.seed, so one net IS all of them
    qnet = QNet(cfg.net, seed=cfg.train.seed,
                obs_dim=int(np.prod(venv.obs_shape)), device="cpu")

    def _policy() -> RetryPolicy:
        return RetryPolicy(base_delay=cfg.actors.rpc_retry_base,
                           max_delay=cfg.actors.rpc_retry_max,
                           deadline=cfg.actors.rpc_retry_deadline)

    # per-row stream clients: stream id actor_id*V + j keeps the
    # server-side contract intact — flush_seq dedup, slot ownership and
    # per-stream telemetry all key on it, exactly as V processes
    clients = []
    for j, g in enumerate(gids):
        c = ResilientReplayFeedClient.connect(
            host, port, actor_id=actor_id * v + j, policy=_policy(),
            timeout=cfg.actors.rpc_call_timeout,
            should_abort=stop_event.is_set,
            seed=cfg.train.seed + 31337 * (g + 1))
        c.call("reset_stream")
        clients.append(c)
    # heartbeat/θ lane on its own liveness id (see _liveness_id) with a
    # DEDICATED rng: _ActorComms draws its pull phase at construction,
    # and that draw must not perturb any row's ε stream
    comms_client = ResilientReplayFeedClient.connect(
        host, port, actor_id=_liveness_id(cfg, actor_id), policy=_policy(),
        timeout=cfg.actors.rpc_call_timeout,
        should_abort=stop_event.is_set,
        seed=cfg.train.seed + 31337 * (fleet + actor_id + 1))
    comms = _ActorComms(cfg, comms_client, qnet,
                        np.random.default_rng(
                            cfg.train.seed + 4242 * (actor_id + 1)))
    comms_client.on_backpressure = comms.touch
    for c in clients:
        c.on_backpressure = comms.touch

    rngs = [np.random.default_rng(cfg.train.seed + 7777 * (g + 1))
            for g in gids]
    epsilons = [actor_epsilon(g, fleet, cfg.actors.eps_base,
                              cfg.actors.eps_alpha) for g in gids]
    acting = VectorActing(venv, cfg.env.stack, rngs, epsilons)

    remote = None
    if cfg.inference.enabled:
        remote = _RemoteInference(cfg, stop_event, actor_id * v, base,
                                  touch=comms.touch)

    infer_ms: list[float] = []
    infer_rows: list[float] = []

    def greedy_fn(rows: np.ndarray) -> np.ndarray:
        if remote is not None:
            with tracing.span_sampled("vector_infer"):
                t0 = time.perf_counter()
                out = remote.actions(rows)
            infer_ms.append(1e3 * (time.perf_counter() - t0))
            infer_rows.append(float(len(rows)))
            return out
        return np.argmax(np.asarray(qnet.forward(rows)), axis=-1)

    chunks = [{k: [] for k in ("frame", "action", "reward", "done",
                               "boundary")} for _ in range(v)]
    births: list[list[float]] = [[] for _ in range(v)]
    ep_rets: list[list[float]] = [[] for _ in range(v)]
    episodes = [0] * v
    resets_sent = 0

    def flush(j: int) -> None:
        nonlocal resets_sent
        ch = chunks[j]
        if not ch["action"]:
            return
        payload = {
            "frame": np.stack(ch["frame"]).astype(np.uint8),
            "action": np.asarray(ch["action"], np.int32),
            "reward": np.asarray(ch["reward"], np.float32),
            "done": np.asarray(ch["done"], bool),
            "boundary": np.asarray(ch["boundary"], bool),
            "episodes": episodes[j],
            "ep_returns": np.asarray(ep_rets[j], np.float32),
        }
        # process-level telemetry rides whichever stream flushes next
        # (drain semantics — each sample ships exactly once)
        payload.update(comms.drain_telemetry())
        step_ms = venv.drain_step_ms()
        if step_ms:
            tick_ms = np.asarray(step_ms, np.float32)
            payload["tm_vector_step_ms"] = tick_ms
            # amortized per-env step cost feeds the SAME fleet histogram
            # the per-env actors populate, so the two modes compare on
            # one axis
            payload["tm_env_step_ms"] = tick_ms / v
        if infer_ms:
            payload["tm_vector_infer_ms"] = np.asarray(infer_ms, np.float32)
            infer_ms.clear()
        if infer_rows:
            payload["tm_vector_rows"] = np.asarray(infer_rows, np.float32)
            infer_rows.clear()
        new_resets = acting.auto_resets - resets_sent
        if new_resets:
            payload["tm_vector_resets"] = np.asarray(
                [new_resets], np.float32)
            resets_sent = acting.auto_resets
        if births[j]:
            if tracing.lineage_sample():
                payload[tracing.KEY_BIRTH] = tracing.to_server_clock(
                    np.asarray(births[j], np.float64))
            births[j].clear()
        resp = clients[j].add_transitions(**payload)
        comms.note_published(resp.get("params_version"))
        for q in ch.values():
            q.clear()
        ep_rets[j].clear()
        episodes[j] = 0

    ticks = 0
    steps = 0
    try:
        while not stop_event.is_set():
            if max_env_steps and steps >= max_env_steps:
                break
            if remote is None:
                comms.maybe_pull(ticks)
            else:
                comms.touch()
            with tracing.span_sampled("vector_step"):
                frames, actions, rewards, dones, overs = \
                    acting.tick(greedy_fn)
            now = tracing.now() if tracing.ENABLED else 0.0
            for j in range(v):
                ch = chunks[j]
                ch["frame"].append(frames[j])
                ch["action"].append(int(actions[j]))
                ch["reward"].append(float(rewards[j]))
                ch["done"].append(bool(dones[j]))
                ch["boundary"].append(bool(overs[j]))
                if tracing.ENABLED:
                    births[j].append(now)
                if overs[j]:
                    episodes[j] += 1
            for j, ret in acting.drain_completed():
                ep_rets[j].append(ret)
            ticks += 1
            steps += v
            for j in range(v):
                if len(chunks[j]["action"]) >= cfg.actors.send_batch:
                    flush(j)
        for j in range(v):
            flush(j)
    except (ConnectionError, OSError):
        pass  # learner gone; supervisor owns our lifecycle
    finally:
        comms.close()
        if remote is not None:
            remote.close()
        for c in clients:
            c.close()
        comms_client.close()
        if tracing.ENABLED:
            tracing.export()


def _recurrent_actor_loop(cfg: Config, env, qnet, client, rng, eps: float,
                          stop_event, max_env_steps: int = 0) -> None:
    """R2D2 actor body: thread the LSTM carry through the episode, assemble
    overlapping sequences with the stored start-of-window carry
    (``SequenceBuilder``), and ship whole sequences over the RPC boundary.

    The carry ALWAYS advances (even on random actions) so the carry stored
    with each sequence matches what the policy network actually saw. It is
    stored as ``(c, h)``, the reference's Flax carry order, so a port actor
    and a reference learner (or the reverse) burn in from the same state.
    """
    from distributed_deep_q_tpu_torch.replay.sequence import SequenceBuilder

    pixel = env.obs_dtype == np.uint8
    stacker = (game.FrameStacker(env.obs_shape, cfg.env.stack) if pixel
               else None)
    obs_shape = (tuple(env.obs_shape) + (cfg.env.stack,)) if pixel \
        else tuple(env.obs_shape)
    obs_dtype = np.uint8 if pixel else np.float32
    builder = SequenceBuilder(cfg.replay.sequence_length, cfg.replay.burn_in,
                              obs_shape, obs_dtype, cfg.net.lstm_size,
                              cfg.train.gamma)
    # one RPC message per ~send_batch transitions, in whole-sequence units
    period = max(cfg.replay.sequence_length - cfg.replay.burn_in, 1)
    send_seqs = max(1, cfg.actors.send_batch // period)

    seqs: list[dict] = []
    ep_returns: list[float] = []
    births: list[float] = []  # per-env-step birth stamps (tracing only)
    episodes = 0
    env_steps_since = 0
    steps = 0

    def flush() -> None:
        nonlocal episodes, env_steps_since
        if not seqs:
            return
        payload: dict = {k: np.stack([s[k] for s in seqs]) for k in seqs[0]}
        payload["episodes"] = episodes
        payload["ep_returns"] = np.asarray(ep_returns, np.float32)
        payload["env_steps"] = env_steps_since
        payload.update(comms.drain_telemetry())
        step_ms = getattr(env, "drain_step_ms", lambda: [])()
        if step_ms:
            payload["tm_env_step_ms"] = np.asarray(step_ms, np.float32)
        if births:
            if tracing.lineage_sample():
                # rows ≠ ring slots for overlapping sequences: the server
                # folds these into the flush-level ingest-lag histogram
                payload[tracing.KEY_BIRTH] = tracing.to_server_clock(
                    np.asarray(births, np.float64))
            births.clear()
        resp = client.add_transitions(**payload)
        comms.note_published(resp.get("params_version"))
        seqs.clear()
        ep_returns.clear()
        episodes = 0
        env_steps_since = 0

    frame = env.reset()
    obs = stacker.reset(frame) if pixel else frame
    carry = qnet.initial_state(1)
    ep_ret = 0.0
    comms = _ActorComms(cfg, client, qnet, rng)
    client.on_backpressure = comms.touch
    try:
        while not stop_event.is_set():
            if max_env_steps and steps >= max_env_steps:
                break
            comms.maybe_pull(steps)

            carry_before = carry
            q, carry = qnet.forward(np.asarray(obs)[None, None], carry)
            if rng.random() < eps:
                a = int(rng.integers(env.num_actions))
            else:
                a = int(np.argmax(q[0, 0]))
            with tracing.span_sampled("env_step"):
                next_frame, r, done, over = env.step(a)
            next_obs = stacker.push(next_frame) if pixel else next_frame
            ep_ret += r
            steps += 1
            env_steps_since += 1
            if tracing.ENABLED:
                births.append(tracing.now())
            seqs.extend(builder.on_step(
                obs, a, r, done, (carry_before[0][0], carry_before[1][0]),
                next_obs))
            obs = next_obs

            if over:
                if not done:
                    # time-limit truncation: ship the window tail with its
                    # bootstrap intact
                    seqs.extend(builder.flush_truncated(next_obs))
                ep_returns.append(ep_ret)
                episodes += 1
                ep_ret = 0.0
                builder.reset()
                frame = env.reset()
                obs = stacker.reset(frame) if pixel else frame
                carry = qnet.initial_state(1)

            if len(seqs) >= send_seqs:
                flush()
        flush()
    except (ConnectionError, OSError):
        pass  # learner gone; supervisor owns our lifecycle
    finally:
        comms.close()
        client.close()
        if tracing.ENABLED:
            tracing.export()


# ---------------------------------------------------------------------------
# Supervisor (failure detection)
# ---------------------------------------------------------------------------


class ActorSupervisor:
    """Spawns the actor fleet and restarts dead or silent actors.

    The fleet is elastic: the autoscale executor grows and retires actors
    at run time through ``grow``/``retire``, so the process map moves
    under ``_procs_lock``: the watch loop re-checks membership under it
    before acting, so a concurrent retirement is never respawned.
    Retirements are counted in ``executor_terminations``, separate from
    ``kill_escalations`` (SIGKILL escalations of crashed or hung actors).
    """

    def __init__(self, cfg: Config, host: str, port: int,
                 heartbeat_timeout: float = 60.0,
                 spawn_grace: float = 120.0, target=None):
        self.cfg = cfg
        self.host, self.port = host, port
        self.heartbeat_timeout = heartbeat_timeout
        # first-contact deadline for a fresh (re)spawn: generous (a child
        # imports torch and the port before its first heartbeat) but
        # finite, so an actor that hangs BEFORE its first heartbeat is
        # still detected and replaced
        self.spawn_grace = max(spawn_grace, heartbeat_timeout)
        # the child entry point: actor_main unless a harness substitutes
        # a lightweight worker (same (cfg, host, port, i, stop) shape)
        self._target = target or actor_main
        self._ctx = mp.get_context("spawn")
        # parent-side master switch (watch-loop pacing). Children get a
        # PRIVATE per-incarnation event instead: a child terminated while
        # parked in mp.Event.wait() dies still registered as a sleeper on
        # the event's shared Condition, and the next set() on that event
        # deadlocks; a private one is orphaned harmlessly
        self.stop_event = self._ctx.Event()
        self._procs_lock = threading.RLock()
        self._child_stops: dict[int, Any] = {}
        self.procs: dict[int, Any] = {}
        self.spawned_at: dict[int, float] = {}
        self.retired: set[int] = set()
        self.restarts = 0
        self.kill_escalations = 0
        self.executor_terminations = 0
        self._watch: threading.Thread | None = None

    def _spawn(self, i: int) -> None:
        ev = self._ctx.Event()
        p = self._ctx.Process(
            target=self._target,
            args=(self.cfg, self.host, self.port, i, ev),
            name=f"actor-{i}", daemon=True)
        p.start()
        with self._procs_lock:
            self.procs[i] = p
            self._child_stops[i] = ev
            self.spawned_at[i] = time.monotonic()

    def start(self) -> None:
        for i in range(self.cfg.actors.num_actors):
            self._spawn(i)

    # -- elastic surface ----------------------------------------------------

    def fleet_size(self) -> int:
        with self._procs_lock:
            return len(self.procs)

    def actor_ids(self) -> list[int]:
        with self._procs_lock:
            return sorted(self.procs)

    def grow(self) -> int:
        """Start one more actor: reuse the lowest retired slot else mint
        the next id. Returns the actor id."""
        with self._procs_lock:
            if self.retired:
                i = min(self.retired)
                self.retired.discard(i)
            else:
                i = max(self.procs) + 1 if self.procs else 0
        self._spawn(i)
        return i

    def retire(self, i: int) -> bool:
        """Scale-down of one actor: remove it from the supervised map
        FIRST (so the watch loop cannot respawn it), then stop it — its
        private stop event first, the escalation ladder after."""
        with self._procs_lock:
            p = self.procs.pop(i, None)
            self.spawned_at.pop(i, None)
            ev = self._child_stops.pop(i, None)
            if p is not None:
                self.retired.add(i)
        if p is None:
            return False
        if ev is not None:
            ev.set()
            p.join(timeout=2)
        self._reap(p)
        with self._procs_lock:
            self.executor_terminations += 1
        return True

    def reap_actor(self, i: int) -> bool:
        """Rollback path: reap a just-grown actor that missed its grace
        window and release its slot for the next grow."""
        return self.retire(i)

    def _is_silent(self, now: float, last: float, spawned: float) -> bool:
        """Liveness verdict for one actor. Contact since the last
        (re)spawn → plain heartbeat timeout. No contact yet (stale stamps
        from a previous incarnation count as none) → the spawn-grace
        deadline."""
        if last > spawned:
            return now - last > self.heartbeat_timeout
        return now - spawned > self.spawn_grace

    def _reap(self, p) -> None:
        """terminate → join → kill escalation; each escalation counted."""
        if p.is_alive():
            p.terminate()
        p.join(timeout=5)
        if p.is_alive():
            p.kill()
            p.join(timeout=5)
            with self._procs_lock:
                self.kill_escalations += 1

    def watch(self, last_seen: dict[int, float],
              poll_period: float = 2.0) -> None:
        """Background liveness loop: restart on process death or heartbeat
        silence (``last_seen`` is the ReplayFeed server's contact map)."""
        def loop() -> None:
            while not self.stop_event.is_set():
                now = time.monotonic()
                with self._procs_lock:
                    snap = list(self.procs.items())
                    spawned = dict(self.spawned_at)
                for i, p in snap:
                    dead = not p.is_alive()
                    silent = self._is_silent(
                        now, last_seen.get(_liveness_id(self.cfg, i), 0.0),
                        spawned.get(i, 0.0))
                    if dead or silent:
                        with self._procs_lock:
                            if (self.procs.get(i) is not p
                                    or self.stop_event.is_set()):
                                continue  # retired/replaced/stopping
                            self.restarts += 1
                        self._reap(p)
                        self._spawn(i)
                self.stop_event.wait(poll_period)

        self._watch = threading.Thread(target=loop, name="actor-supervisor",
                                       daemon=True)
        self._watch.start()

    def stop(self, timeout: float = 10.0) -> None:
        self.stop_event.set()
        if self._watch is not None:
            # no respawn after this: a restart racing the stop has spawned
            # into self.procs by the time the loop exits
            self._watch.join(timeout=timeout)
        with self._procs_lock:
            procs = list(self.procs.values())
            events = list(self._child_stops.values())
        # only live, supervised children share these events, so set()
        # here cannot trip the dead-sleeper deadlock
        for ev in events:
            ev.set()
        for p in procs:
            p.join(timeout=timeout)
            if p.is_alive():
                self._reap(p)


# ---------------------------------------------------------------------------
# Distributed training loop (learner side)
# ---------------------------------------------------------------------------


def _bring_up_rpc_plane(cfg: Config, replay, obs_dim: int = 4,
                        device: torch.device | str = "cuda"):
    """Server + supervised fleet, with the fault-tolerance plumbing: chaos
    spec exported for the spawned actors to inherit, warm boot from
    ``train.server_snapshot_path`` (stable port when snapshotting — a
    restarted learner must come back where the fleet expects it), and the
    membership registry seeded with this host. Call it from the learner's
    thread: the server starts the device ring's ingest drain, whose writes
    go on the stream current here.

    With ``inference.enabled`` (feed-forward nets only) the batched
    inference plane comes up too, its ``BatchedPolicy`` on ``device`` (the
    solver's): its bound address is written into ``cfg.inference`` BEFORE
    the supervisor is made, because the fleet learns it through the cfg
    pickled into each spawned child. Returns ``(server, sup,
    infer_server or None)``."""
    import os

    from distributed_deep_q_tpu_torch.actors.membership import (
        MembershipRegistry)
    from distributed_deep_q_tpu_torch.rpc import faultinject
    from distributed_deep_q_tpu_torch.rpc.flowcontrol import FlowConfig
    from distributed_deep_q_tpu_torch.rpc.replay_server import (
        ReplayFeedServer)

    if cfg.actors.chaos:
        os.environ[faultinject.ENV_VAR] = cfg.actors.chaos
    snap = cfg.train.server_snapshot_path
    flow = FlowConfig(
        flush_credit_floor=cfg.actors.flush_credit_floor,
        staged_high_watermark=cfg.replay.staged_high_watermark,
        shed_policy=cfg.replay.shed_policy,
        rss_high_watermark_mb=cfg.replay.rss_high_watermark_mb)
    server = ReplayFeedServer(replay, host=cfg.actors.host,
                              port=cfg.actors.port if snap else 0,
                              snapshot_path=snap, flow=flow,
                              snapshot_keep=cfg.train.snapshot_keep)
    infer_server = None
    if cfg.inference.enabled and cfg.net.kind != "r2d2":
        from distributed_deep_q_tpu_torch.models.policy import BatchedPolicy
        from distributed_deep_q_tpu_torch.rpc.inference_server import (
            InferenceServer)
        policy = BatchedPolicy(cfg.net, seed=cfg.train.seed,
                               obs_dim=obs_dim,
                               buckets=cfg.inference.buckets,
                               device=device)
        infer_server = InferenceServer(
            policy, host=cfg.inference.host, port=cfg.inference.port,
            max_batch=cfg.inference.max_batch,
            cutoff_us=cfg.inference.cutoff_us,
            flow=FlowConfig(
                staged_high_watermark=cfg.inference.queue_high_watermark,
                shed_policy=cfg.replay.shed_policy),
            tenants=cfg.inference.tenants,
            shed_shadow_frac=cfg.inference.shed_shadow_frac,
            shed_ab_frac=cfg.inference.shed_ab_frac,
            ladder_burn_s=cfg.inference.ladder_burn_s)
        cfg.inference.host, cfg.inference.port = infer_server.address
    host, port = server.address
    registry = MembershipRegistry()
    registry.join(f"host-{cfg.mesh.process_id}", host, port)
    server.attach_membership(registry)
    sup = ActorSupervisor(cfg, host, port)
    sup.start()
    sup.watch(server.last_seen)
    return server, sup, infer_server


def _publish_weights(server, infer_server, weights) -> int:
    """One θ publish across both planes: the replay feed's cached wire
    frame (local-inference pulls) and the inference server's in-process
    install, tied to the SAME version number so actors on either plane
    agree on what "current" means. Returns the version."""
    version = server.publish_params(weights)
    if infer_server is not None:
        infer_server.set_params(weights, version=version)
    return version


def _bring_up_health_plane(cfg: Config, server, infer_server=None,
                           solver=None, replay=None, fused: bool = False):
    """Fleet health aggregator + live MFU meter. Each server's
    ``health_scrape`` (the replay feed's, and the inference plane's when
    it is up) registers with one ``FleetHealth``. The MFU meter
    gets a FLOPs-per-step count only on the fused device-PER path and only
    while the health plane is on (the count runs one extra dispatch).
    Returns ``(fleet, meter)``; both are inert while ``health.ENABLED`` is
    off."""
    from distributed_deep_q_tpu_torch.profiling import (
        MFUMeter, fused_train_flops, peak_flops_for)

    fleet = health.FleetHealth()
    fleet.register("replay", server.health_scrape)
    if infer_server is not None:
        fleet.register("inference", infer_server.health_scrape)
    flops = peak = None
    if health.ENABLED and solver is not None:
        peak = peak_flops_for(solver.device)
        if fused and replay is not None:
            flops = fused_train_flops(solver, replay, cfg.replay.fused_chain)
    return fleet, MFUMeter(flops, peak)


def _bring_up_autoscaler(cfg: Config, sup=None, server=None):
    """Health-driven autoscaler + its executor. Returns ``(autoscaler,
    executor)`` — ``(None, None)`` unless BOTH the health plane and
    ``cfg.autoscale`` are enabled (the scaler's only input is the fleet
    verdict). The executor also needs ``autoscale.execute`` and a
    supervisor to drive; it drains and evicts through the replay server
    and checks spawn-grace heartbeats against its contact map."""
    if not (health.ENABLED and cfg.autoscale.enabled):
        return None, None
    from distributed_deep_q_tpu_torch.actors.autoscaler import Autoscaler
    a = cfg.autoscale
    boot = cfg.actors.fleet_size or cfg.actors.num_actors
    scaler = Autoscaler(
        min_actors=min(a.min_actors, boot),
        max_actors=a.max_actors or boot,
        min_inference=a.min_inference, max_inference=a.max_inference,
        step=a.step, cooldown_s=a.cooldown_s,
        recover_ticks=a.recover_ticks)
    executor = None
    if a.execute and sup is not None:
        from distributed_deep_q_tpu_torch.actors.executor import (
            ScaleExecutor)
        hb = seq = evict = None
        if server is not None:
            spawned = sup.spawned_at

            def hb(i: int) -> bool:  # noqa: E306 — grace-window check
                return (server.last_seen.get(_liveness_id(cfg, i), 0.0)
                        > spawned.get(i, 0.0))

            seq = server.stream_seq_of
            evict = server.retire_stream
        executor = ScaleExecutor(
            sup, rate_limit_s=a.rate_limit_s, drain_s=a.drain_s,
            spawn_grace_s=a.spawn_grace_s, dry_run=a.dry_run,
            heartbeat_ok=hb, stream_seq=seq, retire_stream=evict)
    return scaler, executor


def _health_tick(fleet, meter, server, gstep: int, scrape: bool = True,
                 autoscaler=None, executor=None) -> dict:
    """Per-log-tick health record: live MFU + ingest utilization gauges,
    fleet self-accounting and the aggregated verdict (JSON-able; empty
    while disabled).

    With an autoscaler attached, each FRESH scrape is folded through it
    (a stale ``last()`` verdict would double-count into the recovery
    streak) and its decisions ride the record under
    ``autoscale/decision``; with an executor, they are applied here, on
    this thread, and every action lands under ``autoscale/applied`` naming
    the decision's rule."""
    if not health.ENABLED:
        return {}
    fc = server.flow_counters()
    out = meter.update(gstep, ingest_rate=fc["ingest_rate"],
                       consume_rate=fc["consume_rate"])
    v = fleet.scrape() if scrape else fleet.last()
    out.update(fleet.gauges())
    if server.membership is not None:
        out.update(server.membership.gauges())
    if autoscaler is not None and scrape:
        decisions = autoscaler.observe(v)
        out.update(autoscaler.gauges())
        if decisions:
            out["autoscale/decision"] = [d.to_jsonable()
                                         for d in decisions]
        if executor is not None:
            applied = executor.apply(decisions)
            out.update(executor.gauges())
            if applied:
                out["autoscale/applied"] = applied
    out["health/verdict"] = v.to_jsonable()
    return out


def _fleet_rate(server, first: tuple[float, int]) -> float:
    """The fleet's env steps/s: env steps landed since ``first`` (see
    ``_wait_for_fill``) over the wall time since."""
    t0, n0 = first
    return ((server.counters()["env_steps"] - n0)
            / max(time.monotonic() - t0, 1e-9))


def _tear_down_rpc_plane(cfg: Config, server, sup, infer_server=None) -> None:
    sup.stop()
    if infer_server is not None:
        infer_server.close()
    snap = cfg.train.server_snapshot_path
    if snap:
        server.shutdown(snap)  # quiesce + snapshot for the next warm boot
    else:
        server.close()


def _restore(cfg: Config, solver):
    """The newest checkpoint into ``solver`` on ``train.resume`` (made
    process 0's on every process). Returns the checkpointer or None."""
    from distributed_deep_q_tpu_torch.utils.checkpoint import (
        maybe_checkpointer)
    ckpt = maybe_checkpointer(cfg.train)
    if ckpt and cfg.train.resume and ckpt.latest_step() is not None:
        solver.state, _ = ckpt.restore(solver.state)
        solver.replicate_state()
    return ckpt


def _wait_for_fill(server, ready) -> tuple[float, int]:
    """Wait for the learn gate (the actors stream meanwhile). Returns when,
    and at how many env steps, rows from the fleet were first seen: the
    origin of the fleet's env steps/s, so the actors' start-up is not
    counted against it."""
    first = None
    while not ready():
        if first is None and (n := server.counters()["env_steps"]):
            first = (time.monotonic(), n)
        time.sleep(0.05)
    return first or (time.monotonic(), server.counters()["env_steps"])


def _log_record(server, sup, metrics: Metrics, m: dict) -> dict:
    """The per-log-tick summary both loops write."""
    counts = server.counters()
    return {
        "loss": float(m["loss"]),
        "q_mean": float(m["q_mean"]),
        "return_avg100": server.mean_recent_return(),
        "env_steps": counts["env_steps"],
        "replay_size": counts["replay_size"],
        "grad_steps_per_s": metrics.rate("grad_steps"),
        "actor_restarts": sup.restarts,
        "actor_kill_escalations": sup.kill_escalations,
        "actor_scale_terminations": sup.executor_terminations,
    }


def _finish_summary(summary: dict, server, sup, solver, replay,
                    fleet_rate: float, infer_server=None) -> dict:
    """The end-of-run keys both loops report (the reference's, the
    inference plane's when it is up), plus ``grad_steps`` and the fleet's
    ``env_steps_per_s`` (``fleet_rate``)."""
    summary["env_steps"] = server.counters()["env_steps"]
    summary["env_steps_per_s"] = fleet_rate
    summary["grad_steps"] = solver.step
    summary["actor_restarts"] = sup.restarts
    summary["actor_kill_escalations"] = sup.kill_escalations
    summary["actor_scale_terminations"] = sup.executor_terminations
    rpc = server.telemetry.robustness_counters()
    summary["rpc_dispatch_errors"] = rpc["dispatch_errors"]
    summary["rpc_duplicate_flushes"] = rpc["duplicate_flushes"]
    summary["rpc_shed_flushes"] = rpc["shed_flushes"]
    summary["rpc_checksum_errors"] = rpc["checksum_errors"]
    summary["snapshot_quarantined"] = rpc["snapshot_quarantined"]
    summary["flow_degraded_trips"] = server.flow_counters()["degraded_trips"]
    if infer_server is not None:
        itm = infer_server.telemetry_summary()
        summary["inference_requests"] = int(itm["inference/requests"])
        summary["inference_sheds"] = int(itm["inference/sheds"])
        summary["inference_compiled_buckets"] = int(
            itm["inference/compiled_buckets"])
        # the mode's whole point: actors pulled actions, not parameters
        # (get_params never fires once the plane is up)
        with server.telemetry._lock:
            summary["inference_param_pulls"] = int(
                server.telemetry.method_calls.get("get_params", 0))
    summary["solver"] = solver
    summary["replay"] = replay
    if solver.device.type == "cuda":
        torch.cuda.synchronize(solver.device)
    return summary


def train_distributed(cfg: Config, metrics: Metrics | None = None,
                      log_every: int = 500) -> dict:
    """Actor fleet over RPC → replay → learner on the device; returns the
    summary (and the solver and replay under ``"solver"`` and
    ``"replay"``).

    The learner samples and steps continuously once the buffer is ready;
    actors stream transitions and pull θ through the ``ReplayFeed``
    service. Total work: ``cfg.train.total_steps`` grad steps. The replay
    follows the env and the settings, as in the reference:

    - pixel env, ``replay.device_resident``, ``prioritized`` and
      ``device_per``: ``DevicePERFrameReplay`` on the fused stream, the
      server's replay lock held across each dispatch;
    - pixel env, ``device_resident`` otherwise: ``DeviceFrameReplay``,
      sample and dispatch under the lock, the write-back under it too;
    - pixel env, ``device_resident=false``: ``MultiStreamFrameReplay``
      (uniform only) through a ``DeviceStager``;
    - vector env: ``ReplayMemory`` (PER-wrapped when ``prioritized``)
      through a ``DeviceStager``;
    - ``net.kind=r2d2``: ``_train_distributed_recurrent``.

    Every replay is built with one stream per env row: ``num_actors``
    times ``actors.vector_envs`` when actors are vectorized. With
    ``inference.enabled`` the actors' greedy actions come from the
    inference plane on the solver's device (summary keys
    ``inference_*``).
    """
    check_distributed(cfg)
    if cfg.net.kind == "r2d2":
        return _train_distributed_recurrent(cfg, metrics, log_every)
    from distributed_deep_q_tpu_torch.profiling import StepTimer, TraceWindow
    from distributed_deep_q_tpu_torch.replay.device_per import (
        DevicePERFrameReplay)
    from distributed_deep_q_tpu_torch.replay.device_ring import (
        DeviceFrameReplay)
    from distributed_deep_q_tpu_torch.replay.multistream import (
        MultiStreamFrameReplay)
    from distributed_deep_q_tpu_torch.replay.prioritized import (
        make_writeback, maybe_prioritize)
    from distributed_deep_q_tpu_torch.replay.replay_memory import ReplayMemory
    from distributed_deep_q_tpu_torch.replay.staging import DeviceStager
    from distributed_deep_q_tpu_torch.solver import FusedStepStream, Solver
    from distributed_deep_q_tpu_torch.train import (
        log_final_eval, save_checkpoint)

    metrics = metrics or Metrics()
    tracing.configure_from(cfg.trace)  # learner-process tracer state
    health.configure_from(cfg.health)  # learner-process health plane
    probe = _probe_envs(cfg)
    cfg.net.num_actions = probe.num_actions
    obs_shape = probe.obs_shape
    pixel = probe.obs_dtype == np.uint8
    if int(cfg.actors.vector_envs) > 1 and not pixel:
        # fail HERE, not in the actor subprocess: VectorActing rejects
        # non-uint8 frames at construction, and a dead actor fleet
        # leaves the learner waiting on learn_start forever
        raise ValueError(
            "actors.vector_envs > 1 is the pixel acting path (uint8 "
            f"frames); env {cfg.env.kind}/{cfg.env.id} observes "
            f"{np.dtype(probe.obs_dtype).name} — use a pixel env or "
            "vector_envs=1")
    del probe

    # β anneal is denominated in sample() calls; this topology samples once
    # per grad step
    replay_cfg = dataclasses.replace(
        cfg.replay, priority_beta_steps=cfg.train.total_steps)
    solver = Solver(cfg, obs_dim=int(np.prod(obs_shape)))
    cfg, metrics, pc, _ = _split_fleet_across_processes(
        cfg, pixel, metrics, "device frame ring", fused_ok=True)
    batch_size = solver.local_batch
    # every stacked env row is its own replay stream (slot ownership and
    # flush_seq dedup key on it)
    streams = cfg.actors.num_actors * max(int(cfg.actors.vector_envs), 1)
    if pixel and cfg.replay.device_resident:
        cls = (DevicePERFrameReplay
               if cfg.replay.prioritized and cfg.replay.device_per
               else DeviceFrameReplay)
        replay = cls(replay_cfg, solver.device, obs_shape, cfg.env.stack,
                     cfg.train.gamma, seed=cfg.train.seed,
                     write_chunk=cfg.replay.write_chunk, num_streams=streams,
                     num_shards=solver.num_shards,
                     local_shards=solver.local_shards)
    elif pixel:
        if cfg.replay.prioritized:
            raise ValueError(
                "prioritized replay in the distributed pixel topology "
                "requires replay.device_resident=True (the host "
                "MultiStreamFrameReplay fallback is uniform-only)")
        replay = MultiStreamFrameReplay(
            cfg.replay.capacity, obs_shape, cfg.env.stack, cfg.replay.n_step,
            cfg.train.gamma, num_streams=streams, seed=cfg.train.seed)
    else:
        replay = maybe_prioritize(
            ReplayMemory(cfg.replay.capacity, obs_shape, np.float32,
                         seed=cfg.train.seed),
            replay_cfg, seed=cfg.train.seed)

    server, sup, infer_server = _bring_up_rpc_plane(
        cfg, replay, obs_dim=int(np.prod(obs_shape)), device=solver.device)
    _publish_weights(server, infer_server, solver.get_weights())

    fused_per = isinstance(replay, DevicePERFrameReplay)
    ring = isinstance(replay, DeviceFrameReplay) and not fused_per
    fleet_health, mfu_meter = _bring_up_health_plane(
        cfg, server, infer_server, solver=solver, replay=replay,
        fused=fused_per)
    autoscaler, scale_executor = _bring_up_autoscaler(cfg, sup, server)
    writeback = None
    if replay.prioritized and not fused_per:
        # with more than one process each writes back its own rows only
        writeback = make_writeback(replay, cfg.replay,
                                   lock=server.replay_lock,
                                   to_host=local_rows if pc > 1 else None)
    summary: dict = {}
    timer = StepTimer()
    trace = TraceWindow(cfg.train.profile_dir, cfg.train.profile_start_step,
                        cfg.train.profile_num_steps)
    ckpt = _restore(cfg, solver)
    if solver.step:
        _publish_weights(server, infer_server, solver.get_weights())
    stager = None
    try:
        # every process's shards warm: the AND is a collective, so the
        # polling processes go in lockstep and none steps alone
        first = _wait_for_fill(
            server, lambda: all_processes_ready(
                replay.ready(cfg.replay.learn_start)))
        if not (ring or fused_per) and pc == 1:
            # host-batch path: double-buffered sample → device pipeline;
            # shares the server's replay lock so the background sampler
            # serializes with RPC writers and the priority write-back.
            # More than one process samples synchronously, as the
            # reference does
            stager = DeviceStager(lambda: replay.sample(batch_size),
                                  device=solver.device, depth=2,
                                  lock=server.replay_lock)
        fused_stream = (FusedStepStream(solver, replay,
                                        cfg.replay.fused_chain,
                                        dispatch_lock=server.replay_lock,
                                        timer=timer)
                        if fused_per else None)
        # the learning-dynamics plane: one plane per fused chunk, folded at
        # log cadence; the learner joins the fleet verdict as a member
        learn_acc = None
        if cfg.train.learn_metrics and fused_per:
            learn_acc = learning.LearnAccumulator()
            learn_monitor = health.HealthMonitor(
                rules=health.default_learn_rules(),
                trends=health.default_learn_trends(), name="learner")
            fleet_health.register(
                "learner", learning.learn_scrape_fn(learn_acc, learn_monitor))
        for gstep in range(1, cfg.train.total_steps + 1):
            if fused_per:
                # the fused chunk flushes staged actor rows and dispatches
                # up to fused_chain grad steps; the lock serializes it
                # against the writers and the drain
                m = fused_stream.next(cfg.train.total_steps - gstep + 1)
            elif ring:
                # sample AND dispatch under the lock: the step's gather
                # must be enqueued before a writer can flush over its rows
                with server.replay_lock:
                    with timer.phase("sample"):
                        batch = replay.sample(batch_size)
                    sampled_at = batch.pop("_sampled_at")
                    with timer.phase("dispatch"):
                        m = solver.train_step_from_ring(
                            replay.ring, batch, replay.frame_shape)
            else:
                with timer.phase("sample"):  # wait on the pipeline
                    if stager is not None:
                        batch = stager.get()
                    else:
                        with server.replay_lock:
                            batch = replay.sample(batch_size)
                sampled_at = batch.pop("_sampled_at", replay.steps_added)
                if tracing.ENABLED and isinstance(batch.get("index"),
                                                  np.ndarray):
                    # lineage lookup at consumption: env-step birth →
                    # this gradient step = time_to_learn
                    ages = server.lineage_ages(batch["index"])
                    if ages.size:
                        metrics.observe_many("learner/time_to_learn_ms",
                                             ages * 1e3)
                with timer.phase("dispatch"):
                    m = solver.train_step(batch)
            metrics.count("grad_steps")
            # the flow controller's consumption EWMA: credits granted to
            # actors track what the learner actually drains per step
            server.note_consumed(batch_size)
            timer.step_done()
            trace.on_step(gstep)

            if writeback is not None:
                # pipelined write-back: the |TD| fetch never blocks the
                # step, and the update itself takes the replay lock
                writeback.push(m["index"], m["td_abs"], sampled_at)

            if gstep % cfg.actors.param_sync_period == 0:
                t0 = time.perf_counter()
                _publish_weights(server, infer_server, solver.get_weights())
                metrics.observe("learner/publish_params_ms",
                                1e3 * (time.perf_counter() - t0))

            if ckpt and gstep % cfg.train.checkpoint_every == 0:
                save_checkpoint(cfg, ckpt, solver,
                                server.counters()["env_steps"])
                if cfg.train.server_snapshot_path:
                    server.snapshot_async(cfg.train.server_snapshot_path)

            if gstep % log_every == 0:
                timer.measure_device(m["loss"])
                summary = _log_record(server, sup, metrics, m)
                infer_tm = (infer_server.telemetry_summary()
                            if infer_server is not None else {})
                if learn_acc is not None:
                    learning.publish_planes(
                        learn_acc, fused_stream.drain_planes(), metrics)
                hk = _health_tick(
                    fleet_health, mfu_meter, server, gstep,
                    scrape=(gstep // log_every)
                    % max(cfg.health.scrape_every, 1) == 0,
                    autoscaler=autoscaler, executor=scale_executor)
                metrics.log(gstep, **summary, **timer.summary(),
                            **server.telemetry_summary(), **infer_tm,
                            **metrics.telemetry(), **hk,
                            **solver.dispatch_counters())
        fleet_rate = _fleet_rate(server, first)
    finally:
        trace.close()
        if stager is not None:
            stager.close()
        _tear_down_rpc_plane(cfg, server, sup, infer_server)
        if tracing.ENABLED:
            tracing.export()  # learner-process shard (actors wrote theirs)

    summary["final_return_avg100"] = server.mean_recent_return()
    if writeback:
        writeback.drain()
    log_final_eval(solver, cfg, metrics, summary)
    return _finish_summary(summary, server, sup, solver, replay, fleet_rate,
                           infer_server)


def _train_distributed_recurrent(cfg: Config, metrics: Metrics | None = None,
                                 log_every: int = 500) -> dict:
    """Distributed R2D2: recurrent actors over RPC → sequence replay →
    sequence learner on the device.

    Actors run the full recurrent policy (LSTM carry threaded through the
    episode) and ship whole sequences with their stored start carry. Pixel
    envs with ``replay.device_resident`` keep sequences in a
    ``DeviceSequenceReplay``: the ring step samples and dispatches under
    the server's replay lock, or, with ``device_per`` and ``prioritized``,
    the chained fused dispatch holds it across each dispatch. Otherwise a
    host ``SequenceReplay`` is sampled under the lock and its batch
    shipped. Capacity and learn_start count transitions and are divided by
    ``sequence_length``, as in the reference.
    """
    from distributed_deep_q_tpu_torch.parallel.sequence_learner import (
        SequenceSolver)
    from distributed_deep_q_tpu_torch.profiling import StepTimer
    from distributed_deep_q_tpu_torch.replay.device_sequence import (
        DeviceSequenceReplay)
    from distributed_deep_q_tpu_torch.replay.prioritized import make_writeback
    from distributed_deep_q_tpu_torch.replay.sequence import SequenceReplay
    from distributed_deep_q_tpu_torch.solver import FusedStepStream
    from distributed_deep_q_tpu_torch.train import (
        log_final_eval, save_checkpoint)

    metrics = metrics or Metrics()
    tracing.configure_from(cfg.trace)  # learner-process tracer state
    health.configure_from(cfg.health)  # learner-process health plane
    probe = _probe_envs(cfg)
    cfg.net.num_actions = probe.num_actions
    pixel = probe.obs_dtype == np.uint8
    obs_shape = (tuple(probe.obs_shape) + (cfg.env.stack,)) if pixel \
        else tuple(probe.obs_shape)
    obs_dtype = np.uint8 if pixel else np.float32
    obs_dim = int(np.prod(probe.obs_shape))
    del probe

    solver = SequenceSolver(cfg, obs_dim=obs_dim)
    cfg, metrics, pc, _ = _split_fleet_across_processes(
        cfg, pixel, metrics, "device sequence ring", fused_ok=True)
    batch_size = solver.local_batch
    seq_len = cfg.replay.sequence_length
    seq_capacity = max(cfg.replay.capacity // seq_len, 64)
    per = dict(prioritized=cfg.replay.prioritized,
               alpha=cfg.replay.priority_alpha,
               beta0=cfg.replay.priority_beta0,
               beta_steps=cfg.train.total_steps, eps=cfg.replay.priority_eps,
               seed=cfg.train.seed, use_native=cfg.replay.use_native)
    device_seq = pixel and cfg.replay.device_resident
    if device_seq:
        replay = DeviceSequenceReplay(seq_capacity, seq_len, obs_shape,
                                      solver.device, cfg.net.lstm_size,
                                      num_shards=solver.num_shards,
                                      local_shards=solver.local_shards,
                                      **per)
    else:
        replay = SequenceReplay(seq_capacity, seq_len, obs_shape, obs_dtype,
                                cfg.net.lstm_size, **per)
    learn_start_seqs = max(cfg.replay.learn_start // seq_len, 2)

    # no inference plane: recurrent actors carry per-episode LSTM state
    # that cannot be microbatched across actors (BatchedPolicy refuses it)
    server, sup, _ = _bring_up_rpc_plane(cfg, replay)
    _publish_weights(server, None, solver.get_weights())
    ckpt = _restore(cfg, solver)
    if solver.step:
        _publish_weights(server, None, solver.get_weights())

    # the chained fused path samples from the device priority row, so it
    # runs prioritized only
    fused_seq = (device_seq and cfg.replay.device_per
                 and cfg.replay.prioritized)
    # no FLOPs count on the sequence program: live MFU is absent here;
    # steps/s + ingest utilization still emit
    fleet_health, mfu_meter = _bring_up_health_plane(cfg, server)
    autoscaler, scale_executor = _bring_up_autoscaler(cfg, sup, server)
    writeback = None
    if replay.prioritized and not fused_seq:
        writeback = make_writeback(replay, cfg.replay,
                                   lock=server.replay_lock,
                                   to_host=local_rows if pc > 1 else None)
    summary: dict = {}
    timer = StepTimer()
    try:
        # the collective learn gate (see train_distributed)
        first = _wait_for_fill(server, lambda: all_processes_ready(
            replay.ready(learn_start_seqs)))
        fused_stream = (FusedStepStream(solver, replay,
                                        cfg.replay.fused_chain,
                                        dispatch_lock=server.replay_lock,
                                        timer=timer)
                        if fused_seq else None)
        for gstep in range(1, cfg.train.total_steps + 1):
            if fused_seq:
                m = fused_stream.next(cfg.train.total_steps - gstep + 1)
            elif device_seq:
                # sample AND dispatch under the lock: the gather must be
                # enqueued before a writer can flush over its slots
                with server.replay_lock:
                    with timer.phase("sample"):
                        batch = replay.sample(batch_size)
                    sampled_at = batch.pop("_sampled_at")
                    with timer.phase("dispatch"):
                        m = solver.train_step_from_ring(replay, batch)
            else:
                with server.replay_lock:
                    with timer.phase("sample"):
                        batch = replay.sample(batch_size)
                    sampled_at = batch.pop("_sampled_at")
                if tracing.ENABLED and isinstance(batch.get("index"),
                                                  np.ndarray):
                    ages = server.lineage_ages(batch["index"])
                    if ages.size:
                        metrics.observe_many("learner/time_to_learn_ms",
                                             ages * 1e3)
                with timer.phase("dispatch"):
                    m = solver.train_step(batch)
            metrics.count("grad_steps")
            # consumption is denominated in env transitions (what actors
            # flush), so a sequence batch counts batch × sequence_length
            server.note_consumed(batch_size * seq_len)
            timer.step_done()

            if writeback is not None:
                writeback.push(m["index"], m["td_abs"], sampled_at)

            if gstep % cfg.actors.param_sync_period == 0:
                t0 = time.perf_counter()
                _publish_weights(server, None, solver.get_weights())
                metrics.observe("learner/publish_params_ms",
                                1e3 * (time.perf_counter() - t0))
            if ckpt and gstep % cfg.train.checkpoint_every == 0:
                save_checkpoint(cfg, ckpt, solver,
                                server.counters()["env_steps"])
                if cfg.train.server_snapshot_path:
                    server.snapshot_async(cfg.train.server_snapshot_path)
            if gstep % log_every == 0:
                timer.measure_device(m["loss"])
                summary = _log_record(server, sup, metrics, m)
                hk = _health_tick(
                    fleet_health, mfu_meter, server, gstep,
                    scrape=(gstep // log_every)
                    % max(cfg.health.scrape_every, 1) == 0,
                    autoscaler=autoscaler, executor=scale_executor)
                metrics.log(gstep, **summary, **timer.summary(),
                            **server.telemetry_summary(),
                            **metrics.telemetry(), **hk,
                            **solver.dispatch_counters())
        fleet_rate = _fleet_rate(server, first)
    finally:
        _tear_down_rpc_plane(cfg, server, sup)
        if tracing.ENABLED:
            tracing.export()  # learner-process shard (actors wrote theirs)

    summary["final_return_avg100"] = server.mean_recent_return()
    if writeback:
        writeback.drain()
    log_final_eval(solver, cfg, metrics, summary, recurrent=True)
    return _finish_summary(summary, server, sup, solver, replay, fleet_rate)
