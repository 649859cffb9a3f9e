"""Single dataclass-tree config system (PyTorch/CUDA port).

A copy of ``distributed_deep_q_tpu/config.py``: the same dataclass tree, the
same presets and the same ``--set path=value`` bridge, so one command line
configures either package. Network topology is code (``nn.Module``s selected
by ``NetConfig.kind``). The one change is the ``--backend`` switch, which
takes ``cuda|cpu`` (default ``cuda``): the port runs on an NVIDIA card unless
the caller asks for the CPU, and asking for ``cuda`` without a card raises.

The field comments describe what each field does in the reference. The port
honours the fields its slice runs. It refuses settings outside the slice
with ``NotImplementedError`` (``train.check_slice``, ``Solver``,
``Learner``). Two fields change only XLA's op schedule, not the function:
``stack_forwards`` and ``fuse_double_forward``. The port computes the same
function one net at a time whatever they say.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass, field
from typing import Any


@dataclass
class NetConfig:
    """Q-network topology. Replaces the reference's ``models/*.prototxt``."""

    kind: str = "mlp"  # mlp | nature_cnn | r2d2
    num_actions: int = 2
    # mlp
    hidden: tuple[int, ...] = (64, 64)
    # nature_cnn / r2d2 torso input: (H, W, stack)
    frame_shape: tuple[int, int] = (84, 84)
    stack: int = 4
    dueling: bool = False
    # r2d2
    lstm_size: int = 512
    torso: str = "nature_cnn"  # r2d2 feature torso: nature_cnn | mlp
    # compute dtype for the torso ("bfloat16" feeds the tensor cores;
    # params stay float32)
    compute_dtype: str = "float32"


@dataclass
class ReplayConfig:
    capacity: int = 100_000
    batch_size: int = 64
    prioritized: bool = False
    priority_alpha: float = 0.6
    priority_beta0: float = 0.4
    priority_beta_steps: int = 1_000_000
    priority_eps: float = 1e-6
    # PER write-back runs this many grad steps behind the learner so the
    # per-sample |TD| D2H fetch (async-copied at dispatch) never blocks the
    # step — see replay.prioritized.DelayedPriorityWriteback
    priority_writeback_delay: int = 8
    # fully device-resident PER: priorities + metadata live in HBM and
    # sampling/priority-update fuse into the train step (zero host round
    # trips — replay/device_per.py); needs device_resident + prioritized
    device_per: bool = False
    # grad steps chained per fused-PER dispatch (lax.scan inside the two
    # XLA programs): dispatch + host bookkeeping amortize over the chunk;
    # sampling within a chunk sees chunk-start priorities (staleness ≤
    # fused_chain steps — same bound as priority_writeback_delay on the
    # host path). Applies where grad steps run back-to-back (the
    # decoupled distributed learner, benches); the in-process loop chains
    # at most grad_steps_per_train to keep its env/learn cadence
    fused_chain: int = 8
    n_step: int = 1
    # minimum fill before learning starts
    learn_start: int = 1_000
    # pixel envs: keep the frame ring in device HBM and gather stacks inside
    # the jitted step (replay/device_ring.py) instead of shipping pixel
    # minibatches host→device every step
    device_resident: bool = True
    # frames staged per shard per HBM write (device-resident mode)
    write_chunk: int = 64
    # sequence replay (R2D2)
    sequence_length: int = 80
    burn_in: int = 40
    use_native: bool = True  # use the C++ replay core when available
    # columnar ingest staging: staged rows land in per-shard
    # per-column preallocated buffers (one memcpy per column per staged
    # segment — replay/columnar.py) instead of the legacy per-flush FIFO
    # of array tuples. False selects the legacy reference path, kept
    # bit-identical for the staged≡legacy equivalence tests
    staging_columnar: bool = True
    # initial per-shard staging-buffer depth in rows (grows by doubling;
    # occupancy is bounded in practice by staged_high_watermark)
    staging_depth: int = 4096
    # background staging→device drain thread (replay.start_drain): the
    # server/bench attach it so writers never pay the device dispatch.
    # Ignored on multi-host meshes (flushes are lockstep collectives)
    ingest_drain: bool = True
    # rows staged before the drain thread dispatches a batched flush
    # (0 = write_chunk)
    drain_min_rows: int = 0
    # optional replay persistence (SURVEY §5.4): when set, the buffer's
    # complete sampling state (rings, cursors, trees, RNG) is dumped to
    # this .npz alongside learner checkpoints and restored on
    # train.resume. Default empty = warm-refill, matching the reference
    persist_path: str = ""
    # overload plane (rpc/flowcontrol.py): staged-but-unflushed rows the
    # server tolerates before flushes are shed / the watchdog trips
    # degraded mode. Watermark rows are replay rows, not bytes
    staged_high_watermark: int = 8192
    # which flushes the admission controller sheds under overload:
    # "fair" sheds actors over their fair share of the fleet ingest rate
    # first, "all" sheds every flush while over the watermark, "none"
    # disables shedding (credits still throttle)
    shed_policy: str = "fair"
    # learner-process RSS bound for the flowcontrol watchdog (0 = RSS
    # tripwire disabled; staged-depth tripwire is always on)
    rss_high_watermark_mb: int = 0


@dataclass
class TrainConfig:
    lr: float = 1e-4
    optimizer: str = "adam"  # adam | rmsprop (reference PS used RMSProp/AdaGrad [P])
    adam_eps: float = 1.5e-4  # DQN-Atari convention; 1e-8 for classic control
    gamma: float = 0.99
    target_update_period: int = 500  # "every C pulls: θ⁻ ← θ" (SURVEY §3.1 [M])
    # Polyak soft target updates: θ⁻ ← τθ + (1−τ)θ⁻ every step when τ > 0
    # (overrides the hard period copy; the stable choice for small nets)
    target_tau: float = 0.0
    double_dqn: bool = False
    huber_delta: float = 1.0
    # R2D2 sequence path: invertible value rescaling h(x) on targets, and
    # the η mixing of max/mean |TD| for per-sequence priorities
    value_rescale: bool = True
    priority_eta: float = 0.9
    grad_clip_norm: float = 10.0
    total_steps: int = 50_000
    # env steps between learn phases when running single-process, and grad
    # steps per learn phase — the reference worker's "actor phase: k steps /
    # learn phase: j minibatches" cadence (SURVEY §3.1 [M])
    train_every: int = 4
    grad_steps_per_train: int = 1
    eval_every: int = 0  # 0 = no periodic eval
    eval_episodes: int = 5
    # with periodic eval on: keep the best-eval params and restore them at
    # the end of training if the final params score worse (EvalCallback-
    # style model selection; DQN end-of-run policies oscillate)
    keep_best_eval: bool = False
    seed: int = 0
    # the fused TD loss: hand-written CUDA kernels for its forward and
    # backward (ops/fused_loss.py) instead of the plain tensor loss
    use_pallas_loss: bool = False
    # batch the online net's s and s' forwards into ONE conv application
    # (Double-DQN only): halves per-step weight reads and doubles conv
    # batch (MXU utilization) at the cost of saving s' activations for
    # the (zero-cotangent) backward — wins when the step is weight-read
    # bound (small batch), loses nothing measurable at large batch
    fuse_double_forward: bool = False
    # stack θ and θ⁻ on a leading axis and run ALL the step's Q-forwards
    # (θ(s), θ(s') for Double-DQN, θ⁻(s')) as ONE vmapped application —
    # the conv/dense chain count collapses to a single forward's worth
    # (the small-batch step is op-count-bound). "auto" turns
    # it on when the per-shard batch is ≤ 128 — at large batch the step
    # is HBM/flop-bound and the extra θ⁻(s) quarter stops being free.
    # Supersedes fuse_double_forward when active.
    stack_forwards: str = "auto"  # auto | on | off
    # store Adam's first moment in bfloat16 (optax mu_dtype): trims
    # optimizer-state HBM traffic on the HBM-bound small-batch step
    adam_mu_dtype: str = "float32"  # float32 | bfloat16
    # learning-dynamics plane (reference learning.py): accumulate loss /
    # TD-histogram / grad-norm / Q / PER-sampling statistics INSIDE the
    # fused-chain and Anakin scan bodies, returned as one flat plane per
    # dispatch. Static trace-time gate: False compiles the exact pre-PR
    # programs (bitwise math, unchanged op budgets); True pays the small
    # documented budget delta and still zero host-comm ops
    learn_metrics: bool = False
    checkpoint_dir: str = ""
    checkpoint_every: int = 0  # grad steps between checkpoints
    resume: bool = False       # restore newest snapshot before training
    # learner-restart survival (distributed topology): when set, the
    # ReplayFeed server binds actors.port (stable across restarts),
    # snapshots replay + counters + the θ frame here (at checkpoint
    # cadence and on exit), and warm-boots from it — a restarted learner
    # resumes with its replay intact while actors simply reconnect
    server_snapshot_path: str = ""
    # generational snapshot retention: server_snapshot_path holds the
    # newest N checksummed generations; restore walks newest→oldest past
    # any torn/corrupt one (quarantined, not fatal)
    snapshot_keep: int = 3
    # profiling (SURVEY §5.1): a torch.profiler trace of a step window
    # (profiling.TraceWindow); the live profiler server port (0 = off) is
    # the reference's jax.profiler server, which torch has no counterpart
    # of: the port refuses it
    profile_dir: str = ""
    profile_start_step: int = 100
    profile_num_steps: int = 20
    profile_port: int = 0


@dataclass
class EnvConfig:
    id: str = "CartPole-v1"
    kind: str = "gym"  # gym | atari | fake_atari | signal_atari
    # multi-game fleets (config 4 "Atari-57 8-game subset"): when non-empty,
    # actor i plays games[i % len(games)] (env_for_actor) and eval reports
    # per-game returns. All games must expose the same action count — for
    # ALE use full_action_space=True (the 18-action set) as Ape-X does.
    games: tuple[str, ...] = ()
    full_action_space: bool = False
    frame_skip: int = 4
    frame_shape: tuple[int, int] = (84, 84)
    stack: int = 4
    reward_clip: float = 1.0  # 0 disables; Atari clips to ±1 [P]
    terminal_on_life_loss: bool = True
    max_episode_steps: int = 27_000  # 108k frames / skip 4, standard Atari cap
    noop_max: int = 30


@dataclass
class ActorConfig:
    num_actors: int = 1
    # multi-host fleets (config 5 full shape): each learner process runs
    # its own supervisor over a slice of the fleet. Local actor ids stay
    # 0..k-1 (they double as per-host replay stream ids); the offset and
    # global fleet size give every actor its GLOBAL identity for the ε
    # ladder and env seeding, so host slices cover different ladder
    # segments instead of repeating the same one
    actor_id_offset: int = 0
    fleet_size: int = 0  # 0 = num_actors (single-host)
    # actor→host placement for multi-host fleets (actors/assignment.py):
    # "contiguous" slices the gid range per process (the historical
    # layout); "hash" walks a bounded-load consistent-hash ring, so a
    # restarting actor keeps its host, host join/leave remaps only
    # ~fleet/hosts actors, and a host address change is just a reconnect
    assignment: str = "contiguous"
    # Sebulba-style vectorized acting (actors/vector.py): >1 makes each
    # actor PROCESS drive this many stacked env copies behind one
    # batched step — V global actor identities (ε ladder slots, env
    # seeds, replay streams) per process, one infer RPC per wall tick.
    # 0/1 = the historical one-env-per-process loop. Replay stream ids
    # become process_id*V + row, so device replays must be built with
    # num_streams = num_actors * V (train_distributed does this).
    vector_envs: int = 0
    # explicit local→global actor id map, filled in by the supervisor's
    # fleet split under assignment="hash" (local slot i plays global
    # actor actor_gids[i]). Empty = derive gid as actor_id + offset
    actor_gids: tuple[int, ...] = ()
    # Anakin mode (parallel/anakin.py): >0 runs acting INSIDE the jitted
    # learner program — this many jax envs (ops/jax_envs.py, must divide
    # over the dp mesh; 0 = mode off) co-resident with training, one
    # device sub-ring per env, zero steady-state host transfers. An
    # explicit opt-in, not inferred: only the signal_atari family has a
    # JAX-expressible step
    anakin_envs: int = 0
    # env ticks per Anakin superstep (must stay ≤ the ring's slot_cap so
    # one insert never wraps a sub-ring — the same single-flush-chunk
    # invariant the host write path keeps)
    anakin_ticks: int = 16
    # Ape-X ε ladder: actor i uses ε = base ** (1 + i/(N-1) * alpha) [T]
    eps_base: float = 0.4
    eps_alpha: float = 7.0
    # single-actor annealed schedule (Nature-DQN style)
    eps_start: float = 1.0
    eps_end: float = 0.05
    eps_decay_steps: int = 10_000
    eval_eps: float = 0.05
    # pull fresh θ from the learner every this many env steps (SURVEY §5.8);
    # each actor offsets its pull schedule by a stable random phase so a
    # 256-actor fleet doesn't stampede the learner host in lockstep
    param_sync_period: int = 400
    # wall-clock seconds between explicit liveness heartbeats (0 disables).
    # Liveness must not be inferred from data traffic alone: a healthy
    # actor in a slow env can legitimately go > heartbeat_timeout without
    # filling a send_batch
    heartbeat_period: float = 5.0
    # the beat stops once the env loop has made no progress for this many
    # wall-clock seconds, so a PERMANENTLY wedged env still trips the
    # supervisor's heartbeat_timeout and gets respawned — this budget is
    # the line between "slow step, keep alive" and "hung, replace"
    env_stall_budget: float = 300.0
    # transitions per RPC AddTransitions message
    send_batch: int = 64
    # RPC fault tolerance (rpc/resilience.py): exponential backoff between
    # retried calls, capped per attempt, giving up after the deadline.
    # Flushes are idempotent (flush_seq dedup on the server), so a retry
    # after an ambiguous failure can never double-insert into replay
    rpc_retry_base: float = 0.05
    rpc_retry_max: float = 2.0
    rpc_retry_deadline: float = 120.0
    # per-call socket timeout on the actor-side stub: a stalled server
    # surfaces as a retryable TimeoutError instead of hanging the actor
    rpc_call_timeout: float = 30.0
    # staleness guard: an actor whose pulled θ version trails the
    # published version by more than this many publishes blocks on a
    # fresh pull before acting (0 disables). The published version rides
    # back on every add_transitions reply, so the check is free
    max_param_lag: int = 10
    # credit-based backpressure floor: the server never grants an actor
    # fewer than this many rows/second while healthy, so a throttled
    # fleet keeps trickling instead of livelocking
    flush_credit_floor: int = 64
    # chaos injection spec for the whole fleet (rpc/faultinject.py), e.g.
    # "drop=0.02,delay=0.05:40,corrupt=0.01,seed=7"; propagated to actor
    # processes via the DDQ_CHAOS env var. Empty = no faults
    chaos: str = ""
    # replay-feed service address
    host: str = "127.0.0.1"
    port: int = 6379


@dataclass
class MeshConfig:
    """Device / backend selection — the ``--backend`` switch.

    ``backend='cuda'`` runs on CUDA device 0 and raises when there is no
    card; ``backend='cpu'`` runs on the host (the tests' backend). The port
    runs in one process on one device: the mesh fields below are kept so a
    reference command line parses, and anything but one shard is refused.
    """

    backend: str = "cuda"  # cuda | cpu
    num_fake_devices: int = 8  # reference CPU-mesh field; unused here
    dp: int = 0  # shards on the data-parallel axis; the port runs exactly 1
    model: int = 1  # model-parallel axis; the port runs exactly 1
    # multi-process learner: not ported yet (the port refuses
    # num_processes > 1)
    coordinator: str = ""       # e.g. "10.0.0.1:8476"
    num_processes: int = 1
    process_id: int = 0


@dataclass
class TraceConfig:
    """Distributed tracing plane (``tracing.py``).

    Off by default; when off the tracer costs a single module-flag branch
    per instrumented site. Context piggybacks on existing wire frames as
    ``tr_*`` keys (no wire version bump), so a traced learner and
    untraced actors — or the reverse — interoperate freely.
    """

    enabled: bool = False
    # fraction of per-env-step hot-path cycles that record a span
    # (counter-based, deterministic: every round(1/rate)-th step)
    sample_rate: float = 0.01
    # fraction of flushes carrying per-row lineage birth stamps — the
    # input to the learner's time_to_learn histogram
    lineage_rate: float = 0.05
    # per-thread span ring capacity (drop-oldest beyond this)
    buffer_spans: int = 8192
    # shard export directory; each process writes trace-<pid>.json here
    dir: str = "traces"


@dataclass
class HealthConfig:
    """Health plane (``health.py``).

    Off by default; when off every monitor entry point is a single
    module-flag branch returning preallocated constants. When on, each
    server samples its own telemetry into fixed-capacity rings and the
    supervisor aggregates every member's ``health`` RPC verdict into
    one fleet ``HealthVerdict`` logged as ``health/verdict``.
    """

    enabled: bool = False
    # fixed capacity of each per-key time-series ring (drop-oldest)
    ring_capacity: int = 512
    # multi-window burn-rate alerting: a rule fires only when BOTH
    # windows have burned their budget; it clears (hysteresis) when the
    # fast window cools below clear_ratio. Per-rule overrides win.
    fast_window_s: float = 30.0
    slow_window_s: float = 300.0
    clear_ratio: float = 0.5
    # supervisor fleet-scrape cadence (log ticks between scrapes; the
    # scrape itself is one in-process call + one RPC per remote member)
    scrape_every: int = 1


@dataclass
class AutoscaleConfig:
    """Health-driven autoscaler (``actors/autoscaler.py``).

    Off by default (and inert unless the health plane is on — its only
    input is the fleet ``HealthVerdict``). When enabled, the supervisor
    folds each scraped verdict through the autoscaler on the health
    tick; decisions land in the run JSONL under ``autoscale/decision``
    with the triggering rule and burn numbers, and the targets are
    exported as ``autoscale/target_*`` gauges. With ``execute`` on, a
    supervisor-side ``ScaleExecutor`` (``actors/executor.py``) closes
    the loop: actor-dimension decisions actually start/stop actor
    processes — rate-limited, dry-run-able, rolled back when a spawned
    actor misses its grace window — and every applied action lands in
    the JSONL under ``autoscale/applied`` with the decision's rule for
    lineage (``telemetry_report --strict`` audits applied vs target).
    """

    enabled: bool = False
    # actor-capacity band; max_actors=0 = the boot fleet size
    min_actors: int = 1
    max_actors: int = 0
    # inference-capacity band (replicas of the batched-inference plane)
    min_inference: int = 0
    max_inference: int = 0
    # capacity change per decision
    step: int = 1
    # per-dimension cooldown between decisions (anti-flap damper)
    cooldown_s: float = 30.0
    # consecutive ok verdicts required before growing back (hysteresis)
    recover_ticks: int = 3
    # executor: act on actor-dimension decisions. dry_run
    # logs what WOULD happen without touching processes
    execute: bool = False
    dry_run: bool = False
    # floor between applied actions (on top of the decision cooldown)
    rate_limit_s: float = 5.0
    # graceful retirement: wait this long for the actor's in-flight
    # flush to drain before terminating it
    drain_s: float = 5.0
    # a grown actor must heartbeat within this window or the grow is
    # rolled back (the process reaped, the slot released)
    spawn_grace_s: float = 20.0


@dataclass
class InferenceConfig:
    """Batched inference plane (``rpc/inference_server.py``).

    When enabled, the learner hosts an ``InferenceServer`` next to the
    replay feed and actors ship OBSERVATIONS instead of pulling θ: the
    server queues per-actor requests, cuts microbatches under the
    deadline-aware SLO below, and answers with argmax actions + Q-values
    from ONE device-resident forward. ε-greedy stays client-side
    (seeded, per-actor ε) so exploration is bitwise reproducible either
    way. Param pulls drop to zero in steady state and actor staleness
    is eliminated by construction — the forward always uses the θ the
    learner last pushed.
    """

    enabled: bool = False
    # service address; port 0 = ephemeral (the supervisor rewrites the
    # pickled cfg with the bound port before spawning actors). Snapshot
    # runs that need a stable address set it explicitly
    host: str = "127.0.0.1"
    port: int = 0
    # microbatch SLO: close a batch at max_batch rows OR cutoff_us after
    # its first request, whichever comes first — the deadline bounds the
    # tail latency a lone actor pays for batching
    max_batch: int = 256
    cutoff_us: int = 2000
    # compiled batch buckets: each forward pads to the smallest bucket
    # that fits, so XLA compiles at most len(buckets) programs (≤ 4 per
    # the acceptance bound) instead of one per observed batch size
    buckets: tuple = (8, 32, 128, 256)
    # admission (reuses rpc/flowcontrol.py): queued rows beyond this shed
    # new requests with an explicit retry_after_ms reply
    queue_high_watermark: int = 4096
    # reply-latency SLO for bench/chaos verdicts (not enforced inline)
    slo_ms: float = 50.0
    # multi-tenant serving: extra tenant tags registered at
    # boot ("ab:<name>" arms join the actor-hash split once θ installs;
    # "shadow:<name>" tenants mirror primary traffic, replies never
    # reach actors). The primary always exists and needs no entry
    tenants: tuple = ()
    # degrade ladder: tenant classes shed in strict order (shadow → A/B
    # → primary) when queue occupancy SUSTAINS above these fractions of
    # queue_high_watermark for ladder_burn_s; the primary only ever
    # sheds through its own controller at the full watermark
    shed_shadow_frac: float = 0.5
    shed_ab_frac: float = 0.75
    ladder_burn_s: float = 1.0


@dataclass
class Config:
    net: NetConfig = field(default_factory=NetConfig)
    replay: ReplayConfig = field(default_factory=ReplayConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    env: EnvConfig = field(default_factory=EnvConfig)
    actors: ActorConfig = field(default_factory=ActorConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    trace: TraceConfig = field(default_factory=TraceConfig)
    inference: InferenceConfig = field(default_factory=InferenceConfig)
    health: HealthConfig = field(default_factory=HealthConfig)
    autoscale: AutoscaleConfig = field(default_factory=AutoscaleConfig)

    def replace(self, **kv: Any) -> "Config":
        return dataclasses.replace(self, **kv)


# ---------------------------------------------------------------------------
# Presets mirroring BASELINE.json ``configs`` [M]
# ---------------------------------------------------------------------------


def cartpole_config() -> Config:
    """Config 1: CartPole-v1, MLP Q-net, single worker, uniform replay.

    Recipe selected empirically (scripts/diag_cartpole.py sweeps): Double
    DQN + dueling + 3-step returns + Polyak targets (τ=0.005) converges
    monotonically to 500/500 within 30k steps. Atari-style settings (hard
    target copies, 1-step) plateau at ~120 from max-bias overestimation —
    not a numerics bug (scripts/diag_mdp.py recovers analytic Q* exactly,
    and a faithful torch replica of the published community recipe plateaus
    identically in this environment). ``keep_best_eval`` guards the tail
    against late policy oscillation; eval is greedy.
    """
    c = Config()
    c.net = NetConfig(kind="mlp", num_actions=2, hidden=(128, 128),
                      dueling=True)
    c.replay = ReplayConfig(capacity=100_000, batch_size=128,
                            learn_start=1_000, n_step=3)
    c.train = TrainConfig(
        lr=5e-4, adam_eps=1e-8, gamma=0.99, target_tau=0.005,
        double_dqn=True, total_steps=30_000, train_every=1,
        grad_clip_norm=10.0, eval_every=2_500, keep_best_eval=True,
    )
    c.env = EnvConfig(id="CartPole-v1", kind="gym", stack=1, reward_clip=0.0)
    c.actors = ActorConfig(num_actors=1, eps_decay_steps=8_000, eps_end=0.04,
                           eval_eps=0.0)
    return c


def pong_config() -> Config:
    """Config 2: Atari Pong, Nature-DQN CNN, 4 actors + 1 learner, uniform.

    Uniform sampling runs through the FUSED device sampler with α=0:
    constant priorities make the inverse-CDF draw uniform within each
    shard, and the stratified-IS weights stay within a few percent of 1
    (exactly 1 once shard fills equalize — they correct for unequal
    per-shard sampleable mass, which plain weight=1 uniform ignores).
    Sampling/composition stay on device (no per-step host sum-tree/index
    work).
    """
    c = Config()
    c.net = NetConfig(kind="nature_cnn", num_actions=6, compute_dtype="bfloat16")
    c.replay = ReplayConfig(capacity=1_000_000, batch_size=512,
                            learn_start=20_000, prioritized=True,
                            priority_alpha=0.0, device_per=True)
    c.train = TrainConfig(lr=6.25e-5, target_update_period=2_500, total_steps=2_000_000)
    c.env = EnvConfig(id="PongNoFrameskip-v4", kind="atari")
    c.actors = ActorConfig(num_actors=4)
    return c


def breakout_config() -> Config:
    """Config 3: Atari Breakout, Double-DQN + prioritized replay, 16 actors."""
    c = pong_config()
    c.net = dataclasses.replace(c.net, num_actions=4)
    c.replay = dataclasses.replace(
        c.replay, prioritized=True, n_step=3, batch_size=512,
        # real PER here: pong's α=0 (fused-uniform) must not leak through
        priority_alpha=0.6,
        # fused device-PER is the production prioritized path
        # (replay/device_per.py); host sum-tree remains the fallback
        device_per=True,
        # β anneals per sample() (= per grad step): reach β=1 by end of
        # training (total_steps env steps / train_every)
        priority_beta_steps=c.train.total_steps // c.train.train_every)
    c.train = dataclasses.replace(c.train, double_dqn=True)
    c.env = dataclasses.replace(c.env, id="BreakoutNoFrameskip-v4")
    c.actors = dataclasses.replace(c.actors, num_actors=16)
    return c


def apex_config() -> Config:
    """Config 4: Ape-X style — 256 CPU actors, prioritized n-step, dueling,
    8-game Atari-57 subset round-robined across the fleet (full 18-action
    space so one Q-head serves every game)."""
    c = breakout_config()
    c.net = dataclasses.replace(c.net, dueling=True, num_actions=18)
    c.actors = dataclasses.replace(c.actors, num_actors=256)
    c.env = dataclasses.replace(
        c.env, full_action_space=True,
        games=("BreakoutNoFrameskip-v4", "PongNoFrameskip-v4",
               "BeamRiderNoFrameskip-v4", "EnduroNoFrameskip-v4",
               "QbertNoFrameskip-v4", "SeaquestNoFrameskip-v4",
               "SpaceInvadersNoFrameskip-v4", "AsterixNoFrameskip-v4"))
    return c


def r2d2_config() -> Config:
    """Config 5 (stretch): R2D2 recurrent Q-net, sequence replay.
    Single-game (drops apex's multi-game round-robin): the config-5 bar is
    the recurrent pipeline at scale, not Atari-57 coverage."""
    c = apex_config()
    c.net = dataclasses.replace(c.net, kind="r2d2", lstm_size=512)
    c.replay = dataclasses.replace(
        c.replay, sequence_length=80, burn_in=40, batch_size=64,
        # sequence replay prioritizes whole sequences on the host; the
        # fused transition-level device-PER path does not apply here
        device_per=False)
    c.env = dataclasses.replace(c.env, games=(), full_action_space=False)
    return c


def env_for_actor(env: EnvConfig, actor_id: int) -> EnvConfig:
    """Per-actor game assignment (config 4 multi-game fleets): actor i
    plays ``games[i % len(games)]``; single-game configs pass through."""
    if not env.games:
        return env
    return dataclasses.replace(env,
                               id=env.games[actor_id % len(env.games)])


PRESETS = {
    "cartpole": cartpole_config,
    "pong": pong_config,
    "breakout": breakout_config,
    "apex": apex_config,
    "r2d2": r2d2_config,
}


# ---------------------------------------------------------------------------
# argparse bridge
# ---------------------------------------------------------------------------


def add_config_flags(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--preset", default="cartpole", choices=sorted(PRESETS))
    parser.add_argument(
        "--backend", default="cuda", choices=["cuda", "cpu"],
        help="Compute device behind the Solver: an NVIDIA card or the host.")
    parser.add_argument("--set", nargs="*", default=[], metavar="PATH=VALUE",
                        help="Override any config field, e.g. train.lr=3e-4")


def _coerce(old: Any, s: str) -> Any:
    if isinstance(old, bool):
        return s.lower() in ("1", "true", "yes")
    if isinstance(old, int):
        return int(s)
    if isinstance(old, float):
        return float(s)
    if isinstance(old, tuple):
        return tuple(type(old[0])(v) for v in s.split(",")) if s else ()
    return s


def apply_overrides(cfg: Config, overrides: list[str]) -> Config:
    for item in overrides:
        path, _, val = item.partition("=")
        *parents, leaf = path.split(".")
        node = cfg
        for p in parents:
            node = getattr(node, p)
        setattr(node, leaf, _coerce(getattr(node, leaf), val))
    return cfg


def config_from_args(args: argparse.Namespace) -> Config:
    cfg = PRESETS[args.preset]()
    cfg.mesh.backend = args.backend
    apply_overrides(cfg, args.set)
    return cfg
