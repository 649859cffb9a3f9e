"""Batched inference service — serve actions, not parameters (port of the
reference's ``rpc/inference_server.py``; host only, the forward is the
policy's).

The parameter-pull topology ships N×θ bytes per sync and needs an
explicit staleness throttle (``actors.max_param_lag``); the Podracer/
Sebulba split (arXiv:2104.06272) and IMPACT (arXiv:1912.00167) invert
it: the forward pass lives next to the learner on the accelerator and
actors ship observations. This server is that inversion, riding the
existing wire protocol unchanged (one new ``infer`` verb, v4 CRC
framing, same faultinject chaos surface, same flowcontrol admission):

- Serve threads (one per connection, the ``ReplayFeedServer`` shape)
  enqueue ``infer`` requests and block on a per-request event
  (``infer_wait`` span).
- A single batcher thread cuts microbatches under a deadline-aware SLO:
  a batch closes at ``max_batch`` queued rows OR ``cutoff_us`` after its
  oldest request, whichever comes first — a lone actor pays at most the
  cutoff, a busy fleet amortizes one forward across many actors.
- The batch runs as ONE forward on the policy's device
  (``models/policy.py``, ``infer_forward`` span), padded to a fixed
  bucket so at most ``len(buckets)`` batch shapes ever run.
- Replies carry argmax actions + Q-value rows + the served θ version +
  a flowcontrol credit grant. ε-greedy stays CLIENT-side (seeded,
  per-actor ε) so exploration is bitwise reproducible.

Admission reuses ``rpc/flowcontrol.py`` verbatim: the controller's
"staged rows" gauge is the inference queue depth, its consumption EWMA
is rows actually forwarded, and over-watermark requests get an explicit
``shed`` reply with ``retry_after_ms`` — never a silent drop. An infer
is a pure function of (θ, obs), so a client re-send after a shed or an
ambiguous transport failure is naturally idempotent: no dedup map
needed, the feed's zero-loss/zero-dup contract costs nothing here.

θ installs are in-process (``set_params`` from the learner's publish
cadence) — the wire never carries parameters on this plane, which is
the point.

**Multi-tenant serving.** The server holds several concurrently-served
θ generations keyed by a tenant tag — ``primary``, ``ab:<name>``,
``shadow:<name>`` — all riding the same wire verb and the same
≤ ``len(buckets)`` batch shapes (θ is an argument of the forward, a
generation of tensors, so tenants share the bucket census). Requests
that don't name a tenant are split deterministically across the A/B
arms by an actor-id hash; shadow tenants never serve actors directly —
their θ sees mirrored copies of primary observations and only drift
counters come back (``tenant/shadow_diverged``), so a shadow can never
leak an action into a primary stream by construction. Admission is
per-tenant (a private ``FlowController`` each), and a **degrade
ladder** sheds tenant classes in strict order under sustained queue
pressure: shadow mirroring suspends first, A/B arms shed second, and
the primary sheds last through its own controller at the full
watermark — graceful degradation instead of uniform sheds.
"""

from __future__ import annotations

import logging
import socket
import threading
import time
from typing import Any

import numpy as np

from distributed_deep_q_tpu_torch import health, tracing
from distributed_deep_q_tpu_torch.metrics import Histogram
from distributed_deep_q_tpu_torch.rpc import faultinject
from distributed_deep_q_tpu_torch.rpc.flowcontrol import FlowConfig, FlowController
from distributed_deep_q_tpu_torch.rpc.protocol import (
    ChecksumError, ProtocolError, recv_msg_sized, send_msg)
from distributed_deep_q_tpu_torch.rpc.replay_server import ReplayFeedClient

log = logging.getLogger(__name__)

# bound on one request's wait for its batch result: far above any sane
# forward, low enough that a wedged device surfaces as shed replies the
# client retries instead of serve threads parked forever
REPLY_BOUND_S = 60.0

# the canonical tenant tag every single-tenant deployment serves
TENANT_PRIMARY = "primary"

# degrade-ladder order (shed first → shed last); level k sheds every
# class with index < k, so the primary is only ever shed by its own
# flow controller at the full watermark (level 3 is "everything sheds")
LADDER_CLASSES = ("shadow", "ab", "primary")


def tenant_class(tag: str) -> str:
    """``primary`` | ``ab`` | ``shadow`` from a tenant tag; raises on
    anything else so a typo'd tag fails loudly at install time."""
    if tag == TENANT_PRIMARY:
        return "primary"
    if tag.startswith("ab:") and len(tag) > 3:
        return "ab"
    if tag.startswith("shadow:") and len(tag) > 7:
        return "shadow"
    raise ValueError(
        f"unknown tenant tag {tag!r}: expected 'primary', 'ab:<name>' "
        "or 'shadow:<name>'")


def arm_for(actor_id: int, arms: tuple) -> str:
    """Deterministic A/B split: Knuth multiplicative hash of the actor
    id over the sorted arm list. Pure in (actor_id, arms) so clients,
    oracles, and the server agree on every actor's arm without any
    coordination wire."""
    if len(arms) <= 1:
        return arms[0] if arms else TENANT_PRIMARY
    return arms[((int(actor_id) * 2654435761) >> 8) % len(arms)]


class _QueueDepth:
    """The flow controller's replay-shaped view of the inference queue:
    admission reads pending ROWS through the same ``pending_rows``
    surface the replay staging plane exposes, so ``FlowController``
    needs no inference-specific branch."""

    def __init__(self, server: "InferenceServer"):
        self._server = server

    def pending_rows(self) -> int:
        return self._server.queued_rows()


class _Pending:
    """One queued infer request: observations in, a slot the batcher
    fills, an event the serve thread blocks on."""

    __slots__ = ("obs", "actor_id", "tenant", "t_enq", "event", "actions",
                 "q", "version", "error")

    def __init__(self, obs: np.ndarray, actor_id: int,
                 tenant: str = TENANT_PRIMARY):
        self.obs = obs
        self.actor_id = actor_id
        self.tenant = tenant
        self.t_enq = time.monotonic()
        self.event = threading.Event()
        self.actions: np.ndarray | None = None
        self.q: np.ndarray | None = None
        self.version = 0
        self.error: str | None = None


class _Tenant:
    """One served θ generation: tag, class, parameter tree + version,
    and a PRIVATE admission controller. The tree/version pair only ever
    moves together under the server's ``_params_lock`` — a microbatch
    captures both atomically, so a reply's (actions, version) can never
    mix two generations."""

    __slots__ = ("tag", "cls", "tree", "version", "flow")

    def __init__(self, tag: str, flow: FlowController):
        self.tag = tag
        self.cls = tenant_class(tag)
        self.tree = None           # params tree; None until first install
        self.version = 0
        self.flow = flow


class InferenceTelemetry:
    """One-lock inference-plane telemetry (the ``ServerTelemetry``
    shape, scoped to this service): reply-latency / batch-size /
    forward-time histograms plus request/shed/wire-error counters."""

    def __init__(self) -> None:
        # RLock: the per-tenant row helper re-acquires lexically under
        # holding record_* callers (HealthMonitor discipline)
        self._lock = threading.RLock()
        self.latency_ms = Histogram()
        self.batch_rows = Histogram()
        self.forward_ms = Histogram()
        self.requests = 0
        self.sheds = 0
        self.wire_errors = 0
        self.reply_timeouts = 0
        # per-tenant plane: counters + a latency histogram
        # per tag, all under the same one lock as the aggregates
        self.tenant_counts: dict[str, dict[str, float]] = {}
        self.tenant_latency: dict[str, Histogram] = {}

    def _tenant_row(self, tag: str) -> dict[str, float]:
        with self._lock:
            row = self.tenant_counts.get(tag)
            if row is None:
                row = {"requests": 0.0, "sheds": 0.0,
                       "shadow_requests": 0.0, "shadow_diverged": 0.0,
                       "swaps": 0.0}
                self.tenant_counts[tag] = row
                self.tenant_latency[tag] = Histogram()
            return row

    def record_reply(self, ms: float, tenant: str = TENANT_PRIMARY) -> None:
        with self._lock:
            self.requests += 1
            self.latency_ms.observe(ms)
            self._tenant_row(tenant)["requests"] += 1
            self.tenant_latency[tenant].observe(ms)

    def record_shed(self, tenant: str = TENANT_PRIMARY) -> None:
        with self._lock:
            self.sheds += 1
            self._tenant_row(tenant)["sheds"] += 1

    def record_shadow(self, tenant: str, rows: int, diverged: int) -> None:
        with self._lock:
            row = self._tenant_row(tenant)
            row["shadow_requests"] += rows
            row["shadow_diverged"] += diverged

    def record_swap(self, tenant: str) -> None:
        with self._lock:
            self._tenant_row(tenant)["swaps"] += 1

    def record_wire_error(self) -> None:
        with self._lock:
            self.wire_errors += 1

    def record_reply_timeout(self) -> None:
        with self._lock:
            self.reply_timeouts += 1

    def record_batch(self, rows: int, forward_ms: float) -> None:
        with self._lock:
            self.batch_rows.observe(float(rows))
            self.forward_ms.observe(forward_ms)

    def summary(self) -> dict[str, float]:
        with self._lock:
            out = {
                "inference/requests": float(self.requests),
                "inference/sheds": float(self.sheds),
                "inference/wire_errors": float(self.wire_errors),
                "inference/reply_timeouts": float(self.reply_timeouts),
            }
            out.update(self.latency_ms.summary("inference/latency_ms"))
            out.update(self.batch_rows.summary("inference/batch_rows"))
            out.update(self.forward_ms.summary("inference/forward_ms"))
            # per-tenant counters under dynamic tenant/<tag>/* keys (the
            # fnmatch surface the tenant SLO rules watch) + aggregates
            agg = {"requests": 0.0, "sheds": 0.0, "shadow_requests": 0.0,
                   "shadow_diverged": 0.0, "swaps": 0.0}
            for tag, row in self.tenant_counts.items():
                for k, v in row.items():
                    out[f"tenant/{tag}/{k}"] = v
                    agg[k] += v
                out.update(self.tenant_latency[tag].summary(
                    f"tenant/{tag}/latency_ms"))
            out["tenant/requests"] = agg["requests"]
            out["tenant/sheds"] = agg["sheds"]
            out["tenant/shadow_requests"] = agg["shadow_requests"]
            out["tenant/shadow_diverged"] = agg["shadow_diverged"]
            out["tenant/swaps"] = agg["swaps"]
            return out

    def latency_snapshots(self) -> dict[str, Histogram]:
        """Cumulative-histogram snapshots for the health plane's
        sliding-window p99 diffs (same contract as the replay feed's
        ``ServerTelemetry.latency_snapshots``)."""
        with self._lock:
            out = {"inference/latency_ms": self.latency_ms.snapshot(),
                   "inference/forward_ms": self.forward_ms.snapshot()}
            for tag, h in self.tenant_latency.items():
                out[f"tenant/{tag}/latency_ms"] = h.snapshot()
            return out


class InferenceServer:
    """Microbatching action server over the v4 wire protocol.

    ``policy`` is a ``models.policy.BatchedPolicy`` (owns the forward
    and the bucket census). One batcher thread, one serve thread per
    connection, chaos-wrapped sockets, flowcontrol admission — the same
    operational envelope as the replay feed.
    """

    def __init__(self, policy, host: str = "127.0.0.1", port: int = 0,
                 max_batch: int = 256, cutoff_us: int = 2000,
                 flow: FlowConfig | None = None, tenants: tuple = (),
                 shed_shadow_frac: float = 0.5, shed_ab_frac: float = 0.75,
                 ladder_burn_s: float = 1.0):
        self.policy = policy
        self.max_batch = max(int(max_batch), 1)
        self._cutoff_s = max(int(cutoff_us), 0) / 1e6
        self.telemetry = InferenceTelemetry()
        # health plane: local monitor answering the `health`
        # verb; free while cfg.health is off (module flag). Tenant SLO
        # rules ride along — they only fire once tenant/* keys sample
        self.health_monitor = health.HealthMonitor(
            rules=(health.default_inference_rules()
                   + health.default_tenant_rules()),
            trends=health.default_inference_trends(), name="inference")
        self.last_seen: dict[int, float] = {}
        # request queue: pending list + row gauge + shutdown flag, all
        # under one condition the batcher sleeps on
        self._cv = threading.Condition()
        self._pending: list[_Pending] = []
        self._queued_rows = 0
        self._closed = False
        # degrade ladder: queue-pressure level + first-shed
        # ledger, under the same condition as the row gauge it reads.
        # Occupancy fractions of the primary watermark; a level rises
        # only after the pressure SUSTAINS for ladder_burn_s and falls
        # with the same sustain at half the threshold (hysteresis)
        self._shed_fracs = (float(shed_shadow_frac), float(shed_ab_frac))
        self._ladder_burn_s = max(float(ladder_burn_s), 0.0)
        self._ladder_level = 0
        self._ladder_rise_since: float | None = None
        self._ladder_fall_since: float | None = None
        self._ladder_ledger: list[dict] = []
        self._first_shed: dict[str, float] = {}
        # θ install plane: version + the policy's parameter swap. An
        # RLock — tenant-registry helpers re-acquire lexically (the
        # HealthMonitor discipline)
        self._params_lock = threading.RLock()
        self._params_version = 0
        # admission: the stock controller against the queue-depth proxy.
        # Its lock is private to this plane (nothing shares state with
        # the replay server), so a busy replay lock never delays an admit
        self.flow = FlowController(flow or FlowConfig(),
                                   threading.RLock(), _QueueDepth(self))
        # tenant registry: the primary always exists and owns
        # self.flow; extra tenants each get a PRIVATE controller against
        # the same global queue-depth proxy (per-tenant credits, shared
        # pressure signal — that shared signal is what makes the ladder
        # ordering strict). Tree installs and registry mutations move
        # under _params_lock; active A/B arms are cached as a tuple
        self._tenants: dict[str, _Tenant] = {}
        self._active_arms: tuple = (TENANT_PRIMARY,)
        with self._params_lock:
            self._make_tenant(TENANT_PRIMARY)
            for tag in tenants:
                self._make_tenant(str(tag))
        self._conns: set = set()
        self._conns_lock = threading.Lock()
        self._sock = socket.create_server((host, port))
        self.address = self._sock.getsockname()
        self._stop = threading.Event()
        self._batcher = threading.Thread(
            target=self._batch_loop, name="infer-batch", daemon=True)
        self._batcher.start()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="infer-accept", daemon=True)
        self._accept_thread.start()

    # -- learner-side API ---------------------------------------------------

    def _make_tenant(self, tag: str) -> "_Tenant":
        """Register a tenant. The primary adopts the server's own
        controller; every other tenant gets a private one against the
        shared queue-depth proxy."""
        with self._params_lock:
            t = self._tenants.get(tag)
            if t is not None:
                return t
            if tag == TENANT_PRIMARY:
                t = _Tenant(tag, self.flow)
            else:
                t = _Tenant(tag, FlowController(
                    self.flow.cfg, threading.RLock(), _QueueDepth(self)))
            self._tenants[tag] = t
            return t

    def _refresh_arms(self) -> None:
        # the A/B split spans the primary plus every ab: tenant that
        # actually has θ installed
        with self._params_lock:
            self._active_arms = (TENANT_PRIMARY,) + tuple(sorted(
                t.tag for t in self._tenants.values()
                if t.cls == "ab" and t.tree is not None))

    def set_params(self, weights: list[np.ndarray],
                   version: int | None = None,
                   tenant: str = TENANT_PRIMARY) -> int:
        """Install θ for one served tenant (in-process push from the
        learner's publish cadence — parameters never cross the wire on
        this plane). Unknown tenants register on first install; the
        (tree, version) pair moves atomically under ``_params_lock`` so
        a racing microbatch serves either generation whole, never a
        mix. Returns the installed version."""
        tenant_class(tenant)  # validate the tag before touching state
        with self._params_lock:
            t = self._make_tenant(tenant)
            if tenant == TENANT_PRIMARY:
                self.policy.set_weights(weights)
                self._params_version = (int(version) if version is not None
                                        else self._params_version + 1)
                t.version = self._params_version
            else:
                t.tree = self.policy.unflatten(weights)
                t.version = (int(version) if version is not None
                             else t.version + 1)
                self._refresh_arms()
            out = t.version
        self.telemetry.record_swap(tenant)
        return out

    def drop_tenant(self, tag: str) -> bool:
        """Retire a non-primary tenant: its θ is dropped, its controller
        closed, and the A/B arms recomputed. Pure no-op for unknown
        tags; the primary cannot be dropped."""
        if tag == TENANT_PRIMARY:
            raise ValueError("the primary tenant cannot be dropped")
        with self._params_lock:
            t = self._tenants.pop(tag, None)
            self._refresh_arms()
        if t is None:
            return False
        t.flow.close()
        return True

    def tenants(self) -> list[str]:
        with self._params_lock:
            return sorted(self._tenants)

    def _published_version(self) -> int:
        with self._params_lock:
            return self._params_version

    # -- degrade ladder ------------------------------------------------------

    def _ladder_tick(self) -> int:
        """Fold current queue occupancy into the ladder level. Rises one
        class at a time (shadow → ab) when occupancy sustains above the
        class's fraction of the primary watermark for ``ladder_burn_s``;
        falls with the same sustain below half the previous threshold."""
        now = time.monotonic()
        wm = float(self.flow.cfg.staged_high_watermark or 0)
        with self._cv:
            occ = (self._queued_rows / wm) if wm > 0 else 0.0
            lvl = self._ladder_level
            if lvl < len(self._shed_fracs) and occ >= self._shed_fracs[lvl]:
                if self._ladder_rise_since is None:
                    self._ladder_rise_since = now
                elif now - self._ladder_rise_since >= self._ladder_burn_s:
                    lvl += 1
                    self._ladder_level = lvl
                    self._ladder_rise_since = now
                    self._ladder_fall_since = None
                    shed_cls = LADDER_CLASSES[lvl - 1]
                    self._note_shed_locked(shed_cls, now, occ)
            else:
                self._ladder_rise_since = None
            if lvl > 0 and occ < 0.5 * self._shed_fracs[lvl - 1]:
                if self._ladder_fall_since is None:
                    self._ladder_fall_since = now
                elif now - self._ladder_fall_since >= self._ladder_burn_s:
                    self._ladder_level = lvl - 1
                    self._ladder_fall_since = now
            else:
                self._ladder_fall_since = None
            return self._ladder_level

    def _note_shed_locked(self, cls: str, t: float, occ: float) -> None:
        # first-shed stamps prove the strict shadow → ab → primary
        # ordering in the chaos gate (a Condition wraps an RLock, so
        # re-acquiring under a holding caller is free)
        with self._cv:
            if cls not in self._first_shed:
                self._first_shed[cls] = t
                self._ladder_ledger.append(
                    {"class": cls, "t": t, "level": self._ladder_level,
                     "occupancy": round(occ, 4)})

    def _note_primary_shed(self) -> None:
        now = time.monotonic()
        wm = float(self.flow.cfg.staged_high_watermark or 0)
        with self._cv:
            occ = (self._queued_rows / wm) if wm > 0 else 0.0
            self._note_shed_locked("primary", now, occ)

    def ladder_ledger(self) -> list[dict]:
        """First-shed events per tenant class, in the order they
        happened — the chaos harness asserts the strict ladder order."""
        with self._cv:
            return [dict(e) for e in self._ladder_ledger]

    def ladder_level(self) -> int:
        with self._cv:
            return self._ladder_level

    def queued_rows(self) -> int:
        with self._cv:
            return self._queued_rows

    def telemetry_summary(self) -> dict[str, float]:
        out = self.telemetry.summary()
        out["inference/queued_rows"] = float(self.queued_rows())
        out["inference/compiled_buckets"] = float(
            len(self.policy.compiled_buckets()))
        with self._params_lock:
            out["tenant/served"] = float(len(self._tenants))
        with self._cv:
            out["tenant/ladder_level"] = float(self._ladder_level)
            out["tenant/shed_shadow"] = float("shadow" in self._first_shed)
            out["tenant/shed_ab"] = float("ab" in self._first_shed)
            out["tenant/shed_primary"] = float("primary" in self._first_shed)
        return out

    def health_scrape(self) -> dict[str, Any]:
        """Body of the ``health`` verb: sample telemetry + latency
        snapshots into this plane's monitor and return the verdict as a
        flat wire dict."""
        if not health.ENABLED:
            return health.verdict_to_wire(health.NULL_VERDICT)
        return self.health_monitor.scrape(
            gauges=self.telemetry_summary(),
            hists=self.telemetry.latency_snapshots())

    def close(self) -> None:
        self._stop.set()
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        self._accept_thread.join(timeout=5)
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.close()
            except OSError:
                pass
        self._batcher.join(timeout=5)
        with self._params_lock:
            tens = list(self._tenants.values())
        for t in tens:
            if t.tag != TENANT_PRIMARY:
                t.flow.close()
        self.flow.close()

    # -- wire loop ----------------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return  # socket closed
            threading.Thread(target=self._serve, args=(conn,),
                             name="infer-serve", daemon=True).start()

    def _serve(self, conn: socket.socket) -> None:
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        deadline = self.flow.cfg.conn_deadline_s
        if deadline and deadline > 0:
            conn.settimeout(deadline)
        # the chaos shim applies to this socket exactly like the replay
        # feed's — drop/delay/corrupt/stall verbs hit both planes
        conn = faultinject.wrap(conn, side="server")
        with self._conns_lock:
            self._conns.add(conn)
        try:
            while not self._stop.is_set():
                try:
                    req, _ = recv_msg_sized(conn)
                except TimeoutError:
                    return  # idle past the conn deadline; client reconnects
                except (ChecksumError, ProtocolError) as e:
                    # corrupt/desynced stream: no reply possible — drop
                    # the conn; an infer re-send is naturally idempotent
                    self.telemetry.record_wire_error()
                    log.warning("inference bad frame: %s: %s",
                                type(e).__name__, e)
                    return
                try:
                    resp = self._dispatch(req)
                except Exception as e:  # noqa: BLE001 — malformed payloads
                    # must answer loudly, never kill the serve thread
                    log.warning("inference dispatch %r: %s: %s",
                                req.get("method"), type(e).__name__, e)
                    resp = {"error": f"{type(e).__name__}: {e}"}
                send_msg(conn, resp)
        except TimeoutError:
            pass  # deadline expired mid-send
        except (ConnectionError, OSError):
            pass  # client went away; its supervisor owns liveness
        finally:
            with self._conns_lock:
                self._conns.discard(conn)
            conn.close()

    def _dispatch(self, req: dict[str, Any]) -> dict[str, Any]:
        method = req.get("method")
        actor_id = int(req.get("actor_id", -1))
        if actor_id >= 0:
            self.last_seen[actor_id] = time.monotonic()

        if method == "infer":
            with tracing.activate(req):
                return self._infer(req, actor_id)

        if method == "heartbeat":
            return {"ok": True}

        if method == "health":
            return self.health_scrape()

        if method == "stats":  # ddq: allow(protocol.orphan-handler) — the scrape verb of operators and tests; the port's own code reads this telemetry in process
            out: dict[str, Any] = {
                "params_version": self._published_version(),
                "compiled_buckets": np.asarray(
                    self.policy.compiled_buckets(), np.int64),
                "tenants": ",".join(self.tenants()),
                "ladder_level": self.ladder_level(),
            }
            out.update(self.telemetry_summary())
            return out

        return {"error": f"unknown method {method!r}"}

    # -- the infer verb ------------------------------------------------------

    def _resolve_tenant(self, req: dict[str, Any], actor_id: int) -> _Tenant:
        """Pick the serving tenant for one request: an explicit
        ``tenant`` field wins (validated — shadow tags are rejected so a
        shadow can never answer an actor), otherwise the deterministic
        actor-hash A/B split over the active arms."""
        tag = str(req.get("tenant", "") or "")
        with self._params_lock:
            if not tag:
                tag = arm_for(actor_id, self._active_arms)
            t = self._tenants.get(tag)
        if t is None:
            tenant_class(tag)  # raise the descriptive error for typos
            raise ValueError(f"tenant {tag!r} is not served here")
        if t.cls == "shadow":
            raise ValueError(
                "shadow tenants are mirror-only: their replies never "
                "reach actors")
        if t.cls == "ab" and t.tree is None:
            raise ValueError(f"tenant {tag!r} has no params installed yet")
        return t

    def _infer(self, req: dict[str, Any], actor_id: int) -> dict[str, Any]:
        t0 = time.perf_counter()
        obs = np.asarray(req["obs"])
        if obs.ndim < 2:
            return {"error": "infer obs must be a stacked [n, ...] batch"}
        n = int(obs.shape[0])
        ten = self._resolve_tenant(req, actor_id)
        level = self._ladder_tick()
        if ten.cls == "ab" and level >= 2:
            # degrade ladder: under sustained pressure the A/B arms shed
            # wholesale before the primary's own watermark is reached
            self.telemetry.record_shed(ten.tag)
            return {"shed": True, "retry_after_ms": 1000,
                    "degraded": ten.cls, "tenant": ten.tag,
                    "credits": ten.flow.grant(actor_id)}
        admitted, retry_ms = ten.flow.admit(actor_id, n)
        if not admitted:
            # explicit shed, never a silent drop: the client re-sends the
            # SAME observations after retry_after_ms; the infer is a pure
            # function of (θ, obs), so the re-send is idempotent for free
            self.telemetry.record_shed(ten.tag)
            if ten.tag == TENANT_PRIMARY:
                self._note_primary_shed()
            return {"shed": True, "retry_after_ms": retry_ms,
                    "tenant": ten.tag,
                    "credits": ten.flow.grant(actor_id)}
        ten.flow.on_ingest(actor_id, n)
        p = _Pending(obs, actor_id, ten.tag)
        with self._cv:
            if self._closed:
                return {"error": "inference server closing"}
            self._pending.append(p)
            self._queued_rows += n
            self._cv.notify_all()
        with tracing.span("infer_wait"):
            if not p.event.wait(REPLY_BOUND_S):
                timed_out = False
                with self._cv:
                    if p in self._pending:
                        # never picked up (wedged batcher/device): shed it
                        # so the client retries instead of hanging
                        self._pending.remove(p)
                        self._queued_rows -= n
                        timed_out = True
                # grant OUTSIDE _cv: admit holds the flow lock while it
                # reads queue depth under _cv — grant-under-_cv would be
                # the reverse order (deadlock)
                if timed_out:
                    self.telemetry.record_shed(ten.tag)
                    return {"shed": True, "retry_after_ms": 1000,
                            "tenant": ten.tag,
                            "credits": ten.flow.grant(actor_id)}
                # in-flight: the forward owns it and sets the event on
                # success AND error paths, so this normally returns in
                # one batch time. The bound guards the one remaining
                # hang — a batcher wedged mid-forward (device stall)
                # would strand this reply forever, and with it the
                # client's connection mutex. Timing out is counted and
                # surfaced as a plain error; the client reconnects and
                # re-sends, which is safe because infer is idempotent
                if not p.event.wait(2 * REPLY_BOUND_S):
                    self.telemetry.record_reply_timeout()
                    return {"error": "inference reply timed out in-flight"
                                     f" ({2 * REPLY_BOUND_S:.0f}s) — "
                                     "batcher wedged"}
        if p.error is not None:
            return {"error": p.error}
        resp: dict[str, Any] = {
            "actions": p.actions,
            "q": p.q,
            "version": p.version,
            "tenant": ten.tag,
            "credits": ten.flow.grant(actor_id),
        }
        if "seq" in req:
            resp["seq"] = req["seq"]  # client-side pairing check
        self.telemetry.record_reply(1e3 * (time.perf_counter() - t0), ten.tag)
        return resp

    # -- the batcher ---------------------------------------------------------

    def _take_batch(self) -> list[_Pending]:
        """Block until a microbatch is due, pop it. Empty ⇒ shutting down.

        A batch closes at ``max_batch`` queued rows or ``cutoff_us``
        after its OLDEST request — the deadline bounds the tail latency
        a lone actor pays for batching. Whole requests only: one reply
        per request, rows never split across forwards."""
        with self._cv:
            while not self._pending and not self._closed:
                self._cv.wait(0.25)
            if not self._pending:
                return []  # closed and drained
            deadline = self._pending[0].t_enq + self._cutoff_s
            while self._queued_rows < self.max_batch and not self._closed:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cv.wait(remaining)
            take: list[_Pending] = []
            rows = 0
            while self._pending and rows < self.max_batch:
                nxt = self._pending[0].obs.shape[0]
                if take and rows + nxt > self.max_batch:
                    break  # oversized single requests still go alone
                take.append(self._pending.pop(0))
                rows += nxt
            self._queued_rows -= rows
            return take

    def _batch_loop(self) -> None:
        while True:
            take = self._take_batch()
            if not take:
                return
            self._run_batch(take)

    def _run_batch(self, take: list[_Pending]) -> None:
        with tracing.span("infer_batch"):
            groups: dict[str, list[_Pending]] = {}
            for p in take:
                groups.setdefault(p.tenant, []).append(p)
        # primary first: its (obs, actions) feed the shadow mirror diff,
        # and its waiters are released before any shadow forward runs
        order = sorted(groups, key=lambda t: (t != TENANT_PRIMARY, t))
        prim_obs: np.ndarray | None = None
        prim_actions: np.ndarray | None = None
        for tag in order:
            grp = groups[tag]
            obs = (grp[0].obs if len(grp) == 1
                   else np.concatenate([p.obs for p in grp]))
            rows = int(obs.shape[0])
            # atomic (tree, version) capture: a racing set_params swaps
            # both together under _params_lock, so every reply in this
            # group carries ONE whole generation — never a mix. The
            # primary tolerates a tree-less duck-typed policy (tests
            # stub the forward) by running the installed tree implicitly
            with self._params_lock:
                t = self._tenants.get(tag)
                if tag == TENANT_PRIMARY:
                    tree = getattr(self.policy, "params", None)
                    version = self._params_version
                elif t is None or t.tree is None:
                    tree, version = None, -1
                else:
                    tree, version = t.tree, t.version
            if tree is None and tag != TENANT_PRIMARY:
                for p in grp:
                    p.error = f"tenant {tag!r} dropped mid-flight"
                    p.event.set()
                continue
            t0 = time.perf_counter()
            try:
                with tracing.span("infer_forward"):
                    if tree is None:
                        actions, q = self.policy.forward(obs)
                    else:
                        actions, q = self.policy.forward(obs, params=tree)
            except Exception as e:  # noqa: BLE001 — a failed forward must
                # release every waiter with a loud error, not park them
                log.warning("inference forward failed (%s): %s: %s",
                            tag, type(e).__name__, e)
                for p in grp:
                    p.error = f"{type(e).__name__}: {e}"
                    p.event.set()
                continue
            self.telemetry.record_batch(
                rows, 1e3 * (time.perf_counter() - t0))
            if t is not None:
                t.flow.note_consumed(rows)
            off = 0
            for p in grp:
                k = p.obs.shape[0]
                p.actions = actions[off:off + k]
                p.q = q[off:off + k]
                p.version = version
                off += k
                p.event.set()
            if tag == TENANT_PRIMARY:
                prim_obs, prim_actions = obs, actions
        if prim_obs is not None:
            self._mirror_shadows(prim_obs, prim_actions)

    def _mirror_shadows(self, obs: np.ndarray,
                        prim_actions: np.ndarray) -> None:
        """Run every shadow tenant's θ over the primary microbatch and
        count action divergence. Replies NEVER touch a ``_Pending`` —
        shadows are bitwise-isolated from actor streams by construction.
        Mirroring is the first rung shed by the degrade ladder."""
        with self._cv:
            if self._ladder_level >= 1:
                return
        with self._params_lock:
            shadows = [(t.tag, t.tree) for t in self._tenants.values()
                       if t.cls == "shadow" and t.tree is not None]
        if not shadows:
            return
        with tracing.span("infer_shadow"):
            for tag, tree in shadows:
                try:
                    a, _ = self.policy.forward(obs, params=tree)
                except Exception as e:  # noqa: BLE001 — a shadow failure
                    # must never disturb the primary plane
                    log.warning("shadow forward failed (%s): %s: %s",
                                tag, type(e).__name__, e)
                    continue
                self.telemetry.record_shadow(
                    tag, int(obs.shape[0]),
                    int(np.sum(a != prim_actions)))


class InferenceClient(ReplayFeedClient):
    """Actor-side stub for the inference plane: the ``ReplayFeedClient``
    transport (one persistent chaos-wrapped connection, lazy reconnect
    after any failure) pointed at an ``InferenceServer``, plus the one
    helper this plane adds. The replay-specific helpers it inherits are
    meaningless against this server and go unused."""

    def infer(self, obs: np.ndarray, seq: int = -1,
              tenant: str = "") -> dict[str, Any]:
        """One infer round trip for a stacked [n, ...] observation batch.
        Returns the raw reply dict (``actions``/``q``/``version`` or
        ``shed``/``retry_after_ms``); callers own retry and shed policy.
        An empty ``tenant`` lets the server pick the actor's A/B arm."""
        if tenant:
            return self.call("infer", obs=np.ascontiguousarray(obs),
                             seq=seq, tenant=tenant)
        return self.call("infer", obs=np.ascontiguousarray(obs), seq=seq)
