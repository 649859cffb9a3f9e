"""Fault-tolerance layer for the actor↔learner RPC plane.

A copy of the reference ``rpc/resilience.py`` (host only), its imports rewritten
to this package.

The paper's parameter-server topology assumes every process survives the
whole run; Podracer (arXiv:2104.06272) and IMPACT (arXiv:1912.00167) both
make the opposite assumption — transient failures on the actor/learner
boundary are normal and must be absorbed, not fatal. This module supplies
the absorption:

``RetryPolicy``
    Exponential backoff with decorrelated jitter, a wall-clock deadline,
    and a retryable-exception classification (connection loss, timeouts,
    and ``ProtocolError`` stream desyncs — the client stub already drops
    its socket on those, so the next attempt reconnects cleanly).

``ResilientReplayFeedClient``
    Wraps ``ReplayFeedClient`` so ``add_transitions`` / ``get_params`` /
    ``reset_stream`` reconnect-and-resend instead of dying. Flushes are
    made **idempotent**: every ``add_transitions`` is stamped with a
    monotonically increasing ``flush_seq``, and a retry resends the SAME
    seq — the server dedups ``(actor_id, flush_seq)``, so the ambiguous
    failure mode (frame sent, ack lost) can never double-insert into
    replay.

Overload is NOT failure: the server may answer a flush with an
explicit ``SHED`` (admission control) and every reply carries a credit
grant (rows/second allowance). ``add_transitions`` honors both — a
``TokenBucket`` paces the flush cadence to the granted rate, and a shed
flush is re-sent with the SAME ``flush_seq`` after the server's
``retry_after_ms`` hint, distinct from the transport-failure retry path
(no socket drop, no reconnect, no deadline burn).

Nothing here owns policy about *fatal* errors: once the deadline lapses
the last exception propagates and the supervisor's respawn path takes
over, exactly as before this layer existed.
"""

from __future__ import annotations

import logging
import socket
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np

from distributed_deep_q_tpu_torch import tracing
from distributed_deep_q_tpu_torch.rpc.flowcontrol import TokenBucket
from distributed_deep_q_tpu_torch.rpc.protocol import ProtocolError

log = logging.getLogger(__name__)

# what a retry can fix: the peer vanished, the link hiccuped, or the stream
# desynced (client dropped the socket; reconnect starts a clean frame).
# socket.timeout is an OSError alias since 3.10 but spelled out for clarity.
RETRYABLE = (ConnectionError, OSError, socket.timeout, ProtocolError)


class RPCError(RuntimeError):
    """The server answered with an application error — retrying won't help."""


class ServerClosing(ConnectionError):
    """The server answered that it is shutting down (a restart in
    progress): a transport fault in all but name, so an idempotent call
    retries it under the policy's deadline like a dropped connection."""


# process-wide mass-reconnect accounting (rpc/mass_reconnects): every
# remap-flavored ``rehost`` from any client in this process counts here,
# so the churn harness and the supervisor read one fleet-level gauge
_herd_lock = threading.Lock()
_mass_reconnects = 0


def mass_reconnects() -> int:
    """Total remap-driven reconnects across every client in-process."""
    with _herd_lock:
        return _mass_reconnects


def _note_mass_reconnect() -> None:
    global _mass_reconnects
    with _herd_lock:
        _mass_reconnects += 1


@dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff + jitter with a total wall-clock deadline."""

    base_delay: float = 0.05   # first backoff (seconds)
    max_delay: float = 2.0     # per-attempt cap
    multiplier: float = 2.0
    jitter: float = 0.5        # each delay is scaled by U[1-jitter, 1]
    deadline: float = 120.0    # give up after this many seconds total
    retryable: tuple = RETRYABLE

    def backoff(self, attempt: int, rng: np.random.Generator) -> float:
        """Sleep length before retry ``attempt`` (0-based)."""
        raw = min(self.base_delay * self.multiplier ** attempt,
                  self.max_delay)
        if self.jitter:
            raw *= 1.0 - self.jitter * float(rng.random())
        return raw

    def backoff_decorrelated(self, prev: float,
                             rng: np.random.Generator) -> float:
        """Decorrelated-jitter sleep: ``U[base, 3·prev]`` capped at
        ``max_delay``. Unlike the exponential ladder, consecutive
        delays share no deterministic schedule — when a whole actor
        slice remaps at once (a fleet-epoch change), the herd's retries
        spread across the full window instead of arriving in the
        lock-stepped waves the ladder produces."""
        prev = max(float(prev), self.base_delay)
        return min(self.max_delay,
                   self.base_delay
                   + (3.0 * prev - self.base_delay) * float(rng.random()))

    def run(self, fn: Callable[[], Any], *, rng: np.random.Generator,
            should_abort: Callable[[], bool] | None = None,
            on_retry: Callable[[int, BaseException], None] | None = None,
            decorrelate: bool = False):
        """Call ``fn`` until success, non-retryable error, abort, or
        deadline; re-raises the last retryable error on give-up.
        ``decorrelate=True`` swaps the exponential ladder for the
        decorrelated-jitter schedule (mass-remap reconnects)."""
        start = time.monotonic()
        attempt = 0
        prev = self.base_delay
        while True:
            try:
                return fn()
            except self.retryable as e:
                if should_abort is not None and should_abort():
                    raise
                if decorrelate:
                    delay = prev = self.backoff_decorrelated(prev, rng)
                else:
                    delay = self.backoff(attempt, rng)
                if time.monotonic() + delay - start > self.deadline:
                    raise
                if on_retry is not None:
                    on_retry(attempt, e)
                attempt += 1
                time.sleep(delay)


class ResilientReplayFeedClient:
    """Retry/backoff + idempotent-flush wrapper around ``ReplayFeedClient``.

    Drop-in for the raw stub in the actor loops: same ``call`` /
    ``add_transitions`` / ``get_params`` / ``close`` surface. The one
    deliberate behavioral difference: ``call_once`` exposes the raw
    single-attempt path for callers that own their own retry cadence (the
    heartbeat thread — its period IS its backoff, and retrying inside the
    beat would defeat the stall-budget gate).
    """

    def __init__(self, client, policy: RetryPolicy | None = None,
                 should_abort: Callable[[], bool] | None = None,
                 seed: int | None = None):
        self._client = client
        self.policy = policy or RetryPolicy()
        self._should_abort = should_abort
        self._rng = np.random.default_rng(seed)
        self._flush_seq = 0
        self.retries = 0      # attempts beyond the first, all methods
        self.gave_up = 0      # deadline exhaustions (error propagated)
        # overload plane: credit-fed flush pacer (unlimited until the
        # server's first grant — zero cost against a grantless server),
        # shed/throttle accounting, and the newest θ version the server
        # advertised on a flush reply (feeds the staleness guard)
        self.bucket = TokenBucket()
        self.sheds = 0          # flushes answered with SHED, then re-sent
        self.throttled_s = 0.0  # total seconds spent pacing to credits
        self.params_version = -1
        # elastic-fleet remap state (actors/membership.py): after a
        # fleet-epoch remap the old shard's importer is queried for this
        # actor's highest LANDED flush_seq; any in-flight resend at or
        # below the floor already traveled inside the handoff snapshot
        # and is answered synthetically instead of double-sent
        self.resend_floor = -1
        self.resends_skipped = 0
        self.mass_reconnects = 0   # remap-flavored rehosts on this client
        # one-outage flag: a remap reconnect uses decorrelated jitter so
        # the whole remapped slice doesn't retry in lock-stepped waves;
        # the first success reverts to the plain ladder
        self._decorrelate = False
        # optional liveness hook, called while waiting out backpressure —
        # the supervisor wires this to its progress watermark so a long
        # throttle reads as intentional waiting, not a hang
        self.on_backpressure: Callable[[], None] | None = None

    @classmethod
    def connect(cls, host: str, port: int, actor_id: int = 0,
                policy: RetryPolicy | None = None, timeout: float = 30.0,
                should_abort: Callable[[], bool] | None = None,
                seed: int | None = None) -> "ResilientReplayFeedClient":
        """Open a stub with retries on the INITIAL connection too — an
        actor spawned while the learner is mid-restart must wait it out,
        not die and feed the restart storm."""
        from distributed_deep_q_tpu_torch.rpc.replay_server import ReplayFeedClient

        policy = policy or RetryPolicy()
        rng = np.random.default_rng(seed)
        raw = policy.run(
            lambda: ReplayFeedClient(host, port, actor_id=actor_id,
                                     timeout=timeout),
            rng=rng, should_abort=should_abort)
        return cls(raw, policy, should_abort=should_abort, seed=seed)

    @property
    def actor_id(self) -> int:
        return self._client.actor_id

    def _on_retry(self, method: str) -> Callable[[int, BaseException], None]:
        def cb(attempt: int, e: BaseException) -> None:
            self.retries += 1
            tracing.instant("retry", method=method, attempt=attempt)
            if attempt == 0:  # one line per outage, not per attempt
                log.info("rpc %s failed (%s: %s); retrying with backoff",
                         method, type(e).__name__, e)
        return cb

    def _run(self, method: str, fn: Callable[[], Any]):
        try:
            out = self.policy.run(fn, rng=self._rng,
                                  should_abort=self._should_abort,
                                  on_retry=self._on_retry(method),
                                  decorrelate=self._decorrelate)
            self._decorrelate = False  # outage over; back to the ladder
            return out
        except self.policy.retryable:
            self.gave_up += 1
            raise

    def call(self, method: str,
             reply_check: Callable[[dict], None] | None = None,
             **kwargs: Any) -> dict[str, Any]:
        """Request/reply with retries. Safe for idempotent methods only —
        ``add_transitions`` must go through its stamped wrapper below.
        ``reply_check`` sees every reply inside the retry loop and may
        raise a retryable error (``ServerClosing``) to re-send."""
        def send() -> dict[str, Any]:
            resp = self._client.call(method, **kwargs)
            if reply_check is not None:
                reply_check(resp)
            return resp

        return self._run(method, send)

    def call_once(self, method: str, **kwargs: Any) -> dict[str, Any]:
        """Single attempt, no retries (heartbeat thread's cadence)."""
        return self._client.call(method, **kwargs)

    def add_transitions(self, **batch: Any) -> dict[str, Any]:
        """Idempotent flush: stamp a fresh ``flush_seq``, resend the SAME
        stamp on every retry so the server can dedup ambiguous resends.

        Honors the overload plane on both sides of the send: the token
        bucket paces the flush to the last credit grant BEFORE the bytes
        move, and a ``SHED`` reply re-stages the same payload (same seq)
        after the server's ``retry_after_ms`` hint — backpressure is
        explicit cooperation, not a transport fault, so it neither drops
        the socket nor burns the retry deadline."""
        rows = int(batch.get("env_steps", 0)) or \
            len(batch.get("action", ())) or 1
        with tracing.span("flush"):
            wait = self.bucket.reserve(rows)
            if wait > 0.0:
                self.throttled_s += wait
                with tracing.span("bucket_wait"):
                    self._sleep_backpressure(wait)
            self._flush_seq += 1
            seq = self._flush_seq
            while True:
                # causal context + send stamp ride the frame as plain
                # tr_* keys (tm_* piggyback precedent — no version bump);
                # empty when tracing is off, so untraced peers see the
                # exact untraced payload
                ctx = tracing.wire_context()
                t1 = tracing.now() if tracing.ENABLED else 0.0

                def _send(seq=seq, ctx=ctx):
                    # re-checked on EVERY retry attempt: the remap
                    # watcher may raise the floor while this flush is
                    # mid-backoff against its departed owner
                    if seq <= self.resend_floor:
                        self.resends_skipped += 1
                        return {"ok": True, "duplicate": True,
                                "resend_skipped": True}
                    return self._client.call("add_transitions",
                                             flush_seq=seq, **ctx,
                                             **batch)

                with tracing.span("rpc_call"):
                    resp = self._run("add_transitions", _send)
                if resp.get("error"):
                    # the server rejected the payload (malformed batch,
                    # not a transport fault) — surface it loudly;
                    # retrying cannot help
                    raise RPCError(
                        f"add_transitions rejected: {resp['error']}")
                self._note_reply(resp)
                if tracing.ENABLED:
                    # NTP-style skew sample: our t1/t4 + the server's
                    # recv/reply stamps → offset to the server clock
                    # (corrects lineage birth stamps + aligns shards)
                    t2 = resp.get(tracing.KEY_RECV_AT)
                    t3 = resp.get(tracing.KEY_DONE_AT)
                    if t2 is not None and t3 is not None:
                        off, rtt = tracing.estimate_skew(
                            t1, float(t2), float(t3), tracing.now())
                        tracing.record_skew(off, rtt)
                if resp.get("shed"):
                    self.sheds += 1
                    tracing.instant(
                        "shed",
                        retry_after_ms=float(resp.get("retry_after_ms", 0)))
                    delay = max(float(resp.get("retry_after_ms", 100)),
                                10.0) / 1e3
                    # decorrelate the fleet's re-sends a little
                    delay *= 1.0 + 0.25 * float(self._rng.random())
                    self._sleep_backpressure(delay)
                    continue
                return resp

    def _note_reply(self, resp: dict[str, Any]) -> None:
        credits = resp.get("credits")
        if credits is not None:
            self.bucket.grant(int(credits))
        version = resp.get("params_version")
        if version is not None:
            self.params_version = max(self.params_version, int(version))

    def _sleep_backpressure(self, seconds: float) -> None:
        """Sleep in short slices so shutdown stays responsive and the
        liveness hook keeps firing — a throttled actor must read as
        intentionally waiting, never as hung."""
        end = time.monotonic() + seconds
        while True:
            if self._should_abort is not None and self._should_abort():
                raise ConnectionAbortedError(
                    "aborted while waiting out backpressure")
            if self.on_backpressure is not None:
                self.on_backpressure()
            remaining = end - time.monotonic()
            if remaining <= 0.0:
                return
            time.sleep(min(remaining, 0.2))

    def rehost(self, host: str, port: int, remap: bool = False) -> None:
        """Repoint at a moved server (same hash-assigned host, new
        address). The next call reconnects
        through the normal retry path; in-flight idempotency state
        (``flush_seq``, credits) carries over because the HOST — and
        hence the server-side dedup/ledger identity — is unchanged.

        ``remap=True`` marks a fleet-epoch remap (this actor's OWNER
        changed, not just its address): the reconnect counts into the
        ``rpc/mass_reconnects`` gauge and the next outage's retries use
        decorrelated jitter, so a whole remapped slice spreads its
        reconnects instead of thundering in ladder lock-step."""
        if remap:
            self.mass_reconnects += 1
            _note_mass_reconnect()
            self._decorrelate = True
        self._client.rehost(host, port)

    def get_params(self, have_version: int = -1):
        """Returns (version, weights-or-None) like the raw stub."""
        return self._run("get_params",
                         lambda: self._client.get_params(have_version))

    def close(self) -> None:
        self._client.close()
