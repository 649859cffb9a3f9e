"""Overload plane for the actor↔learner RPC boundary.

The resilience layer (``rpc/resilience.py``) makes the data plane
survive *faults*; this module makes it survive
*load*. Podracer (arXiv:2104.06272) and IMPACT (arXiv:1912.00167) both
bound producer/consumer mismatch explicitly — an actor fleet that outruns
the learner must be slowed, not buffered, or staged rows and RSS grow
without bound while actors train on ever-staler θ. Three mechanisms,
composable and individually inert at their defaults:

- **Credits** (``FlowController.grant``): every ``add_transitions`` reply
  carries a per-actor allowance in rows/second, derived from replay free
  space (warm-fill is unthrottled), staged-but-unflushed row depth, and
  the learner's observed consumption rate. Clients feed the grant into a
  ``TokenBucket`` and pace their flush cadence; a healthy server never
  grants below ``flush_credit_floor`` so a throttled fleet keeps
  trickling instead of livelocking.
- **Admission / shedding** (``FlowController.admit``): when staged depth
  crosses ``staged_high_watermark`` or fleet ingest exceeds
  ``ingest_factor ×`` consumption, flushes are answered with an explicit
  ``SHED`` reply (never a silent drop). The shed flush keeps its
  ``flush_seq`` unstamped, so the client re-sends the SAME payload after
  ``retry_after_ms`` — the zero-loss/zero-dup contract holds.
  ``shed_policy="fair"`` sheds actors at/above their fair share of the
  fleet ingest rate first (the lowest-priority flushes), ``"all"`` sheds
  everything while over the line, ``"none"`` disables shedding.
- **Watchdog / degraded mode** (``FlowController.poll``): a daemon thread
  trips degraded mode when staged depth or process RSS crosses its
  watermark — accepts pause (every flush sheds), credits shrink to zero,
  and staged rows are drained via ``replay.flush()`` each tick. Recovery
  is hysteretic (staged below half the watermark) so the mode doesn't
  flap at the boundary.

All mutable state is guarded by the server's ``replay_lock`` (an RLock —
the server dispatches under it and the controller re-enters). A copy of
the reference ``rpc/flowcontrol.py``; host only.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from dataclasses import dataclass

from distributed_deep_q_tpu_torch import tracing

log = logging.getLogger(__name__)


def rss_mb() -> float:
    """Resident set size of this process in MB via ``/proc/self/statm``
    (field 2 is resident pages) — stdlib-only, no psutil. Returns 0.0
    where /proc is unavailable (macOS), which disables the RSS tripwire
    rather than faulting."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGESIZE") / 1e6
    except (OSError, ValueError, IndexError):
        return 0.0


@dataclass
class FlowConfig:
    """Knobs for the overload plane. The config.py surface
    (``cfg.replay.{staged_high_watermark,shed_policy,rss_high_watermark_mb}``,
    ``cfg.actors.flush_credit_floor``) maps onto the matching fields here;
    the rest are library-level tuning with safe defaults."""

    flush_credit_floor: int = 64        # min rows/s granted while healthy
    staged_high_watermark: int = 8192   # staged rows before shed/degrade
    shed_policy: str = "fair"           # "fair" | "all" | "none"
    rss_high_watermark_mb: int = 0      # 0 = RSS tripwire disabled
    ingest_factor: float = 8.0          # allowed fleet ingest ÷ consumption
    rate_halflife_s: float = 2.0        # EWMA half-life for rate estimates
    watchdog_period_s: float = 0.5      # degraded-mode evaluation cadence
    conn_deadline_s: float = 300.0      # server-side socket recv/send bound
    max_retry_after_s: float = 5.0      # cap on the SHED backoff hint


class _Rate:
    """Time-decayed exponential rate estimator (rows/second).

    Each ``add(rows)`` contributes ~``rows·ln2/halflife`` to the estimate
    independent of call spacing, so a sustained R rows/s stream reads R at
    equilibrium and the estimate halves every ``halflife`` of silence.
    Callers hold the controller's lock; no locking here."""

    def __init__(self, halflife_s: float, clock) -> None:
        self._halflife = float(halflife_s)
        self._clock = clock
        self._value = 0.0
        self._t = clock()

    def add(self, rows: int) -> None:
        now = self._clock()
        dt = max(now - self._t, 1e-6)
        decay = 0.5 ** (dt / self._halflife)
        self._value = decay * self._value + (1.0 - decay) * (rows / dt)
        self._t = now

    def rate(self) -> float:
        dt = max(self._clock() - self._t, 0.0)
        return self._value * 0.5 ** (dt / self._halflife)


class TokenBucket:
    """Client-side flush pacer fed by server credit grants.

    Starts unlimited — against a server that never grants credits (or a
    pre-credit snapshot of the protocol) ``reserve`` returns 0.0 wait
    forever, making the bucket literally free when the feature is idle.
    The first ``grant(credits)`` switches it to ``credits`` rows/second
    with a one-``burst_s`` burst capacity; sustained overdraw accrues
    bounded debt so no single flush ever waits more than ``max_wait_s``."""

    def __init__(self, burst_s: float = 1.0, max_wait_s: float = 5.0,
                 clock=time.monotonic) -> None:
        self._lock = threading.Lock()
        self._clock = clock
        self._burst_s = float(burst_s)
        self._max_wait_s = float(max_wait_s)
        self._rate = float("inf")
        self._capacity = float("inf")
        self._tokens = float("inf")
        self._t = clock()
        self.granted = -1  # last grant seen (rows/s); -1 = never granted

    def grant(self, credits: int) -> None:
        credits = max(int(credits), 0)
        with self._lock:
            self.granted = credits
            self._rate = float(credits)
            self._capacity = max(credits * self._burst_s, 1.0)
            self._tokens = min(self._tokens, self._capacity)

    def reserve(self, rows: int) -> float:
        """Debit ``rows``; return seconds the caller should sleep before
        sending. 0.0 while within the granted rate."""
        with self._lock:
            now = self._clock()
            if self._rate == float("inf"):
                self._t = now
                return 0.0
            dt = max(now - self._t, 0.0)
            self._t = now
            self._tokens = min(self._tokens + self._rate * dt,
                               self._capacity)
            self._tokens -= rows
            if self._tokens >= 0.0:
                return 0.0
            wait = self._max_wait_s if self._rate <= 0.0 else \
                min(-self._tokens / self._rate, self._max_wait_s)
            # debt floor bounds the NEXT wait too — a huge flush must not
            # stall the stream for minutes
            self._tokens = max(self._tokens,
                               -max(self._rate, 1.0) * self._max_wait_s)
            return wait


class FlowController:
    """Server-side credit ledger + admission controller + watchdog.

    All mutable state (``credits`` map, ``degraded`` flag, shed counter,
    rate estimators) is guarded by ``replay_lock`` — the same RLock the
    owning ``ReplayFeedServer`` dispatches under, so admission decisions
    are atomic with the insert they gate."""

    def __init__(self, cfg: FlowConfig | None = None, replay_lock=None,
                 replay=None, clock=time.monotonic) -> None:
        self.cfg = cfg or FlowConfig()
        self.replay_lock = replay_lock or threading.RLock()
        self._replay = replay
        self._clock = clock
        self.credits: dict[int, int] = {}
        self.degraded = False
        self.degraded_trips = 0
        self.shed_total = 0
        self._consumed = _Rate(self.cfg.rate_halflife_s, clock)
        self._ingested = _Rate(self.cfg.rate_halflife_s, clock)
        self._actor_rates: dict[int, _Rate] = {}
        self._stop = threading.Event()
        self._watchdog: threading.Thread | None = None

    # -- rate feeds ---------------------------------------------------------

    def note_consumed(self, rows: int) -> None:
        """Learner-side feed: ``rows`` sampled for training. Drives both
        the credit formula and the ingest-mismatch shed branch."""
        with self.replay_lock:
            self._consumed.add(rows)

    def on_ingest(self, actor_id: int, rows: int) -> None:
        """Record an ADMITTED flush (shed flushes must not count — their
        retries would otherwise inflate the fleet rate they back off to)."""
        with self.replay_lock:
            self._ingested.add(rows)
            r = self._actor_rates.get(actor_id)
            if r is None:
                r = self._actor_rates[actor_id] = _Rate(
                    self.cfg.rate_halflife_s, self._clock)
            r.add(rows)

    # -- credit + admission -------------------------------------------------

    def grant(self, actor_id: int) -> int:
        """Per-actor allowance in rows/second, returned on every flush
        reply. Healthy floor ``flush_credit_floor``; 0 while degraded."""
        with self.replay_lock:
            if self.degraded:
                self.credits[actor_id] = 0
                return 0
            high = max(self.cfg.staged_high_watermark, 1)
            headroom = min(max(high - self._staged(), 0) / high, 1.0)
            consume = self._consumed.rate()
            if consume > 1e-6:
                allow = consume * self.cfg.ingest_factor
            else:
                # no consumption observed yet → warm-fill: open the gate
                # as wide as the buffer's free space
                free = self._free()
                allow = float(free) if free is not None else 1e9
            active = len(self._actor_rates) + (
                0 if actor_id in self._actor_rates else 1)
            credit = int(min(allow, 1e9) / max(active, 1) * headroom)
            credit = max(credit, self.cfg.flush_credit_floor)
            self.credits[actor_id] = credit
            return credit

    def admit(self, actor_id: int, rows: int) -> tuple[bool, int]:
        """Admission decision for one flush of ``rows``: ``(admitted,
        retry_after_ms)``. Shed reasons: degraded mode, staged depth over
        the watermark, or fleet ingest outrunning consumption by more than
        ``ingest_factor``. ``shed_policy="none"`` always admits."""
        with self.replay_lock:
            policy = self.cfg.shed_policy
            if policy == "none":
                return True, 0
            staged = self._staged()
            if self.degraded:
                return self._shed(rows, staged)
            if staged + rows > self.cfg.staged_high_watermark \
                    and self._over_fair_share(actor_id, policy):
                return self._shed(rows, staged)
            consume = self._consumed.rate()
            if consume > 1e-6 \
                    and self._ingested.rate() > self.cfg.ingest_factor * consume \
                    and self._over_fair_share(actor_id, policy):
                return self._shed(rows, staged)
            return True, 0

    def _shed(self, rows: int, staged: int) -> tuple[bool, int]:
        # re-entrant (callers hold replay_lock) but lexical, so the lock
        # checker can see the discipline
        with self.replay_lock:
            self.shed_total += 1
            consume = self._consumed.rate()
            if consume > 1e-6:
                backlog = max(
                    staged + rows - self.cfg.staged_high_watermark // 2, rows)
                est = backlog / consume
            else:
                est = 2.0 * self.cfg.watchdog_period_s
            est = min(max(est, 0.05), self.cfg.max_retry_after_s)
            return False, int(1000 * est)

    def _over_fair_share(self, actor_id: int, policy: str) -> bool:
        if policy != "fair":
            return True  # "all": every flush over the line sheds
        # "fair": only actors at/above their share of the fleet rate are
        # low-priority; a new actor's first flush always lands
        r = self._actor_rates.get(actor_id)
        if r is None:
            return False
        active = max(len(self._actor_rates), 1)
        return r.rate() * active >= self._ingested.rate() * 0.999

    # -- watchdog / degraded mode -------------------------------------------

    def poll(self) -> bool:
        """One watchdog evaluation (public so tests can step it under a
        fake clock). Returns the degraded flag after evaluation."""
        limit = self.cfg.rss_high_watermark_mb
        rss = rss_mb() if limit > 0 else 0.0
        with self.replay_lock:
            staged = self._staged()
            high = self.cfg.staged_high_watermark
            over = staged > high or (limit > 0 and rss > limit)
            under = staged <= high // 2 and (limit <= 0 or rss <= 0.9 * limit)
            if not self.degraded and over:
                self.degraded = True
                self.degraded_trips += 1
                tracing.instant("degraded", staged=staged, rss_mb=rss)
                log.warning("flowcontrol: DEGRADED (staged=%d/%d rss=%.0fMB"
                            "/%d) — pausing accepts, draining", staged, high,
                            rss, limit)
            elif self.degraded and under:
                self.degraded = False
                log.info("flowcontrol: recovered (staged=%d) — resuming",
                         staged)
            if self.degraded:
                flush = getattr(self._replay, "flush", None)
                if flush is not None:
                    flush()  # drain staged rows toward the sampler
            return self.degraded

    def set_degraded(self, flag: bool) -> None:
        """Manual trip/clear — ops escape hatch and test hook."""
        with self.replay_lock:
            if flag and not self.degraded:
                self.degraded_trips += 1
            self.degraded = bool(flag)

    def start_watchdog(self) -> None:
        if self._watchdog is not None:
            return
        self._watchdog = threading.Thread(
            target=self._watch_loop, name="flow-watchdog", daemon=True)
        self._watchdog.start()

    def _watch_loop(self) -> None:
        while not self._stop.wait(self.cfg.watchdog_period_s):
            self.poll()

    def close(self) -> None:
        self._stop.set()
        if self._watchdog is not None:
            self._watchdog.join(timeout=5)
            self._watchdog = None

    # -- introspection ------------------------------------------------------

    def counters(self) -> dict:
        """Locked snapshot of the overload gauges for summaries/verdicts."""
        with self.replay_lock:
            return {
                "degraded": int(self.degraded),
                "degraded_trips": self.degraded_trips,
                "shed_total": self.shed_total,
                "consume_rate": self._consumed.rate(),
                "ingest_rate": self._ingested.rate(),
                "staged_rows": self._staged(),
                "credits": dict(self.credits),
                "credit_starvation": self._credit_starvation(),
            }

    def _credit_starvation(self) -> float:
        """Fraction of the fleet pinned at (or below) the credit floor —
        the health plane's leading indicator that admission is throttling
        actors before any shed happens. Healthy grants sit strictly
        above ``flush_credit_floor`` only when headroom allows; degraded
        mode grants 0 to everyone, so the gauge saturates at 1.0.
        Re-entrant (callers hold ``replay_lock``) but lexical, so the
        lock discipline pass sees it."""
        with self.replay_lock:
            if not self.credits:
                return 0.0
            floor = self.cfg.flush_credit_floor
            starved = sum(1 for c in self.credits.values() if c <= floor)
            return starved / len(self.credits)

    # callers hold replay_lock (RLock) — these only read the replay object

    def _staged(self) -> int:
        pending = getattr(self._replay, "pending_rows", None)
        return int(pending()) if pending is not None else 0

    def _free(self) -> int | None:
        cap = getattr(self._replay, "capacity", None)
        if cap is None:
            return None
        try:
            return max(int(cap) - len(self._replay), 0)
        except TypeError:
            return None
