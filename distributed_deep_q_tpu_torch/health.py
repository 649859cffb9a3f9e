"""Health plane: windowed series, SLO burn rates, one verdict.

A copy of the reference ``health.py`` (host only), its imports rewritten
to this package.

``metrics.py`` and ``tracing.py`` are the EMIT side of observability — histograms, gauges,
causal spans — but nothing consumed those signals live. This module is
the read side: a fixed-capacity time-series ring over sampled gauges
and histogram *deltas* (``Histogram.snapshot``/``delta`` turn the
cumulative telemetry histograms into sliding windows), declarative SLO
rules with multi-window burn-rate alerting (the Google SRE workbook
shape: a rule FIRES only when both a fast and a slow window have burned
through their error budget, which kills single-spike flaps; it CLEARS
with hysteresis when the fast window cools below ``clear_ratio``),
plus trend detectors (monotonic queue growth, p99 drift, ingest-rate
collapse) that need no target at all. Everything reduces to one
structured ``HealthVerdict {ok|degraded|critical, findings[]}`` — the
machine-readable signal ROADMAP item 5's autoscaler will consume.

Deployment shape: each server (replay feed, inference) owns a
``HealthMonitor`` sampling its own telemetry and answers a ``health``
RPC verb with its verdict; the supervisor's ``FleetHealth`` scrapes
every member into ONE fleet verdict surfaced in the run JSONL
(``health/verdict``) and ``scripts/telemetry_report.py``.

Cost discipline mirrors ``tracing.py``: a module ``ENABLED`` flag is
the single branch on every entry point, and the disabled path returns
preallocated singletons (``NULL_VERDICT``, ``_EMPTY_GAUGES``) without
allocating — pinned by ``tests/test_health.py``.
"""

from __future__ import annotations

import fnmatch
import json
import math
import threading
import time
from dataclasses import dataclass, field

__all__ = [
    "ENABLED", "configure", "configure_from", "disable", "reset",
    "SLORule", "TrendRule", "HealthFinding", "HealthVerdict",
    "NULL_VERDICT", "SeriesRing", "HealthMonitor", "FleetHealth",
    "verdict_to_wire", "verdict_from_wire",
    "default_server_rules", "default_server_trends",
    "default_inference_rules", "default_inference_trends",
    "default_learn_rules", "default_learn_trends",
]

ENABLED = False  # module flag: the single branch on every hot path

# module defaults — per-rule overrides win when set (tests and the
# chaos gate shrink the windows to seconds; production keeps minutes)
_RING_CAP = 512
_FAST_WINDOW_S = 30.0
_SLOW_WINDOW_S = 300.0
_CLEAR_RATIO = 0.5

_SEVERITIES = ("ok", "degraded", "critical")  # worst-of ordering


def configure(enabled: bool = False, ring_capacity: int = 512,
              fast_window_s: float = 30.0, slow_window_s: float = 300.0,
              clear_ratio: float = 0.5) -> None:
    """Set module state from config values (``cfg.health``). Monitors
    created earlier keep their ring capacity (configure first)."""
    global ENABLED, _RING_CAP, _FAST_WINDOW_S, _SLOW_WINDOW_S
    global _CLEAR_RATIO
    _RING_CAP = max(int(ring_capacity), 8)
    _FAST_WINDOW_S = max(float(fast_window_s), 1e-3)
    _SLOW_WINDOW_S = max(float(slow_window_s), _FAST_WINDOW_S)
    _CLEAR_RATIO = min(max(float(clear_ratio), 0.0), 1.0)
    ENABLED = bool(enabled)


def configure_from(health_cfg) -> None:
    """``configure`` from a ``config.HealthConfig`` instance."""
    configure(enabled=health_cfg.enabled,
              ring_capacity=health_cfg.ring_capacity,
              fast_window_s=health_cfg.fast_window_s,
              slow_window_s=health_cfg.slow_window_s,
              clear_ratio=health_cfg.clear_ratio)


def disable() -> None:
    global ENABLED
    ENABLED = False


def reset() -> None:
    """Test hook: restore module defaults (monitors are per-instance
    state and are simply dropped by their owners)."""
    configure()


# -- declarative rules ------------------------------------------------------
@dataclass(frozen=True)
class SLORule:
    """Target + multi-window burn-rate alert over one metric key.

    ``key`` is an ``fnmatch`` pattern over sampled series names (e.g.
    ``rpc/*_ms_p99``). ``mode``: ``above`` — a sample violates when
    value > target; ``below`` — when value < target; ``rate_above`` —
    the per-second delta between consecutive samples violates when it
    exceeds target (the shape for cumulative counters: target 0.0 means
    "this counter must not move", e.g. ``rpc/checksum_errors``).
    ``budget`` is the violating-sample fraction the SLO tolerates; the
    burn rate of a window is violating-fraction / budget, and the rule
    fires when BOTH windows burn ≥ 1.
    """

    name: str
    key: str
    target: float
    mode: str = "above"          # above | below | rate_above
    budget: float = 0.1
    severity: str = "degraded"   # degraded | critical
    fast_window_s: float | None = None  # None → module default
    slow_window_s: float | None = None
    clear_ratio: float | None = None

    def __post_init__(self):
        if self.mode not in ("above", "below", "rate_above"):
            raise ValueError(f"unknown SLO mode {self.mode!r}")
        if self.severity not in ("degraded", "critical"):
            raise ValueError(f"unknown severity {self.severity!r}")


@dataclass(frozen=True)
class TrendRule:
    """Targetless shape detector over one series.

    ``kind``: ``monotonic_growth`` — the window never decreases and
    grows by ≥ ``ratio``× overall (queue that only fills is a leak even
    before any absolute threshold trips); ``drift`` — the latest sample
    exceeds ``ratio``× the window median AND sits above ``floor``
    (p99 creep; the floor keeps the multiplicative noise of a fast
    series — a windowed p99 jumping 0.2→1 ms between scrapes — from
    reading as drift); ``collapse`` — the latest sample falls below
    ``ratio``× the window median while the median itself sat above
    ``floor`` (an ingest rate that was genuinely flowing and then
    died — there the floor keeps an idle series from "collapsing"
    from zero to zero).
    """

    name: str
    key: str
    kind: str                    # monotonic_growth | drift | collapse
    ratio: float = 2.0
    min_points: int = 4
    floor: float = 0.0
    severity: str = "degraded"

    def __post_init__(self):
        if self.kind not in ("monotonic_growth", "drift", "collapse"):
            raise ValueError(f"unknown trend kind {self.kind!r}")


@dataclass(frozen=True)
class HealthFinding:
    """One violated rule, with enough numbers to act on it."""

    rule: str
    key: str
    severity: str = "degraded"
    kind: str = "slo"            # slo | trend | fleet
    value: float = float("nan")
    target: float = float("nan")
    burn_fast: float = 0.0
    burn_slow: float = 0.0
    member: str = ""             # set by FleetHealth aggregation
    detail: str = ""

    def to_dict(self) -> dict:
        d = {"rule": self.rule, "key": self.key,
             "severity": self.severity, "kind": self.kind,
             "value": None if math.isnan(self.value) else self.value,
             "target": None if math.isnan(self.target) else self.target,
             "burn_fast": round(self.burn_fast, 4),
             "burn_slow": round(self.burn_slow, 4)}
        if self.member:
            d["member"] = self.member
        if self.detail:
            d["detail"] = self.detail
        return d

    @staticmethod
    def from_dict(d: dict) -> "HealthFinding":
        v, t = d.get("value"), d.get("target")
        return HealthFinding(
            rule=d.get("rule", ""), key=d.get("key", ""),
            severity=d.get("severity", "degraded"),
            kind=d.get("kind", "slo"),
            value=float("nan") if v is None else float(v),
            target=float("nan") if t is None else float(t),
            burn_fast=float(d.get("burn_fast", 0.0)),
            burn_slow=float(d.get("burn_slow", 0.0)),
            member=d.get("member", ""), detail=d.get("detail", ""))


@dataclass(frozen=True)
class HealthVerdict:
    """The one ops answer: status + the findings that justify it."""

    status: str = "ok"           # ok | degraded | critical
    findings: tuple = ()
    t: float = 0.0

    @property
    def ok(self) -> bool:
        return self.status == "ok"

    def to_jsonable(self) -> dict:
        return {"status": self.status, "ok": self.ok,
                "t": round(self.t, 3),
                "findings": [f.to_dict() for f in self.findings]}


# preallocated disabled-path singletons (zero-cost pin in test_health)
NULL_VERDICT = HealthVerdict()
_EMPTY_GAUGES: dict = {}


def _worse(a: str, b: str) -> str:
    return a if _SEVERITIES.index(a) >= _SEVERITIES.index(b) else b


# -- wire helpers -----------------------------------------------------------
# rpc/protocol.py frames are FLAT dicts (scalars/strings/arrays only),
# so findings cross the wire as one JSON string — no version bump.
def verdict_to_wire(v: HealthVerdict) -> dict:
    return {"status": v.status, "ok": v.ok,
            "n_findings": len(v.findings), "t": float(v.t),
            "findings_json": json.dumps([f.to_dict()
                                         for f in v.findings])}


def verdict_from_wire(reply: dict) -> HealthVerdict:
    findings = tuple(HealthFinding.from_dict(d) for d in
                     json.loads(reply.get("findings_json", "[]")))
    return HealthVerdict(status=str(reply.get("status", "ok")),
                         findings=findings,
                         t=float(reply.get("t", 0.0)))


# -- fixed-capacity time series --------------------------------------------
class SeriesRing:
    """Drop-oldest ring of (t, value) samples — O(1) push, bounded
    memory regardless of run length (same discipline as tracing's span
    ring)."""

    __slots__ = ("cap", "_t", "_v", "n")

    def __init__(self, cap: int):
        self.cap = max(int(cap), 1)
        self._t = [0.0] * self.cap
        self._v = [0.0] * self.cap
        self.n = 0

    def push(self, t: float, v: float) -> None:
        i = self.n % self.cap
        self._t[i] = t
        self._v[i] = v
        self.n += 1

    def __len__(self) -> int:
        return min(self.n, self.cap)

    def items(self) -> list[tuple[float, float]]:
        """Oldest-first (t, v) pairs currently held."""
        if self.n <= self.cap:
            return list(zip(self._t[:self.n], self._v[:self.n]))
        i = self.n % self.cap
        return (list(zip(self._t[i:], self._v[i:]))
                + list(zip(self._t[:i], self._v[:i])))

    def last(self) -> tuple[float, float] | None:
        if self.n == 0:
            return None
        i = (self.n - 1) % self.cap
        return (self._t[i], self._v[i])


# -- rule evaluation (pure functions over window slices) --------------------
def _window(items: list, now: float, span: float) -> list:
    return [(t, v) for t, v in items if now - t <= span]


def _burn(items: list, rule: SLORule, now: float, span: float) -> float:
    """Burn rate of one window: violating-sample fraction / budget."""
    w = _window(items, now, span)
    if rule.mode == "rate_above":
        if len(w) < 2:
            return 0.0
        viol = n = 0
        for (t0, v0), (t1, v1) in zip(w, w[1:]):
            n += 1
            if (v1 - v0) / max(t1 - t0, 1e-9) > rule.target:
                viol += 1
        frac = viol / n
    else:
        if not w:
            return 0.0
        if rule.mode == "above":
            viol = sum(1 for _, v in w if v > rule.target)
        else:
            viol = sum(1 for _, v in w if v < rule.target)
        frac = viol / len(w)
    return frac / max(rule.budget, 1e-9)


def _median(vals: list[float]) -> float:
    s = sorted(vals)
    m = len(s) // 2
    return s[m] if len(s) % 2 else 0.5 * (s[m - 1] + s[m])


def _trend_hit(items: list, rule: TrendRule, now: float,
               span: float) -> tuple[bool, float, float]:
    """-> (fired, latest_value, reference_value)."""
    w = _window(items, now, span)
    if len(w) < rule.min_points:
        return (False, float("nan"), float("nan"))
    vals = [v for _, v in w]
    last = vals[-1]
    if rule.kind == "monotonic_growth":
        mono = all(b >= a for a, b in zip(vals, vals[1:]))
        base = vals[0]
        grew = last >= rule.ratio * base if base > 0 else last > 0
        return (mono and last > base and grew, last, base)
    med = _median(vals[:-1])
    if rule.kind == "drift":
        # the floor gates materiality: windowed p99s of a fast series
        # fluctuate multiplicatively (a scrape window holds only a
        # handful of samples), so a ratio alone fires on quantization
        # noise — creep counts once the level itself matters
        return (med > 0 and last > rule.floor
                and last > rule.ratio * med, last, med)
    # collapse: was genuinely flowing (median above floor), now dead
    return (med > rule.floor and last < rule.ratio * med, last, med)


# -- per-process monitor ----------------------------------------------------
class HealthMonitor:
    """Samples watched gauges / histogram deltas into rings and reduces
    the declarative rules to one local ``HealthVerdict``.

    One lock guards all mutable structures — ``sample`` runs on the
    owner's telemetry cadence while ``verdict`` answers the ``health``
    RPC from serve threads. Only keys matched by some rule/trend
    pattern are stored (bounded memory, no per-sample allocation for
    unwatched keys); when the module is disabled every entry point is
    a single flag branch returning preallocated constants.
    """

    def __init__(self, rules: tuple = (), trends: tuple = (),
                 name: str = "", ring_capacity: int | None = None):
        # RLock: the _watched/_push helpers re-acquire lexically under
        # callers that already hold it (lock-discipline pass idiom)
        self._lock = threading.RLock()
        self.name = name
        self.rules = tuple(rules)
        self.trends = tuple(trends)
        self._cap = int(ring_capacity) if ring_capacity else _RING_CAP
        self._patterns = tuple(sorted({r.key for r in self.rules}
                                      | {t.key for t in self.trends}))
        self._watch_cache: dict[str, bool] = {}
        self._series: dict[str, SeriesRing] = {}
        self._rule_state: dict[tuple, bool] = {}  # (rule, key) -> active
        self._prev_snaps: dict = {}
        self._n_samples = 0
        self._last_verdict = NULL_VERDICT

    def _watched(self, key: str) -> bool:
        with self._lock:
            hit = self._watch_cache.get(key)
            if hit is None:
                hit = any(fnmatch.fnmatchcase(key, p)
                          for p in self._patterns)
                self._watch_cache[key] = hit
            return hit

    def sample(self, gauges: dict | None = None,
               hists: dict | None = None,
               t: float | None = None) -> None:
        """Record one sampling tick. ``gauges`` is a flat name→scalar
        dict (e.g. ``telemetry_summary()``); ``hists`` maps series
        prefix → cumulative ``Histogram`` *snapshot* — each is diffed
        against the previous snapshot and the window's p99 lands in the
        ``{prefix}_p99`` series, OVERWRITING any cumulative gauge of
        the same name sampled this tick (windowed beats
        since-process-start for alerting)."""
        if not ENABLED:
            return
        if t is None:
            t = time.monotonic()
        with self._lock:
            # keys a histogram feeds are OWNED by the windowed path:
            # pushing the cumulative gauge too would pin the ring at the
            # since-start p99 (one bad era then violates forever), and
            # a quiet window must age out to nothing — not fall back to
            # the cumulative value — for its rule to clear
            owned = {name + "_p99" for name in hists} if hists else set()
            if gauges:
                for k, v in gauges.items():
                    if k in owned:
                        continue
                    if isinstance(v, (int, float)) and self._watched(k):
                        self._push(k, t, float(v))
            if hists:
                for name, snap in hists.items():
                    prev = self._prev_snaps.get(name)
                    self._prev_snaps[name] = snap
                    key = name + "_p99"
                    if not self._watched(key):
                        continue
                    win = snap.delta(prev) if prev is not None else snap
                    if win.count:
                        self._push(key, t, win.percentile(0.99))
            self._n_samples += 1

    def _push(self, key: str, t: float, v: float) -> None:
        with self._lock:
            ring = self._series.get(key)
            if ring is None:
                ring = self._series[key] = SeriesRing(self._cap)
            ring.push(t, v)

    def verdict(self, t: float | None = None) -> HealthVerdict:
        """Evaluate every rule against the current rings. SLO rules
        are stateful: fire when both windows burn ≥ 1, stay active
        until the fast window cools below ``clear_ratio`` (hysteresis —
        a rule flapping around burn=1 does not flap the verdict)."""
        if not ENABLED:
            return NULL_VERDICT
        if t is None:
            t = time.monotonic()
        findings: list[HealthFinding] = []
        with self._lock:
            keys = list(self._series)
            for rule in self.rules:
                fast = rule.fast_window_s or _FAST_WINDOW_S
                slow = rule.slow_window_s or _SLOW_WINDOW_S
                clear = (rule.clear_ratio if rule.clear_ratio
                         is not None else _CLEAR_RATIO)
                for key in keys:
                    if not fnmatch.fnmatchcase(key, rule.key):
                        continue
                    items = self._series[key].items()
                    bf = _burn(items, rule, t, fast)
                    bs = _burn(items, rule, t, slow)
                    sid = (rule.name, key)
                    active = self._rule_state.get(sid, False)
                    if active:
                        active = bf >= clear
                    else:
                        active = bf >= 1.0 and bs >= 1.0
                    self._rule_state[sid] = active
                    if active:
                        last = self._series[key].last()
                        findings.append(HealthFinding(
                            rule=rule.name, key=key,
                            severity=rule.severity, kind="slo",
                            value=last[1] if last else float("nan"),
                            target=rule.target,
                            burn_fast=bf, burn_slow=bs))
            for trend in self.trends:
                slow = _SLOW_WINDOW_S
                for key in keys:
                    if not fnmatch.fnmatchcase(key, trend.key):
                        continue
                    hit, last, ref = _trend_hit(
                        self._series[key].items(), trend, t, slow)
                    if hit:
                        findings.append(HealthFinding(
                            rule=trend.name, key=key,
                            severity=trend.severity, kind="trend",
                            value=last, target=ref,
                            detail=trend.kind))
            status = "ok"
            for f in findings:
                status = _worse(status, f.severity)
            v = HealthVerdict(status, tuple(findings), t)
            self._last_verdict = v
            return v

    def gauges(self) -> dict[str, float]:
        """Monitor self-accounting for the metrics spine."""
        if not ENABLED:
            return _EMPTY_GAUGES
        with self._lock:
            v = self._last_verdict
            return {"health/samples": float(self._n_samples),
                    "health/series": float(len(self._series)),
                    "health/findings": float(len(v.findings)),
                    "health/degraded": float(v.status == "degraded"),
                    "health/critical": float(v.status == "critical")}

    def scrape(self, gauges: dict | None = None,
               hists: dict | None = None,
               t: float | None = None) -> dict:
        """sample + verdict + wire encode in one call — the body of the
        servers' ``health`` RPC verb."""
        if not ENABLED:
            return verdict_to_wire(NULL_VERDICT)
        self.sample(gauges, hists, t)
        return verdict_to_wire(self.verdict(t))


# -- fleet aggregation ------------------------------------------------------
class FleetHealth:
    """Supervisor-side aggregator: scrapes every registered member's
    ``health`` endpoint (an in-process callable or an RPC client bound
    method, both returning the flat wire dict) into ONE fleet verdict —
    worst-of member statuses, findings tagged with their member, and an
    unreachable member itself a degraded finding (a health plane that
    goes silent is not healthy)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._members: dict[str, object] = {}
        self._fleet_verdict = NULL_VERDICT
        self._scrape_errors = 0

    def register(self, name: str, scrape_fn) -> None:
        with self._lock:
            self._members[name] = scrape_fn

    def deregister(self, name: str) -> bool:
        """Drop a member from the scrape set — the elastic-fleet leave
        path (actors/membership.py): a host that handed its shard off
        and left ON PURPOSE must stop burning the unreachable budget.
        Returns False if the name was never registered."""
        with self._lock:
            return self._members.pop(name, None) is not None

    def scrape(self, t: float | None = None) -> HealthVerdict:
        if not ENABLED:
            return NULL_VERDICT
        if t is None:
            t = time.monotonic()
        with self._lock:
            members = list(self._members.items())
        findings: list[HealthFinding] = []
        status = "ok"
        for name, fn in members:
            try:
                wire = fn()
                mv = verdict_from_wire(wire)
            except Exception as e:  # noqa: BLE001 — member down IS the signal
                with self._lock:
                    self._scrape_errors += 1
                findings.append(HealthFinding(
                    rule="member_unreachable", key=name,
                    severity="degraded", kind="fleet", member=name,
                    detail=f"{type(e).__name__}: {e}"))
                status = _worse(status, "degraded")
                continue
            status = _worse(status, mv.status)
            for f in mv.findings:
                findings.append(HealthFinding(
                    rule=f.rule, key=f.key, severity=f.severity,
                    kind=f.kind, value=f.value, target=f.target,
                    burn_fast=f.burn_fast, burn_slow=f.burn_slow,
                    member=name, detail=f.detail))
        v = HealthVerdict(status, tuple(findings), t)
        with self._lock:
            self._fleet_verdict = v
        return v

    def last(self) -> HealthVerdict:
        with self._lock:
            return self._fleet_verdict

    def gauges(self) -> dict[str, float]:
        if not ENABLED:
            return _EMPTY_GAUGES
        with self._lock:
            v = self._fleet_verdict
            return {"health/members": float(len(self._members)),
                    "health/scrape_errors": float(self._scrape_errors),
                    "health/findings": float(len(v.findings)),
                    "health/degraded": float(v.status == "degraded"),
                    "health/critical": float(v.status == "critical")}


# -- default rule sets ------------------------------------------------------
def default_server_rules() -> tuple:
    """Replay feed server SLOs. ``wire_integrity`` is the chaos gate's
    trigger: a CRC-rejected frame rate above zero burns the budget
    deterministically under an injected corrupt fault."""
    return (
        SLORule(name="wire_integrity", key="rpc/checksum_errors",
                target=0.0, mode="rate_above", budget=0.05),
        SLORule(name="flush_p99", key="rpc/add_transitions_ms_p99",
                target=250.0, mode="above", budget=0.25),
        SLORule(name="credit_starvation", key="flow/credit_starvation",
                target=0.5, mode="above", budget=0.5),
        SLORule(name="ingest_shed", key="rpc/shed_flushes",
                target=0.0, mode="rate_above", budget=0.5),
    )


def default_server_trends() -> tuple:
    return (
        TrendRule(name="staged_growth", key="queue/staged_rows",
                  kind="monotonic_growth", ratio=2.0, min_points=6),
        TrendRule(name="ingest_collapse", key="flow/ingest_rate",
                  kind="collapse", ratio=0.2, floor=1.0),
        # floor: a tenth of the tightest latency SLO on these keys —
        # sub-floor windowed p99s are sample-count quantization, not
        # creep, and would otherwise flap the fleet verdict under
        # perfectly healthy sub-millisecond traffic
        TrendRule(name="rpc_p99_drift", key="rpc/*_ms_p99",
                  kind="drift", ratio=3.0, min_points=6, floor=25.0),
    )


def default_inference_rules() -> tuple:
    return (
        SLORule(name="infer_latency", key="inference/latency_ms_p99",
                target=50.0, mode="above", budget=0.25),
        SLORule(name="infer_shed", key="inference/sheds",
                target=0.0, mode="rate_above", budget=0.5),
    )


def default_tenant_rules() -> tuple:
    """Per-tenant serving SLOs. Keys are fnmatch patterns
    over the dynamic ``tenant/<tag>/*`` gauge surface, so a finding
    NAMES the tenant that burned its budget via the matched key — the
    chaos gate asserts the verdict JSONL carries those names."""
    return (
        SLORule(name="tenant_latency", key="tenant/*/latency_ms_p99",
                target=50.0, mode="above", budget=0.25),
        SLORule(name="tenant_shed", key="tenant/*/sheds",
                target=0.0, mode="rate_above", budget=0.5),
    )


def default_inference_trends() -> tuple:
    return (
        TrendRule(name="infer_queue_growth", key="inference/queued_rows",
                  kind="monotonic_growth", ratio=2.0, min_points=6),
    )


def default_learn_rules() -> tuple:
    """Learning-dynamics SLOs (the learn-metrics plane's ``learn/*``
    gauges). A non-finite loss is the one hard divergence fact — any
    sustained rate of NaN/inf steps is critical; everything softer is a
    trend below."""
    return (
        SLORule(name="loss_nonfinite", key="learn/loss_nonfinite",
                target=0.0, mode="above", budget=0.25,
                severity="critical"),
    )


def default_learn_trends() -> tuple:
    """Targetless divergence detectors over the learner's own dynamics.
    ``loss_divergence`` is the chaos gate's named finding (an lr spike
    must walk the fleet verdict ok → degraded → ok —
    scripts/chaos_smoke.py divergence mode)."""
    return (
        TrendRule(name="loss_divergence", key="learn/loss",
                  kind="drift", ratio=5.0, min_points=4),
        TrendRule(name="loss_collapse", key="learn/loss",
                  kind="collapse", ratio=0.02, floor=1e-5),
        TrendRule(name="grad_norm_spike", key="learn/grad_norm",
                  kind="drift", ratio=10.0, min_points=4),
        TrendRule(name="q_overestimation", key="learn/q_max",
                  kind="monotonic_growth", ratio=3.0, min_points=6),
        TrendRule(name="priority_collapse", key="learn/prio_mean",
                  kind="collapse", ratio=0.05, floor=1e-5),
    )
