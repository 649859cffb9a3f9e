"""Metric-name / span-name registry cross-check.

Every gauge/counter/histogram the observability spine emits is read
back BY NAME — ``telemetry_report.py``'s section filters, the health
rules, the PERF tables. A typo at an emit site doesn't fail;
the series silently vanishes from every report (emitted under one name,
read under another). This pass pins the names:

- ``REGISTRY`` declares every metric name the repo emits or reads as a
  string literal: the namespaced ``<ns>/...`` keys and the bare
  counters.
- Any string literal matching a metric namespace (``rpc/…``,
  ``trace/…``, …) anywhere in the port package, its tool modules
  included (the twins of the reference's ``scripts/``), must be
  declared → ``metric_keys.unknown-metric``. The port's ``bench.py``
  is one of those tool modules, as the reference scans its root
  ``bench.py``.
- The first argument of ``metrics.count/gauge/observe/observe_many/
  histogram`` — when a literal — must be declared too (covers bare
  names like ``grad_steps`` that carry no namespace).
- Span/instant names at ``tracing.span/span_sampled/instant`` call
  sites must exist in the tracer's tables (parsed from ``tracing.py``'s
  AST, no import): a span's in ``STAGES`` or the port's own
  ``PORT_STAGES``, an instant's in ``EVENTS`` →
  ``metric_keys.unknown-span``.

Dynamic keys (f-strings such as ``f"rpc/{m}_calls"``) are out of
static reach and deliberately skipped — their PREFIX constants don't
match the namespace pattern (no name tail). Histogram summary suffixes
(``_count/_mean/_p50/_p95/_p99/_max``) expand from a declared prefix at
runtime and are not separate entries. Tests are not scanned (they
invent names freely).
"""

from __future__ import annotations

import ast
import os
import re

from distributed_deep_q_tpu_torch.analysis.core import (
    Finding, Source, dotted, load_sources, package_files, pkg)

RULE_METRIC = "metric_keys.unknown-metric"
RULE_SPAN = "metric_keys.unknown-span"

NAMESPACES = ("rpc", "fleet", "queue", "durability", "flow", "trace",
              "learner", "ingest", "inference", "shard", "actor",
              "health", "train", "learn", "autoscale", "tenant")
_NS_RE = re.compile(r"^(?:%s)/.+" % "|".join(NAMESPACES))

EMITTERS = frozenset(
    {"count", "gauge", "observe", "observe_many", "histogram"})
# each span function's name tables (any one of them holds a valid name)
SPAN_FNS = {"span": ("STAGES", "PORT_STAGES"),
            "span_sampled": ("STAGES", "PORT_STAGES"),
            "instant": ("EVENTS",)}

# every metric name that appears as a string literal — emit sites,
# report-side reads, and registry-keyed tables. One source of truth;
# adding a metric means adding its name here (that is the point).
REGISTRY = frozenset({
    # bare throughput counters (Metrics.count / rate)
    "env_steps",
    "grad_steps",
    # rpc server telemetry (scalar keys; per-method f-string keys are
    # dynamic and unchecked — except names a reader spells out as a
    # literal, which are declared so the read side stays registered)
    "rpc/add_transitions_calls",
    "rpc/checksum_errors",
    "rpc/conn_timeouts",
    "rpc/dispatch_errors",
    "rpc/duplicate_flushes",
    "rpc/shed_flushes",
    # fleet (actor-side) histograms + liveness gauge
    "fleet/actors_seen",
    "fleet/env_step_ms",
    "fleet/heartbeat_rtt_ms",
    "fleet/param_pull_ms",
    # queue-depth gauges (the r5 ingest-OOM early-warning signals)
    "queue/params_version",
    "queue/params_version_lag",
    "queue/replay_size",
    "queue/staged_rows",
    # durability plane (ISSUE 6)
    "durability/generations",
    "durability/quarantined",
    "durability/snapshot_bytes",
    "durability/snapshot_capture_ms",
    "durability/snapshot_count",
    "durability/snapshot_skipped",
    "durability/snapshot_write_ms",
    # overload data plane (flow control)
    "flow/consume_rate",
    "flow/degraded",
    "flow/degraded_trips",
    "flow/ingest_rate",
    "flow/shed_total",
    # tracing plane (ISSUE 7): tracer counters + lineage histograms
    "trace/clock_skew_ms",
    "trace/ingest_lag_ms",
    "trace/skew_samples",
    "trace/spans_buffered",
    "trace/spans_dropped",
    # how the fused dispatches ran (Solver.dispatch_counters)
    "learner/eager_dispatches",
    "learner/graph_captures",
    "learner/graph_replays",
    "learner/publish_params_ms",
    "learner/time_to_learn_ms",
    # columnar ingest plane (ISSUE 8): drain-thread throughput gauges
    "ingest/drained_rows",
    "ingest/drain_flushes",
    # batched inference plane (ISSUE 9): histogram prefixes (summary
    # suffixes expand at runtime) + request/shed/queue counters
    "inference/latency_ms",
    "inference/batch_rows",
    "inference/forward_ms",
    "inference/requests",
    "inference/sheds",
    "inference/wire_errors",
    "inference/reply_timeouts",
    "inference/queued_rows",
    "inference/compiled_buckets",
    # multi-host sharded replay (ISSUE 10): per-shard data-plane gauges
    # — each learner process's server IS one shard, so these read as
    # shard fill / shard-local ingest rate / owning process index
    "shard/rows",
    "shard/ingest_rate",
    "shard/owner_host",
    # vectorized acting plane (ISSUE 11): histogram prefixes fed by the
    # vector actor's tm_* payload keys — whole-tick batched step ms,
    # batched-infer round trip + rows per RPC, auto-resets per flush
    "actor/vector_step_ms",
    "actor/infer_rtt_ms",
    "actor/vector_rows",
    "actor/auto_resets",
    # health & SLO plane (ISSUE 13): windowed p99 series the SLO rules
    # watch (``*_p99`` names are ring-sampled histogram-window deltas,
    # not cumulative summary suffixes), the starvation fraction gauge,
    # monitor/aggregator self-telemetry, and the fleet verdict key
    "flow/credit_starvation",
    "rpc/add_transitions_ms",
    "rpc/add_transitions_ms_p99",
    "rpc/*_ms_p99",
    "inference/latency_ms_p99",
    "health/samples",
    "health/series",
    "health/findings",
    "health/degraded",
    "health/critical",
    "health/members",
    "health/scrape_errors",
    "health/verdict",
    # live efficiency accounting (ISSUE 13): learner-loop gauges fed by
    # profiling.MFUMeter from per-window step rates + the flops census
    "train/steps_per_s",
    "train/mfu",
    "train/ingest_utilization",
    # learning-dynamics plane (ISSUE 16): learn/* gauges the on-device
    # metrics plane accumulates inside the fused-chain / Anakin scan
    # bodies (learning.LearnAccumulator.gauges) + the TD-|error|
    # histogram prefix (summary suffixes expand at runtime)
    "learn/loss",
    "learn/grad_norm",
    "learn/grad_norm_clipped",
    "learn/q_mean",
    "learn/q_max",
    "learn/td_mean",
    "learn/td_max",
    "learn/prio_mean",
    "learn/prio_max",
    "learn/is_weight_mean",
    "learn/is_weight_min",
    "learn/target_refreshes",
    "learn/loss_nonfinite",
    "learn/steps",
    "learn/td_error",
    # elastic-fleet plane (ISSUE 17): membership-registry gauges, the
    # shard-handoff receipt the churn gate + strict report consume, the
    # remap-storm reconnect counter, and the autoscaler's decision
    # record (a JSON list in the run JSONL) + its self-accounting
    "fleet/epoch",
    "fleet/members",
    "fleet/joins",
    "fleet/leaves",
    "fleet/lease_expired",
    "fleet/handoffs",
    "fleet/handoff_ms",
    "fleet/handoff_rows",
    "fleet/handoff_lost_rows",
    "rpc/mass_reconnects",
    "autoscale/decision",
    "autoscale/decisions",
    "autoscale/grow",
    "autoscale/shrink",
    "autoscale/cooldown_blocked",
    "autoscale/target_actors",
    "autoscale/target_inference",
    # autoscale executor (ISSUE 20): the applied-action record (a JSON
    # list next to autoscale/decision) + the executor's self-accounting
    # gauges the strict report audits against the scaler's targets
    "autoscale/applied",
    "autoscale/applied_actors",
    "autoscale/applied_actions",
    "autoscale/rollbacks",
    "autoscale/retirements",
    "autoscale/rate_limited",
    "autoscale/skipped",
    # multi-tenant inference plane (ISSUE 20): per-tag keys are dynamic
    # (f"tenant/{tag}/...", unchecked); the fleet aggregates, the
    # ladder gauges, and the fnmatch PATTERNS the tenant SLO rules
    # watch are the literal surface
    "tenant/requests",
    "tenant/sheds",
    "tenant/shadow_requests",
    "tenant/shadow_diverged",
    "tenant/swaps",
    "tenant/served",
    "tenant/ladder_level",
    "tenant/shed_shadow",
    "tenant/shed_ab",
    "tenant/shed_primary",
    "tenant/*/latency_ms_p99",
    "tenant/*/sheds",
})

_TRACING_REL = pkg("tracing.py")


def tracer_tables(tracing_src: Source) -> dict[str, frozenset[str]]:
    """``{"STAGES": {...}, "PORT_STAGES": {...}, "EVENTS": {...}}`` from
    module-level tuple assignments in tracing.py — AST only, the tracer
    is never imported."""
    out = {"STAGES": frozenset(), "PORT_STAGES": frozenset(),
           "EVENTS": frozenset()}
    for node in tracing_src.tree.body:
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            continue
        name = node.targets[0].id
        if name in out and isinstance(node.value, ast.Tuple):
            out[name] = frozenset(
                e.value for e in node.value.elts
                if isinstance(e, ast.Constant) and isinstance(e.value, str))
    return out


class _Walker:
    """Driven over ``Source.walk()`` — all calls first (claiming their
    literal args), then all constants — so the claim set is complete
    before any constant is judged."""

    def __init__(self, src: Source, registry: frozenset,
                 tables: dict[str, frozenset[str]], out: list[Finding]):
        self.src = src
        self.registry = registry
        self.tables = tables
        self.out = out
        # literals consumed by a span-name check are not ALSO metric
        # names; same for namespaced emitter args (the constant scan
        # reports those once)
        self._claimed: set[int] = set()

    def visit_Call(self, node: ast.Call) -> None:
        # cheap tail filter before building the dotted chain — almost
        # no call in the tree targets an emitter or span function
        func = node.func
        tail = (func.attr if isinstance(func, ast.Attribute)
                else func.id if isinstance(func, ast.Name) else None)
        if tail not in EMITTERS and tail not in SPAN_FNS:
            return
        name = dotted(node.func) or ""
        parts = name.split(".")
        arg = node.args[0] if node.args else None
        lit = (arg.value if isinstance(arg, ast.Constant)
               and isinstance(arg.value, str) else None)
        if parts[-1] in SPAN_FNS and "tracing" in parts and lit is not None:
            self._claimed.add(id(arg))
            tables = SPAN_FNS[parts[-1]]
            if not any(lit in self.tables[t] for t in tables):
                self.src.finding(
                    RULE_SPAN, node,
                    f"{parts[-1]}({lit!r}) is not in tracing."
                    f"{' or tracing.'.join(tables)} — add it to the "
                    "tracer's stage table or fix the name", self.out)
        elif parts[-1] in EMITTERS and any("metrics" in p.lower()
                                           for p in parts[:-1]) \
                and lit is not None and not _NS_RE.match(lit):
            # namespaced literals are handled by the constant scan
            self._claimed.add(id(arg))
            if lit not in self.registry:
                self.src.finding(
                    RULE_METRIC, node,
                    f"metric name {lit!r} is not declared in "
                    "analysis/metric_keys.py REGISTRY", self.out)

    def visit_Constant(self, node: ast.Constant) -> None:
        if isinstance(node.value, str) and id(node) not in self._claimed \
                and _NS_RE.match(node.value) \
                and node.value not in self.registry:
            self.src.finding(
                RULE_METRIC, node,
                f"metric name {node.value!r} is not declared in "
                "analysis/metric_keys.py REGISTRY", self.out)


def check_sources(sources: list[Source], tracing_src: Source,
                  registry: frozenset = REGISTRY) -> list[Finding]:
    tables = tracer_tables(tracing_src)
    out: list[Finding] = []
    for src in sources:
        walker = _Walker(src, registry, tables, out)
        for node in src.nodes(ast.Call):
            walker.visit_Call(node)
        for node in src.nodes(ast.Constant):
            walker.visit_Constant(node)
    return out


def check(repo_root: str,
          registry: frozenset = REGISTRY) -> list[Finding]:
    srcs = load_sources(repo_root, package_files(repo_root))
    tracing_src = next(
        (s for s in srcs
         if s.path.replace(os.sep, "/") == _TRACING_REL), None)
    if tracing_src is None:
        tracing_src = Source.load(os.path.join(repo_root, _TRACING_REL),
                                  _TRACING_REL)
    return check_sources(srcs, tracing_src, registry)
