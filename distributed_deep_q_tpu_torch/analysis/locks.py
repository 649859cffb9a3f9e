"""Lock-discipline checker + static lock-order deadlock detection.

The RPC plane's correctness rests on invariants like "the flush-seq
dedup map is only touched under ``replay_lock``" — comments until now.
This pass makes them machine-checked:

- ``LockRegistry`` maps guarded attributes to the lock that owns them.
  A guard names the attribute, the lock, the owning class (scopes
  ``self.X`` checks), and the receiver expressions it applies to —
  ``server.env_steps`` in the learner loop is checked, ``cfg.replay``
  is not (same attribute name, unrelated object).
- Any read/write of a guarded attribute outside a ``with <lock>:``
  block on the SAME receiver is a ``locks.unguarded`` finding.
  ``with`` nesting is lexical: a lambda inside ``with self._cv:`` (the
  ``wait_for`` predicate) counts as held. Construction/restore methods
  that run before any other thread exists are exempted by name.
- Module-level globals guarded by a module lock (``native/__init__.py``
  builds the ctypes lib under ``_lock``) use the per-file ``globals``
  table.
- A lock-ORDER graph is built from lexically nested ``with`` blocks
  over known lock names; a cycle is a static deadlock →
  ``locks.order-cycle``.
- Condition-variable discipline (the registry's ``conditions`` set
  names which lock attrs are CVs): a ``<cv>.wait(...)`` not lexically
  inside a ``while`` loop is ``locks.cv-wait-no-loop`` — a woken
  waiter must re-check its predicate (spurious wakeups, stolen
  wakeups, timeouts); ``wait_for`` carries its predicate and is
  exempt. A ``notify``/``notify_all`` without lexically holding the
  owning CV is ``locks.cv-notify-unheld`` (it raises at runtime, but
  only on the path that reaches it).

Registering a new guarded field = one line in ``DEFAULT_REGISTRY``.

The port's registry starts from the reference's and describes the port:
every guard, condition and module-global table of a class the port has,
plus the locks only the port has (``BatchedPolicy._lock``, the
``FusedStepStream`` dispatch lock) and the module-global and small-class
locks the reference leaves unregistered (the tracer's id, ring-registry
and skew locks, the chaos plan's counters, the credit bucket, the
mass-reconnect counter, the CRC power table). A lock that guards no
attribute of its own is listed in ``bare`` with the reason, a
serialization token (held across slow work on purpose) in ``tokens``,
so every lock the port's non-tool modules build is named here (a test
holds the registry to that).
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field

from distributed_deep_q_tpu_torch.analysis.core import (
    Finding, Source, dotted, load_sources, pkg)

RULE_UNGUARDED = "locks.unguarded"
RULE_CYCLE = "locks.order-cycle"
RULE_CV_WAIT = "locks.cv-wait-no-loop"
RULE_CV_NOTIFY = "locks.cv-notify-unheld"


@dataclass(frozen=True)
class Guard:
    """One guarded attribute: which lock, whose attribute, which
    receiver expressions the check applies to."""

    lock: str                       # lock attribute name on the receiver
    owner: str                      # class that owns the attribute
    receivers: tuple[str, ...] = ("self",)  # dotted receivers to check


@dataclass
class LockRegistry:
    attrs: dict[str, Guard] = field(default_factory=dict)
    # file-suffix → {global name → module-level lock name}
    globals: dict[str, dict[str, str]] = field(default_factory=dict)
    # methods that run single-threaded (construction / warm boot — the
    # generational restore helpers run before the listener opens)
    unlocked_methods: frozenset = frozenset(
        {"__init__", "_restore", "_load_generation", "_reset_boot_state"})
    # repo-relative files this pass walks
    files: tuple[str, ...] = ()
    # lock attrs that are threading.Condition objects — their wait/
    # notify calls get the CV-discipline rules
    conditions: frozenset = frozenset()
    # locks that guard no attribute of their own: (repo-relative file,
    # owning class, lock name) → why. They are lock names all the same
    # (a blocking call under one is a finding)
    bare: dict[tuple[str, str, str], str] = field(default_factory=dict)
    # serialization tokens: (file, owning class, lock name) → why. Held
    # across slow work on purpose, so NOT lock names (``blocking`` would
    # invert their design)
    tokens: dict[tuple[str, str, str], str] = field(default_factory=dict)

    def lock_names(self) -> set[str]:
        names = {g.lock for g in self.attrs.values()}
        names.update(self.conditions)  # a CV is a lock when entered
        for table in self.globals.values():
            names.update(table.values())
        names.update(lock for _, _, lock in self.bare)
        return names


DEFAULT_REGISTRY = LockRegistry(
    attrs={
        # ReplayFeedServer ingest state — counters, dedup map, and the
        # buffer itself move together under replay_lock
        "env_steps":        Guard("replay_lock", "ReplayFeedServer",
                                  ("self", "server")),
        "episodes":         Guard("replay_lock", "ReplayFeedServer",
                                  ("self", "server")),
        "returns":          Guard("replay_lock", "ReplayFeedServer",
                                  ("self", "server")),
        "replay":           Guard("replay_lock", "ReplayFeedServer",
                                  ("self", "server")),
        "_flush_seq":       Guard("replay_lock", "ReplayFeedServer",
                                  ("self", "server")),
        # lineage stamps (tracing plane): slot → (birth, insert position)
        # moves with the ring inserts it describes
        "_lineage":         Guard("replay_lock", "ReplayFeedServer",
                                  ("self", "server")),
        # published θ frame
        "_params_wire":     Guard("_params_lock", "ReplayFeedServer"),
        "_params_version":  Guard("_params_lock", "ReplayFeedServer"),
        # live connection set + rate-limited error log state
        "_conns":           Guard("_conns_lock", "ReplayFeedServer"),
        "_err_log_at":      Guard("_conns_lock", "ReplayFeedServer"),
        "_err_suppressed":  Guard("_conns_lock", "ReplayFeedServer"),
        # in-flight dispatch count — the shutdown drain condition
        "_inflight":        Guard("_inflight_cv", "ReplayFeedServer"),
        # ServerTelemetry: every structure is touched from every serve
        # thread; one lock guards them all
        "method_calls":     Guard("_lock", "ServerTelemetry",
                                  ("self", "server.telemetry")),
        "method_lat":       Guard("_lock", "ServerTelemetry",
                                  ("self", "server.telemetry")),
        "method_bytes":     Guard("_lock", "ServerTelemetry",
                                  ("self", "server.telemetry")),
        "fleet":            Guard("_lock", "ServerTelemetry",
                                  ("self", "server.telemetry")),
        "actor_env_steps":  Guard("_lock", "ServerTelemetry",
                                  ("self", "server.telemetry")),
        "last_pulled_version": Guard("_lock", "ServerTelemetry",
                                     ("self", "server.telemetry")),
        "dispatch_errors":  Guard("_lock", "ServerTelemetry",
                                  ("self", "server.telemetry")),
        "duplicate_flushes": Guard("_lock", "ServerTelemetry",
                                   ("self", "server.telemetry")),
        "shed_flushes":     Guard("_lock", "ServerTelemetry",
                                  ("self", "server.telemetry")),
        "actor_sheds":      Guard("_lock", "ServerTelemetry",
                                  ("self", "server.telemetry")),
        "conn_timeouts":    Guard("_lock", "ServerTelemetry",
                                  ("self", "server.telemetry")),
        "ingest_lag":       Guard("_lock", "ServerTelemetry",
                                  ("self", "server.telemetry")),
        # durability plane gauges (ISSUE 6): CRC rejections + snapshot
        # cadence/stall/quarantine counters
        "checksum_errors":  Guard("_lock", "ServerTelemetry",
                                  ("self", "server.telemetry")),
        "snapshot_count":   Guard("_lock", "ServerTelemetry",
                                  ("self", "server.telemetry")),
        "snapshot_skipped": Guard("_lock", "ServerTelemetry",
                                  ("self", "server.telemetry")),
        "snapshot_capture_ms": Guard("_lock", "ServerTelemetry",
                                     ("self", "server.telemetry")),
        "snapshot_write_ms": Guard("_lock", "ServerTelemetry",
                                   ("self", "server.telemetry")),
        "snapshot_bytes":   Guard("_lock", "ServerTelemetry",
                                  ("self", "server.telemetry")),
        "snapshot_generations": Guard("_lock", "ServerTelemetry",
                                      ("self", "server.telemetry")),
        "snapshot_quarantined": Guard("_lock", "ServerTelemetry",
                                      ("self", "server.telemetry")),
        # FlowController overload state shares the server's replay_lock so
        # admission is atomic with the insert it gates
        "credits":          Guard("replay_lock", "FlowController"),
        "degraded":         Guard("replay_lock", "FlowController"),
        "degraded_trips":   Guard("replay_lock", "FlowController"),
        "shed_total":       Guard("replay_lock", "FlowController"),
        # IngestDrain (columnar ingest plane, ISSUE 8): the drain
        # thread's stop flag, throughput counters, and recorded death
        # move under its condition variable. The staging buffers
        # themselves (ColumnStage) carry no lock — they are serialized
        # by the caller's replay lock, which the drain re-acquires for
        # every flush (same mutual exclusion as the inline path)
        "_stop":            Guard("_cv", "IngestDrain"),
        "_drained_rows":    Guard("_cv", "IngestDrain"),
        "_drain_flushes":   Guard("_cv", "IngestDrain"),
        "_err":             Guard("_cv", "IngestDrain"),
        # InferenceServer (ISSUE 9): the microbatch queue — pending
        # request slots, the row gauge admission reads, and the shutdown
        # flag — moves under one condition the batcher sleeps on.
        # (_params_version is registered above for ReplayFeedServer;
        # InferenceServer's copy under its own _params_lock follows the
        # same discipline but the registry keys by attribute name)
        "_pending":         Guard("_cv", "InferenceServer"),
        "_queued_rows":     Guard("_cv", "InferenceServer"),
        "_closed":          Guard("_cv", "InferenceServer"),
        # degrade ladder (ISSUE 20): level + hysteresis stamps + the
        # first-shed ledger move under the SAME condition as the row
        # gauge the occupancy is computed from
        "_ladder_level":    Guard("_cv", "InferenceServer"),
        "_ladder_rise_since": Guard("_cv", "InferenceServer"),
        "_ladder_fall_since": Guard("_cv", "InferenceServer"),
        "_ladder_ledger":   Guard("_cv", "InferenceServer"),
        "_first_shed":      Guard("_cv", "InferenceServer"),
        # tenant registry (ISSUE 20): tag → _Tenant map and the cached
        # A/B arm tuple move with the θ installs they key (helpers
        # re-acquire the RLock lexically)
        "_tenants":         Guard("_params_lock", "InferenceServer"),
        "_active_arms":     Guard("_params_lock", "InferenceServer"),
        # InferenceTelemetry: every histogram/counter is touched from
        # every serve thread plus the batcher; one lock guards them all
        "requests":         Guard("_lock", "InferenceTelemetry"),
        "sheds":            Guard("_lock", "InferenceTelemetry"),
        "wire_errors":      Guard("_lock", "InferenceTelemetry"),
        "reply_timeouts":   Guard("_lock", "InferenceTelemetry"),
        "latency_ms":       Guard("_lock", "InferenceTelemetry"),
        "batch_rows":       Guard("_lock", "InferenceTelemetry"),
        "forward_ms":       Guard("_lock", "InferenceTelemetry"),
        "tenant_counts":    Guard("_lock", "InferenceTelemetry"),
        "tenant_latency":   Guard("_lock", "InferenceTelemetry"),
        # HealthMonitor (ISSUE 13): rings, rule hysteresis state, prev
        # histogram snapshots, and the cached verdict are written on the
        # telemetry cadence and read from serve threads answering the
        # ``health`` RPC — one RLock guards them all (helpers re-acquire
        # lexically)
        "_series":          Guard("_lock", "HealthMonitor"),
        "_rule_state":      Guard("_lock", "HealthMonitor"),
        "_prev_snaps":      Guard("_lock", "HealthMonitor"),
        "_watch_cache":     Guard("_lock", "HealthMonitor"),
        "_n_samples":       Guard("_lock", "HealthMonitor"),
        "_last_verdict":    Guard("_lock", "HealthMonitor"),
        # FleetHealth: member table + aggregate verdict cross the
        # supervisor loop and whoever reads last()/gauges()
        "_members":         Guard("_lock", "FleetHealth"),
        "_scrape_errors":   Guard("_lock", "FleetHealth"),
        "_fleet_verdict":   Guard("_lock", "FleetHealth"),
        # LearnAccumulator (ISSUE 16): cumulative + window planes and
        # the cached gauge dict — ``ingest`` runs on the training loop's
        # dispatch cadence while ``gauges``/``hist_snapshot`` answer the
        # supervisor log tick and the fleet's health scrape thread
        "_lm_total":        Guard("_lm_lock", "LearnAccumulator"),
        "_lm_window":       Guard("_lm_lock", "LearnAccumulator"),
        "_lm_planes":       Guard("_lm_lock", "LearnAccumulator"),
        "_lm_last":         Guard("_lm_lock", "LearnAccumulator"),
        # MembershipRegistry (ISSUE 17): the epoch-numbered host set,
        # shard lineage, and churn counters move together — serve
        # threads answering fleet_* verbs race the supervisor's gauge
        # reads and the lease sweeper
        "_fleet_members":   Guard("_fleet_lock", "MembershipRegistry"),
        "_fleet_epoch":     Guard("_fleet_lock", "MembershipRegistry"),
        "_fleet_lineage":   Guard("_fleet_lock", "MembershipRegistry"),
        "_fleet_stats":     Guard("_fleet_lock", "MembershipRegistry"),
        # Autoscaler (ISSUE 17): targets, streak, cooldown stamps, and
        # decision counters under one RLock (helpers re-acquire
        # lexically, HealthMonitor precedent)
        "_as_target_actors": Guard("_as_lock", "Autoscaler"),
        "_as_target_inference": Guard("_as_lock", "Autoscaler"),
        "_as_ok_streak":    Guard("_as_lock", "Autoscaler"),
        "_as_last_at":      Guard("_as_lock", "Autoscaler"),
        "_as_counts":       Guard("_as_lock", "Autoscaler"),
        # ActorSupervisor (ISSUE 20): the fleet became elastic — the
        # process map and its counters race the watch loop against the
        # autoscale executor's grow/retire
        "procs":            Guard("_procs_lock", "ActorSupervisor"),
        "spawned_at":       Guard("_procs_lock", "ActorSupervisor"),
        "retired":          Guard("_procs_lock", "ActorSupervisor"),
        "restarts":         Guard("_procs_lock", "ActorSupervisor"),
        "kill_escalations": Guard("_procs_lock", "ActorSupervisor"),
        "executor_terminations": Guard("_procs_lock", "ActorSupervisor"),
        # ScaleExecutor (ISSUE 20): applied-action counters, the rate-
        # limit stamp, and grows inside their grace window
        "_ex_counts":       Guard("_ex_lock", "ScaleExecutor"),
        "_ex_last_apply":   Guard("_ex_lock", "ScaleExecutor"),
        "_ex_pending_grows": Guard("_ex_lock", "ScaleExecutor"),
        # BatchedPolicy (port only): functional_call swaps the module's
        # parameters for the forward's duration, so the lock is held
        # across the whole forward; the bucket census and the row
        # counters move with it
        "_compiled":        Guard("_lock", "BatchedPolicy"),
        "forwards":         Guard("_lock", "BatchedPolicy"),
        "rows":             Guard("_lock", "BatchedPolicy"),
        # FusedStepStream (port only): the dispatch lock (the replay
        # server's replay_lock under the feed) is held across the
        # enqueue of each chunk's sample of the ring, so the drain's B2
        # writes and this dispatch's B1 reads queue on one stream in
        # lock order
        "_replay":          Guard("_lock", "FusedStepStream"),
        # ChaosPlan: every fault fired, counted from every socket thread
        "counters":         Guard("_lock", "ChaosPlan"),
        # TokenBucket (the client's flush pacer): the grant and the
        # bucket it refills move together
        "granted":          Guard("_lock", "TokenBucket"),
        "_rate":            Guard("_lock", "TokenBucket"),
        "_capacity":        Guard("_lock", "TokenBucket"),
        "_tokens":          Guard("_lock", "TokenBucket"),
        # NOTE deliberately unregistered: ReplayFeedServer.last_seen is a
        # GIL-atomic monotonic stamp dict (single-writer per key, reader
        # tolerates staleness); DeviceStager._err is benign once-set;
        # BatchedPolicy._pinned is touched only by stage(), which
        # forward() calls under _lock (a lexical check cannot see
        # through the call)
    },
    globals={
        pkg("native", "__init__.py"): {"_lib": "_lock", "_tried": "_lock"},
        # the tracer: id counter, ring registry, clock-skew estimate
        pkg("tracing.py"): {"_id_counter": "_id_lock", "_rings": "_reg_lock",
                       "_tid_names": "_reg_lock", "_skew_s": "_skew_lock",
                       "_skew_rtt_s": "_skew_lock",
                       "_skew_samples": "_skew_lock"},
        # the process-wide mass-reconnect counter
        pkg("rpc", "resilience.py"): {"_mass_reconnects": "_herd_lock"},
        # the CRC combine's lazily extended power table
        pkg("utils", "durability.py"): {"_POWS": "_POWS_LOCK"},
    },
    # the condition variables: the ingest drain's and inference
    # microbatcher's _cv, and the replay server's shutdown-drain CV
    conditions=frozenset({"_cv", "_inflight_cv"}),
    bare={
        (pkg("replay", "staging.py"), "DeviceStager", "_lock"):
            "DeviceStager's lock is the caller's replay lock, held across "
            "sample_fn; the state it guards is the caller's replay",
        (pkg("rpc", "replay_server.py"), "ReplayFeedClient", "_lock"):
            "ReplayFeedClient's connection mutex: it serializes connect, "
            "request and reply on one socket (the wire I/O under it is "
            "pragma'd), and close() drops the socket without it so another "
            "thread can break a call in flight",
    },
    tokens={
        (pkg("rpc", "replay_server.py"), "ReplayFeedServer", "_snap_lock"):
            "one snapshot writer at a time: held across the background "
            "serialize + fsync, after the hot locks are released (see "
            "blocking.py)",
    },
    files=(
        pkg("rpc", "flowcontrol.py"),
        pkg("rpc", "replay_server.py"),
        pkg("rpc", "inference_server.py"),
        pkg("rpc", "faultinject.py"),
        pkg("rpc", "resilience.py"),
        pkg("actors", "supervisor.py"),
        pkg("actors", "membership.py"),
        pkg("actors", "autoscaler.py"),
        pkg("actors", "executor.py"),
        pkg("health.py"),
        pkg("learning.py"),
        pkg("tracing.py"),
        pkg("solver.py"),
        pkg("models", "policy.py"),
        pkg("replay", "staging.py"),
        pkg("replay", "columnar.py"),
        pkg("utils", "durability.py"),
        pkg("utils", "checkpoint.py"),
        pkg("native", "__init__.py"),
    ),
)


class _Walker(ast.NodeVisitor):
    """Lexical walk tracking held locks, enclosing class, enclosing
    function names, and nested-with lock ordering."""

    def __init__(self, src: Source, reg: LockRegistry,
                 out: list[Finding],
                 order_edges: dict[tuple[str, str], tuple[str, int]]):
        self.src = src
        self.reg = reg
        self.out = out
        self.order_edges = order_edges
        self.held: list[str] = []        # dotted lock exprs, e.g. self._lock
        self.classes: list[str] = []
        self.funcs: list[str] = []
        # lexical scope markers: "f" per enclosing function, "w" per
        # enclosing while — a CV wait is loop-checked iff a "w" follows
        # the innermost "f" (a while in an OUTER function doesn't count)
        self.scope: list[str] = []
        self.globals_table = next(
            (t for suffix, t in reg.globals.items()
             if src.path.replace(os.sep, "/").endswith(suffix)), {})
        self._lock_names = reg.lock_names()

    # -- scoping ----------------------------------------------------------

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self.classes.append(node.name)
        self.generic_visit(node)
        self.classes.pop()

    def _visit_func(self, node) -> None:
        self.funcs.append(getattr(node, "name", "<lambda>"))
        self.scope.append("f")
        self.generic_visit(node)
        self.scope.pop()
        self.funcs.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def visit_While(self, node: ast.While) -> None:
        self.scope.append("w")
        self.generic_visit(node)
        self.scope.pop()

    def _in_while(self) -> bool:
        for marker in reversed(self.scope):
            if marker == "w":
                return True
            if marker == "f":
                return False
        return False

    def visit_With(self, node: ast.With) -> None:
        taken: list[str] = []
        for item in node.items:
            expr = item.context_expr
            # ``with tracing.locked(self.replay_lock):`` is lock
            # acquisition with wait/hold spans around it — same mutual
            # exclusion, so look through to the lock argument
            if (isinstance(expr, ast.Call) and expr.args
                    and (dotted(expr.func) or "").rsplit(".", 1)[-1]
                    == "locked"):
                expr = expr.args[0]
            name = dotted(expr)
            if name and name.rsplit(".", 1)[-1] in self._lock_names:
                canon = name.rsplit(".", 1)[-1]
                for h in self.held:
                    prior = h.rsplit(".", 1)[-1]
                    if prior != canon:
                        self.order_edges.setdefault(
                            (prior, canon), (self.src.path, item.context_expr.lineno))
                self.held.append(name)
                taken.append(name)
            self.visit(item.context_expr)
            if item.optional_vars is not None:
                self.visit(item.optional_vars)
        for stmt in node.body:
            self.visit(stmt)
        for _ in taken:
            self.held.pop()

    visit_AsyncWith = visit_With

    # -- checks -----------------------------------------------------------

    def _exempt(self) -> bool:
        # no threads exist before construction finishes; module-level
        # statements run at import time, equally single-threaded
        if not self.funcs:
            return True
        return any(f in self.reg.unlocked_methods for f in self.funcs)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        guard = self.reg.attrs.get(node.attr)
        if guard is not None and not self._exempt():
            recv = dotted(node.value)
            applies = recv is not None and (
                recv in guard.receivers if recv != "self"
                else "self" in guard.receivers
                and guard.owner in self.classes)
            if applies and f"{recv}.{guard.lock}" not in self.held:
                self.src.finding(
                    RULE_UNGUARDED, node,
                    f"access to {recv}.{node.attr} outside "
                    f"'with {recv}.{guard.lock}:' "
                    f"(guarded field of {guard.owner})", self.out)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        name = dotted(node.func)
        if name is not None and "." in name:
            recv, method = name.rsplit(".", 1)
            cv = recv.rsplit(".", 1)[-1]
            if cv in self.reg.conditions and not self._exempt():
                if method == "wait" and not self._in_while():
                    # wait_for is exempt: it re-checks its predicate
                    self.src.finding(
                        RULE_CV_WAIT, node,
                        f"{recv}.wait() outside a while-predicate loop — "
                        "a woken waiter must re-check its condition "
                        "(spurious/stolen wakeups, timeouts)", self.out)
                elif method in ("notify", "notify_all") \
                        and recv not in self.held:
                    self.src.finding(
                        RULE_CV_NOTIFY, node,
                        f"{recv}.{method}() without lexically holding "
                        f"'with {recv}:' — raises RuntimeError on the "
                        "path that reaches it", self.out)
        self.generic_visit(node)

    def visit_Name(self, node: ast.Name) -> None:
        lock = self.globals_table.get(node.id)
        if lock is not None and self.funcs and not self._exempt() \
                and lock not in self.held:
            self.src.finding(
                RULE_UNGUARDED, node,
                f"access to module global {node.id!r} outside "
                f"'with {lock}:'", self.out)


def _find_cycles(edges: dict[tuple[str, str], tuple[str, int]],
                 out: list[Finding]) -> None:
    graph: dict[str, set[str]] = {}
    for a, b in edges:
        graph.setdefault(a, set()).add(b)
        graph.setdefault(b, set())
    color: dict[str, int] = {}
    stack: list[str] = []

    def dfs(n: str) -> None:
        color[n] = 1
        stack.append(n)
        for m in sorted(graph[n]):
            if color.get(m, 0) == 1:
                cycle = stack[stack.index(m):] + [m]
                path, line = edges.get((n, m)) or next(iter(edges.values()))
                out.append(Finding(
                    RULE_CYCLE, path, line,
                    "lock-order cycle (potential deadlock): "
                    + " -> ".join(cycle)))
            elif color.get(m, 0) == 0:
                dfs(m)
        stack.pop()
        color[n] = 2

    for n in sorted(graph):
        if color.get(n, 0) == 0:
            dfs(n)


def check_sources(sources: list[Source],
                  registry: LockRegistry = DEFAULT_REGISTRY) -> list[Finding]:
    out: list[Finding] = []
    edges: dict[tuple[str, str], tuple[str, int]] = {}
    for src in sources:
        _Walker(src, registry, out, edges).visit(src.tree)
    _find_cycles(edges, out)
    return out


def check(repo_root: str,
          registry: LockRegistry = DEFAULT_REGISTRY) -> list[Finding]:
    paths = [os.path.join(repo_root, f) for f in registry.files
             if os.path.exists(os.path.join(repo_root, f))]
    return check_sources(load_sources(repo_root, paths), registry)
