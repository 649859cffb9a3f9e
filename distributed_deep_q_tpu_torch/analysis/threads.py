"""Thread-lifecycle registry — every spawn site is a declared contract.

The fleet is deeply threaded (accept/serve loops on two RPC servers,
the ingest drain, the snapshot writer, the flow watchdog, the actor
heartbeat and supervisor watch loop), and each thread's lifecycle —
who owns it, what stops it, who joins it — was comment-folklore. This
pass makes the contract declarative and machine-checked:

- ``ThreadSpec`` registers one spawn site by (file, target) and names
  the thread, its owner, its stop mechanism, and its join/shutdown
  site. An unregistered ``threading.Thread(...)`` in a walked file is
  ``threads.unregistered``; a spawn whose ``name=``/``daemon=`` kwargs
  disagree with the spec is ``threads.spec-mismatch``.
- Non-daemon threads must have a reachable join: the spec names the
  method (``joined_in``) and the checker verifies a ``.join(`` on the
  attribute the spawn was stored to actually exists there —
  ``threads.no-join`` otherwise. Daemon threads may skip the join only
  with a stated ``why_no_join`` reason in the spec.
- Stop mechanisms are verified, not trusted: an ``("event", attr)``
  stop needs a ``<attr>.set()`` call somewhere in the file (a stop
  event nobody sets is an unstoppable thread → ``threads.no-stop``);
  a ``("lock-release", attr)`` stop (the snapshot writer is bounded by
  releasing ``_snap_lock``) needs the ``.release()`` inside the target;
  a ``("flag", attr, guard)`` stop is a plain bool whose every write
  must sit under ``with <recv>.<guard>:`` — ``threads.stop-unguarded``
  otherwise (the IngestDrain/InferenceServer shutdown flags move under
  their condition variables). ``("connection", why)`` declares a
  per-connection serve thread reaped by peer close / socket deadline —
  nothing to verify beyond the registration itself; ``("bounded",
  why)`` (port) declares a thread whose target is one finite piece of
  work with no loop to stop (the checkpoint writer) — likewise.

Registering a new thread = one ``ThreadSpec`` line in
``DEFAULT_THREADS``; an unregistered spawn fails the gate. The port's
registry is the reference's, for the port's paths, plus the checkpoint
writer (``utils/checkpoint.py``), which only the port runs on a thread.
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field

from distributed_deep_q_tpu_torch.analysis.core import (
    Finding, Source, call_name, dotted, load_sources, pkg)

RULE_UNREGISTERED = "threads.unregistered"
RULE_MISMATCH = "threads.spec-mismatch"
RULE_NO_JOIN = "threads.no-join"
RULE_NO_STOP = "threads.no-stop"
RULE_STOP_UNGUARDED = "threads.stop-unguarded"


@dataclass(frozen=True)
class ThreadSpec:
    """One registered spawn site: the lifecycle contract of a thread."""

    name: str                 # thread-name literal the spawn must pass
    owner: str                # owning class (or enclosing function)
    stop: tuple               # ("event", attr) | ("flag", attr, guard) |
    #                           ("lock-release", attr) | ("connection", why)
    #                           | ("bounded", why)
    joined_in: str | None     # method containing the join; None = no join
    why_no_join: str = ""     # required rationale when joined_in is None
    daemon: bool = True


@dataclass
class ThreadRegistry:
    # (repo-relative file, target callable's tail name) → spec
    specs: dict[tuple[str, str], ThreadSpec] = field(default_factory=dict)
    # methods that run single-threaded (construction / warm boot) —
    # stop-flag writes there need no guard
    unlocked_methods: frozenset = frozenset(
        {"__init__", "_restore", "_load_generation", "_reset_boot_state"})
    files: tuple[str, ...] = ()


DEFAULT_THREADS = ThreadRegistry(
    specs={
        # actor heartbeat (_ActorComms): paced on a PROCESS-LOCAL event —
        # never the shared mp stop event (a SIGKILL'd sleeper would
        # deadlock the supervisor's notify_all). Daemon dies with the
        # process; clean exits set _local_stop from close()
        (pkg("actors", "supervisor.py"), "_beat"):
            ThreadSpec(
                name="actor-heartbeat", owner="_ActorComms",
                stop=("event", "_local_stop"), joined_in=None,
                why_no_join="close() sets the process-local stop and the "
                            "beat exits within one backoff period; joining "
                            "would stall actor teardown on a sleeping "
                            "backoff"),
        # supervisor watch loop: polls process liveness + heartbeat
        # silence; exits on the shared mp stop event checked every poll
        (pkg("actors", "supervisor.py"), "loop"):
            ThreadSpec(
                name="actor-supervisor", owner="ActorSupervisor",
                stop=("event", "stop_event"), joined_in=None,
                why_no_join="stop() sets the mp stop event and joins the "
                            "actor PROCESSES; the daemon watch loop exits "
                            "on its next poll tick"),
        # replay feed: accept loop joined by close() after the socket
        # shutdown unblocks accept()
        (pkg("rpc", "replay_server.py"), "_accept_loop"):
            ThreadSpec(
                name="replayfeed-accept", owner="ReplayFeedServer",
                stop=("event", "_stop"), joined_in="close"),
        # async snapshot writer: bounded by one serialize+fsync; holds
        # ONLY _snap_lock (captured state travels by argument), so
        # shutdown serializes against it via snapshot()'s lock acquire,
        # not a join
        (pkg("rpc", "replay_server.py"), "_write_and_release"):
            ThreadSpec(
                name="replayfeed-snapshot", owner="ReplayFeedServer",
                stop=("lock-release", "_snap_lock"), joined_in=None,
                why_no_join="bounded by one serialize+fsync; shutdown "
                            "serializes on _snap_lock, which the thread "
                            "releases in its finally"),
        # per-connection serve threads: reaped by peer close or close()
        # closing every tracked conn; the socket deadline bounds a wedge
        (pkg("rpc", "replay_server.py"), "_serve"):
            ThreadSpec(
                name="replayfeed-serve", owner="ReplayFeedServer",
                stop=("connection", "close() closes every conn in "
                      "_conns; recv then raises"), joined_in=None,
                why_no_join="per-connection; exits when its socket dies"),
        # inference plane: batcher drains on the _closed flag (under
        # _cv), accept loop on the _stop event; both joined by close()
        (pkg("rpc", "inference_server.py"), "_batch_loop"):
            ThreadSpec(
                name="infer-batch", owner="InferenceServer",
                stop=("flag", "_closed", "_cv"), joined_in="close"),
        (pkg("rpc", "inference_server.py"), "_accept_loop"):
            ThreadSpec(
                name="infer-accept", owner="InferenceServer",
                stop=("event", "_stop"), joined_in="close"),
        (pkg("rpc", "inference_server.py"), "_serve"):
            ThreadSpec(
                name="infer-serve", owner="InferenceServer",
                stop=("connection", "close() closes every conn in "
                      "_conns; recv then raises"), joined_in=None,
                why_no_join="per-connection; exits when its socket dies"),
        # flow-control watchdog: wakes on _stop.wait(period), joined by
        # close()
        (pkg("rpc", "flowcontrol.py"), "_watch_loop"):
            ThreadSpec(
                name="flow-watchdog", owner="FlowController",
                stop=("event", "_stop"), joined_in="close"),
        # device stager: sample-under-lock / device_put-off-lock
        # pipeline; joined by close() after draining the queue so a
        # blocked put() can observe the stop flag
        (pkg("replay", "staging.py"), "_run"):
            ThreadSpec(
                name="replay-stager", owner="DeviceStager",
                stop=("event", "_stop"), joined_in="close"),
        # ingest drain: stop flag moves under its condition variable
        # (set + notify in close()), joined by close() before the final
        # stranded-rows work unit
        (pkg("replay", "columnar.py"), "_run"):
            ThreadSpec(
                name="ingest-drain", owner="IngestDrain",
                stop=("flag", "_stop", "_cv"), joined_in="close"),
        # checkpoint writer (port only): one snapshot's files written
        # with atomic_write, then the prune; the next save() and every
        # read of the directory join it first through wait(), which
        # re-raises its error on the caller
        (pkg("utils", "checkpoint.py"), "_write"):
            ThreadSpec(
                name="checkpoint-writer", owner="Checkpointer",
                stop=("bounded", "one snapshot's writes and the prune; no "
                      "loop to stop"), joined_in="wait"),
    },
    files=(
        pkg("rpc", "flowcontrol.py"),
        pkg("rpc", "replay_server.py"),
        pkg("rpc", "inference_server.py"),
        pkg("actors", "supervisor.py"),
        pkg("actors", "membership.py"),
        pkg("actors", "autoscaler.py"),
        pkg("replay", "staging.py"),
        pkg("replay", "columnar.py"),
        pkg("utils", "checkpoint.py"),
    ),
)


def _is_thread_call(node: ast.Call) -> bool:
    name = call_name(node)
    return name is not None and name.rsplit(".", 1)[-1] == "Thread"


def _kwarg(node: ast.Call, key: str) -> ast.AST | None:
    for kw in node.keywords:
        if kw.arg == key:
            return kw.value
    return None


def _const(node: ast.AST | None):
    return node.value if isinstance(node, ast.Constant) else None


def _tail(name: str | None) -> str | None:
    return name.rsplit(".", 1)[-1] if name else None


def _spawn_sites(src: Source) -> list[tuple[ast.Call, str | None]]:
    """Every ``threading.Thread(...)`` call with the attribute it was
    stored to (``self._thread = Thread(...)`` → ``_thread``; a chained
    ``Thread(...).start()`` or bare call stores nothing → None)."""
    stored: dict[int, str] = {}
    for node in src.nodes(ast.Assign):
        if len(node.targets) == 1 \
                and isinstance(node.value, ast.Call) \
                and _is_thread_call(node.value):
            attr = _tail(dotted(node.targets[0]))
            if attr:
                stored[id(node.value)] = attr
    out: list[tuple[ast.Call, str | None]] = []
    for node in src.nodes(ast.Call):
        if _is_thread_call(node):
            out.append((node, stored.get(id(node))))
    return out


def _functions_named(src: Source, name: str) -> list[ast.FunctionDef]:
    return [n for n in src.nodes(ast.FunctionDef, ast.AsyncFunctionDef)
            if n.name == name]


def _calls_method_on(scope: ast.AST, method: str,
                     recv_tail: str | None = None) -> bool:
    """Is there a ``<recv>.<method>(...)`` call in ``scope``? When
    ``recv_tail`` is given, the receiver chain must end with it."""
    for node in ast.walk(scope):
        if not isinstance(node, ast.Call) \
                or not isinstance(node.func, ast.Attribute) \
                or node.func.attr != method:
            continue
        if recv_tail is None:
            return True
        recv = dotted(node.func.value)
        if recv is not None and recv.rsplit(".", 1)[-1] == recv_tail:
            return True
    return False


class _FlagWalker(ast.NodeVisitor):
    """Lexical walk flagging writes to a stop flag outside its guard."""

    def __init__(self, src: Source, flag: str, guard: str,
                 unlocked: frozenset, out: list[Finding]):
        self.src = src
        self.flag = flag
        self.guard = guard
        self.unlocked = unlocked
        self.out = out
        self.held = 0
        self.funcs: list[str] = []

    def _visit_func(self, node) -> None:
        self.funcs.append(getattr(node, "name", "<lambda>"))
        self.generic_visit(node)
        self.funcs.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def visit_With(self, node: ast.With) -> None:
        taken = 0
        for item in node.items:
            expr = item.context_expr
            if (isinstance(expr, ast.Call) and expr.args
                    and (dotted(expr.func) or "").rsplit(".", 1)[-1]
                    == "locked"):
                expr = expr.args[0]
            name = dotted(expr)
            if name and name.rsplit(".", 1)[-1] == self.guard:
                self.held += 1
                taken += 1
        for stmt in node.body:
            self.visit(stmt)
        self.held -= taken

    visit_AsyncWith = visit_With

    def _check_target(self, target: ast.AST, node: ast.AST) -> None:
        if isinstance(target, ast.Attribute) and target.attr == self.flag \
                and not self.held \
                and not any(f in self.unlocked for f in self.funcs):
            self.src.finding(
                RULE_STOP_UNGUARDED, node,
                f"stop flag {self.flag!r} written outside "
                f"'with {self.guard}:' — the thread's exit check races "
                "this store", self.out)

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            self._check_target(t, node)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._check_target(node.target, node)
        self.generic_visit(node)


def check_sources(sources: list[Source],
                  registry: ThreadRegistry = DEFAULT_THREADS
                  ) -> list[Finding]:
    out: list[Finding] = []
    for src in sources:
        relpath = src.path.replace(os.sep, "/")
        checked_flags: set[tuple[str, str]] = set()
        for call, stored_attr in _spawn_sites(src):
            target_name = _tail(dotted(_kwarg(call, "target")))
            spec = None
            if target_name is not None:
                for (file, target), s in registry.specs.items():
                    if target == target_name and relpath.endswith(file):
                        spec = s
                        break
            if spec is None:
                src.finding(
                    RULE_UNREGISTERED, call,
                    f"unregistered thread spawn (target="
                    f"{target_name or '<computed>'}): add a ThreadSpec "
                    "naming its owner, stop mechanism, and join site",
                    out)
                continue
            name = _const(_kwarg(call, "name"))
            if name != spec.name:
                src.finding(
                    RULE_MISMATCH, call,
                    f"thread spawn name={name!r} but the registered spec "
                    f"says {spec.name!r} — name every thread so stack "
                    "dumps attribute it", out)
            daemon = bool(_const(_kwarg(call, "daemon")))
            if daemon != spec.daemon:
                src.finding(
                    RULE_MISMATCH, call,
                    f"thread spawn daemon={daemon} but the registered "
                    f"spec says daemon={spec.daemon}", out)
            # join contract: non-daemon threads MUST have one; a spec
            # that declares one must be verifiable against the file
            if spec.joined_in is None:
                if not daemon:
                    src.finding(
                        RULE_NO_JOIN, call,
                        "non-daemon thread with no registered join site "
                        "— process exit will hang on it", out)
                elif not spec.why_no_join:
                    src.finding(
                        RULE_NO_JOIN, call,
                        "daemon thread skips its join without a stated "
                        "why_no_join reason in the spec", out)
            else:
                joiners = _functions_named(src, spec.joined_in)
                ok = stored_attr is not None and any(
                    _calls_method_on(fn, "join", stored_attr)
                    for fn in joiners)
                if not ok:
                    src.finding(
                        RULE_NO_JOIN, call,
                        f"spec says {spec.owner}.{spec.joined_in}() joins "
                        "this thread, but no .join() on the stored "
                        f"attribute ({stored_attr or 'not stored'}) was "
                        "found there", out)
            # stop contract
            kind = spec.stop[0] if spec.stop else None
            if kind == "event":
                attr = spec.stop[1]
                if not _calls_method_on(src.tree, "set", attr):
                    src.finding(
                        RULE_NO_STOP, call,
                        f"stop event {attr!r} is never .set() in this "
                        "file — the thread is unstoppable", out)
            elif kind == "lock-release":
                attr = spec.stop[1]
                targets = _functions_named(src, target_name)
                if not any(_calls_method_on(fn, "release", attr)
                           for fn in targets):
                    src.finding(
                        RULE_NO_STOP, call,
                        f"spec says the thread is bounded by releasing "
                        f"{attr!r}, but {target_name}() never releases "
                        "it", out)
            elif kind == "flag":
                flag, guard = spec.stop[1], spec.stop[2]
                if (flag, guard) not in checked_flags:
                    checked_flags.add((flag, guard))
                    _FlagWalker(src, flag, guard,
                                registry.unlocked_methods, out
                                ).visit(src.tree)
    return out


def check(repo_root: str,
          registry: ThreadRegistry = DEFAULT_THREADS) -> list[Finding]:
    paths = [os.path.join(repo_root, f) for f in registry.files
             if os.path.exists(os.path.join(repo_root, f))]
    return check_sources(load_sources(repo_root, paths), registry)
