"""RPC protocol-drift detector — client/server/wire skew at lint time.

Three cross-checks, so a renamed handler or a new client method shows
up as a file:line finding instead of a live ``ProtocolError`` (or a
silent ``{"error": "unknown method ..."}``) under traffic:

- ``protocol.unhandled-method``: a ``.call("X")`` / ``.call_once("X")``
  anywhere in the port package, its tool modules included (the twins
  of the reference's ``scripts/``), whose method string has no
  ``method == "X"`` branch in any registered server dispatch table
  (``SERVER_TABLES`` — the replay feed and the batched inference
  plane).
- ``protocol.orphan-handler``: a ``_dispatch`` branch whose method
  string no caller ever emits — dead protocol surface that drifts
  silently.
- ``protocol.wire-skew``: a ``_KIND_*`` wire tag referenced by
  ``encode`` but not ``_decode`` (or vice versa) in ``rpc/protocol.py``
  — an encode/decode pairing break.

Idempotence classes (ISSUE 18): the resilient client's ``call()``
retries on any failure, so a lost ACK means the server may execute a
verb TWICE. Every handled verb must therefore declare its resend
semantics in ``VERB_CLASSES`` — ``idempotent`` (a duplicate delivery
converges to the same state), ``dedup_keyed`` (duplicates are dropped
server-side by an explicit key, e.g. ``add_transitions``' per-actor
``flush_seq`` stamp), or ``unsafe`` (a duplicate corrupts state).

- ``protocol.unclassified-verb``: a ``_dispatch`` branch whose verb has
  no class — resend semantics living only in comments.
- ``protocol.stale-verb-class``: a class entry with no handler left.
- ``protocol.unsafe-resend``: a literal ``.call("X")`` — the RETRYING
  resend path — on a verb classified ``unsafe``. Unsafe verbs must go
  through ``call_once`` (single attempt) or gain a dedup key.

Registering a new RPC method = adding the ``method == "X"`` branch, at
least one literal call site, and one ``VERB_CLASSES`` line.

The reference's emit scan also reads ``tests/``; this one does not. The
port's passes scan the port package only: ``tests/`` holds both
packages' tests side by side, and a verb that only a test emits would
let a handler the port itself never calls pass as live. The one verb
only operators and tests emit, ``stats``, carries a pragma on each of
its handlers saying so.
"""

from __future__ import annotations

import ast
import os
import re

from distributed_deep_q_tpu_torch.analysis.core import (
    Finding, Source, call_name, package_files, pkg)

# text pre-filter for emitter files: ``emitted_methods`` only matches
# AST calls whose target tail is ``call``/``call_once``, and any such
# call spells ``call``/``call_once`` directly before its ``(`` in
# source (modulo whitespace). Files without the token cannot emit, so
# their parse is skipped.
_EMIT_HINT = re.compile(r"\bcall(?:_once)?\s*\(")

# every server-side dispatch table on the wire protocol: the replay
# feed and (ISSUE 9) the batched inference plane. The two planes share
# one client emit surface, so handlers are unioned before cross-checking
SERVER_TABLES = (
    (pkg("rpc", "replay_server.py"), "ReplayFeedServer"),
    (pkg("rpc", "inference_server.py"), "InferenceServer"),
    # elastic-fleet verbs (ISSUE 17): ReplayFeedServer delegates
    # fleet_* to the attached registry, whose own _dispatch holds the
    # authoritative method branches
    (pkg("actors", "membership.py"), "MembershipRegistry"),
)
PROTOCOL_FILE = pkg("rpc", "protocol.py")

IDEMPOTENT, DEDUP_KEYED, UNSAFE = "idempotent", "dedup_keyed", "unsafe"

# resend semantics of every wire verb — what happens when the resilient
# client's retry loop delivers it twice (lost ACK, reconnect replay):
VERB_CLASSES = {
    # pure function of (θ, obs); the shed path re-sends the SAME
    # observations, so a duplicate forward returns the same actions
    "infer": IDEMPOTENT,
    # dedup map keyed (actor_id, flush_seq) under replay_lock: a
    # replayed seq is counted as duplicate_flush and dropped — the
    # exactly-once backbone of the resilience plane
    "add_transitions": DEDUP_KEYED,
    # cached θ frame read; have_version refresh is a no-op reply
    "get_params": IDEMPOTENT,
    # liveness stamp: last_seen[actor] = now, monotone overwrite
    "heartbeat": IDEMPOTENT,
    # reads of telemetry / health rings; a duplicate health scrape
    # re-samples a time-windowed ring — benign double sample
    "stats": IDEMPOTENT,
    "health": IDEMPOTENT,
    # pure read of the landed-flush floor (elastic remap support)
    "stream_seq": IDEMPOTENT,
    # seal current slot + drop the actor's flush_seq stamp; re-sealing
    # an already-sealed slot and re-popping an absent stamp are no-ops
    "reset_stream": IDEMPOTENT,
    # permanent dedup-stamp eviction on scale-down (ISSUE 20): evicting
    # an absent stamp is the same no-op twice — safe to re-send
    "retire_stream": IDEMPOTENT,
    # membership state converges: re-join supersedes the member row,
    # leaving an absent member is a pop of nothing, a lease renew
    # extends monotonically from `now`. Each duplicate delivery still
    # bumps the epoch — observers re-run the SAME assignment, so the
    # churn is benign (and counted in fleet stats)
    "fleet_join": IDEMPOTENT,
    "fleet_leave": IDEMPOTENT,
    "fleet_lease": IDEMPOTENT,
    # pure read of the epoch-numbered member table
    "fleet_view": IDEMPOTENT,
}


def dispatch_handlers(server_src: Source,
                      class_name: str = "ReplayFeedServer") -> dict[str, int]:
    """Method strings handled by ``<class_name>._dispatch``:
    string constants compared against the ``method`` variable."""
    handlers: dict[str, int] = {}
    dispatch: ast.FunctionDef | None = None
    for node in ast.walk(server_src.tree):
        if isinstance(node, ast.ClassDef) and node.name == class_name:
            for item in ast.walk(node):
                if isinstance(item, ast.FunctionDef) \
                        and item.name == "_dispatch":
                    dispatch = item
    if dispatch is None:
        return handlers
    for node in ast.walk(dispatch):
        if not isinstance(node, ast.Compare):
            continue
        operands = [node.left, *node.comparators]
        if not any(isinstance(o, ast.Name) and o.id == "method"
                   for o in operands):
            continue
        for o in operands:
            if isinstance(o, ast.Constant) and isinstance(o.value, str):
                handlers.setdefault(o.value, o.lineno)
    return handlers


def emitted_methods(sources: list[Source],
                    tails: tuple[str, ...] = ("call", "call_once"),
                    ) -> list[tuple[str, Source, int]]:
    """Literal first arguments of ``.call(...)`` / ``.call_once(...)``
    (also a bare ``call("X")`` — the heartbeat thread binds the method
    to a local). ``tails=("call",)`` restricts to the RETRYING emit
    surface for the unsafe-resend check."""
    out: list[tuple[str, Source, int]] = []
    for src in sources:
        for node in src.nodes(ast.Call):
            if not node.args:
                continue
            name = call_name(node)
            if name is None or name.rsplit(".", 1)[-1] not in tails:
                continue
            arg = node.args[0]
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                out.append((arg.value, src, node.lineno))
    return out


def wire_kind_skew(proto_src: Source, out: list[Finding]) -> None:
    defined: dict[str, int] = {}
    for node in proto_src.tree.body:
        if isinstance(node, ast.Assign):
            targets = node.targets[0]
            elts = targets.elts if isinstance(targets, ast.Tuple) \
                else [targets]
            for t in elts:
                if isinstance(t, ast.Name) and t.id.startswith("_KIND_"):
                    defined[t.id] = node.lineno

    def used_in(fn_name: str) -> set[str]:
        for node in proto_src.tree.body:
            if isinstance(node, ast.FunctionDef) and node.name == fn_name:
                return {n.id for n in ast.walk(node)
                        if isinstance(n, ast.Name)
                        and n.id.startswith("_KIND_")}
        return set()

    enc, dec = used_in("encode"), used_in("_decode")
    for kind, line in sorted(defined.items()):
        if kind in enc and kind not in dec:
            proto_src.finding(
                "protocol.wire-skew", line,
                f"{kind} is encoded but never decoded — wire pairing "
                "broken", out)
        elif kind in dec and kind not in enc:
            proto_src.finding(
                "protocol.wire-skew", line,
                f"{kind} is decoded but never encoded — wire pairing "
                "broken", out)
        elif kind not in enc and kind not in dec:
            proto_src.finding(
                "protocol.wire-skew", line,
                f"{kind} is defined but used by neither encode nor "
                "_decode", out)


def check_sources(server_src, proto_src: Source,
                  emitter_sources: list[Source],
                  verb_classes: dict[str, str] | None = None
                  ) -> list[Finding]:
    """``server_src`` is one ``Source`` (checked as ``ReplayFeedServer``)
    or a list of ``(Source, class_name)`` pairs — one per dispatch
    table. Handlers are unioned for the unhandled-method direction; the
    orphan direction attributes each handler to its own table. With
    ``verb_classes``, every handled verb must carry a resend class and
    ``unsafe`` verbs must never ride the retrying ``.call`` path."""
    if isinstance(server_src, Source):
        server_src = [(server_src, "ReplayFeedServer")]
    out: list[Finding] = []
    tables = [(src, cls, dispatch_handlers(src, cls))
              for src, cls in server_src]
    handled = {m for _, _, handlers in tables for m in handlers}
    emitted = emitted_methods(emitter_sources)
    if verb_classes is not None:
        for table_src, cls, handlers in tables:
            for method, line in sorted(handlers.items()):
                if method not in verb_classes:
                    table_src.finding(
                        "protocol.unclassified-verb", line,
                        f"{cls}._dispatch handles {method!r} but "
                        "VERB_CLASSES declares no resend semantics for "
                        "it (idempotent | dedup_keyed | unsafe)", out)
        for method, klass in sorted(verb_classes.items()):
            if method not in handled and tables:
                tables[0][0].finding(
                    "protocol.stale-verb-class", 1,
                    f"VERB_CLASSES declares {method!r} as {klass} but no "
                    "server _dispatch table handles it", out)
        unsafe = {m for m, k in verb_classes.items() if k == UNSAFE}
        if unsafe:
            for method, src, line in emitted_methods(
                    emitter_sources, tails=("call",)):
                if method in unsafe:
                    src.finding(
                        "protocol.unsafe-resend", line,
                        f".call({method!r}) rides the resilient client's "
                        "retry path, but the verb is classified unsafe "
                        "under resend — use call_once or add a dedup "
                        "key", out)
    for method, src, line in emitted:
        if method not in handled:
            src.finding(
                "protocol.unhandled-method", line,
                f"client emits RPC method {method!r} but no server "
                "_dispatch table has a handler for it "
                f"({', '.join(cls for _, cls, _ in tables)})", out)
    emitted_names = {m for m, _, _ in emitted}
    for table_src, cls, handlers in tables:
        for method, line in sorted(handlers.items()):
            if method not in emitted_names:
                table_src.finding(
                    "protocol.orphan-handler", line,
                    f"{cls}._dispatch handles {method!r} but no client, "
                    "script, or test ever emits it", out)
    wire_kind_skew(proto_src, out)
    return out


def check(repo_root: str) -> list[Finding]:
    server_srcs = [
        (Source.load(os.path.join(repo_root, path), path), cls)
        for path, cls in SERVER_TABLES
        if os.path.exists(os.path.join(repo_root, path))]
    proto_src = Source.load(os.path.join(repo_root, PROTOCOL_FILE),
                            PROTOCOL_FILE)
    emitters: list[Source] = []
    for p in package_files(repo_root):
        try:
            with open(p, encoding="utf-8") as f:
                text = f.read()
        except OSError:
            continue
        if _EMIT_HINT.search(text):
            emitters.append(Source.load(p, os.path.relpath(p, repo_root)))
    return check_sources(server_srcs, proto_src, emitters,
                         verb_classes=VERB_CLASSES)
