"""Blocking-while-locked detector — the off-lock disciplines as a
machine-checked ratchet.

Two hard-won hot-path lessons live in this tree as hand-enforced
conventions: PR 6 moved snapshot serialize+fsync off ``replay_lock``
(1639 ms → 116 ms lock hold) and PR 8 moved the ingest wire parse
off-lock. This pass makes "no blocking call while a registered lock is
held" a gate rule rather than folklore:

- A ``with <registered lock>:`` body (any lock name from the
  ``locks.py`` registry; ``tracing.locked(lock)`` is looked through,
  same as the lock pass) that lexically contains a call classified
  blocking — socket send/recv/accept/connect, ``time.sleep``,
  ``Event.wait`` on anything that is NOT the held lock (a CV wait on
  the held condition RELEASES it and is exempt), file ``open``/fsync,
  ``np.savez``/``savez_bytes``/``atomic_write``, the repo's
  ``send_msg``/``recv_msg`` wire helpers, a wait on the card
  (``torch.cuda.synchronize``, ``.synchronize()`` on a stream or event;
  the reference's ``jax.device_put``/``block_until_ready`` stay listed),
  ``subprocess.*``, and thread ``.join`` — is a ``blocking.under-lock``
  finding. A device→host copy (``.cpu()``, ``.item()``) also waits for
  the card, but it is not listed: it is ordinary on a CPU tensor and
  cannot be told apart statically, and the one deliberate case (the
  policy's reply copy under its forward lock) waits on the policy's own
  stream.
- Expansion is interprocedural over the same static resolution rules
  ``purity.py`` uses: a callee reached by bare name (same module, or a
  uniquely-named top-level elsewhere in the scanned set) or by
  ``self.X``/``cls.X`` is linted in the caller's lock context,
  transitively. Findings land on the blocking line with the entry
  point in the message, so the pragma sits where the blocking is.
- Deliberate cases carry the existing ``# ddq: allow(blocking.under-lock)``
  pragma with a stated reason — e.g. the client connection mutex, whose
  entire purpose is to serialize wire I/O on one socket.

Deliberately NOT in the lock set: ``_snap_lock`` is a serialization
token whose purpose is to be HELD across the background serialize+
fsync (one writer at a time; the hot locks are released before the
slow part starts) — checking it would invert PR 6's design.
Construction methods (``__init__``/restore helpers, per the locks
registry) are not lock roots: no second thread exists yet.
"""

from __future__ import annotations

import ast
import os

from distributed_deep_q_tpu_torch.analysis.core import (
    Finding, Source, call_name, dotted, load_sources)
from distributed_deep_q_tpu_torch.analysis import locks as _locks

RULE = "blocking.under-lock"

# the files the locks registry walks: the threaded RPC/replay plane and
# the resilient client, whose retry loop and raw transport are exactly
# where sleeps and wire I/O meet locks (the reference's pass adds the
# client to its registry's files; the port's registry lists it)
SCAN_FILES = _locks.DEFAULT_REGISTRY.files

# -- what counts as blocking ------------------------------------------------

_DOTTED = {
    "time.sleep", "os.fsync", "os.fdatasync", "select.select",
    "socket.create_connection", "socket.create_server",
    "jax.device_put", "torch.cuda.synchronize",
    "np.savez", "np.savez_compressed", "np.load",
    "numpy.savez", "numpy.savez_compressed", "numpy.load",
}
_DOTTED_PREFIXES = ("subprocess.",)
# bare-name calls: builtins and this repo's wire/durability helpers
_BARE = {"open", "sleep", "savez_bytes", "atomic_write",
         "send_msg", "recv_msg", "recv_msg_sized",
         "create_connection", "create_server"}
# method tails blocking on any receiver
_TAILS = {"accept", "recv", "recv_into", "sendall", "sendfile", "connect",
          "fsync", "device_put", "block_until_ready", "synchronize"}
# blocking UNLESS the receiver is the held lock itself (Condition.wait
# releases the lock it waits on; a foreign Event.wait does not)
_WAIT_TAILS = {"wait", "wait_for"}
# thread/process join is blocking; path joins are string work
_JOIN_EXEMPT_PREFIXES = ("os.path.", "posixpath.", "ntpath.")


def _tail(name: str) -> str:
    return name.rsplit(".", 1)[-1]


def _classify(name: str, held_tails: set[str]) -> str | None:
    """Why ``name(...)`` is blocking under a lock, or None."""
    if name in _DOTTED or name.startswith(_DOTTED_PREFIXES):
        return f"{name}()"
    if "." not in name:
        return f"{name}()" if name in _BARE else None
    tail = _tail(name)
    if tail in _TAILS:
        return f"{name}()"
    if tail in _WAIT_TAILS:
        recv = name.rsplit(".", 1)[0]
        if _tail(recv) in held_tails:
            return None  # CV wait on the held lock releases it
        return f"{name}() on a foreign event"
    if tail == "join" and not name.startswith(_JOIN_EXEMPT_PREFIXES):
        return f"{name}()"
    return None


# -- static call resolution (purity.py's rules) -----------------------------

_FuncNode = (ast.FunctionDef, ast.AsyncFunctionDef)


class _ModuleIndex:
    def __init__(self, src: Source):
        self.src = src
        self.by_name: dict[str, list] = {}
        self.top_level: set[str] = set()
        for node in src.nodes(*_FuncNode):
            self.by_name.setdefault(node.name, []).append(node)
        for node in src.tree.body:
            if isinstance(node, _FuncNode):
                self.top_level.add(node.name)


def _resolve(name: str, mod: _ModuleIndex,
             global_index: dict) -> list[tuple[_ModuleIndex, ast.AST]]:
    parts = name.split(".")
    if len(parts) == 1:
        local = mod.by_name.get(parts[0], [])
        if local:
            return [(mod, f) for f in local]
        if parts[0] in global_index:
            return [global_index[parts[0]]]
    elif len(parts) == 2 and parts[0] in ("self", "cls"):
        return [(mod, f) for f in mod.by_name.get(parts[1], [])]
    return []


class _Walker(ast.NodeVisitor):
    """Lexical walk of one function/module: track held registered
    locks; under any hold, lint calls and queue resolvable callees for
    expansion in the inherited lock context."""

    def __init__(self, mod: _ModuleIndex, lock_names: set[str],
                 unlocked: frozenset, global_index: dict,
                 out: list[Finding], work: list,
                 inherited: tuple[str, ...] = (), via: str = ""):
        self.mod = mod
        self.lock_names = lock_names
        self.unlocked = unlocked
        self.global_index = global_index
        self.out = out
        self.work = work
        self.held: list[str] = list(inherited)  # lock attr tails
        self.via = via
        self.funcs: list[str] = []

    def _visit_func(self, node) -> None:
        name = getattr(node, "name", "<lambda>")
        if not self.held and name in self.unlocked:
            return  # construction runs single-threaded: not a lock root
        self.funcs.append(name)
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
            if name and _tail(name) in self.lock_names:
                self.held.append(_tail(name))
                taken += 1
            self.visit(item.context_expr)
            if item.optional_vars is not None:
                self.visit(item.optional_vars)
        for stmt in node.body:
            self.visit(stmt)
        for _ in range(taken):
            self.held.pop()

    visit_AsyncWith = visit_With

    def visit_Call(self, node: ast.Call) -> None:
        if self.held:
            name = call_name(node)
            if name is not None:
                what = _classify(name, set(self.held))
                if what is not None:
                    where = f" (entered from {self.via})" if self.via else ""
                    self.mod.src.finding(
                        RULE, node,
                        f"blocking call {what} while holding "
                        f"{' -> '.join(sorted(set(self.held)))}{where} — "
                        "move the slow work off-lock or pragma with a "
                        "reason", self.out)
                for target in _resolve(name, self.mod, self.global_index):
                    self.work.append(
                        (target[0], target[1], tuple(sorted(set(self.held))),
                         self.via or f"{self.mod.src.path}:{node.lineno}"))
        self.generic_visit(node)


def check_sources(sources: list[Source],
                  lock_names: set[str] | None = None,
                  unlocked: frozenset | None = None) -> list[Finding]:
    lock_names = lock_names if lock_names is not None \
        else _locks.DEFAULT_REGISTRY.lock_names()
    unlocked = unlocked if unlocked is not None \
        else _locks.DEFAULT_REGISTRY.unlocked_methods
    indexes = [_ModuleIndex(s) for s in sources]
    global_index: dict = {}
    ambiguous: set[str] = set()
    for idx in indexes:
        for name in idx.top_level:
            fns = idx.by_name.get(name, [])
            if len(fns) != 1:
                continue
            if name in global_index:
                ambiguous.add(name)
            global_index[name] = (idx, fns[0])
    for name in ambiguous:
        global_index.pop(name, None)

    out: list[Finding] = []
    work: list = []
    for idx in indexes:
        _Walker(idx, lock_names, unlocked, global_index, out, work
                ).visit(idx.src.tree)
    seen: set[tuple] = set()
    while work:
        mod, fn, held, via = work.pop()
        key = (id(fn), held)
        if key in seen or fn.name in unlocked:
            continue
        seen.add(key)
        w = _Walker(mod, lock_names, unlocked, global_index, out, work,
                    inherited=held, via=via)
        w.funcs.append(fn.name)
        for stmt in fn.body:
            w.visit(stmt)
    # a nested def is walked via its parent's subtree AND via expansion —
    # keep one copy of each finding
    uniq: dict[tuple, Finding] = {}
    for f in out:
        uniq.setdefault((f.rule, f.path, f.line, f.message), f)
    return sorted(uniq.values(), key=lambda f: (f.path, f.line))


def check(repo_root: str) -> list[Finding]:
    paths = [os.path.join(repo_root, f) for f in SCAN_FILES
             if os.path.exists(os.path.join(repo_root, f))]
    return check_sources(load_sources(repo_root, paths))
