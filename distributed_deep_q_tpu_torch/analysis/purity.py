"""Torch purity lint — host side effects inside the device-step functions.

The reference lints what ``jit`` traces: a traced function runs once per
compilation, so a ``print``, a clock read, a host RNG draw or a host
read inside it is frozen or leaks. The port runs eagerly, but the same
functions are what a CUDA graph captures (ROADMAP item 8 puts the
Anakin superstep under one), and a graph replays exactly the device work
issued during capture: a host sync inside it breaks the capture, a host
RNG draw or clock read becomes a constant, a write to captured Python
state happens once. This pass keeps those functions capture-safe:

- Roots, two ways. ``DEVICE_ROOTS`` declares the port's counterparts of
  the reference's 21 jit roots, each entry naming the reference root it
  stands for (``NO_COUNTERPART`` names the one with none, and why). And,
  as the reference finds ``jit``, roots are found in the source: the
  argument of ``torch.compile`` / ``torch.cuda.make_graphed_callables``
  (by name, ``self.<method>``, lambda, ``functools.partial(f, ...)``, a
  local alias, either branch of a static ``f if gate else g``, or a
  tuple of these), a function decorated with ``torch.compile``, the body
  of ``with torch.cuda.graph(...)`` and the statements between a
  ``CUDAGraph``'s ``capture_begin()`` and ``capture_end()`` (these two
  are linted inline, with the enclosing function's locals). A
  ``torch.compile`` of a module instance is out of static reach: its
  class's ``forward`` goes in ``DEVICE_ROOTS``.
- Expansion: the reference's — callees by bare name or ``self.<name>``
  resolve within the same module; bare names also resolve to
  uniquely-named top-level functions elsewhere in the scanned set. One
  refinement: ``self.<name>`` inside a class that defines ``<name>``
  resolves to that class's method alone (``MlpQNet.forward_nchw``'s
  ``self.forward`` is ``MlpQNet.forward``, not the host wrapper
  ``QNet.forward`` of the same module).
- Rules inside a root's scope: ``purity.print``, ``purity.logging``,
  ``purity.time`` (``time.*``/``datetime.*``, and the tracer's
  ``tracing.*``, whose spans stamp the host's clock into a host ring: a
  graph replays none of them), ``purity.host-rng`` (``random.*``, ``np.random.*``, ``torch.Generator(``,
  ``torch.manual_seed``), ``purity.host-sync`` (``.item()``, ``.cpu()``,
  ``.tolist()``, ``.numpy()``, ``np.asarray``/``np.array``,
  ``torch.cuda.synchronize``/``.synchronize()``) and
  ``purity.captured-write`` (assignment through an attribute/subscript
  whose base is not a local, ``self``/``cls`` included, and
  ``global``/``nonlocal``). In-place tensor ops (``x.add_()``,
  ``buf[i] = v`` on a tensor the function was given) are device work,
  not findings.

Scope: ``parallel/``, ``ops/``, ``models/`` and ``replay/`` (whose
device functions the roots call by bare name), plus the files
``DEVICE_ROOTS`` names.
"""

from __future__ import annotations

import ast
import os
from typing import NamedTuple

from distributed_deep_q_tpu_torch.analysis.core import (
    Finding, Source, call_name, dotted, load_sources, package_files, pkg)

SCAN_DIRS = ("parallel", "ops", "models", "replay")


class DeviceRoot(NamedTuple):
    """One declared root: ``qualname`` (``Class.method``, ``func`` or
    ``outer.inner``) in the package-relative ``file``, and the reference
    jit root (``file:line name`` in ``distributed_deep_q_tpu/``) it
    stands for."""

    file: str
    qualname: str
    reference: str


_R = DeviceRoot
DEVICE_ROOTS = (
    # learner.py:519 — the host-batch train step
    _R("parallel/learner.py", "Learner._step_core",
       "parallel/learner.py:519 step_fn"),
    # learner.py:538 — the ring step: the stacks composed on the device,
    # then the core above
    _R("replay/device_ring.py", "compose_stacks",
       "parallel/learner.py:538 step_fn"),
    # learner.py:612 — the fused sample stage
    _R("parallel/learner.py", "fused_sample",
       "parallel/learner.py:612 sample_fn"),
    # learner.py:666/:680 — the fused chain's tree and plane bodies: one
    # train stage in the port, the plane its lm_update/lm_finalize
    _R("parallel/learner.py", "Learner._train_chain",
       "parallel/learner.py:666 tree_train_fn"),
    _R("parallel/learner.py", "Learner._train_chain",
       "parallel/learner.py:680 plane_train_fn"),
    _R("learning.py", "lm_init", "parallel/learner.py:680 plane_train_fn"),
    _R("learning.py", "lm_update", "parallel/learner.py:680 plane_train_fn"),
    _R("learning.py", "lm_finalize",
       "parallel/learner.py:680 plane_train_fn"),
    # sequence_learner.py:198 — the recurrent host-batch train step
    _R("parallel/sequence_learner.py", "SequenceLearner._step_core",
       "parallel/sequence_learner.py:198 <lambda>"),
    # sequence_learner.py:226/:235 — the per-step ring path: the window
    # gather (one B1 launch) and the block composition before the core
    _R("ops/ring_gather.py", "gather_windows",
       "parallel/sequence_learner.py:226 sample_fn"),
    _R("replay/device_sequence.py", "compose_sequence_block",
       "parallel/sequence_learner.py:235 train_fn"),
    # sequence_learner.py:297/:330 — the fused sequence sample and chain
    _R("parallel/sequence_learner.py", "fused_sequence_sample",
       "parallel/sequence_learner.py:297 sample_fn"),
    _R("parallel/sequence_learner.py", "SequenceLearner.train_steps_fused",
       "parallel/sequence_learner.py:330 train_fn"),
    # sequence_learner.py:451 — SequenceSolver's forward: the net's
    # (q_values around it is the host's copy in and out)
    _R("models/qnet.py", "R2d2QNet.forward",
       "parallel/sequence_learner.py:451 <lambda>"),
    # anakin.py:217 — the envs' first reset
    _R("ops/device_envs.py", "make_signal_env.reset_fn",
       "parallel/anakin.py:217 _init"),
    _R("ops/device_envs.py", "make_velocity_signal_env.reset_fn",
       "parallel/anakin.py:217 _init"),
    # anakin.py:274 — the superstep body: act (T ticks, the env step),
    # the insert, then fused_sample and _train_chain (above)
    _R("parallel/anakin.py", "act_tick", "parallel/anakin.py:274 "
       "superstep_body"),
    _R("parallel/anakin.py", "AnakinRunner._act",
       "parallel/anakin.py:274 superstep_body"),
    _R("parallel/anakin.py", "AnakinRunner._insert",
       "parallel/anakin.py:274 superstep_body"),
    _R("ops/device_envs.py", "make_signal_env.step_fn",
       "parallel/anakin.py:274 superstep_body"),
    _R("ops/device_envs.py", "make_velocity_signal_env.step_fn",
       "parallel/anakin.py:274 superstep_body"),
    # qnet.py:359 — the recurrent net's apply: every module it runs
    _R("models/qnet.py", "R2d2QNet.features",
       "models/qnet.py:359 <lambda>"),
    _R("models/qnet.py", "R2d2QNet.features_stacked",
       "models/qnet.py:359 <lambda>"),
    _R("models/qnet.py", "R2d2QNet.burn_carry",
       "models/qnet.py:359 <lambda>"),
    _R("models/qnet.py", "R2d2QNet.recur", "models/qnet.py:359 <lambda>"),
    _R("models/qnet.py", "_Lstm.forward", "models/qnet.py:359 <lambda>"),
    # qnet.py:362 — the feed-forward nets' apply: every module they run
    _R("models/qnet.py", "NatureCnnQNet.forward",
       "models/qnet.py:362 <lambda>"),
    _R("models/qnet.py", "NatureCnnQNet.forward_nchw",
       "models/qnet.py:362 <lambda>"),
    _R("models/qnet.py", "MlpQNet.forward", "models/qnet.py:362 <lambda>"),
    _R("models/qnet.py", "MlpQNet.forward_nchw",
       "models/qnet.py:362 <lambda>"),
    _R("models/qnet.py", "_NatureTorso.forward",
       "models/qnet.py:362 <lambda>"),
    _R("models/qnet.py", "_MlpTorso.forward", "models/qnet.py:362 <lambda>"),
    _R("models/qnet.py", "_Conv.forward", "models/qnet.py:362 <lambda>"),
    _R("models/qnet.py", "_Dense.forward", "models/qnet.py:362 <lambda>"),
    _R("models/qnet.py", "_Head.forward", "models/qnet.py:362 <lambda>"),
    # policy.py:65 — the batched policy's forward on a staged batch
    _R("models/policy.py", "BatchedPolicy.q_values",
       "models/policy.py:65 <lambda>"),
    # the four Pallas kernel bodies: each kernel's plain version, and the
    # wrapper that launches the CUDA kernel in its place
    _R("ops/ring_gather.py", "gather_windows_plain",
       "ops/ring_gather.py:102 _gather_kernel"),
    _R("ops/ring_gather.py", "scatter_rows_plain",
       "ops/ring_gather.py:108 _scatter_kernel"),
    _R("ops/ring_gather.py", "scatter_rows",
       "ops/ring_gather.py:108 _scatter_kernel"),
    _R("ops/fused_loss.py", "fused_loss_fwd_plain",
       "ops/pallas_kernels.py:55 _fwd_kernel"),
    _R("ops/fused_loss.py", "FusedDqnLoss.forward",
       "ops/pallas_kernels.py:55 _fwd_kernel"),
    _R("ops/fused_loss.py", "fused_loss_bwd_plain",
       "ops/pallas_kernels.py:67 _bwd_kernel"),
    _R("ops/fused_loss.py", "FusedDqnLoss.backward",
       "ops/pallas_kernels.py:67 _bwd_kernel"),
)
del _R

# reference roots with no device function in the port, and why
NO_COUNTERPART = {
    "parallel/anakin.py:236 <lambda>":
        "it converts θ, θ⁻ and the Adam moments into the flat planes the "
        "reference's Anakin scan carries; the port's superstep trains "
        "solver.state in place, so there is no conversion to run",
}

_TIME_PREFIXES = ("time.", "datetime.")
_TRACER_PREFIX = "tracing."
_RNG_PREFIXES = ("random.", "np.random.", "numpy.random.")
_RNG_NAMES = {"torch.Generator", "torch.manual_seed", "torch.seed",
              "torch.cuda.manual_seed", "torch.cuda.manual_seed_all"}
_HOST_SYNC = {"np.asarray", "np.array", "numpy.asarray", "numpy.array",
              "torch.cuda.synchronize"}
# method tails that read the device from the host (or wait for it)
_SYNC_TAILS = {"item", "cpu", "tolist", "numpy", "synchronize"}
_LOG_METHODS = {"debug", "info", "warning", "warn", "error", "exception",
                "critical"}

# capture wrappers whose first argument is captured code
_WRAPPER_CALLS = {"torch.compile", "torch.cuda.make_graphed_callables"}
_WRAPPER_DECORATORS = {"torch.compile"}
_GRAPH_CONTEXTS = {"torch.cuda.graph"}

_FuncNode = ast.FunctionDef | ast.AsyncFunctionDef | ast.Lambda


class _Region(ast.stmt):
    """Inline captured statements — a ``with torch.cuda.graph(...)`` body
    or a ``capture_begin()``..``capture_end()`` span — linted as a scope
    whose locals are the enclosing function's."""

    _fields = ("body",)

    def __init__(self, body: list, lineno: int, locals_: set[str]):
        super().__init__()
        self.body = body
        self.lineno = lineno
        self.locals_ = locals_


def _last(name: str | None) -> str | None:
    return name.rsplit(".", 1)[-1] if name else None


def _unwrap_partial(node: ast.AST) -> ast.AST:
    """``functools.partial(f, ...)`` / ``partial(f, ...)`` → ``f``."""
    if isinstance(node, ast.Call) and _last(call_name(node)) == "partial" \
            and node.args:
        return node.args[0]
    return node


class _ModuleIndex:
    """Function defs of one module, by bare name (a reused name maps to
    ALL its defs; linting an extra candidate is over-strict, never
    unsound), plus which names are top-level (eligible for cross-module
    calls)."""

    def __init__(self, src: Source):
        self.src = src
        self.by_name: dict[str, list[_FuncNode]] = {}
        self.top_level: set[str] = set()
        # id(def or lambda) → its innermost enclosing class; (class, name)
        # → that class's own methods of that name
        self.owner: dict[int, str] = {}
        self.methods: dict[tuple[str, str], list[_FuncNode]] = {}
        for node in src.nodes(ast.FunctionDef, ast.AsyncFunctionDef):
            self.by_name.setdefault(node.name, []).append(node)
        for node in src.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.top_level.add(node.name)
        for cls in src.nodes(ast.ClassDef):   # outer classes first
            for item in cls.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    self.methods.setdefault((cls.name, item.name),
                                            []).append(item)
            for node in ast.walk(cls):
                if isinstance(node, _FuncNode):
                    self.owner[id(node)] = cls.name

    def self_call(self, caller: ast.AST, name: str) -> list[_FuncNode]:
        """``self.<name>`` called from ``caller``: the caller's class's own
        method where it has one, else every def of that name here."""
        own = self.methods.get((self.owner.get(id(caller), ""), name))
        return own or self.by_name.get(name, [])


def _alias_targets(value: ast.AST) -> list[str]:
    """Function names an assignment RHS can resolve to: a bare ``f``, a
    ``partial(f, ...)``, or a static gate picking between builders —
    ``step = graphed_fn if use_graph else eager_fn``; both branches are
    roots."""
    value = _unwrap_partial(value)
    if isinstance(value, ast.IfExp):
        return _alias_targets(value.body) + _alias_targets(value.orelse)
    if isinstance(value, ast.Name):
        return [value.id]
    return []


def _local_aliases(src: Source) -> dict[str, list[str]]:
    """``x = f`` / ``x = partial(f, ...)`` / ``x = f if gate else g``
    anywhere in the module → {x: [f, ...]} for resolving wrapper
    arguments passed by name."""
    out: dict[str, list[str]] = {}
    for node in src.nodes(ast.Assign):
        if len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            for name in _alias_targets(node.value):
                out.setdefault(node.targets[0].id, []).append(name)
    return out


def _find_qualname(tree: ast.Module, qualname: str) -> _FuncNode | None:
    """The def at ``qualname`` (``Class.method``, ``func``,
    ``outer.inner``): each part a class or function defined directly in
    the previous one's body."""
    scope: list = tree.body
    node = None
    for part in qualname.split("."):
        node = next((n for n in scope
                     if isinstance(n, (ast.ClassDef, ast.FunctionDef,
                                       ast.AsyncFunctionDef))
                     and n.name == part), None)
        if node is None:
            return None
        scope = node.body
    return node if isinstance(node, _FuncNode) else None


def _is_wrapper_call(node: ast.Call) -> bool:
    return call_name(node) in _WRAPPER_CALLS


def _capture_regions(idx: _ModuleIndex) -> list[_Region]:
    """``with torch.cuda.graph(...)`` bodies and ``capture_begin()`` ..
    ``capture_end()`` statement spans, each with its enclosing function's
    locals (none at module level)."""
    regions: list[_Region] = []
    scopes = [(idx.src.tree, set())] + [
        (fn, _scope_locals(fn))
        for fn in idx.src.nodes(ast.FunctionDef, ast.AsyncFunctionDef)]
    for scope, locals_ in scopes:
        for node in _own_nodes(scope):
            if isinstance(node, (ast.With, ast.AsyncWith)) and any(
                    isinstance(it.context_expr, ast.Call)
                    and call_name(it.context_expr) in _GRAPH_CONTEXTS
                    for it in node.items):
                regions.append(_Region(node.body, node.lineno, locals_))
            for field in ("body", "orelse", "finalbody"):
                block = getattr(node, field, None)
                if isinstance(block, list):
                    regions.extend(_capture_spans(block, locals_))
    return regions


def _own_nodes(scope: ast.AST) -> list[ast.AST]:
    """``scope`` and the nodes under it, not descending into nested
    function or class scopes (they are scanned as scopes of their own)."""
    out = [scope]
    todo = list(ast.iter_child_nodes(scope))
    while todo:
        node = todo.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef, ast.Lambda)):
            continue
        out.append(node)
        todo.extend(ast.iter_child_nodes(node))
    return out


def _capture_spans(block: list, locals_: set[str]) -> list[_Region]:
    """Statement spans of ``block`` strictly between an expression
    statement ``<g>.capture_begin(...)`` and ``<g>.capture_end()``."""

    def marker(stmt: ast.stmt, tail: str) -> bool:
        return (isinstance(stmt, ast.Expr) and isinstance(stmt.value,
                                                          ast.Call)
                and _last(call_name(stmt.value)) == tail)

    out: list[_Region] = []
    start = None
    for i, stmt in enumerate(block):
        if marker(stmt, "capture_begin"):
            start = i
        elif marker(stmt, "capture_end") and start is not None:
            if i > start + 1:
                out.append(_Region(block[start + 1:i],
                                   block[start + 1].lineno, locals_))
            start = None
    return out


def _collect_roots(idx: _ModuleIndex,
                   declared: tuple[str, ...] = ()) -> list:
    roots: list = []
    seen: set[int] = set()

    def add(node: ast.AST | None) -> None:
        if isinstance(node, (*_FuncNode.__args__, _Region)) \
                and id(node) not in seen:
            seen.add(id(node))
            roots.append(node)

    aliases = _local_aliases(idx.src)

    def resolve(arg: ast.AST) -> None:
        arg = _unwrap_partial(arg)
        if isinstance(arg, ast.Lambda):
            add(arg)
        elif isinstance(arg, ast.IfExp):
            resolve(arg.body)
            resolve(arg.orelse)
        elif isinstance(arg, (ast.Tuple, ast.List)):
            for el in arg.elts:
                resolve(el)
        elif isinstance(arg, ast.Attribute) \
                and isinstance(arg.value, ast.Name) \
                and arg.value.id in ("self", "cls"):
            for fn in idx.by_name.get(arg.attr, []):
                add(fn)
        elif isinstance(arg, ast.Name):
            for name in aliases.get(arg.id, [arg.id]):
                for fn in idx.by_name.get(name, []):
                    add(fn)

    for qualname in declared:
        fn = _find_qualname(idx.src.tree, qualname)
        if fn is None:
            raise LookupError(
                f"DEVICE_ROOTS names {idx.src.path}:{qualname}, which "
                "does not exist: a renamed device-step function must be "
                "renamed in the table too")
        add(fn)
    for node in idx.src.nodes(ast.Call):
        if _is_wrapper_call(node) and node.args:
            resolve(node.args[0])
    for node in idx.src.nodes(ast.FunctionDef, ast.AsyncFunctionDef):
        for dec in node.decorator_list:
            target = dec.func if isinstance(dec, ast.Call) else dec
            name = dotted(target)
            if name in _WRAPPER_DECORATORS:
                add(node)
            elif _last(name) == "partial" and isinstance(dec, ast.Call) \
                    and dec.args \
                    and dotted(dec.args[0]) in _WRAPPER_DECORATORS:
                add(node)
    for region in _capture_regions(idx):
        add(region)
    return roots


def _expand(roots: list, idx: _ModuleIndex,
            global_index: dict[str, tuple[_ModuleIndex, _FuncNode]],
            ) -> list[tuple[_ModuleIndex, ast.AST]]:
    """Transitive closure of statically-resolvable callees."""
    work = [(idx, r) for r in roots]
    seen = {id(r) for r in roots}
    out: list[tuple[_ModuleIndex, ast.AST]] = []
    while work:
        mod, fn = work.pop()
        out.append((mod, fn))
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node)
            if name is None:
                continue
            targets: list[tuple[_ModuleIndex, _FuncNode]] = []
            parts = name.split(".")
            if len(parts) == 1:
                local = mod.by_name.get(parts[0], [])
                if local:
                    targets = [(mod, f) for f in local]
                elif parts[0] in global_index:
                    targets = [global_index[parts[0]]]
            elif len(parts) == 2 and parts[0] in ("self", "cls"):
                targets = [(mod, f) for f in mod.self_call(fn, parts[1])]
            for target in targets:
                if id(target[1]) not in seen:
                    seen.add(id(target[1]))
                    work.append(target)
    return out


def _scope_locals(fn: ast.AST) -> set[str]:
    """Names bound inside this scope (args + assignments), not
    descending into nested function scopes; a region's are its
    enclosing function's plus its own."""
    names: set[str] = set()
    if isinstance(fn, _Region):
        names.update(fn.locals_)
    else:
        a = fn.args
        for arg in [*a.posonlyargs, *a.args, *a.kwonlyargs]:
            names.add(arg.arg)
        if a.vararg:
            names.add(a.vararg.arg)
        if a.kwarg:
            names.add(a.kwarg.arg)

    def collect_target(t: ast.AST) -> None:
        # only Store-context names BIND: in ``stats["k"] = v`` the base
        # ``stats`` is a Load and stays captured, not local
        for n in ast.walk(t):
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store):
                names.add(n.id)

    def handle(node: ast.AST) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names.add(node.name)
            return  # nested scope: only its name binds here
        if isinstance(node, ast.Lambda):
            return
        if isinstance(node, ast.Assign):
            for t in node.targets:
                collect_target(t)
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign,
                               ast.For, ast.AsyncFor)):
            collect_target(node.target)
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                if item.optional_vars is not None:
                    collect_target(item.optional_vars)
        elif isinstance(node, ast.NamedExpr):
            collect_target(node.target)
        elif isinstance(node, ast.comprehension):
            collect_target(node.target)
        elif isinstance(node, ast.ExceptHandler) and node.name:
            names.add(node.name)
        for child in ast.iter_child_nodes(node):
            handle(child)

    body = fn.body if isinstance(fn.body, list) else [fn.body]
    for stmt in body:
        handle(stmt)
    return names


def _base_name(node: ast.AST) -> str | None:
    """Leftmost Name of an Attribute/Subscript chain."""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _lint_calls(fn: ast.AST, src: Source, out: list[Finding]) -> None:
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        name = call_name(node)
        if name is None:
            if isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _SYNC_TAILS and not node.args:
                src.finding("purity.host-sync", node,
                            f".{node.func.attr}() reads the device from "
                            "the host inside a device-step function", out)
            continue
        last = _last(name)
        if name == "print":
            src.finding("purity.print", node,
                        "print() inside a device-step function runs only "
                        "at capture time under a CUDA graph", out)
        elif name.startswith("logging.") or (
                "." in name and name.split(".", 1)[0] in ("log", "logger")
                and last in _LOG_METHODS):
            src.finding("purity.logging", node,
                        f"{name}() inside a device-step function runs only "
                        "at capture time under a CUDA graph", out)
        elif name.startswith(_TIME_PREFIXES):
            src.finding("purity.time", node,
                        f"{name}() is a capture-time constant inside a "
                        "device-step function", out)
        elif name.startswith(_TRACER_PREFIX):
            src.finding("purity.time", node,
                        f"{name}() reads the host's clock inside a "
                        "device-step function: under a CUDA graph it is "
                        "stamped once, at capture, and never on replay",
                        out)
        elif name.startswith(_RNG_PREFIXES) or name in _RNG_NAMES:
            src.finding("purity.host-rng", node,
                        f"{name}() is host RNG — a capture-time constant "
                        "inside a device-step function (draw on the device "
                        "from threefry keys)", out)
        elif name in _HOST_SYNC or (last in _SYNC_TAILS and "." in name
                                    and not node.args):
            src.finding("purity.host-sync", node,
                        f"{name}() reads the device from the host (a sync) "
                        "inside a device-step function", out)


def _lint_writes(fn: ast.AST, src: Source, out: list[Finding]) -> None:
    locals_ = _scope_locals(fn)
    body = fn.body if isinstance(fn.body, list) else [fn.body]

    def check_target(t: ast.AST, node: ast.AST) -> None:
        if isinstance(t, (ast.Attribute, ast.Subscript)):
            base = _base_name(t)
            if base is not None and (base in ("self", "cls")
                                     or base not in locals_):
                src.finding("purity.captured-write", node,
                            f"mutation of captured state {base!r} inside a "
                            "device-step function (under a CUDA graph it "
                            "happens once, at capture)", out)
        elif isinstance(t, (ast.Tuple, ast.List)):
            for el in t.elts:
                check_target(el, node)

    def handle(node: ast.AST) -> None:
        if isinstance(node, _FuncNode):
            _lint_writes(node, src, out)  # fresh scope, own locals
            return
        if isinstance(node, ast.Assign):
            for t in node.targets:
                check_target(t, node)
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            check_target(node.target, node)
        elif isinstance(node, (ast.Global, ast.Nonlocal)):
            kw = "global" if isinstance(node, ast.Global) else "nonlocal"
            src.finding("purity.captured-write", node,
                        f"{kw} statement inside a device-step function",
                        out)
        for child in ast.iter_child_nodes(node):
            handle(child)

    for stmt in body:
        handle(stmt)


def check_sources(sources: list[Source],
                  device_roots: tuple[DeviceRoot, ...] = DEVICE_ROOTS
                  ) -> list[Finding]:
    """Lint every root of ``sources``: the ``device_roots`` entries whose
    file (package-relative) is one of them, and the capture wrappers'
    arguments found in them."""
    declared: dict[str, list[str]] = {}
    for root in device_roots:
        declared.setdefault(pkg(root.file), []).append(root.qualname)
    out: list[Finding] = []
    indexes = [_ModuleIndex(s) for s in sources]
    global_index: dict[str, tuple[_ModuleIndex, _FuncNode]] = {}
    ambiguous: set[str] = set()
    for idx in indexes:
        for name in idx.top_level:
            fns = idx.by_name.get(name, [])
            if len(fns) != 1:
                continue  # reused within its own module: not a unique target
            if name in global_index:
                ambiguous.add(name)
            global_index[name] = (idx, fns[0])
    for name in ambiguous:
        global_index.pop(name, None)

    linted: set[int] = set()
    for idx in indexes:
        path = idx.src.path.replace(os.sep, "/")
        roots = _collect_roots(idx, tuple(declared.get(path, ())))
        for mod, fn in _expand(roots, idx, global_index):
            if id(fn) in linted:
                continue
            linted.add(id(fn))
            _lint_calls(fn, mod.src, out)
            _lint_writes(fn, mod.src, out)
    # a nested def can be linted via its parent's subtree AND via call
    # expansion — keep one copy of each finding
    uniq: dict[tuple, Finding] = {}
    for f in out:
        uniq.setdefault((f.rule, f.path, f.line, f.message), f)
    return list(uniq.values())


def check(repo_root: str) -> list[Finding]:
    paths = set(package_files(repo_root, SCAN_DIRS, tools=False))
    for root in DEVICE_ROOTS:
        full = os.path.normpath(os.path.join(repo_root, pkg(root.file)))
        if not os.path.exists(full):
            raise LookupError(f"DEVICE_ROOTS names {pkg(root.file)}, which "
                              "does not exist")
        paths.add(full)
    return check_sources(load_sources(
        repo_root, sorted({os.path.normpath(p) for p in paths})))
