"""Shared infrastructure for the port's static-analysis suite.

The passes in this package (``locks``, ``purity``, ``protocol_drift``,
``config_keys``) are AST checkers that understand *this* codebase's
invariants — which attribute is guarded by which lock, which functions
are jit-traced, which strings are RPC methods — rather than generic
lint rules. This module holds what they share:

- ``Finding`` — one (rule, file, line, message) result.
- ``Source``  — a parsed file plus its ``# ddq: allow(<rule>)`` pragma
  map; ``Source.finding`` is the ONLY way passes emit results, so
  suppression is honored uniformly.
- ``dotted`` / ``call_name`` — attribute-chain helpers ("self.replay_lock",
  "np.random.normal") used by every pass.
- ``PACKAGE`` / ``pkg`` / ``package_files`` — the one place that names the
  scanned package: every pass scans it, and only it (never ``tests/`` or
  ``scripts/``), and every registry path is built with ``pkg``.
- ``TOOL_MODULES`` — the port's tools, which live inside the package
  where the reference keeps their twins under ``scripts/``. A pass that
  scans ``scripts/`` in the reference (``config_keys``, ``metric_keys``,
  ``protocol_drift``'s emit scan) scans them; one that does not
  (``atomic_writes``, ``locks``, ``threads``, ``blocking``, ``purity``)
  leaves them out (``package_files(..., tools=False)``).

Suppression pragma: an end-of-line comment ``# ddq: allow(rule)`` (or
``allow(rule-a, rule-b)`` / ``allow(*)``) silences findings of that rule
on that line only. Rules match by exact name or by pass prefix — e.g.
``allow(purity)`` covers ``purity.print``.
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field

PACKAGE = "distributed_deep_q_tpu_torch"

# package-relative: the chaos harness, the fleet soak, the telemetry
# report, the bench and the dispatch split, each run as
# ``python -m distributed_deep_q_tpu_torch.<tool>``
TOOL_MODULES = ("chaos_smoke.py", "fleet_smoke.py", "telemetry_report.py",
                "bench.py", "bench_multihost_worker.py", "bench_diff.py",
                "trace_report.py", "bench_elasticity.py",
                "dispatch_phases.py")

_PRAGMA = re.compile(r"#\s*ddq:\s*allow\(([^)]*)\)")

# parse memo: five passes walk the whole tree and ast.parse dominates
# gate wall time — share one parsed Source per (path, mtime, size).
# Sources are never mutated by passes (findings route through the
# caller-owned ``out`` list), so sharing is safe
_PARSE_CACHE: dict[tuple, "Source"] = {}


@dataclass(frozen=True)
class Finding:
    """One analyzer result, formatted ``path:line: [rule] message``."""

    rule: str
    path: str
    line: int
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


@dataclass
class Source:
    """A parsed module + pragma map; findings route through here."""

    path: str            # path as reported in findings (repo-relative)
    text: str
    tree: ast.Module
    allow: dict[int, set[str]] = field(default_factory=dict)
    _flat: list | None = field(default=None, repr=False, compare=False)
    _by_type: dict | None = field(default=None, repr=False, compare=False)

    def walk(self) -> list:
        """Cached flat node list in ``ast.walk`` order (parents before
        children). Passes that sweep whole modules filter this instead
        of re-traversing — with several tree-wide passes per gate run,
        traversal cost is paid once per file."""
        if self._flat is None:
            self._flat = list(ast.walk(self.tree))
        return self._flat

    def nodes(self, *types: type) -> list:
        """Module-wide nodes of the given exact AST type(s), in
        ``walk()`` order. Bucketing by ``type(node)`` is built once per
        file, so a pass that only cares about Calls iterates ~15% of
        the tree instead of isinstance-filtering all of it. Exact-type
        lookup is sound for ast nodes (the stdlib grammar classes have
        no subclasses in the tree); callers that accept a family pass
        each member, e.g. ``nodes(ast.FunctionDef,
        ast.AsyncFunctionDef)``."""
        if self._by_type is None:
            by: dict[type, list] = {}
            for n in self.walk():
                by.setdefault(type(n), []).append(n)
            self._by_type = by
        if len(types) == 1:
            return self._by_type.get(types[0], [])
        out: list = []
        for t in types:
            out.extend(self._by_type.get(t, []))
        return out

    @classmethod
    def load(cls, abspath: str, relpath: str | None = None) -> "Source":
        key = None
        try:
            st = os.stat(abspath)
            key = (abspath, relpath, st.st_mtime_ns, st.st_size)
        except OSError:
            pass
        if key is not None and key in _PARSE_CACHE:
            return _PARSE_CACHE[key]
        with open(abspath, encoding="utf-8") as f:
            text = f.read()
        src = cls.parse(text, relpath or abspath)
        if key is not None:
            _PARSE_CACHE[key] = src
        return src

    @classmethod
    def parse(cls, text: str, path: str) -> "Source":
        tree = ast.parse(text, filename=path)
        allow: dict[int, set[str]] = {}
        for lineno, line in enumerate(text.splitlines(), start=1):
            m = _PRAGMA.search(line)
            if m:
                rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
                allow[lineno] = rules
        return cls(path=path, text=text, tree=tree, allow=allow)

    def suppressed(self, rule: str, line: int) -> bool:
        allowed = self.allow.get(line)
        if not allowed:
            return False
        if "*" in allowed or rule in allowed:
            return True
        # pass-prefix match: allow(purity) covers purity.print etc.
        return any(rule.startswith(a + ".") for a in allowed)

    def finding(self, rule: str, node_or_line, message: str,
                out: list[Finding]) -> None:
        line = (node_or_line if isinstance(node_or_line, int)
                else getattr(node_or_line, "lineno", 0))
        if not self.suppressed(rule, line):
            out.append(Finding(rule, self.path, line, message))


def dotted(node: ast.AST) -> str | None:
    """``a.b.c`` for a pure Name/Attribute chain, else None (calls,
    subscripts, and anything computed break the chain)."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_name(call: ast.Call) -> str | None:
    """Dotted name of a call's target, or None when computed."""
    return dotted(call.func)


def iter_py_files(root: str, subdirs: tuple[str, ...] = ()) -> list[str]:
    """All ``.py`` files under ``root`` (or its listed subdirs), sorted.
    Skips __pycache__ and hidden directories."""
    bases = [os.path.join(root, d) for d in subdirs] if subdirs else [root]
    out: list[str] = []
    for base in bases:
        if os.path.isfile(base) and base.endswith(".py"):
            out.append(base)
            continue
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames[:] = [d for d in dirnames
                           if d != "__pycache__" and not d.startswith(".")]
            out.extend(os.path.join(dirpath, f) for f in filenames
                       if f.endswith(".py"))
    return sorted(out)


def load_sources(root: str, paths: list[str]) -> list[Source]:
    """Load files as Sources with repo-relative finding paths."""
    srcs = []
    for p in paths:
        rel = os.path.relpath(p, root)
        srcs.append(Source.load(p, rel))
    return srcs


def pkg(*parts: str) -> str:
    """The repo-relative path of ``parts`` (joined with ``/``) inside the
    scanned package. Registries spell a path as its segments: a literal
    ``"rpc/replay_server.py"`` would read as a metric name of the
    ``rpc/`` namespace to ``metric_keys``."""
    return "/".join((PACKAGE,) + parts)


TOOL_FILES = tuple(pkg(m) for m in TOOL_MODULES)


def package_files(root: str, subdirs: tuple[str, ...] = (),
                  tools: bool = True) -> list[str]:
    """The package's ``.py`` files under ``root`` (or under its listed
    package-relative ``subdirs``), sorted; ``tools=False`` leaves out the
    tool modules."""
    base = os.path.join(root, PACKAGE)
    if not os.path.isdir(base):
        return []
    paths = iter_py_files(base, subdirs)
    if tools:
        return paths
    skip = {os.path.normpath(os.path.join(root, f)) for f in TOOL_FILES}
    return [p for p in paths if os.path.normpath(p) not in skip]
