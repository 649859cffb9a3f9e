"""Atomic-write discipline — persisted bytes go through ``utils.durability``.

The durability plane (ISSUE 6) guarantees crash consistency only for
bytes written through ``atomic_write`` / ``GenerationStore``: a direct
``open(path, "wb")``, ``np.savez(path, ...)``, ``arr.tofile(path)`` or
``pickle.dump`` to a real path reintroduces exactly the torn-write
window the plane closed — a crash mid-write leaves garbage at the final
path with no checksum to catch it. This pass flags every such raw
binary-write call site in the package so the discipline holds as code
grows (the next snapshot format, the multi-host shard files of ROADMAP
item 3, ...).

What is flagged (rule ``durability.raw-write``):

- ``open(..., mode)`` where ``mode`` is a string literal selecting a
  binary write ("wb", "ab", "xb", "rb+", "wb+", ...). Binary *reads*
  and all text modes pass — the hazard is persisted binary state, and
  text writes in the package are append-only JSONL logs.
- ``np.save`` / ``np.savez`` / ``np.savez_compressed`` with a non-BytesIO
  first argument (``savez_bytes`` serializes to memory; a literal path
  or path variable is a raw disk write).
- ``<anything>.tofile(...)`` and ``pickle.dump`` — always raw.
- ``torch.save`` (port) with a sink that is not an in-memory buffer —
  the torch twin of ``np.save``, and a pickle besides.

The port streams a large payload into the tmp file instead of building
it in memory first: ``atomic_write(path, lambda f: np.savez(f, ...))``
(the replay file, the checkpoint's ``torch.save``). A writer whose sink
is the parameter of a lambda handed to ``atomic_write`` writes into the
tmp file that ``atomic_write`` fsyncs and renames, so it is not flagged.
The reference's pass has no such case to know (its tree serializes with
``savez_bytes`` and hands ``atomic_write`` bytes).

``utils/durability.py`` itself is exempt (it IS the primitive), and a
``# ddq: allow(durability.raw-write)`` pragma covers deliberate
exceptions, as everywhere in the suite.

Scope: the port package without its tool modules (``core.TOOL_MODULES``),
as the reference's pass scans its package and not ``scripts/``, where
the twins of those tools live: the chaos harness's deliberately torn
write is a tool's, not persisted state's.
"""

from __future__ import annotations

import ast

from distributed_deep_q_tpu_torch.analysis.core import (
    Finding, Source, call_name, load_sources, package_files, pkg)

RULE = "durability.raw-write"
EXEMPT_FILES = (pkg("utils", "durability.py"),)

_NP_WRITERS = ("save", "savez", "savez_compressed")


def _binary_write_mode(call: ast.Call) -> str | None:
    """The mode-string literal of an ``open`` call iff it selects a
    binary write; None otherwise (text, read-only, or non-literal)."""
    mode_node = None
    if len(call.args) >= 2:
        mode_node = call.args[1]
    for kw in call.keywords:
        if kw.arg == "mode":
            mode_node = kw.value
    if not isinstance(mode_node, ast.Constant) \
            or not isinstance(mode_node.value, str):
        return None
    mode = mode_node.value
    if "b" in mode and any(c in mode for c in "wax+"):
        return mode
    return None


def _memory_sink(call: ast.Call) -> bool:
    """True when np.save*'s first argument (torch.save's second) is
    clearly an in-memory buffer (``io.BytesIO(...)`` or a name like
    ``buf``/``bio``), which is the one legitimate non-atomic use."""
    first = _sink_arg(call)
    if first is None:
        return False
    if isinstance(first, ast.Call):
        name = call_name(first) or ""
        return name.split(".")[-1] == "BytesIO"
    if isinstance(first, ast.Name):
        return first.id in ("buf", "bio", "buffer", "stream")
    return False


def _tmp_file_sinks(src: Source) -> set[int]:
    """ids of the writer calls that stream into ``atomic_write``'s tmp
    file: inside ``atomic_write(path, lambda f: ...)``, a ``np.save*``
    whose first argument (a ``torch.save`` whose second) is ``f``."""
    out: set[int] = set()
    for call in src.nodes(ast.Call):
        name = call_name(call) or ""
        if name.split(".")[-1] != "atomic_write" or len(call.args) < 2:
            continue
        fn = call.args[1]
        if not isinstance(fn, ast.Lambda) or not fn.args.args:
            continue
        param = fn.args.args[0].arg
        for node in ast.walk(fn.body):
            if not isinstance(node, ast.Call):
                continue
            sink = _sink_arg(node)
            if isinstance(sink, ast.Name) and sink.id == param:
                out.add(id(node))
    return out


def _sink_arg(call: ast.Call) -> ast.AST | None:
    """The argument a ``np.save*`` / ``torch.save`` call writes to."""
    name = call_name(call) or ""
    pos = 1 if name == "torch.save" else 0
    return call.args[pos] if len(call.args) > pos else None


def check_sources(sources: list[Source]) -> list[Finding]:
    out: list[Finding] = []
    for src in sources:
        if src.path in EXEMPT_FILES:
            continue
        streamed = _tmp_file_sinks(src)
        for node in src.nodes(ast.Call):
            name = call_name(node)
            if name is None:
                continue
            if name == "open":
                mode = _binary_write_mode(node)
                if mode is not None:
                    src.finding(
                        RULE, node,
                        f"open(..., {mode!r}) writes binary bytes to a "
                        "path directly — route persisted state through "
                        "utils.durability.atomic_write (tmp + fsync + "
                        "rename) so a crash cannot leave a torn file",
                        out)
            elif name.split(".")[-1] in _NP_WRITERS and \
                    name.split(".")[0] in ("np", "numpy", "jnp"):
                if not _memory_sink(node) and id(node) not in streamed:
                    src.finding(
                        RULE, node,
                        f"{name}(...) serializes straight to the final "
                        "path — use durability.savez_bytes + atomic_write "
                        "(or GenerationStore.commit) so the write is "
                        "atomic and checksummed", out)
            elif name == "torch.save":
                if not _memory_sink(node) and id(node) not in streamed:
                    src.finding(
                        RULE, node,
                        "torch.save(...) pickles straight to the final "
                        "path — hand it to utils.durability.atomic_write "
                        "as a callback on the tmp file", out)
            elif name.endswith(".tofile"):
                src.finding(
                    RULE, node,
                    f"{name}(...) is a raw unbuffered disk write — "
                    "persisted state must go through "
                    "utils.durability.atomic_write", out)
            elif name in ("pickle.dump", "pickle.dumps"):
                src.finding(
                    RULE, node,
                    f"{name}(...) — pickle is banned on persisted paths "
                    "(code execution on load, no integrity check); use "
                    "the npz + manifest format via utils.durability", out)
    return out


def check(repo_root: str) -> list[Finding]:
    return check_sources(load_sources(
        repo_root, package_files(repo_root, tools=False)))
