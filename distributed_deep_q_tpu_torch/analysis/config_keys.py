"""Config-key checker — every ``cfg.<section>.<field>`` must exist.

``Config`` is a dataclass tree (``config.py``): sections are the
``Config`` fields (``net``, ``replay``, ``train``, ``env``, ``actors``,
``mesh``), each a dataclass with typed fields. ``getattr`` on a typo'd
field raises only when the code path runs — which for rarely-exercised
branches (multi-host, chaos, profiling) can be never in tests and
always in production. This pass checks statically:

- The section/field tables are parsed from ``config.py`` itself (an
  AnnAssign walk), so adding a config field needs no analyzer change.
- Any attribute chain ``<root>.<section>.<field>`` where ``<root>`` is
  a recognized config expression (``cfg``, ``c`` in the presets,
  ``self.cfg``, ``self.config``) and ``<section>`` is a known section
  is checked: unknown field → ``config.unknown-key``.
- Chains whose middle attribute is not a section are skipped — ``cfg``
  locals of narrower types (a bare ``TrainConfig`` named ``cfg``) and
  unrelated objects must not false-positive.

Scope: the port package, its tool modules (the twins of the
reference's ``scripts/``) and ``config.py``'s own presets included.
"""

from __future__ import annotations

import ast
import os

from distributed_deep_q_tpu_torch.analysis.core import (
    Finding, Source, dotted, load_sources, package_files, pkg)

CONFIG_FILE = pkg("config.py")
ROOTS = ("cfg", "c", "self.cfg", "self.config", "config")

RULE = "config.unknown-key"


def config_schema(config_src: Source) -> dict[str, set[str]]:
    """section name → set of field names, parsed from the dataclasses."""
    class_fields: dict[str, set[str]] = {}
    class_defs: dict[str, ast.ClassDef] = {}
    for node in config_src.tree.body:
        if isinstance(node, ast.ClassDef):
            class_defs[node.name] = node
            fields = set()
            for item in node.body:
                if isinstance(item, ast.AnnAssign) \
                        and isinstance(item.target, ast.Name):
                    fields.add(item.target.id)
            class_fields[node.name] = fields

    schema: dict[str, set[str]] = {}
    root = class_defs.get("Config")
    if root is None:
        return schema
    for item in root.body:
        if isinstance(item, ast.AnnAssign) \
                and isinstance(item.target, ast.Name):
            ann = item.annotation
            type_name = ann.id if isinstance(ann, ast.Name) else None
            if type_name in class_fields:
                schema[item.target.id] = class_fields[type_name]
    return schema


def check_sources(schema: dict[str, set[str]],
                  sources: list[Source]) -> list[Finding]:
    out: list[Finding] = []
    for src in sources:
        for node in src.nodes(ast.Attribute):
            # a checkable chain is <root>.<section>.<field>[...]; the
            # node ending at <field> has <section> one link in — filter
            # on that before building the full dotted chain (most
            # attribute nodes in the tree are single-link self.x/np.y)
            val = node.value
            if not isinstance(val, ast.Attribute) or val.attr not in schema:
                continue
            chain = dotted(node)
            if chain is None:
                continue
            rest = None
            for root in ROOTS:
                if chain.startswith(root + "."):
                    rest = chain[len(root) + 1:].split(".")
                    break
            if rest is None or len(rest) < 2:
                continue
            section, fld = rest[0], rest[1]
            if section in schema and fld not in schema[section]:
                src.finding(
                    RULE, node,
                    f"config key {section}.{fld} does not exist in "
                    "config.py", out)
    # ast.walk visits inner chains of the same access too — dedupe
    uniq: dict[tuple, Finding] = {}
    for f in out:
        uniq.setdefault((f.path, f.line, f.message), f)
    return list(uniq.values())


def check(repo_root: str) -> list[Finding]:
    config_src = Source.load(os.path.join(repo_root, CONFIG_FILE),
                             CONFIG_FILE)
    schema = config_schema(config_src)
    return check_sources(schema, load_sources(
        repo_root, package_files(repo_root)))
