"""The port's static-analysis gate — run every pass; exit non-zero on
findings.

    python -m distributed_deep_q_tpu_torch.analysis [--root DIR]
        [--rule PREFIX]... [--json] [--list-rules]

Runs the lock/CV-discipline checker, thread-lifecycle registry,
blocking-while-locked detector, torch purity lint, RPC protocol-drift +
verb-class detector, config-key, durability, and metric-key checkers
over the port package under ``--root`` (default: this checkout) and
prints one ``path:line: [rule] message`` line per finding (or one JSON
object per line with ``--json``). ``--rule`` (repeatable) filters
findings to the given rule name or pass prefix; an unknown prefix is an
error (exit 2), so a pre-flight whitelist can never silently match
nothing. Exit status 0 = clean, 1 = findings. Pure-CPU AST work: the
port package's ``__init__`` imports nothing, so neither does the gate.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from distributed_deep_q_tpu_torch.analysis import KNOWN_RULES, run_all


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m distributed_deep_q_tpu_torch.analysis",
        description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=None,
                        help="repo root (default: auto-detected)")
    parser.add_argument("--rule", action="append", default=[],
                        metavar="PREFIX",
                        help="only report findings whose rule matches "
                             "this name or pass prefix (repeatable)")
    parser.add_argument("--json", action="store_true",
                        help="one JSON finding object per line")
    parser.add_argument("--list-rules", action="store_true",
                        help="print every rule the suite can emit, exit 0")
    args = parser.parse_args(argv)

    if args.list_rules:
        for rule in KNOWN_RULES:
            print(rule)
        return 0

    def matches(rule: str, prefix: str) -> bool:
        return rule == prefix or rule.startswith(prefix + ".")

    for prefix in args.rule:
        if not any(matches(rule, prefix) for rule in KNOWN_RULES):
            print(f"analysis gate: unknown rule prefix {prefix!r} "
                  "(see --list-rules)", file=sys.stderr)
            return 2

    findings = run_all(args.root)
    if args.rule:
        findings = [f for f in findings
                    if any(matches(f.rule, p) for p in args.rule)]
    for f in findings:
        if args.json:
            print(json.dumps({"rule": f.rule, "path": f.path,
                              "line": f.line, "message": f.message}))
        else:
            print(f)
    # with --json, stdout stays machine-parseable (one object per line);
    # the human verdict goes to stderr
    verdict_out = sys.stderr if args.json else sys.stdout
    if findings:
        print(f"analysis gate: FAILED — {len(findings)} finding(s)",
              file=verdict_out)
        return 1
    print("analysis gate: clean", file=verdict_out)
    return 0


if __name__ == "__main__":
    rc = main()
    # skip interpreter teardown: refcount-freeing the cached AST nodes is
    # pure exit latency. Nothing here needs atexit/finalizers — flush and
    # leave.
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(rc)
