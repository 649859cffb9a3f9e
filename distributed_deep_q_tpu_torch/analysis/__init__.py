"""The port's static analysis — machine-checked concurrency, device-step
and RPC invariants of ``distributed_deep_q_tpu_torch`` (the twin of the
reference's ``analysis/``, with the port's registries and a torch purity
pass).

Eight passes, one entry point:

- ``locks``          — guarded-attribute lock discipline, static
                       lock-order deadlock detection, CV wait/notify
                       discipline
- ``threads``        — thread-lifecycle registry: every spawn site
                       declares its owner, stop mechanism, join site
- ``blocking``       — blocking calls (socket/sleep/fsync/synchronize/
                       …) while a registered lock is held, expanded
                       interprocedurally
- ``purity``         — host side effects inside the device-step
                       functions (``DEVICE_ROOTS``) and whatever
                       ``torch.compile`` / a CUDA graph captures
- ``protocol_drift`` — RPC client/server/wire skew + wire-verb resend
                       (idempotence) classes
- ``config_keys``    — ``cfg.<section>.<field>`` existence
- ``atomic_writes``  — raw binary writes bypassing the durability plane
- ``metric_keys``    — metric names vs the declared registry; span
                       names vs the tracer's stage tables

``run_all(repo_root)`` returns every finding; ``python -m
distributed_deep_q_tpu_torch.analysis`` is the CLI gate (exit non-zero on
findings), the chaos harness refuses to run on a tree it rejects, and a
tier-1 test keeps the shipped tree at zero findings. Every pass scans the
port package only (``core.PACKAGE``). Suppress an individual line with
``# ddq: allow(<rule>)`` (see ``core``).
"""

from __future__ import annotations

import os

from distributed_deep_q_tpu_torch.analysis.core import Finding, Source
from distributed_deep_q_tpu_torch.analysis import (  # noqa: F401
    atomic_writes, blocking, config_keys, locks, metric_keys,
    protocol_drift, purity, threads)

__all__ = ["Finding", "Source", "KNOWN_RULES", "run_all", "repo_root"]

# every rule the suite can emit — the gate validates ``--rule`` prefixes
# against this table so a typo'd filter fails loudly instead of
# silently matching nothing
KNOWN_RULES = (
    "locks.unguarded",
    "locks.order-cycle",
    "locks.cv-wait-no-loop",
    "locks.cv-notify-unheld",
    "threads.unregistered",
    "threads.spec-mismatch",
    "threads.no-join",
    "threads.no-stop",
    "threads.stop-unguarded",
    "blocking.under-lock",
    "purity.print",
    "purity.logging",
    "purity.time",
    "purity.host-rng",
    "purity.host-sync",
    "purity.captured-write",
    "protocol.unhandled-method",
    "protocol.orphan-handler",
    "protocol.wire-skew",
    "protocol.unclassified-verb",
    "protocol.stale-verb-class",
    "protocol.unsafe-resend",
    "config.unknown-key",
    "durability.raw-write",
    "metric_keys.unknown-metric",
    "metric_keys.unknown-span",
)


def repo_root() -> str:
    """The directory containing the ``distributed_deep_q_tpu_torch``
    package."""
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def run_all(root: str | None = None) -> list[Finding]:
    root = root or repo_root()
    findings: list[Finding] = []
    findings += locks.check(root)
    findings += threads.check(root)
    findings += blocking.check(root)
    findings += purity.check(root)
    findings += protocol_drift.check(root)
    findings += config_keys.check(root)
    findings += atomic_writes.check(root)
    findings += metric_keys.check(root)
    return sorted(findings, key=lambda f: (f.path, f.line, f.rule))
