"""Run-JSONL checks of the elastic fleet (port of the reference's
``scripts/telemetry_report.py::elastic_problems``, which its ``--strict``
mode gates on; port tools live in the port package).

``elastic_problems(records)`` reads the metrics JSONL records a
``train_distributed`` run wrote (``load_records``: one dict per log tick)
and returns one line per problem: a shard handoff that lost rows, an autoscaler decision
or an applied scale action without its provenance, or an executor whose
fleet did not converge on the scaler's target. An empty list is a clean
run.
"""

from __future__ import annotations

import json

__all__ = ["elastic_problems", "load_records"]


def load_records(path: str) -> list[dict]:
    """Parse one JSONL file; raises ValueError naming the bad line."""
    records = []
    with open(path) as fh:
        for lineno, line in enumerate(fh, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{lineno}: invalid JSON ({e})")
            if not isinstance(rec, dict):
                raise ValueError(f"{path}:{lineno}: record is not an object")
            records.append(rec)
    return records


def _series(records: list[dict], key: str) -> list:
    return [r[key] for r in records if key in r]


def elastic_problems(records: list[dict]) -> list[str]:
    """Elastic-fleet failures ``--strict`` gates on: a shard
    handoff that lost rows, or an autoscaler decision that fired
    without a named finding — every decision must carry the rule and
    the burn numbers that triggered it (lineage-traceable), else the
    capacity change is an unauditable mutation of a production fleet."""
    out = []
    lost = [v for v in _series(records, "fleet/handoff_lost_rows")
            if isinstance(v, (int, float))]
    if any(v > 0 for v in lost):
        out.append(f"elastic: shard handoff lost {int(max(lost))} "
                   "row(s) — the manifest-committed export/import "
                   "round trip must be lossless")
    for i, rec in enumerate(records):
        decisions = rec.get("autoscale/decision")
        if decisions is None:
            continue
        if isinstance(decisions, dict):
            decisions = [decisions]
        if not isinstance(decisions, list):
            out.append(f"elastic: record {i}: autoscale/decision is "
                       f"{type(decisions).__name__}, not a list")
            continue
        for d in decisions:
            if not isinstance(d, dict) or not d.get("rule"):
                out.append(f"elastic: record {i}: autoscaler decision "
                           "without a named rule")
            elif not all(isinstance(d.get(k), (int, float))
                         for k in ("burn_fast", "burn_slow")):
                out.append(f"elastic: record {i}: decision "
                           f"'{d.get('rule')}' missing burn numbers")
    # executor lineage: every APPLIED scale action must name
    # the decision rule it executed — a process start/stop with no
    # provenance is exactly the unauditable mutation the decision JSONL
    # exists to prevent
    for i, rec in enumerate(records):
        applied = rec.get("autoscale/applied")
        if applied is None:
            continue
        if isinstance(applied, dict):
            applied = [applied]
        if not isinstance(applied, list):
            out.append(f"elastic: record {i}: autoscale/applied is "
                       f"{type(applied).__name__}, not a list")
            continue
        for a in applied:
            if not isinstance(a, dict) or not a.get("rule"):
                out.append(f"elastic: record {i}: applied scale action "
                           "without a named decision rule")
            elif not a.get("action"):
                out.append(f"elastic: record {i}: applied entry for rule "
                           f"'{a.get('rule')}' names no action")
    # applied vs target: with the executor on, the LAST
    # record's fleet size must have converged to the scaler's target —
    # a sustained mismatch means the control loop is open after all
    applied_g = [v for v in _series(records, "autoscale/applied_actors")
                 if isinstance(v, (int, float))]
    target_g = [v for v in _series(records, "autoscale/target_actors")
                if isinstance(v, (int, float))]
    if applied_g and target_g and applied_g[-1] != target_g[-1]:
        out.append(f"elastic: final autoscale/applied_actors "
                   f"{int(applied_g[-1])} != autoscale/target_actors "
                   f"{int(target_g[-1])} — executor did not converge "
                   "on the scaler's target")
    return out
