"""Human-readable report over a run's metrics JSONL (observability spine).

The port's copy of the reference's ``scripts/telemetry_report.py`` (port
tools live in the port package). It reads the port's metrics JSONL under
the reference's keys, and gives the same findings and text on the same
records.

``python -m distributed_deep_q_tpu_torch.telemetry_report RUN.jsonl
[--last N] [--strict]``

Reads the JSONL a ``Metrics(jsonl_path=...)`` run wrote and prints:

- run overview — record/step span, wall time, throughput counters;
- training curve tail — loss / q_mean / return at the end of the run;
- learning dynamics — the ``learn/*`` gauges the on-device metrics
  plane accumulated inside the fused-chain / Anakin scan bodies
  (loss, grad norm pre/post clip, Q scale, PER priority and IS-weight
  statistics) plus the TD-|error| histogram percentiles; under
  ``--strict`` any learn divergence finding in a fleet verdict fails
  the gate even if the run later recovered;
- per-phase step breakdown — ``time_<phase>_ms`` means plus the
  streaming-histogram p50/p99 where the run recorded them;
- RPC server table — per-method call counts, latency percentiles and
  payload sizes (``rpc/<method>_*`` keys from the ``stats`` RPC /
  ``telemetry_summary``);
- fleet counters — θ-pull, heartbeat RTT, env-step latency histograms
  the actors flushed back (``fleet/*``);
- queue gauges — replay/staged-row depths and params-version lag
  (``queue/*``), the host-OOM early-warning signals;
- tracing & data age — span-drop / clock-skew counters (``trace/*``)
  and the ingest-lag histogram; ``learner/time_to_learn_ms`` rides the
  learner table. Runs that never enabled tracing emit none of these
  keys and the sections simply don't print;
- health & SLO plane — monitor/aggregator self-gauges, live efficiency
  gauges (``train/steps_per_s``, ``train/mfu``,
  ``train/ingest_utilization``), and the aggregated fleet verdict the
  supervisor logged under ``health/verdict`` — final status, how many
  records spent degraded/critical, and the last verdict's findings;
- anomalies — bad JSON, non-monotonic steps, logging gaps, stalled
  counters, non-finite values, span-ring overflow.

``--strict`` exits non-zero when anomalies or SLO violations are
present (the reference's ``scripts/trace_report.py`` convention): any record
with a CRITICAL fleet verdict, a run that ENDS degraded/critical, or
any structural anomaly fails the report. Transient degraded windows
that recover are reported but pass — that is the health plane working.

Pure stdlib (json/math/argparse): usable on any host with the JSONL file,
no torch or numpy required. ``load_records`` / ``validate_records`` /
``slo_problems`` are importable by tests and other tooling.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

# suffixes Histogram.summary() emits, in display order
HIST_SUFFIXES = ("count", "mean", "p50", "p95", "p99", "max")


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


def validate_records(records: list[dict]) -> list[str]:
    """Structural problems: missing/non-monotonic ``step``, non-finite
    values. Returns human-readable problem strings (empty = clean)."""
    problems = []
    last_step = None
    for i, rec in enumerate(records):
        if "step" not in rec:
            problems.append(f"record {i}: missing 'step'")
            continue
        step = rec["step"]
        if not isinstance(step, (int, float)):
            problems.append(f"record {i}: non-numeric step {step!r}")
            continue
        if last_step is not None and step < last_step:
            problems.append(
                f"record {i}: step {step} < previous {last_step} "
                "(non-monotonic)")
        last_step = step
        for k, v in rec.items():
            if isinstance(v, float) and not math.isfinite(v):
                problems.append(f"record {i} (step {step}): {k} = {v}")
    return problems


def _series(records: list[dict], key: str) -> list:
    return [r[key] for r in records if key in r]


def _verdicts(records: list[dict]) -> list[dict]:
    """The aggregated fleet verdicts a supervisor run logged — the one
    non-scalar value on the metrics spine (Metrics.log passes dicts
    through to JSONL; the TB mirror skips them)."""
    return [v for v in _series(records, "health/verdict")
            if isinstance(v, dict)]


def slo_problems(records: list[dict]) -> list[str]:
    """SLO violations ``--strict`` gates on: a CRITICAL fleet verdict in
    ANY record, or a run whose FINAL verdict is not ok. Returns
    human-readable problem strings naming the violated rules."""
    verdicts = _verdicts(records)
    if not verdicts:
        return []
    out = []
    crit = [i for i, v in enumerate(verdicts)
            if v.get("status") == "critical"]
    if crit:
        out.append(f"SLO: fleet verdict CRITICAL in {len(crit)} "
                   f"record(s) (first at verdict {crit[0]})")
    final = verdicts[-1]
    if final.get("status") not in (None, "ok"):
        rules = sorted({str(f.get("rule", "?"))
                        for f in final.get("findings") or []
                        if isinstance(f, dict)})
        out.append(f"SLO: run ended {final.get('status')}"
                   + (f" ({', '.join(rules)})" if rules else ""))
    return out


# findings the learning-dynamics monitor emits (health.default_learn_
# rules/trends over the learn/* plane). ``--strict`` treats ANY such
# finding as a failure even if the fleet later recovered: a loss that
# diverged and came back still trained on poisoned updates, so the run
# is not a clean gate.
LEARN_DIVERGENCE_RULES = (
    "loss_divergence", "loss_collapse", "grad_norm_spike",
    "q_overestimation", "priority_collapse", "loss_nonfinite")


def learn_problems(records: list[dict]) -> list[str]:
    """Learning-dynamics failures ``--strict`` gates on: any fleet
    verdict carrying a learn divergence finding, or a run whose last
    window still counted non-finite losses."""
    hits: dict[str, int] = {}
    for v in _verdicts(records):
        for f in v.get("findings") or []:
            if isinstance(f, dict) \
                    and str(f.get("rule")) in LEARN_DIVERGENCE_RULES:
                r = str(f.get("rule"))
                hits[r] = hits.get(r, 0) + 1
    out = [f"learning: divergence finding '{rule}' in {n} verdict(s)"
           for rule, n in sorted(hits.items())]
    nf = [v for v in _series(records, "learn/loss_nonfinite")
          if isinstance(v, (int, float))]
    if nf and nf[-1] > 0:
        out.append(f"learning: {int(nf[-1])} non-finite loss step(s) in "
                   "the final window")
    return out


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


def _hist_groups(records: list[dict], prefix: str) -> dict[str, dict]:
    """Latest value per histogram-summary group under ``prefix``:
    ``{'fleet/param_pull_ms': {'count': ..., 'p50': ..., ...}, ...}``."""
    groups: dict[str, dict] = {}
    for rec in records:
        for k, v in rec.items():
            if not k.startswith(prefix):
                continue
            for suf in HIST_SUFFIXES:
                if k.endswith(f"_{suf}"):
                    groups.setdefault(k[: -len(suf) - 1], {})[suf] = v
                    break
    return groups


def _fmt(v, width: int = 9) -> str:
    if v is None:
        return " " * (width - 1) + "-"
    if isinstance(v, float) and not math.isfinite(v):
        return f"{v!s:>{width}}"
    if isinstance(v, float) and abs(v) < 1e5:
        return f"{v:>{width}.2f}"
    return f"{int(v):>{width}d}"


def _table(title: str, rows: list[tuple], header: tuple,
           out: list[str]) -> None:
    if not rows:
        return
    out.append(f"\n== {title} ==")
    name_w = max(len(str(r[0])) for r in rows + [header])
    out.append("  " + str(header[0]).ljust(name_w)
               + "".join(f"{h:>10}" for h in header[1:]))
    for r in rows:
        out.append("  " + str(r[0]).ljust(name_w)
                   + "".join(" " + _fmt(v) for v in r[1:]))


def _gap_anomalies(records: list[dict], factor: float = 5.0) -> list[str]:
    """Logging gaps (wall-time deltas >> the median cadence) and stalled
    throughput counters."""
    out = []
    ts = [r["t"] for r in records if isinstance(r.get("t"), (int, float))]
    if len(ts) >= 4:
        deltas = [b - a for a, b in zip(ts, ts[1:])]
        med = sorted(deltas)[len(deltas) // 2]
        if med > 0:
            for i, d in enumerate(deltas):
                if d > factor * med:
                    out.append(
                        f"logging gap: {d:.1f}s between records {i} and "
                        f"{i + 1} (median cadence {med:.1f}s)")
    for key in ("env_steps", "grad_steps_per_s"):
        vals = _series(records, key)
        if len(vals) >= 3 and vals[-1] == vals[-2] == vals[-3] \
                and (key != "env_steps" or vals[-1] == vals[0]):
            out.append(f"counter stalled: {key} flat at {vals[-1]} over the "
                       "last 3 records")
    return out


def render_report(records: list[dict], last: int = 0) -> str:
    if last:
        records = records[-last:]
    if not records:
        return "no records"
    out: list[str] = []
    steps = _series(records, "step")
    ts = _series(records, "t")
    out.append("== run overview ==")
    out.append(f"  records             {len(records)}")
    if steps:
        out.append(f"  step span           {steps[0]} .. {steps[-1]}")
    if ts:
        out.append(f"  wall span           {ts[-1] - ts[0]:.1f}s "
                   f"(t={ts[0]:.1f} .. {ts[-1]:.1f})")
    for key in ("grad_steps_per_s", "env_steps_per_s", "env_steps",
                "replay_size", "actor_restarts"):
        vals = [v for v in _series(records, key)
                if isinstance(v, (int, float))]
        if vals:
            out.append(f"  {key:<19} last {_fmt(vals[-1]).strip()}   "
                       f"max {_fmt(max(vals)).strip()}")

    rows = []
    for key in ("loss", "q_mean", "return_avg100", "eval_return", "epsilon"):
        vals = [v for v in _series(records, key)
                if isinstance(v, (int, float)) and math.isfinite(v)]
        if vals:
            rows.append((key, vals[0], vals[-1], min(vals), max(vals)))
    _table("training curve", rows, ("metric", "first", "last", "min", "max"),
           out)

    # learning dynamics: the learn/* gauges the on-device metrics plane
    # accumulated inside the fused-chain / Anakin scan bodies
    # (learning.py), plus the cumulative TD-|error| histogram summary.
    # Runs without cfg.train.learn_metrics log none of these keys.
    rows = []
    for key in ("learn/loss", "learn/grad_norm", "learn/grad_norm_clipped",
                "learn/q_mean", "learn/q_max", "learn/td_mean",
                "learn/td_max", "learn/prio_mean", "learn/prio_max",
                "learn/is_weight_mean", "learn/is_weight_min",
                "learn/target_refreshes", "learn/loss_nonfinite",
                "learn/steps"):
        vals = [v for v in _series(records, key)
                if isinstance(v, (int, float)) and math.isfinite(v)]
        if vals:
            rows.append((key[6:], vals[0], vals[-1], min(vals), max(vals)))
    _table("learning dynamics (learn/*)", rows,
           ("gauge", "first", "last", "min", "max"), out)
    rows = [(name[6:], d.get("count"), d.get("p50"), d.get("p95"),
             d.get("p99"), d.get("max"))
            for name, d in sorted(
                _hist_groups(records, "learn/td_error").items())]
    _table("TD |error| (sampled-priority distribution)", rows,
           ("histogram", "count", "p50", "p95", "p99", "max"), out)

    # per-phase step breakdown: time_<phase>_ms (+ _p50_ms/_p99_ms)
    phases: dict[str, dict] = {}
    for rec in records:
        for k, v in rec.items():
            if not (k.startswith("time_") and k.endswith("_ms")):
                continue
            stem = k[5:-3].rstrip("_")  # 'sample', 'sample_p50', ...
            for suf in ("p50", "p99"):
                if stem.endswith(f"_{suf}"):
                    phases.setdefault(stem[: -len(suf) - 1], {})[suf] = v
                    break
            else:
                phases.setdefault(stem, {})["mean"] = v
    rows = [(name, d.get("mean"), d.get("p50"), d.get("p99"))
            for name, d in sorted(phases.items())]
    _table("step phases (ms, latest window)", rows,
           ("phase", "mean", "p50", "p99"), out)

    # RPC server table — join the latency/bytes/calls keys per method
    lat = _hist_groups(records, "rpc/")
    methods: dict[str, dict] = {}
    calls: dict[str, float] = {}
    for rec in records:
        for k, v in rec.items():
            if k.startswith("rpc/") and k.endswith("_calls"):
                calls[k[4:-6]] = v
    for group, d in lat.items():
        name = group[4:]
        if name.endswith("_ms"):
            methods.setdefault(name[:-3], {})["ms"] = d
        elif name.endswith("_bytes"):
            methods.setdefault(name[:-6], {})["bytes"] = d
    rows = []
    for m in sorted(set(methods) | set(calls)):
        ms = methods.get(m, {}).get("ms", {})
        by = methods.get(m, {}).get("bytes", {})
        rows.append((m, calls.get(m), ms.get("p50"), ms.get("p95"),
                     ms.get("p99"), ms.get("max"), by.get("p95")))
    _table("rpc methods", rows, ("method", "calls", "ms_p50", "ms_p95",
                                 "ms_p99", "ms_max", "B_p95"), out)

    rows = [(name[6:], d.get("count"), d.get("p50"), d.get("p95"),
             d.get("p99"), d.get("max"))
            for name, d in sorted(_hist_groups(records, "fleet/").items())]
    _table("fleet (actor-side, ms)", rows,
           ("counter", "count", "p50", "p95", "p99", "max"), out)

    rows = [(name[8:], d.get("count"), d.get("p50"), d.get("p99"),
             d.get("max"))
            for name, d in sorted(_hist_groups(records, "learner/").items())]
    _table("learner (ms)", rows, ("counter", "count", "p50", "p99", "max"),
           out)

    rows = []
    for key in sorted({k for r in records for k in r
                       if k.startswith("queue/") or k == "fleet/actors_seen"}):
        vals = [v for v in _series(records, key)
                if isinstance(v, (int, float))]
        if vals:
            rows.append((key, vals[-1], min(vals), max(vals)))
    _table("queue gauges", rows, ("gauge", "last", "min", "max"), out)

    # durability plane: snapshot cadence/stall/size, generation retention,
    # quarantines, and wire CRC rejections (any nonzero quarantine or
    # checksum count deserves a look — it means damage was absorbed)
    rows = []
    for key in sorted({k for r in records for k in r
                       if k.startswith("durability/")
                       or k == "rpc/checksum_errors"}):
        vals = [v for v in _series(records, key)
                if isinstance(v, (int, float))]
        if vals:
            rows.append((key, vals[-1], min(vals), max(vals)))
    _table("durability (snapshots & integrity)", rows,
           ("gauge", "last", "min", "max"), out)

    # tracing plane: tracer counters + flush-level data-age histogram.
    # A run that never enabled tracing logs none of these keys, so both
    # row lists stay empty and _table skips the sections cleanly.
    rows = []
    for key in ("trace/spans_dropped", "trace/spans_buffered",
                "trace/clock_skew_ms", "trace/skew_samples"):
        vals = [v for v in _series(records, key)
                if isinstance(v, (int, float))]
        if vals:
            rows.append((key, vals[-1], min(vals), max(vals)))
    _table("tracing (spans & clock skew)", rows,
           ("gauge", "last", "min", "max"), out)
    rows = [(name[6:], d.get("count"), d.get("p50"), d.get("p95"),
             d.get("p99"), d.get("max"))
            for name, d in sorted(_hist_groups(records, "trace/").items())]
    _table("data age (ms)", rows,
           ("histogram", "count", "p50", "p95", "p99", "max"), out)

    # health & SLO plane: self-gauges + live efficiency, then the fleet
    # verdict trail. Runs without health enabled log none of these keys.
    rows = []
    for key in ("health/members", "health/findings", "health/degraded",
                "health/critical", "health/scrape_errors",
                "train/steps_per_s", "train/mfu",
                "train/ingest_utilization"):
        vals = [v for v in _series(records, key)
                if isinstance(v, (int, float))]
        if vals:
            rows.append((key, vals[-1], min(vals), max(vals)))
    _table("health & efficiency", rows, ("gauge", "last", "min", "max"),
           out)
    verdicts = _verdicts(records)
    if verdicts:
        final = verdicts[-1]
        n_deg = sum(v.get("status") == "degraded" for v in verdicts)
        n_crit = sum(v.get("status") == "critical" for v in verdicts)
        out.append("\n== fleet verdict ==")
        out.append(f"  final status        {final.get('status', '?')}")
        out.append(f"  degraded records    {n_deg}/{len(verdicts)}")
        out.append(f"  critical records    {n_crit}/{len(verdicts)}")
        for f in (final.get("findings") or [])[:10]:
            if isinstance(f, dict):
                out.append(
                    f"  ! [{f.get('severity', '?')}] "
                    f"{f.get('member') or '-'}: {f.get('rule', '?')} "
                    f"on {f.get('key', '?')}")

    problems = (validate_records(records) + _gap_anomalies(records)
                + slo_problems(records) + learn_problems(records)
                + elastic_problems(records))
    drops = [v for v in _series(records, "trace/spans_dropped")
             if isinstance(v, (int, float))]
    if drops and drops[-1] > 0:
        problems.append(
            f"tracing: {int(drops[-1])} spans dropped (ring overflow) — "
            "raise trace.buffer_spans or lower trace.sample_rate")
    out.append(f"\n== anomalies ({len(problems)}) ==")
    for p in problems[:50]:
        out.append(f"  ! {p}")
    if len(problems) > 50:
        out.append(f"  ... and {len(problems) - 50} more")
    if not problems:
        out.append("  none")
    return "\n".join(out)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("jsonl", help="metrics JSONL file written by a run")
    ap.add_argument("--last", type=int, default=0,
                    help="only the last N records (default: all)")
    ap.add_argument("--strict", action="store_true",
                    help="exit non-zero on anomalies or SLO violations")
    args = ap.parse_args(argv)
    try:
        records = load_records(args.jsonl)
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    print(render_report(records, last=args.last))
    if args.strict:
        window = records[-args.last:] if args.last else records
        problems = (validate_records(window) + _gap_anomalies(window)
                    + slo_problems(window) + learn_problems(window)
                    + elastic_problems(window))
        if problems:
            print(f"strict: FAILED ({len(problems)} problem(s), first: "
                  f"{problems[0]})", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
