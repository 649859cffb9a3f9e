"""Diff two bench result lines and flag regressions.

Usage::

    python -m distributed_deep_q_tpu_torch.bench_diff OLD.json NEW.json
    python -m distributed_deep_q_tpu_torch.bench_diff --tolerance 0.05 \
        old.json new.json

The port's copy of the reference's ``scripts/bench_diff.py`` (port tools
live in the port package), over two lines of the port's bench
(``python -m distributed_deep_q_tpu_torch.bench``), each saved as a JSON
file. Its rules, its text and its exit codes are the reference's:

Compares every numeric metric present in both files. A metric has
REGRESSED when it moves in its bad direction (throughput down, latency /
op-count up) by more than its tolerance — the larger recorded ``spread``
of the two runs when one exists (benches record run-to-run relative
spread next to gated metrics), else ``--tolerance`` (default 2%).

Keys listed under ``tunnel_bound_keys`` are measurements of the
benchmarking transport, not of the system — their regressions are
ANNOTATED but never fail the diff. The CANDIDATE run's list wins
(falling back to the baseline's when absent). Exit status is 1 iff a
non-tunnel-bound metric regressed, 2 when the files share no numeric
metric; stdlib only, no repo imports, so it runs anywhere the jsons
land.

Rules only for the port's own keys (``bench.PORT_ONLY``): the
``launches`` rows are echoes of the kernels' counters and are skipped;
``ingest_rows_lost`` and ``actor_rows_lost`` are lower-is-better; ``quick``
and ``nvidia_smi`` are not numbers and are not compared, but where the two
files differ in one of them a line of its own says so (a ``--quick`` line
against a full one, or another card or power limit, is not like for
like).
"""

from __future__ import annotations

import argparse
import json
import sys

# metric -> its recorded run-to-run spread key, where the bench doesn't
# follow the "<prefix>_steps_per_s" / "<prefix>_spread" convention
SPREAD_KEY = {
    "value": "flagship_spread",
    "idle_uniform_steps_per_s": "idle_spread",
    "pallas_off_steps_per_s": "idle_spread",
    "flagship_under_ingest_steps_per_s": "under_ingest_spread",
    # linearity ratios divide two curve points, so their run-to-run
    # spread is the (first-order) SUM of the points' spreads — the bench
    # records that sum next to each ratio
    "multihost_linearity_2x": "multihost_linearity_2x_spread",
    "multihost_linearity_4x": "multihost_linearity_4x_spread",
    # health-plane overhead rows share one measured spread
    "health_sample_us": "health_spread",
    "health_verdict_us": "health_spread",
    "health_disabled_us": "health_spread",
    "mfu_live": "flagship_spread",
    # learn_metrics on-vs-off overhead: the pct divides two
    # timed points, so its noise is the sum of their spreads — recorded
    # as learn_spread (learn_off/on_steps_per_s follow the automatic
    # "<prefix>_spread" convention and need no entry here)
    "learn_overhead_pct": "learn_spread",
    # elasticity rows share one measured handoff spread; the
    # remap fractions are ring properties (deterministic given the host
    # set) but ride the same key so a ring change gates like noise would
    "handoff_export_ms": "elasticity_spread",
    "handoff_import_ms": "elasticity_spread",
    "remap_fraction_grow": "elasticity_spread",
    "remap_fraction_shrink": "elasticity_spread",
    # multi-tenant serving rows share one measured spread;
    # shadow_overhead_pct divides two timed latencies, so its noise is
    # the sum of their spreads — folded into the same recorded key
    "tenant_swap_us": "tenant_spread",
    "shadow_overhead_pct": "tenant_spread",
    "executor_apply_us": "tenant_spread",
}

# substrings marking metrics where UP is the bad direction
# (_rpcs: cross_host_replay_rpcs is a badness LEDGER — any cross-host
# replay traffic is a sharding violation, so up must gate, and the
# common old=0 case makes any appearance an infinite regression)
_LOWER_BETTER = ("_ms", "_fusions", "_convs", "_copies", "fusions",
                 "spread", "_rpcs", "_us", "overhead_pct",
                 # remap fraction: more of the fleet reconnecting per
                 # membership change is strictly worse (reconnect storm)
                 "remap_fraction",
                 # the port's ledgers of rows lost by a curve: any is wrong
                 "_rows_lost")
# keys that are configuration echoes / identities, not metrics
# (max_in_flight_rows is the writers' backpressure watermark — a state
# echo of the pacing loop, not a quality axis with a bad direction;
# inference_curve's SLO/batch knobs are config echoes, sheds a state
# echo, and local_actions_per_s the comparison-host baseline the
# speedup already folds in — gating it would gate host CPU noise;
# multihost_curve's n_hosts is the point's identity and dispatch_k its
# calibration echo)
_SKIP = ("_chain_k", "_vs_", "vs_baseline", "ring_capacity",
         "flagship_batch", "concurrent_writers", "peak_flops", "n", "rc",
         "flops_per_step", "max_in_flight_rows", "inference_slo_ms",
         "inference_max_batch", "inference_cutoff_us", "sheds",
         "local_actions_per_s", "n_hosts", "dispatch_k", "n_envs",
         # elasticity bench identities: rows carried per handoff and the
         # acting fleet the remap fractions are computed over
         "handoff_rows", "fleet_size",
         # config echo: the live-vs-offline MFU agreement bound bench.py
         # asserts; the gated quality axes are mfu / mfu_live themselves
         "mfu_live_tolerance")


# the port's echoes: every kernel's launch counts per row
_PORT_SKIP_PREFIXES = ("launches.",)
# the port's keys that are not numbers, said when the two runs differ
_PORT_RUN_KEYS = ("quick", "nvidia_smi")


def _parsed(path: str) -> dict:
    with open(path) as f:
        doc = json.load(f)
    return doc.get("parsed", doc) if isinstance(doc, dict) else {}


def _lower_is_better(key: str) -> bool:
    return any(tag in key for tag in _LOWER_BETTER)


def _skipped(key: str) -> bool:
    return (key in _SKIP or any(tag in key for tag in _SKIP if tag != "n")
            or key.startswith(_PORT_SKIP_PREFIXES))


def _spread_for(key: str, a: dict, b: dict) -> float | None:
    sk = SPREAD_KEY.get(key)
    if sk is None and key.endswith("_steps_per_s"):
        sk = key[: -len("_steps_per_s")] + "_spread"
    if sk is None:
        return None
    vals = [d[sk] for d in (a, b) if isinstance(d.get(sk), (int, float))]
    return max(vals) if vals else None


def _flatten(d: dict, prefix: str = "") -> dict:
    """Nested curve rows (``ingest_curve``, ``inference_curve``) become
    dotted keys; each nested dict's own ``spread`` rides along under its
    dotted name and becomes the tolerance for its siblings."""
    out = {}
    for k, v in d.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, f"{key}."))
        elif isinstance(v, (int, float)) and not isinstance(v, bool):
            out[key] = float(v)
    return out


def diff(a: dict, b: dict, tolerance: float):
    """-> (rows, failed). Each row: (key, old, new, rel_delta, tol,
    status) with status in {ok, improved, regressed, tunnel-bound}."""
    # candidate's tunnel list wins: a bench that PROMOTES a key out of
    # the tunnel set (ingest_curve) starts gating it even
    # against baselines that still listed it
    tunnel = set(b.get("tunnel_bound_keys")
                 or a.get("tunnel_bound_keys") or [])
    fa, fb = _flatten(a), _flatten(b)
    rows, failed = [], False
    for key in sorted(fa.keys() & fb.keys()):
        if _skipped(key) or key.endswith(".spread"):
            continue
        old, new = fa[key], fb[key]
        if key.endswith("spread"):
            continue
        tol = _spread_for(key, a, b)
        if tol is None:
            # nested curves record spread alongside the metric
            tol = fa.get(key.rsplit(".", 1)[0] + ".spread")
        if tol is None:
            tol = tolerance
        delta = (new - old) / abs(old) if old else (0.0 if new == old
                                                    else float("inf"))
        bad = -delta if _lower_is_better(key) else delta
        if bad < -tol:
            root = key.split(".", 1)[0]
            if root in tunnel or key in tunnel:
                status = "tunnel-bound"
            else:
                status, failed = "regressed", True
        elif bad > tol:
            status = "improved"
        else:
            status = "ok"
        rows.append((key, old, new, delta, tol, status))
    return rows, failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old", help="baseline BENCH_r*.json")
    ap.add_argument("new", help="candidate BENCH_r*.json")
    ap.add_argument("--tolerance", type=float, default=0.02,
                    help="relative tolerance for metrics with no "
                         "recorded spread (default 0.02)")
    ap.add_argument("--all", action="store_true",
                    help="print every compared metric, not just moves")
    args = ap.parse_args(argv)

    old_run, new_run = _parsed(args.old), _parsed(args.new)
    for key in _PORT_RUN_KEYS:
        if old_run.get(key) != new_run.get(key):
            print(f"note: {key} differs: {old_run.get(key)!r} -> "
                  f"{new_run.get(key)!r} (not like for like)")
    rows, failed = diff(old_run, new_run, args.tolerance)
    if not rows:
        print("no shared numeric metrics to compare")
        return 2

    width = max(len(r[0]) for r in rows)
    marks = {"regressed": "!!", "tunnel-bound": "~~", "improved": "++",
             "ok": "  "}
    shown = 0
    for key, old, new, delta, tol, status in rows:
        if status == "ok" and not args.all:
            continue
        shown += 1
        note = " (tunnel-bound: informational, never gates)" \
            if status == "tunnel-bound" else ""
        print(f"{marks[status]} {key:<{width}}  {old:>12.4g} -> "
              f"{new:>12.4g}  {delta:+8.2%} (tol {tol:.2%}) "
              f"{status}{note}")
    if shown == 0:
        print(f"all {len(rows)} shared metrics within tolerance")
    print(f"\n{len(rows)} metrics compared; "
          f"{sum(r[5] == 'regressed' for r in rows)} regressed, "
          f"{sum(r[5] == 'tunnel-bound' for r in rows)} tunnel-bound, "
          f"{sum(r[5] == 'improved' for r in rows)} improved")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
