"""The port's ``telemetry_report`` against the reference's
``scripts/telemetry_report.py``: ``validate_records``, ``slo_problems``,
``learn_problems``, ``elastic_problems``, the gap checks and
``render_report`` give equal findings and equal text on the same records,
and the command line exits the same way.

The records: the cases of ``tests/test_telemetry.py`` and of the port's
``tests/test_torch_telemetry.py``, one case per gate the report holds, and
the metrics JSONL of one CPU ``health`` chaos run of each package (each
read by both reports). Tolerance: none, the text is compared as strings.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import pytest

from distributed_deep_q_tpu_torch import telemetry_report as port

REPO = Path(__file__).resolve().parent.parent


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref = _load("_ref_telemetry_report", REPO / "scripts" / "telemetry_report.py")

FUNCS = ("validate_records", "slo_problems", "learn_problems",
         "elastic_problems", "_gap_anomalies", "render_report")


def _verdict(status, rules=()):
    return {"status": status, "ok": status == "ok", "t": 1.0,
            "findings": [{"rule": r, "key": "k", "severity": status,
                          "kind": "slo", "member": "learner"}
                         for r in rules]}


CASES = {
    "synthetic": [
        {"step": 100, "t": 1.0, "loss": 0.5, "grad_steps_per_s": 90.0,
         "env_steps": 400, "time_sample_ms": 1.2, "time_sample_p50_ms": 1.0,
         "time_sample_p99_ms": 3.0, "rpc/add_transitions_calls": 4,
         "rpc/add_transitions_ms_p50": 0.4, "rpc/add_transitions_ms_p95": 0.9,
         "queue/replay_size": 1000, "fleet/param_pull_ms_count": 3,
         "fleet/param_pull_ms_p95": 2.0},
        {"step": 200, "t": 2.0, "loss": 0.4, "grad_steps_per_s": 95.0,
         "env_steps": 800, "queue/replay_size": 2000}],
    "anomalies": [{"step": 100, "t": 1.0}, {"step": 50, "t": 2.0},
                  {"step": 150, "t": 3.0, "loss": float("nan")},
                  {"t": 4.0}, {"step": "x", "t": 5.0}],
    "recovered_degraded": [
        {"step": 1, "t": 1.0,
         "health/verdict": _verdict("degraded", ["wire_integrity"])},
        {"step": 2, "t": 2.0, "health/verdict": _verdict("ok")}],
    "ends_degraded": [
        {"step": 1, "t": 1.0, "health/members": 2, "health/findings": 0,
         "train/steps_per_s": 120.0, "train/mfu": 0.31,
         "health/verdict": _verdict("ok")},
        {"step": 2, "t": 2.0, "health/members": 2, "health/findings": 1,
         "health/verdict": _verdict("degraded", ["wire_integrity"])}],
    "critical": [
        {"step": 1, "t": 1.0, "health/verdict": _verdict("critical",
                                                         ["oom"])},
        {"step": 2, "t": 2.0, "health/verdict": _verdict("ok")}],
    "learn_divergence": [
        {"step": 1, "t": 1.0, "learn/loss": 1.0, "learn/grad_norm": 2.0,
         "learn/td_error_count": 64, "learn/td_error_p50": 0.5,
         "learn/td_error_p99": 2.0, "learn/loss_nonfinite": 0.0,
         "health/verdict": _verdict("degraded", ["loss_divergence",
                                                 "grad_norm_spike"])},
        {"step": 2, "t": 2.0, "learn/loss": 5.0, "learn/loss_nonfinite": 3.0,
         "health/verdict": _verdict("ok")}],
    "elastic": [
        {"step": 1, "t": 1.0, "fleet/handoff_lost_rows": 3.0,
         "autoscale/decision": [{"action": "shrink_actors", "rule": "",
                                 "burn_fast": 1.0, "burn_slow": 1.0},
                                {"action": "grow_actors", "rule": "r"}],
         "autoscale/applied": {"action": "", "rule": "r"},
         "autoscale/applied_actors": 3, "autoscale/target_actors": 3},
        {"step": 2, "t": 2.0, "autoscale/decision": "bad",
         "autoscale/applied": [{"rule": ""}],
         "autoscale/applied_actors": 2, "autoscale/target_actors": 3}],
    "gaps_and_stalls": [
        {"step": i, "t": float(t), "env_steps": 100, "grad_steps_per_s": 5.0,
         "trace/spans_dropped": 2.0 * i, "trace/spans_buffered": 10.0,
         "trace/ingest_lag_ms_p50": 1.0, "durability/snapshots": 1.0,
         "rpc/checksum_errors": 1.0}
        for i, t in enumerate((0, 1, 2, 3, 30, 31))],
    "empty": [],
}


def _call(mod, func: str, records):
    return getattr(mod, func)(records)


@pytest.mark.parametrize("func", FUNCS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_findings_and_text_equal_the_reference(case, func):
    records = json.loads(json.dumps(CASES[case]))
    assert _call(port, func, records) == _call(ref, func, records)


def test_report_windows_the_last_records_like_the_reference():
    recs = CASES["synthetic"] + CASES["ends_degraded"]
    assert port.render_report(recs, last=2) == ref.render_report(recs,
                                                                 last=2)


@pytest.fixture(scope="module")
def health_runs():
    """The metrics JSONL of one CPU ``health`` chaos run of each package
    (the run writes it to a ``tempfile.mktemp`` path, redirected here).
    Every process-global the run touches is reset in a ``finally``."""
    sys.path.insert(0, str(REPO / "scripts"))
    ref_chaos = _load("_ref_chaos_smoke", REPO / "scripts" / "chaos_smoke.py")
    from distributed_deep_q_tpu import health as ref_health
    from distributed_deep_q_tpu.rpc import faultinject as ref_fi

    from distributed_deep_q_tpu_torch import chaos_smoke, health
    from distributed_deep_q_tpu_torch.rpc import faultinject

    out_dir = Path(tempfile.mkdtemp(prefix="torch_report_"))
    paths, verdicts = {}, {}
    real_mktemp = tempfile.mktemp
    try:
        for name, run in (("port", chaos_smoke.run_health_smoke),
                          ("reference", ref_chaos.run_health_smoke)):
            path = out_dir / f"{name}.jsonl"
            tempfile.mktemp = lambda *a, _p=path, **kw: str(_p)
            try:
                verdicts[name] = run()
            finally:
                tempfile.mktemp = real_mktemp
            paths[name] = path
    finally:
        tempfile.mktemp = real_mktemp
        for fi in (faultinject, ref_fi):
            fi.uninstall()
        for h in (health, ref_health):
            h.reset()
        sys.path.remove(str(REPO / "scripts"))
    return paths, verdicts


@pytest.mark.parametrize("func", FUNCS)
@pytest.mark.parametrize("run", ["port", "reference"])
def test_health_run_jsonl_reads_the_same(health_runs, run, func):
    """Each package's health run JSONL: the port's report reads the same
    keys the reference's does and finds the same (the run recovered, so
    the strict SLO gate is clean in both)."""
    paths, verdicts = health_runs
    assert verdicts[run]["ok"], verdicts[run]
    records = port.load_records(str(paths[run]))
    assert records == ref.load_records(str(paths[run]))
    assert any("health/verdict" in r for r in records)
    assert _call(port, func, records) == _call(ref, func, records)
    if func == "slo_problems":
        assert port.slo_problems(records) == []


@pytest.mark.parametrize("case, strict", [("synthetic", False),
                                          ("ends_degraded", False),
                                          ("ends_degraded", True),
                                          ("recovered_degraded", True)])
def test_command_line_exits_like_the_reference(case, strict, tmp_path):
    jsonl = tmp_path / "run.jsonl"
    jsonl.write_text("".join(json.dumps(r) + "\n" for r in CASES[case]))
    extra = ["--strict"] if strict else []
    got = subprocess.run(
        [sys.executable, "-m", "distributed_deep_q_tpu_torch.telemetry_report",
         str(jsonl), *extra], capture_output=True, text=True, timeout=60,
        cwd=REPO)
    want = subprocess.run(
        [sys.executable, str(REPO / "scripts" / "telemetry_report.py"),
         str(jsonl), *extra], capture_output=True, text=True, timeout=60,
        cwd=REPO)
    assert (got.returncode, got.stdout, got.stderr) == (
        want.returncode, want.stdout, want.stderr)


def test_missing_file_is_a_clean_error(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "distributed_deep_q_tpu_torch.telemetry_report",
         str(tmp_path / "nope.jsonl")], capture_output=True, text=True,
        timeout=60, cwd=REPO)
    assert proc.returncode == 1 and "error:" in proc.stderr
