"""The port's tools around its bench against the reference's scripts, on
the CPU: ``bench_diff``, ``trace_report``, ``bench --trace-ingest`` and
``bench_elasticity``.

- ``bench_diff`` gives the rows, the text and the exit code of
  ``scripts/bench_diff.py`` (loaded by path) on synthetic pairs of lines:
  a regression, an improvement, a tunnel-bound key, nested curves, a
  ``parsed`` wrapper, no shared keys; with ``--all`` and ``--tolerance``.
  Its port-only rules: ``launches.*`` skipped, the curves' lost rows
  lower-is-better, a line of its own when ``quick`` or ``nvidia_smi``
  differ.
- ``trace_report`` gives the findings, the text, the merged trace and the
  exit code of ``scripts/trace_report.py`` on the shards of one traced
  CPU feed run of each package (alone and merged), with ``--strict``, a
  planted orphan, a planted drop, no matching file and a file that is
  not a shard. Tolerance: none, the text is compared as strings.
- ``bench --trace-ingest`` on the CPU prints the reference's keys (and
  ``launches``), with the learner's stages in its attribution, and its
  shard passes the port's report under ``--strict``.
- ``bench_elasticity`` prints the reference's keys; its remap fractions
  are the reference's exactly; every handed-off row lands, and a handoff
  that drops one fails.
"""

from __future__ import annotations

import ast
import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from distributed_deep_q_tpu_torch import bench_diff, bench_elasticity
from distributed_deep_q_tpu_torch import trace_report

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref_diff = _load("_ref_bench_diff", REPO / "scripts" / "bench_diff.py")
ref_report = _load("_ref_trace_report", REPO / "scripts" / "trace_report.py")


def _run(main, argv) -> tuple[int, str, str]:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


# -- bench_diff ---------------------------------------------------------------

_BASE = {
    "metric": "learner_grad_steps_per_sec", "value": 100.0,
    "unit": "steps/s", "flagship_spread": 0.01, "fence_rtt_ms": 1.0,
    "idle_uniform_steps_per_s": 50.0, "idle_spread": 0.02,
    "batch32_steps_per_s": 80.0, "batch32_spread": 0.03,
    "flagship_chain_k": 32, "health_sample_us": 30.0,
    "health_spread": 0.05, "mfu": 0.006,
}


def _with(d: dict, **kw) -> dict:
    out = json.loads(json.dumps(d))
    out.update(kw)
    return out


def _curves(rate: float, ingest: float, rpcs: int = 0) -> dict:
    return {
        "ingest_curve": {
            "1024": {"steps_per_s": rate, "achieved_t_per_s": ingest,
                     "spread": 0.05, "max_in_flight_rows": 256}},
        "multihost_curve": {
            str(n): {"n_hosts": n, "steps_per_s": rate * n,
                     "wall_steps_per_s": rate, "spread": 0.04,
                     "ingest_t_per_s": ingest, "cross_host_replay_rpcs": rpcs,
                     "dispatch_k": 12} for n in (1, 2, 4)},
        "multihost_linearity_2x": 1.9, "multihost_linearity_2x_spread": 0.08,
    }


PAIRS = {
    "regression": (_BASE, _with(_BASE, value=90.0, fence_rtt_ms=1.5,
                                batch32_steps_per_s=81.0)),
    "improvement": (_BASE, _with(_BASE, value=120.0, fence_rtt_ms=0.5,
                                 health_sample_us=20.0)),
    "tunnel_bound": (
        _with(_BASE, **_curves(100.0, 1000.0)),
        _with(_BASE, tunnel_bound_keys=["ingest_curve"],
              **{**_curves(100.0, 1000.0),
                 "ingest_curve": _curves(100.0, 500.0)["ingest_curve"]})),
    "nested_curves": (
        _with(_BASE, **_curves(100.0, 1000.0)),
        _with(_BASE, **{**_curves(80.0, 1100.0, rpcs=2),
                        "multihost_linearity_2x": 1.5})),
    "parsed_wrapper": ({"parsed": _BASE},
                       {"parsed": _with(_BASE, value=99.5)}),
    "no_shared_keys": ({"a_steps_per_s": 1.0}, {"b_steps_per_s": 2.0}),
}


@pytest.mark.parametrize("flags", [[], ["--all"], ["--tolerance", "0.3"]])
@pytest.mark.parametrize("case", sorted(PAIRS))
def test_bench_diff_is_the_references(case, flags, tmp_path):
    """Rows, text and exit code equal the reference's on each pair."""
    old, new = PAIRS[case]
    po, pn = tmp_path / "old.json", tmp_path / "new.json"
    po.write_text(json.dumps(old))
    pn.write_text(json.dumps(new))
    argv = flags + [str(po), str(pn)]
    got, want = _run(bench_diff.main, argv), _run(ref_diff.main, argv)
    assert got == want
    tol = float(flags[1]) if flags[:1] == ["--tolerance"] else 0.02
    a, b = ref_diff._parsed(str(po)), ref_diff._parsed(str(pn))
    assert bench_diff.diff(a, b, tol) == ref_diff.diff(a, b, tol)
    expect = {"regression": 1, "improvement": 0, "tunnel_bound": 0,
              "nested_curves": 1, "parsed_wrapper": 0, "no_shared_keys": 2}
    assert got[0] == expect[case], got


def test_bench_diff_port_only_rules(tmp_path):
    """``launches.*`` are echoes (never a row); the curves' lost rows are
    lower-is-better (0 → 3 regresses, 2 → 0 improves); ``quick`` and
    ``nvidia_smi`` are not compared, but each difference gets a line of
    its own, and equal values get none."""
    old = _with(_BASE, launches={"flagship": {"gather_windows": 10,
                                              "scatter_rows": 4}},
                ingest_rows_lost=0, actor_rows_lost=2, quick=False,
                nvidia_smi="NVIDIA H100 80GB HBM3, 700.00 W")
    new = _with(old, launches={"flagship": {"gather_windows": 900,
                                            "scatter_rows": 0}},
                ingest_rows_lost=3, actor_rows_lost=0, quick=True,
                nvidia_smi="NVIDIA H100 80GB HBM3, 500.00 W")
    po, pn = tmp_path / "old.json", tmp_path / "new.json"
    po.write_text(json.dumps(old))
    pn.write_text(json.dumps(new))
    rc, out, _ = _run(bench_diff.main, ["--all", str(po), str(pn)])
    assert rc == 1
    rows = {r[0]: r for r in bench_diff.diff(old, new, 0.02)[0]}
    assert not any(k.startswith("launches") for k in rows), rows
    assert rows["ingest_rows_lost"][5] == "regressed"
    assert rows["actor_rows_lost"][5] == "improved"
    assert "quick" not in rows and "nvidia_smi" not in rows
    notes = [ln for ln in out.splitlines() if ln.startswith("note: ")]
    assert notes == [
        "note: quick differs: False -> True (not like for like)",
        "note: nvidia_smi differs: 'NVIDIA H100 80GB HBM3, 700.00 W' -> "
        "'NVIDIA H100 80GB HBM3, 500.00 W' (not like for like)"]
    pn.write_text(json.dumps(_with(old, value=101.0)))
    rc, out, _ = _run(bench_diff.main, [str(po), str(pn)])
    assert rc == 0 and "note:" not in out


# -- trace_report -------------------------------------------------------------

def _traced_feed(pkg: str, export_dir: Path) -> str:
    """One traced feed run of a package on the CPU: a resilient client
    flushing 12 chunks into a ``ReplayFeedServer`` with the tracer at
    sample rate 1; returns the exported shard's path."""
    if pkg == "port":
        from distributed_deep_q_tpu_torch import tracing
        from distributed_deep_q_tpu_torch.replay.replay_memory import (
            ReplayMemory)
        from distributed_deep_q_tpu_torch.rpc.replay_server import (
            ReplayFeedServer)
        from distributed_deep_q_tpu_torch.rpc.resilience import (
            ResilientReplayFeedClient, RetryPolicy)
    else:
        from distributed_deep_q_tpu import tracing
        from distributed_deep_q_tpu.replay.replay_memory import ReplayMemory
        from distributed_deep_q_tpu.rpc.replay_server import ReplayFeedServer
        from distributed_deep_q_tpu.rpc.resilience import (
            ResilientReplayFeedClient, RetryPolicy)

    tracing.reset()
    tracing.configure(enabled=True, sample_rate=1.0, lineage_rate=1.0,
                      buffer_spans=1 << 14, export_dir=str(export_dir))
    try:
        replay = ReplayMemory(1024, (2,), np.float32, seed=0)
        server = ReplayFeedServer(replay)
        host, port = server.address
        client = ResilientReplayFeedClient.connect(
            host, port, actor_id=1, policy=RetryPolicy(deadline=30.0),
            seed=0)
        try:
            for f in range(12):
                ids = f * 100 + np.arange(16, dtype=np.float32)
                obs = np.stack([ids, ids], axis=1)
                client.add_transitions(
                    obs=obs, action=np.zeros(16, np.int32),
                    reward=np.zeros(16, np.float32), next_obs=obs,
                    discount=np.ones(16, np.float32))
        finally:
            client.close()
            server.close()
        path = tracing.export()
    finally:
        tracing.disable()
        tracing.reset()
    assert path is not None
    return path


@pytest.fixture(scope="module")
def shards(tmp_path_factory) -> dict[str, str]:
    root = tmp_path_factory.mktemp("shards")
    return {pkg: _traced_feed(pkg, root / pkg)
            for pkg in ("port", "reference")}


def _planted(src: str, dst: Path, orphan: bool = False,
             dropped: int = 0) -> str:
    with open(src) as f:
        doc = json.load(f)
    if orphan:
        ev = next(e for e in doc["traceEvents"] if e.get("ph") == "X")
        doc["traceEvents"].append(dict(
            ev, args=dict(ev["args"], span=987_654_321,
                          parent=123_456_789)))
    if dropped:
        doc["otherData"]["spans_dropped"] = dropped
    dst.write_text(json.dumps(doc))
    return str(dst)


def _both_reports(argv: list[str], out: Path):
    """Each report on ``argv`` with ``--out out``: (rc, stdout, stderr,
    merged trace) of the port's and of the reference's."""
    res = []
    for main in (trace_report.main, ref_report.main):
        if out.exists():
            out.unlink()
        rc, so, se = _run(main, argv + ["--out", str(out)])
        merged = json.loads(out.read_text()) if out.exists() else None
        res.append((rc, so, se, merged))
    return res


@pytest.mark.parametrize("strict", [False, True])
@pytest.mark.parametrize("which", ["port", "reference", "both"])
def test_trace_report_is_the_references(which, strict, shards, tmp_path):
    paths = [shards["port"], shards["reference"]] if which == "both" \
        else [shards[which]]
    argv = paths + ["--wall", "2.5"] + (["--strict"] if strict else [])
    port, ref = _both_reports(argv, tmp_path / "merged.json")
    assert port == ref
    rc, text, _, merged = port
    assert rc == 0
    assert "orphan spans: 0" in text and "== attribution (self time) ==" \
        in text
    assert merged["otherData"]["orphan_spans"] == 0
    spans = {e["name"] for e in merged["traceEvents"] if e.get("ph") == "X"}
    assert {"flush", "rpc_call", "ring_insert"} <= spans, spans


@pytest.mark.parametrize("fault", ["orphan", "dropped"])
def test_trace_report_strict_fails_alike_on_a_planted_fault(fault, shards,
                                                            tmp_path):
    planted = [_planted(shards[pkg], tmp_path / f"{pkg}.json",
                        orphan=fault == "orphan",
                        dropped=3 if fault == "dropped" else 0)
               for pkg in ("port", "reference")]
    for strict in (False, True):
        argv = planted + (["--strict"] if strict else [])
        port, ref = _both_reports(argv, tmp_path / "merged.json")
        assert port == ref
        assert port[0] == (1 if strict else 0), port[:3]
    text = port[1]
    if fault == "orphan":
        assert "orphan spans: 2" in text and "parent=123456789" in text
    else:
        assert "spans dropped at record time: 6" in text
    assert "strict: FAILED" in port[2]


def test_trace_report_errors_alike(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"nothing": []}))
    for argv in ([str(tmp_path / "none-*.json")], [str(bad)]):
        port, ref = _both_reports(argv, tmp_path / "merged.json")
        assert port == ref and port[0] == 1, port


def test_trace_report_loads_the_ports_tracing_without_torch():
    """The report reads the port's ``tracing.py`` by path, in a fresh
    interpreter that never imports torch."""
    code = ("import sys; from distributed_deep_q_tpu_torch import "
            "trace_report as t; m = t._load_tracing(); "
            "assert m.__file__.endswith('distributed_deep_q_tpu_torch/"
            "tracing.py'), m.__file__; "
            "assert 'torch' not in sys.modules, 'torch imported'")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr


# -- bench --trace-ingest ----------------------------------------------------

def _reference_dumped_keys(func: str) -> set[str]:
    """The keys of the dict literal ``func`` in the root ``bench.py``
    prints with ``json.dumps``."""
    tree = ast.parse((REPO / "bench.py").read_text())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == func)
    for node in ast.walk(fn):
        if (isinstance(node, ast.Call) and isinstance(node.func,
                                                      ast.Attribute)
                and node.func.attr == "dumps"
                and isinstance(node.args[0], ast.Dict)):
            return {k.value for k in node.args[0].keys}
    raise AssertionError(f"no json.dumps({{...}}) in {func}")


def test_trace_ingest_on_the_cpu(tmp_path):
    """``bench --trace-ingest --device cpu --quick``: one line of the
    reference's keys and ``launches``; the learner's stages attributed,
    no span dropped, the writers' rows arrived; the shard it names passes
    the port's report under ``--strict``."""
    trace_dir = tmp_path / "traces"
    proc = subprocess.run(
        [sys.executable, "-m", "distributed_deep_q_tpu_torch.bench",
         "--trace-ingest", "--device", "cpu", "--quick", "--trace-dir",
         str(trace_dir)], cwd=REPO, capture_output=True, text=True,
        timeout=240, env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert len(lines) == 1, lines
    line = json.loads(lines[0])
    want = _reference_dumped_keys("trace_ingest")
    assert set(line) == want | {"launches"}, set(line) ^ want
    assert chip_smoke.P18_TRACE_KEYS == want | {"launches"}
    assert line["metric"] == "ingest_attribution"
    assert line["steps_per_s"] > 0 and line["achieved_t_per_s"] > 0
    assert line["wall_s"] >= 2.0
    assert line["spans_dropped"] == 0
    assert {"sample", "train_step", "lock_hold"} <= set(
        line["stage_self_ms"]), line["stage_self_ms"]
    assert set(line["launches"].values()) == {0}   # plain versions
    assert Path(line["trace_path"]).parent == trace_dir
    rc, text, err = _run(trace_report.main, [line["trace_path"], "--strict",
                                             "--out",
                                             str(tmp_path / "m.json")])
    assert rc == 0, err
    assert "orphan spans: 0" in text


# -- bench_elasticity --------------------------------------------------------

def _reference_returned_keys(path: Path) -> set[str]:
    """Every key of the dicts the elasticity bench's functions return."""
    tree = ast.parse(path.read_text())
    keys: set[str] = set()
    for fn in tree.body:
        if isinstance(fn, ast.FunctionDef) and fn.name.startswith("bench_"):
            for node in ast.walk(fn):
                if isinstance(node, ast.Return) and isinstance(node.value,
                                                               ast.Dict):
                    keys |= {k.value for k in node.value.keys}
    return keys


def test_bench_elasticity_prints_the_references_keys():
    proc = subprocess.run(
        [sys.executable, "-m", "distributed_deep_q_tpu_torch.bench_elasticity",
         "--rows", "512", "--repeats", "2", "--tenant-repeats", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert len(lines) == 1, lines
    line = json.loads(lines[0])
    want = _reference_returned_keys(REPO / "scripts" / "bench_elasticity.py")
    assert set(line) == want, set(line) ^ want
    assert line["handoff_rows"] == 512 and line["fleet_size"] == 64
    for k in ("handoff_export_ms", "handoff_import_ms", "tenant_swap_us",
              "executor_apply_us"):
        assert np.isfinite(line[k]) and line[k] > 0, (k, line[k])


@pytest.mark.parametrize("fleet", [8, 64, 257])
def test_remap_fractions_are_the_references(fleet):
    ref = _load("_ref_bench_elasticity",
                REPO / "scripts" / "bench_elasticity.py")
    got = bench_elasticity.bench_remap(fleet)
    assert got == ref.bench_remap(fleet)
    assert 0 < got["remap_fraction_grow"] < 0.75


def test_every_handed_off_row_lands(tmp_path, monkeypatch):
    """A handoff round carries every row; an import that drops one row
    (its replay one row short, the counts untouched) fails the bench."""
    out = bench_elasticity.bench_handoff(700, 1, str(tmp_path / "ok"))
    assert out["handoff_rows"] == 700

    import_shard = bench_elasticity.ms.import_shard

    def lossy(replay, path, *a, **kw):
        server, info = import_shard(replay, path, *a, **kw)
        replay.obs[0] = replay.obs[1]    # row 0's id replaced by row 1's
        return server, info

    monkeypatch.setattr(bench_elasticity.ms, "import_shard", lossy)
    with pytest.raises(SystemExit, match="each of the 700"):
        bench_elasticity.bench_handoff(700, 1, str(tmp_path / "lossy"))


# -- chip_smoke.py phase 18's checks of the two tools' lines ------------------

def _card_trace_line() -> dict:
    return {"metric": "ingest_attribution", "wall_s": 2.1,
            "steps_per_s": 110.0, "achieved_t_per_s": 1_000.0,
            "trace_path": "chip_smoke_out/p18_traces/trace-1.json",
            "spans_dropped": 0,
            "stage_self_ms": {"train_step": 900.0, "sample": 40.0,
                              "ingest_drain": 30.0, "lock_hold": 50.0,
                              "lock_wait": 2_000.0},
            "launches": {"gather_windows": 8, "scatter_rows": 3,
                         "fused_loss_fwd": 0, "fused_loss_bwd": 0}}


@pytest.mark.parametrize("fault", [
    None, "extra_key", "zero_rate", "no_drain_stage", "no_learner_stage",
    "dropped", "no_gather"])
def test_phase18_trace_ingest_check(fault):
    line = _card_trace_line()
    if fault == "extra_key":
        line["quick"] = True
    elif fault == "zero_rate":
        line["achieved_t_per_s"] = 0.0
    elif fault == "no_drain_stage":
        del line["stage_self_ms"]["ingest_drain"]
    elif fault == "no_learner_stage":
        del line["stage_self_ms"]["train_step"]
    elif fault == "dropped":
        line["spans_dropped"] = 4
    elif fault == "no_gather":
        line["launches"]["gather_windows"] = 0
    if fault is None:
        chip_smoke.check_trace_ingest_line(line)
    else:
        with pytest.raises(AssertionError):
            chip_smoke.check_trace_ingest_line(line)


def test_phase18_elasticity_check_takes_the_references_keys():
    """Phase 18's key set is the reference's, and a line as the bench
    prints it passes; a missing key or a zero time fails."""
    want = _reference_returned_keys(REPO / "scripts" / "bench_elasticity.py")
    assert chip_smoke.P18_ELASTICITY_KEYS == want
    line = dict(handoff_export_ms=6.8, handoff_import_ms=4.5,
                handoff_rows=4096, elasticity_spread=0.3, fleet_size=64,
                remap_fraction_grow=0.5156, remap_fraction_shrink=0.5156,
                tenant_swap_us=180.0, shadow_overhead_pct=20.0,
                executor_apply_us=50.0, tenant_spread=0.1)
    chip_smoke.check_elasticity_line(line)
    for k, v in (("handoff_rows", None), ("handoff_import_ms", 0.0)):
        bad = dict(line)
        if v is None:
            del bad[k]
        else:
            bad[k] = v
        with pytest.raises(AssertionError):
            chip_smoke.check_elasticity_line(bad)
