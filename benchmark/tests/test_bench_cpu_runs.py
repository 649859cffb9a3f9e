"""Whole runs of each cell at a size a CPU holds (``tiny``): the port
against the plain reference, a workload or metric added as files alone,
and no JAX in the run."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import textwrap

import pytest

from benchmark import run, system
from benchmark.tests import tiny

SPEC = tiny.with_ingest(run.load_spec())
CELLS = {w["name"]: w["config"] for w in SPEC["workloads"]}


def cpu_cfg(cell: str, dtype: str | None = None) -> dict:
    cfg = tiny.config(CELLS[cell])
    if dtype:
        cfg["net"]["compute_dtype"] = dtype
    if cell == "apex-ingest":
        cfg["replay"]["capacity"] = 65536
    return cfg


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_float32_port_follows_the_reference(cell):
    """With the torso in float32 the port and the reference compute the
    same function from the same draws: every compared number is round-off
    (the draw, windows, n-step targets, loss, Adam, priorities)."""
    res = run.run_cell(SPEC, cell, 7_000_000_001, 0.3, False, device="cpu",
                       cfg=cpu_cfg(cell, "float32"))
    assert res["correct"]
    for name, c in res["checks"].items():
        assert c["value"] <= (0 if name == "ingest_rows_wrong" else 1e-4), \
            (name, c)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_bfloat16_port_is_correct_with_a_full_result(cell):
    res = run.run_cell(SPEC, cell, 2**33 + 5, 0.3, False, device="cpu",
                       cfg=cpu_cfg(cell))
    assert res["correct"], res["checks"]
    assert list(res)[-3:] == ["checks", "_split", "_diag"]
    assert res["attempted"] > 0 and res["failed"] == 0
    names = {m["name"] for m in run.metric_entries(SPEC, cell, False)}
    assert set(res["metrics"]) == names
    assert all(v["value"] > 0 for v in res["metrics"].values())


def test_a_new_mix_and_metric_are_found_by_name(tmp_path, monkeypatch):
    """A later PR adds a cell or a per-layer metric by adding files and
    entries: here a mix file and a reader file in a copy of the folders."""
    for kind in ("configs", "counts", "metrics", "mixes"):
        shutil.copytree(system.BENCH_DIR / kind, tmp_path / kind)
    (tmp_path / "mixes" / "learner_short.json").write_text(
        json.dumps({"name": "learner_short", "trace_dispatches": 2}))
    (tmp_path / "metrics" / "window_dispatches.py").write_text(
        textwrap.dedent('''
        def read(ctx):
            return float(ctx.out.dispatches) or None
        '''))
    monkeypatch.setattr(system, "BENCH_DIR", tmp_path)
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({"name": "apex-short", "config": "apex",
                              "traffic": "learner_short", "chips": 1,
                              "why": "a test cell"})
    spec["per_layer"].append({"name": "window_dispatches", "unit": "1",
                              "better": "higher", "source": "host_clock",
                              "layer": "learner dispatch",
                              "moves": "grad_steps_per_s",
                              "workloads": ["apex-short"]})
    res = run.run_cell(spec, "apex-short", 11, 0.2, True, device="cpu",
                       cfg=cpu_cfg("apex-fused"))
    assert res["correct"]
    assert set(res["metrics"]) == {"window_dispatches"}
    assert res["metrics"]["window_dispatches"]["value"] >= 1


def test_a_run_loads_no_jax(tmp_path):
    """In a fresh interpreter a whole run leaves no module whose top-level
    name is jax, jaxlib, flax or the JAX package (compared whole: the
    port's own name begins with the last), nor the root bench."""
    code = textwrap.dedent(f'''
        import sys
        sys.path.insert(0, {str(run.ROOT)!r})
        from benchmark import run
        from benchmark.tests import tiny
        cfg = tiny.config("apex")
        run.run_cell(run.load_spec(), "apex-fused", 3, 0.2, False,
                     device="cpu", cfg=cfg)
        top = {{m.split(".")[0] for m in sys.modules}}
        print(sorted(set(run.forbidden_modules())), "bench" in top,
              "distributed_deep_q_tpu_torch" in top)
        ''')
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split("\n")[-2] == "[] False True"


def test_forbidden_names_compare_whole_top_levels(monkeypatch):
    monkeypatch.setitem(sys.modules, "distributed_deep_q_tpu_torch_x",
                        sys.modules["json"])
    assert "distributed_deep_q_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "distributed_deep_q_tpu.config",
                        sys.modules["json"])
    assert run.forbidden_modules() == ["distributed_deep_q_tpu"]


def test_no_module_of_the_benchmark_imports_jax():
    """By their import statements: no module under ``benchmark/`` names
    jax, jaxlib, flax or the JAX package as its top-level import."""
    import ast

    for path in system.BENCH_DIR.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                tops = [(node.module or "").split(".")[0]]
            else:
                continue
            assert not set(tops) & set(run.FORBIDDEN), (path, tops)
