"""BENCHMARK.json against the contract's limits, and the harness finding
every cell, configuration, mix and metric by name."""

from __future__ import annotations

import json
import re

import pytest

from benchmark import run, system
from benchmark.tests import tiny

SPEC = run.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys_and_budget():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    rs = SPEC["run_seconds"]
    assert 1 <= rs <= 51
    # a full check of 24 cells fits in 43,200 seconds
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(CELLS) // 4)
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_names_units_and_lines():
    named = (SPEC["configs"] + SPEC["workloads"] + SPEC["end_to_end"]
             + SPEC["per_layer"])
    for e in named:
        assert NAME.match(e["name"]), e["name"]
    for kind in ("configs", "workloads"):
        names = [e["name"] for e in SPEC[kind]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(metrics) == len(set(metrics))
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for e in SPEC["configs"] + SPEC["workloads"]:
        assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"]
    for c in SPEC["configs"]:
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])


def test_end_to_end_bounds():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_finds_its_files_by_name(cell):
    wl = run.find(SPEC["workloads"], cell)
    entry = run.find(SPEC["configs"], wl["config"])
    with open(run.ROOT / entry["file"]) as f:
        cfg = json.load(f)
    assert cfg["name"] == wl["config"]
    assert sorted(cfg["reduced"]) == sorted(entry["reduced"])
    assert (system.BENCH_DIR / "mixes" / f"{wl['traffic']}.json").exists()
    for kind in ("configs", "counts", "reference"):
        key = {"configs": "builder"}.get(kind, kind)
        assert system.load_module(kind, cfg[key]) is not None
    e2e = run.metric_entries(SPEC, cell, per_layer=False)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    layer = run.metric_entries(SPEC, cell, per_layer=True)
    assert layer
    for m in layer:
        assert m["moves"] in names
        assert callable(system.load_module("metrics", m["name"]).read)


def test_each_config_is_used_and_layer_names_agree():
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    layers = {}
    for m in SPEC["per_layer"]:
        layers.setdefault(m["layer"], set()).add(m["name"])
    assert set(layers) == {"learner dispatch", "device", "whole grad step",
                           "kernels"}


def test_ingest_metrics_only_in_the_ingest_cell():
    """The actor-ingest cell, added by its entries alone, reports the feed's
    metrics, and no other cell does."""
    spec = tiny.with_ingest(SPEC)
    for cell in [w["name"] for w in spec["workloads"]]:
        e2e = {m["name"] for m in run.metric_entries(spec, cell, False)}
        layer = {m["name"] for m in run.metric_entries(spec, cell, True)}
        ingest = cell == "apex-ingest"
        assert ("ingest_transitions_per_s" in e2e) == ingest
        assert ("learner_lock_hold_ms" in layer) == ingest
        for name in layer:
            assert callable(system.load_module("metrics", name).read)
