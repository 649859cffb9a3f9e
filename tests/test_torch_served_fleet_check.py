"""``chip_smoke.py`` phase 12b's served-fleet check on the CPU.

The phase runs the autoscaler's executor in dry run, so a decision moves
the scaler's target while the fleet stays at its boot size. The check
must accept that run only when every decision was walked through the
executor's dry-run path, and must keep failing every other elastic
problem. Records are built from the port's own ``ScaleExecutor``.
"""

from __future__ import annotations

import copy
import json
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from distributed_deep_q_tpu_torch import telemetry_report  # noqa: E402
from distributed_deep_q_tpu_torch.actors.autoscaler import Decision  # noqa: E402
from distributed_deep_q_tpu_torch.actors.executor import ScaleExecutor  # noqa: E402

FLEET = chip_smoke.SERVED_FLEET
SUMMARY = {"inference_requests": 10, "inference_param_pulls": 0,
           "inference_compiled_buckets": 2, "actor_scale_terminations": 0}


class _Fleet:
    def fleet_size(self) -> int:
        return FLEET

    def actor_ids(self) -> list[int]:
        return list(range(FLEET))


def _records(decide: bool) -> list[dict]:
    """Three log ticks of a dry-run fleet; with ``decide`` the last one
    carries a flush-latency shrink, as the scaler emits it."""
    ex = ScaleExecutor(_Fleet(), dry_run=True, clock=lambda: 331.0)
    recs = [{"autoscale/target_actors": float(FLEET), **ex.gauges()}
            for _ in range(3)]
    if decide:
        d = Decision(action="shrink_actors", rule="flush_p99",
                     key="rpc/add_transitions_ms_p99", member="replay",
                     value=287.6, target=250.0, burn_fast=1.3333,
                     burn_slow=1.3333, from_n=FLEET, to_n=FLEET - 1,
                     t=330.5)
        recs[-1]["autoscale/decision"] = [d.to_jsonable()]
        recs[-1]["autoscale/applied"] = ex.apply([d])
        recs[-1].update(ex.gauges())
        recs[-1]["autoscale/target_actors"] = float(FLEET - 1)
    return recs


def _check(tmp_path, monkeypatch, records: list[dict]) -> dict:
    monkeypatch.setattr(chip_smoke, "OUT_DIR", str(tmp_path))
    (tmp_path / "served.jsonl").write_text(
        "".join(json.dumps(r) + "\n" for r in records))
    return chip_smoke.check_served_fleet({"summary": SUMMARY},
                                         "served.jsonl", telemetry_report)


@pytest.mark.parametrize("decide", [False, True],
                         ids=["no_decision", "dry_run_shrink_at_the_end"])
def test_clean_dry_run_passes(tmp_path, monkeypatch, decide):
    out = _check(tmp_path, monkeypatch, _records(decide))
    assert len(out["decisions"]) == int(decide)
    # the open loop is reported, and only when the target moved
    assert len(out["elastic_problems"]) == int(decide)


def _applied_in_dry_run(recs):
    recs[-1]["autoscale/applied"][0]["applied"] = 1


def _no_finding(recs):
    del recs[-1]["autoscale/applied"]


def _fleet_moved(recs):
    recs[-1]["autoscale/applied_actors"] = float(FLEET - 1)


def _rule_lost(recs):
    recs[-1]["autoscale/decision"][0]["rule"] = ""


def _burns_lost(recs):
    del recs[-1]["autoscale/decision"][0]["burn_fast"]


def _open_loop_without_decision(recs):
    for r in recs:
        r["autoscale/applied_actors"] = float(FLEET - 1)
        r["autoscale/target_actors"] = float(FLEET)
        r.pop("autoscale/decision", None)
        r.pop("autoscale/applied", None)


@pytest.mark.parametrize("mutate", [
    _applied_in_dry_run, _no_finding, _fleet_moved, _rule_lost, _burns_lost,
    _open_loop_without_decision])
def test_broken_run_fails(tmp_path, monkeypatch, mutate):
    recs = copy.deepcopy(_records(True))
    mutate(recs)
    with pytest.raises(AssertionError):
        _check(tmp_path, monkeypatch, recs)


def test_lost_handoff_rows_fail(tmp_path, monkeypatch):
    recs = _records(False)
    recs[-1]["fleet/handoff_lost_rows"] = 3
    with pytest.raises(AssertionError):
        _check(tmp_path, monkeypatch, recs)
