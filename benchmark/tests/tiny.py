"""Configurations cut to a size a CPU test holds: every shape the cells
run, smaller (36×36 frames, small batches, rings and LSTM), with the
first target refresh in the warm-up.

At this size the compared numbers read otherwise than at the cells' own,
so the tiny configurations carry limits of their own, set as the cells'
are: from the port's readings on this CPU over 12 seeds (largest: apex
loss1 0.0022, grad 0.022, dtheta1 0.022, prio 0.0036, dtheta2 0.020;
r2d2 0.0072, 0.015, 0.0074, 0.0043, 0.0063) and the stand-ins' over 4
(smallest: the control's apex prio 0.029, r2d2 grad 0.065, dtheta1
0.027, dtheta2 0.033; half the batch's loss1 0.13 and 0.16, grad 0.28,
dtheta1 0.29, dtheta2 0.37 on apex; a frozen state's 1). As at the
cells' sizes, a number no stand-in separates from the port by the
contract's margins has no limit here (r2d2's priorities: the control
reads 0.0089 against the port's 0.0043)."""

from __future__ import annotations

import copy
import json
from pathlib import Path

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
LIMITS = {
    "apex": {"loss1_gap": 0.02, "grad_gap": 0.1, "dtheta1_gap": 0.1,
             "prio_gap": 0.012, "dtheta2_gap": 0.1},
    "r2d2": {"loss1_gap": 0.04, "grad_gap": 0.04, "dtheta1_gap": 0.016,
             "dtheta2_gap": 0.015},
}


def config(name: str) -> dict:
    with open(CONFIGS / f"{name}.json") as f:
        cfg = json.load(f)
    cfg = copy.deepcopy(cfg)
    cfg["net"]["frame_shape"] = [36, 36]
    cfg["warmup_dispatches"] = 1
    # the first target refresh falls in the warm-up, where a run checks it
    cfg["train"]["target_update_period"] = 12
    rp = cfg["replay"]
    if name == "apex":
        rp.update(capacity=16384, batch_size=32, fused_chain=4,
                  write_chunk=16)
        cfg.update(fill_rows=2048, fill_chunk=64, done_every=16)
        cfg["limits"] = LIMITS["apex"]
    else:
        cfg["limits"] = LIMITS["r2d2"]
        cfg["net"]["lstm_size"] = 16
        rp.update(batch_size=8, sequence_length=12, burn_in=4,
                  sequences=32, fused_chain=3, write_chunk=4)
        cfg.update(fill_sequences=16, end_every=2)
    return cfg


# the actor-ingest cell as a later PR would add it (entries only: its mix,
# traffic and readers are files the harness has): the CPU tests drive the
# feed path through it
INGEST_CELL = {"name": "apex-ingest", "config": "apex",
               "traffic": "actor_ingest", "chips": 1,
               "why": "apex-fused's learner under 4 paced actor writers"}
INGEST_METRICS = {
    "end_to_end": [{"name": "ingest_transitions_per_s",
                    "unit": "transitions/s", "better": "higher",
                    "bound": 0.25, "source": "host_clock",
                    "workloads": ["apex-ingest"]}],
    "per_layer": [
        {"name": name, "unit": unit, "better": better, "source": source,
         "layer": layer, "moves": "ingest_transitions_per_s",
         "workloads": ["apex-ingest"]}
        for name, unit, better, source, layer in (
            ("scatter_rows_roofline", "%", "higher", "device_trace",
             "kernels"),
            ("ingest_add_p95_ms", "ms", "lower", "program_span", "feed"),
            ("learner_lock_hold_ms", "ms", "lower", "program_span",
             "feed lock"))],
}


def with_ingest(spec: dict) -> dict:
    """``spec`` with the actor-ingest cell and its metrics added."""
    spec = copy.deepcopy(spec)
    spec["workloads"].append(dict(INGEST_CELL))
    for kind, entries in INGEST_METRICS.items():
        spec[kind] += copy.deepcopy(entries)
    for m in spec["per_layer"]:
        if m["moves"] == "grad_steps_per_s":
            m["workloads"].append("apex-ingest")
    return spec
