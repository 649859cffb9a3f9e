"""Split a benchmark cell's learner dispatch by the program's tracer
spans, on an NVIDIA card. Run from the repo's root, beside
``benchmark/``:

    python -m distributed_deep_q_tpu_torch.dispatch_phases \
        --workload apex-fused --seed 7 [--out phases.jsonl]

Builds the cell as ``benchmark/run.py`` does (its configuration, weights
and replay from the seed), warms up, then with the tracer on
(``tracing.py``, every span kept):

1. ``DISPATCHES`` dispatches back to back: host ms per grad step in each
   span (``dispatch_inputs``, ``sample``, ``train_step`` and the three
   ``step_*`` spans), beside the dispatching call's own host time
   (``dispatch_host_ms``, as the benchmark reads it) and the share of it
   that the program's top-level spans cover;
2. the benchmark's profiled stretch (``benchmark/trace.py`` ``Stretch``)
   over ``PROFILED`` dispatches, its raw export read by
   ``profiling.phase_census``: device ms and launch calls per grad step
   by span, the top device operations with the span that launched each,
   and the longest idle gaps of the card, named by ``label_gaps`` with
   the program's span open at their middle appended;
3. ``COST_WINDOWS`` windows of ``DISPATCHES`` dispatches, the tracer on
   and off in turns (on, off, off, on, ...): ``dispatch_host_ms`` and
   grad steps/s of each, fence to fence.

The dispatches run the eager body (``Solver.train_steps_eager``), which a
CUDA graph replays on the benchmark's own path: a replay is one launch
call under one span, so only the eager body shows the passes apart.

Prints one JSON line (and appends it to ``--out`` where given). Exits 2
without a card. It reads the benchmark's internals, so it goes once the
benchmark's traced run reads the spans itself.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import torch

from benchmark import run as bench, system, trace
from distributed_deep_q_tpu_torch import profiling, tracing

DISPATCHES = 40     # dispatches a host window holds
PROFILED = 4        # dispatches in the profiled stretch
COST_WINDOWS = 8    # host windows of the on/off comparison


class _RawStretch(trace.Stretch):
    """The benchmark's stretch, keeping the whole export: the host's
    launch calls and each device operation's ``correlation`` as well."""

    def collect(self) -> list:
        self._prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                return json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)
            self._prof = None


def _dispatches(sysm, n: int) -> list:
    """``n`` dispatches; the (start, end) perf_counter seconds of each
    dispatching call."""
    calls = []
    for _ in range(n):
        t = time.perf_counter()
        secs, _ = sysm.dispatch()
        calls.append((t, t + secs))
    return calls


def _host_window(sysm) -> dict:
    """``DISPATCHES`` dispatches; their calls' host seconds, the steps,
    the seconds fence to fence, and the spans the tracer drained."""
    tracing.drain()
    s0, t0 = sysm.steps(), time.perf_counter()
    calls = _dispatches(sysm, DISPATCHES)
    s1, t1 = sysm.steps(), time.perf_counter()
    spans = [e for e in tracing.drain() if e.get("ph") == "X"]
    return {"calls": calls, "steps": s1 - s0, "secs": t1 - t0,
            "spans": spans}


def _host_split(w: dict) -> dict:
    steps = max(w["steps"], 1)
    ms: dict = {}
    for e in w["spans"]:
        ms[e["name"]] = ms.get(e["name"], 0.0) + e["dur"] / 1e3 / steps
    call_s = sum(b - a for a, b in w["calls"])
    top_s = sum(e["dur"] for e in w["spans"]
                if e["args"]["parent"] == 0) / 1e6
    return {"host_ms_per_step": ms,
            "dispatch_host_ms": 1e3 * call_s / steps,
            "coverage": top_s / max(call_s, 1e-12),
            "grad_steps_per_s": w["steps"] / w["secs"]}


def _device_split(sysm) -> dict:
    """``PROFILED`` dispatches in the stretch: ``phase_census`` of its
    export, its gaps named as the benchmark names them plus the span."""
    tracing.drain()
    stretch = _RawStretch()
    stretch.start()
    calls = _dispatches(sysm, PROFILED)
    stretch.close()
    spans = [e for e in tracing.drain() if e.get("ph") == "X"]
    steps = PROFILED * sysm.chain
    census = profiling.phase_census(stretch.collect(), spans, stretch.t0,
                                    steps)
    gaps = census["idle_gaps"]
    named = trace.label_gaps([(t, n) for t, n, _ in gaps],
                             [("dispatch", a, b) for a, b in calls],
                             n=len(gaps))
    census["idle_gaps"] = [
        [n, base if span == profiling.NO_SPAN else f"{base}/{span}"]
        for (base, n), (_, _, span) in zip(named, gaps)]
    busy_s = census["device_ms_per_step_total"] * steps / 1e3
    window_s = stretch.window_s()
    return dict(census, window_s=window_s, idle_share=1.0 - busy_s / window_s)


def main(argv: list | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--out", help="a JSON-lines file to append to")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("dispatch_phases: no CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    spec = bench.load_spec()
    wl = bench.find(spec["workloads"], args.workload)
    entry = bench.find(spec["configs"], wl["config"])
    with open(bench.ROOT / entry["file"]) as f:
        cfg = json.load(f)
    builder = system.load_module("configs", cfg["builder"])
    sysm = builder.build(cfg, args.seed, torch.device("cuda"))
    # the eager body, whose passes the spans split (see above)
    sysm.solver.train_steps_device_per = sysm.solver.train_steps_eager
    sysm.attach(False)
    for _ in range(int(cfg["warmup_dispatches"])):
        sysm.dispatch()
    sysm.steps()

    tracing.configure(enabled=True, sample_rate=1.0, buffer_spans=1 << 17)
    dropped0 = tracing.drop_count()
    host = _host_split(_host_window(sysm))
    device = _device_split(sysm)
    dropped = tracing.drop_count() - dropped0

    cost = []
    for w in range(COST_WINDOWS):
        on = w % 4 in (0, 3)
        tracing.configure(enabled=on, sample_rate=1.0, buffer_spans=1 << 17)
        split = _host_split(_host_window(sysm))
        cost.append({"tracer": on,
                     "dispatch_host_ms": split["dispatch_host_ms"],
                     "grad_steps_per_s": split["grad_steps_per_s"]})
    tracing.configure(enabled=False)
    tracing.drain()

    line = json.dumps({
        "workload": args.workload, "seed": args.seed,
        "card": bench.power_limit(), "host": host, "spans_dropped": dropped,
        "device": device, "cost": cost,
    })
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
