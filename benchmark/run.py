"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration, whose
file under ``configs/`` names its module, plain reference and counts, and
a traffic mix, a data file under ``mixes/`` that ``traffic.py`` reads. The
run builds the program's learner with weights and replay made from the
seed, drives its first steps and keeps what the reference needs, warms up,
and measures one window. With ``--trace 0`` the result carries the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics, each read by
``metrics/<name>.py`` from the run and a profiled stretch of the window.
Then the program is freed and the reference judges the first steps (and,
under ingest, every row the writers counted), and θ⁻ is held against θ
at step P, the first target refresh, where the run reached it:
``correct``.

Standard output's last line is the result: ``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``, each compared number with its limit, which also close
standard error. Exits 2 without a CUDA card or with fewer cards than the
cell asks for, 3 if JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "distributed_deep_q_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (compared whole: the port's name begins with the last)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def find(entries: list, name: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no entry named {name!r}")


def metric_entries(spec: dict, cell: str, per_layer: bool) -> list:
    """The cell's metrics of one kind: an end-to-end one without
    ``workloads`` in every cell, any other where its ``workloads`` lists
    the cell (every per-layer entry lists its cells)."""
    if per_layer:
        return [m for m in spec["per_layer"] if cell in m["workloads"]]
    return [m for m in spec["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]]


def end_to_end(name: str, out, t_start: float):
    """An end-to-end metric from the host clock's window."""
    if name == "grad_steps_per_s":
        return out.steps / out.window_s
    if name == "ingest_transitions_per_s":
        if out.writers is None:
            return None
        return (out.landed[1] - out.landed[0]) / out.window_s
    if name == "setup_s":
        return out.t_open - t_start
    raise KeyError(f"no end-to-end metric {name!r}")


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def run_cell(spec: dict, cell: str, seed: int, seconds: float, traced: bool,
             device: str = "cuda", cfg: dict | None = None,
             t_start: float = T_START) -> dict:
    """One run of ``cell``; returns the result (the last line's object)."""
    import torch

    from benchmark import peaks, system, traffic
    from benchmark.trace import label_gaps

    split = {"before_cell_s": time.perf_counter() - t_start}
    wl = find(spec["workloads"], cell)
    entry = find(spec["configs"], wl["config"])
    if cfg is None:
        with open(ROOT / entry["file"]) as f:
            cfg = json.load(f)
    with open(system.BENCH_DIR / "mixes" / f"{wl['traffic']}.json") as f:
        mix = json.load(f)
    builder = system.load_module("configs", cfg["builder"])
    counts = system.load_module("counts", cfg["counts"])
    t = time.perf_counter()
    import distributed_deep_q_tpu_torch.solver  # noqa: F401
    split["imports_s"] = time.perf_counter() - t
    t = time.perf_counter()
    dev = torch.device(device)
    torch.zeros(1, device=dev).sum().item()
    split["device_init_s"] = time.perf_counter() - t
    t = time.perf_counter()
    sysm = builder.build(cfg, seed, dev)
    split["build_and_fill_s"] = time.perf_counter() - t
    t = time.perf_counter()
    sysm.attach(bool(mix.get("ingest")))
    sysm.first_steps()
    split["first_steps_s"] = time.perf_counter() - t
    t = time.perf_counter()
    out = traffic.run(sysm, mix, seconds, traced)
    split["warmup_s"] = out.t_open - t
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    ctx = SimpleNamespace(out=out, cfg=cfg, chain=sysm.chain, counts=counts,
                          flops=counts.flops_per_step(cfg), peaks=peaks)
    metrics = {}
    for m in metric_entries(spec, cell, traced):
        value = (system.load_module("metrics", m["name"]).read(ctx)
                 if traced else end_to_end(m["name"], out, t_start))
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    # θ⁻ is a copy of θ: exact
    checks = [("target_gap", sysm.target_gap(), 0.0)]
    failed_chunks, chunks = 0, traffic.window_chunks(out)
    if out.writers is not None:
        wrong = sysm.rows_wrong(out.writers.counted, out.writers.first_t)
        checks.append(("ingest_rows_wrong", wrong, 0))
        failed_chunks = min(chunks, -(-wrong // out.writers.chunk))
    refreshed = sysm.at_period is not None
    fill, plan, trace = sysm.fill, sysm.plan, sysm.trace
    reference = sysm.reference
    sysm.free()
    del sysm
    judged, diag = system.judge(cfg, seed, fill, dev, plan, trace,
                                reference)
    checks = judged + checks
    diag["target_refresh_reached"] = refreshed
    correct = all(math.isfinite(v) and v <= lim for _, v, lim in checks)
    result = {
        "correct": bool(correct),
        "attempted": out.steps + chunks,
        "failed": traffic.nonfinite_steps(out) + failed_chunks,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu"),
            "count": int(wl["chips"]),
            "memory_peak_bytes": int(peak),
        },
    }
    if traced and out.stretch is not None:
        st = out.stretch
        result["device"]["busy_s"] = st.busy_s()
        result["device"]["window_s"] = st.window_s()
        result["breakdown"] = {
            "device_ops": st.top_ops(10),
            "idle_gaps": label_gaps(st.gaps(), out.spans, 10)}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, v, lim in checks}
    result["_split"] = split
    result["_diag"] = diag
    return result


def main(argv: list | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("benchmark: no CUDA card (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    spec = load_spec()
    wl = find(spec["workloads"], args.workload)
    if torch.cuda.device_count() < wl["chips"]:
        print(f"benchmark: {args.workload} needs {wl['chips']} cards, "
              f"{torch.cuda.device_count()} are visible", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    result = run_cell(spec, args.workload, args.seed, args.seconds,
                      bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: loaded {', '.join(bad)}: the run must not import "
              "JAX or the JAX package", file=sys.stderr)
        return 3
    split = result.pop("_split")
    print(f"setup split: {json.dumps(split)}", file=sys.stderr)
    print(f"first steps: {json.dumps(result.pop('_diag'))}",
          file=sys.stderr)
    print(f"card: {power_limit()}", file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
