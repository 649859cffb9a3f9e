"""Readings of the comparison's control and faults, which set the limits
of ``correct`` (the benchmark's own runs never run this).

    python3 benchmark/control.py --config apex --seeds 11 12 13 \
        [--modes control half_batch frozen] [--device cuda]

Each mode puts the plain reference in the program's place at the
configuration's own sizes and follows the same first steps from the same
seeded inputs, then judges that stand-in as a run judges the program:

- ``control``: computed one precision below what the configuration
  states: its bfloat16 torso and head in float8 (e4m3, one scale per
  tensor), and a float32 LSTM in TF32;
- ``half_batch``: the loss the mean over half of the batch;
- ``frozen``: every step leaves the parameters unchanged.

Prints one JSON line per (mode, seed) with each compared number.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

MODES = ("control", "half_batch", "frozen")


def reading(cfg: dict, seed: int, mode: str, device) -> dict:
    """The compared numbers of ``mode``'s stand-in against the reference."""
    from benchmark import system
    from benchmark.reference import common

    reference = system.load_module("reference", cfg["reference"])
    builder = system.load_module("configs", cfg["builder"])
    fill = builder.fill_counts(cfg)
    plan = common.plan_for(cfg)
    kw = {}
    if mode == "control":
        kw["prec"] = "fp8"
        if cfg["net"]["kind"] == "r2d2":
            kw["lstm_prec"] = "tf32"
    else:
        kw["fault"] = mode
    cand = reference.run(cfg, seed, fill, device, plan, **kw)
    ref = reference.run(cfg, seed, fill, device, plan, cand=cand)
    nums = common.follow_and_compare(ref, cand)
    nums.pop("quiet_leaves")
    return nums


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--modes", nargs="+", default=list(MODES),
                    choices=MODES)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    with open(ROOT / "benchmark" / "configs" / f"{args.config}.json") as f:
        cfg = json.load(f)
    for mode in args.modes:
        for seed in args.seeds:
            t = time.perf_counter()
            nums = reading(cfg, seed, mode, args.device)
            print(json.dumps({"config": args.config, "mode": mode,
                              "seed": seed, **nums,
                              "seconds": time.perf_counter() - t}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
