"""The FLOP and byte counts against hand counts at small shapes, and
against ``torch.utils.flop_counter`` over the reference's own step."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import data
from benchmark.counts import apex as apex_counts
from benchmark.counts import r2d2 as r2d2_counts
from benchmark.reference import apex, common, r2d2
from benchmark.tests import tiny


def test_apex_hand_count_at_36x36():
    cfg = tiny.config("apex")
    cfg["net"]["num_actions"] = 4
    cfg["replay"]["batch_size"] = 2
    # 36×36×4 → conv1 8×8×32, conv2 3×3×64, conv3 1×1×64, fc4 64 → 512
    conv1 = 8 * 8 * 32 * 8 * 8 * 4
    m = conv1 + 3 * 3 * 64 * 4 * 4 * 32 + 64 * 3 * 3 * 64 + 64 * 512 \
        + 512 * 5
    assert apex_counts.flops_per_step(cfg) == {
        "bf16": 2.0 * 2 * (5 * m - conv1)}
    # two windows of 7 frames of 36·36 bytes, read and written
    assert apex_counts.gather_bytes(cfg, 1) == 2 * 7 * 1296 * 2
    assert apex_counts.scatter_bytes_per_row(cfg) == 2 * 1296


def test_full_size_counts():
    import json

    from benchmark import system

    with open(system.BENCH_DIR / "configs" / "apex.json") as f:
        a = json.load(f)
    with open(system.BENCH_DIR / "configs" / "r2d2.json") as f:
        r = json.load(f)
    assert apex_counts.flops_per_step(a)["bf16"] == 44_530_401_280.0
    assert apex_counts.gather_bytes(a, 32) == 1_618_477_056.0
    f = r2d2_counts.flops_per_step(r)
    assert (f["bf16"], f["fp32"]) == (272_832_528_384.0, 64_827_162_624.0)
    assert r2d2_counts.gather_bytes(r, 8) == 606_928_896.0


def _counted(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def test_apex_count_is_the_references_step():
    cfg = tiny.config("apex")
    b = cfg["replay"]["batch_size"]
    hw = tuple(cfg["net"]["frame_shape"])
    p0 = data.make_weights(1, apex.param_spec(cfg), "cpu")
    p = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
    tp = {k: v.clone() for k, v in p0.items()}
    opt = common.Optimizer(p, cfg["train"], cfg["optimizer_constants"])
    frames = torch.randint(0, 255, (b, 4) + hw, dtype=torch.uint8)
    batch = {"obs": frames, "next_obs": frames.flip(0),
             "action": torch.zeros(b, dtype=torch.int64),
             "reward": torch.zeros(b), "discount": torch.ones(b)}
    n = _counted(lambda: common.train_step(
        lambda: apex._loss(p, tp, batch, torch.ones(b), cfg["train"], "f32"),
        p, tp, opt, None))
    assert n == apex_counts.flops_per_step(cfg)["bf16"]


def test_r2d2_count_is_the_references_step():
    cfg = tiny.config("r2d2")
    rp = cfg["replay"]
    store = r2d2.Store(cfg, 3, cfg["fill_sequences"], "cpu")
    p0 = data.make_weights(3, r2d2.param_spec(cfg), "cpu")
    p = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
    tp = {k: v.clone() for k, v in p0.items()}
    opt = common.Optimizer(p, cfg["train"], {})
    batch = store.batch(torch.arange(rp["batch_size"]))
    n = _counted(lambda: common.train_step(
        lambda: r2d2._loss(p, tp, batch, torch.ones(rp["batch_size"]), cfg,
                           "f32", "f32"), p, tp, opt, None))
    f = r2d2_counts.flops_per_step(cfg)
    assert n == f["bf16"] + f["fp32"]
