"""The comparison that decides ``correct`` fails what it must: the control
(the reference one precision below the configuration's, in the program's
place) and the faults a training cell can have, planted in the reference
standing in for the program and in the program itself under a whole
run."""

from __future__ import annotations

import pytest
import torch

from benchmark import control, run
from benchmark.tests import tiny
from benchmark.tests.test_bench_cpu_runs import cpu_cfg

SPEC = tiny.with_ingest(run.load_spec())


def fails(nums: dict, cfg: dict) -> list:
    return [k for k, v in nums.items() if k in cfg["limits"]
            and not v <= cfg["limits"][k]]


@pytest.mark.parametrize("mode", control.MODES)
@pytest.mark.parametrize("config", ["apex", "r2d2"])
@pytest.mark.parametrize("seed", [101, 2**33 + 9])
def test_stand_in_fails_the_comparison(config, mode, seed):
    cfg = tiny.config(config)
    assert fails(control.reading(cfg, seed, mode, "cpu"), cfg), mode


def _frozen_step(monkeypatch):
    """Every optimizer step returns the state unchanged."""
    from distributed_deep_q_tpu_torch.parallel import learner, \
        sequence_learner

    def frozen(*args, **kw):
        return None

    monkeypatch.setattr(learner, "apply_optimizer", frozen)
    monkeypatch.setattr(sequence_learner, "apply_optimizer", frozen)


def _half_batch(monkeypatch):
    """The loss is the mean over the first half of the batch; every
    sample's |TD| is still returned."""
    from distributed_deep_q_tpu_torch.parallel import learner, \
        sequence_learner

    dqn, seq = learner.dqn_loss, sequence_learner.sequence_dqn_loss

    def half(q, a, t, w, *rest, **kw):
        h = q.shape[0] // 2
        loss, _ = dqn(q[:h], a[:h], t[:h], w[:h], *rest, **kw)
        return loss, dqn(q, a, t, w, *rest, **kw)[1]

    def half_seq(q, a, t, m, w, *rest, **kw):
        h = q.shape[0] // 2
        loss, _ = seq(q[:h], a[:h], t[:h], m[:h], w[:h], *rest, **kw)
        return loss, seq(q, a, t, m, w, *rest, **kw)[1]

    monkeypatch.setattr(learner, "dqn_loss", half)
    monkeypatch.setattr(sequence_learner, "sequence_dqn_loss", half_seq)


def _altered_row(monkeypatch):
    """One pixel of one writer's row changed where the ring's insert pack
    is made (the first flush once the writers run)."""
    import threading

    from distributed_deep_q_tpu_torch.replay import device_per

    pack = device_per.insert_meta_pack
    done = []

    def altered(staged, maxp, **kw):
        rows, p = pack(staged, maxp, **kw)
        writing = any(t.name.startswith("bench-writer")
                      for t in threading.enumerate())
        if writing and not done:
            done.append(True)
            rows = rows.clone()
            rows[5] ^= 1
        return rows, p

    monkeypatch.setattr(device_per, "insert_meta_pack", altered)


def _no_refresh(monkeypatch):
    """The target copy dropped: θ⁻ stays θ₀ at step P."""
    from distributed_deep_q_tpu_torch.parallel import learner

    adam = learner.fused_adam_target_step

    def adam_no_target(cfg, grads, opt_state, params, target_params, *rest):
        adam(cfg, grads, opt_state, params, None, *rest)

    monkeypatch.setattr(learner, "refresh_target", lambda *a, **k: None)
    monkeypatch.setattr(learner, "fused_adam_target_step", adam_no_target)


FAULTS = {"frozen": _frozen_step, "half_batch": _half_batch,
          "altered_row": _altered_row, "no_refresh": _no_refresh}


@pytest.mark.parametrize("cell,fault", [
    ("apex-fused", "frozen"), ("apex-fused", "half_batch"),
    ("apex-fused", "no_refresh"), ("r2d2-ring", "no_refresh"),
    ("r2d2-ring", "frozen"), ("r2d2-ring", "half_batch"),
    ("apex-ingest", "frozen"), ("apex-ingest", "half_batch"),
    ("apex-ingest", "altered_row")])
def test_a_broken_program_reads_not_correct(cell, fault, monkeypatch):
    """A whole run, the chip's look skipped, with the timed path broken
    underneath: ``correct`` comes out false. (One chip: no exchange
    between chips to leave out. The tiny configurations' target period
    puts step P in the warm-up, so a dropped refresh shows.)"""
    FAULTS[fault](monkeypatch)
    res = run.run_cell(SPEC, cell, 424242, 0.5, False, device="cpu",
                       cfg=cpu_cfg(cell))
    assert not res["correct"], res["checks"]


@pytest.mark.gpu
@pytest.mark.parametrize("config", ["apex", "r2d2"])
def test_control_fails_at_the_cells_size_on_the_card(config):
    """The control and the faults at the configuration's own sizes, on the
    card (``benchmark/control.py`` reads them on several seeds)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    import json

    with open(run.ROOT / "benchmark" / "configs" / f"{config}.json") as f:
        cfg = json.load(f)
    for mode in control.MODES:
        assert fails(control.reading(cfg, 17, mode, "cuda"), cfg), mode
