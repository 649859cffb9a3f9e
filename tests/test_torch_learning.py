"""Port vs reference: the learning-dynamics plane (``learning.py``) and where
the fused chains return it.

Pins and their tolerances:

- the plane's geometry is the port's ``metrics.Histogram``'s and the
  reference's layout, slot for slot;
- ``lm_update`` on the same inputs (NaN, ±inf, |TD| below ``TD_LO`` and
  above ``TD_HI``, repeated bucket indices): bucket counts, sample and
  step counts exact, sums within 1e-6 relative, extrema bitwise;
- the host fold, the accumulator, its window drain and the scrape:
  bitwise against the reference's host functions on the same planes;
- the fused chain with the gate on leaves the train state and the
  priorities bitwise equal to the gate off;
- the port's plane against the reference ``Solver``'s
  (``stack_forwards=on``, the reference's uniforms): counts exact, the
  float slots within 1e-4 relative (|TD|, Q and the losses differ between
  the packages by float rounding, ``tests/test_torch_fused_step.py``);
- no plane wherever the reference's ``use_plane`` is false;
- the R2D2 chained plane against the reference's, the same way;
- the in-process loop's JSONL carries every ``learn/*`` gauge and the
  ``learn/td_error`` summary; the divergence trend fires and the scrape
  feeds the fleet verdict (the twins of the reference's own tests).
"""

import json
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_deep_q_tpu import config as ref_config
from distributed_deep_q_tpu import health as ref_health
from distributed_deep_q_tpu import learning as ref_learning
from distributed_deep_q_tpu.parallel.learner import _locate_adam_state
from distributed_deep_q_tpu.replay.device_per import (
    DevicePERFrameReplay as RefReplay)
from distributed_deep_q_tpu.solver import Solver as RefSolver

from distributed_deep_q_tpu_torch import config as port_config
from distributed_deep_q_tpu_torch import health, learning
from distributed_deep_q_tpu_torch.main import main
from distributed_deep_q_tpu_torch.metrics import Histogram
from distributed_deep_q_tpu_torch.replay.device_per import (
    DevicePERFrameReplay)
from distributed_deep_q_tpu_torch.solver import Solver

FRAME, STACK = (10, 10), 2
COUNT_SLOTS = (list(range(learning.N_HIST))
               + [learning.I_SAMPLES, learning.I_REFRESH,
                  learning.I_NONFINITE, learning.I_STEPS])


def _assert_planes(got, want, rtol, extrema_rtol=0.0):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape == (learning.PLANE_SIZE,)
    np.testing.assert_array_equal(got[COUNT_SLOTS], want[COUNT_SLOTS])
    sums = [i for i in range(learning.N_HIST, learning._MAX)
            if i not in COUNT_SLOTS]
    np.testing.assert_allclose(got[sums], want[sums], rtol=rtol)
    np.testing.assert_allclose(got[learning._MAX:], want[learning._MAX:],
                               rtol=extrema_rtol, atol=0)


# -- geometry and the device update ------------------------------------------

def test_plane_geometry_matches_histogram_and_reference():
    h = Histogram(learning.TD_LO, learning.TD_HI, learning.TD_PER_DECADE)
    assert learning.N_HIST == len(h._counts) == ref_learning.N_HIST
    for name in ("PLANE_SIZE", "I_TD_SUM", "I_PRIO_SUM", "I_ISW_SUM",
                 "I_SAMPLES", "I_LOSS_SUM", "I_GNORM_SUM",
                 "I_GNORM_CLIP_SUM", "I_QMEAN_SUM", "I_REFRESH",
                 "I_NONFINITE", "I_STEPS", "I_TD_MAX", "I_Q_MAX",
                 "I_PRIO_MAX", "I_ISW_MIN", "I_TD_MIN", "_REPL", "_MAX",
                 "_MIN"):
        assert getattr(learning, name) == getattr(ref_learning, name), name
    np.testing.assert_array_equal(learning.lm_init("cpu").numpy(),
                                  np.asarray(ref_learning.lm_init()))


def _step_inputs(rng, i):
    td = rng.lognormal(0.0, 3.0, 48).astype(np.float32)
    td[:6] = [np.nan, np.inf, -np.inf, 0.0, learning.TD_LO / 10,
              learning.TD_HI * 7]
    td[6:16] = td[16]                 # ten repeats of one bucket index
    w = rng.uniform(0.1, 1.0, 48).astype(np.float32)
    w[3] = np.nan
    q = rng.standard_normal((48, 4)).astype(np.float32)
    q[5, 2] = np.inf
    loss = np.float32([1.5, np.nan, 0.25, np.inf, 3.0][i % 5])
    gnorm = np.float32([0.5, 20.0, np.nan, 12.0, 3.0][i % 5])
    return td, w, q, loss, np.float32(q[np.isfinite(q)].mean()), gnorm


@pytest.mark.parametrize("clip, tau", [(10.0, 0.0), (0.0, 0.0),
                                       (10.0, 0.01), (0.0, 0.005)])
def test_lm_update_matches_reference(clip, tau):
    rng = np.random.default_rng(3)
    kw = dict(grad_clip_norm=clip, target_tau=tau, target_update_period=3)
    rcfg, pcfg = ref_config.TrainConfig(**kw), port_config.TrainConfig(**kw)
    ref_plane, plane = ref_learning.lm_init(), learning.lm_init("cpu")
    for i in range(7):
        td, w, q, loss, qm, gn = _step_inputs(rng, i)
        step = i + 1
        ref_plane = ref_learning.lm_update(
            ref_plane, cfg=rcfg, td_abs=jnp.asarray(td),
            weight=jnp.asarray(w), loss=jnp.asarray(loss),
            q=jnp.asarray(q), q_mean=jnp.asarray(qm),
            gnorm=jnp.asarray(gn), step=jnp.int32(step), alpha=0.6,
            eps=1e-6)
        learning.lm_update(
            plane, cfg=pcfg, td_abs=torch.from_numpy(td),
            weight=torch.from_numpy(w), loss=torch.tensor(loss),
            q=torch.from_numpy(q), q_mean=torch.tensor(qm),
            gnorm=torch.tensor(gn), step=torch.tensor(step, dtype=torch.int32),
            alpha=0.6, eps=1e-6)
    got = learning.lm_finalize(plane).numpy()
    _assert_planes(got, np.asarray(ref_plane), rtol=1e-6)
    # per step: nan, -inf, 0 and lo/10 underflow; +inf and 7·hi overflow
    assert got[0] >= 7 * 4 and got[learning.N_HIST - 1] >= 7 * 2


# -- the host half -----------------------------------------------------------

def _planes(n=5, seed=4):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        p = np.asarray(ref_learning.lm_init(), np.float32).copy()
        p[:learning.N_HIST] = rng.integers(0, 9, learning.N_HIST)
        p[learning.N_HIST:learning._MAX] = rng.uniform(
            0, 10, learning._MAX - learning.N_HIST)
        p[learning.I_STEPS] = 8
        p[learning.I_SAMPLES] = p[:learning.N_HIST].sum()
        p[learning._MAX:] = rng.uniform(0.01, 5, 5)
        out.append(p)
    return out


def test_host_fold_accumulator_and_drain_match_reference():
    planes = _planes()
    a, b = learning.host_plane(), ref_learning.host_plane()
    learning.fold_plane(a, np.stack(planes[:2]))
    ref_learning.fold_plane(b, np.stack(planes[:2]))
    learning.fold_plane(a, torch.from_numpy(planes[2]))
    ref_learning.fold_plane(b, planes[2])
    np.testing.assert_array_equal(a, b)
    assert (learning.plane_histogram(a).summary("x")
            == ref_learning.plane_histogram(b).summary("x"))

    acc, ref_acc = learning.LearnAccumulator(), ref_learning.LearnAccumulator()
    assert acc.gauges() == ref_acc.gauges() == {}
    for p in planes[:3]:
        acc.ingest(torch.from_numpy(p))
        ref_acc.ingest(p)
    acc.ingest(None)
    assert acc.planes == ref_acc.planes == 3
    g = acc.gauges()
    assert g == ref_acc.gauges() and len(g) == 14
    # a drained window publishes its last gauges again
    assert acc.gauges() == ref_acc.gauges() == g
    acc.ingest(planes[3])
    ref_acc.ingest(planes[3])
    assert acc.gauges() == ref_acc.gauges() != g
    assert (acc.hist_snapshot().summary("learn/td_error")
            == ref_acc.hist_snapshot().summary("learn/td_error"))


def test_learn_scrape_matches_reference():
    health.configure(enabled=True, fast_window_s=1.0, slow_window_s=5.0)
    ref_health.configure(enabled=True, fast_window_s=1.0, slow_window_s=5.0)
    try:
        out = []
        for lrn, hl in ((learning, health), (ref_learning, ref_health)):
            acc = lrn.LearnAccumulator()
            mon = hl.HealthMonitor(hl.default_learn_rules(),
                                   hl.default_learn_trends(), name="learner")
            scrape = lrn.learn_scrape_fn(acc, mon)
            for p in _planes(3):
                acc.ingest(p)
            verdict = scrape()
            verdict.pop("t")                # the scrape's own clock
            out.append(verdict)
        assert out[0] == out[1]
    finally:
        health.reset()
        ref_health.reset()


def _synth_plane(loss=1.0, gnorm=2.0, steps=1.0) -> np.ndarray:
    p = np.zeros(learning.PLANE_SIZE, np.float32)
    p[0] = 3.0
    p[learning.I_TD_SUM] = 6.0
    p[learning.I_PRIO_SUM] = 3.0
    p[learning.I_ISW_SUM] = 3.0
    p[learning.I_SAMPLES] = 3.0
    p[learning.I_LOSS_SUM] = loss * steps
    p[learning.I_GNORM_SUM] = gnorm * steps
    p[learning.I_GNORM_CLIP_SUM] = gnorm * steps
    p[learning.I_QMEAN_SUM] = 0.5 * steps
    p[learning.I_REFRESH] = steps
    p[learning.I_STEPS] = steps
    p[learning.I_TD_MAX] = 4.0
    p[learning.I_Q_MAX] = 2.0
    p[learning.I_PRIO_MAX] = 1.0
    p[learning.I_ISW_MIN] = 0.25
    p[learning.I_TD_MIN] = 0.5
    return p


def test_loss_divergence_trend_fires_on_spike():
    """Twin of the reference's: a flat loss series is ok; a 50× spike
    walks the learner monitor to degraded with a ``loss_divergence``
    finding carrying the spiked value."""
    health.configure(enabled=True, fast_window_s=1.0, slow_window_s=5.0)
    try:
        mon = health.HealthMonitor(health.default_learn_rules(),
                                   health.default_learn_trends(),
                                   name="learner")
        t0 = 100.0
        for i in range(6):
            mon.sample({"learn/loss": 1.0, "learn/grad_norm": 2.0},
                       t=t0 + 0.5 * i)
        assert mon.verdict(t=t0 + 3.0).status == "ok"
        mon.sample({"learn/loss": 50.0, "learn/grad_norm": 2.0}, t=t0 + 3.5)
        v = mon.verdict(t=t0 + 3.5)
        assert v.status == "degraded"
        hits = [f for f in v.findings if f.rule == "loss_divergence"]
        assert hits and hits[0].value == 50.0 and hits[0].kind == "trend"
    finally:
        health.reset()


def test_learn_scrape_feeds_fleet_verdict():
    """Twin of the reference's: the aggregate verdict carries the
    learner's findings under its member name, on the wire schema."""
    health.configure(enabled=True, fast_window_s=1.0, slow_window_s=5.0)
    try:
        acc = learning.LearnAccumulator()
        mon = health.HealthMonitor(health.default_learn_rules(),
                                   health.default_learn_trends(),
                                   name="learner")
        fleet = health.FleetHealth()
        fleet.register("learner", learning.learn_scrape_fn(acc, mon))
        t0 = 200.0
        for i in range(6):
            acc.ingest(_synth_plane(loss=1.0))
            fleet.scrape(t=t0 + 0.5 * i)
        assert fleet.scrape(t=t0 + 3.0).status == "ok"
        acc.ingest(_synth_plane(loss=60.0))
        v = fleet.scrape(t=t0 + 3.5)
        assert v.status == "degraded"
        assert any(f.rule == "loss_divergence" and f.member == "learner"
                   for f in v.findings)
        wire = v.to_jsonable()
        assert wire["status"] == "degraded" and not wire["ok"]
        assert all({"rule", "severity", "kind"} <= set(f)
                   for f in wire["findings"])
    finally:
        health.reset()


# -- the feed-forward fused chain ----------------------------------------------

def _ff_cfg(mod, stack_forwards="on", batch=16, optimizer="adam",
            learn=True):
    cfg = mod.Config()
    cfg.mesh.backend = "cpu"
    cfg.mesh.dp = 1
    cfg.net = mod.NetConfig(kind="mlp", num_actions=4, hidden=(32, 32),
                            frame_shape=FRAME, stack=STACK)
    cfg.replay = mod.ReplayConfig(capacity=512, batch_size=batch, n_step=2,
                                  prioritized=True, priority_alpha=0.6,
                                  device_per=True, write_chunk=16,
                                  fused_chain=3)
    cfg.train = mod.TrainConfig(lr=1e-3, double_dqn=True,
                                target_update_period=2,
                                stack_forwards=stack_forwards,
                                optimizer=optimizer, learn_metrics=learn,
                                seed=0)
    return cfg


def _stream(replays, n, seed):
    rng = np.random.default_rng(seed)
    for i in range(n):
        frame = rng.integers(0, 255, FRAME, dtype=np.uint8)
        a, r = int(rng.integers(4)), float(rng.standard_normal())
        for rep in replays:
            rep.add(frame, a, r, i % 13 == 12)


def _ref_uniforms(keys, per_shard, device):
    u = np.stack([np.asarray(jax.random.uniform(jnp.asarray(k), (per_shard,)))
                  for k in keys])
    return torch.from_numpy(u).to(device)


def _port_pair(**kw):
    cfg = _ff_cfg(port_config, **kw)
    solver = Solver(cfg, obs_dim=FRAME[0] * FRAME[1] * STACK, backend="cpu")
    rep = DevicePERFrameReplay(cfg.replay, "cpu", FRAME, stack=STACK,
                               gamma=0.99, write_chunk=16)
    return solver, rep


def test_fused_chain_gate_off_is_bitwise_gate_on():
    torch.set_num_threads(1)
    on, rep_on = _port_pair(learn=True)
    off, rep_off = _port_pair(learn=False)
    _stream([rep_on, rep_off], 300, seed=0)
    for _ in range(2):
        m_on = on.train_steps_device_per(rep_on)
        m_off = off.train_steps_device_per(rep_off)
        _stream([rep_on, rep_off], 40, seed=1)
    assert "learn_plane" not in m_off
    p = m_on.pop("learn_plane").numpy()
    assert p[learning.I_STEPS] == 3 and p[learning.I_SAMPLES] == 3 * 16
    assert p[:learning.N_HIST].sum() == p[learning.I_SAMPLES]
    for k in m_off:
        assert torch.equal(m_on[k], m_off[k]), k
    for a, b in ((on.state.net, off.state.net),
                 (on.state.target_net, off.state.target_net)):
        for (na, pa), (_, pb) in zip(a.named_parameters(),
                                     b.named_parameters()):
            assert torch.equal(pa, pb), na
    for key in ("mu", "nu"):
        for name, t in on.state.opt_state[key].items():
            assert torch.equal(t, off.state.opt_state[key][name]), name
    assert torch.equal(on.state.opt_state["count"],
                       off.state.opt_state["count"])
    for key in ("prio", "maxp", "frames"):
        assert torch.equal(rep_on.dstate[key], rep_off.dstate[key]), key


def _ref_pair(**kw):
    cfg = _ff_cfg(ref_config, **kw)
    ref = RefSolver(cfg, obs_dim=FRAME[0] * FRAME[1] * STACK)
    rep = RefReplay(cfg.replay, ref.mesh, FRAME, stack=STACK, gamma=0.99,
                    write_chunk=16)
    return ref, rep


def test_plane_matches_reference_solver():
    """Two chain-3 dispatches with ``stack_forwards=on`` (the reference's
    plane-carry body), the port drawing the reference's uniforms."""
    torch.set_num_threads(1)
    ref, ref_rep = _ref_pair()
    port, rep = _port_pair()
    st = jax.tree.map(np.asarray, ref.state)
    adam, _ = _locate_adam_state(st.opt_state)
    port.load_flax_state(st.params, st.target_params, adam.count, adam.mu,
                         adam.nu, st.step)
    port.draw_uniforms = _ref_uniforms
    _stream([ref_rep, rep], 300, seed=0)
    for _ in range(2):
        want = np.asarray(ref.train_steps_device_per(ref_rep)["learn_plane"])
        got = port.train_steps_device_per(rep)["learn_plane"].numpy()
        _assert_planes(got, want, rtol=1e-4, extrema_rtol=1e-4)
        _stream([ref_rep, rep], 40, seed=1)
    # the chain-1 dispatch pops the plane before slicing the rows
    m = port.train_step_device_per(rep)
    assert m["learn_plane"].shape == (learning.PLANE_SIZE,)
    assert m["loss"].shape == ()


@pytest.mark.parametrize("kw, plane", [
    (dict(stack_forwards="on"), True),
    (dict(stack_forwards="auto", batch=16), True),
    (dict(stack_forwards="auto", batch=256), False),   # > 128 per shard
    (dict(stack_forwards="off"), False),
    (dict(stack_forwards="on", optimizer="rmsprop"), False),
])
def test_plane_appears_exactly_where_the_reference_gives_one(kw, plane):
    torch.set_num_threads(1)
    ref, ref_rep = _ref_pair(**kw)
    port, rep = _port_pair(**kw)
    _stream([ref_rep, rep], 600, seed=0)
    assert ("learn_plane" in ref.train_steps_device_per(ref_rep)) is plane
    assert ("learn_plane" in port.train_steps_device_per(rep)) is plane


def test_r2d2_chained_plane_matches_reference():
    """The R2D2 fused chain feeds the per-sequence priority as |TD| and
    the step's Q max as Q; it has no ``use_plane`` gate."""
    from distributed_deep_q_tpu.parallel.sequence_learner import (
        SequenceSolver as RefSeqSolver)
    from distributed_deep_q_tpu.replay import device_sequence as ref_ds
    from distributed_deep_q_tpu_torch.parallel.sequence_learner import (
        SequenceSolver)
    from distributed_deep_q_tpu_torch.replay import device_sequence as ds
    from test_torch_sequence_step import (
        CAP, FRAME as SFRAME, LSTM, SEQ_LEN, STACK as SSTACK, _cfg,
        _sequences)

    torch.set_num_threads(1)
    rcfg, pcfg = _cfg(ref_config, True), _cfg(port_config, True)
    rcfg.train.learn_metrics = pcfg.train.learn_metrics = True
    ref = RefSeqSolver(rcfg)
    port = SequenceSolver(pcfg, backend="cpu")
    st = jax.tree.map(np.asarray, ref.state)
    adam, _ = _locate_adam_state(st.opt_state)
    port.load_flax_state(st.params, st.target_params, adam.count, adam.mu,
                         adam.nu, st.step)
    kw = dict(lstm_size=LSTM, prioritized=True, alpha=0.6, seed=0,
              write_chunk=4)
    shape = SFRAME + (SSTACK,)
    ref_rep = ref_ds.DeviceSequenceReplay(CAP, SEQ_LEN, shape, ref.mesh, **kw)
    port_rep = ds.DeviceSequenceReplay(CAP, SEQ_LEN, shape, "cpu", **kw)
    for s in _sequences():
        ref_rep.add_sequence(s)
        port_rep.add_sequence(s)
    port.draw_uniforms = _ref_uniforms
    m_ref = ref.train_steps_device_per(ref_rep, chain=3)
    m = port.train_steps_device_per(port_rep, chain=3)
    np.testing.assert_allclose(m["q_max"].numpy(), np.asarray(m_ref["q_max"]),
                               rtol=1e-5)
    _assert_planes(m["learn_plane"].numpy(), np.asarray(m_ref["learn_plane"]),
                   rtol=1e-4, extrema_rtol=1e-4)


def test_in_process_loop_logs_learn_gauges(tmp_path):
    """``main train`` on the fused path with the gate on: the JSONL's log
    records carry every ``learn/*`` gauge and the ``learn/td_error``
    summary, and the steps the planes counted are the grad steps."""
    torch.set_num_threads(1)
    path = tmp_path / "m.jsonl"
    rc = main(["train", "--preset", "pong", "--backend", "cpu",
               "--log-every", "25", "--metrics-jsonl", str(path), "--set",
               "env.kind=signal_atari", "env.id=signal",
               "env.frame_shape=36,36", "net.frame_shape=36,36",
               "net.compute_dtype=float32", "replay.capacity=4096",
               "replay.batch_size=16", "replay.learn_start=300",
               "replay.write_chunk=16", "train.total_steps=700",
               "train.train_every=4", "train.eval_episodes=1",
               "train.learn_metrics=true", "train.stack_forwards=on"])
    assert rc == 0
    records = [json.loads(line) for line in path.read_text().splitlines()]
    logged = [r for r in records if "learn/loss" in r]
    assert logged
    want = set(learning.LearnAccumulator().gauges()) | {
        "learn/loss", "learn/grad_norm", "learn/grad_norm_clipped",
        "learn/q_mean", "learn/q_max", "learn/td_mean", "learn/td_max",
        "learn/prio_mean", "learn/prio_max", "learn/is_weight_mean",
        "learn/is_weight_min", "learn/target_refreshes",
        "learn/loss_nonfinite", "learn/steps"}
    last = logged[-1]
    assert want <= set(last)
    assert any(k.startswith("learn/td_error") for k in last)
    assert last["learn/steps"] == last["step"]
    assert all(math.isfinite(last[k]) for k in want)


def test_distributed_learner_folds_planes_and_joins_the_fleet(
        tmp_path, monkeypatch):
    """``main train --distributed`` on the fused path with the gate on: the
    learner registers itself as the fleet-health member ``"learner"`` and
    its log records carry the ``learn/*`` gauges."""
    import signal

    from distributed_deep_q_tpu_torch.actors import supervisor as sup_mod
    from distributed_deep_q_tpu_torch.metrics import Metrics
    from test_torch_distributed import PIXEL, _cfg, _check

    def expire(signum, frame):
        raise TimeoutError("the distributed run exceeded its 150 s deadline")

    prev = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, 150)
    monkeypatch.setattr(sup_mod.health, "ENABLED", sup_mod.health.ENABLED)
    members = []
    register = sup_mod.health.FleetHealth.register

    def spy(self, name, fn):
        members.append(name)
        return register(self, name, fn)

    monkeypatch.setattr(sup_mod.health.FleetHealth, "register", spy)
    try:
        torch.set_num_threads(2)
        cfg = _cfg("pong", PIXEL + ["train.learn_metrics=true",
                                    "train.stack_forwards=on",
                                    "health.enabled=true"])
        path = tmp_path / "d.jsonl"
        summary = sup_mod.train_distributed(cfg, Metrics(str(path)),
                                            log_every=20)
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, prev)
    _check(summary, cfg)
    assert "learner" in members
    records = [json.loads(line) for line in path.read_text().splitlines()]
    logged = [r for r in records if "learn/steps" in r]
    assert logged and logged[-1]["learn/steps"] == logged[-1]["step"]
    assert "learn/td_error_count" in logged[-1]
