"""The tracer's spans inside the port's two fused dispatches.

Each dispatch (``Solver`` / ``SequenceSolver.train_steps_device_per``)
records one ``dispatch_inputs``, one ``sample`` and one ``train_step``
span, and ``chain`` each of ``step_forward``, ``step_backward`` and
``step_optimizer`` under ``train_step``; with the tracer off it records
nothing, and the losses and θ are bitwise the same either way. Beside
them: the port's own span table and its static check, the tracer's clock
conversion, a ring grown after it exists, and ``profiling.phase_census``
on a made-up profiler window.
"""

import os
import textwrap
import time

import numpy as np
import pytest
import torch

from distributed_deep_q_tpu_torch import config as port_config
from distributed_deep_q_tpu_torch import profiling, tracing
from distributed_deep_q_tpu_torch.actors.game import FrameStacker
from distributed_deep_q_tpu_torch.analysis import metric_keys
from distributed_deep_q_tpu_torch.analysis.core import Source, pkg
from distributed_deep_q_tpu_torch.parallel.sequence_learner import (
    SequenceSolver)
from distributed_deep_q_tpu_torch.replay.device_per import (
    DevicePERFrameReplay)
from distributed_deep_q_tpu_torch.replay.device_sequence import (
    DeviceSequenceReplay)
from distributed_deep_q_tpu_torch.replay.sequence import SequenceBuilder
from distributed_deep_q_tpu_torch.solver import Solver

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = ("step_forward", "step_backward", "step_optimizer")
# the fused chain of tests/test_torch_fused_step.py's shapes at 4 steps,
# and the sequence chain of tests/test_torch_sequence_step.py's at 2
CHAINS = {"feedforward": 4, "sequence": 2}


def _feedforward():
    frame = (52, 52)
    cfg = port_config.Config()
    cfg.mesh.backend = "cpu"
    cfg.mesh.dp = 1
    cfg.net = port_config.NetConfig(kind="nature_cnn", num_actions=4,
                                    frame_shape=frame,
                                    compute_dtype="float32")
    cfg.replay = port_config.ReplayConfig(
        capacity=256, batch_size=16, n_step=2, prioritized=True,
        priority_alpha=0.6, device_per=True, write_chunk=16, fused_chain=4)
    cfg.train = port_config.TrainConfig(lr=1e-4, double_dqn=True,
                                        target_update_period=2,
                                        stack_forwards="off", seed=0)
    solver = Solver(cfg, backend="cpu")
    replay = DevicePERFrameReplay(cfg.replay, "cpu", frame, stack=4,
                                  gamma=0.99, write_chunk=16)
    rng = np.random.default_rng(0)
    for i in range(300):
        replay.add(rng.integers(0, 255, frame, dtype=np.uint8),
                   int(rng.integers(4)), float(rng.standard_normal()),
                   i % 11 == 10)
    return solver, replay


def _sequence():
    frame, stack, seq_len, burn, lstm, cap = (36, 36), 4, 8, 4, 16, 24
    cfg = port_config.Config()
    cfg.mesh.backend = "cpu"
    cfg.mesh.dp = 1
    cfg.net = port_config.NetConfig(kind="r2d2", num_actions=4,
                                    lstm_size=lstm, frame_shape=frame,
                                    stack=stack, dueling=True,
                                    compute_dtype="float32")
    cfg.replay = port_config.ReplayConfig(
        capacity=cap * seq_len, batch_size=8, sequence_length=seq_len,
        burn_in=burn, prioritized=True, priority_alpha=0.6,
        device_per=True, fused_chain=2)
    cfg.train = port_config.TrainConfig(lr=1e-3, double_dqn=True,
                                        target_update_period=2, seed=0)
    solver = SequenceSolver(cfg, backend="cpu")
    replay = DeviceSequenceReplay(cap, seq_len, frame + (stack,), "cpu",
                                  lstm_size=lstm, prioritized=True,
                                  alpha=0.6, seed=0, write_chunk=4)
    rng = np.random.default_rng(0)
    builder = SequenceBuilder(seq_len, burn, frame + (stack,), np.uint8,
                              lstm)
    stacker = FrameStacker(frame, stack)
    obs = stacker.reset(rng.integers(0, 255, frame, dtype=np.uint8))
    for t in range(120):
        carry = (rng.standard_normal(lstm).astype(np.float32),
                 rng.standard_normal(lstm).astype(np.float32))
        done = t % 11 == 10
        nxt = stacker.push(rng.integers(0, 255, frame, dtype=np.uint8))
        for s in builder.on_step(obs, int(rng.integers(4)),
                                 float(rng.standard_normal()), done, carry,
                                 nxt):
            replay.add_sequence(s)
        obs = nxt
        if done:
            builder.reset()
            obs = stacker.reset(rng.integers(0, 255, frame, dtype=np.uint8))
    return solver, replay


BUILD = {"feedforward": _feedforward, "sequence": _sequence}


@pytest.fixture
def tracer():
    """The tracer on for every span, restored off and emptied after."""
    tracing.reset()
    tracing.drain()
    tracing.configure(enabled=True, sample_rate=1.0)
    try:
        yield tracing
    finally:
        tracing.configure(enabled=False)
        tracing.drain()
        tracing.reset()


def _dispatch(kind, n=2):
    """``n`` dispatches of the kind's chain from a fresh build: the losses
    and θ, θ⁻ after them."""
    torch.manual_seed(0)
    solver, replay = BUILD[kind]()
    losses = [solver.train_steps_device_per(replay, chain=CHAINS[kind])
              ["loss"] for _ in range(n)]
    st = solver.state
    params = [p.detach().clone() for m in (st.net, st.target_net)
              for p in m.parameters()]
    return torch.cat(losses), params


@pytest.mark.parametrize("kind", sorted(CHAINS))
def test_each_dispatch_records_its_spans(kind, tracer):
    chain = CHAINS[kind]
    torch.manual_seed(0)
    solver, replay = BUILD[kind]()
    tracer.drain()
    for _ in range(2):
        solver.train_steps_device_per(replay, chain=chain)
        events = [e for e in tracer.drain() if e["ph"] == "X"]
        names = [e["name"] for e in events]
        for name in ("dispatch_inputs", "sample", "train_step"):
            assert names.count(name) == 1, (name, names)
        for name in PHASES:
            assert names.count(name) == chain, (name, names)
        by_name = {e["name"]: e for e in events}
        train = by_name["train_step"]["args"]["span"]
        for e in events:
            assert {"trace", "span", "parent"} <= set(e["args"])
            assert e["dur"] >= 0
            if e["name"] in PHASES:
                assert e["args"]["parent"] == train
        # the three top-level stages follow one another, in order
        top = [e for e in events if e["args"]["parent"] == 0]
        assert [e["name"] for e in top if e["name"] in (
            "dispatch_inputs", "sample", "train_step")] == [
            "dispatch_inputs", "sample", "train_step"]
    assert tracer.drop_count() == 0


@pytest.mark.parametrize("kind", sorted(CHAINS))
def test_tracer_off_records_nothing(kind):
    tracing.configure(enabled=False)
    tracing.drain()
    _dispatch(kind, n=1)
    assert tracing.drain() == []


@pytest.mark.parametrize("kind", sorted(CHAINS))
def test_spans_leave_the_arithmetic_bitwise_alone(kind, tracer):
    on_losses, on_params = _dispatch(kind)
    tracer.configure(enabled=False)
    off_losses, off_params = _dispatch(kind)
    torch.testing.assert_close(on_losses, off_losses, rtol=0, atol=0)
    for a, b in zip(on_params, off_params):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("delay_s", [0.0, 1e-3])
def test_span_stamps_convert_to_perf_counter_within_a_microsecond(
        delay_s, tracer):
    before = time.perf_counter()
    with tracer.span("step_forward"):
        time.sleep(delay_s)
    after = time.perf_counter()
    (ev,) = [e for e in tracer.drain() if e["name"] == "step_forward"]
    t0 = tracer.to_perf_counter(ev["ts"])
    t1 = tracer.to_perf_counter(ev["ts"] + ev["dur"])
    assert before - 1e-6 <= t0 <= t1 <= after + 1e-6
    assert t1 - t0 >= delay_s - 1e-6
    for t in (before, after, time.perf_counter()):
        ts = (tracing._T0_WALL + (t - tracing._T0_MONO)) * 1e6
        assert abs(tracer.to_perf_counter(ts) - t) < 1e-6


def test_port_stages_are_their_own_table():
    assert set(tracing.PORT_STAGES).isdisjoint(tracing.STAGES)
    assert set(tracing.PORT_STAGES).isdisjoint(tracing.EVENTS)
    assert set(tracing.PORT_STAGES) == {
        "dispatch_inputs", "step_forward", "step_backward", "step_optimizer",
        "dispatch_replay"}


@pytest.mark.parametrize("name, known", [
    ("train_step", True), ("sample", True), ("dispatch_inputs", True),
    ("step_optimizer", True), ("dispatch_replay", True),
    ("step_optimiser", False), ("shed", False)])
def test_span_check_takes_either_table_and_nothing_else(name, known):
    src = Source.parse(textwrap.dedent(f"""
        from distributed_deep_q_tpu_torch import tracing
        with tracing.span({name!r}):
            pass
        with tracing.span_sampled({name!r}):
            pass
    """), "synthetic.py")
    tr = Source.load(os.path.join(REPO, pkg("tracing.py")))
    findings = metric_keys.check_sources([src], tr)
    assert [f.rule for f in findings] == (
        [] if known else [metric_keys.RULE_SPAN] * 2)


def test_configure_resizes_the_importing_threads_ring():
    """The importing thread's ring exists before any ``configure``; a
    larger ``buffer_spans`` must reach it."""
    tracing.reset()
    tracing.drain()
    try:
        tracing.configure(enabled=True, sample_rate=1.0, buffer_spans=32768)
        for _ in range(20000):
            with tracing.span("step_forward"):
                pass
        assert tracing.drop_count() == 0
        assert len(tracing.drain()) == 20000
        # a smaller size leaves a ring that exists as it is
        for _ in range(10):
            with tracing.span("step_backward"):
                pass
        tracing.configure(enabled=True, sample_rate=1.0, buffer_spans=4)
        assert tracing.drop_count() == 0
        assert len(tracing.drain()) == 10
    finally:
        tracing.configure(enabled=False)
        tracing.drain()
        tracing.reset()


def test_configure_off_keeps_the_spans_not_yet_drained():
    """Turning the tracer off with the default size keeps what a larger
    ring holds, in order, none counted dropped."""
    tracing.reset()
    tracing.drain()
    try:
        tracing.configure(enabled=True, sample_rate=1.0, buffer_spans=32768)
        for name in ("sample", "train_step") * 6000:
            with tracing.span(name):
                pass
        tracing.configure(enabled=False)
        got = tracing.drain()
        assert tracing.drop_count() == 0
        assert [e["name"] for e in got] == ["sample", "train_step"] * 6000
    finally:
        tracing.configure(enabled=False)
        tracing.drain()
        tracing.reset()


# -- phase_census on a made-up window ---------------------------------------

def _span(name, t0_s, t1_s, parent=0):
    ts = (tracing._T0_WALL + (t0_s - tracing._T0_MONO)) * 1e6
    return {"name": name, "ph": "X", "ts": ts, "dur": (t1_s - t0_s) * 1e6,
            "args": {"trace": 1, "span": 0, "parent": parent}}


def _window(clock_us=5e8, kernel_lag_us=3.0):
    """A made-up export whose clock runs ``clock_us`` ahead of
    perf_counter's, with the marker's kernel starting ``kernel_lag_us``
    after its launch call; host spans over 10.000–10.010 s."""
    def call(c, t_s, name="cudaLaunchKernel", cat="cuda_runtime"):
        return {"ph": "X", "cat": cat, "name": name,
                "ts": 1e6 * t_s + clock_us, "dur": 2.0,
                "args": {"correlation": c}}

    def op(c, t_s, dur_us, cat="kernel", name="k"):
        return {"ph": "X", "cat": cat, "name": name,
                "ts": 1e6 * t_s + clock_us, "dur": dur_us,
                "args": {"correlation": c}}

    events = [
        call(1, 10.0), op(1, 10.0 + kernel_lag_us / 1e6, 1.0),  # marker
        call(2, 10.0005), op(2, 10.0020, 50.0, "gpu_memcpy"),   # inputs
        call(3, 10.0012), op(3, 10.0030, 100.0),                # sample
        call(4, 10.0032), op(4, 10.0040, 200.0),                # forward
        call(5, 10.0052), op(5, 10.0060, 300.0),                # backward
        call(6, 10.0072), op(6, 10.0080, 400.0, "gpu_memset"),  # optim.
        call(7, 10.0085), op(7, 10.0090, 25.0),                 # scatter
        call(8, 10.0110), op(8, 10.0120, 25.0),                 # no span
        call(9, 10.0050, "cudaStreamSynchronize"),  # not a launch
        # a library's kernel launched by a cu* call, in the optimizer
        call(10, 10.0075, "cuLaunchKernel", "cuda_driver"),
        op(10, 10.0085, 30.0),
        op(11, 10.0130, 10.0),                      # its call not kept
    ]
    spans = [
        _span("dispatch_inputs", 10.0001, 10.0010),
        _span("sample", 10.0010, 10.0020),
        _span("train_step", 10.0030, 10.0100),
        _span("step_forward", 10.0031, 10.0050, parent=7),
        _span("step_backward", 10.0050, 10.0070, parent=7),
        _span("step_optimizer", 10.0070, 10.0080, parent=7),
    ]
    return events, spans


def test_phase_census_attributes_each_op_to_its_launchs_innermost_span():
    events, spans = _window()
    got = profiling.phase_census(events, spans, mark_s=10.0, steps=2)
    ms = got["device_ms_per_step"]
    assert ms == pytest.approx({
        "dispatch_inputs": 0.025, "sample": 0.05, "step_forward": 0.1,
        "step_backward": 0.15, "step_optimizer": 0.215,
        "train_step": 0.0125, profiling.NO_SPAN: 0.0125,
        profiling.UNMATCHED: 0.005})
    assert got["device_ms_per_step_total"] == pytest.approx(0.57)
    # the calls that launched an op: not the sync, nor the marker's
    assert got["launches_per_step_total"] == pytest.approx(4.0)
    assert got["launches_per_step"]["step_forward"] == pytest.approx(0.5)
    assert got["launches_per_step"]["step_optimizer"] == pytest.approx(1.0)
    # the ops launched under no span, and under train_step's self time
    assert got["device_share"][profiling.NO_SPAN] == pytest.approx(
        25 / 1140)
    assert got["device_share"]["train_step"] == pytest.approx(25 / 1140)
    # the memset and the driver-launched kernel, both named "k"
    assert got["top_ops"][0] == ["k", "step_optimizer", pytest.approx(0.215)]


def test_phase_census_aligns_on_the_markers_launch_call():
    """The kernel's lag behind its launch call is reported, and does not
    move the attribution: the clocks are tied at the call."""
    events, spans = _window(kernel_lag_us=700.0)
    got = profiling.phase_census(events, spans, mark_s=10.0, steps=2)
    assert got["align_us"] == pytest.approx(700.0)
    assert got["device_ms_per_step"]["step_forward"] == pytest.approx(0.1)
    assert got["device_ms_per_step"]["dispatch_inputs"] == pytest.approx(
        0.025)


def test_phase_census_names_each_idle_gap_by_the_span_at_its_middle():
    events, spans = _window()
    got = profiling.phase_census(events, spans, mark_s=10.0, steps=2,
                                 gaps=3)
    labels = [(round(n * 1e6), name) for _, n, name in got["idle_gaps"]]
    # after the scatter's op (mid 10.0105: train_step has closed), before
    # the inputs' copy (mid 10.0010: sample has opened), and between the
    # forward's op and the backward's (mid 10.0051)
    assert labels == [(2975, profiling.NO_SPAN), (1996, "sample"),
                      (1800, "step_backward")]


def test_dispatch_phases_is_a_tool_that_needs_a_card(monkeypatch, capsys):
    """The split tool is one of the gate's tool modules, and without a
    CUDA card it exits 2 before building anything."""
    from distributed_deep_q_tpu_torch import dispatch_phases
    from distributed_deep_q_tpu_torch.analysis.core import (
        TOOL_MODULES, package_files)

    path = os.path.join(REPO, "distributed_deep_q_tpu_torch",
                        "dispatch_phases.py")
    assert "dispatch_phases.py" in TOOL_MODULES
    assert path in package_files(REPO)
    assert path not in package_files(REPO, tools=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert dispatch_phases.main(["--workload", "apex-fused",
                                 "--seed", "1"]) == 2
    assert "no CUDA card" in capsys.readouterr().err
