"""Tracing / profiling of the training loop (port of the reference
``profiling.py``).

- ``StepTimer`` — host wall time per train-loop phase (``sample``,
  ``dispatch``, ``writeback``, ``device``), emitted as ``time_<phase>_ms``
  plus per-phase p50/p99.
- ``TraceWindow`` — a ``torch.profiler`` trace over a step window (the
  reference captures a ``jax.profiler`` trace), written as a
  TensorBoard-loadable trace directory; enabled by ``train.profile_dir``.
  The reference's live profiler server (``train.profile_port``) has no
  torch counterpart and stays refused.
- ``MFUMeter`` — live model-FLOPs utilization from grad-step rates, with
  ``fused_train_flops`` (FLOPs per fused grad step, counted by
  ``torch.utils.flop_counter``) over ``peak_flops_for`` (the card's
  spec-sheet peak).
- ``launch_census`` — kernel launches, device time and busy share per
  step from a ``torch.profiler`` window: the port's counterpart of the
  reference's compiled-HLO op census.
"""

from __future__ import annotations

import contextlib
import copy
import time
from collections import defaultdict
from typing import Callable, Iterator

import torch

from distributed_deep_q_tpu_torch.metrics import Histogram

# the port's hand-written kernels, by the name of their __global__ function
# (``csrc/*.cu``: ``<name>_kernel``)
PORT_KERNELS = ("gather_windows", "scatter_rows", "fused_loss_fwd",
                "fused_loss_bwd")


class StepTimer:
    """Accumulates per-phase wall time across train-loop steps.

    ``summary()`` returns mean milliseconds per phase since the last call
    (keys ``time_<phase>_ms``) plus ``time_step_ms`` (mean wall time per
    step, measured step_done→step_done), and p50/p99 per phase.
    """

    def __init__(self) -> None:
        self._acc: dict[str, float] = defaultdict(float)
        self._hists: dict[str, Histogram] = {}
        self._steps = 0
        self._last_step_t: float | None = None
        self._step_total = 0.0

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self._acc[name] += dt
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram()
            h.observe(1e3 * dt)

    def measure_device(self, output: torch.Tensor) -> None:
        """Wait for the device work behind ``output`` and attribute the
        wait to the ``device`` phase. Call on logging steps only — this
        synchronizes the stream."""
        with self.phase("device"):
            if output.is_cuda:
                torch.cuda.synchronize(output.device)

    def step_done(self) -> None:
        now = time.perf_counter()
        if self._last_step_t is not None:
            self._step_total += now - self._last_step_t
        self._last_step_t = now
        self._steps += 1

    def summary(self, reset: bool = True) -> dict[str, float]:
        n = max(self._steps, 1)
        out = {f"time_{k}_ms": 1e3 * v / n for k, v in self._acc.items()}
        # device is measured once per summary window, not per step
        if "time_device_ms" in out:
            out["time_device_ms"] = 1e3 * self._acc["device"]
        if self._steps > 1:
            out["time_step_ms"] = 1e3 * self._step_total / (self._steps - 1)
        for name, h in self._hists.items():
            if h.count:
                out[f"time_{name}_p50_ms"] = h.percentile(0.50)
                out[f"time_{name}_p99_ms"] = h.percentile(0.99)
        if reset:
            self._acc.clear()
            self._hists.clear()
            self._steps = 0
            self._step_total = 0.0
            self._last_step_t = None
        return out


# -- FLOPs and the card's peak (live MFU) -----------------------------------

# dense bf16 tensor-core peak FLOP/s by ``torch.cuda.get_device_name()``
# (NVIDIA's H100 data sheet, without sparsity, at the full power limit)
PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989.4e12,   # SXM
    "NVIDIA H100 NVL": 835.5e12,
    "NVIDIA H100 PCIe": 756.5e12,
}


def peak_flops_for(device: torch.device | str | None = None) -> float | None:
    """Spec-sheet dense bf16 peak of ``device`` (default: CUDA device 0
    when there is one). None on the CPU or on a card the table does not
    know: MFU is then absent rather than invented."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", 0)
    device = torch.device(device)
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    for prefix, peak in sorted(PEAK_FLOPS.items(), key=lambda kv: -len(kv[0])):
        if name.startswith(prefix):
            return peak
    return None


def fused_train_flops(solver, replay, chain: int = 1) -> float | None:
    """FLOPs per grad step of the fused device-PER dispatch
    (``Learner.train_steps_device_per``), counted by
    ``torch.utils.flop_counter.FlopCounterMode`` over one ``chain=1``
    dispatch, forward and backward: the convolutions and matmuls of the
    Q forwards (θ on s, θ⁻ on s', and θ on s' with Double DQN) and of the
    backward through θ. Elementwise work, the sample stage, the loss kernels and
    Adam are not counted (neither does an MFU numerator count them).

    The dispatch runs on a copy of the train state, a copy of the
    priority row and fixed β/uniforms, so the solver's state, its key
    schedule and the replay's β anneal are untouched. ``chain`` is
    accepted for the reference's signature: a chained dispatch repeats the
    same step, so the per-step count does not depend on it."""
    from torch.utils.flop_counter import FlopCounterMode

    del chain
    spec = (replay.slot_cap, replay.slot_pad, replay.rowb, replay._row_len,
            replay.stack, replay.n_step, replay.gamma,
            tuple(replay.frame_shape),
            solver.config.replay.batch_size // replay.num_shards,
            float(solver.config.replay.priority_alpha),
            float(solver.config.replay.priority_eps), replay.num_shards)
    dev = solver.device
    state = copy.deepcopy(solver.state)
    rows = dict(replay.dstate)
    rows["prio"] = rows["prio"].clone()
    rows["maxp"] = rows["maxp"].clone()
    cursors, sizes = (torch.from_numpy(a).to(dev)
                      for a in replay.device_inputs())
    betas = torch.full((1,), 0.5, dtype=torch.float32, device=dev)
    u = torch.rand((replay.num_shards, 1, spec[8]),
                   generator=torch.Generator().manual_seed(0))
    counter = FlopCounterMode(display=False)
    with counter:
        solver.learner.train_steps_device_per(
            state, rows, cursors, sizes, betas, u.to(dev), spec)
    flops = float(counter.get_total_flops())
    return flops if flops > 0 else None


class MFUMeter:
    """Live model-FLOPs-utilization gauge (copy of the reference's).

    The learner calls ``update(gstep)`` on its logging cadence; the meter
    converts the grad-step delta over the wall-clock window into steps/s
    and emits ``train/steps_per_s`` + ``train/mfu`` (and, fed the flow
    plane's rates, ``train/ingest_utilization`` — the fraction of ingested
    rows the learner actually consumes). ``peak_flops`` is None on devices
    with no published peak (the CPU): MFU is then absent from the gauges
    rather than a made-up number.
    """

    def __init__(self, flops_per_step: float | None,
                 peak_flops: float | None):
        self.flops_per_step = (float(flops_per_step)
                               if flops_per_step else None)
        self.peak_flops = float(peak_flops) if peak_flops else None
        self._last_t: float | None = None
        self._last_step = 0

    def update(self, gstep: int, t: float | None = None,
               ingest_rate: float | None = None,
               consume_rate: float | None = None) -> dict[str, float]:
        """One window: gauges for the steps/s since the previous call
        (empty on the first call — no window yet)."""
        if t is None:
            t = time.monotonic()
        if self._last_t is None:
            self._last_t, self._last_step = t, int(gstep)
            return {}
        dt = max(t - self._last_t, 1e-9)
        rate = max(int(gstep) - self._last_step, 0) / dt
        self._last_t, self._last_step = t, int(gstep)
        out = {"train/steps_per_s": round(rate, 3)}
        if self.flops_per_step and self.peak_flops:
            out["train/mfu"] = round(
                self.flops_per_step * rate / self.peak_flops, 4)
        if ingest_rate is not None and consume_rate is not None:
            util = (min(consume_rate / ingest_rate, 1.0)
                    if ingest_rate > 1e-9 else 0.0)
            out["train/ingest_utilization"] = round(util, 4)
        return out


# -- torch.profiler windows ---------------------------------------------------


def _activities() -> list:
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


def _census(events, wall_ms: float, steps: int, top_n: int = 8) -> dict:
    """Per-step kernel census of a finished profile's ``key_averages()``.
    Device-busy share = the kernels' summed device time over the window's
    wall time (one stream, so kernels do not overlap); the top kernels by
    device time, in ms per step; the port's own kernels' launches and
    device time per launch."""
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:top_n]
    ours = {}
    for name in PORT_KERNELS:
        hits = [e for e in kernels if f"{name}_kernel" in e.key]
        count = sum(e.count for e in hits)
        if count:
            ours[name] = {"launches": count, "us_per_launch": sum(
                e.self_device_time_total for e in hits) / count}
    steps = max(int(steps), 1)
    return {"wall_ms_per_grad_step": wall_ms / steps,
            "device_ms_per_grad_step": device_ms / steps,
            "device_busy_share": device_ms / max(wall_ms, 1e-9),
            "kernel_launches_per_grad_step":
                sum(e.count for e in kernels) / steps,
            "top_kernels_ms_per_grad_step": [
                [e.key[:60], e.self_device_time_total / 1e3 / steps]
                for e in top],
            "port_kernels": ours}


def _synchronize() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def launch_census(fn: Callable[[], object], steps: int, calls: int = 1,
                  top_n: int = 8) -> dict:
    """Kernel launches per step from a ``torch.profiler`` window over
    ``calls`` calls of ``fn`` that make ``steps`` grad steps: launches and
    device ms per grad step, the device-busy share, the top kernels and
    the port's own (``PORT_KERNELS``). The port's counterpart of the
    reference's ``compiled_op_census``: what a step costs on the card is
    its launches, not an XLA op count. On the CPU the census holds no
    kernels."""
    from torch.profiler import profile

    _synchronize()
    with profile(activities=_activities()) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        _synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    return _census(prof.key_averages(), wall_ms, steps, top_n)


class TraceWindow:
    """Capture a ``torch.profiler`` trace over a contiguous step window.

    ``on_step(step)`` is called once per train-loop step; the trace starts
    when ``step >= start_step`` and stops after ``num_steps`` more steps
    (or at ``stop()``/``close()``). Output is a TensorBoard-loadable trace
    directory at ``logdir`` (``torch.profiler.tensorboard_trace_handler``).
    ``census(steps)`` is ``launch_census``'s count over the same window.
    An empty ``logdir`` turns the window off."""

    def __init__(self, logdir: str, start_step: int = 100,
                 num_steps: int = 20):
        self.logdir = logdir
        self.start_step = int(start_step)
        self.num_steps = int(num_steps)
        self._prof = None
        self._active = False
        self._done = False
        self._stop_at = 0
        self._t0 = 0.0
        self.wall_ms = 0.0

    def on_step(self, step: int) -> None:
        if self._done or not self.logdir:
            return
        if not self._active and step >= self.start_step:
            from torch.profiler import profile, tensorboard_trace_handler

            _synchronize()
            self._prof = profile(
                activities=_activities(),
                on_trace_ready=tensorboard_trace_handler(self.logdir))
            self._prof.start()
            self._t0 = time.perf_counter()
            self._active = True
            self._stop_at = step + self.num_steps
        elif self._active and step >= self._stop_at:
            self.stop()

    def stop(self) -> None:
        if self._active:
            _synchronize()
            self.wall_ms = 1e3 * (time.perf_counter() - self._t0)
            self._prof.stop()      # writes the trace directory
            self._active = False
            self._done = True

    close = stop

    def census(self, steps: int, top_n: int = 8) -> dict:
        """``launch_census``'s per-step count over this (finished)
        window, ``steps`` grad steps long."""
        if not self._done:
            raise RuntimeError("the trace window has not run to its end")
        return _census(self._prof.key_averages(), self.wall_ms, steps, top_n)


def check_profile_port(port: int) -> None:
    """The reference's live profiler server (``jax.profiler.start_server``)
    has no torch counterpart: a nonzero ``train.profile_port`` is
    refused by name."""
    if port:
        raise NotImplementedError(
            "train.profile_port: torch has no counterpart of "
            "jax.profiler's live profiler server (ROADMAP A9)")

