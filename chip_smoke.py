#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``distributed_deep_q_tpu_torch``).

Run from the repository root on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. device — the card's name, count, ``nvidia-smi`` name and power limit,
   and the TF32 flags;
2. build — compile the hand-written kernels (one ``nvcc`` per source, all
   started together) and print the compiler's register/spill report;
3. ring kernels — an empty kernel's time first (the launch floor every
   kernel row stands beside); then each kernel against its plain PyTorch
   version on the card, bitwise, at the Pong preset's shapes on a
   1,000,005-row × 8192-byte ring (8.19 GB, window starts past the
   2³¹-byte mark): the gather at n = 512 and 4096, the scatter at the
   flush's two shapes (a 62-row chunk filled while acting, and the 4-row
   flush before each dispatch, 124 of whose 128 lanes are padding); then
   timed (device time by CUDA events, host time per call by wall clock)
   beside the bound of the bytes the data needs, the plain version and one
   library call;
3b. loss kernels — the fused TD loss forward (B3) and backward (B4)
   against their plain versions at B = 512 with A = 4 and A = 18, δ in
   {0.5, 1, 2}, a few actions out of range: |td| and dq bitwise, the loss
   within 1e-6 relative; B4 also at every head width it has an instance
   for (2, 4, 6, 18) and one it loops over (5), with and without NaN and
   inf in q, dq compared as int32 bit patterns (NaN rows, −0.0 columns);
   then timed (device and host time per call, B4's host time both through
   its public wrapper and on the autograd route ``FusedDqnLoss`` takes)
   beside their byte bound, the plain versions and the nearest PyTorch
   composition;
4. main path — ``main train --preset pong --backend cuda`` in process on the
   SignalAtari probe at full 84×84 (bf16 Nature CNN, batch 512, 1M ring,
   learn_start 20,000), several hundred grad steps of the fused device-PER
   dispatch;
5. chained dispatch — a ``Solver`` and a filled replay at the same preset,
   ``train_steps_device_per(chain=8)`` timed over a few dozen dispatches
   with the plain loss and with the fused loss kernels, then each traced
   with ``torch.profiler`` over four (the port's kernels' device time per
   launch read from the fused-loss trace, beside an empty kernel's time in
   a profiler window of its own); then the same small fused
   dispatch on the card and on the CPU (whose path the CPU tests hold to
   the JAX reference), compared;
6. host-sampled path — ``main train --preset breakout --backend cuda`` with
   ``replay.device_per=false train.use_pallas_loss=true`` at full width
   (84×84, batch 512, 1M-frame device ring, host sum trees, n-step 3,
   Double DQN, PER α = 0.6): several hundred grad steps through B3/B4;
6b. the same preset with ``replay.device_resident=false`` (frames in a host
   ``FrameStackReplay``, pixel batches shipped per step), learn_start cut
   to 5,000, a hundred grad steps;
7. the ``kernels`` JSON line, the ``nvidia-smi`` line, and the last line
   ``{"ok": true, "device": {...}}``.

Every path run (phases 4, 6, 6b) sets all kernel launch counters to 0 just
before it and reads them just after.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import subprocess
import sys
import time
import traceback

import numpy as np

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
ROWS, ROWB = 1_000_005, 8192       # Pong ring: 1M slots + 4 ghost + scratch
SLOT_CAP, WINDOW = 1_000_000, 5    # stack 4 + n_step 1
ITERS, WARMUP = 64, 5
OUT_DIR = "chip_smoke_out"   # gitignored; the train loop's metrics JSONL
PORT_KERNELS = ("gather_windows", "scatter_rows", "fused_loss_fwd",
                "fused_loss_bwd")


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int = ITERS) -> tuple[float, float]:
    """(device ms, host ms) per call over ``iters`` calls, after
    ``WARMUP`` calls. Device time: CUDA events around the run, queued
    behind a ~30 ms device-side spin so the host has enqueued every launch
    before the first one runs (otherwise a short kernel's events measure
    the host's launch rate). Host time: wall clock per call, the run
    ending in a synchronize."""
    for i in range(WARMUP):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(60_000_000)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    device_ms = start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for i in range(iters):
        fn(i)
    torch.cuda.synchronize()
    return device_ms, 1e3 * (time.perf_counter() - t0) / iters


def max_abs_err(torch, a, b) -> int:
    if torch.equal(a, b):
        return 0
    return int((a.long() - b.long()).abs().max())


def float_err(torch, a, b) -> float:
    """0.0 when two float32 tensors are the same bit patterns, else their
    largest difference (inf where NaN meets a number)."""
    if torch.equal(a.view(torch.int32), b.view(torch.int32)):
        return 0.0
    return float((a - b).abs().nan_to_num(math.inf).max())


# -- phase 3 ------------------------------------------------------------------


def check_gather(torch, rg, ring, dev, n: int) -> dict:
    rowp = ROWB // 4
    gen = torch.Generator(device=dev).manual_seed(n)
    # 8 index sets, cycled while timing, so repeated launches do not find
    # their windows in the 50 MB L2 cache (a fresh draw's windows are cold)
    idx_sets = [torch.randint(0, ROWS - WINDOW + 1, (n,), dtype=torch.int32,
                              device=dev, generator=gen) for _ in range(8)]
    idx = idx_sets[0]
    idx[0] = ROWS - WINDOW                 # the ring's last window
    idx[1] = 2**31 // ROWB + 1             # just past the 2³¹-byte mark
    idx[2] = 0
    high = int((idx.long() * ROWB >= 2**31).sum())
    got = rg.gather_windows(idx, ring, n=n, w=WINDOW, rowb=ROWB)
    want = rg.gather_windows_plain(idx, ring, n=n, w=WINDOW, rowb=ROWB)
    torch.cuda.synchronize()
    err = max_abs_err(torch, got, want)
    del got, want
    ring2d = ring.view(-1, rowp)
    lib_rows = [(i.long()[:, None] + torch.arange(WINDOW, device=dev)
                 ).reshape(-1) for i in idx_sets]
    ms, host_ms = time_ms(torch, lambda i: rg.gather_windows(
        idx_sets[i % 8], ring, n=n, w=WINDOW, rowb=ROWB))
    plain_ms, plain_host_ms = time_ms(
        torch, lambda i: rg.gather_windows_plain(
            idx_sets[i % 8], ring, n=n, w=WINDOW, rowb=ROWB))
    library_ms, library_host_ms = time_ms(
        torch, lambda i: torch.index_select(ring2d, 0, lib_rows[i % 8]))
    nbytes = n * 4 + 2 * n * WINDOW * ROWB
    return {"n": n, "windows_past_2^31_bytes": high, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "host_ms": host_ms, "plain_host_ms": plain_host_ms,
            "library_host_ms": library_host_ms,
            "bytes": nbytes, "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S}


# The Pong flush's two shapes (write_chunk 64 → 128 lanes: 64 main, 64
# ghost; src = arange(64) twice, as ``DevicePERFrameReplay._apply_write``
# builds it). Padding lanes target the scratch row.
SCATTER_SHAPES = {
    # a chunk filled while acting, wrapping to the sub-ring's start: main
    # lanes on rows 0..61, two padding lanes, ghost lanes re-sending rows
    # 0..3 to their mirrors 1,000,000..1,000,003 (past 2³¹ bytes); 66 real
    # lanes, 62 padding
    "fill": (0, 62, True),
    # the flush before each dispatch: the train_every = 4 rows staged since
    # the last one, past the 2³¹-byte mark and clear of the sub-ring's first
    # window - 1 rows (so no ghost lane is real); 4 real lanes, 124 padding
    "flush": (700_000, 4, False),
}


def check_scatter(torch, rg, ring, dev, shape: str, empty_ms: float) -> dict:
    """One flush shape of ``SCATTER_SHAPES``, launched as the main path
    launches it (the scratch row named as ``skip_row``): the kernel against
    its plain version (bitwise outside the scratch row, whose contents are
    unspecified) and the scratch row untouched; then timed beside the plain
    version, ``index_copy_`` and the bound of the bytes this data needs."""
    first, real, ghosts = SCATTER_SHAPES[shape]
    rowp, k = ROWB // 4, 64
    scratch = ROWS - 1
    gen = torch.Generator(device=dev).manual_seed(7)
    staged = torch.randint(-2**31, 2**31 - 1, (k * rowp,), dtype=torch.int32,
                           device=dev, generator=gen)
    main = torch.full((k,), scratch, dtype=torch.int32, device=dev)
    main[:real] = first + torch.arange(real, dtype=torch.int32, device=dev)
    ghost = torch.full((k,), scratch, dtype=torch.int32, device=dev)
    if ghosts:
        ghost[:WINDOW - 1] = SLOT_CAP + torch.arange(
            WINDOW - 1, dtype=torch.int32, device=dev)
    src = torch.arange(k, dtype=torch.int32, device=dev).repeat(2)
    dst = torch.cat([main, ghost])
    n = 2 * k
    plain = ring.clone()
    scratch_row = ring[-rowp:].clone()
    rg.scatter_rows(src, dst, staged, ring, n=n, rowb=ROWB, skip_row=scratch)
    rg.scatter_rows_plain(src, dst, staged, plain, n=n, rowb=ROWB)
    torch.cuda.synchronize()
    err = max_abs_err(torch, ring[:-rowp], plain[:-rowp])
    kept = bool(torch.equal(ring[-rowp:], scratch_row))
    del plain
    torch.cuda.empty_cache()
    ring2d, staged2d = ring.view(-1, rowp), staged.view(-1, rowp)
    rows_src = staged2d[src.long()]
    dst_l = dst.long()
    ms, host_ms = time_ms(torch, lambda i: rg.scatter_rows(
        src, dst, staged, ring, n=n, rowb=ROWB, skip_row=scratch))
    plain_ms, plain_host_ms = time_ms(
        torch, lambda i: rg.scatter_rows_plain(
            src, dst, staged, ring, n=n, rowb=ROWB))
    library_ms, library_host_ms = time_ms(
        torch, lambda i: ring2d.index_copy_(0, dst_l, rows_src))
    # bytes this data needs: the scratch row's contents are unspecified, so
    # a padding lane needs none; each distinct staged row a real lane sends
    # read once, each distinct real target written once, both index
    # vectors read once
    to_ring = dst != scratch
    n_src = int(torch.unique(src[to_ring]).numel())
    n_dst = int(torch.unique(dst[to_ring]).numel())
    nbytes = (n_src + n_dst) * ROWB + 2 * n * 4
    return {"shape": shape, "n": n, "real_lanes": int(to_ring.sum()),
            "distinct_src_rows": n_src, "distinct_dst_rows": n_dst,
            "max_abs_err": err, "scratch_row_kept": kept,
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "empty_kernel_ms": empty_ms, "host_ms": host_ms,
            "plain_host_ms": plain_host_ms,
            "library_host_ms": library_host_ms, "bytes": nbytes,
            "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S}


# -- phase 3b -----------------------------------------------------------------


def loss_inputs(torch, dev, b: int, a: int, seed: int):
    """Q-values [b, a], int32 actions with three out of [0, a), targets,
    weights and the incoming loss gradient, on the card."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, a, device=dev, generator=gen) * 3
    actions = torch.randint(0, a, (b,), dtype=torch.int32, device=dev,
                            generator=gen)
    actions[:3] = torch.tensor([-1, a, a + 5], dtype=torch.int32)
    targets = torch.randn(b, device=dev, generator=gen) * 2
    weights = torch.rand(b, device=dev, generator=gen) * 0.9 + 0.1
    g = torch.tensor(0.37, device=dev)
    return q, actions, targets, weights, g


def with_nonfinite(q, actions):
    """NaN and ±inf in rows 3-8, on and off each row's action: rows 3, 4,
    7 and 8 come out NaN, rows 5 and 6 (inf on the action) clip to ±δ."""
    a = q.shape[1]
    for row, on_action, value in ((3, False, math.nan), (4, False, math.inf),
                                  (5, True, math.inf), (6, True, -math.inf),
                                  (7, True, math.nan), (8, False, -math.inf)):
        col = int(actions[row]) if on_action else (int(actions[row]) + 1) % a
        q[row, col] = value
    return q


# B4's head widths: the presets' (an instance each) and one the loop takes
BWD_WIDTHS = (2, 4, 6, 18, 5)


def check_bwd_widths(torch, fl, dev, b: int = 512) -> list[dict]:
    """B4 against its plain version at every width of ``BWD_WIDTHS``, with
    finite q and with NaN and inf in it, as int32 bit patterns."""
    cases = []
    for a in BWD_WIDTHS:
        for nonfinite in (False, True):
            q, act, t, w, g = loss_inputs(torch, dev, b, a, seed=100 + a)
            if nonfinite:
                q = with_nonfinite(q, act)
            dq = fl.fused_loss_bwd(q, act, t, w, g, 1.0)
            dq_p = fl.fused_loss_bwd_plain(q, act, t, w, g, 1.0)
            torch.cuda.synchronize()
            bits = dq_p.view(torch.int32)
            cases.append({
                "a": a, "nonfinite": nonfinite,
                "max_abs_err": float_err(torch, dq, dq_p),
                "nan_rows": int(torch.isnan(dq_p).all(dim=1).sum()),
                "neg_zeros": int((bits == -2**31).sum())})
    return cases


def autograd_route(torch, fl, q, act, t, w, g):
    """(B4 on the autograd route, the whole ``torch.autograd.grad`` call):
    ``FusedDqnLoss`` on int64 actions, as the learner hands them over; the
    first calls the Function's backward as the engine does."""
    qr = q.clone().requires_grad_(True)
    loss, _ = fl.FusedDqnLoss.apply(qr, act.long(), t, w, 1.0)
    ctx = loss.grad_fn
    return (lambda i: fl.FusedDqnLoss.backward(ctx, g, None),
            lambda i: torch.autograd.grad(loss, [qr], retain_graph=True))


def check_fused_loss(torch, fl, dev) -> dict:
    """B3/B4 against their plain versions (bitwise |td| and dq, loss to
    1e-6 relative) over A in {4, 18} and δ in {0.5, 1, 2}, B4 at every
    width with and without NaN and inf, then timed at δ = 1 for A = 4
    and 18."""
    import torch.nn.functional as F

    b = 512
    out: dict = {"cases": 0, "td_max_abs_err": 0.0, "dq_max_abs_err": 0.0,
                 "loss_max_rel_err": 0.0}
    for a in (4, 18):
        for delta in (0.5, 1.0, 2.0):
            q, act, t, w, g = loss_inputs(torch, dev, b, a, seed=a)
            loss, td = fl.fused_loss_fwd(q, act, t, w, delta)
            dq = fl.fused_loss_bwd(q, act, t, w, g, delta)
            loss_p, td_p = fl.fused_loss_fwd_plain(q, act, t, w, delta)
            dq_p = fl.fused_loss_bwd_plain(q, act, t, w, g, delta)
            torch.cuda.synchronize()
            out["cases"] += 1
            out["td_max_abs_err"] = max(out["td_max_abs_err"],
                                        float_err(torch, td, td_p))
            out["dq_max_abs_err"] = max(out["dq_max_abs_err"],
                                        float_err(torch, dq, dq_p))
            out["loss_max_rel_err"] = max(
                out["loss_max_rel_err"],
                abs(float(loss) - float(loss_p)) / abs(float(loss_p)))
            assert not dq[:3].any(), "out-of-range actions got a gradient"
    out["bwd_widths"] = check_bwd_widths(torch, fl, dev, b)
    out["dq_max_abs_err"] = max([out["dq_max_abs_err"]] + [
        c["max_abs_err"] for c in out["bwd_widths"]])
    for a in (4, 18):
        q, act, t, w, g = loss_inputs(torch, dev, b, a, seed=a)
        # the composition cannot take out-of-range actions: gather faults
        act_in = act.clamp(0, a - 1)
        qr = q.clone().requires_grad_(True)

        def composition(qq):
            q_sa = qq.gather(1, act_in.long()[:, None])[:, 0]
            hub = F.huber_loss(q_sa, t, reduction="none", delta=1.0)
            return (w * hub).mean()

        comp_loss = composition(qr)
        fwd = timed(torch, lambda i: fl.fused_loss_fwd(q, act, t, w, 1.0),
                    lambda i: fl.fused_loss_fwd_plain(q, act, t, w, 1.0))
        fwd["composition_ms"] = time_ms(torch, lambda i: composition(q))[0]
        fwd["bytes"] = 4 * (b * a + 4 * b + 1)
        bwd = timed(torch, lambda i: fl.fused_loss_bwd(q, act, t, w, g, 1.0),
                    lambda i: fl.fused_loss_bwd_plain(q, act, t, w, g, 1.0))
        backward, grad = autograd_route(torch, fl, q, act, t, w, g)
        bwd["autograd_host_ms"] = time_ms(torch, backward)[1]
        bwd["autograd_grad_host_ms"] = time_ms(torch, grad)[1]
        bwd["composition_ms"] = time_ms(torch, lambda i: torch.autograd.grad(
            comp_loss, [qr], retain_graph=True))[0]
        bwd["bytes"] = 4 * (2 * b * a + 3 * b + 1)
        for k in (fwd, bwd):
            k["bound_ms"] = 1e3 * k["bytes"] / HBM_BYTES_PER_S
        out[f"a{a}"] = {"fwd": fwd, "bwd": bwd}
    return out


def timed(torch, kernel, plain) -> dict:
    """Device and host ms per call of a kernel's wrapper and of its plain
    version."""
    ms, host_ms = time_ms(torch, kernel)
    plain_ms, plain_host_ms = time_ms(torch, plain)
    return {"ms": ms, "host_ms": host_ms, "plain_ms": plain_ms,
            "plain_host_ms": plain_host_ms}


# -- phases 4, 5 and 6 -------------------------------------------------------


def run_cli(main, counters, argv: list[str], jsonl: str):
    """``main(argv)`` in process, with every kernel launch counter set to 0
    just before and read just after. Returns (summary, launches, the last
    metrics record)."""
    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, jsonl)
    argv = argv[:1] + ["--metrics-jsonl", path] + argv[1:]
    for fn in counters.values():
        fn.launches = 0
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    summary = json.loads(out.getvalue().strip().splitlines()[-1])
    assert rc == 0, f"main returned {rc}"
    summary["wall_s"] = wall
    with open(path) as f:
        last_record = json.loads(f.read().strip().splitlines()[-1])
    return summary, launches, last_record


def random_policy_return(make_env, env_cfg, episodes: int,
                         seed: int = 10_000) -> float:
    """The uniform-random policy's mean return on the eval env and seed
    (actions drawn independently of the env's own generator)."""
    env = make_env(env_cfg, seed=seed)
    rng = np.random.default_rng(seed + 1)
    returns = []
    for _ in range(episodes):
        env.reset()
        total, over = 0.0, False
        while not over:
            _, r, _, over = env.step(int(rng.integers(env.num_actions)))
            total += r
        returns.append(total)
    return float(np.mean(returns))


def fill_replay(replay, rows: int, seed: int = 0) -> None:
    rng = np.random.default_rng(seed)
    for start in range(0, rows, 1000):
        n = min(1000, rows - start)
        done = (np.arange(start, start + n) % 32) == 31
        replay.add_batch({
            "frame": rng.integers(0, 256, (n, 84, 84), dtype=np.uint8),
            "action": rng.integers(0, 4, n).astype(np.int32),
            "reward": (rng.random(n) < 0.25).astype(np.float32),
            "done": done})
    replay.flush()


def time_chain(torch, solver, replay, chain: int, dispatches: int):
    """(ms per grad step, last chunk's losses) over ``dispatches`` chained
    dispatches, after two of warm-up; host clock, ending in a
    synchronize."""
    for _ in range(2):
        solver.train_steps_device_per(replay, chain=chain)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(dispatches):
        m = solver.train_steps_device_per(replay, chain=chain)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    loss = m["loss"].float().cpu().numpy()
    assert np.isfinite(loss).all() and loss.shape == (chain,), loss
    return 1e3 * dt / (chain * dispatches), loss


def run_chained(torch, config, Solver, DevicePERFrameReplay) -> dict:
    """The chain=8 dispatch with the plain loss and with the fused loss
    kernels (``use_pallas_loss``), two solvers on one replay, timed in
    turns: plain, fused, fused, plain; each traced, beside an empty
    kernel in a trace of its own."""
    def solver_for(pallas: bool):
        cfg = config.pong_config()
        cfg.mesh.backend = "cuda"
        cfg.env.kind, cfg.env.id = "signal_atari", "signal"
        cfg.net.num_actions = 4
        cfg.train.use_pallas_loss = pallas
        return Solver(cfg)

    plain, fused = solver_for(False), solver_for(True)
    cfg = plain.config
    replay = DevicePERFrameReplay(cfg.replay, plain.device, (84, 84),
                                  cfg.env.stack, cfg.train.gamma,
                                  write_chunk=cfg.replay.write_chunk)
    fill_replay(replay, 30_000)
    chain, dispatches = 8, 24
    torch.cuda.reset_peak_memory_stats()
    times: dict[str, list[float]] = {"plain_loss": [], "fused_loss": []}
    for name, solver in (("plain_loss", plain), ("fused_loss", fused),
                         ("fused_loss", fused), ("plain_loss", plain)):
        ms, loss = time_chain(torch, solver, replay, chain, dispatches)
        times[name].append(ms)
    out = {"chain": chain, "dispatches": dispatches,
           "ms_per_grad_step": times["plain_loss"],
           "fused_loss_ms_per_grad_step": times["fused_loss"],
           "max_memory_allocated_GB": torch.cuda.max_memory_allocated() / 1e9,
           "last_loss": float(loss[-1])}
    out["trace"] = trace_dispatches(torch, plain, replay, chain, 4)
    out["fused_loss_trace"] = trace_dispatches(torch, fused, replay, chain, 4)
    out["empty_kernel_trace_us"] = trace_empty_kernel(torch)
    return out


def trace_empty_kernel(torch, launches: int = 64) -> float:
    """An empty kernel's (``torch.cuda._sleep(0)``) device time per launch
    in a ``torch.profiler`` window of its own: the floor of the phase-5
    "in trace" times, which, unlike the back-to-back floor, hold no gap
    between launches."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(launches):
            torch.cuda._sleep(0)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    # ATen's spin_kernel, if the trace holds anything else
    kernels = [e for e in kernels if "spin" in e.key] or kernels
    count = sum(e.count for e in kernels)
    assert count > 0, "the profiler saw no empty kernel"
    return sum(e.self_device_time_total for e in kernels) / count


def trace_dispatches(torch, solver, replay, chain: int, dispatches: int):
    """Where a chained grad step's time goes: a ``torch.profiler`` window
    over ``dispatches`` dispatches. Device-busy share = the kernels' summed
    device time over the window's wall time (one stream, so kernels do not
    overlap); the top kernels by device time, in ms per grad step."""
    from torch.profiler import ProfilerActivity, profile

    steps = chain * dispatches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(dispatches):
            solver.train_steps_device_per(replay, chain=chain)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    # the port's own kernels, by the name of their __global__ function
    ours = {}
    for name in PORT_KERNELS:
        hits = [e for e in kernels if f"{name}_kernel" in e.key]
        count = sum(e.count for e in hits)
        if count:
            ours[name] = {"launches": count, "us_per_launch": sum(
                e.self_device_time_total for e in hits) / count}
    return {"wall_ms_per_grad_step": wall_ms / steps,
            "device_ms_per_grad_step": device_ms / steps,
            "device_busy_share": device_ms / wall_ms,
            "kernel_launches_per_grad_step":
                sum(e.count for e in kernels) / steps,
            "top_kernels_ms_per_grad_step": [
                [e.key[:60], e.self_device_time_total / 1e3 / steps]
                for e in top],
            "port_kernels": ours}


def cross_device_check(torch, config, Solver, DevicePERFrameReplay) -> dict:
    """The same small fused dispatch (float32, 52×52, batch 16, chain 3)
    from the same weights and data on the card and on the CPU. Ring bytes
    (but the scratch row) and priorities must agree bitwise (the sampling
    uniforms are drawn on the host); loss to 1e-4 relative and θ to 2·lr
    (different convolution algorithms, TF32 off)."""
    def build(backend):
        cfg = config.Config()
        cfg.mesh.backend = backend
        cfg.net = config.NetConfig(kind="nature_cnn", num_actions=4,
                                   frame_shape=(52, 52))
        cfg.replay = config.ReplayConfig(
            capacity=512, batch_size=16, n_step=2, prioritized=True,
            priority_alpha=0.0, device_per=True, write_chunk=16)
        cfg.train = config.TrainConfig(lr=1e-4, double_dqn=True,
                                       target_update_period=2)
        s = Solver(cfg)
        r = DevicePERFrameReplay(cfg.replay, s.device, (52, 52), 4, 0.99,
                                 write_chunk=16)
        rng = np.random.default_rng(3)
        for i in range(600):
            r.add(rng.integers(0, 256, (52, 52), dtype=np.uint8),
                  int(rng.integers(4)), float(rng.standard_normal()),
                  i % 11 == 10)
        m = s.train_steps_device_per(r, chain=3)
        return s, r, m

    (sg, rg_, mg), (sc, rc, mc) = build("cuda"), build("cpu")
    rowp = rc.rowp   # the scratch row (the last) takes racing padding lanes
    assert torch.equal(rg_.dstate["frames"][:-rowp].cpu(),
                       rc.dstate["frames"][:-rowp])
    assert torch.equal(rg_.dstate["prio"].cpu(), rc.dstate["prio"])
    lg, lc = mg["loss"].cpu().numpy(), mc["loss"].numpy()
    np.testing.assert_allclose(lg, lc, rtol=1e-4)
    dtheta = max(float((a.detach().cpu() - b.detach()).abs().max())
                 for a, b in zip(sg.state.net.parameters(),
                                 sc.state.net.parameters()))
    assert dtheta <= 2e-4, dtheta
    return {"loss_cuda": lg.tolist(), "loss_cpu": lc.tolist(),
            "max_abs_dtheta": dtheta}


PONG_ARGV = ["train", "--preset", "pong", "--backend", "cuda",
             "--log-every", "100", "--set", "env.kind=signal_atari",
             "env.id=signal", "train.total_steps=22000"]
# the Breakout preset at full width; depth cut to 1,600 env steps (400 grad
# steps) past learn_start 20,000
BREAKOUT_ARGV = ["train", "--preset", "breakout", "--backend", "cuda",
                 "--log-every", "100", "--set", "env.kind=signal_atari",
                 "env.id=signal", "train.use_pallas_loss=true",
                 "train.total_steps=21600"]


def check_path(summary: dict, grad_steps: int) -> None:
    for key in ("loss", "q_mean", "grad_steps_per_s", "env_steps_per_s",
                "eval_return"):
        assert math.isfinite(summary[key]), f"{key} = {summary.get(key)}"
    assert summary["grad_steps"] == grad_steps, summary["grad_steps"]


def main() -> int:
    import torch

    # -- 1. device ------------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    try:
        from distributed_deep_q_tpu_torch import config
        from distributed_deep_q_tpu_torch.actors.game import make_env
        from distributed_deep_q_tpu_torch.main import main as cli_main
        from distributed_deep_q_tpu_torch.ops import cuda_build
        from distributed_deep_q_tpu_torch.ops import fused_loss as fl
        from distributed_deep_q_tpu_torch.ops import ring_gather as rg
        from distributed_deep_q_tpu_torch.replay.device_per import (
            DevicePERFrameReplay)
        from distributed_deep_q_tpu_torch.solver import Solver
    except ImportError as e:
        print(f"chip_smoke: the port package is missing ({e}); run from "
              "the repository root", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi_line()
    log(f"[1] device: {kind} count={count} nvidia-smi: {smi}")
    log(f"[1] torch {torch.__version__} cuda {torch.version.cuda}; TF32 "
        f"flags at start: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32} (the port's Solver sets "
        "both False on the card)")
    counters = {"gather_windows": rg.gather_windows,
                "scatter_rows": rg.scatter_rows,
                "fused_loss_fwd": fl.fused_loss_fwd,
                "fused_loss_bwd": fl.fused_loss_bwd}

    # -- 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    built = cuda_build.build_all()
    log(f"[2] build: {built} (wall {time.perf_counter() - t0:.2f} s)")
    for name, text in cuda_build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"[2] {name}: {line.strip()}")

    # -- 3. ring kernels at main-path shapes -----------------------------------
    # the launch floor every kernel row stands beside: an empty kernel,
    # queued back to back as the kernels are
    empty_ms = time_ms(torch, lambda i: torch.cuda._sleep(0))[0]
    log(f"[3] empty kernel: {empty_ms} ms")
    gen = torch.Generator(device=dev).manual_seed(0)
    ring = torch.randint(-2**31, 2**31 - 1, (ROWS * ROWB // 4,),
                         dtype=torch.int32, device=dev, generator=gen)
    log(f"[3] ring: {ROWS} rows x {ROWB} B = {ring.numel() * 4 / 1e9:.2f} GB")
    gathers = [check_gather(torch, rg, ring, dev, n) for n in (512, 4096)]
    for g in gathers:
        log(f"[3] gather_windows {json.dumps(g)}")
        assert g["max_abs_err"] == 0, "gather_windows disagrees with plain"
        assert g["windows_past_2^31_bytes"] > 0
    scatters = {shape: check_scatter(torch, rg, ring, dev, shape, empty_ms)
                for shape in SCATTER_SHAPES}
    for s in scatters.values():
        log(f"[3] scatter_rows {json.dumps(s)}")
        assert s["max_abs_err"] == 0, "scatter_rows disagrees with plain"
        assert s["scratch_row_kept"], "scatter_rows wrote the scratch row"
    del ring
    torch.cuda.empty_cache()

    # -- 3b. loss kernels ----------------------------------------------------
    loss_k = check_fused_loss(torch, fl, dev)
    loss_k["empty_kernel_ms"] = empty_ms
    log(f"[3b] fused loss: {json.dumps(loss_k)}")
    assert loss_k["td_max_abs_err"] == 0, "B3 |td| disagrees with plain"
    assert loss_k["dq_max_abs_err"] == 0, "B4 dq disagrees with plain"
    assert loss_k["loss_max_rel_err"] <= 1e-6, "B3 loss disagrees with plain"
    assert all(c["nan_rows"] == 4 for c in loss_k["bwd_widths"]
               if c["nonfinite"]), "the NaN case lost its NaN rows"
    assert all(c["neg_zeros"] > 0 for c in loss_k["bwd_widths"]), \
        "no -0.0 column was checked"

    # -- 4. Pong main path through the CLI -------------------------------------
    summary, launches, record = run_cli(cli_main, counters, PONG_ARGV,
                                        "chip_smoke_train.jsonl")
    log(f"[4] main path summary: {json.dumps(summary)}")
    log(f"[4] last metrics record (100 grad steps): {json.dumps(record)}")
    log(f"[4] main path launches: {json.dumps(launches)}; TF32 flags now: "
        f"matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    check_path(summary, 501)
    assert launches["gather_windows"] >= summary["grad_steps"], launches
    assert launches["scatter_rows"] > 0, launches
    torch.cuda.empty_cache()

    # -- 5. chained dispatch, then card vs CPU on a small input ---------------
    chained = run_chained(torch, config, Solver, DevicePERFrameReplay)
    log(f"[5] chained dispatch: {json.dumps(chained)}")
    torch.cuda.empty_cache()
    cross = cross_device_check(torch, config, Solver, DevicePERFrameReplay)
    log(f"[5] card vs CPU fused dispatch: {json.dumps(cross)}")
    torch.cuda.empty_cache()

    # -- 6. Breakout host-sampled path through the CLI ------------------------
    b_summary, b_launches, b_record = run_cli(
        cli_main, counters, BREAKOUT_ARGV + ["replay.device_per=false"],
        "chip_smoke_breakout.jsonl")
    cfg = config.breakout_config()
    cfg.env.kind, cfg.env.id = "signal_atari", "signal"
    random_ret = random_policy_return(make_env, cfg.env,
                                      cfg.train.eval_episodes)
    log(f"[6] breakout host-sampled summary: {json.dumps(b_summary)}")
    log(f"[6] last metrics record (100 grad steps): {json.dumps(b_record)}")
    log(f"[6] launches: {json.dumps(b_launches)}; random policy's "
        f"eval_return {random_ret}")
    log("[6] loop phases, ms per grad step: " + json.dumps(
        {k: b_record.get(k) for k in ("time_sample_ms", "time_dispatch_ms",
                                      "time_writeback_ms", "time_step_ms",
                                      "time_device_ms")}))
    check_path(b_summary, 401)
    for name in ("fused_loss_fwd", "fused_loss_bwd"):
        assert b_launches[name] >= b_summary["grad_steps"], b_launches
    assert b_summary["eval_return"] > random_ret, (b_summary, random_ret)
    torch.cuda.empty_cache()

    # -- 6b. Breakout with frames in a host FrameStackReplay --------------------
    h_summary, h_launches, h_record = run_cli(
        cli_main, counters,
        BREAKOUT_ARGV[:-1] + ["train.total_steps=5400",
                              "replay.learn_start=5000",
                              "replay.device_resident=false"],
        "chip_smoke_breakout_host.jsonl")
    log(f"[6b] breakout host FrameStackReplay summary: "
        f"{json.dumps(h_summary)}")
    log(f"[6b] last metrics record (100 grad steps): {json.dumps(h_record)}")
    log(f"[6b] launches: {json.dumps(h_launches)}")
    check_path(h_summary, 101)
    for name in ("fused_loss_fwd", "fused_loss_bwd"):
        assert h_launches[name] >= h_summary["grad_steps"], h_launches

    # -- 7. result lines ------------------------------------------------------
    src = "distributed_deep_q_tpu_torch/csrc/ring_gather.cu"
    loss_src = "distributed_deep_q_tpu_torch/csrc/fused_loss.cu"
    g512, g4096 = gathers
    kernels = [
        {"name": "gather_windows", "route": "cuda", "source": src,
         "replaces": "distributed_deep_q_tpu/ops/ring_gather.py:133",
         "launches": launches["gather_windows"],
         "max_abs_err": g512["max_abs_err"], "ms": g512["ms"],
         "plain_ms": g512["plain_ms"], "bound_ms": g512["bound_ms"],
         "bound_by": "bytes", "library_ms": g512["library_ms"],
         "empty_kernel_ms": empty_ms, "host_ms": g512["host_ms"],
         "ok": g512["max_abs_err"] == 0 and g4096["max_abs_err"] == 0,
         "shape": "n=512 w=5 rowb=8192", "path": "phase 4 (pong)",
         "chain8": {k: g4096[k] for k in ("ms", "plain_ms", "bound_ms",
                                          "library_ms", "max_abs_err",
                                          "host_ms")}},
    ]
    # B2's row: the pre-dispatch flush, the shape of most of its launches;
    # the fill chunk beside it
    flush, fill = scatters["flush"], scatters["fill"]
    kernels.append(
        {"name": "scatter_rows", "route": "cuda", "source": src,
         "replaces": "distributed_deep_q_tpu/ops/ring_gather.py:165",
         "launches": launches["scatter_rows"],
         "max_abs_err": max(flush["max_abs_err"], fill["max_abs_err"]),
         "ms": flush["ms"], "plain_ms": flush["plain_ms"],
         "bound_ms": flush["bound_ms"], "bound_by": "bytes",
         "library_ms": flush["library_ms"], "empty_kernel_ms": empty_ms,
         "host_ms": flush["host_ms"],
         "ok": flush["max_abs_err"] == 0 and fill["max_abs_err"] == 0,
         "shape": "n=128 lanes, 4 real (pre-dispatch flush), rowb=8192",
         "path": "phase 4 (pong)",
         "fill": {k: fill[k] for k in ("real_lanes", "ms", "plain_ms",
                                       "bound_ms", "library_ms",
                                       "max_abs_err", "host_ms")}})
    in_trace = chained["fused_loss_trace"]["port_kernels"]
    for name, line, part, err in (
            ("fused_loss_fwd", 100, "fwd", loss_k["td_max_abs_err"]),
            ("fused_loss_bwd", 130, "bwd", loss_k["dq_max_abs_err"])):
        k4, k18 = loss_k["a4"][part], loss_k["a18"][part]
        kernels.append(
            {"name": name, "route": "cuda", "source": loss_src,
             "replaces": f"distributed_deep_q_tpu/ops/pallas_kernels.py:{line}",
             "launches": b_launches[name], "max_abs_err": err,
             "ms": k4["ms"], "plain_ms": k4["plain_ms"],
             "bound_ms": k4["bound_ms"], "bound_by": "bytes",
             "library_ms": None, "composition_ms": k4["composition_ms"],
             "empty_kernel_ms": empty_ms, "host_ms": k4["host_ms"],
             "phase5_trace_us_per_launch":
                 in_trace.get(name, {}).get("us_per_launch"),
             "phase5_trace_empty_kernel_us":
                 chained["empty_kernel_trace_us"],
             "loss_max_rel_err": loss_k["loss_max_rel_err"],
             "ok": err == 0, "shape": "B=512 A=4 delta=1",
             "path": "phase 6 (breakout, host-sampled)",
             "a18": {k: k18[k] for k in ("ms", "plain_ms", "bound_ms",
                                         "composition_ms", "host_ms")}})
    bwd_row = kernels[-1]
    bwd_row.update({k: loss_k["a4"]["bwd"][k] for k in (
        "autograd_host_ms", "autograd_grad_host_ms")})
    bwd_row["a18"].update({k: loss_k["a18"]["bwd"][k] for k in (
        "autograd_host_ms", "autograd_grad_host_ms")})
    bwd_row["widths_checked"] = sorted({c["a"] for c in loss_k["bwd_widths"]})
    log(json.dumps({"kernels": kernels}))
    log(nvidia_smi_line())
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        code = 1
    sys.exit(code)
