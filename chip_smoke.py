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
3c. ring kernels at the r2d2 preset's sequence shapes — on a ring of its
   geometry (12,501 slots × 84 rows × 8192 B = 8.6 GB, slots past the
   2³¹-byte mark), bitwise against the plain versions: the gather at
   n = 64 and 512 windows of 84 rows, the scatter at 4 lanes of one
   688,128-byte slot each with 1 and with 4 real (the scratch slot named
   as ``skip_row`` and untouched); then timed beside the plain version,
   ``index_select``/``index_copy_`` and the byte bound;
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
7. the r2d2 preset — ``main train --preset r2d2 --backend cuda`` on the
   SignalAtari probe at full width (bf16 Nature torso at 84×84, LSTM 512,
   dueling, batch 64 × 80 steps with 40 of burn-in, an 8.6 GB sequence
   ring, host sum trees): 201 grad steps of the ring step (one B1 launch
   each), B2 flushing the sequences; eval_return printed beside the random
   policy's (SignalAtari's 32-step episodes end inside the 40-step burn-in,
   so the train windows are all masked and the loss is 0);
7b. the same preset with ``replay.device_per=true``: the chained fused
   path (chain 8, one B1 launch per dispatch), learn_start cut, 100 grad
   steps;
7c. the ring step at full width on a ring filled with random sequences
   (most of them full length, so the loss is not 0), timed and traced with
   ``torch.profiler`` (ms per grad step, device busy share, launches per
   grad step, the top five kernels); then one small ring step on the card
   and on the CPU from the same weights and batch, compared;
8. the ``kernels`` JSON line, the ``nvidia-smi`` line, and the last line
   ``{"ok": true, "device": {...}}``.

Every path run (phases 4, 6, 6b, 7, 7b) sets all kernel launch counters to
0 just before it and reads them just after.
"""

from __future__ import annotations

import contextlib
import gc
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


# -- phase 3c -----------------------------------------------------------------

# The r2d2 preset's sequence ring: 1M transitions / 80 = 12,500 sequence
# slots + 1 scratch slot, each W = 3 + 81 = 84 frame rows of 8192 B
SEQ_SLOTS, SEQ_W = 12_501, 84
SEQ_ROWB = SEQ_W * ROWB               # one sequence slot: 688,128 B
SEQ_SCRATCH = SEQ_SLOTS - 1


def check_seq_gather(torch, rg, ring, dev, n: int) -> dict:
    """B1 on the sequence ring at ``n`` windows of 84 rows, window starts
    at sequence slots (most past the 2³¹-byte mark): bitwise against the
    plain version, then timed beside the plain version, ``index_select``
    over the slots and the byte bound."""
    gen = torch.Generator(device=dev).manual_seed(100 + n)
    slot_sets = [torch.randint(0, SEQ_SCRATCH, (n,), dtype=torch.int32,
                               device=dev, generator=gen) for _ in range(8)]
    slot_sets[0][0] = SEQ_SCRATCH - 1          # the last real slot
    slot_sets[0][1] = 2**31 // SEQ_ROWB + 1    # just past 2³¹ bytes
    idx_sets = [s * SEQ_W for s in slot_sets]
    high = int((slot_sets[0].long() * SEQ_ROWB >= 2**31).sum())
    rowp = ROWB // 4
    want = rg.gather_windows_plain(idx_sets[0], ring, n=n, w=SEQ_W,
                                   rowb=ROWB)
    got = rg.gather_windows(idx_sets[0], ring, n=n, w=SEQ_W, rowb=ROWB)
    torch.cuda.synchronize()
    err = max_abs_err(torch, got, want)
    del got, want
    slots2d = ring.view(-1, SEQ_W * rowp)
    slots_l = [s.long() for s in slot_sets]
    ms, host_ms = time_ms(torch, lambda i: rg.gather_windows(
        idx_sets[i % 8], ring, n=n, w=SEQ_W, rowb=ROWB))
    plain_ms = time_ms(torch, lambda i: rg.gather_windows_plain(
        idx_sets[i % 8], ring, n=n, w=SEQ_W, rowb=ROWB))[0]
    library_ms = time_ms(torch, lambda i: torch.index_select(
        slots2d, 0, slots_l[i % 8]))[0]
    nbytes = n * 4 + 2 * n * SEQ_ROWB
    return {"n": n, "w": SEQ_W, "windows_past_2^31_bytes": high,
            "max_abs_err": err, "ms": ms, "host_ms": host_ms,
            "plain_ms": plain_ms, "library_ms": library_ms, "bytes": nbytes,
            "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S}


def check_seq_scatter(torch, rg, ring, dev, real: int) -> dict:
    """B2 as the sequence flush launches it: 4 lanes of one 688,128-byte
    sequence row each, ``real`` of them aimed at slots (past the 2³¹-byte
    mark), the rest at the scratch slot, named as ``skip_row``: bitwise
    against the plain version outside the scratch slot, the scratch slot
    untouched; then timed beside the plain version, ``index_copy_`` and the
    byte bound."""
    k, rowp = 4, SEQ_ROWB // 4
    gen = torch.Generator(device=dev).manual_seed(200 + real)
    staged = torch.randint(-2**31, 2**31 - 1, (k * rowp,), dtype=torch.int32,
                           device=dev, generator=gen)
    dst = torch.full((k,), SEQ_SCRATCH, dtype=torch.int32, device=dev)
    dst[:real] = torch.tensor([12_345, 4_000, 9_999, 7_777][:real],
                              dtype=torch.int32)
    src = torch.arange(k, dtype=torch.int32, device=dev)
    scratch_slot = ring[-rowp:].clone()
    plain = ring.clone()
    rg.scatter_rows(src, dst, staged, ring, n=k, rowb=SEQ_ROWB,
                    skip_row=SEQ_SCRATCH)
    rg.scatter_rows_plain(src, dst, staged, plain, n=k, rowb=SEQ_ROWB)
    torch.cuda.synchronize()
    err = max_abs_err(torch, ring[:-rowp], plain[:-rowp])
    kept = bool(torch.equal(ring[-rowp:], scratch_slot))
    del plain
    torch.cuda.empty_cache()
    ms, host_ms = time_ms(torch, lambda i: rg.scatter_rows(
        src, dst, staged, ring, n=k, rowb=SEQ_ROWB, skip_row=SEQ_SCRATCH))
    plain_ms = time_ms(torch, lambda i: rg.scatter_rows_plain(
        src, dst, staged, ring, n=k, rowb=SEQ_ROWB))[0]
    ring2d, rows_src = ring.view(-1, rowp), staged.view(-1, rowp)[src.long()]
    dst_l = dst.long()
    library_ms = time_ms(
        torch, lambda i: ring2d.index_copy_(0, dst_l, rows_src))[0]
    to_ring = dst != SEQ_SCRATCH
    n_src = int(torch.unique(src[to_ring]).numel())
    n_dst = int(torch.unique(dst[to_ring]).numel())
    nbytes = (n_src + n_dst) * SEQ_ROWB + 2 * k * 4
    return {"n": k, "rowb": SEQ_ROWB, "real_lanes": real,
            "max_abs_err": err, "scratch_slot_kept": kept,
            "ms": ms, "host_ms": host_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bytes": nbytes,
            "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S}


def seq_row(m: dict, empty_ms: float) -> dict:
    """A phase-3c measurement as the ``kernels`` line carries it: the
    wrapper's time and its yardsticks."""
    keys = ("ms", "plain_ms", "bound_ms", "library_ms", "host_ms",
            "max_abs_err", "bytes")
    return dict({k: m[k] for k in keys}, bound_by="bytes",
                empty_kernel_ms=empty_ms)


def r2d2_ring_kernels(torch, rg, dev, empty_ms: float) -> dict:
    """Phase 3c: B1 and B2 at the r2d2 preset's shapes on a ring of its
    geometry (12,501 slots × 84 rows × 8192 B = 8.6 GB)."""
    gen = torch.Generator(device=dev).manual_seed(5)
    ring = torch.randint(-2**31, 2**31 - 1,
                         (SEQ_SLOTS * SEQ_ROWB // 4,), dtype=torch.int32,
                         device=dev, generator=gen)
    log(f"[3c] sequence ring: {SEQ_SLOTS} slots x {SEQ_W} rows x {ROWB} B "
        f"= {ring.numel() * 4 / 1e9:.2f} GB")
    out = {"gather": [check_seq_gather(torch, rg, ring, dev, n)
                      for n in (64, 512)],
           "scatter": [check_seq_scatter(torch, rg, ring, dev, real)
                       for real in (1, 4)],
           "empty_kernel_ms": empty_ms}
    del ring
    torch.cuda.empty_cache()
    for g in out["gather"]:
        log(f"[3c] gather_windows {json.dumps(g)}")
        assert g["max_abs_err"] == 0, "gather_windows disagrees with plain"
        assert g["windows_past_2^31_bytes"] > 0
    for s in out["scatter"]:
        log(f"[3c] scatter_rows {json.dumps(s)}")
        assert s["max_abs_err"] == 0, "scatter_rows disagrees with plain"
        assert s["scratch_slot_kept"], "scatter_rows wrote the scratch slot"
    return out


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
    """Where a chained grad step's time goes: ``trace_steps`` over
    ``dispatches`` dispatches of ``chain`` grad steps."""
    return trace_steps(
        torch, lambda: solver.train_steps_device_per(replay, chain=chain),
        dispatches, chain * dispatches)


def trace_steps(torch, run, calls: int, steps: int, top_n: int = 8):
    """A ``torch.profiler`` window over ``calls`` calls of ``run`` that
    make ``steps`` grad steps. Device-busy share = the kernels' summed
    device time over the window's wall time (one stream, so kernels do not
    overlap); the top kernels by device time, in ms per grad step."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:top_n]
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


# the r2d2 preset at full width (bf16 Nature torso at 84×84, LSTM 512,
# dueling head, batch 64 × 80 steps, burn-in 40, an 8.6 GB sequence ring)
# on SignalAtari. Its 32-step episodes each give one 80-step sequence, so
# the 250 sequences of learn_start 20,000 are in at env step 8,000; 8,800
# steps train every 4th from there: 201 grad steps. A 32-step episode ends
# before the 40-step burn-in does, so every train window is masked and the
# loss is 0 (as in the reference): these paths run every layer and kernel
# without a learning signal; phase 7c's ring step has one.
R2D2_ARGV = ["train", "--preset", "r2d2", "--backend", "cuda",
             "--log-every", "100", "--set", "env.kind=signal_atari",
             "env.id=signal", "train.total_steps=8800"]
R2D2_GRAD_STEPS = (8800 - 250 * 32) // 4 + 1
# the chained fused path (replay.device_per=true, chain 8): learn_start cut
# to 100 sequences (env step 3,200) and depth to 100 grad steps, 13
# dispatches
R2D2_FUSED_ARGV = R2D2_ARGV[:-1] + ["train.total_steps=3596",
                                    "replay.learn_start=8000",
                                    "replay.device_per=true"]
R2D2_FUSED_GRAD_STEPS, R2D2_FUSED_DISPATCHES = 100, 13


def r2d2_config(config):
    cfg = config.r2d2_config()
    cfg.mesh.backend = "cuda"
    cfg.env.kind, cfg.env.id = "signal_atari", "signal"
    cfg.net.num_actions = 4
    return cfg


def random_sequences(n: int, seq_len: int, lstm: int, frame=(84, 84),
                     stack: int = 4, seed: int = 0):
    """``n`` sequence emissions as a ``SequenceBuilder`` makes them: stacked
    random frames, the last third of them padded past a 20-step episode
    end, random stored carries."""
    rng = np.random.default_rng(seed)
    for i in range(n):
        valid = seq_len if i % 3 else 20
        mask = np.zeros(seq_len, np.float32)
        mask[:valid] = 1.0
        obs = np.zeros((seq_len + 1,) + frame + (stack,), np.uint8)
        obs[:valid + 1] = rng.integers(0, 256, obs[:valid + 1].shape,
                                       dtype=np.uint8)
        yield {"obs": obs,
               "action": rng.integers(0, 4, seq_len).astype(np.int32),
               "reward": (rng.random(seq_len) < 0.25).astype(np.float32),
               "discount": np.where(np.arange(seq_len) == valid - 1, 0.0,
                                    0.99).astype(np.float32) * mask,
               "mask": mask,
               "init_c": rng.standard_normal(lstm).astype(np.float32) * 0.1,
               "init_h": rng.standard_normal(lstm).astype(np.float32) * 0.1}


def r2d2_ring_step_trace(torch, config, SequenceSolver,
                         DeviceSequenceReplay) -> dict:
    """Phase 7c, first half: the preset's ring step (host sample, one B1
    launch, the recurrent step) at full width on a filled 8.6 GB ring:
    ms per grad step by the host clock over 10 steps, then a profiler
    window over 4."""
    cfg = r2d2_config(config)
    solver = SequenceSolver(cfg)
    rc = cfg.replay
    replay = DeviceSequenceReplay(
        rc.capacity // rc.sequence_length, rc.sequence_length, (84, 84, 4),
        solver.device, cfg.net.lstm_size, prioritized=rc.prioritized,
        alpha=rc.priority_alpha, beta0=rc.priority_beta0,
        beta_steps=rc.priority_beta_steps, eps=rc.priority_eps)
    for seq in random_sequences(320, rc.sequence_length, cfg.net.lstm_size):
        replay.add_sequence(seq)

    def step():
        batch = replay.sample(rc.batch_size)
        batch.pop("_sampled_at")
        return solver.train_step_from_ring(replay, batch)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        m = step()
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / 10
    # two in three of these sequences fill the train window, so, unlike
    # phase 7's SignalAtari sequences, they give a loss and a gradient
    assert math.isfinite(float(m["loss"])) and float(m["loss"]) > 0, m
    torch.cuda.reset_peak_memory_stats()
    out = {"ms_per_grad_step": ms, "loss": float(m["loss"]),
           "trace": trace_steps(torch, step, 4, 4, top_n=5),
           "max_memory_allocated_GB":
               torch.cuda.max_memory_allocated() / 1e9}
    del solver, replay
    return out


def r2d2_cross_device_check(torch, config, SequenceSolver,
                            DeviceSequenceReplay) -> dict:
    """Phase 7c, second half: one small ring step (float32, 36×36, LSTM 16,
    8-step sequences with 4 of burn-in, batch 8) on the card and on the CPU
    (whose path the CPU tests hold to the JAX reference) from the same
    weights, sequences and sampled batch. The rings must agree bitwise
    outside the scratch slot; the loss within 1e-4 relative, the
    priorities within 1e-3 relative plus 1e-5 (value_rescale_inv cancels
    to 2ε, which magnifies a last-bit difference of sqrt). The backward
    (convolution and LSTM backward, the clip) is held through Adam's first
    moment, (1 − β₁)·g after one step: each leaf within 1e-3 of its
    largest element on the CPU. θ within 1e-6: one Adam step moves a leaf
    by lr·g/(|g| + ε), so a gradient of the wrong sign, or a wrong size
    where |g| is near ε, shows there (convolution algorithms differ; TF32
    off)."""
    frame, lstm, seq_len = (36, 36), 16, 8

    def build(backend):
        cfg = config.Config()
        cfg.mesh.backend = backend
        cfg.net = config.NetConfig(kind="r2d2", num_actions=4, lstm_size=lstm,
                                   frame_shape=frame, dueling=True)
        cfg.replay = config.ReplayConfig(batch_size=8, sequence_length=seq_len,
                                         burn_in=4, prioritized=True)
        cfg.train = config.TrainConfig(lr=1e-4, double_dqn=True,
                                       target_update_period=2)
        s = SequenceSolver(cfg)
        r = DeviceSequenceReplay(24, seq_len, frame + (4,), s.device, lstm,
                                 prioritized=True, alpha=0.6, seed=3)
        for seq in random_sequences(30, seq_len, lstm, frame, seed=4):
            r.add_sequence(seq)
        return s, r

    (sg, rg_), (sc, rc) = build("cuda"), build("cpu")
    st = sc.flax_state()
    sg.load_flax_state(st["params"], st["target_params"], st["count"],
                       st["mu"], st["nu"], st["step"])
    bg, bc = rg_.sample(8), rc.sample(8)
    assert np.array_equal(bg["seq_local"], bc["seq_local"])
    for b in (bg, bc):
        b.pop("_sampled_at")
    mg = sg.train_step_from_ring(rg_, bg)
    mc = sc.train_step_from_ring(rc, bc)
    seq_elems = rc.W * rc.rowp
    assert torch.equal(rg_.ring[:-seq_elems].cpu(), rc.ring[:-seq_elems])
    lg, lc = float(mg["loss"]), float(mc["loss"])
    assert abs(lg - lc) <= 1e-4 * abs(lc), (lg, lc)
    pg, pc = mg["td_abs"].cpu().numpy(), mc["td_abs"].numpy()
    np.testing.assert_allclose(pg, pc, rtol=1e-3, atol=1e-5)
    dtheta = max(float((a.detach().cpu() - b.detach()).abs().max())
                 for a, b in zip(sg.state.net.parameters(),
                                 sc.state.net.parameters()))
    assert dtheta <= 1e-6, dtheta
    mu_g, mu_c = sg.state.opt_state["mu"], sc.state.opt_state["mu"]
    assert mu_g.keys() == mu_c.keys()
    dmu = {}
    for name, c in mu_c.items():
        scale = float(c.abs().max())
        assert scale > 0, f"no gradient reached {name}"
        dmu[name] = float((mu_g[name].cpu() - c).abs().max()) / scale
    worst = max(dmu, key=dmu.get)
    assert dmu[worst] <= 1e-3, (worst, dmu[worst])
    return {"loss_cuda": lg, "loss_cpu": lc,
            "priority_max_rel_diff": float(np.max(np.abs(pg - pc)
                                                  / np.abs(pc))),
            "max_abs_dtheta": dtheta,
            "mu_max_rel_diff": {"leaf": worst, "value": dmu[worst]}}


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
        from distributed_deep_q_tpu_torch.parallel.sequence_learner import (
            SequenceSolver)
        from distributed_deep_q_tpu_torch.replay.device_per import (
            DevicePERFrameReplay)
        from distributed_deep_q_tpu_torch.replay.device_sequence import (
            DeviceSequenceReplay)
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

    # -- 3c. ring kernels at the r2d2 preset's sequence shapes ---------------
    seq_k = r2d2_ring_kernels(torch, rg, dev, empty_ms)

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

    torch.cuda.empty_cache()

    # -- 7. the r2d2 preset through the CLI, its own path ---------------------
    r_summary, r_launches, r_record = run_cli(
        cli_main, counters, R2D2_ARGV, "chip_smoke_r2d2.jsonl")
    r_random = random_policy_return(make_env, r2d2_config(config).env,
                                    config.r2d2_config().train.eval_episodes)
    log(f"[7] r2d2 ring path summary: {json.dumps(r_summary)}")
    log(f"[7] last metrics record (100 grad steps): {json.dumps(r_record)}")
    log(f"[7] launches: {json.dumps(r_launches)}; eval_return "
        f"{r_summary['eval_return']} beside the random policy's {r_random} "
        "(printed, not asserted: a few hundred R2D2 steps may not learn)")
    check_path(r_summary, R2D2_GRAD_STEPS)
    assert r_launches["gather_windows"] >= r_summary["grad_steps"], r_launches
    assert r_launches["scatter_rows"] > 0, r_launches
    gc.collect()
    torch.cuda.empty_cache()

    # -- 7b. the r2d2 preset's chained fused path ----------------------------
    f_summary, f_launches, f_record = run_cli(
        cli_main, counters, R2D2_FUSED_ARGV, "chip_smoke_r2d2_fused.jsonl")
    log(f"[7b] r2d2 chained fused path summary: {json.dumps(f_summary)}")
    log(f"[7b] last metrics record (100 grad steps): {json.dumps(f_record)}")
    log(f"[7b] launches: {json.dumps(f_launches)}")
    check_path(f_summary, R2D2_FUSED_GRAD_STEPS)
    assert f_launches["gather_windows"] == R2D2_FUSED_DISPATCHES, f_launches
    assert f_launches["scatter_rows"] > 0, f_launches
    gc.collect()
    torch.cuda.empty_cache()

    # -- 7c. the ring step traced, then card vs CPU -------------------------
    r_trace = r2d2_ring_step_trace(torch, config, SequenceSolver,
                                   DeviceSequenceReplay)
    log(f"[7c] r2d2 ring step: {json.dumps(r_trace)}")
    gc.collect()
    torch.cuda.empty_cache()
    r_cross = r2d2_cross_device_check(torch, config, SequenceSolver,
                                      DeviceSequenceReplay)
    log(f"[7c] card vs CPU r2d2 ring step: {json.dumps(r_cross)}")

    # -- 8. result lines ------------------------------------------------------
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
    # the sequence-shape numbers (phase 3c) and the r2d2 paths' launches
    r2d2_in_trace = r_trace["trace"]["port_kernels"]
    g64, g512s = seq_k["gather"]
    s1, s4 = seq_k["scatter"]
    kernels[0]["ok"] = kernels[0]["ok"] and g64["max_abs_err"] == 0 \
        and g512s["max_abs_err"] == 0
    kernels[0]["r2d2"] = dict(
        seq_row(g64, empty_ms),
        shape="n=64 w=84 rowb=8192 (ring step)",
        launches=r_launches["gather_windows"], path="phase 7 (r2d2)",
        in_trace_us_per_launch=r2d2_in_trace.get(
            "gather_windows", {}).get("us_per_launch"),
        chain8=dict(seq_row(g512s, empty_ms),
                    shape="n=512 w=84 rowb=8192 (chain 8)",
                    launches=f_launches["gather_windows"],
                    path="phase 7b (r2d2, device_per)"))
    kernels[1]["ok"] = kernels[1]["ok"] and s1["max_abs_err"] == 0 \
        and s4["max_abs_err"] == 0
    kernels[1]["r2d2"] = dict(
        seq_row(s1, empty_ms),
        shape="n=4 lanes, 1 real, rowb=688128 (sequence flush)",
        launches=r_launches["scatter_rows"], path="phase 7 (r2d2)",
        launches_phase_7b=f_launches["scatter_rows"],
        real4=dict(seq_row(s4, empty_ms),
                   shape="n=4 lanes, 4 real, rowb=688128"))
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
