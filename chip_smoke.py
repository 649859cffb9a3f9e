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
   to 5,000, a hundred grad steps; ``train.profile_dir`` set, so the loop's
   ``TraceWindow`` writes a ``torch.profiler`` trace of its last step;
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
8. Pong resume — the preset at full width with the fused loss
   (``train.use_pallas_loss=true``), its ring cut to 131,072 rows (~1 GB
   persisted) and ``learn_start`` to 5,000: ``main train`` with
   ``train.checkpoint_dir`` and ``replay.persist_path`` (251 grad steps,
   saved every 200 and at the end), then the resumed run
   (``train.resume=true``, 100 more grad steps from the restored step and
   ring). The loop's files restored into a fresh solver and replay on the
   card and on the CPU: the train state, the replay's state and the ring
   bytes bitwise; one fused dispatch from each and a chain-8 dispatch from
   the card pairs, their sampled rows, window starts and B1 windows
   bitwise, the losses within stated tolerances; save and load seconds and
   the file sizes;
8b. r2d2 resume — the same on the r2d2 preset's ring-step path at full
   width, the sequence ring cut to 1,250 slots (0.86 GB): B1 reads the
   restored ring and B2 flushes into it; the restored recurrent net's
   ``bias_ih`` is still a zero buffer; the CPU pair's sample and plain
   gather against the card's;
8c. the r2d2 motion gate — the reference's memory-gate configuration
   (``signal-vel-ep`` at stack 1, 16-step sequences, 4 of burn-in) through
   ``train_recurrent`` on the card's device sequence ring:
   ``eval_return`` must reach 16, printed beside the random policy's;
10. the replay feed — the Pong preset at full width (bf16, 84×84, batch
   512, device PER, chain 8, the fused loss) with two cuts: the ring to
   131,072 rows (1.07 GB) in four stream sub-rings, and the depth (4,096
   rows per feeder; the learner trains 200 grad steps from learn_start
   8,192 while the rest arrive). Four ``spawn``ed feeder processes (the port's
   host modules only, no torch) step SignalAtari under a seeded random
   policy and send 64-row batches through a ``ResilientReplayFeedClient``
   with ``flush_seq``, pulling θ every 1,000 frames; the last one under a
   ``ChaosPlan`` that drops some sends and replies. A port
   ``ReplayFeedServer`` on loopback stages them and its ``IngestDrain``
   thread flushes them into the card's ring through B2, while this thread
   takes the server's replay lock around each fused dispatch (B1, B3, B4),
   calls ``note_consumed`` and publishes θ every 50 grad steps. Tracing on
   at sample rate 1; a ``TraceWindow`` over 4 dispatches under ingest
   gives the launches per grad step and the busy share. Checks: every
   acknowledged row landed exactly once (per actor, the server's env steps
   = the feeder's acked rows = the stream's rows; duplicates absorbed on
   the chaos feeder); each stream's frame plane and metadata, bitwise
   against a CPU ring fed the same frames (regenerated from the seeds);
   the drain flushed and did not die; all four kernels launched; a
   snapshot warm-booted into a fresh server and ring gives back every
   replay key, the dedup map and the θ version; the span export and the
   trace directory; the θ a feeder pulled has the reference's leaves.
   Printed: rows/s over the wire, grad steps/s under ingest, the
   ``add_transitions`` p50/p99, the drain's counters, launches per grad
   step and the busy share, ``train/mfu``, snapshot save and load seconds;
9. the ``kernels`` JSON line (each kernel's launches on every path in
   ``launches_by_path``), the ``nvidia-smi`` line, and the last line
   ``{"ok": true, "device": {...}}``.

Every path run (phases 4, 6, 6b, 7, 7b, both runs of 8 and 8b, 8c and 10)
sets all kernel launch counters to 0 just before it and reads them just
after.
"""

from __future__ import annotations

import contextlib
import gc
import io
import json
import math
import os
import shutil
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
    """Where a chained grad step's time goes: ``profiling.launch_census``
    over ``dispatches`` dispatches of ``chain`` grad steps."""
    from distributed_deep_q_tpu_torch.profiling import launch_census

    return launch_census(
        lambda: solver.train_steps_device_per(replay, chain=chain),
        chain * dispatches, calls=dispatches)


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
    window over 4 (``profiling.launch_census``)."""
    from distributed_deep_q_tpu_torch.profiling import launch_census

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
           "trace": launch_census(step, 4, calls=4, top_n=5),
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


# -- phases 8, 8b and 8c: resume on the card, and the r2d2 motion gate ------

# Phase 8: the Pong preset at full width with the fused loss, its ring cut to
# 131,072 rows (a 1.07 GB padded int32 plane, so the persisted file stays
# near 1 GB) and learn_start to 5,000; 6,000 env steps (251 grad steps),
# checkpointed and persisted every 200 grad steps and at the end, then 400
# resumed env steps (100 grad steps: the restored ring opens the learn gate
# at once)
PONG_RESUME_SET = ["env.kind=signal_atari", "env.id=signal",
                   "replay.capacity=131072", "replay.learn_start=5000",
                   "train.use_pallas_loss=true",
                   "train.checkpoint_every=200"]
PONG_RESUME_STEPS, PONG_RESUME_GRAD = (6000, 400), (251, 351)
# Phase 8b: the r2d2 preset at full width, its sequence ring cut to 1,250
# slots (0.86 GB) and learn_start to 64 sequences (env step 2,048); 2,448
# env steps (101 grad steps), then 400 resumed (100 more)
R2D2_RESUME_SET = ["env.kind=signal_atari", "env.id=signal",
                   "replay.capacity=100000", "replay.learn_start=5120",
                   "train.checkpoint_every=100"]
R2D2_RESUME_STEPS, R2D2_RESUME_GRAD = (2448, 400), (101, 201)
# Losses of a restored pair against the original, same card, cuDNN
# deterministic: the chain's first step within 1e-6 relative (the same
# weights and batch), every later step within 1e-3 (each depends on the
# backward before it); the CPU against the card within 2e-2 (bf16
# compute, other convolution algorithms)
LOSS_RTOL_FIRST, LOSS_RTOL_CHAIN, LOSS_RTOL_CPU = 1e-6, 1e-3, 2e-2


def run_counted(counters, fn):
    """``fn()`` with every kernel launch counter set to 0 just before and
    read just after. Returns (its result, launches, wall seconds)."""
    for f in counters.values():
        f.launches = 0
    t0 = time.perf_counter()
    out = fn()
    wall = time.perf_counter() - t0
    return out, {name: f.launches for name, f in counters.items()}, wall


def resume_files(name: str) -> tuple[str, str]:
    """A fresh (checkpoint dir, replay file) pair under ``OUT_DIR``: a
    stale checkpoint from an earlier run would be restored instead."""
    d = os.path.join(OUT_DIR, name)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    return os.path.join(d, "ckpt"), os.path.join(d, "replay.npz")


@contextlib.contextmanager
def capturing(module, name: str, keep):
    """Wrap ``module.name`` so each call also appends ``keep(args,
    result)`` to the yielded list (to hold what a dispatch sampled)."""
    orig = getattr(module, name)
    calls: list = []

    def wrapped(*args, **kwargs):
        out = orig(*args, **kwargs)
        calls.append(keep(args, out))
        return out

    setattr(module, name, wrapped)
    try:
        yield calls
    finally:
        setattr(module, name, orig)


@contextlib.contextmanager
def cudnn_deterministic(torch):
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev


def train_state_diffs(torch, a, b) -> list[str]:
    """The train-state leaves (θ, θ⁻, Adam's count, μ and ν, the step)
    where solvers ``a`` and ``b`` differ, compared bit for bit on the
    host."""
    def leaves(s):
        st = s.state
        out = {f"params/{k}": p for k, p in st.net.named_parameters()}
        out.update({f"target/{k}": p
                    for k, p in st.target_net.named_parameters()})
        for key in ("mu", "nu"):
            out.update({f"{key}/{k}": t
                        for k, t in st.opt_state[key].items()})
        out["count"], out["step"] = st.opt_state["count"], st.step
        return out

    la, lb = leaves(a), leaves(b)
    assert la.keys() == lb.keys(), (la.keys() ^ lb.keys())
    return [k for k in la if not torch.equal(la[k].detach().cpu(),
                                             lb[k].detach().cpu())]


def replay_state_diffs(persistence, want: dict, replay) -> list[str]:
    """The keys of ``replay``'s persisted state (host metadata, cursors,
    RNG states, trees, the downloaded device planes) that differ from
    ``want``."""
    got = persistence.replay_state(replay)
    assert got.keys() == want.keys(), (got.keys() ^ want.keys())
    return [k for k in want if not np.array_equal(np.asarray(got[k]),
                                                  np.asarray(want[k]))]


def tensors_equal(torch, a, b) -> bool:
    return bool(torch.equal(a.detach().cpu(), b.detach().cpu()))


def rel_diff(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-12)


def timed_save_and_load(torch, persistence, checkpoint, solver, replay,
                        ckdir: str, npz: str, restore_into):
    """The loop's save (a checkpoint with ``wait=True``, then the replay
    file) timed on its own into a scratch copy, the file sizes, and the
    restore of the loop's own files into ``restore_into()``'s fresh
    (solver, replay), timed. Returns (that solver, that replay, the times
    and sizes)."""
    scratch_ck, scratch_npz = ckdir + "_timed", npz + ".timed.npz"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    checkpoint.Checkpointer(scratch_ck).save(solver.state, wait=True)
    ckpt_save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    persistence.save_replay(replay, scratch_npz)
    replay_save_s = time.perf_counter() - t0
    shutil.rmtree(scratch_ck)
    os.remove(scratch_npz)
    step = checkpoint.Checkpointer(ckdir).latest_step()
    state_pt = os.path.join(ckdir, str(step), "state.pt")
    s, r = restore_into()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    checkpoint.Checkpointer(ckdir).restore(s.state)
    torch.cuda.synchronize()
    ckpt_load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    persistence.load_replay(r, npz)
    torch.cuda.synchronize()
    replay_load_s = time.perf_counter() - t0
    return s, r, {"checkpoint_save_s": ckpt_save_s,
                  "replay_save_s": replay_save_s,
                  "checkpoint_load_s": ckpt_load_s,
                  "replay_load_s": replay_load_s,
                  "checkpoint_MB": os.path.getsize(state_pt) / 1e6,
                  "replay_file_GB": os.path.getsize(npz) / 1e9}


def check_resume_runs(s1, l1, s2, l2, grad, ckpt_steps, fused_loss) -> None:
    """The first run trained ``grad[0]`` steps; the resumed one started
    from that step and trained to ``grad[1]``; every kernel of the path
    launched in both."""
    assert s1["grad_steps"] == grad[0] == ckpt_steps[0], (s1, ckpt_steps)
    assert s2["grad_steps"] == grad[1] == ckpt_steps[1], (s2, ckpt_steps)
    for s, launches, n in ((s1, l1, grad[0]), (s2, l2, grad[1] - grad[0])):
        assert math.isfinite(s["loss"]) and math.isfinite(s["eval_return"])
        assert launches["gather_windows"] >= n, launches
        assert launches["scatter_rows"] > 0, launches
        if fused_loss:
            for name in ("fused_loss_fwd", "fused_loss_bwd"):
                assert launches[name] >= n, launches


def pong_resume(torch, config, cli_main, counters, modules) -> dict:
    """Phase 8: ``main train`` with a checkpoint dir and a persist path,
    then the resumed run (``train.resume=true``) through
    ``train_single_process``, the function ``main train`` calls, which
    hands back its solver and replay (the original: their state is the
    one the run saved last). The loop's files restored into a fresh pair
    on the card and on the CPU; states compared bit for bit; one fused
    dispatch (chain 1) from each pair and one chain-8 dispatch on the
    card pairs, their sampled rows, window starts and B1 windows bit for
    bit, the losses within the stated tolerances."""
    train, learner, persistence, checkpoint, metrics = modules
    ckdir, npz = resume_files("pong_resume")
    files = [f"train.checkpoint_dir={ckdir}", f"replay.persist_path={npz}"]
    s1, l1, _ = run_cli(
        cli_main, counters,
        ["train", "--preset", "pong", "--backend", "cuda", "--log-every",
         "50", "--set", *PONG_RESUME_SET, *files,
         f"train.total_steps={PONG_RESUME_STEPS[0]}"],
        "chip_smoke_pong_resume_1.jsonl")
    step1 = checkpoint.Checkpointer(ckdir).latest_step()
    cfg = config.pong_config()
    cfg.mesh.backend = "cuda"
    config.apply_overrides(cfg, PONG_RESUME_SET + files + [
        f"train.total_steps={PONG_RESUME_STEPS[1]}", "train.resume=true"])
    jsonl = os.path.join(OUT_DIR, "chip_smoke_pong_resume_2.jsonl")
    s2, l2, wall2 = run_counted(counters, lambda: train.train_single_process(
        cfg, metrics=metrics.Metrics(jsonl), log_every=50))
    orig, orig_replay = s2.pop("solver"), s2.pop("replay")
    step2 = checkpoint.Checkpointer(ckdir).latest_step()
    check_resume_runs(s1, l1, s2, l2, PONG_RESUME_GRAD, (step1, step2),
                      True)
    assert orig.step == step2

    env = train.make_env(cfg.env)

    def fresh(backend):
        s = train.Solver(cfg, backend=backend)
        return s, train.make_replay(cfg, env, s.device)

    restored, restored_replay, io_s = timed_save_and_load(
        torch, persistence, checkpoint, orig, orig_replay, ckdir, npz,
        lambda: fresh("cuda"))
    t0 = time.perf_counter()
    cpu, cpu_replay = fresh("cpu")
    checkpoint.Checkpointer(ckdir).restore(cpu.state)
    persistence.load_replay(cpu_replay, npz)
    io_s["cpu_load_s"] = time.perf_counter() - t0

    # the restored pairs against the original, before any dispatch
    want = persistence.replay_state(orig_replay)
    out = {"runs": [s1, {**s2, "wall_s": wall2}], "launches": [l1, l2],
           "restored_step": step2, "io": io_s,
           "state_diffs": train_state_diffs(torch, orig, restored),
           "cpu_state_diffs": train_state_diffs(torch, orig, cpu),
           "replay_diffs": replay_state_diffs(persistence, want,
                                              restored_replay),
           "cpu_replay_diffs": replay_state_diffs(persistence, want,
                                                  cpu_replay),
           "ring_bytes_equal": all(
               torch.equal(orig_replay.dstate[k], restored_replay.dstate[k])
               for k in orig_replay.dstate)}
    del want

    def keep(args, res):
        metas, win, idx, ws = res
        return {"idx": idx.clone(), "ws": ws.clone(), "win": win.clone(),
                **{f"meta_{k}": v.clone() for k, v in metas.items()}}

    with cudnn_deterministic(torch), \
            capturing(learner, "fused_sample", keep) as calls:
        losses = [orig.train_steps_device_per(orig_replay, chain=1),
                  restored.train_steps_device_per(restored_replay, chain=1),
                  cpu.train_steps_device_per(cpu_replay, chain=1),
                  orig.train_steps_device_per(orig_replay, chain=8),
                  restored.train_steps_device_per(restored_replay, chain=8)]
    lo, lr_, lc, lo8, lr8 = (m["loss"].float().cpu().numpy().tolist()
                             for m in losses)
    co, cr, cc, co8, cr8 = calls
    out["sample_diffs"] = {
        "restored": [k for k in co if not tensors_equal(torch, co[k], cr[k])],
        "cpu": [k for k in co if not tensors_equal(torch, co[k], cc[k])],
        "restored_chain8": [k for k in co8
                            if not tensors_equal(torch, co8[k], cr8[k])]}
    out["sampled_rows"] = {"chain1": int(co["idx"].numel()),
                           "chain8": int(co8["idx"].numel())}
    out["losses"] = {"original": lo + lo8, "restored": lr_ + lr8,
                     "cpu": lc}
    out["loss_rel_diff"] = {
        "restored_first": max(rel_diff(lr_[0], lo[0]),
                              rel_diff(lr8[0], lo8[0])),
        "restored_chain8": max(rel_diff(a, b) for a, b in zip(lr8, lo8)),
        "cpu": rel_diff(lc[0], lo[0])}
    del orig, orig_replay, restored, restored_replay, cpu, cpu_replay
    shutil.rmtree(os.path.dirname(npz))
    return out


def check_resume(out: dict) -> None:
    for key in ("state_diffs", "cpu_state_diffs", "replay_diffs",
                "cpu_replay_diffs"):
        assert not out.get(key), (key, out[key])
    for key, diffs in out["sample_diffs"].items():
        assert not diffs, (key, diffs)
    rel = out["loss_rel_diff"]
    assert rel["restored_first"] <= LOSS_RTOL_FIRST, rel
    assert rel.get("restored_chain8", 0.0) <= LOSS_RTOL_CHAIN, rel
    if "cpu" in rel:
        assert rel["cpu"] <= LOSS_RTOL_CPU, rel


def r2d2_resume(torch, config, cli_main, counters, modules, rg) -> dict:
    """Phase 8b: phase 8's checks on the r2d2 preset's own path (ring
    steps: B1 reads the restored sequence ring, B2 flushes into it). The
    resumed run goes through ``train_recurrent``. One ring step from the
    original and one from the restored pair: the host sample, B1's window
    starts and windows bit for bit, the loss within 1e-6 relative. The
    CPU pair's sample and the plain gather over its ring are compared
    with the card's; its full-width step is not run (phase 7c holds the
    ring step on the card to the CPU at a small size)."""
    train, seq_learner, persistence, checkpoint, metrics = modules
    ckdir, npz = resume_files("r2d2_resume")
    files = [f"train.checkpoint_dir={ckdir}", f"replay.persist_path={npz}"]
    s1, l1, _ = run_cli(
        cli_main, counters,
        ["train", "--preset", "r2d2", "--backend", "cuda", "--log-every",
         "50", "--set", *R2D2_RESUME_SET, *files,
         f"train.total_steps={R2D2_RESUME_STEPS[0]}"],
        "chip_smoke_r2d2_resume_1.jsonl")
    step1 = checkpoint.Checkpointer(ckdir).latest_step()
    cfg = config.r2d2_config()
    cfg.mesh.backend = "cuda"
    config.apply_overrides(cfg, R2D2_RESUME_SET + files + [
        f"train.total_steps={R2D2_RESUME_STEPS[1]}", "train.resume=true"])
    jsonl = os.path.join(OUT_DIR, "chip_smoke_r2d2_resume_2.jsonl")
    s2, l2, wall2 = run_counted(counters, lambda: train.train_recurrent(
        cfg, metrics=metrics.Metrics(jsonl), log_every=50))
    orig, orig_replay = s2.pop("solver"), s2.pop("replay")
    step2 = checkpoint.Checkpointer(ckdir).latest_step()
    check_resume_runs(s1, l1, s2, l2, R2D2_RESUME_GRAD, (step1, step2),
                      False)
    assert orig.step == step2
    obs_shape = tuple(cfg.env.frame_shape) + (cfg.env.stack,)

    def fresh():
        s = train.SequenceSolver(cfg)
        return s, train.make_sequence_replay(cfg, obs_shape, np.uint8,
                                             s.device)

    restored, restored_replay, io_s = timed_save_and_load(
        torch, persistence, checkpoint, orig, orig_replay, ckdir, npz, fresh)
    bias_ih = dict(restored.state.net.named_buffers())["lstm.bias_ih"]
    t0 = time.perf_counter()
    cpu_replay = train.make_sequence_replay(cfg, obs_shape, np.uint8,
                                            torch.device("cpu"))
    persistence.load_replay(cpu_replay, npz)
    io_s["cpu_load_s"] = time.perf_counter() - t0

    want = persistence.replay_state(orig_replay)
    out = {"runs": [s1, {**s2, "wall_s": wall2}], "launches": [l1, l2],
           "restored_step": step2, "io": io_s,
           "state_diffs": train_state_diffs(torch, orig, restored),
           "bias_ih_zero_buffer": not bool(bias_ih.any()) and "lstm.bias_ih"
           not in dict(restored.state.net.named_parameters()),
           "replay_diffs": replay_state_diffs(persistence, want,
                                              restored_replay),
           "cpu_replay_diffs": replay_state_diffs(persistence, want,
                                                  cpu_replay),
           "ring_bytes_equal": tensors_equal(torch, orig_replay.ring,
                                             restored_replay.ring)}
    del want
    assert out["bias_ih_zero_buffer"]
    b = cfg.replay.batch_size
    batches = [r.sample(b) for r in (orig_replay, restored_replay,
                                     cpu_replay)]
    for batch in batches:
        batch.pop("_sampled_at")
    with cudnn_deterministic(torch), capturing(
            seq_learner, "gather_windows",
            lambda args, res: {"idx": args[0].clone(),
                               "win": res.clone()}) as calls:
        mo = orig.train_step_from_ring(orig_replay, batches[0])
        mr = restored.train_step_from_ring(restored_replay, batches[1])
    co, cr = calls
    W = cpu_replay.W
    cpu_idx = torch.from_numpy(batches[2]["seq_local"].astype(np.int32) * W)
    cpu_win = rg.gather_windows(cpu_idx, cpu_replay.ring, n=b, w=W,
                                rowb=cpu_replay.rowb)
    out["sample_diffs"] = {
        "restored": [k for k in batches[0] if not np.array_equal(
            batches[0][k], batches[1][k])]
        + [k for k in co if not tensors_equal(torch, co[k], cr[k])],
        "cpu": [k for k in batches[0] if not np.array_equal(
            batches[0][k], batches[2][k])]
        + ([] if tensors_equal(torch, co["idx"], cpu_idx) else ["idx"])
        + ([] if tensors_equal(torch, co["win"], cpu_win) else ["win"])}
    lo, lr_ = float(mo["loss"]), float(mr["loss"])
    out["losses"] = {"original": lo, "restored": lr_}
    out["loss_rel_diff"] = {"restored_first": 0.0 if lo == lr_
                            else rel_diff(lr_, lo)}
    del orig, orig_replay, restored, restored_replay, cpu_replay
    shutil.rmtree(os.path.dirname(npz))
    return out


def r2d2_gate_config(config):
    """The reference's R2D2 memory gate (``tests/test_velocity_signal.py``):
    ``signal-vel-ep`` at stack 1, 16-step sequences with 4 of burn-in, LSTM
    128, float32 — the band's previous position can live only in the LSTM
    carry. Through the device sequence ring (pixels, ``device_resident``)."""
    cfg = config.Config()
    cfg.mesh.backend = "cuda"
    cfg.env = config.EnvConfig(id="signal-vel-ep", kind="signal_atari",
                               frame_shape=(36, 36), stack=1,
                               reward_clip=0.0)
    cfg.net = config.NetConfig(kind="r2d2", num_actions=4,
                               frame_shape=(36, 36), stack=1, lstm_size=128,
                               compute_dtype="float32")
    cfg.replay = config.ReplayConfig(capacity=16384, batch_size=16,
                                     learn_start=640, sequence_length=16,
                                     burn_in=4)
    cfg.train = config.TrainConfig(lr=1e-3, adam_eps=1e-8, gamma=0.99,
                                   target_tau=0.01, double_dqn=True,
                                   total_steps=8000, train_every=2,
                                   eval_episodes=10, seed=0)
    cfg.actors.eps_decay_steps = 4000
    cfg.actors.eps_end = 0.05
    cfg.actors.eval_eps = 0.0
    return cfg


def r2d2_gate(config, counters, modules, make_env) -> dict:
    """Phase 8c: the motion gate on the card, ``train_recurrent`` on the
    gate's configuration; eval_return beside the random policy's."""
    train, _, _, _, metrics = modules
    cfg = r2d2_gate_config(config)
    jsonl = os.path.join(OUT_DIR, "chip_smoke_r2d2_gate.jsonl")
    s, launches, wall = run_counted(counters, lambda: train.train_recurrent(
        cfg, metrics=metrics.Metrics(jsonl), log_every=500))
    for key in ("solver", "replay"):
        s.pop(key)
    random_ret = random_policy_return(make_env, cfg.env,
                                      cfg.train.eval_episodes)
    return {"summary": {**s, "wall_s": wall}, "launches": launches,
            "random_policy_return": random_ret, "bar": 16.0}


# -- phase 10: the replay feed ----------------------------------------------

# The Pong preset at full width (bf16 Nature CNN, 84×84 SignalAtari, batch
# 512, device PER, chain 8, the fused loss) fed over the v4 wire. Two cuts:
# the ring to 131,072 rows (1.07 GB, as in phase 8) in four stream
# sub-rings, and the depth: the learner trains FEED_GRAD_STEPS grad steps
# from learn_start, while the feeders send the rest of their rows.
FEED_SET = ["env.kind=signal_atari", "env.id=signal",
            "replay.capacity=131072", "replay.learn_start=8192",
            "train.use_pallas_loss=true"]
FEED_STREAMS, FEED_ROWS, FEED_CHUNK = 4, 4_096, 64   # rows per feeder
FEED_SEED0, FEED_PULL_EVERY, FEED_PUBLISH_EVERY = 100, 1_000, 50
FEED_GRAD_STEPS, FEED_DEADLINE_S = 200, 400.0
# the last feeder's plan: drops sends and replies (a reply lost after its
# flush landed is resent and deduplicated; at 0.1 per socket operation a
# feed of 64 flushes loses a reply with probability 1 - 0.9^64 > 0.998)
FEED_CHAOS = "drop=0.1,seed=7"
FEED_TRACE_START, FEED_TRACE_DISPATCHES = 2, 4
# the reference's θ leaves for this net, in ``jax.tree_util.tree_leaves``
# order (``tests/test_torch_replay_feed.py`` pins the port's get_weights
# to the reference's on the CPU)
FEED_THETA_SHAPES = [[4], [512, 4], [32], [8, 8, 4, 32], [64],
                     [4, 4, 32, 64], [64], [3, 3, 64, 64], [512],
                     [3136, 512]]
FEED_SPANS = ("wire_recv", "crc_verify", "wire_decode", "ring_insert",
              "ingest_drain", "sample", "train_step")


def feeder_batches(seed: int, rows: int, chunk: int = FEED_CHUNK):
    """The pixel batches feeder ``seed`` sends, in order: SignalAtari at
    84×84 under a seeded random policy, ``chunk`` rows a batch (the frame
    before each action, the action, reward, done and episode boundary, as
    the in-process loop adds them), with the episode returns that ended
    inside each batch. Regenerated from the seed for the CPU check."""
    from distributed_deep_q_tpu_torch.actors.game import make_env
    from distributed_deep_q_tpu_torch.config import EnvConfig

    env = make_env(EnvConfig(kind="signal_atari", id="signal"), seed=seed)
    rng = np.random.default_rng(seed + 1)
    frame, ep_ret = env.reset(), 0.0
    for start in range(0, rows, chunk):
        n = min(chunk, rows - start)
        b = {"frame": np.empty((n, 84, 84), np.uint8),
             "action": np.empty(n, np.int32),
             "reward": np.empty(n, np.float32),
             "done": np.empty(n, bool), "boundary": np.empty(n, bool)}
        returns = []
        for i in range(n):
            a = int(rng.integers(env.num_actions))
            nxt, r, done, over = env.step(a)
            b["frame"][i], b["action"][i], b["reward"][i] = frame, a, r
            b["done"][i], b["boundary"][i] = done, over
            ep_ret += r
            if over:
                returns.append(ep_ret)
                frame, ep_ret = env.reset(), 0.0
            else:
                frame = nxt
        yield b, returns


def feeder(actor_id: int, host: str, port: int, rows: int, chaos: str,
           out) -> None:
    """One feeder process (started with ``spawn``; it imports the port's
    host modules only, never torch): ``feeder_batches`` through a
    ``ResilientReplayFeedClient`` (``flush_seq`` on every flush), θ pulled
    every ``FEED_PULL_EVERY`` frames. Puts its result (or its traceback)
    on ``out``."""
    try:
        from distributed_deep_q_tpu_torch.rpc import faultinject
        from distributed_deep_q_tpu_torch.rpc.resilience import (
            ResilientReplayFeedClient)

        plan = faultinject.install(chaos) if chaos else None
        client = ResilientReplayFeedClient.connect(
            host, port, actor_id=actor_id, seed=actor_id)
        acked, version, pulls, shapes, next_pull = 0, 0, [], None, 0
        t0 = time.perf_counter()
        for batch, returns in feeder_batches(FEED_SEED0 + actor_id, rows):
            if acked >= next_pull:
                v, w = client.get_params(have_version=version)
                if w is not None:
                    version = v
                    shapes = [list(x.shape) for x in w]
                pulls.append(v)
                next_pull += FEED_PULL_EVERY
            r = client.add_transitions(
                **batch, episodes=len(returns),
                ep_returns=np.asarray(returns, np.float32))
            if not r.get("ok"):
                raise RuntimeError(f"flush refused: {r}")
            acked += len(batch["action"])
        wall = time.perf_counter() - t0
        client.close()
        out.put({"actor": actor_id, "acked": acked, "wall_s": wall,
                 "sheds": client.sheds, "retries": client.retries,
                 "pulls": pulls, "theta_version": version,
                 "theta_shapes": shapes,
                 "chaos": dict(plan.counters) if plan else {}})
    except BaseException:  # noqa: BLE001 — reported to the parent
        out.put({"actor": actor_id, "error": traceback.format_exc()})


def stream_diffs(torch, card, cpu) -> list[str]:
    """Per stream (stream i owns slot i), the planes where the card's ring
    and the CPU ring differ: the padded frame rows of the slot (ghost rows
    included, the scratch row not), the device metadata rows, the host
    slot's metadata and the cursors/sizes. Priorities are left out: they
    depend on how the learner interleaved."""
    out = []
    frames = card.dstate["frames"].cpu()
    rowp, pad, cap = card.rowp, card.slot_pad, card.slot_cap
    for g in range(card.num_slots):
        lo, hi = g * pad * rowp, (g + 1) * pad * rowp
        if not torch.equal(frames[lo:hi], cpu.dstate["frames"][lo:hi]):
            out.append(f"stream{g}/frames")
        for k in ("action", "reward", "done", "boundary"):
            a = card.dstate[k][g * cap:(g + 1) * cap].cpu()
            if not torch.equal(a, cpu.dstate[k][g * cap:(g + 1) * cap]):
                out.append(f"stream{g}/{k}")
            if not np.array_equal(getattr(card.slots[g], k),
                                  getattr(cpu.slots[g], k)):
                out.append(f"stream{g}/host_{k}")
    for a, b in zip(card.device_inputs(), cpu.device_inputs()):
        if not np.array_equal(a, b):
            out.append("cursors_sizes")
    return out


def replay_feed(torch, config, counters, modules) -> dict:
    """Phase 10: four spawned feeders send pixel batches over the v4 wire
    to a ``ReplayFeedServer`` whose ``IngestDrain`` flushes them into the
    card's ring (B2), while this thread trains from the ring (B1, B3, B4)
    under the server's replay lock; then the checks of the module
    docstring."""
    import multiprocessing as mp

    (Solver, DevicePERFrameReplay, rs, tracing, profiling,
     persistence) = modules
    cfg = config.pong_config()
    cfg.mesh.backend = "cuda"
    config.apply_overrides(cfg, FEED_SET)
    cfg.net.num_actions = 4
    solver = Solver(cfg)
    rc = cfg.replay

    def ring(device):
        return DevicePERFrameReplay(rc, device, (84, 84), cfg.env.stack,
                                    cfg.train.gamma, seed=cfg.train.seed,
                                    write_chunk=rc.write_chunk,
                                    num_streams=FEED_STREAMS)

    replay = ring(solver.device)
    trace_dir = os.path.join(OUT_DIR, "feed_trace")
    shutil.rmtree(trace_dir, ignore_errors=True)
    tracing.configure(enabled=True, sample_rate=1.0, lineage_rate=0.05,
                      export_dir=os.path.join(OUT_DIR, "feed_spans"))
    server = rs.ReplayFeedServer(replay)    # starts the drain on this stream
    assert server._drain is not None, "the server started no ingest drain"
    server.publish_params(solver.get_weights())
    # FLOPs per grad step and the card's peak, before the counted path
    flops = profiling.fused_train_flops(solver, replay)
    peak = profiling.peak_flops_for(solver.device)
    meter = profiling.MFUMeter(flops, peak)
    window = profiling.TraceWindow(trace_dir, FEED_TRACE_START,
                                   FEED_TRACE_DISPATCHES)
    chain = rc.fused_chain
    host, port = server.address
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(
        target=feeder, args=(i, host, port, FEED_ROWS,
                             FEED_CHAOS if i == FEED_STREAMS - 1 else "", q),
        daemon=True) for i in range(FEED_STREAMS)]
    results: dict[int, dict] = {}

    def collect(block: bool) -> None:
        while len(results) < len(procs):
            try:
                r = q.get(timeout=1.0 if block else 0.0)
            except Exception:  # noqa: BLE001 — queue.Empty
                if not block:
                    return
                if not any(p.is_alive() for p in procs):
                    raise RuntimeError("a feeder exited without a result")
                continue
            if "error" in r:
                raise RuntimeError(f"feeder {r['actor']}:\n{r['error']}")
            results[r["actor"]] = r

    for f in counters.values():
        f.launches = 0
    t0 = time.perf_counter()
    try:
        for p in procs:
            p.start()
        while True:                       # the learn gate
            with server.replay_lock:
                ready = replay.ready(rc.learn_start)
            if ready:
                break
            collect(block=False)
            if time.perf_counter() - t0 > FEED_DEADLINE_S:
                raise RuntimeError("the ring never reached learn_start")
            time.sleep(0.01)
        t_learn = time.perf_counter()
        meter.update(0, t=t_learn)
        gsteps = dispatches = published = 0
        window_rows = None
        with server.replay_lock:
            rows_at_learn = replay.steps_added
        while gsteps < FEED_GRAD_STEPS:
            with server.replay_lock:
                solver.train_steps_device_per(replay, chain=chain)
                if dispatches + 1 == FEED_TRACE_START:
                    window_rows = [replay.steps_added]
                if dispatches + 1 == FEED_TRACE_START + FEED_TRACE_DISPATCHES:
                    window_rows.append(replay.steps_added)
            server.note_consumed(chain * rc.batch_size)
            gsteps += chain
            dispatches += 1
            window.on_step(dispatches)
            if gsteps // FEED_PUBLISH_EVERY > published:
                published = gsteps // FEED_PUBLISH_EVERY
                server.publish_params(solver.get_weights())
            if time.perf_counter() - t0 > FEED_DEADLINE_S:
                raise RuntimeError("the replay feed phase ran out of time")
        torch.cuda.synchronize()
        t_end = time.perf_counter()
        with server.replay_lock:
            rows_while_learning = replay.steps_added - rows_at_learn
        window.close()
        collect(block=True)
        for p in procs:
            p.join(timeout=60)
        assert not any(p.is_alive() for p in procs), "a feeder did not exit"
        mfu = meter.update(gsteps, t=t_end)
        drain_counters = server._drain.counters()   # raises if it died
        summary = server.telemetry_summary()
        ids, steps = server.telemetry.per_actor_env_steps()
        robust = server.telemetry.robustness_counters()
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        server.close()     # stop_drain: one last flush, or its death
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: f.launches for name, f in counters.items()}
    span_path = tracing.export()
    tracing.disable()
    with open(span_path) as f:
        span_names = {e["name"] for e in json.load(f)["traceEvents"]}

    acked = {r["actor"]: r["acked"] for r in results.values()}
    census = window.census(chain * FEED_TRACE_DISPATCHES)
    out = {
        "feeders": [results[i] for i in sorted(results)],
        "grad_steps": gsteps, "dispatches": dispatches,
        "wall_s": wall,
        "rows_per_s_over_wire": sum(acked.values()) / max(
            r["wall_s"] for r in results.values()),
        "grad_steps_per_s_under_ingest": gsteps / (t_end - t_learn),
        "rows_ingested_while_learning": rows_while_learning,
        "add_transitions_ms_p50": summary.get("rpc/add_transitions_ms_p50"),
        "add_transitions_ms_p99": summary.get("rpc/add_transitions_ms_p99"),
        "drain": drain_counters,
        "server_env_steps_by_actor": dict(zip(ids.tolist(), steps.tolist())),
        "robustness": robust,
        "launches": launches,
        "launches_per_grad_step_in_window":
            census["kernel_launches_per_grad_step"],
        "device_busy_share_in_window": census["device_busy_share"],
        "window": {k: census[k] for k in (
            "wall_ms_per_grad_step", "device_ms_per_grad_step",
            "top_kernels_ms_per_grad_step", "port_kernels")},
        "rows_ingested_in_window": (window_rows[1] - window_rows[0]
                                    if window_rows and len(window_rows) == 2
                                    else 0),
        "trace_files": sorted(os.listdir(trace_dir))
        if os.path.isdir(trace_dir) else [],
        "spans_missing": sorted(set(FEED_SPANS) - span_names),
        "train/mfu": mfu.get("train/mfu"), "train/steps_per_s":
            mfu.get("train/steps_per_s"),
        "fused_train_flops": flops, "peak_flops": peak,
        "slot_steps_added": [m.steps_added for m in replay.slots],
    }
    out["exact_once"] = all(
        out["server_env_steps_by_actor"].get(i) == acked[i]
        == replay.slots[i].steps_added for i in range(FEED_STREAMS))

    # the snapshot, taken after the feeders stopped, and its warm boot
    snap = os.path.join(OUT_DIR, "feed_snapshot")
    shutil.rmtree(snap, ignore_errors=True)
    t_s = time.perf_counter()
    server.snapshot(snap)
    out["snapshot_save_s"] = time.perf_counter() - t_s
    want = persistence.replay_state(replay)
    dedup, version = dict(server._flush_seq), server._published_version()
    env_steps = server.counters()["env_steps"]

    # each stream against a CPU ring of the same geometry fed the same
    # per-stream frames, regenerated from the feeders' seeds
    cpu = ring(torch.device("cpu"))
    for i in range(FEED_STREAMS):
        for batch, _ in feeder_batches(FEED_SEED0 + i, FEED_ROWS):
            cpu.add_batch(batch, stream=i)
    cpu.flush()
    out["stream_diffs"] = stream_diffs(torch, replay, cpu)
    del cpu
    del replay
    gc.collect()
    torch.cuda.empty_cache()

    fresh = ring(solver.device)
    t_l = time.perf_counter()
    booted = rs.ReplayFeedServer(fresh, snapshot_path=snap)
    torch.cuda.synchronize()
    out["snapshot_load_s"] = time.perf_counter() - t_l
    try:
        out["warm_boot"] = {
            "replay_diffs": replay_state_diffs(persistence, want, fresh),
            "dedup_equal": booted._flush_seq == dedup,
            "theta_version": [booted._published_version(), version],
            "env_steps": [booted.counters()["env_steps"], env_steps]}
    finally:
        booted.close()
    del want, fresh
    shutil.rmtree(snap, ignore_errors=True)
    return out


def check_replay_feed(out: dict) -> None:
    """Phase 10's checks (each failure raises)."""
    feeders = out["feeders"]
    assert len(feeders) == FEED_STREAMS, feeders
    assert out["exact_once"], (out["server_env_steps_by_actor"],
                               out["slot_steps_added"], feeders)
    chaos = feeders[-1]
    assert chaos["retries"] > 0 and out["robustness"][
        "duplicate_flushes"] > 0, (chaos, out["robustness"])
    assert not out["stream_diffs"], out["stream_diffs"]
    d = out["drain"]
    assert d["flushes"] >= 1 and d["rows"] > 0, d
    for name in ("gather_windows", "scatter_rows", "fused_loss_fwd",
                 "fused_loss_bwd"):
        assert out["launches"][name] > 0, out["launches"]
    assert out["launches"]["gather_windows"] == out["dispatches"]
    assert out["launches"]["fused_loss_fwd"] >= out["grad_steps"]
    wb = out["warm_boot"]
    assert not wb["replay_diffs"], wb
    assert wb["dedup_equal"], wb
    assert wb["theta_version"][0] == wb["theta_version"][1] > 1, wb
    assert wb["env_steps"][0] == wb["env_steps"][1], wb
    assert not out["spans_missing"], out["spans_missing"]
    assert out["trace_files"], "the TraceWindow wrote no trace"
    assert out["rows_ingested_in_window"] > 0, \
        "no row arrived while the trace window ran"
    for f in feeders:
        assert f["theta_shapes"] == FEED_THETA_SHAPES, f["theta_shapes"]
        assert f["theta_version"] >= 1, f


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
        from distributed_deep_q_tpu_torch import metrics as metrics_mod
        from distributed_deep_q_tpu_torch import profiling, tracing
        from distributed_deep_q_tpu_torch import train as train_mod
        from distributed_deep_q_tpu_torch.actors.game import make_env
        from distributed_deep_q_tpu_torch.main import main as cli_main
        from distributed_deep_q_tpu_torch.ops import cuda_build
        from distributed_deep_q_tpu_torch.ops import fused_loss as fl
        from distributed_deep_q_tpu_torch.ops import ring_gather as rg
        from distributed_deep_q_tpu_torch.parallel import learner as learner_mod
        from distributed_deep_q_tpu_torch.parallel import (
            sequence_learner as seq_learner_mod)
        from distributed_deep_q_tpu_torch.parallel.sequence_learner import (
            SequenceSolver)
        from distributed_deep_q_tpu_torch.replay.device_per import (
            DevicePERFrameReplay)
        from distributed_deep_q_tpu_torch.replay import persistence
        from distributed_deep_q_tpu_torch.replay.device_sequence import (
            DeviceSequenceReplay)
        from distributed_deep_q_tpu_torch.rpc import replay_server
        from distributed_deep_q_tpu_torch.solver import Solver
        from distributed_deep_q_tpu_torch.utils import checkpoint
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
    # train.profile_dir through the CLI on the card: a torch.profiler trace
    # of the last grad step (step 101, after the last metrics record)
    profile_dir = os.path.join(OUT_DIR, "profile_6b")
    shutil.rmtree(profile_dir, ignore_errors=True)
    h_summary, h_launches, h_record = run_cli(
        cli_main, counters,
        BREAKOUT_ARGV[:-1] + ["train.total_steps=5400",
                              "replay.learn_start=5000",
                              "replay.device_resident=false",
                              f"train.profile_dir={profile_dir}",
                              "train.profile_start_step=101",
                              "train.profile_num_steps=5"],
        "chip_smoke_breakout_host.jsonl")
    log(f"[6b] breakout host FrameStackReplay summary: "
        f"{json.dumps(h_summary)}")
    log(f"[6b] last metrics record (100 grad steps): {json.dumps(h_record)}")
    log(f"[6b] launches: {json.dumps(h_launches)}; train.profile_dir "
        f"trace: {os.listdir(profile_dir)}")
    check_path(h_summary, 101)
    for name in ("fused_loss_fwd", "fused_loss_bwd"):
        assert h_launches[name] >= h_summary["grad_steps"], h_launches
    assert os.listdir(profile_dir), "train.profile_dir wrote no trace"

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

    # -- 8. Pong resume through the CLI, restored on the card and the CPU --
    gc.collect()
    torch.cuda.empty_cache()
    p_resume = pong_resume(torch, config, cli_main, counters, (
        train_mod, learner_mod, persistence, checkpoint, metrics_mod))
    log(f"[8] pong resume: {json.dumps(p_resume)}")
    check_resume(p_resume)
    assert p_resume["ring_bytes_equal"]
    gc.collect()
    torch.cuda.empty_cache()

    # -- 8b. r2d2 resume through the CLI, restored on the card ---------------
    r_resume = r2d2_resume(torch, config, cli_main, counters, (
        train_mod, seq_learner_mod, persistence, checkpoint, metrics_mod), rg)
    log(f"[8b] r2d2 resume: {json.dumps(r_resume)}")
    check_resume(r_resume)
    assert r_resume["ring_bytes_equal"]
    gc.collect()
    torch.cuda.empty_cache()

    # -- 8c. the r2d2 motion gate on the card ---------------------------------
    gate = r2d2_gate(config, counters, (
        train_mod, seq_learner_mod, persistence, checkpoint, metrics_mod),
        make_env)
    log(f"[8c] r2d2 motion gate: {json.dumps(gate)}")
    g_sum = gate["summary"]
    assert math.isfinite(g_sum["loss"]) and g_sum["grad_steps"] > 0, g_sum
    assert gate["launches"]["gather_windows"] >= g_sum["grad_steps"], gate
    assert gate["launches"]["scatter_rows"] > 0, gate
    assert g_sum["eval_return"] >= gate["bar"], (
        f"r2d2 motion gate: eval_return {g_sum['eval_return']} < "
        f"{gate['bar']} (random {gate['random_policy_return']})")

    # -- 10. the replay feed: feeders over the wire, the drain, the learner --
    gc.collect()
    torch.cuda.empty_cache()
    feed = replay_feed(torch, config, counters, (
        Solver, DevicePERFrameReplay, replay_server, tracing, profiling,
        persistence))
    log(f"[10] replay feed: {json.dumps(feed)}")
    log(f"[10] rows/s over the wire {feed['rows_per_s_over_wire']}; grad "
        f"steps/s under ingest (host clock) "
        f"{feed['grad_steps_per_s_under_ingest']} over "
        f"{feed['grad_steps']} grad steps; add_transitions p50 "
        f"{feed['add_transitions_ms_p50']} ms, p99 "
        f"{feed['add_transitions_ms_p99']} ms")
    log(f"[10] drain {json.dumps(feed['drain'])}; launches per grad step "
        f"{feed['launches_per_grad_step_in_window']}, device busy share "
        f"{feed['device_busy_share_in_window']} (trace window of "
        f"{FEED_TRACE_DISPATCHES} dispatches, "
        f"{feed['rows_ingested_in_window']} rows ingested in it)")
    log(f"[10] train/mfu {feed['train/mfu']} (fused_train_flops "
        f"{feed['fused_train_flops']} per grad step, peak "
        f"{feed['peak_flops']}); snapshot save {feed['snapshot_save_s']} s, "
        f"warm boot {feed['snapshot_load_s']} s")
    check_replay_feed(feed)
    gc.collect()
    torch.cuda.empty_cache()

    # -- 9. result lines ------------------------------------------------------
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
    # every path's launches, each path's counts set to 0 just before it
    by_path = {"4 pong": launches, "6 breakout host-sampled": b_launches,
               "6b breakout host FrameStackReplay": h_launches,
               "7 r2d2": r_launches, "7b r2d2 fused": f_launches,
               "8 pong train": p_resume["launches"][0],
               "8 pong resumed": p_resume["launches"][1],
               "8b r2d2 train": r_resume["launches"][0],
               "8b r2d2 resumed": r_resume["launches"][1],
               "8c r2d2 motion gate": gate["launches"],
               "10 feed": feed["launches"]}
    for row in kernels:
        row["launches_by_path"] = {path: counts[row["name"]]
                                   for path, counts in by_path.items()}
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
