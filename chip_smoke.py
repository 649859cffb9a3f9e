#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``distributed_deep_q_tpu_torch``).

Run from the repository root on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. device — the card's name, count, ``nvidia-smi`` name and power limit,
   and the TF32 flags;
1b. the static-analysis gate — ``distributed_deep_q_tpu_torch.analysis``
   (``python -m distributed_deep_q_tpu_torch.analysis``) over the port
   package as this checkout holds it: findings (the run fails on any),
   the rules, the files scanned, the host seconds and the Python version
   (``--phase1b`` runs it alone, and needs no card);
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
   against their plain versions at B = 512 with A = 4, 6 (the bench's
   head) and 18, δ in
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
   learn_start cut to 8,192), 501 grad steps of the fused device-PER
   dispatch;
5. chained dispatch — a ``Solver`` and a filled replay at the same preset,
   ``train_steps_device_per(chain=8)`` timed over a few dozen dispatches
   with the plain loss and with the fused loss kernels, then each traced
   with ``torch.profiler`` over four (the port's kernels' device time per
   launch read from the fused-loss trace, beside an empty kernel's time in
   a profiler window of its own); where to draw the sampler's uniforms
   (``uniforms_for_keys`` on the host or on the card: ms per call and per
   grad step, in turns); then the same small fused
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
   ``train_recurrent`` on the card's device sequence ring, cuDNN
   deterministic (one reproducible run, as the reference's seeded CPU gate
   is): ``eval_return`` must reach 16, printed beside the random policy's;
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
11. the distributed topology — ``main train --distributed --preset pong
   --backend cuda`` on SignalAtari at full width (bf16 Nature CNN at
   84×84, batch 512, device PER with α = 0, chain 8, the fused loss), the
   preset's 4 actor processes ``spawn``ed on the host and its uncut 1M-row
   ring in four stream sub-rings; cuts: learn_start 8,192 and the depth,
   400 grad steps. First a control: a spawned child that does make a CUDA
   context, and what the checks see of it. While the learner trains, a
   watcher samples the actor processes (this process's ``spawn``ed
   children) and shows that none holds a CUDA context: by ``nvidia-smi``'s
   compute-app pids where they are this namespace's, else by the card's
   device files (``/dev/nvidia*``) being open in no actor and
   ``nvidia-smi`` listing no context beyond the learner's (the CUDA build
   of torch maps ``libcuda.so`` at import, so the maps are printed, not
   held). Checks: the summary (as ``check_path`` holds it), env steps ≥
   learn_start, no actor restart, no checksum or dispatch error, all four
   kernels launched. Printed: grad steps/s, the fleet's env steps/s, the
   ``StepTimer`` phases, ``add_transitions`` p50/p99,
   ``learner/publish_params_ms``, eval_return beside the random policy's;
11b. the Breakout preset host-sampled (``replay.device_resident=false
   replay.prioritized=false``: a host ``MultiStreamFrameReplay`` through
   the ``DeviceStager``'s pinned copies, the fused loss), 4 actors,
   learn_start 8,192, 100 grad steps; the same checks, B3 and B4 launched;
11c. the r2d2 preset on its ring-step path at full width (bf16 Nature
   torso, LSTM 512, batch 64 × 80, burn-in 40, host sum trees with the
   write-back under the server's lock), 2 recurrent actors, the sequence
   ring cut to 1,250 slots as in 8b, learn_start 64 sequences, 100 grad
   steps; the same checks (the fill counted in sequences), B1 and B2
   launched;
12a. ``BatchedPolicy`` on the card at the Pong preset's net (bf16 Nature
   CNN, 84×84×4, 4 actions, buckets 8, 32, 128 and 256), at each bucket
   with 3 rows of padding: the real rows bitwise beside zero and random
   padding; Q within 2e-2 of the port's ``QNet`` at batch 1 on the card
   and of the same forward on the CPU, actions equal to the card's
   batch-1 argmax wherever the top two Q-values differ by more than
   4e-2; two θ generations swapped between forwards each give their own
   replies (bitwise). Timed on full buckets: the forward's device ms
   (CUDA events on the policy's stream), host ms per call with the
   observations' staging and copies, the copy's device and host ms and
   its share, rows/s, beside the bound (bytes or operations); an actor's
   batch-1 forward on one CPU thread, the local baseline;
12b. the served fleet — phase 11's run with ``inference.enabled=true
   actors.vector_envs=8`` (4 actor processes × 8 envs = 32 replay streams
   in the uncut ring, every greedy action from the ``InferenceServer``
   on the learner's card), the health plane on and the autoscaler with
   its executor in ``dry_run``; phase 11's checks (no actor holds a CUDA
   context, all four kernels launched) and: ``infer`` requests made, no
   θ pulled, at most 4 bucket shapes run, no scale action, every
   autoscaler decision acknowledged by the executor's dry-run finding of
   the same rule and the fleet held at 4, and the metrics JSONL passes
   ``telemetry_report.elastic_problems`` (whose applied-vs-target line
   is expected, and only then, when the scaler's final target is not
   the boot fleet: a dry run never closes the loop). Printed:
   the fleet's env steps/s and grad steps/s beside phase 11's, the infer
   reply p50/p99, rows per forward, the forward's ms, sheds,
   ``learner/publish_params_ms`` (which now includes the install),
   eval_return beside the random policy's;
13. the learning-dynamics plane — ``main train --preset breakout --backend
   cuda`` at full width (bf16 Nature CNN, 84×84×4, batch 512, 1M-row
   device-PER ring, α = 0.6, n-step 3, Double DQN, the fused loss) with
   ``train.learn_metrics=true train.stack_forwards=on`` (the reference's
   plane gate on), learn_start cut to 8,192, 301 grad steps: the JSONL
   carries every ``learn/*`` gauge and the ``learn/td_error`` summary, the
   plane's steps are the grad steps and its histogram holds every sample,
   all four kernels launched. Then, from one filled replay, a chain-8
   dispatch with the gate off and one with it on from equal states
   (deterministic cuDNN and index writes): θ, θ⁻, the Adam state and the
   priorities bitwise equal; the card's plane against ``lm_update`` on the
   CPU over the card's own per-step inputs (counts exact, sums within
   1e-5 relative, extrema bitwise but the max priority, whose ``pow``
   rounds its own way on each device: within 2 ulp); ms per chain-8
   dispatch with the gate off and on, and the overhead;
13b. RMSProp — ``main train --preset pong --backend cuda`` with
   ``train.optimizer=rmsprop`` at full width, learn_start cut to 8,192,
   301 grad steps (finite losses; eval_return printed beside the random
   policy's); one small fused step on the card and on the CPU from the
   same weights and batch (θ within 1e-6, ``mu``/``nu`` within 1e-3 of
   each leaf's largest element); a checkpoint of the card's RMSProp state
   restored bitwise into a fresh card solver;
14. Anakin — the reference test's configuration (16 envs, 10×10×2, MLP
   32×32, batch 16, chain 2, 8 ticks, capacity 256): three supersteps
   against the host-driven twin (batched ``act_tick``, ``add_batch(stream
   =g)``, ``train_steps_device_per``), bitwise (every real and ghost ring
   row, action, reward, done, boundary, priority, maxp, θ, θ⁻ and the Adam
   state); 40 supersteps at lr 3e-3 through ``run_anakin``: act_reward >
   0.30. B2 at the superstep's insert shape (2,048 lanes) against its
   plain version, timed beside the byte bound and ``index_copy_``. Then
   the Pong preset's geometry on signal_atari (bf16 Nature CNN 84×84×4,
   batch 512, 1M-row ring, α = 0, chain 8, the fused loss), 64 envs × 16
   ticks, 30 supersteps: all four kernels launched; 10 supersteps under
   ``torch.cuda.set_sync_debug_mode("warn")`` make no synchronizing call;
   a ``torch.profiler`` window of 1 superstep gives the act / insert /
   sample / train stages' device ms, launches per superstep and
   threefry's share, B1 and B2 per launch; the synced solver's greedy
   eval beats the random policy's. Printed: env and grad steps/s, ms per
   superstep;
15. the sharded ring, ``mesh.dp = 8`` — 15a: ``main train --preset pong
   --backend cuda --set mesh.dp=8`` at full width (bf16 Nature CNN, batch
   512 = 64 per shard, the uncut 1M-row ring as 8 shards of 125,000 rows,
   device PER α = 0, chain 8), learn_start cut to 8,192, 201 grad steps;
   grad steps/s beside phase 4's (D = 1), its ``StepTimer`` phases and
   a launch census; phase 5's chain-8 dispatch at D = 1 and D = 8 in
   turns; then
   a small fused dispatch at D = 8 on the card and on the CPU with no
   uniforms injected (8 streams filling the shards alike, and 1 stream
   filling them unequally): sampled rows, window starts, B1 windows,
   metadata, IS weights, ring bytes and priorities bitwise (the weights within 2 ulp where the shards' masses
   differ: ``pow`` may round its own way on each device); 15c: 15a's
   replay saved (8.2 GB) and loaded into a fresh D = 8 replay, its state
   and next draws bitwise, save and load seconds; 15b: B1 and B2 at the
   D = 8 shapes on a ring of that geometry, bitwise against the plain
   versions, timed beside the D = 1 shapes on the same ring; 15d: Anakin
   at D = 8 (phase 14's pin configuration, 2 envs per shard) bitwise
   against its host-driven twin;
16. two learner processes on the one card (``mesh.num_processes=2``,
   gloo, both on ``cuda:0``; each process a ``--phase16-worker`` child of
   this one) — 16a: the Pong preset's geometry (bf16 Nature CNN, batch
   512, chain 8, α = 0) on a 131,072-row ring of 2 shards filled with rows
   keyed by their global slot, 8 chain-8 dispatches at 2 processes × 1
   shard and at 1 process × 2 shards, cuDNN deterministic: the drawn rows
   and IS weights bitwise, every B1 launch's windows bitwise against the
   plain gather on the same indices, the two ranks' θ and Adam's μ
   bitwise, θ within ``P16_THETA_TOL`` and μ within ``P16_MU_TOL`` of
   the 1-process run (``--phase16a`` runs 16a alone); before it, B3/B4 at
   B = 256 and B1 at 2,048 windows on 16b's one-shard ring against their
   plain versions; 16b: phase 11's ``main train
   --distributed`` at 2 processes × 2 actors, 200 grad steps: both exit
   0, grad steps exact, both shards fed, the θ hashes equal, no actor
   holds a CUDA context (an ``ActorWatch`` in each process), B1 and B2
   launched in both; 16c: ``main train`` (the in-process loop) at 2
   processes, the Breakout preset host-sampled with the fused loss,
   learn_start 5,000, 100 grad steps: B3 and B4 launched in both, θ
   hashes equal. Printed: each process's grad steps/s beside phases 11,
   6 and 6b's one-process rates, and the host-clock ms per grad step
   inside the train step's collectives;
17. the chaos and soak gates (``distributed_deep_q_tpu_torch/chaos_smoke.py``
   and ``fleet_smoke.py``) on the card at the Pong preset's width on
   signal_atari (bf16 Nature CNN, 84×84×4, 4 actions, batch 512), each
   sub-phase's kernel counts set to 0 just before it and read just after
   (``--phase17`` runs the phase alone), after the chaos tool's own
   preflight (``chaos_smoke._require_clean_gate``: on a tree the analysis
   gate rejects it prints the findings to stderr and exits 2, so no chaos
   verdict is printed for it; ``--phase17`` runs it before it looks for a
   card) — 17a ``ingest``: 4 actors × 40
   flushes × 64 labeled 84×84 frames into the preset's fused ring of
   16,384 rows (no slot wraps) through the ``IngestDrain`` (B2) while the
   preset's learner steps on it at the capped consumption rate (B1):
   lost, duplicated and corrupt 0 (every id read back from the ring once
   the drain has stopped and the card has finished), sheds fired, the
   drain carried the flushes; 17b ``inference``: ``BatchedPolicy`` behind
   the ``InferenceServer`` at the preset's buckets under
   ``drop=0.03,truncate=0.02,corrupt=0.01,seed=29``: wrong, missing and
   duplicated actions 0 against an oracle forward at the bucket each row
   was served at (cuDNN deterministic), the clients' reply p50/p99; 17c
   ``vector``: the same net, the server hard-killed and rebooted mid-run,
   wrong 0; 17d ``tenants``: both arcs, no actor process holding a CUDA
   context; 17e ``train``: phase 11's run under
   ``actors.chaos=drop=0.005,truncate=0.003,seed=5``, 400 grad steps:
   phase 11's checks, the robustness counters printed, kill escalations
   0, the replay's stored rows equal to the server's env steps (duplicate
   flushes absorbed, not stored); 17f: the pixel fleet soak at 64 streams
   (84×84, batch 512, the 1M-row fused ring) in a ``--phase17f-worker``
   child (the soak's 128 threads share one interpreter lock, and this
   process holds the threads of every earlier phase): every stream
   delivers, the learner steps, the reference's floors (burst > 5,000 and
   paced > 1,000 transitions/s, contention ratio > 0.1), ingest and
   grad-step rates printed beside the card's name and power limit. In 17a
   and 17f the
   first 16 launches of each B1 and B2 shape are held bitwise against
   the plain versions on the same inputs;
18. the bench — its ``--quick`` command line (``bench.main``) in a
   ``--phase18-worker`` child process (``--phase18`` runs the phase
   alone): every row of the port's bench at full width (84×84×4, batch
   512 and 32, chains 64, 256 and 32, the 65,536-row rings and the
   1M-row flagship ring, the r2d2 sequence learner at 64 × 80 on its
   512-sequence ring; the flagship under four paced writers at 256,
   1,024 and 4,096 transitions/s through its ring's drain; the served
   inference plane at 4, 16 and 64 clients; the vector acting plane at
   8, 32 and 128 envs into a 10×10 fused ring behind the feed server;
   the multi-process curve at 1, 2 and 4 learner processes on the one
   card, each a ``--phase18-mh-worker`` child of the bench's process
   with its own shards, feed server and writers, joined over gloo; the
   health plane's overhead), its depth cut. Checks: the one JSON
   line holds every key the bench keeps of the root ``bench.py``'s and
   its own, every rate is finite and above 0, 0 < ``mfu`` ≤ 1.05,
   ``flops_per_step`` within 10% of ``flops_per_step_analytic``, B1 and
   B2 launched in the flagship row and the ingest curve, B2 in the actor
   curve, B3 and B4 in ``pallas_on``; every curve point present, ingest
   achieved above 0 at each target with at most 32,768 + 4 × 64 rows in
   flight, no ingest or actor row lost, the bucket census within the
   buckets; the first 4 launches of each B1 and B2 shape in each row (up
   to 131,072 windows, 7.5 GB out, on the chain-256 row; the ingest
   curve's drain flushes; the actor curve's 10×10 rows; each
   multi-process worker's dispatches and drain flushes) held bitwise
   against the plain versions on the same inputs; at every process
   count every rate and the summed ingest above 0, no RPC crossed to
   another process's server, B1 and B2 launched in every worker, the
   four linearity keys finite. Then B1 and B2 at the workers' shapes on
   a ring of each worker's geometry, and B2 at the actor curve's flush,
   bitwise and timed beside the plain versions, the byte bound and
   ``index_select``/``index_copy_``. Then, each in a child process,
   ``bench --trace-ingest --quick`` (its shard under
   ``chip_smoke_out/p18_traces``, its launches under the same checks):
   its keys, the learner's and the drain's stages attributed, no span
   dropped, and the port's ``trace_report --strict`` on its shard exits
   0; and ``bench_elasticity`` at 2 repeats: the reference's keys.
   B3 at the bench's A = 6 is in 3b;
9. the ``phase_seconds`` JSON line (where the run's time went, phase
   by phase, and its total), the ``kernels`` JSON line (each kernel's
   launches on every path in ``launches_by_path``), the ``nvidia-smi``
   line, and the last line ``{"ok": true, "device": {...}}``.

Every path run (phases 4, 6, 6b, 7, 7b, both runs of 8 and 8b, 8c, 10, 11,
11b, 11c, 12b, 13, 13b, 14, 15a, each process of 16a, 16b and 16c,
17a–17f, and each row of 18) sets all kernel launch counters to 0 just
before it and reads them just after; phase 18's path is the sum of its
rows.

``python3 chip_smoke.py --phase17`` runs phase 17 alone, after the build.

``python3 chip_smoke.py --phase18`` runs phase 18 alone, after the build.

``python3 chip_smoke.py --phase1b`` runs the analysis gate alone (exit 0
clean, 1 on findings).

``python3 chip_smoke.py --phase5 DIR [DIR ...]`` runs phase 5's chained
dispatch from each checkout DIR of the repository in turn (parent,
change, change, parent compares two trees on one card in one call) and
prints its ms per grad step.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import glob
import io
import json
import math
import os
import shutil
import subprocess
import sys
import threading
import time
import traceback

import numpy as np

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
ROWS, ROWB = 1_000_005, 8192       # Pong ring: 1M slots + 4 ghost + scratch
SLOT_CAP, WINDOW = 1_000_000, 5    # stack 4 + n_step 1
ITERS, WARMUP = 64, 5
OUT_DIR = "chip_smoke_out"   # gitignored; the train loop's metrics JSONL


# each phase's tag ("[4]", "[17d]") → the clock at its latest log line
_PHASE_LAST: dict[str, float] = {}
_T0 = time.perf_counter()


def log(msg: str) -> None:
    if msg.startswith("[") and "]" in msg[:8]:
        _PHASE_LAST[msg[1:msg.index("]")]] = time.perf_counter()
    print(msg, flush=True)


def phase_seconds() -> dict:
    """Seconds from each phase's predecessor's last log line to its own
    last one (the first phase's from the process start), in the order the
    phases ended: where the run's time went."""
    out, prev = {}, _T0
    for tag, t in sorted(_PHASE_LAST.items(), key=lambda kv: kv[1]):
        out[tag] = round(t - prev, 1)
        prev = t
    return out


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


def check_gather(torch, rg, ring, dev, n: int, rows: int = ROWS,
                 w: int = WINDOW) -> dict:
    """B1 at ``n`` windows of ``w`` rows on a random ring of ``rows`` rows
    of ``ROWB`` bytes: bitwise against its plain version, then timed beside it,
    ``index_select`` and the byte bound."""
    rowp = ROWB // 4
    gen = torch.Generator(device=dev).manual_seed(n)
    # 8 index sets, cycled while timing, so repeated launches do not find
    # their windows in the 50 MB L2 cache (a fresh draw's windows are cold)
    idx_sets = [torch.randint(0, rows - w + 1, (n,), dtype=torch.int32,
                              device=dev, generator=gen) for _ in range(8)]
    idx = idx_sets[0]
    idx[0] = rows - w                 # the ring's last window
    idx[1] = 2**31 // ROWB + 1             # just past the 2³¹-byte mark
    idx[2] = 0
    high = int((idx.long() * ROWB >= 2**31).sum())
    got = rg.gather_windows(idx, ring, n=n, w=w, rowb=ROWB)
    want = rg.gather_windows_plain(idx, ring, n=n, w=w, rowb=ROWB)
    torch.cuda.synchronize()
    err = max_abs_err(torch, got, want)
    del got, want
    ring2d = ring.view(-1, rowp)
    lib_rows = [(i.long()[:, None] + torch.arange(w, device=dev)
                 ).reshape(-1) for i in idx_sets]
    ms, host_ms = time_ms(torch, lambda i: rg.gather_windows(
        idx_sets[i % 8], ring, n=n, w=w, rowb=ROWB))
    plain_ms, plain_host_ms = time_ms(
        torch, lambda i: rg.gather_windows_plain(
            idx_sets[i % 8], ring, n=n, w=w, rowb=ROWB))
    library_ms, library_host_ms = time_ms(
        torch, lambda i: torch.index_select(ring2d, 0, lib_rows[i % 8]))
    nbytes = n * 4 + 2 * n * w * ROWB
    return {"n": n, "rows": rows, "windows_past_2^31_bytes": high,
            "max_abs_err": err,
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


def check_fused_loss(torch, fl, dev, b: int = 512) -> dict:
    """B3/B4 against their plain versions (bitwise |td| and dq, loss to
    1e-6 relative) over A in {4, 6, 18} (6: the bench's head) and δ in
    {0.5, 1, 2}, B4 at every
    width with and without NaN and inf, then timed at δ = 1 for A = 4, 6
    and 18; all at ``b`` rows (the presets' 512; 256 is one of two
    processes' share)."""
    import torch.nn.functional as F

    out: dict = {"cases": 0, "td_max_abs_err": 0.0, "dq_max_abs_err": 0.0,
                 "loss_max_rel_err": 0.0}
    for a in (4, 6, 18):
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
    for a in (4, 6, 18):
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
    out["uniform_draw"] = time_uniform_draws(torch, plain, replay, chain,
                                             dispatches)
    return out


def time_uniform_draws(torch, solver, replay, chain: int,
                       dispatches: int) -> dict:
    """Where to draw the fused sampler's uniforms: one chain-8 dispatch's
    [8, 512] from its keys on the host (``uniforms_for_keys``: numpy, then
    one pinned copy) or on the card (the keys copied, then
    ``ops/threefry.py``'s hash in torch, ~170 elementwise launches). The
    numbers are the same bits either way (checked); host ms per call over
    64 calls ending in a synchronize, and ms per chain-8 grad step with
    each, in turns (host, card, card, host)."""
    from distributed_deep_q_tpu_torch.ops import threefry
    from distributed_deep_q_tpu_torch.replay.device_per import (
        uniforms_for_keys)
    from distributed_deep_q_tpu_torch.replay.device_ring import to_device
    from distributed_deep_q_tpu_torch.solver import sample_key_schedule

    def on_card(keys, per_shard, device):
        return threefry.uniforms(
            to_device(np.asarray(keys, np.uint32).astype(np.int64), device),
            per_shard)

    dev = solver.device
    keys = sample_key_schedule(0, 0, 1, chain).reshape(-1, 2)
    draws = {"host": uniforms_for_keys, "card": on_card}
    out = {"bitwise_equal": bool(torch.equal(draws["host"](keys, 512, dev),
                                             draws["card"](keys, 512, dev)))}
    for where, draw in draws.items():
        out[f"{where}_ms_per_call"] = time_ms(
            torch, lambda i: draw(keys, 512, dev))[1]
    grad: dict[str, list[float]] = {"host": [], "card": []}
    for where in ("host", "card", "card", "host"):
        solver.draw_uniforms = draws[where]
        grad[where].append(time_chain(torch, solver, replay, chain,
                                      dispatches)[0])
    solver.draw_uniforms = uniforms_for_keys
    out.update({f"{w}_ms_per_grad_step": v for w, v in grad.items()})
    return out


# ``python3 chip_smoke.py --phase5 DIR [DIR ...]``: phase 5's chained
# dispatch run from each checkout DIR of the repository in turn (its own
# package and kernels, built there), in one process each, so two trees
# are compared on one card in one call (parent, change, change, parent)
PHASE5_CODE = """
import json, torch, chip_smoke
from distributed_deep_q_tpu_torch import config
from distributed_deep_q_tpu_torch.replay.device_per import DevicePERFrameReplay
from distributed_deep_q_tpu_torch.solver import Solver
# the empty kernel launched once before phase 5's profiler windows, as the
# whole run has by then (a fresh process's first launch of it goes unseen
# by the profiler)
chip_smoke.time_ms(torch, lambda i: torch.cuda._sleep(0))
out = chip_smoke.run_chained(torch, config, Solver, DevicePERFrameReplay)
print(json.dumps({k: out[k] for k in ("ms_per_grad_step",
                                      "fused_loss_ms_per_grad_step")}))
"""


def phase5_trees(dirs: list[str]) -> int:
    log(nvidia_smi_line())
    for d in dirs:
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, "-c", PHASE5_CODE],
                             cwd=d, capture_output=True, text=True,
                             timeout=900)
        if run.returncode != 0:
            print(run.stderr[-4000:], file=sys.stderr)
            return run.returncode
        row = json.loads(run.stdout.strip().splitlines()[-1])
        log(json.dumps({"tree": d, **row,
                        "wall_s": time.perf_counter() - t0}))
    return 0


def trace_empty_kernel(torch, launches: int = 64, windows: int = 3) -> float:
    """An empty kernel's (``torch.cuda._sleep(0)``) device time per launch
    in a ``torch.profiler`` window of its own: the floor of the phase-5
    "in trace" times, which, unlike the back-to-back floor, hold no gap
    between launches. The window is padded with 20 ms of host time on each
    side, and taken again (up to ``windows`` times) when the profiler
    returns no kernel from it: on the card's machine a window of only
    these launches sometimes came back empty (2 of ~8 in PR 11's calls)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(windows):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(0.02)
            for _ in range(launches):
                torch.cuda._sleep(0)
            torch.cuda.synchronize()
            time.sleep(0.02)
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        # ATen's spin_kernel, if the trace holds anything else
        kernels = [e for e in kernels if "spin" in e.key] or kernels
        count = sum(e.count for e in kernels)
        if count:
            return sum(e.self_device_time_total for e in kernels) / count
    raise AssertionError(f"the profiler saw no empty kernel in {windows} "
                         "windows")


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
# phase 4's run of it: learn_start cut to 8,192 (as in phases 11-15), the
# same 501 grad steps
PONG_MAIN_ARGV = PONG_ARGV[:-1] + ["replay.learn_start=8192",
                                   "train.total_steps=10192"]
# the Breakout preset at full width; depth cut to 1,600 env steps (400 grad
# steps) past learn_start 20,000
BREAKOUT_ARGV = ["train", "--preset", "breakout", "--backend", "cuda",
                 "--log-every", "100", "--set", "env.kind=signal_atari",
                 "env.id=signal", "train.use_pallas_loss=true",
                 "train.total_steps=21600"]


# the r2d2 preset at full width (bf16 Nature torso at 84×84, LSTM 512,
# dueling head, batch 64 × 80 steps, burn-in 40, an 8.6 GB sequence ring)
# on SignalAtari. Its 32-step episodes each give one 80-step sequence, so
# the 100 sequences of learn_start 8,000 (cut from the preset's 20,000) are
# in at env step 3,200; 4,000 steps train every 4th from there: 201 grad
# steps. A 32-step episode ends
# before the 40-step burn-in does, so every train window is masked and the
# loss is 0 (as in the reference): these paths run every layer and kernel
# without a learning signal; phase 7c's ring step has one.
R2D2_SET = ["train", "--preset", "r2d2", "--backend", "cuda",
            "--log-every", "100", "--set", "env.kind=signal_atari",
            "env.id=signal"]
R2D2_ARGV = R2D2_SET + ["replay.learn_start=8000", "train.total_steps=4000"]
R2D2_GRAD_STEPS = (4000 - 100 * 32) // 4 + 1
# the chained fused path (replay.device_per=true, chain 8): learn_start cut
# to 100 sequences (env step 3,200) and depth to 100 grad steps, 13
# dispatches
R2D2_FUSED_ARGV = R2D2_SET + ["train.total_steps=3596",
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
        if "count" in st.opt_state:        # Adam's; RMSProp keeps none
            out["count"] = st.opt_state["count"]
        out["step"] = st.step
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


def r2d2_gate(torch, config, counters, modules, make_env) -> dict:
    """Phase 8c: the motion gate on the card, ``train_recurrent`` on the
    gate's configuration; eval_return beside the random policy's. cuDNN
    runs deterministic here, so the gate holds one reproducible run, as
    the reference's seeded CPU gate does: with cuDNN's default algorithms
    the seed-0 run's eval_return moved between 14.7 and 19.7 from run to
    run on one card (PERF.md §6)."""
    train, _, _, _, metrics = modules
    cfg = r2d2_gate_config(config)
    jsonl = os.path.join(OUT_DIR, "chip_smoke_r2d2_gate.jsonl")
    with cudnn_deterministic(torch):
        s, launches, wall = run_counted(
            counters, lambda: train.train_recurrent(
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


# -- phases 11, 11b and 11c: the distributed topology ------------------------

# ``main train --distributed`` at full width on SignalAtari at 84×84: the
# learner on the card, the presets' actor processes spawned on the host,
# feeding it over the v4 wire. Phase 11, the Pong preset (bf16 Nature CNN,
# batch 512, its uncut 1M-row ring in four stream sub-rings, device PER
# with α = 0, chain 8, the fused loss: all four kernels); cuts: learn_start
# 8,192 and the depth, 400 grad steps. The actor watch reads "training"
# from the first metrics record, so the run logs every 50 grad steps: a
# watch period (1.5 s) must fit between that record and the run's end
DIST_PONG_ARGV = ["train", "--distributed", "--preset", "pong",
                  "--backend", "cuda", "--log-every", "50", "--set",
                  "env.kind=signal_atari", "env.id=signal",
                  "replay.learn_start=8192", "train.use_pallas_loss=true",
                  "train.total_steps=400"]
# Phase 11b, the Breakout preset host-sampled: frames in a host
# MultiStreamFrameReplay (uniform), batches through the DeviceStager's
# pinned copies, the fused loss; cuts: 4 actors (the preset has 16),
# learn_start 8,192, 100 grad steps
DIST_BREAKOUT_ARGV = ["train", "--distributed", "--preset", "breakout",
                      "--backend", "cuda", "--log-every", "50", "--set",
                      "env.kind=signal_atari", "env.id=signal",
                      "replay.device_resident=false",
                      "replay.prioritized=false", "actors.num_actors=4",
                      "replay.learn_start=8192",
                      "train.use_pallas_loss=true", "train.total_steps=100"]
# Phase 11c, the r2d2 preset on its ring-step path (bf16 Nature torso, LSTM
# 512, batch 64 × 80, burn-in 40, host sum trees with the write-back under
# the server's lock); cuts: 2 recurrent actors (the preset has 256), the
# sequence ring to 1,250 slots as in phase 8b, learn_start 64 sequences,
# 100 grad steps
DIST_R2D2_ARGV = ["train", "--distributed", "--preset", "r2d2",
                  "--backend", "cuda", "--log-every", "50", "--set",
                  "env.kind=signal_atari", "env.id=signal",
                  "actors.num_actors=2", "replay.capacity=100000",
                  "replay.learn_start=5120", "train.total_steps=100"]
DIST_PRINTED = ("time_sample_ms", "time_dispatch_ms", "time_step_ms",
                "time_device_ms", "rpc/add_transitions_ms_p50",
                "rpc/add_transitions_ms_p99", "learner/publish_params_ms_p50",
                "learner/publish_params_ms_max", "fleet/env_step_ms_p50",
                "ingest/drained_rows", "ingest/drain_flushes")


def child_pids() -> list[int]:
    """This process's child processes: the tasks listed in
    ``/proc/<pid>/task/*/children`` (a scan of ``/proc/*/stat`` where the
    kernel keeps no such list) that lead their thread group: some kernels
    (gVisor's, for one) list the children's threads there too."""
    me, pids = os.getpid(), set()
    paths = glob.glob(f"/proc/{me}/task/*/children")
    for path in paths:
        with contextlib.suppress(OSError):
            with open(path) as f:
                pids.update(int(x) for x in f.read().split())
    if not paths:
        for stat in glob.glob("/proc/[0-9]*/stat"):
            with contextlib.suppress(OSError, ValueError, IndexError):
                with open(stat) as f:
                    if int(f.read().rsplit(")", 1)[1].split()[1]) == me:
                        pids.add(int(stat.split("/")[2]))
    leaders = []
    for pid in sorted(pids):
        with contextlib.suppress(OSError):
            with open(f"/proc/{pid}/status") as f:
                tgid = [ln for ln in f if ln.startswith("Tgid:")]
            if tgid and int(tgid[0].split()[1]) == pid:
                leaders.append(pid)
    return leaders


def spawned_children() -> list[int]:
    """The ``spawn``ed children (``spawn_main`` on their command line)."""
    out = []
    for pid in child_pids():
        with contextlib.suppress(OSError):
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                if b"spawn_main" in f.read():
                    out.append(pid)
    return out


def card_files(pid: int) -> list[str]:
    """The card's device files ``pid`` holds open (``/dev/nvidia0``,
    ``/dev/nvidiactl``, ``/dev/nvidia-uvm``): a CUDA context opens them."""
    out = set()
    for fd in glob.glob(f"/proc/{pid}/fd/*"):
        with contextlib.suppress(OSError):
            target = os.readlink(fd)
            if target.startswith("/dev/nvidia"):
                out.add(target)
    return sorted(out)


def maps_libcuda(pid: int) -> bool:
    with contextlib.suppress(OSError):
        with open(f"/proc/{pid}/maps") as f:
            return "libcuda.so" in f.read()
    return False


def compute_apps() -> list[int]:
    """``nvidia-smi``'s compute-app pids, one entry per CUDA context."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return [int(x) for x in out.split() if x.isdigit()]


def _hold_context(ready, stop) -> None:
    """A spawned child that makes a CUDA context and holds it (the
    positive control of the actors' context check)."""
    import torch

    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    ready.set()
    stop.wait(120)


def context_control() -> dict:
    """What the context checks see for a spawned child that does hold a
    CUDA context: its card files and the compute-app count with it alive
    (this process holds one context too)."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    ready, stop = ctx.Event(), ctx.Event()
    p = ctx.Process(target=_hold_context, args=(ready, stop), daemon=True)
    p.start()
    try:
        assert ready.wait(120), "the control child made no CUDA context"
        out = {"card_files": card_files(p.pid),
               "maps_libcuda": maps_libcuda(p.pid),
               "compute_apps": len(compute_apps())}
    finally:
        stop.set()
        p.join(30)
    out["compute_apps_after"] = len(compute_apps())
    return out


class ActorWatch:
    """Samples, every ``period`` seconds while a distributed run goes on:
    the actor processes among this process's ``spawn``ed children, the
    card files each holds open, whether each maps ``libcuda.so``, the
    compute apps ``nvidia-smi`` lists, and whether the learner had logged
    a grad step yet (its metrics JSONL)."""

    def __init__(self, jsonl: str, period: float = 1.5):
        self.jsonl, self.period = jsonl, period
        self.samples: list[dict] = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.period):
            actors = spawned_children()
            if not actors:
                continue
            self.samples.append({
                "actors": actors,
                "card_files": {p: f for p in actors if (f := card_files(p))},
                "maps_libcuda": [p for p in actors if maps_libcuda(p)],
                "compute_apps": compute_apps(),
                "training": (os.path.exists(self.jsonl)
                             and os.path.getsize(self.jsonl) > 0)})

    def verdict(self, fleet: int) -> dict:
        """Stops sampling; the check that ran and what it saw. Where
        ``nvidia-smi`` lists this process's own pid, an actor holds a
        context when it is listed too. Otherwise (a PID namespace, where
        the list shows other pids) an actor holds one when it has a card
        file open, and the list must never hold more entries than this
        process's one context. ``libcuda.so`` in an actor's maps is
        printed, not held: the CUDA build of torch maps it at import."""
        self._stop.set()
        self._thread.join(timeout=120)
        me = os.getpid()
        by_pid = any(me in s["compute_apps"] for s in self.samples)
        if by_pid:
            holding = {p for s in self.samples
                       for p in set(s["actors"]) & set(s["compute_apps"])}
        else:
            holding = {p for s in self.samples for p in s["card_files"]}
        return {"check": ("nvidia-smi pids" if by_pid else
                          "card files open + nvidia-smi compute-app count"),
                "samples": len(self.samples),
                "samples_full_fleet_training": sum(
                    len(s["actors"]) >= fleet and s["training"]
                    for s in self.samples),
                "actors_seen": sorted({p for s in self.samples
                                       for p in s["actors"]}),
                "actors_holding_cuda": sorted(holding),
                "compute_apps_max": max(
                    (len(s["compute_apps"]) for s in self.samples),
                    default=0),
                "actors_mapping_libcuda": sorted({
                    p for s in self.samples for p in s["maps_libcuda"]})}


def distributed_run(cli_main, counters, argv: list[str], jsonl: str,
                    fleet: int) -> dict:
    """One ``main train --distributed`` run through ``run_cli`` (counters
    set to 0 just before, read just after) with an ``ActorWatch``
    sampling the fleet meanwhile."""
    path = os.path.join(OUT_DIR, jsonl)
    with contextlib.suppress(FileNotFoundError):
        os.remove(path)
    watch = ActorWatch(path)
    try:
        summary, launches, record = run_cli(cli_main, counters, argv, jsonl)
    finally:
        ctx = watch.verdict(fleet)
    return {"summary": summary, "launches": launches,
            "printed": {k: record.get(k) for k in DIST_PRINTED},
            "cuda_context": ctx}


def check_distributed_run(out: dict, grad_steps: int, fill: tuple[str, int],
                          kernels: tuple[str, ...]) -> None:
    """Phases 11, 11b and 11c's checks (each failure raises). ``fill`` is
    the summary key and the count the learn gate waited for: env steps
    for the frame replays, sequences (``replay_size``) for r2d2, whose
    32-step SignalAtari episodes each give one padded 80-step sequence,
    so its env steps fall short of the transition-counted learn_start."""
    s = out["summary"]
    check_path(s, grad_steps)
    assert s[fill[0]] >= fill[1], (fill, s)
    assert s["actor_restarts"] == 0, s
    assert s["rpc_checksum_errors"] == 0, s
    assert s["rpc_dispatch_errors"] == 0, s
    for name in kernels:
        assert out["launches"][name] > 0, out["launches"]
    ctx = out["cuda_context"]
    assert ctx["samples_full_fleet_training"] > 0, ctx
    assert not ctx["actors_holding_cuda"], ctx
    if not ctx["check"].startswith("nvidia-smi pids"):
        assert ctx["compute_apps_max"] <= 1, ctx

def check_path(summary: dict, grad_steps: int) -> None:
    for key in ("loss", "q_mean", "grad_steps_per_s", "env_steps_per_s",
                "eval_return"):
        assert math.isfinite(summary[key]), f"{key} = {summary.get(key)}"
    assert summary["grad_steps"] == grad_steps, summary["grad_steps"]


# -- phases 12a and 12b: the served fleet -----------------------------------

# Phase 12a: ``BatchedPolicy`` on the card at the Pong preset's net (bf16
# Nature CNN, 84×84×4, SignalAtari's 4 actions, the preset's buckets).
# Q of a real row against the port's ``QNet`` on the card at batch 1 and
# on the CPU: within 2e-2 absolute (bf16 Q-values carry 8 significant
# bits; cuDNN picks its algorithm per batch shape, the CPU another
# library); actions equal wherever the top two Q-values differ by more
# than twice that. Within one bucket every comparison is bitwise.
POLICY_Q_TOL = 2e-2
POLICY_ITERS = 32

# Phase 12b: phase 11's run with the inference plane on and 8 envs per
# actor process (4 × 8 = 32 replay streams in the uncut 1M-row ring), the
# health plane and the autoscaler with its executor in dry_run (the fleet
# stays 4); the same cuts (learn_start 8,192, 400 grad steps)
SERVED_SET = ["inference.enabled=true", "actors.vector_envs=8",
              "health.enabled=true", "autoscale.enabled=true",
              "autoscale.execute=true", "autoscale.dry_run=true"]
SERVED_PRINTED = ("inference/latency_ms_p50", "inference/latency_ms_p99",
                  "inference/batch_rows_mean", "inference/batch_rows_p50",
                  "inference/forward_ms_p50", "inference/forward_ms_p99",
                  "inference/sheds", "inference/requests",
                  "actor/infer_rtt_ms_p50", "actor/infer_rtt_ms_p99",
                  "actor/vector_rows_mean", "actor/vector_step_ms_p50",
                  "health/findings", "autoscale/target_actors",
                  "autoscale/applied_actors")


def nature_macs_per_row(frame=(84, 84), stack=4, actions=4) -> int:
    """Multiply-adds of one Nature-CNN forward row (convs VALID, fc4 512,
    the Q head): 9.35 M at 84×84×4 with 4 actions."""
    h, w = frame
    macs, cin = 0, stack
    for k, st, cout in ((8, 4, 32), (4, 2, 64), (3, 1, 64)):
        h, w = (h - k) // st + 1, (w - k) // st + 1
        macs += h * w * cout * k * k * cin
        cin = cout
    return macs + h * w * cin * 512 + 512 * actions


def policy_bound(bucket: int, params: int,
                 actions: int = 4) -> tuple[float, str]:
    """The least time of one bucket's forward and what bounds it: the
    larger of its bytes (the uint8 batch in, θ in float32 read once, Q
    out) over 3.35 TB/s and its operations (2 per multiply-add) over
    989.4 TFLOP/s bf16."""
    nbytes = bucket * 84 * 84 * 4 + 4 * params + 4 * bucket * actions
    by_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    by_ops = 1e3 * 2 * nature_macs_per_row() * bucket / 989.4e12
    return ((by_bytes, "bytes") if by_bytes >= by_ops
            else (by_ops, "operations"))


def batched_policy(torch, config) -> dict:
    """Phase 12a: ``BatchedPolicy`` on the card, checked and timed at each
    bucket (see ``POLICY_Q_TOL``)."""
    from distributed_deep_q_tpu_torch.models.policy import BatchedPolicy
    from distributed_deep_q_tpu_torch.models.qnet import QNet

    dev = torch.device("cuda", 0)
    cfg = config.pong_config()
    net = cfg.net
    net.num_actions = 4
    qnet = QNet(net, seed=0, device=dev)
    theta = qnet.get_weights()
    cpu = QNet(net, seed=0)
    cpu.set_weights(theta)
    policy = BatchedPolicy(net, seed=1, buckets=cfg.inference.buckets,
                           device=dev)
    t0 = time.perf_counter()
    policy.set_weights(theta)
    torch.cuda.synchronize()
    install_ms = 1e3 * (time.perf_counter() - t0)
    theta_b = QNet(net, seed=2).get_weights()
    params = sum(int(np.prod(np.shape(w))) for w in theta)
    rng = np.random.default_rng(0)
    rows = []
    for bucket in policy.buckets:
        n = bucket - 3
        obs = rng.integers(0, 256, (bucket, 84, 84, 4), dtype=np.uint8)
        a_pad, q_pad = policy.forward(obs[:n])
        a_rand, q_rand = policy.forward(obs)
        q_one = np.concatenate([qnet.forward(obs[i:i + 1])
                                for i in range(n)])
        q_cpu = cpu.forward(obs[:n])
        top2 = np.sort(q_one, axis=-1)[:, -2:]
        sure = top2[:, 1] - top2[:, 0] > 2 * POLICY_Q_TOL
        # two generations swapped between forwards, each its own replies
        policy.set_weights(theta_b)
        _, q_b = policy.forward(obs[:n])
        policy.set_weights(theta)
        _, q_a = policy.forward(obs[:n])
        gen_b = policy.unflatten(theta_b)
        _, q_b2 = policy.forward(obs[:n], params=gen_b)
        row = {
            "bucket": bucket, "real_rows": n,
            "padding_bitwise": bool(np.array_equal(q_rand[:n], q_pad)
                                    and np.array_equal(a_rand[:n], a_pad)),
            "q_vs_qnet_card_batch1": float(np.abs(q_pad - q_one).max()),
            "q_vs_qnet_cpu": float(np.abs(q_pad - q_cpu).max()),
            "action_rows_checked": int(sure.sum()),
            "actions_equal": bool(np.array_equal(a_pad[sure],
                                                 q_one[sure].argmax(-1))),
            "generations_own_replies": bool(
                np.array_equal(q_a, q_pad) and np.array_equal(q_b2, q_b)
                and not np.array_equal(q_b, q_pad))}
        # timed on full buckets: device ms of the forward alone (events on
        # the policy stream), host ms per call (staging, the copies and
        # the argmax included) and of the observation's staging and copy
        with torch.cuda.stream(policy.stream):
            x = policy.stage(obs, bucket)
            fwd_ms, _ = time_ms(
                torch, lambda i: policy.q_values(x, policy.params),
                POLICY_ITERS)
            copy_ms, copy_host_ms = time_ms(
                torch, lambda i: policy.stage(obs, bucket),
                POLICY_ITERS)
        for _ in range(WARMUP):
            policy.forward(obs)
        t0 = time.perf_counter()
        for _ in range(POLICY_ITERS):
            policy.forward(obs)
        host_ms = 1e3 * (time.perf_counter() - t0) / POLICY_ITERS
        bound_ms, bound_by = policy_bound(bucket, params)
        row.update({
            "device_ms": fwd_ms, "host_ms": host_ms,
            "obs_copy_device_ms": copy_ms,
            "obs_copy_host_ms": copy_host_ms,
            "obs_copy_share_of_host_ms": copy_host_ms / host_ms,
            "rows_per_s": bucket / (host_ms / 1e3),
            "bound_ms": bound_ms, "bound_by": bound_by})
        rows.append(row)
    # the local baseline: an actor's batch-1 forward on one CPU thread
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = rng.integers(0, 256, (1, 84, 84, 4), dtype=np.uint8)
        for _ in range(3):
            cpu.forward(one)
        t0 = time.perf_counter()
        for _ in range(20):
            cpu.forward(one)
        actor_ms = 1e3 * (time.perf_counter() - t0) / 20
    finally:
        torch.set_num_threads(threads)
    return {"buckets": rows, "params": params,
            "macs_per_row": nature_macs_per_row(), "install_ms": install_ms,
            "compiled_buckets": policy.compiled_buckets(),
            "actor_batch1_cpu_one_thread_ms": actor_ms,
            "q_tolerance": POLICY_Q_TOL}


def check_batched_policy(out: dict, buckets) -> None:
    for row in out["buckets"]:
        assert row["padding_bitwise"], row
        assert row["q_vs_qnet_card_batch1"] <= POLICY_Q_TOL, row
        assert row["q_vs_qnet_cpu"] <= POLICY_Q_TOL, row
        assert row["actions_equal"] and row["action_rows_checked"] > 0, row
        assert row["generations_own_replies"], row
    assert out["compiled_buckets"] == sorted(buckets), out


SERVED_FLEET = 4
DRY_RUN_OPEN_LOOP = "elastic: final autoscale/applied_actors"


def dry_run_lineage(records: list[dict], fleet: int) -> list[str]:
    """Problems of a dry-run executor's run: each decision of a record
    must have, in that record's ``autoscale/applied``, a finding of the
    same rule and decision time that says it was a dry run and touched
    nothing, and every ``autoscale/applied_actors`` must stay ``fleet``.
    Returns one line per problem; an empty list is a clean run."""
    out = []
    for i, rec in enumerate(records):
        applied = rec.get("autoscale/applied") or []
        for d in rec.get("autoscale/decision") or []:
            match = [a for a in applied
                     if a.get("rule") == d.get("rule")
                     and a.get("decision_t") == d.get("t")]
            if not match:
                out.append(f"record {i}: decision {d.get('rule')} at "
                           f"{d.get('t')} has no executor finding")
            elif not all(a.get("dry_run") == 1 and a.get("applied") == 0
                         for a in match):
                out.append(f"record {i}: decision {d.get('rule')} was "
                           f"applied in a dry run: {match}")
        n = rec.get("autoscale/applied_actors")
        if n is not None and n != fleet:
            out.append(f"record {i}: autoscale/applied_actors {n} != "
                       f"the boot fleet {fleet} in a dry run")
    return out


def check_served_fleet(out: dict, jsonl: str, report) -> dict:
    """Phase 12b's checks beyond phase 11's (``report`` is the port's
    ``telemetry_report``); returns what it read."""
    s = out["summary"]
    assert s["inference_requests"] > 0, s
    assert s["inference_param_pulls"] == 0, s
    assert 1 <= s["inference_compiled_buckets"] <= 4, s
    assert s["actor_scale_terminations"] == 0, s
    records = report.load_records(os.path.join(OUT_DIR, jsonl))
    found = report.elastic_problems(records)
    decisions = [d for r in records for d in r.get("autoscale/decision", [])]
    # the decisions name the rule and finding behind any scale action
    lineage = dry_run_lineage(records, SERVED_FLEET)
    # a dry-run executor touches no process, so the fleet converges on
    # the scaler's target only while the scaler keeps it at the boot
    # size; every other elastic problem fails the phase
    open_loop = [f for f in found if f.startswith(DRY_RUN_OPEN_LOOP)]
    final_target = [r["autoscale/target_actors"] for r in records
                    if "autoscale/target_actors" in r][-1:]
    assert not open_loop or final_target != [SERVED_FLEET], (
        open_loop, final_target)
    assert not lineage and len(open_loop) == len(found), (
        found, lineage, decisions)
    return {"records": len(records), "last_record": records[-1],
            "elastic_problems": found, "decisions": decisions,
            "verdicts": [r["health/verdict"].get("status") for r in records
                         if isinstance(r.get("health/verdict"), dict)]}



# -- phases 13, 13b and 14: the learning-dynamics plane, RMSProp, Anakin -------

# Phase 13: the Breakout preset's fused device-PER path at full width (bf16
# Nature CNN, 84×84×4, batch 512, 1M-row ring, α = 0.6, n-step 3, Double
# DQN, the fused loss) with the plane on and the reference's gate on
# (stack_forwards=on): learn_start cut to 8,192 as in phase 11, 301 grad
# steps. Phase 13b: the Pong preset the same way under RMSProp.
LM_ARGV = BREAKOUT_ARGV[:-1] + ["train.total_steps=9392",
                                "replay.learn_start=8192",
                                "train.learn_metrics=true",
                                "train.stack_forwards=on"]
RMS_ARGV = PONG_ARGV[:-1] + ["train.total_steps=9392",
                             "replay.learn_start=8192",
                             "train.optimizer=rmsprop"]
CUT_GRAD_STEPS = (9392 - 8192) // 4 + 1
LEARN_GAUGES = ("learn/loss", "learn/grad_norm", "learn/grad_norm_clipped",
                "learn/q_mean", "learn/q_max", "learn/td_mean",
                "learn/td_max", "learn/prio_mean", "learn/prio_max",
                "learn/is_weight_mean", "learn/is_weight_min",
                "learn/target_refreshes", "learn/loss_nonfinite",
                "learn/steps")


@contextlib.contextmanager
def deterministic(torch):
    """cuDNN's deterministic algorithms and PyTorch's deterministic index
    writes (the priority scatter's duplicate rows), so two runs of one
    computation on the card give the same bits."""
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with cudnn_deterministic(torch):
            yield
    finally:
        torch.use_deterministic_algorithms(prev)


def ulps_apart(torch, a, b) -> int:
    """Largest distance in float32 units in the last place."""
    ia = a.float().cpu().view(torch.int32).long()
    ib = b.float().cpu().view(torch.int32).long()
    return int((ia - ib).abs().max())


def learn_plane_gate(torch, config, Solver, DevicePERFrameReplay,
                     learning) -> dict:
    """Phase 13's second half, from one filled replay at the Breakout
    preset: a chain-8 dispatch with the gate off and one with it on, from
    equal states (two solvers of one seed; the priorities, maxp and β
    counter put back between them), cuDNN and index writes deterministic:
    θ, θ⁻, the Adam state and the priorities bitwise equal. Then the card's
    plane against ``lm_update`` run on the CPU over the card's own per-step
    inputs. Then the dispatch timed with the gate off and on."""
    def solver_for(learn: bool):
        cfg = config.breakout_config()
        cfg.mesh.backend = "cuda"
        cfg.env.kind, cfg.env.id = "signal_atari", "signal"
        cfg.train.use_pallas_loss = True
        cfg.train.stack_forwards = "on"
        cfg.train.learn_metrics = learn
        return Solver(cfg)

    off, on = solver_for(False), solver_for(True)
    cfg = on.config
    replay = DevicePERFrameReplay(cfg.replay, on.device, (84, 84),
                                  cfg.env.stack, cfg.train.gamma,
                                  write_chunk=cfg.replay.write_chunk)
    fill_replay(replay, 30_000)
    saved = (replay.dstate["prio"].clone(), replay.dstate["maxp"].clone(),
             replay._samples)
    calls: list[dict] = []
    orig = learning.lm_update

    def recording(plane, **kw):
        calls.append({k: (v.detach().clone() if hasattr(v, "detach")
                          else v) for k, v in kw.items()})
        return orig(plane, **kw)

    with deterministic(torch):
        m_off = off.train_steps_device_per(replay, chain=8)
        prio_off = replay.dstate["prio"].clone()
        maxp_off = replay.dstate["maxp"].clone()
        replay.dstate["prio"].copy_(saved[0])
        replay.dstate["maxp"] = saved[1].clone()
        replay._samples = saved[2]
        learning.lm_update = recording
        try:
            m_on = on.train_steps_device_per(replay, chain=8)
        finally:
            learning.lm_update = orig
        torch.cuda.synchronize()
    diffs = train_state_diffs(torch, off, on)
    plane = m_on.pop("learn_plane")
    out = {"state_diffs": diffs,
           "prio_equal": tensors_equal(torch, prio_off,
                                       replay.dstate["prio"]),
           "maxp_equal": tensors_equal(torch, maxp_off,
                                       replay.dstate["maxp"]),
           "metrics_equal": all(tensors_equal(torch, m_off[k], m_on[k])
                                for k in m_off),
           "plane_calls": len(calls)}
    cpu = learning.lm_init("cpu")
    for kw in calls:
        learning.lm_update(cpu, **{k: (v.cpu() if hasattr(v, "cpu") else v)
                                   for k, v in kw.items()})
    card = plane.cpu().double().numpy()
    host = cpu.double().numpy()
    counts = list(range(learning.N_HIST)) + [
        learning.I_SAMPLES, learning.I_REFRESH, learning.I_NONFINITE,
        learning.I_STEPS]
    sums = [i for i in range(learning.N_HIST, learning._MAX)
            if i not in counts]
    ext = plane[learning._MAX:].cpu()
    ext_cpu = cpu[learning._MAX:]
    out.update({
        "counts_equal": bool((card[counts] == host[counts]).all()),
        "sums_max_rel_err": float(np.max(np.abs(card[sums] - host[sums])
                                         / np.maximum(np.abs(host[sums]),
                                                      1e-30))),
        # max |TD|, max Q, min IS weight, min |TD| bitwise; the max
        # priority is (|TD|+ε)^α, whose pow rounds its own way on each
        # device
        "extrema_bitwise": bool(torch.equal(ext[[0, 1, 3, 4]],
                                            ext_cpu[[0, 1, 3, 4]])),
        "prio_max_ulps": ulps_apart(torch, ext[2:3], ext_cpu[2:3]),
        "plane_steps": float(card[learning.I_STEPS]),
        "plane_samples": float(card[learning.I_SAMPLES]),
        "hist_total": float(card[:learning.N_HIST].sum())})
    # ms per chain-8 dispatch, off and on in turns (off, on, on, off)
    times = {"off": [], "on": []}
    for name, solver in (("off", off), ("on", on), ("on", on),
                         ("off", off)):
        ms, _ = time_chain(torch, solver, replay, 8, 16)
        times[name].append(8 * ms)
    ms_off, ms_on = min(times["off"]), min(times["on"])
    out.update({"ms_per_chain8_dispatch_gate_off": times["off"],
                "ms_per_chain8_dispatch_gate_on": times["on"],
                "learn_overhead_pct": 100.0 * (ms_on - ms_off) / ms_off})
    return out


def check_learn_plane_run(summary: dict, record: dict, launches: dict
                          ) -> dict:
    """Phase 13's CLI run: every ``learn/*`` gauge and the ``learn/td_error``
    summary in the last record; the plane's steps are the grad steps the
    record was logged at, its histogram holds every sample."""
    check_path(summary, CUT_GRAD_STEPS)
    missing = [k for k in LEARN_GAUGES if k not in record]
    assert not missing, f"learn gauges missing from the JSONL: {missing}"
    hist = {k: v for k, v in record.items()
            if k.startswith("learn/td_error")}
    assert "learn/td_error_count" in hist, sorted(record)
    assert record["learn/steps"] == record["step"], record
    assert hist["learn/td_error_count"] == 512 * record["learn/steps"], hist
    for name in ("gather_windows", "scatter_rows", "fused_loss_fwd",
                 "fused_loss_bwd"):
        assert launches[name] > 0, (name, launches)
    return hist


def rmsprop_cross_device(torch, config, Solver, DevicePERFrameReplay,
                         checkpoint) -> dict:
    """Phase 13b's card-vs-CPU step: the same small fused dispatch under
    RMSProp (float32, 52×52, batch 16, chain 1) from the same weights and
    data on the card and on the CPU — θ within 1e-6, ``mu``/``nu`` within
    1e-3 of each leaf's largest element. Then a checkpoint of the card's
    state restored into a fresh card solver, bitwise."""
    def build(backend):
        cfg = config.Config()
        cfg.mesh.backend = backend
        cfg.net = config.NetConfig(kind="nature_cnn", num_actions=4,
                                   frame_shape=(52, 52))
        cfg.replay = config.ReplayConfig(
            capacity=512, batch_size=16, n_step=2, prioritized=True,
            priority_alpha=0.0, device_per=True, write_chunk=16)
        cfg.train = config.TrainConfig(lr=1e-4, double_dqn=True,
                                       target_update_period=2,
                                       optimizer="rmsprop")
        s = Solver(cfg)
        r = DevicePERFrameReplay(cfg.replay, s.device, (52, 52), 4, 0.99,
                                 write_chunk=16)
        rng = np.random.default_rng(3)
        for i in range(600):
            r.add(rng.integers(0, 256, (52, 52), dtype=np.uint8),
                  int(rng.integers(4)), float(rng.standard_normal()),
                  i % 11 == 10)
        m = s.train_step_device_per(r)
        return s, m

    (sg, mg), (sc, mc) = build("cuda"), build("cpu")
    dtheta = max(float((a.detach().cpu() - b.detach()).abs().max())
                 for a, b in zip(
                     list(sg.state.net.parameters())
                     + list(sg.state.target_net.parameters()),
                     list(sc.state.net.parameters())
                     + list(sc.state.target_net.parameters())))
    moment_err = 0.0
    for key in ("mu", "nu"):
        for name, t in sc.state.opt_state[key].items():
            g = sg.state.opt_state[key][name].cpu()
            scale = float(t.abs().max()) or 1.0
            moment_err = max(moment_err, float((g - t).abs().max()) / scale)
    ckdir = os.path.join(OUT_DIR, "ckpt_13b")
    shutil.rmtree(ckdir, ignore_errors=True)
    ck = checkpoint.Checkpointer(ckdir)
    ck.save(sg.state, wait=True)
    fresh = Solver(sg.config)
    ck.restore(fresh.state)
    return {"loss_cuda": float(mg["loss"]), "loss_cpu": float(mc["loss"]),
            "max_abs_dtheta": dtheta,
            "moments_max_err_over_leaf_max": moment_err,
            "restore_diffs": train_state_diffs(torch, sg, fresh),
            "optimizer": fresh.state.opt_state["name"]}


# Phase 14, the pin: the reference test's configuration (tests/test_anakin.py:
# 16 envs, 10×10×2 signal frames, MLP 32×32, batch 16, chain 2, 8 ticks,
# capacity 256) on the card, one shard.
def anakin_pin_config(config, capacity=256, lr=None):
    cfg = config.Config(
        env=config.EnvConfig(id="signal", kind="signal_atari",
                             frame_shape=(10, 10), stack=2),
        net=config.NetConfig(kind="mlp", num_actions=4, hidden=(32, 32),
                             frame_shape=(10, 10), stack=2),
        replay=config.ReplayConfig(capacity=capacity, batch_size=16,
                                   fused_chain=2, n_step=1, learn_start=0,
                                   device_resident=True, write_chunk=32,
                                   prioritized=True, device_per=True),
        train=config.TrainConfig(optimizer="adam", seed=3,
                                 stack_forwards="on"),
        actors=config.ActorConfig(anakin_envs=16, anakin_ticks=8),
        mesh=config.MeshConfig(backend="cuda"))
    if lr is not None:
        cfg.train.lr = lr
    return cfg


def anakin_host_twin(torch, cfg, supersteps, Solver, DevicePERFrameReplay,
                     anakin, threefry, make_device_env, actor_epsilon):
    """The superstep driven from the host on the card: the batched
    ``act_tick`` one tick at a time over all envs, the rows through
    ``add_batch(stream=g)``, then ``train_steps_device_per``."""
    n, ticks = cfg.actors.anakin_envs, cfg.actors.anakin_ticks
    h, w = cfg.env.frame_shape
    stack = cfg.env.stack
    solver = Solver(cfg, obs_dim=h * w * stack)
    dev, d = solver.device, solver.num_shards
    replay = DevicePERFrameReplay(cfg.replay, dev, (h, w), stack,
                                  cfg.train.gamma, seed=cfg.train.seed,
                                  write_chunk=cfg.replay.write_chunk,
                                  num_streams=n, num_shards=d)
    reset_fn, step_fn = make_device_env(cfg.env)
    base = threefry.prng_key(cfg.train.seed, dev)
    # with D shards the env at position p = s·E + e is stream e·D + s
    gids = [(p % (n // d)) * d + p // (n // d) for p in range(n)]
    g = torch.tensor(gids, device=dev)
    st, frames = reset_fn(threefry.fold_in(base, 1000 * (g + 1)))
    buf = torch.zeros((n, stack, h * w), dtype=torch.uint8, device=dev)
    buf[:, -1] = frames.reshape(n, -1)
    akeys = threefry.fold_in(base, 7777 * (g + 1))
    eps = torch.tensor([actor_epsilon(i, n, cfg.actors.eps_base,
                                      cfg.actors.eps_alpha)
                        for i in gids], dtype=torch.float32, device=dev)
    for _ in range(supersteps):
        recs = []
        for _t in range(ticks):
            st, buf, akeys, rec = anakin.act_tick(
                solver.state.net, step_fn, (h, w), eps, st, buf, akeys)
            recs.append({k: v.cpu().numpy() for k, v in rec.items()})
        for s in range(n):
            done = np.array([r["done"][s] for r in recs], bool)
            replay.add_batch({
                "frame": np.stack([r["frame"][s].reshape(h, w)
                                   for r in recs]),
                "action": np.array([r["action"][s] for r in recs], np.int64),
                "reward": np.array([r["reward"][s] for r in recs],
                                   np.float32),
                "done": done, "boundary": done}, stream=gids[s])
        solver.train_steps_device_per(replay, cfg.replay.fused_chain)
    return solver, replay


def anakin_pin(torch, config, modules, dp: int = 1) -> dict:
    """Phase 14's pin (15d at ``dp`` = 8 shards): three supersteps against
    the host twin, bitwise (every shard's real and ghost ring rows, action,
    reward, done, boundary, priority and maxp, θ and θ⁻); then, at one
    shard, 40 supersteps at lr 3e-3 through ``run_anakin`` must give
    act_reward > 0.30."""
    (Solver, DevicePERFrameReplay, anakin, threefry, make_device_env,
     actor_epsilon) = modules
    cfg = anakin_pin_config(config)
    cfg.mesh.dp = dp
    with deterministic(torch):
        runner = anakin.AnakinRunner(cfg)
        for _ in range(3):
            runner.superstep()
        runner.sync_solver()
        solver, replay = anakin_host_twin(
            torch, cfg, 3, Solver, DevicePERFrameReplay, anakin, threefry,
            make_device_env, actor_epsilon)
        torch.cuda.synchronize()
    rp = runner.replay
    a, h = rp.dstate, replay.dstate
    real = rp.cap_local_pad     # each shard's rows but its scratch row
    shape = (rp.num_shards, rp.shard_rows, rp.rowp)
    diffs = [] if tensors_equal(
        torch, a["frames"].view(shape)[:, :real],
        h["frames"].view(shape)[:, :real]) else ["frames"]
    diffs += [f for f in ("action", "reward", "done", "boundary", "prio",
                          "maxp") if not tensors_equal(torch, a[f], h[f])]
    diffs += train_state_diffs(torch, runner.solver, solver)
    if dp > 1:
        return {"pin_diffs": diffs, "grad_steps": int(solver.state.step),
                "shards": rp.num_shards, "envs_per_shard":
                    runner.envs_per_shard}
    t0 = time.perf_counter()
    out = anakin.run_anakin(anakin_pin_config(config, 2048, 3e-3), 40)
    smoke_s = time.perf_counter() - t0
    return {"pin_diffs": diffs, "grad_steps": int(solver.state.step),
            "act_reward_40": out["act_reward"],
            "loss_40": out["loss"].tolist(), "smoke_wall_s": smoke_s}


# Phase 14 at full width: the Pong preset's geometry (bf16 Nature CNN at
# 84×84×4, batch 512, 1M-row ring = 8.19 GB, α = 0, chain 8, the fused
# loss) on signal_atari, 64 envs × 16 ticks = 1,024 env steps and 8 grad
# steps per superstep; 30 supersteps, the first 5 of them warm-up and 10
# under the sync check (300 until phase 16 came, 200 until phase 17 came,
# 80, 60 and then 40 beside phase 18, with 20 and 20 and 2 profiled, then
# 10 warm-up: cut to keep the whole run well inside its limit)
ANAKIN_ENVS, ANAKIN_TICKS, ANAKIN_SUPERSTEPS = 64, 16, 30
ANAKIN_WARM, ANAKIN_SYNC_CHECKED = 5, 10
ANAKIN_PROFILED = 1     # ~38,000 launches for the profiler


def anakin_full_config(config):
    cfg = config.pong_config()
    cfg.mesh.backend = "cuda"
    cfg.env.kind, cfg.env.id = "signal_atari", "signal"
    cfg.net.num_actions = 4
    cfg.train.use_pallas_loss = True
    cfg.actors.anakin_envs = ANAKIN_ENVS
    cfg.actors.anakin_ticks = ANAKIN_TICKS
    return cfg


def _subtree_kernels(ev) -> tuple[int, float]:
    """(kernel launches, their device µs) under a profiler event."""
    n = len(ev.kernels)
    us = sum(k.duration for k in ev.kernels)
    for c in ev.cpu_children:
        cn, cus = _subtree_kernels(c)
        n, us = n + cn, us + cus
    return n, us


def anakin_full(torch, config, counters, modules, make_env, train_mod
                ) -> dict:
    """Phase 14 at full width through ``run_anakin``'s runner: the counts
    set to 0 just before the supersteps and read just after; a window of
    supersteps under ``torch.cuda.set_sync_debug_mode("warn")`` must raise
    no synchronizing call (nothing read back inside a superstep); a
    ``torch.profiler`` window gives the act / insert / sample / train
    stages, launches per superstep and the threefry share of them, and B1
    and B2's device time per launch at these shapes; then the synced
    solver's greedy eval beside the random policy's."""
    import warnings

    from torch.profiler import ProfilerActivity, profile, record_function

    anakin, threefry = modules
    cfg = anakin_full_config(config)
    runner = anakin.AnakinRunner(cfg)
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warm = ANAKIN_WARM
    for _ in range(warm):
        runner.superstep()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    syncs = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(ANAKIN_SYNC_CHECKED):
                runner.superstep()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        # each synchronizing call warns "called a synchronizing CUDA
        # operation"; the mode's own prototype notice is not one
        syncs = [str(w.message)[:200] for w in caught
                 if "called a synchronizing" in str(w.message)]
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    ev0.record()
    timed = ANAKIN_SUPERSTEPS - warm - ANAKIN_SYNC_CHECKED - ANAKIN_PROFILED
    t2 = time.perf_counter()
    for _ in range(timed):
        runner.superstep()
    ev1.record()
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    device_ms = ev0.elapsed_time(ev1) / timed
    wall_s = t3 - t2
    # the profiler window: each stage and threefry under a named range
    stages = {"act": ("_act", runner), "insert": ("_insert", runner)}
    saved = {}

    def ranged(name, fn):
        def inner(*a, **kw):
            with record_function(f"anakin/{name}"):
                return fn(*a, **kw)
        return inner

    for name, (attr, obj) in stages.items():
        saved[(obj, attr)] = getattr(obj, attr)
        setattr(obj, attr, ranged(name, getattr(obj, attr)))
    saved[(anakin, "fused_sample")] = anakin.fused_sample
    anakin.fused_sample = ranged("sample", anakin.fused_sample)
    learner = runner.solver.learner
    saved[(learner, "_train_chain")] = learner._train_chain
    learner._train_chain = ranged("train", learner._train_chain)
    saved[(threefry, "threefry2x32")] = threefry.threefry2x32
    threefry.threefry2x32 = ranged("threefry", threefry.threefry2x32)
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            tp = time.perf_counter()
            for _ in range(ANAKIN_PROFILED):
                runner.superstep()
            torch.cuda.synchronize()
            prof_wall_ms = 1e3 * (time.perf_counter() - tp)
    finally:
        for (obj, attr), fn in saved.items():
            if obj is runner or obj is learner:
                delattr(obj, attr)     # back to the class's method
            else:
                setattr(obj, attr, fn)
    launches = {name: fn.launches for name, fn in counters.items()}
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    events = prof.events()
    stage_ms, stage_host_ms, stage_launches = {}, {}, {}
    for name in ("act", "insert", "sample", "train", "threefry"):
        hits = [e for e in events if e.name == f"anakin/{name}"
                and e.device_type == torch.autograd.DeviceType.CPU]
        n_us = [_subtree_kernels(e) for e in hits]
        stage_launches[name] = sum(n for n, _ in n_us) / ANAKIN_PROFILED
        stage_ms[name] = sum(us for _, us in n_us) / 1e3 / ANAKIN_PROFILED
        stage_host_ms[name] = sum(e.cpu_time_total for e in hits) / 1e3 \
            / ANAKIN_PROFILED
    census = profiling_census(torch, prof, prof_wall_ms)
    all_launches = census["kernel_launches"] / ANAKIN_PROFILED
    steps = runner.supersteps_run
    assert steps == ANAKIN_SUPERSTEPS, steps
    state = runner.sync_solver()
    ret = train_mod.evaluate(runner.solver, cfg)
    random_ret = random_policy_return(make_env, cfg.env,
                                      cfg.train.eval_episodes)
    metrics = {k: v.float().cpu().numpy().tolist()
               for k, v in runner.last_metrics.items()}
    return {
        "supersteps": steps, "grad_steps": int(state.step),
        "env_steps": runner.env_steps,
        "launches": launches, "sync_warnings": syncs,
        "env_steps_per_s": timed * ANAKIN_TICKS * ANAKIN_ENVS / wall_s,
        "grad_steps_per_s": timed * runner.chain / wall_s,
        "ms_per_superstep_device": device_ms,
        "ms_per_superstep_wall": 1e3 * wall_s / timed,
        "profiled_supersteps": ANAKIN_PROFILED,
        "profiled_wall_ms_per_superstep": prof_wall_ms / ANAKIN_PROFILED,
        "stage_device_ms": stage_ms, "stage_launches": stage_launches,
        "stage_host_ms_in_profiled_window": stage_host_ms,
        "launches_per_superstep": all_launches,
        "threefry_share_of_launches":
            stage_launches["threefry"] / max(all_launches, 1e-9),
        "device_busy_share": census["device_ms"] / max(prof_wall_ms, 1e-9),
        "port_kernels": census["port_kernels"],
        "act_reward": float(runner.last_act_reward),
        "last_loss": metrics["loss"], "eval_return": ret,
        "random_policy_return": random_ret, "wall_s": total_s,
        "warm_supersteps_s": t1 - t0}


def profiling_census(torch, prof, wall_ms: float) -> dict:
    """Kernel launches, their device ms and the port's kernels' device
    time per launch in a finished profile."""
    # the device-side copies of the anakin/* ranges are annotations, not
    # kernels
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith("anakin/")]
    ours = {}
    for name in ("gather_windows", "scatter_rows", "fused_loss_fwd",
                 "fused_loss_bwd"):
        hits = [e for e in kernels if f"{name}_kernel" in e.key]
        count = sum(e.count for e in hits)
        if count:
            ours[name] = {"launches": count, "us_per_launch": sum(
                e.self_device_time_total for e in hits) / count}
    return {"kernel_launches": sum(e.count for e in kernels),
            "device_ms": sum(e.self_device_time_total for e in kernels) / 1e3,
            "port_kernels": ours}


def anakin_kernel_shapes(torch, rg, dev, empty_ms: float) -> dict:
    """B2 at the superstep's insert shape (2·T·E = 2,048 lanes: 1,024 main
    rows, ghost lanes real only where local < window − 1, the rest on the
    scratch row) on a 1M-row ring laid out as the superstep's (64 sub-rings
    of 15,625 + 4 ghost rows), bitwise against the plain version, timed
    beside the byte bound, the plain version and ``index_copy_``."""
    subs, slot_cap, window = ANAKIN_ENVS, 1_000_000 // ANAKIN_ENVS, WINDOW
    slot_pad = slot_cap + window - 1
    scratch = subs * slot_pad
    rows = scratch + 1
    rowp = ROWB // 4
    ring = torch.zeros(rows * rowp, dtype=torch.int32, device=dev)
    k = ANAKIN_ENVS * ANAKIN_TICKS
    gen = torch.Generator(device=dev).manual_seed(1)
    staged = torch.randint(-2**31, 2**31 - 1, (k * rowp,), dtype=torch.int32,
                           device=dev, generator=gen)
    # a superstep that starts at cursor 0: every ghost lane is real for
    # local < window - 1 = 4, the rest aim at the scratch row
    t_i = torch.arange(ANAKIN_TICKS, device=dev)[:, None]
    e_i = torch.arange(subs, device=dev)[None, :]
    local = t_i.expand(-1, subs)
    main = (e_i * slot_pad + local).reshape(-1)
    ghost = torch.where(local < window - 1, e_i * slot_pad + slot_cap + local,
                        torch.full_like(local, scratch)).reshape(-1)
    didx = torch.cat([main, ghost]).to(torch.int32)
    sidx = torch.arange(k, dtype=torch.int32, device=dev).repeat(2)
    real = int((didx != scratch).sum())
    plain_ring = ring.clone()
    rg.scatter_rows(sidx, didx, staged, ring, n=2 * k, rowb=ROWB,
                    skip_row=scratch)
    rg.scatter_rows_plain(sidx, didx, staged, plain_ring, n=2 * k, rowb=ROWB)
    ok = bool(torch.equal(ring.view(rows, rowp)[:scratch],
                          plain_ring.view(rows, rowp)[:scratch]))
    del plain_ring
    kernel_ms, host_ms = time_ms(torch, lambda i: rg.scatter_rows(
        sidx, didx, staged, ring, n=2 * k, rowb=ROWB, skip_row=scratch))
    plain_ms = time_ms(torch, lambda i: rg.scatter_rows_plain(
        sidx, didx, staged, ring, n=2 * k, rowb=ROWB))[0]
    keep = didx != scratch
    dst_l, src_l = didx[keep].long(), sidx[keep].long()
    ring2 = ring.view(rows, rowp)
    st2 = staged.view(k, rowp)
    lib_ms = time_ms(torch, lambda i: ring2.index_copy_(
        0, dst_l, st2.index_select(0, src_l)))[0]
    # bytes the data needs: each staged row read once (a ghost lane re-sends
    # its main lane's row), each real lane's ring row written once, and the
    # two index arrays
    nbytes = (k + real) * ROWB + 2 * 4 * 2 * k
    out = {"lanes": 2 * k, "real_lanes": real, "max_abs_err": 0 if ok else 1,
           "ms": kernel_ms, "host_ms": host_ms, "plain_ms": plain_ms,
           "library_ms": lib_ms, "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S,
           "empty_kernel_ms": empty_ms}
    del ring, ring2, staged
    return out


# -- phase 15: the sharded ring, mesh.dp = 8 ----------------------------------

# 15a: the Pong preset at full width with mesh.dp=8: bf16 Nature CNN, batch
# 512 (64 per shard), the uncut 1M-row ring as 8 shards of 125,000 rows,
# device PER α = 0, chain 8; cuts: learn_start 8,192 (as in phases 11-13)
# and the depth, 201 grad steps
D8 = 8
D8_ARGV = PONG_ARGV[:-1] + ["train.total_steps=8992",
                            "replay.learn_start=8192", f"mesh.dp={D8}"]
D8_GRAD_STEPS = (8992 - 8192) // 4 + 1
# the Pong ring at D = 8: each shard one sub-ring of 125,000 rows + 4
# ghost rows + its scratch row
D8_SLOT_CAP = 1_000_000 // D8
PONG_STACK = 4                    # WINDOW = stack 4 + n_step 1
D8_SLOT_PAD = D8_SLOT_CAP + WINDOW - 1
D8_SHARD_ROWS = D8_SLOT_PAD + 1


LOOP_KEYS = ("grad_steps_per_s", "time_dispatch_ms", "time_step_ms")


def sharded_main_path(torch, cli_main, counters, train_mod) -> dict:
    """15a: ``main train --preset pong --backend cuda --set mesh.dp=8`` in
    process, its launches counted; the solver and the replay it built kept
    (through ``restore_for_resume``, which the loop calls with both), and a
    ``launch_census`` of 4 chain-8 dispatches on them; its loop rate and
    ``StepTimer`` phases from its last metrics record. (The same loop at
    ``mesh.dp=1`` ran in turns beside it until phase 18 came: cut to keep
    the whole run inside its limit; ``shard_cost`` keeps the D = 1 and
    D = 8 dispatch in turns.)"""
    with capturing(train_mod, "restore_for_resume",
                   lambda args, out: args[1:3]) as pairs:
        summary, launches, record = run_cli(cli_main, counters, D8_ARGV,
                                            "chip_smoke_pong_d8.jsonl")
    (solver, replay), = pairs
    census = trace_dispatches(torch, solver, replay, 8, 4)
    return {"summary": summary, "launches": launches, "record": record,
            "solver": solver, "replay": replay,
            "shards": [solver.num_shards, replay.num_shards,
                       replay.subs_per_shard, replay.slot_cap],
            "census": census,
            "loop": {k: record[k] for k in LOOP_KEYS}}


def shard_cost(torch, config, Solver, DevicePERFrameReplay) -> dict:
    """What the shard axis costs the learner: phase 5's chain-8 dispatch
    (the Pong preset, plain loss, the 1M-row ring filled with 30,000 rows)
    at D = 1 and at D = 8, two solvers and replays from the same weights
    and rows, timed in turns (1, 8, 8, 1): ms per grad step, host clock to
    a synchronize."""
    pairs = {}
    for d in (1, D8):
        cfg = config.pong_config()
        cfg.mesh.backend, cfg.mesh.dp = "cuda", d
        cfg.env.kind, cfg.env.id = "signal_atari", "signal"
        cfg.net.num_actions = 4
        s = Solver(cfg)
        r = DevicePERFrameReplay(cfg.replay, s.device, (84, 84),
                                 cfg.env.stack, cfg.train.gamma,
                                 write_chunk=cfg.replay.write_chunk,
                                 num_shards=d)
        fill_replay(r, 30_000)
        pairs[d] = (s, r)
    times: dict[int, list[float]] = {1: [], D8: []}
    for d in (1, D8, D8, 1):
        times[d].append(time_chain(torch, *pairs[d], 8, 24)[0])
    del pairs
    return {"d1_ms_per_grad_step": times[1],
            "d8_ms_per_grad_step": times[D8]}


def sharded_cross_device_check(torch, config, Solver, DevicePERFrameReplay,
                               learner_mod) -> dict:
    """15a's card-vs-CPU check at D = 8 on a small ring (float32, 52×52,
    batch 16 = 2 per shard, 1,024 rows in 8 shards, chain 3), the same
    weights and rows on both, no uniforms injected: every fused dispatch's
    sampled rows, window starts, B1 windows, metadata and IS weights
    bitwise, and the ring bytes (each shard's scratch row left out) and
    priorities after it. Twice: 8 streams filled alike (equal shard
    masses) and 1 stream (unequal): there the weights' ``pow`` may round
    its own way on each device, so they are held within 2 ulp and the
    largest difference printed."""
    def build(backend, streams):
        cfg = config.Config()
        cfg.mesh.backend, cfg.mesh.dp = backend, D8
        cfg.net = config.NetConfig(kind="nature_cnn", num_actions=4,
                                   frame_shape=(52, 52))
        cfg.replay = config.ReplayConfig(
            capacity=1024, batch_size=16, n_step=2, prioritized=True,
            priority_alpha=0.0, device_per=True, write_chunk=16)
        cfg.train = config.TrainConfig(lr=1e-4, double_dqn=True,
                                       target_update_period=2)
        s = Solver(cfg)
        r = DevicePERFrameReplay(cfg.replay, s.device, (52, 52), 4, 0.99,
                                 write_chunk=16, num_streams=streams,
                                 num_shards=D8)
        rng = np.random.default_rng(3)
        for c in range(96 if streams > 1 else 40):
            # 8 streams: 13-row episodes, 12 to a shard (every shard full);
            # 1 stream: 7- to 17-row episodes, one shard after the other,
            # 465 rows in all (the shards' fills and masses differ)
            n = 13 if streams > 1 else 7 + (5 * c) % 11
            done = np.zeros(n, bool)
            done[-1] = True
            r.add_batch({
                "frame": rng.integers(0, 256, (n, 52, 52), dtype=np.uint8),
                "action": rng.integers(0, 4, n).astype(np.int32),
                "reward": rng.standard_normal(n).astype(np.float32),
                "done": done}, stream=c % streams)
        return s, r

    def keep(args, res):
        metas, win, idx, ws = res
        return {"idx": idx.cpu(), "ws": ws.cpu(), "win": win.cpu(),
                **{f"meta_{k}": v.cpu() for k, v in metas.items()}}

    out = {}
    for streams in (D8, 1):
        pairs = [build(b, streams) for b in ("cuda", "cpu")]
        with capturing(learner_mod, "fused_sample", keep) as calls:
            for s, r in pairs:
                s.train_steps_device_per(r, chain=3)
        card, cpu = calls
        (_, rg_), (_, rc) = pairs
        shape = (D8, rc.shard_rows, rc.rowp)
        w_ulps = int((card["meta_weight"].view(torch.int32).long()
                      - cpu["meta_weight"].view(torch.int32).long())
                     .abs().max())
        out[f"streams_{streams}"] = {
            "sizes": rc.device_inputs()[1].tolist(),
            "diffs": [k for k in card if k != "meta_weight"
                      and not torch.equal(card[k], cpu[k])],
            "weight_max_ulps": w_ulps,
            "weights_all_one": bool((card["meta_weight"] == 1).all()),
            "ring_equal": tensors_equal(
                torch, rg_.dstate["frames"].view(shape)[:, :-1],
                rc.dstate["frames"].view(shape)[:, :-1]),
            "prio_equal": tensors_equal(torch, rg_.dstate["prio"],
                                        rc.dstate["prio"]),
            "sampled_rows": int(card["idx"].numel())}
    return out


def check_sharded_cross(out: dict) -> None:
    for key, o in out.items():
        assert not o["diffs"], (key, o)
        assert o["ring_equal"] and o["prio_equal"], (key, o)
    assert out[f"streams_{D8}"]["weight_max_ulps"] == 0, out
    assert out["streams_1"]["weight_max_ulps"] <= 2, out


def _gather_row(torch, rg, ring, idx_sets, n: int, w: int = WINDOW,
                rowb: int = ROWB) -> dict:
    """B1 at one shape: the first index set against the plain version
    (bitwise), then all 8 cycled (cold windows) for the kernel, the plain
    version and ``index_select``, device and host ms."""
    dev = ring.device
    idx = idx_sets[0]
    got = rg.gather_windows(idx, ring, n=n, w=w, rowb=rowb)
    want = rg.gather_windows_plain(idx, ring, n=n, w=w, rowb=rowb)
    torch.cuda.synchronize()
    err = max_abs_err(torch, got, want)
    del got, want
    ring2d = ring.view(-1, rowb // 4)
    lib_rows = [(i.long()[:, None] + torch.arange(w, device=dev)
                 ).reshape(-1) for i in idx_sets]
    ms, host_ms = time_ms(torch, lambda i: rg.gather_windows(
        idx_sets[i % 8], ring, n=n, w=w, rowb=rowb))
    plain_ms = time_ms(torch, lambda i: rg.gather_windows_plain(
        idx_sets[i % 8], ring, n=n, w=w, rowb=rowb))[0]
    library_ms = time_ms(torch, lambda i: torch.index_select(
        ring2d, 0, lib_rows[i % 8]))[0]
    nbytes = n * 4 + 2 * n * w * rowb
    return {"n": n, "max_abs_err": err, "ms": ms, "host_ms": host_ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bytes": nbytes, "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S}


def _scatter_row(torch, rg, ring, shards: int, skip: int) -> dict:
    """B2 at a pre-dispatch flush over ``shards`` shards: each shard's 64
    main lanes (4 real: the rows staged since the last flush, at its row
    100,000) and 64 ghost lanes (all padding), one launch,
    padding aimed at ``skip``, as ``DevicePERFrameReplay._apply_write``
    builds it; against the plain version (bitwise but the skip row, which
    the kernel leaves), then timed beside ``index_copy_``."""
    dev, rowp, k, real = ring.device, ROWB // 4, 64, 4
    gen = torch.Generator(device=dev).manual_seed(shards)
    staged = torch.randint(-2**31, 2**31 - 1, (shards * k * rowp,),
                           dtype=torch.int32, device=dev, generator=gen)
    main = torch.full((shards, k), skip, dtype=torch.int32, device=dev)
    base = torch.arange(shards, device=dev)[:, None] * D8_SHARD_ROWS
    main[:, :real] = (base + 100_000 + torch.arange(real, device=dev)
                      ).to(torch.int32)
    ghost = torch.full_like(main, skip)
    src = torch.arange(shards * k, dtype=torch.int32,
                       device=dev).view(shards, k).repeat(1, 2).reshape(-1)
    dst = torch.cat([main, ghost], dim=1).reshape(-1)
    n = 2 * k * shards
    plain = ring.clone()
    skip_row = ring.view(-1, rowp)[skip].clone()
    rg.scatter_rows(src, dst, staged, ring, n=n, rowb=ROWB, skip_row=skip)
    rg.scatter_rows_plain(src, dst, staged, plain, n=n, rowb=ROWB)
    torch.cuda.synchronize()
    r2, p2 = ring.view(-1, rowp), plain.view(-1, rowp)
    err = max(max_abs_err(torch, r2[:skip], p2[:skip]),
              max_abs_err(torch, r2[skip + 1:], p2[skip + 1:]))
    kept = bool(torch.equal(r2[skip], skip_row))
    del plain, p2
    torch.cuda.empty_cache()
    to_ring = dst != skip
    dst_l = dst[to_ring].long()
    rows_src = staged.view(-1, rowp)[src[to_ring].long()]
    ms, host_ms = time_ms(torch, lambda i: rg.scatter_rows(
        src, dst, staged, ring, n=n, rowb=ROWB, skip_row=skip))
    plain_ms = time_ms(torch, lambda i: rg.scatter_rows_plain(
        src, dst, staged, ring, n=n, rowb=ROWB))[0]
    library_ms = time_ms(torch, lambda i: r2.index_copy_(
        0, dst_l, rows_src))[0]
    n_real = int(to_ring.sum())
    nbytes = 2 * n_real * ROWB + 2 * n * 4
    return {"shards": shards, "lanes": n, "real_lanes": n_real,
            "max_abs_err": err, "skip_row_kept": kept, "ms": ms,
            "host_ms": host_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bytes": nbytes,
            "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S}


def sharded_ring_kernels(torch, rg, dev, empty_ms: float) -> dict:
    """15b: B1 and B2 at the D = 8 shapes on a ring of the D = 8 Pong
    geometry (8 × 125,005 rows × 8192 B = 8.19 GB), each bitwise against
    its plain version and timed beside the D = 1 shape on the same ring:
    B1's chain-8 draw (n = 4096: 512 windows in each shard, from each
    shard's own rows, against 4096 anywhere in the first 1,000,000), B2's
    pre-dispatch flush of 8 shards in one launch (1,024 lanes, 32 real)
    against one shard's (128 lanes, 4 real)."""
    rowp = ROWB // 4
    rows = D8 * D8_SHARD_ROWS
    gen = torch.Generator(device=dev).manual_seed(15)
    ring = torch.randint(-2**31, 2**31 - 1, (rows * rowp,),
                         dtype=torch.int32, device=dev, generator=gen)
    n = 4096
    shard = torch.arange(n, device=dev) // (n // D8)

    def d8_starts():
        local = torch.randint(0, D8_SLOT_CAP, (n,), device=dev,
                              generator=gen)
        return (shard * D8_SHARD_ROWS + (local - (PONG_STACK - 1))
                % D8_SLOT_CAP).to(torch.int32)

    d8_sets = [d8_starts() for _ in range(8)]
    d8_sets[0][n // D8 - 1] = D8_SLOT_CAP - 1     # a shard's last window
    d1_sets = [torch.randint(0, SLOT_CAP, (n,), dtype=torch.int32,
                             device=dev, generator=gen) for _ in range(8)]
    out = {"ring_GB": ring.numel() * 4 / 1e9, "empty_kernel_ms": empty_ms,
           "gather_d8": _gather_row(torch, rg, ring, d8_sets, n),
           "gather_d1": _gather_row(torch, rg, ring, d1_sets, n),
           "scatter_d8": _scatter_row(torch, rg, ring, D8, D8_SLOT_PAD),
           "scatter_d1": _scatter_row(torch, rg, ring, 1, D8_SLOT_PAD)}
    del ring
    torch.cuda.empty_cache()
    return out


def check_sharded_kernels(out: dict) -> None:
    for key in ("gather_d8", "gather_d1", "scatter_d8", "scatter_d1"):
        assert out[key]["max_abs_err"] == 0, (key, out[key])
    for key in ("scatter_d8", "scatter_d1"):
        assert out[key]["skip_row_kept"], (key, out[key])


def sharded_resume(torch, persistence, train_mod, learner_mod, solver,
                   replay) -> dict:
    """15c: 15a's replay saved at D = 8 (its 8.19 GB frame plane and
    metadata), loaded into a fresh D = 8 replay on the card; the device
    planes, the cursors and sizes, β's counter and every slot's host
    metadata equal, and the next sampled rows, window starts, B1 windows,
    metadata and IS weights of both (the same keys and β) bitwise. Save and
    load seconds (host clock, the load ending in a synchronize) and the
    file's size."""
    d = os.path.join(OUT_DIR, "pong_d8")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    npz = os.path.join(d, "replay.npz")
    cfg = solver.config
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    persistence.save_replay(replay, npz)
    save_s = time.perf_counter() - t0
    size_gb = os.path.getsize(npz) / 1e9
    fresh = train_mod.make_replay(cfg, train_mod.make_env(cfg.env),
                                  solver.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    persistence.load_replay(fresh, npz)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    shutil.rmtree(d)
    diffs = [k for k in replay.dstate
             if not tensors_equal(torch, replay.dstate[k], fresh.dstate[k])]
    for a, b, name in ((replay.device_inputs(), fresh.device_inputs(),
                        "cursors/sizes"),
                       ([replay._samples, replay._stream_pos],
                        [fresh._samples, fresh._stream_pos], "counters")):
        if not all(np.array_equal(x, y) for x, y in zip(a, b)):
            diffs.append(name)
    for i, (m, f) in enumerate(zip(replay.slots, fresh.slots)):
        if not all(np.array_equal(getattr(m, k), getattr(f, k))
                   for k in ("action", "reward", "done", "boundary")) \
                or (m._cursor, len(m)) != (f._cursor, len(f)):
            diffs.append(f"slot{i}")
    from distributed_deep_q_tpu_torch.replay.device_per import (
        uniforms_for_keys)
    from distributed_deep_q_tpu_torch.solver import (
        fused_spec, sample_key_schedule)
    spec = fused_spec(cfg, replay)
    keys = sample_key_schedule(cfg.train.seed, solver.step, D8, 8)
    u = uniforms_for_keys(keys.reshape(-1, 2), spec[8], solver.device)
    betas = torch.full((8,), 0.5, device=solver.device)
    draws = []
    for r in (replay, fresh):
        cursors, sizes = (torch.from_numpy(a).to(solver.device)
                          for a in r.device_inputs())
        metas, win, idx, ws = learner_mod.fused_sample(
            r.dstate, cursors, sizes, betas, u, spec)
        draws.append({"idx": idx, "ws": ws, "win": win, **{
            f"meta_{k}": v for k, v in metas.items()}})
    a, b = draws
    sample_diffs = [k for k in a if not torch.equal(a[k], b[k])]
    out = {"save_s": save_s, "load_s": load_s, "replay_file_GB": size_gb,
           "state_diffs": diffs, "sample_diffs": sample_diffs,
           "sampled_rows": int(a["idx"].numel()),
           "shards_sampled": int(torch.unique(
               a["idx"].long() // replay.cap_local).numel())}
    del fresh, draws, a, b
    return out



# -- phase 16: two learner processes on the one card -------------------------

# 16a: the Pong preset's geometry (bf16 Nature CNN 84×84×4, batch 512,
# chain 8, α = 0) on a 131,072-row ring of D = 2 shards, each shard's one
# slot filled with rows keyed by its global slot (so the ring is the same in
# either layout); 8 chain-8 dispatches at 2 processes × 1 shard and at 1
# process × 2 shards, cuDNN deterministic
P16_RING, P16_ROWS_PER_SLOT = 131_072, 12_000
P16_DISPATCHES, P16_CHAIN = 8, 8
# θ at 2 processes against 1 process after the 64 grad steps: the
# forwards run in bf16 and cuDNN picks its algorithm per batch shape (256
# rows against 512), so the gradients differ in their low bits, and Adam,
# which normalizes each element, turns that into up to ~lr per step where
# a gradient is small. Measured 3.13e-4 on an H100 80GB HBM3 at 700 W
# (PERF.md §6, phase 16); the bound keeps a 3x margin (2·lr·64 = 8e-3 is
# Adam's own worst case)
P16_THETA_TOL = 1e-3
# Adam's first moment at 2 processes against 1 process, as
# max|Δμ| / max|μ|: μ is linear in the gradient, so a wrong mean over the
# processes (a sum, or B3/B4 dividing by the global batch) moves it by
# about 1, where θ, which Adam normalizes, barely moves. Measured 0.062
# on an H100 80GB HBM3 at 700 W; a planted sum in place of the mean read
# 1.30 and a planted division by the global batch 0.735, with θ inside
# P16_THETA_TOL in both (PERF.md §6, phase 16): the bound sits 4x above
# the first reading and 2.9x below the nearest fault
P16_MU_TOL = 0.25
P16_TIMEOUT_S = 420
# 16b: each process's padded frame ring, one shard of D = 2 (what 16b's
# replay allocates): 2 sub-rings of 250,000 rows + 4 ghost rows, and the
# scratch row; B1 runs on it at chain 8 × 256 rows = 2,048 windows
P16_SHARD_ROWS, P16_GATHER_N = 2 * (250_000 + WINDOW - 1) + 1, 8 * 256
# 16b: phase 11's run at 2 processes, 2 of the preset's 4 actors each,
# each process's ring the preset's 1M rows' half (one shard of D = 2);
# 200 grad steps, logged every 25 for each process's actor watch
P16_DIST_ARGV = ["train", "--distributed", "--preset", "pong",
                 "--backend", "cuda", "--log-every", "25", "--set",
                 "env.kind=signal_atari", "env.id=signal",
                 "replay.learn_start=8192", "train.use_pallas_loss=true",
                 "train.total_steps=200"]
# 16c: the in-process loop at 2 processes, the Breakout preset with frames
# in a host FrameStackReplay on each (the reference refuses the device ring
# there), the fused loss; learn_start 5,000, 100 grad steps (phase 6b's
# cut)
P16_HOST_ARGV = ["train", "--preset", "breakout", "--backend", "cuda",
                 "--log-every", "50", "--set", "env.kind=signal_atari",
                 "env.id=signal", "replay.device_resident=false",
                 "train.use_pallas_loss=true", "replay.learn_start=5000",
                 "train.total_steps=5396"]


def theta_hash(solver) -> str:
    import hashlib
    return hashlib.sha256(b"".join(
        p.detach().float().cpu().numpy().tobytes()
        for p in solver.state.net.parameters())).hexdigest()


def p16_kernel_counters():
    from distributed_deep_q_tpu_torch.ops import fused_loss as fl
    from distributed_deep_q_tpu_torch.ops import ring_gather as rg
    return {"gather_windows": rg.gather_windows,
            "scatter_rows": rg.scatter_rows,
            "fused_loss_fwd": fl.fused_loss_fwd,
            "fused_loss_bwd": fl.fused_loss_bwd}


def p16_pin_worker(pid: int, nproc: int, port: str, out: str) -> None:
    """One process of 16a: join, fill this process's slots, run the 8
    dispatches; write the drawn rows (global coordinates), IS weights, θ
    and the launches."""
    from distributed_deep_q_tpu_torch import config
    from distributed_deep_q_tpu_torch.parallel import multihost

    cfg = config.pong_config()
    cfg.env.kind, cfg.env.id = "signal_atari", "signal"
    cfg.net.num_actions = 4
    cfg.replay.capacity = P16_RING
    cfg.mesh = config.MeshConfig(
        backend="cuda", dp=2, coordinator=f"127.0.0.1:{port}",
        num_processes=nproc, process_id=pid)
    multihost.initialize_multihost(cfg.mesh)
    try:
        p16_pin_run(pid, nproc, cfg, out)
    finally:
        multihost.shutdown()


def p16_pin_run(pid: int, nproc: int, cfg, out: str) -> None:
    import torch

    from distributed_deep_q_tpu_torch.ops import ring_gather as rg
    from distributed_deep_q_tpu_torch.parallel import learner as learner_mod
    from distributed_deep_q_tpu_torch.replay.device_per import (
        DevicePERFrameReplay)
    from distributed_deep_q_tpu_torch.solver import Solver

    torch.backends.cudnn.deterministic = True
    solver = Solver(cfg)
    streams = 2 // nproc                      # 1:1 stream ↔ slot
    replay = DevicePERFrameReplay(
        cfg.replay, solver.device, (84, 84), cfg.env.stack, cfg.train.gamma,
        seed=0, write_chunk=cfg.replay.write_chunk, num_streams=streams,
        num_shards=2, local_shards=solver.local_shards)
    for s in range(streams):
        g = pid * streams + s
        assert replay._slot_cycle[s] == [g], replay._slot_cycle
        rng = np.random.default_rng(3000 + g)
        for start in range(0, P16_ROWS_PER_SLOT, 1000):
            done = (np.arange(start, start + 1000) % 32) == 31
            replay.add_batch({
                "frame": rng.integers(0, 256, (1000, 84, 84),
                                      dtype=np.uint8),
                "action": rng.integers(0, 4, 1000).astype(np.int32),
                "reward": (rng.random(1000) < 0.25).astype(np.float32),
                "done": done}, stream=s)
    replay.flush()
    counters = p16_kernel_counters()
    for f in counters.values():
        f.launches = 0
    # every B1 launch of the dispatches held against its plain version on
    # the same inputs (the plain version launches no kernel)
    gathered = []
    gather = learner_mod.gather_windows

    def checked_gather(idx, ring, **kw):
        out = gather(idx, ring, **kw)
        plain = rg.gather_windows_plain(idx, ring, **kw)
        gathered.append((kw["n"], bool(torch.equal(out, plain))))
        return out

    learner_mod.gather_windows = checked_gather
    with capturing(learner_mod, "fused_sample",
                   lambda args, res: (res[2].cpu().numpy(),
                                      res[0]["weight"].cpu().numpy())) \
            as draws:
        try:
            for _ in range(P16_DISPATCHES):
                solver.train_steps_device_per(replay, chain=P16_CHAIN)
            torch.cuda.synchronize()
        finally:
            learner_mod.gather_windows = gather
    idx = np.stack([d[0] for d in draws]).astype(np.int64)
    idx = np.where(idx < replay.local_capacity,
                   idx + replay.local_shards[0] * replay.cap_local,
                   replay.capacity)
    theta = torch.cat([p.detach().float().reshape(-1)
                       for p in solver.state.net.parameters()]).cpu()
    mu = solver.state.opt_state["mu"]
    mu = torch.cat([mu[k].detach().float().reshape(-1)
                    for k in sorted(mu)]).cpu()
    with open(out, "wb") as fh:
        np.savez(fh, idx=idx, weight=np.stack([d[1] for d in draws]),
                 theta=theta.numpy(), mu=mu.numpy(),
                 gathers=np.asarray(gathered, np.int64),
                 theta_hash=theta_hash(solver),
                 launches=json.dumps({k: f.launches
                                      for k, f in counters.items()}),
                 step=solver.step)


def p16_cli_worker(pid: int, nproc: int, port: str, out: str,
                   watch_jsonl: str, *argv: str) -> None:
    """One process of 16b or 16c: ``main`` in process with the mesh flags
    of process ``pid``, every kernel counter set to 0 just before it and
    read just after; ``--distributed`` runs under an ``ActorWatch`` (whose
    grad-step signal is process 0's metrics JSONL, ``watch_jsonl``)."""
    import torch  # noqa: F401 (the card's context is made by the loop)

    from distributed_deep_q_tpu_torch import train as train_mod
    from distributed_deep_q_tpu_torch.actors import supervisor
    from distributed_deep_q_tpu_torch.main import main as cli_main
    from distributed_deep_q_tpu_torch.parallel import multihost

    distributed = "--distributed" in argv
    jsonl = os.path.join(OUT_DIR, f"chip_smoke_p16_{os.path.basename(out)}"
                                  ".jsonl")
    argv = (list(argv[:1]) + ["--metrics-jsonl", jsonl] + list(argv[1:])
            + [f"mesh.coordinator=127.0.0.1:{port}",
               f"mesh.num_processes={nproc}", f"mesh.process_id={pid}"])
    counters = p16_kernel_counters()
    for f in counters.values():
        f.launches = 0
    watch = ActorWatch(watch_jsonl) if distributed else None
    target = ((supervisor, "train_distributed") if distributed
              else (train_mod, "train_single_process"))
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with capturing(*target, lambda args, res: (
                theta_hash(res["solver"]),
                getattr(res.get("replay"), "shard_rows", None))) \
                as hashes, contextlib.redirect_stdout(buf):
            rc = cli_main(argv)
    finally:
        ctx = watch.verdict(2) if watch else None
    wall = time.perf_counter() - t0
    assert rc == 0, f"main returned {rc}"
    launches = {k: fn.launches for k, fn in counters.items()}
    with open(out, "w") as fh:
        json.dump({"pid": pid, "summary": json.loads(
            buf.getvalue().strip().splitlines()[-1]),
            "launches": launches, "theta_hash": hashes[0][0],
            "ring_shard_rows": hashes[0][1], "wall_s": wall,
            "collectives": multihost.STATS, "cuda_context": ctx}, fh)


def p16_worker(argv: list[str]) -> int:
    """``chip_smoke.py --phase16-worker KIND PID NPROC PORT OUT ...``: one
    learner process of phase 16 (``pin`` or ``cli``)."""
    kind, pid, nproc, port, out, *rest = argv
    fn = {"pin": p16_pin_worker, "cli": p16_cli_worker}[kind]
    fn(int(pid), int(nproc), port, out, *rest)
    return 0


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def p16_start(kind: str, nproc: int, tag: str, *extra: str):
    """Start ``nproc`` phase-16 workers; returns (processes, their output
    files, their stderr files)."""
    port = str(free_port())
    procs, outs, errs = [], [], []
    for pid in range(nproc):
        out = os.path.join(OUT_DIR, f"p16_{tag}_{pid}.out")
        err = open(os.path.join(OUT_DIR, f"p16_{tag}_{pid}.err"), "w")
        with contextlib.suppress(FileNotFoundError):
            os.remove(out)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--phase16-worker",
             kind, str(pid), str(nproc), port, out, *extra],
            stdout=err, stderr=subprocess.STDOUT))
        outs.append(out)
        errs.append(err)
    return procs, outs, errs


def p16_stop(started) -> None:
    """Kill whichever of the workers still runs, and reap them all."""
    procs, _, errs = started
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()
    for e in errs:
        e.close()


def p16_wait(started, timeout: float = P16_TIMEOUT_S) -> list[str]:
    """Wait for the workers; kill them all when one fails or the time is
    up, and raise with the tail of each one's output."""
    procs, outs, errs = started
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break
            if time.monotonic() > deadline:
                break
            time.sleep(0.5)
    finally:
        p16_stop(started)
    bad = [i for i, p in enumerate(procs) if p.returncode != 0]
    if bad:
        tails = []
        for i in bad:
            with open(errs[i].name) as f:
                tails.append(f"--- worker {i} rc={procs[i].returncode}\n"
                             + f.read()[-3000:])
        raise AssertionError("phase 16 workers failed:\n" + "\n".join(tails))
    return outs


def phase16_pin() -> dict:
    """16a: 2 processes × 1 shard against 1 process × 2 shards, started
    together."""
    one_w = p16_start("pin", 1, "pin1")
    two_w = p16_start("pin", 2, "pin2")
    try:
        one = dict(np.load(p16_wait(one_w)[0]))
        two = [dict(np.load(o)) for o in p16_wait(two_w)]
    finally:
        p16_stop(two_w)
    idx2 = np.concatenate([t["idx"] for t in two], axis=-1)
    w2 = np.concatenate([t["weight"] for t in two], axis=-1)
    dtheta = float(np.abs(two[0]["theta"] - one["theta"]).max())
    dmu = float(np.abs(two[0]["mu"] - one["mu"]).max())
    gathers = [r["gathers"] for r in [one] + two]
    return {"draws_bitwise": bool(np.array_equal(idx2, one["idx"])),
            "b1_windows_bitwise_vs_plain": bool(all(
                len(g) and g[:, 1].all() for g in gathers)),
            "b1_n": [sorted(set(g[:, 0].tolist())) for g in gathers],
            "weights_bitwise": bool(np.array_equal(w2, one["weight"])),
            "rows_drawn": int(one["idx"].size),
            "shards_drawn": sorted(set((one["idx"] // (P16_RING // 2))
                                       .ravel().tolist())),
            "ranks_theta_bitwise": bool(np.array_equal(two[0]["theta"],
                                                       two[1]["theta"])),
            "theta_max_abs_diff_vs_one_process": dtheta,
            "theta_max_abs": float(np.abs(one["theta"]).max()),
            "mu_rel_diff_vs_one_process":
                dmu / float(np.abs(one["mu"]).max()),
            "ranks_mu_bitwise": bool(np.array_equal(two[0]["mu"],
                                                    two[1]["mu"])),
            "steps": [int(one["step"])] + [int(t["step"]) for t in two],
            "launches": [json.loads(str(one["launches"]))]
            + [json.loads(str(t["launches"])) for t in two]}


def check_phase16_pin() -> dict:
    """16a, run and held to its bars."""
    pin16 = phase16_pin()
    log(f"[16a] 2 processes x 1 shard against 1 process x 2 shards, "
        f"{P16_DISPATCHES} chain-{P16_CHAIN} dispatches: {json.dumps(pin16)}")
    assert pin16["draws_bitwise"] and pin16["weights_bitwise"], pin16
    assert pin16["b1_windows_bitwise_vs_plain"], pin16
    assert pin16["b1_n"] == [[P16_CHAIN * 512], [P16_GATHER_N],
                             [P16_GATHER_N]], pin16
    assert pin16["shards_drawn"] == [0, 1], pin16
    assert pin16["ranks_theta_bitwise"] and pin16["ranks_mu_bitwise"], pin16
    assert pin16["steps"] == [P16_DISPATCHES * P16_CHAIN] * 3, pin16
    assert pin16["theta_max_abs_diff_vs_one_process"] <= P16_THETA_TOL, \
        pin16
    assert pin16["mu_rel_diff_vs_one_process"] <= P16_MU_TOL, pin16
    return pin16


def phase16a_only() -> int:
    """``chip_smoke.py --phase16a``: 16a alone (its bars and its
    readings), for a quick check of the multi-process train step."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from distributed_deep_q_tpu_torch.ops import cuda_build
    os.makedirs(OUT_DIR, exist_ok=True)
    log(nvidia_smi_line())
    log(f"[2] build: {cuda_build.build_all()}")   # before the workers
    check_phase16_pin()
    return 0


def phase16_cli(tag: str, argv: list[str]) -> list[dict]:
    """16b / 16c: ``main`` on 2 processes."""
    watch = os.path.join(OUT_DIR, f"chip_smoke_p16_p16_{tag}_0.out.jsonl")
    with contextlib.suppress(FileNotFoundError):
        os.remove(watch)
    res = []
    for o in p16_wait(p16_start("cli", 2, tag, watch, *argv)):
        with open(o) as f:
            res.append(json.load(f))
    return res


def check_phase16_cli(res: list[dict], grad_steps: int,
                      kernels: tuple[str, ...]) -> None:
    for r in res:
        check_path(r["summary"], grad_steps)
        for name in kernels:
            assert r["launches"][name] > 0, (r["pid"], r["launches"])
    assert res[0]["theta_hash"] == res[1]["theta_hash"], \
        [r["theta_hash"] for r in res]


def p16_collective_ms(r: dict) -> float:
    """Host-clock ms per grad step inside the train step's collectives."""
    st = r["collectives"]["step"]
    return 1e3 * st["seconds"] / max(r["summary"]["grad_steps"], 1)


# -- phase 17: the chaos and soak gates on the card --------------------------

# The port's chaos modes (``distributed_deep_q_tpu_torch/chaos_smoke.py``)
# and the pixel fleet soak (``fleet_smoke.py``) at the Pong preset's width
# on SignalAtari: the bf16 Nature CNN over 84×84×4, 4 actions, batch 512.
# 17a ingest: the preset's fused ring (B2 flushes through the IngestDrain),
# sized so no slot wraps: 4 actors × 40 flushes × 64 rows into 16,384 rows
# (4 sub-rings of 4,096; 134 MB padded), the preset's learner stepping on
# it at the capped consumption rate (B1); the reference's spec
P17_INGEST = dict(num_actors=4, flushes=40, rows=64, capacity=16_384,
                  consume_rate=500.0, frame_shape=(84, 84),
                  device_per=True)
# 17e: phase 11's run (4 actors, the uncut 1M-row ring, the fused loss)
# under the train mode's wire chaos (drop=0.005,truncate=0.003,seed=5);
# cut: 400 grad steps (phase 11: 800)
P17_TRAIN_SET = ["env.kind=signal_atari", "env.id=signal",
                 "replay.learn_start=8192", "train.use_pallas_loss=true",
                 "train.total_steps=400"]
P17_TRAIN_GRAD_STEPS = 400
# 17f: the pixel soak at 64 streams, the preset's geometry (1M rows, 15,625
# per stream, its actors' 64 transitions per message: the harness's default
# 16 was sized for 36×36 frames, and at 84×84 the per-message host cost of
# 128 threads under one interpreter lock kept the burst near the floor) and
# the reference's phases (5 s fill, 3 s idle, 6 s paced)
P17_SOAK = dict(num_actors=64, fill_s=5.0, measure_s=6.0, batch=512,
                send_batch=64, rate_per_actor=128.0, frame_hw=84,
                capacity=1_000_000, compute_dtype="bfloat16")
P17_SOAK_TIMEOUT_S = 300
# the launches of each kernel shape held against the plain version on the
# same inputs, per sub-phase (the first ones; later launches pass through)
P17_CHECKED = 16


class KernelChecks:
    """Wraps B1 where ``gather_mods`` call it and B2 where
    ``scatter_mods`` call it: the first ``limit`` launches of each shape
    are held against the plain version on the same inputs (B2 on a copy
    of the ring taken just before, compared outside the skipped scratch
    row, whose contents are unspecified). The wrapped kernel counts its
    launch as always; the plain version launches none. With ``scope``
    set (phase 18 sets it to the bench row running), each scope checks
    its own first launches of each shape, and its key ends in
    ``@<scope>``."""

    def __init__(self, torch, rg, gather_mods, scatter_mods,
                 limit: int = P17_CHECKED):
        self.torch, self.rg, self.limit = torch, rg, limit
        self.scope: str | None = None
        self.mods = ([(m, "gather_windows", self._gather)
                      for m in gather_mods]
                     + [(m, "scatter_rows", self._scatter)
                        for m in scatter_mods])
        self.seen: dict[str, dict] = {}

    def __enter__(self):
        for mod, name, fn in self.mods:
            setattr(mod, name, fn)
        return self

    def __exit__(self, *exc):
        for mod, name, _ in self.mods:
            setattr(mod, name, getattr(self.rg, name))

    def _slot(self, name: str, key: tuple):
        tag = f"{name} {key}" if self.scope is None \
            else f"{name} {key} @{self.scope}"
        rec = self.seen.setdefault(tag, {"checked": 0, "bitwise": 0})
        return rec if rec["checked"] < self.limit else None

    def _gather(self, idx, ring, **kw):
        out = self.rg.gather_windows(idx, ring, **kw)
        rec = self._slot("gather_windows",
                         (kw["n"], kw["w"], kw["rowb"]))
        if rec is not None:
            plain = self.rg.gather_windows_plain(idx, ring, **kw)
            rec["checked"] += 1
            rec["bitwise"] += int(self.torch.equal(out, plain))
        return out

    def _scatter(self, src, dst, staged, ring, **kw):
        rec = self._slot("scatter_rows", (kw["n"], kw["rowb"]))
        before = ring.clone() if rec is not None else None
        out = self.rg.scatter_rows(src, dst, staged, ring, **kw)
        if rec is not None:
            self.rg.scatter_rows_plain(src, dst, staged, before, **kw)
            rowp = kw["rowb"] // 4
            skip = kw.get("skip_row")
            if skip is not None:
                before.view(-1, rowp)[skip] = ring.view(-1, rowp)[skip]
            rec["checked"] += 1
            rec["bitwise"] += int(self.torch.equal(ring, before))
            rec.setdefault("real_lanes", []).append(
                int((dst != (-1 if skip is None else skip)).sum()))
            del before
        return out

    def verdict(self) -> dict:
        return {"shapes": self.seen,
                "all_bitwise": all(r["bitwise"] == r["checked"]
                                   for r in self.seen.values())}


def p17_net(config):
    """The Pong preset's net on SignalAtari's 4 actions, and the preset."""
    cfg = config.pong_config()
    cfg.env.kind, cfg.env.id = "signal_atari", "signal"
    cfg.net = dataclasses.replace(cfg.net, num_actions=4)
    return cfg, cfg.net


def run_phase17(torch, counters, cli_modules) -> dict:
    """17a–17f, each with every kernel counter set to 0 just before it and
    read just after; each gate failing raises. Returns what the result
    lines need: each sub-phase's launches and verdict, and the B1/B2
    checks."""
    from distributed_deep_q_tpu_torch import chaos_smoke, config
    from distributed_deep_q_tpu_torch import metrics as metrics_mod
    from distributed_deep_q_tpu_torch.actors import supervisor
    from distributed_deep_q_tpu_torch.parallel import learner as learner_mod
    from distributed_deep_q_tpu_torch.replay import device_per
    from distributed_deep_q_tpu_torch.solver import Solver

    rg = cli_modules["rg"]
    os.makedirs(OUT_DIR, exist_ok=True)
    out: dict = {"launches": {}}
    pong, net = p17_net(config)
    obs_dim = 84 * 84 * 4
    t17 = time.perf_counter()

    def zero():
        for fn in counters.values():
            fn.launches = 0

    def read() -> dict:
        return {k: fn.launches for k, fn in counters.items()}

    def show(tag: str, v: dict, keys: tuple) -> None:
        log(f"[{tag}] {json.dumps({k: v.get(k) for k in keys})}")

    # 17a: ingest at saturation into the fused ring, the learner on it
    cfg_a = copy.deepcopy(pong)
    cfg_a.replay = dataclasses.replace(cfg_a.replay,
                                       capacity=P17_INGEST["capacity"])
    learner = Solver(cfg_a)
    zero()
    t0 = time.perf_counter()
    with KernelChecks(torch, rg, [learner_mod], [device_per]) as chk_a:
        va = chaos_smoke.run_ingest_saturation_smoke(
            device="cuda", learner=learner, **P17_INGEST)
    out["launches"]["17a"] = read()
    out["17a"] = dict(va, checks=chk_a.verdict(),
                      phase_s=time.perf_counter() - t0)
    del learner
    torch.cuda.empty_cache()
    show("17a", out["17a"], (
        "ok", "transitions_sent", "transitions_stored", "lost",
        "duplicated", "corrupt_rows", "shed_flushes", "client_sheds",
        "drain_flushes", "drained_rows", "rows_left_staged",
        "learner_grad_steps", "faults_fired", "wall_s", "errors",
        "checks", "trace"))
    log(f"[17a] launches {json.dumps(out['launches']['17a'])}")
    assert va["ok"], va
    assert va["lost"] == va["duplicated"] == va["corrupt_rows"] == 0, va
    assert va["shed_flushes"] > 0 and va["drain_flushes"] > 0, va
    assert chk_a.verdict()["all_bitwise"], chk_a.verdict()
    assert out["launches"]["17a"]["scatter_rows"] > 0, out["launches"]
    assert out["launches"]["17a"]["gather_windows"] > 0, out["launches"]

    # 17b: BatchedPolicy behind the InferenceServer under wire chaos
    zero()
    vb = chaos_smoke.run_inference_chaos_smoke(
        device="cuda", net=net, obs_dim=obs_dim,
        buckets=pong.inference.buckets)
    out["launches"]["17b"] = read()
    out["17b"] = vb
    show("17b", vb, (
        "ok", "requests_sent", "replies", "wrong_actions",
        "missing_actions", "client_sheds", "server_requests",
        "server_wire_errors", "compiled_buckets", "served_buckets",
        "reply_ms_p50", "reply_ms_p99", "faults_fired", "wall_s", "errors"))
    assert vb["ok"], vb
    assert vb["wrong_actions"] == vb["missing_actions"] == 0, vb
    assert vb["replies"] == vb["requests_sent"], vb

    # 17c: the vector loop through a hard-killed and rebooted server
    zero()
    vc = chaos_smoke.run_vector_chaos_smoke(device="cuda", net=net)
    out["launches"]["17c"] = read()
    out["17c"] = vc
    show("17c", vc, (
        "ok", "actions_checked", "wrong_actions", "missing_actions",
        "duplicated_ticks", "kill_tick", "retry_events", "client_sheds",
        "reboot_server_requests", "served_buckets", "faults_fired",
        "wall_s", "errors"))
    assert vc["ok"], vc
    assert vc["wrong_actions"] == vc["missing_actions"] == 0, vc

    # 17d: both tenants arcs; arc 2's actor processes hold no CUDA context
    zero()
    watch = ActorWatch(os.path.join(OUT_DIR, "chip_smoke_p17d.none"))
    try:
        vd = chaos_smoke.run_tenants_smoke(device="cuda", net=net,
                                           obs_dim=obs_dim)
    finally:
        ctx_d = watch.verdict(3)
    out["launches"]["17d"] = read()
    out["17d"] = dict(vd, cuda_context=ctx_d)
    show("17d", vd, (
        "ok", "replies", "wrong_actions", "missing_actions",
        "tenant_mismatches", "version_mismatches", "ladder_ledger",
        "ladder_cleared", "shadow_direct_rejected", "compiled_buckets",
        "warmed", "ladder_rose", "ab_rung_by_equal_wave",
        "equal_wave_occupancy_max", "primary_shed", "retired_ok", "shrunk", "retire_applied", "regrew", "grow_applied", "settled",
        "executor_terminations", "kill_escalations", "rollbacks",
        "transitions_stored", "duplicated", "wrong_stored_actions",
        "critical_flaps", "slo_problems", "elastic_problems",
        "invalid_records", "wall_s", "errors"))
    log(f"[17d] arc 2's actors and the card ({ctx_d['check']} check): "
        f"{json.dumps(ctx_d)}")
    assert vd["ok"], {k: v for k, v in vd.items()
                      if k not in ("decisions", "applied")}
    assert vd["wrong_actions"] == vd["missing_actions"] == 0, vd
    assert vd["duplicated"] == vd["wrong_stored_actions"] == 0, vd
    assert ctx_d["samples"] > 0 and ctx_d["actors_seen"], ctx_d
    assert not ctx_d["actors_holding_cuda"], ctx_d
    if not ctx_d["check"].startswith("nvidia-smi pids"):
        assert ctx_d["compute_apps_max"] <= 1, ctx_d

    # 17e: train_distributed under the fleet's wire chaos (phase 11's run)
    jsonl = os.path.join(OUT_DIR, "chip_smoke_p17e.jsonl")
    with contextlib.suppress(FileNotFoundError):
        os.remove(jsonl)
    watch = ActorWatch(jsonl)
    zero()
    t0 = time.perf_counter()
    try:
        with capturing(supervisor, "train_distributed",
                       lambda args, res: res) as runs, \
                contextlib.redirect_stdout(io.StringIO()):
            ve = chaos_smoke.run_train_chaos(
                P17_TRAIN_SET, device="cuda", preset="pong",
                metrics=metrics_mod.Metrics(jsonl), log_every=100)
    finally:
        ctx_e = watch.verdict(4)
    launches_e = read()
    summary = {k: v for k, v in runs[0].items()
               if isinstance(v, (int, float, str))}
    stored = int(runs[0]["replay"].steps_added)
    out["launches"]["17e"] = launches_e
    out["17e"] = {"counters": ve, "stored_rows": stored,
                  "phase_s": time.perf_counter() - t0,
                  "summary": {k: summary.get(k) for k in (
                      "grad_steps", "env_steps", "grad_steps_per_s",
                      "env_steps_per_s", "loss", "q_mean", "eval_return",
                      "rpc_checksum_errors", "rpc_shed_flushes")}}
    log(f"[17e] robustness counters {json.dumps(ve)}; stored rows {stored}"
        f"; {json.dumps(out['17e']['summary'])}; launches "
        f"{json.dumps(launches_e)}; phase {out['17e']['phase_s']:.1f} s")
    log(f"[17e] actors and the card ({ctx_e['check']} check): "
        f"{json.dumps(ctx_e)}")
    check_distributed_run(
        {"summary": summary, "launches": launches_e, "cuda_context": ctx_e},
        P17_TRAIN_GRAD_STEPS, ("env_steps", 8192), tuple(counters))
    assert ve["actor_kill_escalations"] == 0, ve
    # a duplicate flush is counted by the dedup and lands no row: every
    # row the replay stored is one the server counted once
    assert stored == summary["env_steps"], (stored, summary["env_steps"])

    # 17f: the pixel fleet soak at 64 streams, in a fresh process: its
    # 64 actor and 64 server threads share one interpreter lock, which
    # the threads earlier phases leave in this one would share too
    log(f"[17f] threads in this process: {threading.active_count()}")
    res = os.path.join(OUT_DIR, "p17f.json")
    with contextlib.suppress(FileNotFoundError):
        os.remove(res)
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--phase17f-worker", res],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        timeout=P17_SOAK_TIMEOUT_S)
    assert proc.returncode == 0, (
        f"17f worker rc={proc.returncode}\n{proc.stdout[-3000:]}")
    with open(res) as f:
        soak = json.load(f)
    vf, chk_f = soak["result"], soak["checks"]
    out["launches"]["17f"] = soak["launches"]
    out["17f"] = dict(vf, checks=chk_f)
    log(f"[17f] {json.dumps(out['17f'])}; launches "
        f"{json.dumps(out['launches']['17f'])}; {nvidia_smi_line()}")
    # every stream delivers, the learner keeps stepping, and the floors of
    # the reference's test_pixel_fleet_64_streams_fused_per hold
    assert vf["errors"] == [] and vf["streams_seen"] == 64, vf
    assert vf["pixel_burst_ingest_tps"] > 5_000, vf
    assert vf["ingest_transitions_per_s"] > 1_000, vf
    assert vf["learner_idle_steps_per_s"] > 1, vf
    assert vf["contention_ratio"] > 0.1, vf
    assert chk_f["all_bitwise"], chk_f
    for k in ("gather_windows", "scatter_rows"):
        assert out["launches"]["17f"][k] > 0, out["launches"]
    # B1 at 17f's draw, the shape no other phase launches (n-step 2: 6-row
    # windows), on a random ring of the preset's rows: bitwise against the
    # plain version, then timed beside it, index_select and its bound
    gc.collect()
    torch.cuda.empty_cache()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(17)
    ring = torch.randint(-2**31, 2**31 - 1, (ROWS * ROWB // 4,),
                         dtype=torch.int32, device=dev, generator=gen)
    out["gather_w6"] = check_gather(torch, rg, ring, dev,
                                    P17_SOAK["batch"], w=6)
    del ring
    torch.cuda.empty_cache()
    log(f"[17f] gather_windows at the soak's shape (n=512, w=6): "
        f"{json.dumps(out['gather_w6'])}")
    assert out["gather_w6"]["max_abs_err"] == 0, out["gather_w6"]
    out["wall_s"] = time.perf_counter() - t17
    log(f"[17] phase 17 wall {out['wall_s']:.1f} s")
    return out


def p17_soak_worker(argv: list[str]) -> int:
    """``chip_smoke.py --phase17f-worker OUT``: 17f's soak in a process of
    its own, every kernel counter set to 0 just before it and read just
    after, the first launches of each B1/B2 shape held against the plain
    versions; writes the result, the checks and the launches to OUT."""
    import torch

    from distributed_deep_q_tpu_torch import fleet_smoke
    from distributed_deep_q_tpu_torch.ops import ring_gather as rg
    from distributed_deep_q_tpu_torch.parallel import learner as learner_mod
    from distributed_deep_q_tpu_torch.replay import device_per

    counters = p16_kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    with KernelChecks(torch, rg, [learner_mod], [device_per]) as chk:
        vf = fleet_smoke.run_pixel_fleet_smoke(device="cuda", **P17_SOAK)
    launches = {k: fn.launches for k, fn in counters.items()}
    with open(argv[0], "w") as f:
        json.dump({"result": vf, "checks": chk.verdict(),
                   "launches": launches}, f)
    return 0


def analysis_gate() -> dict:
    """Phase 1b: the port's static-analysis gate over this checkout's
    port package, timed on the host clock."""
    from distributed_deep_q_tpu_torch.analysis import (
        KNOWN_RULES, repo_root, run_all)
    from distributed_deep_q_tpu_torch.analysis.core import package_files

    root = repo_root()
    t0 = time.perf_counter()
    findings = run_all(root)
    seconds = time.perf_counter() - t0
    for f in findings:
        log(f"[1b] {f}")
    return {"findings": len(findings),
            "finding_rules": sorted({f.rule for f in findings}),
            "rules": len(KNOWN_RULES),
            "files_scanned": len(package_files(root)),
            "seconds": seconds, "python": sys.version.split()[0]}


def phase1b_only() -> int:
    """``chip_smoke.py --phase1b``: the analysis gate alone."""
    with contextlib.suppress(Exception):
        log(nvidia_smi_line())
    gate = analysis_gate()
    log(f"[1b] analysis gate: {json.dumps(gate)}")
    return 0 if gate["findings"] == 0 else 1


def p17_preflight() -> None:
    """Phase 17's preflight, the chaos tool's own: on a tree the analysis
    gate rejects, the findings go to stderr and the process exits 2."""
    from distributed_deep_q_tpu_torch import chaos_smoke

    chaos_smoke._require_clean_gate()


def phase17_only() -> int:
    """``chip_smoke.py --phase17``: phase 17 alone (its gates and its
    readings), after its preflight, the build and phase 3's kernel checks
    at the shapes 17a and 17f launch."""
    p17_preflight()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from distributed_deep_q_tpu_torch.ops import cuda_build
    from distributed_deep_q_tpu_torch.ops import fused_loss as fl
    from distributed_deep_q_tpu_torch.ops import ring_gather as rg
    os.makedirs(OUT_DIR, exist_ok=True)
    log(nvidia_smi_line())
    log(f"[2] build: {cuda_build.build_all()}")
    counters = {"gather_windows": rg.gather_windows,
                "scatter_rows": rg.scatter_rows,
                "fused_loss_fwd": fl.fused_loss_fwd,
                "fused_loss_bwd": fl.fused_loss_bwd}
    p17 = run_phase17(torch, counters, {"rg": rg})
    log(json.dumps({"launches_by_path": p17["launches"]}))
    return 0


P18_TIMEOUT_S = 300
# the bench's launches of each B1/B2 shape held against the plain version
# on the same inputs (the first ones: they fall in each row's calibration
# probe and first rep, so the timed reps run almost unchecked)
P18_CHECKED = 4


def _positive(key: str, v) -> None:
    assert isinstance(v, (int, float)) and math.isfinite(v) and v > 0, \
        (key, v)


def check_bench_line(line: dict, keys: tuple) -> None:
    """The bench's line holds every key it keeps of the reference's and
    its own; every rate is finite and above 0; MFU lies in (0, 1.05]; the
    counted FLOPs lie within 10% of the analytic count; B1 and B2
    launched in the flagship row, B3 and B4 in ``pallas_on``.

    The curves: every target, client count and env count of the full
    run; at every ingest target a learner rate and an achieved ingest
    above 0, and at most ``STAGED_ROWS_CAP`` + 4 × 64 rows seen in
    flight; no ingest or actor row lost; every inference and actor rate
    and p99 finite and above 0; the bucket census within the buckets;
    the health plane's sample and verdict times finite and above 0; B1
    and B2 launched in the ingest curve and B2 in the actor curve.

    The multi-process curve: every process count of the full run; at
    each, every rate finite and above 0, the summed ingest above 0 and no
    RPC crossed to another process's server; B1 and B2 launched in every
    worker (``launches["multihost_<n>_<pid>"]``); the four linearity keys
    finite."""
    from distributed_deep_q_tpu_torch import bench
    from distributed_deep_q_tpu_torch.config import InferenceConfig

    missing = [k for k in keys if k not in line]
    assert not missing, missing
    for k, v in line.items():
        if k == "value" or k.endswith("_steps_per_s"):
            _positive(k, v)
    assert line["mfu"] is not None and 0 < line["mfu"] <= 1.05, line["mfu"]
    fl, an = line["flops_per_step"], line["flops_per_step_analytic"]
    assert abs(fl - an) / an <= 0.10, (fl, an)
    launches = line["launches"]
    flag, pallas = launches["flagship"], launches["pallas_on"]
    assert flag["gather_windows"] > 0 and flag["scatter_rows"] > 0, flag
    assert pallas["fused_loss_fwd"] > 0 and pallas["fused_loss_bwd"] > 0, \
        pallas

    cs = bench.FULL.curves
    ingest = line["ingest_curve"]
    assert set(ingest) == {str(t) for t in cs.ingest_targets}, ingest
    cap = bench.STAGED_ROWS_CAP + bench.WRITERS * 64
    for t, pt in ingest.items():
        _positive(f"ingest {t} steps_per_s", pt["steps_per_s"])
        _positive(f"ingest {t} achieved_t_per_s", pt["achieved_t_per_s"])
        assert 0 <= pt["max_in_flight_rows"] <= cap, (t, pt, cap)
    _positive("ingest_transitions_per_s", line["ingest_transitions_per_s"])
    assert line["concurrent_writers"] == bench.WRITERS, \
        line["concurrent_writers"]
    assert line["ingest_rows_lost"] == 0, line["ingest_rows_lost"]
    assert line["actor_rows_lost"] == 0, line["actor_rows_lost"]
    inference = line["inference_curve"]
    assert set(inference) == {str(n) for n in cs.clients}, inference
    for n, pt in inference.items():
        for k in ("actions_per_s", "p99_ms", "local_actions_per_s",
                  "forward_actions_per_s"):
            _positive(f"inference {n} {k}", pt[k])
    buckets = InferenceConfig().buckets
    census = line["inference_compiled_buckets"]
    assert 0 < len(census) <= len(buckets) and set(census) <= set(
        buckets), census
    actor = line["actor_curve"]
    assert set(actor) == {str(n) for n in cs.envs}, actor
    for n, pt in actor.items():
        for k in ("actions_per_s", "ingest_t_per_s", "tick_p99_ms"):
            _positive(f"actor {n} {k}", pt[k])
    for k in ("health_sample_us", "health_verdict_us"):
        _positive(k, line[k])
    assert math.isfinite(line["health_disabled_us"]) \
        and line["health_disabled_us"] >= 0, line["health_disabled_us"]
    ing, act = launches["ingest_curve"], launches["actor_curve"]
    assert ing["gather_windows"] > 0 and ing["scatter_rows"] > 0, ing
    assert act["scatter_rows"] > 0, act
    mh = line["multihost_curve"]
    assert set(mh) == {str(n) for n in cs.multihost_hosts}, mh
    for n, pt in mh.items():
        for k in ("steps_per_s", "wall_steps_per_s", "ingest_t_per_s"):
            _positive(f"multihost {n} {k}", pt[k])
        assert pt["cross_host_replay_rpcs"] == 0, (n, pt)
        for pid in range(int(n)):
            w = launches.get(f"multihost_{n}_{pid}", {})
            assert w.get("gather_windows", 0) > 0 \
                and w.get("scatter_rows", 0) > 0, (n, pid, w)
    for k in ("multihost_linearity_2x", "multihost_linearity_4x",
              "multihost_linearity_2x_spread",
              "multihost_linearity_4x_spread"):
        v = line[k]
        assert isinstance(v, (int, float)) and math.isfinite(v), (k, v)


def p18_mh_worker(argv: list[str]) -> int:
    """``chip_smoke.py --phase18-mh-worker DIR WORKER ARGS``: one process
    of the bench's multi-process curve (``bench_multihost_worker.main``
    on WORKER ARGS), with the first ``P18_CHECKED`` launches of each
    B1/B2 shape (its fused dispatches' gathers, its drain's flushes) held
    against the plain versions, keys ending in ``@multihost_<n>_<pid>``;
    writes the checks to ``DIR/multihost_<n>_<pid>.json``."""
    import torch

    from distributed_deep_q_tpu_torch import bench_multihost_worker
    from distributed_deep_q_tpu_torch.ops import ring_gather as rg
    from distributed_deep_q_tpu_torch.parallel import learner as learner_mod
    from distributed_deep_q_tpu_torch.replay import device_per

    out_dir, args = argv[0], argv[1:]
    tag = f"multihost_{args[1]}_{args[0]}"
    with KernelChecks(torch, rg, [learner_mod], [device_per],
                      limit=P18_CHECKED) as chk:
        chk.scope = tag
        code = bench_multihost_worker.main(args)
    with open(os.path.join(out_dir, f"{tag}.json"), "w") as f:
        json.dump(chk.verdict(), f)
    return code


def p18_bench_worker(argv: list[str], sizes=None) -> int:
    """``chip_smoke.py --phase18-worker OUT [BENCH ARGS]``: the bench's
    command line (``bench.main``, ``--quick`` unless other arguments
    follow; its one line goes to stdout) in a process of its own, with
    the first ``P18_CHECKED`` launches of each B1/B2 shape in each row
    (the frame rings', the sequence ring's, the ingest curve's drain
    flushes and dispatches, the actor curve's 10×10 ring, the
    ``--trace-ingest`` mode's) held against the plain versions; the
    multi-process curve's workers are ``--phase18-mh-worker`` processes,
    which check their own launches the same way. Writes the checks, the
    workers' merged in, to OUT. ``sizes`` goes to ``bench.main`` (the
    tests' small run)."""
    import shutil

    import torch

    from distributed_deep_q_tpu_torch import bench
    from distributed_deep_q_tpu_torch.ops import ring_gather as rg
    from distributed_deep_q_tpu_torch.parallel import learner as learner_mod
    from distributed_deep_q_tpu_torch.parallel import (
        sequence_learner as seq_learner_mod)
    from distributed_deep_q_tpu_torch.replay import device_per
    from distributed_deep_q_tpu_torch.replay import device_sequence

    counted = bench.counted

    @contextlib.contextmanager
    def scoped(launches, row):
        # each row checks its own first launches of each shape: the
        # ingest curve's drain flushes and dispatches have the flagship
        # row's shapes
        chk.scope = row
        try:
            with counted(launches, row):
                yield
        finally:
            chk.scope = None

    mh_dir = argv[0] + ".workers"
    shutil.rmtree(mh_dir, ignore_errors=True)
    os.makedirs(mh_dir)
    mh_worker = bench.MULTIHOST_WORKER
    with KernelChecks(torch, rg, [learner_mod, seq_learner_mod],
                      [device_per, device_sequence],
                      limit=P18_CHECKED) as chk:
        bench.counted = scoped
        bench.MULTIHOST_WORKER = [sys.executable, os.path.abspath(__file__),
                                  "--phase18-mh-worker", mh_dir]
        try:
            code = bench.main(argv[1:] or ["--quick"], sizes=sizes)
        finally:
            bench.counted = counted
            bench.MULTIHOST_WORKER = mh_worker
    verdict = chk.verdict()
    for name in sorted(os.listdir(mh_dir)):
        with open(os.path.join(mh_dir, name)) as f:
            worker = json.load(f)
        verdict["shapes"].update(worker["shapes"])
        verdict["all_bitwise"] = (verdict["all_bitwise"]
                                  and worker["all_bitwise"])
    with open(argv[0], "w") as f:
        json.dump(verdict, f)
    return code


# the --trace-ingest line's keys (the root bench.py's, and the port's
# launches) and the stages its attribution must hold: the learner's
# dispatch and draw, and the drain's flushes
P18_TRACE_KEYS = {"metric", "wall_s", "steps_per_s", "achieved_t_per_s",
                  "trace_path", "spans_dropped", "stage_self_ms", "launches"}
P18_TRACE_STAGES = {"train_step", "sample", "ingest_drain", "lock_hold"}
# the elasticity bench's keys (scripts/bench_elasticity.py's)
P18_ELASTICITY_KEYS = {
    "handoff_export_ms", "handoff_import_ms", "handoff_rows",
    "elasticity_spread", "fleet_size", "remap_fraction_grow",
    "remap_fraction_shrink", "tenant_swap_us", "shadow_overhead_pct",
    "executor_apply_us", "tenant_spread"}


def p18_child(argv: list[str], tag: str, timeout: float) -> tuple[dict,
                                                                  float]:
    """One phase-18 child process: its stderr to ``p18_<tag>.stderr``, its
    exit code 0, its one stdout line parsed; (line, seconds)."""
    t0 = time.perf_counter()
    proc = subprocess.run(argv, stdout=subprocess.PIPE,
                          stderr=subprocess.PIPE, text=True, timeout=timeout)
    seconds = time.perf_counter() - t0
    with open(os.path.join(OUT_DIR, f"p18_{tag}.stderr"), "w") as f:
        f.write(proc.stderr)
    assert proc.returncode == 0, (
        f"{tag} rc={proc.returncode}\n{proc.stderr[-3000:]}")
    lines = proc.stdout.splitlines()
    assert len(lines) == 1, lines
    return json.loads(lines[0]), seconds


def check_trace_ingest_line(line: dict) -> None:
    """``bench --trace-ingest``'s line: its keys, rates above 0, the
    learner's and the drain's stages attributed, no span dropped, B1 and
    B2 launched."""
    assert set(line) == P18_TRACE_KEYS, set(line) ^ P18_TRACE_KEYS
    assert line["metric"] == "ingest_attribution", line["metric"]
    for k in ("wall_s", "steps_per_s", "achieved_t_per_s"):
        _positive(f"trace_ingest {k}", line[k])
    stages = line["stage_self_ms"]
    assert P18_TRACE_STAGES <= set(stages), stages
    assert line["spans_dropped"] == 0, line["spans_dropped"]
    assert line["launches"]["gather_windows"] > 0 \
        and line["launches"]["scatter_rows"] > 0, line["launches"]


def check_elasticity_line(line: dict) -> None:
    """The elasticity bench's line: the reference's keys, times and
    fractions finite, every handed-off row counted."""
    assert set(line) == P18_ELASTICITY_KEYS, set(line) ^ P18_ELASTICITY_KEYS
    for k in ("handoff_export_ms", "handoff_import_ms", "tenant_swap_us",
              "executor_apply_us"):
        _positive(f"elasticity {k}", line[k])
    for k in ("remap_fraction_grow", "remap_fraction_shrink"):
        assert 0 < line[k] < 1, (k, line[k])


def _p18_gather_row(torch, rg, ring, n: int, w: int, rowb: int) -> dict:
    """B1 at (n, w, rowb) on ``ring`` (``_gather_row``) over 8 sets of
    random window starts anywhere in the ring."""
    dev, rows = ring.device, ring.numel() // (rowb // 4)
    gen = torch.Generator(device=dev).manual_seed(n * 31 + w)
    sets = [torch.randint(0, rows - w + 1, (n,), dtype=torch.int32,
                          device=dev, generator=gen) for _ in range(8)]
    return dict(_gather_row(torch, rg, ring, sets, n, w=w, rowb=rowb),
                w=w, rowb=rowb, ring_MB=ring.numel() * 4 / 1e6)


def _p18_scatter_row(torch, rg, ring, n: int, real: int, rowb: int,
                     skip: int) -> dict:
    """B2 at ``n`` lanes of ``rowb`` bytes, the first ``real`` to distinct
    random rows of ``ring`` and the rest aimed at the scratch row
    ``skip``, as a flush builds them: bitwise against the plain version
    (outside the skip row, which the kernel leaves), then timed beside it
    and ``index_copy_`` of the real lanes; bytes are the real rows read
    and written and the two index vectors."""
    dev, rowp = ring.device, rowb // 4
    rows = ring.numel() // rowp
    gen = torch.Generator(device=dev).manual_seed(n * 7 + real)
    staged = torch.randint(-2**31, 2**31 - 1, (n * rowp,),
                           dtype=torch.int32, device=dev, generator=gen)
    src = torch.arange(n, dtype=torch.int32, device=dev)
    dst = torch.full((n,), skip, dtype=torch.int32, device=dev)
    targets = torch.randperm(rows - 1, device=dev, generator=gen)[:real]
    dst[:real] = torch.where(targets >= skip, targets + 1, targets).to(
        torch.int32)
    plain = ring.clone()
    rg.scatter_rows(src, dst, staged, ring, n=n, rowb=rowb, skip_row=skip)
    rg.scatter_rows_plain(src, dst, staged, plain, n=n, rowb=rowb)
    r2, p2 = ring.view(-1, rowp), plain.view(-1, rowp)
    err = max(max_abs_err(torch, r2[:skip], p2[:skip]),
              max_abs_err(torch, r2[skip + 1:], p2[skip + 1:]))
    del plain, p2
    dst_l = dst[:real].long()
    rows_src = staged.view(-1, rowp)[:real]
    ms, host_ms = time_ms(torch, lambda i: rg.scatter_rows(
        src, dst, staged, ring, n=n, rowb=rowb, skip_row=skip))
    plain_ms = time_ms(torch, lambda i: rg.scatter_rows_plain(
        src, dst, staged, ring, n=n, rowb=rowb))[0]
    library_ms = time_ms(torch, lambda i: r2.index_copy_(
        0, dst_l, rows_src))[0]
    nbytes = 2 * real * rowb + 2 * n * 4
    return {"lanes": n, "real_lanes": real, "rowb": rowb,
            "ring_MB": ring.numel() * 4 / 1e6, "max_abs_err": err, "ms": ms,
            "host_ms": host_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bytes": nbytes,
            "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S}


def p18_kernel_rows(torch, rg, checks: dict, actor_envs: int) -> dict:
    """B1 and B2 at the shapes phase 18's multi-process workers launched
    (process 0's at each process count, read from their checks), each on
    a ring of that process's geometry (the worker's replay holding D / N
    of its D shards), and B2 at the actor curve's flush shape on that
    curve's ring (``actor_envs`` streams): bitwise against the plain
    versions, then timed (CUDA events over ``ITERS`` launches) beside the
    plain versions and the library calls, with each byte bound."""
    from distributed_deep_q_tpu_torch import bench_multihost_worker as mhw
    from distributed_deep_q_tpu_torch import config
    from distributed_deep_q_tpu_torch.replay.device_per import (
        DevicePERFrameReplay)

    def shapes(scope: str) -> dict:
        out: dict = {}
        for key, rec in checks["shapes"].items():
            name, rest = key.split(" ", 1)
            shape, _, where = rest.partition(" @")
            if where == scope:
                dims = tuple(int(x) for x in shape.strip("()").split(","))
                out.setdefault(name, []).append((dims, rec))
        return out

    dev = torch.device("cuda", 0)
    res: dict = {"multihost": {}}
    for n in sorted({int(k.rsplit("_", 2)[1]) for k in checks["shapes"]
                     if "@multihost_" in k}):
        cfg = mhw.config(0, n, "0", "cuda")
        replay = DevicePERFrameReplay(
            cfg.replay, dev, mhw.FRAME, stack=4, gamma=0.99, seed=0,
            write_chunk=mhw.WRITE_CHUNK, num_streams=mhw.STREAMS,
            num_shards=mhw.DEVICES,
            local_shards=list(range(mhw.DEVICES // n)))
        ring = replay.dstate["frames"]
        skip = replay.shard_rows - 1          # shard 0's scratch row
        got = shapes(f"multihost_{n}_0")
        res["multihost"][str(n)] = {
            "gather": [_p18_gather_row(torch, rg, ring, *dims)
                       for dims, _ in got.get("gather_windows", [])],
            "scatter": [_p18_scatter_row(
                torch, rg, ring, dims[0], max(rec["real_lanes"]), dims[1],
                skip) for dims, rec in got.get("scatter_rows", [])]}
        del replay, ring
        torch.cuda.empty_cache()
    replay = DevicePERFrameReplay(
        config.ReplayConfig(capacity=8192, batch_size=32, prioritized=True,
                            device_per=True),
        dev, (10, 10), stack=2, gamma=0.99, seed=0, write_chunk=64,
        num_streams=actor_envs)
    ring = replay.dstate["frames"]
    res["actor_flush"] = [
        _p18_scatter_row(torch, rg, ring, dims[0], max(rec["real_lanes"]),
                         dims[1], replay.shard_rows - 1)
        for dims, rec in shapes("actor_curve").get("scatter_rows", [])]
    del replay, ring
    torch.cuda.empty_cache()
    return res


def run_phase18() -> dict:
    """18: the bench's ``--quick`` command line in a ``--phase18-worker``
    child process (its rings, 8.19 GB for the flagship, are freed when it
    exits; its multi-process curve's workers are children of it), its one
    line parsed and checked, and its B1/B2 checks against the plain
    versions read, the workers' among them; the launches of all its rows
    summed per kernel, and the multi-process curve's alone. Then, each in
    a child process: ``bench --trace-ingest --quick`` (under the same
    checks), its line checked and its shard read by the port's
    ``trace_report --strict``; and ``bench_elasticity`` at 2 repeats."""
    from distributed_deep_q_tpu_torch import bench

    res = os.path.join(OUT_DIR, "p18_checks.json")
    with contextlib.suppress(FileNotFoundError):
        os.remove(res)
    line, seconds = p18_child(
        [sys.executable, os.path.abspath(__file__), "--phase18-worker", res],
        "bench", P18_TIMEOUT_S)
    check_bench_line(line, bench.KEPT + tuple(bench.PORT_ONLY))
    launches: dict[str, int] = {}
    multihost: dict[str, int] = {}
    for name, row in line["launches"].items():
        for k, n in row.items():
            launches[k] = launches.get(k, 0) + n
            if name.startswith("multihost_"):
                multihost[k] = multihost.get(k, 0) + n
    with open(res) as f:
        checks = json.load(f)
    log(f"[18] bench --quick: {seconds:.1f} s; {json.dumps(line)}")
    log(f"[18] launches {json.dumps(launches)}; multi-process curve "
        f"{json.dumps(multihost)}; {nvidia_smi_line()}")

    # --trace-ingest, under the same checks, its shard into OUT_DIR
    trace_dir = os.path.join(OUT_DIR, "p18_traces")
    shutil.rmtree(trace_dir, ignore_errors=True)
    tres = os.path.join(OUT_DIR, "p18_trace_checks.json")
    trace, trace_s = p18_child(
        [sys.executable, os.path.abspath(__file__), "--phase18-worker", tres,
         "--trace-ingest", "--quick", "--trace-dir", trace_dir],
        "trace_ingest", P18_TIMEOUT_S)
    check_trace_ingest_line(trace)
    with open(tres) as f:
        tchecks = json.load(f)
    checks["shapes"].update(tchecks["shapes"])
    checks["all_bitwise"] = checks["all_bitwise"] and tchecks["all_bitwise"]
    report = subprocess.run(
        [sys.executable, "-m", "distributed_deep_q_tpu_torch.trace_report",
         trace["trace_path"], "--strict", "--wall", str(trace["wall_s"]),
         "--out", os.path.join(trace_dir, "merged.json")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        timeout=120)
    with open(os.path.join(OUT_DIR, "p18_trace_report.txt"), "w") as f:
        f.write(report.stdout + report.stderr)
    assert report.returncode == 0, report.stdout[-3000:] + report.stderr
    log(f"[18] bench --trace-ingest --quick: {trace_s:.1f} s; "
        f"{json.dumps(trace)}; trace_report --strict: exit 0")

    elastic, elastic_s = p18_child(
        [sys.executable, "-m", "distributed_deep_q_tpu_torch.bench_elasticity",
         "--repeats", "2", "--tenant-repeats", "1"], "elasticity", 120)
    check_elasticity_line(elastic)
    log(f"[18] bench_elasticity: {elastic_s:.1f} s; {json.dumps(elastic)}")

    log(f"[18] B1/B2 against the plain versions: {json.dumps(checks)}")
    kinds = {k.split()[0] for k in checks["shapes"]}
    assert kinds == {"gather_windows", "scatter_rows"}, checks
    workers = {f"multihost_{n}_{pid}" for n in bench.QUICK.curves.
               multihost_hosts for pid in range(n)}
    scopes = {k.rsplit("@", 1)[-1] for k in checks["shapes"] if "@" in k}
    assert workers | {"trace_ingest"} <= scopes, scopes
    assert checks["all_bitwise"], checks

    import torch

    from distributed_deep_q_tpu_torch.ops import ring_gather as rg
    kernel_rows = p18_kernel_rows(torch, rg, checks,
                                  min(bench.QUICK.curves.envs))
    log(f"[18] B1/B2 at the workers' and the actor flush's shapes: "
        f"{json.dumps(kernel_rows)}")
    for part in [*kernel_rows["multihost"].values(),
                 {"scatter": kernel_rows["actor_flush"]}]:
        for row in [*part.get("gather", []), *part["scatter"]]:
            assert row["max_abs_err"] == 0, row
    return {"line": line, "seconds": seconds, "launches": launches,
            "multihost_launches": multihost, "checks": checks,
            "trace_ingest": trace, "elasticity": elastic,
            "kernel_rows": kernel_rows}


def phase18_only() -> int:
    """``chip_smoke.py --phase18``: phase 18 alone, after the build."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from distributed_deep_q_tpu_torch.ops import cuda_build
    os.makedirs(OUT_DIR, exist_ok=True)
    log(nvidia_smi_line())
    log(f"[2] build: {cuda_build.build_all()}")
    run_phase18()
    return 0


def main() -> int:
    import torch

    # -- 1. device ------------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    try:
        from distributed_deep_q_tpu_torch import config, learning
        from distributed_deep_q_tpu_torch import metrics as metrics_mod
        from distributed_deep_q_tpu_torch import profiling, tracing
        from distributed_deep_q_tpu_torch import telemetry_report
        from distributed_deep_q_tpu_torch import train as train_mod
        from distributed_deep_q_tpu_torch.actors.game import make_env
        from distributed_deep_q_tpu_torch.actors.supervisor import (
            actor_epsilon)
        from distributed_deep_q_tpu_torch.ops import threefry
        from distributed_deep_q_tpu_torch.ops.device_envs import (
            make_device_env)
        from distributed_deep_q_tpu_torch.parallel import anakin
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

    # -- 1b. the static-analysis gate ------------------------------------------
    gate = analysis_gate()
    log(f"[1b] analysis gate: {json.dumps(gate)}")
    assert gate["findings"] == 0, (
        f"the analysis gate found {gate['findings']} finding(s)")
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
    summary, launches, record = run_cli(cli_main, counters, PONG_MAIN_ARGV,
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
    gate = r2d2_gate(torch, config, counters, (
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

    # -- 11. the distributed topology: Pong, all four kernels ---------------
    control = context_control()
    log(f"[11] a spawned child holding a CUDA context (the control of the "
        f"actors' check): {json.dumps(control)}")
    assert control["card_files"], control
    assert control["compute_apps"] == control["compute_apps_after"] + 1, \
        control
    all_kernels = tuple(counters)
    dist = {}
    for tag, argv, jsonl, fleet, grad, fill, kernels in (
            ("11", DIST_PONG_ARGV, "chip_smoke_dist_pong.jsonl", 4, 400,
             ("env_steps", 8192), all_kernels),
            ("11b", DIST_BREAKOUT_ARGV, "chip_smoke_dist_breakout.jsonl", 4,
             100, ("env_steps", 8192), ("fused_loss_fwd", "fused_loss_bwd")),
            ("11c", DIST_R2D2_ARGV, "chip_smoke_dist_r2d2.jsonl", 2, 100,
             ("replay_size", 5120 // 80),
             ("gather_windows", "scatter_rows"))):
        out = distributed_run(cli_main, counters, argv, jsonl, fleet)
        s = out["summary"]
        log(f"[{tag}] summary: {json.dumps(s)}")
        log(f"[{tag}] launches: {json.dumps(out['launches'])}; no actor "
            f"holds a CUDA context ({out['cuda_context']['check']} check): "
            f"{json.dumps(out['cuda_context'])}")
        log(f"[{tag}] grad steps/s {s['grad_steps_per_s']} (last window), "
            f"the fleet's env steps/s {s['env_steps_per_s']} ({fleet} actor "
            f"processes on the host), wall {s['wall_s']:.1f} s; "
            + json.dumps(out["printed"]))
        check_distributed_run(out, grad, fill, kernels)
        dist[tag] = out
        gc.collect()
        torch.cuda.empty_cache()
    pcfg = config.pong_config()
    pcfg.env.kind, pcfg.env.id = "signal_atari", "signal"
    pong_random = random_policy_return(make_env, pcfg.env,
                                       pcfg.train.eval_episodes)
    log(f"[11] eval_return {dist['11']['summary']['eval_return']} beside "
        f"the random policy's {pong_random} (printed, not held: a few "
        "hundred grad steps at the preset's lr, as in phase 4)")

    # -- 12a. BatchedPolicy on the card ---------------------------------------
    pol = batched_policy(torch, config)
    for row in pol["buckets"]:
        log(f"[12a] bucket {json.dumps(row)}")
    log(f"[12a] θ install {pol['install_ms']} ms; {pol['params']} "
        f"parameters, {pol['macs_per_row']} multiply-adds per row; an "
        f"actor's batch-1 forward on one CPU thread "
        f"{pol['actor_batch1_cpu_one_thread_ms']} ms; compiled buckets "
        f"{pol['compiled_buckets']}")
    check_batched_policy(pol, pcfg.inference.buckets)
    gc.collect()
    torch.cuda.empty_cache()

    # -- 12b. the served fleet: phase 11 with the inference plane ----------
    served_jsonl = "chip_smoke_dist_pong_served.jsonl"
    served = distributed_run(cli_main, counters, DIST_PONG_ARGV + SERVED_SET,
                             served_jsonl, SERVED_FLEET)
    s = served["summary"]
    log(f"[12b] summary: {json.dumps(s)}")
    log(f"[12b] launches: {json.dumps(served['launches'])}; no actor holds "
        f"a CUDA context ({served['cuda_context']['check']} check): "
        f"{json.dumps(served['cuda_context'])}")
    check_distributed_run(served, 400, ("env_steps", 8192), all_kernels)
    served_read = check_served_fleet(served, served_jsonl, telemetry_report)
    last = served_read.pop("last_record")
    log(f"[12b] the fleet's env steps/s {s['env_steps_per_s']} (4 actor "
        f"processes × 8 envs, served) beside phase 11's "
        f"{dist['11']['summary']['env_steps_per_s']} (4 × 1, local); grad "
        f"steps/s {s['grad_steps_per_s']} beside phase 11's "
        f"{dist['11']['summary']['grad_steps_per_s']} (last window); wall "
        f"{s['wall_s']:.1f} s")
    infer_keys = {k: last.get(k) for k in SERVED_PRINTED}
    log(f"[12b] inference: {json.dumps(infer_keys)}; requests "
        f"{s['inference_requests']}, sheds {s['inference_sheds']}, compiled "
        f"buckets "
        f"{s['inference_compiled_buckets']}, θ pulls "
        f"{s['inference_param_pulls']}")
    log(f"[12b] {json.dumps(served['printed'])}; eval_return "
        f"{s['eval_return']} beside the random policy's {pong_random}; "
        f"health verdicts {served_read['verdicts']}, autoscale decisions "
        f"{served_read['decisions']}, elastic_problems "
        f"{served_read['elastic_problems']}")
    gc.collect()
    torch.cuda.empty_cache()

    # -- 13. the learning-dynamics plane on the card ---------------------------
    lm_summary, lm_launches, lm_record = run_cli(
        cli_main, counters, LM_ARGV, "chip_smoke_learn_plane.jsonl")
    log(f"[13] breakout fused path, learn_metrics on: "
        f"{json.dumps(lm_summary)}")
    lm_hist = check_learn_plane_run(lm_summary, lm_record, lm_launches)
    log(f"[13] launches: {json.dumps(lm_launches)}; learn gauges: "
        + json.dumps({k: lm_record[k] for k in LEARN_GAUGES})
        + f"; {json.dumps(lm_hist)}")
    gc.collect()
    torch.cuda.empty_cache()
    lm_gate = learn_plane_gate(torch, config, Solver, DevicePERFrameReplay,
                               learning)
    log(f"[13] gate off vs on, plane vs CPU lm_update: "
        f"{json.dumps(lm_gate)}")
    assert not lm_gate["state_diffs"], lm_gate["state_diffs"]
    assert lm_gate["prio_equal"] and lm_gate["maxp_equal"], lm_gate
    assert lm_gate["metrics_equal"] and lm_gate["plane_calls"] == 8, lm_gate
    assert lm_gate["counts_equal"], "plane counts differ from lm_update"
    assert lm_gate["sums_max_rel_err"] <= 1e-5, lm_gate
    assert lm_gate["extrema_bitwise"] and lm_gate["prio_max_ulps"] <= 2, \
        lm_gate
    assert lm_gate["plane_steps"] == 8, lm_gate
    assert lm_gate["hist_total"] == lm_gate["plane_samples"] == 8 * 512
    log(f"[13] ms per chain-8 dispatch: gate off "
        f"{lm_gate['ms_per_chain8_dispatch_gate_off']}, gate on "
        f"{lm_gate['ms_per_chain8_dispatch_gate_on']}; learn_overhead_pct "
        f"{lm_gate['learn_overhead_pct']}")
    gc.collect()
    torch.cuda.empty_cache()

    # -- 13b. RMSProp on the card ------------------------------------------
    rm_summary, rm_launches, rm_record = run_cli(
        cli_main, counters, RMS_ARGV, "chip_smoke_rmsprop.jsonl")
    log(f"[13b] pong fused path under rmsprop: {json.dumps(rm_summary)}")
    log(f"[13b] launches: {json.dumps(rm_launches)}; eval_return "
        f"{rm_summary['eval_return']} beside the random policy's "
        f"{pong_random} (printed, not held)")
    check_path(rm_summary, CUT_GRAD_STEPS)
    assert rm_launches["gather_windows"] >= CUT_GRAD_STEPS, rm_launches
    rm_cross = rmsprop_cross_device(torch, config, Solver,
                                    DevicePERFrameReplay, checkpoint)
    log(f"[13b] card vs CPU rmsprop step, checkpoint restore: "
        f"{json.dumps(rm_cross)}")
    assert rm_cross["max_abs_dtheta"] <= 1e-6, rm_cross
    assert rm_cross["moments_max_err_over_leaf_max"] <= 1e-3, rm_cross
    assert not rm_cross["restore_diffs"], rm_cross
    assert rm_cross["optimizer"] == "rmsprop", rm_cross
    gc.collect()
    torch.cuda.empty_cache()

    # -- 14. Anakin on the card ----------------------------------------------
    pin = anakin_pin(torch, config, (Solver, DevicePERFrameReplay, anakin,
                                     threefry, make_device_env,
                                     actor_epsilon))
    log(f"[14] pin against the host twin, and the learning smoke: "
        f"{json.dumps(pin)}")
    assert not pin["pin_diffs"], pin["pin_diffs"]
    assert pin["grad_steps"] == 6, pin
    assert pin["act_reward_40"] > 0.30, pin
    a_shape = anakin_kernel_shapes(torch, rg, dev, empty_ms)
    log(f"[14] scatter_rows at the superstep's insert shape: "
        f"{json.dumps(a_shape)}")
    assert a_shape["max_abs_err"] == 0, a_shape
    gc.collect()
    torch.cuda.empty_cache()
    ana = anakin_full(torch, config, counters, (anakin, threefry), make_env,
                      train_mod)
    log(f"[14] anakin at full width: {json.dumps(ana)}")
    log(f"[14] env steps/s {ana['env_steps_per_s']}, grad steps/s "
        f"{ana['grad_steps_per_s']}; ms per superstep {ana['ms_per_superstep_wall']} "
        f"(wall), {ana['ms_per_superstep_device']} (CUDA events); stages "
        f"(device ms) {json.dumps(ana['stage_device_ms'])}; launches per "
        f"superstep {ana['launches_per_superstep']}, threefry's share "
        f"{ana['threefry_share_of_launches']}; B1/B2 per launch "
        f"{json.dumps(ana['port_kernels'])}; eval_return "
        f"{ana['eval_return']} beside the random policy's "
        f"{ana['random_policy_return']}")
    for name in counters:
        assert ana["launches"][name] > 0, (name, ana["launches"])
    assert not ana["sync_warnings"], ana["sync_warnings"]
    assert ana["eval_return"] > ana["random_policy_return"], ana
    assert all(math.isfinite(x) for x in ana["last_loss"]), ana
    gc.collect()
    torch.cuda.empty_cache()

    # -- 15. the sharded ring: mesh.dp = 8 -----------------------------------
    d8 = sharded_main_path(torch, cli_main, counters, train_mod)
    d8_solver, d8_replay = d8.pop("solver"), d8.pop("replay")
    d8_summary, d8_launches = d8["summary"], d8["launches"]
    log(f"[15a] pong mesh.dp=8 summary: {json.dumps(d8_summary)}")
    log(f"[15a] (solver shards, replay shards, sub-rings per shard, rows "
        f"per sub-ring) {d8['shards']}; launches: {json.dumps(d8_launches)}")
    log(f"[15a] grad steps/s {d8_summary['grad_steps_per_s']} (phase 4, "
        f"one shard: {summary['grad_steps_per_s']}); the loop's phases: "
        f"{json.dumps(d8['loop'])}; census of 4 chain-8 dispatches: "
        f"{json.dumps(d8['census'])}")
    check_path(d8_summary, D8_GRAD_STEPS)
    assert d8["shards"][:2] == [D8, D8], d8["shards"]
    assert d8_launches["gather_windows"] >= d8_summary["grad_steps"], \
        d8_launches
    assert d8_launches["scatter_rows"] > 0, d8_launches
    cost = shard_cost(torch, config, Solver, DevicePERFrameReplay)
    log(f"[15a] ms per chain-8 grad step, D=1 and D=8 in turns: "
        f"{json.dumps(cost)}")
    gc.collect()
    torch.cuda.empty_cache()
    d8_cross = sharded_cross_device_check(torch, config, Solver,
                                          DevicePERFrameReplay, learner_mod)
    log(f"[15a] card vs CPU at D=8, no uniforms injected: "
        f"{json.dumps(d8_cross)}")
    check_sharded_cross(d8_cross)
    d8_resume = sharded_resume(torch, persistence, train_mod, learner_mod,
                               d8_solver, d8_replay)
    log(f"[15c] the 15a replay saved at D=8 and loaded into a fresh one: "
        f"{json.dumps(d8_resume)}")
    assert not d8_resume["state_diffs"], d8_resume
    assert not d8_resume["sample_diffs"], d8_resume
    assert d8_resume["shards_sampled"] == D8, d8_resume
    del d8_solver, d8_replay
    gc.collect()
    torch.cuda.empty_cache()
    d8_k = sharded_ring_kernels(torch, rg, dev, empty_ms)
    log(f"[15b] B1 and B2 at the D=8 shapes beside D=1's: {json.dumps(d8_k)}")
    check_sharded_kernels(d8_k)
    gc.collect()
    torch.cuda.empty_cache()
    d8_pin = anakin_pin(torch, config, (Solver, DevicePERFrameReplay, anakin,
                                        threefry, make_device_env,
                                        actor_epsilon), dp=D8)
    log(f"[15d] anakin at D=8 against its host twin: {json.dumps(d8_pin)}")
    assert not d8_pin["pin_diffs"], d8_pin["pin_diffs"]
    assert d8_pin["shards"] == D8 and d8_pin["grad_steps"] == 6, d8_pin
    gc.collect()
    torch.cuda.empty_cache()

    # -- 16. two learner processes on the one card ---------------------------
    t16 = time.perf_counter()
    # B3/B4 at one of two processes' rows (B = 256), as phase 3b at 512
    loss256 = check_fused_loss(torch, fl, dev, b=256)
    log(f"[16] fused loss at B=256: {json.dumps(loss256)}")
    assert loss256["td_max_abs_err"] == 0, "B3 |td| disagrees at B=256"
    assert loss256["dq_max_abs_err"] == 0, "B4 dq disagrees at B=256"
    assert loss256["loss_max_rel_err"] <= 1e-6, loss256
    # B1 at one of two processes' shapes: 2,048 windows on 16b's ring of
    # one shard, as phase 3 at 512 and 4,096 on the whole ring
    gen = torch.Generator(device=dev).manual_seed(16)
    ring16 = torch.randint(-2**31, 2**31 - 1, (P16_SHARD_ROWS * ROWB // 4,),
                           dtype=torch.int32, device=dev, generator=gen)
    gather16 = check_gather(torch, rg, ring16, dev, P16_GATHER_N,
                            rows=P16_SHARD_ROWS)
    del ring16
    torch.cuda.empty_cache()
    log(f"[16] gather_windows at one process's shape: "
        f"{json.dumps(gather16)}")
    assert gather16["max_abs_err"] == 0, "B1 disagrees at n=2048"
    assert gather16["windows_past_2^31_bytes"] > 0, gather16
    pin16 = check_phase16_pin()
    d16 = phase16_cli("dist", P16_DIST_ARGV)
    h16 = phase16_cli("host", P16_HOST_ARGV)
    for tag, res in (("16b", d16), ("16c", h16)):
        for r in res:
            ctx = r.pop("cuda_context")
            log(f"[{tag}] process {r['pid']}: {json.dumps(r)}")
            if ctx is not None:
                log(f"[{tag}] process {r['pid']}'s actors and the card "
                    f"({ctx['check']} check): {json.dumps(ctx)}")
                assert ctx["samples_full_fleet_training"] > 0, ctx
                assert not ctx["actors_holding_cuda"], ctx
                if not ctx["check"].startswith("nvidia-smi pids"):
                    # this process and the two learners
                    assert ctx["compute_apps_max"] <= 3, ctx
    check_phase16_cli(d16, 200, ("gather_windows", "scatter_rows"))
    assert [r["ring_shard_rows"] for r in d16] == [P16_SHARD_ROWS] * 2, \
        [r["ring_shard_rows"] for r in d16]
    check_phase16_cli(h16, 100, ("fused_loss_fwd", "fused_loss_bwd"))
    for r in d16:
        s16 = r["summary"]
        assert s16["env_steps"] >= 8192, s16      # each process's shard fed
        assert s16["actor_restarts"] == 0, s16
        assert s16["rpc_checksum_errors"] == 0, s16
        assert s16["rpc_dispatch_errors"] == 0, s16
    log(f"[16] grad steps/s per process (last window): 16b "
        f"{[r['summary']['grad_steps_per_s'] for r in d16]} beside phase "
        f"11's {dist['11']['summary']['grad_steps_per_s']} (one process); "
        f"16c {[r['summary']['grad_steps_per_s'] for r in h16]} beside "
        f"phase 6's {b_summary['grad_steps_per_s']} and 6b's "
        f"{h_summary['grad_steps_per_s']} (one process)")
    log(f"[16] ms per grad step inside the train step's collectives (host "
        f"clock): 16b {[p16_collective_ms(r) for r in d16]}, 16c "
        f"{[p16_collective_ms(r) for r in h16]}; phase 16 wall "
        f"{time.perf_counter() - t16:.1f} s")

    # -- 17. the chaos and soak gates ------------------------------------------
    p17_preflight()
    p17 = run_phase17(torch, counters, {"rg": rg})

    # -- 18. the bench --------------------------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    p18 = run_phase18()

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
         "ok": (g512["max_abs_err"] == 0 and g4096["max_abs_err"] == 0
                and gather16["max_abs_err"] == 0),
         "shape": "n=512 w=5 rowb=8192", "path": "phase 4 (pong)",
         "chain8": {k: g4096[k] for k in ("ms", "plain_ms", "bound_ms",
                                          "library_ms", "max_abs_err",
                                          "host_ms")},
         # one of two processes' draw: chain 8 x 256 rows on 16b's ring
         "two_process_chain8": {k: gather16[k] for k in (
             "n", "rows", "ms", "plain_ms", "bound_ms", "library_ms",
             "max_abs_err", "host_ms")}},
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
    # the Anakin superstep's shapes (phase 14): B1's sample stage draws
    # chain 8 × 512 windows of 5 rows, phase 3's n = 4096 shape; B2's
    # insert is 2·T·E = 2,048 lanes
    ana_k = ana["port_kernels"]
    kernels[0]["anakin"] = dict(
        {k: g4096[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms",
                               "max_abs_err", "host_ms")},
        shape="n=4096 w=5 rowb=8192 (superstep sample stage)",
        launches=ana["launches"]["gather_windows"], path="phase 14 (anakin)",
        in_trace_us_per_launch=ana_k.get("gather_windows", {}).get(
            "us_per_launch"))
    kernels[1]["ok"] = kernels[1]["ok"] and a_shape["max_abs_err"] == 0
    kernels[1]["anakin"] = dict(
        {k: a_shape[k] for k in ("lanes", "real_lanes", "ms", "host_ms",
                                 "plain_ms", "bound_ms", "library_ms",
                                 "max_abs_err")},
        shape=f"n={a_shape['lanes']} lanes, {a_shape['real_lanes']} real "
              "(superstep insert), rowb=8192",
        launches=ana["launches"]["scatter_rows"], path="phase 14 (anakin)",
        in_trace_us_per_launch=ana_k.get("scatter_rows", {}).get(
            "us_per_launch"))
    # the D = 8 shapes (phase 15b) and 15a's launches
    d8_trace = d8["census"]["port_kernels"]
    kernels[0]["ok"] = kernels[0]["ok"] and \
        d8_k["gather_d8"]["max_abs_err"] == 0
    kernels[0]["d8"] = dict(
        {k: d8_k["gather_d8"][k] for k in (
            "ms", "host_ms", "plain_ms", "bound_ms", "library_ms",
            "max_abs_err")},
        shape="n=4096 w=5 rowb=8192, 512 windows in each of 8 shards "
              "(chain 8)", launches=d8_launches["gather_windows"],
        path="phase 15a (pong, mesh.dp=8)",
        in_trace_us_per_launch=d8_trace.get("gather_windows", {}).get(
            "us_per_launch"),
        d1_same_ring={k: d8_k["gather_d1"][k] for k in (
            "ms", "host_ms", "plain_ms", "library_ms")})
    kernels[1]["ok"] = kernels[1]["ok"] and \
        d8_k["scatter_d8"]["max_abs_err"] == 0
    kernels[1]["d8"] = dict(
        {k: d8_k["scatter_d8"][k] for k in (
            "lanes", "real_lanes", "ms", "host_ms", "plain_ms", "bound_ms",
            "library_ms", "max_abs_err")},
        shape="n=1024 lanes over 8 shards, 32 real (pre-dispatch flush of "
              "8 shards), rowb=8192", launches=d8_launches["scatter_rows"],
        path="phase 15a (pong, mesh.dp=8)",
        d1_same_ring={k: d8_k["scatter_d1"][k] for k in (
            "lanes", "real_lanes", "ms", "host_ms", "plain_ms",
            "library_ms")})
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
                                         "composition_ms", "host_ms")},
             "a6": dict({k: loss_k["a6"][part][k] for k in (
                 "ms", "plain_ms", "bound_ms", "composition_ms",
                 "host_ms")}, shape="B=512 A=6 delta=1",
                 path="phase 18 (the bench's pallas_on row)",
                 launches=p18["line"]["launches"]["pallas_on"][name])})
    bwd_row = kernels[-1]
    bwd_row.update({k: loss_k["a4"]["bwd"][k] for k in (
        "autograd_host_ms", "autograd_grad_host_ms")})
    bwd_row["a18"].update({k: loss_k["a18"]["bwd"][k] for k in (
        "autograd_host_ms", "autograd_grad_host_ms")})
    bwd_row["widths_checked"] = sorted({c["a"] for c in loss_k["bwd_widths"]})
    # one of two processes' rows (phase 16c's shape)
    for row, part in ((kernels[-2], "fwd"), (kernels[-1], "bwd")):
        row["ok"] = row["ok"] and loss256[
            "td_max_abs_err" if part == "fwd" else "dq_max_abs_err"] == 0
        row["b256"] = dict(
            {k: loss256["a4"][part][k] for k in (
                "ms", "host_ms", "plain_ms", "bound_ms", "composition_ms",
                "bytes")},
            shape="B=256 A=4 delta=1 (one of two processes)",
            path="phase 16c (breakout host-sampled, 2 processes)",
            launches=[r["launches"][row["name"]] for r in h16])
    # every path's launches, each path's counts set to 0 just before it
    by_path = {"4 pong": launches, "6 breakout host-sampled": b_launches,
               "6b breakout host FrameStackReplay": h_launches,
               "7 r2d2": r_launches, "7b r2d2 fused": f_launches,
               "8 pong train": p_resume["launches"][0],
               "8 pong resumed": p_resume["launches"][1],
               "8b r2d2 train": r_resume["launches"][0],
               "8b r2d2 resumed": r_resume["launches"][1],
               "8c r2d2 motion gate": gate["launches"],
               "10 feed": feed["launches"],
               "11 pong distributed": dist["11"]["launches"],
               "11b breakout distributed host-sampled":
                   dist["11b"]["launches"],
               "11c r2d2 distributed": dist["11c"]["launches"],
               "12b pong served fleet": served["launches"],
               "13 breakout learn plane": lm_launches,
               "13b pong rmsprop": rm_launches,
               "14 anakin": ana["launches"],
               "15a pong mesh.dp=8": d8_launches,
               "16a pin, 1 process": pin16["launches"][0],
               "16a pin, 2 processes, rank 0": pin16["launches"][1],
               "16a pin, 2 processes, rank 1": pin16["launches"][2],
               "16b pong distributed, 2 processes, rank 0":
                   d16[0]["launches"],
               "16b pong distributed, 2 processes, rank 1":
                   d16[1]["launches"],
               "16c breakout host-sampled, 2 processes, rank 0":
                   h16[0]["launches"],
               "16c breakout host-sampled, 2 processes, rank 1":
                   h16[1]["launches"],
               "17a chaos ingest": p17["launches"]["17a"],
               "17b chaos inference": p17["launches"]["17b"],
               "17c chaos vector": p17["launches"]["17c"],
               "17d chaos tenants": p17["launches"]["17d"],
               "17e chaos train": p17["launches"]["17e"],
               "17f pixel fleet soak, 64 streams": p17["launches"]["17f"],
               "18 bench": p18["launches"],
               **{f"18 bench {row}": p18["line"]["launches"][row]
                  for row in ("ingest_curve", "actor_curve",
                              "inference_curve")},
               "18 bench multihost_curve (every worker)":
                   p18["multihost_launches"],
               "18 bench --trace-ingest": p18["trace_ingest"]["launches"]}
    # phases 17 and 18's B1/B2 launches held against the plain versions
    for row in kernels[:2]:
        def mine(shapes: dict) -> dict:
            return {k: v for k, v in shapes.items()
                    if k.startswith(row["name"])}
        checked = {tag: mine(p17[tag]["checks"]["shapes"])
                   for tag in ("17a", "17f")}
        row["phase17_checked_vs_plain"] = checked
        row["phase18_checked_vs_plain"] = mine(p18["checks"]["shapes"])
        row["ok"] = row["ok"] and all(
            r["bitwise"] == r["checked"]
            for c in [*checked.values(), row["phase18_checked_vs_plain"]]
            for r in c.values())
    g6 = p17["gather_w6"]
    kernels[0]["ok"] = kernels[0]["ok"] and g6["max_abs_err"] == 0
    kernels[0]["soak"] = dict(
        {k: g6[k] for k in ("ms", "host_ms", "plain_ms", "bound_ms",
                            "library_ms", "max_abs_err")},
        shape="n=512 w=6 rowb=8192 (n-step 2)",
        launches=p17["launches"]["17f"]["gather_windows"],
        path="phase 17f (pixel fleet soak, 64 streams)")
    # phase 18's multi-process workers' shapes (process 0's at each
    # count; the launches are every worker's) and the actor curve's flush
    kr, p18_launches = p18["kernel_rows"], p18["line"]["launches"]
    for row, part in ((kernels[0], "gather"), (kernels[1], "scatter")):
        row["multihost_workers"] = {
            n: [dict(r, launches=[p18_launches[f"multihost_{n}_{pid}"][
                row["name"]] for pid in range(int(n))],
                path=f"phase 18 (bench multihost_curve, {n} processes)")
                for r in rows[part]]
            for n, rows in kr["multihost"].items()}
    kernels[1]["actor_flush"] = [
        dict(r, launches=p18_launches["actor_curve"]["scatter_rows"],
             path="phase 18 (bench actor_curve)")
        for r in kr["actor_flush"]]
    for row in kernels:
        row["launches_by_path"] = {path: counts[row["name"]]
                                   for path, counts in by_path.items()}
    log(json.dumps({"phase_seconds": phase_seconds(),
                    "total_s": round(time.perf_counter() - _T0, 1)}))
    log(json.dumps({"kernels": kernels}))
    log(nvidia_smi_line())
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    try:
        if sys.argv[1:2] == ["--phase5"]:
            code = phase5_trees(sys.argv[2:])
        elif sys.argv[1:2] == ["--phase16a"]:
            code = phase16a_only()
        elif sys.argv[1:2] == ["--phase17"]:
            code = phase17_only()
        elif sys.argv[1:2] == ["--phase1b"]:
            code = phase1b_only()
        elif sys.argv[1:2] == ["--phase18"]:
            code = phase18_only()
        elif sys.argv[1:2] == ["--phase17f-worker"]:
            code = p17_soak_worker(sys.argv[2:])
        elif sys.argv[1:2] == ["--phase18-worker"]:
            code = p18_bench_worker(sys.argv[2:])
        elif sys.argv[1:2] == ["--phase18-mh-worker"]:
            code = p18_mh_worker(sys.argv[2:])
        elif sys.argv[1:2] == ["--phase16-worker"]:
            code = p16_worker(sys.argv[2:])
        else:
            code = main()
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        code = 1
    sys.exit(code)
