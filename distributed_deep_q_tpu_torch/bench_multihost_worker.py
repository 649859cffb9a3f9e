"""One learner process of the bench's multi-process curve (port of the
reference's ``scripts/_bench_multihost_worker.py``).

    python -m distributed_deep_q_tpu_torch.bench_multihost_worker \\
        PID NPROC PORT OUT TARGET [--device cuda|cpu] [--reps N]
        [--rep-s S] [--settle-reps N]

``bench._multihost_curve`` starts NPROC of these at 1, 2 and 4 processes
and reads each one's JSON file ``OUT``. Every process owns a whole local
data plane: its block of ``D / NPROC`` replay shards
(``parallel/mesh.local_shards``) in its own ``DevicePERFrameReplay``, a
``ReplayFeedServer`` whose ``IngestDrain`` flushes into that ring, fed
only by this process's hash-assigned writers
(``actors/assignment.local_slice``), its own fused PER sampling and its
own priority write-back. The one interaction between processes is the
train step's gradient mean over ``gloo`` (``parallel/multihost.py``),
which is what the curve measures.

The workload is fixed globally at every process count (strong scaling):
the global batch, ring capacity, shard count and ingest target are the
constants below, and each of the NPROC processes carries 1/NPROC of each.
On the card every process takes ``cuda:0`` of the one H100 and they
time-slice it, as the reference's processes time-slice the CPU cores; so
the point's headline is the aggregate rate (wall grad steps/s × NPROC),
which stays linear in NPROC as long as the sharing costs (the all-reduce
and the host work of each process) stay small.

Every process runs the same number of dispatches (warm-up, calibration,
settle and reps; the per-rep count agreed through
``multihost.global_max_int``), so the collectives of the train steps pair
up across processes. Each dispatch runs under the feed server's replay
lock and is followed by the reference's 10 ms yield, so the serve threads
get the lock between dispatches; where a writer's RPC was queued at the
release, the yield lasts until it is served (at most ``HANDOFF_S``: a
loaded host need not wake its serve thread within 10 ms, and the lock is
not granted in order). A rep ends in the device→host fence
(``bench._fence``).

The reference also agrees a lockstep flush round count before each
flush (its flush program is a global-array computation every process
must enter the same number of times). The port has no deferred flush
(ROADMAP slice 12): each process's drain writes only its own shards'
tensors, with no collective, so there is nothing to agree on.

Beside the reference's fields the output carries ``launches``: each
kernel wrapper's launches in this process over the whole run (B1 per
dispatch, B2 per flush; 0 on the CPU, where the wrappers take their
plain versions).

``--reps``, ``--rep-s`` and ``--settle-reps`` set the depth only (the
reference's: 5 reps of about 2 s, a settle of one rep's dispatches plus
2); the widths are the constants.
"""

from __future__ import annotations

import argparse
import json
import threading
import time
import traceback

import numpy as np

# the fixed global workload: the same at every process count
DEVICES = 4          # global replay shards (mesh.dp)
BATCH = 64           # global train batch
CAPACITY = 8192      # global frame-ring capacity
STREAMS = 2          # writer streams per process (fleet = STREAMS × NPROC)
CHAIN = 8            # fused grad steps per dispatch
FRAME = (36, 36)     # the Nature conv stack's smallest frame
WRITE_CHUNK = 32
PREFILL_PER_HOST = 480
REPS = 5
WRITER_ROWS = 256    # rows per writer RPC
REP_S = 2.0          # each rep's target seconds (sizes its dispatch count)
SETTLE_REPS = 1      # settle dispatches: this many reps' worth, plus 2
YIELD_S = 0.01       # the reference's yield after each dispatch
HANDOFF_S = 1.0      # the longest the yield waits for the queued writers
WRITER_TIMEOUT_S = 120.0  # a writer's RPC deadline (the client's: 30 s)


def _writer(client, stop, rate_tps: float, seed: int, counter, ci: int,
            errs: list, rpcs: list):
    """Paced RPC writer for one local stream: frames, actions and rewards
    from the stream's own rng, short episodes so slots seal steadily.
    ``rpcs[ci]`` is ``[in flight, RPCs done]``, which the dispatch loop
    reads to hand the lock over."""
    rng = np.random.default_rng(seed)
    # big batches: the dispatch loop holds the replay lock for most of a
    # step, so each yield between dispatches admits about one RPC per
    # writer, and the rows it carries set the achievable ingest rate
    rows = WRITER_ROWS
    period = rows / max(rate_tps, 1e-6)
    nxt = time.perf_counter()
    while not stop.is_set():
        batch = {
            "frame": rng.integers(0, 255, (rows,) + FRAME, dtype=np.uint8),
            "action": rng.integers(0, 4, rows).astype(np.int32),
            "reward": rng.standard_normal(rows).astype(np.float32),
            "done": (rng.random(rows) < 1 / 9).astype(bool),
        }
        rpcs[ci][0] = True
        try:
            resp = client.add_transitions(**batch)
        except Exception:
            if not stop.is_set():  # teardown races are expected
                errs.append(traceback.format_exc())
            return
        finally:
            rpcs[ci][0] = False
            rpcs[ci][1] += 1
        if resp.get("ok"):
            counter[ci] += rows
        nxt += period
        delay = nxt - time.perf_counter()
        if delay > 0:
            stop.wait(delay)


def config(pid: int, nproc: int, port: str, device: str):
    """The worker's ``Config``: the reference's nets and replay at
    ``mesh.dp = DEVICES``, process ``pid`` of ``nproc``."""
    from distributed_deep_q_tpu_torch.config import (
        Config, MeshConfig, NetConfig, ReplayConfig)

    cfg = Config()
    cfg.mesh = MeshConfig(backend=device, num_fake_devices=DEVICES,
                          dp=DEVICES, coordinator=f"127.0.0.1:{port}",
                          num_processes=nproc, process_id=pid)
    cfg.net = NetConfig(kind="nature_cnn", num_actions=4, frame_shape=FRAME)
    cfg.replay = ReplayConfig(capacity=CAPACITY, batch_size=BATCH, n_step=2,
                              prioritized=True, device_per=True,
                              write_chunk=WRITE_CHUNK)
    return cfg


def make_replay(cfg, solver):
    """This process's block of the global ring."""
    from distributed_deep_q_tpu_torch.replay.device_per import (
        DevicePERFrameReplay)

    return DevicePERFrameReplay(
        cfg.replay, solver.device, FRAME, stack=4, gamma=0.99, seed=0,
        write_chunk=WRITE_CHUNK, num_streams=STREAMS,
        num_shards=solver.num_shards, local_shards=solver.local_shards)


def prefill(replay, pid: int) -> None:
    """Fill this process's streams directly (no pacing), then flush: the
    reference worker's prefill, row for row."""
    rng = np.random.default_rng(1000 + pid)
    per_stream = PREFILL_PER_HOST // STREAMS
    for s in range(STREAMS):
        replay.add_batch({
            "frame": rng.integers(0, 255, (per_stream,) + FRAME,
                                  dtype=np.uint8),
            "action": rng.integers(0, 4, per_stream).astype(np.int32),
            "reward": rng.standard_normal(per_stream).astype(np.float32),
            "done": (np.arange(per_stream) % 9 == 8),
        }, stream=s)
    replay.flush()


def run(pid: int, nproc: int, port: str, out_path: str, target_tps: float,
        device: str = "cuda", reps: int = REPS, rep_s: float = REP_S,
        settle_reps: int = SETTLE_REPS) -> dict:
    """One process of the point: build, prefill, serve and dispatch;
    write the JSON to ``out_path`` and return it. The caller has joined
    the group (``multihost.initialize_multihost``)."""
    from distributed_deep_q_tpu_torch.actors.assignment import local_slice
    from distributed_deep_q_tpu_torch.bench import _fence, _kernels
    from distributed_deep_q_tpu_torch.parallel.multihost import (
        all_processes_ready, global_max_int)
    from distributed_deep_q_tpu_torch.rpc.replay_server import (
        ReplayFeedClient, ReplayFeedServer)
    from distributed_deep_q_tpu_torch.solver import Solver

    kernels = _kernels()
    for fn in kernels.values():
        fn.launches = 0
    cfg = config(pid, nproc, port, device)
    solver = Solver(cfg)
    replay = make_replay(cfg, solver)
    prefill(replay, pid)
    assert all_processes_ready(replay.ready(BATCH)), \
        "prefill left a shard empty: every process must be sampleable"

    # the local data plane: this process's feed server (its drain flushes
    # into this ring) and the writers the hash ring assigns to it (the
    # wire's actor_id is the local stream, the supervisor's mapping)
    server = ReplayFeedServer(replay)
    fleet = STREAMS * nproc
    gids = local_slice(fleet, nproc, pid)
    stop = threading.Event()
    counter = [0] * STREAMS
    rpcs = [[False, 0] for _ in range(STREAMS)]
    errs: list[str] = []
    writers = []
    clients = []
    for s in range(STREAMS):
        client = ReplayFeedClient("127.0.0.1", server.address[1],
                                  actor_id=s, timeout=WRITER_TIMEOUT_S)
        clients.append(client)
        th = threading.Thread(
            target=_writer, name=f"bench-mh-writer-{s}",
            args=(client, stop, target_tps / fleet, 5000 + gids[s],
                  counter, s, errs, rpcs), daemon=True)
        th.start()
        writers.append(th)

    def dispatch() -> None:
        with server.replay_lock:
            solver.train_steps_device_per(replay, chain=CHAIN)
        queued = [(i, done) for i, (busy, done) in enumerate(rpcs) if busy]
        # the reference's yield: the serve threads get the lock between
        # dispatches; charged to the measured wall time
        time.sleep(YIELD_S)
        # the lock is not granted in order: a host too loaded to wake a
        # queued serve thread within the yield would let this loop take it
        # straight back, dispatch after dispatch, until the writers' RPCs
        # time out. So the yield lasts until the writers that were queued
        # at the release are served (at most HANDOFF_S)
        deadline = time.perf_counter() + HANDOFF_S
        while (any(rpcs[i][0] and rpcs[i][1] == done for i, done in queued)
               and time.perf_counter() < deadline):
            time.sleep(0.001)

    try:
        # warm-up, then calibration; the per-rep dispatch count must be
        # agreed, or the processes' collective sequences would part
        for _ in range(2):
            dispatch()
        _fence(solver)
        t0 = time.perf_counter()
        for _ in range(2):
            dispatch()
        _fence(solver)
        per_dispatch = (time.perf_counter() - t0) / 2
        k = int(min(max(round(rep_s / max(per_dispatch, 1e-6)), 3), 40))
        k = global_max_int(k)

        # the settle window (discarded) re-anchors the ingest counter
        # past the writers' ramp
        for _ in range(settle_reps * k + 2):
            dispatch()
        _fence(solver)
        ingest_t0, ingest_c0 = time.perf_counter(), sum(counter)

        rates = []
        for _ in range(reps):
            t0 = time.perf_counter()
            for _ in range(k):
                dispatch()
            _fence(solver)
            rates.append(k * CHAIN / (time.perf_counter() - t0))
        ingest = ((sum(counter) - ingest_c0)
                  / (time.perf_counter() - ingest_t0))
    finally:
        stop.set()
        for th in writers:
            th.join(timeout=10.0)
        for client in clients:
            client.close()
    # the ledger before close: every actor id this server saw; an id
    # outside this process's streams would be a cross-process RPC
    summary = server.telemetry_summary()
    seen = sorted(int(a) for a in server.last_seen)
    server.close()

    local_ids = list(range(STREAMS))
    out = {
        "pid": pid,
        "n_hosts": nproc,
        "rates": [round(r, 3) for r in rates],
        "dispatch_k": k,
        "ingest_t_per_s": round(ingest, 1),
        "assigned_gids": [int(g) for g in gids],
        "actor_ids_seen": seen,
        "rpc_add_calls": int(summary.get("rpc/add_transitions_calls", 0)),
        "foreign_actor_calls": sum(1 for a in seen if a not in local_ids),
        "shard_rows": int(summary.get("shard/rows", 0)),
        "writer_errors": errs[:2],
        "launches": {name: fn.launches for name, fn in kernels.items()},
    }
    with open(out_path, "w") as fh:
        json.dump(out, fh)
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m distributed_deep_q_tpu_torch.bench_multihost_worker",
        description="One learner process of the bench's multi-process "
                    "curve.")
    ap.add_argument("pid", type=int)
    ap.add_argument("nproc", type=int)
    ap.add_argument("port")
    ap.add_argument("out")
    ap.add_argument("target", type=float,
                    help="the global ingest target, transitions/s")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--reps", type=int, default=REPS)
    ap.add_argument("--rep-s", type=float, default=REP_S)
    ap.add_argument("--settle-reps", type=int, default=SETTLE_REPS)
    args = ap.parse_args(argv)

    from distributed_deep_q_tpu_torch.parallel import multihost

    multihost.initialize_multihost(
        config(args.pid, args.nproc, args.port, args.device).mesh)
    try:
        run(args.pid, args.nproc, args.port, args.out, args.target,
            device=args.device, reps=args.reps, rep_s=args.rep_s,
            settle_reps=args.settle_reps)
    finally:
        multihost.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
