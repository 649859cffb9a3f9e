"""The bench's multi-process worker
(``distributed_deep_q_tpu_torch/bench_multihost_worker.py``) against the
reference's ``scripts/_bench_multihost_worker.py``, on the CPU.

- ``parallel/multihost.global_max_int``: two processes over gloo agree on
  the larger of their values; at one process it is the identity.
- The worker's global workload is the reference worker's, constant for
  constant (read from the reference's module).
- Every process's assigned writer gids are the reference's
  ``local_slice`` at 1, 2 and 4 processes.
- The worker's replay after its prefill, built in process at
  ``mesh.dp=4`` (one process holding all four shards), is bitwise the
  reference worker's (its ring on a four-device CPU mesh, filled by the
  reference worker's prefill): the padded frame plane (a shard's scratch
  row aside), metadata, priorities, cursors and sizes.
"""

from __future__ import annotations

import importlib.util
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:  # run as a script: one process of a test
    sys.path.insert(0, str(REPO))

from distributed_deep_q_tpu_torch import (  # noqa: E402
    bench_multihost_worker as worker)
from distributed_deep_q_tpu_torch.parallel import multihost  # noqa: E402


def _load_reference_worker():
    spec = importlib.util.spec_from_file_location(
        "_ref_bench_multihost_worker",
        REPO / "scripts" / "_bench_multihost_worker.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_global_max_int_agrees_over_two_processes(tmp_path):
    """Each process offers its own value; both get the larger one, as an
    int."""
    outs = [str(tmp_path / f"max{pid}.json") for pid in range(2)]
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(pid), str(port),
         outs[pid]], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE) for pid in range(2)]
    deadline = time.monotonic() + 120
    try:
        res = [p.communicate(timeout=max(deadline - time.monotonic(), 1))
               for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (_, err) in zip(procs, res):
        assert p.returncode == 0, err.decode()[-3000:]
    got = []
    for o in outs:
        with open(o) as f:
            got.append(json.load(f))
    assert got == [{"max": 12, "again": 7}] * 2, got


def test_global_max_int_is_the_identity_at_one_process():
    assert not multihost.is_multiprocess()
    assert multihost.global_max_int(5) == 5
    assert isinstance(multihost.global_max_int(np.int64(3)), int)


def test_worker_constants_are_the_references():
    ref = _load_reference_worker()
    for name in ("DEVICES", "BATCH", "CAPACITY", "STREAMS", "CHAIN",
                 "FRAME", "WRITE_CHUNK", "PREFILL_PER_HOST", "REPS"):
        assert getattr(worker, name) == getattr(ref, name), name
    cfg = worker.config(0, 1, "0", "cpu")
    assert (cfg.mesh.dp, cfg.replay.batch_size, cfg.replay.capacity,
            cfg.replay.n_step, cfg.replay.write_chunk) == (
        ref.DEVICES, ref.BATCH, ref.CAPACITY, 2, ref.WRITE_CHUNK)


@pytest.mark.parametrize("nproc", [1, 2, 4])
def test_assigned_gids_are_the_references_local_slice(nproc):
    from distributed_deep_q_tpu.actors.assignment import (
        local_slice as ref_local_slice)

    from distributed_deep_q_tpu_torch.actors.assignment import local_slice

    fleet = worker.STREAMS * nproc
    slices = [local_slice(fleet, nproc, pid) for pid in range(nproc)]
    assert slices == [ref_local_slice(fleet, nproc, pid)
                      for pid in range(nproc)]
    assert sorted(g for sl in slices for g in sl) == list(range(fleet))
    assert all(len(sl) == worker.STREAMS for sl in slices), slices


def _reference_worker_replay():
    """The reference worker's ring at one process (a four-device CPU
    mesh) after its prefill: ``main``'s construction and prefill lines,
    with its constants."""
    from distributed_deep_q_tpu.config import MeshConfig
    from distributed_deep_q_tpu.config import ReplayConfig as RefReplayConfig
    from distributed_deep_q_tpu.parallel.mesh import make_mesh
    from distributed_deep_q_tpu.replay.device_per import (
        DevicePERFrameReplay)

    ref = _load_reference_worker()
    mesh = make_mesh(MeshConfig(backend="cpu", num_fake_devices=8,
                                dp=ref.DEVICES))
    rcfg = RefReplayConfig(capacity=ref.CAPACITY, batch_size=ref.BATCH,
                           n_step=2, prioritized=True, device_per=True,
                           write_chunk=ref.WRITE_CHUNK)
    replay = DevicePERFrameReplay(rcfg, mesh, ref.FRAME, stack=4,
                                  gamma=0.99, seed=0,
                                  write_chunk=ref.WRITE_CHUNK,
                                  num_streams=ref.STREAMS)
    pid = 0
    rng = np.random.default_rng(1000 + pid)
    per_stream = ref.PREFILL_PER_HOST // ref.STREAMS
    for s in range(ref.STREAMS):
        replay.add_batch({
            "frame": rng.integers(0, 255, (per_stream,) + ref.FRAME,
                                  dtype=np.uint8),
            "action": rng.integers(0, 4, per_stream).astype(np.int32),
            "reward": rng.standard_normal(per_stream).astype(np.float32),
            "done": (np.arange(per_stream) % 9 == 8),
        }, stream=s)
    replay.flush()
    return replay


def test_worker_replay_after_prefill_is_the_reference_workers():
    from distributed_deep_q_tpu_torch.solver import Solver

    torch.set_num_threads(1)
    cfg = worker.config(0, 1, "0", "cpu")
    solver = Solver(cfg)
    port = worker.make_replay(cfg, solver)
    worker.prefill(port, 0)
    ref = _reference_worker_replay()
    d = worker.DEVICES
    assert (port.num_shards, port.shard_rows, port.cap_local,
            port.capacity) == (d, ref.shard_rows, ref.cap_local,
                               ref.capacity)
    assert port.dstate["frames"].shape == ref.dstate.frames.shape

    def real_rows(frames):
        # every shard's plane but its scratch row (padding lanes race
        # there by contract)
        return np.asarray(frames).reshape(d, port.shard_rows,
                                          port.rowp)[:, :-1]

    np.testing.assert_array_equal(real_rows(port.dstate["frames"]),
                                  real_rows(ref.dstate.frames))
    for name in ("action", "reward", "done", "boundary", "prio", "maxp"):
        np.testing.assert_array_equal(
            port.dstate[name].numpy(), np.asarray(getattr(ref.dstate, name)),
            err_msg=name)
    for a, b in zip(port.device_inputs(), ref.device_inputs()):
        np.testing.assert_array_equal(a, b)
    assert port.ready(worker.BATCH) and ref.ready(worker.BATCH)
    assert port.pending_rows() == 0


def _max_worker(pid: int, port: str, out: str) -> None:
    """One process of the ``global_max_int`` test."""
    from distributed_deep_q_tpu_torch.config import MeshConfig

    multihost.initialize_multihost(MeshConfig(
        backend="cpu", num_fake_devices=2, coordinator=f"127.0.0.1:{port}",
        num_processes=2, process_id=pid))
    try:
        got = {"max": multihost.global_max_int(12 if pid else 5),
               "again": multihost.global_max_int(7 - pid)}
    finally:
        multihost.shutdown()
    with open(out, "w") as f:
        json.dump(got, f)


if __name__ == "__main__":
    _max_worker(int(sys.argv[1]), sys.argv[2], sys.argv[3])
