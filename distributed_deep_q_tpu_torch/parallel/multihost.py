"""More than one learner process (port of the reference
``parallel/multihost.py``).

The reference is multi-controller JAX: every learner process runs the same
program, ``jax.distributed.initialize`` joins them, the ``dp`` mesh spans
every process's devices and the ``lax.pmean``/``psum``/``pmax`` of the
sharded train step cross the process boundary. Each process hosts its own
env or actor slice and its own block of replay shards, and the batch rows
each process samples feed one train step whose gradient mean spans the
processes.

The port has no global arrays. Each process owns the contiguous block of
``D / pc`` replay shards that its devices hold in the reference
(``parallel/mesh.local_shards``), keeps them as the leading shard axis of
its own device replay, and holds the whole θ and the whole optimizer state.
Every reference collective becomes a ``torch.distributed`` call at the same
point: the gradient, loss and Q-mean mean before the clip, the sampleable
count's sum and the IS weights' and the running priority's max in the
fused sample, the learning-dynamics plane's reductions, and the learn
gate's AND here.

The backend is ``gloo`` on the CPU and on the card alike: NCCL refuses two
ranks on one GPU, and the test machines run two processes on one card.
Gloo all-reduces and broadcasts CUDA tensors but does not all-gather them,
so every collective here is an ``all_reduce`` or a ``broadcast``.

What became an identity, and why:

- the reference's ``global_batch`` assembles the global sharded batch
  from each process's local rows. The port's train step takes the local
  rows as they are and all-reduces the gradients, so a process's rows
  *are* its share of the step, and the port has no such function.
- ``local_rows``: the reference reads this process's rows back out of a
  batch-sharded result. The port's results are local tensors already;
  what is left is the copy to the host.

There is no fallback: a process group that cannot be started, or a peer
that does not arrive, raises, and nothing carries on as one process.

Teardown: ``jax.distributed.initialize`` is shut down at interpreter exit by
jax itself; torch's process group is not. A process that exits with the
group still up can abort in its C++ teardown after its work is done
(``terminate called without an active exception``). So
``initialize_multihost`` registers ``shutdown`` to run at exit, and every
entry point that joins calls it on its way out.
"""

from __future__ import annotations

import atexit
import contextlib
import datetime
import time
from typing import Iterable

import numpy as np
import torch
import torch.distributed as dist

from distributed_deep_q_tpu_torch.config import MeshConfig

# a peer that has not joined within this long fails the start-up
JOIN_TIMEOUT_S = 300.0

# the collectives this process made, by kind (the train step's tensors,
# the host gates, the state broadcasts), and the host-clock seconds spent
# in them, which include waiting for the device work each one reads
STATS = {kind: {"calls": 0, "seconds": 0.0}
         for kind in ("step", "gate", "replicate")}


@contextlib.contextmanager
def _counted(kind: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        STATS[kind]["calls"] += 1
        STATS[kind]["seconds"] += time.perf_counter() - t0


def check_process_split(cfg: MeshConfig) -> None:
    """The reference's even-split checks, by its messages: the CPU
    backend's ``num_fake_devices`` and the replay's shard count ``D``
    (``mesh.dp``; 0 is one shard per process) must divide evenly across
    ``num_processes``."""
    pc = int(cfg.num_processes)
    if pc <= 1:
        return
    if cfg.backend == "cpu" and cfg.num_fake_devices % pc:
        raise ValueError(
            f"num_fake_devices={cfg.num_fake_devices} must divide evenly "
            f"across num_processes={pc}")
    if cfg.dp > 0 and cfg.dp % pc:
        raise ValueError(
            f"mesh.dp={cfg.dp} replay shards must divide evenly across "
            f"num_processes={pc}")
    if not 0 <= cfg.process_id < pc:
        raise ValueError(f"mesh.process_id={cfg.process_id} outside "
                         f"[0, num_processes={pc})")


def initialize_multihost(cfg: MeshConfig) -> None:
    """Join this process to the learner processes' group (idempotent).

    A no-op at one process, so single-process entry points call it
    unconditionally. Otherwise ``init_process_group("gloo")`` at
    ``tcp://{mesh.coordinator}`` as rank ``mesh.process_id`` of
    ``mesh.num_processes``; it waits for every peer and raises when one
    does not arrive within ``JOIN_TIMEOUT_S``."""
    if cfg.num_processes <= 1:
        return
    if dist.is_initialized():
        return
    check_process_split(cfg)
    if not cfg.coordinator:
        raise ValueError(
            f"mesh.num_processes={cfg.num_processes} needs "
            "mesh.coordinator=<host:port> (process 0's address, the same "
            "on every process)")
    dist.init_process_group(
        "gloo", init_method=f"tcp://{cfg.coordinator}",
        rank=int(cfg.process_id), world_size=int(cfg.num_processes),
        timeout=datetime.timedelta(seconds=JOIN_TIMEOUT_S))
    atexit.register(shutdown)


def shutdown() -> None:
    """Leave the learner processes' group; a no-op when this process is in
    none (so it is safe to call twice, and at exit after an explicit call).

    Every process meets the others at a barrier, then destroys its group.
    Rank 0 hosts the group's TCP store, so it goes last: each other rank
    says goodbye through the store after its own teardown, and rank 0
    waits for every goodbye before it returns. Bounded: a peer that died
    makes the barrier raise at once (gloo sees the closed connection), and
    one that hangs makes it raise after ``JOIN_TIMEOUT_S``; the group is
    destroyed either way."""
    if not dist.is_initialized():
        return
    rank, world = dist.get_rank(), dist.get_world_size()
    timeout = datetime.timedelta(seconds=JOIN_TIMEOUT_S)
    store = dist.distributed_c10d._get_default_store()
    try:
        if world > 1:
            dist.monitored_barrier(timeout=timeout)
    finally:
        dist.destroy_process_group()
    if world <= 1:
        return
    if rank == 0:
        store.wait([f"multihost/left/{r}" for r in range(1, world)],
                   timeout)
    else:
        store.set(f"multihost/left/{rank}", "1")


def is_multiprocess() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def check_joined(cfg: MeshConfig) -> None:
    """Refuse a configuration of ``num_processes`` > 1 in a process that is
    not in a group of that size: running it as one process would be a
    silent fallback."""
    if cfg.num_processes <= 1:
        return
    if process_count() != cfg.num_processes:
        raise ValueError(
            f"mesh.num_processes={cfg.num_processes}, but this process is "
            f"in a group of {process_count()}: call "
            "initialize_multihost(cfg.mesh) first (main does)")
    if process_index() != cfg.process_id:
        raise ValueError(f"mesh.process_id={cfg.process_id}, but this "
                         f"process is rank {process_index()}")


@torch.no_grad()
def put_replicated(tensors: Iterable[torch.Tensor]) -> None:
    """Make every process hold rank 0's values: a broadcast of each tensor
    from rank 0, in place (θ, θ⁻ and the optimizer state at init and at
    restore). The reference places one host value on every process's
    devices; the port's processes hold their own copies, which this makes
    equal bit for bit. A no-op at one process."""
    if not is_multiprocess():
        return
    for t in tensors:
        with _counted("replicate"):
            dist.broadcast(t, src=0)


def all_processes_ready(local_ready: bool) -> bool:
    """AND of a host flag across processes (the learn gate: no process may
    enter the collective train step alone). A collective: every process
    calls it at the same loop point. The identity at one process."""
    if not is_multiprocess():
        return bool(local_ready)
    t = torch.tensor([1 if local_ready else 0], dtype=torch.int32)
    with _counted("gate"):
        dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return bool(t.item())


def local_rows(t: torch.Tensor) -> np.ndarray:
    """This process's rows of a per-row result, on the host: all of ``t``
    (see the module docstring)."""
    return t.detach().cpu().numpy()


# -- tensor collectives of the train step ------------------------------------

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


def all_reduce_(t: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """``t`` reduced over processes (``sum``, ``max`` or ``min``), in place
    where it can be; returns the result. The identity at one process."""
    if not is_multiprocess():
        return t
    out = t if t.is_contiguous() else t.contiguous()
    with _counted("step"):
        dist.all_reduce(out, op=_OPS[op])
    return out


def mean_grads_and_scalars(grads: dict[str, torch.Tensor],
                           scalars: list[torch.Tensor],
                           ) -> tuple[dict[str, torch.Tensor],
                                      list[torch.Tensor]]:
    """The reference's ``pmean`` of the gradients and of the step's
    scalars (loss, Q mean) as ONE collective: every leaf and scalar
    packed into one flat buffer, summed over processes, divided by the
    process count. The identity at one process."""
    if not is_multiprocess():
        return grads, scalars
    names = list(grads)
    parts = [grads[k].reshape(-1).float() for k in names]
    parts += [s.reshape(1).float() for s in scalars]
    flat = torch.cat(parts)
    with _counted("step"):
        dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    flat = flat / dist.get_world_size()
    out, off = {}, 0
    for k in names:
        g = grads[k]
        out[k] = flat[off:off + g.numel()].view(g.shape).to(g.dtype)
        off += g.numel()
    return out, [flat[off + i].to(s.dtype) for i, s in enumerate(scalars)]
