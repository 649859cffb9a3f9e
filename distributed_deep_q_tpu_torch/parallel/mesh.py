"""The data-parallel shard axis (port of the part of the reference
``parallel/mesh.py`` that the replay shards need).

The reference builds a ``(dp, model)`` device mesh: its replay rings,
batches and gradient means are sharded over ``dp``, one shard per device.
The port runs each process on one device, so the reference's D shards
become a leading shard axis of the replay's device state on that device
(shard-major, the layout ``np.asarray`` assembles from the reference's
``P('dp')`` arrays), sampled shard by shard; the learner then takes one
step over the process's rows, which is the reference's mean of per-shard
means at equal ``B/D`` per shard.

``mesh.dp = 0`` means one shard per device, as in the reference: one per
process (the reference's CPU backend takes ``num_fake_devices`` virtual
devices there). ``mesh.dp = D`` gives D shards in all.

With ``mesh.num_processes = pc`` > 1 (``parallel/multihost.py``) process
``pid`` owns the contiguous block of ``D/pc`` shards that the reference's
``make_mesh`` puts on its devices: the reference orders its devices by
process, so ``local_shards`` is ``[pid·D/pc, (pid+1)·D/pc)``. Which global
shard a process holds decides which sampling keys it draws with.

The reference's partition rules (``match_partition_rules``,
``tree_shardings``) place parameters on a model axis that every
configuration sets to 1; they wait for a model axis, which the port
refuses (``check_mesh``).
"""

from __future__ import annotations

from distributed_deep_q_tpu_torch.config import MeshConfig
from distributed_deep_q_tpu_torch.parallel import multihost

AXIS_DP = "dp"
AXIS_MODEL = "model"


def check_mesh(cfg: MeshConfig) -> None:
    """Refuse the mesh settings the port does not run: a model axis, a
    shard count that does not split across the processes, and more than
    one process in a process that has not joined their group (no
    single-process fallback). Any ``dp`` runs."""
    if cfg.model > 1:
        raise NotImplementedError(
            f"mesh.model={cfg.model}: the port has no model axis (every "
            "reference configuration sets it to 1; ROADMAP, the refusals "
            "still in the port)")
    if cfg.dp < 0:
        raise ValueError(f"mesh.dp={cfg.dp} must be 0 (one shard per "
                         "device) or a shard count")
    multihost.check_process_split(cfg)
    multihost.check_joined(cfg)


def num_shards(cfg: MeshConfig) -> int:
    """D, the replay shards on the ``dp`` axis over every process:
    ``mesh.dp``, or one per device (one per process) when it is 0."""
    check_mesh(cfg)
    return int(cfg.dp) if cfg.dp > 0 else max(int(cfg.num_processes), 1)


def local_shards(cfg: MeshConfig) -> list[int]:
    """The global shard ids this process owns, in order: the contiguous
    block ``[pid·D/pc, (pid+1)·D/pc)`` (all D at one process)."""
    d, pc = num_shards(cfg), max(int(cfg.num_processes), 1)
    per = d // pc
    return list(range(cfg.process_id * per, (cfg.process_id + 1) * per))
