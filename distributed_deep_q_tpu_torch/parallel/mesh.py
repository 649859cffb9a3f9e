"""The data-parallel shard axis (port of the part of the reference
``parallel/mesh.py`` that the replay shards need).

The reference builds a ``(dp, model)`` device mesh: its replay rings,
batches and gradient means are sharded over ``dp``, one shard per device.
The port runs on one device, so the reference's D shards become a leading
shard axis of the replay's device state on that device (shard-major, the
layout ``np.asarray`` assembles from the reference's ``P('dp')`` arrays),
sampled shard by shard; the learner then takes one step over the whole
batch of B rows, which is the reference's mean of D per-shard means at
equal ``B/D`` per shard.

``mesh.dp = 0`` means one shard per device, as in the reference, which is 1
on the card and on the CPU (the reference's CPU backend takes
``num_fake_devices`` virtual devices there). ``mesh.dp = D`` gives D shards.

The reference's partition rules (``match_partition_rules``,
``tree_shardings``) place parameters on a model axis that every
configuration sets to 1; they wait for a model axis, which the port
refuses (``check_mesh``).
"""

from __future__ import annotations

from distributed_deep_q_tpu_torch.config import MeshConfig

AXIS_DP = "dp"
AXIS_MODEL = "model"


def check_mesh(cfg: MeshConfig) -> None:
    """Refuse the mesh settings the port does not run: a model axis and
    more than one process (ROADMAP A14b). Any ``dp`` runs."""
    if cfg.num_processes > 1 or cfg.coordinator:
        raise NotImplementedError(
            "multi-process training is not ported yet (ROADMAP A14b)")
    if cfg.model > 1:
        raise NotImplementedError(
            f"mesh.model={cfg.model}: the port has no model axis (every "
            "reference configuration sets it to 1)")
    if cfg.dp < 0:
        raise ValueError(f"mesh.dp={cfg.dp} must be 0 (one shard per "
                         "device) or a shard count")


def num_shards(cfg: MeshConfig) -> int:
    """D, the replay shards on the ``dp`` axis: ``mesh.dp``, or one per
    device (the port's one) when it is 0."""
    check_mesh(cfg)
    return int(cfg.dp) if cfg.dp > 0 else 1
