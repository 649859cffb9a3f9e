"""Batched inference policy — the forward behind the ``InferenceServer``
(``rpc/inference_server.py``), on the learner's card (port of the
reference's ``models/policy.py``).

The Podracer/Sebulba split (arXiv:2104.06272) centralizes the actor
forward on the accelerator: actors ship observations, the learner-side
policy answers with actions. This module is that forward: the module
``build_qnet`` makes (the net ``QNet`` acts with on the actors' CPUs),
with the argmax taken on the host by ``np.argmax``, the same call and
tie-breaking as ``QNet.argmax_action``.

**Buckets.** Every batch pads (zero rows, sliced off after the forward)
to the smallest of a few fixed ``buckets``, so at most ``len(buckets)``
batch shapes ever run (``compiled_buckets`` is that census, the
reference's compiled-program count); batches larger than the biggest
bucket fold into chunks of it.

**Generations.** Every θ, installed or a tenant's, is a dict of tensors
made by ``unflatten``; the forward runs it through
``torch.func.functional_call``, so a tenant's θ never touches the
installed one and an install never writes into tensors a forward in
flight reads (a new generation replaces the old reference).

**Streams.** On the card the policy has a CUDA stream of its own: each
generation's tensors are allocated and copied on it, each forward copies
its observations (through one pinned host buffer per bucket) and runs on
it, and the reply's copy to the host waits on it alone, never on the
learner's queue of dispatches. Memory freed from a generation is reused
only by later work on the same stream, so no forward reads a freed θ.
"""

from __future__ import annotations

import threading
from typing import Any

import numpy as np
import torch

from distributed_deep_q_tpu_torch import convert
from distributed_deep_q_tpu_torch.config import NetConfig
from distributed_deep_q_tpu_torch.models.qnet import build_qnet

__all__ = ["BatchedPolicy"]

Generation = dict[str, torch.Tensor]


class BatchedPolicy:
    """Bucket-padded batched Q-forward with the ``QNet`` weight surface.

    ``set_weights`` takes the flat numpy leaf list the θ wire ships (the
    reference's Flax leaves, ``convert.flax_leaves``), so the learner
    feeds it straight from ``solver.get_weights()``. ``device`` defaults
    to the card; on a CUDA device without a card the constructor raises
    (there is no fallback to the CPU).
    """

    def __init__(self, cfg: NetConfig, seed: int = 0, obs_dim: int = 4,
                 buckets: tuple = (8, 32, 128, 256),
                 device: torch.device | str = "cuda"):
        if cfg.kind == "r2d2":
            raise ValueError(
                "BatchedPolicy serves feed-forward torsos; recurrent "
                "actors carry per-episode LSTM state that cannot be "
                "microbatched across actors — keep r2d2 on local inference")
        if not buckets or any(int(b) <= 0 for b in buckets):
            raise ValueError(f"inference buckets must be positive: {buckets}")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "BatchedPolicy on a CUDA device needs a card; pass "
                "device='cpu' to serve from the CPU")
        self.buckets = tuple(sorted(int(b) for b in set(buckets)))
        self._frame_shape = tuple(cfg.frame_shape)
        # the module is only the forward's structure: every call replaces
        # all of its parameters with a generation, so it stays on the CPU
        self.module = build_qnet(cfg, obs_dim, seed).eval()
        # the policy's CUDA stream (None on the CPU, where
        # torch.cuda.stream(None) is a no-op)
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)
        # functional_call swaps the module's parameters for the call's
        # duration: one forward at a time
        self._lock = threading.Lock()
        self._pinned: dict[tuple, torch.Tensor] = {}
        self._compiled: set[int] = set()
        self.forwards = 0
        self.rows = 0
        self.params: Generation = self.unflatten(
            convert.flax_leaves(self.module, self._frame_shape))

    # -- bucket math --------------------------------------------------------

    def bucket_for(self, n: int) -> int:
        """Smallest bucket holding ``n`` rows (largest bucket if none do —
        the caller then loops in largest-bucket chunks)."""
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def compiled_buckets(self) -> list[int]:
        """Bucket sizes that have run — the census holding the
        ≤ ``len(buckets)`` batch-shape bound."""
        with self._lock:
            return sorted(self._compiled)

    # -- forward ------------------------------------------------------------

    def forward(self, obs: np.ndarray,
                params: Generation | None = None, bucket: int | None = None
                ) -> tuple[np.ndarray, np.ndarray]:
        """Actions + Q-values for a stacked observation batch.

        Returns ``(actions int64 [n], q float32 [n, A])``. Rows are
        independent; padding rows are zeros and sliced off before the
        argmax, so they never influence a real row. ``params`` (a
        generation from ``unflatten``) overrides the installed θ for this
        forward only. ``bucket`` pads to that size instead of the smallest
        bucket holding ``n`` rows (an oracle's forward at the shape a
        served row went through).
        """
        obs = np.asarray(obs)
        n = obs.shape[0]
        cap = self.buckets[-1]
        if n > cap:
            parts = [self.forward(obs[i:i + cap], params=params)
                     for i in range(0, n, cap)]
            return (np.concatenate([p[0] for p in parts]),
                    np.concatenate([p[1] for p in parts]))
        if bucket is None:
            bucket = self.bucket_for(n)
        elif bucket < n:
            raise ValueError(f"bucket {bucket} holds fewer than {n} rows")
        gen = self.params if params is None else params
        with self._lock, torch.cuda.stream(self.stream):
            self._compiled.add(bucket)
            self.forwards += 1
            self.rows += n
            # the copy to the host waits on the policy stream only
            q = self.q_values(self.stage(obs, bucket), gen)[:n].cpu().numpy()
        # host-side argmax, same call as QNet.argmax_action — identical
        # tie-breaking keeps the remote/local action streams equal
        return np.argmax(q, axis=-1), q

    def q_values(self, x: torch.Tensor, gen: Generation) -> torch.Tensor:
        """Float32 Q-values of a padded batch already on the device (on
        the card, run it on ``stream``)."""
        with torch.inference_mode():
            return torch.func.functional_call(self.module, gen, (x,))

    def stage(self, obs: np.ndarray, bucket: int) -> torch.Tensor:
        """The batch padded with zero rows to ``bucket``, on the policy's
        device. On the card it goes through this bucket's pinned buffer
        and is copied on the current stream (``stream`` in ``forward``);
        the buffer is free again when ``forward`` returns, since its
        reply's copy to the host waited on the same stream."""
        if self.stream is None:
            if obs.shape[0] == bucket:
                return torch.from_numpy(np.ascontiguousarray(obs))
            pad = np.zeros((bucket - obs.shape[0],) + obs.shape[1:],
                           obs.dtype)
            return torch.from_numpy(np.concatenate([obs, pad]))
        key = (bucket, obs.shape[1:], obs.dtype.str)
        buf = self._pinned.get(key)
        if buf is None:
            buf = torch.from_numpy(np.empty((bucket,) + obs.shape[1:],
                                            obs.dtype)).pin_memory()
            self._pinned[key] = buf
        host = buf.numpy()
        n = obs.shape[0]
        host[:n] = obs
        host[n:] = 0
        return buf.to(self.device, non_blocking=True)

    # -- weight IO (numpy; the θ wire) --------------------------------------

    def get_weights(self) -> list[np.ndarray]:
        """The installed θ as the θ wire's Flax leaves."""
        named = {k: v.float().cpu().numpy() for k, v in self.params.items()}
        return convert.tree_leaves(
            convert.params_to_flax(named, self._frame_shape))

    def set_weights(self, flat: list[Any]) -> None:
        self.params = self.unflatten(flat)

    def unflatten(self, flat: list[Any]) -> Generation:
        """A generation (``{parameter name: tensor}`` on the policy's
        device) from the flat θ leaf list WITHOUT installing it — tenant
        θ generations live outside ``params`` so installing one tenant
        never disturbs another's forward."""
        named = convert.named_from_flax_leaves(self.module, flat,
                                               self._frame_shape)
        with torch.cuda.stream(self.stream):
            return {k: torch.from_numpy(v).to(self.device)
                    for k, v in named.items()}
