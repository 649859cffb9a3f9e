"""Prioritized experience replay (PER) on the host (copy of the reference
``replay/prioritized.py``; Schaul et al. 2016, proportional variant).

- Host-side **sum tree** over slot priorities. The tree is a flat numpy
  array with fully vectorized batched set/sample; the C++ core
  (``native/``) replaces the descent loop when it builds.
- **Priorities** p = (|TD| + ε)^α set from the learner's per-sample
  ``td_abs`` — copied to the host asynchronously and applied a few steps
  later (``DelayedPriorityWriteback``), so the learner never waits on it.
- **IS weights** w = (N·P(i))^-β / max_j w_j computed on the host at sample
  time, annealing β → 1 over ``priority_beta_steps`` samples.

``PrioritizedReplay`` wraps either base buffer (``ReplayMemory`` or
``FrameStackReplay``) by composition: storage/gather semantics stay in the
base, prioritization owns only the index distribution. New slots enter at
max priority (optimistic: every transition is seen at least once).
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

from distributed_deep_q_tpu_torch import native as _native


class SumTree:
    """Flat-array complete binary tree holding priorities in its leaves.

    ``size`` is the leaf count rounded up to a power of two; node ``i`` has
    children ``2i`` and ``2i+1``; leaves live at ``[size, 2*size)``; the
    total mass is at the root, index 1. All ops are batched numpy.
    """

    def __init__(self, capacity: int, use_native: bool = True):
        self.capacity = int(capacity)
        size = 1
        while size < capacity:
            size *= 2
        self.size = size
        self.tree = np.zeros(2 * size, np.float64)
        # C++ descent/set loops (native/replay_core.cpp) when buildable;
        # the numpy paths below remain the semantic reference
        self._native = _native.load() if use_native else None

    @property
    def total(self) -> float:
        return float(self.tree[1])

    def get(self, idx: np.ndarray) -> np.ndarray:
        return self.tree[np.asarray(idx) + self.size]

    def set(self, idx: np.ndarray, p: np.ndarray) -> None:
        """Set leaf priorities and repair all affected ancestors, level by
        level (duplicate indices resolve to the last write, like numpy)."""
        if self._native is not None:
            idx64 = np.ascontiguousarray(idx, np.int64)
            p64 = np.ascontiguousarray(p, np.float64)
            if idx64.size and (idx64.min() < 0 or idx64.max() >= self.size):
                raise IndexError(  # keep numpy's fail-fast, not a heap write
                    f"SumTree.set: index out of range [0, {self.size})")
            self._native.st_set(
                _native.as_double_p(self.tree), self.size,
                _native.as_int64_p(idx64), _native.as_double_p(p64),
                len(idx64))
            return
        leaf = np.asarray(idx, np.int64) + self.size
        self.tree[leaf] = p
        parents = np.unique(leaf >> 1)
        while parents.size and parents[0] >= 1:
            self.tree[parents] = (self.tree[2 * parents]
                                  + self.tree[2 * parents + 1])
            parents = np.unique(parents >> 1)
            if parents[0] == 0:
                parents = parents[1:]

    def sample_stratified(self, batch_size: int,
                          rng: np.random.Generator) -> np.ndarray:
        """Batched proportional sampling: one uniform draw per stratum of the
        total mass, then a vectorized root→leaf descent (all lanes descend a
        level per iteration — log₂(size) numpy steps, no Python recursion)."""
        total = self.tree[1]
        assert total > 0, "sample from empty SumTree"
        if self._native is not None:
            urand = np.ascontiguousarray(rng.random(batch_size))
            out = np.empty(batch_size, np.int64)
            self._native.st_sample_stratified(
                _native.as_double_p(self.tree), self.size,
                _native.as_double_p(urand), _native.as_int64_p(out),
                batch_size)
            return out
        targets = (np.arange(batch_size) + rng.random(batch_size)) \
            * (total / batch_size)
        idx = np.ones(batch_size, np.int64)
        while idx[0] < self.size:
            left = 2 * idx
            left_sum = self.tree[left]
            go_right = targets > left_sum
            targets -= left_sum * go_right
            idx = left + go_right
        return idx - self.size


def beta_at(samples: int, beta0: float, beta_steps: int) -> float:
    """IS-correction exponent annealed linearly β₀ → 1 over ``beta_steps``
    sample() calls (Schaul et al. §3.4)."""
    frac = min(samples / max(beta_steps, 1), 1.0)
    return beta0 + frac * (1.0 - beta0)


def filter_stale(idx: np.ndarray, vals: np.ndarray, steps_added: int,
                 sampled_at: int, capacity: int):
    """Drop (idx, vals) pairs whose ring slot was recycled by writes since
    the ``sampled_at`` snapshot.

    The write cursor of every ring here is ``steps_added % capacity``, so a
    slot is stale iff its distance ahead of the snapshot cursor is inside
    the since-written window. Returns filtered (idx, vals); both empty when
    a full buffer turnover happened. Shared by the host PER buffer and the
    device ring's per-slot trees.
    """
    written = steps_added - sampled_at
    if written <= 0:
        return idx, vals
    if written >= capacity:
        return idx[:0], vals[:0]
    cursor_then = sampled_at % capacity
    fresh = ((idx - cursor_then) % capacity) >= written
    return idx[fresh], vals[fresh]


def allocate_proportional(quota: int, masses: list[float]) -> list[int]:
    """Split ``quota`` integer draws across bins ∝ mass (largest remainder).
    All-zero mass → all-zero counts."""
    total = sum(masses)
    if total <= 0:
        return [0] * len(masses)
    exact = [quota * m / total for m in masses]
    counts = [int(e) for e in exact]
    rem = quota - sum(counts)
    for i in sorted(range(len(exact)),
                    key=lambda i: exact[i] - counts[i], reverse=True)[:rem]:
        counts[i] += 1
    return counts


def sample_valid_from_tree(tree: SumTree, base, count: int,
                           rng: np.random.Generator) -> np.ndarray:
    """Proportional draw of ``count`` valid slot indices from ``tree``.

    Base-buffer validity (frame-stack window crossing the cursor,
    truncation-only boundaries): redraw invalid lanes through the tree a few
    times, then fall back to the base's uniform valid sampler. Shared by
    ``PrioritizedReplay`` and the device ring's per-slot trees.
    """
    idx = tree.sample_stratified(count, rng)
    invalid_fn = getattr(base, "_invalid", None)
    if invalid_fn is not None:
        bad = invalid_fn(idx)
        for _ in range(8):
            if not bad.any():
                break
            idx[bad] = tree.sample_stratified(int(bad.sum()), rng)
            bad = invalid_fn(idx)
        if bad.any():
            idx[bad] = base.sample_indices(int(bad.sum()))
    return idx


class PrioritizedReplay:
    """Proportional PER over any base buffer with add/gather/index surface:
    ``add``/``add_batch``/``sample``/``__len__`` plus ``update_priorities``
    for the learner's per-step |TD| feedback."""

    prioritized = True

    def __init__(
        self,
        base,
        alpha: float = 0.6,
        beta0: float = 0.4,
        beta_steps: int = 1_000_000,
        eps: float = 1e-6,
        seed: int = 0,
        use_native: bool = True,
    ):
        self.base = base
        self.alpha = float(alpha)
        self.beta0 = float(beta0)
        self.beta_steps = int(beta_steps)
        self.eps = float(eps)
        self.tree = SumTree(base.capacity, use_native=use_native)
        self.max_priority = 1.0
        self._samples = 0
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.base)

    def ready(self, learn_start: int) -> bool:
        return self.base.ready(learn_start)

    @property
    def steps_added(self) -> int:
        return self.base.steps_added

    @property
    def beta(self) -> float:
        return beta_at(self._samples, self.beta0, self.beta_steps)

    def add(self, *args, **kwargs) -> int:
        i = self.base.add(*args, **kwargs)
        self.tree.set(np.asarray([i]),
                      np.asarray([self.max_priority ** self.alpha]))
        return i

    def add_batch(self, batch) -> np.ndarray:
        idx = self.base.add_batch(batch)
        self.tree.set(idx, np.full(len(idx), self.max_priority ** self.alpha))
        return idx

    def sample_indices_weighted(
            self, batch_size: int) -> tuple[np.ndarray, np.ndarray]:
        """(slot indices, unnormalized IS weights) — the index-distribution
        half of ``sample``."""
        idx = sample_valid_from_tree(self.tree, self.base, batch_size,
                                     self._rng)
        self._samples += 1
        # IS weights: w_i = (N · P(i))^-β (Schaul et al. §3.4); callers
        # normalize by the batch max so updates only ever get scaled down.
        p = self.tree.get(idx)
        n = len(self.base)
        probs = np.maximum(p / max(self.tree.total, 1e-12), 1e-12)
        w = (n * probs) ** (-self.beta)
        return idx, w

    def sample(self, batch_size: int) -> dict[str, np.ndarray]:
        idx, w = self.sample_indices_weighted(batch_size)
        batch = self.base.gather(idx)
        batch["weight"] = (w / w.max()).astype(np.float32)
        batch["_sampled_at"] = self.base.steps_added
        return batch

    def update_priorities(self, idx: np.ndarray, td_abs: np.ndarray,
                          sampled_at: int | None = None) -> None:
        """Write |TD|-derived priorities back to sampled slots.

        ``sampled_at`` is the buffer's ``steps_added`` snapshot taken when
        the batch was sampled; slots recycled by writes since then are
        dropped so a stale |TD| never clobbers a fresh transition's
        optimistic max-priority bootstrap (the cursor position is always
        ``steps_added % capacity``, so recency is decidable from counts).
        """
        idx = np.asarray(idx, np.int64)
        td = np.abs(np.asarray(td_abs, np.float64)) + self.eps
        if sampled_at is not None:
            idx, td = filter_stale(idx, td, self.base.steps_added,
                                   sampled_at, self.base.capacity)
            if idx.size == 0:
                return
        self.tree.set(idx, td ** self.alpha)
        self.max_priority = max(self.max_priority, float(td.max()))


def maybe_prioritize(base, cfg, seed: int = 0):
    """Wrap ``base`` in PER when ``cfg.prioritized`` (ReplayConfig) is set."""
    if not cfg.prioritized:
        return base
    return PrioritizedReplay(
        base, alpha=cfg.priority_alpha, beta0=cfg.priority_beta0,
        beta_steps=cfg.priority_beta_steps, eps=cfg.priority_eps, seed=seed,
        use_native=cfg.use_native)


def _start_host_copy(td_abs: torch.Tensor):
    """(host tensor, event or None): a card tensor is copied into pinned
    host memory without blocking — a non-blocking copy into pageable
    memory would be synchronous — and the event marks its arrival."""
    if not td_abs.is_cuda:
        return td_abs.detach(), None
    host = torch.empty(td_abs.shape, dtype=td_abs.dtype, pin_memory=True)
    host.copy_(td_abs.detach(), non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(td_abs.device))
    return host, done


class DelayedPriorityWriteback:
    """Priority write-back pipelined ``depth`` steps behind the learner.

    Each pushed ``td_abs`` starts its device→host copy at dispatch
    (``_start_host_copy``) and is consumed only ``depth`` steps later, by
    which point the copy has landed and waiting on its event is free.
    Priorities arrive ``depth`` grad-steps stale — well inside PER's
    tolerance — and ``filter_stale`` (via the replay's ``sampled_at``
    snapshots) still drops updates for recycled rows exactly as in the
    synchronous path.
    """

    def __init__(self, replay, depth: int = 8):
        self.replay = replay
        self.depth = max(int(depth), 1)
        self._q: deque = deque()

    def push(self, index, td_abs: torch.Tensor, sampled_at) -> None:
        """Queue one step's (index, |TD| tensor, snapshot); applies the
        update that falls ``depth`` steps behind."""
        self._q.append((index, _start_host_copy(td_abs), sampled_at))
        if len(self._q) > self.depth:
            self._apply(self._q.popleft())

    def _apply(self, item) -> None:
        index, (host, done), sampled_at = item
        if done is not None:
            done.synchronize()
        self.replay.update_priorities(index, host.numpy(),
                                      sampled_at=sampled_at)

    def drain(self) -> None:
        """Apply everything still queued (end of training)."""
        while self._q:
            self._apply(self._q.popleft())


def make_writeback(replay, replay_cfg) -> DelayedPriorityWriteback:
    """The write-back every host-sampled prioritized loop uses, at the
    configured depth."""
    return DelayedPriorityWriteback(
        replay, depth=replay_cfg.priority_writeback_delay)
