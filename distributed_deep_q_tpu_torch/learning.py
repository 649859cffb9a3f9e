"""Learning-dynamics plane: on-device metric accumulators (port of the
reference ``learning.py``).

The fused train chain (``parallel/learner.py``), the R2D2 fused chain
(``parallel/sequence_learner.py``) and the Anakin superstep
(``parallel/anakin.py``) read nothing back per step. This module gives them
a small flat float32 **metrics plane** that each grad step folds into with
plain tensor ops (no host read), finalized once per dispatch and handed
back as an ordinary output the host folds at its own cadence.

Plane layout (one float32 vector, ``PLANE_SIZE`` elements)::

    [0:N_HIST]      TD-|error| log-bucket counts — the geometry of
                    ``metrics.Histogram(TD_LO, TD_HI, TD_PER_DECADE)``
    shard sums      Σ|TD|, Σ sampled priority ((|TD|+ε)^α, the value
                    ``scatter_priorities`` writes), Σ IS weight, samples
    replicated sums per-step scalars (loss, grad norm before and after
                    the clip, Q mean, target refreshes, non-finite-loss
                    steps, steps)
    maxes           max |TD|, max Q, max priority
    mins            min IS weight, min |TD|

Each process's shards share its device and its learner steps over all of
its rows at once, so ``lm_finalize``'s reductions over shards are the
identity within a process and collectives across processes; the segments
keep the reference's layout. Everything sits
behind ``cfg.train.learn_metrics``: with it off no plane code runs and no
plane is allocated.

Host side, ``LearnAccumulator`` folds returned planes (cumulative plus a
sliding window), rebuilds the TD histogram as a real ``metrics.Histogram``
and publishes the ``learn/*`` gauges that the health plane
(``health.default_learn_rules``/``default_learn_trends``) and the run
JSONL read.
"""

from __future__ import annotations

import math
import threading

import numpy as np
import torch

from distributed_deep_q_tpu_torch.metrics import Histogram
from distributed_deep_q_tpu_torch.parallel import multihost

# TD-|error| histogram geometry — in lockstep with the host Histogram the
# accumulator rebuilds. Four buckets per decade over eight decades.
TD_LO = 1e-4
TD_HI = 1e4
TD_PER_DECADE = 4
_LOG_LO = math.log(TD_LO)
_SCALE = TD_PER_DECADE / math.log(10.0)
# interior + underflow + overflow — the derivation of Histogram.__init__
N_HIST = int(math.ceil((math.log(TD_HI) - _LOG_LO) * _SCALE)) + 2

# scalar slots after the histogram segment
I_TD_SUM = N_HIST + 0        # Σ|TD| over samples          (shard sum)
I_PRIO_SUM = N_HIST + 1      # Σ(|TD|+ε)^α                 (shard sum)
I_ISW_SUM = N_HIST + 2       # Σ IS weight                 (shard sum)
I_SAMPLES = N_HIST + 3       # sample count                (shard sum)
I_LOSS_SUM = N_HIST + 4      # Σ loss                      (replicated)
I_GNORM_SUM = N_HIST + 5     # Σ grad norm before the clip (replicated)
I_GNORM_CLIP_SUM = N_HIST + 6  # Σ grad norm after the clip (replicated)
I_QMEAN_SUM = N_HIST + 7     # Σ Q mean                    (replicated)
I_REFRESH = N_HIST + 8       # target-refresh count        (replicated)
I_NONFINITE = N_HIST + 9     # non-finite-loss step count  (replicated)
I_STEPS = N_HIST + 10        # grad-step count             (replicated)
I_TD_MAX = N_HIST + 11       # max |TD|                    (max)
I_Q_MAX = N_HIST + 12        # max Q                       (max)
I_PRIO_MAX = N_HIST + 13     # max sampled priority        (max)
I_ISW_MIN = N_HIST + 14      # min IS weight               (min)
I_TD_MIN = N_HIST + 15       # min |TD|                    (min)
PLANE_SIZE = N_HIST + 16

# segment boundaries: [0, _REPL) shard sums, [_REPL, _MAX) replicated,
# [_MAX, _MIN) maxes, [_MIN, end) mins
_REPL = I_LOSS_SUM
_MAX = I_TD_MAX
_MIN = I_ISW_MIN


# -- device side -------------------------------------------------------------
def lm_init(device) -> torch.Tensor:
    """Fresh per-dispatch plane: zero sums, ∓inf extrema identities."""
    z = torch.zeros(PLANE_SIZE, dtype=torch.float32, device=device)
    z[_MAX:_MIN] = -math.inf
    z[_MIN:] = math.inf
    return z


def _finite_or_zero(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    return torch.where(torch.isfinite(x), x, torch.zeros_like(x))


@torch.no_grad()
def lm_update(plane: torch.Tensor, *, cfg, td_abs, weight, loss, q, q_mean,
              gnorm, step, alpha: float, eps: float) -> torch.Tensor:
    """Fold one grad step into ``plane`` (in place; also returned) with
    tensor ops only — nothing is read back.

    ``td_abs``/``weight``/``q`` are per-sample tensors; ``loss``,
    ``q_mean`` and ``gnorm`` scalars; ``step`` the already-incremented
    step. ``alpha``/``eps`` are the replay's PER exponent and floor, so the
    priority statistic is the value ``scatter_priorities`` writes.
    Non-finite inputs are squashed (``nan_to_num``, |TD| +inf to
    ``TD_HI·10``) so one diverged step cannot poison the window; the
    divergence itself is what ``I_NONFINITE`` counts.
    """
    td = torch.nan_to_num(td_abs.float().reshape(-1), nan=0.0,
                          posinf=TD_HI * 10.0, neginf=0.0)
    w = torch.nan_to_num(weight.float().reshape(-1), nan=0.0, posinf=0.0,
                         neginf=0.0)
    qf = torch.nan_to_num(q.float(), nan=0.0, posinf=0.0, neginf=0.0)
    finite = torch.isfinite(loss).float()
    loss_s = _finite_or_zero(loss)
    gnorm_s = _finite_or_zero(gnorm)
    qmean_s = _finite_or_zero(q_mean)

    # log-bucket index — the twin of Histogram.observe, with the underflow
    # and overflow clamp. Repeated indices must each count: index_add_,
    # not an indexed +=
    safe = torch.clamp(td, min=TD_LO)
    idx = 1 + torch.floor((torch.log(safe) - _LOG_LO) * _SCALE).to(
        torch.int64)
    idx = torch.where(td < TD_LO, torch.zeros_like(idx),
                      torch.clamp(idx, max=N_HIST - 1))
    plane.index_add_(0, idx, torch.ones_like(td))

    prio = (td + eps) ** alpha
    clip = float(cfg.grad_clip_norm)
    if clip > 0:
        scale = torch.clamp(clip / torch.clamp(gnorm_s, min=1e-12), max=1.0)
    else:
        scale = torch.ones_like(gnorm_s)
    if cfg.target_tau > 0:
        refresh = torch.ones_like(gnorm_s)  # Polyak: every step refreshes
    else:
        refresh = (step % cfg.target_update_period == 0).float()
    one = torch.ones_like(gnorm_s)
    sums = torch.stack([
        td.sum(), prio.sum(), w.sum(), one * td.shape[0],
        loss_s, gnorm_s, gnorm_s * scale, qmean_s, refresh,
        1.0 - finite, one])
    plane[I_TD_SUM:I_TD_SUM + sums.shape[0]] += sums
    plane[_MAX:_MIN] = torch.maximum(
        plane[_MAX:_MIN], torch.stack([td.max(), qf.max(), prio.max()]))
    plane[_MIN:] = torch.minimum(plane[_MIN:],
                                 torch.stack([w.min(), td.min()]))
    return plane


def lm_finalize(plane: torch.Tensor, num_shards: int = 1) -> torch.Tensor:
    """The per-dispatch reduction, segment by segment: the reference psums
    the shard segment over every shard, passes the replicated one through
    and pmax/pmins the extrema. Within a process the port folds each grad
    step over all of its rows at once, so its shard segment already sums
    its shards and its extrema already run over them; across processes
    (``parallel/multihost.py``) the shard segment is summed, the maxima
    and minima reduced, and the replicated segment, equal on every
    process after the step's all-reduce, left alone. ``num_shards`` is
    kept for the reference's signature."""
    del num_shards
    return torch.cat([multihost.all_reduce_(plane[:_REPL]),
                      plane[_REPL:_MAX],
                      multihost.all_reduce_(plane[_MAX:_MIN], "max"),
                      multihost.all_reduce_(plane[_MIN:], "min")])


# -- host side ---------------------------------------------------------------
def host_plane() -> np.ndarray:
    """The fold identity, as float64 numpy (counts stay exact far past the
    float32 2^24 integer ceiling once folded on the host)."""
    z = np.zeros(PLANE_SIZE, np.float64)
    z[_MAX:_MIN] = -np.inf
    z[_MIN:] = np.inf
    return z


def _as_numpy(plane) -> np.ndarray:
    if isinstance(plane, torch.Tensor):
        plane = plane.detach().cpu().numpy()
    return np.asarray(plane, np.float64)


def fold_plane(dst: np.ndarray, plane) -> np.ndarray:
    """Fold one or more returned planes (``[PLANE_SIZE]`` or any
    leading-dim stack; numpy or a tensor) into ``dst`` in place — sums
    add, extrema max/min, as the device combines them."""
    p = _as_numpy(plane).reshape(-1, PLANE_SIZE)
    dst[:_MAX] += p[:, :_MAX].sum(axis=0)
    np.maximum(dst[_MAX:_MIN], p[:, _MAX:_MIN].max(axis=0),
               out=dst[_MAX:_MIN])
    np.minimum(dst[_MIN:], p[:, _MIN:].min(axis=0), out=dst[_MIN:])
    return dst


def plane_histogram(plane: np.ndarray) -> Histogram:
    """The TD-|error| histogram as a real ``metrics.Histogram``: counts
    poured into its buckets, total and extrema from the scalar slots."""
    h = Histogram(TD_LO, TD_HI, TD_PER_DECADE)
    counts = [int(round(c)) for c in np.asarray(plane[:N_HIST])]
    assert len(counts) == len(h._counts), "plane/Histogram geometry drift"
    h._counts = counts
    h.count = sum(counts)
    h.total = float(plane[I_TD_SUM])
    if h.count:
        h.vmin = float(plane[I_TD_MIN])
        h.vmax = float(plane[I_TD_MAX])
    return h


class LearnAccumulator:
    """Host fold of learning-dynamics planes: cumulative totals (the TD
    histogram) plus a sliding window that turns into fresh ``learn/*``
    gauges on each ``gauges()`` call.

    One lock guards all mutable state: ``ingest`` runs on the training
    loop's log cadence while ``gauges``/``hist_snapshot`` answer the log
    tick and the fleet's ``health`` scrape thread.
    """

    def __init__(self):
        self._lm_lock = threading.Lock()
        self._lm_total = host_plane()
        self._lm_window = host_plane()
        self._lm_planes = 0
        self._lm_last: dict[str, float] = {}

    def ingest(self, plane) -> None:
        """Fold one dispatch's returned plane (numpy or a device tensor —
        the copy to the host happens here, at log cadence)."""
        if plane is None:
            return
        with self._lm_lock:
            fold_plane(self._lm_total, plane)
            fold_plane(self._lm_window, plane)
            self._lm_planes += 1

    @property
    def planes(self) -> int:
        with self._lm_lock:
            return self._lm_planes

    def hist_snapshot(self) -> Histogram:
        """Cumulative TD histogram — monotone, so ``HealthMonitor``'s
        snapshot/delta windowing applies unchanged."""
        with self._lm_lock:
            return plane_histogram(self._lm_total)

    def gauges(self) -> dict[str, float]:
        """Drain the window into one flat ``learn/*`` gauge dict; with no
        new planes since the last call the previous gauges are published
        again (a stalled learner holds its last readings)."""
        with self._lm_lock:
            w = self._lm_window
            steps = w[I_STEPS]
            if steps <= 0:
                return dict(self._lm_last)
            samples = max(w[I_SAMPLES], 1.0)
            out = {
                "learn/loss": w[I_LOSS_SUM] / steps,
                "learn/grad_norm": w[I_GNORM_SUM] / steps,
                "learn/grad_norm_clipped": w[I_GNORM_CLIP_SUM] / steps,
                "learn/q_mean": w[I_QMEAN_SUM] / steps,
                "learn/q_max": w[I_Q_MAX],
                "learn/td_mean": w[I_TD_SUM] / samples,
                "learn/td_max": w[I_TD_MAX],
                "learn/prio_mean": w[I_PRIO_SUM] / samples,
                "learn/prio_max": w[I_PRIO_MAX],
                "learn/is_weight_mean": w[I_ISW_SUM] / samples,
                "learn/is_weight_min": w[I_ISW_MIN],
                "learn/target_refreshes": w[I_REFRESH],
                "learn/loss_nonfinite": w[I_NONFINITE],
                "learn/steps": self._lm_total[I_STEPS],
            }
            out = {k: float(v) for k, v in out.items()}
            self._lm_window = host_plane()
            self._lm_last = out
            return dict(out)


def publish_planes(acc: LearnAccumulator, planes, metrics) -> None:
    """The train loops' log tick: fold the window's planes (their copy to
    the host happens here, never per step) and publish the ``learn/*``
    gauges and the ``learn/td_error`` histogram summary on ``metrics``."""
    for plane in planes:
        acc.ingest(plane)
    for k, v in acc.gauges().items():
        metrics.gauge(k, v)
    for k, v in acc.hist_snapshot().summary(
            prefix="learn/td_error").items():
        metrics.gauge(k, v)


def learn_scrape_fn(acc: LearnAccumulator, monitor):
    """The learner's fleet-member ``health`` endpoint: sample the
    accumulator's gauges and TD-histogram snapshot into ``monitor`` and
    answer the wire verdict."""
    def _scrape() -> dict:
        return monitor.scrape(acc.gauges(),
                              {"learn/td_error": acc.hist_snapshot()})
    return _scrape
