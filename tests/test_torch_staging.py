"""The learner's host-side pipelines of the distributed topology:
``replay/staging.py``'s ``DeviceStager`` and the locked delayed priority
write-back (``make_writeback(..., lock=...)``).

- ``DeviceStager``: batches come back in sample order and equal, bitwise,
  to ``replay.sample`` on a twin replay with the same seed and contents;
  the host keys (``index``, ``_sampled_at``) come back as the same numpy
  values; ``close()`` joins while the thread is blocked on a full queue;
  an error raised by ``sample_fn`` surfaces on ``get()``. On the CPU the
  staged tensors are the sampled arrays (the card path's pinned copies
  and stream events run in ``chip_smoke.py`` phase 11b).
- The write-back applies each update holding the lock it was given, and
  the priorities it leaves (the sum tree and the max priority) equal,
  bitwise, those the reference's write-back leaves when fed the same
  |TD| on the reference's replay.
"""

import signal
import threading
import time

import numpy as np
import pytest
import torch

from distributed_deep_q_tpu.replay import prioritized as ref_per
from distributed_deep_q_tpu.replay import replay_memory as ref_mem

from distributed_deep_q_tpu_torch.config import ReplayConfig
from distributed_deep_q_tpu_torch.replay import prioritized as per
from distributed_deep_q_tpu_torch.replay import replay_memory as mem
from distributed_deep_q_tpu_torch.replay.staging import DeviceStager

TIMEOUT_S = 60
CAP, OBS, BATCH = 512, (4,), 32


@pytest.fixture(autouse=True)
def _deadline():
    def expire(signum, frame):
        raise TimeoutError(f"test exceeded its {TIMEOUT_S} s deadline")

    prev = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, TIMEOUT_S)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, prev)


def _rows(n=400, seed=0):
    rng = np.random.default_rng(seed)
    return {"obs": rng.standard_normal((n,) + OBS).astype(np.float32),
            "action": rng.integers(0, 2, n).astype(np.int32),
            "reward": rng.standard_normal(n).astype(np.float32),
            "next_obs": rng.standard_normal((n,) + OBS).astype(np.float32),
            "discount": np.full(n, 0.99, np.float32)}


def _replay(memory, prioritized_mod, prioritized: bool):
    base = memory.ReplayMemory(CAP, OBS, np.float32, seed=5)
    if prioritized:
        base = prioritized_mod.PrioritizedReplay(base, alpha=0.6, seed=5)
    base.add_batch(_rows())
    return base


@pytest.mark.parametrize("prioritized", [False, True])
def test_batches_arrive_in_sample_order_bitwise(prioritized):
    staged = _replay(mem, per, prioritized)
    twin = _replay(mem, per, prioritized)
    stager = DeviceStager(lambda: staged.sample(BATCH), device="cpu",
                          depth=2)
    try:
        for _ in range(6):
            got = stager.get()
            want = twin.sample(BATCH)
            assert set(got) == set(want)
            for k, v in want.items():
                if k in ("index", "_sampled_at"):
                    # host keys: the same numpy values, not tensors
                    assert not isinstance(got[k], torch.Tensor), k
                    np.testing.assert_array_equal(got[k], v)
                else:
                    assert isinstance(got[k], torch.Tensor), k
                    np.testing.assert_array_equal(got[k].numpy(), v)
    finally:
        stager.close()


def test_close_joins_while_a_put_is_blocked():
    replay = _replay(mem, per, False)
    calls = []

    def sample():
        calls.append(1)
        return replay.sample(BATCH)

    stager = DeviceStager(sample, depth=1)
    deadline = time.monotonic() + 10
    while len(calls) < 2 and time.monotonic() < deadline:
        time.sleep(0.01)   # one batch queued, the next blocked in put()
    assert len(calls) == 2
    t0 = time.monotonic()
    stager.close()
    assert time.monotonic() - t0 < 5
    assert not stager._thread.is_alive()


def test_a_sampler_error_surfaces_on_get():
    def boom():
        raise ValueError("the replay broke")

    stager = DeviceStager(boom)
    try:
        with pytest.raises(RuntimeError, match="staging thread failed") as e:
            stager.get(timeout=10)
        assert isinstance(e.value.__cause__, ValueError)
    finally:
        stager.close()


class _RecordingLock:
    """A lock that records whether it is held."""

    def __init__(self):
        self._lock = threading.Lock()
        self.held = False
        self.acquired = 0

    def __enter__(self):
        self._lock.acquire()
        self.held = True
        self.acquired += 1
        return self

    def __exit__(self, *exc):
        self.held = False
        self._lock.release()


def test_locked_writeback_matches_the_reference_bitwise():
    cfg = ReplayConfig(priority_writeback_delay=3)
    port, ref = _replay(mem, per, True), _replay(ref_mem, ref_per, True)
    lock, ref_lock = _RecordingLock(), _RecordingLock()
    seen = []
    update = port.update_priorities

    def checked_update(*args, **kw):
        seen.append(lock.held)
        return update(*args, **kw)

    port.update_priorities = checked_update
    wb = per.make_writeback(port, cfg, lock=lock)
    ref_wb = ref_per.make_writeback(ref, cfg, lock=ref_lock)
    rng = np.random.default_rng(3)
    for step in range(10):
        idx = rng.integers(0, 400, BATCH)
        td = np.abs(rng.standard_normal(BATCH)).astype(np.float32) * 3
        sampled_at = 400 - (step % 2)   # an older snapshot drops nothing
        wb.push(idx, torch.from_numpy(td), sampled_at)
        ref_wb.push(idx, td, sampled_at)
    wb.drain()
    ref_wb.drain()
    assert seen == [True] * 10 and lock.acquired == 10
    np.testing.assert_array_equal(port.tree.tree, ref.tree.tree)
    assert port.max_priority == ref.max_priority
