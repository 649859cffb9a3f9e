"""Port vs reference: columnar staging, the native ``staged_append``, the
legacy staging FIFO and the background ingest drain.

Tolerance: none — every comparison is bitwise, as the reference pins its
own staging paths (``tests/test_columnar_ingest.py``):

- the port's native ``staged_append`` equals its numpy version, and both
  equal the reference's ``ColumnStage``, over growth and partial takes;
- ``replay.staging_columnar=false`` (the legacy FIFO) leaves the same ring
  bytes, metadata and trees as the columnar path, in the port and against
  the reference, for both device ring tiers;
- a ring drained by the ``IngestDrain`` thread equals one flushed inline;
- a drain whose work raises surfaces the error on ``counters()`` and
  ``close()``; a stress run of writer threads loses and duplicates no row.

Every test carries a deadline of its own, so a hung thread fails fast.
"""

import signal
import sys
import threading
import time

import numpy as np
import pytest
import torch

from distributed_deep_q_tpu.config import MeshConfig
from distributed_deep_q_tpu.config import ReplayConfig as RefReplayConfig
from distributed_deep_q_tpu.parallel.mesh import make_mesh
from distributed_deep_q_tpu.replay import columnar as ref_columnar
from distributed_deep_q_tpu.replay import device_per as ref_dp
from distributed_deep_q_tpu.replay import device_ring as ref_ring

from distributed_deep_q_tpu_torch.config import ReplayConfig
from distributed_deep_q_tpu_torch.replay import columnar
from distributed_deep_q_tpu_torch.replay import device_per as dp
from distributed_deep_q_tpu_torch.replay import device_ring as ring

TIMEOUT_S = 120


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


def _stream(replay, n_steps, episode_len=13, seed=0, frame_shape=(8, 8)):
    """The reference staging tests' stream: episode cuts plus
    truncation-only boundaries every 29 steps."""
    rng = np.random.default_rng(seed)
    t = 0
    for _ in range(n_steps):
        frame = rng.integers(0, 255, frame_shape, dtype=np.uint8)
        a, r = int(rng.integers(0, 4)), float(rng.standard_normal())
        t += 1
        done = t % episode_len == 0
        trunc = (not done) and (t % 29 == 0)
        replay.add(frame, a, r, done, boundary=done or trunc)
        if done or trunc:
            t = 0


def _batches(n_batches, rows, seed, frame_shape=(8, 8)):
    rng = np.random.default_rng(seed)
    for _ in range(n_batches):
        n = int(rng.integers(1, rows))
        done = rng.random(n) < 0.05
        yield {"frame": rng.integers(0, 255, (n,) + frame_shape, np.uint8),
               "action": rng.integers(0, 4, n).astype(np.int32),
               "reward": rng.standard_normal(n).astype(np.float32),
               "done": done, "boundary": done | (rng.random(n) < 0.02)}


# -- ColumnStage ---------------------------------------------------------------


def test_staged_append_native_equals_numpy_and_the_reference():
    cols = [((), np.int32), ((17,), np.uint8), ((), np.float32)]
    stages = [columnar.ColumnStage(cols, depth=8, use_native=True),
              columnar.ColumnStage(cols, depth=8, use_native=False),
              ref_columnar.ColumnStage(cols, depth=8, use_native=False)]
    if stages[0]._lib is None:
        pytest.skip("no C++ compiler: the native core did not build")
    rng = np.random.default_rng(7)
    for _ in range(40):
        n = int(rng.integers(1, 50))
        seg = (rng.integers(0, 2 ** 31 - 1, n).astype(np.int32),
               rng.integers(0, 255, (n, 17), dtype=np.uint8),
               rng.standard_normal(n).astype(np.float64))  # coerced
        for st in stages:
            st.append(*seg)
        assert len({len(st) for st in stages}) == 1
        # the staged rows, oldest first: the port's from its head cursor,
        # the reference's (which compacts on every take) from row 0
        staged = [stages[0].staged(), stages[1].staged(),
                  [b[:len(stages[2])] for b in stages[2]._bufs]]
        for bufs in zip(*staged):
            for b in bufs[1:]:
                np.testing.assert_array_equal(b, bufs[0])
        if rng.random() < 0.4:
            k = int(rng.integers(1, len(stages[0]) + 1))
            planes = [[np.zeros((1, k) + t, d) for t, d in cols]
                      for _ in stages]
            taken = {st.take(k, p, 0) for st, p in zip(stages, planes)}
            assert len(taken) == 1
            for ps in zip(*planes):
                for p in ps[1:]:
                    np.testing.assert_array_equal(p, ps[0])


# -- legacy FIFO ≡ columnar, in the port and against the reference -------------


def _ring_kw(prioritized=True, device_per=True):
    return dict(capacity=512, batch_size=32, n_step=3,
                prioritized=prioritized, device_per=device_per,
                write_chunk=16)


def _ref_mesh():
    return make_mesh(MeshConfig(backend="cpu", num_fake_devices=8, dp=1))


def _planes(replay, ref: bool) -> dict:
    if isinstance(replay, (dp.DevicePERFrameReplay,
                           ref_dp.DevicePERFrameReplay)):
        names = ("frames", "action", "reward", "done", "boundary", "prio",
                 "maxp")
        if ref:
            return {k: np.asarray(getattr(replay.dstate, k)) for k in names}
        return {k: replay.dstate[k].numpy() for k in names}
    out = {"ring": np.asarray(replay.ring)}
    for g, t in enumerate(replay.trees or ()):
        out[f"tree{g}"] = t.tree.copy()
    return out


def _assert_planes_equal(a: dict, b: dict, skip_scratch_rowp: int = 0):
    assert a.keys() == b.keys()
    for k in a:
        x, y = a[k], b[k]
        if k == "frames" and skip_scratch_rowp:
            # the scratch row takes the padding lanes' racing writes
            x, y = x[:-skip_scratch_rowp], y[:-skip_scratch_rowp]
        np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.mark.parametrize("tier", ["device_per", "device_ring"])
def test_legacy_staging_equals_columnar_in_the_port(tier):
    cls = dp.DevicePERFrameReplay if tier == "device_per" \
        else ring.DeviceFrameReplay
    kw = _ring_kw(device_per=tier == "device_per")
    out = []
    for columnar_on in (True, False):
        r = cls(ReplayConfig(staging_columnar=columnar_on, **kw), "cpu",
                (8, 8), stack=4, gamma=0.99, seed=0, write_chunk=16,
                num_streams=2)
        assert r._columnar is columnar_on
        _stream(r, 300)
        for i, b in enumerate(_batches(12, 40, seed=1)):
            r.add_batch(b, stream=i % 2)
        r.flush()
        assert r.pending_rows() == 0
        out.append(_planes(r, ref=False))
    _assert_planes_equal(*out)


@pytest.mark.parametrize("tier", ["device_per", "device_ring"])
@pytest.mark.parametrize("columnar_on", [True, False],
                         ids=["columnar", "legacy"])
def test_staging_matches_the_reference_bitwise(tier, columnar_on):
    torch.set_num_threads(1)
    per = tier == "device_per"
    kw = dict(_ring_kw(device_per=per), staging_columnar=columnar_on)
    if per:
        port = dp.DevicePERFrameReplay(ReplayConfig(**kw), "cpu", (8, 8),
                                       stack=4, gamma=0.99, seed=0,
                                       write_chunk=16, num_streams=2)
        ref = ref_dp.DevicePERFrameReplay(RefReplayConfig(**kw), _ref_mesh(),
                                          (8, 8), stack=4, gamma=0.99, seed=0,
                                          write_chunk=16, num_streams=2)
    else:
        port = ring.DeviceFrameReplay(ReplayConfig(**kw), "cpu", (8, 8),
                                      stack=4, gamma=0.99, seed=0,
                                      write_chunk=16, num_streams=2)
        ref = ref_ring.DeviceFrameReplay(RefReplayConfig(**kw), _ref_mesh(),
                                         (8, 8), stack=4, gamma=0.99, seed=0,
                                         write_chunk=16, num_streams=2)
    for r in (port, ref):
        _stream(r, 200)
        for i, b in enumerate(_batches(10, 40, seed=2)):
            r.add_batch(b, stream=i % 2)
        r.flush()
    _assert_planes_equal(_planes(port, ref=False), _planes(ref, ref=True),
                         skip_scratch_rowp=port.rowp if per else 0)
    for a, b in zip(port.device_inputs() if per else (),
                    ref.device_inputs() if per else ()):
        np.testing.assert_array_equal(a, b)


# -- the drain -----------------------------------------------------------------


def _per(drain=True, **kw):
    cfg = ReplayConfig(**{**_ring_kw(), **kw, "ingest_drain": drain})
    return dp.DevicePERFrameReplay(cfg, "cpu", (8, 8), stack=4, gamma=0.99,
                                   seed=0, write_chunk=16, num_streams=2)


def _wait(cond, timeout=20.0):
    end = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < end, "timed out waiting"
        time.sleep(0.005)


def test_drain_flush_equals_inline_flush():
    inline, drained = _per(), _per()
    lock = threading.RLock()
    drain = drained.start_drain(lock)
    assert drain is not None and drained.start_drain(lock) is drain
    batches = list(_batches(30, 40, seed=3))
    for i, b in enumerate(batches):
        inline.add_batch(b, stream=i % 2)
        with lock:
            drained.add_batch(b, stream=i % 2)
    # writers only nudge: rows past a chunk stay staged until the thread
    # flushes them
    _wait(lambda: drained.pending_rows() < drained.write_chunk)
    counters = drain.counters()
    assert counters["flushes"] >= 1 and counters["rows"] > 0
    drained.stop_drain()          # one last flush strands nothing
    inline.flush()
    assert drained.pending_rows() == 0
    _assert_planes_equal(_planes(inline, False), _planes(drained, False),
                         skip_scratch_rowp=inline.rowp)
    for a, b in zip(inline.device_inputs(), drained.device_inputs()):
        np.testing.assert_array_equal(a, b)


def test_drain_respects_the_config():
    r = _per(drain=False)
    assert r.start_drain(threading.RLock()) is None
    b = next(_batches(1, 40, seed=4))
    b = {k: np.concatenate([v, v]) for k, v in b.items()}   # ≥ one chunk
    r.add_batch(b, stream=0)
    assert r.pending_rows() < r.write_chunk     # flushed inline
    r2 = _per(drain_min_rows=48)
    d = r2.start_drain(threading.RLock())
    assert d._min == 48
    r2.stop_drain()


def test_a_dead_drain_surfaces_on_counters_and_close(monkeypatch):
    r = _per()
    lock = threading.RLock()
    boom = RuntimeError("device lost")

    def fail():
        raise boom

    monkeypatch.setattr(r, "flush", fail)
    drain = r.start_drain(lock)
    for b in _batches(6, 40, seed=5):
        with lock:
            r.add_batch(b, stream=0)
    drain.notify()
    _wait(lambda: not drain._thread.is_alive())
    with pytest.raises(RuntimeError, match="drain thread died") as e:
        drain.counters()
    assert e.value.__cause__ is boom
    with pytest.raises(RuntimeError, match="drain thread died"):
        r.stop_drain()


def test_writer_threads_lose_and_duplicate_no_row():
    """More writer threads than cores, a short switch interval: every row
    lands once (the ring's host counters and the device metadata agree)."""
    r = _per(capacity=4096)
    lock = threading.RLock()
    r.start_drain(lock)
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    counts = [0, 0]
    errors = []

    def writer(stream, seed):
        try:
            for b in _batches(25, 30, seed=seed):
                b["done"][:] = False
                b["boundary"][:] = False
                with lock:
                    r.add_batch(b, stream=stream)
                    counts[stream] += len(b["action"])
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=writer, args=(i % 2, 100 + i))
               for i in range(6)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(prev)
    r.stop_drain()
    assert not errors, errors
    assert r.pending_rows() == 0
    assert [r.slots[g].steps_added for g in range(2)] == counts
    # every landed row's action made it to the device (rows never written
    # keep action 0 and reward 0.0)
    written = sum(min(c, r.slot_cap) for c in counts)
    assert int((r.dstate["reward"] != 0).sum()) == written
