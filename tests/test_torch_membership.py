"""Port vs reference: the elastic-fleet membership registry and the shard
handoff.

Tolerance: none — epochs, views, lineage, gauges and fleet-verb replies
are compared with ``==`` under one injected monotonic clock; a shard
exported through the port's persistence comes back bitwise (every
persisted replay key, the ring planes, the dedup map). Sockets bind
127.0.0.1, port 0; every test carries a deadline of its own.
"""

import signal

import numpy as np
import pytest
import torch

from distributed_deep_q_tpu.actors import membership as ref_ms
from distributed_deep_q_tpu.config import MeshConfig
from distributed_deep_q_tpu.config import ReplayConfig as RefReplayConfig
from distributed_deep_q_tpu.parallel.mesh import make_mesh
from distributed_deep_q_tpu.replay import device_per as ref_dp
from distributed_deep_q_tpu.rpc import replay_server as ref_rs

from distributed_deep_q_tpu_torch.actors import membership as ms
from distributed_deep_q_tpu_torch.config import ReplayConfig
from distributed_deep_q_tpu_torch.replay import device_per as dp
from distributed_deep_q_tpu_torch.replay import persistence
from distributed_deep_q_tpu_torch.replay.multistream import (
    MultiStreamFrameReplay)
from distributed_deep_q_tpu_torch.rpc import replay_server as rs

TIMEOUT_S = 90


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


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self) -> float:
        return self.t


def _script(mod, clock) -> list:
    """Joins, renewals, a handoff, a lease expiry sweep and a re-join,
    recording the registry's answers and its view after each."""
    reg = mod.MembershipRegistry(lease_s=10.0)
    out = []

    def note(*answer):
        v = reg.view()
        out.append((answer, reg.epoch(), mod.view_tokens(v),
                    dict(sorted(reg.gauges().items()))))

    note(reg.join("host-2", "127.0.0.1", 1002))
    clock.t += 3.0
    note(reg.join("host-0", "127.0.0.1", 1000))
    note(reg.join("host-1", "127.0.0.1", 1001))
    clock.t += 6.0
    note(reg.renew("host-0"), reg.expire())
    note(reg.leave("host-1", importer="host-0"))
    clock.t += 5.0
    # host-2 last renewed 14 s ago: expired; host-0 renewed 5 s ago
    note(reg.expire(), reg.renew("host-2"))
    v = reg.view()
    out.append((mod.resolve_importer(v, "host-1"),
                mod.resolve_importer(v, "host-9"),
                mod.view_address(v, "host-0")))
    note(reg.join("host-1", "127.0.0.1", 3001))
    note(reg._dispatch({"method": "fleet_lease", "token": "host-1"}))
    note(reg._dispatch({"method": "fleet_destroy"}))
    clock.t += 100.0
    note(reg.expire())
    return out


def test_lease_expiry_and_view_tokens_are_equal(monkeypatch):
    runs = []
    for mod in (ms, ref_ms):
        clock = _Clock()
        monkeypatch.setattr(mod.time, "monotonic", clock)
        runs.append(_script(mod, clock))
    assert runs[0] == runs[1]
    epochs = [step[1] for step in runs[0] if len(step) == 4]
    assert epochs == sorted(epochs) and epochs[-1] > 5


def test_fleet_verbs_ride_the_port_wire():
    replies = []
    for smod in (rs, ref_rs):
        from distributed_deep_q_tpu.replay.replay_memory import ReplayMemory
        server = smod.ReplayFeedServer(ReplayMemory(64, (2,)))
        server.attach_membership(
            (ms if smod is rs else ref_ms).MembershipRegistry())
        host, port = server.address
        c = smod.ReplayFeedClient(host, port, actor_id=1)
        try:
            got = [c.call("fleet_join", token="host-0", host=host, port=1),
                   c.call("fleet_join", token="host-1", host=host, port=2),
                   c.call("fleet_lease", token="host-0"),
                   c.call("fleet_leave", token="host-1", importer="host-0")]
            v = c.call("fleet_view")
            got.append(((ms if smod is rs else ref_ms).view_tokens(v),
                        ms.resolve_importer(v, "host-1")))
            got.append(c.call("stream_seq"))
        finally:
            c.close()
            server.close()
        replies.append(got)
    assert replies[0] == replies[1]


def _ring(ref: bool):
    cfg = dict(capacity=512, batch_size=32, n_step=3, prioritized=True,
               priority_alpha=0.6, device_per=True, write_chunk=16)
    if ref:
        mesh = make_mesh(MeshConfig(backend="cpu", num_fake_devices=8, dp=1))
        return ref_dp.DevicePERFrameReplay(RefReplayConfig(**cfg), mesh,
                                           (8, 8), 4, 0.99, seed=0,
                                           write_chunk=16, num_streams=2)
    return dp.DevicePERFrameReplay(ReplayConfig(**cfg), "cpu", (8, 8), 4,
                                   0.99, seed=0, write_chunk=16,
                                   num_streams=2)


def _pixels(n, seed):
    rng = np.random.default_rng(seed)
    done = rng.random(n) < 0.05
    return {"frame": rng.integers(0, 255, (n, 8, 8), np.uint8),
            "action": rng.integers(0, 4, n).astype(np.int32),
            "reward": rng.standard_normal(n).astype(np.float32),
            "done": done, "boundary": done}


def test_shard_export_import_round_trips_through_port_persistence(tmp_path):
    torch.set_num_threads(1)
    snap = str(tmp_path / "handoff")
    ring = _ring(False)
    server = rs.ReplayFeedServer(ring)
    c = rs.ReplayFeedClient(*server.address, actor_id=1)
    try:
        for seq in range(1, 6):
            c.add_transitions(flush_seq=seq, **_pixels(30, seq))
    finally:
        c.close()
    export = ms.export_shard(server, snap)    # drains, then snapshots
    assert export["rows"] == 150
    want = persistence.replay_state(ring)

    ring2 = _ring(False)
    server2, receipt = ms.import_shard(ring2, snap)
    try:
        assert receipt["rows"] == 150 and receipt["generation"] == 0
        assert server2._flush_seq == {1: 5}
        c2 = rs.ReplayFeedClient(*server2.address, actor_id=1)
        try:
            # the in-flight resend: seq 5 landed before the handoff
            assert c2.add_transitions(flush_seq=5,
                                      **_pixels(30, 5))["duplicate"]
            assert ms.resend_floor(*server2.address, actor_id=1) == 5
        finally:
            c2.close()
    finally:
        server2.close()
    got = persistence.replay_state(ring2)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)
    # the reference imports the port's export
    ref_ring = _ring(True)
    ref_server, ref_receipt = ref_ms.import_shard(ref_ring, snap)
    try:
        assert ref_receipt["rows"] == 150
        assert ref_server._flush_seq == {1: 5}
    finally:
        ref_server.close()
    for k in ("frames", "action", "reward", "done", "boundary", "prio"):
        a = ring2.dstate[k].numpy()
        b = np.asarray(getattr(ref_ring.dstate, k))
        if k == "frames":
            a, b = a[:-ring2.rowp], b[:-ring2.rowp]
        np.testing.assert_array_equal(a, b, err_msg=k)


def test_multistream_replay_matches_the_reference():
    """The host multi-stream fallback: the same per-stream chunks give the
    same shards and the same uniform sample."""
    from distributed_deep_q_tpu.replay.multistream import (
        MultiStreamFrameReplay as RefMulti)

    a = MultiStreamFrameReplay(256, (8, 8), 4, 3, 0.99, num_streams=2,
                               seed=3)
    b = RefMulti(256, (8, 8), 4, 3, 0.99, num_streams=2, seed=3)
    for i in range(8):
        chunk = _pixels(25, 40 + i)
        a.add_batch(chunk, stream=i % 2)
        b.add_batch(chunk, stream=i % 2)
    a.reset_stream(1)
    b.reset_stream(1)
    assert len(a) == len(b) == 200
    sa, sb = a.sample(16), b.sample(16)
    assert sa.keys() == sb.keys()
    for k in sa:
        np.testing.assert_array_equal(np.asarray(sa[k]), np.asarray(sb[k]),
                                      err_msg=k)
