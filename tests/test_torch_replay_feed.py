"""Port vs reference: the replay feed across the wire, both ways.

A reference ``ReplayFeedClient`` feeds a port ``ReplayFeedServer`` on a port
``DevicePERFrameReplay`` (on the CPU, its kernels' plain versions, the
ingest drain on), and a port client feeds a reference server on the
reference's ring (JAX on the CPU). The same frames land in both.

Tolerance: bitwise for everything the reference pins bitwise — ring bytes
(the scratch row aside, where padding lanes race by contract), the device
metadata and priority planes, cursors and sizes, sequence tiers' contents,
every persisted replay key after a snapshot and warm boot, dedup maps and
θ versions. Q from θ that crossed the wire: rtol 1e-5, atol 1e-6, the
float32 forward tolerance of ``tests/test_torch_qnet.py``.

Also covered: dedup of a replayed ``flush_seq`` (and of chaos-dropped
acks), a shed and its retry, ``reset_stream`` sealing the slot on the host
and in the device boundary ring (as ``tests/test_stream_seam.py`` pins),
and an R2D2 sequence payload into both sequence tiers (as
``tests/test_rpc_r2d2.py`` pins). Sockets bind 127.0.0.1, port 0; every
test carries a deadline of its own.
"""

import signal
import threading
import time

import numpy as np
import pytest
import torch

from distributed_deep_q_tpu.config import MeshConfig
from distributed_deep_q_tpu.config import ReplayConfig as RefReplayConfig
from distributed_deep_q_tpu.config import pong_config as ref_pong_config
from distributed_deep_q_tpu.parallel.mesh import make_mesh
from distributed_deep_q_tpu.replay import device_per as ref_dp
from distributed_deep_q_tpu.replay import device_sequence as ref_ds
from distributed_deep_q_tpu.replay import persistence as ref_persist
from distributed_deep_q_tpu.replay import replay_memory as ref_mem
from distributed_deep_q_tpu.replay import sequence as ref_seq
from distributed_deep_q_tpu.rpc import faultinject as ref_fi
from distributed_deep_q_tpu.rpc import flowcontrol as ref_flow
from distributed_deep_q_tpu.rpc import replay_server as ref_rs
from distributed_deep_q_tpu.rpc import resilience as ref_res
from distributed_deep_q_tpu.solver import Solver as RefSolver

from distributed_deep_q_tpu_torch.config import ReplayConfig, pong_config
from distributed_deep_q_tpu_torch.replay import device_per as dp
from distributed_deep_q_tpu_torch.replay import device_sequence as ds
from distributed_deep_q_tpu_torch.replay import persistence
from distributed_deep_q_tpu_torch.replay import replay_memory as mem
from distributed_deep_q_tpu_torch.replay import sequence as seq
from distributed_deep_q_tpu_torch.rpc import faultinject as fi
from distributed_deep_q_tpu_torch.rpc import flowcontrol as flow
from distributed_deep_q_tpu_torch.rpc import replay_server as rs
from distributed_deep_q_tpu_torch.rpc import resilience as res
from distributed_deep_q_tpu_torch.solver import Solver

TIMEOUT_S = 120
FRAME, STACK, N_STEP, GAMMA, CHUNK = (8, 8), 4, 3, 0.99, 16
PLANES = ("frames", "action", "reward", "done", "boundary", "prio", "maxp")


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


@pytest.fixture(autouse=True)
def _no_chaos():
    for m in (fi, ref_fi):
        m.uninstall()
    yield
    for m in (fi, ref_fi):
        m.uninstall()


def _mesh():
    return make_mesh(MeshConfig(backend="cpu", num_fake_devices=8, dp=1))


def _ring(ref: bool, **kw):
    """A two-stream fused-PER ring in either package (the ingest drain
    on, unless ``ingest_drain=False``)."""
    cfg = dict(capacity=512, batch_size=32, n_step=N_STEP, prioritized=True,
               priority_alpha=0.6, device_per=True, write_chunk=CHUNK)
    cfg.update(kw)
    if ref:
        return ref_dp.DevicePERFrameReplay(
            RefReplayConfig(**cfg), _mesh(), FRAME, STACK, GAMMA, seed=0,
            write_chunk=cfg["write_chunk"], num_streams=2)
    return dp.DevicePERFrameReplay(
        ReplayConfig(**cfg), "cpu", FRAME, STACK, GAMMA, seed=0,
        write_chunk=cfg["write_chunk"], num_streams=2)


def _planes(replay) -> dict:
    st = replay.dstate
    if isinstance(st, dict):
        return {k: st[k].numpy() for k in PLANES}
    return {k: np.asarray(getattr(st, k)) for k in PLANES}


def _assert_rings_equal(a, b):
    pa, pb = _planes(a), _planes(b)
    for k in PLANES:
        x, y = pa[k], pb[k]
        if k == "frames":   # the scratch row takes racing padding lanes
            x, y = x[:-a.rowp], y[:-a.rowp]
        np.testing.assert_array_equal(x, y, err_msg=k)
    for x, y in zip(a.device_inputs(), b.device_inputs()):
        np.testing.assert_array_equal(x, y)
    for ma, mb in zip(a.slots, b.slots):
        for f in ("action", "reward", "done", "boundary"):
            np.testing.assert_array_equal(getattr(ma, f), getattr(mb, f))


def _batches(n, seed, rows=(8, 40)):
    """Pixel flushes of 8–40 rows, episode ends and truncations inside."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        k = int(rng.integers(*rows))
        done = rng.random(k) < 0.04
        yield {"frame": rng.integers(0, 255, (k,) + FRAME, np.uint8),
               "action": rng.integers(0, 4, k).astype(np.int32),
               "reward": rng.standard_normal(k).astype(np.float32),
               "done": done, "boundary": done | (rng.random(k) < 0.02)}


def _feed(client_mod, address, batches, actor_id):
    """Send ``batches`` through a resilient client (fresh flush_seqs);
    returns the rows the server acknowledged."""
    c = client_mod.ResilientReplayFeedClient.connect(
        *address, actor_id=actor_id, seed=actor_id)
    acked = 0
    try:
        for b in batches:
            r = c.add_transitions(**b)
            assert r["ok"]
            acked += len(b["action"])
    finally:
        c.close()
    return acked


# -- the ring bytes, fed across the wire both ways ------------------------------


def test_reference_client_feeds_port_server_and_back_bitwise():
    torch.set_num_threads(1)
    port_ring, ref_ring = _ring(False), _ring(True)
    port_srv, ref_srv = rs.ReplayFeedServer(port_ring), \
        ref_rs.ReplayFeedServer(ref_ring)
    assert port_srv._drain is not None and ref_srv._drain is not None
    try:
        for actor in (0, 1):
            batches = list(_batches(15, seed=10 + actor))
            # the reference's client into the port's server, and the
            # port's client into the reference's server
            a = _feed(ref_res, port_srv.address, batches, actor)
            b = _feed(res, ref_srv.address, batches, actor)
            assert a == b == sum(len(x["action"]) for x in batches)
        stats = []
        for srv, cmod in ((port_srv, ref_rs), (ref_srv, rs)):
            c = cmod.ReplayFeedClient(*srv.address, actor_id=0)
            try:
                stats.append(c.call("stats"))
            finally:
                c.close()
        assert stats[0]["env_steps"] == stats[1]["env_steps"] > 0
        np.testing.assert_array_equal(stats[0]["actor_env_steps"],
                                      stats[1]["actor_env_steps"])
    finally:
        port_srv.close()    # stops the drains after a last flush
        ref_srv.close()
    assert port_ring.pending_rows() == ref_ring.pending_rows() == 0
    _assert_rings_equal(port_ring, ref_ring)


# -- θ across the wire --------------------------------------------------------------


def _solvers():
    cfgs = []
    for make in (pong_config, ref_pong_config):
        cfg = make()
        cfg.mesh.backend = "cpu"
        cfg.net.frame_shape = (36, 36)
        cfg.net.compute_dtype = "float32"
        cfg.net.num_actions = 4
        cfgs.append(cfg)
    port = Solver(cfgs[0])
    ref = RefSolver(cfgs[1])
    return port, ref


@pytest.mark.parametrize("direction", ["port_to_reference",
                                       "reference_to_port"])
def test_params_cross_the_wire_both_ways(direction):
    torch.set_num_threads(1)
    port, ref = _solvers()
    if direction == "port_to_reference":
        src, dst, smod, cmod = port, ref, rs, ref_rs
        replay = mem.ReplayMemory(8, (4,))
    else:
        src, dst, smod, cmod = ref, port, ref_rs, rs
        replay = ref_mem.ReplayMemory(8, (4,))
    server = smod.ReplayFeedServer(replay)
    client = cmod.ReplayFeedClient(*server.address, actor_id=2)
    try:
        assert client.get_params() == (0, None)
        version = server.publish_params(src.get_weights())
        got_version, weights = client.get_params()
        assert got_version == version == 1
        # a refresh at the version held is a no-op reply
        assert client.get_params(have_version=1) == (1, None)
    finally:
        client.close()
        server.close()
    want = src.get_weights()
    assert [w.shape for w in weights] == [w.shape for w in want]
    for w, v in zip(weights, want):
        np.testing.assert_array_equal(w, v)
    dst.update(weights)
    obs = np.random.default_rng(0).integers(0, 255, (8, 36, 36, 4),
                                            dtype=np.uint8)
    np.testing.assert_allclose(dst.q_values(obs), src.q_values(obs),
                               rtol=1e-5, atol=1e-6)
    # the round trip back gives the same leaves
    for w, v in zip(dst.get_weights(), want):
        np.testing.assert_array_equal(w, v)


def test_get_weights_is_the_reference_layout():
    torch.set_num_threads(1)
    port, ref = _solvers()
    port.update(ref.get_weights())
    for a, b in zip(port.get_weights(), ref.get_weights()):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        port.update(ref.get_weights()[:-1])


# -- dedup, shed, seal --------------------------------------------------------------


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_a_replayed_flush_seq_is_deduplicated(pkg):
    smod, cmod = (rs, rs) if pkg == "port" else (ref_rs, ref_rs)
    ring = _ring(pkg == "reference")
    server = smod.ReplayFeedServer(ring)
    client = cmod.ReplayFeedClient(*server.address, actor_id=1)
    b = next(_batches(1, seed=3, rows=(20, 21)))
    try:
        r1 = client.add_transitions(flush_seq=1, **b)
        r2 = client.add_transitions(flush_seq=1, **b)
        assert r1["ok"] and not r1.get("duplicate")
        assert r2["ok"] and r2["duplicate"]
        assert server.counters()["env_steps"] == 20
        assert server.telemetry.robustness_counters()[
            "duplicate_flushes"] == 1
        assert server.stream_seq_of(1) == 1
    finally:
        client.close()
        server.close()
    assert len(ring) == 20


def test_chaos_dropped_acks_land_exactly_once(monkeypatch):
    """A feeder whose socket drops sends and replies (the chaos plan on
    the client side only, as in a feeder process of its own): resent
    flushes carry their ``flush_seq`` and dedup, so every acknowledged row
    lands once."""
    ring = _ring(False, capacity=4096)
    server = rs.ReplayFeedServer(ring)
    plan = fi.ChaosPlan.from_spec("drop=0.15,seed=11")
    monkeypatch.setattr(
        fi, "wrap", lambda sock, side="client":
        fi.ChaosSocket(sock, plan, side) if side == "client" else sock)
    try:
        batches = list(_batches(40, seed=4))
        acked = _feed(res, server.address, batches, actor_id=0)
    finally:
        server.close()
    assert plan.counters.get("client/drop_recv", 0) > 0
    assert acked == sum(len(b["action"]) for b in batches)
    assert ring.slots[0].steps_added == acked
    assert server.counters()["env_steps"] == acked
    assert server.telemetry.robustness_counters()["duplicate_flushes"] > 0


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_a_shed_flush_is_resent_and_lands_once(pkg):
    """Staged rows over the watermark shed the flush; the resilient client
    re-sends the SAME flush_seq after the hint, and it lands once the
    backlog clears."""
    port = pkg == "port"
    smod, cmod, fmod = (rs, res, flow) if port else (ref_rs, ref_res,
                                                     ref_flow)
    ring = _ring(not port, write_chunk=64, ingest_drain=False)
    server = smod.ReplayFeedServer(
        ring, flow=fmod.FlowConfig(staged_high_watermark=24,
                                   shed_policy="all"))
    client = cmod.ResilientReplayFeedClient.connect(*server.address,
                                                    actor_id=0, seed=0)
    first, second = _batches(2, seed=5, rows=(16, 17))
    for b in (first, second):
        b["done"][:] = b["boundary"][:] = False

    def clear_backlog():
        time.sleep(0.3)
        with server.replay_lock:
            ring.flush()

    t = threading.Thread(target=clear_backlog)
    try:
        assert client.add_transitions(**first)["ok"]   # 16 staged ≤ 24
        assert ring.pending_rows() == 16
        t.start()
        r = client.add_transitions(**second)           # 32 > 24: SHED first
        t.join(timeout=10)
        assert not t.is_alive()
        assert r["ok"] and not r.get("duplicate")
        assert client.sheds >= 1
        counters = server.telemetry.robustness_counters()
        assert counters["shed_flushes"] == client.sheds
        assert counters["duplicate_flushes"] == 0
        assert server.counters()["env_steps"] == 32
    finally:
        client.close()
        server.close()
    ring.flush()
    assert len(ring) == 32


def _seam_chunk(n):
    return {"frame": np.stack([np.full(FRAME, i, np.uint8)
                               for i in range(n)]),
            "action": np.zeros(n, np.int32),
            "reward": np.ones(n, np.float32),
            "done": np.zeros(n, bool), "boundary": np.zeros(n, bool)}


def test_reset_stream_seals_the_slot_on_host_and_device():
    rings = []
    for ref, smod in ((False, rs), (True, ref_rs)):
        ring = _ring(ref)
        server = smod.ReplayFeedServer(ring)
        client = smod.ReplayFeedClient(*server.address, actor_id=1)
        try:
            client.add_transitions(**_seam_chunk(10))   # mid-episode
            slot = ring._slot_cycle[1][0]
            assert not ring.slots[slot].boundary[:10].any()
            # the replacement actor announces itself on the same stream
            client2 = smod.ReplayFeedClient(*server.address, actor_id=1)
            try:
                assert client2.call("reset_stream")["ok"]
            finally:
                client2.close()
            m = ring.slots[slot]
            assert m.boundary[9] and not m.done[9]
            assert ring.pending_rows() == 0       # flushed before the seal
            _, base = ring._slot_base(slot)
            assert int(_planes(ring)["boundary"][base + 9]) == 1
        finally:
            client.close()
            server.close()
        rings.append(ring)
    _assert_rings_equal(*rings)


# -- R2D2 sequences -----------------------------------------------------------------

SEQ_LEN, LSTM = 8, 16


def _sequences(n, seed):
    rng = np.random.default_rng(seed)
    return {
        "obs": rng.integers(0, 255, (n, SEQ_LEN + 1, 6, 6, 3), np.uint8),
        "action": rng.integers(0, 4, (n, SEQ_LEN)).astype(np.int32),
        "reward": rng.standard_normal((n, SEQ_LEN)).astype(np.float32),
        "discount": np.full((n, SEQ_LEN), 0.99, np.float32),
        "mask": np.ones((n, SEQ_LEN), np.float32),
        "init_c": rng.standard_normal((n, LSTM)).astype(np.float32),
        "init_h": rng.standard_normal((n, LSTM)).astype(np.float32),
    }


def _seq_tier(tier: str, ref: bool):
    kw = dict(lstm_size=LSTM, alpha=0.6, seed=0, prioritized=True)
    if tier == "sequence":
        return (ref_seq if ref else seq).SequenceReplay(
            32, SEQ_LEN, (6, 6, 3), np.uint8, **kw)
    if ref:
        return ref_ds.DeviceSequenceReplay(32, SEQ_LEN, (6, 6, 3), _mesh(),
                                           write_chunk=3, **kw)
    return ds.DeviceSequenceReplay(32, SEQ_LEN, (6, 6, 3), "cpu",
                                   write_chunk=3, **kw)


@pytest.mark.parametrize("tier", ["sequence", "device_sequence"])
def test_sequence_payloads_land_in_both_sequence_tiers(tier):
    torch.set_num_threads(1)
    port, ref = _seq_tier(tier, False), _seq_tier(tier, True)
    pairs = ((rs, port, ref_rs), (ref_rs, ref, rs))   # server pkg, replay,
    for smod, replay, cmod in pairs:                  # client pkg
        server = smod.ReplayFeedServer(replay)
        client = cmod.ReplayFeedClient(*server.address, actor_id=1)
        try:
            for i in range(3):
                r = client.add_transitions(
                    flush_seq=i + 1, **_sequences(5, seed=i), env_steps=20,
                    episodes=1, ep_returns=np.asarray([12.0], np.float32))
                assert r["ok"] and r["env_steps"] == 20 * (i + 1)
            assert client.call("stats")["replay_size"] == 15
        finally:
            client.close()
            server.close()
    if tier == "device_sequence":
        for r in (port, ref):
            r.flush()
        np.testing.assert_array_equal(np.asarray(port.ring),
                                      np.asarray(ref.ring))
        for k in ref.dmeta:
            np.testing.assert_array_equal(np.asarray(port.dmeta[k]),
                                          np.asarray(ref.dmeta[k]),
                                          err_msg=k)
    want = ref_persist.replay_state(ref)
    got = persistence.replay_state(port)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)


# -- snapshot and warm boot ---------------------------------------------------------


def test_snapshot_warm_boots_a_fresh_server_bitwise(tmp_path):
    torch.set_num_threads(1)
    path = str(tmp_path / "snap")
    ring = _ring(False)
    server = rs.ReplayFeedServer(ring)
    try:
        for actor in (0, 1):
            _feed(res, server.address, _batches(8, seed=20 + actor), actor)
        server.publish_params([np.arange(6, dtype=np.float32)])
        server.publish_params([np.arange(6, dtype=np.float32) * 2])
    finally:
        server.close()
    server.snapshot(path)
    want = persistence.replay_state(ring)
    dedup = dict(server._flush_seq)
    assert dedup == {0: 8, 1: 8}

    booted_ring = _ring(False)
    booted = rs.ReplayFeedServer(booted_ring, snapshot_path=path)
    try:
        assert booted._flush_seq == dedup
        assert booted._published_version() == 2
        assert booted.counters() == server.counters()
        c = rs.ReplayFeedClient(*booted.address, actor_id=0)
        try:
            version, w = c.get_params()
            assert version == 2
            np.testing.assert_array_equal(
                w[0], np.arange(6, dtype=np.float32) * 2)
            b = next(_batches(1, seed=99))
            assert c.add_transitions(flush_seq=8, **b)["duplicate"]
        finally:
            c.close()
    finally:
        booted.close()
    got = persistence.replay_state(booted_ring)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)
    # the reference's server warm-boots from the port's snapshot too
    ref_ring = _ring(True)
    ref_booted = ref_rs.ReplayFeedServer(ref_ring, snapshot_path=path)
    try:
        assert ref_booted._flush_seq == dedup
        assert ref_booted._published_version() == 2
    finally:
        ref_booted.close()
    _assert_rings_equal(booted_ring, ref_ring)
