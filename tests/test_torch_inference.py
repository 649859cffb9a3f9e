"""Port vs reference: the inference plane (``rpc/inference_server.py``,
``models/policy.py``, ``actors/supervisor.py::_RemoteInference``).

A twin of each test in ``tests/test_inference.py``, on the port's server,
client and policy (on the CPU): the ``infer`` wire round trip, remote ==
local actions on both torsos, microbatch coalescing across concurrent
clients, shed and retry against a wedged forward, the actor-side
``_RemoteInference`` source, the deterministic A/B arm split, tenants
serving distinct θ generations, the shadow tenant mirror-only (its
counters read with a deadline: the batcher releases the primary's waiters
before it mirrors, so one read right after the reply can race the last
mirror), and a θ swap racing the batcher never tearing a reply. Added:
a failed forward reaches the actor as ``RPCError`` while a closing
server's reply (a restart) is retried like a dropped connection, and each package's
client is served by the other package's server from the same θ — the
same actions (the Q rows of two implementations agree within 1e-5, so a
near-tie may flip; there the action must be one of the tied), the same
reply keys and the same version.

Sockets bind 127.0.0.1, port 0; every test carries a deadline of its own.
"""

import signal
import threading
import time

import numpy as np
import pytest
import torch

from distributed_deep_q_tpu.config import NetConfig as RefNetConfig
from distributed_deep_q_tpu.models.policy import BatchedPolicy as RefPolicy
from distributed_deep_q_tpu.rpc import inference_server as ref_is

from distributed_deep_q_tpu_torch.actors.supervisor import _RemoteInference
from distributed_deep_q_tpu_torch.config import Config, NetConfig
from distributed_deep_q_tpu_torch.models.policy import BatchedPolicy
from distributed_deep_q_tpu_torch.models.qnet import QNet
from distributed_deep_q_tpu_torch.rpc.flowcontrol import FlowConfig
from distributed_deep_q_tpu_torch.rpc.inference_server import (
    TENANT_PRIMARY, InferenceClient, InferenceServer, arm_for)
from distributed_deep_q_tpu_torch.rpc.resilience import RPCError

TIMEOUT_S = 60
Q_TIE = 1e-5
MLP = dict(kind="mlp", hidden=(32, 32), num_actions=5)


@pytest.fixture(autouse=True)
def _deadline():
    def expire(signum, frame):
        raise TimeoutError(f"test exceeded its {TIMEOUT_S} s deadline")

    prev = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, TIMEOUT_S)
    torch.set_num_threads(2)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, prev)


def _policy(net=MLP, seed=0, obs_dim=6, buckets=(8,)):
    return BatchedPolicy(NetConfig(**net), seed=seed, obs_dim=obs_dim,
                         buckets=buckets, device="cpu")


def _mlp_obs(n, seed):
    return np.random.default_rng(seed).standard_normal(
        (n, 6)).astype(np.float32)


def _same_or_tied(got, want, q) -> None:
    """Equal actions, except where ``q`` (the Q rows ``want`` came from)
    has its top two within ``Q_TIE``: there ``got`` must be one of them."""
    got, want = np.asarray(got), np.asarray(want)
    q = np.asarray(q)
    for i in np.flatnonzero(got != want):
        top = np.sort(q[i])[-1]
        assert q[i, got[i]] >= top - Q_TIE, (i, got[i], want[i], q[i])


# ---------------------------------------------------------------------------
# Wire round trip
# ---------------------------------------------------------------------------


def test_infer_wire_roundtrip():
    policy = _policy(seed=3, buckets=(4,))
    server = InferenceServer(policy, cutoff_us=500)
    host, port = server.address
    client = InferenceClient(host, port, actor_id=0)
    try:
        obs = _mlp_obs(3, 4)
        want_a, want_q = policy.forward(obs)
        version = server.set_params(policy.get_weights(), version=7)
        assert version == 7

        resp = client.infer(obs, seq=11)
        assert "error" not in resp
        np.testing.assert_array_equal(resp["actions"], want_a)
        np.testing.assert_array_equal(resp["q"], want_q)
        assert resp["version"] == 7
        assert resp["seq"] == 11
        assert resp["credits"] > 0

        assert client.call("heartbeat")["ok"] is True
        stats = client.call("stats")
        assert stats["params_version"] == 7
        assert 4 in np.asarray(stats["compiled_buckets"]).tolist()
        assert "error" in client.call("get_params")  # a replay-plane verb
    finally:
        client.close()
        server.close()


# ---------------------------------------------------------------------------
# Action parity: remote == local CPU forward, both torsos
# ---------------------------------------------------------------------------


def _net_and_obs(kind):
    if kind == "mlp":
        net = dict(kind="mlp", hidden=(24,), num_actions=4)
        rng = np.random.default_rng(5)
        return net, 6, lambda: rng.standard_normal(6).astype(np.float32)
    net = dict(kind="nature_cnn", num_actions=4, frame_shape=(36, 36),
               stack=2, compute_dtype="float32")
    rng = np.random.default_rng(6)
    return net, 4, lambda: rng.integers(0, 256, (36, 36, 2), dtype=np.uint8)


@pytest.mark.parametrize("kind", ["mlp", "nature_cnn"])
def test_action_parity_remote_vs_local(kind):
    """With identical θ, the server's bucket-padded batched forward picks
    the action the actor's own ``QNet.argmax_action`` picks (the port's
    float32 rows differ by ~1e-7 between a batch of 4 and a batch of 1 on
    the CPU, so a near-tie within 1e-5 may pick either of the tied)."""
    net, obs_dim, make = _net_and_obs(kind)
    local = QNet(NetConfig(**net), seed=9, obs_dim=obs_dim)
    policy = _policy(net, obs_dim=obs_dim, buckets=(4,))
    policy.set_weights(local.get_weights())

    server = InferenceServer(policy, cutoff_us=500)
    host, port = server.address
    client = InferenceClient(host, port, actor_id=0)
    try:
        for _ in range(16):
            obs = make()
            resp = client.infer(obs[None])
            _same_or_tied(resp["actions"], [local.argmax_action(obs)],
                          local.forward(obs[None]))
    finally:
        client.close()
        server.close()


# ---------------------------------------------------------------------------
# Microbatching across concurrent clients
# ---------------------------------------------------------------------------


def test_microbatch_coalesces_concurrent_clients():
    """Requests from distinct clients inside one cutoff window ride ONE
    forward — and every client still gets its own row back."""
    policy = _policy(seed=7, buckets=(8,))
    server = InferenceServer(policy, max_batch=8, cutoff_us=200_000)
    host, port = server.address
    num = 4
    obs = _mlp_obs(num, 8)
    want_a, want_q = policy.forward(obs)
    start = threading.Barrier(num)
    failures: list[str] = []

    def worker(i: int) -> None:
        c = InferenceClient(host, port, actor_id=i)
        try:
            start.wait(10)
            resp = c.infer(obs[i:i + 1], seq=i)
            if int(np.asarray(resp["actions"])[0]) != int(want_a[i]) \
                    or not np.allclose(resp["q"][0], want_q[i], rtol=Q_TIE,
                                       atol=Q_TIE):
                failures.append(f"client {i}: crossed or wrong reply")
        except Exception as e:  # noqa: BLE001 — surfaced via failures
            failures.append(f"client {i}: {type(e).__name__}: {e}")
        finally:
            c.close()

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(num)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    biggest = server.telemetry.batch_rows.vmax
    server.close()
    assert not any(t.is_alive() for t in threads)
    assert not failures, failures
    assert biggest >= 2


# ---------------------------------------------------------------------------
# Shed / admission against a wedged forward
# ---------------------------------------------------------------------------


class _GatedPolicy:
    """Stub with an event-gated forward so the test controls exactly when
    the batcher is busy."""

    def __init__(self, num_actions: int = 3):
        self.gate = threading.Event()
        self.in_forward = threading.Event()
        self.num_actions = num_actions

    def forward(self, obs):
        self.in_forward.set()
        assert self.gate.wait(30)
        n = obs.shape[0]
        return (np.zeros(n, np.int64),
                np.zeros((n, self.num_actions), np.float32))

    def compiled_buckets(self):
        return []


def test_shed_reply_and_retry():
    policy = _GatedPolicy()
    server = InferenceServer(
        policy, max_batch=256, cutoff_us=1_000,
        flow=FlowConfig(staged_high_watermark=8, shed_policy="all",
                        flush_credit_floor=4))
    host, port = server.address
    obs6 = np.zeros((6, 2), np.float32)
    replies: dict[str, dict] = {}

    def send(name: str, aid: int) -> None:
        c = InferenceClient(host, port, actor_id=aid)
        try:
            replies[name] = c.call("infer", obs=obs6)
        finally:
            c.close()

    ta = threading.Thread(target=send, args=("a", 1))
    ta.start()
    assert policy.in_forward.wait(10)  # the batcher took A, wedged
    tb = threading.Thread(target=send, args=("b", 2))
    tb.start()
    deadline = time.monotonic() + 10
    while server.queued_rows() < 6 and time.monotonic() < deadline:
        time.sleep(0.005)
    assert server.queued_rows() == 6  # B staged behind the wedged forward

    # C: 6 staged + 6 new > watermark 8 → explicit shed, never queued
    c = InferenceClient(host, port, actor_id=99)
    try:
        resp = c.call("infer", obs=obs6)
        assert resp.get("shed") is True
        assert resp["retry_after_ms"] >= 0
        assert "credits" in resp

        policy.gate.set()  # unwedge; A then B drain
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            resp = c.call("infer", obs=obs6)
            if not resp.get("shed"):
                break
            time.sleep(resp["retry_after_ms"] / 1e3)
        assert not resp.get("shed"), "retry never admitted after drain"
        assert len(resp["actions"]) == 6
    finally:
        c.close()
        ta.join(timeout=10)
        tb.join(timeout=10)
        summary = server.telemetry_summary()
        server.close()
    assert len(replies["a"]["actions"]) == 6
    assert len(replies["b"]["actions"]) == 6
    assert summary["inference/sheds"] >= 1


# ---------------------------------------------------------------------------
# Actor-side source (_RemoteInference)
# ---------------------------------------------------------------------------


def _remote_cfg(server, net) -> Config:
    cfg = Config()
    cfg.net = NetConfig(**net)
    cfg.inference.enabled = True
    cfg.inference.host, cfg.inference.port = server.address
    return cfg


def test_remote_inference_actor_source():
    net = dict(kind="mlp", hidden=(24,), num_actions=3)
    local = QNet(NetConfig(**net), seed=2, obs_dim=4)
    policy = _policy(net, obs_dim=4, buckets=(4,))
    server = InferenceServer(policy, cutoff_us=500)
    cfg = _remote_cfg(server, net)
    server.set_params(local.get_weights(), version=5)

    remote = _RemoteInference(cfg, threading.Event(), actor_id=0, gid=0)
    try:
        rng = np.random.default_rng(10)
        for _ in range(8):
            obs = rng.standard_normal(4).astype(np.float32)
            _same_or_tied([remote.action(obs)], [local.argmax_action(obs)],
                          local.forward(obs[None]))
        rows = rng.standard_normal((5, 4)).astype(np.float32)
        got = remote.actions(rows)
        assert got.dtype == np.int64 and got.shape == (5,)
        _same_or_tied(got, np.argmax(local.forward(rows), axis=-1),
                      local.forward(rows))
        assert remote.version == 5
        assert remote.sheds == 0
    finally:
        remote.close()
        server.close()


class _FailingPolicy(_GatedPolicy):
    def forward(self, obs):
        raise RuntimeError("device lost")


def test_failed_forward_reaches_the_actor_as_rpc_error():
    """No fallback: a forward that raises answers the reference's
    ``error`` reply, and the actor's source raises ``RPCError``."""
    server = InferenceServer(_FailingPolicy(), cutoff_us=500)
    cfg = _remote_cfg(server, dict(kind="mlp", hidden=(8,), num_actions=3))
    remote = _RemoteInference(cfg, threading.Event(), actor_id=0, gid=0)
    try:
        with pytest.raises(RPCError, match="device lost"):
            remote.action(np.zeros(2, np.float32))
    finally:
        remote.close()
        server.close()


def _scripted(server, replies):
    """Answer the server's first infers with ``replies``, in order, then
    serve as usual."""
    real = server._infer
    left = list(replies)

    def infer(req, actor_id):
        return left.pop(0) if left else real(req, actor_id)

    server._infer = infer


@pytest.mark.parametrize("first, raises", [
    ({"error": "inference server closing"}, None),
    ({"error": "RuntimeError: device lost"}, "device lost"),
])
def test_remote_inference_retries_a_closing_server_only(monkeypatch, first,
                                                        raises):
    """An infer that meets a closing server (a restart) is re-sent under
    the stub's retry deadline, with the ``retry`` instant of every other
    retry, and gets the right actions; the infer is a pure function of
    (θ, obs), so the re-send is idempotent. Any other ``error`` reply (a
    failed forward) still raises ``RPCError``."""
    from distributed_deep_q_tpu_torch import tracing

    net = dict(kind="mlp", hidden=(24,), num_actions=3)
    local = QNet(NetConfig(**net), seed=2, obs_dim=4)
    server = InferenceServer(_policy(net, obs_dim=4, buckets=(8,)),
                             cutoff_us=500)
    server.set_params(local.get_weights(), version=3)
    _scripted(server, [first])
    cfg = _remote_cfg(server, net)
    cfg.actors.rpc_retry_base = 0.01
    instants = []
    monkeypatch.setattr(tracing, "instant",
                        lambda name, **kw: instants.append((name, kw)))
    remote = _RemoteInference(cfg, threading.Event(), actor_id=0, gid=0)
    rows = np.random.default_rng(3).standard_normal((5, 4)).astype(
        np.float32)
    try:
        if raises:
            with pytest.raises(RPCError, match=raises):
                remote.actions(rows)
            assert remote._client.retries == 0
            return
        got = remote.actions(rows)
        _same_or_tied(got, np.argmax(local.forward(rows), axis=-1),
                      local.forward(rows))
        assert remote.version == 3
        assert remote._client.retries == 1
        assert ("retry", {"method": "infer", "attempt": 0}) in instants
    finally:
        remote.close()
        server.close()


# ---------------------------------------------------------------------------
# Each package's client against the other package's server
# ---------------------------------------------------------------------------


def _cross_servers(kind):
    """A reference and a port server, the reference policy's θ installed
    in both under one version."""
    if kind == "mlp":
        net, obs_dim = dict(MLP), 6
    else:
        net, obs_dim = dict(kind="nature_cnn", num_actions=4,
                            frame_shape=(36, 36), compute_dtype="float32"), 4
    ref_policy = RefPolicy(RefNetConfig(**net), seed=4, obs_dim=obs_dim,
                           buckets=(8, 32))
    theta = ref_policy.get_weights()
    ref = ref_is.InferenceServer(ref_policy, cutoff_us=500)
    port = InferenceServer(_policy(net, obs_dim=obs_dim, buckets=(8, 32)),
                           cutoff_us=500)
    for srv in (ref, port):
        assert srv.set_params(theta, version=7) == 7
    rng = np.random.default_rng(12)
    if kind == "mlp":
        obs = rng.standard_normal((11, 6)).astype(np.float32)
    else:
        obs = rng.integers(0, 256, (11, 36, 36, 4), dtype=np.uint8)
    return ref, port, obs


@pytest.mark.parametrize("kind", ["mlp", "nature_cnn"])
@pytest.mark.parametrize("client_pkg", ["reference", "port"])
def test_a_client_is_served_by_the_other_packages_server(client_pkg, kind):
    ref, port, obs = _cross_servers(kind)
    client_cls = (ref_is.InferenceClient if client_pkg == "reference"
                  else InferenceClient)
    clients = [client_cls(*srv.address, actor_id=3) for srv in (ref, port)]
    try:
        r_ref, r_port = (c.infer(obs, seq=2) for c in clients)
        assert "error" not in r_ref and "error" not in r_port
        assert set(r_port) == set(r_ref)
        assert r_port["version"] == r_ref["version"] == 7
        assert r_port["tenant"] == r_ref["tenant"] == TENANT_PRIMARY
        assert r_port["seq"] == r_ref["seq"] == 2
        np.testing.assert_allclose(r_port["q"], r_ref["q"], rtol=Q_TIE,
                                   atol=Q_TIE)
        _same_or_tied(r_port["actions"], r_ref["actions"], r_ref["q"])
        assert np.asarray(r_port["actions"]).dtype == np.int64
        s_ref, s_port = (c.call("stats") for c in clients)
        assert set(s_port) == set(s_ref)
        assert s_port["params_version"] == s_ref["params_version"] == 7
    finally:
        for c in clients:
            c.close()
        ref.close()
        port.close()


# ---------------------------------------------------------------------------
# Multi-tenant serving: per-tenant θ, A/B split, shadow mirror
# ---------------------------------------------------------------------------


def _rigged(weights, v: int, num_actions: int = 5):
    """All-zero θ except the final Q bias, one-hot at ``v % A``: argmax
    action == v % A for ANY observation, so a reply's actions spell out
    which θ generation computed them."""
    out = []
    for w in weights:
        z = np.zeros_like(np.asarray(w))
        if z.ndim == 1 and z.shape[0] == num_actions:
            z[v % num_actions] = 1.0
        out.append(z)
    return out


def test_arm_split_deterministic_and_covers_arms():
    arms = (TENANT_PRIMARY, "ab:cand")
    picks = [arm_for(a, arms) for a in range(64)]
    assert picks == [arm_for(a, arms) for a in range(64)]  # pure
    assert picks == [ref_is.arm_for(a, arms) for a in range(64)]
    assert set(picks) == set(arms)
    assert arm_for(3, ()) == TENANT_PRIMARY


def test_tenants_serve_distinct_generations():
    policy = _policy(seed=11, buckets=(8,))
    server = InferenceServer(policy, max_batch=8, cutoff_us=300,
                             tenants=("ab:cand",))
    host, port = server.address
    base = policy.get_weights()
    server.set_params(_rigged(base, 2), version=2)
    server.set_params(_rigged(base, 3), version=3, tenant="ab:cand")
    client = InferenceClient(host, port, actor_id=0)
    try:
        obs = _mlp_obs(4, 0)
        rp = client.infer(obs, tenant=TENANT_PRIMARY)
        ra = client.infer(obs, tenant="ab:cand")
        assert rp["version"] == 2 and rp["tenant"] == TENANT_PRIMARY
        assert ra["version"] == 3 and ra["tenant"] == "ab:cand"
        assert all(int(a) == 2 for a in np.asarray(rp["actions"]))
        assert all(int(a) == 3 for a in np.asarray(ra["actions"]))
        tm = server.telemetry_summary()
        assert tm["tenant/served"] >= 2.0
        assert tm["tenant/ab:cand/requests"] == 1.0
    finally:
        client.close()
        server.close()


def test_shadow_is_mirror_only_and_counts_divergence():
    policy = _policy(seed=12, buckets=(8,))
    server = InferenceServer(policy, max_batch=8, cutoff_us=300,
                             tenants=("shadow:next",))
    host, port = server.address
    base = policy.get_weights()
    server.set_params(_rigged(base, 1), version=1)
    # the shadow θ is rigged to a DIFFERENT action: every mirrored row
    # diverges
    server.set_params(_rigged(base, 4), version=4, tenant="shadow:next")
    client = InferenceClient(host, port, actor_id=5)
    try:
        rej = client.infer(np.zeros((2, 6), np.float32),
                           tenant="shadow:next")
        assert "mirror-only" in str(rej.get("error", ""))
        for i in range(4):
            r = client.infer(_mlp_obs(4, i))
            assert r["tenant"] == TENANT_PRIMARY  # never a shadow reply
            assert all(int(a) == 1 for a in np.asarray(r["actions"]))
        # the primary's waiters are released before the mirror runs: wait
        # for the last mirror with a deadline instead of reading once
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            tm = server.telemetry_summary()
            if tm["tenant/shadow:next/shadow_requests"] >= 16.0:
                break
            time.sleep(0.01)
        assert tm["tenant/shadow:next/shadow_requests"] >= 16.0
        assert tm["tenant/shadow:next/shadow_diverged"] >= 16.0
        assert tm["tenant/shadow:next/requests"] == 0.0  # served nobody
    finally:
        client.close()
        server.close()


def test_mid_batch_swap_keeps_reply_consistent():
    """``set_params`` racing the batcher: every reply's (actions, version)
    pair comes from ONE θ generation per tenant — the rigged weights make
    a torn capture visible as an action contradicting the reply's own
    version stamp."""
    policy = _policy(seed=13, buckets=(8,))
    server = InferenceServer(policy, max_batch=8, cutoff_us=2000,
                             tenants=("ab:cand",))
    host, port = server.address
    base = policy.get_weights()
    server.set_params(_rigged(base, 0), version=0)
    server.set_params(_rigged(base, 1), version=1, tenant="ab:cand")
    stop = threading.Event()
    problems: list[str] = []

    def swapper() -> None:
        v = 2
        while not stop.is_set():
            server.set_params(_rigged(base, v), version=v)
            server.set_params(_rigged(base, v + 1), version=v + 1,
                              tenant="ab:cand")
            v += 2
            time.sleep(0.002)

    def drive(aid: int, tenant: str) -> None:
        rng = np.random.default_rng(aid)
        c = InferenceClient(host, port, actor_id=aid)
        try:
            done = 0
            while done < 40 and not problems:
                obs = rng.standard_normal(
                    (int(rng.integers(1, 6)), 6)).astype(np.float32)
                r = c.infer(obs, seq=done, tenant=tenant)
                if r.get("shed"):
                    time.sleep(r.get("retry_after_ms", 10) / 1e3)
                    continue
                if "error" in r:
                    problems.append(f"aid {aid}: {r['error']}")
                    return
                acts = np.asarray(r["actions"])
                want = int(r["version"]) % 5
                if r["tenant"] != tenant:
                    problems.append(
                        f"aid {aid}: tenant {r['tenant']} != {tenant}")
                if not all(int(a) == want for a in acts):
                    problems.append(
                        f"aid {aid}: actions {acts.tolist()} vs version "
                        f"{r['version']} (torn θ capture)")
                done += 1
        finally:
            c.close()

    sw = threading.Thread(target=swapper, daemon=True)
    sw.start()
    callers = ([threading.Thread(target=drive, args=(a, TENANT_PRIMARY))
                for a in (0, 1, 2)]
               + [threading.Thread(target=drive, args=(a, "ab:cand"))
                  for a in (3, 4)])
    for t in callers:
        t.start()
    for t in callers:
        t.join(timeout=40)
    stop.set()
    sw.join(timeout=10)
    server.close()
    assert problems == []
    assert not any(t.is_alive() for t in callers)
