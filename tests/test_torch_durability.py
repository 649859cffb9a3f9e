"""The port's durability plane (``utils/durability.py``) against the
reference's: the cases of ``tests/test_durability.py`` that the chaos
``durability`` and ``churn`` modes lean on — ``GenerationStore`` commit
and verify, torn generations, the newest valid generation, quarantine,
the server's warm boot from it and the shard handoff.

Each case runs against both packages' store (``pkg``), so the port is
held to the reference's own expectations, and the two stores read each
other's generations byte for byte. Tolerance: none, everything is exact.
The raw ``open`` calls here damage or forge snapshot files on purpose.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

from distributed_deep_q_tpu.rpc import faultinject as ref_faultinject
from distributed_deep_q_tpu.utils import durability as ref_durability

from distributed_deep_q_tpu_torch.rpc import faultinject
from distributed_deep_q_tpu_torch.rpc.replay_server import (
    ReplayFeedClient, ReplayFeedServer)
from distributed_deep_q_tpu_torch.replay.replay_memory import ReplayMemory
from distributed_deep_q_tpu_torch.utils import durability

PKGS = {"port": (durability, faultinject),
        "reference": (ref_durability, ref_faultinject)}


@pytest.fixture(autouse=True)
def _no_chaos_leak(monkeypatch):
    for _, fi in PKGS.values():
        monkeypatch.delenv(fi.ENV_VAR, raising=False)
        fi.uninstall()
    yield
    for _, fi in PKGS.values():
        fi.uninstall()


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


def _two_gen_store(dur, root: str):
    """gen 0 and gen 1, two payload files each, distinct contents (the
    reference test's store)."""
    store = dur.GenerationStore(root, keep=4)
    for i in range(2):
        store.commit({"server.npz": bytes([i]) * 900,
                      "replay.npz": bytes([10 + i]) * 1700},
                     meta={"env_steps": 100 + i})
    return store


def test_store_commit_verify_roundtrip(pkg, tmp_path):
    dur, _ = pkg
    store = dur.GenerationStore(str(tmp_path / "s"), keep=3)
    gen = store.commit({"a.npz": b"AAAA", "b.npz": b"BBBBBB"},
                       meta={"env_steps": 7})
    assert gen == 0
    paths, meta = store.verify(0)
    assert set(paths) == {"a.npz", "b.npz"}
    assert meta == {"env_steps": 7}
    assert store.latest_valid()[0] == 0


def test_store_retention_prunes_oldest(pkg, tmp_path):
    dur, _ = pkg
    store = dur.GenerationStore(str(tmp_path / "s"), keep=2)
    for i in range(5):
        store.commit({"f": bytes([i])})
    assert store.generations() == [3, 4]
    assert store.latest_valid()[0] == 4


def test_store_missing_root_is_cold_boot(pkg, tmp_path):
    dur, _ = pkg
    store = dur.GenerationStore(str(tmp_path / "never"))
    assert store.generations() == []
    assert store.latest_valid() is None
    assert store.quarantined == 0


def test_torn_chaos_verb_damages_the_final_file(pkg, tmp_path):
    dur, fi = pkg
    plan = fi.install("torn=1.0,seed=3")
    p = str(tmp_path / "torn.bin")
    data = bytes(range(256)) * 16
    dur.atomic_write(p, data)
    assert plan.counters.get("file/torn", 0) == 1
    with open(p, "rb") as f:
        got = f.read()
    assert got != data
    assert dur.crc32c(got) != dur.crc32c(data)


def test_store_never_serves_torn_generations_under_chaos(pkg, tmp_path):
    """torn= chaos on every other write: the newest valid generation is
    always one that verifies clean."""
    dur, fi = pkg
    fi.install("torn=0.5,seed=11")
    rng = np.random.default_rng(1)
    store = dur.GenerationStore(str(tmp_path / "store"), keep=8)
    for _ in range(6):
        blob = rng.integers(0, 256, size=1500, dtype=np.uint8).tobytes()
        store.commit({"server.npz": blob}, meta={"n": len(blob)})
    fi.uninstall()
    pick = store.latest_valid()
    if pick is not None:
        gen, paths, meta = pick
        with open(paths["server.npz"], "rb") as f:
            assert len(f.read()) == meta["n"]


@pytest.mark.parametrize("name, size", [("server.npz", 900),
                                        ("replay.npz", 1700)])
def test_torn_write_matrix_truncation_every_boundary(pkg, name, size,
                                                     tmp_path):
    """Truncating a payload file of the newest generation at any boundary
    quarantines it and falls back to the previous generation."""
    dur, _ = pkg
    for case, cut in enumerate((0, 1, size // 2, size - 1)):
        root = str(tmp_path / f"m{case}")
        store = _two_gen_store(dur, root)
        victim = os.path.join(root, f"{dur.GEN_PREFIX}00000001", name)
        with open(victim, "rb") as f:
            pristine = f.read()
        with open(victim, "wb") as f:
            f.write(pristine[:cut])
        with pytest.raises(dur.IntegrityError, match="torn write"):
            store.verify(1)
        gen, _, meta = store.latest_valid()
        assert gen == 0 and meta["env_steps"] == 100
        assert store.quarantined == 1
        assert any(n.startswith(dur.QUARANTINE_PREFIX)
                   for n in os.listdir(root))


def test_torn_write_matrix_garbage_span_same_size(pkg, tmp_path):
    dur, _ = pkg
    root = str(tmp_path / "g")
    store = _two_gen_store(dur, root)
    victim = os.path.join(root, f"{dur.GEN_PREFIX}00000001", "server.npz")
    with open(victim, "r+b") as f:
        f.seek(300)
        f.write(b"\xde\xad\xbe\xef" * 8)
    with pytest.raises(dur.IntegrityError, match="corrupt"):
        store.verify(1)
    assert store.latest_valid()[0] == 0


@pytest.mark.parametrize("damage", ["torn_json", "schema", "digest", "size"])
def test_torn_write_matrix_manifest_damage(pkg, damage, tmp_path):
    dur, _ = pkg
    server_digest = '"%08x"' % dur.crc32c(b"\x01" * 900)
    mutate = {"torn_json": lambda t: t[: len(t) // 2],
              "schema": lambda t: t.replace('"schema": 1', '"schema": 99'),
              "digest": lambda t: t.replace(server_digest, '"00000000"'),
              "size": lambda t: t.replace('"size": 900', '"size": 901')}
    root = str(tmp_path / "mf")
    store = _two_gen_store(dur, root)
    mpath = os.path.join(root, f"{dur.GEN_PREFIX}00000001",
                         dur.MANIFEST_NAME)
    with open(mpath, encoding="utf-8") as f:
        text = f.read()
    assert mutate[damage](text) != text
    with open(mpath, "w", encoding="utf-8") as f:
        f.write(mutate[damage](text))
    with pytest.raises(dur.IntegrityError):
        store.verify(1)
    assert store.latest_valid()[0] == 0


def test_uncommitted_generation_is_invisible(pkg, tmp_path):
    """A generation directory without a manifest (a crash before the
    commit point, what the chaos durability mode fabricates) is
    quarantined by the walk, and numbering continues past it."""
    dur, _ = pkg
    root = str(tmp_path / "u")
    store = _two_gen_store(dur, root)
    partial = os.path.join(root, f"{dur.GEN_PREFIX}00000002")
    os.makedirs(partial)
    with open(os.path.join(partial, "server.npz"), "wb") as f:
        f.write(b"\x00" * 100)
    gen, _, meta = store.latest_valid()
    assert gen == 1 and meta["env_steps"] == 101
    assert store.quarantined == 1
    assert store.commit({"server.npz": b"x"}) == 2


def test_quarantine_disk_use_is_bounded(pkg, tmp_path):
    dur, _ = pkg
    root = str(tmp_path / "q")
    store = dur.GenerationStore(root, keep=2)
    for _ in range(4):
        for _ in range(2):
            g = store.commit({"f": b"x" * 64})
            with open(os.path.join(store._gen_dir(g), "f"), "wb") as f:
                f.write(b"")
        assert store.latest_valid() is None
    assert store.quarantined == 8
    quars = [n for n in os.listdir(root)
             if n.startswith(dur.QUARANTINE_PREFIX)]
    assert len(quars) <= 4


@pytest.mark.parametrize("writer, reader", [("port", "reference"),
                                            ("reference", "port")])
def test_generations_cross_both_ways(writer, reader, tmp_path):
    """A generation one package commits, the other verifies to the same
    paths, bytes and metadata; a torn one, it quarantines the same way.
    The crc32c digests agree on the same bytes."""
    w, r = PKGS[writer][0], PKGS[reader][0]
    root = str(tmp_path / "x")
    _two_gen_store(w, root)
    store = r.GenerationStore(root, keep=4)
    paths, meta = store.verify(1)
    assert meta == {"env_steps": 101}
    with open(paths["replay.npz"], "rb") as f:
        assert f.read() == bytes([11]) * 1700
    victim = os.path.join(root, f"{w.GEN_PREFIX}00000001", "server.npz")
    with open(victim, "r+b") as f:
        f.truncate(10)
    gen, _, meta = store.latest_valid()
    assert gen == 0 and meta == {"env_steps": 100}
    blob = bytes(range(256)) * 9
    assert w.crc32c(blob) == r.crc32c(blob)


def _vector_batch(n: int, base: float = 0.0) -> dict:
    ids = base + np.arange(n, dtype=np.float32)
    obs = np.stack([ids, ids], axis=1)
    return dict(obs=obs, action=np.zeros(n, np.int32),
                reward=np.zeros(n, np.float32), next_obs=obs,
                discount=np.ones(n, np.float32))


def _fed_snapshots(snap: str, gens: int) -> None:
    """A port server fed 2 rows per generation (flush seqs 1, 2, ...),
    snapshotted after each."""
    server = ReplayFeedServer(ReplayMemory(64, (2,)))
    c = ReplayFeedClient(*server.address, actor_id=1)
    try:
        for g in range(gens):
            c.call("add_transitions", flush_seq=g + 1,
                   **_vector_batch(2, base=50.0 * g))
            assert server.snapshot(snap) == g
    finally:
        c.close()
        server.close()


def test_warm_boot_falls_back_to_older_generation(tmp_path):
    """The port's server boots from the newest generation that verifies:
    a torn newest one is quarantined and counted, and the one before it
    restores its rows, counters and dedup map (the chaos durability
    mode's probe answers the same generation)."""
    snap = str(tmp_path / "fb")
    _fed_snapshots(snap, 2)
    victim = os.path.join(snap, f"{durability.GEN_PREFIX}00000001",
                          "server.npz")
    with open(victim, "r+b") as f:
        f.truncate(40)
    probe = ref_durability.GenerationStore(snap, keep=4)
    assert probe.verify(0)[1]["env_steps"] == 2
    replay = ReplayMemory(64, (2,))
    server = ReplayFeedServer(replay, snapshot_path=snap)
    try:
        assert server._restored_generation == 0
        assert server.env_steps == 2 and len(replay) == 2
        assert server._flush_seq == {1: 1}
        assert server.telemetry.robustness_counters()[
            "snapshot_quarantined"] == 1
    finally:
        server.close()


def test_warm_boot_cold_boots_when_every_generation_is_torn(tmp_path):
    snap = str(tmp_path / "cb")
    _fed_snapshots(snap, 2)
    for gen in (0, 1):
        with open(os.path.join(snap, f"{durability.GEN_PREFIX}{gen:08d}",
                               durability.MANIFEST_NAME), "w") as f:
            f.write("{ not json")
    replay = ReplayMemory(64, (2,))
    server = ReplayFeedServer(replay, snapshot_path=snap)
    try:
        assert server._restored_generation == -1
        assert server.env_steps == 0 and len(replay) == 0
        assert server.telemetry.snapshot_quarantined == 2
    finally:
        server.close()


def test_shard_handoff_is_lossless_and_keeps_the_dedup_map(tmp_path):
    """The churn mode's handoff: a retiring host exports its shard through
    the GenerationStore and a fresh host imports it; the rows, the counters
    and the flush-seq dedup map arrive, so a resent flush lands nothing."""
    from distributed_deep_q_tpu_torch.actors import membership as ms

    server = ReplayFeedServer(ReplayMemory(64, (2,)))
    c = ReplayFeedClient(*server.address, actor_id=4)
    try:
        for seq in (1, 2, 3):
            c.call("add_transitions", flush_seq=seq,
                   **_vector_batch(4, base=10.0 * seq))
    finally:
        c.close()
    shard = str(tmp_path / "shard")
    export = ms.export_shard(server, shard)
    replay2 = ReplayMemory(64, (2,))
    server2, imported = ms.import_shard(replay2, shard)
    try:
        assert export["rows"] == imported["rows"] == 12
        np.testing.assert_array_equal(
            replay2.obs[:12, 0],
            np.concatenate([10.0 * s + np.arange(4) for s in (1, 2, 3)]))
        with open(os.path.join(shard, f"{durability.GEN_PREFIX}"
                               f"{imported['generation']:08d}",
                               durability.MANIFEST_NAME)) as f:
            assert json.load(f)["files"]
        c2 = ReplayFeedClient(*server2.address, actor_id=4)
        try:
            c2.call("add_transitions", flush_seq=3,
                    **_vector_batch(4, base=30.0))
        finally:
            c2.close()
        assert len(replay2) == 12 and server2.env_steps == 12
        assert server2.telemetry.robustness_counters()[
            "duplicate_flushes"] == 1
    finally:
        server2.close()
