"""The port's consistent-hash actor→host assignment
(``distributed_deep_q_tpu_torch/actors/assignment.py``) against the
reference's: the twins of ``tests/test_assignment.py``, each asserting the
property on the port and that the reference computes the same result.

The properties, in load-bearing order: no empty shard (an unfed replay
shard deadlocks the cross-process learn gate), a pure function of (fleet,
hosts), restart stability, minimal remap when the host set changes.
"""

from __future__ import annotations

import pytest

from distributed_deep_q_tpu.actors import assignment as ref

from distributed_deep_q_tpu_torch.actors.assignment import (
    assign_fleet, host_tokens, local_slice, owner_host, stable_hash)


def test_stable_hash_is_process_independent():
    assert stable_hash("actor-0") == stable_hash("actor-0")
    assert stable_hash("actor-0") != stable_hash("actor-1")
    assert stable_hash("host-0") == 0x4D13B6CDF93B5206
    for token in ("host-0", "host-7", "actor-0", "actor-123"):
        assert stable_hash(token) == ref.stable_hash(token)


def test_covers_fleet_disjoint_and_deterministic():
    for fleet, hosts in [(1, 1), (7, 2), (16, 4), (64, 4), (13, 5)]:
        a = assign_fleet(fleet, host_tokens(hosts))
        assert a == assign_fleet(fleet, host_tokens(hosts))
        gids = [g for v in a.values() for g in v]
        assert sorted(gids) == list(range(fleet))
        assert a == ref.assign_fleet(fleet, ref.host_tokens(hosts))


def test_balance_floor_ceil_every_host_nonempty():
    for fleet, hosts in [(4, 4), (5, 4), (8, 3), (64, 8), (257, 16)]:
        out = assign_fleet(fleet, host_tokens(hosts))
        lo, hi = fleet // hosts, -(-fleet // hosts)
        for h, v in out.items():
            assert lo <= len(v) <= hi, (fleet, hosts, h, len(v))
        if fleet >= hosts:
            assert all(out[h] for h in out)
        assert out == ref.assign_fleet(fleet, ref.host_tokens(hosts))


def test_restart_stability_same_gid_same_host():
    hosts = host_tokens(4)
    before = assign_fleet(64, hosts)
    owner = {g: h for h, v in before.items() for g in v}
    after = assign_fleet(64, hosts)
    for g in range(64):
        assert g in set(after[owner[g]])
    assert before == ref.assign_fleet(64, ref.host_tokens(4))


def test_minimal_remap_on_host_join():
    fleet = 64
    a = assign_fleet(fleet, host_tokens(4))
    b = assign_fleet(fleet, host_tokens(5))
    owner_a = {g: h for h, v in a.items() for g in v}
    owner_b = {g: h for h, v in b.items() for g in v}
    moved = sum(owner_a[g] != owner_b[g] for g in range(fleet))
    assert 0 < moved < fleet * 0.5, f"{moved}/{fleet} actors moved on join"
    assert b == ref.assign_fleet(fleet, ref.host_tokens(5))


def test_minimal_remap_on_multi_host_leave():
    fleet = 64
    before = host_tokens(6)
    a = assign_fleet(fleet, before)
    survivors = tuple(t for t in before if t not in ("host-1", "host-4"))
    b = assign_fleet(fleet, survivors)
    owner_a = {g: h for h, v in a.items() for g in v}
    owner_b = {g: h for h, v in b.items() for g in v}
    orphaned = set(a["host-1"]) | set(a["host-4"])
    moved = {g for g in range(fleet) if owner_a[g] != owner_b[g]}
    assert orphaned <= moved
    assert len(moved - orphaned) <= fleet * 0.15, sorted(moved - orphaned)
    lo, hi = fleet // len(survivors), -(-fleet // len(survivors))
    for v in b.values():
        assert lo <= len(v) <= hi
    assert b == ref.assign_fleet(fleet, survivors)


def test_local_slice_matches_assign_fleet():
    fleet, hosts = 24, 3
    full = assign_fleet(fleet, host_tokens(hosts))
    for i, tok in enumerate(host_tokens(hosts)):
        assert local_slice(fleet, hosts, i) == full[tok]
        assert local_slice(fleet, hosts, i) == ref.local_slice(fleet, hosts,
                                                                i)
    gids = [g for i in range(hosts) for g in local_slice(fleet, hosts, i)]
    assert sorted(gids) == list(range(fleet))


def test_owner_host_is_ring_preference():
    hosts = host_tokens(3)
    for g in range(16):
        h = owner_host(g, hosts)
        assert h in hosts
        assert owner_host(g, hosts) == h == ref.owner_host(g, hosts)


def test_invalid_host_sets_rejected():
    for fn in (assign_fleet, ref.assign_fleet):
        with pytest.raises(ValueError, match="at least one host"):
            fn(4, [])
        with pytest.raises(ValueError, match="duplicate"):
            fn(4, ["host-0", "host-0"])
