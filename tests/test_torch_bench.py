"""The port's bench module (``distributed_deep_q_tpu_torch/bench.py``)
against the root ``bench.py``, on the CPU at a small size (rings of 8,192
and 16,384 rows, batch 32, chains of 2 and 4, 2 reps).

- The module prints exactly one JSON line, led by the reference's headline
  keys; its keys beside ``NOT_PORTED`` are exactly the reference's, read
  from the root ``bench.py``'s text (every ``out["…"]`` literal, the
  f-string keys over their loop's values, the keys of the dicts merged
  into ``out``, the headline's), and ``PORT_ONLY`` holds the rest.
- ``analytic_flops_per_step`` is the reference's at batch 32 and 512.
- ``time_variant`` advances the step counter by exactly iterations ×
  chain in every rep, and over the whole call by what it dispatched.
- ``build`` leaves the ring bytes (the fused ring's scratch row aside,
  where padding lanes race by contract), the priorities and the rest of
  the replay's state bitwise equal to the reference's ``build`` at the
  same arguments, both at ``mesh.dp=1`` (at ``mesh.dp=0`` the reference
  would take one shard per virtual CPU device, the port one).
- Without ``--device cpu`` and without a card the module raises and
  prints nothing.
- ``fused_train_flops`` is within 10% of the analytic count.
- ``--quick`` keeps every width of the full run and cuts depth only.
- The bench is one of the analysis gate's tool modules.
- ``chip_smoke.py`` phase 18's check passes a line as the card gives it
  and fails each planted fault.
"""

from __future__ import annotations

import ast
import contextlib
import dataclasses
import importlib.util
import io
import json
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from distributed_deep_q_tpu import config as ref_config
from distributed_deep_q_tpu.replay import persistence as ref_persist

from distributed_deep_q_tpu_torch import bench
from distributed_deep_q_tpu_torch import config as port_config
from distributed_deep_q_tpu_torch.profiling import (
    PORT_KERNELS, fused_train_flops)
from distributed_deep_q_tpu_torch.replay import persistence

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

TINY = bench.Sizes(
    batch=32, flag_batch=32, chain=2, b32_chain=4, idle_capacity=8_192,
    flag_capacity=16_384, idle_prefill=2_048, flag_prefill=4_096,
    probe_steps=2, warmup=1, reps=2, rep_target_s=0.01, iters_min=1,
    settle_s=0.0,
    r2d2=bench.R2d2Sizes(hw=(36, 36), stack=4, seq_len=16, burn_in=4,
                         batch=4, lstm=16, compute_dtype="float32",
                         n_seqs=16, iters_host=1, iters_dev=2, reps=2,
                         chain=2),
    # the CPU run's target, client and env counts; short windows; the
    # multi-process curve at 1 and 2 processes, 2 reps of the fewest
    # dispatches a worker runs (3), no settle beyond its 2 dispatches
    curves=dataclasses.replace(bench.CPU.curves, ingest_warmup=1,
                               ingest_settle_s=0.2, curve_s=0.3,
                               health_iters=20, health_reps=3,
                               multihost_hosts=(1, 2), multihost_reps=2,
                               multihost_rep_s=0.01,
                               multihost_settle_reps=0))

# the reference's keys this slice moved out of NOT_PORTED
MOVED = {"flagship_under_ingest_steps_per_s", "under_ingest_spread",
         "ingest_transitions_per_s", "ingest_curve", "concurrent_writers",
         "inference_curve", "inference_compiled_buckets",
         "inference_max_batch", "inference_cutoff_us", "inference_slo_ms",
         "actor_curve", "health_sample_us", "health_verdict_us",
         "health_disabled_us", "health_spread", "multihost_curve",
         "multihost_linearity_2x", "multihost_linearity_4x",
         "multihost_linearity_2x_spread", "multihost_linearity_4x_spread"}


@pytest.fixture(autouse=True)
def _two_threads():
    """Two torch threads a test: the suite runs several workers at once."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(prev)


def _load_reference_bench():
    spec = importlib.util.spec_from_file_location("_ref_bench",
                                                  REPO / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _dp1(cfg_mod):
    """``cfg_mod`` whose ``Config()`` has ``mesh.dp = 1``."""
    def config():
        cfg = cfg_mod.Config()
        cfg.mesh.dp = 1
        return cfg

    return types.SimpleNamespace(
        Config=config, NetConfig=cfg_mod.NetConfig,
        TrainConfig=cfg_mod.TrainConfig, ReplayConfig=cfg_mod.ReplayConfig)


def _reference_keys() -> set[str]:
    """Every key of the root ``bench.py``'s one line, read from its text."""
    tree = ast.parse((REPO / "bench.py").read_text())
    funcs = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    keys: set[str] = set()

    def out_key(node):
        if (isinstance(node, ast.Subscript) and isinstance(node.value,
                                                           ast.Name)
                and node.value.id == "out"):
            return node.slice
        return None

    for node in ast.walk(tree):
        key = out_key(node)
        if isinstance(key, ast.Constant) and isinstance(key.value, str):
            keys.add(key.value)
    # f-string keys, over the values of the loop that binds their name
    for loop in ast.walk(tree):
        if not (isinstance(loop, ast.For) and isinstance(loop.target,
                                                         ast.Name)
                and isinstance(loop.iter, ast.Tuple)):
            continue
        values = [e.value for e in loop.iter.elts]
        for node in ast.walk(loop):
            key = out_key(node)
            if not isinstance(key, ast.JoinedStr):
                continue
            for v in values:
                keys.add("".join(
                    str(v) if isinstance(part, ast.FormattedValue)
                    and isinstance(part.value, ast.Name)
                    and part.value.id == loop.target.id
                    else part.value for part in key.values))
    # dicts merged into out: out.update(f(...)) -> the dicts f returns
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "update"
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id == "out"
                and isinstance(node.args[0], ast.Call)
                and isinstance(node.args[0].func, ast.Name)):
            fn = funcs[node.args[0].func.id]
            for ret in ast.walk(fn):
                if isinstance(ret, ast.Return) and isinstance(ret.value,
                                                              ast.Dict):
                    keys |= {k.value for k in ret.value.keys}
    # the headline: line = {...} in main
    for node in ast.walk(funcs["main"]):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(isinstance(t, ast.Name) and t.id == "line"
                        for t in node.targets)):
            keys |= {k.value for k in node.value.keys}
    return keys


def test_reference_key_reader_sees_every_kind_of_key():
    """The reader finds a key of each kind the reference writes."""
    keys = _reference_keys()
    assert {"fence_rtt_ms", "learn_off_steps_per_s", "learn_on_spread",
            "health_sample_us", "metric", "vs_baseline",
            "r2d2_chained_chain_k", "tunnel_bound_keys"} <= keys
    assert not any("{" in k for k in keys), keys


@pytest.fixture(scope="module")
def printed():
    """What one small run on the CPU prints to stdout (on two torch
    threads: this fixture runs before the per-test one)."""
    buf = io.StringIO()
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        with contextlib.redirect_stdout(buf):
            assert bench.main(["--device", "cpu"], sizes=TINY) == 0
    finally:
        torch.set_num_threads(prev)
    return buf.getvalue()


def test_one_line_whose_keys_with_not_ported_are_the_references(printed):
    lines = printed.splitlines()
    assert len(lines) == 1, lines
    line = json.loads(lines[0])
    assert list(line)[:4] == ["metric", "value", "unit", "vs_baseline"]
    assert line["metric"] == "learner_grad_steps_per_sec"
    assert line["unit"] == "steps/s"

    ref = _reference_keys()
    kept = set(line) - set(bench.PORT_ONLY)
    assert list(line) == list(bench.KEPT) + list(bench.PORT_ONLY)
    assert not set(bench.PORT_ONLY) & ref
    assert set(bench.NOT_PORTED) <= ref, set(bench.NOT_PORTED) - ref
    assert not kept & set(bench.NOT_PORTED), kept & set(bench.NOT_PORTED)
    assert kept | set(bench.NOT_PORTED) == ref, \
        ref ^ (kept | set(bench.NOT_PORTED))
    for key in ("value", "idle_uniform_steps_per_s", "idle_fused_steps_per_s",
                "batch32_steps_per_s", "batch32_single_dispatch_steps_per_s",
                "pallas_on_steps_per_s", "r2d2_host_steps_per_s",
                "r2d2_device_steps_per_s", "r2d2_chained_steps_per_s",
                "learn_off_steps_per_s", "learn_on_steps_per_s"):
        assert np.isfinite(line[key]) and line[key] > 0, (key, line[key])
    assert line["flops_source"] == "torch_flop_counter"
    assert line["device_kind"] == "cpu"
    assert line["mfu"] is None and line["peak_flops_bf16"] is None
    # the MFU's numerator: the counted FLOPs over the idle fused row's
    # whole timed window, not the two-chain split
    assert line["tflops_per_s"] == round(
        line["flops_per_step"] * line["idle_fused_steps_per_s"] / 1e12, 4)
    assert line["ring_capacity_frames"] == TINY.flag_capacity
    assert set(line["launches"]) == {
        "idle_uniform", "idle_fused", "batch32", "batch32_single_dispatch",
        "pallas_on", "r2d2_host", "r2d2_device", "r2d2_chained",
        "inference_curve", "actor_curve", "flagship", "ingest_curve",
        "multihost_1_0", "multihost_2_0", "multihost_2_1",
        "learn_off", "learn_on"}


def test_the_moved_keys_are_printed_and_no_longer_not_ported(printed):
    """The curves' (ingest, inference, actor, multi-process) and the
    health overhead's keys are in the line under the reference's names,
    and only there; what is left in ``NOT_PORTED`` has no counterpart
    (no ROADMAP item ports it)."""
    line = json.loads(printed)
    assert MOVED <= _reference_keys()
    assert MOVED <= set(line), MOVED - set(line)
    assert MOVED <= set(bench.KEPT)
    assert not MOVED & set(bench.NOT_PORTED)
    assert all(v.startswith("no counterpart")
               for v in bench.NOT_PORTED.values()), bench.NOT_PORTED
    assert not any(k.startswith("multihost") for k in bench.NOT_PORTED)


def test_ingest_curve_at_the_cpu_sizes(printed):
    """The CPU's one target: the learner stepped, the writers' rows
    arrived at a rate above 0, every one of them landed, and no more rows
    were staged than the writers' bound lets through."""
    line = json.loads(printed)
    curve = line["ingest_curve"]
    assert set(curve) == {str(t) for t in TINY.curves.ingest_targets}
    pt = curve[str(bench.INGEST_TARGET)]
    assert set(pt) == {"steps_per_s", "achieved_t_per_s", "spread",
                       "max_in_flight_rows"}
    assert pt["steps_per_s"] > 0 and pt["achieved_t_per_s"] > 0
    assert 0 <= pt["max_in_flight_rows"] <= bench.STAGED_ROWS_CAP + 4 * 64
    assert line["flagship_under_ingest_steps_per_s"] == pt["steps_per_s"]
    assert line["ingest_transitions_per_s"] == pt["achieved_t_per_s"]
    assert line["under_ingest_spread"] == pt["spread"]
    assert line["concurrent_writers"] == bench.WRITERS == 4
    assert line["ingest_rows_lost"] == 0


def test_inference_and_actor_curves_at_the_cpu_sizes(printed):
    line = json.loads(printed)
    inf = line["inference_curve"]
    assert set(inf) == {"2", "8"}
    for pt in inf.values():
        assert set(pt) == {"actions_per_s", "p99_ms", "local_actions_per_s",
                           "forward_actions_per_s", "speedup", "sheds",
                           "spread"}
        assert pt["actions_per_s"] > 0 and pt["p99_ms"] > 0
        assert pt["local_actions_per_s"] > 0
        assert pt["forward_actions_per_s"] > 0
    icfg = port_config.InferenceConfig()
    assert set(line["inference_compiled_buckets"]) <= set(icfg.buckets)
    assert (line["inference_max_batch"], line["inference_cutoff_us"],
            line["inference_slo_ms"]) == (icfg.max_batch, icfg.cutoff_us,
                                          icfg.slo_ms)
    act = line["actor_curve"]
    assert set(act) == {"2", "8", "32"}
    for n, pt in act.items():
        assert set(pt) == {"n_envs", "actions_per_s", "ingest_t_per_s",
                           "tick_p99_ms", "sheds", "spread"}
        assert pt["n_envs"] == int(n)
        assert pt["actions_per_s"] > 0 and pt["ingest_t_per_s"] > 0
    assert line["actor_rows_lost"] == 0


def _reference_dict_keys(path: Path, func: str, name: str) -> set[str]:
    """The keys of the dict literal assigned to ``name`` in ``func`` of
    the file at ``path``."""
    tree = ast.parse(path.read_text())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == func)
    for node in ast.walk(fn):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(isinstance(t, ast.Name) and t.id == name
                        for t in node.targets)):
            return {k.value for k in node.value.keys}
    raise AssertionError(f"no {name} = {{...}} in {func}")


def test_multihost_curve_at_one_and_two_processes(printed):
    """The multi-process curve at 1 and 2 processes on the CPU: each
    point's keys are the root ``bench.py``'s (``_multihost_curve``), its
    rates and ingest above 0, no RPC crossed to another process's server,
    each worker's fields are the reference worker's plus ``launches``
    (the wrappers' counters: 0 on the CPU), and each worker served the
    gids the reference's ``local_slice`` assigns it. The 4-process ratio
    is null, its point not run."""
    from distributed_deep_q_tpu.actors.assignment import (
        local_slice as ref_local_slice)

    line = json.loads(printed)
    curve = line["multihost_curve"]
    assert set(curve) == {"1", "2"}
    want = _reference_dict_keys(REPO / "bench.py", "_multihost_curve",
                                "point")
    worker_keys = _reference_dict_keys(
        REPO / "scripts" / "_bench_multihost_worker.py", "main", "out")
    for n, pt in curve.items():
        assert set(pt) == want, set(pt) ^ want
        assert pt["n_hosts"] == int(n)
        for k in ("steps_per_s", "wall_steps_per_s", "ingest_t_per_s"):
            assert np.isfinite(pt[k]) and pt[k] > 0, (n, k, pt)
        # the aggregate: process 0's wall rate × n (each rounded alone)
        assert abs(pt["steps_per_s"] - pt["wall_steps_per_s"] * int(n)) \
            <= 0.005 * (int(n) + 1)
        assert pt["cross_host_replay_rpcs"] == 0
        assert pt["dispatch_k"] >= 3
        hosts = bench.LAST_MULTIHOST[n]
        assert [h["pid"] for h in hosts] == list(range(int(n)))
        for h in hosts:
            assert set(h) == worker_keys | {"launches"}, set(h) ^ worker_keys
            assert h["assigned_gids"] == ref_local_slice(
                2 * int(n), int(n), h["pid"])
            assert h["actor_ids_seen"] == [0, 1] and not h["writer_errors"]
            assert len(h["rates"]) == TINY.curves.multihost_reps
            assert h["launches"] == line["launches"][
                f"multihost_{n}_{h['pid']}"]
            assert set(h["launches"].values()) == {0}
    assert line["multihost_linearity_2x"] == round(
        curve["2"]["steps_per_s"] / curve["1"]["steps_per_s"], 2)
    assert line["multihost_linearity_2x_spread"] == round(
        curve["1"]["spread"] + curve["2"]["spread"], 4)
    assert line["multihost_linearity_4x"] is None
    assert line["multihost_linearity_4x_spread"] is None


def test_bench_diff_of_the_cpu_line_against_itself(printed, tmp_path):
    """``bench_diff`` on the CPU run's line against itself: every shared
    metric within tolerance, no note, exit 0."""
    from distributed_deep_q_tpu_torch import bench_diff

    path = tmp_path / "line.json"
    path.write_text(printed)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bench_diff.main([str(path), str(path)])
    assert rc == 0, buf.getvalue()
    text = buf.getvalue()
    assert text.startswith("all ") and "0 regressed" in text, text
    assert "launches" not in text and "note:" not in text


def test_health_overhead_keys(printed):
    line = json.loads(printed)
    assert line["health_sample_us"] > 0 and line["health_verdict_us"] > 0
    assert line["health_disabled_us"] >= 0 and line["health_spread"] >= 0
    # the disabled path is one flag branch: cheaper than a live sample
    assert line["health_disabled_us"] < line["health_sample_us"]


@pytest.mark.parametrize("batch", [32, 512])
def test_analytic_flops_are_the_references(batch):
    ref = _load_reference_bench()
    assert bench.analytic_flops_per_step(batch) == \
        ref.analytic_flops_per_step(batch)


@pytest.mark.parametrize("fused, chain", [(True, 2), (True, 1), (False, 1)])
def test_time_variant_advances_the_step_by_iters_times_chain(fused, chain):
    """Each rep advances the counter by iterations × chain; the call by
    its warm-up, probe and reps. The host ring is prioritized, so its
    steps go through the delayed priority write-back."""
    solver, replay = bench.build(port_config, capacity=4_096, batch=16,
                                 prioritized=True, pallas=False,
                                 device_per=fused, prefill=1_500,
                                 device="cpu")
    sz = dataclasses.replace(TINY, reps=3, iters_min=2)
    before = bench._fence(solver)
    t = bench.time_variant(solver, replay, 16, sz, chain=chain)
    assert t.rep_steps == [t.iters * chain] * sz.reps
    assert t.iters >= sz.iters_min
    assert len(t.rates) == sz.reps and min(t.rates) > 0
    probe = max(sz.probe_steps // chain, 1)
    dispatched = sz.warmup + probe + sz.reps * t.iters
    assert bench._fence(solver) - before == dispatched * chain


BUILDS = {
    "uniform_ring": dict(prioritized=False, device_per=False, num_streams=1),
    "ring_with_trees": dict(prioritized=True, device_per=False,
                            num_streams=1),
    "fused": dict(prioritized=True, device_per=True, num_streams=1),
    "fused_four_streams": dict(prioritized=True, device_per=True,
                               num_streams=4),
}


@pytest.mark.parametrize("name", sorted(BUILDS))
def test_build_state_is_the_references(name):
    """Ring bytes, priorities and every other key of the replay's state,
    bitwise, both packages at ``mesh.dp=1``."""
    kw = dict(capacity=4_096, batch=32, pallas=False, seed=3,
              prefill=2_560, **BUILDS[name])
    ref = _load_reference_bench()
    _, ref_replay = ref.build(_dp1(ref_config), **kw)
    _, port_replay = bench.build(_dp1(port_config), device="cpu", **kw)
    want = ref_persist.replay_state(ref_replay)
    got = persistence.replay_state(port_replay)
    assert set(got) == set(want), set(got) ^ set(want)
    planes = [k for k in want if k.startswith(("dev_", "tree"))]
    assert "dev_frames" in planes
    assert any(k in planes for k in ("dev_prio", "tree0")) == \
        BUILDS[name]["prioritized"]
    for key in sorted(want):
        w, g = np.asarray(want[key]), np.asarray(got[key])
        assert w.dtype == g.dtype and w.shape == g.shape, key
        if key == "dev_frames" and BUILDS[name]["device_per"]:
            # the fused ring's scratch row (the shard's last) takes the
            # padding lanes' racing writes, by contract
            w, g = w[:-port_replay.rowp], g[:-port_replay.rowp]
        assert np.array_equal(w.view(np.uint8) if w.ndim else w,
                              g.view(np.uint8) if g.ndim else g), key


def test_actor_curve_server_steps_are_the_rings_rows(monkeypatch):
    """Every row the actor curve's feed server counted is in its ring:
    the server's ``env_steps`` equals the ring's size (no slot wraps at
    these counts) at each env count."""
    from distributed_deep_q_tpu_torch.rpc import replay_server

    servers = []

    class Recorded(replay_server.ReplayFeedServer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            servers.append(self)

    monkeypatch.setattr(replay_server, "ReplayFeedServer", Recorded)
    cs = dataclasses.replace(TINY.curves, envs=(2, 8))
    out: dict = {}
    assert bench.bench_actor_curve(port_config, "cpu", cs, out) == 0
    assert set(out["actor_curve"]) == {"2", "8"}
    assert len(servers) == 2
    for srv, n in zip(servers, cs.envs):
        steps = srv.counters()["env_steps"]
        assert steps > 0
        assert steps == len(srv.replay), (n, steps, len(srv.replay))
        assert srv.replay.num_streams == n
        assert srv.replay.pending_rows() == 0


class _FirstChunks:
    """A ring that takes each stream's first ``k`` chunks and drops the
    rest, and sets ``stop`` once every stream has its ``k``: writers then
    leave at their next loop, and the ring holds exactly k chunks a
    stream however the writers interleaved."""

    def __init__(self, ring, k: int, streams: int, stop):
        self.ring, self.k, self.stop = ring, k, stop
        self.n = [0] * streams

    def add_batch(self, payload, stream: int = 0):
        if self.n[stream] < self.k:
            self.ring.add_batch(payload, stream=stream)
            self.n[stream] += 1
            if min(self.n) == self.k:
                self.stop.set()

    def __getattr__(self, name):
        return getattr(self.ring, name)


def _run_writers(run_writers, ring, writers: int, k: int) -> list:
    import threading

    lock, stop = threading.Lock(), threading.Event()
    counter = [0] * writers
    proxy = _FirstChunks(ring, k, writers, stop)
    threads = run_writers(proxy, lock, stop, counter, writers,
                          total_rate=1e6)
    for th in threads:
        th.join(timeout=60.0)
    assert not any(th.is_alive() for th in threads)
    assert proxy.n == [k] * writers
    ring.flush()
    return counter


@pytest.mark.parametrize("fused", [False, True], ids=["uniform", "fused"])
@pytest.mark.parametrize("writers", [1, 4])
def test_run_writers_fill_the_ring_as_the_references(fused, writers):
    """Writers stopped after exactly 11 chunks a stream (an episode
    boundary at the 10th) leave the port's ring bitwise the reference's
    after its ``run_writers``: ring bytes (the fused ring's scratch row
    aside), metadata, boundaries, priorities and every other key of the
    replay's state, per stream with 4 writers."""
    k = 11
    kw = dict(capacity=4_096, batch=32, pallas=False, seed=5, prefill=0,
              prioritized=fused, device_per=fused, num_streams=writers)
    ref = _load_reference_bench()
    _, ref_ring = ref.build(_dp1(ref_config), **kw)
    _, port_ring = bench.build(_dp1(port_config), device="cpu", **kw)
    _run_writers(ref.run_writers, ref_ring, writers, k)
    _run_writers(bench.run_writers, port_ring, writers, k)
    for i in range(writers):
        assert port_ring.stream_rows(i) == k * 64
    want = ref_persist.replay_state(ref_ring)
    got = persistence.replay_state(port_ring)
    assert set(got) == set(want), set(got) ^ set(want)
    for key in sorted(want):
        w, g = np.asarray(want[key]), np.asarray(got[key])
        assert w.dtype == g.dtype and w.shape == g.shape, key
        if key == "dev_frames" and fused:
            w, g = w[:-port_ring.rowp], g[:-port_ring.rowp]
        assert np.array_equal(w.view(np.uint8) if w.ndim else w,
                              g.view(np.uint8) if g.ndim else g), key


def test_run_writers_stage_no_more_than_their_bound(monkeypatch):
    """With more rows staged than ``STAGED_ROWS_CAP``, a writer waits
    before its next insert and the high-water gauge reads what it saw."""
    import threading

    monkeypatch.setattr(bench, "STAGED_ROWS_CAP", 0)
    _, ring = bench.build(_dp1(port_config), device="cpu", capacity=4_096,
                          batch=32, pallas=False, prioritized=False,
                          prefill=0)
    ring.write_chunk = 1 << 20          # nothing flushes on its own
    lock, stop = threading.Lock(), threading.Event()
    counter, stats = [0], {}
    threads = bench.run_writers(ring, lock, stop, counter, 1,
                                total_rate=1e6, stats=stats)
    deadline = time.monotonic() + 30.0
    while counter[0] < 64 and time.monotonic() < deadline:
        time.sleep(0.01)
    time.sleep(0.2)
    # one chunk in, then held: 64 rows staged over a cap of 0
    assert counter[0] == 64 and ring.pending_rows() == 64
    stop.set()
    threads[0].join(timeout=10.0)
    assert stats["max_pending_rows"] == 64


def test_fair_lock_serves_in_arrival_order():
    """A writer queued on the curve's lock gets it at the learner's next
    release, however fast the learner asks again."""
    import threading

    lock = bench.FairLock()
    order: list[str] = []
    lock.acquire()
    asked = threading.Event()

    def writer():
        asked.set()
        with lock:
            order.append("writer")

    th = threading.Thread(target=writer)
    th.start()
    asked.wait()
    time.sleep(0.05)              # the writer is queued
    lock.release()
    for _ in range(3):            # the learner's loop: release, ask again
        with lock:
            order.append("learner")
    th.join(timeout=10.0)
    assert order[0] == "writer", order
    assert order.count("learner") == 3


def test_without_a_card_the_bench_raises_and_prints_nothing(capsys):
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--quick"])
    assert capsys.readouterr().out == ""


def test_flop_counter_within_ten_percent_of_the_analytic_count():
    solver, replay = bench.build(port_config, capacity=4_096, batch=32,
                                 prioritized=True, pallas=False,
                                 device_per=True, prefill=1_500,
                                 device="cpu")
    flops = fused_train_flops(solver, replay)
    analytic = bench.analytic_flops_per_step(32)
    assert abs(flops - analytic) / analytic <= 0.10, (flops, analytic)


def test_bench_is_a_tool_module_of_the_analysis_gate():
    """The gate scans the bench as the reference's scans its root
    ``bench.py``: with the passes that scan tools, not the others."""
    from distributed_deep_q_tpu_torch.analysis.core import (
        TOOL_MODULES, package_files)

    path = str(REPO / "distributed_deep_q_tpu_torch" / "bench.py")
    assert "bench.py" in TOOL_MODULES
    assert path in package_files(str(REPO))
    assert path not in package_files(str(REPO), tools=False)


def test_quick_cuts_depth_only():
    """``--quick`` keeps the full run's widths (frames, batch, chain,
    ring capacities, the r2d2 shapes and ring) and cuts reps, rep length,
    warm-up, the calibration probe and prefill."""
    widths = ("batch", "flag_batch", "chain", "b32_chain", "idle_capacity",
              "flag_capacity")
    for f in widths:
        assert getattr(bench.QUICK, f) == getattr(bench.FULL, f), f
    for f in ("hw", "stack", "seq_len", "burn_in", "batch", "lstm",
              "compute_dtype", "chain", "n_seqs"):
        assert getattr(bench.QUICK.r2d2, f) == getattr(bench.FULL.r2d2, f), f
    for f in ("reps", "rep_target_s", "warmup", "probe_steps",
              "idle_prefill", "flag_prefill"):
        assert getattr(bench.QUICK, f) < getattr(bench.FULL, f), f
    for f in ("iters_host", "iters_dev"):
        assert getattr(bench.QUICK.r2d2, f) < getattr(bench.FULL.r2d2, f), f
    for f in ("ingest_targets", "clients", "envs", "multihost_hosts"):
        assert getattr(bench.QUICK.curves, f) == getattr(bench.FULL.curves,
                                                         f), f
    for f in ("ingest_warmup", "ingest_settle_s", "curve_s", "health_iters",
              "health_reps", "multihost_reps", "multihost_rep_s",
              "multihost_settle_reps"):
        assert getattr(bench.QUICK.curves, f) < getattr(bench.FULL.curves,
                                                        f), f


def _card_line() -> dict:
    """A line as the card gives it: every key, rates above 0, an MFU, the
    FLOPs counted near the analytic count, every kernel launched in every
    row, and every curve point of the full run."""
    cs = bench.FULL.curves
    line = {k: 1.0 for k in bench.KEPT}
    line.update(flops_per_step=44.5e9, flops_per_step_analytic=47.9e9,
                mfu=0.0055, quick=True, nvidia_smi="card, 700.00 W",
                ingest_rows_lost=0, actor_rows_lost=0,
                concurrent_writers=bench.WRITERS,
                inference_compiled_buckets=[8, 32],
                health_disabled_us=0.12)
    line["ingest_curve"] = {
        str(t): {"steps_per_s": 120.0, "achieved_t_per_s": 0.98 * t,
                 "spread": 0.1, "max_in_flight_rows": 1_024}
        for t in cs.ingest_targets}
    line["inference_curve"] = {
        str(n): {"actions_per_s": 900.0, "p99_ms": 4.2,
                 "local_actions_per_s": 2_000.0,
                 "forward_actions_per_s": 30_000.0, "speedup": 15.0,
                 "sheds": 0, "spread": 0.05} for n in cs.clients}
    line["actor_curve"] = {
        str(n): {"n_envs": n, "actions_per_s": 800.0,
                 "ingest_t_per_s": 790.0, "tick_p99_ms": 30.0, "sheds": 0,
                 "spread": 0.1} for n in cs.envs}
    line["multihost_curve"] = {
        str(n): {"n_hosts": n, "steps_per_s": 40.0 * n,
                 "wall_steps_per_s": 40.0, "spread": 0.05,
                 "ingest_t_per_s": 2_000.0, "cross_host_replay_rpcs": 0,
                 "dispatch_k": 12} for n in cs.multihost_hosts}
    line.update(multihost_linearity_2x=1.9, multihost_linearity_4x=3.5,
                multihost_linearity_2x_spread=0.1,
                multihost_linearity_4x_spread=0.1)
    workers = [f"multihost_{n}_{pid}" for n in cs.multihost_hosts
               for pid in range(n)]
    line["launches"] = {row: {k: 3 for k in PORT_KERNELS}
                        for row in ("flagship", "pallas_on",
                                    "ingest_curve", "actor_curve",
                                    *workers)}
    line["launches"]["actor_curve"].update(gather_windows=0,
                                           fused_loss_fwd=0,
                                           fused_loss_bwd=0)
    return line


def _plant(line: dict, fault: str) -> None:
    cs = bench.FULL.curves
    if fault == "missing_key":
        del line["learn_spread"]
    elif fault == "zero_rate":
        line["r2d2_chained_steps_per_s"] = 0.0
    elif fault == "nan_rate":
        line["value"] = float("nan")
    elif fault == "mfu_over":
        line["mfu"] = 1.2
    elif fault == "mfu_none":
        line["mfu"] = None
    elif fault == "flops_off":
        line["flops_per_step"] = 1.2 * line["flops_per_step_analytic"]
    elif fault == "no_flagship_gather":
        line["launches"]["flagship"]["gather_windows"] = 0
    elif fault == "no_pallas_bwd":
        line["launches"]["pallas_on"]["fused_loss_bwd"] = 0
    elif fault == "missing_curve_key":
        del line["actor_curve"]
    elif fault == "missing_target":
        del line["ingest_curve"][str(cs.ingest_targets[-1])]
    elif fault == "zero_achieved_ingest":
        line["ingest_curve"]["256"]["achieved_t_per_s"] = 0.0
    elif fault == "zero_under_ingest":
        line["flagship_under_ingest_steps_per_s"] = 0.0
    elif fault == "zero_inference_rate":
        line["inference_curve"]["16"]["forward_actions_per_s"] = 0.0
    elif fault == "no_p99":
        line["inference_curve"]["64"]["p99_ms"] = None
    elif fault == "zero_actor_ingest":
        line["actor_curve"]["128"]["ingest_t_per_s"] = 0.0
    elif fault == "lost_ingest_rows":
        line["ingest_rows_lost"] = 64
    elif fault == "lost_actor_rows":
        line["actor_rows_lost"] = 1
    elif fault == "queue_over_cap":
        line["ingest_curve"]["4096"]["max_in_flight_rows"] = (
            bench.STAGED_ROWS_CAP + bench.WRITERS * 64 + 1)
    elif fault == "too_many_buckets":
        line["inference_compiled_buckets"] = [8, 16, 32, 128, 256]
    elif fault == "zero_health_sample":
        line["health_sample_us"] = 0.0
    elif fault == "no_ingest_gather":
        line["launches"]["ingest_curve"]["gather_windows"] = 0
    elif fault == "no_ingest_scatter":
        line["launches"]["ingest_curve"]["scatter_rows"] = 0
    elif fault == "no_actor_scatter":
        line["launches"]["actor_curve"]["scatter_rows"] = 0
    elif fault == "missing_host_point":
        del line["multihost_curve"]["4"]
    elif fault == "cross_host_rpc":
        line["multihost_curve"]["2"]["cross_host_replay_rpcs"] = 1
    elif fault == "zero_multihost_ingest":
        line["multihost_curve"]["4"]["ingest_t_per_s"] = 0.0
    elif fault == "zero_multihost_rate":
        line["multihost_curve"]["1"]["wall_steps_per_s"] = 0.0
    elif fault == "nan_linearity":
        line["multihost_linearity_4x"] = float("nan")
    elif fault == "null_linearity_spread":
        line["multihost_linearity_2x_spread"] = None
    elif fault == "no_worker_gather":
        line["launches"]["multihost_4_3"]["gather_windows"] = 0
    elif fault == "no_worker_scatter":
        line["launches"]["multihost_2_1"]["scatter_rows"] = 0
    elif fault == "missing_worker_row":
        del line["launches"]["multihost_4_2"]
    else:
        raise ValueError(fault)


@pytest.mark.parametrize("fault", [
    None, "missing_key", "zero_rate", "nan_rate", "mfu_over", "mfu_none",
    "flops_off", "no_flagship_gather", "no_pallas_bwd",
    "missing_curve_key", "missing_target", "zero_achieved_ingest",
    "zero_under_ingest", "zero_inference_rate", "no_p99",
    "zero_actor_ingest", "lost_ingest_rows", "lost_actor_rows",
    "queue_over_cap", "too_many_buckets", "zero_health_sample",
    "no_ingest_gather", "no_ingest_scatter", "no_actor_scatter",
    "missing_host_point", "cross_host_rpc", "zero_multihost_ingest",
    "zero_multihost_rate", "nan_linearity", "null_linearity_spread",
    "no_worker_gather", "no_worker_scatter", "missing_worker_row"])
def test_phase18_check(fault):
    """``chip_smoke.py`` phase 18's check passes a line as the card gives
    it and fails each planted fault."""
    line = _card_line()
    if fault is not None:
        _plant(line, fault)
    keys = bench.KEPT + tuple(bench.PORT_ONLY)
    if fault is None:
        chip_smoke.check_bench_line(line, keys)
    else:
        with pytest.raises(AssertionError):
            chip_smoke.check_bench_line(line, keys)


def test_phase18_worker_checks_every_gather_and_scatter_shape(tmp_path,
                                                               capsys):
    """``chip_smoke.py``'s phase 18 child: the bench's one line on stdout,
    and the first launches of each B1/B2 shape in each row the bench's
    rows reach (the frame rings', the sequence ring's, the ingest curve's
    dispatches and drain flushes, the actor curve's 10×10 ring) held
    against the plain versions on the same inputs. On the CPU the
    wrappers take the plain versions themselves, so this holds the
    plumbing: every call site is wrapped, the keys and the scratch-row
    rule hold, and the checks are written."""
    out = tmp_path / "checks.json"
    assert chip_smoke.p18_bench_worker([str(out), "--device", "cpu"],
                                       sizes=TINY) == 0
    assert len(capsys.readouterr().out.splitlines()) == 1
    checks = json.loads(out.read_text())
    assert checks["all_bitwise"], checks
    names = {k.split()[0] for k in checks["shapes"]}
    assert names == {"gather_windows", "scatter_rows"}, checks
    # "<kernel> (<shape>) @<row>": each row checks its own launches (the
    # FLOP count's dispatch runs outside every row)
    parsed = {}
    for k in checks["shapes"]:
        name, rest = k.split(" ", 1)
        shape, _, row = rest.partition(" @")
        parsed[k] = (name, tuple(int(x) for x in shape.strip("()")
                                 .split(",")), row)
    # the sequence ring's windows (batch × (sequence + stack) rows) and
    # its slot-wide rows are wrapped too
    seq_w = TINY.r2d2.seq_len + TINY.r2d2.stack
    seq = [v for n, v, _ in parsed.values() if n == "gather_windows"
           and v[:2] == (TINY.r2d2.batch, seq_w)]
    assert seq, checks
    assert any(n == "scatter_rows" and v[1] == seq_w * seq[0][2]
               for n, v, _ in parsed.values()), checks
    # the ingest curve's dispatches and drain flushes on the flagship
    # ring, and the actor curve's flushes of 10×10 rows
    by_row: dict = {}
    for n, v, row in parsed.values():
        by_row.setdefault(row, set()).add((n, v))
    flag_rowb = {v[1] for n, v in by_row["flagship"] if n == "scatter_rows"}
    assert {n for n, _ in by_row["ingest_curve"]} == {"gather_windows",
                                                      "scatter_rows"}
    assert {v[1] for n, v in by_row["ingest_curve"]
            if n == "scatter_rows"} == flag_rowb
    from distributed_deep_q_tpu_torch.ops.ring_gather import (
        padded_row_bytes)
    assert by_row["actor_curve"] == {("scatter_rows",
                                      (2 * 64, padded_row_bytes(100)))}
    # each multi-process worker (a --phase18-mh-worker child) checks its
    # own dispatches' gathers and its drain's flushes of 36×36 rows
    workers = {f"multihost_{n}_{pid}" for n in TINY.curves.multihost_hosts
               for pid in range(n)}
    assert workers <= set(by_row), set(by_row)
    for w in workers:
        assert {n for n, _ in by_row[w]} == {"gather_windows",
                                             "scatter_rows"}, by_row[w]
        assert {v[1] for n, v in by_row[w] if n == "scatter_rows"} == {
            padded_row_bytes(36 * 36)}, by_row[w]
    for rec in checks["shapes"].values():
        assert 0 < rec["checked"] <= chip_smoke.P18_CHECKED, rec
