"""The fused device-PER dispatch replayed as one CUDA graph.

``Solver.train_steps_device_per`` captures the dispatch at its configured
chain, on a card and in a process alone, and replays it
(``graph_engages``, ``parallel/learner.py::DispatchGraph``); every other
dispatch runs the same code eagerly (``Solver.train_steps_eager``).

On the card (``gpu`` marker; skips here): from one seeded state, the
replayed dispatches against eager ones, bitwise — θ, θ⁻, the optimizer's
moments (and Adam's count), the step, the priorities, the running max
priority and every per-step metric — for RMSProp and Adam (the learning
plane too, which the graph captures), over three dispatches in a row; a
tail chunk between replays; and state loaded or rebound between
dispatches (in place it is read by the next replay; rebound, it is
captured anew).

On the CPU: the engagement rule and its counters, the launch tally of a
capture, and a dispatch and the state's IO writing every tensor in place.

This file imports neither jax nor the reference package, so the card's
tests also run with the port's dependencies alone:

    python -m pytest -m gpu --noconftest tests/test_torch_dispatch_graph.py
"""

import numpy as np
import pytest
import torch

from distributed_deep_q_tpu_torch import config as port_config
from distributed_deep_q_tpu_torch.ops import cuda_build
from distributed_deep_q_tpu_torch.ops import ring_gather as rg
from distributed_deep_q_tpu_torch.parallel import multihost
from distributed_deep_q_tpu_torch.parallel.learner import (
    dispatch_key, state_tensors)
from distributed_deep_q_tpu_torch.replay.device_per import (
    DevicePERFrameReplay)
from distributed_deep_q_tpu_torch import solver as solver_mod
from distributed_deep_q_tpu_torch.solver import Solver

FRAME = (52, 52)


def _cfg(optimizer="rmsprop", chain=32, batch=32, backend="cpu",
         learn_metrics=False):
    cfg = port_config.Config()
    cfg.mesh.backend = backend
    cfg.mesh.dp = 1
    cfg.net = port_config.NetConfig(kind="nature_cnn", num_actions=6,
                                    frame_shape=FRAME, dueling=True,
                                    compute_dtype="bfloat16")
    cfg.replay = port_config.ReplayConfig(
        capacity=2048, batch_size=batch, n_step=3, prioritized=True,
        priority_alpha=0.6, device_per=True, write_chunk=64,
        fused_chain=chain)
    cfg.train = port_config.TrainConfig(
        lr=1e-4, double_dqn=True, target_update_period=40,
        optimizer=optimizer, grad_clip_norm=10.0, seed=3,
        learn_metrics=learn_metrics)
    return cfg


def _build(cfg, device, rows=1200):
    solver = Solver(cfg, backend=cfg.mesh.backend)
    replay = DevicePERFrameReplay(cfg.replay, device, FRAME, stack=4,
                                  gamma=0.99, write_chunk=64)
    rng = np.random.default_rng(0)
    for i in range(rows):
        replay.add(rng.integers(0, 255, FRAME, dtype=np.uint8),
                   int(rng.integers(6)), float(rng.standard_normal()),
                   i % 37 == 36)
    return solver, replay


def _tensors(solver, replay) -> dict:
    """Every tensor a dispatch carries to the next, by name."""
    st = solver.state
    out = {f"theta.{k}": p for k, p in st.net.named_parameters()}
    out.update({f"target.{k}": p
                for k, p in st.target_net.named_parameters()})
    for key in ("mu", "nu"):
        out.update({f"{key}.{k}": t
                    for k, t in st.opt_state[key].items()})
    if "count" in st.opt_state:
        out["count"] = st.opt_state["count"]
    out["step"] = st.step
    out["prio"] = replay.dstate["prio"]
    out["maxp"] = replay.dstate["maxp"]
    return out


def _assert_same(a: dict, b: dict, what: str) -> None:
    assert a.keys() == b.keys(), what
    for k in a:
        assert torch.equal(a[k], b[k]), f"{what}: {k} differs"


# -- on the card --------------------------------------------------------------


@pytest.fixture
def card():
    """The card, with every algorithm deterministic (the priority scatter's
    duplicate rows pick a writer at random otherwise), restored after."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(),
            torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield torch.device("cuda", 0)
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
        torch.backends.cudnn.deterministic = prev[2]
        torch.backends.cudnn.benchmark = prev[3]


def _pair(dev, **kw):
    """Two solvers and replays built alike from one seed: the first takes
    the graph, the second runs every dispatch eagerly."""
    cfg = _cfg(backend="cuda", **kw)
    return _build(cfg, dev), _build(_cfg(backend="cuda", **kw), dev)


@pytest.mark.gpu
@pytest.mark.parametrize("optimizer, plane", [
    ("rmsprop", False), ("adam", False), ("adam", True)])
def test_replay_matches_eager_bitwise(card, optimizer, plane):
    (g, gr), (e, er) = _pair(card, optimizer=optimizer, learn_metrics=plane)
    launches = []
    for d in range(3):
        before = rg.gather_windows.launches
        mg = g.train_steps_device_per(gr, chain=32)
        launches.append(rg.gather_windows.launches - before)
        me = e.train_steps_eager(er, chain=32)
        assert ("learn_plane" in mg) == plane
        _assert_same(mg, me, f"{optimizer} dispatch {d} metrics")
        _assert_same(_tensors(g, gr), _tensors(e, er),
                     f"{optimizer} dispatch {d} state")
    assert g.dispatch_counts == {"graph_captures": 1, "graph_replays": 3,
                                 "eager_dispatches": 0}
    assert e.dispatch_counts["eager_dispatches"] == 3
    # B1 once a dispatch; the first also ran the capture's eager warm-up
    assert launches == [2, 1, 1]


@pytest.mark.gpu
def test_metrics_of_one_dispatch_outlive_the_next_replay(card):
    (g, gr), _ = _pair(card)
    first = g.train_steps_device_per(gr)
    kept = {k: v.clone() for k, v in first.items()}
    g.train_steps_device_per(gr)
    _assert_same(first, kept, "the first dispatch's metrics")


@pytest.mark.gpu
def test_tail_chunk_runs_eagerly_between_replays(card):
    (g, gr), (e, er) = _pair(card)
    for chain in (32, 4, 32):
        mg = g.train_steps_device_per(gr, chain=chain)
        me = e.train_steps_eager(er, chain=chain)
        _assert_same(mg, me, f"chain {chain} metrics")
        _assert_same(_tensors(g, gr), _tensors(e, er), f"chain {chain}")
    assert g.dispatch_counts == {"graph_captures": 1, "graph_replays": 2,
                                 "eager_dispatches": 1}


@pytest.mark.gpu
@pytest.mark.parametrize("optimizer", ["rmsprop", "adam"])
def test_state_loaded_or_rebound_between_dispatches(card, optimizer):
    """``update``, ``load_opt_state`` and ``load_flax_state`` write in
    place: the next replay reads what they wrote, with no new capture.
    A tensor rebound to new storage changes ``dispatch_key``: the next
    dispatch captures anew instead of replaying stale addresses."""
    (g, gr), (e, er) = _pair(card, optimizer=optimizer)
    (donor, dr), _ = _pair(card, optimizer=optimizer)
    donor.train_steps_eager(dr)
    donor.train_steps_eager(dr)
    weights = [w * 0.5 for w in donor.get_weights()]
    opt = {"name": optimizer,
           "mu": {k: t.float().cpu().numpy()
                  for k, t in donor.state.opt_state["mu"].items()},
           "nu": {k: t.float().cpu().numpy()
                  for k, t in donor.state.opt_state["nu"].items()}}
    if optimizer == "adam":
        opt["count"] = 11
    fs = donor.flax_state()
    loads = [
        lambda s: s.update(weights),
        lambda s: s.load_opt_state(opt),
        lambda s: s.load_flax_state(fs["params"], fs["target_params"],
                                    fs.get("count", 0), fs["mu"], fs["nu"],
                                    fs["step"]),
    ]
    for d, load in enumerate(loads):
        g.train_steps_device_per(gr)
        e.train_steps_eager(er)
        ptrs = [t.data_ptr() for t in state_tensors(g.state)]
        load(g)
        load(e)
        assert [t.data_ptr() for t in state_tensors(g.state)] == ptrs
        _assert_same(g.train_steps_device_per(gr), e.train_steps_eager(er),
                     f"after load {d}")
        _assert_same(_tensors(g, gr), _tensors(e, er), f"after load {d}")
    assert g.dispatch_counts["graph_captures"] == 1
    # rebound: the same values in new storage
    for s in (g, e):
        st = s.state
        st.step = st.step.clone()
        st.opt_state["mu"] = {k: t.clone()
                              for k, t in st.opt_state["mu"].items()}
    _assert_same(g.train_steps_device_per(gr), e.train_steps_eager(er),
                 "after the rebinding")
    _assert_same(_tensors(g, gr), _tensors(e, er), "after the rebinding")
    assert g.dispatch_counts["graph_captures"] == 2


# -- on the CPU ---------------------------------------------------------------


@pytest.mark.parametrize("device, chain, processes, engages", [
    ("cuda", 32, 1, True),
    ("cpu", 32, 1, False),      # no card
    ("cuda", 4, 1, False),      # a tail chunk
    ("cuda", 64, 1, False),     # any other length
    ("cuda", 32, 2, False),     # the gloo all-reduces are the host's
])
def test_graph_engages_on_a_card_alone_at_the_configured_chain(
        monkeypatch, device, chain, processes, engages):
    monkeypatch.setattr(multihost, "is_multiprocess",
                        lambda: processes > 1)
    assert solver_mod.graph_engages(torch.device(device), chain,
                                    32) is engages


@pytest.mark.parametrize("chains", [(4, 4, 2), (8,)])
def test_cpu_dispatches_stay_eager_and_are_counted(chains):
    solver, replay = _build(_cfg(chain=4, batch=16), "cpu", rows=300)
    for c in chains:
        solver.train_steps_device_per(replay, chain=c)
    assert solver.dispatch_counts == {"graph_captures": 0,
                                      "graph_replays": 0,
                                      "eager_dispatches": len(chains)}
    assert solver.dispatch_counters() == {
        "learner/graph_captures": 0.0, "learner/graph_replays": 0.0,
        "learner/eager_dispatches": float(len(chains))}


def test_multi_process_dispatch_takes_the_eager_body(monkeypatch):
    """With more than one process the rule keeps the eager body even on a
    card (the solver's device is faked as CUDA, and the eager body is
    recorded, not run: its all-reduces need a process group)."""
    solver, replay = _build(_cfg(chain=4, batch=16), "cpu", rows=300)
    monkeypatch.setattr(multihost, "is_multiprocess", lambda: True)
    monkeypatch.setattr(solver, "device", torch.device("cuda"))
    calls = []
    monkeypatch.setattr(solver, "train_steps_eager",
                        lambda rp, chain: calls.append(chain) or {})
    solver.train_steps_device_per(replay)
    assert calls == [4]
    assert solver._graph is None
    assert solver.dispatch_counts["graph_replays"] == 0


@pytest.mark.parametrize("optimizer", ["rmsprop", "adam"])
def test_dispatch_and_state_io_write_in_place(optimizer):
    """A dispatch and ``update`` / ``load_opt_state`` / ``load_flax_state``
    leave every tensor of the train state and of the replay's rows in its
    own storage: ``dispatch_key`` is unchanged, so a graph stays valid."""
    cfg = _cfg(optimizer=optimizer, chain=2, batch=16)
    solver, replay = _build(cfg, "cpu", rows=300)
    key = dispatch_key(solver.learner.cfg, solver.state, replay.dstate, 2,
                       solver_mod.fused_spec(solver.config, replay))
    ptrs = [t.data_ptr() for t in _tensors(solver, replay).values()]
    step0 = int(solver.state.step)
    solver.train_steps_device_per(replay)
    assert int(solver.state.step) == step0 + 2
    fs = solver.flax_state()
    solver.update([w + 1.0 for w in solver.get_weights()])
    opt = {"name": optimizer,
           "mu": {k: t.numpy() * 2
                  for k, t in solver.state.opt_state["mu"].items()},
           "nu": {k: t.numpy() * 2
                  for k, t in solver.state.opt_state["nu"].items()}}
    if optimizer == "adam":
        opt["count"] = 5
    solver.load_opt_state(opt)
    for k, t in solver.state.opt_state["nu"].items():
        np.testing.assert_array_equal(t.numpy(), opt["nu"][k])
    if optimizer == "adam":
        assert int(solver.state.opt_state["count"]) == 5
    solver.load_flax_state(fs["params"], fs["target_params"],
                           fs.get("count", 0), fs["mu"], fs["nu"], 9)
    assert int(solver.state.step) == 9
    assert [t.data_ptr() for t in _tensors(solver, replay).values()] == ptrs
    assert dispatch_key(solver.learner.cfg, solver.state, replay.dstate, 2,
                        solver_mod.fused_spec(solver.config, replay)) == key


def test_dispatch_key_changes_with_a_rebinding_or_a_setting():
    solver, replay = _build(_cfg(chain=2, batch=16), "cpu", rows=300)
    spec = solver_mod.fused_spec(solver.config, replay)

    def key():
        return dispatch_key(solver.learner.cfg, solver.state, replay.dstate,
                            2, spec)

    k0 = key()
    assert key() == k0
    assert dispatch_key(solver.learner.cfg, solver.state, replay.dstate, 3,
                        spec) != k0
    solver.state.step = solver.state.step.clone()
    k1 = key()
    assert k1 != k0
    replay.dstate["prio"] = replay.dstate["prio"].clone()
    k2 = key()
    assert k2 != k1
    solver.learner.cfg.lr *= 2
    assert key() != k2


def test_load_opt_state_refuses_another_shape():
    solver, _ = _build(_cfg(chain=2, batch=16), "cpu", rows=300)
    opt = {"name": "rmsprop",
           "mu": {k: np.zeros((1,) + tuple(t.shape), np.float32)
                  for k, t in solver.state.opt_state["mu"].items()},
           "nu": {k: t.numpy()
                  for k, t in solver.state.opt_state["nu"].items()}}
    with pytest.raises(ValueError, match="the state's is"):
        solver.load_opt_state(opt)


def test_a_capture_tallies_its_launches_instead_of_counting(monkeypatch):
    """Launches made into a capturing stream while a tally is open go to
    the tally (the graph adds it on each replay); any other launch counts
    at once, the tally open or not."""
    def fake():
        pass
    fake.launches = 0
    capturing = {"now": False}
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing["now"])
    cuda_build.count_launch(fake)
    with cuda_build.launch_tally() as tally:
        cuda_build.count_launch(fake)        # another stream's launch
        capturing["now"] = True
        cuda_build.count_launch(fake)
        cuda_build.count_launch(fake)
    assert fake.launches == 2 and tally == {fake: 2}
    cuda_build.count_launch(fake)            # no tally open
    assert fake.launches == 3
