"""Port vs reference: the learners at D = 2 shards (``mesh.dp=2``), and the
port at D = 8 against itself at D = 1.

The reference trains on a two-device CPU mesh: each shard steps over its
B/D rows and the gradients, loss and Q mean are ``pmean``'d. The port
draws per shard the same rows (no uniforms injected: both draw
``jax.random.uniform`` from the same keys), then takes one step over the
whole batch of B rows, which at equal B/D is the same mean up to float
order. Tolerances, each the one the port already holds at one shard:

- the fused Pong-geometry chain (the twin of ``tests/test_device_per.py``'s
  dp=2 chain): the sampled rows bitwise; priorities bitwise at α = 0,
  within 1e-4 relative at α = 0.6 (rows sampled twice in one step left
  out); loss and Q mean per step within 1e-5 relative; θ and θ⁻ within
  2·lr; Adam's ``mu``/``nu`` within 1e-3 relative plus 1e-4 of the leaf's
  largest magnitude (``tests/test_torch_fused_step.py``'s reasons);
- the r2d2 chained path (the twin of ``tests/test_device_sequence.py``'s
  dp=2 runs): the sampled sequences bitwise; loss within 1e-5 relative,
  priorities within 1e-4, θ and θ⁻ within 2e-4 relative plus 1e-6 (the
  reference's dp=1-vs-dp=8 tolerances, ``tests/test_sequence.py``);
- the learning-dynamics plane at dp=2 (the twin of
  ``tests/test_learning_metrics.py``'s): gate off bitwise gate on; against
  the reference's plane, counts exact, sums and extrema within 1e-4;
- the port's sequence ring step at D = 8 against D = 1 on the same
  sequences, in the sense of the reference's dp=8-vs-dp=1 test: the loss
  within 1e-5 relative, priorities within 1e-4, θ within 2e-4 relative
  plus 1e-6 (in fact bitwise: the same full batch either way).
"""

import copy
import signal

import numpy as np
import pytest
import torch

import jax

from distributed_deep_q_tpu import config as ref_config
from distributed_deep_q_tpu.parallel.learner import _locate_adam_state
from distributed_deep_q_tpu.parallel.sequence_learner import (
    SequenceSolver as RefSeqSolver)
from distributed_deep_q_tpu.replay import device_sequence as ref_ds
from distributed_deep_q_tpu.replay.device_per import (
    DevicePERFrameReplay as RefReplay)
from distributed_deep_q_tpu.solver import Solver as RefSolver

from distributed_deep_q_tpu_torch import config as port_config
from distributed_deep_q_tpu_torch import learning
from distributed_deep_q_tpu_torch.parallel import learner as learner_mod
from distributed_deep_q_tpu_torch.parallel import (
    sequence_learner as seq_learner_mod)
from distributed_deep_q_tpu_torch.parallel.sequence_learner import (
    SequenceSolver)
from distributed_deep_q_tpu_torch.replay import device_sequence as ds
from distributed_deep_q_tpu_torch.replay.device_per import (
    DevicePERFrameReplay)
from distributed_deep_q_tpu_torch.solver import Solver

from test_torch_fused_step import (
    LR, _assert_tree_close, _within_step_duplicates)
from test_torch_learning import _assert_planes
from test_torch_sequence_step import (
    BURN, CAP, FRAME as SFRAME, LSTM, SEQ_LEN, STACK as SSTACK,
    _assert_states_close, _sequences)

FRAME = (52, 52)


@pytest.fixture(autouse=True)
def _deadline():
    """Each test gets 240 s; a hang fails it instead of the run."""
    def expire(*_):
        raise TimeoutError("test exceeded its 240 s deadline")
    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(240)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def _cfg(mod, alpha=0.0, dp=2, learn=False, stack_forwards="off"):
    cfg = mod.Config()
    cfg.mesh.backend = "cpu"
    cfg.mesh.dp = dp
    cfg.net = mod.NetConfig(kind="nature_cnn", num_actions=4,
                            frame_shape=FRAME, compute_dtype="float32")
    cfg.replay = mod.ReplayConfig(capacity=256, batch_size=16, n_step=2,
                                  prioritized=True, priority_alpha=alpha,
                                  device_per=True, write_chunk=16,
                                  fused_chain=3)
    cfg.train = mod.TrainConfig(lr=LR, double_dqn=True,
                                target_update_period=2,
                                stack_forwards=stack_forwards,
                                learn_metrics=learn, seed=0)
    return cfg


def _stream(replays, n, seed, streams=2):
    """Chunks of 11 rows (an episode each) round-robin over the streams,
    so both shards fill alike."""
    rng = np.random.default_rng(seed)
    for c in range(n // 11):
        done = np.zeros(11, bool)
        done[-1] = True
        batch = {"frame": rng.integers(0, 255, (11,) + FRAME, np.uint8),
                 "action": rng.integers(0, 4, 11).astype(np.int32),
                 "reward": rng.standard_normal(11).astype(np.float32),
                 "done": done}
        for rep in replays:
            rep.add_batch(batch, stream=c % streams)


def _pair(alpha, **kw):
    ref = RefSolver(_cfg(ref_config, alpha, **kw))
    ref_rep = RefReplay(ref.config.replay, ref.mesh, FRAME, stack=4,
                        gamma=0.99, seed=0, write_chunk=16, num_streams=2)
    port = Solver(_cfg(port_config, alpha, **kw), backend="cpu")
    st = jax.tree.map(np.asarray, ref.state)
    adam, _ = _locate_adam_state(st.opt_state)
    port.load_flax_state(st.params, st.target_params, adam.count, adam.mu,
                         adam.nu, st.step)
    rep = DevicePERFrameReplay(port.config.replay, "cpu", FRAME, stack=4,
                               gamma=0.99, write_chunk=16, num_streams=2,
                               num_shards=port.num_shards)
    return ref, ref_rep, port, rep


def _recording(monkeypatch, ref_learner, build_name, module, fn_name,
               drawn_ref, drawn):
    """Record the reference learner's sample-program outputs and the
    port's sample-stage outputs."""
    build = getattr(ref_learner, build_name)

    def wrapped(*args, **kw):
        sample, train = build(*args, **kw)

        def recording(*a):
            out = sample(*a)
            drawn_ref.append(jax.tree.map(np.asarray, out))
            return out
        return recording, train

    monkeypatch.setattr(ref_learner, build_name, wrapped)
    fn = getattr(module, fn_name)

    def recording_port(*args):
        out = fn(*args)
        drawn.append(out)
        return out

    monkeypatch.setattr(module, fn_name, recording_port)


@pytest.mark.parametrize("alpha", [0.0, 0.6])
def test_fused_chain_matches_reference_at_dp2(alpha, monkeypatch):
    torch.set_num_threads(1)
    ref, ref_rep, port, rep = _pair(alpha)
    assert port.num_shards == rep.num_shards == ref.mesh.shape["dp"] == 2
    drawn_ref, drawn = [], []
    _recording(monkeypatch, ref.learner, "_build_device_per_step",
               learner_mod, "fused_sample", drawn_ref, drawn)
    _stream([ref_rep, rep], 330, seed=0)          # wraps both shards
    m_ref = [ref.train_steps_device_per(ref_rep, chain=3)]
    m = [port.train_steps_device_per(rep, chain=3)]
    _stream([ref_rep, rep], 44, seed=1)           # flushed inside
    m_ref.append(ref.train_steps_device_per(ref_rep, chain=3))
    m.append(port.train_steps_device_per(rep, chain=3))

    per, cap_local = 8, rep.cap_local
    shard = np.arange(16) // per
    for i, ((_, _, idx, _), (_, _, idx_r)) in enumerate(
            zip(drawn, drawn_ref)):
        want = np.where(idx_r == cap_local, rep.capacity,
                        shard * cap_local + idx_r)
        if alpha == 0.0 or i == 0:    # later α > 0 draws follow |TD|
            np.testing.assert_array_equal(idx.numpy(), want)
    prio = rep.dstate["prio"].numpy()
    prio_ref = np.asarray(ref_rep.dstate.prio)
    if alpha == 0.0:
        np.testing.assert_array_equal(prio, prio_ref)
    else:
        keep = np.ones(prio.shape, bool)
        keep[_within_step_duplicates([d[2] for d in drawn])] = False
        assert keep.sum() > 0.9 * keep.size
        np.testing.assert_allclose(prio[keep], prio_ref[keep], rtol=1e-4)
    for key in ("loss", "q_mean"):
        got = np.concatenate([x[key].numpy() for x in m])
        want = np.concatenate([np.asarray(x[key]) for x in m_ref])
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=key)
    got = port.flax_state()
    st = jax.tree.map(np.asarray, ref.state)
    adam, _ = _locate_adam_state(st.opt_state)
    assert got["step"] == int(st.step) == 6
    _assert_tree_close(got["params"], st.params, "params", rtol=0,
                       atol=2 * LR)
    _assert_tree_close(got["target_params"], st.target_params, "target",
                       rtol=0, atol=2 * LR)
    _assert_tree_close(got["mu"], adam.mu, "mu", rtol=1e-3, atol_rel=1e-4)
    _assert_tree_close(got["nu"], adam.nu, "nu", rtol=1e-3, atol_rel=1e-4)


def test_chained_steps_equal_sequential_at_dp2():
    """Twin of the reference's dp=2 ``chain=3 ≡ 3 × chain=1`` (α = 0):
    one chain-3 dispatch and three single ones run the same three steps
    bit for bit, optimizer state and priorities included."""
    torch.set_num_threads(1)
    cfg = _cfg(port_config)
    a = Solver(cfg, backend="cpu")
    b = Solver(copy.deepcopy(cfg), backend="cpu")
    reps = [DevicePERFrameReplay(s.config.replay, "cpu", FRAME, stack=4,
                                 gamma=0.99, write_chunk=16, num_streams=2,
                                 num_shards=2) for s in (a, b)]
    _stream(reps, 330, seed=0)
    for _ in range(3):
        a.train_step_device_per(reps[0])
    b.train_steps_device_per(reps[1], chain=3)
    for x, y in ((a.state.net, b.state.net),
                 (a.state.target_net, b.state.target_net)):
        for (name, p), (_, q) in zip(x.named_parameters(),
                                     y.named_parameters()):
            assert torch.equal(p, q), name
    for key in ("mu", "nu"):
        for name, t in a.state.opt_state[key].items():
            assert torch.equal(t, b.state.opt_state[key][name]), name
    assert torch.equal(reps[0].dstate["prio"], reps[1].dstate["prio"])


def _seq_cfg(mod, device_per, dp=2):
    cfg = mod.Config()
    cfg.mesh.backend = "cpu"
    cfg.mesh.dp = dp
    cfg.net = mod.NetConfig(kind="r2d2", num_actions=4, lstm_size=LSTM,
                            frame_shape=SFRAME, stack=SSTACK, dueling=True,
                            compute_dtype="float32")
    cfg.replay = mod.ReplayConfig(
        capacity=CAP * SEQ_LEN, batch_size=8, sequence_length=SEQ_LEN,
        burn_in=BURN, prioritized=True, priority_alpha=0.6,
        device_per=device_per, fused_chain=3)
    cfg.train = mod.TrainConfig(lr=1e-3, double_dqn=True,
                                target_update_period=2, seed=0)
    return cfg


def _seq_pair(device_per):
    ref = RefSeqSolver(_seq_cfg(ref_config, device_per))
    port = SequenceSolver(_seq_cfg(port_config, device_per), backend="cpu")
    st = jax.tree.map(np.asarray, ref.state)
    adam, _ = _locate_adam_state(st.opt_state)
    port.load_flax_state(st.params, st.target_params, adam.count, adam.mu,
                         adam.nu, st.step)
    kw = dict(lstm_size=LSTM, prioritized=True, alpha=0.6, seed=0,
              write_chunk=4)
    shape = SFRAME + (SSTACK,)
    ref_rep = ref_ds.DeviceSequenceReplay(CAP, SEQ_LEN, shape, ref.mesh, **kw)
    port_rep = ds.DeviceSequenceReplay(CAP, SEQ_LEN, shape, "cpu",
                                       num_shards=2, **kw)
    for s in _sequences():                 # ~46 sequences: both shards wrap
        ref_rep.add_sequence(s)
        port_rep.add_sequence(s)
    return ref, port, ref_rep, port_rep


def test_sequence_ring_state_matches_reference_at_dp2():
    """The per-shard sequence ring: ring bytes (each shard's scratch slot
    left out), host and device metadata, cursors, sizes, add counts, the
    round-robin shard counter, and the host-sampled index batches."""
    torch.set_num_threads(1)
    ref, port, ref_rep, port_rep = _seq_pair(device_per=False)
    ref_rep.flush()
    port_rep.flush()
    elems = port_rep.slots_local * port_rep.W * port_rep.rowp
    real = port_rep.caps_local * port_rep.W * port_rep.rowp
    got = port_rep.ring.numpy().reshape(2, elems)[:, :real]
    want = np.asarray(ref_rep.ring).reshape(2, elems)[:, :real]
    np.testing.assert_array_equal(got, want)
    for k in ds.META_KEYS + ("n_valid",):
        np.testing.assert_array_equal(getattr(port_rep, k),
                                      getattr(ref_rep, k), err_msg=k)
    for k in ds.META_KEYS + ("prio",):
        np.testing.assert_array_equal(port_rep.dmeta[k].numpy(),
                                      np.asarray(ref_rep.dmeta[k]),
                                      err_msg=k)
    for k in ("_cursor", "_sizes", "_added"):
        np.testing.assert_array_equal(getattr(port_rep, k),
                                      getattr(ref_rep, k), err_msg=k)
    assert port_rep._next_shard == ref_rep._next_shard
    for t, tr in zip(port_rep.trees, ref_rep.trees):
        np.testing.assert_array_equal(t.tree, tr.tree)
    for _ in range(2):
        a, b = ref_rep.sample(8), port_rep.sample(8)
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]),
                                          np.asarray(b[k]), err_msg=k)
        prio = np.linspace(0.2, 2.0, 8)
        ref_rep.update_priorities(a["index"], prio, a["_sampled_at"])
        port_rep.update_priorities(b["index"], prio, b["_sampled_at"])


def test_sequence_ring_step_matches_reference_at_dp2():
    torch.set_num_threads(1)
    ref, port, ref_rep, port_rep = _seq_pair(device_per=False)
    for _ in range(3):
        a, b = ref_rep.sample(8), port_rep.sample(8)
        np.testing.assert_array_equal(a["seq_local"], b["seq_local"])
        at_a, at_b = a.pop("_sampled_at"), b.pop("_sampled_at")
        m_ref = ref.train_step_from_ring(ref_rep, a)
        m = port.train_step_from_ring(port_rep, b)
        np.testing.assert_allclose(float(m["loss"]), float(m_ref["loss"]),
                                   rtol=1e-5)
        prio_ref = np.asarray(m_ref["td_abs"])
        np.testing.assert_allclose(m["td_abs"].numpy(), prio_ref, rtol=1e-4)
        ref_rep.update_priorities(a["index"], prio_ref, at_a)
        port_rep.update_priorities(b["index"], prio_ref, at_b)
    _assert_states_close(port, ref, 3)


def test_sequence_fused_chain_matches_reference_at_dp2(monkeypatch):
    """One chain-3 dispatch per package, no uniforms injected: the
    sequences drawn per shard, their IS weights (every fresh priority is
    the same, so each is exactly 1) and windows bitwise; then the three
    steps within the stated tolerances."""
    torch.set_num_threads(1)
    ref, port, ref_rep, port_rep = _seq_pair(device_per=True)
    drawn_ref, drawn = [], []
    _recording(monkeypatch, ref.learner, "_build_fused_steps",
               seq_learner_mod, "fused_sequence_sample", drawn_ref, drawn)
    m_ref = ref.train_steps_device_per(ref_rep, chain=3)
    m = port.train_steps_device_per(port_rep, chain=3)
    (meta, win, idx), = drawn
    (meta_r, win_r, idx_r), = drawn_ref
    shard = np.arange(8) // 4
    caps = port_rep.caps_local
    np.testing.assert_array_equal(
        idx.numpy(), np.where(idx_r == caps, port_rep.capacity,
                              shard * caps + idx_r))
    np.testing.assert_array_equal(meta["weight"].numpy(), meta_r["weight"])
    np.testing.assert_array_equal(win.numpy(), win_r)
    np.testing.assert_allclose(m["loss"].numpy(), np.asarray(m_ref["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(port_rep.dmeta["prio"].numpy(),
                               np.asarray(ref_rep.dmeta["prio"]), rtol=1e-4)
    _assert_states_close(port, ref, 3)


@pytest.mark.parametrize("device_per", [False, True])
def test_train_recurrent_runs_at_dp2(device_per):
    """Twins of the reference's dp=2 R2D2 loops (ring step and chained
    fused path) through ``train_recurrent``: finite losses, the step
    total, priorities moved off the fresh seed on the fused path."""
    from distributed_deep_q_tpu_torch.train import train_recurrent

    torch.set_num_threads(1)
    mod = port_config
    cfg = mod.Config()
    cfg.mesh.backend = "cpu"
    cfg.mesh.dp = 2
    cfg.env = mod.EnvConfig(id="signal", kind="signal_atari",
                            frame_shape=(36, 36), stack=4, reward_clip=0.0)
    cfg.net = mod.NetConfig(kind="r2d2", num_actions=4, frame_shape=(36, 36),
                            stack=4, lstm_size=16, compute_dtype="float32")
    cfg.replay = mod.ReplayConfig(
        capacity=4096, batch_size=8, learn_start=256, sequence_length=16,
        burn_in=4, prioritized=True, device_resident=True,
        device_per=device_per, fused_chain=3)
    cfg.train = mod.TrainConfig(lr=1e-3, total_steps=500, train_every=16,
                                target_update_period=10, seed=0,
                                eval_episodes=1)
    summary = train_recurrent(cfg, log_every=10)
    assert np.isfinite(summary["loss"])
    assert 10 <= summary["solver"].step <= 500 // 16 + 1
    replay = summary["replay"]
    assert replay.num_shards == 2 and (replay._sizes > 0).all()
    if device_per:
        prio = replay.dmeta["prio"].numpy()
        seeded = prio[prio > 0]
        assert len(seeded) > 0
        assert (~np.isclose(seeded, float(replay.dmaxp) ** replay.alpha)
                ).any()


def test_learn_plane_at_dp2():
    """Twin of the reference's dp=2 gate test: the gate off is bitwise the
    gate on (θ, θ⁻, Adam, priorities), the plane counts every sample of
    both shards, and it matches the reference's dp=2 plane (psummed over
    shards there; one full-batch step here)."""
    torch.set_num_threads(1)
    on = _pair(0.6, learn=True, stack_forwards="on")
    off = _pair(0.6, learn=False, stack_forwards="on")
    (ref, ref_rep, port, rep), (_, _, port_off, rep_off) = on, off
    _stream([ref_rep, rep, rep_off], 330, seed=0)
    want = np.asarray(ref.train_steps_device_per(ref_rep)["learn_plane"])
    m_on = port.train_steps_device_per(rep)
    m_off = port_off.train_steps_device_per(rep_off)
    p = m_on.pop("learn_plane").numpy()
    assert "learn_plane" not in m_off
    assert p[learning.I_STEPS] == 3 and p[learning.I_SAMPLES] == 3 * 16
    for k in m_off:
        assert torch.equal(m_on[k], m_off[k]), k
    for x, y in ((port.state.net, port_off.state.net),
                 (port.state.target_net, port_off.state.target_net)):
        for (name, a), (_, b) in zip(x.named_parameters(),
                                     y.named_parameters()):
            assert torch.equal(a, b), name
    for key in ("mu", "nu"):
        for name, t in port.state.opt_state[key].items():
            assert torch.equal(t, port_off.state.opt_state[key][name]), name
    assert torch.equal(rep.dstate["prio"], rep_off.dstate["prio"])
    _assert_planes(p, want, rtol=1e-4, extrema_rtol=1e-4)


def _slots_in(replay, order):
    """The ring's (shard-local slot, shard) of the n-th sequence added,
    for each n of ``order`` (round-robin over the shards)."""
    d = replay.num_shards
    n = np.asarray(order)
    return (n // d) % replay.caps_local, n % d


def test_port_d8_ring_step_equals_d1():
    """The reference's dp=8-vs-dp=1 test, on the port: the same 16
    sequences in the same batch positions, once from a D = 1 sequence
    ring and once from a D = 8 one (2 per shard), from the same weights."""
    torch.set_num_threads(1)
    seqs = list(_sequences())[:48]
    out = {}
    for d in (1, 8):
        cfg = _seq_cfg(port_config, False, dp=d)
        cfg.replay.batch_size = 16
        solver = SequenceSolver(cfg, backend="cpu")
        rep = ds.DeviceSequenceReplay(48, SEQ_LEN, SFRAME + (SSTACK,), "cpu",
                                      lstm_size=LSTM, prioritized=True,
                                      alpha=0.6, seed=0, write_chunk=4,
                                      num_shards=d)
        for s in seqs:
            rep.add_sequence(s)
        # sequence n = 8·j + s for batch row r = 2·s + j: shard s's j-th
        # row, as a D = 8 sample lays them out
        order = [8 * (r % 2) + r // 2 for r in range(16)]
        local, _ = _slots_in(rep, order)
        gidx = np.asarray(order) if d == 1 else (
            np.asarray(order) % 8 * rep.caps_local + local)
        batch = {"seq_local": local.astype(np.int32),
                 "n_valid": rep.n_valid[gidx],
                 **{k: getattr(rep, k)[gidx] for k in ds.META_KEYS},
                 "weight": np.linspace(0.5, 1.0, 16).astype(np.float32),
                 "index": gidx.astype(np.int32)}
        out[d] = (solver, solver.train_step_from_ring(rep, batch))
    (s1, m1), (s8, m8) = out[1], out[8]
    np.testing.assert_allclose(float(m8["loss"]), float(m1["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(m8["td_abs"].numpy(), m1["td_abs"].numpy(),
                               rtol=1e-4)
    for (name, a), (_, b) in zip(s1.state.net.named_parameters(),
                                 s8.state.net.named_parameters()):
        np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(),
                                   rtol=2e-4, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("run", ["fused_per", "ring_multigame", "r2d2_fused"])
def test_distributed_learner_runs_at_dp2(run):
    """The distributed topology at one process with two replay shards:
    the learner's replay holds both, the actors' streams fill them, and
    the run trains as at one shard (``tests/test_torch_distributed.py``'s
    configurations and checks)."""
    from test_torch_distributed import RUNS, _cfg, _check

    from distributed_deep_q_tpu_torch.actors import supervisor as sup_mod

    torch.set_num_threads(2)
    preset, overrides = RUNS[run]
    cfg = _cfg(preset, overrides + ["mesh.dp=2"])
    if run == "ring_multigame":
        cfg.env.games = ("signal", "signal-h")
    summary = sup_mod.train_distributed(cfg, log_every=20)
    _check(summary, cfg)
    replay = summary["replay"]
    assert replay.num_shards == 2
    sizes = (replay._sizes if run.startswith("r2d2") else
             [sum(len(m) for g, m in enumerate(replay.slots) if g % 2 == s)
              for s in range(2)])
    assert (np.asarray(sizes) > 0).all()
