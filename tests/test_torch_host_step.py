"""Port vs reference: the host-sampled train steps — ``Solver.train_step``
(a host batch) and ``Solver.train_step_from_ring`` (an index batch into the
device frame ring) — with the plain loss and with the fused TD-loss
kernels (``train.use_pallas_loss``; the reference runs its Pallas kernels
in interpret mode, the port their plain versions).

Both solvers start from the same weights and Adam state (``convert.py``)
and take the same batches, drawn from the reference's prioritized replay:

- ``ring``: a ``DeviceFrameReplay`` on each side fed the same stream
  (52×52 frames, so conv3's output is 3×3 and the flatten order matters;
  the ring wraps), Nature CNN;
- ``host_pixels``: a host ``FrameStackReplay`` batch of ``[B, H, W, stack]``
  frames, Nature CNN;
- ``host_mlp``: a CartPole-like ``ReplayMemory`` batch, dueling MLP with a
  Polyak target.

Pins, with slice 1's tolerances (``tests/test_torch_fused_step.py``):
loss and q_mean per step and the per-sample |TD| within 1e-5 relative
(float32 on both sides, sums in other orders); θ and θ⁻ within 2·lr (one
Adam sign flip); Adam's ``mu``/``nu`` within 1e-3 relative plus 1e-4 of
the leaf's largest magnitude.
"""

import numpy as np
import pytest
import torch

import jax

from distributed_deep_q_tpu import config as ref_config
from distributed_deep_q_tpu.parallel.learner import _locate_adam_state
from distributed_deep_q_tpu.replay import device_ring as ref_ring
from distributed_deep_q_tpu.replay import prioritized as ref_per
from distributed_deep_q_tpu.replay import replay_memory as ref_mem
from distributed_deep_q_tpu.solver import Solver as RefSolver

from distributed_deep_q_tpu_torch import config as port_config
from distributed_deep_q_tpu_torch.replay.device_ring import DeviceFrameReplay
from distributed_deep_q_tpu_torch.solver import Solver

FRAME, LR, STEPS, BATCH = (52, 52), 1e-4, 4, 16


def _cfg(mod, path, pallas):
    cfg = mod.Config()
    cfg.mesh.backend = "cpu"
    cfg.mesh.dp = 1
    cfg.replay = mod.ReplayConfig(capacity=256, batch_size=BATCH, n_step=2,
                                  prioritized=True, device_per=False,
                                  write_chunk=16)
    cfg.train = mod.TrainConfig(lr=LR, double_dqn=True,
                                target_update_period=2, stack_forwards="off",
                                use_pallas_loss=pallas, seed=0)
    if path == "host_mlp":
        cfg.net = mod.NetConfig(kind="mlp", num_actions=2, hidden=(32, 32),
                                dueling=True)
        cfg.train.target_tau = 0.005
    else:
        cfg.net = mod.NetConfig(kind="nature_cnn", num_actions=4,
                                frame_shape=FRAME, compute_dtype="float32")
    return cfg


def _pixel_stream(n, seed):
    rng = np.random.default_rng(seed)
    for i in range(n):
        frame = rng.integers(0, 255, FRAME, dtype=np.uint8)
        yield frame, int(rng.integers(4)), float(rng.standard_normal()), \
            i % 11 == 10


def _replays(path, ref_solver, port_cfg):
    """(reference replay that draws the batches, port replay or None)."""
    rc = ref_solver.config.replay
    if path == "host_mlp":
        ref = ref_per.maybe_prioritize(
            ref_mem.ReplayMemory(256, (4,), np.float32, seed=0), rc)
        rng = np.random.default_rng(0)
        for t in range(300):
            ref.add(rng.normal(size=4).astype(np.float32),
                    int(rng.integers(2)), float(rng.normal()),
                    rng.normal(size=4).astype(np.float32),
                    0.0 if t % 19 == 18 else 0.99 ** 2)
        return ref, None
    if path == "host_pixels":
        ref = ref_per.maybe_prioritize(
            ref_mem.FrameStackReplay(256, FRAME, 4, 2, 0.99, seed=0), rc)
        for f, a, r, d in _pixel_stream(300, seed=0):
            ref.add(f, a, r, d)
        return ref, None
    ref = ref_ring.DeviceFrameReplay(rc, ref_solver.mesh, FRAME, 4, 0.99,
                                     seed=0, write_chunk=16)
    port = DeviceFrameReplay(port_cfg.replay, "cpu", FRAME, 4, 0.99, seed=0,
                             write_chunk=16)
    for f, a, r, d in _pixel_stream(300, seed=0):
        ref.add(f, a, r, d)
        port.add(f, a, r, d)
    return ref, port


def _assert_tree_close(got, ref, name, rtol, atol_rel=0.0, atol=0.0):
    for path, leaf in jax.tree_util.tree_leaves_with_path(ref):
        g = got
        for p in path:
            g = g[p.key]
        tol = atol + atol_rel * float(np.abs(leaf).max())
        np.testing.assert_allclose(g, leaf, rtol=rtol, atol=tol,
                                   err_msg=f"{name}{jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("path, pallas", [
    ("ring", False), ("ring", True), ("host_pixels", True),
    ("host_mlp", False), ("host_mlp", True)])
def test_host_sampled_steps_match_reference(path, pallas):
    torch.set_num_threads(1)
    obs_dim = 4 if path == "host_mlp" else 1
    ref = RefSolver(_cfg(ref_config, path, pallas), obs_dim=obs_dim)
    port = Solver(_cfg(port_config, path, pallas), obs_dim=obs_dim,
                  backend="cpu")
    st = jax.tree.map(np.asarray, ref.state)
    adam, _ = _locate_adam_state(st.opt_state)
    port.load_flax_state(st.params, st.target_params, adam.count, adam.mu,
                         adam.nu, st.step)
    ref_rep, port_rep = _replays(path, ref, port.config)

    for _ in range(STEPS):
        batch = ref_rep.sample(BATCH)
        sampled_at = batch.pop("_sampled_at")
        if path == "ring":
            port_rep.flush()   # as its own sample() would
            mr = ref.train_step_from_ring(ref_rep.ring, batch, FRAME)
            mp = port.train_step_from_ring(port_rep.ring, batch, FRAME)
        else:
            mr = ref.train_step(batch)
            mp = port.train_step(batch)
        np.testing.assert_array_equal(mp["index"], batch["index"])
        for key in ("loss", "q_mean"):
            np.testing.assert_allclose(float(mp[key]), float(mr[key]),
                                       rtol=1e-5, err_msg=key)
        td_ref = np.asarray(mr["td_abs"])
        np.testing.assert_allclose(mp["td_abs"].numpy(), td_ref, rtol=1e-5,
                                   atol=1e-6)
        ref_rep.update_priorities(batch["index"], td_ref, sampled_at)

    got = port.flax_state()
    st = jax.tree.map(np.asarray, ref.state)
    adam, _ = _locate_adam_state(st.opt_state)
    assert got["step"] == int(st.step) == STEPS
    assert got["count"] == int(adam.count) == STEPS
    _assert_tree_close(got["params"], st.params, "params", rtol=0,
                       atol=2 * LR)
    _assert_tree_close(got["target_params"], st.target_params, "target",
                       rtol=0, atol=2 * LR)
    _assert_tree_close(got["mu"], adam.mu, "mu", rtol=1e-3, atol_rel=1e-4)
    _assert_tree_close(got["nu"], adam.nu, "nu", rtol=1e-3, atol_rel=1e-4)
