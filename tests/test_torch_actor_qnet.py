"""Port vs reference: the actors' numpy ``QNet`` wrapper.

The reference ``QNet`` (Flax, JAX on the CPU) and the port's are built from
the same config; the reference's initial leaves go into the port through
``set_weights`` (the θ wire). Inputs come from numpy seeds.

Pins and their reasons:

- ``get_weights`` of the port gives the reference's leaf shapes in the
  reference's order, and leaves → port → leaves is bit for bit (a pure
  layout change);
- Q-values within 1e-5 absolute and relative (float32 on both sides; the
  sums run in other orders, XLA against oneDNN);
- the r2d2 carry ``(c, h)`` after each of 8 single steps within 1e-5, in
  the reference's order (c first): an actor that swapped them would ship
  a wrong stored state and nothing would raise;
- ``argmax_action`` equal.

The Nature CNN runs at 36×36 (the actors' test size) and at 52×52, where
conv3's output is 3×3 so a wrong fc4 row order could not hide.
"""

import numpy as np
import pytest
import torch

from distributed_deep_q_tpu.config import NetConfig as RefNetConfig
from distributed_deep_q_tpu.models.qnet import QNet as RefQNet

from distributed_deep_q_tpu_torch.config import NetConfig
from distributed_deep_q_tpu_torch.models.qnet import QNet

TOL = 1e-5
NETS = {
    "mlp": dict(kind="mlp", num_actions=3, hidden=(32, 16), dueling=True),
    "nature36": dict(kind="nature_cnn", num_actions=4, frame_shape=(36, 36)),
    "nature52": dict(kind="nature_cnn", num_actions=4, frame_shape=(52, 52),
                     dueling=True),
    "r2d2_mlp": dict(kind="r2d2", num_actions=2, torso="mlp", hidden=(32,),
                     lstm_size=16),
    "r2d2_nature": dict(kind="r2d2", num_actions=4, torso="nature_cnn",
                        frame_shape=(36, 36), lstm_size=16),
}
OBS_DIM = 4


def _pair(name, seed=3):
    kw = dict(NETS[name], compute_dtype="float32")
    ref = RefQNet(RefNetConfig(**kw), seed=seed, obs_dim=OBS_DIM)
    port = QNet(NetConfig(**kw), seed=0, obs_dim=OBS_DIM)
    port.set_weights(ref.get_weights())
    return ref, port


def _obs(name, n, seed=0):
    rng = np.random.default_rng(seed)
    cfg = NETS[name]
    if cfg["kind"] == "mlp" or cfg.get("torso") == "mlp":
        return rng.standard_normal((n, OBS_DIM)).astype(np.float32)
    return rng.integers(0, 256, (n,) + cfg["frame_shape"] + (4,),
                        dtype=np.uint8)


@pytest.mark.parametrize("name", list(NETS))
def test_weights_are_the_reference_leaves_and_round_trip_bitwise(name):
    torch.set_num_threads(1)
    ref, port = _pair(name)
    want = ref.get_weights()
    got = port.get_weights()
    assert [w.shape for w in got] == [w.shape for w in want]
    assert [w.dtype for w in got] == [w.dtype for w in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert port.num_params() == ref.num_params()
    # the port's parameters are its own layouts (not a leaf cache): set
    # them from another net's leaves and read them back
    other = RefQNet(RefNetConfig(**dict(NETS[name],
                                        compute_dtype="float32")),
                    seed=11, obs_dim=OBS_DIM).get_weights()
    port.set_weights(other)
    for a, b in zip(port.get_weights(), other):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["mlp", "nature36", "nature52"])
def test_q_values_and_argmax_match_the_reference(name):
    torch.set_num_threads(1)
    ref, port = _pair(name)
    obs = _obs(name, 16)
    q_ref = np.asarray(ref.forward(obs))
    q = port.forward(obs)
    assert isinstance(q, np.ndarray) and q.shape == q_ref.shape
    np.testing.assert_allclose(q, q_ref, rtol=TOL, atol=TOL)
    for o in obs:   # one observation: the batch axis is added and dropped
        np.testing.assert_allclose(port.forward(o), np.asarray(
            ref.forward(o)), rtol=TOL, atol=TOL)
        assert port.argmax_action(o) == ref.argmax_action(o)


@pytest.mark.parametrize("name", ["r2d2_mlp", "r2d2_nature"])
def test_r2d2_carry_order_and_values_over_8_steps(name):
    torch.set_num_threads(1)
    ref, port = _pair(name)
    obs = _obs(name, 8 * 2, seed=1).reshape((2, 8) + _obs(name, 1).shape[1:])
    c_ref = ref.initial_state(2)
    c_port = port.initial_state(2)
    for a, b in zip(c_port, c_ref):
        np.testing.assert_array_equal(a, np.asarray(b))
    for t in range(8):
        step = obs[:, t:t + 1]
        q_ref, c_ref = ref.forward(step, c_ref)
        q, c_port = port.forward(step, c_port)
        np.testing.assert_allclose(q, np.asarray(q_ref), rtol=TOL, atol=TOL)
        # (c, h) in the reference's order, each [B, H]
        for a, b in zip(c_port, c_ref):
            assert isinstance(a, np.ndarray) and a.shape == (2, 16)
            np.testing.assert_allclose(a, np.asarray(b), rtol=TOL, atol=TOL)
        assert (np.argmax(q[:, 0], -1)
                == np.argmax(np.asarray(q_ref)[:, 0], -1)).all()
    # c and h differ, so a swap would have shown
    assert not np.allclose(c_port[0], c_port[1])


def test_the_wrapper_stays_on_the_host():
    """Actors build their net on the CPU unless the caller names a
    device."""
    port = QNet(NetConfig(**dict(NETS["mlp"], compute_dtype="float32")))
    assert port.device.type == "cpu"
    assert all(p.device.type == "cpu" for p in port.module.parameters())
    assert not port.module.training
