"""Port vs reference: the Q-nets (through ``convert.py``) and the losses.

Inputs are made from a numpy seed and fed to both packages. The forward
pins run at 52×52 frames, where conv3's output is 3×3×64, so a wrong
flatten order before ``fc4`` (HWC in the reference, CHW in the port) could
not hide (at 36×36 conv3 is 1×1 and any order agrees).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_deep_q_tpu.config import NetConfig as RefNetConfig
from distributed_deep_q_tpu.models.qnet import build_qnet as ref_build_qnet
from distributed_deep_q_tpu.models.qnet import init_params
from distributed_deep_q_tpu.ops import losses as ref_losses

from distributed_deep_q_tpu_torch.config import NetConfig
from distributed_deep_q_tpu_torch.convert import (
    params_from_flax, params_to_flax, train_state_from_flax,
    train_state_to_flax)
from distributed_deep_q_tpu_torch.models.qnet import build_qnet
from distributed_deep_q_tpu_torch.ops import losses

FRAME = (52, 52)


def _nets(dueling: bool, dtype: str, num_actions: int = 6):
    kw = dict(kind="nature_cnn", num_actions=num_actions, frame_shape=FRAME,
              dueling=dueling, compute_dtype=dtype)
    rcfg = RefNetConfig(**kw)
    module = ref_build_qnet(rcfg)
    ref_params = jax.tree.map(np.asarray, init_params(module, rcfg, seed=3))
    net = build_qnet(NetConfig(**kw), seed=0)
    converted = params_from_flax(ref_params, FRAME)
    with torch.no_grad():
        for name, p in net.named_parameters():
            p.copy_(torch.from_numpy(converted[name]))
    return module, ref_params, net


def _frames(b=8, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (b,) + FRAME + (4,), dtype=np.uint8)


@pytest.mark.parametrize("dueling", [False, True])
def test_nature_cnn_forward_matches_reference_f32(dueling):
    """f32 forward parity at rtol 1e-5: both sides compute in float32 on
    the CPU; the sums run in other orders (XLA vs oneDNN convolutions), so
    values agree to a few ulps, not bitwise (atol covers Q-values near 0)."""
    torch.set_num_threads(1)
    module, ref_params, net = _nets(dueling, "float32")
    obs = _frames()
    q_ref = np.asarray(module.apply({"params": ref_params}, obs))
    with torch.no_grad():
        q = net(torch.from_numpy(obs)).numpy()
    assert q.shape == q_ref.shape == (8, 6)
    np.testing.assert_allclose(q, q_ref, rtol=1e-5, atol=1e-6)


def test_nature_cnn_forward_bf16_loose():
    """bf16 compute rounds at other places in the two frameworks (and
    bf16 keeps 8 bits of mantissa), so the pin is loose: within 2% of the
    largest |Q|."""
    torch.set_num_threads(1)
    module, ref_params, net = _nets(False, "bfloat16")
    obs = _frames(16, seed=1)
    q_ref = np.asarray(module.apply({"params": ref_params}, obs))
    with torch.no_grad():
        q = net(torch.from_numpy(obs)).numpy()
    assert q.dtype == np.float32
    scale = np.abs(q_ref).max()
    np.testing.assert_allclose(q, q_ref, atol=0.02 * scale)


def test_convert_round_trips_and_carries_train_state():
    """params_to_flax(params_from_flax(x)) == x bitwise (pure layout
    moves), and the train-state converter carries θ, θ⁻, Adam and step."""
    _, ref_params, _ = _nets(True, "float32")
    back = params_to_flax(params_from_flax(ref_params, FRAME), FRAME)
    flat_a = jax.tree_util.tree_leaves_with_path(ref_params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)
    state = train_state_from_flax(ref_params, ref_params, 7, ref_params,
                                  ref_params, 11, FRAME)
    assert state["opt_state"]["count"] == 7 and state["step"] == 11
    assert state["params"]["torso.fc4.weight"].shape == (512, 3 * 3 * 64)
    assert state["params"]["torso.conv1.weight"].shape == (32, 4, 8, 8)
    again = train_state_to_flax(state, FRAME)
    np.testing.assert_array_equal(again["mu"]["torso"]["fc4"]["kernel"],
                                  ref_params["torso"]["fc4"]["kernel"])


def test_mlp_forward_matches_reference():
    torch.set_num_threads(1)
    kw = dict(kind="mlp", num_actions=2, hidden=(32, 16), dueling=True)
    rcfg = RefNetConfig(**kw)
    module = ref_build_qnet(rcfg)
    ref_params = jax.tree.map(np.asarray,
                              init_params(module, rcfg, seed=1, obs_dim=4))
    net = build_qnet(NetConfig(**kw), obs_dim=4)
    converted = params_from_flax(ref_params)
    with torch.no_grad():
        for name, p in net.named_parameters():
            p.copy_(torch.from_numpy(converted[name]))
    obs = np.random.default_rng(2).standard_normal((5, 4)).astype(np.float32)
    q_ref = np.asarray(module.apply({"params": ref_params}, obs))
    with torch.no_grad():
        q = net(torch.from_numpy(obs)).numpy()
    np.testing.assert_allclose(q, q_ref, rtol=1e-5, atol=1e-6)


def test_init_is_lecun_normal_with_zero_bias():
    """The port initializes like Flax in distribution: zero biases,
    truncated-normal weights with std √(1/fan_in) inside ±2σ/0.8796."""
    net = build_qnet(NetConfig(kind="nature_cnn", num_actions=6,
                               frame_shape=(84, 84)), seed=0)
    for name, p in net.named_parameters():
        if name.endswith("bias"):
            assert torch.count_nonzero(p) == 0
            continue
        fan_in = int(np.prod(p.shape[1:]))
        std = np.sqrt(1.0 / fan_in)
        w = p.detach()
        assert abs(float(w.std()) / std - 1.0) < 0.1, name
        assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6


@pytest.mark.parametrize("delta", [1.0, 0.5])
def test_huber_matches_reference(delta):
    x = np.linspace(-3, 3, 61).astype(np.float32)
    np.testing.assert_array_equal(
        losses.huber(torch.from_numpy(x), delta).numpy(),
        np.asarray(ref_losses.huber(jnp.asarray(x), delta)))


@pytest.mark.parametrize("double", [False, True])
def test_bellman_targets_match_reference(double):
    rng = np.random.default_rng(4)
    r = rng.standard_normal(32).astype(np.float32)
    disc = (rng.random(32) > 0.2).astype(np.float32) * 0.99
    qt = rng.standard_normal((32, 6)).astype(np.float32)
    qo = rng.standard_normal((32, 6)).astype(np.float32)
    qo[0, 1] = qo[0, 4] = qo[0].max() + 1.0   # a tie: first maximum wins
    ref = np.asarray(ref_losses.bellman_targets(
        jnp.asarray(r), jnp.asarray(disc), jnp.asarray(qt), jnp.asarray(qo),
        double))
    got = losses.bellman_targets(
        torch.from_numpy(r), torch.from_numpy(disc), torch.from_numpy(qt),
        torch.from_numpy(qo), double).numpy()
    np.testing.assert_array_equal(got, ref)


def test_dqn_loss_matches_reference():
    """Loss within f32 rounding of the mean (different summation order);
    |TD| bitwise."""
    rng = np.random.default_rng(5)
    q = (3 * rng.standard_normal((64, 6))).astype(np.float32)
    a = rng.integers(0, 6, 64).astype(np.int32)
    t = (3 * rng.standard_normal(64)).astype(np.float32)
    w = rng.random(64).astype(np.float32)
    loss_r, td_r = ref_losses.dqn_loss(jnp.asarray(q), jnp.asarray(a),
                                       jnp.asarray(t), jnp.asarray(w))
    loss, td = losses.dqn_loss(torch.from_numpy(q), torch.from_numpy(a),
                               torch.from_numpy(t), torch.from_numpy(w))
    np.testing.assert_allclose(float(loss), float(loss_r), rtol=1e-6)
    np.testing.assert_array_equal(td.numpy(), np.asarray(td_r))
