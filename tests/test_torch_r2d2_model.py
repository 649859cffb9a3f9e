"""Port vs reference: the R2D2 Q-net, its parameter conversion and the
sequence losses.

Inputs come from numpy seeds; the reference's weights are converted into
the port (``convert.py``). Pins and their reasons:

- forward q and the final carry ``(c, h)`` in float32: within 2e-6 absolute
  (sums over the fan-ins in other orders; measured ≤ 2.5e-7);
- in bfloat16 (the torso and the head in bf16, the LSTM in float32): q
  within 0.05 and the carry within 0.02 absolute — the two frameworks round
  to bf16 at other places (the conv algorithms differ), and the LSTM
  carries the torso's bf16 rounding through tanh and sigmoid;
- the LSTM (``torch.lstm``, cuDNN's on the card) against the plain
  ``lstm_cell`` written out step by step: within 1e-6;
- parameter round trips Flax → port → Flax: bit for bit;
- the losses: the same float32 ops on both sides, within 1e-6 relative,
  except where ``value_rescale_inv`` enters. Its ``sqrt(1 + 4ε(|x|+1+ε))
  − 1`` cancels down to ≥ 2ε = 0.002, so one ulp of the square root
  (PyTorch's vectorized CPU ``sqrt`` is within 0.5001 ulp, XLA's is
  correctly rounded: they differ in the last bit on some inputs) becomes
  up to 1.2e-4 relative after the cancellation and the square: the
  inverse and the rescaled targets within 2.5e-4 · (|value| + 1).
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

from distributed_deep_q_tpu_torch import convert
from distributed_deep_q_tpu_torch.config import NetConfig
from distributed_deep_q_tpu_torch.models.qnet import build_qnet, lstm_cell
from distributed_deep_q_tpu_torch.ops import losses

LSTM, B, T, A = 16, 5, 7, 3


def _pair(torso, dueling, dtype="float32", frame=(52, 52), seed=1):
    """(reference module, reference params as numpy, port net) with the
    reference's weights in the port."""
    kw = dict(kind="r2d2", num_actions=A, lstm_size=LSTM, torso=torso,
              hidden=(16, 12), frame_shape=frame, dueling=dueling, stack=4,
              compute_dtype=dtype)
    obs_dim = int(np.prod(frame)) * 4
    ref_cfg = RefNetConfig(**kw)
    module = ref_build_qnet(ref_cfg)
    params = jax.tree.map(np.asarray, init_params(module, ref_cfg, seed=seed,
                                                  obs_dim=obs_dim))
    net = build_qnet(NetConfig(**kw), obs_dim=obs_dim)
    tree = convert.params_from_flax(params, frame)
    assert set(tree) == {n for n, _ in net.named_parameters()}
    with torch.no_grad():
        for name, p in net.named_parameters():
            p.copy_(torch.from_numpy(tree[name]))
    return module, params, net


def _inputs(frame, seed=0):
    rng = np.random.default_rng(seed)
    obs = rng.integers(0, 255, (B, T) + frame + (4,), dtype=np.uint8)
    c0 = rng.standard_normal((B, LSTM)).astype(np.float32)
    h0 = rng.standard_normal((B, LSTM)).astype(np.float32)
    return obs, c0, h0


@pytest.mark.parametrize("dueling", [False, True])
@pytest.mark.parametrize("torso", ["mlp", "nature_cnn"])
def test_r2d2_forward_matches_reference(torso, dueling):
    frame = (52, 52)            # conv3 output 3×3: the flatten order counts
    module, params, net = _pair(torso, dueling, frame=frame)
    obs, c0, h0 = _inputs(frame)
    q_ref, (c_ref, h_ref) = module.apply({"params": params}, obs, (c0, h0))
    with torch.no_grad():
        q, (c, h) = net(torch.from_numpy(obs),
                        (torch.from_numpy(c0), torch.from_numpy(h0)))
    assert q.shape == (B, T, A) and q.dtype == torch.float32
    np.testing.assert_allclose(q.numpy(), q_ref, rtol=0, atol=2e-6)
    np.testing.assert_allclose(c.numpy(), c_ref, rtol=0, atol=2e-6)
    np.testing.assert_allclose(h.numpy(), h_ref, rtol=0, atol=2e-6)


@pytest.mark.parametrize("torso", ["mlp", "nature_cnn"])
def test_r2d2_forward_bf16_within_stated_tolerance(torso):
    frame = (36, 36)
    module, params, net = _pair(torso, True, dtype="bfloat16", frame=frame)
    obs, c0, h0 = _inputs(frame, seed=3)
    q_ref, (c_ref, h_ref) = module.apply({"params": params}, obs, (c0, h0))
    with torch.no_grad():
        q, (c, h) = net(torch.from_numpy(obs),
                        (torch.from_numpy(c0), torch.from_numpy(h0)))
    assert q.dtype == torch.float32 and c.dtype == torch.float32
    np.testing.assert_allclose(q.numpy(), q_ref, rtol=0, atol=0.05)
    np.testing.assert_allclose(c.numpy(), c_ref, rtol=0, atol=0.02)
    np.testing.assert_allclose(h.numpy(), h_ref, rtol=0, atol=0.02)


@pytest.mark.parametrize("torso", ["mlp", "nature_cnn"])
def test_r2d2_split_application_equals_forward(torso):
    """``features`` + ``burn_carry`` + ``recur`` (the learner's pieces, the
    reference's ``r2d2_*`` helpers) give ``forward``'s q and carry, and
    ``features_stacked`` on the ring's ``[B, T, stack, H·W]`` planes gives
    ``features`` on the reference's NHWC frames."""
    frame = (36, 36)
    _, _, net = _pair(torso, True, frame=frame)
    obs, c0, h0 = _inputs(frame, seed=4)
    x = torch.from_numpy(obs)
    carry = (torch.from_numpy(c0), torch.from_numpy(h0))
    with torch.no_grad():
        planes = x.permute(0, 1, 4, 2, 3).reshape(B, T, 4, -1)
        f = net.features(x)
        torch.testing.assert_close(net.features_stacked(planes), f, rtol=0,
                                   atol=0)
        q_all, carry_all = net(x, carry)
        mid = net.burn_carry(f[:, :3], carry)
        q_tail, carry_tail = net.recur(f[:, 3:], mid)
    torch.testing.assert_close(q_tail, q_all[:, 3:], rtol=0, atol=1e-6)
    for a, b in zip(carry_tail, carry_all):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_lstm_matches_plain_cell():
    """The net's LSTM (``torch.lstm``) against Flax's gate math written out
    step by step (``lstm_cell``), and that cell against the reference's
    ``OptimizedLSTMCell`` applied to the same leaves."""
    import flax.linen as nn

    _, params, net = _pair("mlp", False, frame=(4, 4))
    rng = np.random.default_rng(5)
    feats = rng.standard_normal((B, T, 12)).astype(np.float32)
    _, c0, h0 = _inputs((4, 4), seed=6)
    lstm = net.lstm
    carry = (torch.from_numpy(c0), torch.from_numpy(h0))
    x = torch.from_numpy(feats)
    with torch.no_grad():
        out, (c, h) = lstm(x, carry)
        steps, cc = [], carry
        for t in range(T):
            cc, y = lstm_cell(x[:, t], cc, lstm.weight_ih, lstm.weight_hh,
                              lstm.bias_hh)
            steps.append(y)
    torch.testing.assert_close(out, torch.stack(steps, 1), rtol=0, atol=1e-6)
    torch.testing.assert_close(c, cc[0], rtol=0, atol=1e-6)
    torch.testing.assert_close(h, cc[1], rtol=0, atol=1e-6)

    (cell_key,) = [k for k in params if k not in ("torso", "head")]
    (c1, h1), y1 = nn.OptimizedLSTMCell(LSTM).apply(
        {"params": params[cell_key]}, (c0, h0), feats[:, 0])
    with torch.no_grad():
        (c2, h2), y2 = lstm_cell(x[:, 0], carry, lstm.weight_ih,
                                 lstm.weight_hh, lstm.bias_hh)
    np.testing.assert_allclose(c2.numpy(), c1, rtol=0, atol=1e-6)
    np.testing.assert_allclose(h2.numpy(), h1, rtol=0, atol=1e-6)


def test_lstm_init_is_flax_like():
    """Orthogonal recurrent kernels per gate, zero biases, a zero input
    bias that is a buffer (Flax's cell has none), lecun-normal input
    kernels (std √(1/F) within 10%)."""
    net = build_qnet(NetConfig(kind="r2d2", num_actions=4, lstm_size=64,
                               frame_shape=(36, 36)), seed=3)
    lstm = net.lstm
    for block in lstm.weight_hh.detach().chunk(4):
        torch.testing.assert_close(block @ block.T, torch.eye(64), rtol=0,
                                   atol=1e-5)
    assert not lstm.bias_hh.any() and not lstm.bias_ih.any()
    assert "lstm.bias_ih" not in dict(net.named_parameters())
    std = float(lstm.weight_ih.detach().std())
    assert abs(std - (1 / 512) ** 0.5) < 0.1 * (1 / 512) ** 0.5


@pytest.mark.parametrize("torso", ["mlp", "nature_cnn"])
def test_r2d2_params_and_train_state_round_trip_bitwise(torso):
    frame = (52, 52)
    _, params, _ = _pair(torso, True, frame=frame)
    (cell_key,) = [k for k in params if k not in ("torso", "head")]
    back = convert.params_to_flax(convert.params_from_flax(params, frame),
                                  frame, lstm_scope=cell_key)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    jax.tree.map(np.testing.assert_array_equal, back, params)

    rng = np.random.default_rng(0)

    def noise(tree):
        return jax.tree.map(
            lambda a: rng.standard_normal(a.shape).astype(np.float32), tree)

    target, mu, nu = noise(params), noise(params), noise(params)
    state = convert.train_state_from_flax(params, target, 7, mu, nu, 7,
                                          frame)
    out = convert.train_state_to_flax(state, frame)
    for key, tree in (("params", params), ("target_params", target),
                      ("mu", mu), ("nu", nu)):
        jax.tree.map(np.testing.assert_array_equal, out[key], tree)
    assert out["count"] == out["step"] == 7


# -- losses --------------------------------------------------------------------


def test_value_rescale_and_inverse_match_reference():
    x = np.concatenate([np.linspace(-50, 50, 101),
                        np.geomspace(1e-4, 1e4, 50)]).astype(np.float32)
    x = np.concatenate([x, -x])
    h = losses.value_rescale(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(h, ref_losses.value_rescale(x), rtol=1e-6)
    inv = losses.value_rescale_inv(torch.from_numpy(h)).numpy()
    np.testing.assert_allclose(inv, ref_losses.value_rescale_inv(h),
                               rtol=2.5e-4, atol=2.5e-4)
    np.testing.assert_allclose(inv, x, rtol=1e-3, atol=1e-3)


def _seq_loss_inputs(seed=0, b=6, t=9, a=4):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, a)).astype(np.float32) * 3
    q_next_t = rng.standard_normal((b, t, a)).astype(np.float32) * 3
    q_next_o = rng.standard_normal((b, t, a)).astype(np.float32) * 3
    q_next_o[0, 0] = q_next_o[0, 0, 0]          # a tie: the first maximum
    reward = rng.standard_normal((b, t)).astype(np.float32) * 5
    discount = np.where(rng.random((b, t)) < 0.1, 0.0, 0.99).astype(
        np.float32)
    actions = rng.integers(0, a, (b, t)).astype(np.int32)
    mask = np.ones((b, t), np.float32)
    mask[1, 5:] = 0.0
    mask[2, 1:] = 0.0
    mask[3] = 0.0                                # a fully masked sequence
    weights = rng.uniform(0.2, 1.0, b).astype(np.float32)
    return q, q_next_t, q_next_o, reward, discount, actions, mask, weights


@pytest.mark.parametrize("rescale", [False, True])
@pytest.mark.parametrize("double", [False, True])
def test_sequence_bellman_targets_match_reference(double, rescale):
    _, q_next_t, q_next_o, reward, discount, *_ = _seq_loss_inputs()
    want = ref_losses.sequence_bellman_targets(
        reward, discount, q_next_t, q_next_o, double=double,
        rescale=rescale)
    got = losses.sequence_bellman_targets(
        torch.from_numpy(reward), torch.from_numpy(discount),
        torch.from_numpy(q_next_t), torch.from_numpy(q_next_o),
        double=double, rescale=rescale)
    tol = 2.5e-4 if rescale else 1e-6
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("delta, eta", [(1.0, 0.9), (0.5, 0.3)])
def test_sequence_dqn_loss_priority_and_grad_match_reference(delta, eta):
    q, q_next_t, q_next_o, reward, discount, actions, mask, weights = \
        _seq_loss_inputs(seed=2)
    targets = np.array(ref_losses.sequence_bellman_targets(
        reward, discount, q_next_t, q_next_o))

    def ref_fn(qq):
        return ref_losses.sequence_dqn_loss(qq, actions, targets, mask,
                                            weights, delta, eta)

    (loss_ref, prio_ref), dq_ref = jax.value_and_grad(
        ref_fn, has_aux=True)(jnp.asarray(q))
    qt = torch.from_numpy(q).requires_grad_(True)
    loss, prio = losses.sequence_dqn_loss(
        qt, torch.from_numpy(actions), torch.from_numpy(targets),
        torch.from_numpy(mask), torch.from_numpy(weights), delta, eta)
    (dq,) = torch.autograd.grad(loss, [qt])
    np.testing.assert_allclose(float(loss.detach()), float(loss_ref),
                               rtol=1e-6)
    np.testing.assert_allclose(prio.numpy(), prio_ref, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(dq.numpy(), dq_ref, rtol=1e-6, atol=1e-9)
    assert prio[3] == 0 and not dq[3].any()     # a fully masked sequence
