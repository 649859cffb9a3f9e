"""Port vs reference: the fused masked-Huber TD loss (B3 forward, B4
backward), through its plain versions — the CPU path of
``ops/fused_loss.py``.

The reference side is ``ops/pallas_kernels.py::fused_dqn_loss`` in Pallas
interpret mode (as ``tests/test_pallas.py`` runs it on the CPU). Inputs
come from numpy with a seed, and include actions outside ``[0, A)``, which
the one-hot contraction maps to ``q_sa = 0`` and a zero gradient row.

Pins and their reasons:

- ``|td|``: bitwise — the one-hot sum has one non-zero term, so both sides
  compute ``q[b, a] − t`` exactly;
- ``dq``: bitwise — ``((g·w)·clip)/B`` is three roundings in the same
  order on both sides;
- the loss: 1e-6 relative — the batch mean sums in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_deep_q_tpu.ops.pallas_kernels import (
    fused_dqn_loss as ref_fused_dqn_loss)

from distributed_deep_q_tpu_torch.ops import fused_loss as fl
from distributed_deep_q_tpu_torch.ops.losses import dqn_loss


def _inputs(b, a, seed, out_of_range=True):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, a)).astype(np.float32) * 3
    actions = rng.integers(0, a, size=b).astype(np.int32)
    if out_of_range:
        actions[:3] = [-1, a, a + 5]
    targets = (q[np.arange(b), np.clip(actions, 0, a - 1)]
               + rng.normal(size=b).astype(np.float32) * 2).astype(np.float32)
    weights = rng.uniform(0.1, 1.0, size=b).astype(np.float32)
    return q, actions, targets, weights


def _ref(q, actions, targets, weights, delta, g):
    args = [jnp.asarray(x) for x in (actions, targets, weights)]
    (loss, td), vjp = jax.vjp(
        lambda qq: ref_fused_dqn_loss(qq, *args, delta), jnp.asarray(q))
    (dq,) = vjp((jnp.float32(g), jnp.zeros_like(td)))
    return float(loss), np.asarray(td), np.asarray(dq)


CASES = [(b, a, delta) for b, a in ((512, 4), (512, 18), (32, 6))
         for delta in (0.5, 1.0, 2.0)]


@pytest.mark.parametrize("b, a, delta", CASES)
def test_plain_fused_loss_matches_reference(b, a, delta):
    q, actions, targets, weights = _inputs(b, a, seed=b + a)
    g = 0.37
    loss_r, td_r, dq_r = _ref(q, actions, targets, weights, delta, g)
    tq, ta, tt, tw = (torch.from_numpy(x)
                      for x in (q, actions, targets, weights))
    loss, td = fl.fused_loss_fwd_plain(tq, ta, tt, tw, delta)
    dq = fl.fused_loss_bwd_plain(tq, ta, tt, tw, torch.tensor(g), delta)
    np.testing.assert_allclose(float(loss), loss_r, rtol=1e-6)
    np.testing.assert_array_equal(td.numpy(), td_r)
    np.testing.assert_array_equal(dq.numpy(), dq_r)
    # out-of-range actions: zero gradient rows
    assert not dq[:3].any()


def test_autograd_function_on_cpu_matches_reference_gradient():
    """``FusedDqnLoss`` through autograd: the loss's gradient wrt q is B4's
    ``dq`` at g = 1, and |td| carries no gradient."""
    q, actions, targets, weights = _inputs(64, 4, seed=5)
    loss_r, td_r, dq_r = _ref(q, actions, targets, weights, 1.0, 1.0)
    tq = torch.from_numpy(q).requires_grad_(True)
    loss, td = fl.FusedDqnLoss.apply(tq, torch.from_numpy(actions),
                                 torch.from_numpy(targets),
                                 torch.from_numpy(weights), 1.0)
    assert not td.requires_grad
    (dq,) = torch.autograd.grad(loss, [tq])
    np.testing.assert_allclose(loss.item(), loss_r, rtol=1e-6)
    np.testing.assert_array_equal(td.numpy(), td_r)
    np.testing.assert_array_equal(dq.numpy(), dq_r)


@pytest.mark.parametrize("delta", [0.5, 1.0, 2.0])
def test_fused_loss_equals_plain_tensor_loss(delta):
    """In range, the fused loss is the learner's plain ``dqn_loss``: same
    value (1e-6 relative), same |TD| and the same gradient to 1e-7."""
    q, actions, targets, weights = _inputs(128, 6, seed=11,
                                           out_of_range=False)
    t_a, t_t, t_w = (torch.from_numpy(x) for x in (actions, targets, weights))
    q1 = torch.from_numpy(q).requires_grad_(True)
    q2 = torch.from_numpy(q).requires_grad_(True)
    l1, td1 = fl.FusedDqnLoss.apply(q1, t_a, t_t, t_w, delta)
    l2, td2 = dqn_loss(q2, t_a, t_t, t_w, delta)
    np.testing.assert_allclose(l1.item(), l2.item(), rtol=1e-6)
    torch.testing.assert_close(td1, td2, rtol=0, atol=0)
    (g1,) = torch.autograd.grad(l1, [q1])
    (g2,) = torch.autograd.grad(l2, [q2])
    torch.testing.assert_close(g1, g2, rtol=0, atol=1e-7)


def test_int64_actions_are_taken_as_int32():
    q, actions, targets, weights = _inputs(16, 4, seed=3)
    tq, tt, tw = (torch.from_numpy(x) for x in (q, targets, weights))
    a32 = fl.fused_loss_fwd(tq, torch.from_numpy(actions), tt, tw, 1.0)
    a64 = fl.fused_loss_fwd(tq, torch.from_numpy(actions).long(), tt, tw, 1.0)
    for x, y in zip(a32, a64):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_wrappers_reject_bad_inputs_and_count_no_cpu_launches():
    q, actions, targets, weights = (torch.from_numpy(x)
                                    for x in _inputs(8, 4, seed=1))
    before = (fl.fused_loss_fwd.launches, fl.fused_loss_bwd.launches)
    fl.fused_loss_fwd(q, actions, targets, weights, 1.0)
    fl.fused_loss_bwd(q, actions, targets, weights, torch.tensor(1.0), 1.0)
    assert (fl.fused_loss_fwd.launches, fl.fused_loss_bwd.launches) == before
    with pytest.raises(ValueError, match="float32"):
        fl.fused_loss_fwd(q.double(), actions, targets, weights, 1.0)
    with pytest.raises(ValueError, match="float32"):
        fl.fused_loss_fwd(q.t().contiguous().t(), actions, targets, weights,
                          1.0)
    with pytest.raises(ValueError, match="targets"):
        fl.fused_loss_fwd(q, actions, targets[:4], weights, 1.0)
    with pytest.raises(ValueError, match="integer"):
        fl.fused_loss_fwd(q, actions.float(), targets, weights, 1.0)
    with pytest.raises(ValueError, match="g must be"):
        fl.fused_loss_bwd(q, actions, targets, weights,
                          torch.tensor(1.0, dtype=torch.float64), 1.0)
