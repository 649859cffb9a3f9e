"""DQN loss construction (port of the reference ``ops/losses.py``).

Pure tensor functions, differentiated by autograd inside the learner step.
The fused TD-loss kernels (``train.use_pallas_loss``) are in
``ops/fused_loss.py``.
"""

from __future__ import annotations

import torch


def huber(x: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    """Huber loss elementwise: quadratic within ±delta, linear outside."""
    abs_x = x.abs()
    quad = torch.clamp(abs_x, max=delta)
    return 0.5 * quad * quad + delta * (abs_x - quad)


def bellman_targets(
    reward: torch.Tensor,          # [B] float32 (n-step summed)
    discount: torch.Tensor,        # [B] float32: γ^n · (1 - done)
    q_next_target: torch.Tensor,   # [B, A] target-net Q(s')
    q_next_online: torch.Tensor | None = None,  # [B, A] online Q(s') (DDQN)
    double: bool = False,
) -> torch.Tensor:
    """r + γⁿ·(1-done)·Q⁻(s', a*) with a* from the online net when
    ``double`` (first maximum on ties, as ``jnp.argmax``)."""
    if double:
        assert q_next_online is not None
        a_star = q_next_online.argmax(dim=-1)
        q_sel = q_next_target.gather(-1, a_star[:, None])[:, 0]
    else:
        q_sel = q_next_target.max(dim=-1).values
    return reward + discount * q_sel


def dqn_loss(
    q: torch.Tensor,         # [B, A] online Q(s)
    actions: torch.Tensor,   # [B] integer
    targets: torch.Tensor,   # [B] float32 (no gradient flows into it)
    weights: torch.Tensor,   # [B] importance weights
    delta: float = 1.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Weighted Huber TD loss. Returns (scalar loss, |TD| for PER updates)."""
    q_sa = q.gather(-1, actions[:, None].long())[:, 0]
    td = q_sa - targets.detach()
    loss = (weights * huber(td, delta)).mean()
    return loss, td.detach().abs()


def value_rescale(x: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """R2D2's invertible value rescaling h(x) = sign(x)(√(|x|+1)−1) + εx."""
    return torch.sign(x) * (torch.sqrt(x.abs() + 1.0) - 1.0) + eps * x


def value_rescale_inv(x: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """Analytic inverse of ``value_rescale``."""
    return torch.sign(x) * (
        torch.square((torch.sqrt(1.0 + 4.0 * eps * (x.abs() + 1.0 + eps))
                      - 1.0) / (2.0 * eps)) - 1.0)


def sequence_bellman_targets(
    reward: torch.Tensor,          # [B, T]
    discount: torch.Tensor,        # [B, T]: γ·(1-done) per step
    q_next_target: torch.Tensor,   # [B, T, A] target net Q(s_{t+1})
    q_next_online: torch.Tensor | None = None,  # [B, T, A] (Double DQN)
    double: bool = True,
    rescale: bool = True,
) -> torch.Tensor:
    """Per-step targets h(r + γ·h⁻¹(Q⁻(s', a*))) over a sequence window
    (a* the first maximum, as ``jnp.argmax``)."""
    if double:
        assert q_next_online is not None
        a_star = q_next_online.argmax(dim=-1)
    else:
        a_star = q_next_target.argmax(dim=-1)
    q_sel = q_next_target.gather(-1, a_star[..., None])[..., 0]
    if rescale:
        return value_rescale(reward + discount * value_rescale_inv(q_sel))
    return reward + discount * q_sel


def sequence_dqn_loss(
    q: torch.Tensor,         # [B, T, A] online Q over the training window
    actions: torch.Tensor,   # [B, T] integer
    targets: torch.Tensor,   # [B, T] float32 (no gradient flows into it)
    mask: torch.Tensor,      # [B, T] 1.0 on valid steps, 0.0 past the end
    weights: torch.Tensor,   # [B] per-sequence importance weights
    delta: float = 1.0,
    eta: float = 0.9,
) -> tuple[torch.Tensor, torch.Tensor]:
    """R2D2 sequence TD loss over the valid steps. Returns (scalar loss,
    per-sequence priority η·max_t|TD| + (1−η)·mean_t|TD|)."""
    q_sa = q.gather(-1, actions[..., None].long())[..., 0]
    td = (q_sa - targets.detach()) * mask
    per_t = huber(td, delta) * mask
    denom = torch.clamp(mask.sum(dim=1), min=1.0)
    per_seq = per_t.sum(dim=1) / denom
    loss = (weights * per_seq).mean()

    abs_td = td.detach().abs()
    max_td = abs_td.max(dim=1).values
    mean_td = abs_td.sum(dim=1) / denom
    priority = eta * max_td + (1.0 - eta) * mean_td
    return loss, priority
