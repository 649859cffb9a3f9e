"""DQN loss construction (port of the reference ``ops/losses.py``).

Pure tensor functions, differentiated by autograd inside the learner step.
The optional fused TD-loss kernel (reference ``ops/pallas_kernels.py``) is
not ported yet.
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
