"""Prioritized-replay helpers the fused device path needs (the reference
``replay/prioritized.py``'s ``beta_at``; the host sum-tree is not ported)."""

from __future__ import annotations


def beta_at(samples: int, beta0: float, beta_steps: int) -> float:
    """IS-correction exponent annealed linearly β₀ → 1 over ``beta_steps``
    sample() calls (Schaul et al. §3.4)."""
    frac = min(samples / max(beta_steps, 1), 1.0)
    return beta0 + frac * (1.0 - beta0)
