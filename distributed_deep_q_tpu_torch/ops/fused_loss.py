"""Fused masked-Huber TD loss: the kernels, their plain versions, and the
``torch.autograd.Function`` that joins them (the reference's
``ops/pallas_kernels.py::fused_dqn_loss``).

For ``q`` [B, A] float32, integer ``actions`` [B] and float32 ``targets``
and ``weights`` [B]:

- forward (``fused_loss_fwd``): ``q_sa = Σ_a q·onehot(a)``,
  ``td = q_sa − t``, ``loss = mean_b(w·huber_δ(td))`` and ``|td|`` [B];
- backward (``fused_loss_bwd``): ``dq = onehot(a)·(((g·w)·clip(td, ±δ))/B)``
  for the incoming gradient ``g`` of the loss. Targets and weights get no
  gradient; ``|td|`` carries none.

The action gather is the reference's one-hot contraction, not an index: an
action outside ``[0, A)`` gives ``q_sa = 0`` and a zero gradient row.

Each wrapper takes its plain PyTorch version for tensors on the CPU and
launches its CUDA kernel (``csrc/fused_loss.cu``, built for ``sm_90a`` at
first use) for tensors on the card; any other device raises. The kernel
path counts its launches in ``fused_loss_fwd.launches`` /
``fused_loss_bwd.launches``.

Batch size: the reference runs the kernel per mesh shard and averages the
shard losses; the port runs one device and divides by the full batch —
the same function, rounded differently.
"""

from __future__ import annotations

import ctypes

import torch

from distributed_deep_q_tpu_torch.ops.cuda_build import Entry


def _check(q: torch.Tensor, actions: torch.Tensor, targets: torch.Tensor,
           weights: torch.Tensor) -> torch.Tensor:
    """Validate the operands; returns ``actions`` as contiguous int32 (the
    reference casts them too), without a copy when they already are."""
    if q.dtype != torch.float32 or q.dim() != 2 or not q.is_contiguous():
        raise ValueError(f"q must be a contiguous [B, A] float32 tensor, got "
                         f"{q.dtype} {tuple(q.shape)}")
    b, a = q.shape
    if b == 0 or a == 0:
        raise ValueError(f"q has an empty dimension: {tuple(q.shape)}")
    for name, t in (("targets", targets), ("weights", weights)):
        if (t.dtype != torch.float32 or t.dim() != 1 or t.shape[0] != b
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous [{b}] float32 "
                             f"tensor, got {t.dtype} {tuple(t.shape)}")
    if actions.dim() != 1 or actions.shape[0] != b \
            or actions.is_floating_point() or actions.is_complex():
        raise ValueError(f"actions must be a [{b}] integer tensor, got "
                         f"{actions.dtype} {tuple(actions.shape)}")
    dev = q.device
    if actions.device != dev or targets.device != dev \
            or weights.device != dev:
        devs = {t.device for t in (q, actions, targets, weights)}
        raise ValueError(f"tensors on different devices: "
                         f"{sorted(str(d) for d in devs)}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if actions.dtype == torch.int32 and actions.is_contiguous():
        return actions
    return actions.to(torch.int32).contiguous()


_P, _I64 = ctypes.c_void_p, ctypes.c_longlong
_I32, _F32 = ctypes.c_int, ctypes.c_float
_FWD = Entry("fused_loss", "ddq_fused_loss_fwd",
             [_P, _P, _P, _P, _P, _P, _I64, _I32, _F32])
_BWD = Entry("fused_loss", "ddq_fused_loss_bwd",
             [_P, _P, _P, _P, _P, _P, _I64, _I32, _F32])


# -- plain versions (the CPU path, and the card's reference) ----------------


def _td(q, actions, targets):
    """(td [B], onehot [B, A]) by the reference's one-hot contraction."""
    cols = torch.arange(q.shape[1], device=q.device)
    onehot = (cols == actions.long()[:, None]).to(q.dtype)
    return (q * onehot).sum(dim=1) - targets, onehot


def fused_loss_fwd_plain(q, actions, targets, weights,
                         delta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(scalar loss, |td| [B]) in the reference kernel's operation order."""
    td, _ = _td(q, actions, targets)
    abs_td = td.abs()
    m = torch.clamp(abs_td, max=delta)
    huber = 0.5 * m * m + delta * (abs_td - m)
    return (weights * huber).mean(), abs_td


def fused_loss_bwd_plain(q, actions, targets, weights, g,
                         delta: float) -> torch.Tensor:
    """``dq`` [B, A]: ``onehot(a)·(((g·w)·clip(td, ±δ))/B)``. The division
    is by a tensor on ``q``'s device: PyTorch on the card turns a division
    by a Python number into a multiply by its reciprocal, which would
    round differently from the kernel and the reference."""
    td, onehot = _td(q, actions, targets)
    batch = torch.full((), q.shape[0], dtype=q.dtype, device=q.device)
    coeff = g * weights * torch.clamp(td, -delta, delta) / batch
    return onehot * coeff[:, None]


# -- wrappers ----------------------------------------------------------------


def fused_loss_fwd(q: torch.Tensor, actions: torch.Tensor,
                   targets: torch.Tensor, weights: torch.Tensor,
                   delta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """B3: returns (0-d loss, |td| [B]), both float32 on ``q``'s device."""
    return _fwd(q, _check(q, actions, targets, weights), targets, weights,
                delta)


def fused_loss_bwd(q: torch.Tensor, actions: torch.Tensor,
                   targets: torch.Tensor, weights: torch.Tensor,
                   g: torch.Tensor, delta: float) -> torch.Tensor:
    """B4: ``dq`` [B, A] float32 for the loss gradient ``g`` (a 0-d float32
    tensor on ``q``'s device, read there by the kernel)."""
    return _bwd(q, _check(q, actions, targets, weights), targets, weights, g,
                delta)


def _fwd(q, a32, targets, weights, delta):
    """B3 on operands ``_check`` has passed, ``a32`` the actions it
    returned."""
    dev = q.device
    if dev.type == "cpu":
        return fused_loss_fwd_plain(q, a32, targets, weights, delta)
    b, a = q.shape
    loss = torch.empty((), dtype=torch.float32, device=dev)
    td_abs = torch.empty(b, dtype=torch.float32, device=dev)
    err = _FWD(dev, q.data_ptr(), a32.data_ptr(), targets.data_ptr(),
               weights.data_ptr(), loss.data_ptr(), td_abs.data_ptr(), b, a,
               delta)
    if err:
        raise RuntimeError(f"fused_loss_fwd kernel launch failed: CUDA "
                           f"error {err}")
    fused_loss_fwd.launches += 1
    return loss, td_abs


def _bwd(q, a32, targets, weights, g, delta):
    """B4 on operands ``_check`` has passed, ``a32`` the actions it
    returned; only ``g`` is checked here. The backward of ``FusedDqnLoss``
    comes here directly, since its forward checked the rest."""
    if g.dtype != torch.float32 or g.numel() != 1 or g.device != q.device:
        raise ValueError(f"g must be one float32 element on {q.device}, "
                         f"got {g.dtype} {tuple(g.shape)} on {g.device}")
    if q.device.type == "cpu":
        return fused_loss_bwd_plain(q, a32, targets, weights, g.reshape(()),
                                    delta)
    b, a = q.shape
    dq = torch.empty_like(q)
    # one element: data_ptr() is its address whatever g's strides
    err = _BWD(q.device, q.data_ptr(), a32.data_ptr(), targets.data_ptr(),
               weights.data_ptr(), g.data_ptr(), dq.data_ptr(), b, a, delta)
    if err:
        raise RuntimeError(f"fused_loss_bwd kernel launch failed: CUDA "
                           f"error {err}")
    fused_loss_bwd.launches += 1
    return dq


fused_loss_fwd.launches = 0
fused_loss_bwd.launches = 0


class FusedDqnLoss(torch.autograd.Function):
    """``FusedDqnLoss.apply(q, actions, targets, weights, delta)``: the
    contract of ``ops.losses.dqn_loss`` — (scalar loss, |TD| [B]), with
    ``targets`` and ``weights`` constants (no gradient). Forward is B3,
    backward is B4; the checked inputs (the actions as int32) are kept for
    the backward, which recomputes td from them."""

    @staticmethod
    def forward(ctx, q, actions, targets, weights, delta: float):
        a32 = _check(q, actions, targets, weights)
        loss, td_abs = _fwd(q, a32, targets, weights, delta)
        ctx.save_for_backward(q, a32, targets, weights)
        ctx.delta = delta
        ctx.mark_non_differentiable(td_abs)
        return loss, td_abs

    @staticmethod
    def backward(ctx, g_loss, g_td_abs):
        q, a32, targets, weights = ctx.saved_tensors
        dq = _bwd(q, a32, targets, weights, g_loss, ctx.delta)
        return dq, None, None, None, None
