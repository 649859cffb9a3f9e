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


def _check(q: torch.Tensor, actions: torch.Tensor, targets: torch.Tensor,
           weights: torch.Tensor) -> torch.Tensor:
    """Validate the operands; returns ``actions`` as contiguous int32 (the
    reference casts them too)."""
    if q.dtype != torch.float32 or q.dim() != 2 or not q.is_contiguous():
        raise ValueError(f"q must be a contiguous [B, A] float32 tensor, got "
                         f"{q.dtype} {tuple(q.shape)}")
    b, a = q.shape
    if b == 0 or a == 0:
        raise ValueError(f"q has an empty dimension: {tuple(q.shape)}")
    for name, t in (("targets", targets), ("weights", weights)):
        if (t.dtype != torch.float32 or t.shape != (b,)
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous [{b}] float32 "
                             f"tensor, got {t.dtype} {tuple(t.shape)}")
    if actions.shape != (b,) or actions.is_floating_point() \
            or actions.is_complex():
        raise ValueError(f"actions must be a [{b}] integer tensor, got "
                         f"{actions.dtype} {tuple(actions.shape)}")
    devs = {t.device for t in (q, actions, targets, weights)}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: "
                         f"{sorted(str(d) for d in devs)}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    return actions.to(torch.int32).contiguous()


def _lib():
    from distributed_deep_q_tpu_torch.ops import cuda_build

    lib = cuda_build.load("fused_loss")
    if not getattr(lib, "_ddq_typed", False):
        p, i64 = ctypes.c_void_p, ctypes.c_longlong
        i32, f32 = ctypes.c_int, ctypes.c_float
        lib.ddq_fused_loss_fwd.argtypes = [p, p, p, p, p, p, i64, i32, f32, p]
        lib.ddq_fused_loss_fwd.restype = ctypes.c_int
        lib.ddq_fused_loss_bwd.argtypes = [p, p, p, p, p, p, i64, i32, f32, p]
        lib.ddq_fused_loss_bwd.restype = ctypes.c_int
        lib._ddq_typed = True
    return lib


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
    a32 = _check(q, actions, targets, weights)
    if q.device.type == "cpu":
        return fused_loss_fwd_plain(q, a32, targets, weights, delta)
    b, a = q.shape
    loss = torch.empty((), dtype=torch.float32, device=q.device)
    td_abs = torch.empty(b, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _lib().ddq_fused_loss_fwd(
            q.data_ptr(), a32.data_ptr(), targets.data_ptr(),
            weights.data_ptr(), loss.data_ptr(), td_abs.data_ptr(), b, a,
            float(delta), torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"fused_loss_fwd kernel launch failed: CUDA "
                           f"error {err}")
    fused_loss_fwd.launches += 1
    return loss, td_abs


def fused_loss_bwd(q: torch.Tensor, actions: torch.Tensor,
                   targets: torch.Tensor, weights: torch.Tensor,
                   g: torch.Tensor, delta: float) -> torch.Tensor:
    """B4: ``dq`` [B, A] float32 for the loss gradient ``g`` (a 0-d float32
    tensor on ``q``'s device, read there by the kernel)."""
    a32 = _check(q, actions, targets, weights)
    if g.dtype != torch.float32 or g.numel() != 1 or g.device != q.device:
        raise ValueError(f"g must be one float32 element on {q.device}, "
                         f"got {g.dtype} {tuple(g.shape)} on {g.device}")
    if q.device.type == "cpu":
        return fused_loss_bwd_plain(q, a32, targets, weights, g.reshape(()),
                                    delta)
    b, a = q.shape
    g = g.contiguous()
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _lib().ddq_fused_loss_bwd(
            q.data_ptr(), a32.data_ptr(), targets.data_ptr(),
            weights.data_ptr(), g.data_ptr(), dq.data_ptr(), b, a,
            float(delta), torch.cuda.current_stream(q.device).cuda_stream)
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
    backward is B4; the inputs are kept for the backward, which recomputes
    td from them."""

    @staticmethod
    def forward(ctx, q, actions, targets, weights, delta: float):
        loss, td_abs = fused_loss_fwd(q, actions, targets, weights, delta)
        ctx.save_for_backward(q, actions, targets, weights)
        ctx.delta = delta
        ctx.mark_non_differentiable(td_abs)
        return loss, td_abs

    @staticmethod
    def backward(ctx, g_loss, g_td_abs):
        q, actions, targets, weights = ctx.saved_tensors
        dq = fused_loss_bwd(q, actions, targets, weights, g_loss, ctx.delta)
        return dq, None, None, None, None
