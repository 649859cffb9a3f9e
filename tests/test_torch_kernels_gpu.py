"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test carries the ``gpu`` marker and skips inside the test where
``torch.cuda.is_available()`` is false. This file imports neither jax nor
the reference package, so it also runs where only the port's dependencies
are installed (the repository's conftest imports jax; skip it there):

    python -m pytest -m gpu --noconftest tests/test_torch_kernels_gpu.py
"""

import pytest
import torch

from distributed_deep_q_tpu_torch.ops import fused_loss as fl
from distributed_deep_q_tpu_torch.ops import ring_gather as rg


def _need_card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda", 0)


def _ring(rows, rowp, dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(-2**31, 2**31 - 1, (rows * rowp,),
                         dtype=torch.int32, device=dev, generator=gen), gen


@pytest.mark.gpu
@pytest.mark.parametrize("n, w", [(512, 5), (4096, 5), (3, 7)])
def test_gather_windows_kernel_matches_plain_on_card(n, w):
    """Bitwise, on a ring past 2³¹ bytes (300,000 rows of 8192 B), with
    window starts in the ring's top rows; counted once per launch."""
    dev = _need_card()
    rowb, rows = 8192, 300_000
    ring, gen = _ring(rows, rowb // 4, dev, 0)
    idx = torch.randint(0, rows - w + 1, (n,), dtype=torch.int32, device=dev,
                        generator=gen)
    idx[0] = rows - w                        # the ring's last window
    idx[-1] = (2**31 // rowb) + 1            # just past the 2³¹-byte mark
    before = rg.gather_windows.launches
    got = rg.gather_windows(idx, ring, n=n, w=w, rowb=rowb)
    torch.cuda.synchronize()
    assert rg.gather_windows.launches == before + 1
    want = rg.gather_windows_plain(idx, ring, n=n, w=w, rowb=rowb)
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_scatter_rows_kernel_matches_plain_on_card():
    """A 128-lane flush with ghost mirrors and padding lanes on the scratch
    row; rows everywhere but the scratch row equal bitwise."""
    dev = _need_card()
    rowb, rows, k = 8192, 300_000, 64
    rowp, scratch = rowb // 4, rows - 1
    ring, gen = _ring(rows, rowp, dev, 1)
    staged = torch.randint(-2**31, 2**31 - 1, (k * rowp,),
                           dtype=torch.int32, device=dev, generator=gen)
    main = torch.arange(k, dtype=torch.int32, device=dev) + 280_000
    main[-3:] = scratch
    ghost = torch.full((k,), scratch, dtype=torch.int32, device=dev)
    ghost[:4] = torch.arange(4, dtype=torch.int32, device=dev) + 290_000
    src = torch.arange(k, dtype=torch.int32, device=dev).repeat(2)
    dst = torch.cat([main, ghost])
    kernel, plain = ring.clone(), ring
    before = rg.scatter_rows.launches
    rg.scatter_rows(src, dst, staged, kernel, n=2 * k, rowb=rowb)
    torch.cuda.synchronize()
    assert rg.scatter_rows.launches == before + 1
    rg.scatter_rows_plain(src, dst, staged, plain, n=2 * k, rowb=rowb)
    assert torch.equal(kernel[:-rowp], plain[:-rowp])


@pytest.mark.gpu
def test_cuda_wrappers_refuse_cpu_mixes_and_misalignment():
    dev = _need_card()
    ring = torch.zeros(8 * 1024, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="different devices"):
        rg.gather_windows(torch.zeros(2, dtype=torch.int32), ring, n=2, w=2,
                          rowb=4096)
    with pytest.raises(ValueError, match="aligned"):
        rg.gather_windows(torch.zeros(1, dtype=torch.int32, device=dev),
                          ring[1:1 + 4 * 1024], n=1, w=2, rowb=4096)


def _loss_inputs(b, a, dev, seed):
    """Random [B, A] Q-values, actions with three out of ``[0, A)``,
    targets and weights, on the card."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, a, device=dev, generator=gen) * 3
    actions = torch.randint(0, a, (b,), dtype=torch.int32, device=dev,
                            generator=gen)
    actions[:3] = torch.tensor([-1, a, a + 5], dtype=torch.int32)
    targets = torch.randn(b, device=dev, generator=gen) * 2
    weights = torch.rand(b, device=dev, generator=gen) * 0.9 + 0.1
    return q, actions, targets, weights


@pytest.mark.gpu
@pytest.mark.parametrize("b, a", [(512, 4), (512, 18), (1500, 6)])
@pytest.mark.parametrize("delta", [0.5, 1.0, 2.0])
def test_fused_loss_kernels_match_plain_on_card(b, a, delta):
    """B3/B4: |td| and dq bitwise, the loss within 1e-6 relative; B = 1500
    makes the forward's one block loop over rows. One launch each."""
    dev = _need_card()
    q, actions, targets, weights = _loss_inputs(b, a, dev, seed=b + a)
    g = torch.tensor(0.37, device=dev)
    before = (fl.fused_loss_fwd.launches, fl.fused_loss_bwd.launches)
    loss, td = fl.fused_loss_fwd(q, actions, targets, weights, delta)
    dq = fl.fused_loss_bwd(q, actions, targets, weights, g, delta)
    torch.cuda.synchronize()
    assert (fl.fused_loss_fwd.launches, fl.fused_loss_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    loss_p, td_p = fl.fused_loss_fwd_plain(q, actions, targets, weights,
                                           delta)
    dq_p = fl.fused_loss_bwd_plain(q, actions, targets, weights, g, delta)
    assert torch.equal(td, td_p)
    assert torch.equal(dq, dq_p)
    assert not dq[:3].any()
    assert abs(float(loss) - float(loss_p)) <= 1e-6 * abs(float(loss_p))
    # a fixed-order sum: the same bits on every run
    again, _ = fl.fused_loss_fwd(q, actions, targets, weights, delta)
    assert torch.equal(loss, again)


@pytest.mark.gpu
def test_fused_loss_autograd_on_card():
    """``FusedDqnLoss`` on card tensors runs B3 forward and B4 backward,
    and its gradient equals the plain backward's at g = 1."""
    dev = _need_card()
    q, actions, targets, weights = _loss_inputs(512, 4, dev, seed=9)
    q.requires_grad_(True)
    before = (fl.fused_loss_fwd.launches, fl.fused_loss_bwd.launches)
    loss, td = fl.FusedDqnLoss.apply(q, actions, targets, weights, 1.0)
    (dq,) = torch.autograd.grad(loss, [q])
    torch.cuda.synchronize()
    assert (fl.fused_loss_fwd.launches, fl.fused_loss_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    assert not td.requires_grad
    want = fl.fused_loss_bwd_plain(q.detach(), actions, targets, weights,
                                   torch.ones((), device=dev), 1.0)
    assert torch.equal(dq, want)
    with pytest.raises(ValueError, match="different devices"):
        fl.fused_loss_fwd(q.detach(), actions.cpu(), targets, weights, 1.0)
