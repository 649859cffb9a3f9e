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
@pytest.mark.parametrize("skip", [True, False])
@pytest.mark.parametrize("real, ghosts", [(4, 0), (0, 0), (62, 4)])
def test_scatter_rows_flush_shapes_on_card(real, ghosts, skip):
    """The flush's shapes: the 4-row flush before each dispatch (124 of
    128 lanes padding), a chunk with no real lane, and a 62-row chunk with
    4 ghost mirrors; with and without ``skip_row``. Bitwise outside the
    scratch row; with ``skip_row`` the scratch row is untouched."""
    dev = _need_card()
    rowb, rows, k = 8192, 300_000, 64
    rowp, scratch = rowb // 4, rows - 1
    ring, gen = _ring(rows, rowp, dev, 2)
    staged = torch.randint(-2**31, 2**31 - 1, (k * rowp,),
                           dtype=torch.int32, device=dev, generator=gen)
    main = torch.full((k,), scratch, dtype=torch.int32, device=dev)
    main[:real] = torch.arange(real, dtype=torch.int32, device=dev) + 270_000
    ghost = torch.full((k,), scratch, dtype=torch.int32, device=dev)
    ghost[:ghosts] = torch.arange(ghosts, dtype=torch.int32, device=dev) + 5
    src = torch.arange(k, dtype=torch.int32, device=dev).repeat(2)
    dst = torch.cat([main, ghost])
    kernel, plain = ring.clone(), ring
    before = rg.scatter_rows.launches
    rg.scatter_rows(src, dst, staged, kernel, n=2 * k, rowb=rowb,
                    skip_row=scratch if skip else None)
    torch.cuda.synchronize()
    assert rg.scatter_rows.launches == before + 1
    scratch_before = plain[-rowp:].clone()
    rg.scatter_rows_plain(src, dst, staged, plain, n=2 * k, rowb=rowb)
    assert torch.equal(kernel[:-rowp], plain[:-rowp])
    if skip:
        assert torch.equal(kernel[-rowp:], scratch_before)


# the R2D2 sequence ring: windows of W = 84 rows of 8192 B, one 688,128-byte
# slot per sequence; 3,200 slots put the ring past 2³¹ bytes
SEQ_W, SEQ_SLOTS = 84, 3_200
# the kernels' bytes per block (kGatherChunkBytes, kScatterChunkBytes in
# csrc/ring_gather.cu)
GC, SC = 64 * 1024, 32 * 1024


@pytest.mark.gpu
@pytest.mark.parametrize("n, w, rowb", [
    (64, SEQ_W, 8192), (512, SEQ_W, 8192),          # the r2d2 shapes
    (7, 1, GC - 16), (7, 1, GC), (7, 1, GC + 16),   # around one chunk
    (9, 3, (2 * GC + 64) // 3 // 16 * 16), (5, 16, GC // 16)])
def test_gather_windows_split_windows_on_card(n, w, rowb):
    """Windows longer than one chunk are split over the grid's second
    dimension: bitwise at the sequence shapes (window starts at sequence
    slots, past the 2³¹-byte mark) and at windows just under, at and over
    one chunk and over two."""
    dev = _need_card()
    rows = max(SEQ_SLOTS * SEQ_W * 8192 // rowb, 4 * n * w)
    ring, gen = _ring(rows, rowb // 4, dev, 3)
    idx = torch.randint(0, rows - w + 1, (n,), dtype=torch.int32, device=dev,
                        generator=gen)
    if w == SEQ_W:
        idx = (idx // SEQ_W) * SEQ_W          # sequence slot starts
    idx[0] = rows - w
    before = rg.gather_windows.launches
    got = rg.gather_windows(idx, ring, n=n, w=w, rowb=rowb)
    torch.cuda.synchronize()
    assert rg.gather_windows.launches == before + 1
    want = rg.gather_windows_plain(idx, ring, n=n, w=w, rowb=rowb)
    assert torch.equal(got, want)
    assert int((idx.long() * rowb >= 2**31).sum()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("real", [1, 4, 0])
@pytest.mark.parametrize("rowb", [SEQ_W * 8192, SC - 16, SC, SC + 16,
                                  2 * SC + 16])
def test_scatter_rows_split_rows_on_card(rowb, real):
    """The sequence flush: 4 lanes of one row each, ``real`` aimed at rows
    past the 2³¹-byte mark, the rest at the scratch row named as
    ``skip_row``; rows of one sequence slot and just under, at and over
    one chunk and over two. Bitwise outside the scratch row, which stays
    untouched."""
    dev = _need_card()
    k, rowp = 4, rowb // 4
    rows = 2**31 // rowb + 64
    scratch = rows - 1
    ring, gen = _ring(rows, rowp, dev, 4)
    staged = torch.randint(-2**31, 2**31 - 1, (k * rowp,), dtype=torch.int32,
                           device=dev, generator=gen)
    dst = torch.full((k,), scratch, dtype=torch.int32, device=dev)
    dst[:real] = torch.arange(real, dtype=torch.int32, device=dev) * 7 + (
        rows - 40)
    src = torch.arange(k, dtype=torch.int32, device=dev)
    kernel, plain = ring.clone(), ring
    scratch_before = plain[-rowp:].clone()
    before = rg.scatter_rows.launches
    rg.scatter_rows(src, dst, staged, kernel, n=k, rowb=rowb,
                    skip_row=scratch)
    torch.cuda.synchronize()
    assert rg.scatter_rows.launches == before + 1
    rg.scatter_rows_plain(src, dst, staged, plain, n=k, rowb=rowb)
    assert torch.equal(kernel[:-rowp], plain[:-rowp])
    assert torch.equal(kernel[-rowp:], scratch_before)


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
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("b", [1, 31, 512, 1500])
@pytest.mark.parametrize("a", [2, 4, 6, 18, 5])
def test_fused_loss_fwd_widths_on_card(a, b, aligned):
    """B3 at every head width with its own instance (2, 4, 6, 18) and one
    that takes the runtime loop (5), over batch sizes from one row to
    three rows a thread; and with q one float off 16-byte alignment, which
    takes the loop at every width. q is written by a copy queued behind a
    slow kernel just before the launch. |td| bitwise, the loss within 1e-6
    relative, and the same bits on a second run."""
    dev = _need_card()
    q, actions, targets, weights = _loss_inputs(max(b, 3), a, dev,
                                                seed=7 * b + a)
    q, actions, targets, weights = q[:b], actions[:b], targets[:b], \
        weights[:b]
    fresh = torch.empty(b * a + 1, device=dev)[int(not aligned):]
    fresh = fresh[:b * a].view(b, a)
    torch.cuda._sleep(2_000_000)          # keeps the copy below queued
    fresh.copy_(q)
    loss, td = fl.fused_loss_fwd(fresh, actions, targets, weights, 1.0)
    again, td_again = fl.fused_loss_fwd(fresh, actions, targets, weights,
                                        1.0)
    torch.cuda.synchronize()
    loss_p, td_p = fl.fused_loss_fwd_plain(q, actions, targets, weights, 1.0)
    assert torch.equal(td, td_p)
    assert abs(float(loss) - float(loss_p)) <= 1e-6 * abs(float(loss_p))
    assert torch.equal(loss, again) and torch.equal(td, td_again)


def _bits(x):
    return x.view(torch.int32)


def _with_nonfinite(q, actions):
    """NaN and ±inf in rows 3–8, on and off each row's action: NaN rows
    where the one-hot sum meets NaN or inf·0, finite rows where inf sits on
    the action and clips to ±δ."""
    a = q.shape[1]
    for row, on_action, value in ((3, False, float("nan")),
                                  (4, False, float("inf")),
                                  (5, True, float("inf")),
                                  (6, True, float("-inf")),
                                  (7, True, float("nan")),
                                  (8, False, float("-inf"))):
        col = int(actions[row]) if on_action else (int(actions[row]) + 1) % a
        q[row, col] = value
    return q


@pytest.mark.gpu
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("b", [1, 31, 512, 1500])
@pytest.mark.parametrize("a", [2, 4, 6, 18, 5])
def test_fused_loss_bwd_widths_on_card(a, b, aligned):
    """B4 at every head width with its own instance (2, 4, 6, 18) and one
    that takes the runtime loop (5), over batch sizes from one row to
    several blocks; and with q one float off 16-byte alignment, which takes
    the loop at every width. q is written by a copy queued behind a slow
    kernel just before the launch; g is a 0-d view at an offset. dq equals
    the plain version as int32 bit patterns (−0.0 off the action where the
    coefficient is negative); one launch."""
    dev = _need_card()
    q, actions, targets, weights = _loss_inputs(max(b, 3), a, dev,
                                                seed=11 * b + a)
    q, actions, targets, weights = q[:b], actions[:b], targets[:b], \
        weights[:b]
    g = torch.tensor([5.0, 0.37], device=dev)[1]
    fresh = torch.empty(b * a + 1, device=dev)[int(not aligned):]
    fresh = fresh[:b * a].view(b, a)
    before = fl.fused_loss_bwd.launches
    torch.cuda._sleep(2_000_000)          # keeps the copy below queued
    fresh.copy_(q)
    dq = fl.fused_loss_bwd(fresh, actions, targets, weights, g, 1.0)
    torch.cuda.synchronize()
    assert fl.fused_loss_bwd.launches == before + 1
    want = fl.fused_loss_bwd_plain(q, actions, targets, weights, g, 1.0)
    assert torch.equal(_bits(dq), _bits(want))


@pytest.mark.gpu
@pytest.mark.parametrize("a", [2, 4, 6, 18, 5])
def test_fused_loss_bwd_nonfinite_on_card(a):
    """NaN and inf in q, and negative coefficients: NaN rows and −0.0
    columns come out of B4 with the plain version's bits."""
    dev = _need_card()
    q, actions, targets, weights = _loss_inputs(512, a, dev, seed=a)
    q = _with_nonfinite(q, actions)
    g = torch.tensor(-0.37, device=dev)
    dq = fl.fused_loss_bwd(q, actions, targets, weights, g, 1.0)
    torch.cuda.synchronize()
    want = fl.fused_loss_bwd_plain(q, actions, targets, weights, g, 1.0)
    assert torch.equal(_bits(dq), _bits(want))
    assert torch.isnan(want[[3, 4, 7, 8]]).all()
    assert torch.isfinite(want[[5, 6]]).all()
    assert (_bits(want) == -2**31).any()


@pytest.mark.gpu
def test_fused_loss_autograd_int64_actions_on_card():
    """``FusedDqnLoss`` with int64 actions: the same dq bits as the public
    wrapper with int32 actions, and exactly one B4 launch per backward (the
    forward's int32 actions are kept, so nothing is cast again)."""
    dev = _need_card()
    q, actions, targets, weights = _loss_inputs(512, 18, dev, seed=5)
    want = fl.fused_loss_bwd(q, actions, targets, weights,
                             torch.ones((), device=dev), 1.0)
    q.requires_grad_(True)
    loss, _ = fl.FusedDqnLoss.apply(q, actions.long(), targets, weights, 1.0)
    assert loss.grad_fn.saved_tensors[1].dtype == torch.int32
    for _ in range(2):
        before = fl.fused_loss_bwd.launches
        (dq,) = torch.autograd.grad(loss, [q], retain_graph=True)
        torch.cuda.synchronize()
        assert fl.fused_loss_bwd.launches == before + 1
        assert torch.equal(_bits(dq), _bits(want))


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


@pytest.mark.gpu
def test_batched_policy_on_card_matches_qnet_on_card():
    """``BatchedPolicy`` on the card at the Pong preset's net (bf16 Nature
    CNN, 84×84×4, 4 actions) at every bucket: padding never leaks (real
    rows bitwise beside zero and random padding), Q within 2e-2 absolute
    of the port's ``QNet`` forward at batch 1 on the card (bf16 Q-values
    carry 8 significant bits, and cuDNN picks its algorithm per batch
    shape), actions equal wherever the top two Q-values differ by more
    than 4e-2; a second generation swapped in between forwards gives its
    own replies and leaves the installed one's unchanged."""
    import numpy as np

    from distributed_deep_q_tpu_torch.config import NetConfig
    from distributed_deep_q_tpu_torch.models.policy import BatchedPolicy
    from distributed_deep_q_tpu_torch.models.qnet import QNet

    dev = _need_card()
    tol = 2e-2
    net = NetConfig(kind="nature_cnn", num_actions=4,
                    compute_dtype="bfloat16")
    qnet = QNet(net, seed=0, device=dev)
    policy = BatchedPolicy(net, seed=1, buckets=(8, 32, 128, 256),
                           device=dev)
    policy.set_weights(qnet.get_weights())
    other = QNet(net, seed=2, device=dev)
    rng = np.random.default_rng(0)
    for bucket in policy.buckets:
        n = bucket - 3
        obs = rng.integers(0, 256, (bucket, 84, 84, 4), dtype=np.uint8)
        a_pad, q_pad = policy.forward(obs[:n])
        _, q_rand = policy.forward(obs)
        assert np.array_equal(q_rand[:n], q_pad)
        q_one = np.concatenate([qnet.forward(obs[i:i + 1])
                                for i in range(n)])
        assert np.abs(q_pad - q_one).max() <= tol
        top2 = np.sort(q_one, axis=-1)[:, -2:]
        sure = top2[:, 1] - top2[:, 0] > 2 * tol
        assert np.array_equal(a_pad[sure], q_one[sure].argmax(-1))
        gen = policy.unflatten(other.get_weights())
        _, q_other = policy.forward(obs[:n], params=gen)
        assert np.abs(q_other - other.forward(obs[:n])).max() <= tol
        assert np.array_equal(policy.forward(obs[:n])[1], q_pad)
    assert policy.compiled_buckets() == [8, 32, 128, 256]
    torch.cuda.synchronize()
