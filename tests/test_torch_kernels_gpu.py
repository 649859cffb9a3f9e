"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test carries the ``gpu`` marker and skips inside the test where
``torch.cuda.is_available()`` is false. This file imports neither jax nor
the reference package, so it also runs where only the port's dependencies
are installed (the repository's conftest imports jax; skip it there):

    python -m pytest -m gpu --noconftest tests/test_torch_kernels_gpu.py
"""

import pytest
import torch

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
