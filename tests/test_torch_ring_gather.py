"""The frame-ring kernels' plain versions against the reference's Pallas
kernels (interpret mode on the CPU), bitwise. The CUDA kernels are held to
these plain versions on the card by ``tests/test_torch_kernels_gpu.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from distributed_deep_q_tpu.ops import ring_gather as ref_rg

from distributed_deep_q_tpu_torch.ops import ring_gather as rg

ROWB = 4096          # one 4096-byte row (a 36×36 or 52×52 frame, padded)
ROWP = ROWB // 4


def _ring(rows, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(-2**31, 2**31 - 1, rows * ROWP, dtype=np.int64
                        ).astype(np.int32)


def test_padded_row_bytes_matches_reference():
    for n in (1, 64, 1296, 2704, 4096, 4097, 7056):
        assert rg.padded_row_bytes(n) == ref_rg.padded_row_bytes(n)
    assert rg.padded_row_bytes(84 * 84) == 8192


@pytest.mark.parametrize("w", [4, 7])
def test_gather_windows_plain_matches_reference_kernel(w):
    rows, n = 40, 12
    ring = _ring(rows)
    idx = np.random.default_rng(1).integers(0, rows - w + 1, n).astype(
        np.int32)
    idx[0], idx[-1] = 0, rows - w            # first and last window
    want = np.asarray(ref_rg.gather_windows(
        jnp.asarray(idx), jnp.asarray(ring), n=n, w=w, rowb=ROWB,
        interpret=True))
    got = rg.gather_windows(torch.from_numpy(idx), torch.from_numpy(ring),
                            n=n, w=w, rowb=ROWB)
    assert got.dtype == torch.int32 and got.shape == (n * w * ROWP,)
    np.testing.assert_array_equal(got.numpy(), want)


def test_scatter_rows_plain_matches_reference_kernel():
    """A flush's lane layout: 8 staged rows, each sent to its main row;
    ghost lanes re-send rows 0..2 to their mirrors; the other ghost lanes
    and two padding lanes hit the scratch row (the ring's last row), which
    is excluded from the comparison (racing writes land there)."""
    rows, k = 30, 8
    scratch = rows - 1
    ring = _ring(rows, seed=2)
    staged = _ring(k, seed=3)
    main = np.arange(4, 4 + k, dtype=np.int32)
    main[-2:] = scratch                                  # padding lanes
    ghost = np.full(k, scratch, np.int32)
    ghost[:3] = 20 + np.arange(3)                        # mirror rows
    src = np.concatenate([np.arange(k), np.arange(k)]).astype(np.int32)
    dst = np.concatenate([main, ghost]).astype(np.int32)
    want = np.asarray(ref_rg.scatter_rows(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(staged),
        jnp.asarray(ring), n=2 * k, rowb=ROWB, interpret=True))
    t_ring = torch.from_numpy(ring.copy())
    out = rg.scatter_rows(torch.from_numpy(src), torch.from_numpy(dst),
                          torch.from_numpy(staged), t_ring, n=2 * k,
                          rowb=ROWB)
    assert out.data_ptr() == t_ring.data_ptr()          # in place
    np.testing.assert_array_equal(t_ring.numpy()[:-ROWP], want[:-ROWP])
    # the ghost mirrors carry the same bytes as their main rows
    r2 = t_ring.numpy().reshape(rows, ROWP)
    np.testing.assert_array_equal(r2[20:23], r2[4:7])


def test_scatter_rows_validates_skip_row_and_plain_ignores_it():
    """``skip_row`` must be an int row of the ring; on the CPU the plain
    version writes every lane, the skipped row included, as the reference
    kernel does."""
    rows, k = 12, 4
    ring = torch.from_numpy(_ring(rows, seed=4))
    staged = torch.from_numpy(_ring(k, seed=5))
    src = torch.arange(k, dtype=torch.int32)
    dst = torch.tensor([2, 5, rows - 1, rows - 1], dtype=torch.int32)
    for bad, err in ((rows, ValueError), (-1, ValueError),
                     (2.0, TypeError), (True, TypeError),
                     (np.int64(3), TypeError)):
        with pytest.raises(err, match="skip_row"):
            rg.scatter_rows(src, dst, staged, ring.clone(), n=k, rowb=ROWB,
                            skip_row=bad)
    skipped = rg.scatter_rows(src, dst, staged, ring.clone(), n=k,
                              rowb=ROWB, skip_row=rows - 1)
    plain = rg.scatter_rows_plain(src, dst, staged, ring.clone(), n=k,
                                  rowb=ROWB)
    assert torch.equal(skipped, plain)
    r2 = skipped.view(rows, ROWP)
    assert torch.equal(r2[rows - 1], staged.view(k, ROWP)[3])
    assert torch.equal(r2[5], staged.view(k, ROWP)[1])


def test_wrappers_reject_bad_inputs():
    ring = torch.zeros(4 * ROWP, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        rg.gather_windows(torch.zeros(2, dtype=torch.int64), ring, n=2, w=2,
                          rowb=ROWB)
    with pytest.raises(ValueError, match="elements"):
        rg.gather_windows(torch.zeros(3, dtype=torch.int32), ring, n=2, w=2,
                          rowb=ROWB)
    with pytest.raises(ValueError, match="multiple of 16"):
        rg.gather_windows(torch.zeros(2, dtype=torch.int32), ring, n=2, w=2,
                          rowb=4100)
    with pytest.raises(ValueError, match="whole rows"):
        rg.scatter_rows(torch.zeros(1, dtype=torch.int32),
                        torch.zeros(1, dtype=torch.int32),
                        torch.zeros(ROWP + 1, dtype=torch.int32), ring, n=1,
                        rowb=ROWB)


def test_cpu_path_does_not_count_launches():
    before = (rg.gather_windows.launches, rg.scatter_rows.launches)
    ring = torch.from_numpy(_ring(8))
    rg.gather_windows(torch.tensor([0, 3], dtype=torch.int32), ring, n=2,
                      w=2, rowb=ROWB)
    assert (rg.gather_windows.launches, rg.scatter_rows.launches) == before
