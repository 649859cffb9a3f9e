"""Row-copy kernels for the flat frame ring, and their plain versions.

The fused prioritized replay keeps its pixels in ONE flat int32 tensor:
pixel bytes packed 4 per element (little-endian, so ``uint8 ⇄ int32``
views round-trip), each frame row padded to ``rowb`` bytes, a multiple of
4096 — the reference's TPU tiling, kept so that ring bytes compare with the
reference one for one. Ghost rows make every sample's stack+n_step window
one contiguous run of rows (replay/device_per.py), so both operations are
indexed copies of contiguous runs:

- ``gather_windows`` — ``n`` windows of ``w`` rows out of the ring (the
  fused sampler's obs + next-obs pixels, once per dispatch).
- ``scatter_rows``   — staged rows into the ring at row indices, in place
  (the replay flush).

Each wrapper takes its plain PyTorch version for a tensor on the CPU and
launches its CUDA kernel (``csrc/ring_gather.cu``, built for ``sm_90a`` at
first use) for a tensor on the card; any other device raises. The kernel
path counts its launches in ``gather_windows.launches`` /
``scatter_rows.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from distributed_deep_q_tpu_torch.ops.cuda_build import Entry

# rows are padded to whole 4096-byte blocks (the reference's 1024-element
# int32 tile; on the card it keeps every row 16-byte aligned)
I32_TILE = 1024


def padded_row_bytes(row_len: int) -> int:
    """Smallest 4096-byte-aligned row stride (BYTES) holding ``row_len``
    pixel bytes."""
    return -(-row_len // (4 * I32_TILE)) * (4 * I32_TILE)


def _check_i32(name: str, t: torch.Tensor, numel: int | None = None):
    if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 1-D int32 tensor, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if numel is not None and t.numel() != numel:
        raise ValueError(f"{name} has {t.numel()} elements, expected {numel}")


def _check_rowb(rowb: int) -> None:
    if rowb <= 0 or rowb % 16:
        raise ValueError(f"rowb={rowb} must be a positive multiple of 16")


def _same_device(*ts: torch.Tensor) -> torch.device:
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError(f"tensors on different devices: "
                         f"{[str(t.device) for t in ts]}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _check_aligned(*ts: torch.Tensor) -> None:
    """The kernels move 16 bytes per access."""
    for t in ts:
        if t.data_ptr() % 16:
            raise ValueError("ring/staged storage must be 16-byte aligned")


_P, _I64 = ctypes.c_void_p, ctypes.c_longlong
_GATHER = Entry("ring_gather", "ddq_gather_windows",
                [_P, _P, _P, _I64, _I64, _I64, _I64])
_SCATTER = Entry("ring_gather", "ddq_scatter_rows",
                 [_P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64])


# -- plain versions (the CPU path, and the card's reference) ----------------


def gather_windows_plain(idx: torch.Tensor, ring: torch.Tensor, *, n: int,
                         w: int, rowb: int) -> torch.Tensor:
    """``ring.view(-1, rowp)[idx[:, None] + arange(w)]``, flattened."""
    rowp = rowb // 4
    rows = idx.long()[:, None] + torch.arange(w, device=idx.device)
    return ring.view(-1, rowp)[rows].reshape(-1)


def scatter_rows_plain(src_idx: torch.Tensor, dst_idx: torch.Tensor,
                       staged: torch.Tensor, ring: torch.Tensor, *, n: int,
                       rowb: int, skip_row: int | None = None
                       ) -> torch.Tensor:
    """``ring.view(-1, rowp)[dst] = staged.view(-1, rowp)[src]``, in place.
    It writes every lane, as the reference does; ``skip_row`` is accepted
    and ignored (the skipped row's contents are unspecified either way)."""
    rowp = rowb // 4
    ring.view(-1, rowp)[dst_idx.long()] = staged.view(-1, rowp)[src_idx.long()]
    return ring


# -- wrappers ----------------------------------------------------------------


def gather_windows(idx: torch.Tensor, ring: torch.Tensor, *, n: int, w: int,
                   rowb: int) -> torch.Tensor:
    """Copy ``n`` contiguous ``w``-row windows out of the flat ring.

    ``idx`` [n] int32 — window-start ROW indices (callers keep ``idx + w``
    inside the ring: the ghost rows guarantee it); ``ring`` [S] int32;
    ``rowb`` the row stride in BYTES. Returns ``[n · w · rowb/4]`` int32.
    """
    _check_rowb(rowb)
    _check_i32("idx", idx, n)
    _check_i32("ring", ring)
    rowp = rowb // 4
    if ring.numel() % rowp:
        raise ValueError(f"ring of {ring.numel()} int32 is not whole rows of "
                         f"{rowp}")
    dev = _same_device(idx, ring)
    if dev.type == "cpu":
        return gather_windows_plain(idx, ring, n=n, w=w, rowb=rowb)
    _check_aligned(ring)
    out = torch.empty(n * w * rowp, dtype=torch.int32, device=dev)
    err = _GATHER(dev, idx.data_ptr(), ring.data_ptr(), out.data_ptr(), n, w,
                  rowb, ring.numel() // rowp)
    if err:
        raise RuntimeError(f"gather_windows kernel launch failed: CUDA "
                           f"error {err}")
    gather_windows.launches += 1
    return out


def scatter_rows(src_idx: torch.Tensor, dst_idx: torch.Tensor,
                 staged: torch.Tensor, ring: torch.Tensor, *, n: int,
                 rowb: int, skip_row: int | None = None) -> torch.Tensor:
    """Write ``n`` rows ``staged[src_idx[k]] → ring[dst_idx[k]]`` (row
    units; ``staged``/``ring`` flat int32, ``rowb`` in BYTES), in place on
    ``ring``, which is returned.

    ``src_idx`` decouples lane from source row, so ghost rows re-send the
    same staged bytes to their mirror target. Padding lanes point at the
    ring's scratch row, whose contents are unspecified; distinct REAL
    targets within one call are the caller's invariant. ``skip_row``, the
    scratch row's index, lets the kernel skip those lanes without moving a
    byte; the plain version ignores it.
    """
    _check_rowb(rowb)
    _check_i32("src_idx", src_idx, n)
    _check_i32("dst_idx", dst_idx, n)
    _check_i32("staged", staged)
    _check_i32("ring", ring)
    rowp = rowb // 4
    if ring.numel() % rowp or staged.numel() % rowp:
        raise ValueError("ring and staged must hold whole rows of "
                         f"{rowp} int32")
    ring_rows = ring.numel() // rowp
    if skip_row is not None:
        if isinstance(skip_row, bool) or not isinstance(skip_row, int):
            raise TypeError(f"skip_row must be an int row index, got "
                            f"{type(skip_row).__name__}")
        if not 0 <= skip_row < ring_rows:
            raise ValueError(f"skip_row={skip_row} is outside the ring's "
                             f"{ring_rows} rows")
    dev = _same_device(src_idx, dst_idx, staged, ring)
    if dev.type == "cpu":
        return scatter_rows_plain(src_idx, dst_idx, staged, ring, n=n,
                                  rowb=rowb)
    _check_aligned(staged, ring)
    err = _SCATTER(dev, src_idx.data_ptr(), dst_idx.data_ptr(),
                   staged.data_ptr(), ring.data_ptr(), n, rowb,
                   staged.numel() // rowp, ring_rows,
                   -1 if skip_row is None else skip_row)
    if err:
        raise RuntimeError(f"scatter_rows kernel launch failed: CUDA "
                           f"error {err}")
    scatter_rows.launches += 1
    return ring


gather_windows.launches = 0
scatter_rows.launches = 0
