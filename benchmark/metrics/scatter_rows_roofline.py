"""B2 (``scatter_rows``, ``ops/ring_gather.py``): the bytes of the rows
that landed in the ring during the traced stretch (read between its two
synchronizes, under the writers' lock) over the HBM peak, against the
device time of every B2 launch in the stretch."""

KERNEL = "scatter_rows_kernel"


def read(ctx):
    st = ctx.out.stretch
    rows = ctx.out.stretch_landed[1] - ctx.out.stretch_landed[0]
    times = st.kernel_times(KERNEL) if st is not None else []
    if not times or rows <= 0:
        return None
    need = rows * ctx.counts.scatter_bytes_per_row(ctx.cfg) / \
        ctx.peaks.HBM_BYTES_PER_S
    return 100.0 * need / sum(times)
