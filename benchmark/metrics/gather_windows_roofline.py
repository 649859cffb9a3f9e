"""B1 (``gather_windows``, ``ops/ring_gather.py``): the bytes one window
dispatch's launch needs (``counts/<config>.py``) over the HBM peak,
against its mean device time in the traced stretch."""

KERNEL = "gather_windows_kernel"


def read(ctx):
    st = ctx.out.stretch
    times = st.kernel_times(KERNEL) if st is not None else []
    if not times:
        return None
    need = ctx.counts.gather_bytes(ctx.cfg, ctx.chain) / \
        ctx.peaks.HBM_BYTES_PER_S
    return 100.0 * need / (sum(times) / len(times))
