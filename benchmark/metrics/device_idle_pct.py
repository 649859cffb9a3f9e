"""The share of the traced stretch in which no kernel, copy or fill ran
on the card (the profiler's device events, their union against the
stretch's host-clock length)."""


def read(ctx):
    st = ctx.out.stretch
    if st is None or st.window_s() <= 0:
        return None
    return 100.0 * (1.0 - st.busy_s() / st.window_s())
