"""The whole grad step's share of the card's peak: the least time the card
could take for one grad step (``counts/<config>.py``'s FLOPs in each
precision the configuration states, each over its published dense peak,
``peaks.py``), over the window's seconds per grad step outside the traced
stretch."""


def read(ctx):
    steps, secs = ctx.out.outside
    if steps <= 0 or secs <= 0:
        return None
    ideal = sum(f / ctx.peaks.FLOPS[p] for p, f in ctx.flops.items())
    return 100.0 * ideal / (secs / steps)
