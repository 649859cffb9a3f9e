"""The mean milliseconds the learner holds the writers' lock per window
dispatch, outside the traced stretch: the feed's lock as the learner
takes it."""


def read(ctx):
    hold = ctx.out.lock_hold_s
    if ctx.out.writers is None or not hold:
        return None
    return 1e3 * sum(hold) / len(hold)
