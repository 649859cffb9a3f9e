"""Host milliseconds per grad step inside the learner's dispatch call
(``Solver.train_steps_device_per``): the seconds each window dispatch's
call took on the host clock, over its grad steps, outside the traced
stretch. Moves ``grad_steps_per_s`` where the host paces the card."""


def read(ctx):
    ds = ctx.out.dispatch_s
    if not ds:
        return None
    return 1e3 * sum(ds) / (len(ds) * ctx.chain)
