"""Host milliseconds in the allocator and the scheduler (first plans
and replans) over the window, per round."""


def read(ctx):
    s = sum(c.t1 - c.t0 for log in ctx.rounds for c in log.calls)
    return 1e3 * s / len(ctx.rounds)
