"""Service-steps executed in the window over the window's seconds: one
DDIM step of one image, or one decode token of one request."""


def read(ctx):
    return sum(len(b[0]) for log in ctx.rounds for b in log.batches) \
        / ctx.window_s
