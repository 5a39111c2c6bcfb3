"""Seconds from the process's start to the first timed round: import,
kernel builds, weights, a step at each warm batch size and one untimed
round."""


def read(ctx):
    return ctx.setup_s
