"""95th percentile (nearest rank) over every request in the window of
its end-to-end delay (harness clock from the round's start to its last
batch's end, plus its transmission) over its deadline."""

import math


def read(ctx):
    r = sorted(o["delay"] / o["deadline"] for o in ctx.outcomes)
    return r[max(0, math.ceil(0.95 * len(r)) - 1)]
