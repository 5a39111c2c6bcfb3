"""Sum over the window's decode steps of each step's least time on the
card (``counts/decode_step.py``), over the window's seconds."""


def read(ctx):
    step = ctx.counts("decode_step")
    total = 0.0
    for log in ctx.rounds:
        for cur in ctx.driver.cur_lens(log):
            total += step.bound_s(ctx.cfg, cur, ctx.traffic["max_len"])
    return 100.0 * total / ctx.window_s
