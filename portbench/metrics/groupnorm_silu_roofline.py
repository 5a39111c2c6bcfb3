"""The least time of the ``groupnorm_silu`` calls the traced rounds
made (each batch's forward at its useful rows, ``counts``), over the
device time of that kernel's launches in the trace."""


def read(ctx):
    t = ctx.tracer
    if t is None:
        return None
    dev, n = t.kernel_seconds("groupnorm_silu")
    if n == 0 or dev <= 0:
        return None
    gn = ctx.counts("groupnorm_silu")
    bound = sum(gn.forward_bound_s(ctx.cfg, len(b[0]))
                for log in ctx.traced_rounds for b in log.batches
                if t.t0 <= b[1] and b[2] <= t.t1)
    return 100.0 * bound / dev
