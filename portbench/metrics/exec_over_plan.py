"""Measured batch seconds over the seconds the plan's g(X) predicted
for them, summed over every batch the execution loop ran (its own
records)."""


def read(ctx):
    meas = sum(m for log in ctx.rounds for _, _, m in log.records)
    pred = sum(p for log in ctx.rounds for _, p, _ in log.records)
    return meas / pred if pred > 0 else None
