"""Host milliseconds a denoising batch takes, from the loop's call into
the session to its return (which synchronizes), over every batch."""


def read(ctx):
    spans = [b[2] - b[1] for log in ctx.rounds for b in log.batches]
    return 1e3 * sum(spans) / len(spans) if spans else None
