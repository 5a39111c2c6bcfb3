"""Mean over every request in the window of the quality model at the
steps it received, late or undelivered content scoring fid(0)."""


def read(ctx):
    return sum(o["fid"] for o in ctx.outcomes) / len(ctx.outcomes)
