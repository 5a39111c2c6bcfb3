"""Host milliseconds of a traced round that the execution loop's clock
never counts: the program's ``round`` span less its ``execute`` span's
``loop_clock_s`` (the sum of measured batch seconds, the clock of the
loop's deadline verdicts and replans), mean over the traced rounds."""

from harness.spans import program_spans


def read(ctx):
    got = program_spans(ctx)
    if got is None:
        return None
    spans, inside = got
    clock = {s.parent: s.attrs["loop_clock_s"] for s in spans
             if s.name == "execute" and "loop_clock_s" in s.attrs}
    out = [spans[i].t1 - spans[i].t0 - clock[i] for i in inside
           if spans[i].name == "round" and i in clock]
    return 1e3 * sum(out) / len(out) if out else None
