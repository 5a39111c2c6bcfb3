"""Host milliseconds of prefill in a decode batch that holds one: the
program's ``serving.prefill`` spans summed within each ``serving.decode``
span, mean over the traced batches that prefilled."""

from harness.spans import program_spans


def read(ctx):
    got = program_spans(ctx)
    if got is None:
        return None
    spans, inside = got
    per_batch = {}
    for i in inside:
        s = spans[i]
        if s.name == "serving.prefill":
            per_batch[s.parent] = per_batch.get(s.parent, 0.0) \
                + s.t1 - s.t0
    if not per_batch:
        return None
    return 1e3 * sum(per_batch.values()) / len(per_batch)
