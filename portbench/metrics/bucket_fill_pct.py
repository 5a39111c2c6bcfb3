"""Useful rows over launched rows of the traced rounds' padded batches:
the sum of ``rows`` over the sum of ``bucket`` of the program's
``engine.batch`` spans (a multi-step chunk counted once a step)."""

from harness.spans import window_spans


def read(ctx):
    spans = window_spans(ctx, "engine.batch")
    if not spans:
        return None
    rows = sum(s.attrs["rows"] * s.attrs.get("steps", 1) for s in spans)
    bucket = sum(s.attrs["bucket"] * s.attrs.get("steps", 1)
                 for s in spans)
    return 100.0 * rows / bucket
