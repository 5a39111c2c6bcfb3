"""Share of the traced window in which no operation ran on the card
while the innermost open program span was the planner's (``allocate``,
``plan``, ``validate``, ``loop.replan``): each idle gap split by the
program spans' own time (``harness/spans.py``)."""

from harness.spans import idle_pct_by_layer


def read(ctx):
    split = idle_pct_by_layer(ctx)
    return None if split is None else split["planner"]
