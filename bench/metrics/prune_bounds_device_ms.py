"""Device milliseconds a traced batch of the operations launched inside the
program's `nns.stream.bounds` span: the pruned streaming plan's prune bounds
(`_prune_mask`: the block summary's lower bounds for every (query, block)
pair and the mask over them). From `bench/program_spans.py`'s profiled run
(by launch, not by overlap), over the `serve` spans of its window; None
where the span recorded no device time (no card, another plan, or a program
without the span). Layer: nns."""
from __future__ import annotations

from bench import program_spans

SPAN = "nns.stream.bounds"


def read(ctx):
    return program_spans.span_times(ctx).device_ms(SPAN)
