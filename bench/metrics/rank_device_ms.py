"""Device milliseconds a traced batch of the operations launched inside the
program's `serve.rank` span: the rank stage (`_rank_stage`: the candidate
rows' pool launch, the ranking MLP, the threshold top-k and the final
gather). From `bench/program_spans.py`'s profiled run (by launch, not by
overlap), over the `serve` spans of its window; None where the span recorded
no device time (no card, another plan, or a program without the span).
Layer: serve step."""
from __future__ import annotations

from bench import program_spans

SPAN = "serve.rank"


def read(ctx):
    return program_spans.span_times(ctx).device_ms(SPAN)
