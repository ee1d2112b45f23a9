"""Device milliseconds a traced batch of the operations launched inside the
program's `serve.scan` span: the scan stage (`_scan_stage`: the LSH
signature of u and the filtering NNS, whichever plan ran). From
`bench/program_spans.py`'s profiled run (by launch, not by overlap), over
the `serve` spans of its window; None where the span recorded no device time
(no card, another plan, or a program without the span). Layer: serve step."""
from __future__ import annotations

from bench import program_spans

SPAN = "serve.scan"


def read(ctx):
    return program_spans.span_times(ctx).device_ms(SPAN)
