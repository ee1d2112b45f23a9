"""Device milliseconds a traced batch of the operations launched inside the
program's `nns.dense.select` span: the dense plan's selection after the
Hamming kernel (the masks, the counts, the stable sort of the masked
distances and the slice to the first candidates). From
`bench/program_spans.py`'s profiled run (by launch, not by overlap), over
the `serve` spans of its window; None where the span recorded no device time
(no card, another plan, or a program without the span). Layer: nns."""
from __future__ import annotations

from bench import program_spans

SPAN = "nns.dense.select"


def read(ctx):
    return program_spans.span_times(ctx).device_ms(SPAN)
