"""Share of the traced window in which no operation ran on the device, in
percent: 1 - busy / window, from `torch.profiler`'s device events merged
where they overlap. Layer: device."""
from __future__ import annotations


def read(ctx):
    t = ctx.trace
    if t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
