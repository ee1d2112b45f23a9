"""Share of the embedding lookups served from the hot rows, in percent:
`ServeResult.stats` hits over lookups, summed over the window (the
program's counters). Layer: embedding lookup."""
from __future__ import annotations


def read(ctx):
    lookups = ctx.counters.get("lookups", 0)
    if not lookups:
        return None
    return 100.0 * ctx.counters["hits"] / lookups
