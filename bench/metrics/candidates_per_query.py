"""Items within the radius a query, the mean of `ServeResult.nns.counts`
over the window's queries (the program's counter). Layer: NNS."""
from __future__ import annotations


def read(ctx):
    if not ctx.window.queries:
        return None
    return ctx.counters["matches"] / ctx.window.queries
