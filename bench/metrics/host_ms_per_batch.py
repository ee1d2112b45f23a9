"""Host milliseconds inside each `RecSysEngine.serve` call of the window
(host clock around the call; the call returns before the card finishes),
the mean over the window's batches. Layer: entry."""
from __future__ import annotations


def read(ctx):
    serve_s = [b.serve_s for b in ctx.window.landed]
    if not serve_s:
        return None
    return sum(serve_s) / len(serve_s) * 1e3
