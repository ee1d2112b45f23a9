"""Share of the block summary's blocks that the pruned streaming scan
admitted: `nns.blocks_touched` summed over the window's queries, over
queries x summary blocks (the program's counters). Nothing to read where
the scan is dense or unpruned. Layer: NNS."""
from __future__ import annotations


def read(ctx):
    blocks = ctx.system.summary_blocks
    if "blocks" not in ctx.counters or not blocks or not ctx.window.queries:
        return None
    return ctx.counters["blocks"] / (ctx.window.queries * blocks)
