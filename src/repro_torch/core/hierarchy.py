"""Two-level hierarchical reduction — the iMARS adder trees
(mirrors `repro/core/hierarchy.py`).

Paper (Sec. III-A1): partial sums accumulate inside each CMA, then across
the CMAs of a mat, then across mats through a fan-in-4 intra-bank adder
tree, and blocks communicate over the RSC bus. Here a bank is a rank of a
mesh axis: each pools the ids in its row range (`bank_bag`, the pool
kernel), and the partials are summed across ranks, one axis after another
(`hierarchical_psum`), in the adder tree's fixed order (`tree_sum`).

Floating-point sums across ranks never go through `all_reduce`, which
fixes no order: the partials are all-gathered in rank order and
tree-summed on every rank, so every rank, and every run, gets the same
bits.
"""
from __future__ import annotations

import torch

from repro_torch.core.quantization import QuantizedTensor
from repro_torch.kernels import ops
from repro_torch.utils import all_gather_axis


def tree_sum(parts: torch.Tensor, fan_in: int = 4) -> torch.Tensor:
    """Deterministic fan-in-`fan_in` tree sum over axis 0 (adder-tree
    semantics): the parts, zero-padded to a multiple of `fan_in`, add in
    groups of `fan_in`, left to right within a group, level after level.
    The order is fixed by the shape alone, so the bits are the same on
    every device and in every run."""
    x = parts
    while x.shape[0] > 1:
        pad = (-x.shape[0]) % fan_in
        if pad:
            x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
        x = x.reshape((x.shape[0] // fan_in, fan_in) + tuple(x.shape[1:]))
        acc = x[:, 0]
        for j in range(1, fan_in):
            acc = acc + x[:, j]
        x = acc
    return x[0]


def hierarchical_psum(x: torch.Tensor, mesh, axes: tuple) -> torch.Tensor:
    """Level-by-level sum over the mesh axes `axes` (intra-bank before the
    RSC bus): at each level the partials of the axis' ranks are
    all-gathered in rank order and `tree_sum`med, and the next level sums
    those. Every rank returns the same bits."""
    for axis in axes:
        x = tree_sum(torch.stack(all_gather_axis(x, mesh, axis)))
    return x


def bank_bag(table: QuantizedTensor, ids: torch.Tensor, bank: int,
             weights: torch.Tensor | None = None) -> torch.Tensor:
    """One bank's partial bag: bank `bank` of equal banks holds `table`'s
    rows, global ids ``[bank * per_bank, (bank + 1) * per_bank)``; the ids
    of (B, L) `ids` (-1 padded, global) in that range pool through the
    pool kernel, the others read nothing -> (B, d) f32."""
    per_bank = table.values.shape[0]
    local = ids - bank * per_bank
    local = torch.where((ids >= 0) & (local >= 0) & (local < per_bank),
                        local, -1)
    return ops.embedding_pool(table.values, table.scales, local, weights)


def sharded_embedding_bag(
    mesh,  # torch.distributed DeviceMesh
    axis: str,
    table: QuantizedTensor,  # this rank's bank of the row-sharded table
    ids: torch.Tensor,  # (B, L) global ids, the same on every rank
    weights: torch.Tensor | None = None,
    extra_axes: tuple = (),
) -> torch.Tensor:
    """Row-sharded pooled lookup -> (B, d), the same on every rank: the
    rank's bank pools its ids (`bank_bag`), then the partial bags sum over
    `axis` and then `extra_axes` (`hierarchical_psum`)."""
    partial = bank_bag(table, ids, mesh.get_local_rank(axis), weights)
    return hierarchical_psum(partial, mesh, (axis,) + tuple(extra_axes))
