"""YoutubeDNN, inference only (mirrors `repro/models/recsys.py`).

The paper's own workload: YoutubeDNN on MovieLens-1M. Parameters are a
plain dict of tensors with the reference's layout (see
`convert.params_from_numpy`): ``tables`` {feature: (cardinality, 32)},
``item_table`` (n_items, 32), ``genre_table`` (18, 32), and the two MLPs
``filter_mlp`` (192 -> 128 -> 64 -> 32) and ``rank_mlp`` (128 -> 128 -> 1)
as lists of {"w": (a, b), "b": (b,)}.
"""
from __future__ import annotations

from typing import Mapping, NamedTuple

import torch

EMBED_DIM = 32  # the paper's ET dimension (32 x int8 = one 256-bit CMA row)


def _mlp_apply(layers, x, final_act=False):
    """x @ w + b per layer with ReLU between layers (full float32)."""
    for i, p in enumerate(layers):
        x = x @ p["w"] + p["b"]
        if i < len(layers) - 1 or final_act:
            x = torch.relu(x)
    return x


class YoutubeDNNConfig(NamedTuple):
    n_items: int = 3000
    user_features: Mapping[str, int] = None  # name -> cardinality
    history_len: int = 20
    filter_dims: tuple = (128, 64, 32)  # paper Table I
    rank_dims: tuple = (128, 1)
    embed_dim: int = EMBED_DIM


def default_youtubednn_config() -> YoutubeDNNConfig:
    """The MovieLens-1M configuration of the paper (Table I)."""
    return YoutubeDNNConfig(
        user_features={
            "user_id": 6040, "gender": 3, "age": 7, "occupation": 21,
            "zip_bucket": 250,
        },
    )
