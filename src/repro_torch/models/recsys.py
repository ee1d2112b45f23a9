"""The paper's two RecSys instances (mirrors `repro/models/recsys.py`):
YoutubeDNN (filtering + ranking) and Facebook DLRM (ranking).

Parameters are a plain dict of tensors with the reference's layout (see
`convert.params_from_numpy`). YoutubeDNN: ``tables`` {feature:
(cardinality, 32)}, ``item_table`` (n_items, 32), ``genre_table`` (18, 32),
and the two MLPs ``filter_mlp`` (192 -> 128 -> 64 -> 32) and ``rank_mlp``
(128 -> 128 -> 1) as lists of {"w": (a, b), "b": (b,)}. DLRM: ``tables``
{"cat_00" ... "cat_25": (cardinality, 32)}, ``bottom`` (13 -> 256 -> 128
-> 32) and ``top`` (383 -> 256 -> 64 -> 1).

Training runs on the dense float32 tables; the losses are plain functions
of the parameter dict, differentiated with `torch.autograd`
(`distributed.training.value_and_grad`, as the reference differentiates
them with `jax.value_and_grad`). Serving quantizes every table to int8
(`serving/recsys_engine.py`). Gathers clamp out-of-range ids as JAX's do
(negative ids count from the end first); torch would raise.

The gradient of a table gather is a sorted segment sum
(`layers.gather_rows`): each row's gradient adds up the rows of its ids in
their batch order, one sequential sum a row, on the CPU as on the card.
PyTorch's own backward of `table[ids]` accumulates duplicates with a
parallel scatter on the CPU, in an order that varies from run to run, and
a training restart must repeat bit for bit.
"""
from __future__ import annotations

from typing import Mapping, NamedTuple

import torch

from repro_torch.models.layers import gather_rows
from repro_torch.utils import resolve_device

EMBED_DIM = 32  # the paper's ET dimension (32 x int8 = one 256-bit CMA row)
N_GENRES = 18


def _ids(ids: torch.Tensor, n: int) -> torch.Tensor:
    """Gather ids into a length-`n` axis with JAX's semantics: negative
    ids wrap once, then every id clamps into [0, n)."""
    ids = ids.long()
    return torch.where(ids < 0, ids + n, ids).clamp(0, n - 1)


def _take(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """`table[ids]` with JAX's gather semantics (`_ids`)."""
    return gather_rows(table, _ids(ids, table.shape[0]))


def _normal(generator: torch.Generator, shape, scale: float,
            device: torch.device) -> torch.Tensor:
    """scale * N(0, 1) of `shape`, drawn on the generator's device."""
    x = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    return (scale * x).to(device)


def _mlp_init(generator: torch.Generator, dims, device: torch.device,
              dtype=torch.float32) -> list:
    """`a**-0.5` * N(0, 1) weights and zero biases, layer by layer."""
    return [{"w": _normal(generator, (a, b), a ** -0.5, device).to(dtype),
             "b": torch.zeros((b,), dtype=dtype, device=device)}
            for a, b in zip(dims[:-1], dims[1:])]


def _mlp_apply(layers, x, final_act=False):
    """x @ w + b per layer with ReLU between layers (full float32)."""
    for i, p in enumerate(layers):
        x = x @ p["w"] + p["b"]
        if i < len(layers) - 1 or final_act:
            x = torch.relu(x)
    return x


def _bce_with_logits(logits: torch.Tensor, labels: torch.Tensor):
    """Mean stable binary cross-entropy, written as the reference writes
    it: max(x, 0) - x y + log1p(exp(-|x|))."""
    y = labels.to(torch.float32)
    return torch.mean(torch.clamp(logits, min=0) - logits * y
                      + torch.log1p(torch.exp(-torch.abs(logits))))


# ---------------------------------------------------------------------------
# YoutubeDNN
# ---------------------------------------------------------------------------
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


def init_youtubednn(generator: torch.Generator, cfg: YoutubeDNNConfig,
                    device=None) -> dict:
    """Random YoutubeDNN parameters on `device` (default `cuda`): tables
    0.05 * N(0, 1), MLP weights `a**-0.5` * N(0, 1), zero biases, the
    reference's shapes. Drawn from `generator` (on its own device) in a
    fixed order: the feature tables by sorted name, the item table, the
    genre table, the filtering MLP, the ranking MLP. `jax.random` draws
    cannot be reproduced, so parity runs carry the reference's across."""
    device = resolve_device(device)
    d = cfg.embed_dim
    p = {"tables": {name: _normal(generator, (card, d), 0.05, device)
                    for name, card in sorted(cfg.user_features.items())}}
    p["item_table"] = _normal(generator, (cfg.n_items, d), 0.05, device)
    # ranking-only UIET (genre) — Table I: 6 ranking UIETs, 5 shared
    p["genre_table"] = _normal(generator, (N_GENRES, d), 0.05, device)
    n_feats = len(cfg.user_features) + 1  # + pooled history
    p["filter_mlp"] = _mlp_init(generator, (n_feats * d,) + cfg.filter_dims,
                                device)
    # ranking input: user emb (32) + item emb (32) + genre (32) + ctx -> 128
    p["rank_mlp"] = _mlp_init(generator, (4 * d,) + cfg.rank_dims, device)
    return p


def _pooled_history(p, batch: dict) -> torch.Tensor:
    """Mean of the history's item rows; -1 slots read no row."""
    hist = batch["history"]  # (B, H) item ids, -1 padded
    valid = (hist >= 0).to(torch.float32)
    rows = _take(p["item_table"], hist.clamp(min=0)) * valid[..., None]
    return rows.sum(1) / valid.sum(1, keepdim=True).clamp(min=1.0)


def user_tower(p, cfg: YoutubeDNNConfig, batch: dict) -> torch.Tensor:
    """Filtering stage DNN on the float32 tables: the user embedding u_i
    (B, 32), as the reference's `user_tower` (no quantization, no cache)."""
    feats = [_take(p["tables"][name], batch[name])  # (B, d)
             for name in sorted(cfg.user_features.keys())]
    feats.append(_pooled_history(p, batch))
    x = torch.cat(feats, dim=-1)
    return _mlp_apply(p["filter_mlp"], x)


def filtering_loss(p, cfg: YoutubeDNNConfig, batch: dict) -> torch.Tensor:
    """Full softmax over the item vocabulary against the next-watched item
    (``label``): a 0-d tensor."""
    u = user_tower(p, cfg, batch)  # (B, d)
    logits = u @ p["item_table"].T  # (B, n_items)
    logp = torch.log_softmax(logits, dim=-1)
    label = _ids(batch["label"], logp.shape[1])
    return -torch.mean(logp.gather(1, label[:, None])[:, 0])


def rank_tower(p, cfg: YoutubeDNNConfig, batch: dict,
               item_ids: torch.Tensor) -> torch.Tensor:
    """Ranking stage: CTR logits for each (user, candidate) pair.

    item_ids: (B, N) candidate ids. Returns (B, N) logits.
    """
    u = user_tower(p, cfg, batch)  # (B, d)
    items = _take(p["item_table"], item_ids)  # (B, N, d)
    genre = _take(p["genre_table"], batch["genre"])  # (B, d)
    pooled = _pooled_history(p, batch)
    B, N = item_ids.shape
    ctx = torch.cat([u, genre, pooled], dim=-1)  # (B, 3d)
    x = torch.cat([ctx[:, None].expand(B, N, ctx.shape[-1]), items], -1)
    return _mlp_apply(p["rank_mlp"], x)[..., 0]  # (B, N)


def ranking_loss(p, cfg: YoutubeDNNConfig, batch: dict) -> torch.Tensor:
    """BCE of the candidates' CTR logits against their clicks."""
    logits = rank_tower(p, cfg, batch, batch["cand_items"])  # (B, N)
    return _bce_with_logits(logits, batch["cand_labels"])


# ---------------------------------------------------------------------------
# DLRM (ranking on Criteo)
# ---------------------------------------------------------------------------
class DLRMConfig(NamedTuple):
    n_dense: int = 13
    n_sparse: int = 26
    cardinality: int = 28000  # rows per ET (Table I)
    embed_dim: int = EMBED_DIM
    bottom_dims: tuple = (256, 128, 32)  # paper Table I
    top_dims: tuple = (256, 64, 1)


def init_dlrm(generator: torch.Generator, cfg: DLRMConfig,
              device=None) -> dict:
    """Random DLRM parameters on `device` (default `cuda`), the
    reference's shapes and scales; drawn in the order tables (cat_00 ...),
    bottom MLP, top MLP."""
    device = resolve_device(device)
    tables = {f"cat_{i:02d}": _normal(
        generator, (cfg.cardinality, cfg.embed_dim), 0.05, device)
        for i in range(cfg.n_sparse)}
    n_vec = cfg.n_sparse + 1
    n_inter = n_vec * (n_vec - 1) // 2
    return {
        "tables": tables,
        "bottom": _mlp_init(generator, (cfg.n_dense,) + cfg.bottom_dims,
                            device),
        "top": _mlp_init(generator,
                         (n_inter + cfg.bottom_dims[-1],) + cfg.top_dims,
                         device),
    }


def dlrm_forward(p, cfg: DLRMConfig, batch: dict) -> torch.Tensor:
    """batch: dense (B, 13), sparse (B, 26) int -> CTR logits (B,)."""
    dense = _mlp_apply(p["bottom"], batch["dense"], final_act=True)  # (B, 32)
    sparse = batch["sparse"]
    embs = [_take(p["tables"][f"cat_{i:02d}"], sparse[:, i])
            for i in range(cfg.n_sparse)]
    vecs = torch.stack([dense] + embs, dim=1)  # (B, 27, 32)
    inter = torch.einsum("bid,bjd->bij", vecs, vecs)  # pairwise dots
    # row-major upper triangle: jnp.triu_indices(27, k=1)'s pair order
    iu, ju = torch.triu_indices(vecs.shape[1], vecs.shape[1], offset=1,
                                device=vecs.device)
    flat = inter[:, iu, ju]  # (B, 351)
    x = torch.cat([flat, dense], dim=-1)
    return _mlp_apply(p["top"], x)[..., 0]


def dlrm_loss(p, cfg: DLRMConfig, batch: dict) -> torch.Tensor:
    """BCE of the CTR logits against ``label``."""
    return _bce_with_logits(dlrm_forward(p, cfg, batch), batch["label"])
