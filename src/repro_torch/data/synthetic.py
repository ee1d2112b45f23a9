"""Deterministic synthetic datasets matching the paper's workloads.

A copy of `repro/data/synthetic.py` (numpy only): the same seeds give the
same arrays in both packages.

MovieLens-1M-like: 6040 users x 3000 items with latent-factor preference
structure, demographic features, and per-user watch histories; leave-one-out
test split (the YoutubeDNN HR evaluation protocol). Criteo-like: 13 dense +
26 categorical (28000 rows each) with a planted logistic CTR model.

Real MovieLens/Criteo are not available offline; generators keep the
cardinalities and marginal statistics so the mapping (Table I) and the
accuracy *ordering* (Sec. IV-B) are reproducible. See DESIGN.md §7.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class MovieLensSynth:
    n_users: int
    n_items: int
    user_feats: dict  # name -> (n_users,) int arrays
    histories: np.ndarray  # (n_users, H) item ids, -1 padded
    train_labels: np.ndarray  # (n_users,) next-item label for training
    test_labels: np.ndarray  # (n_users,) held-out item (leave-one-out)
    genres: np.ndarray  # (n_users,) favourite genre id
    item_factors: np.ndarray  # (n_items, d) ground-truth latents


def make_movielens(
    n_users: int = 6040,
    n_items: int = 3000,
    history_len: int = 20,
    latent_dim: int = 16,
    seed: int = 0,
) -> MovieLensSynth:
    rng = np.random.default_rng(seed)
    # latent structure: users cluster around genre archetypes
    n_genres = 18
    genre_centers = rng.normal(size=(n_genres, latent_dim))
    item_genre = rng.integers(0, n_genres, size=n_items)
    item_factors = genre_centers[item_genre] + 0.6 * rng.normal(
        size=(n_items, latent_dim))
    user_genre = rng.integers(0, n_genres, size=n_users)
    user_factors = genre_centers[user_genre] + 0.5 * rng.normal(
        size=(n_users, latent_dim))

    # per-user preference sampling (top-biased) -> watch history + labels.
    # history/train labels come from the NOISY preference order (diverse
    # watching); the held-out TEST label is the best CLEAN-score unseen item
    # — predictable from the latent structure (not memorizable from the
    # train label), which is what the HR protocol measures.
    scores = user_factors @ item_factors.T  # (U, I)
    noise = rng.gumbel(size=scores.shape) * 1.5
    order = np.argsort(-(scores + noise), axis=1)
    seq = order[:, : history_len + 1]
    histories = seq[:, :history_len].astype(np.int32)
    train_labels = seq[:, history_len].astype(np.int32)
    clean = scores.copy()
    np.put_along_axis(clean, seq, -np.inf, axis=1)  # exclude seen items
    test_labels = np.argmax(clean, axis=1).astype(np.int32)

    user_feats = {
        "user_id": np.arange(n_users, dtype=np.int32),
        "gender": rng.integers(0, 3, n_users).astype(np.int32),
        "age": rng.integers(0, 7, n_users).astype(np.int32),
        "occupation": rng.integers(0, 21, n_users).astype(np.int32),
        "zip_bucket": rng.integers(0, 250, n_users).astype(np.int32),
    }
    return MovieLensSynth(
        n_users=n_users, n_items=n_items, user_feats=user_feats,
        histories=histories, train_labels=train_labels,
        test_labels=test_labels, genres=user_genre.astype(np.int32),
        item_factors=item_factors,
    )


def serving_queries(data: MovieLensSynth, idx) -> list[dict]:
    """Single-user serving query dicts for users `idx` — the submit()
    schema of `serving.MicroBatcher` / `AsyncServer` (user feature scalars
    + history vector + genre). One definition so benchmarks and tests
    can't drift from the batcher's expected query layout."""
    return [{**{k: v[i] for k, v in data.user_feats.items()},
             "history": data.histories[i], "genre": data.genres[i]}
            for i in idx]


def movielens_batches(data: MovieLensSynth, batch_size: int, n_steps: int,
                      seed: int = 1):
    """Training batch iterator for the filtering model."""
    rng = np.random.default_rng(seed)
    for _ in range(n_steps):
        idx = rng.integers(0, data.n_users, batch_size)
        yield {
            **{k: v[idx] for k, v in data.user_feats.items()},
            "history": data.histories[idx],
            "genre": data.genres[idx],
            "label": data.train_labels[idx],
        }


def movielens_rank_batches(data: MovieLensSynth, batch_size: int,
                           n_cand: int, n_steps: int, seed: int = 2):
    """Ranking batches: candidates = 1 positive + sampled negatives."""
    rng = np.random.default_rng(seed)
    for _ in range(n_steps):
        idx = rng.integers(0, data.n_users, batch_size)
        neg = rng.integers(0, data.n_items, (batch_size, n_cand - 1))
        pos = data.train_labels[idx][:, None]
        cands = np.concatenate([pos, neg], axis=1).astype(np.int32)
        labels = np.zeros_like(cands)
        labels[:, 0] = 1
        perm = rng.permuted(np.arange(n_cand)[None].repeat(batch_size, 0),
                            axis=1)
        cands = np.take_along_axis(cands, perm, 1)
        labels = np.take_along_axis(labels, perm, 1)
        yield {
            **{k: v[idx] for k, v in data.user_feats.items()},
            "history": data.histories[idx],
            "genre": data.genres[idx],
            "cand_items": cands,
            "cand_labels": labels,
        }


# ---------------------------------------------------------------------------
# Criteo-like
# ---------------------------------------------------------------------------
def make_criteo_batches(
    batch_size: int,
    n_steps: int,
    n_dense: int = 13,
    n_sparse: int = 26,
    cardinality: int = 28000,
    seed: int = 0,
):
    """Planted logistic CTR model over dense + hashed categorical features."""
    rng = np.random.default_rng(seed)
    w_dense = rng.normal(size=n_dense) * 0.5
    cat_effect = rng.normal(size=(n_sparse, 64)) * 0.4  # low-rank cat effects
    for _ in range(n_steps):
        dense = rng.normal(size=(batch_size, n_dense)).astype(np.float32)
        sparse = rng.integers(
            0, cardinality, (batch_size, n_sparse)).astype(np.int32)
        logit = dense @ w_dense
        for j in range(n_sparse):
            logit += cat_effect[j, sparse[:, j] % 64]
        prob = 1.0 / (1.0 + np.exp(-(logit - 1.0)))
        label = (rng.random(batch_size) < prob).astype(np.int32)
        yield {"dense": dense, "sparse": sparse, "label": label}
