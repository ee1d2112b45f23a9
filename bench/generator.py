"""The traffic generator: one pool of request batches from a mix's
parameters and the seed, made on the device in a few calls.

A mix file (`traffic/<name>.json`) holds, besides the loop's own keys
(`loop` names `loops/<loop>.py`, which reads the rest):

- ``batch``: queries a batch; ``pool_batches``: batches in the pool;
- ``prefixes``: ``ratings``, ``users`` and ``min_ratings`` of the rating
  log whose history prefixes are scored (MovieLens-1M's published counts:
  1,000,209 ratings by 6,040 users, each with at least 20);
- ``population``: the data model's parameters, ``latent_dim``,
  ``item_spread``, ``user_spread`` and ``noise``; ``id_feature``, the user
  feature that holds the user's own id; and ``seed``, the population's
  own.

**Queries.** Bulk scoring recomputes a user's candidates and top-k after
each of its ratings, from the last `history_len` (H) items it rated. A user
with n >= H - 1 ratings so sends one query with each history length 1..H-1
and n - (H - 1) with all H items; over the log, a length below H has the
share users / ratings and H the rest (88.5% for MovieLens-1M and H = 20).
Every batch holds these lengths in these shares, rounded; the user of each
query is drawn uniformly.

**Users.** Their histories, features and genres follow the repo's own
MovieLens-1M data model, a frozen copy of the latent structure of
`src/repro/data/synthetic.py` `make_movielens` (not imported: the yardstick
does not move when that module does): one latent centre a genre, items and
users scattered around their genre's centre, a user's history the first H
items of its preference order with Gumbel noise (scores + noise * Gumbel),
its genre its centre's, its id feature its own index and every other
feature uniform over its cardinality. The data model holds H items a user,
so a user's full-length queries all carry the same H items, and a shorter
one their first items.

The population and the pool's queries are one draw, from the mix's own
seed, as the weights are from the configuration's; the run's seed orders
them: which batch comes when, and the queries within each. Every seed so
serves the same queries, and the scan the same work. Populations drawn
for each seed made the streaming scan's time differ by up to 3% from seed
to seed, and so did users drawn for each seed from one population.

The pool is made once in set-up, copied to the host once and cycled by the
loop, so nothing is generated beside the window.
"""
from __future__ import annotations

import numpy as np
import torch

# a different stream from the one the weights draw from the same seed
_STREAM = 0x7AFF1C
# float32 elements of one block of (user, item) preference scores
_BLOCK_ELEMS = 1 << 24


def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        (int(seed) ^ _STREAM) & (2**64 - 1))


def prefix_lengths(traffic: dict, history_len: int, batch: int) -> np.ndarray:
    """The history lengths of one batch, in ascending order: each length's
    share of the rating log's prefixes times `batch`, rounded so that they
    sum to `batch` (largest remainders first)."""
    r = traffic["prefixes"]
    h = history_len
    if r["min_ratings"] < h - 1:
        raise ValueError("a user with fewer than history_len - 1 ratings "
                         "has no query of some lengths")
    share = np.full(h, r["users"] / r["ratings"])
    share[-1] = 1.0 - (h - 1) * share[0]
    exact = share * batch
    counts = np.floor(exact).astype(np.int64)
    rest = np.argsort(-(exact - counts), kind="stable")
    counts[rest[:batch - counts.sum()]] += 1
    return np.repeat(np.arange(1, h + 1), counts)


def population(cfg: dict, traffic: dict, gen, device) -> dict:
    """The data model's users on `device`: each one's features, genre and
    (users, H) history of item ids."""
    p, n_users = traffic["population"], traffic["prefixes"]["users"]
    n_items, h = cfg["n_items"], cfg["history_len"]

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device)

    def uniform_ids(card: int, n: int):
        return torch.randint(0, card, (n,), generator=gen, device=device)

    centres = normal(cfg["n_genres"], p["latent_dim"])
    items = (centres[uniform_ids(cfg["n_genres"], n_items)]
             + p["item_spread"] * normal(n_items, p["latent_dim"]))
    genre = uniform_ids(cfg["n_genres"], n_users)
    users = centres[genre] + p["user_spread"] * normal(n_users,
                                                       p["latent_dim"])
    history = torch.empty((n_users, h), dtype=torch.int64, device=device)
    step = max(1, _BLOCK_ELEMS // n_items)
    for lo in range(0, n_users, step):
        score = users[lo:lo + step] @ items.T
        u = torch.rand(score.shape, generator=gen, device=device)
        score -= p["noise"] * torch.log(-torch.log(u.clamp_(min=1e-30)))
        history[lo:lo + step] = torch.topk(score, h, dim=1).indices
        del score, u
    feats = {}
    for name, card in sorted(cfg["user_features"].items()):
        if name == p["id_feature"]:
            feats[name] = torch.arange(n_users, device=device) % card
        else:
            feats[name] = uniform_ids(card, n_users)
    return {"features": feats, "genre": genre, "history": history}


def make_pool(cfg: dict, traffic: dict, seed: int, device) -> list[dict]:
    """The mix's pool of `pool_batches` batches (int32 numpy arrays on the
    host), made on `device`, in the order that `seed` draws."""
    mix = _generator(traffic["population"]["seed"], device)
    people = population(cfg, traffic, mix, device)
    n_users = traffic["prefixes"]["users"]
    b, nb, h = traffic["batch"], traffic["pool_batches"], cfg["history_len"]

    def perms(gen, n: int, k: int):
        return torch.stack([torch.randperm(n, generator=gen, device=device)
                            for _ in range(k)])

    lengths = torch.from_numpy(prefix_lengths(traffic, h, b)).to(device)
    length = lengths[perms(mix, b, nb)]  # (nb, b)
    who = torch.randint(0, n_users, (nb, b), generator=mix, device=device)
    gen = _generator(seed, device)
    at = perms(gen, nb, 1)[0]
    within = perms(gen, b, nb)
    length = length[at].gather(1, within)
    who = who[at].gather(1, within)
    hist = people["history"][who]  # (nb, b, h)
    hist[torch.arange(h, device=device) >= length[..., None]] = -1
    pool = {name: f[who] for name, f in people["features"].items()}
    pool["history"] = hist
    pool["genre"] = people["genre"][who]
    host = {k: v.to(torch.int32).cpu().numpy() for k, v in pool.items()}
    return [{k: v[i] for k, v in host.items()} for i in range(nb)]


def id_frequencies(pool: list[dict], key: str, n: int) -> np.ndarray:
    """How often each of `n` ids appears under `key` in the pool (padding
    ids, -1, left out): the traffic's own frequencies, from which the
    engine picks its hot rows."""
    ids = np.concatenate([b[key].reshape(-1) for b in pool])
    return np.bincount(ids[ids >= 0], minlength=n)
