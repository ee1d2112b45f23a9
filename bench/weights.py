"""Seeded YoutubeDNN weights and LSH projection, made on the device.

The counterpart of `chip_smoke.py`'s `numpy_params` (the reference's
layout and scales: tables 0.05 N(0, 1), MLP weights fan_in**-0.5 N(0, 1),
zero biases), drawn on the device from a `torch.Generator` there, so
set-up moves no weights over the bus. The tables are made in float32, as
the engine takes them, and quantized to int8 by its build.

The model is one draw, from the configuration's `model_seed`, and a run's
seed relabels it: it permutes the hidden units of each MLP and the bits
of the signature. Every seed so serves a model that computes the same
function over the same catalog, and the scan has the same work to do.
The tables' rows keep their order, as the traffic's ids name them: the
pruned streaming scan bounds each query's distances from a sample of the
rows, so its work follows their order. Models drawn anew for each seed,
or catalogs relabelled by it, made the scan's time differ by 2-4% from
seed to seed.

The same seed on the same device gives the same bits, so the reference is
handed a fresh copy made the same way.
"""
from __future__ import annotations

import torch


def _shapes(cfg: dict) -> list:
    """(path, shape, scale) in draw order; scale None marks a zero bias."""
    d = cfg["embed_dim"]
    out = [(("tables", name), (card, d), cfg["table_std"])
           for name, card in sorted(cfg["user_features"].items())]
    out += [(("item_table",), (cfg["n_items"], d), cfg["table_std"]),
            (("genre_table",), (cfg["n_genres"], d), cfg["table_std"])]
    n_in = (len(cfg["user_features"]) + 1) * d
    for mlp, dims in (("filter_mlp", [n_in, *cfg["filter_dims"]]),
                      ("rank_mlp", [4 * d, *cfg["rank_dims"]])):
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            out += [((mlp, i, "w"), (a, b), a ** -0.5),
                    ((mlp, i, "b"), (b,), None)]
    out.append((("lsh_proj",), (d, cfg["lsh_bits"]), 1.0))
    return out


def _model(cfg: dict, device) -> tuple[dict, torch.Tensor]:
    """The configuration's model: one draw of a generator seeded with its
    `model_seed`."""
    shapes = _shapes(cfg)
    sizes = [0 if scale is None else torch.Size(shape).numel()
             for _, shape, scale in shapes]
    gen = torch.Generator(device=device).manual_seed(int(cfg["model_seed"]))
    flat = torch.randn(sum(sizes), generator=gen, device=device,
                       dtype=torch.float32)
    params = {"tables": {}, "filter_mlp": [], "rank_mlp": []}
    proj, at = None, 0
    for (path, shape, scale), size in zip(shapes, sizes):
        if scale is None:
            t = torch.zeros(shape, dtype=torch.float32, device=device)
        else:
            t = flat[at:at + size].view(shape) * scale
        at += size
        if path[0] == "tables":
            params["tables"][path[1]] = t
        elif path[0] in ("item_table", "genre_table"):
            params[path[0]] = t
        elif path[0] == "lsh_proj":
            proj = t
        else:
            layers = params[path[0]]
            if path[1] == len(layers):
                layers.append({})
            layers[path[1]][path[2]] = t
    return params, proj


def make_weights(cfg: dict, seed: int, device) -> tuple[dict, torch.Tensor]:
    """(params in the reference's layout, (embed_dim, lsh_bits) projection),
    float32 on `device`: the configuration's model, its hidden units and
    signature bits relabelled by `seed` (the tables as drawn)."""
    params, proj = _model(cfg, device)
    gen = torch.Generator(device=device).manual_seed(int(seed))

    def perm(n: int) -> torch.Tensor:
        return torch.randperm(n, generator=gen, device=device)

    for mlp in ("filter_mlp", "rank_mlp"):
        layers = params[mlp]
        for inner, outer in zip(layers[:-1], layers[1:]):
            p = perm(inner["w"].shape[1])
            inner["w"], inner["b"] = inner["w"][:, p], inner["b"][p]
            outer["w"] = outer["w"][p]
    return params, proj[:, perm(proj.shape[1])]
