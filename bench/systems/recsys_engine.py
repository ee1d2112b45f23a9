"""The system under test for YoutubeDNN configurations: the port's
`repro_torch.serving.recsys_engine.RecSysEngine`, entered through `serve`
on whole batches.

The engine is built with `RecSysEngine.build` from the seeded float32
weights (`bench/weights.py`, made on the device), with the configuration's
radius, candidates, top-k, plan knobs and hot-row capacity; the hot rows of
every table are picked from the traffic pool's own id frequencies. This
file is the only one of the benchmark that uses the program's modules
(`bench/run.py` only checks that the package is the checkout's).
"""
from __future__ import annotations

import torch

from bench.generator import id_frequencies
from bench.weights import make_weights


class System:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device, pool):
        from repro_torch.models.recsys import YoutubeDNNConfig
        from repro_torch.serving.recsys_engine import (
            RecSysEngine,
            n_summary_blocks,
        )

        params, proj = make_weights(cfg, seed, device)
        feats = cfg["user_features"]
        model = YoutubeDNNConfig(
            n_items=cfg["n_items"], user_features=dict(feats),
            history_len=cfg["history_len"],
            filter_dims=tuple(cfg["filter_dims"]),
            rank_dims=tuple(cfg["rank_dims"]), embed_dim=cfg["embed_dim"])
        self.engine = RecSysEngine.build(
            params, model, lsh_proj=proj, radius=cfg["radius"],
            n_candidates=cfg["n_candidates"], top_k=cfg["top_k"],
            hot_rows=cfg["hot_rows"],
            item_freqs=id_frequencies(pool, "history", cfg["n_items"]),
            uiet_freqs={k: id_frequencies(pool, k, card)
                        for k, card in feats.items()},
            scan_block=cfg["scan_block"], prune=cfg["prune"], device=device)
        self.batch = traffic["batch"]
        self.top_k = cfg["top_k"]
        # the block summary a pruned streaming scan chooses from (a dense
        # or unpruned scan reports no blocks touched)
        self.summary_blocks = n_summary_blocks(self.engine)
        self.summary_block_rows = (self.engine.block_summary.block_rows
                                   if self.summary_blocks else 0)

    def answer_buffers(self, pin: bool) -> tuple:
        """Host buffers for one batch's answers: final ids and CTR scores."""
        shape = (self.batch, self.top_k)
        return (torch.empty(shape, dtype=torch.int32, pin_memory=pin),
                torch.empty(shape, dtype=torch.float32, pin_memory=pin))

    def serve(self, inputs: dict):
        return self.engine.serve(inputs)

    @staticmethod
    def answers(result) -> tuple:
        """The device tensors a batch's answers are copied from."""
        return result.items, result.topk.scores

    @staticmethod
    def served(result) -> dict:
        """What the comparison with the reference reads."""
        return {"indices": result.nns.indices,
                "distances": result.nns.distances,
                "counts": result.nns.counts, "items": result.items,
                "scores": result.topk.scores}

    @staticmethod
    def counters(result) -> dict:
        """The program's counters of a batch (device scalars), for the
        per-layer metrics: matches within the radius, returned candidates,
        summary blocks admitted, hot-cache hits and lookups."""
        nns = result.nns
        out = {"matches": nns.counts.sum(dtype=torch.int64),
               "candidates": (nns.indices >= 0).sum(dtype=torch.int64),
               "hits": result.stats.hits.to(torch.int64),
               "lookups": result.stats.lookups.to(torch.int64)}
        if nns.blocks_touched is not None:
            out["blocks"] = nns.blocks_touched.sum(dtype=torch.int64)
        return out

    @staticmethod
    def traced(result) -> dict:
        """What a roofline reader needs of a traced batch's result."""
        return {"indices": result.nns.indices,
                "blocks_touched": result.nns.blocks_touched}
