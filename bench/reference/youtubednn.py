"""Plain reference of YoutubeDNN serving, and the comparison that decides a
run's `correct`.

Plain PyTorch, imports nothing of the program: it is handed the float32
weights, the LSH projection and the request batches that the benchmark
made, and works out everything else itself, as the iMARS paper's pipeline
defines it:

1. every table quantized row-wise to int8 (scale = max |row| / 127, floored
   at 1e-8 / 127, round half to even) and read back as float32;
2. the user features' rows and the mean of the history's rows (padding ids,
   -1, left out), side by side, through the filtering MLP -> u;
3. the signed-random-projection signature of u and of every item row; the
   Hamming distance of a (query, item) pair as (bits - q.s) / 2 over +-1
   vectors, exact in float32; the items within `radius`, sorted by
   (distance, id), the first `n_candidates`, and the count of all;
4. for each candidate, [u, genre row, pooled history, item row] through the
   ranking MLP and a sigmoid -> CTR; the `top_k` by CTR, ties to the
   earlier candidate.

Matrix products run in float32 with TF32 off, the configuration's
precision. ``tf32=True`` rounds every operand of the MLPs and projections
to TF32 first (10 mantissa bits, to nearest even): the control, one
precision below, which has to come out as not correct.

`judge` compares what the program served for a batch with this reference
and returns the numbers that `correct` holds to their limits:

- ``scan_miss``: queries whose candidate ids, distances or count differ
  from the reference's (summed here, a share over the sample in the run);
- ``ctr_err``: the widest gap between a served CTR and the reference's CTR
  of the same (query, item); 1 where a served id is out of range or a
  score is given for no item;
- ``rank_gap``: the widest gap by which the reference's CTR of a served
  item lies below the reference's CTR of the item it should have served
  at that rank from the program's own candidates; 1 where a served item is
  not among those candidates, or one side serves an item and the other
  none.
"""
from __future__ import annotations

import torch

BIG_DIST = 2**30
# float32 elements of one block of the reference's (query, item) work
_BLOCK_ELEMS = 1 << 28


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """`x` (float32) rounded to TF32's 10 mantissa bits, to nearest even."""
    b = x.contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


def dequantized(x: torch.Tensor) -> torch.Tensor:
    """Row-wise symmetric int8 quantization of `x`, read back as float32."""
    scale = x.abs().amax(dim=-1, keepdim=True).clamp(min=1e-8) / 127.0
    return torch.round(x / scale).clamp(-127.0, 127.0) * scale


class Reference:
    """The pipeline over one set of weights (see the module docstring)."""

    def __init__(self, params: dict, proj: torch.Tensor, cfg: dict,
                 tf32: bool = False):
        self.cfg, self.tf32 = cfg, tf32
        if proj.is_cuda:  # float32 products stay float32 on the card
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.features = sorted(cfg["user_features"])
        self.tables = {k: dequantized(v) for k, v in params["tables"].items()}
        self.item = dequantized(params["item_table"])
        self.genre = dequantized(params["genre_table"])
        self.filter_mlp = params["filter_mlp"]
        self.rank_mlp = params["rank_mlp"]
        self.proj = proj
        self.item_pm = self._pm(self.item)  # (n, bits) +-1

    def _mm(self, a, b):
        return tf32_round(a) @ tf32_round(b) if self.tf32 else a @ b

    def _mlp(self, layers, x):
        for i, p in enumerate(layers):
            x = self._mm(x, p["w"]) + p["b"]
            if i < len(layers) - 1:
                x = torch.relu(x)
        return x

    def _pm(self, x):
        """+-1 signature bits of rows `x`: the sign of each projection."""
        return torch.where(self._mm(x, self.proj) >= 0, 1.0, -1.0)

    def user(self, batch: dict):
        """(u, genre rows, pooled history) of a batch of queries."""
        cols = [self.tables[k][batch[k].long()] for k in self.features]
        hist = batch["history"].long()
        valid = hist >= 0
        rows = self.item[hist.clamp(min=0)]
        acc = torch.zeros_like(rows[:, 0])
        for j in range(hist.shape[1]):
            acc = acc + torch.where(valid[:, j, None], rows[:, j], 0.0)
        pooled = acc / valid.sum(-1, keepdim=True).clamp(min=1)
        u = self._mlp(self.filter_mlp, torch.cat(cols + [pooled], -1))
        return u, self.genre[batch["genre"].long()], pooled

    def scan(self, u: torch.Tensor):
        """(indices, distances, counts) of the fixed-radius scan."""
        n, bits = self.item_pm.shape
        k, radius = self.cfg["n_candidates"], self.cfg["radius"]
        shift = max(1, (n - 1).bit_length())
        kdtype = torch.int32 if (radius + 1) << shift < 2**31 else torch.int64
        big = (radius + 1) << shift
        q_pm = self._pm(u)
        rows = torch.arange(n, device=u.device, dtype=kdtype)
        out = []
        step = max(1, _BLOCK_ELEMS // n)
        for lo in range(0, u.shape[0], step):
            dot = q_pm[lo:lo + step] @ self.item_pm.T
            d = ((bits - dot) * 0.5).to(kdtype)
            within = d <= radius
            key = torch.where(within, (d << shift) | rows, big)
            del dot, d
            kk = min(k, n)
            top = torch.topk(key, kk, dim=1, largest=False,
                             sorted=True).values
            hit = top < big
            idx = torch.where(hit, top & ((1 << shift) - 1), -1)
            dist = torch.where(hit, top >> shift, BIG_DIST)
            pad = k - kk
            if pad:
                idx = torch.nn.functional.pad(idx, (0, pad), value=-1)
                dist = torch.nn.functional.pad(dist, (0, pad),
                                               value=BIG_DIST)
            out.append((idx.to(torch.int32), dist.to(torch.int32),
                        within.sum(1, dtype=torch.int32)))
            del key, within
        return tuple(torch.cat(parts) for parts in zip(*out))

    def ctr(self, u, genre, pooled, items: torch.Tensor) -> torch.Tensor:
        """(b, m) CTRs of items (b, m) for the queries; -inf where an id is
        -1 and NaN where it is out of range."""
        n = self.item.shape[0]
        ok = (items >= 0) & (items < n)
        rows = torch.where(ok[..., None],
                           self.item[items.clamp(0, n - 1).long()], 0.0)
        ctx = torch.cat([u, genre, pooled], -1)[:, None].expand(
            -1, items.shape[1], -1)
        logits = self._mlp(self.rank_mlp, torch.cat([ctx, rows], -1))[..., 0]
        ctr = torch.sigmoid(logits)
        ctr = torch.where(items == -1, float("-inf"), ctr)
        return torch.where(ok | (items == -1), ctr, float("nan"))

    def serve(self, batch: dict) -> dict:
        """What the pipeline serves: the candidates and the top-k (the
        control puts this in the program's place)."""
        out = {k: [] for k in ("indices", "distances", "counts", "items",
                               "scores")}
        for part in _blocks(batch, self._rows(batch)):
            u, genre, pooled = self.user(part)
            idx, dist, counts = self.scan(u)
            ctr = self.ctr(u, genre, pooled, idx)
            vals, order = torch.sort(ctr, dim=1, descending=True,
                                     stable=True)
            vals = vals[:, :self.cfg["top_k"]]
            picked = torch.gather(idx, 1, order[:, :self.cfg["top_k"]])
            items = torch.where(torch.isfinite(vals), picked, -1)
            for key, v in zip(out, (idx, dist, counts, items, vals)):
                out[key].append(v)
        return {k: torch.cat(v) for k, v in out.items()}

    def _rows(self, batch: dict) -> int:
        """Queries a block: the (query, candidate) rank inputs of a block
        stay under a quarter of `_BLOCK_ELEMS` floats."""
        width = 4 * self.cfg["embed_dim"]
        return max(1, (_BLOCK_ELEMS // 4) // (self.cfg["n_candidates"]
                                               * width))


def _blocks(batch: dict, rows: int):
    n = next(iter(batch.values())).shape[0]
    for lo in range(0, n, rows):
        yield {k: v[lo:lo + rows] for k, v in batch.items()}


def _widest(x: torch.Tensor) -> float:
    """The largest entry of `x`, a NaN or an infinity counting as 1."""
    return float(torch.nan_to_num(x, nan=1.0, posinf=1.0, neginf=1.0).max())


def judge(ref: Reference, batch: dict, served: dict) -> dict:
    """Compare what was served for `batch` (indices, distances, counts,
    items, scores; tensors on the reference's device) with the reference.
    Returns {"queries", "scan_miss", "ctr_err", "rank_gap"}."""
    k = ref.cfg["top_k"]
    rows = ref._rows(batch)
    queries = scan_miss = 0
    ctr_err = rank_gap = 0.0
    for lo in range(0, next(iter(batch.values())).shape[0], rows):
        part = {key: v[lo:lo + rows] for key, v in batch.items()}
        got = {key: v[lo:lo + rows] for key, v in served.items()}
        u, genre, pooled = ref.user(part)
        idx, dist, counts = ref.scan(u)
        same = ((got["indices"] == idx).all(1)
                & (got["distances"] == dist).all(1)
                & (got["counts"] == counts))
        queries += int(same.numel())
        scan_miss += int((~same).sum())

        items, scores = got["items"].long(), got["scores"]
        want = ref.ctr(u, genre, pooled, items)  # NaN: id out of range
        err = torch.where(items == -1,
                          torch.where(scores == float("-inf"), 0.0, 1.0),
                          (scores - want).abs())
        ctr_err = max(ctr_err, _widest(err))

        cand = got["indices"].long()
        best = torch.sort(ref.ctr(u, genre, pooled, cand), dim=1,
                          descending=True, stable=True).values[:, :k]
        best = torch.where(best.isnan(), 2.0, best)  # ids out of range
        among = (items[:, :, None] == cand[:, None, :]).any(-1)
        fin_b, fin_w = torch.isfinite(best), torch.isfinite(want)
        gap = torch.where(fin_b & fin_w, best - want, 0.0)
        gap = torch.where(fin_b != fin_w, 1.0, gap)
        gap = torch.where((items >= 0) & ~among, 1.0, gap)
        rank_gap = max(rank_gap, _widest(gap))
    return {"queries": queries, "scan_miss": scan_miss, "ctr_err": ctr_err,
            "rank_gap": rank_gap}


def aggregate(parts: list) -> dict:
    """The run's compared numbers from `judge`'s batches: `scan_miss` as a
    share of the sampled queries, the widest `ctr_err` and `rank_gap`."""
    queries = sum(p["queries"] for p in parts)
    return {"scan_miss": sum(p["scan_miss"] for p in parts) / max(queries, 1),
            "ctr_err": max((p["ctr_err"] for p in parts), default=0.0),
            "rank_gap": max((p["rank_gap"] for p in parts), default=0.0)}
