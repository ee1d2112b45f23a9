"""Carry weights and engine state from the JAX reference into the port.

`jax.random` draws cannot be reproduced with PyTorch, so parity runs take
the parameters, the LSH projection and the built engine's arrays from the
reference as numpy arrays (the exporter that calls `np.asarray` on a
`repro` engine lives in the tests). Packed signatures may come as uint32;
they are viewed as int32 holding the same bits. bfloat16 leaves (numpy's
`ml_dtypes.bfloat16`) arrive as bfloat16 tensors with the same bits. A
reference `TrainState` (parameters, AdamW moments with int8 `QuantState`
leaves, count and step) carries across the same way
(`train_state_from_numpy`), so a port trainer continues from the
reference's optimizer state. A reference LM cache tree (KV caches with
int8 or bfloat16 values, recurrent states, None leaves) carries across
with `caches_from_numpy`, so a port decode continues the reference's
prefill.
"""
from __future__ import annotations

from repro_torch.core.nns import BlockSummary
from repro_torch.core.quantization import QuantizedTensor
from repro_torch.distributed.training import TrainState
from repro_torch.models.attention import KVCacheView
from repro_torch.models.recsys import YoutubeDNNConfig
from repro_torch.optim.adamw import AdamWState, QuantState
from repro_torch.serving.hot_cache import HotRowCache
from repro_torch.serving.recsys_engine import RecSysEngine
from repro_torch.utils import resolve_device, to_device, tree_map


def params_from_numpy(tree, device=None):
    """The reference's parameter pytree (dicts/lists of numpy arrays) as
    the same structure of tensors on `device` (default `cuda`)."""
    return to_device(tree, resolve_device(device))


def _moment(leaf, device):
    """One optimizer-moment leaf on `device`: an array, or an int8
    `QuantState`-like object (``values`` and ``scales`` attributes)."""
    if hasattr(leaf, "scales"):
        return QuantState(values=to_device(leaf.values, device),
                          scales=to_device(leaf.scales, device))
    return to_device(leaf, device)


def train_state_from_numpy(state, device=None) -> TrainState:
    """A reference `TrainState` (attributes ``params``, ``opt`` with
    ``mu``, ``nu`` and ``count``, ``step``, and optionally ``err_buf``;
    leaves numpy or anything `np.array` takes) as the port's, on `device`
    (default `cuda`): the RecSys state or the LM's, bfloat16 or float32
    parameters. int8 moments arrive as `QuantState`s, bfloat16 ones and
    bfloat16 parameters with the same bits."""
    device = resolve_device(device)
    opt = state.opt
    err_buf = getattr(state, "err_buf", None)
    return TrainState(
        params=params_from_numpy(state.params, device),
        opt=AdamWState(mu=tree_map(lambda x: _moment(x, device), opt.mu),
                       nu=tree_map(lambda x: _moment(x, device), opt.nu),
                       count=to_device(opt.count, device)),
        step=to_device(state.step, device),
        err_buf=None if err_buf is None else to_device(err_buf, device))


# an LM tree of `repro`'s `models/transformer.py` `init_params` (stacked
# layer dicts, nested for llama4's pairs and the hybrid's groups; bf16 or
# f32 leaves) carries across the same way, ready for
# `repro_torch.models.transformer.forward`
lm_params_from_numpy = params_from_numpy


def caches_from_numpy(tree, device=None):
    """A reference cache tree (`repro/serving/kv_cache.py`, or a prefill's
    `caches`; leaves numpy or anything `np.array` takes) as the port's on
    `device` (default `cuda`): its `KVCacheView`s (any named tuple with
    fields k, v, k_scale, v_scale) become the port's, other tuples stay
    tuples, dicts dicts, None None; bfloat16 and int8 leaves keep their
    bits."""
    device = resolve_device(device)

    def conv(t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, tuple) and getattr(t, "_fields", None) == \
                KVCacheView._fields:
            return KVCacheView(*(conv(v) for v in t))
        if isinstance(t, (tuple, list)):
            return tuple(conv(v) for v in t)
        return to_device(t, device)

    return conv(tree)


def engine_from_arrays(*, cfg, params, tables_q: dict, item_table_q,
                       genre_table_q, item_sigs, lsh_proj, item_hot,
                       uiet_hot: dict, block_summary=None,
                       radius: int = 96, n_candidates: int = 50,
                       top_k: int = 10, scan_block: int | None = None,
                       prune: bool | None = None,
                       device=None) -> RecSysEngine:
    """A port engine from a built reference engine's exported arrays.

    tables_q / item_table_q / genre_table_q: (values int8, scales f32)
    pairs (tables_q a dict by feature); item_sigs: (n, words) uint32 or
    int32; item_hot / uiet_hot: (hot_ids, hot_rows) pairs (uiet_hot a
    dict); block_summary: dict of ``or_sigs``, ``and_sigs``, ``min_pc``,
    ``max_pc``, ``n_alive`` and ``block_rows``, or None; cfg: a config
    with the reference's fields.
    """
    device = resolve_device(device)

    def qt(pair):
        return QuantizedTensor(values=to_device(pair[0], device),
                               scales=to_device(pair[1], device))

    def hot(pair):
        ids = to_device(pair[0], device)
        return HotRowCache(hot_ids=ids, hot_rows=to_device(pair[1], device),
                           capacity=int(ids.shape[0]))

    summary = None
    if block_summary is not None:
        summary = BlockSummary(
            **{f: to_device(block_summary[f], device) for f in
               ("or_sigs", "and_sigs", "min_pc", "max_pc", "n_alive")},
            block_rows=int(block_summary["block_rows"]))
    cfg = YoutubeDNNConfig(**{**cfg._asdict(), "user_features": dict(
        cfg.user_features)})
    return RecSysEngine(
        cfg=cfg, tables_q={k: qt(v) for k, v in tables_q.items()},
        item_table_q=qt(item_table_q), genre_table_q=qt(genre_table_q),
        item_sigs=to_device(item_sigs, device),
        params=params_from_numpy(params, device),
        lsh_proj=to_device(lsh_proj, device), item_hot=hot(item_hot),
        uiet_hot={k: hot(v) for k, v in uiet_hot.items()},
        block_summary=summary, radius=radius, n_candidates=n_candidates,
        top_k=top_k, scan_block=scan_block, prune=prune)
