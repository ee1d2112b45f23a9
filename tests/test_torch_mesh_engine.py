"""The port's sharded `RecSysEngine` (`RecSysEngine.shard`) against the
JAX reference's local engine, on the CPU over `torch.distributed` (gloo).

A `repro` engine like `tests/test_torch_catalog.py`'s (768 items, radius
112, 16 candidates, top 5, 32 hot rows), its block summary rebuilt at 128
rows a block so that banks of whole blocks prune, is exported to the port
(`convert.engine_from_arrays`), on the dense plan and on the pruned
streaming plan (64-row chunks). On every mesh (the banks alone, the
queries alone, and the query x bank grid of `tests/test_torch_mesh.py`),
every rank:

- serves two batches through `engine.serve`, bit-equal to the unsharded
  port engine (items, scores, NNS, blocks touched, cache counters);
- serves a 37-query stream through the sync front-end and the pipelined
  one (whose `coalesce` defaults to the query axis' size) bit-equal to the
  unsharded engine's front-ends (the pipelined one at the same coalesce);
- serves the stream through the concurrent front-end (rank 0 drains,
  the other ranks follow its stream) bit-equal to the sync front-end,
  every rank's counters equal to sync's, and finds `TieredCatalog`
  refused;
- runs a seeded churn through `LiveCatalog` (new ids, re-embedded hot and
  cold rows, deletes, a delete and re-add, a forced compaction that
  re-shards the folded table, a last compaction), each step serving
  bit-equal to `rebuild_reference()` (unsharded), with the same blocks
  touched where both prune.

Rank 0's outputs are held here against the reference's local engine and
`LiveCatalog` on the same weights, churn and batches, by
`tests/test_torch_catalog.py`'s rule: cache counters equal; given the
reference's query signatures, the NNS bit-equal (blocks touched where the
port's banks pruned); CTRs within 1e-6; ids equal within the prefix the
CTR gaps decide. World size 1 runs in this process; 2, 3, 4 (2 x 2) and 8
(4 x 2) ranks are spawned (`tests/test_torch_mesh.py:spawn`), and each
rank asserts that it never loaded `jax`.
"""
import dataclasses
import json
import sys

import numpy as np
import pytest
import torch

from repro_torch.convert import engine_from_arrays
from repro_torch.core import nns as tnns
from repro_torch.models.recsys import YoutubeDNNConfig
from repro_torch.serving import (
    LiveCatalog,
    ServerConfigError,
    TieredCatalog,
    make_server,
)
from repro_torch.serving import recsys_engine as trs
from repro_torch.serving.shadow import rebuild_from_params
from repro_torch.utils import make_mesh, mesh_axis_size
from test_torch_mesh import (
    FIELDS,
    GRIDS,
    WORLDS,
    _np,
    _t,
    assert_ranks_agree,
    meshes,
    rank_main,
    spawn,
    world1,  # noqa: F401 (a fixture)
)

N_ITEMS = 768
B = 16
PLANS = {"dense": None, "pruned": 64}  # scan_block
# mesh -> (bank axis, query axis) of `engine.shard`
SHARDINGS = {"banks": ("banks", None), "qp": (None, "qp"),
             "grid": ("banks", "qp")}
DELTA = 16
FLOAT_RTOL = 1e-6


# ---------------------------------------------------------------------------
# the engine as arrays, and back
# ---------------------------------------------------------------------------
def pack_tree(tree, prefix: str = "") -> dict:
    """Nested dicts / lists / tuples of arrays -> flat `prefix`-keyed
    arrays (list entries as ``#i``)."""
    if isinstance(tree, dict):
        items = [(str(k), v) for k, v in tree.items()]
    elif isinstance(tree, (list, tuple)):
        items = [(f"#{i}", v) for i, v in enumerate(tree)]
    else:
        return {prefix[:-1]: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(pack_tree(v, f"{prefix}{k}/"))
    return out


def unpack_tree(arrays: dict, prefix: str):
    """`pack_tree`'s inverse for the keys under `prefix`."""
    root: dict = {}
    for key, v in arrays.items():
        if not key.startswith(prefix):
            continue
        node, parts = root, key[len(prefix):].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v

    def fix(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.startswith("#") for k in node):
            return [fix(node[f"#{i}"]) for i in range(len(node))]
        return {k: fix(v) for k, v in node.items()}

    return fix(root)


ARRAY_KEYS = ("params", "tables_q", "item_table_q", "genre_table_q",
              "item_sigs", "lsh_proj", "item_hot", "uiet_hot",
              "block_summary")


def engine_inputs(arrays: dict) -> dict:
    """An exported engine (`test_torch_engine.export`) as npz entries."""
    out = pack_tree({k: arrays[k] for k in ARRAY_KEYS}, "engine/")
    meta = {k: arrays[k] for k in ("radius", "n_candidates", "top_k",
                                   "scan_block", "prune")}
    meta["cfg"] = {**arrays["cfg"]._asdict(),
                   "user_features": dict(arrays["cfg"].user_features)}
    out["engine_meta"] = np.array(json.dumps(meta))
    return out


def engine_from_inputs(inputs: dict):
    """The port engine (CPU) from `engine_inputs`' entries."""
    meta = json.loads(str(inputs["engine_meta"]))
    cfg = meta.pop("cfg")
    cfg = YoutubeDNNConfig(**{k: tuple(v) if isinstance(v, list) else v
                              for k, v in cfg.items()})
    return engine_from_arrays(cfg=cfg, **unpack_tree(inputs, "engine/"),
                              **meta, device="cpu")


def _batch(data, idx) -> dict:
    return {**{k: v[idx].astype(np.int32) for k, v in data.user_feats.items()},
            "history": data.histories[idx].astype(np.int32),
            "genre": data.genres[idx].astype(np.int32)}


def _churn(rng, hot):
    """The update batches (catalog method, args) of the live churn: new
    ids, re-embedded hot and cold rows, deletes, a delete and re-add, and
    8 new ids that overflow the 16-slot delta (a forced compaction)."""
    re = np.r_[hot[:3], [20, 400]]
    return [
        ("upsert", np.arange(N_ITEMS, N_ITEMS + 6),
         rng.normal(size=(6, 32)).astype(np.float32)),
        ("upsert", re, rng.normal(size=(len(re), 32)).astype(np.float32)),
        ("delete", np.array([7, 500, N_ITEMS + 1])),
        ("delete", np.array([400])),
        ("upsert", np.array([400]), rng.normal(size=(1, 32)).astype(
            np.float32)),
        ("upsert", np.arange(N_ITEMS + 6, N_ITEMS + 14),
         rng.normal(size=(8, 32)).astype(np.float32)),
        ("compact",),
    ]


def _apply(cat, step) -> None:
    if step[0] == "upsert":
        cat.upsert(step[1], step[2])
    elif step[0] == "delete":
        cat.delete(step[1])
    else:
        cat.compact()


def churn_inputs(steps) -> dict:
    out = {"churn_kinds": np.array([s[0] for s in steps])}
    for i, s in enumerate(steps):
        for j, a in enumerate(s[1:]):
            out[f"churn/{i}/{j}"] = a
    return out


def churn_from_inputs(inputs) -> list:
    return [(str(kind),) + tuple(
        inputs[f"churn/{i}/{j}"] for j in range(2) if f"churn/{i}/{j}" in
        inputs) for i, kind in enumerate(inputs["churn_kinds"])]


# ---------------------------------------------------------------------------
# what a rank runs (in this process at world size 1)
# ---------------------------------------------------------------------------
def _assert_same_serve(got, want, what: str, blocks: str) -> None:
    """Two port ServeResults bit for bit. Blocks touched: "common" —
    equal where both pruned (banks that do not hold whole summary blocks
    scan unpruned); "none" — not compared (a rebuilt table has other
    summary blocks)."""
    assert torch.equal(got.items, want.items), what
    assert torch.equal(got.topk.scores, want.topk.scores), what
    assert got.stats.as_dict() == want.stats.as_dict(), what
    for f in FIELDS:
        a, b = getattr(got.nns, f), getattr(want.nns, f)
        if f == "blocks_touched" and (
                blocks == "none" or (blocks == "common"
                                     and (a is None or b is None))):
            continue
        assert (a is None) == (b is None), f"{what}: {f}"
        assert a is None or torch.equal(a, b), f"{what}: {f}"


def _assert_bank_state(live, whole, what: str) -> None:
    """A sharded engine's rows against the unsharded engine's: the mask
    over every row, and the rank's summary blocks (banks of whole blocks)
    equal to the unsharded summary's blocks over the same rows."""
    from repro_torch.serving.catalog import global_rows
    n = whole.item_table_q.values.shape[0]
    if live.item_mask is not None:
        assert torch.equal(global_rows(live, live.item_mask)[:n],
                           whole.item_mask[:n]), f"{what}: mask"
    mine, full = live.block_summary, whole.block_summary
    if live.nns_axis is None or mine is None \
            or live.item_sigs.shape[0] % mine.block_rows:
        return  # unsharded, or a bank the plan scans unpruned
    nb = live.item_sigs.shape[0] // mine.block_rows
    lo = live.nns_mesh.get_local_rank(live.nns_axis) * nb
    assert full.block_rows == mine.block_rows, what
    assert lo + nb <= full.n_blocks, what
    for f in ("or_sigs", "and_sigs", "min_pc", "max_pc", "n_alive"):
        assert torch.equal(getattr(mine, f), getattr(full, f)[lo:lo + nb]), \
            f"{what}: summary {f}"


def _record(out: dict, key: str, res, engine, jq) -> None:
    """A served result and the NNS given the reference's query signatures
    `jq`, for the parent's comparison."""
    out[f"{key}/items"] = res.items.numpy()
    out[f"{key}/scores"] = res.topk.scores.numpy()
    out[f"{key}/own_indices"] = res.nns.indices.numpy()
    out[f"{key}/stats"] = np.array([res.stats.as_dict()["hits"],
                                    res.stats.as_dict()["lookups"]])
    given = trs._nns(engine, _t(jq))
    for f in FIELDS:
        if getattr(given, f) is not None:
            out[f"{key}/given/{f}"] = getattr(given, f).numpy()


def _queries(stream: dict) -> list:
    n = len(stream["genre"])
    return [{k: v[i] for k, v in stream.items()} for i in range(n)]


def _same_tickets(got, want, what: str) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.ok and w.ok, what
        np.testing.assert_array_equal(g.items, w.items, err_msg=what)
        np.testing.assert_array_equal(g.scores, w.scores, err_msg=what)


def rank_engine(inputs: dict, world: int) -> dict:
    """Every mesh x plan: serve, the front-ends and the live churn, held
    against the unsharded port engine and `rebuild_reference()`;
    outputs for the reference comparison. Every rank makes the same
    (collective) calls; rank 0 alone serves the unsharded engines to
    compare with, since the parent holds every rank's outputs equal to
    rank 0's."""
    import tempfile

    import torch.distributed as dist

    checker = dist.get_rank() == 0
    base = engine_from_inputs(inputs)
    batches = [{k[len(f"batch{j}/"):]: v for k, v in inputs.items()
                if k.startswith(f"batch{j}/")} for j in range(2)]
    stream = _queries({k[len("stream/"):]: v for k, v in inputs.items()
                       if k.startswith("stream/")})
    steps = churn_from_inputs(inputs)
    out = {}
    for mname, mesh in meshes(world).items():
        axis, qaxis = SHARDINGS[mname]
        qp = 1 if qaxis is None else mesh_axis_size(mesh, qaxis)
        for plan, scan in PLANS.items():
            local = dataclasses.replace(base, scan_block=scan)
            eng = local.shard(mesh, axis, query_axis=qaxis)
            key = f"{mname}/{plan}"
            if axis is not None:
                assert eng.item_sigs.shape[0] == -(
                    -N_ITEMS // mesh_axis_size(mesh, axis)), key
            _assert_bank_state(eng, local, key)
            for j, b in enumerate(batches):
                res = eng.serve(b)
                if checker:
                    _assert_same_serve(res, local.serve(b),
                                       f"{key} serve {j}", "common")
                _record(out, f"{key}/serve{j}", res, eng,
                        inputs[f"jq/serve{j}"])

            # the front-ends
            sync = make_server(eng, "sync", max_batch=B)
            got = sync.serve_many(stream)
            st = sync.stats()
            out[f"{key}/sync_stats"] = np.array(
                [st[k] for k in ("n_served", "n_padded", "n_batches",
                                 "cache_hits", "cache_lookups")])
            sync.close()
            pipe = make_server(eng, "pipelined", max_batch=B)
            assert pipe.coalesce == qp, (key, pipe.coalesce)
            piped = pipe.serve_many(stream)
            pipe.close()
            if checker:
                for mode, knobs, tickets in (("sync", {}, got),
                                             ("pipelined", {"coalesce": qp},
                                              piped)):
                    ref = make_server(local, mode, max_batch=B, **knobs)
                    _same_tickets(tickets, ref.serve_many(stream),
                                  f"{key} {mode}")
                    ref.close()
            conc = make_server(eng, "concurrent", max_batch=B,
                               queue_depth=None, autostart=False)
            assert conc.leader == checker
            if checker:
                tickets = [conc.submit(q) for q in stream]
                conc.start()
                _same_tickets([conc.result(t, timeout=60.0)
                               for t in tickets], got, f"{key} concurrent")
            else:
                with pytest.raises(ServerConfigError, match="rank 0"):
                    conc.submit(stream[0])
            conc.close()
            cst = conc.stats()
            assert [cst[k] for k in ("n_served", "n_padded", "n_batches",
                                     "cache_hits", "cache_lookups")] \
                == out[f"{key}/sync_stats"].tolist(), key
            with tempfile.TemporaryDirectory() as d:
                with pytest.raises(ValueError, match="unsharded"):
                    TieredCatalog.from_engine(eng, d)

            # the live churn, beside the same churn unsharded
            cat = LiveCatalog(eng, delta_capacity=DELTA)
            lcat = LiveCatalog(local, delta_capacity=DELTA)
            for i, step in enumerate(steps):
                _apply(cat, step)
                _apply(lcat, step)
                live = cat.engine
                assert live.nns_mesh is mesh and live.nns_axis == axis
                _assert_bank_state(live, lcat.engine, f"{key} churn {i}")
                rebuilt = cat.rebuild_reference()
                assert rebuilt.nns_mesh is None
                res = live.serve(batches[0])
                if checker:
                    _assert_same_serve(res, lcat.engine.serve(batches[0]),
                                       f"{key} churn {i}", "common")
                    _assert_same_serve(res, rebuilt.serve(batches[0]),
                                       f"{key} churn {i} rebuilt", "none")
                _record(out, f"{key}/live{i}", res, live,
                        inputs[f"jq/live{i}"])
            out[f"{key}/n_items"] = np.array([cat.n_items, cat.epoch])
    return out


# ---------------------------------------------------------------------------
# the reference side
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def reference():
    """The reference's engine, batches, stream and churn, and what its
    local engine and LiveCatalog serve -> (npz inputs, expectations)."""
    import jax
    import jax.numpy as jnp

    from repro.core import nns as jnns
    from repro.core.lsh import lsh_signature as jlsh
    from repro.data import synthetic as jsyn
    from repro.models import recsys as jrs
    from repro.serving import LiveCatalog as JLiveCatalog
    from repro.serving import RecSysEngine as JaxEngine
    from repro.serving import make_server as jmake_server
    from repro.serving.recsys_engine import _features as jfeat
    from test_torch_engine import export

    data = jsyn.make_movielens(n_users=120, n_items=N_ITEMS, history_len=6)
    cfg = jrs.YoutubeDNNConfig(
        n_items=N_ITEMS,
        user_features={"user_id": data.n_users, "gender": 3, "age": 7,
                       "occupation": 21, "zip_bucket": 250},
        history_len=6)
    params = jrs.init_youtubednn(jax.random.key(0), cfg)
    freqs = np.bincount(data.histories[data.histories >= 0],
                        minlength=N_ITEMS)
    jeng = JaxEngine.build(params, cfg, radius=112, n_candidates=16,
                           top_k=5, hot_rows=32, item_freqs=freqs)
    jeng = dataclasses.replace(jeng, block_summary=jnns.build_block_summary(
        np.asarray(jeng.item_sigs), 128))
    batches = [_batch(data, np.arange(j * B, (j + 1) * B)) for j in range(2)]
    stream = _batch(data, np.arange(37) % 29 + 40)
    steps = _churn(np.random.default_rng(0),
                   np.asarray(jeng.item_hot.hot_ids))

    inputs = engine_inputs(export(jeng))
    inputs.update(churn_inputs(steps))
    for j, b in enumerate(batches):
        inputs.update({f"batch{j}/{k}": v for k, v in b.items()})
    inputs.update({f"stream/{k}": v for k, v in stream.items()})

    jfeatures = jax.jit(jfeat)

    def jserve(engine, batch):
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        q = np.asarray(jlsh(jfeatures(engine, jb)[0], engine.lsh_proj))
        return engine.serve(jb), q

    # the reference on the pruned plan only: every plan serves the same
    # bits, and this one also counts the blocks touched
    je = dataclasses.replace(jeng, scan_block=PLANS["pruned"])
    want = {}
    for j, b in enumerate(batches):
        want[f"serve{j}"], inputs[f"jq/serve{j}"] = jserve(je, b)
    server = jmake_server(je, "sync", max_batch=B)
    server.serve_many(_queries(stream))
    st = server.stats()
    want["sync_stats"] = np.array(
        [st[k] for k in ("n_served", "n_padded", "n_batches", "cache_hits",
                         "cache_lookups")])
    server.close()
    jcat = JLiveCatalog(je, delta_capacity=DELTA)
    for i, step in enumerate(steps):
        _apply(jcat, step)
        want[f"live{i}"], inputs[f"jq/live{i}"] = jserve(jcat.engine,
                                                          batches[0])
    want["n_items"] = np.array([jcat.n_items, jcat.epoch])
    return inputs, want


def _decided_prefix(scores, tol):
    s = np.where(np.isfinite(scores), scores, -1.0)
    return np.cumprod(s[:, :-1] - s[:, 1:] > tol, axis=1).sum(1)


def assert_serves_like_reference(got: dict, key: str, want) -> int:
    """Rank 0's result `key` against the reference's ServeResult: the
    comparison rule of the module docstring. -> ids compared."""
    hits_lookups = [want.stats.as_dict()[k] for k in ("hits", "lookups")]
    np.testing.assert_array_equal(got[f"{key}/stats"], hits_lookups,
                                  err_msg=key)
    for f in FIELDS:
        name = f"{key}/given/{f}"
        if f == "blocks_touched" and name not in got:
            continue  # the banks scanned unpruned
        np.testing.assert_array_equal(got[name], _np(getattr(want.nns, f)),
                                      err_msg=name)
    scores = np.asarray(want.topk.scores)
    np.testing.assert_allclose(got[f"{key}/scores"], scores,
                               rtol=FLOAT_RTOL, atol=1e-7, err_msg=key)
    if not np.array_equal(got[f"{key}/own_indices"],
                          got[f"{key}/given/indices"]):
        return 0  # a query signature bit with |u @ proj| ~ 0 flipped
    n_dec = _decided_prefix(scores, 2e-6)
    items = np.asarray(want.items)
    for r in range(scores.shape[0]):
        np.testing.assert_array_equal(got[f"{key}/items"][r, :n_dec[r]],
                                      items[r, :n_dec[r]], err_msg=key)
    return int(n_dec.sum())


def check_against_reference(got: dict, want: dict, world: int) -> None:
    checked = 0
    n_steps = sum(1 for k in want if k.startswith("live"))
    for mname in SHARDINGS:
        for plan in PLANS:
            key = f"{mname}/{plan}"
            for j in range(2):
                checked += assert_serves_like_reference(
                    got, f"{key}/serve{j}", want[f"serve{j}"])
            np.testing.assert_array_equal(got[f"{key}/sync_stats"],
                                          want["sync_stats"])
            for i in range(n_steps):
                checked += assert_serves_like_reference(
                    got, f"{key}/live{i}", want[f"live{i}"])
            np.testing.assert_array_equal(got[f"{key}/n_items"],
                                          want["n_items"])
    assert checked > 100
    # banks of whole summary blocks pruned: 768 rows in banks of 384
    # (grid of 2 banks, and 2 banks alone), 256 (3 banks) or 768 (1 bank)
    grid_banks = GRIDS[world][1]
    assert "grid/pruned/serve0/given/blocks_touched" in got, grid_banks
    assert "banks/pruned/serve0/given/blocks_touched" in got or world in (4, 8)


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_engine_on_gloo_ranks(world, reference, tmp_path):
    inputs, want = reference
    outs = spawn(__file__, "engine", world, inputs, tmp_path)
    assert_ranks_agree(outs)
    check_against_reference(outs[0], want, world)


def test_mesh_engine_one_rank(world1, reference):
    """World size 1 in this process: the same run (the concurrent
    front-end on its stream of one rank)."""
    inputs, want = reference
    check_against_reference(rank_engine(inputs, 1), want, 1)


def test_shard_refuses_bad_arguments(world1, reference, tmp_path):
    eng = engine_from_inputs(reference[0])
    mesh = make_mesh((1,), ("banks",), device="cpu")
    with pytest.raises(ValueError, match="axis"):
        eng.shard(mesh)
    sharded = eng.shard(mesh, "banks")
    assert sharded.block_summary is not None  # 768 rows, 128 a block
    with pytest.raises(ValueError, match="unsharded"):
        sharded.shard(mesh, "banks")
    # a bank-sharded snapshot is written in the unsharded layout
    LiveCatalog(sharded).snapshot(tmp_path)
    back = LiveCatalog(eng)
    back.restore(tmp_path)
    assert back.engine.nns_mesh is None
    assert torch.equal(back.engine.item_sigs, eng.item_sigs)
    meta = dataclasses.replace(eng, item_sigs=eng.item_sigs.to("meta"))
    with pytest.raises(ValueError, match="cpu mesh"):
        meta.shard(mesh, "banks")
    # a summary whose blocks do not tile the bank is dropped (same bits)
    odd = dataclasses.replace(eng, block_summary=tnns.build_block_summary(
        eng.item_sigs, 512))
    assert odd.shard(mesh, "banks").block_summary is None
    # a gather never leaves the tensor's device
    from repro_torch.utils import all_gather_axis

    with pytest.raises(ValueError, match="meta"):
        all_gather_axis(torch.empty(2, device="meta"), mesh, "banks")


def test_rebuild_from_params_is_unsharded(world1, reference):
    eng = engine_from_inputs(reference[0])
    sharded = eng.shard(make_mesh((1,), ("banks",), device="cpu"), "banks",
                        query_axis=None)
    rebuilt = rebuild_from_params(sharded, eng.params)
    assert rebuilt.nns_mesh is None and rebuilt.nns_axis is None
    assert rebuilt.item_sigs.shape == eng.item_sigs.shape


if __name__ == "__main__":
    sys.exit(rank_main({"engine": rank_engine}))
