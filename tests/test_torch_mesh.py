"""The port's multi-device NNS plans and adder trees against the JAX
reference, on the CPU over `torch.distributed` (gloo).

World size 1, in this process (a one-rank gloo group, `file://`
rendezvous in a temporary directory): the port's `sharded_fixed_radius_nns`
and `query_parallel_nns` on `(1,)` and `(1, 1)` meshes against the
reference's same plans on one-device meshes and against a numpy (distance,
row) lexsort (`tests/test_nns_scale_matrix.py`'s matrix and
`tests/test_nns_topk.py`'s mesh cases), the query-parallel delta scan
(`tests/test_catalog.py`'s), `tree_sum`, `hierarchical_psum` and
`sharded_embedding_bag` (`tests/test_embedding_hierarchy.py`'s), the bank
decomposition without a collective (`bank_scan` + `merge_banks`, and
`bank_bag` + `tree_sum`, as `chip_smoke.py` phase H.2 runs it on the card),
`fixed_radius_nns_async`, and the embedding helpers.

Spawned gloo groups of 2, 3, 4 and 8 ranks (`spawn`): every rank runs this
file as a script, reads its inputs from an `.npz` the test wrote, asserts
that it never loaded `jax`, and writes its outputs; every rank's outputs
must be equal (SPMD), and rank 0's are held against the JAX local plan and
the numpy oracle here. Meshes: the banks alone, the queries alone, and a
query x bank grid ((2, 1), (1, 3), (2, 2), (4, 2)). The cases: padded
banks, ties planted across bank boundaries, tombstones, aligned summaries
(which prune) and misaligned ones (which do not), 1-row banks, 10 queries
over query blocks that do not divide them, the query-parallel delta scan
with 5 queries, and the adder trees. Integers bit for bit; the sharded bag
bit for bit against a numpy tree sum of the per-bank plain partials, and
within 1e-6 of the JAX local bag.

`jax` is imported inside the tests only, so a rank process never loads it.
"""
import datetime
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.core import embedding as temb
from repro_torch.core import hierarchy as thier
from repro_torch.core import nns as tnns
from repro_torch.core.quantization import QuantizedTensor
from repro_torch.utils import (
    bank_slice,
    make_mesh,
    mesh_axis_size,
)

SRC = Path(__file__).resolve().parents[1] / "src"
JOIN_S = 120.0  # the longest a spawned group may take
GLOO_TIMEOUT_S = 60.0
WORLDS = (2, 3, 4, 8)
# the query x bank grid of each spawned world size
GRIDS = {1: (1, 1), 2: (2, 1), 3: (1, 3), 4: (2, 2), 8: (4, 2)}
N_QUERIES = 10
FIELDS = ("indices", "distances", "counts", "blocks_touched")


# ---------------------------------------------------------------------------
# process groups: one rank in this process, or spawned ranks
# ---------------------------------------------------------------------------
def init_group(rank: int, world: int, directory) -> None:
    """A gloo process group through a `file://` rendezvous in
    `directory` (no TCP port: several test workers share the host)."""
    dist.init_process_group(
        "gloo", init_method=f"file://{Path(directory) / 'rendezvous'}",
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=GLOO_TIMEOUT_S))


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    """A one-rank gloo group for the module's in-process mesh tests."""
    init_group(0, 1, tmp_path_factory.mktemp("rendezvous"))
    yield
    dist.destroy_process_group()


def spawn(script, case: str, world: int, inputs: dict, directory) -> list:
    """Run `case` of `script` on `world` gloo ranks, each its own Python
    process -> every rank's outputs (dicts of arrays), in rank order.

    The ranks read `inputs` from an `.npz` in `directory`. The first rank
    to fail kills every other one and fails the test with its output
    (its traceback); so does a group still running after `JOIN_S`.
    """
    directory = Path(directory)
    np.savez(directory / "inputs.npz", **inputs)
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join(
               p for p in (str(SRC), os.environ.get("PYTHONPATH")) if p)}
    logs = [open(directory / f"rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, str(script), case, str(world), str(r),
         str(directory)], stdout=logs[r], stderr=subprocess.STDOUT, env=env)
        for r in range(world)]
    failed = None
    try:
        deadline = time.monotonic() + JOIN_S
        while failed is None:
            codes = [p.poll() for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                failed = (bad[0], f"exit code {codes[bad[0]]}")
            elif all(c == 0 for c in codes):
                break
            elif time.monotonic() > deadline:
                failed = (codes.index(None), f"still running after {JOIN_S} s")
            else:
                time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()
    if failed is not None:
        rank, why = failed
        text = (directory / f"rank{rank}.log").read_text()
        pytest.fail(f"{case} on {world} ranks: rank {rank} {why}:\n{text}")
    return [dict(np.load(directory / f"out{r}.npz")) for r in range(world)]


def rank_main(cases: dict) -> int:
    """A spawned rank: ``script case world rank directory``."""
    case, world, rank, directory = (sys.argv[1], int(sys.argv[2]),
                                    int(sys.argv[3]), Path(sys.argv[4]))
    torch.set_num_threads(1)
    init_group(rank, world, directory)
    inputs = dict(np.load(directory / "inputs.npz"))
    out = cases[case](inputs, world)
    if "jax" in sys.modules:
        raise AssertionError("a rank process loaded jax")
    np.savez(directory / f"out{rank}.tmp.npz", **out)
    os.replace(directory / f"out{rank}.tmp.npz", directory / f"out{rank}.npz")
    dist.destroy_process_group()
    return 0


def assert_ranks_agree(outs: list) -> None:
    """SPMD: every rank returned the same arrays as rank 0."""
    for r, out in enumerate(outs[1:], 1):
        assert out.keys() == outs[0].keys()
        for k, v in out.items():
            np.testing.assert_array_equal(v, outs[0][k],
                                          err_msg=f"rank {r}: {k}")


def meshes(world: int) -> dict:
    """The spawned ranks' meshes: the banks alone, the queries alone, and
    the query x bank grid."""
    return {"banks": make_mesh((world,), ("banks",), device="cpu"),
            "qp": make_mesh((world,), ("qp",), device="cpu"),
            "grid": make_mesh(GRIDS[world], ("qp", "banks"), device="cpu")}


# ---------------------------------------------------------------------------
# inputs and oracles
# ---------------------------------------------------------------------------
def _t(x):
    """A numpy array as a tensor, uint32 bits viewed as int32."""
    a = np.asarray(x)
    return torch.from_numpy(np.array(a.view(np.int32) if a.dtype == np.uint32
                                     else a))


def _np(x):
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def _popcount(x):
    return np.unpackbits(x.view(np.uint8), axis=-1).sum(-1)


def lexsort_oracle(queries, db, radius, k, n_valid=None, mask=None):
    """Brute-force numpy fixed-radius NNS: threshold, then (distance, row)
    ascending, (-1, BIG_DIST) padded, and the count of matches."""
    d = _popcount(queries[:, None, :] ^ db[None, :, :])
    n = db.shape[0]
    ok = np.arange(n) < (n if n_valid is None else n_valid)
    if mask is not None:
        ok &= mask
    idxs, dists, cnts = [], [], []
    for i in range(queries.shape[0]):
        within = (d[i] <= radius) & ok
        m = np.nonzero(within)[0]
        m = m[np.lexsort((m, d[i][m]))][:k]
        pad = k - len(m)
        idxs.append(np.concatenate([m, np.full(pad, -1)]))
        dists.append(np.concatenate([d[i][m], np.full(pad, tnns.BIG_DIST)]))
        cnts.append(within.sum())
    return (np.stack(idxs).astype(np.int32), np.stack(dists).astype(np.int32),
            np.asarray(cnts, np.int32))


def _near(rng, rows, p=0.15):
    """`rows` with each bit flipped with probability `p`."""
    flips = (rng.random(rows.shape + (32,)) < p).astype(np.uint32)
    return rows ^ (flips << np.arange(32, dtype=np.uint32)).sum(
        -1, dtype=np.uint32)


def nns_scenarios() -> dict:
    """name -> (queries, db, radius, k, n_valid, mask, block_rows,
    scan_block) uint32 signatures; block_rows 0 = no summary, scan_block
    -1 = auto."""
    rng = np.random.default_rng(21)

    def sigs(n, words=8):
        return rng.integers(0, 2**32, (n, words), dtype=np.uint32)

    def clustered(n_blocks, br=128, words=8):
        """Rows of a block share a random base outside their first word:
        the summary's bound then prunes the blocks far from a query."""
        rows = np.repeat(sigs(n_blocks, words), br, axis=0)
        rows[:, 0] = rng.integers(0, 2**32, len(rows), dtype=np.uint32)
        return rows

    out = {}
    db = sigs(100)
    out["pad_dense"] = (_near(rng, db[rng.choice(100, N_QUERIES)]), db, 110,
                        16, -1, None, 0, 0)
    five = sigs(5)
    db = np.tile(five, (20, 1))  # every row tied with 19 others, in all banks
    out["ties"] = (five[rng.integers(0, 5, N_QUERIES)], db, 120, 8, -1, None,
                   0, 0)
    out["ties_streaming"] = (*out["ties"][:7], 16)
    db = sigs(250)
    mask = rng.random(250) > 0.2
    out["masked_streaming"] = (_near(rng, db[rng.choice(250, N_QUERIES)]),
                               db, 110, 16, 230, mask, 0, 32)
    for name, n in (("pruned", 3072), ("misaligned", 3067)):
        db = clustered(24)[:n]
        mask = rng.random(n) > 0.1
        q = _near(rng, db[rng.choice(n, N_QUERIES)], 0.03)
        out[name] = (q, db, 60, 16, 3000, mask, 128, 64)
    db = sigs(3)  # 1-row banks from three banks on
    out["one_row"] = (sigs(N_QUERIES), db, 256, 16, -1, None, 0, 0)
    db = sigs(200)
    out["radius_overflow"] = (db[:N_QUERIES], db, 256, 16, -1, None, 0, 8)
    db = sigs(96)
    out["n_valid_zero"] = (db[:N_QUERIES], db, 30, 16, 0, None, 0, 0)
    return out


def _encode(prefix: str, case: tuple) -> dict:
    q, db, radius, k, n_valid, mask, br, scan = case
    out = {f"{prefix}q": q, f"{prefix}db": db,
           f"{prefix}meta": np.array([radius, k, n_valid, br, scan])}
    if mask is not None:
        out[f"{prefix}mask"] = mask
    return out


def _decode(inputs: dict, prefix: str) -> tuple:
    radius, k, n_valid, br, scan = (int(x) for x in inputs[f"{prefix}meta"])
    mask = inputs.get(f"{prefix}mask")
    return (_t(inputs[f"{prefix}q"]), _t(inputs[f"{prefix}db"]), radius, k,
            None if n_valid < 0 else n_valid,
            None if mask is None else torch.from_numpy(mask), br,
            None if scan < 0 else scan)


def jax_local_plan(case: tuple):
    """The reference's local plan on the whole DB (pruned streaming with a
    summary over the DB when the case has one)."""
    import jax.numpy as jnp

    from repro.core import nns as jnns

    q, db, radius, k, n_valid, mask, br, scan = case
    summary = (jnns.build_block_summary(db, br, db_mask=mask,
                                        n_valid=n_valid) if br else None)
    return jnns.fixed_radius_nns(
        jnp.asarray(q), jnp.asarray(db), radius, k,
        db_mask=None if mask is None else jnp.asarray(mask),
        scan_block=None if scan < 0 else scan,
        n_valid=None if n_valid < 0 else n_valid, summary=summary)


def assert_nns_equal(got: dict, want, oracle, what: str, *,
                     pruned: bool = False) -> None:
    """`got` (field -> array) bit-equal to the JAX result `want` and to
    the numpy oracle; `blocks_touched` where the port pruned (and it must
    have when `pruned`)."""
    for f, o in zip(FIELDS[:3], oracle):
        np.testing.assert_array_equal(got[f], _np(getattr(want, f)),
                                      err_msg=f"{what}: {f} vs jax")
        np.testing.assert_array_equal(got[f], o, err_msg=f"{what}: {f}")
    if pruned:
        assert "blocks_touched" in got, f"{what}: did not prune"
    if "blocks_touched" in got:
        np.testing.assert_array_equal(got["blocks_touched"],
                                      _np(want.blocks_touched),
                                      err_msg=f"{what}: blocks_touched")


def _fields(res, prefix: str = "") -> dict:
    return {f"{prefix}{f}": getattr(res, f).numpy() for f in FIELDS
            if getattr(res, f) is not None}


# ---------------------------------------------------------------------------
# what a spawned rank runs
# ---------------------------------------------------------------------------
def _bank_inputs(mesh, axis, db, mask, br, nv):
    """This rank's bank of the padded DB, its mask and its summary (built
    over the bank's rows; the plan decides whether it prunes)."""
    n_banks, bank = mesh_axis_size(mesh, axis), mesh.get_local_rank(axis)
    bank_db = bank_slice(db, n_banks, bank)
    per = bank_db.shape[0]
    bank_mask = None if mask is None else bank_slice(mask, n_banks, bank,
                                                     fill=False)
    summary = (tnns.build_block_summary(
        bank_db, br, db_mask=bank_mask,
        n_valid=min(max(nv - bank * per, 0), per)) if br else None)
    return bank_db, bank_mask, summary


def rank_nns(inputs: dict, world: int) -> dict:
    """Every scenario through the sharded plan (banks alone, and the grid
    with its query axis) and the query-parallel plan; the query-parallel
    delta scan; `hierarchical_psum` and `sharded_embedding_bag`."""
    ms = meshes(world)
    out = {}
    names = sorted({k.split("/")[0] for k in inputs if "/" in k})
    for name in names:
        q, db, radius, k, n_valid, mask, br, scan = _decode(inputs,
                                                            f"{name}/")
        # the banks pad the rows: the caller's n_valid keeps them out
        nv = db.shape[0] if n_valid is None else n_valid
        for plan in ("banks", "grid"):
            bank_db, bank_mask, summary = _bank_inputs(
                ms[plan], "banks", db, mask, br, nv)
            res = tnns.sharded_fixed_radius_nns(
                ms[plan], "banks", q, bank_db, radius, k, n_valid=nv,
                scan_block=scan, db_mask=bank_mask, summary=summary,
                query_axis="qp" if plan == "grid" else None)
            out.update(_fields(res, f"{name}/{plan}/"))
        summary = (tnns.build_block_summary(db, br, db_mask=mask,
                                            n_valid=n_valid) if br else None)
        res = tnns.query_parallel_nns(
            ms["qp"], "qp", q, db, radius, k, scan_block=scan,
            n_valid=n_valid, db_mask=mask, summary=summary)
        out.update(_fields(res, f"{name}/qp/"))
    for plan in ("qp", "grid"):
        res = tnns.query_parallel_delta_scan(
            ms[plan], "qp", _t(inputs["delta_q"]), _t(inputs["delta_sigs"]),
            _t(inputs["delta_ids"]), 120, 16)
        out.update(_fields(res, f"delta/{plan}/"))
    table = QuantizedTensor(values=_t(inputs["bag_values"]),
                            scales=_t(inputs["bag_scales"]))
    ids, w = _t(inputs["bag_ids"]), _t(inputs["bag_weights"])
    for plan, extra in (("banks", ()), ("grid", ("qp",))):
        mesh = ms[plan]
        n_banks, bank = (mesh_axis_size(mesh, "banks"),
                         mesh.get_local_rank("banks"))
        local = QuantizedTensor(
            values=bank_slice(table.values, n_banks, bank),
            scales=bank_slice(table.scales, n_banks, bank))
        for tag, weights in (("sum", None), ("weighted", w)):
            out[f"bag/{plan}/{tag}"] = thier.sharded_embedding_bag(
                mesh, "banks", local, ids, weights, extra_axes=extra).numpy()
    x = _t(inputs["psum_x"])[dist.get_rank()]
    out["psum"] = thier.hierarchical_psum(x, ms["grid"],
                                          ("banks", "qp")).numpy()
    return out


def np_tree_sum(parts: np.ndarray, fan_in: int = 4) -> np.ndarray:
    """The adder tree in numpy float32: groups of `fan_in`, zero-padded,
    added left to right, level after level."""
    x = parts.astype(np.float32)
    while x.shape[0] > 1:
        pad = (-x.shape[0]) % fan_in
        x = np.concatenate([x, np.zeros((pad,) + x.shape[1:], np.float32)])
        x = x.reshape((-1, fan_in) + x.shape[1:])
        acc = x[:, 0]
        for j in range(1, fan_in):
            acc = acc + x[:, j]
        x = acc
    return x[0]


def _bag_inputs(rng):
    vals = rng.integers(-127, 128, (64, 16)).astype(np.int8)
    scales = (rng.random((64, 1)) * 0.01 + 1e-3).astype(np.float32)
    ids = rng.integers(0, 64, (6, 5)).astype(np.int32)
    ids[rng.random(ids.shape) < 0.25] = -1
    w = rng.normal(size=(6, 5)).astype(np.float32)
    return vals, scales, ids, w


def _plain_partials(vals, scales, ids, w, n_banks):
    """Each bank's partial bag by the port's plain pool (no collective)."""
    table = QuantizedTensor(values=_t(vals), scales=_t(scales))
    return np.stack([thier.bank_bag(QuantizedTensor(
        values=bank_slice(table.values, n_banks, b),
        scales=bank_slice(table.scales, n_banks, b)), _t(ids), b,
        None if w is None else _t(w)).numpy() for b in range(n_banks)])


# ---------------------------------------------------------------------------
# spawned groups
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("world", WORLDS)
def test_mesh_nns_on_gloo_ranks(world, tmp_path):
    import jax.numpy as jnp

    from repro.core import nns as jnns
    from repro.kernels.ref import embedding_pool_ref

    rng = np.random.default_rng(world)
    scen = nns_scenarios()
    inputs = {}
    for name, case in scen.items():
        inputs.update(_encode(f"{name}/", case))
    dq = rng.integers(0, 2**32, (5, 8), dtype=np.uint32)
    dsigs = rng.integers(0, 2**32, (32, 8), dtype=np.uint32)
    dsigs[:3] = dq[:3]  # some delta rows match
    dids = np.full(32, jnns.EMPTY_ID, np.int32)
    dids[:10] = np.sort(rng.choice(500, 10, replace=False))
    vals, scales, ids, w = _bag_inputs(rng)
    px = rng.normal(size=(world, 7)).astype(np.float32)
    inputs.update(delta_q=dq, delta_sigs=dsigs, delta_ids=dids,
                  bag_values=vals, bag_scales=scales, bag_ids=ids,
                  bag_weights=w, psum_x=px)

    outs = spawn(__file__, "nns", world, inputs, tmp_path)
    assert_ranks_agree(outs)
    got = outs[0]
    qp_size, n_banks_grid = GRIDS[world]
    for name, case in scen.items():
        q, db, radius, k, n_valid, mask, br, scan = case
        want = jax_local_plan(case)
        oracle = lexsort_oracle(q, db, radius, k,
                                None if n_valid < 0 else n_valid, mask)
        for plan, n_banks in (("banks", world), ("grid", n_banks_grid),
                              ("qp", None)):
            per = None if n_banks is None else -(-db.shape[0] // n_banks)
            aligned = br and (per is None or per % br == 0)
            sub = {f: got[f"{name}/{plan}/{f}"] for f in FIELDS
                   if f"{name}/{plan}/{f}" in got}
            assert_nns_equal(sub, want, oracle, f"{name}/{plan}",
                             pruned=bool(aligned))
            if not aligned:
                assert "blocks_touched" not in sub, f"{name}/{plan} pruned"
    # pruning really skipped blocks
    assert got["pruned/banks/blocks_touched"].mean() < 24 * 0.5

    jd = jnns.delta_scan(jnp.asarray(dq), jnp.asarray(dsigs),
                         jnp.asarray(dids), 120, 16)
    for plan in ("qp", "grid"):
        for f in FIELDS[:3]:
            np.testing.assert_array_equal(got[f"delta/{plan}/{f}"],
                                          _np(getattr(jd, f)))
    assert got["delta/qp/counts"].sum() > 0

    for plan, n_banks, reps in (("banks", world, 1),
                                ("grid", n_banks_grid, qp_size)):
        for tag, weights in (("sum", None), ("weighted", w)):
            want = np_tree_sum(_plain_partials(vals, scales, ids, weights,
                                               n_banks))
            # the qp ranks hold the same partial: the extra level sums
            # `reps` copies in the tree's order
            want = np_tree_sum(np.stack([want] * reps))
            np.testing.assert_array_equal(got[f"bag/{plan}/{tag}"], want,
                                          err_msg=f"bag {plan} {tag}")
            local = np.asarray(embedding_pool_ref(
                jnp.asarray(vals), jnp.asarray(scales), jnp.asarray(ids),
                None if weights is None else jnp.asarray(weights)))
            np.testing.assert_allclose(got[f"bag/{plan}/{tag}"], reps * local,
                                       rtol=0, atol=1e-6 * reps)
    grid = px.reshape(GRIDS[world] + (-1,))  # rank = qp * banks + bank
    want = np_tree_sum(np.stack([np_tree_sum(row) for row in grid]))
    np.testing.assert_array_equal(got["psum"], want)


# ---------------------------------------------------------------------------
# one rank, in this process
# ---------------------------------------------------------------------------
MATRIX = ("n_valid_zero", "one_row", "pad_dense", "ties", "radius_overflow")


@pytest.mark.parametrize("scenario", MATRIX)
@pytest.mark.parametrize("path", ["sharded", "query_parallel"])
def test_nns_matrix_one_rank(world1, path, scenario):
    """The scale matrix's mesh paths on a one-rank mesh (a streaming scan
    in 16-row chunks): equal to the reference's local plan and to the
    numpy oracle."""
    case = nns_scenarios()[scenario]
    q, db, radius, k, n_valid, _, _, _ = case
    nv = None if n_valid < 0 else n_valid
    if path == "sharded":
        got = tnns.sharded_fixed_radius_nns(
            make_mesh((1,), ("banks",), device="cpu"), "banks", _t(q),
            _t(db), radius, k, n_valid=nv, scan_block=16)
    else:
        got = tnns.query_parallel_nns(
            make_mesh((1,), ("qp",), device="cpu"), "qp", _t(q), _t(db),
            radius, k, scan_block=16, n_valid=nv)
    assert_nns_equal(_fields(got), jax_local_plan(case),
                     lexsort_oracle(q, db, radius, k, nv), scenario)


def _lsh_sigs(n, dim=16, n_bits=128):
    """The reference's signatures of seeded random vectors (its tests'
    `_sigs`, drawn with numpy)."""
    import jax.numpy as jnp

    from repro.core.lsh import lsh_signature

    rng = np.random.default_rng(n)
    proj = rng.normal(size=(dim, n_bits)).astype(np.float32)
    x = rng.normal(size=(n, dim)).astype(np.float32)
    return np.asarray(lsh_signature(jnp.asarray(x), jnp.asarray(proj)))


TOPK_CASES = {
    # name: (n, n queries, K, scan_block, n_valid, mesh, axis, query axis)
    "sharded_matches_unsharded": (64, 2, 16, None, None, (1,), "model",
                                  None),
    "sharded_composes_with_streaming": (96, 3, 16, 17, None, (1,), "model",
                                        None),
    "query_parallel_matches_local": (80, 5, 16, 13, None, (1,), None, "qp"),
    "query_parallel_respects_n_valid": (64, 3, 8, 16, 41, (1,), None, "qp"),
    "sharded_composes_with_query_axis": (96, 5, 16, 17, None, (1, 1),
                                         "model", "qp"),
}


@pytest.mark.parametrize("case", sorted(TOPK_CASES))
def test_nns_topk_mesh_cases_one_rank(world1, case):
    """`tests/test_nns_topk.py`'s mesh cases: the port's plan on a
    one-rank mesh equals the reference's on a one-device mesh and the
    reference's local scan."""
    import jax
    import jax.numpy as jnp

    from repro.core import nns as jnns

    n, nq, k, scan, nv, shape, axis, qaxis = TOPK_CASES[case]
    sigs = _lsh_sigs(n)
    q = sigs[:nq]
    names = tuple(a for a in ("qp", "model") if a in (axis, qaxis))
    jmesh, tmesh = (jax.make_mesh(shape, names),
                    make_mesh(shape, names, device="cpu"))
    kw = dict(scan_block=scan, n_valid=nv)
    if axis is None:
        want = jnns.query_parallel_nns(jmesh, qaxis, jnp.asarray(q),
                                       jnp.asarray(sigs), 25, k, **kw)
        got = tnns.query_parallel_nns(tmesh, qaxis, _t(q), _t(sigs), 25, k,
                                      **kw)
    else:
        want = jnns.sharded_fixed_radius_nns(
            jmesh, axis, jnp.asarray(q), jnp.asarray(sigs), 25, k,
            query_axis=qaxis, **kw)
        got = tnns.sharded_fixed_radius_nns(tmesh, axis, _t(q), _t(sigs), 25,
                                            k, query_axis=qaxis, **kw)
    local = jnns.fixed_radius_nns(jnp.asarray(q), jnp.asarray(sigs), 25, k,
                                  scan_block=0, n_valid=nv)
    for f in FIELDS[:3]:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      _np(getattr(want, f)))
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      _np(getattr(local, f)))
    assert int(got.counts.sum()) > 0


def test_query_parallel_delta_scan_one_rank(world1):
    """`tests/test_catalog.py`'s case: the query-blocked delta scan on a
    one-rank mesh equals the replicated scan (and the reference's)."""
    import jax
    import jax.numpy as jnp

    from repro.core import nns as jnns

    rng = np.random.default_rng(5)
    qs = rng.integers(0, 2**32, (7, 8), dtype=np.uint32)
    dsigs = rng.integers(0, 2**32, (32, 8), dtype=np.uint32)
    dids = np.full(32, jnns.EMPTY_ID, np.int32)
    dids[:10] = np.sort(rng.choice(500, 10, replace=False))
    want = jnns.query_parallel_delta_scan(
        jax.make_mesh((1,), ("qp",)), "qp", jnp.asarray(qs),
        jnp.asarray(dsigs), jnp.asarray(dids), 120, 16)
    got = tnns.query_parallel_delta_scan(
        make_mesh((1,), ("qp",), device="cpu"), "qp", _t(qs), _t(dsigs),
        _t(dids), 120, 16)
    plain = tnns.delta_scan(_t(qs), _t(dsigs), _t(dids), 120, 16)
    for f in FIELDS[:3]:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      _np(getattr(want, f)))
        assert torch.equal(getattr(got, f), getattr(plain, f))


@pytest.mark.parametrize("plan,n_banks", [("dense", 3), ("dense", 7),
                                          ("pruned", 4), ("misaligned", 3)])
def test_bank_decomposition_matches_local_plan(plan, n_banks):
    """`bank_scan` of every bank and `merge_banks`, with no collective
    (`chip_smoke.py` phase H.2's decomposition), equal the reference's
    local plan and the numpy oracle; 7 banks pad the rows."""
    name = {"dense": "pad_dense", "pruned": "pruned",
            "misaligned": "misaligned"}[plan]
    case = nns_scenarios()[name]
    q, db, radius, k, n_valid, mask, br, scan = case
    nv = db.shape[0] if n_valid < 0 else n_valid
    tdb = _t(db)
    tmask = None if mask is None else torch.from_numpy(mask)
    per = -(-db.shape[0] // n_banks)
    banks = []
    for b in range(n_banks):
        bank_db = bank_slice(tdb, n_banks, b)
        bank_mask = None if tmask is None else bank_slice(tmask, n_banks, b,
                                                          fill=False)
        summary = None
        if br and per % br == 0:
            summary = tnns.build_block_summary(
                bank_db, br, db_mask=bank_mask,
                n_valid=min(max(nv - b * per, 0), per))
        banks.append(tnns.bank_scan(_t(q), bank_db, radius, k, bank=b,
                                    n_valid=nv, scan_block=scan,
                                    db_mask=bank_mask, summary=summary))
    got = tnns.merge_banks(banks, k)
    assert_nns_equal(_fields(got), jax_local_plan(case),
                     lexsort_oracle(q, db, radius, k, nv, mask), plan,
                     pruned=plan == "pruned")


def test_tree_sum_matches_sum_any_fanin():
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(13, 7)).astype(np.float32))
    for fan in (2, 4, 8):
        got = thier.tree_sum(x, fan)
        np.testing.assert_allclose(got.numpy(), x.sum(0).numpy(), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(got.numpy(), np_tree_sum(x.numpy(),
                                                               fan))


def test_hierarchical_psum_one_rank(world1):
    mesh = make_mesh((1,), ("model",), device="cpu")
    y = thier.hierarchical_psum(torch.ones(4), mesh, ("model",))
    np.testing.assert_array_equal(y.numpy(), 1.0)


def test_sharded_embedding_bag_one_rank(world1):
    """`tests/test_embedding_hierarchy.py`'s case on a one-rank mesh,
    against the reference's sharded bag on a one-device mesh; and the
    bank decomposition over 4 banks against a numpy tree sum."""
    import jax
    import jax.numpy as jnp

    from repro.core.hierarchy import sharded_embedding_bag
    from repro.core.quantization import QuantizedTensor as JQ
    from repro.kernels.ref import embedding_pool_ref

    vals, scales, ids, w = _bag_inputs(np.random.default_rng(3))
    jt = JQ(values=jnp.asarray(vals), scales=jnp.asarray(scales))
    table = QuantizedTensor(values=_t(vals), scales=_t(scales))
    mesh = make_mesh((1,), ("model",), device="cpu")
    for weights in (None, w):
        jw = None if weights is None else jnp.asarray(weights)
        tw = None if weights is None else _t(weights)
        want = sharded_embedding_bag(jax.make_mesh((1,), ("model",)),
                                     "model", jt, jnp.asarray(ids), jw)
        got = thier.sharded_embedding_bag(mesh, "model", table, _t(ids), tw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
        local = np.asarray(embedding_pool_ref(jt.values, jt.scales,
                                              jnp.asarray(ids), jw))
        four = thier.tree_sum(torch.from_numpy(
            _plain_partials(vals, scales, ids, weights, 4)))
        np.testing.assert_array_equal(
            four.numpy(), np_tree_sum(_plain_partials(vals, scales, ids,
                                                      weights, 4)))
        np.testing.assert_allclose(four.numpy(), local, rtol=0, atol=1e-6)


@pytest.mark.parametrize("plan", ["dense", "streaming", "pruned"])
def test_fixed_radius_nns_async_matches_reference(plan):
    import jax.numpy as jnp

    from repro.core import nns as jnns

    q, db, radius, k, n_valid, mask, br, _ = nns_scenarios()["pruned"]
    scan = {"dense": 0, "streaming": 64, "pruned": 64}[plan]
    jsum = (jnns.build_block_summary(db, br, db_mask=mask)
            if plan == "pruned" else None)
    tsum = (tnns.build_block_summary(db, br, db_mask=mask)
            if plan == "pruned" else None)
    want = jnns.fixed_radius_nns_async(
        jnp.asarray(q), jnp.asarray(db), radius, k, jnp.asarray(mask),
        scan_block=scan, n_valid=n_valid, summary=jsum)
    got = tnns.fixed_radius_nns_async(
        _t(q), _t(db), radius, k, torch.from_numpy(mask), scan_block=scan,
        n_valid=n_valid, summary=tsum)
    assert_nns_equal(_fields(got), want,
                     lexsort_oracle(q, db, radius, k, n_valid, mask), plan,
                     pruned=plan == "pruned")
    with pytest.raises(TypeError, match="tensor"):
        tnns.fixed_radius_nns_async(_t(q), db, radius, k)


def test_embedding_helpers_match_reference():
    """`multi_table_pool` (concat and sum) and the dense round trip on
    the reference's tables; `init_table` draws a quantized table."""
    import jax
    import jax.numpy as jnp

    from repro.core import embedding as jemb

    k1, k2 = jax.random.split(jax.random.key(0))
    jt = {"a": jemb.init_table(k1, 10, 4), "b": jemb.init_table(k2, 10, 4)}
    tt = {k: QuantizedTensor(values=_t(v.values), scales=_t(v.scales))
          for k, v in jt.items()}
    feats = {"a": np.array([[1, -1]], np.int32),
             "b": np.array([[2, 3]], np.int32)}
    jf = {k: jnp.asarray(v) for k, v in feats.items()}
    tf = {k: _t(v) for k, v in feats.items()}
    for combine in ("concat", "sum"):
        want = jemb.multi_table_pool(jt, jf, combine=combine)
        got = temb.multi_table_pool(tt, tf, combine=combine)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-7)
    with pytest.raises(ValueError, match="combine"):
        temb.multi_table_pool(tt, tf, combine="max")
    np.testing.assert_array_equal(
        temb.table_to_dense(tt["a"]).numpy(),
        np.asarray(jemb.table_to_dense(jt["a"])))
    dense = np.asarray(jemb.table_to_dense(jt["b"]))
    back = temb.table_from_dense(_t(dense))
    want = jemb.table_from_dense(jnp.asarray(dense))
    np.testing.assert_array_equal(back.values.numpy(),
                                  np.asarray(want.values))

    gen = torch.Generator().manual_seed(0)
    t = temb.init_table(gen, 100, 32, device="cpu")
    assert t.values.shape == (100, 32) and t.values.dtype == torch.int8
    assert t.scales.shape == (100, 1)
    dense = temb.table_to_dense(t)
    assert 0.03 < float(dense.std()) < 0.07  # 0.05 * N(0, 1)
    again = temb.init_table(torch.Generator().manual_seed(0), 100, 32,
                            device="cpu")
    assert torch.equal(again.values, t.values)


if __name__ == "__main__":
    sys.exit(rank_main({"nns": rank_nns}))
