"""Logical-axis sharding rules: how params, optimizer state, caches and
activations map onto a `DeviceMesh` (the port of
`repro/distributed/sharding.py`).

Mesh axes: ("data", "model") single pod, ("pod", "data", "model") multi-pod.

Param dims are tagged with logical tokens:
    "tp"   -> model axis           (TP: heads / mlp / vocab dims)
    "fsdp" -> data axes if FSDP, else None (ZeRO-3 storage sharding)
    "ep"   -> model axis           (expert dim of MoE weight stacks)
    None   -> replicated

Activation constraint points use logical names resolved through the active
`ShardingRules` (a context variable the step builders set):
    act_batch  -> (pod?, data)     act_heads -> model
    act_seq    -> model if seq_shard (sequence parallelism) else None
    act_mlp    -> model            act_experts -> model
    act_vocab  -> model            act_kv_seq -> data for long-context decode

A partition spec is the port's own `PartitionSpec`: a tuple with one entry
a tensor dim, each None, an axis name or a tuple of names, normalized as
JAX's is (a one-name tuple is the name), so ``tuple(spec)`` equals the
reference's. On the torch side a spec becomes DTensor placements
(`placements`): `Shard(d)` on every mesh dim that dim `d`'s entry names,
`Replicate()` on the others; ("pod", "data") shards one dim over both mesh
dims, pod-major, as JAX lays it out.

The mesh travels with the tensors: a DTensor carries its `device_mesh`,
which `constrain` reads, so `ShardingRules` keeps exactly the
reference's fields and no second context variable is needed.
`constrain()` returns its argument itself without rules, so model code
runs unchanged on one device; with rules it redistributes a DTensor
activation to the spec's placements (the reference's
`with_sharding_constraint`). An activation dim the mesh does
not divide stays replicated there: DTensor would shard it unevenly, JAX
pads it, and either way the values are the same.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import re
from typing import Any

import torch

# ---------------------------------------------------------------------------
# partition specs
# ---------------------------------------------------------------------------


class PartitionSpec(tuple):
    """The port's `jax.sharding.PartitionSpec`: ``PartitionSpec(*entries)``,
    one entry a tensor dim (None, an axis name, or a tuple of names; a
    one-name tuple is stored as the name)."""

    def __new__(cls, *entries):
        norm = []
        for e in entries:
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                e = e[0] if len(e) == 1 else (e or None)
            norm.append(e)
        return super().__new__(cls, norm)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


def _axes(entry) -> tuple:
    """The mesh axis names one spec entry shards over."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    data_axes: tuple = ("data",)  # ("pod","data") in multi-pod
    model_axis: str = "model"
    fsdp: bool = False
    seq_shard: bool = False
    kv_seq_data: bool = False  # long-context decode: KV seq over data
    batch_data: bool = True  # decode "2d" mode may replicate batch
    # False when rep_kv_heads doesn't divide the model axis: attention
    # activations replicate over `model` and the KV cache seq-shards over
    # `model` instead; attention WEIGHTS stay channel-sharded either way.
    shard_heads: bool = True
    # shard expert weights' FF dim (not d_model) over the data axes
    moe_ff_fsdp: bool = False

    def param_axis(self, token: str | None):
        if token == "tp" or token == "ep":
            return self.model_axis
        if token == "fsdp":
            return self.data_axes if self.fsdp else None
        return None

    def param_spec(self, tokens: tuple) -> PartitionSpec:
        return P(*[self.param_axis(t) for t in tokens])

    def act_axis(self, name: str | None):
        if name is None:
            return None
        return {
            "act_batch": self.data_axes if self.batch_data else None,
            "act_seq": self.model_axis if self.seq_shard else None,
            "act_kv_seq": self.data_axes if self.kv_seq_data else None,
            "act_heads": self.model_axis if self.shard_heads else None,
            "act_mlp": self.model_axis,
            "act_experts": self.model_axis,
            "act_vocab": self.model_axis,
            "act_embed": None,
        }[name]

    def act_spec(self, names: tuple) -> PartitionSpec:
        return P(*[self.act_axis(n) for n in names])


_ACTIVE_RULES: contextvars.ContextVar[ShardingRules | None] = (
    contextvars.ContextVar("repro_torch_sharding_rules", default=None))


@contextlib.contextmanager
def use_rules(rules: ShardingRules | None):
    token = _ACTIVE_RULES.set(rules)
    try:
        yield
    finally:
        _ACTIVE_RULES.reset(token)


def active_rules() -> ShardingRules | None:
    return _ACTIVE_RULES.get()


def constrain(x: torch.Tensor, names: tuple) -> torch.Tensor:
    """The reference's `with_sharding_constraint` by logical names: `x`
    itself without rules (or when `x` is not a DTensor), else `x`
    redistributed to the names' placements on its mesh."""
    if _ACTIVE_RULES.get() is None or not is_dtensor(x):
        return x
    return to_placements(x, x.device_mesh, act_placements(x, names))


def act_placements(x: torch.Tensor, names: tuple,
                   shape: tuple | None = None) -> tuple:
    """The placements on DTensor `x`'s mesh of an activation of `shape`
    (default `x`'s) under the logical `names` and the active rules (all
    `Replicate()` without rules); a dim the mesh does not divide stays
    whole."""
    from torch.distributed.tensor import Replicate

    rules, mesh = _ACTIVE_RULES.get(), x.device_mesh
    if rules is None:
        return (Replicate(),) * mesh.ndim
    return placements(rules.act_spec(names), mesh,
                      shape=tuple(x.shape if shape is None else shape),
                      strict=False)


# ---------------------------------------------------------------------------
# specs -> DTensor placements
# ---------------------------------------------------------------------------
# a mesh dim standing for several axes, pod-major: the compute mesh's
# flattened ("pod", "data") dim
FLAT_AXES = {"pod_data": ("pod", "data")}


def compute_mesh(mesh):
    """The mesh the DTensors live on: `mesh` itself, or for a ("pod",
    "data", "model") mesh the 2-D (pod_data, model) mesh whose first dim
    is ("pod", "data") flattened pod-major. Every rule names the two axes
    together, so each tensor's blocks are the same; DTensor then reduces
    over both in one collective, and propagates its shardings over two
    mesh dims instead of three (on three the propagation took minutes of
    CPU a step)."""
    names = tuple(mesh.mesh_dim_names)
    if "pod" not in names:
        return mesh
    flat = getattr(mesh, "_repro_compute_mesh", None)
    if flat is None:
        from torch.distributed.device_mesh import DeviceMesh

        ranks = mesh.mesh  # (pod, data, model) rank ids
        flat = DeviceMesh(mesh.device_type,
                          ranks.reshape(-1, ranks.shape[-1]),
                          mesh_dim_names=("pod_data", "model"))
        mesh._repro_compute_mesh = flat  # made once: it makes new groups
    return flat


def _mesh_groups(mesh) -> list:
    """Per mesh dim, the tuple of axis names it stands for."""
    return [FLAT_AXES.get(n, (n,)) for n in mesh.mesh_dim_names]


def placements(spec, mesh, *, shape: tuple | None = None,
               strict: bool = True, what: str = "") -> tuple:
    """DTensor placements of `spec` on `mesh`: `Shard(d)` on each mesh dim
    that dim `d`'s entry names (several names in the mesh's order, so
    ("pod", "data") is pod-major), `Replicate()` on the rest and on every
    mesh dim of one rank (the same layout; DTensor's view rules refuse
    to merge a dim sharded even one way).

    With `shape`, a dim the named mesh dims do not divide raises where
    `strict` (the state and batch placements: JAX's shardings refuse it
    too; `what` names the leaf), and stays replicated otherwise (an
    activation constraint)."""
    from torch.distributed.tensor import Replicate, Shard

    groups = _mesh_groups(mesh)
    out = [Replicate()] * len(groups)
    for d, entry in enumerate(spec):
        axes = _axes(entry)
        if not axes:
            continue
        idx = [i for i, g in enumerate(groups) if set(g) <= set(axes)]
        if tuple(a for i in idx for a in groups[i]) != axes:
            raise ValueError(
                f"{what or 'spec'} {tuple(spec)}: axes {axes} are not whole "
                f"mesh dims in the mesh's order {tuple(groups)}")
        if shape is not None:
            n = 1
            for i in idx:
                n *= mesh.shape[i]
            if shape[d] % n:
                if strict:
                    raise ValueError(
                        f"{what or 'tensor'}: dim {d} of {tuple(shape)} is "
                        f"not divisible by mesh axes {axes} ({n} ranks)")
                continue
        for i in idx:
            if mesh.shape[i] > 1:  # a one-rank mesh dim shards nothing
                out[i] = Shard(d)
    return tuple(out)


def _local_chunk(t: torch.Tensor, place: tuple, mesh) -> torch.Tensor:
    """This rank's block of the full tensor `t` under `place`: each mesh
    dim in order cuts its tensor dim into equal parts and keeps the part
    at this rank's coordinate."""
    from torch.distributed.tensor import Shard

    coord = mesh.get_coordinate()
    for i, p in enumerate(place):
        if isinstance(p, Shard):
            t = t.chunk(mesh.shape[i], dim=p.dim)[coord[i]]
    return t


def place_whole(t: torch.Tensor, mesh, place: tuple):
    """`t` (the same whole tensor on every rank) as a DTensor on `place`:
    this rank keeps its block, no collective runs. A block smaller than
    `t` is a copy, so the whole tensor can go; the whole of `t` is kept
    as it is (a one-rank mesh shares its storage)."""
    from torch.distributed.tensor import DTensor

    local = _local_chunk(t, place, mesh)
    if local.numel() != t.numel():
        local = local.contiguous().clone()
    return DTensor.from_local(local, mesh, place, run_check=False,
                              shape=t.shape, stride=t.stride())


def distribute(t: torch.Tensor, spec, mesh, what: str = ""):
    """`place_whole` under `spec`'s placements; a dim the spec's axes do
    not divide raises, naming `what`."""
    return place_whole(t, mesh, placements(spec, mesh, shape=tuple(t.shape),
                                           what=what))


def shard_tree(tree, specs, mesh, what: str = ""):
    """Every tensor leaf of `tree` distributed under the spec at the same
    place in `specs` (`distribute`); None stays None."""
    return map_tree(lambda path, leaf, spec: distribute(
        leaf, spec, mesh, what=f"{what}{path}"), tree, specs)


def tree_placements(specs, mesh):
    """A spec tree as a tree of placements tuples."""
    return map_tree(lambda _, s: placements(s, mesh), specs)


class NamedSharding:
    """Where a whole tensor goes: a mesh and a `PartitionSpec` (JAX's
    `NamedSharding`); a leaf of the `shardings` trees a checkpoint
    restores onto."""

    __slots__ = ("mesh", "spec")

    def __init__(self, mesh, spec):
        self.mesh, self.spec = mesh, spec

    def place(self, t: torch.Tensor, what: str = ""):
        return distribute(t, self.spec, self.mesh, what=what)


def named_shardings(specs, mesh):
    """A spec tree as a tree of `NamedSharding`s on `mesh`."""
    return map_tree(lambda _, s: NamedSharding(mesh, s), specs)


def map_tree(fn, tree, *others, path: tuple = ()):
    """`fn(path, leaf, *other_leaves)` over the leaves of `tree` (tensors,
    `PartitionSpec`s and `NamedSharding`s) through dicts, lists, tuples,
    NamedTuples and dataclasses; `others` follow its structure down to
    its leaves (None for no tree). None stays None; a path is the keys
    "/"-joined (`_path_str`)."""
    if tree is None:
        return None
    if isinstance(tree, (torch.Tensor, PartitionSpec, NamedSharding)):
        return fn(_path_str(path), tree, *others)

    def kids(get):
        return [None if o is None else get(o) for o in others]

    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *kids(lambda o: o[k]), path=path + (k,))
                for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(**{f.name: map_tree(
            fn, getattr(tree, f.name),
            *kids(lambda o: getattr(o, f.name)), path=path + (f.name,))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_tree(fn, v, *kids(lambda o: getattr(o, f)),
                                     path=path + (f,))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v, *kids(lambda o: o[i]),
                                   path=path + (i,))
                          for i, v in enumerate(tree))
    raise TypeError(f"{_path_str(path)}: not a tree node: {type(tree)}")


def tree_items(tree) -> list:
    """[(path, leaf)] of `tree`'s leaves, in `map_tree`'s order."""
    out = []
    map_tree(lambda path, leaf: out.append((path, leaf)), tree)
    return out


def _path_str(path) -> str:
    """A tree path (dict keys and sequence indices) "/"-joined."""
    return "/".join(str(p) for p in path)


# ---------------------------------------------------------------------------
# param path -> logical tokens (regex on "/"-joined tree path)
# ---------------------------------------------------------------------------
PARAM_PATTERNS: list[tuple[str, tuple]] = [
    # embeddings / heads: vocab over model, embed over fsdp
    (r"embed(/codebooks)?$", ("tp", "fsdp")),
    (r"lm_head(/\d+)?$", ("fsdp", "tp")),
    # attention
    (r"attn/wq/w$", ("fsdp", "tp")),
    (r"attn/wk/w$", ("fsdp", "tp")),
    (r"attn/wv/w$", ("fsdp", "tp")),
    (r"attn/wo/w$", ("tp", "fsdp")),
    (r"attn/w[qkv]/b$", ("tp",)),
    (r"attn/wo/b$", (None,)),
    (r"attn/(q|k)_norm$", (None,)),
    # dense mlp
    (r"mlp/w(i|g)/w$", ("fsdp", "tp")),
    (r"mlp/wo/w$", ("tp", "fsdp")),
    (r"mlp/w./b$", (None,)),
    # moe: expert-stacked weights -> EP over model, inner dims over fsdp
    (r"moe/w(i|g)$", ("ep", "fsdp", None)),
    (r"moe/wo$", ("ep", None, "fsdp")),
    (r"moe/router$", (None, None)),
    (r"moe/shared/w(i|g)/w$", ("fsdp", "tp")),
    (r"moe/shared/wo/w$", ("tp", "fsdp")),
    # mamba2
    (r"ssm/in_proj$", ("fsdp", "tp")),
    (r"ssm/out_proj$", ("tp", "fsdp")),
    (r"ssm/conv_w$", (None, "tp")),
    (r"ssm/conv_b$", ("tp",)),
    (r"ssm/(A_log|D|dt_bias)$", (None,)),
    (r"ssm/norm_w$", ("tp",)),
    # norms / everything small
    (r"(norm|norm1|norm2|final_norm)(/w)?$", (None,)),
]


def logical_tokens_for(path_str: str, ndim: int) -> tuple:
    for pattern, tokens in PARAM_PATTERNS:
        if re.search(pattern, path_str):
            if len(tokens) != ndim:
                # rank mismatch (e.g. stacked-by-layer leading dim): pad left
                return (None,) * (ndim - len(tokens)) + tuple(tokens)
            return tokens
    return (None,) * ndim


_MOE_FF_SWAP = [
    (re.compile(r"moe/w(i|g)$"), ("ep", None, "fsdp")),  # F over data
    (re.compile(r"moe/wo$"), ("ep", "fsdp", None)),
]


def param_partition_specs(params: Any, rules: ShardingRules):
    """Tree of PartitionSpec matching `params` (stacked layer dims -> None).
    Leaves may be tensors of any device, `meta` included."""

    def spec(ps, leaf):
        tokens = logical_tokens_for(ps, leaf.ndim)
        if rules.moe_ff_fsdp:
            for pat, swapped in _MOE_FF_SWAP:
                if pat.search(ps):
                    tokens = ((None,) * (leaf.ndim - len(swapped))
                              + tuple(swapped))
                    break
        return rules.param_spec(tokens)

    return map_tree(spec, params)


# ---------------------------------------------------------------------------
# regions DTensor cannot shard as the reference does: the model calls
# these, and each is the plain op on a plain tensor. A block region
# (`block_of`, `on_local`, `split_blocks`) runs on each rank's blocks,
# its reductions over a mesh dim explicit. Where a rule is missing or
# wrong in the card's torch (2.11), a helper says so; drop it with the
# rule's fix.
# ---------------------------------------------------------------------------
def is_dtensor(x) -> bool:
    return hasattr(x, "device_mesh") and hasattr(x, "placements")


def full(x):
    """A DTensor's whole value as a plain tensor; anything else itself."""
    return x.full_tensor() if is_dtensor(x) else x


def settled(x):
    """A DTensor `x` with its pending sums (`Partial`) all-reduced to
    `Replicate()`; anything else itself. DTensor may otherwise settle
    one by a reduce-scatter onto another dim, and the ops after it follow
    that dim."""
    if not is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate

    return x.redistribute(x.device_mesh, [
        Replicate() if p.is_partial() else p for p in x.placements])


def without_dim(place: tuple, i: int) -> tuple:
    """`place` with mesh dim `i` made `Replicate()`."""
    from torch.distributed.tensor import Replicate

    return tuple(Replicate() if j == i else p for j, p in enumerate(place))


def to_placements(x: torch.Tensor, mesh, place: tuple):
    """`x` on `place`: a DTensor redistributed (itself where it is there
    already), a plain tensor (the same on every rank) kept as this rank's
    block (`place_whole`)."""
    if not is_dtensor(x):
        return place_whole(x, mesh, place)
    return x if tuple(x.placements) == tuple(place) else \
        x.redistribute(mesh, place)


def block_of(x, dim: int):
    """(mesh dim, this rank's first index along `dim`) where exactly one
    mesh dim of more than one rank shards DTensor `x`'s dim `dim`, evenly,
    and no placement of `x` is a pending sum; None otherwise (a plain
    tensor, a dim whole on every rank, or a layout the callers' block
    regions do not take)."""
    from torch.distributed.tensor import Replicate, Shard

    if not is_dtensor(x):
        return None
    dim %= x.ndim
    mesh = x.device_mesh
    if not all(isinstance(p, (Shard, Replicate)) for p in x.placements):
        return None
    idx = [i for i, p in enumerate(x.placements)
           if isinstance(p, Shard) and p.dim == dim and mesh.shape[i] > 1]
    if len(idx) != 1 or x.shape[dim] % mesh.shape[idx[0]]:
        return None
    i = idx[0]
    return i, mesh.get_coordinate()[i] * (x.shape[dim] // mesh.shape[i])


def all_reduce(t: torch.Tensor, op: str, mesh, i: int) -> torch.Tensor:
    """This rank's plain tensor `t` reduced by `op` ("sum", "max") over
    mesh dim `i`'s group: a functional collective, as DTensor issues
    them, so an op recorder counts it (outside autograd)."""
    from torch.distributed import _functional_collectives as funcol

    out = funcol.all_reduce(t, op, (mesh, i))
    return out.wait() if isinstance(out, funcol.AsyncCollectiveTensor) \
        else out


def on_blocks(fn, x, dim: int):
    """`fn(x)` for an `fn` that works along `dim` and entry by entry
    across the other dims (a cumsum). A DTensor runs it on each rank's
    block with `dim` gathered whole first; autograd goes through
    `to_local` / `from_local`, so `fn`'s backward runs on plain tensors
    too (torch 2.11 has no DTensor rule for `flip`, the cumsum's
    backward)."""
    if not is_dtensor(x):
        return fn(x)
    from torch.distributed.tensor import DTensor

    x = replicate_dim(x, dim)
    return DTensor.from_local(fn(x.to_local()), x.device_mesh,
                              x.placements, run_check=False)


def on_local(fn, xs: list, places: list, outs: list, grads: list = None):
    """`fn` over this rank's blocks (`local_map`): each DTensor of `xs` put
    on its entry of `places`, `fn` run on the local tensors, and its
    outputs made DTensors on `outs`. An entry of `grads` (None: the input's
    own placements) lays out that input's gradient block: `Partial()` on a
    mesh dim whose ranks each use the same replicated input for their own
    blocks alone. Autograd goes through `to_local` / `from_local`, so
    `fn`'s backward runs on plain tensors."""
    from torch.distributed.tensor import DTensor

    mesh = xs[0].device_mesh
    grads = grads or [None] * len(xs)
    ys = fn(*(to_placements(x, mesh, p).to_local(grad_placements=g)
              for x, p, g in zip(xs, places, grads)))
    return tuple(DTensor.from_local(y, mesh, p, run_check=False)
                 for y, p in zip(ys, outs))


def write_slice(buf: torch.Tensor, dim: int, start: int,
                val: torch.Tensor) -> None:
    """``buf[..., start:start + n, ...] = val`` along `dim`, in place (n =
    val.shape[dim]). A DTensor `buf` (a decode's KV cache) is written rank
    by rank: `val` goes to `buf`'s placements with `dim` whole, and each
    rank writes the rows that fall in its own block of `dim`."""
    n = val.shape[dim]
    if not is_dtensor(buf):
        buf.narrow(dim, start, n).copy_(val)
        return
    from torch.distributed.tensor import Replicate, Shard

    mesh = buf.device_mesh
    place = tuple(Replicate() if isinstance(p, Shard) and p.dim == dim
                  else p for p in buf.placements)
    val = (place_whole(val, mesh, place) if not is_dtensor(val)
           else val if tuple(val.placements) == place
           else val.redistribute(mesh, place))
    lo, size = 0, buf.shape[dim]  # this rank's block of `dim`
    coord = mesh.get_coordinate()
    for i, p in enumerate(buf.placements):
        if isinstance(p, Shard) and p.dim == dim:
            size //= mesh.shape[i]
            lo += coord[i] * size
    a, b = max(start, lo), min(start + n, lo + size)
    if a < b:
        buf.to_local().narrow(dim, a - lo, b - a).copy_(
            val.to_local().narrow(dim, a - start, b - a))


def pad_zeros(x: torch.Tensor, dim: int, before: int = 0,
              after: int = 0) -> torch.Tensor:
    """`x` with `before` and `after` zero rows along `dim` (`F.pad`). A
    DTensor's pad is a `torch.cat` (the same values) along `dim`, gathered
    whole first, with zeros laid out as `x` is, so the cat keeps the other
    placements: torch 2.11's `constant_pad_nd` rule gives a mesh of two
    dims a one-dim placement."""
    dim %= x.dim()
    if not is_dtensor(x):
        widths = [0, 0] * (x.dim() - 1 - dim) + [before, after]
        return torch.nn.functional.pad(x, widths)
    x = replicate_dim(x, dim)
    row = torch.zeros_like(x.narrow(dim, 0, 1))
    parts = []
    for n in (before, after):
        shape = list(x.shape)
        shape[dim] = n
        parts.append(row.expand(shape) if n else None)
    return torch.cat([t for t in (parts[0], x, parts[1]) if t is not None],
                     dim=dim)


# torch 2.13's DTensor flattens a dim sharded after the first as a
# strided shard; 2.11's view rule refuses to (`matmul`, `einsum`)
FLATTENS_LATER_SHARDS = tuple(
    int(v) for v in torch.__version__.split("+")[0].split(".")[:2]) >= (2, 13)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w``. A DTensor `x` of one token a row (B, 1, D) runs as the
    2-D product that `matmul` folds a plain one into: its local view may
    keep a stride on the size-1 axis that stops the fold, and the batched
    product run instead rounds differently.

    The product flattens `x`'s leading dims, and its backward the
    gradient's. Where DTensor cannot flatten a dim sharded after the
    first (`FLATTENS_LATER_SHARDS` false: torch 2.11), a DTensor `x` has
    its leading dims after the first gathered first, and so has the
    gradient that reaches the product's output (a hook: an op that took
    the output on other placements hands its gradient back on those)."""
    if not is_dtensor(x):
        return x @ w
    if not FLATTENS_LATER_SHARDS:
        x = _lead_whole(x)
    if x.dim() == 3 and x.shape[1] == 1:
        y = (x[:, 0] @ w)[:, None]
    else:
        y = x @ w
    if not FLATTENS_LATER_SHARDS and y.requires_grad and y.dim() > 2:
        y.register_hook(_lead_whole)
    return y


def _lead_whole(x: torch.Tensor) -> torch.Tensor:
    """A DTensor `x` with its dims 1 .. ndim - 2 gathered whole."""
    for d in range(1, x.dim() - 1):
        x = replicate_dim(x, d)
    return x


def einsum(eq: str, *xs: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(eq, *xs)``. The product flattens the batch dims
    (dims in every operand and the output), which DTensor cannot do to a
    dim sharded after the first where `FLATTENS_LATER_SHARDS` is false
    (torch 2.11). There, DTensor operands sharded along batch dims only,
    no mesh dim along two letters, run it on each rank's blocks, an
    operand whole along a mesh dim that another shards cut to its block
    (no collective). Anything else goes to DTensor as it is."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if (FLATTENS_LATER_SHARDS or not all(is_dtensor(x) for x in xs)
            or not any(isinstance(p, Shard) for x in xs
                       for p in x.placements)):
        return torch.einsum(eq, *xs)
    ins, out = eq.replace(" ", "").split("->")
    ins = ins.split(",")
    batch = set(out).intersection(*map(set, ins))
    mesh = xs[0].device_mesh
    letters = []  # per mesh dim: the batch letter it shards, or None
    for i in range(mesh.ndim):
        here = set()
        for spec, x in zip(ins, xs):
            p = x.placements[i]
            if isinstance(p, Shard):
                here.add(spec[p.dim])
            elif not isinstance(p, Replicate):
                return torch.einsum(eq, *xs)  # a pending sum
        if len(here) > 1 or not here <= batch:
            return torch.einsum(eq, *xs)
        letters.append(next(iter(here), None))
    if any(x.device_mesh != mesh for x in xs):
        return torch.einsum(eq, *xs)
    locals_ = []
    for spec, x in zip(ins, xs):
        place = tuple(Replicate() if a is None else Shard(spec.index(a))
                      for a in letters)
        if tuple(x.placements) != place:
            x = x.redistribute(mesh, place)
        locals_.append(x.to_local())
    return DTensor.from_local(
        torch.einsum(eq, *locals_), mesh,
        [Replicate() if a is None else Shard(out.index(a)) for a in letters],
        run_check=False)


def replicate_dim(x: torch.Tensor, dim: int) -> torch.Tensor:
    """`x` itself unless it is a DTensor sharded along `dim`; then `x`
    with that dim gathered whole (its other placements kept)."""
    from torch.distributed.tensor import Replicate, Shard

    if not is_dtensor(x):
        return x
    dim %= x.ndim
    place = tuple(Replicate() if isinstance(p, Shard) and p.dim == dim
                  else p for p in x.placements)
    return x if place == tuple(x.placements) else x.redistribute(
        x.device_mesh, place)


def split_blocks(x: torch.Tensor, sizes: list, dim: int) -> list:
    """`torch.split(x, sizes, dim)`, each part of a DTensor `x` laid out
    as `x` is along its own extent: `dim` is gathered whole (the parts'
    boundaries need not fall on the blocks of `x`), split, and each part
    cut back onto the mesh dims that sharded `dim` where they divide it
    (a local slice, no collective)."""
    from torch.distributed.tensor import Replicate, Shard

    if not is_dtensor(x):
        return list(torch.split(x, sizes, dim))
    dim %= x.ndim
    mesh, place = x.device_mesh, tuple(x.placements)
    parts = torch.split(replicate_dim(x, dim), sizes, dim)
    out = []
    for part, n in zip(parts, sizes):
        want = tuple(
            Replicate() if isinstance(p, Shard) and p.dim == dim
            and n % mesh.shape[i] else p for i, p in enumerate(place))
        out.append(to_placements(part, mesh, want))
    return out


def split_ready(x: torch.Tensor, dim: int, pieces: int) -> torch.Tensor:
    """`x` ready to have dim `dim` split into (`pieces`, rest): itself,
    unless a DTensor whose `dim` is sharded over more ranks than divide
    `pieces` (DTensor cannot view such a split); then that dim is
    gathered whole first, as GSPMD reshards before such a reshape."""
    from torch.distributed.tensor import Shard

    if not is_dtensor(x):
        return x
    dim %= x.ndim
    n = 1
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == dim:
            n *= x.device_mesh.shape[i]
    return x if pieces % n == 0 else replicate_dim(x, dim)
