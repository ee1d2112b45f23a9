"""Op-count analysis of one rank's step: the counterpart of
`repro/launch/hlo_analysis.py`.

The port has no HLO. It counts what one rank dispatches instead: every
aten op and every `_c10d_functional` collective, as the op reaches that
rank's local tensors (below DTensor, so shapes are the rank's blocks).
The reference's split stays: a recorder appends one `OpRecord` per
dispatched op (the parsing), and `analyze_ops(records, total_devices)`
sums them into `HLOStats` (its `analyze_hlo`).

Two recorders, one record format:
  * `OpRecorder`, a `TorchDispatchMode` over a real step (such as one
    step on the card): a DTensor op is left to DTensor, which runs it as
    local ops, and those come back through the mode;
  * `FakeOpRecorder`, a `FakeTensorMode` for the dry run
    (`launch/dryrun.py`): it records the ops that reach its fake local
    tensors, and refuses a real tensor larger than `max_real_bytes`.

Conventions, the reference's where it has one:
  * flops: `torch.utils.flop_counter`'s formula of each op that has one
    (mm, addmm, bmm, baddbmm, convolution and their kin), 2 a
    multiply-add. Every dispatched op counts, remat's recomputed forwards
    too; eager code runs every layer and accumulation step, so there is
    no trip count to correct for.
  * collective bytes, one rank's operand under the reference's kind
    names: `all_gather_into_tensor` is `all-gather` and its operand is
    its input (the result / group), `reduce_scatter_tensor` is
    `reduce-scatter` (input = result x group), `all_reduce` and
    `all_to_all_single` are `all-reduce` and `all-to-all` (the input).
    `wait_tensor` is no collective.
  * `hbm_bytes`, the port's stated model of a fused program (it is not
    XLA's count): views and metadata ops 0, pointwise ops their outputs
    only (the reference's charge for an elementwise fusion), every other
    op its inputs plus its outputs.
  * `hbm_bytes_eager`: the inputs plus outputs of every op that is not a
    view, what eager code moves on the card.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict

import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode

# `_c10d_functional` op -> the reference's collective kind
COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_to_all_single": "all-to-all",
}
# ops that move no bytes though their schema does not alias: allocation,
# metadata, the functional collectives' waits and autograd wrappers
_NO_BYTES = {
    "_unsafe_view", "lift_fresh", "empty", "empty_like", "empty_strided",
    "new_empty", "new_empty_strided", "detach", "alias", "wait_tensor",
    "_wrap_tensor_autograd",
}


@dataclasses.dataclass(frozen=True)
class OpRecord:
    """One dispatched op: its name (`aten.mm.default`), its kind
    ("view", "pointwise", "op" or a collective's kind), its tensor inputs
    and outputs as (shape, dtype name) pairs, its flops, and a
    collective's group size (0 otherwise)."""

    op: str
    kind: str
    inputs: tuple
    outputs: tuple
    flops: int = 0
    group: int = 0

    def to_json(self) -> list:
        return [self.op, self.kind, [[list(s), d] for s, d in self.inputs],
                [[list(s), d] for s, d in self.outputs], self.flops,
                self.group]

    @classmethod
    def from_json(cls, row: list) -> "OpRecord":
        op, kind, ins, outs, flops, group = row
        return cls(op, kind, tuple((tuple(s), d) for s, d in ins),
                   tuple((tuple(s), d) for s, d in outs), flops, group)


@dataclasses.dataclass
class HLOStats:
    flops: float
    hbm_bytes: float
    collective_bytes: float  # one rank's operand bytes, summed over ops
    per_collective: dict  # kind -> bytes
    collective_count: int
    hbm_bytes_eager: float = 0.0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def _tensors(tree) -> list:
    return [t for t in torch.utils._pytree.tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


def _sig(tensors) -> tuple:
    return tuple((tuple(int(n) for n in t.shape), str(t.dtype)[6:])
                 for t in tensors)


def _group_size(func, args, kwargs) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group

    i = [a.name for a in func._schema.arguments].index("group_name")
    return _resolve_process_group(
        kwargs.get("group_name", args[i] if i < len(args) else None)).size()


def record_of(func, args, kwargs, out) -> OpRecord:
    """The record of `func(*args, **kwargs)` that returned `out`."""
    from torch.utils.flop_counter import flop_registry

    ns, name = func.namespace, func._schema.name.split("::")[-1]
    outs = _tensors(out)
    kind = "op"
    if ns == "_c10d_functional" and name in COLLECTIVES:
        kind = COLLECTIVES[name]
    elif func.is_view or name in _NO_BYTES or not outs:
        kind = "view"
    elif torch.Tag.pointwise in func.tags:
        kind = "pointwise"
    flops = 0
    formula = flop_registry.get(func._overloadpacket)
    if formula is not None:
        flops = int(formula(*args, **kwargs, out_val=out))
    return OpRecord(f"{ns}.{name}.{func._overloadname}", kind,
                    _sig(_tensors((args, kwargs))), _sig(outs), flops,
                    _group_size(func, args, kwargs)
                    if kind in COLLECTIVES.values() else 0)


class OpRecorder(TorchDispatchMode):
    """Records every op a real step dispatches on this rank's tensors."""

    def __init__(self):
        super().__init__()
        self.records: list[OpRecord] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor runs it as local ops, seen here
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not any(isinstance(t, FakeTensor)
                   for t in _tensors((args, kwargs))):
            # (DTensor infers its outputs' shapes on fake tensors, which is
            # no work of the rank's)
            self.records.append(record_of(func, args, kwargs, out))
        return out


def check_real(args, limit: int | None, what) -> None:
    """Raise where a real (not fake) tensor of more than `limit` bytes is
    among `args` (a DTensor counts by its local block)."""
    if limit is None:
        return
    for t in _tensors(args):
        local = t._local_tensor if hasattr(t, "_local_tensor") else t
        if isinstance(local, FakeTensor) or local.device.type == "meta":
            continue
        n = local.numel() * local.element_size()
        if n > limit:
            raise RuntimeError(
                f"dry run: a real tensor of {n} B {tuple(local.shape)} "
                f"{local.dtype} reached {what}; only fake tensors may be "
                f"larger than {limit} B")


class FakeOpRecorder(FakeTensorMode):
    """The dry run's recorder: a `FakeTensorMode` that records each op
    reaching its fake tensors, once at its top level (a decomposition the
    mode runs inside is not counted again), and refuses a real input of
    more than `max_real_bytes`."""

    def __init__(self, max_real_bytes: int | None = 1 << 20):
        super().__init__(allow_non_fake_inputs=True)
        self.records: list[OpRecord] = []
        self.max_real_bytes = max_real_bytes
        self._depth = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        check_real((args, kwargs), self.max_real_bytes, func)
        self._depth += 1
        try:
            out = super().__torch_dispatch__(func, types, args, kwargs)
        finally:
            self._depth -= 1
        if self._depth == 0:
            self.records.append(record_of(func, args, kwargs, out))
        return out


def _bytes(sig) -> int:
    total = 0
    for shape, dtype in sig:
        n = getattr(torch, dtype).itemsize
        for d in shape:
            n *= d
        total += n
    return total


def analyze_ops(records, total_devices: int = 1) -> HLOStats:
    """Sum one rank's records (`OpRecord`s) into the reference's stats.
    A collective's operand comes from its result and group size as the
    reference derives it (`total_devices` where no group was recorded).
    """
    flops = hbm = eager = coll = 0
    count = 0
    per: dict[str, float] = defaultdict(float)
    for r in records:
        flops += r.flops
        if r.kind == "view":
            continue
        ins, outs = _bytes(r.inputs), _bytes(r.outputs)
        eager += ins + outs
        if r.kind == "pointwise":
            hbm += outs
            continue
        hbm += ins + outs
        if r.kind in COLLECTIVES.values():
            g = r.group or total_devices
            operand = (outs / g if r.kind == "all-gather" else
                       outs * g if r.kind == "reduce-scatter" else outs)
            coll += operand
            per[r.kind] += operand
            count += 1
    return HLOStats(flops=float(flops), hbm_bytes=float(hbm),
                    collective_bytes=float(coll), per_collective=dict(per),
                    collective_count=count, hbm_bytes_eager=float(eager))
