"""Fault-tolerant checkpointing (mirrors `repro/checkpoint/checkpointer.py`).

  * layout: ``<dir>/step_<N>/`` with one ``.npy`` a leaf (its path in the
    tree as the file name) and ``manifest.json`` (shape, dtype and CRC32 of
    each leaf).
  * atomicity: a save writes ``step_<N>.tmp-<nonce>/``, calls `os.fsync` on
    every file and on the directory, writes the ``COMMITTED`` marker, and
    renames the directory into place with one `os.rename` (then syncs the
    parent). A crashed save never shadows a good checkpoint, and
    `latest_step` believes only directories that hold the marker.
  * integrity: `restore` checks each leaf's CRC32 against the manifest.
  * async: `Checkpointer(async_=True)` copies the tree to host memory in
    the caller's thread (the next step may overwrite the device buffers)
    and writes the files on a background thread; `wait()` joins it.
  * sharded trees: a DTensor leaf is saved whole (`full_tensor()`, a
    collective every rank joins), and only rank 0 writes; `wait()` then
    holds every rank at a barrier until the step is committed. A restore
    places each leaf where `shardings` (a tree of `NamedSharding`s like
    the template) says, or as its template leaf is placed when that is a
    DTensor: a state saved from one mesh restores onto another.

A tree is nested dicts, lists, tuples, NamedTuples and dataclasses (their
init fields); its leaves are tensors, numpy arrays and numpy scalars.
Anything else (ints, strings, None, configs) is structure: it is not
written, and `restore` takes it from the template. A restored tensor
lands on its template's device, with its template's dtype.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import re
import shutil
import threading
import uuid
import zlib
from typing import Any

import numpy as np
import torch

COMMITTED = "COMMITTED"
# tensor dtypes numpy cannot hold, stored as integers of the same width
_BIT_VIEWS = {torch.bfloat16: torch.int16}


def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray, np.generic))


def _children(node):
    """(key, child) pairs of a container node, or None for anything else."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node, key=str)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f, getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f.name, getattr(node, f.name))
                for f in dataclasses.fields(node) if f.init]
    return None


def _leaves(tree, path=()):
    """(path, leaf) for every array leaf of `tree`, in a fixed order."""
    if _is_leaf(tree):
        return [(path, tree)]
    kids = _children(tree)
    if kids is None:
        return []
    return [pair for k, v in kids for pair in _leaves(v, path + (k,))]


def _rebuild(node, path, load):
    """`node` with every array leaf replaced by `load(path, leaf)`."""
    if _is_leaf(node):
        return load(path, node)
    kids = _children(node)
    if kids is None:
        return node
    new = {k: _rebuild(v, path + (k,), load) for k, v in kids}
    if isinstance(node, dict):
        return {k: new[str(k)] for k in node}
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(**new)
    if isinstance(node, (list, tuple)):
        return type(node)(new[str(i)] for i in range(len(node)))
    return dataclasses.replace(node, **new)


def _leaf_filename(path) -> str:
    safe = "__".join(re.sub(r"[^A-Za-z0-9_.-]", "_", p) for p in path)
    return f"{safe or 'leaf'}.npy"


def _host(x) -> np.ndarray:
    """A leaf as a host numpy array (bit views for bfloat16); a DTensor's
    whole value."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if hasattr(x, "full_tensor"):
            x = x.full_tensor()
        if x.dtype in _BIT_VIEWS:
            x = x.view(_BIT_VIEWS[x.dtype])
        return x.cpu().numpy()
    return np.asarray(x)


def _fsync(path) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _sharded(tree) -> bool:
    return any(hasattr(leaf, "device_mesh") for _, leaf in _leaves(tree))


def _writer() -> bool:
    """Whether this process writes a sharded tree (rank 0 does)."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def _barrier() -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.barrier()


def save(directory: str | os.PathLike, step: int, tree: Any, *,
         collective: bool = False) -> pathlib.Path:
    """Atomic synchronous save of `tree` as step `step`. A sharded tree is
    gathered on every rank, written by rank 0, and every rank returns
    once it is committed; so is a tree that every rank of the process
    group holds alike and saves together (`collective`)."""
    leaves = [(path, _host(leaf)) for path, leaf in _leaves(tree)]
    final = pathlib.Path(directory) / f"step_{step:08d}"
    if not (collective or _sharded(tree)):
        return _write(directory, step, leaves)
    if _writer():
        _write(directory, step, leaves)
    _barrier()
    return final


def _write(directory, step: int, leaves) -> pathlib.Path:
    """Write (path, host array) leaves as step `step`, atomically."""
    directory = pathlib.Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"step_{step:08d}"
    tmp = directory / f"step_{step:08d}.tmp-{uuid.uuid4().hex[:8]}"
    tmp.mkdir(parents=True)
    manifest = {"step": step, "leaves": []}
    for path, arr in leaves:
        fname = _leaf_filename(path)
        np.save(tmp / fname, arr)
        _fsync(tmp / fname)
        manifest["leaves"].append({
            "file": fname, "shape": list(arr.shape), "dtype": str(arr.dtype),
            "crc32": zlib.crc32(arr.tobytes()) & 0xFFFFFFFF})
    for name, text in (("manifest.json", json.dumps(manifest)),
                       (COMMITTED, "ok")):
        (tmp / name).write_text(text)
        _fsync(tmp / name)
    _fsync(tmp)
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    _fsync(directory)
    for orphan in directory.glob("step_*.tmp-*"):  # crashed saves
        shutil.rmtree(orphan, ignore_errors=True)
    return final


def latest_step(directory: str | os.PathLike) -> int | None:
    """The largest committed step under `directory`, or None."""
    directory = pathlib.Path(directory)
    if not directory.exists():
        return None
    best = None
    for d in directory.glob("step_*"):
        if not d.is_dir() or ".tmp-" in d.name:
            continue
        if not (d / COMMITTED).exists():
            continue
        m = re.match(r"step_(\d+)$", d.name)
        if m:
            s = int(m.group(1))
            best = s if best is None else max(best, s)
    return best


def restore(directory: str | os.PathLike, step: int, template: Any,
            shardings: Any = None, verify: bool = True) -> Any:
    """Restore step `step` into the structure of `template`: each array
    leaf is read from its file (shapes come from the file), checked
    against its CRC32, and placed on its template leaf's device; a leaf
    with a `NamedSharding` in `shardings` (a tree like the template), or
    whose template leaf is a DTensor, becomes a DTensor placed so."""
    from repro_torch.distributed.sharding import place_whole, tree_items

    directory = pathlib.Path(directory) / f"step_{step:08d}"
    manifest = json.loads((directory / "manifest.json").read_text())
    by_file = {leaf["file"]: leaf for leaf in manifest["leaves"]}
    targets = dict(tree_items(shardings))  # {"a/b": NamedSharding}

    def load(path, tmpl):
        arr = _load(path)
        if not isinstance(tmpl, torch.Tensor):
            return arr[()] if isinstance(tmpl, np.generic) else arr
        target = targets.get("/".join(path))
        if target is None and hasattr(tmpl, "device_mesh"):
            mesh = tmpl.device_mesh
            return place_whole(_tensor(arr, tmpl.dtype, mesh.device_type),
                               mesh, tuple(tmpl.placements))
        if target is None:
            return _tensor(arr, tmpl.dtype, tmpl.device)
        return target.place(_tensor(arr, tmpl.dtype,
                                    target.mesh.device_type),
                            what="/".join(path))

    def _load(path):
        fname = _leaf_filename(path)
        if fname not in by_file:
            raise FileNotFoundError(f"checkpoint missing leaf {fname}")
        arr = np.load(directory / fname)
        if verify and (zlib.crc32(arr.tobytes()) & 0xFFFFFFFF
                       != by_file[fname]["crc32"]):
            raise IOError(f"checksum mismatch for {fname}")
        return arr

    return _rebuild(template, (), load)


def _tensor(arr: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    t = torch.from_numpy(arr)
    if dtype in _BIT_VIEWS:
        t = t.view(dtype)
    return t.to(device)


class Checkpointer:
    """Step-managed checkpointer with optional async I/O and retention of
    the newest `keep` steps."""

    def __init__(self, directory: str | os.PathLike, keep: int = 3,
                 async_: bool = False):
        self.directory = pathlib.Path(directory)
        self.keep = keep
        self.async_ = async_
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None
        self._sharded = False  # the last save was of a sharded tree

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._sharded:  # every rank waits for rank 0's write
            self._sharded = False
            _barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, tree: Any):
        self.wait()
        # to host now: the caller's next step may overwrite the buffers
        leaves = [(path, _host(leaf).copy()) for path, leaf in _leaves(tree)]
        if _sharded(tree):
            self._sharded = True
            if not _writer():
                return
        if not self.async_:
            _write(self.directory, step, leaves)
            self._retain()
            return

        def _run():
            try:
                _write(self.directory, step, leaves)
                self._retain()
            except Exception as e:  # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def _retain(self):
        steps = sorted(
            int(m.group(1)) for d in self.directory.glob("step_*")
            if d.is_dir() and (m := re.match(r"step_(\d+)$", d.name)))
        for s in steps[: -self.keep]:
            shutil.rmtree(self.directory / f"step_{s:08d}",
                          ignore_errors=True)

    def latest(self) -> int | None:
        return latest_step(self.directory)

    def restore_latest(self, template: Any, shardings: Any = None):
        """(step, tree) of the newest committed step, placed as `restore`
        places it, or (None, None)."""
        self.wait()
        step = self.latest()
        if step is None:
            return None, None
        return step, restore(self.directory, step, template, shardings)
