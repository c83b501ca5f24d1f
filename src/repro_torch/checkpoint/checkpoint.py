"""Fault-tolerant checkpointing of a dict of torch tensors (the port's
counterpart of ``repro/checkpoint/checkpoint.py``), in the reference's
on-disk format, so that a step written by either package restores in
the other:

    <dir>/step_<8 digits>/manifest.json  — step, n_leaves, the tree's
                                           structure, ``extra`` (JSON),
                                           the saving grid, and each
                                           leaf's shape, dtype and spec
    <dir>/step_<8 digits>/arr_<i>.npy    — one file per leaf, the logical
                                           (whole) array
    <dir>/step_<8 digits>/_COMMITTED     — the commit marker, written last

A step is written into ``step_<n>.tmp`` and moved into place with
``os.replace``; the marker follows. The leaves are numbered in the order
in which ``jax.tree_util`` flattens a tree: the keys of a dict sorted,
lists and tuples in order, ``None`` no leaf.

Restart semantics, as the reference's:

* :func:`restore` ignores uncommitted (crashed mid-write) steps and loads
  the newest committed one unless ``step`` is given;
* **elastic restore**: the manifest stores logical shapes, so a block
  saved from one ``n_row × n_col`` grid of shards restores into a solver
  on another grid with the same ``D_pad`` and row map. The manifest's
  ``mesh`` field holds the saving grid, ``{"axes": ["row", "col"],
  "shape": [n_row, n_col]}``;
* each restored leaf is a tensor on the device given (or its template
  leaf's device): a CUDA leaf comes back on the card with its bits.

On ranks (one process per shard, ``core/ranks.py``) a
:class:`CheckpointManager` given the launch's ``link`` writes on its first
member alone, what every rank packed alike, then holds every rank at a
barrier, so that no rank reads a step before it is committed; every rank
then restores the whole step and keeps its own rows.

numpy has no bfloat16, so a bfloat16 leaf is written as the reference
writes it (through ``ml_dtypes``, which the port does without): its
2-byte bit patterns under the ``.npy`` descr ``'<V2'``, with manifest
dtype ``"bfloat16"``; :func:`restore` reads the manifest's dtype and
views the bits as ``torch.bfloat16`` again.
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["save", "restore", "latest_step", "CheckpointManager"]


def _flatten(tree) -> list:
    """The leaves of ``tree`` in ``jax.tree_util``'s order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in _flatten(t)]
    return [tree]


def _unflatten(template, leaves: list):
    """``template``'s structure with its leaves taken from ``leaves``
    (consumed from the front)."""
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _unflatten(template[k], leaves) for k in sorted(template)}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(t, leaves) for t in template)
    return leaves.pop(0)


def _treedef(tree) -> str:
    """The structure as ``str(PyTreeDef)`` spells it (informational)."""
    def spell(t):
        if t is None:
            return "None"
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {spell(t[k])}"
                                   for k in sorted(t)) + "}"
        if isinstance(t, (list, tuple)):
            inner = ", ".join(spell(x) for x in t)
            return f"[{inner}]" if isinstance(t, list) else f"({inner})"
        return "*"
    return f"PyTreeDef({spell(tree)})"


def _spec_leaves(tree, specs) -> list:
    """Each leaf's spec, walking ``specs`` along ``tree``'s structure (a
    spec is itself a list, so the tree decides where the leaves are); a
    missing spec is None."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [sp for k in sorted(tree) for sp in _spec_leaves(
            tree[k], specs.get(k) if isinstance(specs, dict) else None)]
    if isinstance(tree, (list, tuple)):
        return [sp for i, t in enumerate(tree) for sp in _spec_leaves(
            t, specs[i] if isinstance(specs, (list, tuple))
            and len(specs) == len(tree) else None)]
    return [specs]


def _spec_to_json(spec):
    if spec is None:
        return None
    return [list(a) if isinstance(a, (tuple, list)) else a for a in spec]


#: The ``.npy`` descr and manifest dtype of a bfloat16 leaf, as
#: ``ml_dtypes`` (the reference's numpy bfloat16) writes them.
BF16_DESCR, BF16 = "<V2", "bfloat16"


def _save_leaf(path: str, leaf) -> tuple[list, str]:
    """Write one leaf's ``.npy``; returns its shape and manifest dtype."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().resolve_conj().cpu()
        if leaf.dtype == torch.bfloat16:
            bits = leaf.contiguous().view(torch.int16).numpy()
            with open(path, "wb") as f:
                np.lib.format.write_array_header_1_0(
                    f, {"descr": BF16_DESCR, "fortran_order": False,
                        "shape": bits.shape})
                f.write(bits.tobytes())
            return list(bits.shape), BF16
        arr = leaf.numpy()
    else:
        arr = np.asarray(leaf)
    np.save(path, arr)
    return list(arr.shape), str(arr.dtype)


def _load_leaf(path: str, dtype: str) -> torch.Tensor:
    """One leaf's ``.npy`` as a CPU tensor of the manifest's dtype."""
    arr = np.load(path)
    if dtype != BF16:
        return torch.from_numpy(arr)
    if arr.dtype.itemsize != 2:
        raise ValueError(f"{path}: a bfloat16 leaf of {arr.dtype} "
                         "(2-byte elements expected)")
    return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)


def _json_default(o):
    """numpy scalars (``np.int64`` counts) as Python numbers."""
    if isinstance(o, np.generic):
        return o.item()
    raise TypeError(f"{type(o).__name__} is not JSON serializable")


def save(directory: str, step: int, tree, specs=None,
         extra: dict | None = None, grid: tuple | None = None) -> str:
    """Write a committed checkpoint of ``tree`` at ``step``. ``specs``
    (the tree's structure, a spec per leaf, or None) and ``grid`` (the
    saving ``(n_row, n_col)``) go into the manifest."""
    path = os.path.join(directory, f"step_{step:08d}")
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    leaves = _flatten(tree)
    spec_leaves = _spec_leaves(tree, specs)
    meta = {"step": step, "n_leaves": len(leaves),
            "treedef": _treedef(tree), "extra": extra or {},
            "mesh": (None if grid is None else
                     {"axes": ["row", "col"],
                      "shape": [int(grid[0]), int(grid[1])]}),
            "leaves": []}
    for i, (leaf, sp) in enumerate(zip(leaves, spec_leaves)):
        shape, dtype = _save_leaf(os.path.join(tmp, f"arr_{i}.npy"), leaf)
        meta["leaves"].append({"shape": shape, "dtype": dtype,
                               "spec": _spec_to_json(sp)})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(meta, f, default=_json_default)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)
    with open(os.path.join(path, "_COMMITTED"), "w") as f:
        f.write("ok")
    return path


def _committed_steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(
        int(n.split("_")[1]) for n in os.listdir(directory)
        if n.startswith("step_") and not n.endswith(".tmp")
        and os.path.exists(os.path.join(directory, n, "_COMMITTED")))


def latest_step(directory: str) -> int | None:
    """The newest committed step in ``directory``, or None."""
    steps = _committed_steps(directory)
    return steps[-1] if steps else None


def restore(directory: str, template, device=None, step: int | None = None):
    """Load a committed checkpoint (the newest unless ``step``) into the
    structure of ``template``; returns ``(tree, step, extra)``. Each leaf
    becomes a tensor on ``device`` (``resolve_device``; when None, its
    template leaf's device, the CPU for a non-tensor leaf), with the bits
    it was saved with. Raises FileNotFoundError when no committed step is
    there."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        meta = json.load(f)
    leaves = _flatten(template)
    if len(leaves) != meta["n_leaves"]:
        raise ValueError(f"the template has {len(leaves)} leaves, the "
                         f"checkpoint {meta['n_leaves']}: the structure "
                         "changed")
    dev = None if device is None else resolve_device(device)
    out = []
    for i, (leaf, lm) in enumerate(zip(leaves, meta["leaves"])):
        t = _load_leaf(os.path.join(path, f"arr_{i}.npy"), lm["dtype"])
        if list(t.shape) != lm["shape"]:
            raise ValueError(f"leaf {i}: file shape {tuple(t.shape)} != "
                             f"manifest {lm['shape']}")
        to = dev if dev is not None else (
            leaf.device if isinstance(leaf, torch.Tensor)
            else torch.device("cpu"))
        out.append(t.to(to))
    return _unflatten(template, out), step, meta["extra"]


class CheckpointManager:
    """Keep the last ``keep`` committed checkpoints, save every
    ``interval`` steps; survives being pointed at a half-written dir.
    With ``link`` (a ``RankLink`` of the launch's ranks) its first member
    alone writes and collects, and every member waits at a barrier after
    each save (module docstring)."""

    def __init__(self, directory: str, interval: int = 100, keep: int = 3,
                 link=None):
        self.directory = directory
        self.interval = interval
        self.keep = keep
        self.link = link
        os.makedirs(directory, exist_ok=True)

    def due(self, step: int) -> bool:
        """Whether :meth:`maybe_save` saves at ``step``."""
        return step % self.interval == 0

    def maybe_save(self, step: int, tree, specs=None, extra=None,
                   grid=None) -> bool:
        if not self.due(step):
            return False
        if self.link is None or self.link.index == 0:
            save(self.directory, step, tree, specs, extra, grid)
            self._gc()
        if self.link is not None:
            self.link.barrier()
        return True

    def _gc(self) -> None:
        for s in _committed_steps(self.directory)[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"))
