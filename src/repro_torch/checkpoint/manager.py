"""Checkpoints with atomic commit, in the JAX package's layout
(counterpart of ``repro.checkpoint.manager``):

    <dir>/step_<N>/
        meta.json     (step, tree structure, shapes, dtype names)
        arr_<i>.npy   (one file per leaf, the GLOBAL array)
        COMMITTED     (the commit marker, written last)

The leaves are numbered in ``jax.tree.flatten``'s order (dict keys
sorted, tuples and lists in their order, ``None`` no leaf), so a
checkpoint written here restores in the JAX package and one written
there restores here, leaf for leaf.  A leaf is a numpy array, a torch
tensor (on any device; it is copied to the host) or a Python scalar.
numpy has no bfloat16 or float8: such a leaf is written as its raw bytes
(``|V2`` / ``|V1``, what ``np.save`` writes for the JAX package's
``ml_dtypes`` arrays) under its recorded dtype name, and read back by
viewing the bytes as that torch dtype, so no value is ever cast.

The layout has a single writer: a job of several ranks gathers the
global arrays on one rank, which saves (``launch.train``'s codec).  This
module imports neither JAX nor ``ml_dtypes``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import tempfile
from typing import Any

import numpy as np
import torch

#: restore() placement-leaf sentinel: keep this leaf on the host as numpy
#: (a bfloat16 or float8 leaf, which numpy cannot hold, as a CPU tensor).
HOST = "host"

#: the dtypes numpy has not, by their recorded name: each is written as
#: raw bytes of its width and viewed back through the integer of that width
_RAW = {"bfloat16": (torch.bfloat16, torch.int16),
        "float8_e4m3fn": (torch.float8_e4m3fn, torch.uint8),
        "float8_e5m2": (torch.float8_e5m2, torch.uint8)}


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    """A template leaf without data: its shape and dtype (a torch dtype,
    a numpy dtype or a dtype name)."""
    shape: tuple
    dtype: Any


def dtype_name(dtype) -> str:
    """The JAX package's name of a torch or numpy dtype (``bfloat16``,
    ``float32``, ``int32``, ``float8_e4m3fn`` ...)."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return np.dtype(dtype).name


def _flatten(tree, path=()):
    """(leaves, structure string) in ``jax.tree.flatten``'s order; the
    string is the one ``str(treedef)`` gives in the JAX package."""
    if tree is None:
        return [], "None"
    if isinstance(tree, dict):
        leaves, parts = [], []
        for k in sorted(tree):
            sub, s = _flatten(tree[k])
            leaves += sub
            parts.append(f"{k!r}: {s}")
        return leaves, "{" + ", ".join(parts) + "}"
    if isinstance(tree, (tuple, list)):
        leaves, parts = [], []
        for v in tree:
            sub, s = _flatten(v)
            leaves += sub
            parts.append(s)
        if isinstance(tree, tuple):
            inner = ", ".join(parts) + ("," if len(parts) == 1 else "")
            return leaves, f"({inner})"
        return leaves, "[" + ", ".join(parts) + "]"
    return [tree], "*"


def flatten(tree) -> list:
    """The leaves of ``tree`` in ``jax.tree.flatten``'s order."""
    return _flatten(tree)[0]


def unflatten(like, leaves):
    """A tree shaped like ``like`` with ``leaves`` (in ``flatten``'s order)
    at its leaves."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (tuple, list)):
            return type(node)(build(v) for v in node)
        return next(it)

    return build(like)


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """A leaf as the numpy array ``np.save`` writes, and its dtype name."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        name = dtype_name(t.dtype)
        if name in _RAW:
            raw = t.contiguous().view(_RAW[name][1]).numpy()
            return raw.view(np.dtype(f"V{raw.itemsize}")), name
        return t.numpy(), name
    arr = np.asarray(leaf)
    return arr, arr.dtype.name


def _shape(leaf) -> tuple:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else np.shape(leaf)


def sweep_orphan_tmps(ckpt_dir: str) -> int:
    """Remove ``.tmp_*`` staging dirs left by a crashed or killed ``save``.

    A hard kill between ``mkdtemp`` and ``os.replace`` orphans the
    staging dir; it is invisible to ``restore``/``latest_step`` but would
    live forever.  The layout has one writer, so any ``.tmp_*`` present
    when a new save or prune runs is dead.  Returns the number removed."""
    if not os.path.isdir(ckpt_dir):
        return 0
    n = 0
    for name in os.listdir(ckpt_dir):
        if name.startswith(".tmp_"):
            shutil.rmtree(os.path.join(ckpt_dir, name), ignore_errors=True)
            n += 1
    return n


def save(ckpt_dir: str, step: int, tree: Any, extra: dict | None = None) -> str:
    """Atomically save a tree of global arrays (numpy, torch or scalars)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    sweep_orphan_tmps(ckpt_dir)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    leaves, structure = _flatten(tree)
    try:
        dtypes, shapes = [], []
        for i, leaf in enumerate(leaves):
            arr, name = _to_numpy(leaf)
            dtypes.append(name)
            shapes.append(list(arr.shape))
            np.save(os.path.join(tmp, f"arr_{i}.npy"), arr)
        meta = {
            "step": step,
            "treedef": f"PyTreeDef({structure})",
            "num_leaves": len(leaves),
            "shapes": shapes,
            "dtypes": dtypes,
            "extra": extra or {},
        }
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        with open(os.path.join(tmp, "COMMITTED"), "w") as f:
            f.write("ok")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and \
                os.path.exists(os.path.join(ckpt_dir, name, "COMMITTED")):
            steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def _load(path: str, name: str | None) -> np.ndarray | torch.Tensor:
    """One saved leaf: a numpy array, or a CPU tensor for a dtype that
    numpy has not (its raw bytes viewed as ``name``)."""
    arr = np.load(path)
    if arr.dtype.kind != "V":
        return arr
    if name not in _RAW:
        raise ValueError(f"{path}: raw {arr.dtype} bytes with no dtype "
                         f"record this module reads ({name!r})")
    dtype, raw = _RAW[name]
    if arr.dtype.itemsize != raw.itemsize:
        raise ValueError(f"{path}: cannot reinterpret {arr.dtype} as {name}")
    ints = arr.view(np.int16 if raw == torch.int16 else np.uint8)
    return torch.from_numpy(np.ascontiguousarray(ints)).view(dtype)


def _cast(leaf, dtype):
    """``leaf`` (numpy or a CPU tensor) at the template's dtype."""
    name = dtype_name(dtype) if not isinstance(dtype, str) else dtype
    t = leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(leaf)
    want = _RAW[name][0] if name in _RAW else getattr(torch, name)
    return t if t.dtype == want else t.to(want)


def restore(ckpt_dir: str, template: Any, step: int | None = None,
            shardings: Any = None) -> tuple[Any, dict]:
    """Restore into the structure of ``template`` (leaves with ``shape``
    and ``dtype``: tensors, numpy arrays or :class:`LeafSpec`), each leaf
    checked against its template's shape and cast to its dtype.

    ``shardings``: an optional tree of placements, one per template leaf:
    None (a CPU tensor), a torch device (a tensor there) or ``HOST`` (the
    array as loaded, numpy where numpy has the dtype).  Returns (tree,
    meta)."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no committed checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    t_leaves = flatten(template)
    assert meta["num_leaves"] == len(t_leaves), \
        f"leaf count mismatch: ckpt {meta['num_leaves']} vs template {len(t_leaves)}"
    if shardings is not None:
        s_leaves = [shardings] * len(t_leaves) if not isinstance(
            shardings, (dict, tuple, list)) else _placements(shardings)
        assert len(s_leaves) == len(t_leaves), \
            f"shardings tree has {len(s_leaves)} leaves, template {len(t_leaves)}"
    else:
        s_leaves = [None] * len(t_leaves)
    saved_dtypes = meta.get("dtypes") or [None] * len(t_leaves)
    out = []
    for i, (tmpl, place) in enumerate(zip(t_leaves, s_leaves)):
        arr = _load(os.path.join(d, f"arr_{i}.npy"), saved_dtypes[i])
        assert tuple(arr.shape) == _shape(tmpl), \
            f"leaf {i}: shape {tuple(arr.shape)} != template {_shape(tmpl)}"
        if isinstance(place, str) and place == HOST:
            if isinstance(arr, np.ndarray) and \
                    dtype_name(tmpl.dtype) not in _RAW:
                out.append(arr.astype(np.dtype(dtype_name(tmpl.dtype)),
                                      copy=False))
            else:
                out.append(_cast(arr, tmpl.dtype))
            continue
        t = _cast(arr, tmpl.dtype)
        out.append(t.to(place) if place is not None else t)
    return unflatten(template, out), meta


def _placements(tree) -> list:
    """The placement leaves of a ``shardings`` tree, None kept in place."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _placements(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _placements(v)]
    return [tree]


def prune(ckpt_dir: str, keep: int = 3):
    if not os.path.isdir(ckpt_dir):
        return
    sweep_orphan_tmps(ckpt_dir)
    steps = sorted(
        int(n.split("_")[1]) for n in os.listdir(ckpt_dir)
        if n.startswith("step_")
        and os.path.exists(os.path.join(ckpt_dir, n, "COMMITTED")))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"), ignore_errors=True)
