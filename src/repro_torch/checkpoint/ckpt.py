"""Numpy-npz checkpoints of nested dicts of tensors (the port of
``repro/checkpoint/ckpt.py``, in its file format).

A file holds ``__meta__`` (JSON: ``keys``, the leaves' paths, and
``step``) and ``arr_0``, ``arr_1``, ... in the order jax flattens the
tree: dict keys sorted at every level, a path's keys joined by ``/``.
So a file either package writes restores in the other, given a ``like``
tree of the same structure: the reference's parameter tree, or the
port's in that layout (``models.convert.to_reference`` of
``named_parameters()``; ``convert.from_reference`` loads it into a
``Model``).
"""
from __future__ import annotations

import json
import os
from typing import Any, Optional

import numpy as np
import torch


def _flatten_with_paths(tree: Any, prefix: tuple = ()) -> list:
    """[(path, leaf)] in jax's order: dict keys sorted, sequences by
    index."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten_with_paths(tree[k], prefix + (str(k),))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _flatten_with_paths(v, prefix + (str(i),))
        return out
    return [(prefix, tree)]


def _unflatten(like: Any, leaves: list) -> Any:
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)
    return build(like)


def _numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save(path: str, tree: Any, *, step: Optional[int] = None) -> None:
    """Write ``tree`` (nested dicts / sequences of tensors or arrays) to
    ``path`` (``.npz``, made so by numpy if missing)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = _flatten_with_paths(tree)
    arrays = {f"arr_{i}": _numpy(v) for i, (_, v) in enumerate(flat)}
    meta = {"keys": ["/".join(p) for p, _ in flat], "step": step}
    np.savez(path, __meta__=json.dumps(meta), **arrays)


def restore(path: str, like: Any) -> Any:
    """The tree saved at ``path``, in the structure of ``like``: each
    leaf a tensor on its ``like`` leaf's device and dtype (numpy arrays
    for numpy leaves). A shape that differs raises."""
    with np.load(_path(path), allow_pickle=False) as data:
        flat = _flatten_with_paths(like)
        leaves = []
        for i, (p, ref) in enumerate(flat):
            new = data[f"arr_{i}"]
            if tuple(ref.shape) != tuple(new.shape):
                raise ValueError(f"shape mismatch for {'/'.join(p)}: "
                                 f"{tuple(ref.shape)} vs {new.shape}")
            if isinstance(ref, torch.Tensor):
                leaves.append(torch.from_numpy(np.array(new)).to(
                    device=ref.device, dtype=ref.dtype))
            else:
                leaves.append(np.asarray(new, dtype=ref.dtype))
    return _unflatten(like, leaves)


def latest_step(path: str) -> Optional[int]:
    """The step ``save`` recorded in the file at ``path``."""
    with np.load(_path(path), allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
    return meta.get("step")
