"""Logical-axis sharding rules -> DTensor placements (the port of
``repro/sharding/rules.py``).

Parameters and caches are annotated with LOGICAL axis names
(``Model.specs()``, ``Model.cache_specs()``); a rules table maps them
onto the mesh's axes at launch time. The production layout is 2-D:
"fsdp" (ZeRO-3-style weight sharding over the data axes, gathered on
use) x "tp" (Megatron-style tensor parallelism over the model axis).
MoE experts ride the model axis ("expert").

  fsdp   -> ("pod", "data")  [multi-pod]  /  ("data",)  [single pod]
  tp     -> "model"
  expert -> "model"
  dp     -> batch axis of activations, ("pod", "data")
  sp     -> sequence sharding for giant decode KV caches
  None   -> replicated

``spec`` returns the reference's ``PartitionSpec`` entries as a tuple
(a mesh axis name, a tuple of names, or None per tensor dim);
``placements`` turns it into one ``Shard(dim)`` / ``Replicate()`` per
mesh dim of a ``torch.distributed.DeviceMesh``, after the reference
dry run's divisibility fallback (``fit``). A mesh is a ``DeviceMesh``
(``mesh_dim_names``, ``size(dim)``) or anything with ``axis_names`` and
a ``shape`` mapping axis -> size, as the reference reads a JAX mesh.
"""
from __future__ import annotations

import math

from torch.distributed.tensor import Replicate, Shard


def axis_names(mesh) -> tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def axis_size(mesh, axis: str) -> int:
    if getattr(mesh, "mesh_dim_names", None) is None:
        return mesh.shape[axis]
    return mesh.size(axis_names(mesh).index(axis))


def dp_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in axis_names(mesh))


def rules_for(mesh, *, serve_pure_tp: bool = False) -> dict:
    if mesh is None:  # one device: everything replicated
        return {"fsdp": None, "tp": None, "expert": None, "dp": None,
                "sp": None, None: None}
    dp = dp_axes(mesh)
    model = "model" if "model" in axis_names(mesh) else None
    return {
        # serving keeps weights TP-resident (SERVE_PURE_TP): a contraction
        # over an fsdp-sharded dim would reduce whole activations instead
        # of gathering the weight
        "fsdp": None if serve_pure_tp else (dp if dp else None),
        "tp": model, "expert": model,
        "dp": dp if dp else None,
        "sp": model,
        None: None,
    }


def spec(logical: tuple, mesh, *, serve_pure_tp: bool = False) -> tuple:
    """The mesh axes of each dim of a tensor with these logical axes (a
    one-axis tuple as its name, as ``PartitionSpec`` keeps it)."""
    r = rules_for(mesh, serve_pure_tp=serve_pure_tp)
    return tuple(_entry(r[name]) for name in logical)


def _entry(e):
    return e[0] if isinstance(e, tuple) and len(e) == 1 else e


def divisible(n: int, mesh, axis: str) -> bool:
    if mesh is None or axis not in axis_names(mesh):
        return True
    return n % axis_size(mesh, axis) == 0


def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def fit(entries: tuple, shape, mesh) -> tuple:
    """``entries`` with every dim that its axes' total size does not
    divide left unsharded (the reference dry run's ``_fit``: batch 1 on
    the data axes, 24 heads' columns over 16 ...). A dim of length 1
    stays unsharded on size-1 axes too: the same layout, and DTensor's
    views squeeze such a dim, which they refuse to do to a sharded one."""
    entries = tuple(entries) + (None,) * (len(shape) - len(entries))
    return tuple(
        e if e is None or (n > 1 and n % math.prod(
            axis_size(mesh, a) for a in _axes(e)) == 0) else None
        for n, e in zip(shape, entries))


def placements_of(entries: tuple, mesh) -> list:
    """One placement per mesh dim: ``Shard(d)`` where tensor dim d's entry
    names that mesh axis, else ``Replicate()``. A dim on a tuple of axes
    is sharded on each of them, in the mesh's order. A list (a tuple of
    placement lists is ``local_map``'s several outputs)."""
    where = {}
    for d, e in enumerate(entries):
        for a in _axes(e):
            if a in where:
                raise ValueError(f"mesh axis {a!r} shards two dims of "
                                 f"{entries}")
            where[a] = d
    return [Shard(where[a]) if a in where else Replicate()
            for a in axis_names(mesh)]


def placements(logical: tuple, mesh, shape, *,
               serve_pure_tp: bool = False) -> list:
    """Placements of a tensor of ``shape`` with these logical axes on
    ``mesh``, after ``fit``."""
    if len(logical) != len(shape):
        raise ValueError(f"logical axes {logical} for a tensor of shape "
                         f"{tuple(shape)}")
    return placements_of(
        fit(spec(logical, mesh, serve_pure_tp=serve_pure_tp), shape, mesh),
        mesh)


def dp_placements(mesh, shape, dim: int = 0) -> list:
    """An activation's placements: ``dim`` over the data axes where they
    divide it, replicated on every other mesh axis."""
    logical = tuple("dp" if i == dim else None for i in range(len(shape)))
    return placements(logical, mesh, shape)


def region_grads(in_placements) -> tuple:
    """``local_map``'s ``in_grad_placements`` for a region whose inputs
    have ``in_placements``: an input replicated on a mesh dim where
    another input is sharded is used by each rank of that dim on
    different data, so its gradient there is a sum over those ranks
    (``Partial``); every other placement is its own."""
    from torch.distributed.tensor import Partial
    sharded = {i for pl in in_placements for i, p in enumerate(pl)
               if p.is_shard()}
    return tuple([Partial() if i in sharded and p.is_replicate() else p
                  for i, p in enumerate(pl)] for pl in in_placements)


def local_block(n: int, mesh, placements, dim: int) -> tuple[int, int]:
    """(offset, length) of this rank's block of a dim of ``n`` entries
    under ``placements`` (``torch.chunk``'s blocks, mesh dims in order),
    from the rank's mesh coordinate alone."""
    coord = mesh.get_coordinate()
    lo, size = 0, n
    for i, p in enumerate(placements):
        if isinstance(p, Shard) and p.dim == dim:
            chunk = -(-size // mesh.size(i))
            start = min(coord[i] * chunk, size)
            lo, size = lo + start, min(chunk, size - start)
    return lo, size
