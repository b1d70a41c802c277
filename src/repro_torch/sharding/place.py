"""A model's parameters, a batch and caches as DTensors on a mesh (the
counterpart of the reference launcher's ``device_put`` with the rules'
shardings, ``repro/launch/train.py:80-92``, and of its dry run's
in / out shardings, ``repro/launch/dryrun.py:104-167``).

Every tensor becomes a ``DTensor`` with the placements of
``rules.placements`` on its logical axes; the model's ops then propagate
sharding (DTensor's rules, the counterpart of XLA's GSPMD), and its two
hand-written kernels are entered through ``local_map`` regions on whole
heads (``layers.flash``, ``mamba2.ssd_diag_chunks``). Each placement
takes the tensor's local block on this rank from the rank's own full
copy (``src_data_rank=None``: no collective): every rank must hold the
same values, as the seeded init and batches give them.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.sharding import rules as R


def tp_only(logical: tuple) -> tuple:
    """A weight's logical axes with every axis but "tp" dropped: its
    placement at a use under ``runtime.GATHER_WEIGHTS`` (the reference's
    ``wgather``)."""
    return tuple("tp" if a == "tp" else None for a in logical)


def distribute(t: torch.Tensor, mesh, placements) -> DTensor:
    return distribute_tensor(t, mesh, placements, src_data_rank=None)


def shard_params(model, mesh, *, serve_pure_tp: bool = False) -> dict:
    """Every parameter of ``model`` replaced, in its module, by an
    ``nn.Parameter`` holding a DTensor placed by the rules on its logical
    axes (``model.specs()``); ``model.mesh`` set, so its entry points run
    under DTensor's implicit replication of the plain tensors they make.
    Each parameter keeps its TP-only placements as ``gather_placements``
    (read by ``layers.w`` under ``runtime.GATHER_WEIGHTS``). Returns the
    parameters by name, as ``model.init`` does."""
    specs = model.specs()
    for prefix, mod in model.named_modules():
        for name, p in list(mod.named_parameters(recurse=False)):
            logical = specs[f"{prefix}.{name}" if prefix else name]
            new = nn.Parameter(
                distribute(p.detach(), mesh, R.placements(
                    logical, mesh, p.shape, serve_pure_tp=serve_pure_tp)),
                requires_grad=p.requires_grad)
            new.gather_placements = R.placements(tp_only(logical), mesh,
                                                 p.shape)
            setattr(mod, name, new)
    model.mesh = mesh
    return dict(model.named_parameters())


def _mesh(mesh):
    from repro_torch.launch.mesh import current_mesh
    mesh = current_mesh() if mesh is None else mesh
    if mesh is None:
        raise ValueError("no mesh: pass mesh= or place the call inside "
                         "launch.mesh.set_mesh(mesh)")
    return mesh


def shard_batch(batch: dict, mesh=None, device=None) -> dict:
    """A batch's tensors (numpy or torch, on ``device``) as DTensors whose
    batch dim is sharded over the data axes where they divide it (on
    ``mesh``, by default the current one: ``launch.mesh.set_mesh``)."""
    mesh = _mesh(mesh)
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v, device=device)
        out[k] = distribute(t, mesh, R.dp_placements(mesh, t.shape))
    return out


def shard_cache(caches, logical, mesh=None):
    """``caches`` (``Model.cache_init``: lists and dicts of tensors and
    host-int ``len``) with each tensor a DTensor placed by ``logical``
    (``Model.cache_specs()``, the same structure without ``len``), on
    ``mesh`` (by default the current one)."""
    mesh = _mesh(mesh)
    if isinstance(caches, list):
        return [shard_cache(c, lg, mesh)
                for c, lg in zip(caches, logical, strict=True)]
    out = {}
    for k, v in caches.items():
        if k == "len":
            out[k] = v
        elif isinstance(v, torch.Tensor):
            out[k] = distribute(v, mesh, R.placements(logical[k], mesh,
                                                      v.shape))
        else:
            out[k] = shard_cache(v, logical[k], mesh)
    return out
