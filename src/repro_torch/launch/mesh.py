"""Meshes for the port's data- and task-parallel paths, over
``torch.distributed``.

Mirrors ``make_shard_mesh`` / ``make_local_mesh`` of
``repro/launch/mesh.py``. A JAX ``Mesh`` is driven by one host that
calls a sharded program once; here every rank of a process group runs
the same Python — the shape of an MPI program. So each entry point that
takes a mesh (``smo.sharded_binary_smo``, ``dist.fit_taskset``,
``SVC`` / ``SVR(mesh=...)``, the cascade) is a collective call: every
rank of the group calls it with the same arguments, takes its own part
of the work (a contiguous block of the samples, or of a bucket's task
slots), and returns the same full result.

A ``Mesh`` is one axis over a process group: the group, the axis name,
``shape`` as ``{axis: size}`` (so ``mesh.shape[axis]`` reads as in the
reference), this rank's index and the device its tensors live on. Every
collective of the port is ``Mesh.all_reduce`` (``torch.distributed.
all_reduce``: NCCL refuses two ranks on one card, and gloo takes CUDA
tensors for all_reduce, broadcast and barrier only). Under gloo a CUDA
tensor is staged through host memory for the call and copied back (the
paper's host-side MPI; the kernels still run on the card); under NCCL
the call is stream-ordered and reads nothing on the host.

``torch.distributed.DeviceMesh`` is not used for these: on "cuda" it
implies NCCL.

The LM substrate's meshes are ``DeviceMesh`` es with named axes, over
the default process group: ``make_production_mesh`` (the reference's
pod layouts: (data 16, model 16), or (pod 2, data 16, model 16)) and
``make_mesh`` (any shape: the launcher's ``--mesh``, the tests').
``set_mesh`` makes one the current mesh for a block (``current_mesh``),
the counterpart of the reference's ``set_mesh``; the LM's DTensors carry
their own mesh, so only the callers that place tensors read it.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch._device import resolve_device

_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
        "max": dist.ReduceOp.MAX}


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """One named axis over ``group``; this process is rank ``rank``."""

    group: object                 # a torch.distributed ProcessGroup
    axis_names: tuple[str, ...]
    shape: dict                   # {axis: size}
    rank: int
    device: torch.device

    @property
    def size(self) -> int:
        return self.group.size()

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``t`` reduced over the group ("sum", "min" or "max"), in place;
        returns it."""
        if self.group.name() == "gloo" and t.is_cuda:
            host = t.cpu()
            dist.all_reduce(host, op=_OPS[op], group=self.group)
            t.copy_(host)
        else:
            dist.all_reduce(t, op=_OPS[op], group=self.group)
        return t


def _mesh(count: Optional[int], axis: str, group, device) -> Mesh:
    if group is None:
        if not dist.is_initialized():
            raise ValueError(
                "no process group: pass group= or call "
                "torch.distributed.init_process_group first")
        group = dist.group.WORLD
    size = group.size()
    if count is None:
        count = size
    if count != size:
        raise ValueError(
            f"requested {count} ranks on axis {axis!r} but the process "
            f"group has {size}; a mesh spans its whole group")
    return Mesh(group=group, axis_names=(axis,), shape={axis: size},
                rank=group.rank(), device=resolve_device(device))


def make_shard_mesh(n_shards: Optional[int] = None, axis: str = "shards",
                    group=None, device: str | torch.device = "cuda") -> Mesh:
    """1-D mesh for the data-parallel single-problem path
    (``smo.sharded_binary_smo`` / ``SVC(shard="data")``): the axis carries
    the SAMPLE dimension of one QP. ``n_shards=None`` takes the group's
    size; another count raises. ``group`` defaults to the default group
    (``init_process_group``); ``device`` is where this rank computes."""
    return _mesh(n_shards, axis, group, device)


def make_local_mesh(n_workers: int, axis: str = "workers", group=None,
                    device: str | torch.device = "cuda") -> Mesh:
    """1-D mesh of ``n_workers`` ranks for the task-parallel layer
    (``dist.fit_taskset``); ``n_workers`` must be the group's size."""
    return _mesh(n_workers, axis, group, device)


# ------------------------------------------------------ the LM substrate's

_CURRENT: list = []


def make_mesh(shape, axes, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` with axis names ``axes`` over the
    default process group (``init_process_group`` first; its world size
    must be the product of ``shape``). Every rank calls it."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The reference's production layouts: 256 ranks as (data 16, model
    16); with ``multi_pod`` 512 as (pod 2, data 16, model 16), the "pod"
    axis carrying only data-parallel traffic. On one card these exist
    only over a fake process group (``launch.dryrun``)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


@contextlib.contextmanager
def set_mesh(mesh):
    """``mesh`` as the current mesh (``current_mesh``) for the block."""
    _CURRENT.append(mesh)
    try:
        yield mesh
    finally:
        _CURRENT.pop()


def current_mesh():
    """The innermost ``set_mesh`` mesh, or None."""
    return _CURRENT[-1] if _CURRENT else None
