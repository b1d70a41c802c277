"""The sharding rules and the models' logical-axis trees against the
reference's (``repro/sharding/rules.py``, ``Model.init``'s spec tree,
``Model.cache_specs``).

* ``rules.spec`` / ``rules_for`` / ``divisible`` equal the reference's
  for every logical name on no mesh, a (data 2, model 4) mesh and a
  (pod 2, data 2, model 4) mesh, with ``serve_pure_tp`` off and on. The
  reference's functions read only ``axis_names`` (and ``shape`` for
  ``divisible``), so a stand-in mesh serves both packages.
* ``rules.placements`` on a fake ``DeviceMesh`` of the same shapes: one
  ``Shard`` per mesh axis that names a dim (after the reference dry
  run's divisibility fallback), ``Replicate`` elsewhere.
* For every reduced architecture, ``Model.specs()`` names every
  parameter and equals the reference's ``abstract_init`` spec tree with
  the stacked layer axes dropped (the port splits the stacks), and
  ``Model.cache_specs()`` equals the reference's ``cache_specs()`` the
  same way (the port's caches keep ``len`` as a host int).

Exact equality throughout: these are tuples of names.
"""
import types

import pytest
import jax

from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.models import runtime as JRT
from repro.models.model import Model as JModel, abstract_init
from repro.sharding import rules as JR
from repro_torch.configs.base import ARCH_NAMES, get_config, reduced
from repro_torch.models import Model
from repro_torch.models import runtime as TRT
from repro_torch.sharding import rules as R

NAMES = ("fsdp", "tp", "expert", "dp", "sp", None)
MESHES = {"none": None,
          "2x4": (("data", "model"), (2, 4)),
          "2x2x4": (("pod", "data", "model"), (2, 2, 4))}


def standin(which):
    if MESHES[which] is None:
        return None
    axes, shape = MESHES[which]
    return types.SimpleNamespace(axis_names=axes, shape=dict(zip(axes, shape)))


@pytest.mark.parametrize("serve_pure_tp", [False, True])
@pytest.mark.parametrize("which", list(MESHES))
def test_spec_matches_reference(which, serve_pure_tp):
    mesh = standin(which)
    assert R.rules_for(mesh, serve_pure_tp=serve_pure_tp) == \
        JR.rules_for(mesh, serve_pure_tp=serve_pure_tp)
    for a in NAMES:
        for b in NAMES:
            lg = (a, b)
            assert R.spec(lg, mesh, serve_pure_tp=serve_pure_tp) == tuple(
                JR.spec(lg, mesh, serve_pure_tp=serve_pure_tp)), lg
    if mesh is not None:
        assert R.dp_axes(mesh) == JR.dp_axes(mesh)
        for n in (1, 2, 3, 4, 6, 8, 12):
            for axis in ("pod", "data", "model", "other"):
                assert R.divisible(n, mesh, axis) == JR.divisible(n, mesh,
                                                                  axis)


@pytest.mark.parametrize("which", ["2x4", "2x2x4"])
def test_placements_on_a_device_mesh(which):
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.mesh import make_mesh
    axes, shape = MESHES[which]
    with fake_world(int(__import__("math").prod(shape))):
        mesh = make_mesh(shape, axes, device_type="cpu")
        by = dict(zip(axes, range(len(axes))))
        # wq: fsdp (the data axes) on rows, tp ("model") on columns
        pl = R.placements(("fsdp", "tp"), mesh, (64, 128))
        want = [Replicate()] * len(axes)
        for a in R.dp_axes(mesh):
            want[by[a]] = Shard(0)
        want[by["model"]] = Shard(1)
        assert pl == want
        # a dim the axes do not divide stays whole (the reference's _fit)
        pl = R.placements(("fsdp", "tp"), mesh, (3, 6))
        assert pl == [Replicate()] * len(axes)
        # an activation: the batch over the data axes
        pl = R.dp_placements(mesh, (8, 5))
        assert pl[by["model"]] == Replicate()
        assert all(pl[by[a]] == Shard(0) for a in R.dp_axes(mesh))
        # serving keeps weights TP-only
        pl = R.placements(("fsdp", "tp"), mesh, (64, 128), serve_pure_tp=True)
        assert [p for i, p in enumerate(pl) if i != by["model"]] == \
            [Replicate()] * (len(axes) - 1)
        # a local block by torch.chunk's rule
        assert R.local_block(10, mesh, [Shard(0)] * len(axes), 0)[0] == 0


def _drop_stacks(name: str, tree):
    """The reference's logical tuple for a port name: the numeric
    components (layer indices of split stacks) dropped from the path and
    one leading stacked axis from the tuple for each."""
    node, depth = tree, 0
    for part in name.split("."):
        if part.isdigit():
            depth += 1
        else:
            node = node[part]
    assert node[:depth] == (None,) * depth, (name, node)
    return node[depth:]


def _flat(tree, prefix=""):
    if isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}{i}.")
    else:
        for k, v in tree.items():
            if isinstance(v, (dict, list)):
                yield from _flat(v, f"{prefix}{k}.")
            else:
                yield prefix + k, v


@pytest.fixture(params=[False, True], ids=["window_cache", "window_cache_sp"])
def window_sp(request, monkeypatch):
    monkeypatch.setattr(JRT, "WINDOW_CACHE_SP", request.param)
    monkeypatch.setattr(TRT, "WINDOW_CACHE_SP", request.param)
    return request.param


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_model_specs_match_reference(arch, window_sp):
    jm = JModel(jreduced(jget_config(arch)))
    _, jspecs = abstract_init(jm, jax.random.PRNGKey(0))
    port = Model(reduced(get_config(arch)), device="cpu")
    specs = port.specs()
    assert set(specs) == {k for k, _ in port.named_parameters()}
    for name, lg in specs.items():
        assert lg == _drop_stacks(name, jspecs), name
    jcache = jm.cache_specs()
    flat = dict(_flat(port.cache_specs()))
    assert flat, arch
    for name, lg in flat.items():
        assert lg == _drop_stacks(name, jcache), name
    # every cache tensor has its logical axes, and nothing else does
    cache = dict(_flat(_tensors(port.cache_init(2, 8))))
    assert set(cache) == set(flat)


def _tensors(node):
    """A cache tree without its host-int ``len`` entries."""
    if isinstance(node, list):
        return [_tensors(v) for v in node]
    return {k: (_tensors(v) if isinstance(v, (dict, list)) else v)
            for k, v in node.items() if k != "len"}


def test_kernel_wrappers_refuse_dtensors():
    """A DTensor has no device pointer the kernels could read: the LM
    kernels' wrappers raise on one (the sharded model enters them through
    ``local_map`` regions on local blocks) instead of computing anything."""
    import torch
    from torch.distributed.tensor import Replicate, distribute_tensor
    from repro_torch.kernels import ops
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.mesh import make_mesh
    with fake_world(1):
        mesh = make_mesh((1, 1), ("data", "model"), device_type="cpu")

        def dt(*shape):
            return distribute_tensor(torch.zeros(shape), mesh,
                                     [Replicate(), Replicate()])
        q = dt(1, 8, 2, 16)
        with pytest.raises(TypeError, match="DTensor"):
            ops.flash_attention(q, q, q)
        with pytest.raises(TypeError, match="DTensor"):
            ops.ssd_diag(dt(2, 8, 4), dt(2, 8, 4), dt(2, 3, 8, 4),
                         dt(2, 3, 8), dt(2, 3, 8))
