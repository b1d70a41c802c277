"""Checkpoints (``repro_torch.checkpoint.ckpt``) in the reference's
``.npz`` format, on the CPU: a tree round-trips bit for bit onto its
``like`` tree's device and dtype; a shape that differs raises;
``latest_step`` reads the step; and a file either package writes
restores in the other, for a reduced model's whole parameter tree
(``convert.to_reference`` / ``from_reference`` between the port's names
and the reference's layout) and for the Adam moments.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.models.model import Model as JModel
from repro.optim.adamw import AdamW as JAdamW
from repro_torch.checkpoint import ckpt
from repro_torch.configs.base import get_config, reduced
from repro_torch.models import Model
from repro_torch.models.convert import flatten, from_reference, to_reference


def small_tree():
    rng = np.random.default_rng(0)
    return {"b": {"z": torch.from_numpy(rng.normal(size=(3, 2)).astype(
                np.float32)),
                  "a": torch.arange(5, dtype=torch.int32)},
            "a": [torch.ones(2, dtype=torch.float64),
                  torch.from_numpy(rng.normal(size=(4,)).astype(
                      np.float32)).to(torch.float16)]}


def test_round_trip_and_latest_step(tmp_path):
    tree = small_tree()
    path = str(tmp_path / "sub" / "t")
    ckpt.save(path, tree, step=7)
    assert ckpt.latest_step(path) == 7
    like = {"b": {"z": torch.zeros(3, 2), "a": torch.zeros(5, dtype=torch.int32)},
            "a": [torch.zeros(2, dtype=torch.float64),
                  torch.zeros(4, dtype=torch.float16)]}
    got = ckpt.restore(path + ".npz", like)
    for (pw, w), (pg, g) in zip(ckpt._flatten_with_paths(tree),
                                ckpt._flatten_with_paths(got)):
        assert pw == pg and g.dtype == w.dtype and torch.equal(g, w)
    with np.load(path + ".npz") as data:   # jax's order: keys sorted
        meta = __import__("json").loads(str(data["__meta__"]))
    assert meta["keys"] == ["a/0", "a/1", "b/a", "b/z"]
    ckpt.save(str(tmp_path / "n"), tree)
    assert ckpt.latest_step(str(tmp_path / "n")) is None


def test_restore_casts_to_like_and_rejects_a_shape_mismatch(tmp_path):
    path = str(tmp_path / "t.npz")
    ckpt.save(path, {"w": np.arange(6, dtype=np.float32).reshape(2, 3)})
    got = ckpt.restore(path, {"w": torch.zeros(2, 3, dtype=torch.bfloat16)})
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"].float(), torch.arange(6.0).reshape(2, 3))
    with pytest.raises(ValueError, match="shape mismatch for w"):
        ckpt.restore(path, {"w": torch.zeros(3, 2)})


@pytest.mark.parametrize("arch", ["zamba2_1p2b", "gemma3_12b"])
def test_files_restore_across_packages(arch, tmp_path):
    jcfg, cfg = jreduced(jget_config(arch)), reduced(get_config(arch))
    params, _ = JModel(jcfg).init(jax.random.PRNGKey(3))
    ref_np = jax.tree.map(np.asarray, params)

    # the reference writes, the port restores and loads it into a Model
    jpath = str(tmp_path / "ref.npz")
    jckpt.save(jpath, params, step=11)
    port = Model(cfg, device="cpu")
    port.init(torch.Generator().manual_seed(0))
    like = to_reference(dict(port.named_parameters()))
    restored = ckpt.restore(jpath, like)
    assert ckpt.latest_step(jpath) == 11
    loaded = from_reference(cfg, restored, device="cpu")
    want = flatten(ref_np)
    for k, p in loaded.named_parameters():
        assert np.array_equal(p.detach().numpy(), want[k]), k

    # the port writes (its parameters and its Adam moments, in the
    # reference's layout), the reference restores into its own trees
    tpath = str(tmp_path / "port.npz")
    ckpt.save(tpath, to_reference(dict(loaded.named_parameters())), step=12)
    back = jckpt.restore(tpath, params)
    assert jckpt.latest_step(tpath) == 12
    for w, g in zip(jax.tree.leaves(ref_np), jax.tree.leaves(back)):
        assert np.array_equal(np.asarray(g), w)
    mu = {k: torch.full_like(p, 0.5) for k, p in
          loaded.named_parameters()}
    mpath = str(tmp_path / "mu.npz")
    ckpt.save(mpath, to_reference(mu))
    jmu = jckpt.restore(mpath, JAdamW().init(params).mu)
    assert all(np.all(np.asarray(v) == 0.5) for v in jax.tree.leaves(jmu))
    assert all(v.dtype == jnp.float32 for v in jax.tree.leaves(jmu))
