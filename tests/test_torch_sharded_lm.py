"""The LM substrate sharded over two CPU ranks (gloo, spawned processes:
``torch_shard_helpers.spawn``), against the unsharded port and the
reference, on (data 1, model 2) and (data 2, model 1) meshes.

* Reduced phi4_mini_3p8b, mamba2_780m and zamba2_1p2b, each parameter a
  DTensor placed by the rules (``sharding.place``): the sharded forward's
  logits, and one train step's loss and updated parameters, against the
  unsharded port's on the same weights (the reference's, carried over
  by ``models.convert.from_reference``) and batch. The step is
  ``SGD(lr=1)``, so a parameter's change is its gradient. The unsharded
  port is held to the reference's forward too.
* The counterpart of ``test_perf_variants.py::
  test_window_cache_sp_decode_consistency``: gemma3_12b reduced with
  ``WINDOW_CACHE_SP``, its window caches sequence-sharded over "model",
  prefill and greedy decode against the full forward.
* The launcher: ``launch.train --mesh 1x2 --device cpu --reduced --steps
  3`` on the two ranks, whose loss falls.
* ``MICROBATCHES = 2`` on a (data 2, model 1) mesh: reduced phi4's step,
  its batch rows sharded over "data", against the unsharded port's
  microbatched step.

Bounds (bf16 compute in both runs; a sharded run sums the same products
in another order and rounds partial sums of a split contraction to bf16
before adding them): logits within LOGIT_TOL (3e-2) of the largest
logit, as ``test_torch_lm_model_*.py``; the loss within LOSS_RTOL (1e-3)
and each gradient within GRAD_TOL (5e-2) of its largest magnitude, as
``test_torch_lm_train_*.py``, whose SSM_HEAD_GRAD_TOL (0.25) holds the
Mamba2 per-head vectors, whose gradients sum cancelling terms over every
position (here D as well as A_log and dt_bias: zamba2's D moved 5.2 %
between the two runs), plus two float32 units of the parameter (a
gradient read back as the change of a parameter carries its rounding);
greedy agreement >= 0.8 for the decode.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.models.model import Model as JModel
from repro_torch.configs.base import get_config, reduced
from repro_torch.models.convert import flatten, from_reference
from repro_torch.optim.adamw import SGD
from repro_torch.training.train import make_train_step
from torch_lm_helpers import LOGIT_TOL, assert_logits_close, compiled, f32
from torch_lm_train_helpers import GRAD_TOL, LOSS_RTOL, SSM_HEAD_GRAD_TOL
from torch_shard_helpers import MESHES, port_model, spawn

ARCHS = ["phi4_mini_3p8b", "mamba2_780m", "zamba2_1p2b"]
SSM_HEAD = ("mamba.A_log", "mamba.dt_bias", "mamba.D")
B, S = 2, 32
WINDOW = dict(arch="gemma3_12b", seed=3, tokens=12, prefill=6, max_len=16)
# a microbatched step whose batch rows are sharded over "data"
MICRO = dict(arch="phi4_mini_3p8b", seed=5, batch=4, micro=2)
LAUNCHER = ["--mesh", "1x2", "--device", "cpu", "--reduced", "--steps", "3",
            "--arch", "mamba2_780m", "--batch", "2", "--seq", "32",
            "--lr", "0.1", "--log-every", "1"]


def _batch(cfg, seed=0, b=B) -> dict:
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, S)),
            "labels": rng.integers(0, cfg.vocab_size, (b, S))}


@pytest.fixture(scope="module")
def runs():
    """The reference's weights for each architecture, the reference's and
    the unsharded port's results, and the two ranks' results."""
    cfgs, arrays, batches, ref, port = {}, {}, {}, {}, {}
    for i, arch in enumerate(ARCHS):
        jm = JModel(jreduced(jget_config(arch)))
        params, _ = jm.init(jax.random.PRNGKey(i + 1))
        tree = jax.tree.map(np.asarray, params)
        cfg = cfgs[arch] = reduced(get_config(arch))
        arrays[arch] = {k: np.asarray(v, np.float32)
                        for k, v in flatten(tree).items()}
        batches[arch] = _batch(cfg, i)
        toks = {"tokens": jnp.asarray(batches[arch]["tokens"], jnp.int32)}
        ref[arch] = f32(compiled(jm.forward, params, toks)(params, toks)[0])
        model = from_reference(cfg, tree, device="cpu")
        logits, _ = model.forward({"tokens": batches[arch]["tokens"]})
        model = from_reference(cfg, tree, device="cpu")
        named = dict(model.named_parameters())
        opt = SGD(lr=1.0)
        named, _, metrics = make_train_step(model, opt)(
            named, opt.init(named),
            {k: torch.as_tensor(v) for k, v in batches[arch].items()})
        port[arch] = {"logits": f32(logits), "loss": float(metrics["loss"]),
                      "params": {k: f32(p) for k, p in named.items()}}
    wcfg = reduced(get_config(WINDOW["arch"]))
    jm = JModel(jreduced(jget_config(WINDOW["arch"])))
    wparams, _ = jm.init(jax.random.PRNGKey(WINDOW["seed"]))
    warrays = {k: np.asarray(v, np.float32) for k, v in
               flatten(jax.tree.map(np.asarray, wparams)).items()}
    wtokens = np.random.default_rng(WINDOW["seed"]).integers(
        0, wcfg.vocab_size, (1, WINDOW["tokens"]))
    ranks = spawn([
        ("sharded_lm", dict(cfgs=cfgs, arrays=arrays, batches=batches)),
        ("window_decode", dict(cfg=wcfg, arrays=warrays, tokens=wtokens,
                               prefill=WINDOW["prefill"],
                               max_len=WINDOW["max_len"])),
        ("launcher", dict(argv=LAUNCHER)),
        ("microbatched_step", dict(cfg=cfgs[MICRO["arch"]],
                                   arrays=arrays[MICRO["arch"]],
                                   batch=_batch(cfgs[MICRO["arch"]],
                                                MICRO["seed"],
                                                MICRO["batch"]),
                                   micro=MICRO["micro"]))])
    return {"cfgs": cfgs, "arrays": arrays, "ref": ref, "port": port,
            "ranks": ranks}


@pytest.mark.parametrize("arch", ARCHS)
def test_unsharded_port_matches_reference(runs, arch):
    cfg = runs["cfgs"][arch]
    assert_logits_close(runs["port"][arch]["logits"], runs["ref"][arch],
                        cfg.vocab_size, f"{arch} forward")


@pytest.mark.parametrize("shape", MESHES, ids=["1x2", "2x1"])
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_forward_matches_unsharded(runs, arch, shape):
    cfg = runs["cfgs"][arch]
    got = runs["ranks"]["sharded_lm"][(shape, arch)]
    assert_logits_close(got["logits"], runs["port"][arch]["logits"],
                        cfg.vocab_size, f"{arch} {shape} sharded forward")
    assert_logits_close(got["logits"], runs["ref"][arch], cfg.vocab_size,
                        f"{arch} {shape} sharded forward vs reference")


@pytest.mark.parametrize("shape", MESHES, ids=["1x2", "2x1"])
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_step_matches_unsharded(runs, arch, shape):
    got = runs["ranks"]["sharded_lm"][(shape, arch)]
    want = runs["port"][arch]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
    before = runs["arrays"][arch]
    assert set(got["params"]) == set(want["params"])
    # every parameter a DTensor; on each mesh some are sharded
    assert any("Shard" in p for p in got["placements"].values())
    for name, w in want["params"].items():
        g_want = before[name] - w          # SGD(lr=1): the gradient
        g_got = before[name] - got["params"][name]
        tol = SSM_HEAD_GRAD_TOL if name.endswith(SSM_HEAD) else GRAD_TOL
        scale = float(np.abs(g_want).max())
        err = float(np.abs(g_got - g_want).max())
        # a gradient read back from p - g carries p's float32 rounding
        ulp = float(np.spacing(np.abs(before[name]).max()))
        assert err <= tol * scale + 2 * ulp, (name, err, scale, ulp)


def test_window_cache_sp_decode_consistency(runs):
    got = runs["ranks"]["window_decode"]
    # the window cache is sequence-sharded over "model"
    assert "Shard(dim=1)" in got["window_placements"]
    p = WINDOW["prefill"]
    steps = got["steps"][0, :p]
    want = got["full"][0, p - 1:2 * p - 1]
    agree = (np.argmax(steps, -1) == np.argmax(want, -1)).mean()
    assert agree >= 0.8


def test_launcher_mesh_loss_falls(runs):
    got = runs["ranks"]["launcher"]
    losses = [float(line.split()[3]) for line in got["out"].splitlines()
              if line.startswith("step")]
    assert "mesh=data 1 x model 2" in got["out"]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses
    assert got["rc"] == 0


def test_sharded_microbatches_match_unsharded(runs, monkeypatch):
    """``MICROBATCHES = 2`` on a batch whose rows are sharded over "data"
    (each rank splits its own rows, so every microbatch keeps the
    batch's placements) against the unsharded port's microbatched step
    on the same weights and batch: the same loss and gradient (each
    microbatch holds other rows than the unsharded split's, and the
    mean over them all is the same)."""
    from repro_torch.models import runtime as RT
    arch = MICRO["arch"]
    got = runs["ranks"]["microbatched_step"]
    assert "Shard(dim=0)" in got["rows_sharded"]
    cfg = runs["cfgs"][arch]
    batch = _batch(cfg, MICRO["seed"], MICRO["batch"])
    model = port_model(cfg, runs["arrays"][arch])
    named = dict(model.named_parameters())
    monkeypatch.setattr(RT, "MICROBATCHES", MICRO["micro"])
    opt = SGD(lr=1.0)
    named, _, metrics = make_train_step(model, opt)(
        named, opt.init(named),
        {k: torch.as_tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(got["loss"], float(metrics["loss"]),
                               rtol=LOSS_RTOL)
    before = runs["arrays"][arch]
    for name, p in named.items():
        g_want = before[name] - f32(p)
        g_got = before[name] - got["params"][name]
        scale = float(np.abs(g_want).max())
        ulp = float(np.spacing(np.abs(before[name]).max()))
        err = float(np.abs(g_got - g_want).max())
        assert err <= GRAD_TOL * scale + 2 * ulp, (name, err, scale, ulp)
