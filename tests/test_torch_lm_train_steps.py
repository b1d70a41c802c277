"""The port's train step beyond one batch's gradient, on the CPU:

* ``runtime.MICROBATCHES = 2`` against the reference's scan over
  microbatches (``repro.training.train.make_train_step``), both steps
  given an optimizer that hands the accumulated gradient back as the new
  parameters: the averaged loss, aux and total within 1e-3 relative, each
  float32 gradient accumulator within 5e-2 of the reference's largest
  magnitude (bf16 compute in both; Mamba2's per-head vectors at 0.25, as
  ``torch_lm_train_helpers`` explains), on the reference's parameters;
* ``Model(remat=True)`` under ``REMAT_POLICY`` "full" and "dots" gives
  the gradient of ``remat=False`` bit for bit;
* the launcher ``repro_torch.launch.train.main`` at a reduced size on
  ``--device cpu`` returns 0 (the loss fell) and writes a checkpoint the
  reference's ``ckpt.restore`` reads into its own parameter tree.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.models import runtime as JRT
from repro.models.model import Model as JModel
from repro.training.train import make_train_step as jmake_train_step
from repro_torch.configs.base import get_config, reduced
from repro_torch.launch import train as launcher
from repro_torch.models import Model
from repro_torch.models import runtime as TRT
from repro_torch.models.convert import flatten, from_reference
from repro_torch.training.train import make_train_step
from torch_lm_helpers import compiled
from torch_lm_train_helpers import (GRAD_TOL, LOSS_RTOL, assert_grads_close,
                                    reference_and_port)


class GradsAsParams:
    """An optimizer whose update returns the gradient it is given as the
    new parameters: the train step then hands back its accumulators."""

    def update(self, grads, state, params):
        return grads, state


@pytest.mark.parametrize("arch", ["zamba2_1p2b", "deepseek_moe_16b"])
def test_microbatches_match_reference_scan(arch, monkeypatch):
    monkeypatch.setattr(JRT, "MICROBATCHES", 2)
    monkeypatch.setattr(TRT, "MICROBATCHES", 2)
    jm, params, port, cfg, data = reference_and_port(arch)
    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    jstep = jmake_train_step(jm, GradsAsParams())
    jgrads, _, jmetrics = compiled(jstep, params, None, jdata)(
        params, None, jdata)
    step = make_train_step(port, GradsAsParams())
    grads, _, metrics = step(dict(port.named_parameters()), None, data)
    for k in ("loss", "aux", "total"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=LOSS_RTOL, atol=1e-7)
    assert all(g.dtype == torch.float32 for g in grads.values())
    assert_grads_close({k: g.numpy() for k, g in grads.items()},
                       flatten(jax.tree.map(np.asarray, jgrads)),
                       f"{cfg.name} micro=2", GRAD_TOL)


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (2, 64)),
           "labels": rng.integers(0, cfg.vocab_size, (2, 64))}
    if cfg.arch_type == "audio":
        out["frames"] = rng.normal(size=(2, cfg.encoder_frames,
                                         cfg.d_model)).astype(np.float32)
    return out


def _grads(cfg, remat, data):
    model = Model(cfg, device="cpu", remat=remat)
    model.init(torch.Generator().manual_seed(0))
    grads, _, metrics = make_train_step(model, GradsAsParams())(
        dict(model.named_parameters()), None, data)
    return grads, metrics


@pytest.mark.parametrize("arch", ["zamba2_1p2b", "gemma3_12b",
                                  "qwen2_moe_a2p7b", "whisper_medium"])
@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_gives_the_same_gradient_bits(arch, policy, monkeypatch):
    cfg = reduced(get_config(arch))
    data = _batch(cfg)
    want, want_m = _grads(cfg, False, data)
    monkeypatch.setattr(TRT, "REMAT_POLICY", policy)
    got, got_m = _grads(cfg, True, data)
    assert torch.equal(got_m["total"], want_m["total"])
    for k in want:
        assert torch.equal(got[k], want[k]), (arch, policy, k)


def test_remat_policy_none_and_unknown(monkeypatch):
    def body(x):
        return x
    monkeypatch.setattr(TRT, "REMAT_POLICY", "none")
    assert TRT.checkpoint_wrap(body) is body
    monkeypatch.setattr(TRT, "REMAT_POLICY", "some")
    with pytest.raises(ValueError, match="REMAT_POLICY"):
        TRT.checkpoint_wrap(body)


def test_launcher_trains_on_cpu_and_writes_a_checkpoint(tmp_path):
    path = str(tmp_path / "ckpt" / "mamba2.npz")
    rc = launcher.main(["--arch", "mamba2_780m", "--reduced", "--steps",
                        "12", "--batch", "2", "--seq", "32", "--lr", "1e-2",
                        "--log-every", "100", "--device", "cpu", "--ckpt",
                        path])
    assert rc == 0
    assert jckpt.latest_step(path) == 12
    like, _ = JModel(jreduced(jget_config("mamba2_780m"))).init(
        jax.random.PRNGKey(0))
    restored = jckpt.restore(path, like)
    model = from_reference(reduced(get_config("mamba2_780m")),
                           jax.tree.map(np.asarray, restored), device="cpu")
    assert all(torch.isfinite(p).all() for p in model.parameters())


def test_launcher_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        launcher.main(["--arch", "mamba2_780m", "--reduced", "--steps", "1"])
