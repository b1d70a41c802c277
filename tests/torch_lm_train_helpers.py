"""Shared pieces of the ``tests/test_torch_lm_train_{a,b,c}.py`` files:
one reduced architecture's loss and gradients through the reference's
``make_loss_fn`` (``jax.value_and_grad``, jitted with XLA's excess
precision off, as ``torch_lm_helpers.compiled``) and through the port's
``make_loss_fn`` and autograd, on the reference's own parameters carried
across (``models.convert.from_reference``) and one numpy-seeded batch;
and the two cases, which each file imports beside its own
``grad_pair`` fixture over its architectures."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import repro.models.layers as JL
import repro.models.mamba2 as JM2
import repro.models.moe as JMOE
import repro_torch.models.layers as TL
import repro_torch.models.mamba2 as TM2
import repro_torch.models.moe as TMOE
from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.models.model import Model as JModel
from repro.training.train import make_loss_fn as jmake_loss_fn
from repro_torch.configs.base import get_config, reduced
from repro_torch.models.convert import flatten, from_reference
from repro_torch.training.train import make_loss_fn
from torch_lm_helpers import batch, compiled

# bf16 compute in both packages (the model files' LOGIT_TOL reading):
# the loss within LOSS_RTOL of the reference's, each gradient tensor
# within GRAD_TOL of its reference gradient's largest magnitude
LOSS_RTOL = 1e-3
GRAD_TOL = 5e-2
# Mamba2's per-head vectors, whose gradient sums a cancelling term from
# every position (sum |term| >> |sum|): bf16 rounding upstream moves it
# by more than GRAD_TOL in the reference itself (mamba2_780m's A_log:
# 8.0 % of its largest magnitude between the reference's bf16 gradient
# and its float32-activation gradient; the port's bf16 gradient is 13.2 %
# from the reference's). Their float32 gradients agree to 1e-5, and
# test_gradients_match_reference_float32 holds every tensor, these too,
# to F32_GRAD_TOL.
SSM_HEAD_GRAD_TOL = 0.25
SSM_HEAD_PARAMS = ("mamba.A_log", "mamba.dt_bias")
# the same comparison with the activations in float32 in both packages
# (ACT_DTYPE): the functions, not bf16 rounding
F32_GRAD_TOL = 1e-4
B, S = 2, 32   # S: one reduced SSD chunk


def train_batch(cfg, seed: int = 0) -> dict:
    """``torch_lm_helpers.batch`` and labels over the real vocab."""
    out = batch(cfg, B, S, seed)
    out["labels"] = np.random.default_rng(seed + 1).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    return out


def reference_and_port(arch: str, seed: int = 1):
    """The reference's model and parameters, the port's model holding
    the same values, and a batch."""
    jcfg, cfg = jreduced(jget_config(arch)), reduced(get_config(arch))
    jm = JModel(jcfg)
    params, _ = jm.init(jax.random.PRNGKey(seed))
    port = from_reference(cfg, jax.tree.map(np.asarray, params),
                          device="cpu")
    return jm, params, port, cfg, train_batch(cfg)


def port_grads(port, total) -> dict:
    named = dict(port.named_parameters())
    got = torch.autograd.grad(total, list(named.values()), allow_unused=True)
    return {k: (g if g is not None else torch.zeros_like(p)).numpy()
            for (k, p), g in zip(named.items(), got)}


def _grads(arch: str) -> dict:
    jm, params, port, cfg, data = reference_and_port(arch)
    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    fn = jax.value_and_grad(jmake_loss_fn(jm), has_aux=True)
    (jtotal, jmetrics), jgrads = compiled(fn, params, jdata)(params, jdata)
    total, metrics = make_loss_fn(port)(data)
    return {"cfg": cfg,
            "ref": {"total": float(jtotal), "loss": float(jmetrics["loss"]),
                    "aux": float(jmetrics["aux"]),
                    "grads": flatten(jax.tree.map(np.asarray, jgrads))},
            "port": {"total": float(total.detach()),
                     "loss": float(metrics["loss"].detach()),
                     "aux": float(metrics["aux"].detach()),
                     "grads": port_grads(port, total)}}


def run_grad_pair(arch: str) -> dict:
    """Both packages' loss and gradients, bf16 compute as they run, and
    again with the activations in float32 (``float32``)."""
    out = _grads(arch)
    with pytest.MonkeyPatch.context() as mp:
        for mod in (JL, JM2, JMOE):
            mp.setattr(mod, "ACT_DTYPE", jnp.float32)
        for mod in (TL, TM2, TMOE):
            mp.setattr(mod, "ACT_DTYPE", torch.float32)
        out["float32"] = _grads(arch)
    return out


def assert_grads_close(got: dict, want: dict, what: str,
                       tol: float) -> None:
    assert set(got) == set(want), (what, set(got) ^ set(want))
    for name, w in want.items():
        g = got[name]
        bound = (SSM_HEAD_GRAD_TOL if tol == GRAD_TOL
                 and name.endswith(SSM_HEAD_PARAMS) else tol)
        assert g.shape == w.shape, (what, name, g.shape, w.shape)
        assert np.isfinite(g).all(), (what, name)
        err = float(np.abs(g - w).max())
        scale = float(np.abs(w).max())
        assert err <= bound * scale, \
            f"{what} {name}: max |port - ref| {err} > {bound} x {scale}"


def test_loss_matches_reference(grad_pair):
    ref, got = grad_pair["ref"], grad_pair["port"]
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["aux"], ref["aux"], rtol=1e-4,
                               atol=1e-7)
    np.testing.assert_allclose(got["total"], ref["total"], rtol=LOSS_RTOL)


def test_gradients_match_reference(grad_pair):
    assert_grads_close(grad_pair["port"]["grads"], grad_pair["ref"]["grads"],
                       grad_pair["cfg"].name, GRAD_TOL)


def test_gradients_match_reference_float32(grad_pair):
    pair = grad_pair["float32"]
    np.testing.assert_allclose(pair["port"]["total"], pair["ref"]["total"],
                               rtol=1e-5)
    assert_grads_close(pair["port"]["grads"], pair["ref"]["grads"],
                       pair["cfg"].name + " float32", F32_GRAD_TOL)
