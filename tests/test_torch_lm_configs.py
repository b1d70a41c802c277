"""The port's LM configurations, its parameter trees, its own random
init and its token pipeline, against the reference's.

* Every field of every ``ModelConfig`` (full and ``reduced``), its
  derived sizes (``param_count``, ``active_param_count``,
  ``padded_vocab``, ``padded_experts``, ``attn_layers``), the input
  shapes and the architecture lists equal the reference's.
* The port's ``Model`` has exactly the reference's parameters, name for
  name (stacked layer axes split, ``models.convert.flatten``) and shape
  for shape, at every reduced architecture; so its parameter count is
  the reference tree's (shapes from ``abstract_init``, nothing drawn).
* ``Model.init`` draws the reference's distributions from an explicit
  generator, and the same seed gives the same tensors.
* ``data.lm.token_batches`` yields the reference's batches.
"""
import dataclasses

import numpy as np
import jax
import pytest
import torch

from repro.configs import base as JB
from repro.data import lm as jlm
from repro.models.model import Model as JModel
from repro.models.model import abstract_init
from repro_torch.configs import base as TB
from repro_torch.data import lm as tlm
from repro_torch.models import convert
from repro_torch.models.model import Model


@pytest.mark.parametrize("arch", JB.ARCH_NAMES)
def test_configs_equal_reference(arch):
    for make in (lambda m, a: m.get_config(a),
                 lambda m, a: m.reduced(m.get_config(a))):
        want, got = make(JB, arch), make(TB, arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        for attr in ("param_count", "active_param_count"):
            assert getattr(got, attr)() == getattr(want, attr)()
        for attr in ("padded_vocab", "padded_experts", "attn_layers"):
            assert getattr(got, attr) == getattr(want, attr)
        for shape in JB.INPUT_SHAPES.values():
            assert TB.supports_shape(got, TB.INPUT_SHAPES[shape.name]) == \
                JB.supports_shape(want, shape)


def test_shape_pool_and_names_equal_reference():
    assert TB.ARCH_NAMES == JB.ARCH_NAMES == TB.list_configs()
    assert TB.LONG_CONTEXT_ARCHS == JB.LONG_CONTEXT_ARCHS
    assert {k: dataclasses.astuple(v) for k, v in TB.INPUT_SHAPES.items()} \
        == {k: dataclasses.astuple(v) for k, v in JB.INPUT_SHAPES.items()}


@pytest.mark.parametrize("arch", JB.ARCH_NAMES)
def test_parameters_are_the_reference_trees(arch):
    jcfg = JB.reduced(JB.get_config(arch))
    shapes, _ = abstract_init(JModel(jcfg))
    want = {k: tuple(v.shape)
            for k, v in convert.flatten(jax.tree.map(
                lambda s: np.empty(s.shape, np.float32), shapes)).items()}
    model = Model(TB.reduced(TB.get_config(arch)), device="cpu")
    got = {k: tuple(p.shape) for k, p in model.named_parameters()}
    assert got == want
    assert sum(p.numel() for p in model.parameters()) == sum(
        int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))


def _by_suffix(params: dict, suffix: str) -> torch.Tensor:
    return torch.cat([p.reshape(-1) for k, p in params.items()
                      if k.endswith(suffix)])


@pytest.mark.parametrize("arch", ["zamba2_1p2b", "qwen2_moe_a2p7b"])
def test_init_draws_the_reference_distributions(arch):
    cfg = TB.reduced(TB.get_config(arch))
    params = Model(cfg, device="cpu").init(torch.Generator().manual_seed(3))
    out = 0.02 / (2 * cfg.n_layers) ** 0.5
    for suffix, std in ((".wq", 0.02), (".w_gate", 0.02), ("embed.table",
                                                           0.02),
                        (".wo", out), (".w_down", out)):
        got = float(_by_suffix(params, suffix).std())
        assert abs(got - std) < 0.05 * std, (suffix, got, std)
    for suffix in ("ln1", "ln2", "final_norm"):
        assert not _by_suffix(params, suffix).any()
    if cfg.arch_type == "moe":
        router = _by_suffix(params, ".router")
        assert abs(float(router.std()) - 0.006) < 0.15 * 0.006
        return
    dt = torch.nn.functional.softplus(_by_suffix(params, ".dt_bias"))
    assert 1e-3 * 0.999 <= float(dt.min()) and float(dt.max()) <= 0.1001
    a_log = _by_suffix(params, ".A_log")
    assert 0.0 <= float(a_log.min()) and float(a_log.max()) <= np.log(16.0)
    assert torch.equal(_by_suffix(params, ".D"),
                       torch.ones_like(_by_suffix(params, ".D")))
    conv = _by_suffix(params, ".conv_x")
    assert abs(float(conv.std()) - 0.1) < 0.1 * 0.1


def test_init_is_reproducible_from_its_generator():
    cfg = TB.reduced(TB.get_config("deepseek_moe_16b"))
    a = Model(cfg, device="cpu").init(torch.Generator().manual_seed(11))
    b = Model(cfg, device="cpu").init(torch.Generator().manual_seed(11))
    c = Model(cfg, device="cpu").init(torch.Generator().manual_seed(12))
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embed.table"], c["embed.table"])


def test_from_reference_refuses_a_foreign_tree():
    cfg = TB.reduced(TB.get_config("phi4_mini_3p8b"))
    table = np.zeros((cfg.padded_vocab, cfg.d_model), np.float32)
    with pytest.raises(KeyError, match="missing"):
        convert.from_reference(cfg, {"embed": {"table": table}},
                               device="cpu")


@pytest.mark.parametrize("vocab,b,s,seed", [(32000, 4, 64, 0), (512, 2, 40, 7)])
def test_token_batches_equal_reference(vocab, b, s, seed):
    got = list(tlm.token_batches(vocab_size=vocab, batch=b, seq_len=s,
                                 n_batches=2, seed=seed))
    want = list(jlm.token_batches(vocab_size=vocab, batch=b, seq_len=s,
                                  n_batches=2, seed=seed))
    for g, w in zip(got, want):
        for key in ("tokens", "labels"):
            np.testing.assert_array_equal(g[key], w[key])
