"""The dry run's launch path (``launch.dryrun``), the counterpart of
``tests/test_dryrun_integration.py``: reduced phi4_mini_3p8b,
qwen2_moe_a2p7b and mamba2_780m traced on a fake (data 2, model 4) mesh
of eight ranks (a fake process group, fake tensors: nothing is
allocated), as a train step, a prefill and a decode step. Each combo
completes with every parameter placed by the rules, and its memory and
collective bytes are non-negative; the (2, 4) train step moves bytes.

On a fake 1 x 1 mesh the rank is the whole program, so its FLOPs
(``roofline.collect.RankCounter``: the local matrix products) equal
``torch.utils.flop_counter.FlopCounterMode``'s count of the same step on
the unsharded model exactly, and it issues no collective.
"""
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.base import InputShape, get_config, reduced
from repro_torch.launch.dryrun import lower_combo
from repro_torch.models.model import abstract_model
from repro_torch.optim.adamw import AdamW
from repro_torch.roofline.collect import model_flops
from repro_torch.training.train import make_train_step

ARCHS = ["phi4_mini_3p8b", "qwen2_moe_a2p7b", "mamba2_780m"]
B, S = 4, 32


def tiny(kind: str) -> InputShape:
    return InputShape(f"tiny_{kind}", S, B, kind)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_dryrun_on_2x4_mesh(arch, kind):
    res = lower_combo(arch, f"tiny_{kind}", shape=tiny(kind),
                      mesh_shape=(2, 4), reduced=True)
    assert res["status"] == "ok"
    assert res["n_ranks"] == 8 and res["mesh"] == {"data": 2, "model": 4}
    assert res["parameters_placed"] == res["parameters"] > 0
    mem = res["memory"]
    assert all(v >= 0 for v in mem.values())
    assert mem["param_bytes"] > 0 and mem["input_bytes"] > 0
    assert (mem["optimizer_bytes"] > 0) == (kind == "train")
    coll = res["collectives"]
    assert all(v >= 0 for v in coll["per_kind_bytes"].values())
    assert coll["total_bytes"] == sum(coll["per_kind_bytes"].values())
    assert res["flops"] > 0
    assert "not a measurement" in res["estimate"]
    if kind == "train":
        assert coll["total_bytes"] > 0


def _unsharded_flops(arch: str, kind: str) -> int:
    cfg = reduced(get_config(arch))
    model, mode = abstract_model(cfg, remat=kind == "train")
    with mode, FlopCounterMode(display=False) as fc:
        batch = {"tokens": torch.zeros((B, S), dtype=torch.long)}
        if kind == "train":
            batch["labels"] = torch.zeros((B, S), dtype=torch.long)
            params = dict(model.named_parameters())
            opt = AdamW(lr=1e-4)
            make_train_step(model, opt)(params, opt.init(params), batch)
        else:
            model.prefill(batch, model.cache_init(B, S))
    return fc.get_total_flops()


@pytest.mark.parametrize("kind", ["train", "prefill"])
@pytest.mark.parametrize("arch", ARCHS)
def test_one_rank_counts_the_unsharded_flops(arch, kind):
    res = lower_combo(arch, f"tiny_{kind}", shape=tiny(kind),
                      mesh_shape=(1, 1), reduced=True)
    assert res["flops"] == _unsharded_flops(arch, kind)
    assert res["collectives"]["total_bytes"] == 0


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_sharding_switches_change_the_layout(kind, monkeypatch):
    """``GATHER_WEIGHTS`` (weights gathered to TP-only at use),
    ``MOE_XE_SHARD`` (the dispatch buffer over experts and capacity)
    and, for the prefill, ``SERVE_PURE_TP`` (weights TP-only) on
    qwen2_moe_a2p7b: each combo completes, and the switches move the
    rank's collective bytes."""
    from repro_torch.models import runtime as RT
    args = ("qwen2_moe_a2p7b", f"tiny_{kind}")
    kw = dict(shape=tiny(kind), mesh_shape=(2, 4), reduced=True)
    base = lower_combo(*args, **kw)
    for name in ("GATHER_WEIGHTS", "MOE_XE_SHARD", "SERVE_PURE_TP"):
        monkeypatch.setattr(RT, name, True)
    flagged = lower_combo(*args, **kw)
    assert flagged["status"] == "ok"
    assert flagged["parameters_placed"] == flagged["parameters"]
    assert flagged["collectives"] != base["collectives"]
    if kind == "prefill":   # TP-only weights: no fsdp blocks to hold
        assert (flagged["memory"]["param_bytes"]
                > base["memory"]["param_bytes"])


def test_model_flops_is_the_reference_rule():
    assert model_flops(10, 4, 100, kind="train") == 6 * 4 * 100
    assert model_flops(10, 4, 100, kind="prefill") == 2 * 4 * 100
