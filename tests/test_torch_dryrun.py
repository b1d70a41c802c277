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

The traces that torch 2.11 refused (qwen2_moe_a2p7b's padded expert
bank in every kind, minicpm3_4b's decode) ask ``redistribute`` for no
``Partial`` target and run no pad on a DTensor; ``layers.matmul`` fed an
activation ``Partial`` on the data axis settles it first; the plain
router (no DTensor) is the formula it always was, bit for bit, and the
reference's within the model tests' bound.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils.flop_counter import FlopCounterMode

from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.models.moe import moe_apply
from repro_torch.configs.base import (ARCH_NAMES, INPUT_SHAPES, InputShape,
                                      get_config, reduced, supports_shape)
from repro_torch.launch import dryrun as DR
from repro_torch.launch.dryrun import fake_world, lower_combo
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models.model import Model, abstract_model
from repro_torch.optim.adamw import AdamW
from repro_torch.roofline.collect import RankCounter, model_flops
from repro_torch.training.train import make_train_step
from torch_lm_helpers import LOGIT_TOL

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


# the sharded traces torch 2.11 refused (ROADMAP C): reduced qwen2_moe
# pads 4 experts to 16
REFUSED = [("qwen2_moe_a2p7b", "train"), ("qwen2_moe_a2p7b", "prefill"),
           ("qwen2_moe_a2p7b", "decode"), ("minicpm3_4b", "decode")]


def _spy_redistribute(monkeypatch) -> list:
    """Every ``DTensor.redistribute`` call's target placements."""
    targets = []
    redistribute = DTensor.redistribute

    def spy(self, device_mesh=None, placements=None, **kw):
        targets.append(tuple(placements or ()))
        return redistribute(self, device_mesh, placements, **kw)
    monkeypatch.setattr(DTensor, "redistribute", spy)
    return targets


def _partial_targets(targets: list) -> list:
    return [t for t in targets if any(p.is_partial() for p in t)]


@pytest.mark.parametrize("arch,kind", REFUSED,
                         ids=[f"{a}-{k}" for a, k in REFUSED])
def test_sharded_trace_targets_no_partial_and_pads_no_dtensor(
        arch, kind, monkeypatch):
    """Every op of the step that reaches DTensor (seen by the rank
    counter, which hands DTensor ops back) and every redistribute."""
    targets = _spy_redistribute(monkeypatch)
    dtensor_ops = []

    class Spy(RankCounter):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                dtensor_ops.append(func)
            return super().__torch_dispatch__(func, types, args, kwargs)
    monkeypatch.setattr(DR, "RankCounter", Spy)
    res = lower_combo(arch, f"tiny_{kind}", shape=tiny(kind),
                      mesh_shape=(2, 4), reduced=True)
    assert res["status"] == "ok"
    assert targets and dtensor_ops
    assert not _partial_targets(targets)
    assert torch.ops.aten.constant_pad_nd.default not in dtensor_ops
    assert torch.ops.aten.mm.default in dtensor_ops


def test_matmul_settles_a_partial_activation(monkeypatch):
    """An activation ``Partial`` on the data axis (and replicated on
    "model") times a weight sharded over "model", on a fake (2, 4) mesh:
    no redistribute targets ``Partial``, the product holds none, and its
    block is the plain product of the rank's blocks (the fake group's
    all-reduce hands a rank its own block back)."""
    targets = _spy_redistribute(monkeypatch)
    gen = torch.Generator().manual_seed(0)
    xl = torch.randn(6, 16, generator=gen)
    wl = torch.randn(16, 8, generator=gen)
    with fake_world(8):
        mesh = make_mesh((2, 4), ("data", "model"), device_type="cpu")
        x = DTensor.from_local(xl, mesh, [Partial(), Replicate()])
        wt = DTensor.from_local(wl, mesh, [Replicate(), Shard(1)])
        out = L.matmul(x, wt)
        placements, local = out.placements, out.to_local()
    assert targets and not _partial_targets(targets)
    assert not any(p.is_partial() for p in placements)
    assert placements[1] == Shard(1)
    assert torch.equal(local, xl @ wl)


def _parent_router(moe, xt):
    """The router as ``MoE.forward`` computed it before the DTensor path
    padded on each rank's rows: pad, top-k, renormalised gates, the
    assignment shares and the load-balance loss."""
    cfg = moe.cfg
    e, e_real, k = cfg.padded_experts, cfg.n_experts, cfg.top_k
    t = xt.shape[0]
    probs = torch.softmax(xt.to(torch.float32) @ moe.router, -1)
    probs = F.pad(probs, (0, e - e_real))
    gate_w, gate_i = M.top_k(probs, k)
    gate_w = gate_w / torch.clamp_min(gate_w.sum(-1, keepdim=True), 1e-9)
    assign = torch.zeros(e).index_add_(
        0, gate_i.reshape(-1), torch.full((gate_i.numel(),), 1.0 / (t * k)))
    aux = e_real * torch.sum(probs.mean(0) * assign) * cfg.router_aux_coef
    return gate_w, gate_i, aux


def test_plain_router_is_the_parent_formula_and_the_reference(monkeypatch):
    """Reduced qwen2_moe_a2p7b (4 experts padded to 16), plain tensors:
    the gates, expert ids and aux loss of ``MoE.forward`` against the
    parent's formula bit for bit, and against the reference's
    ``moe_apply`` (its loss and output; its top-k on its own
    probabilities) within LOGIT_TOL of the largest magnitude."""
    cfg = reduced(get_config("qwen2_moe_a2p7b"))
    assert cfg.padded_experts > cfg.n_experts
    model = Model(cfg, device="cpu")
    model.init(torch.Generator().manual_seed(0))
    moe = model.layers[0].moe
    seen = []
    route = M._route

    def spy(probs, k, t):
        out = route(probs, k, t)
        seen.append(out)
        return out
    monkeypatch.setattr(M, "_route", spy)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)).to(L.ACT_DTYPE)
    with torch.no_grad():
        out, aux = moe(x)
        gate_w, gate_i, aux_parent = _parent_router(
            moe, x.reshape(-1, cfg.d_model))
    (got_w, got_i, _), = seen
    assert torch.equal(got_w, gate_w) and torch.equal(got_i, gate_i)
    assert torch.equal(aux, aux_parent)
    assert int(got_i.max()) < cfg.n_experts

    jcfg = jreduced(jget_config("qwen2_moe_a2p7b"))
    params = {"router": moe.router, "experts": dict(
        moe.experts.named_parameters()), "shared": dict(
        moe.shared.named_parameters())}
    params = jax.tree.map(lambda p: jnp.asarray(p.detach().numpy()), params)
    xj = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    jout, jaux = moe_apply(params, xj, jcfg)
    logits = jnp.asarray(x.float().numpy()).reshape(-1, cfg.d_model) @ \
        params["router"]
    jprobs = jnp.pad(jax.nn.softmax(logits, -1),
                     ((0, 0), (0, cfg.padded_experts - cfg.n_experts)))
    jw, ji = jax.lax.top_k(jprobs, cfg.top_k)
    jw = jw / jnp.maximum(jw.sum(-1, keepdims=True), 1e-9)
    assert np.array_equal(np.asarray(ji), got_i.numpy())
    np.testing.assert_allclose(got_w.numpy(), np.asarray(jw),
                               atol=LOGIT_TOL * float(np.abs(jw).max()))
    np.testing.assert_allclose(float(aux), float(jaux),
                               rtol=LOGIT_TOL)
    jo = np.asarray(jout, np.float32)
    np.testing.assert_allclose(out.float().numpy(), jo,
                               atol=LOGIT_TOL * float(np.abs(jo).max()))


def test_kinds_depth_runs_every_layer_kind():
    """The sweep's depth: gemma3's whole local:global group,
    deepseek_moe's dense layer and its first MoE layer, one layer
    elsewhere (zamba2's first layer applies the shared block; whisper's
    cut covers the encoder too); every supported (arch, shape) once."""
    depth = {a: DR.kinds_depth(get_config(a)) for a in ARCH_NAMES}
    assert depth["gemma3_12b"] == 6 and depth["deepseek_moe_16b"] == 2
    assert {a for a, n in depth.items() if n == 1} == set(ARCH_NAMES) - {
        "gemma3_12b", "deepseek_moe_16b"}
    model, _ = abstract_model(DR.combo_config(
        "deepseek_moe_16b", n_layers=depth["deepseek_moe_16b"]))
    assert len(model.dense_layers) == 1 and len(model.layers) == 1
    model, _ = abstract_model(DR.combo_config(
        "gemma3_12b", n_layers=depth["gemma3_12b"]))
    assert len(model.groups) == 1
    combos = DR.kinds_combos()
    assert len(combos) == len(set(combos)) == 3 * len(ARCH_NAMES) + 3
    assert all(supports_shape(get_config(a), INPUT_SHAPES[s])
               for a, s in combos)


def test_kinds_sweep_reports_each_combo(monkeypatch):
    """``kinds_sweep`` (``chip_smoke.py --lm-dryrun-all``'s loop), on
    reduced configs and a fake (2, 4) mesh: one row a combo at its
    ``kinds_depth``, with the trace's FLOPs and argument bytes; a combo
    that raises is reported as a failure with its traceback, and the
    sweep goes on."""
    combos = [("deepseek_moe_16b", "decode_32k"),
              ("zamba2_1p2b", "decode_32k")]
    kw = dict(mesh_shape=(2, 4), reduced=True)
    rows = list(DR.kinds_sweep(combos, **kw))
    assert [(r["arch"], r["n_layers"]) for r in rows] == [
        ("deepseek_moe_16b", 2), ("zamba2_1p2b", 1)]
    assert all(r["status"] == "ok" and r["flops"] > 0
               and r["argument_bytes"] > 0 for r in rows)
    lower = DR.lower_combo

    def refuse(arch, *a, **k):
        if arch == "deepseek_moe_16b":
            raise IndexError("list index out of range")
        return lower(arch, *a, **k)
    monkeypatch.setattr(DR, "lower_combo", refuse)
    failed, ok = DR.kinds_sweep(combos, **kw)
    assert failed["status"].startswith("FAIL: IndexError")
    assert "IndexError" in failed["trace"] and ok["status"] == "ok"
