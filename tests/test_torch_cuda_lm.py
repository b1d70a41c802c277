"""The LM serving path on the card, at the reduced configurations (needs
an NVIDIA GPU and nvcc; every test is marked ``requires_cuda`` and skips
with a reason elsewhere, which counts as unverified):

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda_lm.py

Each architecture, its weights from a seeded CUDA generator, prefills a
64-token prompt (two SSD chunks) and decodes three tokens with the two
hand-written kernels on its path, and again with their plain versions
swapped in for the wrappers; the logits agree within
``KERNEL_LOGIT_TOL`` of their largest magnitude. A prefill launches one
``flash_attention`` per eligible attention layer and one ``ssd_diag``
per Mamba2 layer; a decode step launches neither. The full-width run is
``chip_smoke.py``'s ``lm_serve`` phase.

The training path: the two backward kernels (``flash_attention_bwd``,
``ssd_diag_bwd``) against their plain versions at small and model
shapes, float32 and bfloat16; the forward's log-sum-exp output leaving
its output's bits unchanged; two calls giving equal bits; and each
reduced architecture's loss and gradient with the kernels both ways
against the same model with the plain versions swapped in, with the
launches of a step (``chip_smoke.py``'s ``lm_train`` phase runs
zamba2_1p2b at full width).
"""
import pytest
import torch

from repro_torch.configs.base import ARCH_NAMES, get_config, reduced
from repro_torch.kernels import flash_attn as FA
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_diag as SD
from repro_torch.models import Model
from torch_helpers import FLASH_CALLS, cuda  # noqa: F401  (cuda: fixture)

pytestmark = pytest.mark.requires_cuda

# the kernels against their plain versions through the whole model, as a
# fraction of the logits' largest magnitude (bf16 activations; the
# kernels round their float32 results once, as the plain versions do)
KERNEL_LOGIT_TOL = 3e-2
# ssd_diag launches a prefill at the reduced configs: one a Mamba2 layer
SSD_CALLS = {"mamba2_780m": 2, "zamba2_1p2b": 2}


def _serve(model, cfg, dev, feed=None, steps=3):
    """Prefill and ``steps`` decode steps fed the greedy tokens, or
    ``feed``'s (the first run's, so both runs see the same inputs)."""
    g = torch.Generator(device=dev).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 64),
                                     generator=g, device=dev)}
    if cfg.arch_type == "vlm":
        batch["vision_embeds"] = torch.randn(
            (2, cfg.vision_tokens, cfg.d_model), generator=g, device=dev)
    if cfg.arch_type == "audio":
        batch["frames"] = torch.randn(
            (2, cfg.encoder_frames, cfg.d_model), generator=g, device=dev)
    caches = model.cache_init(2, 64 + steps)
    ops.reset_launches()
    logits, caches = model.prefill(batch, caches)
    torch.cuda.synchronize()
    prefill = {k: ops.launches[k] for k in ("flash_attention", "ssd_diag")}
    out, fed = [logits], []
    ops.reset_launches()
    for i in range(steps):
        fed.append(out[-1].argmax(-1) if feed is None else feed[i])
        logits, caches = model.decode_step(fed[-1], caches)
        out.append(logits)
    torch.cuda.synchronize()
    decode = {k: ops.launches[k] for k in ("flash_attention", "ssd_diag")}
    return torch.stack(out).float(), fed, prefill, decode


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_model_with_kernels_matches_plain_versions(cuda, arch,  # noqa: F811
                                                   monkeypatch):
    cfg = reduced(get_config(arch))
    model = Model(cfg, device=cuda)
    model.init(torch.Generator(device=cuda).manual_seed(0))
    got, fed, prefill, decode = _serve(model, cfg, cuda)
    assert prefill == {"flash_attention": FLASH_CALLS[arch],
                       "ssd_diag": SSD_CALLS.get(arch, 0)}
    assert decode == {"flash_attention": 0, "ssd_diag": 0}
    monkeypatch.setattr(ops, "flash_attention",
                        lambda q, k, v, *, causal=True, out_dtype=None:
                        FA.flash_attention_plain(q, k, v, causal=causal,
                                                 out_dtype=out_dtype
                                                 or q.dtype))
    monkeypatch.setattr(ops, "ssd_diag", SD.ssd_diag_plain)
    want, _, prefill, _ = _serve(model, cfg, cuda, feed=fed)
    assert prefill == {"flash_attention": 0, "ssd_diag": 0}
    v = cfg.vocab_size
    err = float((got[..., :v] - want[..., :v]).abs().max())
    assert torch.isfinite(got).all()
    assert err <= KERNEL_LOGIT_TOL * float(want[..., :v].abs().max()), err


# ------------------------------------------------------------ backward
# The two backward kernels against their plain versions on the card, at
# the operands' dtype: each gradient within its bound of the plain
# version's largest magnitude. float32 operands: 1e-4 (3xTF32 products,
# sums in another order). bfloat16 operands: 1e-2 (S and dP are exact
# bf16 products summed in float32; P and dS are formed in float32 and
# split into a bf16 high part and the bf16 rounding of the rest for the
# three products they feed, so the kernel keeps ~16 bits of each, and the
# result is rounded once to bf16, one unit of 2^-8).
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
SSD_BWD_TOL = 1e-4


def _rel_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def _attn_operands(dev, b, s, h, hkv, d, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, generator=g, device=dev).to(dtype)
            for shape in ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d),
                          (b, s, h, d))]


# (B, S, H, Hkv, D): 300, 130, 77 and 37 rows fill no whole tile; D 36
# bf16 rows are not 16-byte multiples (staged by loads); phi4_mini_3p8b's
# grouped-query shape; a ragged 300 at D 128
ATTN_SHAPES = [(2, 37, 4, 2, 8), (1, 300, 4, 4, 64), (2, 130, 8, 2, 128),
               (4, 256, 32, 32, 64), (1, 4096, 24, 8, 128),
               (2, 300, 8, 2, 128), (2, 77, 6, 3, 36)]


@pytest.mark.parametrize("shape", ATTN_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_kernel_matches_plain(cuda, shape,  # noqa: F811
                                                  causal, dtype):
    q, k, v, do = _attn_operands(cuda, *shape, dtype)
    o, lse = ops.flash_attention_lse(q, k, v, causal=causal)
    ops.reset_launches()
    got = ops.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    assert ops.launches["flash_attention_bwd"] == 1
    want = FA.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal)
    for g, w in zip(got, want):
        assert g.dtype == dtype and torch.isfinite(g).all()
        assert _rel_err(g, w) <= BWD_TOL[dtype], _rel_err(g, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_lse_leaves_the_output_bits(cuda, dtype):  # noqa: F811
    q, k, v, _ = _attn_operands(cuda, 2, 300, 8, 2, 64, dtype)
    for causal in (True, False):
        plain_out = ops.flash_attention(q, k, v, causal=causal)
        out, lse = ops.flash_attention_lse(q, k, v, causal=causal)
        assert torch.equal(out, plain_out)
        want = FA.attention_lse_plain(q, k, causal=causal)
        torch.testing.assert_close(lse, want, rtol=1e-5, atol=1e-5)


def _ssd_operands(dev, bc, h, q, n, p, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    dt = 0.001 + 0.099 * torch.rand((bc, h, q), generator=g, device=dev)
    a = -(1 + 7 * torch.rand((h,), generator=g, device=dev))
    cs = torch.cumsum(dt * a[None, :, None], dim=2)
    return (torch.randn((bc, q, n), generator=g, device=dev),
            torch.randn((bc, q, n), generator=g, device=dev),
            torch.randn((bc, h, q, p), generator=g, device=dev), dt, cs,
            torch.randn((bc, h, q, p), generator=g, device=dev))


# (BC, H, Q, N, P): zamba2_1p2b's full shape last; Q 20, 100 and 200
# fill no whole tile; N 18 and P 5 are staged by loads
SSD_SHAPES = [(3, 2, 20, 8, 5), (2, 3, 100, 16, 72), (4, 64, 256, 64, 64),
              (2, 8, 256, 128, 64), (2, 5, 200, 18, 40),
              (16, 64, 256, 64, 64)]


@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_ssd_diag_bwd_kernel_matches_plain(cuda, shape):  # noqa: F811
    *fwd, dy = _ssd_operands(cuda, *shape)
    ops.reset_launches()
    got = ops.ssd_diag_bwd(*fwd, dy)
    torch.cuda.synchronize()
    assert ops.launches["ssd_diag_bwd"] == 1
    want = SD.ssd_diag_bwd_plain(*fwd, dy)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert _rel_err(g, w) <= SSD_BWD_TOL, _rel_err(g, w)


def test_backward_kernels_give_equal_bits_twice(cuda):  # noqa: F811
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do = _attn_operands(cuda, 2, 200, 8, 2, 64, dtype)
        o, lse = ops.flash_attention_lse(q, k, v, causal=True)
        one = ops.flash_attention_bwd(q, k, v, o, lse, do)
        two = ops.flash_attention_bwd(q, k, v, o, lse, do)
        assert all(torch.equal(a, b) for a, b in zip(one, two))
    *fwd, dy = _ssd_operands(cuda, 4, 64, 256, 64, 64)
    one, two = ops.ssd_diag_bwd(*fwd, dy), ops.ssd_diag_bwd(*fwd, dy)
    assert all(torch.equal(a, b) for a, b in zip(one, two))


def test_flash_attention_bwd_of_a_float32_output_of_bf16_operands(
        cuda):  # noqa: F811
    q, k, v, do = _attn_operands(cuda, 2, 150, 8, 2, 64, torch.bfloat16)
    for causal in (True, False):
        o, lse = ops.flash_attention_lse(q, k, v, causal=causal,
                                         out_dtype=torch.float32)
        got = ops.flash_attention_bwd(q, k, v, o, lse, do.float(),
                                      causal=causal)
        want = FA.flash_attention_bwd_plain(q, k, v, o, lse, do.float(),
                                            causal=causal)
        for g, w in zip(got, want):
            assert g.dtype == torch.bfloat16 and torch.isfinite(g).all()
            assert _rel_err(g, w) <= BWD_TOL[torch.bfloat16], _rel_err(g, w)


def _ssd_bwd_with(plan, fwd, dy):
    from repro_torch.kernels import _build
    cmat, bmat, x, dt, cs = fwd
    out = [torch.empty_like(t) for t in (cmat, bmat, x, dt, cs)]
    part = torch.empty((plan.groups, cmat.shape[0], plan.pairs,
                        SD.BWD_TILE ** 2), device=x.device)
    assert SD.launch_bwd(_build.library(), *fwd, dy, part, *out,
                         plan=plan) == 0
    return out


def test_ssd_diag_bwd_bits_do_not_depend_on_the_plan(cuda):  # noqa: F811
    """dx, ddt and dcs of a head are the same bits whatever the head
    group; dC and dB sum the groups' partials in group order, so they
    agree across groups within SSD_BWD_TOL."""
    shape = (4, 8, 200, 64, 64)
    *fwd, dy = _ssd_operands(cuda, *shape)
    runs = {grp: _ssd_bwd_with(SD.bwd_plan(*shape, group=grp), fwd, dy)
            for grp in (1, 3, 4)}
    ref = runs[1]
    for got in runs.values():
        assert all(torch.equal(a, b) for a, b in zip(got[2:], ref[2:]))
        for a, b in zip(got[:2], ref[:2]):
            assert _rel_err(a, b) <= SSD_BWD_TOL


# The train step's gradient with the kernels both ways against the same
# model with the plain versions swapped in for the wrappers (autograd
# through them): each tensor within TRAIN_GRAD_TOL of the plain run's
# largest magnitude of that tensor (Mamba2's per-head vectors at
# TRAIN_SSM_HEAD_TOL: their bf16 gradients cancel, as
# tests/torch_lm_train_helpers.py measures), the whole gradient's cosine
# at least TRAIN_COSINE.
TRAIN_GRAD_TOL = 5e-2
TRAIN_SSM_HEAD_TOL = 0.25
TRAIN_COSINE = 0.99


def _train_grads(model, cfg, dev):
    from repro_torch.training.train import make_loss_fn
    g = torch.Generator(device=dev).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 64),
                                     generator=g, device=dev),
             "labels": torch.randint(0, cfg.vocab_size, (2, 64),
                                     generator=g, device=dev)}
    if cfg.arch_type == "vlm":
        batch["vision_embeds"] = torch.randn(
            (2, cfg.vision_tokens, cfg.d_model), generator=g, device=dev)
    if cfg.arch_type == "audio":
        batch["frames"] = torch.randn(
            (2, cfg.encoder_frames, cfg.d_model), generator=g, device=dev)
    ops.reset_launches()
    total, _ = make_loss_fn(model)(batch)
    named = dict(model.named_parameters())
    grads = torch.autograd.grad(total, list(named.values()),
                                allow_unused=True)
    torch.cuda.synchronize()
    counts = {k: ops.launches[k] for k in ("flash_attention", "ssd_diag",
                                           "flash_attention_bwd",
                                           "ssd_diag_bwd")}
    grads = {k: (g_ if g_ is not None else torch.zeros_like(p))
             for (k, p), g_ in zip(named.items(), grads)}
    return float(total.detach()), grads, counts


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_train_step_with_kernels_matches_plain_versions(cuda, arch,  # noqa: F811
                                                        monkeypatch):
    cfg = reduced(get_config(arch))
    model = Model(cfg, device=cuda)
    model.init(torch.Generator(device=cuda).manual_seed(0))
    total, got, counts = _train_grads(model, cfg, cuda)
    n_attn, n_ssd = FLASH_CALLS[arch], SSD_CALLS.get(arch, 0)
    assert counts == {"flash_attention": n_attn, "ssd_diag": n_ssd,
                      "flash_attention_bwd": n_attn, "ssd_diag_bwd": n_ssd}
    monkeypatch.setattr(ops, "flash_attention",
                        lambda q, k, v, *, causal=True, out_dtype=None:
                        FA.flash_attention_plain(q, k, v, causal=causal,
                                                 out_dtype=out_dtype
                                                 or q.dtype))
    monkeypatch.setattr(ops, "ssd_diag", SD.ssd_diag_plain)
    total_p, want, counts = _train_grads(model, cfg, cuda)
    assert not any(counts.values())
    assert abs(total - total_p) <= 1e-3 * abs(total_p)
    for name, w in want.items():
        tol = (TRAIN_SSM_HEAD_TOL if name.endswith(
            ("mamba.A_log", "mamba.dt_bias")) else TRAIN_GRAD_TOL)
        g = got[name]
        assert torch.isfinite(g).all(), name
        assert float((g - w).abs().max()) <= tol * float(w.abs().max()), name
    flat_g = torch.cat([got[k].flatten() for k in want])
    flat_w = torch.cat([want[k].flatten() for k in want])
    assert float(torch.nn.functional.cosine_similarity(
        flat_g, flat_w, dim=0)) >= TRAIN_COSINE
