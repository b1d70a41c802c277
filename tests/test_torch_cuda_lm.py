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
