"""The sharding slice on the card (needs an NVIDIA GPU and nvcc; marked
``requires_cuda``, it skips with a reason elsewhere, which counts as
unverified):

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda_sharded.py

Reduced zamba2_1p2b (both hand-written kernels and their backward
kernels on its path) takes one AdamW step unsharded, and again with
every parameter a DTensor on a 1 x 1 ("data", "model") NCCL
``DeviceMesh`` (one rank, this card), the kernels entered through their
``local_map`` regions: the same launches, the loss within 1e-5 relative
and every updated parameter within 1e-6 (one AdamW step moves a weight
by at most lr(1 + wd|p|) = 1e-3 here; on one rank the two runs do the
same operations, ``chip_smoke.py``'s ``lm_sharded`` saw equal bits at
full size). The full-size run is ``chip_smoke.py``'s ``lm_sharded``.
"""
import pytest
import torch

from repro_torch.configs.base import get_config, reduced
from repro_torch.kernels import ops
from repro_torch.models import Model
from repro_torch.optim.adamw import AdamW
from repro_torch.training.train import make_train_step
from torch_helpers import cuda  # noqa: F401  (cuda: fixture)

pytestmark = pytest.mark.requires_cuda

KERNELS = ("flash_attention", "ssd_diag", "flash_attention_bwd",
           "ssd_diag_bwd")


def _step(cfg, dev, mesh=None):
    from repro_torch.sharding.place import shard_batch, shard_params
    model = Model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    g = torch.Generator(device=dev).manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab_size, (2, 64), generator=g,
                              device=dev) for k in ("tokens", "labels")}
    if mesh is not None:
        params = shard_params(model, mesh)
        batch = shard_batch(batch, mesh)
    opt = AdamW(lr=1e-3)
    ops.reset_launches()
    params, _, metrics = make_train_step(model, opt)(
        params, opt.init(params), batch)
    torch.cuda.synchronize()
    launches = {k: ops.launches[k] for k in KERNELS}
    got = {k: (p.full_tensor() if hasattr(p, "full_tensor") else p)
           .detach().clone() for k, p in params.items()}
    return float(metrics["loss"]), got, launches


def test_one_rank_nccl_mesh_step_equals_unsharded(cuda):
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    if dist.is_initialized():
        pytest.skip("a process group is already initialized here")
    cfg = reduced(get_config("zamba2_1p2b"))
    loss, params, launches = _step(cfg, cuda)
    assert all(launches[k] > 0 for k in KERNELS), launches
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device_type="cuda")
        s_loss, s_params, s_launches = _step(cfg, cuda, mesh)
    finally:
        dist.destroy_process_group()
    assert s_launches == launches
    assert abs(s_loss - loss) <= 1e-5 * abs(loss)
    for k, p in params.items():
        torch.testing.assert_close(s_params[k], p, rtol=0, atol=1e-6)
