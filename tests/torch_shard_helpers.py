"""Rank processes for ``tests/test_torch_sharded_lm.py``: ``spawn`` runs
jobs on a gloo group of spawned CPU processes (a ``FileStore`` in a
temporary directory, no port), each rank on the same inputs, and returns
rank 0's results. Imports no JAX: the ranks run the port alone."""
import datetime
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

MESHES = ((1, 2), (2, 1))       # (data, model) over two ranks
GROUP_TIMEOUT_S = 300


def spawn(jobs: list, world: int = 2) -> dict:
    """``jobs`` (``(name, kwargs)``, names of ``JOBS``) run in order on
    ``world`` rank processes; rank 0's results by job name."""
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "results.pt")
        mp.spawn(_rank_main, args=(world, os.path.join(tmp, "store"), out,
                                   jobs), nprocs=world, join=True)
        return torch.load(out, weights_only=False)


def _rank_main(rank: int, world: int, store: str, out: str, jobs) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        results = {name: JOBS[name](**kw) for name, kw in jobs}
        if rank == 0:
            torch.save(results, out)
    finally:
        dist.destroy_process_group()


def _numpy(t) -> np.ndarray:
    t = t.full_tensor() if hasattr(t, "full_tensor") else t
    return t.detach().float().cpu().numpy()


def port_model(cfg, arrays: dict):
    """A CPU ``Model`` holding ``arrays`` (port names -> numpy)."""
    from repro_torch.models import Model
    model = Model(cfg, device="cpu")
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(torch.from_numpy(arrays[k]))
    return model


def sharded_lm(cfgs: dict, arrays: dict, batches: dict) -> dict:
    """For each (data, model) mesh of ``MESHES`` and each architecture:
    the sharded forward's logits, and one train step with ``SGD(lr=1)``
    (the updated parameters are the old ones minus the gradient): its
    loss and parameters, gathered whole."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim.adamw import SGD
    from repro_torch.sharding.place import shard_batch, shard_params
    from repro_torch.training.train import make_train_step
    out = {}
    for shape in MESHES:
        mesh = make_mesh(shape, ("data", "model"), device_type="cpu")
        for arch, cfg in cfgs.items():
            model = port_model(cfg, arrays[arch])
            shard_params(model, mesh)
            batch = shard_batch(batches[arch], mesh)
            with torch.no_grad():
                logits, aux = model.forward(
                    {k: v for k, v in batch.items() if k != "labels"})
            model = port_model(cfg, arrays[arch])
            params = shard_params(model, mesh)
            opt = SGD(lr=1.0)
            params, _, metrics = make_train_step(model, opt)(
                params, opt.init(params), batch)
            out[(shape, arch)] = {
                "logits": _numpy(logits), "aux": float(_numpy(aux)),
                "loss": float(metrics["loss"]),
                "params": {k: _numpy(p) for k, p in params.items()},
                "placements": {k: str(p.placements)
                               for k, p in params.items()}}
    return out


def window_decode(cfg, arrays: dict, tokens: np.ndarray, prefill: int,
                  max_len: int) -> dict:
    """gemma3's windowed caches sequence-sharded over "model"
    (``runtime.WINDOW_CACHE_SP``) on a (data 1, model 2) mesh: the
    unsharded full forward's logits, and the sharded prefill of the
    first ``prefill`` tokens and decode steps fed the rest, with the
    window caches' placements."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import runtime as RT
    from repro_torch.sharding.place import (shard_batch, shard_cache,
                                            shard_params)
    RT.set_flags(window_cache_sp=True)
    mesh = make_mesh((1, 2), ("data", "model"), device_type="cpu")
    full, _ = port_model(cfg, arrays).forward({"tokens": tokens})
    model = port_model(cfg, arrays)
    shard_params(model, mesh)
    caches = shard_cache(model.cache_init(tokens.shape[0], max_len),
                         model.cache_specs(), mesh)
    lg, caches = model.prefill(
        shard_batch({"tokens": tokens[:, :prefill]}, mesh), caches)
    steps = [_numpy(lg)]
    for t in range(prefill, tokens.shape[1]):
        lg, caches = model.decode_step(
            shard_batch({"t": tokens[:, t]}, mesh)["t"], caches)
        steps.append(_numpy(lg))
    local = caches[0]["local"][0]["k"]
    return {"full": _numpy(full), "steps": np.stack(steps, 1),
            "window_placements": str(local.placements),
            "window_shape": tuple(local.shape)}


def launcher(argv: list) -> dict:
    """``launch.train.main(argv)`` on the ranks' group (``--mesh``):
    its exit code and what rank 0 printed."""
    import contextlib
    import io

    from repro_torch.launch import train
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = train.main(argv)
    return {"rc": rc, "out": buf.getvalue()}


JOBS = {"sharded_lm": sharded_lm, "window_decode": window_decode,
        "launcher": launcher}
