"""End-to-end LM training launcher (the port of
``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2_780m \\
        --reduced --steps 200 --batch 8 --seq 128 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2_1p2b \\
        --batch 2 --seq 2048 --steps 8

Builds the model (optionally the reduced smoke variant), the synthetic
token pipeline, AdamW with a cosine schedule, runs the train step, logs
the loss and writes a checkpoint at the end (``--ckpt``, in the
reference's layout: ``convert.to_reference`` of the parameters). Runs on
the card unless ``--device cpu``; ``--remat`` rematerializes each layer
in the backward (``runtime.REMAT_POLICY``). Exits 0 when the mean loss
of the last 5 steps (of the last half, under 10 steps) is below that of
the first.

``--mesh DxM`` trains on a (data D, model M) ``DeviceMesh`` of D*M ranks,
one process each, every parameter and the batch placed by the sharding
rules (``sharding.place``):

    torchrun --nproc-per-node 2 -m repro_torch.launch.train --mesh 1x2 \
        --arch phi4_mini_3p8b --reduced --steps 3 --device cpu

torchrun gives each process its rank and the group's address; gloo on
the CPU, NCCL on the cards (rank r on card ``LOCAL_RANK``). A process
group that is already initialized is used as it is. Rank 0 prints and
writes the checkpoint.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2_780m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--d-model", type=int, default=0,
                    help="override d_model (e.g. ~100M quickstart)")
    ap.add_argument("--n-layers", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default: the hand-written kernels) or "
                         "cpu (their plain versions)")
    ap.add_argument("--remat", action="store_true",
                    help="recompute each layer's activations in the "
                         "backward (runtime.REMAT_POLICY)")
    ap.add_argument("--mesh", default="",
                    help="DxM: a (data, model) mesh of D*M ranks, one "
                         "process each (torchrun)")
    args = ap.parse_args(argv)

    import contextlib
    import os

    import torch
    import torch.distributed as dist

    from repro_torch._device import resolve_device
    from repro_torch.checkpoint import ckpt as CK
    from repro_torch.configs.base import get_config, reduced as make_reduced
    from repro_torch.data.lm import token_batches
    from repro_torch.models import Model
    from repro_torch.models.convert import to_reference
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.training.train import make_train_step

    dev = resolve_device(args.device)
    mesh, rank = None, 0
    if args.mesh:
        from repro_torch.launch.mesh import make_mesh
        d, m = (int(v) for v in args.mesh.split("x"))
        if not dist.is_initialized():   # torchrun's env:// rendezvous
            dist.init_process_group("nccl" if dev.type == "cuda"
                                    else "gloo")
        rank = dist.get_rank()
        if dev.type == "cuda":
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
            torch.cuda.set_device(dev)
        mesh = make_mesh((d, m), ("data", "model"), device_type=dev.type)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = make_reduced(cfg)
    if args.d_model:
        cfg = dataclasses.replace(cfg, d_model=args.d_model)
    if args.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=args.n_layers)

    model = Model(cfg, device=dev, remat=args.remat)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    n_params = sum(p.numel() for p in params.values())
    say = print if rank == 0 else (lambda *a, **k: None)
    say(f"arch={cfg.name} params={n_params:,} device={dev}"
        + (f" mesh=data {d} x model {m}" if mesh is not None else ""))
    if mesh is not None:
        from repro_torch.launch.mesh import set_mesh
        from repro_torch.sharding.place import shard_params
        params = shard_params(model, mesh)

    opt = AdamW(lr=cosine_schedule(peak_lr=args.lr, warmup=20,
                                   total=args.steps))
    opt_state = opt.init(params)
    step_fn = make_train_step(model, opt)

    t0 = time.time()
    it = token_batches(vocab_size=cfg.vocab_size, batch=args.batch,
                       seq_len=args.seq, n_batches=args.steps, seed=1)
    with set_mesh(mesh) if mesh is not None else contextlib.nullcontext():
        losses = _train(args, cfg, dev, it, step_fn, params, opt_state,
                        mesh, say, t0)

    k = min(5, max(1, len(losses) // 2))
    first = np.mean(losses[:k])
    last = np.mean(losses[-k:])
    say(f"loss first{k}={first:.4f} last{k}={last:.4f} "
        f"improved={last < first}")
    if args.ckpt:
        named = {n: (p.full_tensor() if mesh is not None else p)
                 for n, p in model.named_parameters()}
        if rank == 0:
            CK.save(args.ckpt, to_reference(named), step=args.steps)
            say(f"checkpoint -> {args.ckpt}")
    return 0 if last < first else 1


def _train(args, cfg, dev, it, step_fn, params, opt_state, mesh, say, t0):
    import torch
    losses = []
    for i, nb in enumerate(it):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in nb.items()}
        if cfg.arch_type == "vlm":
            batch["vision_embeds"] = 0.02 * torch.ones(
                (args.batch, cfg.vision_tokens, cfg.d_model),
                dtype=torch.bfloat16, device=dev)
        if cfg.arch_type == "audio":
            batch["frames"] = 0.02 * torch.ones(
                (args.batch, cfg.encoder_frames, cfg.d_model),
                dtype=torch.bfloat16, device=dev)
        if mesh is not None:
            from repro_torch.sharding.place import shard_batch
            batch = shard_batch(batch)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        if i % args.log_every == 0 or i == args.steps - 1:
            dt = time.time() - t0
            say(f"step {i:5d} loss {losses[-1]:.4f} "
                f"({dt / (i + 1):.3f}s/step)", flush=True)
    return losses


if __name__ == "__main__":
    raise SystemExit(main())
