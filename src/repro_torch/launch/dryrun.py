"""Dry run: trace every (arch x shape x mesh) combo as one rank of the
production mesh would run it (the port of ``repro/launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3_12b \\
        --shape train_4k [--multi-pod] [--out results.jsonl]

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch \
        qwen2_moe_a2p7b --shape train_4k --flag MOE_XE_SHARD
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch \
        mamba2_780m --shape train_4k --reduced --mesh 2x4   # seconds

The reference lowers and compiles each combo for 512 forced host devices
and reads XLA's per-device analyses. Here one process joins a FAKE
process group of 256 (or 512) ranks as rank 0, builds the production
``DeviceMesh`` on "cpu" (a fake "cuda" mesh cannot place tensors), makes
the model's parameters, the optimizer state and the inputs fake tensors
(no storage) placed by the sharding rules, and runs the train step with
AdamW, the prefill, or one decode step on them. Collectives of the fake
group return at once. What rank 0 ran is recorded as one JSON line:

  * per-rank argument bytes: the local blocks of the parameters, the
    optimizer state and the inputs (caches included);
  * peak temporary bytes: the most the step's own results held at once
    (``RankCounter.peak_bytes``), and the peak with the arguments;
  * per-rank FLOPs: the local matrix products (``roofline.collect.
    RankCounter``), beside ``model_flops``' 6·N·D (or 2·N·D) per rank;
  * per-rank bytes accessed: every local op's input and output bytes,
    unfused (an upper estimate of the HBM traffic);
  * per-kind collective result bytes and counts (with
    ``keep_collectives``, each collective's record too, under
    ``_collectives``: ``roofline.inspect_hlo``);
  * trace seconds.

``roofline.report`` turns the records into the three roofline terms,
``roofline.differential`` checks them against the reference's two-depth
extrapolation.

Every number is a per-rank ESTIMATE from a fake mesh on the CPU, not a
measurement: no device ran the program. Run it as its own process (it
initializes the default process group).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import logging
import sys
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs.base import (ARCH_NAMES, INPUT_SHAPES, InputShape,
                                      get_config, supports_shape)
from repro_torch.configs.base import reduced as reduced_config
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import make_mesh, make_production_mesh, set_mesh
from repro_torch.models import runtime as RT
from repro_torch.optim.adamw import AdamW
from repro_torch.roofline.collect import RankCounter, model_flops
from repro_torch.training.train import make_train_step

ESTIMATE = ("per-rank estimate from a fake process group and fake tensors "
            "on the CPU; no device ran it: not a measurement")


@contextlib.contextmanager
def fake_world(n_ranks: int):
    """A fake default process group of ``n_ranks`` with this process as
    rank 0, destroyed after the block."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is already "
                           "initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n_ranks)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _local_bytes(tensors) -> int:
    total = 0
    for t in tensors:
        t = t.to_local() if hasattr(t, "to_local") else t
        total += t.numel() * t.element_size()
    return total


def _leaves(tree):
    if isinstance(tree, dict):
        for k, v in tree.items():
            if k != "len":
                yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def lower_combo(arch: str, shape_name: str, *, multi_pod: bool = False,
                remat: bool = True, extra_tag: str = "", n_layers: int = 0,
                cfg_overrides: dict | None = None,
                shape: InputShape | None = None,
                mesh_shape: tuple | None = None,
                reduced: bool = False,
                keep_collectives: bool = False) -> dict:
    """Trace one combo on a fake mesh; returns its record (or raises).

    ``shape`` replaces ``INPUT_SHAPES[shape_name]``, ``mesh_shape`` a
    (data, model) mesh the production one and ``reduced`` the config its
    smoke variant (the tests' small combos); ``n_layers`` cuts the
    depth, as the reference's roofline probes do; ``keep_collectives``
    keeps each collective's record (the reference's ``keep_hlo``)."""
    cfg = combo_config(arch, n_layers=n_layers, cfg_overrides=cfg_overrides,
                       reduced=reduced)
    shape = INPUT_SHAPES[shape_name] if shape is None else shape
    if not supports_shape(cfg, shape):
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "status": "skipped (full attention at 500k; DESIGN.md §6)"}
    if mesh_shape is None:
        n_ranks = 512 if multi_pod else 256
    else:
        n_ranks = mesh_shape[0] * mesh_shape[1]
    with fake_world(n_ranks):
        mesh = (make_production_mesh(multi_pod=multi_pod, device_type="cpu")
                if mesh_shape is None else
                make_mesh(mesh_shape, ("data", "model"), device_type="cpu"))
        res = _trace(cfg, shape, mesh, arch=arch, shape_name=shape_name,
                     multi_pod=multi_pod, remat=remat, tag=extra_tag)
    records = res.pop("_collectives")
    if keep_collectives:
        res["_collectives"] = records
    return res


def combo_config(arch: str, *, n_layers: int = 0,
                 cfg_overrides: dict | None = None, reduced: bool = False):
    """The config ``lower_combo`` traces: the smoke variant under
    ``reduced``, cut to ``n_layers`` (the encoder too, for audio), then
    ``cfg_overrides``."""
    cfg = get_config(arch)
    if reduced:
        cfg = reduced_config(cfg)
    if n_layers:
        kw = {"n_layers": n_layers}
        if cfg.arch_type == "audio":
            kw["encoder_layers"] = n_layers
        cfg = dataclasses.replace(cfg, **kw)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    return cfg


def kinds_depth(cfg) -> int:
    """The fewest layers at which every layer kind of ``cfg`` runs once:
    a whole local:global group (gemma3), the leading dense layers and
    one MoE layer (deepseek_moe), else one (zamba2's first layer applies
    its shared block; ``combo_config`` cuts whisper's encoder too)."""
    if cfg.local_global_ratio:
        return cfg.local_global_ratio + 1
    if cfg.arch_type == "moe":
        return cfg.first_k_dense + 1
    return 1


def kinds_combos() -> list[tuple[str, str]]:
    """Every (arch, shape) the reference's dry run traces: each
    architecture at every shape it supports (long_500k only for
    ``LONG_CONTEXT_ARCHS``)."""
    return [(a, s) for a in ARCH_NAMES for s in INPUT_SHAPES
            if supports_shape(get_config(a), INPUT_SHAPES[s])]


def kinds_sweep(combos=None, **kw):
    """``lower_combo`` of each combo (default ``kinds_combos()``) at its
    ``kinds_depth``, on the production mesh unless ``kw`` says
    otherwise: yields one summary a combo (status, per-rank FLOPs,
    argument bytes, trace seconds), a failure's as its message."""
    for arch, shape in combos or kinds_combos():
        n = kinds_depth(get_config(arch))
        row = {"arch": arch, "shape": shape, "n_layers": n}
        try:
            res = lower_combo(arch, shape, n_layers=n, **kw)
        except Exception as e:   # reported, and the caller fails on it
            row.update(status=f"FAIL: {type(e).__name__}: {e}"[:400],
                       trace=traceback.format_exc()[-1500:])
        else:
            row.update(status=res["status"], flops=res["flops"],
                       argument_bytes=res["memory"]["argument_bytes"],
                       trace_s=res["trace_s"])
        yield row


def _trace(cfg, shape, mesh, *, arch, shape_name, multi_pod, remat, tag):
    train = shape.kind == "train"
    t0 = time.perf_counter()
    model, params, mode = SP.abstract_params(
        cfg, mesh, remat=remat and train,
        serve_pure_tp=RT.SERVE_PURE_TP and not train)
    counter = RankCounter()
    b, s = shape.global_batch, shape.seq_len
    with mode, set_mesh(mesh):
        if train:
            opt = AdamW(lr=1e-4)
            state = opt.init(params)
            inputs = SP.batch_specs(cfg, shape, mesh)
            step = make_train_step(model, opt)
            opt_bytes = _local_bytes([*state.mu.values(),
                                      *state.nu.values()])
            with counter:
                step(params, state, inputs)
            in_bytes = _local_bytes(inputs.values())
        else:
            opt_bytes = 0
            caches = SP.abstract_cache(model, b, s, mesh)
            leaves = list(_leaves(caches))
            if shape.kind == "prefill":
                inputs = SP.batch_specs(cfg, shape, mesh)
                with counter:
                    model.prefill(inputs, caches)
                in_bytes = _local_bytes([*inputs.values(), *leaves])
            else:
                token = SP.decode_token_specs(shape, mesh)
                with counter:
                    model.decode_step(token, caches)
                in_bytes = _local_bytes([token, *leaves])
    trace_s = time.perf_counter() - t0
    param_bytes = _local_bytes(params.values())
    args = param_bytes + opt_bytes + in_bytes
    tokens = b * (s if shape.kind != "decode" else 1)
    mf = model_flops(cfg.param_count(), cfg.active_param_count(), tokens,
                     kind="train" if train else "inference")
    n_ranks = mesh.size()
    return {
        "arch": arch, "shape": shape_name, "multi_pod": multi_pod,
        "tag": tag, "status": "ok", "estimate": ESTIMATE,
        "mesh": dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)),
        "n_ranks": n_ranks, "kind": shape.kind, "batch": b, "seq": s,
        "remat": bool(remat and train), "trace_s": trace_s,
        "memory": {"argument_bytes": args, "param_bytes": param_bytes,
                   "optimizer_bytes": opt_bytes, "input_bytes": in_bytes,
                   "temp_bytes": counter.peak_bytes,
                   "peak_bytes": args + counter.peak_bytes},
        "flops": counter.flops,
        "bytes_accessed": counter.bytes_accessed,
        "model_flops_per_rank": mf / n_ranks,
        "flops_over_model_flops": (counter.flops * n_ranks / mf
                                   if mf else None),
        "collectives": counter.collectives(),
        "_collectives": counter.records,
        "parameters_placed": sum(hasattr(p, "placements")
                                 for p in params.values()),
        "parameters": len(params),
    }


def add_combo_args(ap: argparse.ArgumentParser) -> None:
    """The small-combo flags every dry-run CLI takes (``--reduced``: the
    config's smoke variant; ``--mesh DxM``: a (data, model) mesh in
    place of the production one), for small combos on a CPU."""
    ap.add_argument("--reduced", action="store_true",
                    help="the config's smoke variant (tiny widths)")
    ap.add_argument("--mesh", default="",
                    help="DxM (data x model) ranks in place of the "
                         "production 16x16 / 2x16x16 mesh")


def combo_kwargs(args) -> dict:
    """``lower_combo`` keywords of ``add_combo_args``' flags."""
    mesh = tuple(int(v) for v in args.mesh.split("x")) if args.mesh else None
    if mesh is not None and len(mesh) != 2:
        raise ValueError(f"--mesh {args.mesh!r}: expected DxM")
    return {"reduced": args.reduced, "mesh_shape": mesh}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES)
    ap.add_argument("--shape", choices=list(INPUT_SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="every supported (arch x shape) on this mesh")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--flag", action="append", default=[],
                    help="a switch of models.runtime to turn on for every "
                         "combo (repeatable), e.g. MOE_XE_SHARD")
    add_combo_args(ap)
    args = ap.parse_args(argv)
    RT.set_flags(**{f: True for f in args.flag})
    # DTensor warns at each multi-axis reduction of the mesh
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)

    meshes = [args.multi_pod] if not args.both_meshes else [False, True]
    if args.all:
        combos = [(a, s, mp) for a in ARCH_NAMES for s in INPUT_SHAPES
                  for mp in meshes]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        combos = [(args.arch, args.shape, mp) for mp in meshes]

    out_f = open(args.out, "a") if args.out else None
    n_ok = n_skip = n_fail = 0
    for arch, shp, mp in combos:
        label = f"{arch} x {shp} x {'2x16x16' if mp else '16x16'}"
        try:
            res = lower_combo(arch, shp, multi_pod=mp,
                              remat=not args.no_remat, extra_tag=args.tag,
                              **combo_kwargs(args))
            if res["status"].startswith("skip"):
                n_skip += 1
                print(f"SKIP {label}: {res['status']}", flush=True)
            else:
                n_ok += 1
                print(f"OK   {label}: trace={res['trace_s']:.1f}s "
                      f"flops/rank={res['flops']:.3e} "
                      f"coll={res['collectives']['total_bytes']:.3e}B "
                      f"(estimates)", flush=True)
        except Exception as e:
            n_fail += 1
            res = {"arch": arch, "shape": shp, "multi_pod": mp,
                   "status": f"FAIL: {type(e).__name__}: {e}",
                   "trace": traceback.format_exc()[-2000:]}
            print(f"FAIL {label}: {type(e).__name__}: {e}", flush=True)
        res["flags"] = sorted(f.upper() for f in args.flag)
        line = json.dumps(res)
        print(line, flush=True)
        if out_f:
            out_f.write(line + "\n")
            out_f.flush()
    if out_f:
        out_f.close()
    print(f"done: {n_ok} ok, {n_skip} skipped, {n_fail} failed")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
