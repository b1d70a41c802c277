"""Times the PyTorch port's serving path and its redesigned kernels on one
NVIDIA GPU, on the models chip_smoke.py fits, for the ``src/`` of any
checkout of this repository.

    python3 kernel_times.py --packs DIR [--src DIR] [--sweep] [--out FILE]
    python3 kernel_times.py --dcd --packs DIR [--src DIR] [--dcd-sweep]
    python3 kernel_times.py --smo [--src DIR] [--smo-sweep] [--out FILE]
    python3 kernel_times.py --gram [--src DIR] [--gram-sweep] [--out FILE]
    python3 kernel_times.py --lm [--src DIR] [--lm-sweep] [--out FILE]
    python3 kernel_times.py --lm-train [--src DIR] [--out FILE]
    python3 kernel_times.py --host [--src DIR] [--out FILE]
    python3 kernel_times.py --serving-load --packs DIR [--src DIR]

``--packs`` holds what chip_smoke.py saves under ``chiprun_out/``: the
exact binary SVC (``chip_smoke_model.npz``), the OvO and OvR models of
its overlapping configuration (``chip_smoke_ovo_overlapping.npz``,
``chip_smoke_ovr_overlapping.npz``) and the RFF SVC
(``chip_smoke_lowrank.npz``, for its map). Their held-out rows are made
again as chip_smoke.py makes them (``binary_split``, ``pavia_split``).
One JSON line each:

* ``serve``: the three classifiers, the OvO pack quantized to fp16 and
  bf16, and the RFF SVC through ``serve.Predictor``, warmed at the
  batch ladder: rows/s by request size (``chip_smoke.serve_rates``),
  rows/s and host µs a call of ``decision_values`` at 1, 37, 256 and
  1,024 rows, a warmed predictor's memory; for a checkout whose
  predictor replays a CUDA graph a batch bucket, with the graphs and
  eagerly (``predictor.CUDA_GRAPHS``), each with its captures and
  capture / instantiation seconds;
* ``kernel``: the device time (``chip_smoke.device_ms``) of
  ``ops.decision`` over all binary held-out rows, of
  ``ops.multitask_decision`` at the binary bank (T = 1), the largest
  served OvO and OvR banks and all nine OvR tasks as one bank
  (``chip_smoke.serving_bank``), over 1,024 rows and over one, with the
  wall time of one call among 500 back to back (``host_us``), and of
  ``ops.rff_features`` with the RFF map over the binary training rows
  (the low-rank fit's shape) and over 1,024 of them; each beside the
  library calls' device time for the same function.

``--sweep`` adds every row tile and split of ``multitask_decision`` at
the multi-task banks (a checkout whose ``decision.py`` has
``plan_with``), each checked bit for bit against the planned launch.

``--quant`` (with ``--packs``) times only the quantized route of
``multitask_decision`` (``quant`` lines): an fp16 and a bf16 bank (the
served coef rounded as a quantized pack stores it) at the largest served
OvO and OvR banks over 1,024 held-out rows, each beside the float32
kernel on the upcast bank in the same process (device time, kernel
first, then float32, then the kernel again), with the bits against that
float32 launch and ptxas's registers and spills of the instantiation the
plan takes. With ``--sweep`` it adds each row tile and split of the
quantized banks (``quant_sweep`` lines; a checkout whose ``plan_with``
takes the bank's dtype sizes its 16-bit stage), each checked bit for bit
against the float32 kernel, and for such a checkout a build of a copy of
``csrc/decision.cu`` cut by a regex (``QUANT_LANDING``; ``quant_landing``
lines, a diagnostic that is never shipped): the SV norm pass also writes
each 16-bit tile widened into a float32 stage, which the contraction
reads (the float32 plan's shared memory), at 128-row tiles and the
plan's split and 16.

``--serving-load`` (with ``--packs``) runs ``chip_smoke.py``'s
``serving_load`` phase alone on the checkout, in a fresh process (a
``serving_load`` line with its gate's outcome): batch-1 capacity, p50 /
p99, sustained rows/s and the dynamic / per-request ratio.

``--dcd`` times ``dcd_epoch`` alone (``dcd`` lines, no serving): at the
binary low-rank fit's shape (the training rows through
``chip_smoke_lowrank.npz``'s map, 29,491 x 1,024) and the OvO low-rank
fit's task epoch (36 tasks over the overlapping split's 33,178 rows
through ``chip_smoke_ovo_lowrank.npz``'s map): one task-axis launch
where the checkout has ``ops.dcd_epoch_tasks``, else 36 one-task
launches, and the 36 one-task launches in either case. Each from a cold
state swept 20 epochs first, then device time a call (each call one
more epoch). ``--dcd-sweep`` adds, for a checkout with
``dcd.dcd_plan``, every window and a few ring depths at the binary
shape, and a build of a copy of ``csrc/dcd_epoch.cu`` with the
producer's row copies cut out: the time of the chain alone, a
diagnostic that is never shipped.

``--smo`` times the exact SMO solver's two kernels and fits (``smo``
lines; no packs: the data are made as chip_smoke.py makes them). At the
binary fit's shape (29,491 x 102, ``binary_split``): a Gram row through
the pallas engine's LRU cache (``engine.row(i, cache)``) on a hit and
on a miss (64 rows in turn through 32 slots), and ``ops.gram_row``
uncached; ``ops.gram_row`` with the task axis at the OvO and OvR
buckets of the overlapping multiclass split (``pavia_split``);
``ops.kkt_select`` at T = 1 and at both buckets. Each with its device
time (``chip_smoke.device_ms``), the wall time of one call among 500
back to back (``host_us``) and the device kernels a call (profiler);
beside them the device time of an empty kernel launched as the kernels
are (a checkout whose library has ``svm_empty``). Then the exact fits
(``smo_fit`` lines, ``smo_fits``): the exact SVC (``SVC(engine="pallas",
shrink_every=4)`` on the binary split), OvO and OvR (overlapping split)
and the exact SVR at 16,384 rows with shrinking and in its default
configuration, each after a fit of its shape cut to 2 blocks; for a
checkout whose solver replays its check block from a CUDA graph, with
the graph and with the eager loop (``smo.CUDA_GRAPHS``): wall seconds,
launches an iteration, the graphs' capture and instantiation seconds,
and under the profiler a window of 20 check blocks
(``chip_smoke.block_profile``) for the busy share and device kernels an
iteration. ``--smo-sweep`` (this tree)
adds the cached row call at the binary shape for builds of copies of
``csrc/rbf_gram.cu`` cut by a regex, diagnostics that are never
shipped: without the ticket (the lookup warp never writes the cache's
state), without the row's store into its slot, and with at most 4 row
warps a block (the shipped kernel takes 8); and ``kkt_select`` at its
three shapes for a build with blocks of 1,024 threads (the shipped one
takes 256).

``--gram`` times the Gram block route (``gram`` lines; no packs): the
block ``ops.rbf_gram`` at 2,048 x 29,491 x 102 (the binary split's
training rows) in float32 and bfloat16, and the pallas engine's matvec
``engine.matvec(v)`` at the binary fit's shape (both dtypes) and
``TaskKernelEngine.matvec`` at the OvO and OvR buckets of the
overlapping multiclass split, and (a checkout with row ranges) the
matvec over one rank's rows at P = 4, 7,392 x 29,491 x 102, checked
against the whole call's slice: device time (``chip_smoke.device_ms``
over as many calls as take ~50 ms) and device kernels a call. Then the
exact SVC (``shrink_every=4``) and the exact OvR fit, each fitted once
and again warm with every engine matvec counted by shape: the warm
fit's wall seconds, its matvecs, and their device time at those
shapes (``matvec_share``: that time over the fit's). A checkout with
``rbf_gram.gram_plan`` also gets a sweep of its row tiles (32, 64, 128)
for the block and the binary matvec (the tiles its route takes), each
matvec checked bit for bit against the planned launch; ``--gram-sweep``
(this tree) adds builds of ``csrc/rbf_gram.cu`` cut by a regex
(``GRAM_CUTS``: the mma.sync mainloop without the exponential, MMAs,
column copies or two of three TF32 products, timed at the fp32 block and
the bf16 matvec; the float32 matvec's wgmma route without its split, its
wgmmas or two of three products), diagnostics that are never shipped.

``--lm`` times the LM-substrate kernels at their model shapes (``lm``
lines; no packs; the inputs of ``chip_smoke.lm_inputs``):
``ops.flash_attention`` at phi4_mini_3p8b's causal attention and the
ragged non-causal S = 300 case, float32 and bfloat16 operands, each
beside ``scaled_dot_product_attention`` on the same operands, and
``ops.ssd_diag`` at mamba2_780m's chunk: device time
(``chip_smoke.device_ms``); for a checkout with the backward kernels
also ``lm_bwd`` lines: ``ops.flash_attention_bwd`` at zamba2_1p2b's and
phi4_mini_3p8b's causal shapes (``BWD_ATTN``) beside SDPA's autograd
backward, and ``ops.ssd_diag_bwd`` at zamba2's chunk (``BWD_SSD``).
``--lm-sweep`` (this tree) adds the plans'
alternatives (flash_attention's 64- and 128-row query tiles, ssd_diag's
head groups and ring depths) and builds of ``csrc/flash_attn.cu`` and
``csrc/ssd_diag.cu`` cut by a regex (``LM_CUTS``: no exponential, no
MMAs, no copies, one TF32 product (bf16: no low part of P), and for
ssd_diag no score MMAs), diagnostics that are never shipped. For the
backward kernels it adds ``lm_bwd_sweep`` lines (ssd_diag_bwd's head
groups at BWD_SSD's shape) and ``lm_bwd_cut`` builds of
``csrc/flash_attn_bwd.cu`` and ``csrc/ssd_diag_bwd.cu``
(``LM_BWD_CUTS``: no MMAs, no exponential, no tile copies, and one bf16
pass of P and dS), diagnostics that are never shipped.

``--lm-train`` times chip_smoke.py's training path (``lm_train`` lines;
no packs): zamba2_1p2b at full width and depth (``chip_smoke.LM_TRAIN``:
2 x 2,048 tokens a step, AdamW, seeded init and batches) through the
checkout's entry points (``Model``, ``AdamW``, ``make_train_step``).
Per timed step after the warm ones: the wall time and the host's part of
it (``host_ms``: until the step's call returns, before the synchronize
that ends the step; the time the host takes to issue the step's work,
any wait for the device inside the step included); their medians,
tokens/s and peak memory. Then one step under the profiler: its device
time, and the device time of the backward kernels (device kernels whose
names hold ``flash_bwd_`` or ``ssd_bwd_``) and of the rest; the
device's idle share is 1 - device time / the median step's wall time.

``--host`` times the host side of the five wrappers whose launch plans
the tuner resolves (``host`` lines; no packs; seeded inputs): the wall
time of one call among HOST_ROUNDS x HOST_CALLS back to back
(``host_us``, the median round; the calls' kernels are shorter than
their enqueue, so this is the host's time a launch) of
``ops.kkt_select`` at 29,491, ``ops.decision`` and
``ops.multitask_decision`` over one row (the binary bank, 17 SVs; the
OvO bank, 6 x 986), ``ops.rff_features`` over one row (1,024
features) and ``ops.rbf_gram`` of one row against 1,024, all at 102
features: what the per-shape memo of the plan resolution costs a
launch, for any checkout (one without the tuner plans analytically).
For a checkout with ``kernels.autotune`` it adds ``host_resolve`` lines:
the µs of the memoised resolution a wrapper makes a launch
(``autotune.resolve_*``, a hit) beside the µs of the analytic plan's own
lookup it replaced, each the median of HOST_ROUNDS rounds of 100,000
calls in one process.

Two checkouts compare in one call of the chip tool, each run in its own
process: parent, change, change, parent, and so on.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import inspect
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PACKS = {"binary": "chip_smoke_model.npz",
         "ovo": "chip_smoke_ovo_overlapping.npz",
         "ovr": "chip_smoke_ovr_overlapping.npz",
         "lowrank": "chip_smoke_lowrank.npz"}
DCD_PACKS = {"lowrank": "chip_smoke_lowrank.npz",
             "ovo_lowrank": "chip_smoke_ovo_lowrank.npz"}
WARM_EPOCHS = 20
HOST_CALLS = 500   # back-to-back calls a host_us reading averages
HOST_ROUNDS = 9    # --host: rounds of HOST_CALLS, the median kept
RANGE_RANKS = 4    # --gram: the row-range matvec of one rank of 4
LM_TRAIN_STEPS = 10  # --lm-train: timed steps after chip_smoke's warm ones
# --quant --sweep: csrc/decision.cu widening each 16-bit SV tile once as
# it lands, into a float32 work stage after the two 16-bit ones
QUANT_LANDING = [
    (r"(TS\* ss = reinterpret_cast<TS\*>\(run \+ 4 \* BM\);.*\n)",
     r"\1  float* sw = reinterpret_cast<float*>(ss + 2 * SV_TILE * ld);\n"),
    (r"ssq = fmaf\(v, v, ssq\);",
     "ssq = fmaf(v, v, ssq);\n      if (sizeof(TS) == 2) sw[nr * ld + c] = v;"),
    (r"(#pragma unroll 1\n    for \(int kk = 0; kk < cw; kk \+= 4\))",
     r"if (sizeof(TS) == 2) __syncthreads();\n\1"),
    (r"b\[j\] = ld4w\(sb \+ \(tx \+ 16 \* j\) \* ld \+ kk\);",
     "b[j] = sizeof(TS) == 2 ? ld4(sw + (tx + 16 * j) * ld + kk)"
     " : ld4w(sb + (tx + 16 * j) * ld + kk);"),
    (r"smem_bytes\(BM, pl\.chunk, nch, sizeof\(TS\)\)",
     "smem_bytes(BM, pl.chunk, nch, 4)")]


def _args():
    p = argparse.ArgumentParser()
    p.add_argument("--packs")
    p.add_argument("--src", default=os.path.join(HERE, "src"))
    p.add_argument("--sweep", action="store_true")
    p.add_argument("--quant", action="store_true")
    p.add_argument("--out", default=None)
    p.add_argument("--dcd", action="store_true")
    p.add_argument("--dcd-sweep", action="store_true")
    p.add_argument("--smo", action="store_true")
    p.add_argument("--smo-sweep", action="store_true")
    p.add_argument("--gram", action="store_true")
    p.add_argument("--gram-sweep", action="store_true")
    p.add_argument("--lm", action="store_true")
    p.add_argument("--lm-sweep", action="store_true")
    p.add_argument("--lm-train", action="store_true")
    p.add_argument("--lm-train-steps", type=int, default=LM_TRAIN_STEPS)
    p.add_argument("--host", action="store_true")
    p.add_argument("--serving-load", action="store_true")
    args = p.parse_args()
    if args.packs is None and not (args.smo or args.gram or args.lm
                                   or args.lm_train or args.host):
        p.error("--packs is required, except with --smo, --gram, --lm, "
                "--lm-train or --host")
    return args


def main() -> int:
    args = _args()
    import chip_smoke as cs   # timing helpers; puts ./src on sys.path
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("kernel_times: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path[:] = [p for p in sys.path if p != os.path.join(HERE, "src")]
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch import data, serve
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import decision as D
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    _build.library()
    dev = torch.device("cuda")

    def emit(**row):
        line = json.dumps({"src": args.src, "card": card, **row})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    if args.dcd:
        dcd_times(args, cs, data, serve, ops, dev, emit)
        return 0
    if args.smo:
        smo_times(cs, data, _build, ops, dev, emit, args.smo_sweep)
        return 0
    if args.gram:
        gram_times(cs, data, _build, ops, dev, emit, args.gram_sweep)
        return 0
    if args.lm:
        lm_times(cs, _build, ops, dev, emit, args.lm_sweep)
        return 0
    if args.lm_train:
        lm_train_times(cs, dev, emit, args.lm_train_steps)
        return 0
    if args.host:
        host_times(ops, dev, emit)
        return 0
    if args.quant:
        quant_times(args, cs, data, serve, _build, ops, D, dev, emit)
        return 0
    if args.serving_load:
        serving_load_times(args, cs, data, serve, ops, dev, emit)
        return 0
    packs = {k: serve.load(os.path.join(args.packs, f))
             for k, f in PACKS.items()}
    xtr_b, _, xte_b, _ = cs.binary_split(data)
    xte_m = cs.pavia_split(data, cs.PAVIA_NOISE["overlapping"])[2]

    def host_us(fn, calls=HOST_CALLS):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / calls * 1e6

    def cuda(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    serve_times(cs, serve, packs, xte_b, xte_m, dev, emit)

    gamma = packs["binary"].kernel.gamma
    g = packs["binary"].buckets[0]
    sv, cf, z = cuda(g.sv_x[0]), cuda(g.sv_coef[0]), cuda(xte_b)
    emit(measure="kernel", kernel="decision", shape=[1, *z.shape, sv.shape[0]],
         device_ms=cs.device_ms(lambda: ops.decision(z, sv, cf,
                                                     gamma=gamma)),
         library_device_ms=cs.device_ms(
             lambda: cs.library_decision(z, sv[None], cf[None], gamma)))
    banks = [("binary", gamma, sv[None], cf[None], cuda(xte_b))]
    for model, whole in (("ovo", False), ("ovr", False), ("ovr", True)):
        sv_np, cf_np = cs.serving_bank(packs[model], whole)
        banks.append((model + (" all tasks" if whole else ""),
                      packs[model].kernel.gamma, cuda(sv_np), cuda(cf_np),
                      cuda(xte_m)))
    for bank, gam, sv, cf, zz in banks:
        for nt in (1024, 1):
            z = zz[:nt]

            def kern():
                return ops.multitask_decision(z, sv, cf, gamma=gam)

            emit(measure="kernel", kernel="multitask_decision", bank=bank,
                 shape=[sv.shape[0], nt, *sv.shape[1:]],
                 device_ms=cs.device_ms(kern), host_us=host_us(kern),
                 library_device_ms=cs.device_ms(
                     lambda: cs.library_decision(z, sv, cf, gam)))
            if not args.sweep or sv.shape[0] == 1:
                continue
            from repro_torch.kernels.tile_f32 import current_stream
            lib, want = _build.library(), kern()
            out = torch.empty_like(want)
            n_tasks, w, d = sv.shape
            segments = D.decision_plan(nt, n_tasks, w, d).segments
            for rows in (64, 128):
                for s in sorted({1, 2, 3, 4, 6, 8, 12, 16, segments}):
                    if s > segments:
                        continue
                    plan = D.plan_with(nt, n_tasks, w, d, rows, s)
                    part, tick = D.scratch(plan, n_tasks, nt, dev,
                                           current_stream())

                    def fn():
                        return D.launch_multitask(
                            lib, z, sv, cf, out, gamma=gam, mode="rbf",
                            plan=plan, partial=part, ticket=tick)

                    fn()
                    emit(measure="sweep", kernel="multitask_decision",
                         bank=bank, shape=[n_tasks, nt, w, d],
                         plan=plan._asdict(),
                         equal_to_planned=bool(torch.equal(out, want)),
                         device_ms=cs.device_ms(fn))

    fm = packs["lowrank"].feature_map
    om, ph = cuda(fm.a), cuda(fm.b)
    scale = float(np.sqrt(2.0 / om.shape[1]))
    x = cuda(xtr_b)
    for n in (x.shape[0], 1024):
        xs = x[:n]
        emit(measure="kernel", kernel="rff_features",
             shape=[n, om.shape[1], om.shape[0]],
             device_ms=cs.device_ms(
                 lambda: ops.rff_features(xs, om, ph, scale=scale)),
             library_device_ms=cs.device_ms(
                 lambda: scale * torch.cos(torch.addmm(ph, xs, om))))
    return 0


def serve_times(cs, serve, packs, xte_b, xte_m, dev, emit):
    """``serve`` lines: the binary, OvO, OvR, fp16 / bf16 OvO and RFF
    packs through ``serve.Predictor(engine="pallas")``, warmed at the
    whole batch ladder; for a checkout whose predictor replays a CUDA
    graph a bucket (``predictor.CUDA_GRAPHS``), once with the graphs and
    once eagerly, else as it runs. Each: rows/s of ``predict`` by request
    size (``chip_smoke.serve_rates``), rows/s and host µs a call of
    ``decision_values`` at 1, 37, 256 and 1,024 rows
    (``chip_smoke.rows_per_s``), and the graphs' captures and capture /
    instantiation seconds."""
    import torch
    from repro_torch.serve import predictor
    modes = ("graph", "eager") if hasattr(predictor, "CUDA_GRAPHS") \
        else (None,)
    models = {"binary": (packs["binary"], xte_b),
              "ovo": (packs["ovo"], xte_m), "ovr": (packs["ovr"], xte_m),
              "ovo_fp16": (serve.quantize(packs["ovo"], "fp16"), xte_m),
              "ovo_bf16": (serve.quantize(packs["ovo"], "bf16"), xte_m),
              "rff": (packs["lowrank"], xte_b)}
    for model, (pack, xte) in models.items():
        for mode in modes:
            if mode is not None:
                predictor.CUDA_GRAPHS = mode == "graph"
            try:
                pred = serve.Predictor(pack, engine="pallas", device=dev)
            finally:
                if mode is not None:
                    predictor.CUDA_GRAPHS = True
            torch.cuda.synchronize()
            m0 = torch.cuda.memory_allocated()
            pred.warmup(cs.SERVE_LADDER)
            torch.cuda.synchronize()
            warmed = torch.cuda.memory_allocated() - m0
            emit(measure="serve", model=model, mode=mode,
                 banks=[list(g.sv_x.shape) for g in pack.buckets],
                 rows_per_s=cs.serve_rates(pred, xte)[0],
                 decision_values=cs.rows_per_s(pred, xte),
                 memory_allocated_warmup=warmed,
                 graph_stats=getattr(pred, "graph_stats", None))
            del pred


def serving_load_times(args, cs, data, serve, ops, dev, emit):
    """``serving_load`` line: ``chip_smoke.phase_serving_load`` (the
    open-loop replay against a ServingService and a one-request-a-call
    server over a registry of the binary, OvO and OvO-bf16 packs) run on
    this checkout in a fresh process, its line re-emitted with ``gate``:
    True, or the failed check's message (the phase's gates are
    chip_smoke.py's; here they are read, not enforced)."""
    binary = serve.load(os.path.join(args.packs, PACKS["binary"]))
    ovo = serve.load(os.path.join(args.packs, PACKS["ovo"]))
    xte_b = cs.binary_split(data)[2]
    xte_m = cs.pavia_split(data, cs.PAVIA_NOISE["overlapping"])[2]
    lines, out_line, gate = [], cs.out_line, True
    cs.out_line = lines.append
    try:
        cs.phase_serving_load(
            ops, serve, dev, {"binary": binary, "ovo": ovo,
                              "ovo_bf16": serve.quantize(ovo, "bf16")},
            {"binary": xte_b, "ovo": xte_m, "ovo_bf16": xte_m})
    except cs.SmokeFailure as e:
        gate = str(e)
    finally:
        cs.out_line = out_line
    for line in lines:
        emit(measure="serving_load", gate=gate,
             **{k: v for k, v in line.items() if k != "phase"})


def quant_times(args, cs, data, serve, _build, ops, D, dev, emit):
    """``--quant``: the quantized bank route against the float32 kernel
    on the upcast bank (see the module's docstring)."""
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        _quant_times(args, cs, data, serve, _build, ops, D, dev, emit, tmp)


def _quant_times(args, cs, data, serve, _build, ops, D, dev, emit, tmp):
    import numpy as np
    import torch
    from repro_torch.kernels.tile_f32 import current_stream
    xte = cs.pavia_split(data, cs.PAVIA_NOISE["overlapping"])[2]
    z = torch.from_numpy(np.ascontiguousarray(xte[:1024])).to(dev)
    nt = z.shape[0]
    # a checkout whose plan sizes a 16-bit SV stage takes the bank dtype
    typed = "bank" in inspect.signature(D.plan_with).parameters
    elem = {torch.float16: "6__half", torch.bfloat16: "13__nv_bfloat16"}
    lib = _build.library()
    landing = (variant_lib(_build, tmp, "decision.cu", "decision_landing",
                           QUANT_LANDING, "svm_multitask_decision")
               if args.sweep and typed else None)
    for model in ("ovo", "ovr"):
        packed = serve.load(os.path.join(args.packs, PACKS[model]))
        gamma = packed.kernel.gamma
        sv_np, cf_np = cs.serving_bank(packed)
        sv32 = torch.from_numpy(np.ascontiguousarray(sv_np)).to(dev)
        cf32 = torch.from_numpy(np.ascontiguousarray(cf_np)).to(dev)
        n_tasks, w, d = sv32.shape
        for name, dt in (("fp16", torch.float16), ("bf16", torch.bfloat16)):
            svq = sv32.to(dt)
            up, cf = svq.float(), cf32.to(dt).float()
            bank = {"bank": dt} if typed else {}

            def kern():
                return ops.multitask_decision(z, svq, cf, gamma=gamma)

            def fp32():
                return ops.multitask_decision(z, up, cf, gamma=gamma)

            want = fp32()
            plan = D.decision_plan(nt, n_tasks, w, d, **bank)
            ptx = _build.ptxas_report(
                f"decision_kernelIf{elem[dt]}Li{plan.rows // 16}E")
            emit(measure="quant", bank=model, bank_dtype=name,
                 shape=[n_tasks, nt, w, d], plan=plan._asdict(),
                 bits_equal_fp32_kernel=bool(torch.equal(kern(), want)),
                 device_ms=cs.device_ms(kern),
                 fp32_device_ms=cs.device_ms(fp32),
                 device_ms_repeat=cs.device_ms(kern), ptxas=ptx)
            if not args.sweep:
                continue
            out = torch.empty_like(want)
            for rows in (64, 128):
                for sp in sorted({1, 2, 4, 5, 8, 12, 16, plan.segments}):
                    if sp > plan.segments:
                        continue
                    p_ = D.plan_with(nt, n_tasks, w, d, rows, sp, **bank)
                    part, tick = D.scratch(p_, n_tasks, nt, dev,
                                           current_stream())

                    def fn():
                        return D.launch_multitask(
                            lib, z, svq, cf, out, gamma=gamma, mode="rbf",
                            plan=p_, partial=part, ticket=tick)

                    rc = fn()
                    emit(measure="quant_sweep", bank=model, bank_dtype=name,
                         shape=[n_tasks, nt, w, d], plan=p_._asdict(),
                         rc=rc, equal_to_fp32=bool(torch.equal(out, want)),
                         device_ms=cs.device_ms(fn) if rc == 0 else None)
            if landing is None:
                continue
            for sp in sorted({plan.splits, 16} & set(
                    range(1, plan.segments + 1))):
                p32 = D.plan_with(nt, n_tasks, w, d, 128, sp)
                part, tick = D.scratch(p32, n_tasks, nt, dev,
                                       current_stream())
                runs = {"landing": (landing, svq, p32),
                        "shipped": (lib, svq, D.plan_with(
                            nt, n_tasks, w, d, 128, sp, dt)),
                        "fp32": (lib, up, p32)}
                row, bits = {}, True
                for tag, (lb, sv_, p_) in runs.items():
                    def fn(lb=lb, sv_=sv_, p_=p_):
                        return D.launch_multitask(
                            lb, z, sv_, cf, out, gamma=gamma, mode="rbf",
                            plan=p_, partial=part, ticket=tick)
                    rc = fn()
                    bits = bits and rc == 0 and bool(torch.equal(out, want))
                    row[f"{tag}_device_ms"] = (cs.device_ms(fn) if rc == 0
                                               else None)
                emit(measure="quant_landing", bank=model, bank_dtype=name,
                     shape=[n_tasks, nt, w, d], rows=128, splits=sp,
                     equal_to_fp32=bits, **row)


def host_times(ops, dev, emit):
    """The ``--host`` lines (see the module's docstring)."""
    import statistics
    import numpy as np
    import torch
    from repro_torch.kernels import rbf_gram as G
    rng = np.random.default_rng(7)

    def t(shape, dt=torch.float32):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(dev, dt)

    n, d = 29491, 102
    f, alpha, y = t(n), t(n).abs(), t(n).sign()
    lo, hi = torch.zeros(n, device=dev), torch.ones(n, device=dev)
    mask = torch.ones(n, dtype=torch.bool, device=dev)
    z, sv1, cf1 = t((1, d)), t((17, d)), t(17)
    sv6, cf6 = t((6, 986, d)), t((6, 986))
    om, ph = t((d, 1024)), t(1024)
    b = G.staged(t((1024, d)))
    b2 = (b * b).sum(1)
    calls = {
        "kkt_select": ([n], lambda: ops.kkt_select(f, alpha, y, mask, lo,
                                                   hi)),
        "decision": ([1, 17, d], lambda: ops.decision(z, sv1, cf1,
                                                      gamma=0.01)),
        "multitask_decision": ([6, 1, 986, d], lambda: ops.multitask_decision(
            z, sv6, cf6, gamma=0.01)),
        "rff_features": ([1, 1024, d], lambda: ops.rff_features(
            z, om, ph, scale=0.04)),
        "rbf_gram": ([1, 1024, d], lambda: ops.rbf_gram(
            z, b, gamma=0.01, b2=b2))}
    for kernel, (shape, fn) in calls.items():
        fn()
        torch.cuda.synchronize()
        rounds = []
        for _ in range(HOST_ROUNDS):
            t0 = time.perf_counter()
            for _ in range(HOST_CALLS):
                fn()
            torch.cuda.synchronize()
            rounds.append((time.perf_counter() - t0) / HOST_CALLS * 1e6)
        emit(measure="host", kernel=kernel, shape=shape,
             host_us=statistics.median(rounds), rounds_us=rounds)
    try:
        from repro_torch.kernels import autotune
    except ImportError:   # a checkout without the tuner
        return
    import timeit
    from repro_torch.kernels import decision as D
    from repro_torch.kernels import feature_map as FM
    from repro_torch.kernels import kkt_select as KS
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    f32 = torch.float32
    pairs = {
        "kkt_select": (lambda: autotune.resolve_kkt(n, dev, None),
                       lambda: KS.n_blocks(n)),
        "decision": (lambda: autotune.resolve_decision(
            "decision", 1, 1, 17, d, f32, dev, sms, None, None),
            lambda: D.decision_plan(1, 1, 17, d, sms)),
        "multitask_decision": (lambda: autotune.resolve_decision(
            "multitask_decision", 1, 6, 986, d, f32, dev, sms, None, None),
            lambda: D.decision_plan(1, 6, 986, d, sms)),
        "rff_features": (lambda: autotune.resolve_rff(
            1, 1024, d, f32, dev, sms, None),
            lambda: FM.rff_plan(1, 1024, d, sms)),
        "rbf_gram": (lambda: autotune.resolve_gram(
            1, 1024, d, f32, dev, sms, None),
            lambda: G.gram_plan(1, 1024, d, f32, sms=sms))}
    for kernel, (resolve, plan) in pairs.items():
        us = {}
        for name, fn in (("resolve", resolve), ("plan", plan)):
            fn()
            us[name] = statistics.median(
                timeit.timeit(fn, number=100_000) / 100_000 * 1e6
                for _ in range(HOST_ROUNDS))
        emit(measure="host_resolve", kernel=kernel, resolve_us=us["resolve"],
             analytic_plan_us=us["plan"])


def smo_times(cs, data, _build, ops, dev, emit, sweep=False):
    """The ``--smo`` lines (see the module's docstring)."""
    import numpy as np
    import torch
    from repro_torch.core import dist, kernel_engine as KE
    from repro_torch.core import kernels as K
    from repro_torch.core import multiclass as MC
    from repro_torch.kernels.tile_f32 import current_stream

    def host_us(fn, calls=HOST_CALLS):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / calls * 1e6

    def timed(fn):
        # as many calls as the host enqueues in ~2.5 ms, well inside the
        # spin kernel that device_ms queues them behind
        us = host_us(fn)
        calls = max(3, min(50, int(2500 / us)))
        return dict(device_ms=cs.device_ms(fn, calls=calls), host_us=us,
                    device_calls=calls,
                    kernels_per_call=cs.kernels_per_call(fn))

    lib = _build.library()
    empty = getattr(lib, "svm_empty", None)
    if empty is not None:
        empty.argtypes, empty.restype = [ctypes.c_void_p], ctypes.c_int
        emit(measure="smo", case="empty_kernel",
             **timed(lambda: empty(current_stream())))

    xtr, ytr, _, _ = cs.binary_split(data)
    x = torch.from_numpy(xtr).to(dev)
    n, d = x.shape
    kp = K.resolve_gamma(K.KernelParams(gamma=-1.0), x)
    eng = KE.make_engine(x, kp, "pallas")
    i = torch.tensor(n // 3, device=dev)
    turn = [torch.tensor(v, device=dev) for v in range(0, n, n // 64)][:64]
    hit_cache, miss_cache = eng.init_cache(), eng.init_cache()
    eng.row(i, hit_cache)
    pos = [0]

    def miss():
        pos[0] += 1
        return eng.row(turn[pos[0] % len(turn)], miss_cache)

    for case, fn in (("row_cached_hit", lambda: eng.row(i, hit_cache)),
                     ("row_cached_miss", miss),
                     ("row_uncached", lambda: ops.gram_row(
                         eng._xk, eng._x2, i, gamma=kp.gamma))):
        emit(measure="smo", case=case, shape=[n, d], **timed(fn))
    emit(measure="smo", case="row_cache_counts",
         hit_cache=[int(hit_cache.hits), int(hit_cache.misses)],
         miss_cache=[int(miss_cache.hits), int(miss_cache.misses)])
    stack = contextlib.ExitStack()
    wide = None   # a ticket route of 1,024-thread blocks (--smo-sweep)
    if sweep:
        tmp = stack.enter_context(tempfile.TemporaryDirectory(
            dir=_build.BUILD_DIR))
        row_sweep(cs, _build, eng, i, turn, emit, tmp)
        wide = variant_lib(_build, tmp, "kkt_select.cu", "kkt_wide_blocks",
                           [(r"KKT_THREADS = 256;", "KKT_THREADS = 1024;")],
                           "svm_kkt_select")

    rng = np.random.default_rng(cs.SEED)
    from repro_torch.kernels import kkt_select as KS

    def selection(shape, y, mask, case, **tags):
        f = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
            dev)
        alpha = torch.from_numpy(np.where(
            rng.random(shape) < 0.4, 0.0, rng.uniform(0, 1, shape)).astype(
                np.float32)).to(dev)
        lo, hi = torch.zeros_like(f), torch.ones_like(f)
        emit(measure="smo", case=case, shape=list(shape), **tags,
             **timed(lambda: ops.kkt_select(f, alpha, y, mask, lo, hi)))
        if wide is None:
            return
        # the diagnostic build: 1,024-thread blocks, the same bits
        tasks = shape[0] if len(shape) == 2 else 1
        vals = torch.empty((2, tasks), device=dev)
        idx = torch.empty((2, tasks), dtype=torch.int64, device=dev)
        b_up, i_up, b_low, i_low = (v.reshape(-1) for v in ops.kkt_select(
            f, alpha, y, mask, lo, hi))
        blocks = -(-shape[-1] // 4096)

        def run():
            return KS.launch(wide, f, alpha, y, mask, lo, hi, vals, idx,
                             blocks=blocks)

        assert run() == 0
        same = (torch.equal(vals[0], b_up) and torch.equal(vals[1], b_low)
                and torch.equal(idx[0], i_up) and torch.equal(idx[1], i_low))
        emit(measure="smo_sweep", build="kkt_1024_thread_blocks", case=case,
             shape=list(shape), **tags, blocks=blocks,
             equal_to_entry=bool(same), device_ms=cs.device_ms(run, calls=50))

    yb = torch.from_numpy(np.where(ytr == ytr.max(), 1.0, -1.0).astype(
        np.float32)).to(dev)
    selection((n,), yb, torch.ones(n, dtype=torch.bool, device=dev),
              "kkt_select")

    xm, ym, _, _ = cs.pavia_split(data, cs.PAVIA_NOISE["overlapping"])
    for strategy in ("ovo", "ovr"):
        taskset = MC.get_strategy(strategy).build_taskset(xm, ym)
        bucket = MC.build_schedule(taskset.sizes).buckets[0]
        xt, yt, mk, _ = dist._bucket_arrays(taskset, bucket)
        xb = torch.from_numpy(xt).to(dev)
        x2 = K.sqnorms(xb)
        mask = torch.from_numpy(mk).to(dev)
        ib = (mask.sum(dim=1) // 3).to(torch.int64)
        emit(measure="smo", case="row_task_axis", strategy=strategy,
             shape=list(xb.shape), **timed(lambda: ops.gram_row(
                 xb, x2, ib, gamma=kp.gamma)))
        selection(tuple(mask.shape), torch.from_numpy(yt).to(dev), mask,
                  "kkt_select_task_axis", strategy=strategy)
    del xb, x2

    stack.close()
    smo_fits(cs, data, ops, dev, emit, (xtr, ytr), (xm, ym))


def smo_fits(cs, data, ops, dev, emit, binary, overlapping):
    """The exact fits of ``--smo`` (``smo_fit`` lines): the exact SVC,
    OvO and OvR (overlapping split) and SVR (shrinking, and the default
    configuration) at chip_smoke.py's sizes; for a checkout whose solver
    captures its check block (``smo.CUDA_GRAPHS``), each with the graph
    and again with the eager loop, else as the checkout runs it. Each
    after a fit of the same shape cut to 2 blocks (plans, allocator), its
    wall seconds, iterations, launches an iteration (the wrappers'
    counts), the CUDA graphs' captures and seconds issuing and
    instantiating them, and under the profiler a window of check blocks
    (``chip_smoke.block_profile``): busy share and device kernels an
    iteration, and the fit's busy share: its check blocks at the window's
    device seconds a block (``chip_smoke.fit_busy_share``)."""
    import torch
    from repro_torch.core import smo
    from repro_torch.core.svm import SVC, SVR
    xs, ys = cs.svr_split(data, 16384)[:2]
    svr = dict(engine="pallas", epsilon=0.1, C=1.0, tol=1e-3)
    mc = dict(decision="vote", engine="pallas", C=1.0, tol=1e-3)
    fits = (("svc_exact", SVC, binary, dict(engine="pallas",
                                            shrink_every=4)),
            ("ovo_exact", SVC, overlapping, dict(strategy="ovo", **mc)),
            ("ovr_exact", SVC, overlapping, dict(strategy="ovr", **mc)),
            ("svr_exact", SVR, (xs, ys), dict(**svr, shrink_every=4)),
            ("svr_default_config", SVR, (xs, ys), svr))
    modes = ({"graph": True, "eager": False}
             if hasattr(smo, "CUDA_GRAPHS") else {"checkout": None})
    for case, model, (xf, yf), kw in fits:
        for mode, graphs in modes.items():
            if graphs is not None:
                smo.CUDA_GRAPHS = graphs
            model(**kw, max_iter=64, device=dev).fit(xf, yf)
            torch.cuda.synchronize()
            ops.reset_launches()
            g0 = dict(getattr(smo, "graph_stats", {}))
            t0 = time.perf_counter()
            with cs.counting_blocks(smo) as blocks:
                fit = model(**kw, device=dev).fit(xf, yf)
                torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
            graph = {k: v - g0[k] for k, v in
                     getattr(smo, "graph_stats", {}).items()}
            launches = {k: v for k, v in ops.launches.items() if v}
            iters = (int(fit._fit.n_iter.max()) if "strategy" in kw
                     else int(fit.n_iter_))
            busy = cs.block_profile(smo, lambda: model(**kw, device=dev)
                                    .fit(xf, yf))
            emit(measure="smo_fit", case=case, mode=mode, n_iter=iters,
                 fit_s=fit_s, graph=graph,
                 blocks=blocks[0],
                 busy_share_fit=cs.fit_busy_share(busy, blocks[0], fit_s),
                 launches_per_iter={k: v / iters
                                    for k, v in launches.items()},
                 **busy)
    if "graph" in modes:
        smo.CUDA_GRAPHS = True


def gram_times(cs, data, _build, ops, dev, emit, sweep=False):
    """The ``--gram`` lines (see the module's docstring)."""
    import numpy as np
    import torch
    from repro_torch.core import dist, kernel_engine as KE
    from repro_torch.core import kernels as K
    from repro_torch.core import multiclass as MC
    from repro_torch.core.svm import SVC
    from repro_torch.kernels import rbf_gram as G

    def timed(fn, kernels=True):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        one = (time.perf_counter() - t0) * 1e3
        calls = max(2, min(50, int(50 / max(one, 1e-3))))
        out = dict(device_ms=cs.device_ms(fn, calls=calls), device_calls=calls)
        if kernels:
            out["kernels_per_call"] = cs.kernels_per_call(
                fn, calls=min(calls, 20))
        return out

    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)
    xtr, ytr, _, _ = cs.binary_split(data)
    x = torch.from_numpy(xtr).to(dev)
    n, d = x.shape
    kp = K.resolve_gamma(K.KernelParams(gamma=-1.0), x)
    v = torch.randn(n, generator=gen, device=dev)
    engines = {}
    for dtype in ("fp32", "bf16"):
        eng = KE.make_engine(x, kp, KE.EngineConfig(backend="pallas",
                                                    gram_dtype=dtype))
        engines[dtype] = eng
        xs = getattr(eng, "_xs", eng._xk)   # the engine's rows, as staged
        blk, blk2 = xs[:2048], eng._x2[:2048]
        emit(measure="gram", case="block", dtype=dtype, shape=[2048, n, d],
             **timed(lambda: ops.rbf_gram(blk, xs, gamma=kp.gamma,
                                          compute_dtype=dtype, a2=blk2,
                                          b2=eng._x2)))
        emit(measure="gram", case="matvec", dtype=dtype, shape=[1, n, d],
             **timed(lambda: eng.matvec(v)))
        if "row0" in inspect.signature(ops.gram_matvec).parameters:
            # one rank's rows of the data-parallel SMO at P = RANGE_RANKS
            # the sharded engine's block: whole 32-row chunks
            count = -(-n // (RANGE_RANKS * 32)) * 32
            whole = eng.matvec(v)

            def ranged():
                return ops.gram_matvec(xs, eng._x2, v, gamma=kp.gamma,
                                       row0=count, count=count)

            emit(measure="gram", case="matvec_range", dtype=dtype,
                 shape=[count, n, d], row0=count, ranks=RANGE_RANKS,
                 equal_whole_slice=bool(torch.equal(
                     ranged(), whole[count:2 * count])),
                 **timed(ranged))
    xm, ym, _, _ = cs.pavia_split(data, cs.PAVIA_NOISE["overlapping"])
    kpm = K.resolve_gamma(K.KernelParams(gamma=-1.0),
                          torch.from_numpy(xm).to(dev))
    for strategy in ("ovo", "ovr"):
        taskset = MC.get_strategy(strategy).build_taskset(xm, ym)
        bucket = MC.build_schedule(taskset.sizes).buckets[0]
        xt, _, mk, _ = dist._bucket_arrays(taskset, bucket)
        teng = KE.TaskKernelEngine(torch.from_numpy(xt).to(dev), kpm,
                                   "pallas")
        mask = torch.from_numpy(mk).to(dev)
        vb = torch.randn(mask.shape, generator=gen, device=dev) * mask
        emit(measure="gram", case="matvec_task_axis", strategy=strategy,
             shape=list(xt.shape), **timed(lambda: teng.matvec(vb)))
        del teng

    if hasattr(G, "gram_plan"):   # the row-tile sweep of this route
        lib = _build.library()
        eng = engines["fp32"]
        want = eng.matvec(v)
        out = torch.empty_like(want)
        blk, blk2 = eng._xs[:2048], eng._x2[:2048]
        kblk = torch.empty((2048, n), device=dev)
        mv_rows = getattr(G, "route_rows", lambda *a: G.ROWS)(
            d, torch.float32, "matvec")
        for rows in G.ROWS:
            bplan = G.gram_plan(2048, n, d, rows=rows)

            def bk():
                return G.launch_block(lib, blk, eng._xs, blk2, eng._x2, kblk,
                                      gamma=kp.gamma, mode="rbf", plan=bplan)

            assert bk() == 0
            row = dict(block_plan=bplan._asdict(),
                       block_device_ms=cs.device_ms(bk, calls=20))
            if rows in mv_rows:   # the row tiles the matvec's route takes
                plan = G.gram_plan(n, n, d, entry="matvec", rows=rows)

                def mv():
                    return G.launch_matvec(lib, eng._xs, eng._x2, v, out,
                                           gamma=kp.gamma, mode="rbf",
                                           plan=plan)

                assert mv() == 0
                row.update(matvec_plan=plan._asdict(),
                           matvec_equal_to_planned=bool(torch.equal(out, want)),
                           matvec_device_ms=cs.device_ms(mv, calls=20))
            emit(measure="gram_sweep", rows=rows, **row)
        if sweep:
            gram_cuts(cs, _build, G, engines, v, kp.gamma, emit)
    del engines

    # the fits' matvecs: every outermost engine matvec counted by shape
    counts, samples, depth = {}, {}, [0]
    originals = {cls: cls.matvec for cls in (KE.PallasKernelEngine,
                                             KE.TaskKernelEngine)}

    def counting(cls):
        orig = originals[cls]

        def matvec(self, vec):
            if depth[0] == 0:
                key = (cls.__name__, tuple(vec.shape))
                counts[key] = counts.get(key, 0) + 1
                samples.setdefault(key, (self, vec.clone()))
            depth[0] += 1
            try:
                return orig(self, vec)
            finally:
                depth[0] -= 1
        return matvec

    for cls in originals:
        cls.matvec = counting(cls)
    fits = (("svc_exact", xtr, ytr, dict(engine="pallas", shrink_every=4)),
            ("ovr_exact", xm, ym, dict(strategy="ovr", decision="vote",
                                       engine="pallas", C=1.0, tol=1e-3)))
    try:
        for case, xf, yf, kw in fits:
            SVC(**kw, device=dev).fit(xf, yf)
            counts.clear()
            samples.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            clf = SVC(**kw, device=dev).fit(xf, yf)
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
            iters = (int(clf.n_iter_) if "strategy" not in kw
                     else int(clf._fit.n_iter.max()))
            shapes = []
            for key, calls in counts.items():
                eng, vec = samples[key]
                ms = cs.device_ms(lambda: originals[type(eng)](eng, vec),
                                  calls=2, reps=2)
                shapes.append(dict(engine=key[0], shape=list(key[1]),
                                   calls=calls, device_ms=ms))
            total = sum(r["calls"] * r["device_ms"] for r in shapes)
            emit(measure="gram_fit", case=case, n_iter=iters,
                 fit_s_warm=fit_s, matvecs=shapes, matvec_device_ms=total,
                 matvec_share=total / (fit_s * 1e3))
            samples.clear()
    finally:
        for cls, orig in originals.items():
            cls.matvec = orig


# --gram-sweep: copies of csrc/rbf_gram.cu cut by a regex, diagnostics
# that are never shipped (each cut must match the source exactly once)
GRAM_CUTS = {
    "shipped": [],
    # the matvec's epilogue without the exponential (the dot times v)
    "no_exp": [(r"p\.rbf \? ex2\(fminf\(fmaf\(2\.f \* gl, dot,\s*"
                r"__fadd_rn\(ra\[i\]\[h\], s2\[cl\]\)\),\s*0\.f\)\)\s*: dot",
                "dot")],
    # no MMAs: the accumulators stay 0
    "no_mma": [(r"mma_chunk<T>\(sa", "if (false) mma_chunk<T>(sa")],
    # the column tiles are never copied (the rows still are)
    "no_column_copies": [(r"copy_rows\(sb \+ st \* b_words",
                          "if (false) copy_rows(sb + st * b_words"),
                         (r"max\(0, min\(GT_COLS, m - j \* GT_COLS\)\) \* bb",
                          "0")],
    # the float32 matvec's wgmma route: no high/low split of the stages,
    # no wgmmas, one wgmma product a step instead of three
    "wg_no_split": [(r"for \(int q = q0; q < 2 \* nks; q \+= 2\) \{",
                     "for (int q = q0; q < 0; q += 2) {")],
    "wg_no_wgmma": [(r"wgmma_tf32\(acc, al\[ks\], dh, ks > 0\);", ""),
                    (r"wgmma_tf32\(acc, ah\[ks\], dl, 1\);", ""),
                    (r"wgmma_tf32\(acc, ah\[ks\], dh, 1\);", "")],
    "wg_one_product": [(r"wgmma_tf32\(acc, al\[ks\], dh, ks > 0\);", ""),
                       (r"wgmma_tf32\(acc, ah\[ks\], dl, 1\);", "")],
    # fp32: one TF32 product a step instead of three
    "one_tf32_product": [(r"mma_tf32\(c, al\[i\], bh\);", ""),
                         (r"mma_tf32\(c, ah\[i\], bl\);", "")],
}


def gram_cuts(cs, _build, G, engines, v, gamma, emit):
    """The binary matvec (both dtypes) and the fp32 block for each build
    of GRAM_CUTS, compiled into a temporary directory under _build/."""
    import torch
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        for name, subs in GRAM_CUTS.items():
            lib = variant_lib(_build, tmp, "rbf_gram.cu", f"gram_{name}",
                              subs, "svm_rbf_gram_matvec")
            fn = lib.svm_rbf_gram_block
            fn.argtypes = _build.SIGNATURES["svm_rbf_gram_block"]
            fn.restype = ctypes.c_int
            row = {}
            for dtype, eng in engines.items():
                n, d = eng._xk.shape
                plan = G.gram_plan(n, n, d, eng._xk.dtype, entry="matvec")
                out = torch.empty(n, device=eng._xk.device)

                def mv():
                    return G.launch_matvec(lib, eng._xs, eng._x2, v, out,
                                           gamma=gamma, mode="rbf",
                                           plan=plan)

                assert mv() == 0
                row[f"matvec_{dtype}_device_ms"] = cs.device_ms(mv, calls=10)
            eng = engines["fp32"]
            n, d = eng._xk.shape
            bplan = G.gram_plan(2048, n, d)
            kblk = torch.empty((2048, n), device=eng._xk.device)

            def bk():
                return G.launch_block(lib, eng._xs[:2048], eng._xs,
                                      eng._x2[:2048], eng._x2, kblk,
                                      gamma=gamma, mode="rbf", plan=bplan)

            assert bk() == 0
            row["block_fp32_device_ms"] = cs.device_ms(bk, calls=20)
            emit(measure="gram_cut", build=name, **row)


def variant_lib(_build, tmp, source, name, subs, export):
    """A copy of csrc/ (``source`` and the headers it includes) with each
    (regex, replacement[, count]) of ``subs`` made ``count`` times (1 by
    default, "all": at least once) in ``source``, or where it does not
    match there, in
    ``mma.cuh``; ``source`` built alone into ``tmp`` and loaded;
    ``export`` gets the shipped library's signature."""
    import re
    import shutil
    csrc = os.path.join(os.path.dirname(_build.__file__), "csrc")
    copy = os.path.join(tmp, f"{name}_csrc")
    shutil.copytree(csrc, copy)
    for pat, new, *count in subs:
        want = count[0] if count else 1
        for fname in (source, "mma.cuh"):
            path = os.path.join(copy, fname)
            with open(path) as f:
                text, k = re.subn(pat, new, f.read())
            if k:
                break
        assert k == want or (want == "all" and k > 0), (name, pat, k)
        with open(path, "w") as f:
            f.write(text)
    so = os.path.join(tmp, f"{name}.so")
    subprocess.run([_build._nvcc(), *_build.FLAGS, "-I", copy, "-shared",
                    os.path.join(copy, source), "-o", so], check=True)
    lib = ctypes.CDLL(so)
    fn = getattr(lib, export)
    fn.argtypes = _build.SIGNATURES[export]
    fn.restype = ctypes.c_int
    return lib


def row_sweep(cs, _build, eng, i, turn, emit, tmp):
    """The cached row call (hit, miss) at the binary shape for builds of
    copies of csrc/rbf_gram.cu cut by a regex (see the docstring)."""
    from repro_torch.kernels import rbf_gram as G
    cuts = {
        "shipped": [],
        "no_ticket": [(r"take_ticket\(c\.ticket\) == gridDim\.x \* "
                       r"gridDim\.y - 1", "false")],
        "no_slot_store": [(r"if \(CACHED\) c\.rows\[slot \* n \+ r\] "
                           r"= v;", "")],
    }
    cuts["no_ticket_no_slot_store"] = (cuts["no_ticket"]
                                       + cuts["no_slot_store"])
    cuts["four_row_warps"] = [(r"MAX_ROW_WARPS = 8;", "MAX_ROW_WARPS = 4;")]
    for name, subs in cuts.items():
        lib = variant_lib(_build, tmp, "rbf_gram.cu", f"row_{name}", subs,
                          "svm_rbf_gram_row_cached")
        caches = {"hit": eng.init_cache(), "miss": eng.init_cache()}
        eng.row(i, caches["hit"])   # the shipped kernel fills the slot
        pos = [0]

        def call(which):
            c = caches[which]
            if which == "miss":
                pos[0] += 1
            row = i if which == "hit" else turn[pos[0] % len(turn)]
            out = eng._x2.new_empty(eng._x2.shape)
            return G.launch_row_cached(
                lib, eng._xk, eng._x2, row, out, c.keys, c.stamp,
                c.rows, c.clock, c.hits, c.misses,
                gamma=eng.kernel.gamma, mode="rbf")

        for which in ("hit", "miss"):
            assert call(which) == 0
            emit(measure="smo_sweep", build=name, case=f"row_cached_"
                 f"{which}", device_ms=cs.device_ms(lambda: call(which),
                                                    calls=50))


def dcd_times(args, cs, data, serve, ops, dev, emit):
    """The ``--dcd`` lines (see the module's docstring)."""
    import numpy as np
    import torch
    from repro_torch.core import multiclass as MC
    from repro_torch.kernels import dcd as DCD
    packs = {k: serve.load(os.path.join(args.packs, f))
             for k, f in DCD_PACKS.items()}
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)

    def features(fmap, x):
        om = torch.from_numpy(fmap.a).to(dev)
        ph = torch.from_numpy(fmap.b).to(dev)
        xt = torch.from_numpy(np.ascontiguousarray(x)).to(dev)
        return ops.rff_features(xt, om, ph,
                                scale=float(np.sqrt(2.0 / om.shape[1])))

    def signs(y, positive):
        return torch.from_numpy(np.where(y == positive, 1.0, -1.0)
                                .astype(np.float32)).to(dev)

    def cold(phi, yy):
        n = phi.shape[0]
        zero = torch.zeros(n, device=dev)
        return cs.dcd_state(phi, yy, -torch.ones(n, device=dev), zero,
                            torch.randperm(n, generator=gen, device=dev))

    # the binary low-rank fit's shape
    xtr, ytr, _, _ = cs.binary_split(data)
    phi = features(packs["lowrank"].feature_map, xtr)
    st = cold(phi, signs(ytr, ytr.max()))
    n, k = phi.shape

    def epoch():
        return ops.dcd_epoch(**st, bias=1.0)

    for _ in range(WARM_EPOCHS):
        epoch()
    ms = cs.device_ms(epoch, calls=5)
    plan = DCD.dcd_plan(k)._asdict() if hasattr(DCD, "dcd_plan") else None
    emit(measure="dcd", case="svc", shape=[n, k], plan=plan,
         warm_epochs=WARM_EPOCHS, device_ms=ms, ns_per_coord=ms * 1e6 / n)
    if args.dcd_sweep and plan is not None:
        dcd_sweep(cs, DCD, st, n, k, emit)

    # the OvO low-rank fit's task epoch
    xtr_m, ytr_m, _, _ = cs.pavia_split(data, cs.PAVIA_NOISE["overlapping"])
    phi_m = features(packs["ovo_lowrank"].feature_map, xtr_m)
    taskset = MC.get_strategy("ovo").build_taskset(xtr_m, ytr_m)
    lone = [cold(phi_m.index_select(0, torch.from_numpy(t.indices).to(dev)),
                 torch.from_numpy(t.y).to(dev)) for t in taskset.tasks]

    def lone_all():
        return [ops.dcd_epoch(**s, bias=1.0) for s in lone]

    for _ in range(WARM_EPOCHS):
        lone_all()
    sizes = [t.size for t in taskset.tasks]
    lone_ms = cs.device_ms(lone_all, calls=2)
    row = dict(measure="dcd", case="ovo_tasks", n_tasks=len(sizes),
               rows_of_phi=int(phi_m.shape[0]), task_sizes=[min(sizes),
                                                            max(sizes)],
               lone_launches_device_ms=lone_ms)
    if hasattr(ops, "dcd_epoch_tasks"):
        batch = {name: torch.cat([s[name] for s in lone]).contiguous()
                 for name in ("y", "p", "lo", "hi", "q_diag", "live",
                              "perm", "beta", "wb")}
        batch["w"] = torch.stack([s["w"] for s in lone]).contiguous()
        batch["rows"] = torch.from_numpy(np.concatenate(
            [t.indices for t in taskset.tasks])).to(dev)
        batch["offsets"] = torch.tensor(np.r_[0, np.cumsum(sizes)],
                                        dtype=torch.int64, device=dev)
        ids = torch.arange(len(sizes), device=dev)

        def tasks_epoch():
            return ops.dcd_epoch_tasks(phi_m, **batch, tasks=ids, bias=1.0)

        for _ in range(WARM_EPOCHS):
            tasks_epoch()
        row["task_axis_device_ms"] = cs.device_ms(tasks_epoch, calls=5)
    emit(**row)


def dcd_sweep(cs, DCD, st, n, k, emit):
    """Every window and a few depths at the binary shape, and the build
    that never copies rows."""
    import ctypes
    import re
    import subprocess
    import tempfile
    import torch
    from repro_torch.kernels import _build
    viol = torch.empty((1,), device=st["phi"].device)
    args = [st[name] for name in ("phi", "y", "p", "lo", "hi", "q_diag",
                                  "live", "perm", "beta", "w", "wb")]

    def timed(lib, plan):
        def run():
            return DCD.launch(lib, *args, viol, bias=1.0, plan=plan)
        code = run()
        assert code == 0, code
        return cs.device_ms(run, calls=5)

    lib = _build.library()
    plans = [DCD.dcd_plan(k, window=w) for w in DCD.WINDOWS]
    plans += [DCD.dcd_plan(k, depth=d) for d in (16, 32)]
    for plan in plans:
        ms = timed(lib, plan)
        emit(measure="dcd_sweep", shape=[n, k], plan=plan._asdict(),
             device_ms=ms, ns_per_coord=ms * 1e6 / n)
    with open(os.path.join(os.path.dirname(DCD.__file__), "csrc",
                           "dcd_epoch.cu")) as f:
        text = f.read()
    # the producer's row copies (TMA or cp.async), cut from a copy of the
    # source: the stage's full barrier then waits on the producer alone
    copies = re.compile(r"\n( +)if \(a\.tma\) \{\n.*?"
                        r"cp_async_arrive\(&full\[st\]\);\n +\}\n", re.S)
    text, cut = copies.subn(r"\n\1(void)dst;\n\1(void)src;\n", text)
    assert cut == 1, cut
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        src = os.path.join(tmp, "dcd_no_rows.cu")
        so = os.path.join(tmp, "dcd_no_rows.so")
        with open(src, "w") as f:
            f.write(text)
        subprocess.run([_build._nvcc(), *_build.FLAGS, "-shared", src, "-o",
                        so], check=True)
        diag = ctypes.CDLL(so)
        diag.svm_dcd_epoch.argtypes = _build.SIGNATURES["svm_dcd_epoch"]
        diag.svm_dcd_epoch.restype = ctypes.c_int
        plan = DCD.dcd_plan(k)
        ms = timed(diag, plan)
    emit(measure="dcd_no_rows", shape=[n, k], plan=plan._asdict(),
         device_ms=ms, ns_per_coord=ms * 1e6 / n)


def lm_times(cs, _build, ops, dev, emit, sweep=False):
    """The ``--lm`` lines (see the module's docstring)."""
    import torch
    attn, ragged, ssd = cs.lm_inputs(dev)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for case, args, causal in (("phi4_causal", attn, True),
                               ("ragged_300_noncausal", ragged, False)):
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = (t.to(dt) for t in args)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            emit(measure="lm", kernel="flash_attention", case=case,
                 dtype=str(dt).split(".")[1], shape=list(q.shape),
                 kv_heads=int(k.shape[2]), causal=causal,
                 device_ms=cs.device_ms(
                     lambda: ops.flash_attention(q, k, v, causal=causal)),
                 library_device_ms=cs.device_ms(
                     lambda: sdpa(qt, kt, vt, is_causal=causal,
                                  enable_gqa=True)))
    emit(measure="lm", kernel="ssd_diag", shape=list(ssd[2].shape),
         n_state=int(ssd[0].shape[2]),
         device_ms=cs.device_ms(lambda: ops.ssd_diag(*ssd), calls=20))
    if hasattr(ops, "flash_attention_bwd"):
        lm_bwd_times(cs, ops, dev, emit)
    if sweep:
        lm_sweep(cs, _build, dev, attn, ssd, emit)
        lm_bwd_sweep(cs, _build, dev, emit)


# the backward kernels' shapes: zamba2_1p2b's train step (2 x 2,048
# tokens: 32 / 32 heads of 64, and chunks of 256 of 64 SSD heads, N 64,
# P 64) and phi4_mini_3p8b's attention (1 x 4,096, 24 / 8 heads of 128)
BWD_ATTN = {"zamba2": ((2, 2048, 32, 32, 64), ("bfloat16",)),
            "phi4": ((1, 4096, 24, 8, 128), ("float32", "bfloat16"))}
BWD_SSD = {"zamba2": (16, 64, 256, 64, 64)}


def bwd_inputs(cs, dev):
    """Seeded inputs of the backward kernels, the same for any checkout:
    (case, dtype name, shape, (q, k, v, dO)) for every BWD_ATTN case and
    dtype, and (case, shape, (C, B, x, dt, cs), dY) for every BWD_SSD case
    (dt ~ U(1e-3, 0.1), A ~ -U(1, 8), cs the in-chunk cumsum of dt A)."""
    import torch
    g = torch.Generator(device=dev).manual_seed(cs.SEED)
    attn, ssd = [], []
    for case, (shape, dtypes) in BWD_ATTN.items():
        b, s, h, hkv, d = shape
        base = [torch.randn(sh, generator=g, device=dev)
                for sh in ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d),
                           (b, s, h, d))]
        attn += [(case, name, shape,
                  tuple(t.to(getattr(torch, name)) for t in base))
                 for name in dtypes]
    for case, (bc, h, q, n, p) in BWD_SSD.items():
        dt = 0.001 + 0.099 * torch.rand((bc, h, q), generator=g, device=dev)
        a = -(1 + 7 * torch.rand((h,), generator=g, device=dev))
        fwd = (torch.randn((bc, q, n), generator=g, device=dev),
               torch.randn((bc, q, n), generator=g, device=dev),
               torch.randn((bc, h, q, p), generator=g, device=dev), dt,
               torch.cumsum(dt * a[None, :, None], dim=2))
        ssd.append((case, (bc, h, q, n, p), fwd,
                    torch.randn((bc, h, q, p), generator=g, device=dev)))
    return attn, ssd


def lm_bwd_times(cs, ops, dev, emit):
    """``lm_bwd`` lines: ``ops.flash_attention_bwd`` at BWD_ATTN's causal
    shapes beside the autograd backward of scaled_dot_product_attention
    on the same operands, and ``ops.ssd_diag_bwd`` at BWD_SSD's: device
    time (``chip_smoke.device_ms``) on ``bwd_inputs``."""
    import torch
    sdpa = torch.nn.functional.scaled_dot_product_attention
    attn, ssd = bwd_inputs(cs, dev)
    for case, name, shape, (q, k, v, do) in attn:
        o, lse = ops.flash_attention_lse(q, k, v, causal=True)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        out = sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)
        dot = do.transpose(1, 2)
        emit(measure="lm_bwd", kernel="flash_attention_bwd", case=case,
             dtype=name, shape=list(shape), causal=True,
             device_ms=cs.device_ms(
                 lambda: ops.flash_attention_bwd(q, k, v, o, lse, do,
                                                 causal=True)),
             library_device_ms=cs.device_ms(
                 lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                             retain_graph=True)))
        del out, qt, kt, vt, o, lse
    for case, shape, fwd, dy in ssd:
        emit(measure="lm_bwd", kernel="ssd_diag_bwd", case=case,
             shape=list(shape),
             device_ms=cs.device_ms(lambda: ops.ssd_diag_bwd(*fwd, dy),
                                    calls=20))


def lm_train_times(cs, dev, emit, timed):
    """The ``--lm-train`` line (see the module's docstring)."""
    import statistics
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.optim.adamw import AdamW
    from repro_torch.training.train import make_train_step
    from torch.profiler import ProfilerActivity, profile
    t = cs.LM_TRAIN
    cfg = get_config(t["config"])
    b, s, warm = t["batch"], t["seq"], t["warm"]
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(cs.SEED))
    opt = AdamW(lr=t["lr"])
    state = opt.init(params)
    step = make_train_step(model, opt)
    batches = cs.train_batches(cfg, b, s, warm + timed + 1, dev)
    wall, host, losses = [], [], []
    for i in range(warm + timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, metrics = step(params, state, batches[i])
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        if i >= warm:
            wall.append((time.perf_counter() - t0) * 1e3)
            host.append((t1 - t0) * 1e3)
        losses.append(float(metrics["loss"]))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        params, state, metrics = step(params, state, batches[-1])
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]

    def dev_ms(name=""):
        return sum(e.self_device_time_total for e in kernels
                   if name in e.key) / 1e3

    device = dev_ms()
    bwd = {"flash_attention_bwd": dev_ms("flash_bwd_"),
           "ssd_diag_bwd": dev_ms("ssd_bwd_")}
    step_ms = statistics.median(wall)
    emit(measure="lm_train", config=cfg.name, batch=b, seq=s, warm=warm,
         step_ms=step_ms, step_ms_all=wall,
         host_ms=statistics.median(host), host_ms_all=host,
         tokens_per_s=b * s / step_ms * 1e3, losses=losses,
         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
         device_ms=device, device_kernels=sum(e.count for e in kernels),
         backward_kernels_ms=bwd, rest_device_ms=device - sum(bwd.values()),
         idle_share=1 - device / step_ms)


# --lm-sweep: copies of csrc/flash_attn.cu and csrc/ssd_diag.cu cut by a
# regex, diagnostics that are never shipped (each cut must match as many
# times as it says)
_MMA_NOP = (r"namespace \{\n\nusing namespace svm;\n",
            "namespace {\n\nusing namespace svm;\n"
            "__device__ __forceinline__ void mma_nop(float* c, "
            "const uint32_t* a, const uint32_t* b) {\n"
            "  asm volatile(\"\" : \"+f\"(c[0]) : \"r\"(a[0]), \"r\"(a[1]), "
            "\"r\"(a[2]), \"r\"(a[3]), \"r\"(b[0]), \"r\"(b[1]));\n}\n")
LM_CUTS = {
    "flash_attn.cu": {
        "shipped": [],
        # p = x - m and corr = m - m_new: no ex2
        "no_exp": [(r"const float pv = ex2\(__fsub_rn\(s\[j\]\[e\], "
                    r"m\[e >> 1\]\)\);",
                    "const float pv = __fsub_rn(s[j][e], m[e >> 1]);"),
                   (r"corr\[h\] = ex2\(__fsub_rn\(m\[h\], m_new\)\);",
                    "corr[h] = __fsub_rn(m[h], m_new);")],
        # every mma.sync replaced by an empty asm that keeps its operands
        "no_mma": [_MMA_NOP, (r"mma_tf32\(", "mma_nop(", "all"),
                   (r"mma_bf16\(", "mma_nop(", "all")],
        # the K / V tiles are never copied (Q still is)
        "no_copies": [(r"mbar_arrive_expect_tx\(full \+ st, 2 \* KV \* 4\)",
                       "mbar_arrive_expect_tx(full + st, 0)"),
                      (r"for \(int c = 0; c < NB; \+\+c\) \{\n(\s+)"
                       r"tma_tile\(kt", r"for (int c = 0; c < 0; ++c) {\n"
                       r"\1tma_tile(kt")],
        # fp32: one TF32 product a step (both products); bf16: P V
        # without P's low part
        "one_product": [(r"mma_tf32\(c, al, bh \+ 2 \* h\);", "", 2),
                        (r"mma_tf32\(c, ah, bl \+ 2 \* h\);", "", 2),
                        (r"mma_bf16\(o\[2 \* jp\], pl, bf\);", ""),
                        (r"mma_bf16\(o\[2 \* jp \+ 1\], pl, bf \+ 2\);",
                         "")],
    },
    "ssd_diag.cu": {
        "shipped": [],
        "no_exp": [(r"ex2\(__fmul_rn\(\s*__fsub_rn\(csq\[hh\], ck\.x\), "
                    r"LOG2E\)\)", "__fsub_rn(csq[hh], ck.x)"),
                   (r"ex2\(__fmul_rn\(\s*__fsub_rn\(csq\[hh\], ck\.y\), "
                    r"LOG2E\)\)", "__fsub_rn(csq[hh], ck.y)")],
        "no_mma": [_MMA_NOP, (r"mma_tf32\(", "mma_nop(", "all")],
        # the score phase's MMAs only
        "no_score_mma": [(r"float\* cc = acc\[2 \* jp \+ hh\];\n"
                          r"(\s+)mma_tf32\(cc, al, bh \+ 2 \* hh\);\n"
                          r"\s+mma_tf32\(cc, ah, bl \+ 2 \* hh\);\n"
                          r"\s+mma_tf32\(cc, ah, bh \+ 2 \* hh\);",
                          r"float* cc = acc[2 * jp + hh];\n\1(void)cc;")],
        # no copies into the ring (B, x, cs, dt; C still is copied)
        "no_copies": [(r"if \(a\.tma\) mbar_arrive_expect_tx\(full \+ st, "
                       r"bytes\);", "if (a.tma) mbar_arrive_expect_tx("
                       "full + st, 0);"),
                      (r"tma_tile\(s \+ bx \* SD_BOX", "if (false) tma_tile("
                       "s + bx * SD_BOX"),
                      (r"tma_tile\(xs \+ bx \* SD_BOX", "if (false) tma_tile("
                       "xs + bx * SD_BOX"),
                      (r"if \(lane == 0\) tma_copy\(s, g, 4 \* n, bar\);",
                       "")],
        "one_product": [(r"mma_tf32\(cc, al, bh \+ 2 \* hh\);", ""),
                        (r"mma_tf32\(cc, ah, bl \+ 2 \* hh\);", ""),
                        (r"mma_tf32\(cc, wl\[j\], bh \+ 2 \* hh\);", ""),
                        (r"mma_tf32\(cc, wh\[j\], bl \+ 2 \* hh\);", "")],
    },
}


# copies of csrc/flash_attn_bwd.cu and csrc/ssd_diag_bwd.cu cut by a
# regex, diagnostics that are never shipped: every MMA an empty asm that
# keeps its operands, no exponential, no tile copies (the tiles hold what
# shared memory held), and for the bf16 attention route one pass of P and
# dS (their bf16 low parts dropped)
_BWD_NOP = (r"namespace \{\n\nusing namespace svm;\n",
            "namespace {\n\nusing namespace svm;\n"
            "__device__ __forceinline__ void mma_nop(float* c, "
            "const uint32_t* a, const uint32_t* b) {\n"
            "  asm volatile(\"\" : \"+f\"(c[0]) : \"r\"(a[0]), \"r\"(a[1]), "
            "\"r\"(a[2]), \"r\"(a[3]), \"r\"(b[0]), \"r\"(b[1]));\n}\n"
            "__device__ __forceinline__ void mma3_nop(float* c, float* l, "
            "const uint32_t* ah, const uint32_t* al, const uint32_t* bh, "
            "const uint32_t* bl) {\n"
            "  asm volatile(\"\" : \"+f\"(c[0]) : \"f\"(l[0]), \"r\"(ah[0]), "
            "\"r\"(al[1]), \"r\"(bh[0]), \"r\"(bl[1]));\n}\n"
            "__device__ __forceinline__ void mma3_nop(float* c, "
            "const uint32_t* ah, const uint32_t* al, const uint32_t* bh, "
            "const uint32_t* bl) {\n"
            "  asm volatile(\"\" : \"+f\"(c[0]) : \"r\"(ah[0]), \"r\"(al[1]), "
            "\"r\"(bh[0]), \"r\"(bl[1]));\n}\n")
LM_BWD_CUTS = {
    "flash_attn_bwd.cu": {
        "shipped": [],
        "no_mma": [_BWD_NOP, (r"mma_bf16\(", "mma_nop(", "all"),
                   (r"mma_3xtf32\(", "mma3_nop(", "all")],
        "one_pass_bf16": [(r"mma_bf16\(acc\[2 \* jp\], xl, y\);", ""),
                          (r"mma_bf16\(acc\[2 \* jp \+ 1\], xl, y \+ 2\);",
                           "")],
        "no_exp": [(r"p = ex2\(", "p = (", 2)],
        "no_copies": [(r"f32tile::cp_async<16>\(s \+ r \* LS \+ 4 \* c, "
                       r"src, valid\);", "(void)src;"),
                      (r"f32tile::cp_async<4>\(s \+ e, valid \? g \+ row0 "
                       r"\+ e : g, valid\);", "(void)valid;")],
    },
    "ssd_diag_bwd.cu": {
        "shipped": [],
        "no_mma": [_BWD_NOP, (r"mma_3xtf32_2\(", "mma3_nop(", "all")],
        "no_exp": [(r"ex2\(__fmul_rn\(__fsub_rn\(csq\[ql\], csk\[kl\]\), "
                    r"LOG2E\)\)", "__fsub_rn(csq[ql], csk[kl])")],
        "no_copies": [(r"f32tile::cp_async<16>\(\n\s+s \+ r \* ls \+ c,",
                       "if (false) f32tile::cp_async<16>(s + r * ls + c,"),
                      (r"f32tile::cp_async<4>\(s \+ e, valid",
                       "if (false) f32tile::cp_async<4>(s + e, valid")],
    },
}


def lm_bwd_sweep(cs, _build, dev, emit):
    """The backward kernels' plan alternatives (the SSD head groups) and
    LM_BWD_CUTS builds on ``bwd_inputs`` (``lm_bwd_sweep`` /
    ``lm_bwd_cut`` lines)."""
    import torch
    from repro_torch.kernels import flash_attn as FA
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_diag as SD
    attn, ssd = bwd_inputs(cs, dev)
    args = {}
    for case, name, shape, (q, k, v, do) in attn:
        o, lse = ops.flash_attention_lse(q, k, v, causal=True)
        args[case, name] = (q, k, v, o, lse, do,
                            *(torch.empty_like(t) for t in (q, k, v)),
                            torch.empty((shape[0], shape[2], shape[1]),
                                        device=dev))

    def flash_ms(lib, key, plan):
        def run():
            return FA.launch_bwd(lib, *args[key], causal=True, plan=plan)
        assert run() == 0
        return cs.device_ms(run)

    def plan_of(shape, name):
        b, s, h, hkv, d = shape
        return FA.bwd_plan(b, s, s, h, hkv, d, getattr(torch, name))

    def ssd_ms(lib, shape, fwd, dy, plan):
        out = [torch.empty_like(t) for t in fwd]
        part = torch.empty((plan.groups, shape[0], plan.pairs,
                            SD.BWD_TILE ** 2), device=dev)

        def run():
            return SD.launch_bwd(lib, *fwd, dy, part, *out, plan=plan)
        assert run() == 0
        return cs.device_ms(run, calls=20)

    lib = _build.library()
    for case, shape, fwd, dy in ssd:
        for group in (2, 4, 6, 8, 16):
            try:
                plan = SD.bwd_plan(*shape, group=group)
            except ValueError:
                continue
            emit(measure="lm_bwd_sweep", kernel="ssd_diag_bwd", case=case,
                 plan=plan._asdict(),
                 device_ms=ssd_ms(lib, shape, fwd, dy, plan))
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        for source, cuts in LM_BWD_CUTS.items():
            export = ("svm_flash_attention_bwd" if source.startswith("flash")
                      else "svm_ssd_diag_bwd")
            for name, subs in cuts.items():
                lib = variant_lib(_build, tmp, source,
                                  f"{source[:-3]}_{name}", subs, export)
                if source.startswith("flash"):
                    row = {f"{case}_{dt}_device_ms": flash_ms(
                        lib, (case, dt), plan_of(shape, dt))
                        for case, dt, shape, _ in attn}
                else:
                    row = {f"{case}_device_ms": ssd_ms(
                        lib, shape, fwd, dy, SD.bwd_plan(*shape))
                        for case, shape, fwd, dy in ssd}
                emit(measure="lm_bwd_cut", kernel=source[:-3], build=name,
                     **row)


def lm_sweep(cs, _build, dev, attn, ssd, emit):
    """Plan alternatives and LM_CUTS builds at the model shapes (see the
    module's docstring)."""
    import torch
    from repro_torch.kernels import flash_attn as FA
    from repro_torch.kernels import ssd_diag as SD
    flash = {dt: tuple(t.to(dt) for t in attn)
             for dt in (torch.float32, torch.bfloat16)}
    outs = {dt: torch.empty(qkv[0].shape, dtype=dt, device=dev)
            for dt, qkv in flash.items()}
    y = torch.empty(ssd[2].shape, device=dev)
    b, s, h, d = attn[0].shape
    bc, hs, qs, ps = ssd[2].shape
    n = ssd[0].shape[2]

    def flash_ms(lib, dt, plan):
        def run():
            return FA.launch(lib, *flash[dt], outs[dt], causal=True,
                             plan=plan)
        assert run() == 0
        return cs.device_ms(run)

    def ssd_ms(lib, plan):
        def run():
            return SD.launch(lib, *ssd, y, plan=plan)
        assert run() == 0
        return cs.device_ms(run, calls=20)

    lib = _build.library()
    for dt in flash:
        for rows in FA.ROWS:
            plan = FA.flash_plan(b, s, h, d, dt, rows=rows)
            emit(measure="lm_sweep", kernel="flash_attention",
                 dtype=str(dt).split(".")[1], plan=plan._asdict(),
                 device_ms=flash_ms(lib, dt, plan))
    plans = [SD.ssd_plan(bc, hs, qs, n, ps, group=group)
             for group in (2, 4, 6, 8, 12, 16, 24, 48)]
    plans += [SD.ssd_plan(bc, hs, qs, n, ps)._replace(
        stages=stages, smem_bytes=SD.smem_bytes(n, stages))
        for stages in SD.STAGES if SD.smem_bytes(n, stages) <= SD.SMEM_LIMIT]
    for plan in plans:
        emit(measure="lm_sweep", kernel="ssd_diag", plan=plan._asdict(),
             device_ms=ssd_ms(lib, plan))
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        for source, cuts in LM_CUTS.items():
            for name, subs in cuts.items():
                export = ("svm_flash_attention" if source == "flash_attn.cu"
                          else "svm_ssd_diag")
                lib = variant_lib(_build, tmp, source,
                                  f"{source[:-3]}_{name}", subs, export)
                if source == "flash_attn.cu":
                    row = {str(dt).split(".")[1] + "_device_ms": flash_ms(
                        lib, dt, FA.flash_plan(b, s, h, d, dt))
                        for dt in flash}
                else:
                    row = {"device_ms": ssd_ms(lib, SD.ssd_plan(bc, hs, qs,
                                                                n, ps))}
                emit(measure="lm_cut", kernel=source[:-3], build=name,
                     **row)


if __name__ == "__main__":
    sys.exit(main())
