"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``
with nvcc (into ``src/repro_torch/kernels/_build/``, at first use),
then:

1. holds every kernel against its plain PyTorch version on the card,
   in float32 and bfloat16, at the shapes the main path gives it
   (``dcd_epoch`` over the whole of each low-rank fit's Phi, the
   SVR's doubled one included, and once with a visiting order whose
   indices repeat within a window, across windows and past the ring's
   depth; the task axis of ``dcd_epoch`` over every task of each
   multiclass low-rank fit, equal bit for bit to one-task launches;
   the cached row entry over 200 LRU lookups at 29,491 x 102, its cache
   state equal to the plain lookup's bit for bit and its rows equal to
   the uncached and task-axis entries' bits; the Gram matvec, which
   never writes K, against a float64 sum at 29,491 x 102 and with the
   task axis at the OvO and OvR buckets, each bucket task equal bit for
   bit to its lone call);
2. drives the main path through the entry points a user calls: a binary
   RBF ``SVC(engine="pallas")`` fit by SMO on a Pavia-shaped problem
   (~29.5k x 102), certified by a float64 KKT check of a recomputed
   gradient (the Gram matvec, one launch); then a linear-kernel SVC on
   the same split, its held-out margins computed from the dual over
   every training row (the Gram block entry at 2,048 x 29,491);
3. packs, saves, loads and serves it with ``Predictor(engine="pallas")``
   in requests of several sizes, labels checked against the plain
   chunked predictor on the same card, and rows served alone checked
   bit for bit against the same rows in one 1,024-row request;
4. drives the low-rank tier on the same split: ``SVC(engine="rff",
   rank=1024)`` fit by dual coordinate descent (``rff_features`` and
   ``dcd_epoch`` kernels), certified by a float64 KKT check of the
   augmented-bias dual, then packed (schema v2), saved, loaded and
   served, labels checked against the map's plain transform and ``w``;
5. drives epsilon-SVR, exact (``engine="pallas"``, SMO over the doubled
   problem) and low-rank (``engine="rff"``), on a 16,384-row sinc
   regression problem, each certified, packed, saved, loaded and served;
   the exact fit once more in its default configuration (no shrinking),
   whose certificate is required too (the unshrunk solver certifies a
   recomputed gradient before it stops);
6. drives multiclass C-SVC at the size of Pavia University (9 classes,
   102 bands, 36,864 samples, split 90/10), with separable and with
   overlapping classes: ``SVC(strategy="ovo" | "ovr",
   engine="pallas")`` — one batched SMO per schedule bucket on the
   task-axis row and selection kernels — each task certified by a
   float64 KKT check, two OvO tasks solved again alone (T = 1 launches)
   and compared bit for bit, then packed, saved, loaded and served
   (``multitask_decision`` over T > 1 banks, each bank also held against
   its plain version), labels checked against the per-task engine path
   and rows served alone against the same rows in one request;
   then, on the overlapping classes, ``SVC(strategy="ovo" | "ovr",
   engine="rff", rank=1024)`` over one shared feature map, all tasks in
   one batched DCD solve (one task-axis ``dcd_epoch`` launch an epoch),
   certified per task, within 0.01 of the exact accuracy, served
   through a schema-v2 pack;
7. drives the LM-substrate kernels through ``ops.flash_attention`` at
   phi4_mini_3p8b's attention (B = 1, S = 4,096, 24 heads over 8 kv
   heads, D = 128, causal; float32 and bfloat16 operands) and a ragged
   non-causal S = 300 case, and ``ops.ssd_diag`` at mamba2_780m's chunk
   (Q = 256, N = 128, P = 64, 48 heads, 16 chunks), each against its
   plain version (``ssd_diag`` also with decays 40 times as steep, where
   exp above the diagonal would overflow); and the gradient at phi4's
   shape through the autograd Function (float32 and bfloat16), its
   ``flash_attention_bwd`` against the plain backward;
8. holds the task-axis row and selection kernels against their plain
   versions at the OvO and OvR bucket shapes (ragged widths masked), and
   ``multitask_decision`` at the largest OvO and OvR serving banks;
9. times each kernel, its plain version and one PyTorch library call for
   the same function, beside the least time the card could take
   (``bound_ms``): ``ms`` / ``plain_ms`` / ``library_ms`` are CUDA-event
   medians of one call as the caller sees it (host enqueue included),
   ``*device_ms`` the device time of the same call (CUDA events around
   back-to-back calls queued behind a spin kernel, which hides the
   host's enqueue); the task-axis entries on a ``task_axis`` line,
   ``rff_features`` over one serving batch on a ``serving_shapes`` line,
   ``dcd_epoch`` at the SVR's doubled shape and with the task axis at
   the OvO and OvR low-rank shapes on a ``dcd_shapes`` line (each with
   ns a coordinate, its launch plan and ptxas's report). The low-rank
   fit lines carry the warm fit's wall time and the device's busy
   share under the profiler.
   The rows of the Gram block and matvec entries carry the tensor-core
   bound (3xTF32 / bf16 dots, float32 epilogue) as ``bound_ms`` beside
   the CUDA-core one, the bf16 call's device time, the launch plan and
   ptxas's report; no one PyTorch call computes the matvec, so its
   ``library_ms`` is null and a chunked ``exp(-gamma cdist^2) @ v``
   composition is timed under ``library_composition_*`` instead.
   The rows of the two redesigned kernels (``rff_features``,
   ``decision`` / ``multitask_decision``) also carry the launch plan
   (tile, SV-axis splits, feature chunk, shared memory) and what ptxas
   reported for the instantiation they run (registers, spills). The
   rows of the SMO row entries (uncached, cached: a miss, with the hit's
   times beside it) and of ``kkt_select``, here and on the
   ``task_axis`` line, carry the launch floor (an empty kernel's device
   time), an L2 bound (the same bytes at the L2 read rate measured in
   this run) beside the HBM one, and the device kernels a call (one
   each), which the profiler counts at the start of the run (a
   ``kernel_counts`` line, at the binary and the bucket shapes).

10. drives the paper's GD baseline and the cascade: ``gd`` —
   ``SVC(solver="gd", engine="pallas")`` at the reference's lr 0.01 and
   2,000 steps on the exact SVC's split (one Gram matvec launch a
   step, counted), beside the SMO fit, with lr * lambda_max of
   diag(y) K diag(y) (20 power-iteration matvecs) and whether the loss
   descends or oscillates; ``gd_stable`` — the same at lr = 1 /
   lambda_max, its first 200 steps held against the same loop on the
   plain matvec (``engine="chunked"``); ``gd_svr``; ``gd_ovo`` — OvO GD
   on the overlapping split, one task-axis matvec a step, a task against
   its lone solve; ``cascade_svc`` (S = 4; S = 1 against the unsharded
   fit bit for bit), ``cascade_svc_lowrank`` (RFF; a level's nodes
   against their lone ``linear_svc`` solves bit for bit) and
   ``cascade_svr`` (exact and RFF, each at a cut depth), each
   certificate required <= 1e-3.
11. drives the data-parallel SMO (the paper's MPI-CUDA solver) through
   ``SVC`` / ``SVR(mesh=..., shard=...)``, every rank a spawned process
   with a gloo group on the one card (collectives staged through host
   memory, a 60 s timeout each): ``sharded_svc`` (the exact SVC's split
   on 4 ranks, n not divisible by 4: alphas, b and n_iter equal to the
   ``fit`` phase's bit for bit, certified), ``sharded_svc_nccl`` (the
   same on a one-rank NCCL group in this process, bits equal),
   ``sharded_svr`` (the SVR data cut to 512 rows, 4 ranks, unshrunk:
   bits equal to the unsharded ``svr_smo``, certified) and
   ``mesh_multiclass`` (the overlapping OvO fit task-parallel on 4
   workers, every task equal to the fit without a mesh; the separable
   OvR fit data-parallel, labels equal, every task certified); the
   ``row_range`` line holds the row-range entries against the whole
   call's slices bit for bit (fp32 and bf16, several ranges), and the
   ``kernels`` line times them at one rank's block.
12. drives the serving layer (schema v3, ``ModelRegistry``,
   ``ServingService``) over the exact binary SVC's pack and the
   overlapping OvO and OvR packs: ``serve_quantized`` — each pack
   quantized to fp16 and bf16, saved as v3, loaded and served by
   ``Predictor(engine="pallas")`` from its storage dtype (every bank
   resident at that dtype, half the fp32 predictor's ``sv_x`` bytes; the
   kernel's decisions equal to the fp32 kernel's on the upcast bank bit
   for bit; within DECISION_TOL of the chunked predictor; rows alone
   equal to the batch), beside the fp32 pack (memory, max |delta|,
   labels that differ, accuracy, rows/s); ``serving_load`` —
   ``benchmarks/bench_serving_load.py``'s open-loop Poisson replay
   (seeded) against a ``ServingService(window_ms=2.0, max_batch=1024)``
   over a registry of the binary, OvO and OvO-bf16 packs and against a
   one-request-a-call server, at 0.5, 1.5 and 4.0 x the warm OvO
   predictor's batch-1 capacity, then a mixed-size run over the three
   models: p50 / p99 ms, sustained rows/s, rows a batch, flushes, the
   host ms of each decision call and the collector's pauses (the
   longest one's generation and objects collected); every
   response equal to its rows served alone (values bit for bit, labels),
   dynamic >= 1.3 x per-request at 4 x; ``registry`` —
   ``max_resident=2`` over four packs: the LRU order, re-admitted models
   serving their first bits, an eviction returning >= 0.9 x its bank's
   bytes of ``memory_allocated``. The ``kernels`` line times the
   quantized route (fp16 / bf16 bank, float32 rows) at the largest OvO
   and OvR banks beside the fp32 kernel in the same call, and lists
   ``multitask_decision``'s launches by bank dtype.
13. after every path above ran its analytic launch plans: ``tune`` —
   the launch-plan tuner (``kernels.autotune.tune(objective="wall",
   budget=6)``) for ``rbf_gram`` (2,048 x 29,491 x 102), ``kkt_select``
   (29,491), ``decision`` (3,277 x 17 x 102), ``multitask_decision`` (6 x
   1,024 x 986 x 102) and ``rff_features`` (29,491 and 1,024 x 1,024 x
   102): one line each with the default and tuned plans and their device
   ms, every evaluated plan's output equal to the default's bit for bit;
   the results pinned as the cache (``set_cache_path``), the ``ops``
   wrappers launching the tuned plans with the same bits, the default
   path restored; ``compile_guard`` — a warm ``Predictor`` over the
   overlapping OvO pack serves 40 requests of 1..37 rows under
   ``CompileGuard(budget=0)`` with no fresh program, and
   ``multitask_decision`` at raw widths trips a budget of 2. The
   data-parallel phase (11.) also runs ``sharded_svc_poly``: a poly
   SVC on 2,048 rows over the 4 rank processes, bits equal to the
   unsharded fit, certified.
14. serves a language model through the port's LM substrate
   (``repro_torch.models``; phase ``lm_serve``): zamba2_1p2b at its full
   width and depth (38 Mamba2 layers, one shared attention block
   applied 7 times, d_model 2,048, 1.1 B parameters from a seeded
   generator), 4 prompts of 2,048 tokens from ``data.lm.token_batches``
   prefilled, 32 greedy decode steps into caches of 2,080 positions,
   then a teacher-forced ``forward`` over the 2,080 tokens. Each prefill
   and forward launches 7 ``flash_attention`` (bf16, 4 x 2,048 x 32
   heads x 64) and 38 ``ssd_diag`` (32 chunks x 64 heads x 256 x 64 x
   64), a decode step neither; the prefill logits are held against the
   same weights' prefill with the plain versions swapped in for the two
   kernels (and the float64 evaluation's distance beside it), decode
   against teacher forcing, at full depth and at 6 layers; prefill
   tokens/s, ms a decode step, device kernels a step and the two
   kernels' share of the prefill's device time (profiler). The
   ``kernels`` line has both kernels at the operands of the model's
   first attention and SSD calls (``*_zamba2`` rows, SDPA beside
   attention).
15. trains it (phase ``lm_train``): zamba2_1p2b at full width and depth
   from a seeded generator, ``optim.adamw.AdamW(lr=3e-4)`` and
   ``training.train.make_train_step``, 2 warm and 6 timed steps of 2 x
   2,048 tokens (``data.lm.token_batches``, seed 1). Each step launches
   7 ``flash_attention`` and 38 ``ssd_diag`` forward and 7
   ``flash_attention_bwd`` and 38 ``ssd_diag_bwd`` (the wrappers' counts
   and the profiler's); the losses are finite and fall; the backward
   kernels are held against their plain versions at the operands of
   the step's first attention and SSD calls with the dY of the real
   backward (attention in bf16 and float32), two calls equal bit for
   bit; the whole gradient at 6 layers of the full width against the
   plain versions swapped in both ways (``PlainFlash``, ``PlainSsd``),
   a float64 evaluation beside it. The line has step ms, tokens/s, peak
   memory and the profiled step's device time by kernel; the
   ``kernels`` line has ``flash_attention_bwd_zamba2`` (SDPA's autograd
   backward beside it) and ``ssd_diag_bwd_zamba2``, and
   ``flash_attention_bwd`` / ``_bf16`` at phi4's shape, whose gradient
   the LM kernels' phase (item 7) takes through the autograd Function.
16. trains it sharded (phase ``lm_sharded``): the same model, seed,
   batches and optimizer on a 1 x 1 ("data", "model") NCCL
   ``DeviceMesh`` (one rank: one card), every parameter a DTensor placed
   by the sharding rules (``sharding.place``) and the two kernels
   entered through their ``local_map`` regions; 2 warm and 2 timed
   steps. Each step launches what ``lm_train``'s does, and the losses
   equal ``lm_train``'s first four within LM_SHARDED_LOSS_RTOL (bit
   equality reported). Beside it, as a subprocess on the host,
   ``python -m repro_torch.launch.dryrun --arch zamba2_1p2b --shape
   train_4k``: the per-rank estimates of a 16 x 16 fake mesh, whose
   FLOPs x 256 must fall within 1-3x of 6·N·D (line
   ``lm_sharded_dryrun``).
17. prices it (lines ``lm_roofline``, parts a–d): a second subprocess on
   the host (``python3 chip_smoke.py --lm-roofline``), started with the
   dry run, runs the port's roofline tools on zamba2_1p2b: (a)
   ``roofline.differential.probe`` x train_4k on the fake 16 x 16 mesh,
   the full-depth count (``corrected``) beside the reference's two-depth
   extrapolation (``extrapolated``; 7 shared-attention applications
   against 1 + 32 / 6), and their FLOP gap, which must be positive; (b)
   ``roofline.report.analyze``'s three terms on the H100, the dominant
   one and 6·N·D over the counted FLOPs, for that record and for
   ``lm_sharded_dryrun``'s; (c) the same for ``lm_train``'s own step (2
   x 2,048 tokens, no remat, a 1 x 1 mesh) beside the step ms and the
   profiled step's device ms that ``lm_train`` measured in this run; (d)
   ``roofline.inspect_hlo``'s 5 largest collectives of decode_32k at 2
   layers, each with its ``models/`` source line. Estimates of a fake
   mesh, not measurements; a failed subprocess fails the run.
18. traces every (architecture, shape) of the reference's dry run (line
   ``lm_dryrun_all``): a third subprocess on the host (``python3
   chip_smoke.py --lm-dryrun-all``), started with the other two, runs
   ``launch.dryrun.kinds_sweep`` on the fake 16 x 16 mesh: the 10
   architectures at train_4k / prefill_32k / decode_32k and the three
   long-context ones at long_500k, each at the fewest layers that run
   every layer kind of its architecture (``kinds_depth``), on this
   machine's torch. The line has each combo's status, per-rank FLOPs
   and argument bytes; a combo that fails fails the run.

19. holds the exact solver's CUDA graphs against its eager loop (lines
   ``smo_graph``): the exact SVC at full width, the overlapping OvO
   fit's widest bucket (36 tasks) and the exact SVR at 4,096 rows with
   shrinking and unshrunk, each solved with every check block after the
   first replayed from one captured graph and again eagerly
   (``smo.CUDA_GRAPHS`` off), in this process: alpha, b, n_iter,
   n_active, the row caches' hits and misses and the launch counts
   equal, one capture in the graph run, none in the eager one, and both
   runs' seconds. Every other exact fit runs with its graphs: the
   ``fit``, ``svr``, ``svr_default_config``, ``multiclass`` and cascade
   lines carry ``graph`` (captures, seconds issuing and instantiating
   them, replays); the exact ``svr``, ``svr_default_config`` and
   ``multiclass`` lines a ``profile`` of a window of 20 check blocks
   after the capture (busy share, device kernels an iteration;
   ``block_profile``), the ``fit`` line one of its whole warm fit.
20. holds the ``Predictor``'s decide programs as CUDA graphs against the
   same programs run eagerly (line ``serve_graph``): the exact binary
   SVC, SVR, the overlapping OvO and OvR packs, the OvO pack quantized
   to fp16 and bf16, and the RFF binary and OvO packs, each served by a
   predictor whose programs replay a graph a batch bucket and by one
   with ``predictor.CUDA_GRAPHS`` off, both warmed at the 11 buckets of
   the ladder, in this process: decisions bit for bit at a request a
   bucket and one past ``max_batch``, equal launches, one capture a
   bucket and none eager (the requests under a compile budget of 0),
   capture and instantiation ms a bucket, the memory a warmed predictor
   holds beyond an unwarmed one, rows/s and µs a call at 1, 37, 256 and
   1,024 rows in both modes. Every other serving phase (``serve``,
   ``lowrank_serve``, ``svr``, multiclass serving, ``serve_quantized``,
   ``serving_load``, ``registry``, ``compile_guard``) serves through the
   graphs.

Each path is driven with the launch counts set to 0 just before it and
read just after; the ``kernels`` line sums them over the paths.

Each phase prints one JSON line. The line before the last is the
``kernels`` summary, the last ``{"ok": true, "device": ...}``. Any
failed check exits non-zero. Without CUDA it exits non-zero at once.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# published H100 SXM peaks (NVIDIA data sheet; repro_torch.roofline.collect
# has the same, which this module does not import before main: kernel_times
# imports it and then the repro_torch of another checkout): HBM rate and the
# non-tensor-core float32 rate the kernels' IEEE FMAs run at
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# dense tensor-core peaks, the same sheet: the Gram block route's dots
TF32_FLOP_PER_S = 495e12
BF16_FLOP_PER_S = 989e12
# exponentials (MUFU ex2): 16 a clock on each of the 132 SMs at the
# 1,980 MHz boost clock; reported beside the bound, not in it
MUFU_PER_S = 132 * 16 * 1.98e9
SEED = 7
GRAM_TOL = dict(rtol=2e-5, atol=2e-6)      # tests/test_kernels_pallas.py
DECISION_TOL = dict(rtol=2e-4, atol=2e-5)  # tests/test_kernels_pallas.py
# rff_features against its plain version on the same operands (bf16
# operands rounded before both, float32 accumulation in both); the
# bf16 map against the float32 one: atol, tests/test_approx.py
RFF_TOL = 1e-5
RFF_BF16_VS_FP32_TOL = 5e-2
# one dcd_epoch from the same state: the kernel sums each dot product in
# another order than the plain loop (tests/test_torch_cuda.py)
DCD_TOL = dict(rtol=1e-4, atol_rel=1e-4, viol_atol=1e-5)
RANK = 1024
CSRC = "src/repro_torch/kernels/csrc"
# flash_attention / ssd_diag against their plain versions
# (tests/test_kernels_pallas.py); bf16 operands are rounded before both
LM_TOL = dict(rtol=2e-4, atol=2e-5)
# the shapes the LM substrate gives the two kernels (the reference's
# src/repro/configs/phi4_mini_3p8b.py and mamba2_780m.py; one 4,096-token
# sequence each)
PHI4_ATTN = dict(config="phi4_mini_3p8b", b=1, s=4096, h=24, hkv=8, d=128)
MAMBA2_SSD = dict(config="mamba2_780m", bc=16, h=48, q=256, n=128, p=64)
# Pavia University: 42,776 labelled pixels in 9 classes, 102 bands
PAVIA_PER_CLASS = 4096
# the multiclass configurations, by load_pavia_like's band noise: its
# default (every class separable, a few support vectors a task) and one
# at which the classes overlap as Pavia's do (held-out accuracy below 1,
# hundreds of support vectors a task); the low-rank fit runs on the
# second, where its accuracy check can fail
PAVIA_NOISE = {"separable": 0.15, "overlapping": 5.0}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


# every line printed also goes to chiprun_out/chip_smoke.jsonl, so a run
# whose output is cut short keeps all its lines; a phase line carries the
# seconds since the script started
LOG_PATH = os.path.join(HERE, "chiprun_out", "chip_smoke.jsonl")
T_START = time.perf_counter()


def out_line(obj: dict) -> None:
    line = json.dumps(obj)
    print(line, flush=True)
    with open(LOG_PATH, "a") as f:
        f.write(line + "\n")


def emit(**obj) -> None:
    out_line({**obj, "elapsed_s": time.perf_counter() - T_START})


def median_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of one call, CUDA events around each call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# a spin kernel of ~4 ms at the H100's clocks, queued ahead of the timed
# calls: longer than the host takes to enqueue them
SPIN_CYCLES = 8_000_000


def device_ms(fn, calls: int = 10, reps: int = 3) -> float:
    """Device time of one call, without the host's share: CUDA events
    around ``calls`` back-to-back calls, all enqueued behind a spin
    kernel, so their kernels run back to back once it ends (median of
    ``reps``). The profiler's per-kernel sums are not used: late in a
    long run they dropped most launches of the custom kernels."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def launch_floor_ms() -> float:
    """Device time of an empty kernel launched as the port's kernels are
    (ctypes, current stream), back to back: the floor that a kernel of a
    few microseconds is read against."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.tile_f32 import current_stream
    lib = _build.library()
    return device_ms(lambda: lib.svm_empty(current_stream()), calls=50)


def l2_read_rate(dev) -> float:
    """Bytes/s that torch.sum reads from L2, measured here: the slope of
    its device time between a resident 12 MiB and a resident 24 MiB
    float32 tensor (the launch and the reduction's tail cancel)."""
    a = torch.rand(3 << 20, device=dev)
    b = torch.rand(6 << 20, device=dev)
    ta = device_ms(lambda: a.sum(), calls=50)
    tb = device_ms(lambda: b.sum(), calls=50)
    return (b.numel() - a.numel()) * 4 / ((tb - ta) * 1e-3)


def spin_pad() -> None:
    """Short spin kernels (``torch.cuda._sleep``) that take the place of
    the first or last records of a profiled region, which the profiler
    drops late in a long process; ``profiled_lm_kernels`` and
    ``kernels_per_call`` do not count them."""
    for _ in range(5):
        torch.cuda._sleep(100)


def kernels_per_call(fn, calls: int = 20, tries: int = 3) -> float:
    """Device kernels launched per call of ``fn``, counted by
    torch.profiler over ``calls`` calls between short spin kernels
    (``torch.cuda._sleep``, not counted), which take the place of the
    first and last records where the profiler drops them: the most of
    ``tries`` counts (the profiler can drop a kernel's records, never
    add one)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    counts = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
            spin_pad()
            for _ in range(calls):
                fn()
            spin_pad()
            torch.cuda.synchronize()
        counts.append(sum(
            e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and "spin" not in e.key.lower()) / calls)
    return max(counts)


# the multiclass buckets' (T, w) at the overlapping split (PERF.md §4)
BUCKETS = {"ovo": (36, 7430), "ovr": (9, 33178)}


def phase_kernel_counts(ops, K, dev, n: int, d: int) -> dict:
    """Device kernels a call of the SMO row entries, the Gram matvec and
    kkt_select,
    counted by torch.profiler at the start of the run (late in a long
    run the profiler dropped most launches of the custom kernels; see
    device_ms): seeded operands at the binary fit's (n, d) and at the
    multiclass bucket shapes."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    from repro_torch.kernels.rbf_gram import staged
    x = rand(n, d)
    x2 = K.sqnorms(x)
    xs, v = staged(x), rand(n)   # the pallas engine's layout of its rows
    i = torch.tensor(n // 3, device=dev)
    hit, miss = fresh_row_cache(n, dev), fresh_row_cache(n, dev)
    ops.gram_row_cached(x, x2, i, *hit, gamma=0.01)
    turn = [torch.tensor(v, device=dev) for v in range(0, n, n // 64)][:64]
    pos = [0]

    def next_row():
        pos[0] += 1
        return turn[pos[0] % len(turn)]

    def select(shape):
        f, alpha = rand(*shape), rand(*shape)
        y = torch.where(rand(*shape) < 0.5, 1.0, -1.0)
        mask = torch.ones(shape, dtype=torch.bool, device=dev)
        lo, hi = torch.zeros(shape, device=dev), torch.ones(shape, device=dev)
        return lambda: ops.kkt_select(f, alpha, y, mask, lo, hi)

    saved = dict(ops.launches)
    out = {
        "rbf_gram_row": kernels_per_call(
            lambda: ops.gram_row(x, x2, i, gamma=0.01)),
        "rbf_gram_row_cached": kernels_per_call(
            lambda: ops.gram_row_cached(x, x2, next_row(), *miss,
                                        gamma=0.01)),
        "rbf_gram_row_cached_hit": kernels_per_call(
            lambda: ops.gram_row_cached(x, x2, i, *hit, gamma=0.01)),
        "kkt_select": kernels_per_call(select((n,))),
        "rbf_gram_matvec": kernels_per_call(
            lambda: ops.gram_matvec(xs, x2, v, gamma=0.01))}
    del x, xs, x2, v, hit, miss
    for strategy, (tasks, w) in BUCKETS.items():
        xb = rand(tasks, w, d)
        xb2 = K.sqnorms(xb)
        ib = torch.full((tasks,), w // 3, dtype=torch.int64, device=dev)
        out[f"rbf_gram_row_{strategy}"] = kernels_per_call(
            lambda: ops.gram_row(xb, xb2, ib, gamma=0.01))
        out[f"kkt_select_{strategy}"] = kernels_per_call(select((tasks, w)))
        xbs, vb = staged(xb), rand(tasks, w)
        out[f"rbf_gram_matvec_{strategy}"] = kernels_per_call(
            lambda: ops.gram_matvec(xbs, xb2, vb, gamma=0.01))
        del xb, xbs, xb2, vb
    ops.launches.update(saved)
    emit(phase="kernel_counts", kernels_per_call=out,
         shapes={"binary": [n, d], **{k: [*v, d] for k, v in
                                      BUCKETS.items()}})
    check(all(v == 1.0 for v in out.values()),
          f"an SMO row, matvec or selection call is not one kernel: {out}")
    return out


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gram_bounds(n: int, m: int, d: int, dtype: str, n_bytes: float,
                matvec: bool = False) -> dict:
    """Bounds of a Gram block-route call over (n, d) x (m, d). Its dots
    run on the tensor cores: 3 x 2 n m d operations as 3xTF32 (fp32) at
    495 TFLOP/s, or 2 n m d in bf16 at 989; its epilogue, 6 operations a
    pair (8 for the matvec), on the float32 cores at 67. ``bound_ms`` is
    the largest of those and the bytes' time; ``fp32_core_bound_ms`` the
    bound as the CUDA-core route counted it, n m (2d + 6) (+ 2) at 67
    TFLOP/s against the bytes."""
    extra = 2 if matvec else 0
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    tc = (6.0 * n * m * d / TF32_FLOP_PER_S if dtype == "fp32"
          else 2.0 * n * m * d / BF16_FLOP_PER_S) * 1e3
    epilogue = n * m * (6 + extra) / FP32_FLOP_PER_S * 1e3
    t_ops = max(tc, epilogue)
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "tensor_core_ms": tc, "epilogue_ms": epilogue,
            "bytes_ms": t_bytes,
            "fp32_core_bound_ms": max(
                t_bytes, n * m * (2 * d + 6 + extra) / FP32_FLOP_PER_S * 1e3)}


def lm_bounds(n_bytes: float, tc_flops: float, rate: float,
              fp32_ops: float, exps: float,
              route_passes: float | None = None) -> dict:
    """Bounds of an LM-substrate kernel on its tensor-core route:
    ``bound_ms`` the larger of its bytes' time and ``tc_flops`` at the
    tensor cores' ``rate`` (3xTF32: three passes at TF32_FLOP_PER_S; bf16:
    one pass at BF16_FLOP_PER_S, the route's own passes, P split in two
    for P V, in ``route_ms``); ``fp32_core_bound_ms`` the bound as the
    CUDA-core route counted it (``fp32_ops`` at 67 TFLOP/s against the
    bytes); ``exp_ms`` the exponentials at MUFU_PER_S, beside it."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    tc = tc_flops / rate * 1e3
    out = {"bound_ms": max(t_bytes, tc),
           "bound_by": "bytes" if t_bytes >= tc else "operations",
           "tensor_core_ms": tc, "bytes_ms": t_bytes,
           "exp_ms": exps / MUFU_PER_S * 1e3,
           "fp32_core_bound_ms": max(
               t_bytes, fp32_ops / FP32_FLOP_PER_S * 1e3)}
    if route_passes is not None:
        out["route_ms"] = route_passes * tc
    return out


def max_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max())


def redesign_info(kernel: str, shape, bank: str = "fp32") -> dict:
    """The launch plan of a redesigned kernel (``rff_features`` at an
    (n, k, d) shape, ``decision`` at an (nt, T, w, d) one,
    ``flash_attention`` at (b, sq, h, d, dtype), ``ssd_diag`` at
    (bc, h, q, n, p)) on this card, and what ptxas reported for the
    instantiation it runs (float32, or flash_attention's dtype; the
    decision kernel's float32 rows against a ``bank`` of that dtype):
    registers, static shared memory, spills."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import decision as D
    from repro_torch.kernels import feature_map as FM
    from repro_torch.kernels import flash_attn as FA
    from repro_torch.kernels import ssd_diag as SD
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if kernel == "rff_features":
        plan = FM.rff_plan(*shape, sms=sms)
        name = f"rff_features_kernelIfLi{plan.rows // 64}E"
    elif kernel == "flash_attention":   # (b, sq, h, d, dtype)
        plan = FA.flash_plan(*shape, sms=sms)
        elem = "13__nv_bfloat16" if shape[4] == torch.bfloat16 else "f"
        name = f"flash_kernelI{elem}Li{plan.d_tiles}E"
    elif kernel == "ssd_diag":          # (bc, h, q, n, p)
        plan = SD.ssd_plan(*shape, sms=sms)
        name = "ssd_diag_kernel"
    else:   # the float32-rows instantiation at the bank's dtype
        plan = D.decision_plan(*shape, sms=sms, bank=QUANT_DTYPES.get(
            bank, torch.float32))
        elem = {"fp32": "f", "fp16": "6__half", "bf16": "13__nv_bfloat16"}
        name = f"decision_kernelIf{elem[bank]}Li{plan.rows // 16}E"
    found = _build.ptxas_report(name)
    check(len(found) == 1, f"ptxas log: {len(found)} kernels named {name}")
    return {"plan": plan._asdict(), "ptxas": found[0]}


# ------------------------------------------------------------- phases
def phase_parity(ops, K, G, KS, D, dev, n_train: int, d: int, n_sv: int,
                 n_test: int) -> dict:
    """Each kernel against its plain version at main-path shapes."""
    rng = np.random.default_rng(SEED)

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    errs = {}
    x = t(rng.normal(size=(n_train, d)))
    for dt in ("fp32", "bf16"):
        tdt = ops.tile_dtype(dt)
        xk = x.to(tdt)
        x2 = K.sqnorms(xk)
        blk, blk2 = xk[:2048], x2[:2048]   # one matvec chunk of the engine
        for mode in ("rbf", "linear"):
            got = ops.rbf_gram(blk, xk, gamma=0.01, mode=mode, a2=blk2, b2=x2)
            want = G.rbf_gram_plain(blk, xk, blk2, x2, gamma=0.01, mode=mode)
            tol = GRAM_TOL if mode == "rbf" else dict(rtol=2e-5, atol=1e-4)
            ok = torch.allclose(got, want, **tol)
            emit(phase="parity", kernel="rbf_gram", mode=mode, dtype=dt,
                 shape=[2048, n_train, d], max_abs_err=max_err(got, want),
                 bound=tol, ok=ok)
            check(ok, f"rbf_gram {mode} {dt} disagrees with its plain version")
            if mode == "rbf" and dt == "fp32":
                errs["rbf_gram"] = max_err(got, want)
        i = torch.tensor(n_train // 3, device=dev)
        got = ops.gram_row(xk, x2, i, gamma=0.01)
        want = G.gram_row_plain(xk, x2, i, gamma=0.01)
        ok = torch.allclose(got, want, **GRAM_TOL)
        emit(phase="parity", kernel="rbf_gram_row", dtype=dt,
             shape=[n_train, d], max_abs_err=max_err(got, want),
             bound=GRAM_TOL, ok=ok)
        check(ok, f"rbf_gram_row {dt} disagrees with its plain version")
        err = row_cache_parity(ops, G, K, xk, x2, dt)
        if dt == "fp32":
            errs["rbf_gram_row"] = max_err(got, want)
            errs["rbf_gram_row_cached"] = err

    # kkt_select: random state, a tie across blocks, an all-masked input
    n = n_train
    f = t(rng.normal(size=n))
    alpha = rng.uniform(0, 1, n)
    alpha[rng.random(n) < 0.4] = 0.0
    alpha[rng.random(n) < 0.2] = 1.0
    alpha = t(alpha)
    y = t(np.where(rng.random(n) < 0.5, 1.0, -1.0))
    mask = t(rng.random(n) < 0.9, torch.bool)
    lo, hi = torch.zeros(n, device=dev), torch.ones(n, device=dev)
    tie = torch.zeros(n, device=dev)
    tie[[n - 5, n // 3, n // 7, n // 2]] = -2.0
    cases = {"random": (f, alpha, y, mask, lo, hi),
             "tie": (tie, torch.full((n,), 0.5, device=dev),
                     torch.ones(n, device=dev), torch.ones_like(mask), lo, hi),
             "all_masked": (f, alpha, y, torch.zeros_like(mask), lo, hi)}
    for name, args in cases.items():
        got = [float(v) for v in ops.kkt_select(*args)]
        want = [float(v) for v in KS.kkt_select_plain(*args)]
        ok = got == want
        emit(phase="parity", kernel="kkt_select", case=name, n=n, got=got,
             want=want, ok=ok)
        check(ok, f"kkt_select {name}: {got} != {want}")
    check([float(v) for v in ops.kkt_select(*cases["tie"])][:2]
          == [-2.0, n // 7],
          "kkt_select tie did not go to the lowest index")
    errs["kkt_select"] = 0.0

    for dt in ("fp32", "bf16"):
        tdt = ops.tile_dtype(dt)
        z = t(rng.normal(size=(n_test, d)))
        sv = t(rng.normal(size=(n_sv, d)))
        cf = t(rng.normal(size=n_sv))
        got = ops.decision(z, sv, cf, gamma=0.01, compute_dtype=dt)
        want = D.decision_plain(z.to(tdt), sv.to(tdt), cf, gamma=0.01)
        ok = torch.allclose(got, want, **DECISION_TOL)
        emit(phase="parity", kernel="decision", dtype=dt,
             shape=[n_test, n_sv, d], max_abs_err=max_err(got, want),
             bound=DECISION_TOL, ok=ok)
        check(ok, f"decision {dt} disagrees with its plain version")
        if dt == "fp32":
            errs["decision"] = max_err(got, want)
        z1024 = z[:1024].contiguous()
        one = ops.multitask_decision(z1024, sv[None], cf[None], gamma=0.01,
                                     compute_dtype=dt)
        same = torch.equal(one[0], ops.decision(z1024, sv, cf, gamma=0.01,
                                                compute_dtype=dt))
        emit(phase="parity", kernel="multitask_decision", dtype=dt,
             case="T=1 equals decision bit for bit", ok=same)
        check(same, "multitask_decision T=1 differs from decision")
        # the binary serving bucket, and a 9-class Pavia one-vs-one bucket
        for shape in ((1, n_sv, 1024), (36, 4096, 1024)):
            tasks, w, nt = shape
            svb = t(rng.normal(size=(tasks, w, d)))
            cfb = t(rng.normal(size=(tasks, w)))
            zb = z[:nt].contiguous()
            for mode in ("rbf", "linear"):
                got = ops.multitask_decision(zb, svb, cfb, gamma=0.01,
                                             mode=mode, compute_dtype=dt)
                want = D.multitask_decision_plain(
                    zb.to(tdt), svb.to(tdt), cfb, gamma=0.01, mode=mode)
                # linear mode sums w d products of size ~1 into values of
                # size ~sqrt(w d): float32 rounding then scales with the
                # largest value, not with each (possibly cancelling) one
                tol = (DECISION_TOL if mode == "rbf" else dict(
                    rtol=2e-4, atol=2e-5 * float(want.abs().max())))
                ok = torch.allclose(got, want, **tol)
                emit(phase="parity", kernel="multitask_decision", dtype=dt,
                     mode=mode, shape=[tasks, w, d, nt],
                     max_abs_err=max_err(got, want), bound=tol, ok=ok)
                check(ok, f"multitask_decision {mode} {dt} {shape} "
                          "disagrees with its plain version")
                if dt == "fp32" and mode == "rbf" and tasks == 1:
                    errs["multitask_decision"] = max_err(got, want)
    torch.cuda.synchronize()
    return errs


# the cached row entry's lookups: a hot set (60 % of the calls) and
# enough other rows to evict from 32 slots many times
ROW_CACHE_SLOTS, ROW_CACHE_CALLS = 32, 200


MATVEC_BOUND = ("|got - Kv| <= 2e-5 sum|K v| + 2e-6 sum|v| a row "
                "(GRAM_TOL on each term, summed), against float64")


def matvec_f64(x, v, gamma, step=2048):
    """K(X, X) v and sum_c |K_rc v_c| of the RBF Gram in float64 from the
    rounded operands x (n, d), in row blocks."""
    xd, vd = x.double(), v.double()
    x2 = (xd * xd).sum(1)
    out, mag = [], []
    for s in range(0, xd.shape[0], step):
        k = torch.exp(-gamma * torch.clamp_min(
            x2[s:s + step, None] + x2[None, :] - 2.0 * (xd[s:s + step]
                                                        @ xd.T), 0.0))
        out.append(k @ vd)
        mag.append(k @ vd.abs())   # K >= 0
    return torch.cat(out), torch.cat(mag)


def matvec_errors(got, x, v, gamma) -> tuple[float, float]:
    """(largest |got - K v|, largest error over its MATVEC_BOUND)."""
    want, mag = matvec_f64(x, v, gamma)
    bound = 2e-5 * mag + 2e-6 * float(v.double().abs().sum())
    err = (got.double() - want).abs()
    return float(err.max()), float((err / bound).max())


def phase_matvec_parity(ops, K, dist, dev, xtr, gamma, fits) -> dict:
    """The Gram matvec (ops.gram_matvec, K never written) against a
    float64 sum: at the binary fit's 29,491 x 102 in both compute
    dtypes, and with the task axis at the OvO and OvR buckets of the
    overlapping multiclass fits (zero rows past each task, v 0 there),
    each bucket task also equal bit for bit to its lone call. Seeded
    normal v (every column weighs in). These launches are not the
    path's."""
    saved = dict(ops.launches)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    cases, errs = [], {}
    x = torch.from_numpy(xtr).to(dev)
    for dt in ("fp32", "bf16"):
        xk = x.to(ops.tile_dtype(dt))
        x2 = K.sqnorms(xk)
        v = torch.randn(x.shape[0], generator=gen, device=dev)
        err, worst = matvec_errors(ops.gram_matvec(xk, x2, v, gamma=gamma),
                                   xk, v, gamma)
        cases.append(dict(case="binary", dtype=dt, shape=[1, *x.shape],
                          max_abs_err=err, err_over_bound=worst,
                          ok=worst <= 1.0))
        if dt == "fp32":
            errs["rbf_gram_matvec"] = err
    for strategy in ("ovo", "ovr"):
        clf = fits[strategy][0]
        xt, _, mk, _ = dist._bucket_arrays(clf._taskset,
                                           clf._schedule.buckets[0])
        xb = torch.from_numpy(xt).to(dev)
        mask = torch.from_numpy(mk).to(dev)
        x2 = K.sqnorms(xb)
        v = torch.randn(mask.shape, generator=gen, device=dev) * mask
        g = clf.kernel_params.gamma
        got = ops.gram_matvec(xb, x2, v, gamma=g)
        per_task = [matvec_errors(got[t], xb[t], v[t], g)
                    for t in range(xb.shape[0])]
        lone = all(torch.equal(got[t], ops.gram_matvec(xb[t], x2[t], v[t],
                                                       gamma=g))
                   for t in range(xb.shape[0]))
        worst = max(w for _, w in per_task)
        cases.append(dict(case=f"{strategy}_bucket", dtype="fp32",
                          shape=list(xb.shape),
                          max_abs_err=max(e for e, _ in per_task),
                          err_over_bound=worst, task_rows_equal_lone=lone,
                          ok=worst <= 1.0 and lone))
    torch.cuda.synchronize()
    ops.launches.update(saved)
    ok = all(c["ok"] for c in cases)
    emit(phase="parity", kernel="rbf_gram_matvec", bound=MATVEC_BOUND,
         cases=cases, ok=ok)
    check(ok, f"rbf_gram_matvec disagrees with float64 or a bucket task "
          f"with its lone call: {cases}")
    return errs


def lookup_sequence(n: int, length: int = ROW_CACHE_CALLS,
                    seed: int = SEED) -> np.ndarray:
    """tests/test_torch_row_cache.py's sequence of row indices."""
    rng = np.random.default_rng(seed)
    hot = rng.choice(n, 5, replace=False)
    cold = rng.integers(0, n, length)
    return np.where(rng.random(length) < 0.6, rng.choice(hot, length), cold)


def fresh_row_cache(n: int, dev):
    """(keys, stamp, rows, clock, hits, misses) of an empty LRU cache, as
    kernel_engine.ChunkedKernelEngine.init_cache makes it."""
    def z():
        return torch.zeros((), dtype=torch.int64, device=dev)
    return (torch.full((ROW_CACHE_SLOTS,), -1, dtype=torch.int64,
                       device=dev),
            torch.zeros(ROW_CACHE_SLOTS, dtype=torch.int64, device=dev),
            torch.zeros((ROW_CACHE_SLOTS, n), device=dev), z(), z(), z())


def row_cache_parity(ops, G, K, xk, x2, dt) -> float:
    """The cached row entry against the plain LRU lookup on the same
    sequence of 200 indices at the main path's shape: keys, stamps,
    clock, hits and misses equal bit for bit after every call, rows
    within GRAM_TOL of the plain rows, and each row the bits of the
    uncached entry and of row t of a task-axis launch (the same X
    stacked three times, this index as task 1's)."""
    n = xk.shape[0]
    kern, plain = fresh_row_cache(n, xk.device), fresh_row_cache(n, xk.device)
    stacked = torch.stack([xk, xk, xk])
    stacked2 = torch.stack([x2, x2, x2])
    state_equal = same_bits = close = True
    err = 0.0
    for t, i in enumerate(lookup_sequence(n)):
        it = torch.tensor(int(i), device=xk.device)
        got = ops.gram_row_cached(xk, x2, it, *kern, gamma=0.01)
        want = G.lru_row_plain(*plain, it, lambda j: G.gram_row_plain(
            xk, x2, j, gamma=0.01))
        err = max(err, max_err(got, want))
        close &= bool(torch.allclose(got, want, **GRAM_TOL))
        state_equal &= all(bool(torch.equal(u, v)) for u, v in zip(
            kern[:2] + kern[3:], plain[:2] + plain[3:]))
        if t % 20 == 0:
            three = torch.stack([it, it, it])
            same_bits &= bool(torch.equal(got, ops.gram_row(
                xk, x2, it, gamma=0.01))) and bool(torch.equal(
                    got, ops.gram_row(stacked, stacked2, three,
                                      gamma=0.01)[1]))
    stored = max_err(kern[2], plain[2])
    ok = (state_equal and same_bits and close
          and bool(torch.allclose(kern[2], plain[2], **GRAM_TOL)))
    emit(phase="parity", kernel="rbf_gram_row_cached", dtype=dt,
         shape=[n, xk.shape[1]], slots=ROW_CACHE_SLOTS,
         calls=ROW_CACHE_CALLS, hits=int(kern[4]), misses=int(kern[5]),
         lru_state_equal_plain=state_equal,
         rows_equal_uncached_and_task_axis=same_bits, max_abs_err=err,
         stored_rows_max_abs_err=stored, bound=GRAM_TOL, ok=ok)
    check(state_equal, f"rbf_gram_row_cached {dt}: the LRU state differs "
          "from the plain lookup's")
    check(same_bits, f"rbf_gram_row_cached {dt}: a row differs from the "
          "uncached or the task-axis entry's bits")
    check(ok, f"rbf_gram_row_cached {dt} disagrees with its plain version")
    return err


def warm_fit_profile(SVC, dev, xtr, ytr, n_iter, **kw):
    """The same fit again, warm: its wall time, then once more under
    torch.profiler for the device's busy time and kernel launches (the
    profiler's own overhead lowers the busy share it reports)."""
    return warm_profile(lambda: SVC(**kw, device=dev).fit(xtr, ytr), n_iter)


def warm_profile(fit_once, n_iter):
    """``fit_once()`` again, warm: its wall time, then once more under
    torch.profiler: device busy time and share, kernels launched (per
    solver iteration or epoch), the eight kernels with most device
    time."""
    from torch.profiler import ProfilerActivity, profile

    def fit():
        fit_once()
        torch.cuda.synchronize()

    t0 = time.perf_counter()
    fit()
    warm_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fit()
        prof_s = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kernels)
    launched = sum(e.count for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    busy = {"profiled_wall_s": prof_s, "device_busy_s": dev_us / 1e6,
            "busy_share": dev_us / 1e6 / prof_s if dev_us else None,
            "device_kernels": launched,
            "device_kernels_per_iter": launched / max(n_iter, 1),
            "top": [[e.key[:60], e.count, e.self_device_time_total]
                    for e in top]}
    return warm_s, busy


PROFILE_SKIP_BLOCKS = 2   # a solve's eager first block and its capture
PROFILE_BLOCKS = 20


class WindowDone(Exception):
    """Ends a profiled fit once its window of check blocks closed."""


def graph_stats() -> dict:
    """A copy of the exact solver's CUDA-graph counts
    (``smo.graph_stats``: captures, seconds issuing and instantiating
    them, replays)."""
    from repro_torch.core import smo
    return dict(smo.graph_stats)


def graph_since(before: dict) -> dict:
    now = graph_stats()
    return {k: now[k] - before[k] for k in before}


@contextlib.contextmanager
def block_hook(smo, on_block):
    """``on_block()`` at the start of every check block of the exact
    solver in ``smo`` (sharded solves excepted): through ``smo._Block``
    where the checkout has it, else at every ``check_every``-th
    ``_smo_iteration`` (a checkout from before the check block became a
    graph; a block always runs all its iterations)."""
    if hasattr(smo, "_Block"):
        cls, call = smo._Block, smo._Block.__call__

        def hooked(self):
            on_block()
            return call(self)

        cls.__call__ = hooked
        try:
            yield
        finally:
            cls.__call__ = call
        return
    iterate, calls = smo._smo_iteration, [0]

    def counted(st, **kw):
        if calls[0] % kw["cfg"].check_every == 0:
            on_block()
        calls[0] += 1
        return iterate(st, **kw)

    smo._smo_iteration = counted
    try:
        yield
    finally:
        smo._smo_iteration = iterate


def block_profile(smo, fit_once, check_every: int = 32,
                  skip: int = PROFILE_SKIP_BLOCKS,
                  blocks: int = PROFILE_BLOCKS) -> dict:
    """``fit_once()`` again under torch.profiler, recording a window of
    ``blocks`` whole check blocks of the exact solver after its first
    ``skip`` (the eager block and the capture), and ending the fit when
    the window closes; a fit with fewer blocks is recorded to its end.
    A whole fit's profile is out of reach at the SVR's size (~70,000
    iterations of ~80 kernels). The window's wall time, device busy time
    and share, device kernels an iteration (``check_every`` a block), the
    five kernels with most device time. A block's window starts after the
    host read that ends the block before it, so the device is idle
    there."""
    from torch.profiler import ProfilerActivity, profile, schedule
    marks = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=skip, warmup=1, active=blocks,
                                   repeat=1)) as prof:
        def on_block():
            marks.append(time.perf_counter())
            prof.step()
            if len(marks) == skip + 1 + blocks:
                raise WindowDone

        with block_hook(smo, on_block), contextlib.suppress(WindowDone):
            fit_once()
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
    # marks: the start of every block, then the end of the fit
    n_blocks = min(blocks, len(marks) - 1 - skip)
    if n_blocks < 1:
        return {"window_blocks": 0}
    wall = marks[skip + n_blocks] - marks[skip]
    # device kernels only: the schedule's steps also appear on the
    # device's timeline, as "ProfilerStep#k" annotations a step long
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith("ProfilerStep")
               and not getattr(e, "is_user_annotation", False)]
    dev_us = sum(e.self_device_time_total for e in kernels)
    launched = sum(e.count for e in kernels)
    iters = n_blocks * check_every
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    return {"window_blocks": n_blocks, "window_wall_s": wall,
            "device_busy_s": dev_us / 1e6, "busy_share": dev_us / 1e6 / wall,
            "device_s_per_block": dev_us / 1e6 / n_blocks,
            "device_kernels": launched,
            "device_kernels_per_iter": launched / iters,
            "top": [[e.key[:60], e.count, e.self_device_time_total]
                    for e in top]}


@contextlib.contextmanager
def counting_blocks(smo):
    """A one-item list that counts the exact solver's check blocks."""
    n = [0]
    with block_hook(smo, lambda: n.__setitem__(0, n[0] + 1)):
        yield n


def fit_busy_share(profile: dict, blocks: int, fit_s: float):
    """The share of an unprofiled fit's wall time the device is busy: its
    check blocks (``counting_blocks``) at the window's device seconds a
    block. The profiler slows the host's issue (and a graph's launch),
    so the window's own share reads low."""
    if not profile.get("window_blocks"):
        return None
    return profile["device_s_per_block"] * blocks / fit_s


def binary_split(data):
    """(xtr, ytr, xte, yte) of the exact binary SVC: 32,768 Pavia-like
    rows of 102 bands, a tenth held out."""
    x, y = data.load_pavia_like(n_per_class=16384, n_classes=2, seed=SEED)
    return data.train_test_split(data.normalize(x), y, test_frac=0.1,
                                 seed=SEED)


def pavia_split(data, noise: float):
    """(xtr, ytr, xte, yte) of the multiclass fits: Pavia University's
    size, 9 classes of PAVIA_PER_CLASS rows of 102 bands at one band
    noise, a tenth held out."""
    x, y = data.load_pavia_like(n_per_class=PAVIA_PER_CLASS, n_classes=9,
                                n_bands=102, seed=SEED, noise=noise)
    return data.train_test_split(data.normalize(x), y, test_frac=0.1,
                                 seed=SEED)


def alone_equal_batch(pred, xte) -> bool:
    """Rows served one at a time give the bits they get in one request
    of 1,024 rows (the decision kernel folds a row's sum in an order
    fixed by the bank, whatever the batch and the launch's plan)."""
    z = xte[:1024]
    df = pred.decision_function(z)
    return all(np.array_equal(pred.decision_function(z[i:i + 1]),
                              df[..., i:i + 1])   # (rows,) or (T, rows)
               for i in (0, 1, len(z) // 2, len(z) - 1))


def phase_fit(ops, data, smo, KE, serve_mod, SVC, dev, path):
    xtr, ytr, xte, yte = binary_split(data)
    torch.cuda.synchronize()
    ops.reset_launches()
    g0 = graph_stats()
    t0 = time.perf_counter()
    clf = SVC(engine="pallas", shrink_every=4, device=dev).fit(xtr, ytr)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_launches = dict(ops.launches)
    graph = graph_since(g0)
    warm_s, busy = warm_fit_profile(SVC, dev, xtr, ytr, clf.n_iter_,
                                    engine="pallas", shrink_every=4)
    # held-out margins through the engine path (the decision kernel)
    ops.reset_launches()
    xs = torch.from_numpy(clf.support_vectors_).to(dev)
    df_engine = smo.decision_function(
        xs, torch.ones(len(xs), device=dev),
        torch.from_numpy(clf.dual_coef_).to(dev), clf.b_,
        torch.from_numpy(xte).to(dev), kernel=clf.kernel_params,
        engine=clf.engine_cfg).cpu().numpy()
    torch.cuda.synchronize()
    check_launches = dict(ops.launches)
    serve_mod.save(path, serve_mod.pack(clf))

    # certificate: the f64 KKT violation of a gradient recomputed from
    # scratch by one matvec (not the solver's own bookkeeping)
    yy = torch.from_numpy(np.where(ytr == clf.classes_[1], 1.0, -1.0)
                          .astype(np.float32)).to(dev)
    alpha = torch.from_numpy(clf.alpha_).to(dev)
    eng = KE.make_engine(torch.from_numpy(xtr).to(dev), clf.kernel_params,
                         "pallas")
    f = eng.matvec(alpha * yy) - yy
    kkt = float(smo.kkt_violation(alpha, yy, f, 0.0, clf.smo_cfg.C))
    acc = float(np.mean(np.where(df_engine > 0, clf.classes_[1],
                                 clf.classes_[0]) == yte))
    emit(phase="fit", n=int(xtr.shape[0]), d=int(xtr.shape[1]),
         n_iter=clf.n_iter_, converged=clf.converged_, kkt_f64=kkt,
         tol=clf.smo_cfg.tol, n_support=clf.n_support_, fit_s=fit_s,
         fit_s_warm=warm_s, profile=busy, graph=graph,
         gamma=clf.kernel_params.gamma, launches=fit_launches,
         launches_per_iter={k: v / max(clf.n_iter_, 1)
                            for k, v in fit_launches.items()},
         heldout_check_launches=check_launches, heldout_acc=acc)
    check(clf.converged_, "SMO fit did not converge")
    check(kkt <= clf.smo_cfg.tol, f"f64 KKT {kkt} > tol {clf.smo_cfg.tol}")
    check(graph["captures"] == 1, f"the exact SVC fit captured "
          f"{graph['captures']} CUDA graphs, not one")
    for k in ("rbf_gram_row_cached", "kkt_select"):
        check(fit_launches[k] > 0, f"fit launched no {k}")
    check(check_launches["decision"] > 0, "held-out check launched no "
          "decision kernel")
    main_launches = {k: fit_launches[k] + check_launches[k]
                     for k in fit_launches}
    return xtr, xte, df_engine, main_launches, fit_s, (ytr, yte, acc, clf)


def phase_fit_linear(ops, smo, KE, SVC, dev, xtr, ytr, xte, yte):
    """A linear-kernel exact SVC on the binary split (the pallas engine's
    linear mode), and its held-out margins through
    ``smo.decision_function`` from the solver's dual over every training
    row: the engine's ``decide`` runs the Gram block entry at 2,048 x
    29,491 (a linear kernel has no decision kernel), as a user of an
    ``SMOResult`` gets them. Certified by a float64 KKT check of a
    gradient recomputed by one matvec (not counted as the path's)."""
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    clf = SVC(kernel="linear", engine="pallas", shrink_every=4,
              device=dev).fit(xtr, ytr)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_launches = dict(ops.launches)
    ops.reset_launches()
    x = torch.from_numpy(xtr).to(dev)
    yy = torch.from_numpy(np.where(ytr == clf.classes_[1], 1.0, -1.0)
                          .astype(np.float32)).to(dev)
    alpha = torch.from_numpy(clf.alpha_).to(dev)
    df = smo.decision_function(
        x, yy, alpha, clf.b_, torch.from_numpy(xte).to(dev),
        kernel=clf.kernel_params, engine=clf.engine_cfg).cpu().numpy()
    torch.cuda.synchronize()
    check_launches = dict(ops.launches)
    eng = KE.make_engine(x, clf.kernel_params, "pallas")
    f = eng.matvec(alpha * yy) - yy
    kkt = float(smo.kkt_violation(alpha, yy, f, 0.0, clf.smo_cfg.C))
    acc = float(np.mean(np.where(df > 0, clf.classes_[1],
                                 clf.classes_[0]) == yte))
    emit(phase="fit_linear", n=int(xtr.shape[0]), d=int(xtr.shape[1]),
         n_iter=clf.n_iter_, converged=clf.converged_, kkt_f64=kkt,
         tol=clf.smo_cfg.tol, n_support=clf.n_support_, fit_s=fit_s,
         launches=fit_launches, heldout_check_launches=check_launches,
         heldout_acc=acc)
    check(clf.converged_, "linear SMO fit did not converge")
    check(kkt <= clf.smo_cfg.tol, f"linear SVC: f64 KKT {kkt} > tol")
    check(acc >= 0.99, f"linear SVC: held-out accuracy {acc} < 0.99")
    for k in ("rbf_gram_row_cached", "kkt_select", "rbf_gram_matvec"):
        check(fit_launches[k] > 0, f"linear fit launched no {k}")
    check(check_launches["rbf_gram"] > 0, "linear held-out margins "
          "launched no rbf_gram block")
    return {k: fit_launches[k] + check_launches[k] for k in ops.KERNELS}


def serve_rates(pred, xte):
    """Warm the predictor, then rows/s by request size (1, 37, 256, 1024
    and all held-out rows, up to 2048 rows each) and the labels of the
    one all-rows request."""
    pred.warmup((1, 37, 256, 1024))
    rates, labels = {}, None
    for size in (1, 37, 256, 1024, len(xte)):
        starts = range(0, len(xte), size)[:max(1, 2048 // size)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = [pred.predict(xte[s:s + size]) for s in starts]
        torch.cuda.synchronize()
        rates[str(size)] = sum(len(g) for g in got) / (time.perf_counter()
                                                       - t0)
        if size == len(xte):
            labels = got[0]
    return rates, labels


def phase_serve(ops, serve_mod, dev, path, xte, df_engine):
    packed = serve_mod.load(path)
    ops.reset_launches()
    pred = serve_mod.Predictor(packed, engine="pallas", device=dev)
    rates, labels = serve_rates(pred, xte)
    dfs = pred.decision_function(xte)
    alone = alone_equal_batch(pred, xte)
    torch.cuda.synchronize()
    serve_launches = dict(ops.launches)
    plain = serve_mod.Predictor(packed, engine="chunked", device=dev)
    want_labels = plain.predict(xte)
    want_df = plain.decision_function(xte)
    same = bool(np.array_equal(labels, want_labels))
    close = bool(np.allclose(dfs, want_df, **DECISION_TOL))
    emit(phase="serve", n_test=len(xte), rows_per_s=rates,
         n_programs=pred.n_programs, launches=serve_launches,
         labels_equal_chunked=same, rows_alone_equal_batch=alone,
         max_abs_err_vs_chunked=float(np.abs(dfs - want_df).max()),
         max_abs_err_vs_engine_path=float(np.abs(dfs - df_engine).max()))
    check(same, "pallas predictor labels differ from the chunked predictor")
    check(alone, "a row served alone differs from the same row in a "
          "1,024-row request")
    check(close, "pallas predictor decisions differ from the chunked one")
    check(bool(np.allclose(dfs, df_engine, **DECISION_TOL)),
          "predictor decisions differ from the engine decision path")
    check(serve_launches["multitask_decision"] > 0,
          "serving launched no multitask_decision kernel")
    return serve_launches, packed


def certify_lowrank(smo, phi, s, p, alpha, C: float, bias: float) -> float:
    """float64 KKT violation of the augmented-bias box QP (multiplier
    pinned at r = 0), from a gradient recomputed from Phi — not from the
    solver's incremental w: f = PhiBar PhiBar^T (alpha s) + s p."""
    f64 = torch.float64
    phib = torch.cat([phi.to(f64), torch.full((phi.shape[0], 1), bias,
                                              dtype=f64, device=phi.device)],
                     dim=1)
    a, s64 = alpha.to(f64), s.to(f64)
    f = phib @ (phib.T @ (a * s64)) + s64 * p.to(f64)
    return float(smo.kkt_violation(a, s64, f, 0.0, C, r=0.0))


def phase_lowrank_fit(ops, smo, SVC, dev, xtr, ytr, xte, yte, exact_acc):
    """SVC(engine="rff", rank=1024) on the exact phase's split: the map's
    transform (rff_features) and one dcd_epoch launch per epoch."""
    kw = dict(engine="rff", rank=RANK, C=1.0, tol=1e-3)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    clf = SVC(**kw, device=dev).fit(xtr, ytr)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_launches = dict(ops.launches)
    df = clf._decision_function_engine(xte)   # held-out margins: map and w
    torch.cuda.synchronize()
    launches = dict(ops.launches)
    acc = float(np.mean(np.where(df > 0, clf.classes_[1], clf.classes_[0])
                        == yte))
    warm_s, busy = warm_fit_profile(SVC, dev, xtr, ytr, clf.n_iter_, **kw)
    yy = torch.from_numpy(np.where(ytr == clf.classes_[1], 1.0, -1.0)
                          .astype(np.float32)).to(dev)
    phi = clf._feature_map.transform(torch.from_numpy(xtr).to(dev))
    kkt = certify_lowrank(smo, phi, yy, -torch.ones_like(yy),
                          torch.from_numpy(clf.alpha_).to(dev),
                          clf.dcd_cfg.C, clf.dcd_cfg.bias)
    ops.launches.update(launches)   # warm fits and checks are not the path
    emit(phase="lowrank_fit", n=int(xtr.shape[0]), d=int(xtr.shape[1]),
         rank=RANK, n_iter=clf.n_iter_, converged=clf.converged_,
         kkt_f64=kkt, tol=clf.dcd_cfg.tol, n_support=clf.n_support_,
         fit_s=fit_s, fit_s_warm=warm_s, profile=busy,
         epoch_s=fit_s / max(clf.n_iter_, 1), launches=fit_launches,
         heldout_check_launches={k: launches[k] - fit_launches[k]
                                 for k in launches},
         heldout_acc=acc, exact_heldout_acc=exact_acc)
    check(clf.converged_, "low-rank DCD fit did not converge")
    check(kkt <= clf.dcd_cfg.tol, f"low-rank f64 KKT {kkt} > tol")
    check(abs(acc - exact_acc) <= 0.01,
          f"low-rank held-out accuracy {acc} not within 0.01 of the exact "
          f"SVC's {exact_acc}")
    for k in ("rff_features", "dcd_epoch"):
        check(fit_launches[k] > 0, f"low-rank fit launched no {k}")
    return clf, phi, yy, launches, acc


def phase_lowrank_serve(ops, serve_mod, FM, dev, path, clf, xte):
    """pack -> save (schema v2) -> load -> Predictor, labels against the
    map's plain transform and w on the same card."""
    serve_mod.save(path, serve_mod.pack(clf))
    packed = serve_mod.load(path)
    check(packed.feature_map is not None and packed.feature_map.kind == "rff",
          "the low-rank artifact did not load as an RFF pack")
    ops.reset_launches()
    pred = serve_mod.Predictor(packed, device=dev)
    rates, labels = serve_rates(pred, xte)
    dfs = pred.decision_function(xte)
    torch.cuda.synchronize()
    launches = dict(ops.launches)
    om, ph = clf._feature_map.arrays
    want_df = (FM.rff_features_plain(torch.from_numpy(xte).to(dev), om, ph,
                                     scale=clf._feature_map.scale)
               @ torch.from_numpy(clf.w_).to(dev) + clf.b_).cpu().numpy()
    want_labels = clf.classes_[(want_df > 0).astype(np.int64)]
    same = bool(np.array_equal(labels, want_labels))
    close = bool(np.allclose(dfs, want_df, **DECISION_TOL))
    emit(phase="lowrank_serve", n_test=len(xte), schema_version=2,
         rows_per_s=rates, n_programs=pred.n_programs, launches=launches,
         labels_equal_plain=same,
         max_abs_err_vs_plain=float(np.abs(dfs - want_df).max()))
    check(same, "low-rank predictor labels differ from the plain path")
    check(close, "low-rank predictor decisions differ from the plain path")
    check(launches["rff_features"] > 0, "low-rank serving launched no "
          "rff_features kernel")
    return launches


def phase_svr(ops, data, smo, KE, serve_mod, SVR, dev, out_dir):
    """epsilon-SVR, exact (SMO over the doubled problem on the Gram
    kernels) and low-rank (rff_features + dcd_epoch): fit, certify, pack,
    save, load, serve."""
    xtr, ytr, xte, yte = svr_split(data, 16384)
    n = len(xtr)
    eps, C = 0.1, 1.0
    xt = torch.from_numpy(xtr).to(dev)
    yt = torch.from_numpy(ytr).to(dev)
    s = torch.cat([torch.ones(n, device=dev), -torch.ones(n, device=dev)])
    p = torch.cat([eps - yt, eps + yt])

    def exact_kkt(reg):
        """the f64 certificate of the doubled QP from a recomputed
        gradient"""
        a2 = torch.from_numpy(reg.alpha_raw_).to(dev)
        eng = KE.make_engine(torch.cat([xt, xt]), reg.kernel_params,
                             "pallas")
        f = eng.matvec(a2 * s) + s * p
        return float(smo.kkt_violation(a2, s, f, 0.0, C))

    total = {k: 0 for k in ops.KERNELS}
    r2s = {}
    for engine in ("pallas", "rff"):
        kw = dict(engine=engine, epsilon=eps, C=C, tol=1e-3)
        if engine == "rff":
            kw["rank"] = RANK
        else:
            # as the exact SVC phase: without shrinking, ~60k float32 f
            # updates leave the f cache off the exact gradient by more
            # than tol; the un-shrink re-check recomputes it
            kw["shrink_every"] = 4
        torch.cuda.synchronize()
        ops.reset_launches()
        g0 = graph_stats()
        t0 = time.perf_counter()
        with counting_blocks(smo) as blocks:
            reg = SVR(**kw, device=dev).fit(xtr, ytr)
            torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        fit_launches = dict(ops.launches)
        graph = graph_since(g0)
        warm = {}
        if engine == "rff":   # the low-rank fit's wall time warm, busy share
            warm_s, busy = warm_profile(
                lambda: SVR(**kw, device=dev).fit(xtr, ytr), reg.n_iter_)
            warm = dict(fit_s_warm=warm_s, profile=busy)
            ops.launches.update(fit_launches)
            phi = reg._feature_map.transform(xt)
            a2 = torch.from_numpy(reg.alpha_raw_).to(dev)
            lowrank = dict(phi=torch.cat([phi, phi]), s=s, p=p, beta=a2)
            kkt = certify_lowrank(smo, lowrank["phi"], s, p, a2, C,
                                  reg.dcd_cfg.bias)
        else:
            kkt = exact_kkt(reg)
            # busy share over a window of check blocks of the same fit
            busy = block_profile(smo,
                                 lambda: SVR(**kw, device=dev).fit(xtr, ytr))
            warm = dict(profile=busy, blocks=blocks[0],
                        busy_share_fit=fit_busy_share(busy, blocks[0],
                                                      fit_s))
        ops.launches.update(fit_launches)   # the check is not the path
        values = reg._predict_engine(xte)
        path = os.path.join(out_dir, f"chip_smoke_svr_{engine}.npz")
        serve_mod.save(path, serve_mod.pack(reg))
        pred = serve_mod.Predictor(serve_mod.load(path), engine=engine,
                                   device=dev).warmup((1, 1024))
        served = pred.predict(xte)
        torch.cuda.synchronize()
        launches = dict(ops.launches)
        r2 = r2s[engine] = r2_score(yte, served)
        ok = bool(np.allclose(served, values, **DECISION_TOL))
        emit(phase="svr", engine=engine, n_train=n, qp_variables=2 * n,
             d=int(xtr.shape[1]), rank=kw.get("rank"),
             n_iter=reg.n_iter_, converged=reg.converged_, kkt_f64=kkt,
             tol=1e-3, n_support=reg.n_support_, fit_s=fit_s, **warm,
             graph=graph, heldout_r2=r2, launches=launches,
             max_abs_err_served_vs_engine=float(np.abs(served
                                                       - values).max()),
             served_matches_engine=ok)
        check(reg.converged_, f"SVR({engine}) did not converge")
        check(kkt <= 1e-3, f"SVR({engine}) f64 KKT {kkt} > tol")
        check(ok, f"SVR({engine}) served values differ from the engine path")
        used = (("rbf_gram_row_cached", "kkt_select", "decision",
                 "multitask_decision") if engine == "pallas"
                else ("rff_features", "dcd_epoch"))
        for k in used:
            check(launches[k] > 0, f"SVR({engine}) launched no {k}")
        total = {k: total[k] + launches[k] for k in total}

    # the exact fit as a user gets it by default (no shrinking): the
    # solver certifies a recomputed f before it stops (ROADMAP C, fixed),
    # so the certificate is required; launches here are not the path's
    saved = dict(ops.launches)
    g0 = graph_stats()
    t0 = time.perf_counter()
    with counting_blocks(smo) as blocks:
        reg = SVR(engine="pallas", epsilon=eps, C=C, tol=1e-3,
                  device=dev).fit(xtr, ytr)
        torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    graph = graph_since(g0)
    kkt = exact_kkt(reg)
    busy = block_profile(smo, lambda: SVR(engine="pallas", epsilon=eps, C=C,
                                          tol=1e-3, device=dev).fit(xtr, ytr))
    ops.launches.update(saved)
    emit(phase="svr_default_config", engine="pallas", shrink_every=0,
         qp_variables=2 * n, n_iter=reg.n_iter_, converged=reg.converged_,
         kkt_f64=kkt, tol=1e-3, certified=kkt <= 1e-3, fit_s=fit_s,
         profile=busy, blocks=blocks[0],
         busy_share_fit=fit_busy_share(busy, blocks[0], fit_s), graph=graph)
    check(reg.converged_, "SVR(pallas), default configuration, did not "
          "converge")
    check(kkt <= 1e-3, f"SVR(pallas), default configuration: f64 KKT "
          f"{kkt} > tol 1e-3")
    return total, lowrank, r2s


SMO_GRAPH_SVR_ROWS = 4096


def graph_and_eager(ops, smo, solve) -> dict:
    """``solve()`` eager (``smo.CUDA_GRAPHS`` off), then with each check
    block after the first replayed from its CUDA graph, launch counts
    from 0 each time: per mode the host result, wall seconds, launches,
    CUDA-graph captures (``CompileGuard``) and ``smo.graph_stats``'
    counts. Not a path: the launch counts are restored after."""
    from repro_torch.analysis import CompileGuard
    saved, runs = dict(ops.launches), {}
    try:
        for mode in ("eager", "graph"):
            smo.CUDA_GRAPHS = mode == "graph"
            torch.cuda.synchronize()
            ops.reset_launches()
            before = graph_stats()
            with CompileGuard(budget=10_000) as guard:
                t0 = time.perf_counter()
                out = solve()
                torch.cuda.synchronize()
                fit_s = time.perf_counter() - t0
            runs[mode] = dict(
                out=out, fit_s=fit_s, launches=dict(ops.launches),
                captures=sum(e.startswith("cuda graph capture")
                             for e in guard.compiled),
                graph=graph_since(before))
    finally:
        smo.CUDA_GRAPHS = True
        ops.launches.update(saved)
    return runs


def solve_result(r, caches=()) -> dict:
    """An SMOResult on the host, with the row caches' hits and misses."""
    out = {k: getattr(r, k).cpu().numpy() for k in
           ("alpha", "b", "n_iter", "n_active", "converged")}
    out["cache_hits_misses"] = np.array(
        [[int(c.hits), int(c.misses)] for c in caches if c is not None])
    return out


def tapped_engine(KE, x, kernel):
    """A pallas engine whose row caches are kept (``caches``), so that a
    solve's hits and misses can be read after it."""
    eng = KE.make_engine(x, kernel, "pallas")
    caches, init = [], eng.init_cache

    def keep():
        caches.append(init())
        return caches[-1]

    eng.init_cache = keep
    return eng, caches


def phase_smo_graph(ops, data, smo, KE, K, MC, dist, dev, binary, base,
                    ovo_clf, overlapping):
    """The exact solver's check block as a CUDA graph against the eager
    loop, each case solved both ways in this process: the exact SVC at
    full width (the ``fit`` phase's problem and configuration), the
    overlapping OvO fit's widest bucket (36 tasks at full width) and the
    exact SVR at SMO_GRAPH_SVR_ROWS rows, with shrinking and unshrunk.
    alpha, b, n_iter, n_active, the row caches' hits and misses and the
    launch counts must be equal bit for bit, the graph run must capture
    once a solve of several blocks and the eager run never."""
    xtr, ytr = binary[:2]
    x = torch.from_numpy(xtr).to(dev)
    yy = torch.from_numpy(np.where(ytr == base.classes_[1], 1.0, -1.0)
                          .astype(np.float32)).to(dev)

    def svc():
        eng, caches = tapped_engine(KE, x, base.kernel_params)
        return solve_result(smo.binary_smo(
            x, yy, cfg=base.smo_cfg, kernel=base.kernel_params,
            engine=eng), caches)

    taskset = MC.get_strategy("ovo").build_taskset(*overlapping[:2])
    bucket = MC.build_schedule(taskset.sizes).buckets[0]
    xb, yb, mb = (torch.from_numpy(a).to(dev)
                  for a in dist._bucket_arrays(taskset, bucket)[:3])

    def ovo():
        eng = KE.TaskKernelEngine(xb, ovo_clf.kernel_params, "pallas")
        return solve_result(smo.binary_smo_tasks(
            xb, yb, mb, cfg=ovo_clf.smo_cfg, kernel=ovo_clf.kernel_params,
            engine=eng))

    xs, ys = svr_split(data, SMO_GRAPH_SVR_ROWS)[:2]
    xs = torch.from_numpy(xs).to(dev)
    s, p, lo, hi = smo._svr_spec(torch.from_numpy(ys).to(dev), 0.1, 1.0)
    x2 = torch.cat([xs, xs])
    kp_svr = K.resolve_gamma(K.KernelParams(gamma=-1.0), xs)

    def svr(shrink):
        def solve():
            eng, caches = tapped_engine(KE, x2, kp_svr)
            return solve_result(smo.solve_qp(
                x2, s, p, lo, hi, cfg=smo.SMOConfig(
                    C=1.0, tol=1e-3, shrink_every=shrink),
                kernel=kp_svr, engine=eng), caches)
        return solve

    cases = {"svc_exact": (svc, "29,491 x 102, shrink_every=4"),
             "ovo_bucket": (ovo, f"{tuple(xb.shape)}, overlapping"),
             "svr_shrink": (svr(4), f"{SMO_GRAPH_SVR_ROWS} rows (2 x "
                            f"{len(xs)} variables), shrink_every=4"),
             "svr_unshrunk": (svr(0), f"{SMO_GRAPH_SVR_ROWS} rows, no "
                              "shrinking (certified restarts)")}
    for name, (solve, shape) in cases.items():
        runs = graph_and_eager(ops, smo, solve)
        g, e = runs["graph"], runs["eager"]
        equal = {k: bool(np.array_equal(g["out"][k], e["out"][k]))
                 for k in g["out"]}
        n_iter = int(np.max(g["out"]["n_iter"]))
        emit(phase="smo_graph", case=name, shape=shape, n_iter=n_iter,
             blocks=-(-n_iter // 32), equal=equal,
             launches_equal=g["launches"] == e["launches"],
             captures={"graph": g["captures"], "eager": e["captures"]},
             graph=g["graph"], fit_s={"graph": g["fit_s"],
                                      "eager": e["fit_s"]},
             launches=g["launches"])
        check(all(equal.values()), f"smo_graph {name}: the graph run's "
              f"result differs from the eager run's {equal}")
        check(g["launches"] == e["launches"], f"smo_graph {name}: launch "
              "counts differ between the graph and the eager run")
        check(n_iter > 32 and g["captures"] == 1 and e["captures"] == 0,
              f"smo_graph {name}: {g['captures']} captures in the graph "
              f"run, {e['captures']} eager, over {n_iter} iterations")


def dcd_state(phi, s, p, beta0, perm):
    """The operands of one dcd_epoch from ``beta0`` (box [0, 1], all
    coordinates live), with the exact w and wb of that state."""
    n, dev = phi.shape[0], phi.device
    coef = s * beta0
    return dict(phi=phi, y=s, p=p, lo=torch.zeros(n, device=dev),
                hi=torch.ones(n, device=dev),
                q_diag=torch.sum(phi * phi, dim=1) + 1.0,
                live=torch.ones(n, dtype=torch.bool, device=dev),
                perm=perm, beta=beta0.clone(),
                w=(phi.T @ coef).contiguous(),
                wb=torch.sum(coef).reshape(1))


def repeats_perm(n: int, gen) -> torch.Tensor:
    """A visiting order whose indices repeat at distances 1 and 3 (in one
    window), 20 (across windows, within the ring's depth) and 60 (past
    it): a permutation with some positions overwritten."""
    perm = torch.randperm(n, generator=gen, device=gen.device).cpu()
    for period, dist in ((7, 1), (11, 3), (37, 20), (101, 60)):
        for t in range(dist + period - 1, n, period):
            perm[t] = perm[t - dist]
    return perm.to(gen.device)


def dcd_parity(ops, DCD, dev, gen, problem, case, phi, s, p, beta0,
               perm=None):
    """One dcd_epoch against the plain loop from the same state; the
    largest error."""
    if perm is None:
        perm = torch.randperm(phi.shape[0], generator=gen, device=dev)
    st = dcd_state(phi, s, p, beta0, perm)
    host = {k: v.cpu().clone() for k, v in st.items()}
    viol = float(ops.dcd_epoch(**st, bias=1.0))
    want = float(DCD.dcd_epoch_plain(*host.values(), bias=1.0))
    errs, ok = {}, abs(viol - want) <= DCD_TOL["viol_atol"]
    for name in ("beta", "w", "wb"):
        got, ref = st[name].cpu(), host[name]
        tol = DCD_TOL["atol_rel"] * float(ref.abs().max())
        errs[name] = max_err(got, ref)
        ok = ok and bool(torch.allclose(got, ref, rtol=DCD_TOL["rtol"],
                                        atol=tol))
    moved = st["beta"] != beta0
    repeated = torch.bincount(perm, minlength=phi.shape[0]) > 1
    emit(phase="parity", kernel="dcd_epoch", problem=problem, case=case,
         shape=list(phi.shape), plan=DCD.dcd_plan(phi.shape[1])._asdict(),
         distinct_indices=int(torch.unique(perm).numel()), viol=viol,
         viol_plain=want, max_abs_err=errs, moved=int(moved.sum()),
         repeated_indices_moved=int((moved & repeated).sum()),
         bound=DCD_TOL, ok=ok)
    check(ok, f"dcd_epoch ({problem}, {case}) disagrees with its plain "
              "version")
    if "fitted" not in case:   # from the cold state every index moves
        check(bool(moved.any()), f"dcd_epoch ({problem}, {case}) moved no "
              "coordinate")
        check(not bool(repeated.any()) or bool((moved & repeated).any()),
              f"dcd_epoch ({problem}, {case}): no repeated index moved")
    return max(errs.values())


def phase_lowrank_parity(ops, FM, DCD, dev, xtr, clf, phi_fit, yy_fit,
                         svr_state):
    """rff_features against its plain version at the fit's shape (fp32
    and bf16), and one dcd_epoch against the plain loop from the same
    state, cold and fitted, over the whole Phi of the low-rank SVC fit
    and of the SVR's doubled problem [Phi; Phi]."""
    x = torch.from_numpy(xtr).to(dev)
    om, ph = clf._feature_map.arrays
    scale = clf._feature_map.scale
    errs = {}
    for dt in ("fp32", "bf16"):
        tdt = ops.tile_dtype(dt)
        got = ops.rff_features(x, om, ph, scale=scale, compute_dtype=dt)
        want = FM.rff_features_plain(x.to(tdt), om.to(tdt), ph, scale=scale)
        err = max_err(got, want)
        ok = err <= RFF_TOL
        extra = {}
        if dt == "bf16":   # the bf16 map against the float32 one
            err32 = max_err(got, FM.rff_features_plain(x, om, ph,
                                                       scale=scale))
            extra = dict(max_abs_err_vs_fp32_map=err32,
                         bound_vs_fp32_map=dict(atol=RFF_BF16_VS_FP32_TOL),
                         scale=scale)
            ok = ok and err32 <= RFF_BF16_VS_FP32_TOL
        emit(phase="parity", kernel="rff_features", dtype=dt,
             shape=[x.shape[0], om.shape[1], x.shape[1]], max_abs_err=err,
             bound=dict(atol=RFF_TOL), ok=ok, **extra)
        check(ok, f"rff_features {dt} disagrees with its plain version")
        if dt == "fp32":
            errs["rff_features"] = err
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    n = phi_fit.shape[0]
    m = svr_state["phi"].shape[0]
    cases = [("svc", "cold", phi_fit, yy_fit, -torch.ones(n, device=dev),
              torch.zeros(n, device=dev)),
             ("svc", "fitted", phi_fit, yy_fit, -torch.ones(n, device=dev),
              torch.from_numpy(clf.alpha_).to(dev)),
             ("svr_doubled", "cold", svr_state["phi"], svr_state["s"],
              svr_state["p"], torch.zeros(m, device=dev)),
             ("svr_doubled", "fitted", svr_state["phi"], svr_state["s"],
              svr_state["p"], svr_state["beta"])]
    errs["dcd_epoch"] = max(dcd_parity(ops, DCD, dev, gen, *c)
                            for c in cases)
    # indices that repeat within a window, across windows inside the
    # ring's depth and past it, against the plain loop. A repeat's step
    # reads the beta and w its earlier occurrence wrote, which tests the
    # kernel only where coordinates move: the SVR's doubled problem from
    # its cold state moves ~40 % of them across the whole sweep (the
    # binary problem's cold epoch moves ~60, all early, once w separates
    # the classes; its fitted epoch ~15)
    repeat_cases = [
        ("svr_doubled", "repeated_indices", svr_state["phi"],
         svr_state["s"], svr_state["p"], torch.zeros(m, device=dev)),
        ("svc", "repeated_indices", phi_fit, yy_fit,
         -torch.ones(n, device=dev), torch.zeros(n, device=dev)),
        ("svc", "repeated_indices_fitted", phi_fit, yy_fit,
         -torch.ones(n, device=dev), torch.from_numpy(clf.alpha_).to(dev))]
    for problem, case, phi, s, p, beta0 in repeat_cases:
        errs["dcd_epoch"] = max(errs["dcd_epoch"], dcd_parity(
            ops, DCD, dev, gen, problem, case, phi, s, p, beta0,
            perm=repeats_perm(phi.shape[0], gen)))
    torch.cuda.synchronize()
    return errs


def time_row(ops, name, src, replaces, kern, plain, lib, n_bytes, n_ops,
             launches, err, plain_on_host=False, bounds=None):
    """One ``kernels`` entry: the kernel, its plain version and the
    library call timed at main-path shapes (timing launches do not
    count). ``bounds`` (``gram_bounds`` / ``lm_bounds``) replaces the
    float32-core bound of ``n_bytes`` and ``n_ops``; ``launches`` is the
    path's count, by kernel name, or a number."""
    saved = dict(ops.launches)
    ms = median_ms(kern)
    if plain_on_host:   # a Python loop on the host: wall clock, few reps
        plain()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            plain()
            times.append((time.perf_counter() - t0) * 1e3)
        plain_ms = statistics.median(times)
    else:
        plain_ms = median_ms(plain)
    ms2 = median_ms(kern)                   # kernel, plain, kernel: spread
    library_ms = median_ms(lib) if lib is not None else None
    dev = {"device_ms": device_ms(kern),
           "plain_device_ms": None if plain_on_host else device_ms(plain),
           "library_device_ms": (device_ms(lib) if lib is not None
                                 else None)}
    ops.launches.update(saved)
    b_ms, b_by = bound_ms(n_bytes, n_ops)
    extra = {}
    if bounds is not None:
        extra = {k: v for k, v in bounds.items()
                 if k not in ("bound_ms", "bound_by")}
        b_ms, b_by = bounds["bound_ms"], bounds["bound_by"]
    return {"name": name, "route": "cuda", "source": f"{CSRC}/{src}",
            "replaces": replaces,
            "launches": (launches if isinstance(launches, int)
                         else launches[name]),
            "max_abs_err": err, "ms": ms, "ms_repeat": ms2,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library_ms, **dev, **extra}


def phase_timing_lowrank(ops, FM, DCD, dev, xtr, clf, phi_fit, yy, errs,
                         launches, svr_state, svr_launches, task_rows):
    """rff_features and dcd_epoch at the low-rank fit's shapes; dcd_epoch
    also at the SVR's doubled shape, with the SVR path's own launches,
    and with the task axis (a ``dcd_shapes`` line)."""
    x = torch.from_numpy(xtr).to(dev)
    n, d = x.shape
    om, ph = clf._feature_map.arrays
    k = om.shape[1]
    scale = clf._feature_map.scale
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)

    def dcd_row(phi, s, p, beta, err, launches):
        """dcd_epoch from a fitted state: each timed call is one more
        epoch of the converged solve, the work of a fit's last epochs."""
        m = phi.shape[0]
        st = dcd_state(phi, s, p, beta,
                       torch.randperm(m, generator=gen, device=dev))
        host = {key: v.cpu().clone() for key, v in st.items()}
        before = st["beta"].clone()
        saved = dict(ops.launches)
        ops.dcd_epoch(**st, bias=1.0)
        ops.launches.update(saved)
        moved = int((st["beta"] != before).sum())
        row = time_row(
            ops, "dcd_epoch", "dcd_epoch.cu",
            "src/repro/core/linear.py:141 (lax.fori_loop; no Pallas kernel)",
            lambda: ops.dcd_epoch(**st, bias=1.0),
            lambda: DCD.dcd_epoch_plain(*host.values(), bias=1.0), None,
            # Phi once; y, p, lo, hi, q_diag, beta, perm, live read, beta
            # written; w and wb read and written
            4 * m * k + m * (4 * 7 + 8 + 1) + 8 * (k + 1),
            # the dot products, the moved coordinates' updates of w and
            # about 20 scalar operations a coordinate
            2 * m * k + 2 * k * moved + 20 * m,
            launches, err, plain_on_host=True)
        row.update(shape=[m, k], moved_per_epoch=moved,
                   ns_per_coord=row["device_ms"] * 1e6 / m,
                   **dcd_info(DCD, k))
        return row

    rows = [
        time_row(ops, "rff_features", "rff_features.cu",
                 "src/repro/kernels/feature_map.py:59",
                 lambda: ops.rff_features(x, om, ph, scale=scale),
                 lambda: FM.rff_features_plain(x, om, ph, scale=scale),
                 lambda: scale * torch.cos(torch.addmm(ph, x, om)),
                 4 * (n * d + d * k + k + n * k), n * k * (2 * d + 3),
                 launches, errs["rff_features"]),
        dcd_row(phi_fit, yy, -torch.ones(n, device=dev),
                torch.from_numpy(clf.alpha_).to(dev), errs["dcd_epoch"],
                launches),
    ]
    rows[0].update(redesign_info("rff_features", (n, k, d)))
    svr_row = dcd_row(svr_state["phi"], svr_state["s"], svr_state["p"],
                      svr_state["beta"], errs["dcd_epoch"], svr_launches)
    svr_row["problem"] = "svr_doubled"
    emit(phase="dcd_shapes", kernels=[svr_row, *task_rows])
    # the same map over one serving batch (Predictor max_batch rows)
    xs = x[:1024].contiguous()
    saved = dict(ops.launches)
    err = max_err(ops.rff_features(xs, om, ph, scale=scale),
                  FM.rff_features_plain(xs, om, ph, scale=scale))
    ops.launches.update(saved)
    check(err <= RFF_TOL, "rff_features disagrees with its plain version "
          "at the serving shape")
    serving = time_row(
        ops, "rff_features", "rff_features.cu",
        "src/repro/kernels/feature_map.py:59",
        lambda: ops.rff_features(xs, om, ph, scale=scale),
        lambda: FM.rff_features_plain(xs, om, ph, scale=scale),
        lambda: scale * torch.cos(torch.addmm(ph, xs, om)),
        4 * (1024 * d + d * k + k + 1024 * k), 1024 * k * (2 * d + 3),
        launches, err)
    serving.update(shape=[1024, k, d],
                   **redesign_info("rff_features", (1024, k, d)))
    emit(phase="serving_shapes", kernels=[serving])
    return rows


def task_certificates(ops, smo, KE, clf, dev, alpha=None) -> list[float]:
    """float64 KKT violation of each task of a multiclass exact fit (or
    of ``alpha``, a (C, max_k) matrix over the same tasks), from a
    gradient recomputed by one matvec over the task's own rows."""
    saved = dict(ops.launches)
    alphas = clf._fit.alpha if alpha is None else alpha
    out = []
    for t, task in enumerate(clf._taskset.tasks):
        k = task.size
        xt = torch.from_numpy(task.x).to(dev)
        yt = torch.from_numpy(task.y).to(dev)
        alpha = torch.from_numpy(alphas[t, :k]).to(dev)
        eng = KE.make_engine(xt, clf.kernel_params, "pallas")
        f = eng.matvec(alpha * yt) - yt
        out.append(float(smo.kkt_violation(alpha, yt, f, 0.0,
                                           clf.smo_cfg.C)))
    ops.launches.update(saved)   # the check is not the path
    return out


def decoded(MC, clf, df):
    """Class labels of stacked decision values ``df`` (n_tasks, nt)."""
    idx = MC.decide_from_pairs(torch.from_numpy(df), clf._taskset.pairs,
                               len(clf.classes_), clf.strategy.name,
                               clf.decision)
    return clf.classes_[idx.numpy()]


def batching_check(ops, smo, KE, dist, clf, dev) -> dict:
    """The first and the last task of the OvO bucket solved again alone,
    with T = 1 launches of the same kernels: alphas, b and n_iter equal
    the bucket's bit for bit (each task's arithmetic is the same)."""
    saved = dict(ops.launches)
    bucket = clf._schedule.buckets[0]
    xt, yt, mk, _ = dist._bucket_arrays(clf._taskset, bucket)
    ids = bucket.task_ids.reshape(-1)
    cfg = KE.EngineConfig(backend="pallas", cache_slots=0)
    res = {}
    for s in (0, len(ids) - 1):
        t = int(ids[s])
        k = clf._taskset.tasks[t].size
        r = smo.binary_smo(torch.from_numpy(xt[s]).to(dev),
                           torch.from_numpy(yt[s]).to(dev),
                           torch.from_numpy(mk[s]).to(dev),
                           cfg=clf.smo_cfg, kernel=clf.kernel_params,
                           engine=cfg)
        alpha = r.alpha.cpu().numpy()
        res[f"task_{t}"] = dict(
            n_iter_alone=int(r.n_iter), n_iter_bucket=int(clf._fit.n_iter[t]),
            b_alone=float(r.b), b_bucket=float(clf._fit.b[t]),
            alpha_max_abs_diff=float(np.abs(alpha[:k]
                                            - clf._fit.alpha[t, :k]).max()),
            equal=bool(np.array_equal(alpha[:k], clf._fit.alpha[t, :k])
                       and not alpha[k:].any()
                       and float(r.b) == float(clf._fit.b[t])
                       and int(r.n_iter) == int(clf._fit.n_iter[t])))
    ops.launches.update(saved)
    return res


def decision_f64(z, sv, coef, gamma):
    """(T, nt) decisions of a stacked RBF bank in float64, and the sum of
    the magnitudes of their terms, sum_i |coef_i| K(sv_i, z)."""
    z, sv, coef = z.double(), sv.double(), coef.double()
    d2 = (torch.sum(z * z, dim=1)[None, :, None]
          + torch.sum(sv * sv, dim=2)[:, None, :]
          - 2.0 * torch.einsum("nd,twd->tnw", z, sv))
    k = torch.exp(-gamma * torch.clamp_min(d2, 0.0))
    return ((k @ coef[:, :, None])[..., 0],
            (k @ coef.abs()[:, :, None])[..., 0])


def bank_parity(ops, D, packed, xte, dev) -> list[dict]:
    """multitask_decision on every serving bank of a loaded multiclass
    pack, over all held-out rows, against its plain version on the same
    card tensors at DECISION_TOL, and both against a float64 evaluation:
    the kernel must be no further from it than twice the plain version
    is, plus 2e-6 (these launches are not the path's). A decision sums w
    terms coef_i K_i that cancel; the sum of their magnitudes S is
    reported beside the errors."""
    saved = dict(ops.launches)
    z = torch.from_numpy(xte).to(dev)
    gamma = packed.kernel.gamma
    out = []
    for g in packed.buckets:
        sv = torch.from_numpy(g.sv_x).to(dev)
        cf = torch.from_numpy(g.sv_coef).to(dev)
        got = ops.multitask_decision(z, sv, cf, gamma=gamma)
        want = D.multitask_decision_plain(z, sv, cf, gamma=gamma)
        ref, mag = decision_f64(z, sv, cf, gamma)
        err64 = float((got.double() - ref).abs().max())
        plain64 = float((want.double() - ref).abs().max())
        out.append(dict(
            shape=[int(sv.shape[0]), int(z.shape[0]), int(sv.shape[1]),
                   int(sv.shape[2])],
            max_abs_err=max_err(got, want), term_magnitude_max=float(mag.max()),
            max_abs_err_vs_f64=err64, plain_max_abs_err_vs_f64=plain64,
            ok=(bool(torch.allclose(got, want, **DECISION_TOL))
                and err64 <= 2.0 * plain64 + 2e-6)))
    ops.launches.update(saved)
    return out


def phase_multiclass(ops, data, smo, KE, MC, dist, D, serve_mod, SVC, dev,
                     out_dir, config, noise):
    """Exact multiclass C-SVC at Pavia University's size, OvO then OvR:
    fit (one batched SMO per bucket), per-task certificates, the OvO
    batching check, pack -> save -> load -> Predictor, and each serving
    bank's multitask_decision against its plain version."""
    xtr, ytr, xte, yte = pavia_split(data, noise)
    kw = dict(decision="vote", engine="pallas", C=1.0, tol=1e-3)
    paths, fits = {}, {}
    for strategy in ("ovo", "ovr"):
        torch.cuda.synchronize()
        ops.reset_launches()
        g0 = graph_stats()
        t0 = time.perf_counter()
        clf = SVC(strategy=strategy, **kw, device=dev).fit(xtr, ytr)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        fit_launches = dict(ops.launches)
        graph = graph_since(g0)
        t0 = time.perf_counter()
        with counting_blocks(smo) as blocks:
            SVC(strategy=strategy, **kw, device=dev).fit(xtr, ytr)
            torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        busy = block_profile(smo, lambda: SVC(strategy=strategy, **kw,
                                              device=dev).fit(xtr, ytr))
        ops.launches.update(fit_launches)   # the warm fit is not the path
        kkt = task_certificates(ops, smo, KE, clf, dev)
        df_engine = clf._decision_function_engine(xte)   # decision kernel
        torch.cuda.synchronize()
        check_launches = {k: ops.launches[k] - fit_launches[k]
                          for k in ops.KERNELS}
        engine_labels = decoded(MC, clf, df_engine)
        acc = float(np.mean(engine_labels == yte))
        batching = (batching_check(ops, smo, KE, dist, clf, dev)
                    if strategy == "ovo" else None)
        path = os.path.join(out_dir, f"chip_smoke_{strategy}_{config}.npz")
        serve_mod.save(path, serve_mod.pack(clf))
        packed = serve_mod.load(path)
        banks = bank_parity(ops, D, packed, xte, dev)
        launches_before = dict(ops.launches)
        pred = serve_mod.Predictor(packed, engine="pallas", device=dev)
        rates, labels = serve_rates(pred, xte)
        dfs = pred.decision_function(xte)
        alone = alone_equal_batch(pred, xte)
        torch.cuda.synchronize()
        serve_launches = {k: ops.launches[k] - launches_before[k]
                          for k in ops.KERNELS}
        same = bool(np.array_equal(labels, engine_labels))
        close = bool(np.allclose(dfs, df_engine, **DECISION_TOL))
        iters = clf._fit.n_iter
        sched = MC.schedule_stats(clf._taskset.sizes, clf._schedule)
        emit(phase="multiclass", config=config, noise=noise,
             strategy=strategy, decision="vote",
             n_train=int(xtr.shape[0]), n_test=int(xte.shape[0]),
             d=int(xtr.shape[1]), n_classes=int(len(clf.classes_)),
             n_tasks=int(clf._taskset.n_tasks),
             task_sizes=[int(v) for v in clf._taskset.sizes],
             buckets=[[int(b.width), int(b.n_slots)]
                      for b in clf._schedule.buckets],
             padded_flop_fraction=sched["padded_flop_fraction"],
             n_iter_max=int(iters.max()), n_iter=[int(v) for v in iters],
             converged=clf.converged_, kkt_f64_max=max(kkt),
             kkt_f64=kkt, tol=1e-3,
             n_support=[int(v) for v in clf.n_support_],
             serving_banks=[list(g.sv_x.shape) for g in packed.buckets],
             bank_parity=banks, bank_parity_bound=dict(
                 **DECISION_TOL, vs_f64="kernel <= 2 x plain + 2e-6"),
             fit_s=fit_s, fit_s_warm=warm_s, profile=busy,
             blocks=blocks[0],
             busy_share_fit=fit_busy_share(busy, blocks[0], warm_s),
             graph=graph,
             launches=fit_launches,
             launches_per_iter={k: v / max(int(iters.max()), 1)
                                for k, v in fit_launches.items() if v},
             heldout_check_launches=check_launches, heldout_acc=acc,
             batching_check=batching, rows_per_s=rates,
             n_programs=pred.n_programs, serve_launches=serve_launches,
             labels_equal_engine=same, rows_alone_equal_batch=alone,
             max_abs_err_vs_engine=float(np.abs(dfs - df_engine).max()))
        check(clf.converged_, f"multiclass {strategy} fit did not converge")
        check(max(kkt) <= 1e-3, f"multiclass {strategy}: a task's f64 KKT "
              f"{max(kkt)} > tol")
        for k in ("rbf_gram_row", "kkt_select"):
            check(fit_launches[k] > 0, f"multiclass {strategy} fit "
                  f"launched no {k}")
        # one batched launch per iteration for the whole bucket, not T
        n_blocks_max = -(-int(iters.max()) // 32) + 1
        check(fit_launches["kkt_select"] <= 32 * n_blocks_max
              * len(clf._schedule.buckets) + len(clf._schedule.buckets),
              f"multiclass {strategy}: {fit_launches['kkt_select']} "
              "selection launches — more than one per bucket iteration")
        check(same, f"multiclass {strategy}: served labels differ from the "
              "engine path")
        check(close, f"multiclass {strategy}: served decisions differ from "
              "the engine path")
        check(alone, f"multiclass {strategy}: a row served alone differs "
              "from the same row in a 1,024-row request")
        check(serve_launches["multitask_decision"] > 0,
              f"multiclass {strategy} serving launched no "
              "multitask_decision kernel")
        check(max(b.sv_x.shape[0] for b in packed.buckets) > 1,
              f"multiclass {strategy}: no serving bank stacks T > 1 tasks")
        check(all(v["ok"] for v in banks), f"multiclass {strategy}: "
              f"multitask_decision disagrees with its plain version on a "
              f"serving bank {banks}")
        if batching is not None:
            check(all(v["equal"] for v in batching.values()),
                  f"batching check: a lone solve differs from the bucket "
                  f"{batching}")
        paths[f"svc_{strategy}_{config}"] = {
            k: fit_launches[k] + check_launches[k] + serve_launches[k]
            for k in ops.KERNELS}
        fits[strategy] = (clf, acc, packed)
    return (xtr, ytr, xte, yte), fits, paths


def phase_multiclass_lowrank(ops, smo, MC, FM, DCD, serve_mod, SVC, dev,
                             split, exact_acc, out_dir, config, strategy):
    """SVC(strategy=..., engine="rff", rank=1024) on the exact phases'
    split: one shared map, every task's DCD fit in one batched solve
    (one task-axis dcd_epoch launch an epoch); per-task certificates of
    the augmented-bias dual; served through a schema-v2 pack. Returns
    the path's launches and the fit with its map's Phi."""
    xtr, ytr, xte, yte = split
    kw = dict(strategy=strategy, engine="rff", rank=RANK, C=1.0, tol=1e-3)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    clf = SVC(**kw, device=dev).fit(xtr, ytr)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_launches = dict(ops.launches)
    rounds = fit_launches["dcd_epoch"]
    warm_s, busy = warm_fit_profile(SVC, dev, xtr, ytr, rounds, **kw)
    ops.launches.update(fit_launches)   # the warm fits are not the path
    df_engine = clf._decision_function_engine(xte)   # map and task_w
    engine_labels = decoded(MC, clf, df_engine)
    acc = float(np.mean(engine_labels == yte))
    torch.cuda.synchronize()
    check_launches = {k: ops.launches[k] - fit_launches[k]
                      for k in ops.KERNELS}
    saved = dict(ops.launches)
    phi = clf._feature_map.transform(torch.from_numpy(xtr).to(dev))
    kkt = []
    for t, task in enumerate(clf._taskset.tasks):
        idx = torch.from_numpy(task.indices).to(dev)
        yt = torch.from_numpy(task.y).to(dev)
        kkt.append(certify_lowrank(
            smo, phi.index_select(0, idx), yt, -torch.ones_like(yt),
            torch.from_numpy(clf._task_alpha[t]).to(dev), clf.dcd_cfg.C,
            clf.dcd_cfg.bias))
    ops.launches.update(saved)   # the certificates are not the path
    path = os.path.join(out_dir, f"chip_smoke_{strategy}_lowrank.npz")
    serve_mod.save(path, serve_mod.pack(clf))
    packed = serve_mod.load(path)
    pred = serve_mod.Predictor(packed, device=dev)
    rates, labels = serve_rates(pred, xte)
    dfs = pred.decision_function(xte)
    torch.cuda.synchronize()
    serve_launches = {k: ops.launches[k] - saved[k] for k in ops.KERNELS}
    om, ph = clf._feature_map.arrays
    plain = (FM.rff_features_plain(torch.from_numpy(xte).to(dev), om, ph,
                                   scale=clf._feature_map.scale)
             @ torch.from_numpy(clf.task_w_).to(dev).T).T.cpu().numpy() \
        + clf.task_b_[:, None]
    plain_labels = decoded(MC, clf, plain)
    same = bool(np.array_equal(labels, plain_labels))
    close = bool(np.allclose(dfs, plain, **DECISION_TOL))
    emit(phase="multiclass_lowrank", config=config,
         noise=PAVIA_NOISE[config], strategy=strategy, rank=RANK,
         n_train=int(xtr.shape[0]), n_tasks=int(clf._taskset.n_tasks),
         task_sizes=[int(t.size) for t in clf._taskset.tasks],
         epochs=[int(v) for v in clf.task_n_iter_],
         epochs_total=int(clf.task_n_iter_.sum()), epochs_max=clf.n_iter_,
         task_axis_launches=rounds, converged=clf.converged_,
         kkt_f64_max=max(kkt), kkt_f64=kkt, tol=1e-3,
         n_support=[int(v) for v in clf.n_support_], fit_s=fit_s,
         fit_s_warm=warm_s, profile=busy,
         round_s=fit_s / max(rounds, 1),
         launches=fit_launches, heldout_check_launches=check_launches,
         heldout_acc=acc, exact_heldout_acc=exact_acc,
         schema_version=2,
         rows_per_s=rates, n_programs=pred.n_programs,
         serve_launches=serve_launches, labels_equal_plain=same,
         max_abs_err_vs_plain=float(np.abs(dfs - plain).max()))
    check(packed.feature_map is not None, "the multiclass low-rank "
          "artifact did not load as a low-rank (v2) pack")
    check(clf.converged_, "multiclass low-rank fit did not converge")
    check(max(kkt) <= 1e-3, f"multiclass low-rank: a task's f64 KKT "
          f"{max(kkt)} > tol")
    check(abs(acc - exact_acc) <= 0.01,
          f"multiclass low-rank accuracy {acc} not within 0.01 of the exact "
          f"{strategy} fit's {exact_acc}")
    for k in ("rff_features", "dcd_epoch"):
        check(fit_launches[k] > 0, f"multiclass low-rank fit launched no {k}")
    check(same, "multiclass low-rank: served labels differ from the plain "
          "transform and task_w")
    check(close, "multiclass low-rank: served decisions differ from the "
          "plain path")
    return ({k: fit_launches[k] + check_launches[k] + serve_launches[k]
             for k in ops.KERNELS}, clf, phi)


def task_states(dev, tasks, rows, phi, alphas, gen):
    """One dcd_epoch state per task (its gathered rows, from ``alphas``)
    and the same states concatenated for one task-axis launch."""
    lone = []
    for r, task, a in zip(rows, tasks, alphas):
        yt = torch.from_numpy(task.y).to(dev)
        lone.append(dcd_state(phi.index_select(0, r), yt,
                              -torch.ones_like(yt), torch.from_numpy(a).to(dev),
                              torch.randperm(task.size, generator=gen,
                                             device=dev)))
    batch = {name: torch.cat([st[name] for st in lone]).contiguous()
             for name in ("y", "p", "lo", "hi", "q_diag", "live", "perm",
                          "beta", "wb")}
    batch["w"] = torch.stack([st["w"] for st in lone]).contiguous()
    batch["rows"] = torch.cat(rows).contiguous()
    batch["offsets"] = torch.tensor(
        np.r_[0, np.cumsum([task.size for task in tasks])],
        dtype=torch.int64, device=dev)
    return lone, batch


def dcd_task_axis(ops, DCD, dev, strategy, clf, phi, launches):
    """The task axis of dcd_epoch at a multiclass low-rank fit's shape:
    one ops.dcd_epoch_tasks launch over every task, from the cold state
    (every coordinate takes a step) and from the fitted one, which must
    equal one-task launches on each task's gathered rows bit for bit and
    hold DCD_TOL against the plain loop for three tasks; then its time
    beside the lone launches' from the fitted state (each timed call one
    more epoch of every task). Returns the timing row and the largest
    error against the plain loop."""
    saved = dict(ops.launches)
    tasks = clf._taskset.tasks
    n_tasks, k = len(tasks), phi.shape[1]
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    rows = [torch.from_numpy(t.indices).to(dev) for t in tasks]
    sizes = [task.size for task in tasks]
    ids = torch.arange(n_tasks, device=dev)
    checked = sorted({0, n_tasks // 2, n_tasks - 1})
    errs = []
    for case, alphas in (("cold", [np.zeros(t.size, np.float32)
                                   for t in tasks]),
                         ("fitted", clf._task_alpha)):
        lone, batch = task_states(dev, tasks, rows, phi, alphas, gen)
        start = [{name: v.cpu().clone() for name, v in st.items()}
                 for st in lone]
        before = batch["beta"].clone()
        viols = ops.dcd_epoch_tasks(phi, **batch, tasks=ids, bias=1.0)
        moved = int((batch["beta"] != before).sum())
        lone_viols = [ops.dcd_epoch(**st, bias=1.0) for st in lone]
        off = batch["offsets"].tolist()

        def task_result(t):
            return {"beta": batch["beta"][off[t]:off[t + 1]],
                    "w": batch["w"][t], "wb": batch["wb"][t:t + 1]}

        equal = all(torch.equal(viols[t], lone_viols[t])
                    and all(torch.equal(v, lone[t][name])
                            for name, v in task_result(t).items())
                    for t in range(n_tasks))
        case_errs, ok = [], True
        for t in checked:
            host = start[t]
            want = float(DCD.dcd_epoch_plain(*host.values(), bias=1.0))
            ok = ok and abs(float(viols[t]) - want) <= DCD_TOL["viol_atol"]
            for name, got in task_result(t).items():
                got, ref = got.cpu(), host[name]
                case_errs.append(max_err(got, ref))
                ok = ok and bool(torch.allclose(
                    got, ref, rtol=DCD_TOL["rtol"],
                    atol=DCD_TOL["atol_rel"] * float(ref.abs().max())))
        emit(phase="parity", kernel="dcd_epoch",
             problem=f"{strategy}_task_axis", case=case, n_tasks=n_tasks,
             rows_of_phi=int(phi.shape[0]), rank=k,
             task_sizes=[min(sizes), max(sizes)], moved=moved,
             equal_to_lone_launches=equal, plain_checked_tasks=checked,
             max_abs_err_vs_plain=max(case_errs), bound=DCD_TOL, ok=ok)
        check(equal, f"task-axis dcd_epoch ({strategy}, {case}) differs "
              "from one-task launches")
        check(ok, f"task-axis dcd_epoch ({strategy}, {case}) disagrees "
              "with its plain version")
        if case == "cold":
            check(moved > 0, f"task-axis dcd_epoch ({strategy}, cold) "
                  "moved no coordinate")
        errs += case_errs

    def kern():
        return ops.dcd_epoch_tasks(phi, **batch, tasks=ids, bias=1.0)

    def lone_all():
        return [ops.dcd_epoch(**st, bias=1.0) for st in lone]

    t0 = time.perf_counter()
    for t in checked:
        host = {name: v.clone() for name, v in start[t].items()}
        DCD.dcd_epoch_plain(*host.values(), bias=1.0)
    plain_ms = (time.perf_counter() - t0) * 1e3
    before = batch["beta"].clone()
    kern()
    moved = int((batch["beta"] != before).sum())
    m = sum(sizes)
    b_ms, b_by = bound_ms(
        4 * m * k + m * (4 * 7 + 8 + 8 + 1) + 8 * n_tasks * (k + 1)
        + 8 * (n_tasks + 1),
        2 * m * k + 2 * k * moved + 20 * m)
    dev_ms = device_ms(kern, calls=5)
    row = {"name": "dcd_epoch", "task_axis": strategy,
           "shape": [n_tasks, max(sizes), k], "rows_of_phi": int(phi.shape[0]),
           "coordinates": m, "launches_on_path": launches["dcd_epoch"],
           "max_abs_err": max(errs), "ms": median_ms(kern, reps=10),
           "device_ms": dev_ms,
           "ns_per_coord_longest_task": dev_ms * 1e6 / max(sizes),
           "lone_launches_ms": median_ms(lone_all, reps=5),
           "lone_launches_device_ms": device_ms(lone_all, calls=2),
           "plain_ms": plain_ms, "plain_of_tasks": checked,
           "moved_per_epoch": moved, "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": None, **dcd_info(DCD, k)}
    ops.launches.update(saved)
    return row, max(errs)


def dcd_info(DCD, k: int) -> dict:
    """dcd_epoch's launch plan at rank k and what ptxas reported for the
    instantiation it runs (registers, spills, static shared memory)."""
    from repro_torch.kernels import _build
    plan = DCD.dcd_plan(k)
    name = (f"dcd_ring_kernelILi{plan.window}E" if plan.route == "ring"
            else "dcd_direct_kernel")
    found = _build.ptxas_report(name)
    check(len(found) == 1, f"ptxas log: {len(found)} kernels named {name}")
    return {"plan": plan._asdict(), "ptxas": found[0]}


def lm_inputs(dev):
    """Seeded inputs of the two LM-substrate kernels at their model
    shapes: (q, k, v) for phi4_mini_3p8b's attention, a ragged
    non-causal (q, k, v) of 300 positions, and (C, B, x, dt, cs) for
    mamba2_780m's chunk (dt ~ U(1e-3, 0.1), A ~ -U(1, 8), cs the
    in-chunk cumsum of dt A, as tests/test_kernels_pallas.py draws
    them)."""
    rng = np.random.default_rng(SEED)

    def t(shape):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(dev)

    a = PHI4_ATTN
    attn = (t((a["b"], a["s"], a["h"], a["d"])),
            t((a["b"], a["s"], a["hkv"], a["d"])),
            t((a["b"], a["s"], a["hkv"], a["d"])))
    ragged = (t((2, 300, a["h"], a["d"])), t((2, 300, a["hkv"], a["d"])),
              t((2, 300, a["hkv"], a["d"])))
    m = MAMBA2_SSD
    bc, h, q, n, p = m["bc"], m["h"], m["q"], m["n"], m["p"]
    dt = rng.uniform(0.001, 0.1, size=(bc, h, q)).astype(np.float32)
    a_log = -rng.uniform(1, 8, size=(h,)).astype(np.float32)
    cs = np.cumsum(dt * a_log[None, :, None], axis=2).astype(np.float32)
    ssd = (t((bc, q, n)), t((bc, q, n)), t((bc, h, q, p)),
           torch.from_numpy(dt).to(dev), torch.from_numpy(cs).to(dev))
    return attn, ragged, ssd


def phase_lm(ops, FA, SD, dev):
    """The two LM-substrate kernels through their entry points at model
    shapes (the launch counts of this run are the path's; attention in
    float32 and in bfloat16, its bf16 launches counted apart), then each
    against its plain version: float32 operands, and bfloat16 operands
    rounded before both (the kernel's float32 output at the float32
    bound; its bfloat16 output equal to that, rounded once); ssd_diag
    also with decays 40 times as steep."""
    attn, ragged, ssd = lm_inputs(dev)
    attn_bf16 = [t.to(torch.bfloat16) for t in attn]
    errs = {}
    torch.cuda.synchronize()
    ops.reset_launches()
    out = ops.flash_attention(*attn, causal=True)
    out_r = ops.flash_attention(*ragged, causal=False)
    before = ops.launches["flash_attention"]
    out_b = ops.flash_attention(*attn_bf16, causal=True)
    bf16_launches = ops.launches["flash_attention"] - before
    y = ops.ssd_diag(*ssd)
    # the gradient at phi4's shape through the autograd Function, float32
    # and bf16 operands: the forward (with lse) and flash_attention_bwd
    do = torch.randn(attn[0].shape, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(SEED))
    bwd = {}
    for dt in (torch.float32, torch.bfloat16):
        leaves = [t.detach().to(dt).requires_grad_() for t in attn]
        before = dict(ops.launches)
        grads = torch.autograd.grad(ops.flash_attention(*leaves, causal=True),
                                    leaves, do.to(dt))
        bwd[dt] = (leaves, grads, ops.launches["flash_attention_bwd"]
                   - before["flash_attention_bwd"])
        if dt == torch.bfloat16:
            bf16_launches += (ops.launches["flash_attention"]
                              - before["flash_attention"])
    torch.cuda.synchronize()
    launches = dict(ops.launches)
    bwd_launches = {dt: n for dt, (_, _, n) in bwd.items()}
    for dt, (leaves, grads, _) in bwd.items():
        qkv = [t.detach() for t in leaves]
        o, lse = ops.flash_attention_lse(*qkv, causal=True)
        want = FA.flash_attention_bwd_plain(*qkv, o, lse, do.to(dt),
                                            causal=True)
        rel = [rel_err(g_, w_) for g_, w_ in zip(grads, want)]
        ok = max(rel) <= BWD_TOL[dt] and all(
            bool(torch.isfinite(g_).all()) for g_ in grads)
        emit(phase="parity", kernel="flash_attention_bwd",
             case="phi4_causal", dtype=str(dt).split(".")[1],
             shape=list(qkv[0].shape), kv_heads=int(qkv[1].shape[2]),
             rel_err_dq_dk_dv=rel, bound=BWD_TOL[dt], ok=ok)
        check(ok, f"flash_attention_bwd phi4 {dt} disagrees with its plain "
              "version")
        errs["flash_attention_bwd" if dt == torch.float32
             else "flash_attention_bwd_bf16"] = max(rel)
        del want, grads
    del bwd
    check(bool(torch.isfinite(out).all() and torch.isfinite(out_r).all()
               and torch.isfinite(out_b).all()
               and torch.isfinite(y).all()), "LM kernels gave non-finite "
          "values")
    for name, args, causal in (("phi4_causal", attn, True),
                               ("ragged_300_noncausal", ragged, False)):
        for dt in (torch.float32, torch.bfloat16):
            qkv = [v.to(dt) for v in args]
            got = ops.flash_attention(*qkv, causal=causal,
                                      out_dtype=torch.float32)
            want = FA.flash_attention_plain(*qkv, causal=causal,
                                            out_dtype=torch.float32)
            ok = bool(torch.allclose(got, want, **LM_TOL))
            rounded = bool(torch.equal(ops.flash_attention(
                *qkv, causal=causal), got.to(dt)))
            emit(phase="parity", kernel="flash_attention", case=name,
                 dtype=str(dt).split(".")[1], shape=list(qkv[0].shape),
                 kv_heads=int(qkv[1].shape[2]), causal=causal,
                 max_abs_err=max_err(got, want), bound=LM_TOL, ok=ok,
                 out_in_operand_dtype_equals_rounded_fp32=rounded)
            check(ok and rounded, f"flash_attention {name} {dt} disagrees "
                  "with its plain version")
            if causal:
                errs["flash_attention" if dt == torch.float32
                     else "flash_attention_bf16"] = max_err(got, want)
    cmat, bmat, x, dt_, cs = ssd
    for case, c in (("mamba2", cs), ("steep_decay_x40", cs * 40.0)):
        got = y if case == "mamba2" else ops.ssd_diag(cmat, bmat, x, dt_, c)
        want = SD.ssd_diag_plain(cmat, bmat, x, dt_, c)
        finite = bool(torch.isfinite(got).all())
        ok = bool(torch.allclose(got, want, **LM_TOL))
        emit(phase="parity", kernel="ssd_diag", case=case,
             shape=list(x.shape), n_state=int(cmat.shape[2]),
             max_abs_err=max_err(got, want), bound=LM_TOL, ok=ok,
             finite=finite)
        check(ok and finite, f"ssd_diag {case} disagrees with its plain "
              "version")
        errs["ssd_diag"] = max(errs.get("ssd_diag", 0.0), max_err(got, want))
    ops.launches.update(launches)
    return launches, errs, bf16_launches, bwd_launches


# the LM serving path at zamba2_1p2b's full width and depth (the
# reference's src/repro/configs/zamba2_1p2b.py): 4 prompts of 2,048
# tokens (8 chunks of 256) from data.lm.token_batches, then 32 greedy
# decode steps into caches of 2,080 positions
LM_SERVE = dict(config="zamba2_1p2b", batch=4, prompt=2048, decode=32)
# logits against logits, as a fraction of the second's largest
# magnitude over the real vocab. A prefill with the two kernels against
# the same weights' prefill with their plain versions, and decode against
# a teacher-forced forward: at LM_SHALLOW_LAYERS layers of the full width
# within LM_LOGIT_TOL (tests/test_torch_lm_model_*.py hold the port to
# the reference at this bound); at the full 38 layers within LM_DEEP_TOL
# with LM_DEEP_AGREE of the greedy tokens equal. Through 38 random-init
# layers a float32 round-off in either kernel's output flips bf16
# roundings downstream: evaluating the two functions exactly (float64)
# moves the logits by ~3 % of their largest magnitude against the
# float32 plain versions (reported beside the check as
# ``float64_vs_plain``). LM_DEEP_TOL and LM_DEEP_AGREE are the bounds of
# the reference's test_decode_matches_teacher_forced_forward (atol 0.15
# on logits of largest magnitude ~1 at its reduced sizes, of which a
# tenth of the largest magnitude is the tighter reading; >= 80 % of the
# greedy tokens equal).
LM_LOGIT_TOL = 3e-2
LM_SHALLOW_LAYERS = 6
LM_DEEP_TOL = 0.1
LM_DEEP_AGREE = 0.8


def logits_agreement(got: torch.Tensor, want: torch.Tensor, vocab: int,
                     bound: float) -> dict:
    """max |got - want| over the real vocab against ``bound`` times
    want's largest magnitude; greedy tokens equal overall, and where
    want's top-2 margin exceeds twice the bound (where they must)."""
    g, w = got[..., :vocab].float(), want[..., :vocab].float()
    scale = float(w.abs().max())
    err = float((g - w).abs().max())
    top2 = w.topk(2, dim=-1).values
    sure = (top2[..., 0] - top2[..., 1]) > 2 * bound * scale
    same = g.argmax(-1) == w.argmax(-1)
    return {"max_abs_err": err, "scale": scale,
            "rel_err": err / scale if scale else None,
            "bound": bound, "greedy_agree": float(same.float().mean()),
            "sure_positions": int(sure.sum()),
            "sure_agree": bool(same[sure].all()),
            "ok": bool(err <= bound * scale and same[sure].all())}


class PlainFlash(torch.autograd.Function):
    """``flash_attention`` by its plain versions both ways, on any
    device: the forward, each row's log-sum-exp, and the explicit
    backward formulas (what ``ops.FlashAttention`` runs on CPU
    tensors). Autograd through the plain forward instead would take the
    gradient of its softmax, not the backward kernel's function."""

    @staticmethod
    def forward(ctx, q, k, v, causal, out_dtype):
        from repro_torch.kernels import flash_attn as FA
        o = FA.flash_attention_plain(q, k, v, causal=causal,
                                     out_dtype=out_dtype)
        ctx.save_for_backward(q, k, v, o,
                              FA.attention_lse_plain(q, k, causal=causal))
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        from repro_torch.kernels import flash_attn as FA
        q, k, v, o, lse = ctx.saved_tensors
        return (*FA.flash_attention_bwd_plain(q, k, v, o, lse, do.to(o.dtype),
                                              causal=ctx.causal), None, None)


class PlainSsd(torch.autograd.Function):
    """``ssd_diag`` by its plain versions both ways. Autograd through
    ``ssd_diag_plain`` would give NaN at the model's decays: above the
    diagonal exp(cs_q - cs_k) overflows, and ``where``'s gradient
    multiplies that inf by 0 (the reference's ``ssd_chunked`` forms L
    the same way); the backward formulas never take that exp."""

    @staticmethod
    def forward(ctx, cmat, bmat, x, dt, cs):
        from repro_torch.kernels import ssd_diag as SD
        ctx.save_for_backward(cmat, bmat, x, dt, cs)
        return SD.ssd_diag_plain(cmat, bmat, x, dt, cs)

    @staticmethod
    def backward(ctx, dy):
        from repro_torch.kernels import ssd_diag as SD
        return SD.ssd_diag_bwd_plain(*ctx.saved_tensors, dy)


def plain_lm_kernels(ops, exact: bool = False):
    """Swap the two kernels' wrappers for their plain versions both ways
    (``PlainFlash``, ``PlainSsd``; restored by calling the result): the
    same function, no launch; with ``exact``, evaluated in float64 and
    rounded to the wrappers' output dtypes."""
    real = ops.flash_attention, ops.ssd_diag
    wide = (lambda t: t.double()) if exact else (lambda t: t)

    def flash(q, k, v, *, causal=True, out_dtype=None):
        out = out_dtype or q.dtype
        return PlainFlash.apply(wide(q), wide(k), wide(v), causal,
                                torch.float64 if exact else out).to(out)

    def ssd(cmat, bmat, x, dt, cs):
        return PlainSsd.apply(*(wide(t.to(torch.float32))
                                for t in (cmat, bmat, x, dt, cs))).to(
            torch.float32)
    ops.flash_attention, ops.ssd_diag = flash, ssd

    def restore():
        ops.flash_attention, ops.ssd_diag = real
    return restore


def first_operands(ops):
    """Record the first operands each kernel wrapper is called with
    (restored by calling the result's second item)."""
    real = ops.flash_attention, ops.ssd_diag
    seen = {}

    def flash(q, k, v, **kw):
        seen.setdefault("flash_attention", (q, k, v, kw))
        return real[0](q, k, v, **kw)

    def ssd(*args):
        seen.setdefault("ssd_diag", args)
        return real[1](*args)
    ops.flash_attention, ops.ssd_diag = flash, ssd

    def restore():
        ops.flash_attention, ops.ssd_diag = real
    return seen, restore


def lm_counts(ops) -> dict:
    return {k: ops.launches[k] for k in ("flash_attention", "ssd_diag")}


def serve_and_force(ops, model, cfg, prompt, n_dec, dev, profile_step=None):
    """The serving path on ``prompt`` (B, S): prefill into caches of S +
    n_dec positions and n_dec greedy decode steps, then the teacher-forced
    forward over the S + n_dec tokens (padded to the SSD chunk with
    tokens after the last compared position, which a causal model does
    not see). Returns the prefill and decode logits (B, n_dec + 1, V),
    the forward's at the same positions, the kernel launches of a
    prefill, of the decode steps and of the forward, each decode step's
    host ms (the ``profile_step``-th, under the profiler, left out) and
    that step's device kernels."""
    from torch.profiler import ProfilerActivity, profile
    b, s = prompt.shape
    ops.reset_launches()
    caches = model.cache_init(b, s + n_dec)
    logits, caches = model.prefill({"tokens": prompt}, caches)
    torch.cuda.synchronize()
    per_prefill = lm_counts(ops)
    steps, step_ms, step_kernels = [logits], [], None
    for i in range(n_dec):
        tok = steps[-1].argmax(-1)
        check(int(tok.max()) < cfg.vocab_size,
              "lm_serve: a greedy token in the padded vocab")
        t1 = time.perf_counter()
        if i == profile_step:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                logits, caches = model.decode_step(tok, caches)
                torch.cuda.synchronize()
            step_kernels = sum(
                e.count for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA)
        else:
            logits, caches = model.decode_step(tok, caches)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t1) * 1e3)
        steps.append(logits)
    check(model._cache_len(caches) == s + n_dec, "lm_serve: cache length")
    decode = {k: ops.launches[k] - per_prefill[k] for k in per_prefill}
    fed = torch.stack([st.argmax(-1) for st in steps[:-1]], 1)
    total = -(-(s + n_dec) // cfg.ssm_chunk) * cfg.ssm_chunk
    pad = torch.zeros((b, total - s - n_dec), dtype=torch.long, device=dev)
    before = lm_counts(ops)
    with torch.inference_mode():   # the forward is trainable: no graph here
        fwd, _ = model.forward({"tokens": torch.cat([prompt, fed, pad], 1)})
    torch.cuda.synchronize()
    per_forward = {k: ops.launches[k] - before[k] for k in before}
    forced = fwd[:, s - 1:s + n_dec].clone()
    return (torch.stack(steps, 1), forced, per_prefill, decode, per_forward,
            step_ms, step_kernels)


def phase_lm_serve(ops, FA, SD, dev):
    """zamba2_1p2b served through the port's entry points: ``Model``,
    ``init`` from a seeded generator, ``cache_init``, ``prefill``,
    ``decode_step`` and a teacher-forced ``forward``. Checks: 7
    ``flash_attention`` and 38 ``ssd_diag`` launches a prefill and a
    forward, none a decode step; the prefill logits against the same
    weights' prefill with the plain versions in place of the two
    kernels, and the decode logits against the teacher-forced forward,
    within LM_DEEP_TOL (LM_DEEP_AGREE of the greedy tokens equal); both
    again at LM_SHALLOW_LAYERS layers of the full width, within
    LM_LOGIT_TOL. Returns the path's launches and the kernels' recorded
    operands."""
    from repro_torch.configs import get_config
    from repro_torch.data.lm import token_batches
    from repro_torch.models import Model
    from torch.profiler import ProfilerActivity, profile
    cfg = get_config(LM_SERVE["config"])
    b, s, n_dec = LM_SERVE["batch"], LM_SERVE["prompt"], LM_SERVE["decode"]
    n_attn = -(-cfg.n_layers // cfg.shared_attn_every)
    t0 = time.perf_counter()
    model = Model(cfg, device=dev)
    model.init(torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    prompt = torch.from_numpy(next(token_batches(
        vocab_size=cfg.vocab_size, batch=b, seq_len=s, n_batches=1,
        seed=SEED))["tokens"]).to(dev).long()

    def prefill(m=None):
        m = m or model
        return m.prefill({"tokens": prompt}, m.cache_init(b, s + n_dec))[0]

    def prefill_with(m, exact=False):
        restore = plain_lm_kernels(ops, exact=exact)
        try:
            return prefill(m)
        finally:
            restore()

    # ---- the path: prefill, 32 greedy decode steps, teacher forcing
    torch.cuda.synchronize()
    seen, restore = first_operands(ops)
    try:
        (steps, forced, per_prefill, decode_launches, per_forward, step_ms,
         step_kernels) = serve_and_force(ops, model, cfg, prompt, n_dec, dev,
                                         profile_step=n_dec // 2)
    finally:
        restore()
    path = dict(ops.launches)
    check(per_prefill == {"flash_attention": n_attn,
                          "ssd_diag": cfg.n_layers},
          f"lm_serve: a prefill launched {per_prefill}, not {n_attn} "
          f"flash_attention and {cfg.n_layers} ssd_diag")
    check(per_forward == per_prefill,
          f"lm_serve: the forward launched {per_forward}")
    check(not any(decode_launches.values()),
          f"lm_serve: decode steps launched {decode_launches}")
    deep = {"decode_vs_forward": logits_agreement(
        steps, forced, cfg.vocab_size, LM_DEEP_TOL)}

    # ---- the same weights' prefill with the plain versions (and exact)
    plain_logits = prefill_with(model)
    deep["kernels_vs_plain"] = logits_agreement(
        steps[:, 0], plain_logits, cfg.vocab_size, LM_DEEP_TOL)
    deep["float64_vs_plain"] = logits_agreement(
        prefill_with(model, exact=True), plain_logits, cfg.vocab_size,
        LM_DEEP_TOL)
    for name in ("decode_vs_forward", "kernels_vs_plain"):
        check(deep[name]["ok"] and deep[name]["greedy_agree"]
              >= LM_DEEP_AGREE, f"lm_serve: {name} at full depth: "
              f"{deep[name]}")
    del steps, forced, plain_logits

    # ---- timings (their launches do not count)
    def timed_prefill():
        caches = model.cache_init(b, s + n_dec)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t1 = time.perf_counter()
        start.record()
        model.prefill({"tokens": prompt}, caches)
        end.record()
        end.synchronize()
        return (time.perf_counter() - t1) * 1e3, start.elapsed_time(end)
    runs = [timed_prefill() for _ in range(4)][1:]
    prefill_ms = statistics.median(r[0] for r in runs)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prefill()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kernels)
    mine = {name: sum(e.self_device_time_total for e in kernels
                      if name in e.key)
            for name in ("flash_kernel", "ssd_diag_kernel")}
    del model
    torch.cuda.empty_cache()

    # ---- decode against teacher forcing at a cut depth, same width
    shallow_cfg = dataclasses.replace(cfg, n_layers=LM_SHALLOW_LAYERS)
    shallow = Model(shallow_cfg, device=dev)
    shallow.init(torch.Generator(device=dev).manual_seed(SEED))
    steps, forced, *_ = serve_and_force(ops, shallow, shallow_cfg, prompt,
                                        n_dec, dev)
    cut = {"layers": LM_SHALLOW_LAYERS,
           "decode_vs_forward": logits_agreement(
               steps, forced, cfg.vocab_size, LM_LOGIT_TOL),
           "kernels_vs_plain": logits_agreement(
               steps[:, 0], prefill_with(shallow), cfg.vocab_size,
               LM_LOGIT_TOL)}
    for name in ("decode_vs_forward", "kernels_vs_plain"):
        check(cut[name]["ok"], f"lm_serve: {name} at {LM_SHALLOW_LAYERS} "
              f"layers: {cut[name]}")
    del shallow, steps, forced
    torch.cuda.empty_cache()
    ops.launches.update(path)
    emit(phase="lm_serve", config=cfg.name, params=n_params,
         param_count=cfg.param_count(), init_s=init_s, batch=b, prompt=s,
         decode_steps=n_dec, prefill_launches=per_prefill,
         forward_launches=per_forward, decode_launches=decode_launches,
         full_depth=dict(deep, greedy_agree_bound=LM_DEEP_AGREE),
         cut_depth=cut,
         prefill_ms=prefill_ms,
         prefill_device_ms=statistics.median(r[1] for r in runs),
         prefill_tokens_per_s=b * s / prefill_ms * 1e3,
         decode_ms_per_step=statistics.median(step_ms),
         decode_tokens_per_s=b / statistics.median(step_ms) * 1e3,
         device_kernels_per_decode_step=step_kernels,
         profiled_prefill={
             "device_ms": dev_us / 1e3, "device_kernels": sum(
                 e.count for e in kernels),
             "flash_kernel_ms": mine["flash_kernel"] / 1e3,
             "ssd_diag_kernel_ms": mine["ssd_diag_kernel"] / 1e3,
             "kernels_share": (sum(mine.values()) / dev_us if dev_us
                               else None),
             "top": [[e.key[:60], e.count, e.self_device_time_total / 1e3]
                     for e in sorted(kernels, key=lambda e:
                                     -e.self_device_time_total)[:10]]},
         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    return path, seen


def lm_serve_rows(ops, FA, SD, dev, launches, seen):
    """The two kernels at the operands the zamba2 prefill gave them
    (its first attention and SSD calls): each against its plain version
    (flash in float32 out at LM_TOL, its bf16 out the float32 one rounded
    once; ssd_diag at LM_TOL), timed beside its bound and, for
    attention, SDPA."""
    q, k, v, _ = seen["flash_attention"]
    b, s, h, d = q.shape
    hkv = k.shape[2]
    got = ops.flash_attention(q, k, v, causal=True, out_dtype=torch.float32)
    want = FA.flash_attention_plain(q, k, v, causal=True,
                                    out_dtype=torch.float32)
    ok = bool(torch.allclose(got, want, **LM_TOL))
    rounded = bool(torch.equal(ops.flash_attention(q, k, v, causal=True),
                               got.to(q.dtype)))
    fa_err = max_err(got, want)
    emit(phase="parity", kernel="flash_attention", case="zamba2_prefill",
         dtype="bfloat16", shape=list(q.shape), kv_heads=hkv, causal=True,
         max_abs_err=fa_err, bound=LM_TOL, ok=ok,
         out_in_operand_dtype_equals_rounded_fp32=rounded)
    check(ok and rounded, "flash_attention at zamba2's prefill disagrees "
          "with its plain version")
    cmat, bmat, x, dt, cs = seen["ssd_diag"]
    y = ops.ssd_diag(cmat, bmat, x, dt, cs)
    y_want = SD.ssd_diag_plain(cmat, bmat, x, dt, cs)
    ok = bool(torch.allclose(y, y_want, **LM_TOL)) and bool(
        torch.isfinite(y).all())
    sd_err = max_err(y, y_want)
    emit(phase="parity", kernel="ssd_diag", case="zamba2_prefill",
         shape=list(x.shape), n_state=int(cmat.shape[2]),
         max_abs_err=sd_err, bound=LM_TOL, ok=ok)
    check(ok, "ssd_diag at zamba2's prefill disagrees with its plain "
          "version")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    pairs = b * h * s * (s + 1) // 2
    flops = 4.0 * pairs * d
    n_bytes = 2 * (2 * b * s * h * d + 2 * b * s * hkv * d)
    rows = [time_row(
        ops, "flash_attention_bf16_zamba2", "flash_attn.cu",
        "src/repro/kernels/flash_attn.py:83",
        lambda: ops.flash_attention(q, k, v, causal=True),
        lambda: FA.flash_attention_plain(q, k, v, causal=True,
                                         out_dtype=q.dtype),
        lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True),
        n_bytes, flops, launches["flash_attention"], fa_err,
        bounds=lm_bounds(n_bytes, flops, BF16_FLOP_PER_S, flops, pairs,
                         route_passes=1.5))]
    rows[-1].update(dtype="bfloat16", path="lm_serve",
                    **redesign_info("flash_attention",
                                    (b, s, h, d, q.dtype)))
    bc, q_len, n = cmat.shape
    hs, p = x.shape[1], x.shape[3]
    tri = q_len * (q_len + 1) // 2
    ssd_bytes = 4 * (2 * bc * q_len * n + 2 * bc * hs * q_len * (p + 1))
    ssd_flops = 2.0 * bc * tri * n + 2.0 * bc * hs * tri * p
    fp32_ops = bc * tri * 2 * n + bc * hs * tri * (3 + 2 * p)
    rows.append(time_row(
        ops, "ssd_diag_zamba2", "ssd_diag.cu",
        "src/repro/kernels/ssd_diag.py:51",
        lambda: ops.ssd_diag(cmat, bmat, x, dt, cs),
        lambda: SD.ssd_diag_plain(cmat, bmat, x, dt, cs), None,
        ssd_bytes, fp32_ops, launches["ssd_diag"], sd_err,
        bounds=lm_bounds(ssd_bytes, 3 * ssd_flops, TF32_FLOP_PER_S,
                         fp32_ops, bc * hs * tri)))
    rows[-1].update(path="lm_serve",
                    **redesign_info("ssd_diag", (bc, hs, q_len, n, p)))
    return rows


# the LM training path at zamba2_1p2b's full width and depth: 2 x 2,048
# tokens a step from data.lm.token_batches (seed 1), AdamW(lr=3e-4), 2
# warm steps and 6 timed ones through training.train.make_train_step
LM_TRAIN = dict(config="zamba2_1p2b", batch=2, seq=2048, warm=2, timed=6,
                lr=3e-4)
PROFILED_STEPS = 3
# the backward kernels against their plain versions at the model's
# operands, as a fraction of the plain gradient's largest magnitude:
# float32 operands 1e-4 (3xTF32 products, sums in another order); bf16
# operands 1e-2 (S and dP exact bf16 products summed in float32; P and dS
# formed in float32 and split into a bf16 high part and the bf16 rounding
# of the rest for the products they feed, ~16 bits of each kept, the
# gradient rounded once to bf16, one unit of 2^-8)
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
SSD_BWD_TOL = 1e-4
# the whole model's gradient with the kernels against the same weights'
# with the plain versions swapped in, at LM_SHALLOW_LAYERS layers of the
# full width: each tensor within LM_TRAIN_GRAD_TOL of the plain run's
# largest gradient magnitude, the whole gradient's cosine at least
# LM_TRAIN_COSINE. Each tensor's distance as a fraction of its own
# largest magnitude is reported beside the same distance of a float64
# evaluation of the two functions: through bf16 activations a float32
# round-off moves a gradient that sums cancelling terms over every
# position (a Mamba2 convolution's, a per-head vector's) by ~5 % of
# itself (on an NVIDIA H100 80GB HBM3 at 700 W: float64 against float32
# plain 4.7 %, kernels against plain 6.0 %, both at a conv_C).
LM_TRAIN_GRAD_TOL = 5e-2
LM_TRAIN_COSINE = 0.99
LM_TRAIN_KERNELS = ("flash_attention", "ssd_diag", "flash_attention_bwd",
                    "ssd_diag_bwd")
# device kernels of one backward call of each entry (the ptxas names; dK /
# dV and dQ are templated on the staged type and width, the SSD backward
# is its walk and its dC / dB launch)
BWD_DEVICE_KERNELS = {"flash_attention_bwd": ("flash_bwd_delta_kernel",
                                              "flash_bwd_kv_kernel",
                                              "flash_bwd_q_kernel"),
                      "ssd_diag_bwd": ("ssd_bwd_kernel",
                                       "ssd_bwd_dcdb_kernel")}


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over want's largest magnitude."""
    scale = float(want.float().abs().max())
    err = float((got.float() - want.float()).abs().max())
    return err / scale if scale else err


def captured_operands(ops):
    """Record the first operands of each LM kernel wrapper and, through a
    hook on its output, the gradient the backward hands it (restored by
    calling the result's second item)."""
    real = ops.flash_attention, ops.ssd_diag
    seen = {}

    def flash(q, k, v, **kw):
        out = real[0](q, k, v, **kw)
        if "flash_attention" not in seen and out.requires_grad:
            seen["flash_attention"] = (q.detach(), k.detach(), v.detach(),
                                       kw)
            out.register_hook(lambda g: seen.setdefault("flash_do", g))
        return out

    def ssd(*args):
        out = real[1](*args)
        if "ssd_diag" not in seen and out.requires_grad:
            seen["ssd_diag"] = tuple(a.detach() for a in args)
            out.register_hook(lambda g: seen.setdefault("ssd_dy", g))
        return out
    ops.flash_attention, ops.ssd_diag = flash, ssd

    def restore():
        ops.flash_attention, ops.ssd_diag = real
    return seen, restore


def train_batches(cfg, b: int, s: int, n: int, dev) -> list:
    from repro_torch.data.lm import token_batches
    return [{k: torch.from_numpy(v).to(dev).long() for k, v in nb.items()}
            for nb in token_batches(vocab_size=cfg.vocab_size, batch=b,
                                    seq_len=s, n_batches=n, seed=1)]


def model_grads(model, batch) -> tuple[float, dict]:
    """The loss and every parameter's gradient through the train step's
    loss (``make_loss_fn``), by name."""
    from repro_torch.training.train import make_loss_fn
    total, _ = make_loss_fn(model)(batch)
    named = dict(model.named_parameters())
    got = torch.autograd.grad(total, list(named.values()), allow_unused=True)
    return float(total.detach()), {
        k: (g if g is not None else torch.zeros_like(p))
        for (k, p), g in zip(named.items(), got)}


def grads_agreement(got: dict, want: dict) -> dict:
    """Per tensor max |got - want| against LM_TRAIN_GRAD_TOL of want's
    largest magnitude over all tensors (NaN fails); the worst tensor as
    a fraction of its own largest magnitude; the whole gradient's
    cosine."""
    scale = max(float(w.float().abs().max()) for w in want.values())
    worst, fails, own = 0.0, [], {}
    for name, w in want.items():
        err = float((got[name].float() - w.float()).abs().max())
        if not err <= LM_TRAIN_GRAD_TOL * scale:
            fails.append([name, err])
        worst = max(worst, err)
        own[name] = rel_err(got[name], w)
    own_worst = max(own, key=lambda k: own[k])
    flat_g = torch.cat([got[k].float().flatten() for k in want])
    flat_w = torch.cat([want[k].float().flatten() for k in want])
    cos = float(torch.nn.functional.cosine_similarity(flat_g, flat_w, dim=0))
    return {"max_abs_err": worst, "scale": scale,
            "rel_err": worst / scale, "bound": LM_TRAIN_GRAD_TOL,
            "worst_own_rel_err": own[own_worst],
            "worst_own_tensor": own_worst, "cosine": cos,
            "cosine_bound": LM_TRAIN_COSINE, "failures": fails[:5],
            "ok": not fails and cos >= LM_TRAIN_COSINE}


def profiled_lm_kernels(prof) -> dict:
    """The device time of a profiled region, its device kernels, and by
    LM entry (forward and backward) the device ms and the launches of
    its first device kernel, with the top kernels by device time."""
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "spin" not in e.key.lower()]    # spin_pad's kernels
    total = sum(e.self_device_time_total for e in kernels) / 1e3
    names = {"flash_attention": ("flash_kernel",),
             "ssd_diag": ("ssd_diag_kernel",), **BWD_DEVICE_KERNELS}
    ms = {k: sum(e.self_device_time_total for e in kernels
                 if any(n in e.key for n in ns)) / 1e3
          for k, ns in names.items()}
    launches = {k: sum(e.count for e in kernels if ns[0] in e.key)
                for k, ns in names.items()}
    return {"device_ms": total,
            "device_kernels": sum(e.count for e in kernels),
            "kernel_ms": ms, "kernel_launches": launches,
            "kernels_share": {k: v / total if total else None
                              for k, v in ms.items()},
            "top": [[e.key[:60], e.count, e.self_device_time_total / 1e3]
                    for e in sorted(kernels, key=lambda e:
                                    -e.self_device_time_total)[:12]]}


def phase_lm_train(ops, FA, SD, dev):
    """zamba2_1p2b trained through the port's entry points: ``Model``,
    ``init`` from a seeded generator, ``optim.adamw.AdamW``,
    ``training.train.make_train_step``. Checks: every loss finite and the
    mean of the last two below the first; each step launches 7
    ``flash_attention`` and 38 ``ssd_diag`` forward and as many
    backward kernels (the wrappers' counts, and the profiler's over one
    step); the backward kernels against their plain versions at the
    operands of the model's first attention and SSD calls with the dY
    of the real backward (bf16 and float32 attention operands); the
    whole model's gradient at LM_SHALLOW_LAYERS layers against the plain
    versions swapped in. Returns the path's launches and the operands."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.optim.adamw import AdamW
    from repro_torch.training.train import make_train_step
    from torch.profiler import ProfilerActivity, profile
    t = LM_TRAIN
    cfg = get_config(t["config"])
    b, s = t["batch"], t["seq"]
    n_attn = -(-cfg.n_layers // cfg.shared_attn_every)
    want_step = {"flash_attention": n_attn, "ssd_diag": cfg.n_layers,
                 "flash_attention_bwd": n_attn, "ssd_diag_bwd": cfg.n_layers}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED))
    opt = AdamW(lr=t["lr"])
    state = opt.init(params)
    step = make_train_step(model, opt)
    batches = train_batches(cfg, b, s,
                            t["warm"] + t["timed"] + PROFILED_STEPS, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    # ---- the path: 2 warm and 6 timed steps
    losses, step_ms, per_step = [], [], []
    ops.reset_launches()
    seen, restore = captured_operands(ops)
    try:
        for i in range(t["warm"] + t["timed"]):
            before = {k: ops.launches[k] for k in LM_TRAIN_KERNELS}
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            params, state, metrics = step(params, state, batches[i])
            torch.cuda.synchronize()
            if i >= t["warm"]:
                step_ms.append((time.perf_counter() - t1) * 1e3)
            losses.append(float(metrics["loss"]))
            per_step.append({k: ops.launches[k] - before[k]
                             for k in LM_TRAIN_KERNELS})
    finally:
        restore()
    path = dict(ops.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(all(np.isfinite(losses)), f"lm_train: losses {losses}")
    check(np.mean(losses[-2:]) < losses[0],
          f"lm_train: the loss did not fall: {losses}")
    check(all(c == want_step for c in per_step),
          f"lm_train: steps launched {per_step}, not {want_step}")

    # ---- steps under the profiler (their launches do not count). Late in
    # a long process the profiler drops kernel records (``kernels_per_call``
    # meets the same; it dropped the step's first flash_attention record
    # in three steps running without the spin pads), so each step between
    # spin pads, and up to three profiled steps, each kernel's count the
    # most one of them saw
    counted = {}
    for i in range(PROFILED_STEPS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            spin_pad()
            torch.cuda.synchronize()
            params, state, metrics = step(params, state,
                                          batches[t["warm"] + t["timed"] + i])
            spin_pad()
            torch.cuda.synchronize()
        profiled = profiled_lm_kernels(prof)
        counted = {k: max(counted.get(k, 0), n)
                   for k, n in profiled["kernel_launches"].items()}
        if counted == want_step:
            break
    profiled.update(profiled_steps=i + 1, kernel_launches_most=counted)
    check(counted == want_step,
          f"lm_train: the profiler counted {counted} a step, not "
          f"{want_step}")
    del model, params, state, opt, step, batches, metrics, prof
    torch.cuda.empty_cache()

    # ---- the backward kernels at the model's operands, dY of the real
    # backward: bf16 attention as the model runs it, and float32
    q, k, v, kw = seen["flash_attention"]
    do = seen["flash_do"]
    attn = {}
    for dt in (torch.bfloat16, torch.float32):
        qq, kk, vv, dd = (x.to(dt).contiguous() for x in (q, k, v, do))
        o, lse = ops.flash_attention_lse(qq, kk, vv,
                                         causal=kw["causal"])
        got = ops.flash_attention_bwd(qq, kk, vv, o, lse, dd,
                                      causal=kw["causal"])
        want = FA.flash_attention_bwd_plain(qq, kk, vv, o, lse, dd,
                                            causal=kw["causal"])
        errs = [rel_err(g_, w_) for g_, w_ in zip(got, want)]
        again = ops.flash_attention_bwd(qq, kk, vv, o, lse, dd,
                                        causal=kw["causal"])
        attn[str(dt).split(".")[1]] = {
            "rel_err_dq_dk_dv": errs, "bound": BWD_TOL[dt],
            "equal_bits_twice": all(torch.equal(x_, y_)
                                    for x_, y_ in zip(got, again))}
        check(max(errs) <= BWD_TOL[dt] and attn[str(dt).split(".")[1]][
            "equal_bits_twice"], f"flash_attention_bwd {dt} at zamba2's "
              f"operands: {attn}")
        del got, want, again
    ssd_ops, dy = seen["ssd_diag"], seen["ssd_dy"]
    got = ops.ssd_diag_bwd(*ssd_ops, dy)
    want = SD.ssd_diag_bwd_plain(*ssd_ops, dy)
    again = ops.ssd_diag_bwd(*ssd_ops, dy)
    ssd_errs = [rel_err(g_, w_) for g_, w_ in zip(got, want)]
    ssd_bits = all(torch.equal(x_, y_) for x_, y_ in zip(got, again))
    check(max(ssd_errs) <= SSD_BWD_TOL and ssd_bits,
          f"ssd_diag_bwd at zamba2's operands: {ssd_errs}, equal bits "
          f"{ssd_bits}")
    del got, want, again
    torch.cuda.empty_cache()

    # ---- the whole gradient at LM_SHALLOW_LAYERS layers, full width
    shallow_cfg = dataclasses.replace(cfg, n_layers=LM_SHALLOW_LAYERS)
    shallow = Model(shallow_cfg, device=dev)
    shallow.init(torch.Generator(device=dev).manual_seed(SEED))
    batch = train_batches(cfg, b, s, 1, dev)[0]
    loss_k, g_k = model_grads(shallow, batch)
    losses_p, g_p = {}, {}
    for exact in (False, True):
        restore = plain_lm_kernels(ops, exact=exact)
        try:
            losses_p[exact], g_p[exact] = model_grads(shallow, batch)
        finally:
            restore()
    cut = {"layers": LM_SHALLOW_LAYERS, "loss": loss_k,
           "plain_loss": losses_p[False], "float64_loss": losses_p[True],
           "kernels_vs_plain": grads_agreement(g_k, g_p[False]),
           "float64_vs_plain": grads_agreement(g_p[True], g_p[False])}
    del shallow, g_k, g_p, batch
    torch.cuda.empty_cache()

    ms = statistics.median(step_ms)
    emit(phase="lm_train", config=cfg.name, batch=b, seq=s,
         tokens_per_step=b * s, lr=t["lr"], remat=False, init_s=init_s,
         losses=losses, step_ms=ms, step_ms_all=step_ms,
         tokens_per_s=b * s / ms * 1e3, peak_memory_gb=peak_gb,
         launches_per_step=per_step[-1],
         profiled_step=profiled,
         backward_parity={"flash_attention_bwd": attn,
                          "ssd_diag_bwd": {"rel_err_dc_db_dx_ddt_dcs":
                                           ssd_errs, "bound": SSD_BWD_TOL,
                                           "equal_bits_twice": ssd_bits}},
         cut_depth_gradient=cut)
    check(cut["kernels_vs_plain"]["ok"]
          and abs(loss_k - losses_p[False]) <= 1e-3 * abs(losses_p[False]),
          f"lm_train: the gradient at {LM_SHALLOW_LAYERS} layers: {cut}")
    ops.launches.update(path)
    return path, seen, {"losses": losses, "step_ms": ms,
                        "device_ms": profiled["device_ms"],
                        "step_ms_all": step_ms, "peak_memory_gb": peak_gb}


LM_SHARDED = dict(mesh=(1, 1), warm=2, timed=2)
# the sharded step's losses against lm_train's (same weights, batches and
# order of operations on one rank): relative bound
LM_SHARDED_LOSS_RTOL = 1e-5
LM_DRYRUN = ("zamba2_1p2b", "train_4k")
LM_DRYRUN_RATIO = (1.0, 3.0)     # per-rank FLOPs x ranks over 6·N·D
LM_DRYRUN_TIMEOUT_S = 900


def start_host_job(argv: list):
    """``argv`` as a subprocess on the host (no card, one CPU thread:
    the card's phases are host-bound), its output in files (nothing
    reads it until its phase), killed at exit if the run ends before it
    is read."""
    import atexit
    import tempfile
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    proc = subprocess.Popen([sys.executable, *argv], cwd=HERE, env=env,
                            stdout=out, stderr=err, text=True)
    proc.files = out, err
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc


def start_dryrun():
    """The dry run of LM_DRYRUN as a subprocess on the host."""
    return start_host_job(["-m", "repro_torch.launch.dryrun", "--arch",
                           LM_DRYRUN[0], "--shape", LM_DRYRUN[1]])


def finish_host_job(proc, name: str, timeout: float) -> list[str]:
    """The JSON lines a host subprocess printed; fails the run if it did
    not end in ``timeout`` s or exited non-zero."""
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        check(False, f"{name}: no result in {timeout} s")
    out, err = (f.seek(0) or f.read() for f in proc.files)
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    check(proc.returncode == 0 and bool(lines),
          f"{name}: exit {proc.returncode}: {err[-2000:]}")
    return lines


def finish_dryrun(proc, card: str) -> dict:
    """The dry run's record, its FLOPs beside 6·N·D."""
    lines = finish_host_job(proc, "lm_sharded_dryrun", LM_DRYRUN_TIMEOUT_S)
    rec = json.loads(lines[-1])
    lo, hi = LM_DRYRUN_RATIO
    ratio = rec["flops_over_model_flops"]
    emit(phase="lm_sharded_dryrun", card=card, record=rec,
         flops_over_6nd=ratio, bound=list(LM_DRYRUN_RATIO),
         reading="per-rank FLOPs x ranks over 6 N D: remat's second "
         "forward (~4/3), the one shared attention block counted once in "
         "N but applied 7 times a pass, and the plain attention's full "
         "S x S scores on the fake CPU mesh")
    check(rec["status"] == "ok" and lo <= ratio <= hi,
          f"lm_sharded_dryrun: FLOPs / 6ND {ratio} outside {lo}-{hi}x")
    return rec


def phase_lm_sharded(ops, dev, train: dict, card: str, dryrun):
    """zamba2_1p2b's train step on a 1 x 1 NCCL ``DeviceMesh`` through
    the sharding slice (``launch.mesh.make_mesh``,
    ``sharding.place.shard_params`` / ``shard_batch``): lm_train's model,
    seed, batches and AdamW, every parameter a DTensor. Checks: each step
    launches lm_train's kernels through the ``local_map`` regions, the
    losses equal lm_train's first ones within LM_SHARDED_LOSS_RTOL, and
    the 16 x 16 dry run's FLOPs / 6·N·D (``dryrun``: the subprocess of
    ``start_dryrun``, started at the run's beginning so that its host
    time hides behind the card's phases). Returns the path's launches."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import Model
    from repro_torch.optim.adamw import AdamW
    from repro_torch.sharding.place import shard_batch, shard_params
    from repro_torch.training.train import make_train_step
    t, sh = LM_TRAIN, LM_SHARDED
    cfg = get_config(t["config"])
    b, s = t["batch"], t["seq"]
    n_attn = -(-cfg.n_layers // cfg.shared_attn_every)
    want_step = {"flash_attention": n_attn, "ssd_diag": cfg.n_layers,
                 "flash_attention_bwd": n_attn, "ssd_diag_bwd": cfg.n_layers}
    n_steps = sh["warm"] + sh["timed"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        t0 = time.perf_counter()
        mesh = make_mesh(sh["mesh"], ("data", "model"), device_type="cuda")
        model = Model(cfg, device=dev)
        model.init(torch.Generator(device=dev).manual_seed(SEED))
        params = shard_params(model, mesh)
        placements = sorted({str(p.placements) for p in params.values()})
        opt = AdamW(lr=t["lr"])
        state = opt.init(params)
        step = make_train_step(model, opt)
        batches = [shard_batch(bt, mesh) for bt in
                   train_batches(cfg, b, s, n_steps, dev)]
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        losses, step_ms, per_step = [], [], []
        ops.reset_launches()
        for i in range(n_steps):
            before = {k: ops.launches[k] for k in LM_TRAIN_KERNELS}
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            params, state, metrics = step(params, state, batches[i])
            torch.cuda.synchronize()
            if i >= sh["warm"]:
                step_ms.append((time.perf_counter() - t1) * 1e3)
            losses.append(float(metrics["loss"]))
            per_step.append({k: ops.launches[k] - before[k]
                             for k in LM_TRAIN_KERNELS})
        path = dict(ops.launches)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        del model, params, state, opt, step, batches, metrics
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    want = train["losses"][:n_steps]
    rel = [abs(a - w) / abs(w) for a, w in zip(losses, want)]
    ms = statistics.median(step_ms)
    emit(phase="lm_sharded", card=card, config=cfg.name, batch=b, seq=s,
         mesh=dict(zip(("data", "model"), sh["mesh"])), backend="nccl",
         placements=placements, init_s=init_s, losses=losses,
         lm_train_losses=want, loss_rel_err=rel,
         loss_bound=LM_SHARDED_LOSS_RTOL,
         losses_equal_bits=losses == want, step_ms=ms, step_ms_all=step_ms,
         lm_train_step_ms=train["step_ms"],
         tokens_per_s=b * s / ms * 1e3, peak_memory_gb=peak_gb,
         lm_train_peak_memory_gb=train["peak_memory_gb"],
         launches_per_step=per_step[-1])
    check(all(c == want_step for c in per_step),
          f"lm_sharded: steps launched {per_step}, not {want_step}")
    check(all(np.isfinite(losses)) and max(rel) <= LM_SHARDED_LOSS_RTOL,
          f"lm_sharded: losses {losses} against lm_train's {want}")
    return path, finish_dryrun(dryrun, card)


# the roofline tools on zamba2_1p2b (host subprocess, ``lm_roofline``)
LM_ROOFLINE = dict(arch="zamba2_1p2b", shape="train_4k",
                   decode="decode_32k", decode_layers=2, top=5)
LM_ROOFLINE_TIMEOUT_S = 900


def lm_roofline_job() -> int:
    """The host side of ``lm_roofline`` (``python3 chip_smoke.py
    --lm-roofline``): one JSON line for each of parts a, c and d, and the
    full-depth record for part b. No card: fake meshes on the CPU."""
    import logging

    from repro_torch.configs.base import InputShape
    from repro_torch.launch import dryrun as DR
    from repro_torch.roofline import differential, inspect_hlo, report
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    r = LM_ROOFLINE
    t0 = time.perf_counter()
    rec = differential.probe(r["arch"], r["shape"], multi_pod=False)
    full = rec.pop("full_depth")
    print(json.dumps({"part": "a", "record": rec,
                      "flops_gap": differential.gap(rec),
                      "collective_gap": differential.gap(
                          rec, "collective_total"),
                      "host_s": time.perf_counter() - t0}), flush=True)
    print(json.dumps({"part": "b", "row": report.analyze(full)}),
          flush=True)
    t = LM_TRAIN
    own = DR.lower_combo(r["arch"], "lm_train",
                         shape=InputShape("lm_train", t["seq"], t["batch"],
                                          "train"),
                         mesh_shape=(1, 1), remat=False)
    print(json.dumps({"part": "c", "row": report.analyze(own)}), flush=True)
    dec = DR.lower_combo(r["arch"], r["decode"], n_layers=r["decode_layers"],
                         keep_collectives=True)
    print(json.dumps({"part": "d", "n_ranks": dec["n_ranks"],
                      "total_bytes": dec["collectives"]["total_bytes"],
                      "top": inspect_hlo.top_collectives(
                          dec.pop("_collectives"), r["top"]),
                      "host_s": time.perf_counter() - t0}), flush=True)
    return 0


# every (arch, shape) of the reference's dry run on the fake 16 x 16
# mesh, each at the fewest layers that run all its layer kinds (host
# subprocess, ``lm_dryrun_all``); ~3 s a combo on one core
LM_DRYRUN_ALL_TIMEOUT_S = 600


def lm_dryrun_all_job() -> int:
    """The host side of ``lm_dryrun_all`` (``python3 chip_smoke.py
    --lm-dryrun-all``): ``launch.dryrun.kinds_sweep``, one JSON line a
    combo, a failure's with its message. No card."""
    import logging

    from repro_torch.launch import dryrun as DR
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    for row in DR.kinds_sweep():
        print(json.dumps(row), flush=True)
    return 0


def phase_lm_dryrun_all(proc, card: str) -> None:
    """The ``lm_dryrun_all`` line, read from ``lm_dryrun_all_job``
    (``proc``): each combo's status, per-rank FLOPs and argument bytes
    (estimates of the fake mesh). Fails unless every combo of
    ``kinds_combos`` traced."""
    from repro_torch.launch import dryrun as DR
    rows = [json.loads(ln) for ln in finish_host_job(
        proc, "lm_dryrun_all", LM_DRYRUN_ALL_TIMEOUT_S)]
    failed = [r for r in rows if r["status"] != "ok"]
    want = DR.kinds_combos()
    emit(phase="lm_dryrun_all", card=card, torch=torch.__version__,
         mesh={"data": 16, "model": 16}, n_combos=len(rows),
         n_ok=len(rows) - len(failed), host_s=sum(
             r.get("trace_s", 0.0) for r in rows),
         combos=[{k: v for k, v in r.items() if k != "trace"}
                 for r in rows],
         failures=[{"arch": r["arch"], "shape": r["shape"],
                    "trace": r.get("trace")} for r in failed],
         reading="per-rank estimates from a fake process group on the "
         "host: no device ran them")
    check([(r["arch"], r["shape"]) for r in rows] == want and not failed,
          f"lm_dryrun_all: {len(failed)} of {len(rows)} combos failed "
          f"({[(r['arch'], r['shape']) for r in failed]}), "
          f"{len(want)} wanted")


def _terms_ms(row: dict) -> dict:
    t = row["terms"]
    return {"compute_ms": t["t_compute_s"] * 1e3,
            "memory_ms": t["t_memory_s"] * 1e3,
            "collective_ms": t["t_collective_s"] * 1e3,
            "dominant": t["dominant"], "total_est_ms": t["t_total_est_s"] * 1e3,
            "model_flops_over_counted": row["useful_ratio"],
            "flops": row["flops"], "bytes_accessed": row["bytes_accessed"],
            "collective_bytes": row["collectives"]["total_bytes"],
            "n_ranks": row["n_ranks"]}


def phase_lm_roofline(proc, train: dict, dryrun_rec: dict, card: str):
    """The roofline tools' lines (a)–(d), read from ``lm_roofline_job``
    (``proc``), beside ``lm_sharded_dryrun``'s record and ``lm_train``'s
    measured step (``train``). Checks: the subprocess exited 0 with
    every part; the full-depth FLOPs exceed the two-depth extrapolation
    (zamba2's shared attention: 7 applications against 6.33); every term
    finite; each collective attributed to a ``models/`` line."""
    from repro_torch.roofline import report
    parts = {}
    for ln in finish_host_job(proc, "lm_roofline", LM_ROOFLINE_TIMEOUT_S):
        rec = json.loads(ln)
        parts[rec.pop("part")] = rec
    check(set(parts) == {"a", "b", "c", "d"},
          f"lm_roofline: parts {sorted(parts)}")
    a, d = parts["a"], parts["d"]
    rec = a["record"]
    emit(phase="lm_roofline", part="a", card=card, arch=rec["arch"],
         shape=rec["shape"], n_ranks=rec["n_ranks"],
         n_layers=rec["n_layers"], depth_pair=rec["depth_pair"],
         corrected=rec["corrected"], extrapolated=rec["extrapolated"],
         flops_gap=a["flops_gap"], collective_gap=a["collective_gap"],
         host_s=a["host_s"], estimate=rec["estimate"])
    check(rec["status"] == "ok" and a["flops_gap"] > 0,
          f"lm_roofline (a): full depth against the extrapolation: {a}")
    rows = {"probe_full_depth": _terms_ms(parts["b"]["row"]),
            "lm_sharded_dryrun": _terms_ms(report.analyze(dryrun_rec))}
    emit(phase="lm_roofline", part="b", card=card, rows=rows,
         rates=report.RATES)
    c = _terms_ms(parts["c"]["row"])
    emit(phase="lm_roofline", part="c", card=card, shape="2 x 2,048, no "
         "remat, 1 x 1 mesh", terms=c, step_ms=train["step_ms"],
         device_ms=train["device_ms"],
         total_est_over_device=c["total_est_ms"] / train["device_ms"],
         compute_over_device=c["compute_ms"] / train["device_ms"])
    emit(phase="lm_roofline", part="d", card=card, shape=LM_ROOFLINE[
        "decode"], layers=LM_ROOFLINE["decode_layers"], n_ranks=d["n_ranks"],
         total_bytes=d["total_bytes"], top=d["top"], host_s=d["host_s"])
    for row in (*rows.values(), c):
        check(all(np.isfinite([row["compute_ms"], row["memory_ms"],
                               row["collective_ms"]]))
              and row["model_flops_over_counted"] > 0,
              f"lm_roofline (b, c): terms {row}")
    check(bool(d["top"]) and all(src.startswith("models/")
                                 for *_, src in d["top"]),
          f"lm_roofline (d): top collectives {d['top']}")


def lm_train_rows(ops, FA, SD, dev, launches, seen):
    """The two backward kernels at the operands (and dY) of the zamba2
    train step's first attention and SSD calls, timed beside their
    bounds, their plain versions and, for attention, the autograd
    backward of SDPA on the same operands."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q, k, v, kw = seen["flash_attention"]
    do = seen["flash_do"].contiguous()
    causal = kw["causal"]
    o, lse = ops.flash_attention_lse(q, k, v, causal=causal)
    b, s, h, d = q.shape
    hkv = k.shape[2]
    got = ops.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    want = FA.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal)
    fa_err = max(rel_err(g_, w_) for g_, w_ in zip(got, want))
    del got, want
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    out = sdpa(qt, kt, vt, is_causal=causal, enable_gqa=True)
    dot = do.transpose(1, 2)
    pairs = b * h * s * (s + 1) // 2 if causal else b * h * s * s
    # S, dP, dV, dK and dQ: five products of 2 D operations a pair
    flops = 10.0 * pairs * d
    elem = q.element_size()
    n_bytes = (elem * (3 * b * s * h * d + 2 * b * s * hkv * d)   # q o dO k v
               + 4 * b * h * s                                    # lse
               + elem * (b * s * h * d + 2 * b * s * hkv * d))    # dq dk dv
    rows = [time_row(
        ops, "flash_attention_bwd_zamba2", "flash_attn_bwd.cu",
        "no Pallas counterpart (the reference differentiates "
        "src/repro/models/layers.py:119 by XLA autodiff)",
        lambda: ops.flash_attention_bwd(q, k, v, o, lse, do, causal=causal),
        lambda: FA.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                             causal=causal),
        lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                    retain_graph=True),
        n_bytes, flops, launches["flash_attention_bwd"], fa_err,
        bounds=lm_bounds(n_bytes, flops, BF16_FLOP_PER_S, flops, 2 * pairs))]
    rows[-1].update(dtype=str(q.dtype).split(".")[1], path="lm_train",
                    plan=FA.bwd_plan(b, s, s, h, hkv, d, q.dtype,
                                     o.dtype)._asdict(),
                    device_kernels=list(
                        BWD_DEVICE_KERNELS["flash_attention_bwd"]),
                    ptxas=bwd_ptxas("flash_attention_bwd"),
                    max_abs_err_reading="max |kernel - plain| over the "
                    "plain gradient's largest magnitude, worst of dq dk dv")
    del out, qt, kt, vt
    cmat, bmat, x, dt, cs = seen["ssd_diag"]
    dy = seen["ssd_dy"].contiguous()
    got = ops.ssd_diag_bwd(cmat, bmat, x, dt, cs, dy)
    want = SD.ssd_diag_bwd_plain(cmat, bmat, x, dt, cs, dy)
    sd_err = max(rel_err(g_, w_) for g_, w_ in zip(got, want))
    del got, want
    bc, q_len, n = cmat.shape
    hs, p = x.shape[1], x.shape[3]
    tri = q_len * (q_len + 1) // 2
    # per (chunk, head) dW and dX over the causal half; per chunk S, and
    # dC and dB from dS summed over the heads
    ssd_flops = 4.0 * bc * hs * tri * p + 6.0 * bc * tri * n
    ssd_bytes = 4 * (2 * bc * q_len * n + 2 * bc * hs * q_len * p
                     + 2 * bc * hs * q_len            # read C B x dY dt cs
                     + 2 * bc * q_len * n + bc * hs * q_len * p
                     + 2 * bc * hs * q_len)           # write dC dB dx ddt dcs
    rows.append(time_row(
        ops, "ssd_diag_bwd_zamba2", "ssd_diag_bwd.cu",
        "no Pallas counterpart (the reference differentiates "
        "src/repro/models/mamba2.py:88 by XLA autodiff)",
        lambda: ops.ssd_diag_bwd(cmat, bmat, x, dt, cs, dy),
        lambda: SD.ssd_diag_bwd_plain(cmat, bmat, x, dt, cs, dy), None,
        ssd_bytes, ssd_flops, launches["ssd_diag_bwd"], sd_err,
        bounds=lm_bounds(ssd_bytes, 3 * ssd_flops, TF32_FLOP_PER_S,
                         ssd_flops, bc * hs * tri)))
    rows[-1].update(path="lm_train", shape=[bc, hs, q_len, n, p],
                    plan=SD.bwd_plan(bc, hs, q_len, n, p,
                                     sms=torch.cuda.get_device_properties(
                                         dev).multi_processor_count
                                     )._asdict(),
                    device_kernels=list(BWD_DEVICE_KERNELS["ssd_diag_bwd"]),
                    ptxas=bwd_ptxas("ssd_diag_bwd"),
                    max_abs_err_reading="max |kernel - plain| over the "
                    "plain gradient's largest magnitude, worst of dC dB dx "
                    "ddt dcs")
    return rows


def bwd_ptxas(entry: str) -> list:
    """What ptxas reported for the backward entry's device kernels."""
    from repro_torch.kernels import _build
    return [r for name in BWD_DEVICE_KERNELS[entry]
            for r in _build.ptxas_report(name)]


def phase_task_axis(ops, K, G, KS, D, dist, dev, fits, xte, gamma, counts):
    """The task-axis row and selection kernels at the OvO and OvR bucket
    shapes of the multiclass fits (ragged tasks zero-padded and masked,
    as the solver stacks them) against their plain versions, and their
    times beside their bounds; then multitask_decision on the largest
    OvO and OvR serving banks over one full serving slice of held-out
    rows."""
    saved = dict(ops.launches)
    rows = []
    floor, l2 = launch_floor_ms(), l2_read_rate(dev)
    for strategy in ("ovo", "ovr"):
        clf = fits[strategy][0]
        bucket = clf._schedule.buckets[0]
        xt, yt, mk, _ = dist._bucket_arrays(clf._taskset, bucket)
        x = torch.from_numpy(xt).to(dev)
        y = torch.from_numpy(yt).to(dev)
        mask = torch.from_numpy(mk).to(dev)
        n_tasks, w, d = x.shape
        x2 = K.sqnorms(x)
        sizes = mask.sum(dim=1)
        i = (sizes // 3).to(torch.int64)
        got = ops.gram_row(x, x2, i, gamma=gamma)
        want = G.gram_row_plain(x, x2, i, gamma=gamma)
        ok_row = bool(torch.allclose(got, want, **GRAM_TOL))
        rng = np.random.default_rng(SEED)
        f = torch.from_numpy(rng.normal(size=(n_tasks, w)).astype(
            np.float32)).to(dev)
        alpha = torch.from_numpy(np.where(
            rng.random((n_tasks, w)) < 0.4, 0.0,
            rng.uniform(0, 1, (n_tasks, w))).astype(np.float32)).to(dev)
        lo, hi = torch.zeros_like(f), torch.ones_like(f)
        sel = ops.kkt_select(f, alpha, y, mask, lo, hi)
        sel_plain = KS.kkt_select_plain(f, alpha, y, mask, lo, hi)
        ok_sel = all(bool(torch.equal(a, b)) for a, b in zip(sel, sel_plain))
        emit(phase="parity", kernel="task_axis", strategy=strategy,
             shape=[n_tasks, w, d], ragged_sizes=[int(sizes.min()),
                                                  int(sizes.max())],
             rbf_gram_row_max_abs_err=max_err(got, want), bound=GRAM_TOL,
             kkt_select_equal=ok_sel, ok=ok_row and ok_sel)
        check(ok_row, f"task-axis rbf_gram_row ({strategy} bucket) "
              "disagrees with its plain version")
        check(ok_sel, f"task-axis kkt_select ({strategy} bucket) "
              "disagrees with its plain version")
        z = torch.stack([x[t].index_select(0, i[t:t + 1])[0]
                         for t in range(n_tasks)])
        vb = torch.from_numpy(rng.normal(size=(n_tasks, w)).astype(
            np.float32)).to(dev) * mask
        xs = G.staged(x)   # the bucket engine's layout of its rows
        mv = ops.gram_matvec(xs, x2, vb, gamma=gamma)
        mv_plain = G.gram_matvec_plain(x, x2, vb, gamma=gamma)
        entries = [
            ("rbf_gram_row", lambda: ops.gram_row(x, x2, i, gamma=gamma),
             lambda: G.gram_row_plain(x, x2, i, gamma=gamma),
             lambda: torch.exp(-gamma * torch.cdist(
                 x, z[:, None, :]).square()),
             4 * (n_tasks * w * d + 2 * n_tasks * w) + 8 * n_tasks,
             n_tasks * w * (2 * d + 6), max_err(got, want)),
            ("kkt_select", lambda: ops.kkt_select(f, alpha, y, mask, lo, hi),
             lambda: KS.kkt_select_plain(f, alpha, y, mask, lo, hi), None,
             21 * n_tasks * w + 24 * n_tasks, 12 * n_tasks * w, 0.0),
            # the plain version is T x w / 2,048 Gram blocks and GEMVs
            # (~0.2 s a call at OvR): timed over fewer calls
            ("rbf_gram_matvec", lambda: ops.gram_matvec(xs, x2, vb,
                                                        gamma=gamma),
             lambda: G.gram_matvec_plain(x, x2, vb, gamma=gamma), None,
             4 * (n_tasks * w * d + 3 * n_tasks * w),
             n_tasks * w * w * (2 * d + 8), max_err(mv, mv_plain)),
        ]
        for name, kern, plain, lib, n_bytes, n_ops, err in entries:
            slow = name == "rbf_gram_matvec"
            ms = median_ms(kern)
            plain_ms = (median_ms(plain, reps=3, warmup=1) if slow
                        else median_ms(plain))
            b_ms, b_by = bound_ms(n_bytes, n_ops)
            rows.append({
                "name": name, "task_axis": strategy, "shape": [n_tasks, w, d],
                "launches_on_path": fits[strategy][3][name],
                "max_abs_err": err, "ms": ms, "device_ms": device_ms(kern),
                "plain_ms": plain_ms,
                "plain_device_ms": (device_ms(plain, calls=2, reps=1) if slow
                                    else device_ms(plain)),
                "bound_ms": b_ms, "bound_by": b_by,
                "l2_bound_ms": n_bytes / l2 * 1e3, "l2_read_bytes_per_s": l2,
                "launch_floor_ms": floor,
                "kernels_per_call": counts[f"{name}_{strategy}"],
                "library_ms": median_ms(lib) if lib is not None else None,
                "library_device_ms": (device_ms(lib) if lib is not None
                                      else None)})
            if slow:
                rows[-1].update(gram_bounds(n_tasks * w, w, d, "fp32",
                                            n_bytes, matvec=True),
                                **gram_info(G, "matvec", (w, w, d)))
                rows[-1]["plan"] = G.gram_plan(
                    w, w, d, tasks=n_tasks, entry="matvec",
                    sms=torch.cuda.get_device_properties(0)
                    .multi_processor_count)._asdict()
    for strategy, whole in (("ovo", False), ("ovr", False), ("ovr", True)):
        rows.append(bank_row(ops, D, dev, fits[strategy], strategy, xte,
                             gamma, whole))
    ops.launches.update(saved)
    emit(phase="task_axis", kernels=rows)


def serving_bank(packed, whole: bool = False):
    """(sv, coef) numpy arrays of a multiclass pack's largest serving
    bank or, with ``whole``, of all its tasks stacked into one bank
    padded to the widest (coef 0 past each task's SVs)."""
    banks = packed.buckets
    if not whole:
        g = max(banks, key=lambda g: g.sv_x.shape[0] * g.sv_x.shape[1])
        return g.sv_x, g.sv_coef
    w = max(g.sv_x.shape[1] for g in banks)

    def stack(key):
        return np.ascontiguousarray(np.concatenate([np.pad(
            getattr(g, key), [(0, 0), (0, w - g.sv_x.shape[1])]
            + [(0, 0)] * (getattr(g, key).ndim - 2)) for g in banks]))

    return stack("sv_x"), stack("sv_coef")


def library_decision(z, sv, cf, gamma):
    """(T, nt) RBF decisions by batched cdist, exp and bmm: the library
    calls that compute what multitask_decision does."""
    k = torch.exp(-gamma * torch.cdist(z.expand(sv.shape[0], -1, -1),
                                       sv).square())
    return (k @ cf[:, :, None])[..., 0]


def bank_row(ops, D, dev, fit, strategy, xte, gamma,
             whole: bool = False) -> dict:
    """multitask_decision on the largest serving bank of a multiclass
    pack — with ``whole``, on all its tasks as one bank
    (``serving_bank``) — over one serving slice of held-out rows
    (Predictor max_batch): against its plain version, timed beside
    batched cdist, exp and bmm and beside its bound."""
    sv_np, cf_np = serving_bank(fit[2], whole)
    sv = torch.from_numpy(np.ascontiguousarray(sv_np)).to(dev)
    cf = torch.from_numpy(np.ascontiguousarray(cf_np)).to(dev)
    n_tasks, w, d = sv.shape
    z = torch.from_numpy(xte[:1024]).to(dev)
    nt = z.shape[0]
    got = ops.multitask_decision(z, sv, cf, gamma=gamma)
    want = D.multitask_decision_plain(z, sv, cf, gamma=gamma)
    b_ms, b_by = bound_ms(4 * (nt * d + n_tasks * w * d + n_tasks * w
                               + n_tasks * nt),
                          n_tasks * nt * w * (2 * d + 8))

    def kern():
        return ops.multitask_decision(z, sv, cf, gamma=gamma)

    def plain():
        return D.multitask_decision_plain(z, sv, cf, gamma=gamma)

    def lib():
        return library_decision(z, sv, cf, gamma)

    row = {
        "name": "multitask_decision", "task_axis": strategy,
        "bank": "all tasks, padded" if whole else "largest served",
        "shape": [n_tasks, nt, w, d],
        "launches_on_path": fit[3]["multitask_decision"],
        "max_abs_err": max_err(got, want),
        "ok": bool(torch.allclose(got, want, **DECISION_TOL)),
        "ms": median_ms(kern), "device_ms": device_ms(kern),
        "plain_ms": median_ms(plain), "plain_device_ms": device_ms(plain),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": median_ms(lib),
        "library_device_ms": device_ms(lib),
        **redesign_info("decision", (nt, n_tasks, w, d))}
    check(row["ok"], f"multitask_decision disagrees with its plain version "
          f"on the largest {strategy} serving bank")
    return row


def phase_timing_lm(ops, FA, SD, dev, errs, launches, bf16_launches,
                    bwd_launches):
    """flash_attention (float32 and bfloat16) and ssd_diag at their model
    shapes, each with its plan, ptxas's report and its tensor-core bounds
    (``lm_bounds``)."""
    attn, _, ssd = lm_inputs(dev)
    a, m = PHI4_ATTN, MAMBA2_SSD
    b, s_len, h, hkv, d = a["b"], a["s"], a["h"], a["hkv"], a["d"]
    bc, hs, qs, n, p = m["bc"], m["h"], m["q"], m["n"], m["p"]
    pairs = b * h * s_len * (s_len + 1) // 2   # (query, key) under the mask
    flops = 4.0 * pairs * d                    # both products
    tri = qs * (qs + 1) // 2   # (key, query) pairs under the causal mask
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    for dt, name in ((torch.float32, "flash_attention"),
                     (torch.bfloat16, "flash_attention_bf16")):
        q, k, v = (t.to(dt) for t in attn)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        elem = 2 if dt == torch.bfloat16 else 4
        n_bytes = elem * (2 * b * s_len * h * d + 2 * b * s_len * hkv * d)
        bounds = (lm_bounds(n_bytes, 3 * flops, TF32_FLOP_PER_S, flops,
                            pairs) if dt == torch.float32
                  else lm_bounds(n_bytes, flops, BF16_FLOP_PER_S, flops,
                                 pairs, route_passes=1.5))
        rows.append(time_row(
            ops, name, "flash_attn.cu", "src/repro/kernels/flash_attn.py:83",
            lambda: ops.flash_attention(q, k, v, causal=True),
            lambda: FA.flash_attention_plain(q, k, v, causal=True,
                                             out_dtype=dt),
            lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True),
            n_bytes, flops,
            launches["flash_attention"] - bf16_launches
            if dt == torch.float32 else bf16_launches,
            errs[name], bounds=bounds))
        rows[-1].update(dtype=str(dt).split(".")[1],
                        **redesign_info("flash_attention",
                                        (b, s_len, h, d, dt)))
    # the backward at the same operands: S, dP, dV, dK, dQ (five
    # products of 2 D operations a causal pair); q, k, v, o, dO and lse
    # read, dq, dk, dv written once
    g = torch.Generator(device=dev).manual_seed(SEED)
    do32 = torch.randn(attn[0].shape, generator=g, device=dev)
    for dt, name in ((torch.float32, "flash_attention_bwd"),
                     (torch.bfloat16, "flash_attention_bwd_bf16")):
        q, k, v, do = (t.to(dt) for t in (*attn, do32))
        o, lse = ops.flash_attention_lse(q, k, v, causal=True)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        out = sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)
        dot = do.transpose(1, 2)
        elem = 2 if dt == torch.bfloat16 else 4
        n_bytes = (elem * (4 * b * s_len * h * d + 4 * b * s_len * hkv * d)
                   + 4 * b * h * s_len)
        bflops = 10.0 * pairs * d
        bounds = (lm_bounds(n_bytes, 3 * bflops, TF32_FLOP_PER_S, bflops,
                            2 * pairs) if dt == torch.float32
                  else lm_bounds(n_bytes, bflops, BF16_FLOP_PER_S, bflops,
                                 2 * pairs))
        rows.append(time_row(
            ops, name, "flash_attn_bwd.cu",
            "no Pallas counterpart (the reference differentiates "
            "src/repro/models/layers.py:119 by XLA autodiff)",
            lambda: ops.flash_attention_bwd(q, k, v, o, lse, do),
            lambda: FA.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                 causal=True),
            lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                        retain_graph=True),
            n_bytes, bflops, bwd_launches[dt], errs[name], bounds=bounds))
        rows[-1].update(dtype=str(dt).split(".")[1],
                        plan=FA.bwd_plan(b, s_len, s_len, h, hkv, d, dt,
                                         o.dtype)._asdict(),
                        device_kernels=list(
                            BWD_DEVICE_KERNELS["flash_attention_bwd"]),
                        max_abs_err_reading="max |kernel - plain| over the "
                        "plain gradient's largest magnitude, worst of dq "
                        "dk dv")
        del out, qt, kt, vt
    # C and B once; x, dt, cs read and y written once
    ssd_bytes = 4 * (2 * bc * qs * n + 2 * bc * hs * qs * (p + 1))
    # scores once a chunk, the weighted sum once a head (causal halves)
    ssd_flops = 2.0 * bc * tri * n + 2.0 * bc * hs * tri * p
    rows.append(time_row(
        ops, "ssd_diag", "ssd_diag.cu", "src/repro/kernels/ssd_diag.py:51",
        lambda: ops.ssd_diag(*ssd), lambda: SD.ssd_diag_plain(*ssd), None,
        ssd_bytes, bc * tri * 2 * n + bc * hs * tri * (3 + 2 * p),
        launches, errs["ssd_diag"],
        bounds=lm_bounds(ssd_bytes, 3 * ssd_flops, TF32_FLOP_PER_S,
                         bc * tri * 2 * n + bc * hs * tri * (3 + 2 * p),
                         bc * hs * tri)))
    rows[-1].update(**redesign_info("ssd_diag", (bc, hs, qs, n, p)))
    return rows


def phase_timing(ops, K, G, KS, D, dev, xtr, xte, packed, gamma, errs,
                 launches, counts):
    """Kernel, plain version and one library call, at main-path shapes."""
    x = torch.from_numpy(xtr).to(dev)
    zte = torch.from_numpy(xte).to(dev)
    nte = zte.shape[0]
    n, d = x.shape
    x2 = K.sqnorms(x)
    xs = G.staged(x)   # the pallas engine's layout of its rows
    blk, blk2 = xs[:2048], x2[:2048]
    i = torch.tensor(n // 3, device=dev)
    bank = packed.buckets[0]
    sv = torch.from_numpy(bank.sv_x[0]).to(dev)
    cf = torch.from_numpy(bank.sv_coef[0]).to(dev)
    w = sv.shape[0]
    z = x[:1024].contiguous()
    f = torch.randn(n, device=dev)
    alpha = torch.rand(n, device=dev)
    yv = torch.where(torch.rand(n, device=dev) < 0.5, 1.0, -1.0)
    mask = torch.ones(n, dtype=torch.bool, device=dev)
    lo, hi = torch.zeros(n, device=dev), torch.ones(n, device=dev)

    def lib_rbf(a, b):
        return torch.exp(-gamma * torch.cdist(a, b).square())

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    v = torch.randn(n, generator=gen, device=dev)

    def lib_matvec():   # a composition: no one PyTorch call computes it
        return torch.cat([lib_rbf(x[s:s + 2048], x) @ v
                          for s in range(0, n, 2048)])

    # the cached entry: 64 rows in turn through 32 slots miss every time
    turn = [torch.tensor(v, device=dev) for v in range(0, n, n // 64)][:64]
    miss_kern = fresh_row_cache(n, dev)
    miss_plain = fresh_row_cache(n, dev)

    turns = {"kern": 0, "plain": 0}   # each cache's own rotation

    def next_row(which):
        turns[which] += 1
        return turn[turns[which] % len(turn)]

    def miss():
        return ops.gram_row_cached(x, x2, next_row("kern"), *miss_kern,
                                   gamma=gamma)

    def miss_plain_fn():
        return G.lru_row_plain(*miss_plain, next_row("plain"),
                               lambda j: G.gram_row_plain(x, x2, j,
                                                          gamma=gamma))

    rows = [
        ("rbf_gram", "rbf_gram.cu", "src/repro/kernels/rbf_gram.py:91",
         lambda: ops.rbf_gram(blk, xs, gamma=gamma, a2=blk2, b2=x2),
         lambda: G.rbf_gram_plain(blk, x, blk2, x2, gamma=gamma),
         lambda: lib_rbf(blk, x),
         4 * (2048 * d + n * d + 2048 + n + 2048 * n),
         2048 * n * (2 * d + 6)),
        ("rbf_gram_matvec", "rbf_gram.cu", "src/repro/kernels/rbf_gram.py:91",
         lambda: ops.gram_matvec(xs, x2, v, gamma=gamma),
         lambda: G.gram_matvec_plain(x, x2, v, gamma=gamma), lib_matvec,
         4 * (n * d + 3 * n), n * n * (2 * d + 8)),
        ("rbf_gram_row", "rbf_gram.cu", "src/repro/kernels/rbf_gram.py:91",
         lambda: ops.gram_row(x, x2, i, gamma=gamma),
         lambda: G.gram_row_plain(x, x2, i, gamma=gamma),
         lambda: lib_rbf(x, x[n // 3:n // 3 + 1]),
         4 * (n * d + 2 * n), n * (2 * d + 6)),
        # a miss: X, both norms, the row into its slot and the output,
        # keys and stamps read
        ("rbf_gram_row_cached", "rbf_gram.cu",
         "src/repro/kernels/rbf_gram.py:91", miss, miss_plain_fn, None,
         4 * (n * d + 3 * n) + 16 * ROW_CACHE_SLOTS + 32, n * (2 * d + 6)),
        ("kkt_select", "kkt_select.cu", "src/repro/kernels/kkt_select.py:57",
         lambda: ops.kkt_select(f, alpha, yv, mask, lo, hi),
         lambda: KS.kkt_select_plain(f, alpha, yv, mask, lo, hi),
         None, 21 * n + 24, 12 * n),
        ("decision", "decision.cu", "src/repro/kernels/decision.py:59",
         lambda: ops.decision(zte, sv, cf, gamma=gamma),
         lambda: D.decision_plain(zte, sv, cf, gamma=gamma),
         lambda: lib_rbf(zte, sv) @ cf,
         4 * (nte * d + w * d + w + nte), nte * w * (2 * d + 8)),
        ("multitask_decision", "decision.cu",
         "src/repro/kernels/decision.py:121",
         lambda: ops.multitask_decision(z, sv[None], cf[None], gamma=gamma),
         lambda: D.multitask_decision_plain(z, sv[None], cf[None],
                                            gamma=gamma),
         lambda: (lib_rbf(z, sv) @ cf)[None],
         4 * (1024 * d + w * d + w + 1024), 1024 * w * (2 * d + 8)),
    ]
    out = [time_row(ops, *row, launches, errs[row[0]]) for row in rows]
    out[5].update(redesign_info("decision", (nte, 1, w, d)))
    out[6].update(redesign_info("decision", (1024, 1, w, d)))
    # the block route: tensor-core bounds beside the CUDA-core one, the
    # bf16 call's device time, the plan and ptxas's report
    xb16 = G.staged(x.to(torch.bfloat16))
    blk16 = xb16[:2048]
    x2b16 = K.sqnorms(xb16)
    saved = dict(ops.launches)
    block, matvec = out[0], out[1]
    block.update(gram_bounds(2048, n, d, "fp32", 4 * (2048 * d + n * d
                                                      + 2048 + n
                                                      + 2048 * n)),
                 **gram_info(G, "block", (2048, n, d)),
                 bf16_device_ms=device_ms(lambda: ops.rbf_gram(
                     blk16, xb16, gamma=gamma, compute_dtype="bf16",
                     a2=x2b16[:2048], b2=x2b16)),
                 bf16_bound=gram_bounds(2048, n, d, "bf16", 2 * (
                     2048 * d + n * d) + 4 * (2048 + n + 2048 * n)),
                 main_path_shape="the linear SVC's held-out margins: "
                                 "(1,229 | 2,048) x 29,491 x 102")
    # no one PyTorch call computes K v: the library yardstick is a
    # composition, reported under its own keys
    matvec.update(gram_bounds(n, n, d, "fp32", 4 * (n * d + 3 * n),
                              matvec=True),
                  **gram_info(G, "matvec", (n, n, d)),
                  library_composition="chunked exp(-gamma cdist^2) @ v, "
                                      "2,048 rows a chunk",
                  library_composition_ms=matvec["library_ms"],
                  library_composition_device_ms=matvec["library_device_ms"],
                  library_ms=None, library_device_ms=None,
                  bf16_device_ms=device_ms(lambda: ops.gram_matvec(
                      xb16, x2b16, v, gamma=gamma)),
                  bf16_bound=gram_bounds(n, n, d, "bf16",
                                         2 * n * d + 12 * n, matvec=True),
                  kernels_per_call=counts["rbf_gram_matvec"])
    ops.launches.update(saved)

    # the two SMO kernels beside the launch floor and an L2 bound (X
    # stays in L2 across the SMO loop), with kernels counted a call
    floor, l2 = launch_floor_ms(), l2_read_rate(dev)
    hit_cache = fresh_row_cache(n, dev)
    ops.gram_row_cached(x, x2, i, *hit_cache, gamma=gamma)

    def hit():
        return ops.gram_row_cached(x, x2, i, *hit_cache, gamma=gamma)

    saved = dict(ops.launches)
    hit_bytes = 4 * 2 * n + 16 * ROW_CACHE_SLOTS + 32
    extra = {
        "rbf_gram_row": {},
        "rbf_gram_row_cached": dict(
            hit_ms=median_ms(hit), hit_device_ms=device_ms(hit),
            hit_bound_ms=hit_bytes / HBM_BYTES_PER_S * 1e3,
            hit_l2_bound_ms=hit_bytes / l2 * 1e3,
            hit_kernels_per_call=counts["rbf_gram_row_cached_hit"]),
        "kkt_select": {},
    }
    for row in out:
        if row["name"] not in extra:
            continue
        n_bytes = row["bound_ms"] * 1e-3 * HBM_BYTES_PER_S
        if row["bound_by"] == "bytes":
            row["l2_bound_ms"] = n_bytes / l2 * 1e3
        row.update(launch_floor_ms=floor, l2_read_bytes_per_s=l2,
                   kernels_per_call=counts[row["name"]],
                   **extra[row["name"]])
    cached = next(r for r in out if r["name"] == "rbf_gram_row_cached")
    cached["hits_misses_of_timing"] = [int(miss_kern[4]), int(miss_kern[5])]
    ops.launches.update(saved)
    return out


# ------------------------------------------------ the GD baseline, cascade
# the reference's GD configuration: SVC's gd_lr, GDConfig's step count,
# and the OvO steps of examples/multiclass_pavia.py
GD_LR = 0.01
GD_STEPS = 2000
GD_OVO_STEPS = 800
GD_TOL = dict(rtol=1e-4, atol=1e-4)          # tests/test_torch_gd.py
# gd_stable: the pallas loop against the chunked (plain matvec) one
GD_STABLE_STEPS = 200
GD_STABLE_TOL = dict(loss_rtol=1e-3, alpha_atol_per_C=1e-3)
CASCADE_SHARDS = 4
# the SVR cascades' depths, cut: about 70 % of an SVR's rows are SVs,
# so each of their 5-6 feedback rounds re-solves near-full nodes; on the
# card the exact one took 90 s at 4,096 rows and the RFF one 131 s on
# the full 16,384 (PERF.md section 6)
CASCADE_SVR_ROWS = {"svr_cascade": 2048, "svr_cascade_lowrank": 4096}


def svr_split(data, n: int):
    """(xtr, ytr, xte, yte) of an SVR phase: the sinc regression problem
    of n rows, 6 features, noise 0.1, a tenth held out."""
    x, y = data.make_synth_regression(n, 6, kind="sinc", noise=0.1,
                                      seed=SEED)
    return data.train_test_split(x, y, test_frac=0.1, seed=SEED)


def top_eigenvalue(eng, y: torch.Tensor, iters: int = 20) -> float:
    """The largest eigenvalue of diag(y) K diag(y), by ``iters`` power
    iterations of one engine matvec each (not the path's launches)."""
    gen = torch.Generator(device=y.device)
    gen.manual_seed(SEED)
    v = torch.rand(y.shape, generator=gen, device=y.device)
    v = v / torch.linalg.vector_norm(v)
    lam = torch.zeros((), device=y.device)
    for _ in range(iters):
        w = y * eng.matvec((y * v).contiguous())
        lam = torch.dot(v, w)
        v = w / torch.linalg.vector_norm(w)
    return float(lam)


def loss_trend(losses: np.ndarray) -> dict:
    """Whether a GD loss curve descends: the steps after a 50-step
    warm-up that raise the loss by more than 1e-5 of its scale (the
    bound of tests/test_gd.py)."""
    losses = np.asarray(losses, np.float64)
    rises = np.diff(losses[50:]) > 1e-5 * max(1.0, np.abs(losses).max())
    return {"trend": "oscillates" if rises.any() else "descends",
            "rising_steps": int(rises.sum()), "loss_first": losses[0],
            "loss_last": losses[-1], "loss_min": losses.min()}


def timed_fit(ops, make, x, y):
    """(model, seconds, launches) of one fit from zeroed launch counts."""
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    model = make().fit(x, y)
    torch.cuda.synchronize()
    return model, time.perf_counter() - t0, dict(ops.launches)


def serve_heldout(ops, model, xte):
    """Held-out labels (SVC) or values (SVR) through the model's cached
    Predictor, and the launches they took (the path's serving)."""
    saved = dict(ops.launches)
    out = model.predict(xte)
    torch.cuda.synchronize()
    return out, {k: ops.launches[k] - saved[k] for k in ops.KERNELS}


def add(*counts) -> dict:
    return {k: sum(c[k] for c in counts) for k in counts[0]}


def phase_gd(ops, gd, KE, SVC, dev, split, smo_acc):
    """The paper's comparison at the exact SVC's split: SVC(solver="gd",
    engine="pallas") at the reference's lr 0.01 and GDConfig's 2,000
    steps, beside the SMO fit of ``phase_fit``; the step size against
    the curvature lr * lambda_max of diag(y) K diag(y)."""
    xtr, ytr, xte, yte = split
    kw = dict(solver="gd", engine="pallas", gd_steps=GD_STEPS, gd_lr=GD_LR)
    clf, fit_s, fit_launches = timed_fit(
        ops, lambda: SVC(**kw, device=dev), xtr, ytr)
    warm_s = timed_fit(ops, lambda: SVC(**kw, device=dev), xtr, ytr)[1]
    ops.launches.update(fit_launches)   # the warm fit is not the path
    labels, serve_launches = serve_heldout(ops, clf, xte)
    acc = float(np.mean(labels == yte))
    saved = dict(ops.launches)
    x = torch.from_numpy(xtr).to(dev)
    yy = torch.from_numpy(np.where(ytr == clf.classes_[1], 1.0, -1.0)
                          .astype(np.float32)).to(dev)
    eng = KE.make_engine(x, clf.kernel_params, "pallas")
    lam = top_eigenvalue(eng, yy)
    short = gd.GDConfig(lr=GD_LR, steps=20)
    per_fit = kernels_per_call(lambda: gd.binary_gd(
        x, yy, cfg=short, kernel=clf.kernel_params, engine=eng), calls=3)
    ops.launches.update(saved)   # the checks are not the path
    matvecs = fit_launches["rbf_gram_matvec"]
    emit(phase="gd", n=int(xtr.shape[0]), d=int(xtr.shape[1]),
         steps=GD_STEPS, lr=GD_LR, fit_s=fit_s, fit_s_warm=warm_s,
         ms_per_step_warm=warm_s / GD_STEPS * 1e3,
         heldout_acc=acc, smo_heldout_acc=smo_acc,
         n_support=clf.n_support_, gamma=clf.kernel_params.gamma,
         lambda_max=lam, lr_times_lambda_max=GD_LR * lam,
         stable_below=2.0, **loss_trend(clf.loss_curve_),
         gram_matvec_launches=matvecs,
         device_kernels_per_20_step_fit=per_fit,
         device_kernels_per_step=per_fit / short.steps,
         launches=fit_launches, heldout_launches=serve_launches)
    check(0 < matvecs <= GD_STEPS + 1, f"GD fit: {matvecs} Gram matvec "
          f"launches for {GD_STEPS} steps (one a step, at most steps + 1)")
    check(bool(np.isfinite(clf.loss_curve_).all()),
          "GD fit: loss curve not finite")
    return lam, add(fit_launches, serve_launches)


def phase_gd_stable(ops, gd, SVC, dev, split, lam, smo_acc):
    """The same fit at the stable step lr = 1 / lambda_max, and its first
    200 steps held against the same loop on the plain matvec on the card
    (engine="chunked"): at a stable step the two trajectories contract,
    so this holds the Gram matvec kernel inside the solver."""
    xtr, ytr, xte, yte = split
    lr = 1.0 / lam
    kw = dict(solver="gd", engine="pallas", gd_steps=GD_STEPS, gd_lr=lr)
    clf, fit_s, fit_launches = timed_fit(
        ops, lambda: SVC(**kw, device=dev), xtr, ytr)
    labels, serve_launches = serve_heldout(ops, clf, xte)
    acc = float(np.mean(labels == yte))
    saved = dict(ops.launches)
    x = torch.from_numpy(xtr).to(dev)
    yy = torch.from_numpy(np.where(ytr == clf.classes_[1], 1.0, -1.0)
                          .astype(np.float32)).to(dev)
    cfg = gd.GDConfig(lr=lr, steps=GD_STABLE_STEPS)
    got, want = (gd.binary_gd(x, yy, cfg=cfg, kernel=clf.kernel_params,
                              engine=e) for e in ("pallas", "chunked"))
    loss_err = float(((got.loss_curve - want.loss_curve).abs()
                      / want.loss_curve.abs().clamp_min(1e-30)).max())
    alpha_err = max_err(got.alpha, want.alpha)
    ok = (bool(torch.allclose(got.loss_curve, want.loss_curve,
                              rtol=GD_STABLE_TOL["loss_rtol"], atol=0.0))
          and alpha_err <= GD_STABLE_TOL["alpha_atol_per_C"] * cfg.C)
    ops.launches.update(saved)   # the parity loops are not the path
    emit(phase="gd_stable", steps=GD_STEPS, lr=lr, lr_times_lambda_max=1.0,
         fit_s=fit_s, ms_per_step=fit_s / GD_STEPS * 1e3,
         heldout_acc=acc, smo_heldout_acc=smo_acc,
         n_support=clf.n_support_, **loss_trend(clf.loss_curve_),
         parity_steps=GD_STABLE_STEPS, parity_vs="engine='chunked'",
         loss_max_rel_err=loss_err, alpha_max_abs_err=alpha_err,
         parity_bound=GD_STABLE_TOL, parity_ok=ok,
         launches=fit_launches, heldout_launches=serve_launches)
    check(ok, f"gd_stable: the pallas GD loop differs from the chunked one "
          f"(loss rel {loss_err}, alpha {alpha_err})")
    check(0 < fit_launches["rbf_gram_matvec"] <= GD_STEPS + 1,
          "gd_stable: not one Gram matvec a step")
    return add(fit_launches, serve_launches)


def r2_score(y, pred) -> float:
    y = np.asarray(y, np.float64)
    return 1.0 - float(np.sum((y - pred) ** 2) / np.sum((y - y.mean()) ** 2))


def phase_gd_svr(ops, data, SVR, dev, smo_r2):
    """SVR(solver="gd", engine="pallas") on the SVR phase's data: 2,000
    steps of one n-row Gram matvec each (the doubled matvec as [u; u])."""
    xtr, ytr, xte, yte = svr_split(data, 16384)
    kw = dict(solver="gd", engine="pallas", gd_steps=GD_STEPS)
    reg, fit_s, fit_launches = timed_fit(
        ops, lambda: SVR(**kw, device=dev), xtr, ytr)
    values, serve_launches = serve_heldout(ops, reg, xte)
    r2 = r2_score(yte, values)
    emit(phase="gd_svr", n_train=int(len(xtr)), qp_variables=2 * len(xtr),
         steps=GD_STEPS, lr=reg.gd_cfg.lr, fit_s=fit_s,
         ms_per_step=fit_s / GD_STEPS * 1e3, heldout_r2=r2,
         smo_heldout_r2=smo_r2, n_support=reg.n_support_,
         **loss_trend(reg.loss_curve_),
         gram_matvec_launches=fit_launches["rbf_gram_matvec"],
         launches=fit_launches, heldout_launches=serve_launches)
    check(0 < fit_launches["rbf_gram_matvec"] <= GD_STEPS + 1,
          "GD SVR: not one Gram matvec a step")
    check(bool(np.isfinite(values).all()), "GD SVR: values not finite")
    return add(fit_launches, serve_launches)


def phase_gd_ovo(ops, gd, dist, SVC, dev, split, smo_acc):
    """OvO GD on the overlapping Pavia split: each bucket's tasks step
    together, one task-axis Gram matvec launch a step; one task of the
    largest bucket against its lone ``gd.binary_gd`` on the card."""
    xtr, ytr, xte, yte = split
    kw = dict(solver="gd", engine="pallas", gd_steps=GD_OVO_STEPS,
              strategy="ovo")
    clf, fit_s, fit_launches = timed_fit(
        ops, lambda: SVC(**kw, device=dev), xtr, ytr)
    labels, serve_launches = serve_heldout(ops, clf, xte)
    acc = float(np.mean(labels == yte))
    saved = dict(ops.launches)
    bucket = max(clf._schedule.buckets, key=lambda b: b.width)
    xt, yt, mk, _ = dist._bucket_arrays(clf._taskset, bucket)
    s = 0
    t = int(bucket.task_ids.reshape(-1)[s])
    k = clf._taskset.tasks[t].size
    lone = gd.binary_gd(torch.from_numpy(xt[s]).to(dev),
                        torch.from_numpy(yt[s]).to(dev),
                        torch.from_numpy(mk[s]).to(dev), cfg=clf.gd_cfg,
                        kernel=clf.kernel_params, engine="pallas")
    alpha = lone.alpha.cpu().numpy()
    lone_ok = (bool(np.allclose(alpha[:k], clf._fit.alpha[t, :k], **GD_TOL))
               and abs(float(lone.b) - float(clf._fit.b[t])) <= 1e-4)
    equal = (bool(np.array_equal(alpha[:k], clf._fit.alpha[t, :k]))
             and float(lone.b) == float(clf._fit.b[t]))
    ops.launches.update(saved)   # the lone solve is not the path
    n_buckets = len(clf._schedule.buckets)
    matvecs = fit_launches["rbf_gram_matvec"]
    emit(phase="gd_ovo", config="overlapping",
         noise=PAVIA_NOISE["overlapping"], steps=GD_OVO_STEPS,
         lr=clf.gd_cfg.lr, n_train=int(len(xtr)),
         n_tasks=int(clf._taskset.n_tasks),
         buckets=[[int(b.width), int(b.n_slots)]
                  for b in clf._schedule.buckets],
         fit_s=fit_s, ms_per_step=fit_s / GD_OVO_STEPS * 1e3,
         heldout_acc=acc, smo_heldout_acc=smo_acc,
         n_support_max=int(np.max(clf.n_support_)),
         task_axis_matvec_launches=matvecs,
         expected_launches=GD_OVO_STEPS * n_buckets,
         lone_task=t, lone_task_size=int(k), lone_equal_bits=equal,
         lone_within_tol=lone_ok, lone_tol=GD_TOL,
         lone_alpha_max_abs_diff=float(np.abs(
             alpha[:k] - clf._fit.alpha[t, :k]).max()),
         launches=fit_launches, heldout_launches=serve_launches)
    check(matvecs == GD_OVO_STEPS * n_buckets, f"OvO GD: {matvecs} matvec "
          f"launches, not one a step a bucket ({GD_OVO_STEPS * n_buckets})")
    check(lone_ok, f"OvO GD: task {t} differs from its lone binary_gd")
    return add(fit_launches, serve_launches)


def phase_cascade_svc(ops, cascade, SVC, dev, split, base, base_acc):
    """SVC(shard="cascade", cascade_shards=4) on the exact SVC's split:
    leaves and merge levels as task-axis SMO (row and kkt_select
    kernels), the root on the binary path, the float64 certificate's
    Gram blocks on the block kernel; S = 1 against the unsharded fit
    ``base`` of phase_fit, bit for bit."""
    xtr, ytr, xte, yte = split
    kw = dict(shard="cascade", engine="pallas", shrink_every=4)
    g0 = graph_stats()
    clf, fit_s, fit_launches = timed_fit(ops, lambda: SVC(
        cascade_shards=CASCADE_SHARDS, **kw, device=dev), xtr, ytr)
    graph = graph_since(g0)
    labels, serve_launches = serve_heldout(ops, clf, xte)
    acc = float(np.mean(labels == yte))
    saved = dict(ops.launches)
    one = SVC(cascade_shards=1, **kw, device=dev).fit(xtr, ytr)
    same = (bool(np.array_equal(one.alpha_, base.alpha_))
            and one.b_ == base.b_)
    ops.launches.update(saved)   # the S = 1 check is not the path
    emit(phase="cascade_svc", n=int(len(xtr)), shards=CASCADE_SHARDS,
         rounds=clf.cascade_rounds_, history=list(clf.cascade_history_),
         cascade_kkt=clf.cascade_kkt_, tol=clf.smo_cfg.tol,
         converged=clf.converged_, n_iter=clf.n_iter_,
         n_support=clf.n_support_, fit_s=fit_s, heldout_acc=acc,
         unsharded_heldout_acc=base_acc, one_shard_equals_unsharded=same,
         graph=graph, launches=fit_launches,
         heldout_launches=serve_launches)
    check(clf.converged_ and clf.cascade_kkt_ <= 1e-3,
          f"cascade SVC: certificate {clf.cascade_kkt_} > 1e-3")
    check(abs(acc - base_acc) <= 0.01, f"cascade SVC accuracy {acc} not "
          f"within 0.01 of the unsharded fit's {base_acc}")
    check(same, "cascade SVC with one shard differs from the unsharded fit")
    for k_ in ("rbf_gram_row", "kkt_select", "rbf_gram"):
        check(fit_launches[k_] > 0, f"cascade SVC launched no {k_}")
    return add(fit_launches, serve_launches)


def phase_cascade_svc_lowrank(ops, cascade, SVC, dev, split, base_acc):
    """SVC(engine="rff", rank=1024, shard="cascade", cascade_shards=4):
    each level's nodes one batched DCD over their rows of the shared Phi
    (one task-axis dcd_epoch launch an epoch); the leaf level solved
    again against its lone ``linear_svc`` solves, bit for bit."""
    xtr, ytr, xte, yte = split
    kw = dict(engine="rff", rank=RANK, shard="cascade",
              cascade_shards=CASCADE_SHARDS)
    clf, fit_s, fit_launches = timed_fit(
        ops, lambda: SVC(**kw, device=dev), xtr, ytr)
    labels, serve_launches = serve_heldout(ops, clf, xte)
    acc = float(np.mean(labels == yte))
    saved = dict(ops.launches)
    phi = clf._feature_map.transform(torch.from_numpy(xtr).to(dev))
    yy = np.where(ytr == clf.classes_[1], 1.0, -1.0).astype(np.float32)
    adapter = cascade._DCDSVCAdapter(phi, yy, dcd_cfg=clf.dcd_cfg)
    leaves = [(p, None) for p in cascade.partition_indices(len(yy),
                                                           CASCADE_SHARDS)]
    level = adapter.solve_level(leaves)
    lone = [adapter.solve_level([leaf])[0] for leaf in leaves]
    level_equal = all(
        np.array_equal(a.alpha, b.alpha) and np.array_equal(a.w, b.w)
        and a.b == b.b and a.n_iter == b.n_iter for a, b in zip(level, lone))
    ops.launches.update(saved)   # the level check is not the path
    emit(phase="cascade_svc_lowrank", n=int(len(xtr)), rank=RANK,
         shards=CASCADE_SHARDS, rounds=clf.cascade_rounds_,
         history=list(clf.cascade_history_), cascade_kkt=clf.cascade_kkt_,
         tol=clf.dcd_cfg.tol, converged=clf.converged_,
         epochs=clf.n_iter_, fit_s=fit_s, heldout_acc=acc,
         unsharded_heldout_acc=base_acc,
         leaf_epochs=[int(v.n_iter) for v in level],
         level_equals_lone_solves=level_equal,
         launches=fit_launches, heldout_launches=serve_launches)
    check(clf.converged_ and clf.cascade_kkt_ <= 1e-3,
          f"low-rank cascade: certificate {clf.cascade_kkt_} > 1e-3")
    check(abs(acc - base_acc) <= 0.01, f"low-rank cascade accuracy {acc} "
          f"not within 0.01 of the unsharded low-rank fit's {base_acc}")
    check(level_equal, "low-rank cascade: a level's node differs from its "
          "lone linear_svc")
    check(fit_launches["dcd_epoch"] > 0, "low-rank cascade launched no "
          "dcd_epoch")
    return add(fit_launches, serve_launches)


def phase_cascade_svr(ops, data, SVR, dev):
    """The exact SVR cascade (S = 4) and the RFF one (rank 1,024), each
    on the SVR data cut to CASCADE_SVR_ROWS rows; both must certify."""
    paths = {}
    for name, kw in (("svr_cascade", dict(engine="pallas", shrink_every=4)),
                     ("svr_cascade_lowrank", dict(engine="rff", rank=RANK))):
        rows = CASCADE_SVR_ROWS[name]
        xtr, ytr, xte, yte = svr_split(data, rows)
        g0 = graph_stats()
        reg, fit_s, fit_launches = timed_fit(ops, lambda: SVR(
            shard="cascade", cascade_shards=CASCADE_SHARDS, **kw,
            device=dev), xtr, ytr)
        graph = graph_since(g0)
        values, serve_launches = serve_heldout(ops, reg, xte)
        emit(phase="cascade_svr", path=name, engine=kw["engine"],
             rows=rows, reduced=(f"{rows} of 16,384 rows: 5-6 rounds of "
                                 "near-full node solves (~70 % of the "
                                 "rows are SVs)"),
             n_train=int(len(xtr)), shards=CASCADE_SHARDS,
             rounds=reg.cascade_rounds_,
             history=list(reg.cascade_history_),
             cascade_kkt=reg.cascade_kkt_, tol=reg.smo_cfg.tol,
             converged=reg.converged_, n_iter=reg.n_iter_,
             n_support=reg.n_support_, fit_s=fit_s, graph=graph,
             heldout_r2=r2_score(yte, values), launches=fit_launches,
             heldout_launches=serve_launches)
        check(reg.converged_ and reg.cascade_kkt_ <= 1e-3,
              f"{name}: certificate {reg.cascade_kkt_} > 1e-3")
        paths[name] = add(fit_launches, serve_launches)
    return paths


# -------------------------------------------- the data-parallel SMO (A.11)
# SHARDED_RANKS processes on the one card, each a rank of one gloo group
# over a FileStore in a temporary directory (NCCL refuses two ranks on
# one device; launch.mesh.Mesh.all_reduce stages gloo's CUDA tensors
# through host memory), every collective timing out after 60 s. Threads
# would share one GIL: ~600 GIL hand-offs an SMO iteration across four
# ranks made a thread-rank iteration ~50 ms on the H100 (PERF.md).
SHARDED_RANKS = 4
# the SVR data cut to 512 rows (922 doubled variables): each iteration is
# two staged all_reduces across four ranks time-sharing the card, ~20 ms
# (2,048 rows took 7,254 iterations, 144 s: PERF.md)
SHARDED_SVR_ROWS = 512
# the poly-kernel sharded SVC's rows (~100 iterations)
SHARDED_POLY_ROWS = 2048
COLLECTIVE_TIMEOUT_S = 60
RANKS_TIMEOUT_S = 900        # the rank processes' whole run, at most


class Collectives:
    """Counts the mesh's all_reduce calls (every collective of the port)
    and their host seconds, while active."""

    def __enter__(self):
        from repro_torch.launch import mesh as M
        self.cls, self.orig = M.Mesh, M.Mesh.all_reduce
        self.calls, self.seconds = 0, 0.0
        orig = self.orig

        def counted(mesh, t, op="sum"):
            t0 = time.perf_counter()
            out = orig(mesh, t, op)
            self.calls += 1
            self.seconds += time.perf_counter() - t0
            return out

        self.cls.all_reduce = counted
        return self

    def __exit__(self, *exc):
        self.cls.all_reduce = self.orig


def sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def rank_fit(mesh, make, x, y, extract) -> dict:
    """One rank's part of a collective fit: after a barrier (an
    all_reduce), ``make().fit(x, y)`` timed, with this rank's kernel
    launches and all_reduce calls; ``extract(model)`` gives the rest."""
    from repro_torch.kernels import ops
    mesh.all_reduce(torch.zeros(1, device=mesh.device))
    sync(mesh.device)
    ops.reset_launches()
    with Collectives() as coll:
        t0 = time.perf_counter()
        model = make().fit(x, y)
        sync(mesh.device)
        fit_s = time.perf_counter() - t0
    return dict(fit_s=fit_s, launches=dict(ops.launches),
                all_reduces=coll.calls, all_reduce_s=coll.seconds,
                **extract(model))


def job_svc(mesh) -> dict:
    """The exact SVC's split, sample-sharded (``SVC(shard="data")``)."""
    from repro_torch import data
    from repro_torch.core.svm import SVC
    xtr, ytr, _, _ = binary_split(data)
    return rank_fit(mesh, lambda: SVC(
        engine="pallas", shrink_every=4, mesh=mesh, worker_axes=("shards",),
        shard="data", device=mesh.device), xtr, ytr,
        lambda c: dict(alpha=c.alpha_, b=c.b_, n_iter=c.n_iter_,
                       converged=c.converged_))


def job_svr(mesh) -> dict:
    """The SVR data cut to SHARDED_SVR_ROWS rows, its doubled axis
    sharded, default (unshrunk) configuration."""
    from repro_torch import data
    from repro_torch.core.svm import SVR
    xtr, ytr, xte, _ = svr_split(data, SHARDED_SVR_ROWS)
    return rank_fit(mesh, lambda: SVR(
        engine="pallas", epsilon=0.1, C=1.0, tol=1e-3, mesh=mesh,
        worker_axes=("shards",), shard="data", device=mesh.device), xtr, ytr,
        lambda r: dict(alpha=r.alpha_raw_, b=r.b_, n_iter=r.n_iter_,
                       converged=r.converged_, pred=r.predict(xte)))


def _multiclass_job(mesh, config, strategy, shard, engine):
    from repro_torch import data
    from repro_torch.core.svm import SVC
    xtr, ytr, xte, _ = pavia_split(data, PAVIA_NOISE[config])
    return rank_fit(mesh, lambda: SVC(
        strategy=strategy, decision="vote", engine=engine, C=1.0, tol=1e-3,
        mesh=mesh, worker_axes=("shards",), shard=shard,
        device=mesh.device), xtr, ytr,
        lambda c: dict(alpha=c._fit.alpha, b=c._fit.b, n_iter=c._fit.n_iter,
                       converged=c._fit.converged, labels=c.predict(xte)))


def job_ovo_task(mesh) -> dict:
    """The overlapping OvO fit, its bucket's slots over the workers."""
    return _multiclass_job(mesh, "overlapping", "ovo", "task", "pallas")


def job_ovr_data(mesh) -> dict:
    """The separable OvR fit, every task's samples over the ranks, no
    row cache (as the task path runs it: the uncached row-range entry)."""
    from repro_torch.core import kernel_engine as KE
    return _multiclass_job(mesh, "separable", "ovr", "data",
                           KE.EngineConfig(backend="pallas", cache_slots=0))


def job_svc_poly(mesh) -> dict:
    """A poly-kernel SVC on the exact SVC's split cut to
    SHARDED_POLY_ROWS rows, sample-sharded: its rows by the plain Gram
    function, each rank's block the whole call's slice."""
    from repro_torch import data
    from repro_torch.core.svm import SVC
    xtr, ytr = (a[:SHARDED_POLY_ROWS] for a in binary_split(data)[:2])
    return rank_fit(mesh, lambda: SVC(
        kernel="poly", engine="pallas", shrink_every=4, mesh=mesh,
        worker_axes=("shards",), shard="data", device=mesh.device), xtr, ytr,
        lambda c: dict(alpha=c.alpha_, b=c.b_, n_iter=c.n_iter_,
                       converged=c.converged_))


RANK_JOBS = {"svc": job_svc, "svc_poly": job_svc_poly, "svr": job_svr,
             "ovo_task": job_ovo_task,
             "ovr_data": job_ovr_data}


def rank_main(rank: int, n_ranks: int, store: str, jobs, queue,
              device: str) -> None:
    """A rank process: its gloo group and mesh on ``device``, then each
    job in turn; puts (rank, "ok", {job: result}) or (rank, "error",
    traceback) on ``queue``."""
    try:
        import datetime
        import torch.distributed as dist
        from repro_torch.kernels import _build
        from repro_torch.launch.mesh import make_shard_mesh
        torch.backends.cuda.matmul.allow_tf32 = False
        if device == "cuda":
            _build.library()   # built by the parent: loaded, not compiled
        group = dist.ProcessGroupGloo(
            dist.FileStore(store, n_ranks), rank, n_ranks,
            datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
        mesh = make_shard_mesh(n_ranks, group=group, device=device)
        queue.put((rank, "ok", {j: RANK_JOBS[j](mesh) for j in jobs}))
    except BaseException:
        import traceback
        queue.put((rank, "error", traceback.format_exc()))


def run_rank_jobs(jobs, n_ranks: int = SHARDED_RANKS,
                  device: str = "cuda") -> tuple[dict, float]:
    """Each job of RANK_JOBS as a collective call of ``n_ranks`` spawned
    rank processes: ({job: [rank 0's result, ...]}, wall s). A failing
    rank fails the phase; every process is stopped before returning."""
    import multiprocessing as mp
    import queue as queue_mod
    import tempfile
    ctx = mp.get_context("spawn")
    results, t0 = {}, time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        q = ctx.Queue()
        procs = [ctx.Process(target=rank_main, args=(
            r, n_ranks, os.path.join(tmp, "store"), list(jobs), q, device),
            daemon=True) for r in range(n_ranks)]
        for p in procs:
            p.start()
        try:
            deadline = time.monotonic() + RANKS_TIMEOUT_S
            while len(results) < n_ranks:
                try:
                    rank, status, out = q.get(timeout=max(
                        1.0, deadline - time.monotonic()))
                except queue_mod.Empty:
                    raise SmokeFailure(f"rank processes did not finish in "
                                       f"{RANKS_TIMEOUT_S} s")
                check(status == "ok", f"rank {rank} failed:\n{out}")
                results[rank] = out
        finally:
            for p in procs:
                p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join()
    return ({j: [results[r][j] for r in range(n_ranks)] for j in jobs},
            time.perf_counter() - t0)


def summed_launches(ranks) -> dict:
    return {k: sum(r["launches"][k] for r in ranks)
            for k in ranks[0]["launches"]}


def per_rank_iter(launches, n_ranks: int, n_iter: int) -> dict:
    return {k: v / n_ranks / max(n_iter, 1) for k, v in launches.items() if v}


def ranks_equal(ranks, want: dict) -> bool:
    """Every rank's result equals ``want`` bit for bit, key by key."""
    return all(np.array_equal(np.asarray(r[k]), np.asarray(v))
               for r in ranks for k, v in want.items())


def collective_stats(ranks, n_iter: int) -> dict:
    """A collective fit's wall time (the slowest rank's), its ms an
    iteration, all_reduces an iteration on each rank and their host s."""
    fit_s = max(r["fit_s"] for r in ranks)
    return dict(fit_s=fit_s, ms_per_iter=fit_s * 1e3 / max(n_iter, 1),
                all_reduces_per_iter=ranks[0]["all_reduces"] / max(n_iter, 1),
                all_reduce_host_s_rank0=ranks[0]["all_reduce_s"])


def svc_certificate(smo, KE, alpha, clf, xtr, ytr, dev) -> float:
    """float64 KKT of a binary fit's ``alpha`` from a gradient recomputed
    by one matvec (the check is not the path: its launch is not
    counted)."""
    yy = torch.from_numpy(np.where(ytr == clf.classes_[1], 1.0, -1.0)
                          .astype(np.float32)).to(dev)
    a = torch.from_numpy(alpha).to(dev)
    eng = KE.make_engine(torch.from_numpy(xtr).to(dev), clf.kernel_params,
                         "pallas")
    f = eng.matvec(a * yy) - yy
    return float(smo.kkt_violation(a, yy, f, 0.0, clf.smo_cfg.C))


def phase_sharded_svc(ops, smo, KE, SVC, dev, split, base, ranks, spawn):
    """The exact SVC's split sample-sharded over SHARDED_RANKS rank
    processes (``SVC(mesh=, shard="data")``): every rank's alphas, b and
    n_iter equal the ``fit`` phase's unsharded fit bit for bit, and its
    certificate holds."""
    xtr, ytr = split[:2]
    saved = dict(ops.launches)
    t0 = time.perf_counter()
    again = SVC(engine="pallas", shrink_every=4, device=dev).fit(xtr, ytr)
    torch.cuda.synchronize()
    base_s = time.perf_counter() - t0   # the unsharded fit, warm
    kkt = svc_certificate(smo, KE, ranks[0]["alpha"], base, xtr, ytr, dev)
    ops.launches.update(saved)
    n_iter = ranks[0]["n_iter"]
    launches = summed_launches(ranks)
    equal = ranks_equal(ranks, dict(alpha=base.alpha_, b=base.b_,
                                    n_iter=base.n_iter_))
    stats = collective_stats(ranks, n_iter)
    emit(phase="sharded_svc", ranks=SHARDED_RANKS, backend="gloo",
         processes="one a rank, spawned; the ranks' start-up "
                   f"{spawn['startup_s']:.1f} s, all rank jobs "
                   f"{spawn['wall_s']:.1f} s",
         collectives="all_reduce, CUDA tensors staged through host memory",
         n=int(xtr.shape[0]), d=int(xtr.shape[1]), shrink_every=4,
         n_iter=n_iter, n_iter_unsharded=base.n_iter_, **stats,
         unsharded_fit_s_warm=base_s,
         unsharded_ms_per_iter=base_s * 1e3 / max(again.n_iter_, 1),
         kernels_per_iter_per_rank=per_rank_iter(launches, SHARDED_RANKS,
                                                 n_iter),
         launches=launches, equal_unsharded=equal, kkt_f64=kkt,
         tol=base.smo_cfg.tol,
         note="the ranks share one card: this measures the collectives' "
              "cost, not scaling")
    check(equal, "sharded_svc: a rank's alphas / b / n_iter differ from "
          "the unsharded fit")
    check(all(r["converged"] for r in ranks) and kkt <= base.smo_cfg.tol,
          f"sharded_svc: f64 KKT {kkt} > tol")
    for k in ("rbf_gram_row_cached_range", "rbf_gram_matvec_range",
              "kkt_select"):
        check(launches[k] > 0, f"sharded_svc launched no {k}")
    return launches


def phase_sharded_svc_nccl(ops, SVC, dev, split, base):
    """The same fit on a one-rank NCCL group (``init_process_group`` over
    an in-memory store): the MPI-CUDA transport on the card, collectives
    stream-ordered. Bits equal to the unsharded fit."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_shard_mesh
    xtr, ytr = split[:2]
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_shard_mesh(1, device=dev)
        mesh.all_reduce(torch.zeros(1, device=dev))   # NCCL's set-up
        r = rank_fit(mesh, lambda: SVC(
            engine="pallas", shrink_every=4, mesh=mesh,
            worker_axes=("shards",), shard="data", device=dev), xtr, ytr,
            lambda c: dict(alpha=c.alpha_, b=c.b_, n_iter=c.n_iter_))
    finally:
        dist.destroy_process_group()
    equal = ranks_equal([r], dict(alpha=base.alpha_, b=base.b_,
                                  n_iter=base.n_iter_))
    emit(phase="sharded_svc_nccl", ranks=1, backend="nccl",
         n_iter=r["n_iter"], **collective_stats([r], r["n_iter"]),
         launches=r["launches"], equal_unsharded=equal)
    check(equal, "sharded_svc_nccl: the one-rank NCCL fit differs from the "
          "unsharded fit")
    check(r["launches"]["rbf_gram_row_cached"] > 0
          and r["launches"]["kkt_select"] > 0,
          "sharded_svc_nccl launched no row or selection kernel")
    return r["launches"]


def phase_sharded_svc_poly(ops, data, smo, KE, SVC, dev, ranks):
    """The poly-kernel SVC on SHARDED_POLY_ROWS rows over SHARDED_RANKS
    rank processes (the sharded engine takes every kernel, ROADMAP A.11):
    every rank's alphas, b and n_iter equal the unsharded fit's on the
    card bit for bit, and its certificate holds."""
    xtr, ytr = (a[:SHARDED_POLY_ROWS] for a in binary_split(data)[:2])
    saved = dict(ops.launches)
    t0 = time.perf_counter()
    base = SVC(kernel="poly", engine="pallas", shrink_every=4,
               device=dev).fit(xtr, ytr)
    torch.cuda.synchronize()
    base_s = time.perf_counter() - t0
    kkt = svc_certificate(smo, KE, ranks[0]["alpha"], base, xtr, ytr, dev)
    ops.launches.update(saved)
    n_iter = ranks[0]["n_iter"]
    launches = summed_launches(ranks)
    equal = ranks_equal(ranks, dict(alpha=base.alpha_, b=base.b_,
                                    n_iter=base.n_iter_))
    emit(phase="sharded_svc_poly", ranks=SHARDED_RANKS, backend="gloo",
         kernel="poly", gamma=base.kernel_params.gamma,
         degree=base.kernel_params.degree, rows=SHARDED_POLY_ROWS,
         reduced=f"{SHARDED_POLY_ROWS} of 29,491 rows",
         n_iter=n_iter, n_iter_unsharded=base.n_iter_,
         **collective_stats(ranks, n_iter), unsharded_fit_s=base_s,
         n_support=int(np.sum(base.alpha_ > 0)),
         kernels_per_iter_per_rank=per_rank_iter(launches, SHARDED_RANKS,
                                                 n_iter),
         launches=launches, equal_unsharded=equal, kkt_f64=kkt,
         tol=base.smo_cfg.tol)
    check(equal, "sharded_svc_poly: a rank's alphas / b / n_iter differ "
          "from the unsharded fit")
    check(all(r["converged"] for r in ranks) and kkt <= base.smo_cfg.tol,
          f"sharded_svc_poly: f64 KKT {kkt} > tol")
    check(launches["kkt_select"] > 0, "sharded_svc_poly launched no "
          "kkt_select")
    return launches


def phase_sharded_svr(ops, data, smo, KE, SVR, dev, ranks):
    """epsilon-SVR on the SVR data cut to SHARDED_SVR_ROWS rows, its
    doubled axis sharded over SHARDED_RANKS rank processes in the default
    (unshrunk) configuration: bits equal to the unsharded ``svr_smo`` at
    the same cut, certificate <= 1e-3."""
    xtr, ytr, xte, yte = svr_split(data, SHARDED_SVR_ROWS)
    saved = dict(ops.launches)
    t0 = time.perf_counter()
    base = SVR(engine="pallas", epsilon=0.1, C=1.0, tol=1e-3,
               device=dev).fit(xtr, ytr)
    torch.cuda.synchronize()
    base_s = time.perf_counter() - t0
    n = len(xtr)
    xt, yt = torch.from_numpy(xtr).to(dev), torch.from_numpy(ytr).to(dev)
    s = torch.cat([torch.ones(n, device=dev), -torch.ones(n, device=dev)])
    p = torch.cat([0.1 - yt, 0.1 + yt])
    a2 = torch.from_numpy(ranks[0]["alpha"]).to(dev)
    eng = KE.make_engine(torch.cat([xt, xt]), base.kernel_params, "pallas")
    kkt = float(smo.kkt_violation(a2, s, eng.matvec(a2 * s) + s * p, 0.0,
                                  1.0))
    ops.launches.update(saved)
    n_iter = ranks[0]["n_iter"]
    launches = summed_launches(ranks)
    equal = ranks_equal(ranks, dict(alpha=base.alpha_raw_, b=base.b_,
                                    n_iter=base.n_iter_))
    emit(phase="sharded_svr", ranks=SHARDED_RANKS, backend="gloo",
         rows=SHARDED_SVR_ROWS, n_train=n, doubled=2 * n,
         reduced=f"{SHARDED_SVR_ROWS} of 16,384 rows: ~20 ms an iteration "
                 "on 4 ranks sharing the card",
         n_iter=n_iter, **collective_stats(ranks, n_iter),
         unsharded_fit_s=base_s,
         unsharded_ms_per_iter=base_s * 1e3 / max(base.n_iter_, 1),
         kernels_per_iter_per_rank=per_rank_iter(launches, SHARDED_RANKS,
                                                 n_iter),
         launches=launches, equal_unsharded=equal, kkt_f64=kkt, tol=1e-3,
         heldout_r2=r2_score(yte, ranks[0]["pred"]))
    check(equal, "sharded_svr: a rank's result differs from the unsharded "
          "svr_smo")
    check(ranks[0]["converged"] and kkt <= 1e-3,
          f"sharded_svr: f64 KKT {kkt} > 1e-3")
    for k in ("rbf_gram_row_cached_range", "kkt_select"):
        check(launches[k] > 0, f"sharded_svr launched no {k}")
    return launches


def phase_mesh_multiclass(ops, smo, KE, dev, overlapping, separable,
                          task_ranks, data_ranks):
    """Multiclass on a SHARDED_RANKS-worker mesh: the overlapping OvO fit
    task-parallel (``SVC(mesh=, shard="task")``: each rank solves the
    slots the LPT layout gave it, one all_reduce a bucket), every task's
    alpha, b and n_iter equal to the fit without a mesh; the separable
    OvR fit data-parallel (``SVC(mesh=, shard="data")``), labels equal
    and every task certified."""
    ovo = overlapping[1]["ovo"][0]
    task_equal = ranks_equal(task_ranks, dict(
        alpha=ovo._fit.alpha, b=ovo._fit.b, n_iter=ovo._fit.n_iter))
    (_, _, xte, yte), sep = separable[0], separable[1]["ovr"][0]
    kkt = task_certificates(ops, smo, KE, sep, dev,
                            alpha=data_ranks[0]["alpha"])
    want = sep.predict(xte)
    same = all(np.array_equal(r["labels"], want) for r in data_ranks)
    alpha_equal = all(np.array_equal(r["alpha"], sep._fit.alpha)
                      for r in data_ranks)
    task_launches = summed_launches(task_ranks)
    data_launches = summed_launches(data_ranks)
    iters = int(np.sum(data_ranks[0]["n_iter"]))
    emit(phase="mesh_multiclass", ranks=SHARDED_RANKS,
         task=dict(config="overlapping", strategy="ovo", shard="task",
                   n_tasks=int(ovo._taskset.n_tasks),
                   fit_s=max(r["fit_s"] for r in task_ranks),
                   all_reduces=task_ranks[0]["all_reduces"],
                   launches=task_launches, equal_no_mesh=task_equal),
         data=dict(config="separable", strategy="ovr", shard="data",
                   n_tasks=int(sep._taskset.n_tasks),
                   n_iter=[int(v) for v in data_ranks[0]["n_iter"]],
                   **collective_stats(data_ranks, iters),
                   launches=data_launches, kkt_f64_max=max(kkt),
                   labels_equal_no_mesh=same,
                   alpha_equal_no_mesh=alpha_equal,
                   heldout_acc=float(np.mean(data_ranks[0]["labels"]
                                             == yte))))
    check(task_equal, "mesh_multiclass: a task of the 4-worker OvO fit "
          "differs from the fit without a mesh")
    check(same, "mesh_multiclass: data-parallel OvR labels differ from the "
          "fit without a mesh")
    check(all(all(r["converged"]) for r in data_ranks) and max(kkt) <= 1e-3,
          f"mesh_multiclass: a task's f64 KKT {max(kkt)} > 1e-3")
    check(data_launches["rbf_gram_row_range"] > 0,
          "mesh_multiclass launched no uncached row-range entry")
    return add(task_launches, data_launches)


def phase_data_parallel(ops, data, smo, KE, SVC, SVR, dev, binary, base,
                        mc_configs) -> dict:
    """Every data-parallel path: the rank processes' jobs (one spawn for
    all of them), then the one-rank NCCL fit in this process; one
    launch-count dict a path."""
    t0 = time.perf_counter()
    jobs, wall_s = run_rank_jobs(RANK_JOBS)
    spawn = dict(wall_s=wall_s, startup_s=wall_s - sum(
        max(r["fit_s"] for r in ranks) for ranks in jobs.values()))
    paths = {
        "svc_sharded": phase_sharded_svc(ops, smo, KE, SVC, dev, binary,
                                         base, jobs["svc"], spawn),
        "svc_sharded_nccl": phase_sharded_svc_nccl(ops, SVC, dev, binary,
                                                   base),
        "svc_sharded_poly": phase_sharded_svc_poly(ops, data, smo, KE, SVC,
                                                   dev, jobs["svc_poly"]),
        "svr_sharded": phase_sharded_svr(ops, data, smo, KE, SVR, dev,
                                         jobs["svr"]),
        "svc_mesh_multiclass": phase_mesh_multiclass(
            ops, smo, KE, dev, mc_configs["overlapping"],
            mc_configs["separable"], jobs["ovo_task"], jobs["ovr_data"])}
    emit(phase="data_parallel", seconds=time.perf_counter() - t0, **spawn)
    return paths


def phase_row_range(ops, K, G, dev, xtr, gamma, launches):
    """The row-range entries (one rank's rows of the data-parallel SMO)
    against the whole call's slice, bit for bit, in fp32 and bf16, at
    ranges of n / SHARDED_RANKS rows (row0 = 7,373 k: not a multiple of
    the row kernel's 32-row chunks or the matvec's 128-row tiles), at the
    sharded engine's blocks (whole 32-row chunks) and a range that ends
    past n; then each entry timed at rank 1's block of the engine
    (``kernels`` rows), beside the whole call."""
    saved = dict(ops.launches)
    x = torch.from_numpy(xtr).to(dev)
    n, d = x.shape
    quarter = -(-n // SHARDED_RANKS)
    block = -(-n // (SHARDED_RANKS * G.ROW_CHUNK)) * G.ROW_CHUNK
    i = torch.tensor(n // 3, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    v = torch.randn(n, generator=gen, device=dev)
    errs, cases = {}, []
    for dt in (torch.float32, torch.bfloat16):
        xk = x.to(dt)
        x2 = K.sqnorms(xk)
        xs = G.staged(xk)
        row = ops.gram_row(xk, x2, i, gamma=gamma)
        mv = ops.gram_matvec(xs, x2, v, gamma=gamma)
        for r0, count in ([(r * quarter, quarter)
                           for r in range(SHARDED_RANKS)]
                          + [(r * block, block) for r in (1, 3)]
                          + [(n - 5, quarter)]):
            valid = max(0, min(count, n - r0))
            pad = torch.zeros(count - valid, device=dev)
            want_row = torch.cat([row[r0:r0 + valid], pad])
            want_mv = torch.cat([mv[r0:r0 + valid], pad])
            got_row = ops.gram_row(xk, x2, i, gamma=gamma, row0=r0,
                                   count=count)
            got_mv = ops.gram_matvec(xs, x2, v, gamma=gamma, row0=r0,
                                     count=count)
            cache = fresh_row_cache(count, dev)
            miss = ops.gram_row_cached(xk, x2, i, *cache, gamma=gamma,
                                       row0=r0, count=count)
            hit = ops.gram_row_cached(xk, x2, i, *cache, gamma=gamma,
                                      row0=r0, count=count)
            got = {"rbf_gram_row_range": got_row,
                   "rbf_gram_matvec_range": got_mv,
                   "rbf_gram_row_cached_range": torch.maximum(
                       (miss - want_row).abs(), (hit - want_row).abs())}
            ok = (torch.equal(got_row, want_row)
                  and torch.equal(got_mv, want_mv)
                  and torch.equal(miss, want_row)
                  and torch.equal(hit, want_row))
            cases.append(dict(dtype=str(dt)[6:], row0=r0, count=count,
                              valid=valid, equal=ok))
            for k, g in got.items():
                want = want_mv if "matvec" in k else want_row
                e = (float(g.max()) if k.endswith("cached_range")
                     else max_err(g, want))
                errs[k] = max(errs.get(k, 0.0), e)
    emit(phase="row_range", ranks=SHARDED_RANKS, n=n, d=d, cases=cases,
         max_abs_err=errs)
    check(all(c["equal"] for c in cases), "row_range: a range is not the "
          f"whole call's slice bit for bit: {cases}")

    # timing at rank 1's block of the sharded engine, beside the whole
    # call
    x2 = K.sqnorms(x)
    xs = G.staged(x)
    r0 = count = block
    turn = [torch.tensor(j, device=dev) for j in range(0, n, n // 64)][:64]
    kern_cache, plain_cache = (fresh_row_cache(count, dev),
                               fresh_row_cache(count, dev))
    turns = {"kern": 0, "plain": 0}

    def next_row(which):
        turns[which] += 1
        return turn[turns[which] % len(turn)]

    def lib_rbf(a, b):
        return torch.exp(-gamma * torch.cdist(a, b).square())

    xr = x[r0:r0 + count]
    rows = [
        ("rbf_gram_matvec_range", "rbf_gram.cu",
         "src/repro/kernels/rbf_gram.py:91",
         lambda: ops.gram_matvec(xs, x2, v, gamma=gamma, row0=r0,
                                 count=count),
         lambda: G.gram_matvec_plain(x, x2, v, gamma=gamma, row0=r0,
                                     count=count),
         lambda: torch.cat([lib_rbf(xr[s:s + 2048], x) @ v
                            for s in range(0, count, 2048)]),
         4 * (count * d + n * d + count + 2 * n), count * n * (2 * d + 8)),
        ("rbf_gram_row_range", "rbf_gram.cu",
         "src/repro/kernels/rbf_gram.py:91",
         lambda: ops.gram_row(x, x2, i, gamma=gamma, row0=r0, count=count),
         lambda: G.gram_row_plain(x, x2, i, gamma=gamma, row0=r0,
                                  count=count),
         lambda: lib_rbf(xr, x[n // 3:n // 3 + 1]),
         4 * (count * d + d + 2 * count + 1), count * (2 * d + 6)),
        ("rbf_gram_row_cached_range", "rbf_gram.cu",
         "src/repro/kernels/rbf_gram.py:91",
         lambda: ops.gram_row_cached(x, x2, next_row("kern"), *kern_cache,
                                     gamma=gamma, row0=r0, count=count),
         lambda: G.lru_row_plain(*plain_cache, next_row("plain"),
                                 lambda j: G.gram_row_plain(
                                     x, x2, j, gamma=gamma, row0=r0,
                                     count=count)),
         None,
         4 * (count * d + d + 3 * count + 1) + 16 * ROW_CACHE_SLOTS + 32,
         count * (2 * d + 6)),
    ]
    out = [time_row(ops, *row, launches, errs[row[0]]) for row in rows]
    matvec = out[0]
    matvec.update(gram_bounds(count, n, d, "fp32",
                              4 * (count * d + n * d + count + 2 * n),
                              matvec=True),
                  library_composition="chunked exp(-gamma cdist^2) @ v over "
                                      "the range's rows",
                  library_composition_ms=matvec["library_ms"],
                  library_composition_device_ms=matvec["library_device_ms"],
                  library_ms=None, library_device_ms=None,
                  whole_call_device_ms=device_ms(lambda: ops.gram_matvec(
                      xs, x2, v, gamma=gamma)),
                  shape=f"{count} x {n} x {d}")
    for row, whole in ((out[1], lambda: ops.gram_row(x, x2, i, gamma=gamma)),
                       (out[2], None)):
        row["shape"] = f"{count} of {n} x {d}"
        if whole is not None:
            row["whole_call_device_ms"] = device_ms(whole)
    ops.launches.update(saved)
    return out


# ------------------------------------ serving: schema v3 banks, registry,
# and the dynamic-batching service under open-loop load
QUANT_GATE = 3e-2             # tests/test_serve_service.py (reported here)
QUANT_DTYPES = {"fp16": torch.float16, "bf16": torch.bfloat16}
# benchmarks/bench_serving_load.py: the batching window, the offered
# rates as multiples of the per-request batch-1 capacity, its CI gate (the
# reference's committed full run targets 2x), and its replay's length
WINDOW_MS = 2.0
RATE_FACTORS = (0.5, 1.5, 4.0)
SPEEDUP_GATE = 1.3
SPEEDUP_TARGET = 2.0
LOAD_SECONDS = 2.0
LOAD_MAX_REQUESTS = 6000
FUTURE_TIMEOUT_S = 60
LOAD_OPS = ("values", "predict")   # request i asks for LOAD_OPS[i % 2]


def bank_bytes(pred) -> dict:
    """Device bytes of a predictor's resident banks, by array."""
    return {"sv_x": sum(sv.nbytes for sv, _, _, _ in pred._banks),
            "sv_coef": sum(cf.nbytes for _, cf, _, _ in pred._banks),
            "b": sum(b.nbytes for _, _, b, _ in pred._banks)}


def constructed(make):
    """(what ``make`` returns, torch.cuda.memory_allocated's growth over
    the call)."""
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    out = make()
    torch.cuda.synchronize()
    return out, torch.cuda.memory_allocated() - m0


def add_launches(*counts) -> dict:
    return {k: sum(c[k] for c in counts) for k in counts[0]}


def quantized_bits_equal(ops, pred, x, dev) -> bool:
    """Every bank of a quantized predictor, read by the kernel at its
    storage dtype, against the float32 kernel on the upcast bank, over
    the rows ``x``: equal bit for bit (comparison launches, not the
    path's)."""
    saved = dict(ops.launches)
    z = torch.from_numpy(x).to(dev)
    gamma = pred.model.kernel.gamma
    same = all(torch.equal(ops.multitask_decision(z, sv, cf, gamma=gamma),
                           ops.multitask_decision(z, sv.float(), cf,
                                                  gamma=gamma))
               for sv, cf, _, _ in pred._banks)
    ops.launches.update(saved)
    return same


def phase_serve_quantized(ops, serve_mod, dev, out_dir, packs) -> dict:
    """Each pack (``packs``: name -> (fp32 pack, held-out rows, labels))
    quantized to fp16 and bf16, saved as schema v3, loaded and served by
    ``Predictor(engine="pallas")`` from its storage dtype; each beside the
    fp32 pack's predictor (its construction's memory, its decisions,
    labels and accuracy; not the path's launches)."""
    entries, path_launches = [], []
    for name, (packed, xte, yte) in packs.items():
        saved = dict(ops.launches)
        full, full_mem = constructed(lambda: serve_mod.Predictor(
            packed, engine="pallas", device=dev))
        df_full = full.decision_values(xte)
        labels_full = full.decode(df_full, "predict")
        full_bytes = bank_bytes(full)
        del full
        ops.launches.update(saved)
        for sv_dtype, dt in QUANT_DTYPES.items():
            path = os.path.join(out_dir, f"chip_smoke_{name}_{sv_dtype}.npz")
            serve_mod.save(path, serve_mod.quantize(packed, sv_dtype))
            with np.load(path) as z:
                version = json.loads(str(z["meta"]))["version"]
            loaded = serve_mod.load(path)
            ops.reset_launches()
            pred, mem = constructed(lambda: serve_mod.Predictor(
                loaded, engine="pallas", device=dev))
            rates, _ = serve_rates(pred, xte)
            dfs = pred.decision_values(xte)
            labels = pred.decode(dfs, "predict")
            alone = alone_equal_batch(pred, xte)
            torch.cuda.synchronize()
            launches = dict(ops.launches)
            bits = quantized_bits_equal(ops, pred, xte, dev)
            chunked = serve_mod.Predictor(loaded, engine="chunked",
                                          device=dev).decision_values(xte)
            ops.launches.update(launches)
            path_launches.append(launches)
            nbytes = bank_bytes(pred)
            entry = dict(
                pack=name, sv_dtype=sv_dtype, schema_version=version,
                banks=[[list(sv.shape), str(sv.dtype)]
                       for sv, _, _, _ in pred._banks],
                bank_bytes=nbytes, fp32_bank_bytes=full_bytes,
                memory_allocated_delta=mem, fp32_memory_allocated_delta=full_mem,
                kernel_bits_equal_fp32_on_upcast=bits,
                max_abs_err_vs_chunked=float(np.abs(dfs - chunked).max()),
                max_abs_delta_vs_fp32_pack=float(np.abs(dfs - df_full).max()),
                within_quant_gate=bool(np.abs(dfs - df_full).max()
                                       <= QUANT_GATE),
                labels_differing_from_fp32=int(np.sum(labels != labels_full)),
                n_test=int(len(xte)),
                rows_alone_equal_batch=alone, rows_per_s=rates,
                launches={k: v for k, v in launches.items() if v})
            if yte is not None:
                entry.update(heldout_acc=float(np.mean(labels == yte)),
                             fp32_heldout_acc=float(np.mean(
                                 labels_full == yte)))
            entries.append(entry)
            what = f"serve_quantized {name} {sv_dtype}"
            check(version == 3 and loaded.sv_dtype == sv_dtype,
                  f"{what}: the artifact is not schema v3 at {sv_dtype}")
            check(all(sv.dtype == dt for sv, _, _, _ in pred._banks),
                  f"{what}: a bank is not resident at its storage dtype")
            check(2 * nbytes["sv_x"] == full_bytes["sv_x"],
                  f"{what}: sv_x takes {nbytes['sv_x']} bytes, the fp32 "
                  f"predictor's {full_bytes['sv_x']}")
            check(bits, f"{what}: the kernel's decisions differ from the "
                  "fp32 kernel's on the upcast bank")
            check(bool(np.allclose(dfs, chunked, **DECISION_TOL)),
                  f"{what}: decisions differ from the chunked predictor")
            check(alone, f"{what}: a row served alone differs from the same "
                  "row in a 1,024-row request")
            check(launches[f"multitask_decision_{sv_dtype}_bank"] > 0
                  and launches["multitask_decision"] == 0,
                  f"{what}: the path did not serve through the "
                  f"{sv_dtype}-bank kernel alone: {launches}")
            del pred
    emit(phase="serve_quantized", quant_gate=QUANT_GATE, packs=entries)
    return add_launches(*path_launches)


class PerRequestServer:
    """The no-batching baseline of ``benchmarks/bench_serving_load.py``:
    one worker thread, one predictor call a request, in arrival order."""

    def __init__(self, pred):
        import queue
        import threading
        self._pred = pred
        self._q = queue.Queue()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def submit(self, x, op):
        from concurrent.futures import Future
        fut = Future()
        self._q.put((x, op, fut))
        return fut

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            x, op, fut = item
            try:
                fut.set_result(self._pred.decode(
                    self._pred.decision_values(x), op))
            except Exception as e:   # noqa: BLE001 -- handed to the caller
                fut.set_exception(e)

    def close(self) -> None:
        self._q.put(None)
        self._worker.join(FUTURE_TIMEOUT_S)


class ReplayProbe:
    """While active: the host time of every ``decision_values`` call of
    the given predictors (the service's flushes, the per-request
    server's calls) and every garbage collection's pause, to tell a
    stall in the serving work from one outside it."""

    def __init__(self, preds):
        self.preds, self.calls, self.gcs, self._gc_t0 = preds, [], [], None
        self.gc_info = []   # (generation, objects collected) a pause

    def __enter__(self):
        import gc
        for pred in self.preds:
            orig = pred.decision_values

            def timed(x, _orig=orig):
                t0 = time.perf_counter()
                out = _orig(x)
                self.calls.append((time.perf_counter() - t0) * 1e3)
                return out

            pred.decision_values = timed   # an instance attribute
        gc.callbacks.append(self._gc)
        return self

    def _gc(self, phase, info):
        if phase == "start":
            self._gc_t0 = time.perf_counter()
        elif self._gc_t0 is not None:
            self.gcs.append((time.perf_counter() - self._gc_t0) * 1e3)
            self.gc_info.append((info["generation"], info["collected"]))

    def __exit__(self, *exc):
        import gc
        gc.callbacks.remove(self._gc)
        for pred in self.preds:
            del pred.decision_values

    def summary(self) -> dict:
        calls = np.array(self.calls or [0.0])
        return {"calls": len(self.calls),
                "call_ms_p50": float(np.percentile(calls, 50)),
                "call_ms_p99": float(np.percentile(calls, 99)),
                "call_ms_max": float(calls.max()),
                "call_ms_total": float(calls.sum()),
                "gc_pauses": len(self.gcs),
                "gc_ms_max": max(self.gcs, default=0.0),
                # the longest pause's generation and objects collected:
                # a pause that frees an earlier phase's cyclic garbage
                # collects many, one over a live heap few
                "gc_max_generation_collected": list(self.gc_info[
                    int(np.argmax(self.gcs))]) if self.gcs else None,
                "gc_ms_total": float(sum(self.gcs))}


def draw_schedule(rng, rate: float, sizes, probs):
    """Poisson arrivals (s) at ``rate`` over LOAD_SECONDS, at most
    LOAD_MAX_REQUESTS, with iid request sizes."""
    arrivals = np.cumsum(rng.exponential(1.0 / rate, LOAD_MAX_REQUESTS))
    arrivals = arrivals[arrivals < LOAD_SECONDS]
    return arrivals, rng.choice(sizes, size=len(arrivals), p=probs)


def replay(submit, arrivals, sizes, models, pools, rng) -> dict:
    """Open-loop replay: request i (``sizes[i]`` rows of model
    ``models[i % len(models)]``'s pool, op LOAD_OPS[i % 2]) submitted at
    its scheduled instant, never waiting for completions; latency =
    completion - scheduled arrival. Returns the summary and the records."""
    starts = [int(rng.integers(0, len(pools[models[i % len(models)]]) - n
                               + 1)) for i, n in enumerate(sizes)]
    recs = []
    t0 = time.perf_counter()
    for i, (arrival, n) in enumerate(zip(arrivals, sizes)):
        now = time.perf_counter() - t0
        if arrival > now:
            time.sleep(arrival - now)
        m, s, op = models[i % len(models)], starts[i], LOAD_OPS[i % 2]
        rec = {"sched": float(arrival), "rows": int(n), "model": m,
               "start": s, "op": op}
        fut = submit(pools[m][s:s + n], m, op)
        fut.add_done_callback(
            lambda f, rec=rec: rec.__setitem__("done",
                                               time.perf_counter() - t0))
        rec["future"] = fut
        recs.append(rec)
    for rec in recs:
        rec["out"] = rec.pop("future").result(timeout=FUTURE_TIMEOUT_S)
    deadline = time.perf_counter() + FUTURE_TIMEOUT_S
    while (any("done" not in r for r in recs)   # callbacks run after result
           and time.perf_counter() < deadline):
        time.sleep(1e-4)
    check(all("done" in r for r in recs), "a completion was not recorded")
    lat = np.array([r["done"] - r["sched"] for r in recs])
    span = max(r["done"] for r in recs) - recs[0]["sched"]
    rows = sum(r["rows"] for r in recs)
    return {"n_requests": len(recs), "n_rows": int(rows), "span_s": span,
            "sustained_rows_per_s": rows / span,
            "sustained_requests_per_s": len(recs) / span,
            "p50_ms": float(np.percentile(lat, 50)) * 1e3,
            "p99_ms": float(np.percentile(lat, 99)) * 1e3}, recs


def responses_equal(reg, pools, recs, cache) -> tuple[int, int]:
    """(responses, those equal to the same rows served alone by their
    model's predictor: decision values bit for bit, labels exactly)."""
    equal = 0
    for r in recs:
        key = (r["model"], r["start"], r["rows"])
        pred = reg.get(r["model"])
        if key not in cache:
            s, n = r["start"], r["rows"]
            cache[key] = pred.decision_values(pools[r["model"]][s:s + n])
        want = (cache[key] if r["op"] == "values"
                else pred.decode(cache[key], "predict"))
        equal += bool(np.array_equal(r["out"], want))
    return len(recs), equal


def phase_serving_load(ops, serve_mod, dev, packs, pools) -> dict:
    """``benchmarks/bench_serving_load.py``'s open-loop replay on the
    card: a ServingService(window_ms=2.0, max_batch=1024) over a
    ModelRegistry of three packs, against a per-request server, at
    RATE_FACTORS x the warm OvO predictor's batch-1 capacity, then a
    mixed-size run over all three models."""
    ops.reset_launches()
    reg = serve_mod.ModelRegistry(
        max_resident=3, engine="pallas", max_batch=1024, device=dev,
        warmup_sizes=tuple(1 << k for k in range(11)))
    for name, p in packs.items():
        reg.register(name, p)
        reg.get(name)
    ovo = reg.get("ovo")
    one = pools["ovo"][:1]
    ovo.predict(one)
    times = []
    for _ in range(50):
        t0 = time.perf_counter()
        ovo.predict(one)
        times.append(time.perf_counter() - t0)
    per_request_s = statistics.median(times)
    capacity = 1.0 / per_request_s
    rng = np.random.default_rng(SEED)
    runs, all_recs = [], []

    def run(mode, factor, sizes, probs, models, arrivals=None):
        if arrivals is None:
            arrivals = draw_schedule(rng, capacity * factor, sizes, probs)
        probe = ReplayProbe([reg.get(m) for m in dict.fromkeys(models)])
        if mode == "dynamic":
            svc = serve_mod.ServingService(reg, window_ms=WINDOW_MS,
                                           device=dev)
            try:
                with probe:
                    out, recs = replay(lambda x, m, op: svc.submit(
                        x, model=m, op=op), *arrivals, models, pools, rng)
            finally:
                svc.close(FUTURE_TIMEOUT_S)
            st = svc.stats
            out.update(rows_per_batch=st["rows_per_batch"],
                       n_batches=st["n_batches"],
                       window_flushes=st["n_window_flushes"],
                       full_flushes=st["n_full_flushes"],
                       max_batch_rows=st["max_batch_rows"])
        else:
            srv = PerRequestServer(reg.get(models[0]))
            try:
                with probe:
                    out, recs = replay(lambda x, m, op: srv.submit(x, op),
                                       *arrivals, models, pools, rng)
            finally:
                srv.close()
        out.update(mode=mode, rate_factor=factor, probe=probe.summary(),
                   offered_requests_per_s=capacity * factor,
                   models=list(models),
                   sizes={str(k): v for k, v in zip(sizes, probs)})
        runs.append(out)
        all_recs.extend(recs)
        return arrivals

    t0 = time.perf_counter()
    for factor in RATE_FACTORS:
        arrivals = run("per_request", factor, [1], [1.0], ["ovo"])
        run("dynamic", factor, [1], [1.0], ["ovo"], arrivals)
    run("dynamic", 2.0, [1, 8, 32], [0.7, 0.2, 0.1], list(packs))
    replay_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = dict(ops.launches)
    t0 = time.perf_counter()
    n, equal = responses_equal(reg, pools, all_recs, {})
    verify_s = time.perf_counter() - t0
    ops.launches.update(launches)
    top = {r["mode"]: r["sustained_rows_per_s"] for r in runs
           if r["rate_factor"] == RATE_FACTORS[-1]}
    speedup = top["dynamic"] / top["per_request"]
    emit(phase="serving_load", window_ms=WINDOW_MS, max_batch=1024,
         resident=list(reg.resident),
         per_request_s=per_request_s, capacity_requests_per_s=capacity,
         load_seconds=LOAD_SECONDS, max_requests=LOAD_MAX_REQUESTS,
         runs=runs, speedup_at_top_rate=speedup, speedup_gate=SPEEDUP_GATE,
         reference_target=SPEEDUP_TARGET, responses=n,
         responses_equal_alone=equal, replay_s=replay_s, verify_s=verify_s,
         registry_stats=reg.stats,
         launches={k: v for k, v in launches.items() if v})
    check(equal == n, f"serving_load: {n - equal} of {n} responses differ "
          "from the same rows served alone")
    check(speedup >= SPEEDUP_GATE, f"serving_load: dynamic sustained "
          f"{speedup:.2f}x the per-request rows/s at "
          f"{RATE_FACTORS[-1]}x capacity (gate {SPEEDUP_GATE}x)")
    check(launches["multitask_decision"] > 0
          and launches["multitask_decision_bf16_bank"] > 0,
          f"serving_load: launches {launches}")
    return launches


def phase_registry(ops, serve_mod, dev, packs, pools) -> dict:
    """``ModelRegistry(max_resident=2)`` over four packs: the LRU order
    of admissions and evictions, re-admitted models serving their first
    bits, and an explicit eviction returning the bank's device memory."""
    ops.reset_launches()
    reg = serve_mod.ModelRegistry(max_resident=2, engine="pallas",
                                  device=dev)
    for name, p in packs.items():
        reg.register(name, p)
    order, first, same = [], {}, {}
    want_order = [("binary",), ("binary", "ovo"), ("ovo", "binary"),
                  ("binary", "ovo_fp16"), ("ovo_fp16", "ovr"),
                  ("ovr", "binary"), ("binary", "ovo"), ("ovo", "ovo_fp16"),
                  ("ovo_fp16", "ovr")]
    for name in ("binary", "ovo", "binary", "ovo_fp16", "ovr", "binary",
                 "ovo", "ovo_fp16", "ovr"):
        df = reg.get(name).decision_values(pools[name][:256])
        order.append(reg.resident)
        if name in first:
            same[name] = same.get(name, True) and bool(
                np.array_equal(df, first[name]))
        else:
            first[name] = df
    stats = reg.stats
    freed = []
    for name in ("ovr", "ovo_fp16"):
        nbytes = sum(bank_bytes(reg.get(name)).values())
        _, delta = constructed(lambda: reg.evict(name))
        freed.append(dict(model=name, bank_bytes=nbytes,
                          memory_allocated_drop=-delta,
                          ok=-delta >= 0.9 * nbytes))
    torch.cuda.synchronize()
    launches = dict(ops.launches)
    emit(phase="registry", max_resident=2, order=order, stats=stats,
         readmitted_bits_equal=same, evictions=freed,
         launches={k: v for k, v in launches.items() if v})
    check(order == want_order, f"registry: residency {order}, want the "
          f"LRU order {want_order}")
    check(stats == {"hits": 1, "admissions": 8, "evictions": 6},
          f"registry: stats {stats}")
    check(all(same.values()) and len(same) == 4,
          f"registry: a re-admitted model served other bits {same}")
    check(all(f["ok"] for f in freed), f"registry: an eviction freed less "
          f"than 0.9 x its bank's bytes {freed}")
    return launches


def phase_serving(ops, serve_mod, dev, out_dir, binary_pack, binary_test,
                  fits, split) -> dict:
    """The serving layer over the exact binary SVC's pack and the
    overlapping OvO and OvR packs: quantized banks, the service under
    load, the registry; one launch-count dict a path."""
    xte, yte = binary_test
    ovo, ovr = fits["ovo"][2], fits["ovr"][2]
    pools = {"binary": xte, "ovo": split[2], "ovo_bf16": split[2],
             "ovo_fp16": split[2], "ovr": split[2]}
    return {
        "serve_quantized": phase_serve_quantized(
            ops, serve_mod, dev, out_dir, {
                "binary": (binary_pack, xte, yte),
                "ovo": (ovo, split[2], split[3]),
                "ovr": (ovr, split[2], split[3])}),
        "serving_load": phase_serving_load(
            ops, serve_mod, dev, {"binary": binary_pack, "ovo": ovo,
                                  "ovo_bf16": serve_mod.quantize(ovo, "bf16")},
            pools),
        "registry": phase_registry(
            ops, serve_mod, dev, {"binary": binary_pack, "ovo": ovo,
                                  "ovo_fp16": serve_mod.quantize(ovo, "fp16"),
                                  "ovr": ovr}, pools)}


# the Predictor's batch ladder at max_batch 1,024 (11 buckets) and the
# request sizes of serve_graph's bit comparison: one a bucket, and one
# past max_batch (slices of 1,024, 1,024 and 452 -> bucket 512)
SERVE_LADDER = tuple(1 << k for k in range(11))
SERVE_GRAPH_SIZES = (1, 2, 3, 5, 9, 17, 33, 65, 129, 257, 513, 1024, 2500)
SERVE_RATE_SIZES = (1, 37, 256, 1024)


def rows_per_s(pred, x, sizes=SERVE_RATE_SIZES) -> dict:
    """A warm predictor's rows/s by request size (up to 2,048 rows a
    size, in requests of that size) and host µs a call at each size."""
    rates, host_us = {}, {}
    for size in sizes:
        starts = range(0, len(x) - size + 1, size)[:max(1, 2048 // size)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for s in starts:
            pred.decision_values(x[s:s + size])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        rates[str(size)] = len(starts) * size / dt
        host_us[str(size)] = dt / len(starts) * 1e6
    return {"rows_per_s": rates, "us_per_call": host_us}


def graph_and_eager_serving(ops, serve_mod, pred_mod, dev, pack, x):
    """One pack served by a Predictor(engine="pallas") with its programs
    as CUDA graphs and by one running them eagerly
    (``predictor.CUDA_GRAPHS`` off), each warmed at every bucket of the
    ladder: per mode the decisions at SERVE_GRAPH_SIZES (under a compile
    budget of 0), their launches, the captures, the memory a warmed
    predictor holds beyond an unwarmed one, and rows/s."""
    from repro_torch.analysis import CompileGuard
    runs = {}
    for mode in ("graph", "eager"):
        pred_mod.CUDA_GRAPHS = mode == "graph"
        try:
            pred, built = constructed(lambda: serve_mod.Predictor(
                pack, engine="pallas", device=dev))
        finally:
            pred_mod.CUDA_GRAPHS = True
        torch.cuda.synchronize()
        r0 = torch.cuda.memory_reserved()
        t0 = time.perf_counter()
        with CompileGuard(budget=10 ** 6) as warm:
            _, warmed = constructed(lambda: pred.warmup(SERVE_LADDER))
        warm_s = time.perf_counter() - t0
        reserved = torch.cuda.memory_reserved() - r0
        ops.reset_launches()
        with CompileGuard(budget=0, note=f"warm {mode} predictor"):
            dfs = [pred.decision_values(x[:n]) for n in SERVE_GRAPH_SIZES]
        torch.cuda.synchronize()
        launches = {k: v for k, v in ops.launches.items() if v}
        stats = pred.graph_stats
        runs[mode] = dict(
            dfs=dfs, launches=launches, stats=stats,
            captures=sum(e.startswith("cuda graph capture")
                         for e in warm.compiled),
            out=dict(memory_allocated_construction=built,
                     memory_allocated_warmup=warmed,
                     memory_reserved_warmup=reserved, warmup_s=warm_s,
                     n_programs=pred.n_programs, **rows_per_s(pred, x)))
        del pred
    g, e = runs["graph"], runs["eager"]
    stats = g["stats"]
    caps = max(stats["captures"], 1)
    return dict(
        bits_equal=all(np.array_equal(a, b)
                       for a, b in zip(g["dfs"], e["dfs"])),
        launches_equal=g["launches"] == e["launches"],
        launches=g["launches"], captures=g["captures"],
        eager_captures=e["captures"], graph_stats=stats,
        capture_ms_per_bucket=stats["capture_s"] / caps * 1e3,
        instantiate_ms_per_bucket=stats["instantiate_s"] / caps * 1e3,
        graph=g["out"], eager=e["out"],
        speedup_rows_per_s={k: g["out"]["rows_per_s"][k]
                            / e["out"]["rows_per_s"][k]
                            for k in g["out"]["rows_per_s"]})


def phase_serve_graph(ops, serve_mod, dev, packs) -> dict:
    """The Predictor's decide programs as CUDA graphs against the same
    programs run eagerly, in this process, for each pack kind (``packs``:
    name -> (pack, request rows)): decisions bit for bit at a request a
    bucket and one past max_batch, equal launches, one capture a bucket
    in the graph run and none in the eager one, capture and instantiation
    ms a bucket, a warmed predictor's memory, rows/s and µs a call by
    request size in both modes. The graph runs' launches are the path's."""
    from repro_torch.serve import predictor as pred_mod
    entries, path = [], []
    for name, (pack, x) in packs.items():
        entry = graph_and_eager_serving(ops, serve_mod, pred_mod, dev, pack,
                                        x)
        path.append(entry["launches"])
        entries.append(dict(pack=name, **entry))
        check(entry["bits_equal"], f"serve_graph {name}: a replay's "
              "decisions differ from the eager program's")
        check(entry["launches_equal"], f"serve_graph {name}: the graph run "
              f"counts other launches than the eager run")
        check(entry["captures"] == entry["graph_stats"]["captures"]
              == len(SERVE_LADDER) and entry["eager_captures"] == 0,
              f"serve_graph {name}: {entry['captures']} captures at warmup, "
              f"want one a bucket of {len(SERVE_LADDER)}, none eager")
        check(any(entry["launches"].values()), f"serve_graph {name}: the "
              "path launched no kernel")
    emit(phase="serve_graph", ladder=list(SERVE_LADDER),
         sizes=list(SERVE_GRAPH_SIZES), packs=entries)
    return {k: sum(c.get(k, 0) for c in path) for k in ops.KERNELS}


def quantized_bank_rows(ops, D, dev, fits, xte, launches) -> list[dict]:
    """The quantized route (an fp16 / bf16 bank under float32 compute) at
    the largest OvO and OvR serving banks over one 1,024-row slice: the
    kernel beside the float32 kernel on the upcast bank (same call), its
    plain version, the library composition (upcast, then batched cdist,
    exp and bmm) and its bound (the bank's bytes halved)."""
    saved = dict(ops.launches)
    z = torch.from_numpy(xte[:1024]).to(dev)
    nt = z.shape[0]
    rows = []
    for strategy in ("ovo", "ovr"):
        packed = fits[strategy][2]
        gamma = packed.kernel.gamma
        sv_np, cf_np = serving_bank(packed)
        sv32 = torch.from_numpy(np.ascontiguousarray(sv_np)).to(dev)
        cf32 = torch.from_numpy(np.ascontiguousarray(cf_np)).to(dev)
        n_tasks, w, d = sv32.shape
        for sv_dtype, dt in QUANT_DTYPES.items():
            svq = sv32.to(dt)
            up = svq.float()
            cf = cf32.to(dt).float()   # the coef a quantized pack serves
            name = f"multitask_decision_{sv_dtype}_bank"

            def kern():
                return ops.multitask_decision(z, svq, cf, gamma=gamma)

            def fp32():
                return ops.multitask_decision(z, up, cf, gamma=gamma)

            def plain():
                return D.multitask_decision_plain(z, svq, cf, gamma=gamma)

            def lib():
                return library_decision(z, svq.float(), cf, gamma)

            got, want, bits = kern(), plain(), torch.equal(kern(), fp32())
            n_ops = n_tasks * nt * w * (2 * d + 8)
            n_bytes = 4 * (nt * d + n_tasks * w + n_tasks * nt) \
                + 2 * n_tasks * w * d
            b_ms, b_by = bound_ms(n_bytes, n_ops)
            row = {
                "name": name, "route": "cuda", "source": f"{CSRC}/decision.cu",
                "replaces": "src/repro/kernels/decision.py:121",
                "task_axis": strategy, "bank": "largest served",
                "shape": [n_tasks, nt, w, d], "bank_dtype": sv_dtype,
                "launches": launches[name], "max_abs_err": max_err(got, want),
                "bits_equal_fp32_kernel_on_upcast_bank": bits,
                "ms": median_ms(kern), "device_ms": device_ms(kern),
                "fp32_ms": median_ms(fp32), "fp32_device_ms": device_ms(fp32),
                "plain_ms": median_ms(plain),
                "plain_device_ms": device_ms(plain),
                "ms_repeat": median_ms(kern),
                "bound_ms": b_ms, "bound_by": b_by,
                "fp32_bound_ms": bound_ms(n_bytes + 2 * n_tasks * w * d,
                                          n_ops)[0],
                "library_ms": median_ms(lib),
                "library_device_ms": device_ms(lib),
                "library_composition": "upcast, then batched cdist, exp, bmm",
                **redesign_info("decision", (nt, n_tasks, w, d),
                                bank=sv_dtype)}
            rows.append(row)
            check(bits, f"{name}: the {strategy} bank's decisions differ "
                  "from the fp32 kernel's on the upcast bank")
            check(bool(torch.allclose(got, want, **DECISION_TOL)),
                  f"{name}: disagrees with its plain version on the "
                  f"{strategy} bank")
    ops.launches.update(saved)
    return rows


# ------------------------------------------------- tuner and compile guard
# the tuner's shapes: the main path's (PERF.md §6), and the map's serving
# batch
TUNE_SHAPES = [("rbf_gram", (2048, 29491, 102)), ("kkt_select", (29491,)),
               ("decision", (3277, 17, 102)),
               ("multitask_decision", (6, 1024, 986, 102)),
               ("rff_features", (29491, 1024, 102)),
               ("rff_features", (1024, 1024, 102))]
TUNE_BUDGET = 6
# the launchers of the tunable kernels: (module name, function, the
# keyword that carries the plan)
TUNE_LAUNCHERS = (("rbf_gram", "launch_block", "plan"),
                  ("feature_map", "launch", "plan"),
                  ("decision", "launch_decision", "plan"),
                  ("decision", "launch_multitask", "plan"),
                  ("kkt_select", "launch", "blocks"))


def out_bits(out) -> torch.Tensor:
    """A wrapper's output as one tensor (kkt_select's four as float64,
    which holds its values and indices exactly)."""
    return out if isinstance(out, torch.Tensor) else torch.cat(
        [t.reshape(-1).to(torch.float64) for t in out])


class RecordedPlans:
    """While active, the tunable kernels' launchers record the plan each
    launch takes (and still launch)."""

    def __enter__(self):
        import importlib
        self.plans, self.saved = [], []
        for mod_name, fn_name, knob in TUNE_LAUNCHERS:
            mod = importlib.import_module(f"repro_torch.kernels.{mod_name}")
            fn = getattr(mod, fn_name)
            self.saved.append((mod, fn_name, fn))

            def launch(*a, _fn=fn, _knob=knob, **kw):
                self.plans.append(kw[_knob])
                return _fn(*a, **kw)

            setattr(mod, fn_name, launch)
        return self

    def __exit__(self, *exc):
        for mod, fn_name, fn in self.saved:
            setattr(mod, fn_name, fn)


def phase_tune(ops, dev) -> dict:
    """The launch-plan tuner (``kernels.autotune``) on the card:
    ``tune(objective="wall", budget=TUNE_BUDGET)`` for each of its five
    kernels at the main path's shapes, every evaluated plan's output equal
    to the default plan's bit for bit; then the results in a temporary
    cache pinned with ``set_cache_path``, the ``ops`` wrappers launching
    the tuned plans with the default's bits, and the default path
    restored. One line a (kernel, shape); the tuner's launches are the
    path's."""
    import tempfile
    from repro_torch.kernels import autotune
    t0 = time.perf_counter()
    ops.reset_launches()
    card = autotune.device_kind(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cache, runs = autotune.TuningCache(), []
    for kernel, shape in TUNE_SHAPES:
        inputs = autotune.bench_inputs(kernel, shape, "fp32", dev, seed=SEED)
        res = autotune.tune(kernel, shape, objective="wall",
                            budget=TUNE_BUDGET, device=dev, inputs=inputs)
        want = out_bits(autotune.run(kernel, inputs, "fp32",
                                     res.default.config))
        equal = {json.dumps(ev.config): bool(torch.equal(out_bits(
            autotune.run(kernel, inputs, "fp32", ev.config)), want))
            for ev in res.trace}
        cache.put(autotune.cache_key(card, kernel, "fp32", shape), res)
        runs.append((kernel, shape, inputs, want, res))
        emit(phase="tune", kernel=kernel, shape=list(shape),
             default=res.default.config,
             default_device_ms=res.default.wall_s * 1e3,
             tuned=res.best.config, tuned_device_ms=res.best.wall_s * 1e3,
             evaluated=len(res.trace),
             candidates=len(autotune.candidates(kernel, shape, "fp32", sms)),
             plans=[dict(config=ev.config, device_ms=ev.wall_s * 1e3,
                         roofline_us=ev.roofline_s * 1e6)
                    for ev in res.trace],
             bits_equal_default=all(equal.values()),
             phase_s=time.perf_counter() - t0)
        check(all(equal.values()), f"tune: {kernel} {shape}: a plan's "
              f"output differs from the default plan's: {equal}")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "autotune.json")
        cache.save(path)
        autotune.set_cache_path(path)
        try:
            check(not autotune.runtime_cache().dropped,
                  f"tune: entries dropped {autotune.runtime_cache().dropped}")
            for kernel, shape, inputs, want, res in runs:
                with RecordedPlans() as rec:
                    got = out_bits(autotune.run(kernel, inputs, "fp32", {}))
                check(autotune.config_of(kernel, rec.plans[-1])
                      == res.best.config, f"tune: {kernel} {shape} launched "
                      f"{rec.plans[-1]}, not the tuned {res.best.config}")
                check(torch.equal(got, want), f"tune: {kernel} {shape}: "
                      "the tuned launch's bits differ from the default's")
        finally:
            autotune.set_cache_path(None)
    for kernel, shape, inputs, _, res in runs:   # the analytic plans again
        with RecordedPlans() as rec:
            autotune.run(kernel, inputs, "fp32", {})
        check(rec.plans[-1] == autotune.plan(kernel, shape, "fp32", None,
                                             sms),
              f"tune: {kernel} {shape} kept a tuned plan after the cache "
              "was unpinned")
    torch.cuda.synchronize()
    launches = dict(ops.launches)
    emit(phase="tune_done", seconds=time.perf_counter() - t0,
         pinned_cache_launched_tuned=True, launches=launches)
    for k in ("rbf_gram", "kkt_select", "decision", "multitask_decision",
              "rff_features"):
        check(launches[k] > 0, f"tune launched no {k}")
    return launches


GUARD_REQUESTS = 40
GUARD_RAW_WIDTHS = (1001, 1003, 1005, 1007, 1009)


def phase_compile_guard(ops, serve_mod, dev, ovo_pack, xte) -> dict:
    """The runtime compile guard (``analysis.CompileGuard``): a Predictor
    over the overlapping OvO pack, warmed at the batch buckets 1..64,
    serves GUARD_REQUESTS requests of 1..37 rows under budget 0 and makes
    nothing new; then ``multitask_decision`` at raw (unbucketed) widths
    over the same bank, a plan and a tuner resolution a width, trips a
    budget of 2."""
    from repro_torch.analysis import CompileBudgetExceeded, CompileGuard
    t0 = time.perf_counter()
    pred = serve_mod.Predictor(ovo_pack, engine="pallas", device=dev)
    pred.warmup(tuple(1 << i for i in range(7)))
    ops.reset_launches()
    sizes = [1 + (7 * i) % 37 for i in range(GUARD_REQUESTS)]
    with CompileGuard(budget=0, note="warm OvO predictor") as warm:
        for i, size in enumerate(sizes):
            pred.predict(xte[i:i + size])
    sv, coef, b, _ = max(pred._banks, key=lambda bank: bank[0].numel())
    z = torch.from_numpy(xte[:max(GUARD_RAW_WIDTHS)]).to(dev)
    tripped = None
    try:
        with CompileGuard(budget=2, note="raw widths") as raw:
            for w in GUARD_RAW_WIDTHS:
                ops.multitask_decision(z[:w], sv, coef, b,
                                       gamma=ovo_pack.kernel.gamma)
    except CompileBudgetExceeded as e:
        tripped = str(e)[:200]
    torch.cuda.synchronize()
    launches = dict(ops.launches)
    emit(phase="compile_guard", seconds=time.perf_counter() - t0,
         requests=GUARD_REQUESTS, sizes=sorted(set(sizes)),
         warm_count=warm.count, warm_compiled=warm.compiled,
         n_programs=pred.n_programs, raw_widths=list(GUARD_RAW_WIDTHS),
         raw_count=raw.count, raw_compiled=raw.compiled[:4],
         tripped=tripped, launches=launches)
    check(warm.count == 0, f"compile_guard: the warm predictor made "
          f"{warm.count} fresh programs: {warm.compiled}")
    check(tripped is not None and raw.count >= len(GUARD_RAW_WIDTHS),
          f"compile_guard: raw widths did not trip the guard "
          f"({raw.count} events)")
    check(launches["multitask_decision"] > 0,
          "compile_guard launched no multitask_decision")
    return launches


def gram_info(G, entry: str, shape) -> dict:
    """The block route's launch plan for an (n, m, d) float32 call on
    this card, and what ptxas reported for the kernel it runs (the
    mma.sync mainloop's float32 instantiation, or the matvec's wgmma
    route): registers, spills."""
    from repro_torch.kernels import _build
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = G.gram_plan(*shape, entry=entry, sms=sms)
    name = ("gram_wg_matvec_kernel" if plan.route == "wgmma"
            else f"gram_tc_kernelIfLb{int(entry == 'matvec')}E")
    found = _build.ptxas_report(name)
    check(len(found) == 1, f"ptxas log: {len(found)} kernels named {name}")
    return {"plan": plan._asdict(), "ptxas": found[0]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch import data, serve as serve_mod
    from repro_torch.core import cascade, dist, gd
    from repro_torch.core import kernel_engine as KE, kernels as K, smo
    from repro_torch.core import multiclass as MC
    from repro_torch.core.svm import SVC, SVR
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import dcd as DCD
    from repro_torch.kernels import decision as D
    from repro_torch.kernels import feature_map as FM
    from repro_torch.kernels import flash_attn as FA
    from repro_torch.kernels import kkt_select as KS
    from repro_torch.kernels import rbf_gram as G
    from repro_torch.kernels import ssd_diag as SD

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else ""
    print(card, flush=True)
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    open(LOG_PATH, "w").close()
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _build.library()
    emit(phase="build", card=card, torch=torch.__version__,
         cuda=torch.version.cuda, build_s=time.perf_counter() - t0,
         nvcc_s=_build.build_seconds[0] if _build.build_seconds else None)
    dryrun = start_dryrun()     # host work, read by the lm_sharded phase
    roofline = start_host_job([__file__, "--lm-roofline"])  # lm_roofline
    dryrun_all = start_host_job([__file__, "--lm-dryrun-all"])

    counts = phase_kernel_counts(ops, K, dev, n=29491, d=102)
    path = os.path.join(out_dir, "chip_smoke_model.npz")
    xtr, xte, df_engine, fit_launches, _, (ytr, yte, acc, base) = phase_fit(
        ops, data, smo, KE, serve_mod, SVC, dev, path)
    serve_launches, packed = phase_serve(ops, serve_mod, dev, path, xte,
                                         df_engine)
    exact = {k: fit_launches[k] + serve_launches[k] for k in ops.KERNELS}
    for k in ("rbf_gram_matvec", "rbf_gram_row_cached", "kkt_select",
              "decision", "multitask_decision"):
        check(exact[k] > 0, f"main path launched no {k} kernel")
    linear = phase_fit_linear(ops, smo, KE, SVC, dev, xtr, ytr, xte, yte)
    clf, phi, yy, lr_fit, lr_acc = phase_lowrank_fit(
        ops, smo, SVC, dev, xtr, ytr, xte, yte, acc)
    lr_serve = phase_lowrank_serve(
        ops, serve_mod, FM, dev,
        os.path.join(out_dir, "chip_smoke_lowrank.npz"), clf, xte)
    svr, svr_state, svr_r2 = phase_svr(ops, data, smo, KE, serve_mod, SVR,
                                       dev, out_dir)
    mc_paths, mc_configs = {}, {}
    for config, noise in PAVIA_NOISE.items():
        split, fits, by_path = phase_multiclass(
            ops, data, smo, KE, MC, dist, D, serve_mod, SVC, dev, out_dir,
            config, noise)
        mc_paths.update(by_path)
        mc_configs[config] = (split, fits)
    # the low-rank fits on the last (overlapping) configuration's split
    lowrank_paths, lowrank_fits = {}, {}
    for strategy in ("ovo", "ovr"):
        path_launches, mclf, mphi = phase_multiclass_lowrank(
            ops, smo, MC, FM, DCD, serve_mod, SVC, dev, split,
            fits[strategy][1], out_dir, config, strategy)
        lowrank_paths[f"svc_{strategy}_lowrank"] = path_launches
        lowrank_fits[strategy] = (mclf, mphi, path_launches)
    # the paper's GD baseline and the cascade, beside the SMO fits above
    binary = (xtr, ytr, xte, yte)
    phase_smo_graph(ops, data, smo, KE, K, MC, dist, dev, binary, base,
                    fits["ovo"][0], split)
    lam, gd_path = phase_gd(ops, gd, KE, SVC, dev, binary, acc)
    new_paths = {
        "svc_gd": gd_path,
        "svc_gd_stable": phase_gd_stable(ops, gd, SVC, dev, binary, lam, acc),
        "svr_gd": phase_gd_svr(ops, data, SVR, dev, svr_r2["pallas"]),
        "svc_ovo_gd_overlapping": phase_gd_ovo(ops, gd, dist, SVC, dev,
                                               split, fits["ovo"][1]),
        "svc_cascade": phase_cascade_svc(ops, cascade, SVC, dev, binary,
                                         base, acc),
        "svc_cascade_lowrank": phase_cascade_svc_lowrank(
            ops, cascade, SVC, dev, binary, lr_acc),
        **phase_cascade_svr(ops, data, SVR, dev),
        **phase_data_parallel(ops, data, smo, KE, SVC, SVR, dev, binary,
                              base, mc_configs)}
    del base, mc_configs
    serving = phase_serving(ops, serve_mod, dev, out_dir, packed, (xte, yte),
                            fits, split)
    svr_pack = serve_mod.load(os.path.join(out_dir,
                                           "chip_smoke_svr_pallas.npz"))
    svr_rows = np.random.default_rng(SEED).normal(
        0.0, 1.0, (4096, svr_pack.n_features)).astype(np.float32)
    serving["serve_graph"] = phase_serve_graph(ops, serve_mod, dev, {
        "binary": (packed, xte), "svr": (svr_pack, svr_rows),
        "ovo": (fits["ovo"][2], split[2]), "ovr": (fits["ovr"][2], split[2]),
        "ovo_fp16": (serve_mod.quantize(fits["ovo"][2], "fp16"), split[2]),
        "ovo_bf16": (serve_mod.quantize(fits["ovo"][2], "bf16"), split[2]),
        "rff": (serve_mod.load(os.path.join(out_dir,
                                            "chip_smoke_lowrank.npz")), xte),
        "ovo_rff": (serve_mod.load(os.path.join(
            out_dir, "chip_smoke_ovo_lowrank.npz")), split[2])})
    lm, lm_errs, lm_bf16, lm_bwd = phase_lm(ops, FA, SD, dev)
    check(lm_bf16 > 0, "main path launched no bfloat16 flash_attention")
    lm_serve, lm_seen = phase_lm_serve(ops, FA, SD, dev)
    lm_train, lm_train_seen, lm_train_run = phase_lm_train(ops, FA, SD, dev)
    lm_sharded, dryrun_rec = phase_lm_sharded(ops, dev, lm_train_run, card,
                                              dryrun)
    phase_lm_roofline(roofline, lm_train_run, dryrun_rec, card)
    phase_lm_dryrun_all(dryrun_all, card)
    # the tuner and the compile guard, after every path ran its analytic
    # plans
    tuned = phase_tune(ops, dev)
    guard = phase_compile_guard(ops, serve_mod, dev, fits["ovo"][2],
                                split[2])
    paths = {"svc_exact": exact, "svc_linear": linear,
             "svc_lowrank": {k: lr_fit[k] + lr_serve[k] for k in ops.KERNELS},
             "svr": svr, **mc_paths, **lowrank_paths, **new_paths,
             **serving, "lm_kernels": lm, "lm_serve": lm_serve,
             "lm_train": lm_train, "lm_sharded": lm_sharded,
             "tune": tuned,
             "compile_guard": guard}
    launches = {k: sum(p[k] for p in paths.values()) for k in ops.KERNELS}
    emit(phase="launches", by_path=paths, total=launches)
    for k, v in launches.items():
        check(v > 0, f"no main path launched the {k} kernel")
    for strategy in fits:   # each fit's launches, for the task-axis line
        fits[strategy] = (*fits[strategy],
                          mc_paths[f"svc_{strategy}_{config}"])
    phase_task_axis(ops, K, G, KS, D, dist, dev, fits, split[2],
                    fits["ovo"][0].kernel_params.gamma, counts)
    errs = phase_parity(ops, K, G, KS, D, dev, n_train=xtr.shape[0],
                        d=xtr.shape[1], n_sv=packed.n_support,
                        n_test=len(xte))
    errs.update(phase_matvec_parity(ops, K, dist, dev, xtr,
                                    packed.kernel.gamma, fits))
    errs.update(phase_lowrank_parity(ops, FM, DCD, dev, xtr, clf, phi, yy,
                                     svr_state))
    task_rows = []
    for strategy, (mclf, mphi, path_launches) in lowrank_fits.items():
        row, err = dcd_task_axis(ops, DCD, dev, strategy, mclf, mphi,
                                 path_launches)
        task_rows.append(row)
        errs["dcd_epoch"] = max(errs["dcd_epoch"], err)
    del lowrank_fits
    errs.update(lm_errs)
    kernels = phase_timing(ops, K, G, KS, D, dev, xtr, xte, packed,
                           packed.kernel.gamma, errs, launches, counts)
    kernels += phase_timing_lowrank(ops, FM, DCD, dev, xtr, clf, phi, yy,
                                    errs, launches, svr_state, svr,
                                    task_rows)
    kernels += phase_timing_lm(ops, FA, SD, dev, errs, lm, lm_bf16, lm_bwd)
    kernels += lm_serve_rows(ops, FA, SD, dev, lm_serve, lm_seen)
    kernels += lm_train_rows(ops, FA, SD, dev, lm_train, lm_train_seen)
    kernels += phase_row_range(ops, K, G, dev, xtr, packed.kernel.gamma,
                               launches)
    kernels += quantized_bank_rows(ops, D, dev, fits, split[2], launches)
    for row in kernels:   # the decision kernel's launches by bank dtype
        if row["name"] == "multitask_decision":
            row["launches_by_bank"] = {
                b: launches["multitask_decision" + s] for b, s in (
                    ("fp32", ""), ("fp16", "_fp16_bank"),
                    ("bf16", "_bf16_bank"))}
    out_line({"kernels": kernels})
    out_line({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--lm-roofline"]:   # the host job of lm_roofline
        sys.exit(lm_roofline_job())
    if sys.argv[1:] == ["--lm-dryrun-all"]:   # the host job of lm_dryrun_all
        sys.exit(lm_dryrun_all_job())
    sys.exit(main())
