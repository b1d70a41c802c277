"""Times the PyTorch port's serving path and its redesigned kernels on one
NVIDIA GPU, on the models chip_smoke.py fits, for the ``src/`` of any
checkout of this repository.

    python3 kernel_times.py --packs DIR [--src DIR] [--sweep] [--out FILE]

``--packs`` holds what chip_smoke.py saves under ``chiprun_out/``: the
exact binary SVC (``chip_smoke_model.npz``), the OvO and OvR models of
its overlapping configuration (``chip_smoke_ovo_overlapping.npz``,
``chip_smoke_ovr_overlapping.npz``) and the RFF SVC
(``chip_smoke_lowrank.npz``, for its map). Their held-out rows are made
again as chip_smoke.py makes them (``binary_split``, ``pavia_split``).
One JSON line each:

* ``serve``: each of the three classifiers through ``serve.Predictor``,
  rows/s by request size (``chip_smoke.serve_rates``);
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
Two checkouts compare in one call of the chip tool, each run in its own
process: parent, change, change, parent, and so on.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PACKS = {"binary": "chip_smoke_model.npz",
         "ovo": "chip_smoke_ovo_overlapping.npz",
         "ovr": "chip_smoke_ovr_overlapping.npz",
         "lowrank": "chip_smoke_lowrank.npz"}


def _args():
    p = argparse.ArgumentParser()
    p.add_argument("--packs", required=True)
    p.add_argument("--src", default=os.path.join(HERE, "src"))
    p.add_argument("--sweep", action="store_true")
    p.add_argument("--out", default=None)
    return p.parse_args()


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
    packs = {k: serve.load(os.path.join(args.packs, f))
             for k, f in PACKS.items()}
    xtr_b, _, xte_b, _ = cs.binary_split(data)
    xte_m = cs.pavia_split(data, cs.PAVIA_NOISE["overlapping"])[2]

    def emit(**row):
        line = json.dumps({"src": args.src, "card": card, **row})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    def host_us(fn, calls=500):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / calls * 1e6

    def cuda(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    for model, xte in (("binary", xte_b), ("ovo", xte_m), ("ovr", xte_m)):
        pred = serve.Predictor(packs[model], engine="pallas", device=dev)
        emit(measure="serve", model=model,
             banks=[list(g.sv_x.shape) for g in packs[model].buckets],
             rows_per_s=cs.serve_rates(pred, xte)[0])

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


if __name__ == "__main__":
    sys.exit(main())
