"""One epoch of dual coordinate descent: plain versions, launch plan and
CUDA launcher.

The CUDA kernel (``csrc/dcd_epoch.cu``) runs one full epoch of
``repro/core/linear.py``'s ``coord`` sweep in one launch; it has no
Pallas counterpart (the reference compiles the epoch into an XLA device
loop). With the task axis one launch sweeps several problems over one
shared Phi, a block each. ``ops.dcd_epoch`` and ``ops.dcd_epoch_tasks``
are the checked entry points; the functions here assume checked inputs.

``dcd_plan`` picks the kernel's route for a rank k: the "ring" route
(rows staged ahead into a ring of ``depth`` shared-memory slots, swept
in windows of ``window`` coordinates) wherever w and two slots fit a
block's shared memory, else the "direct" route (rows read from memory
at each step). ``WINDOW`` is the window the ring takes when its depth
allows it; it was chosen by timing every window on the H100 (PERF.md)
and is not a caller's setting.

The plain version is the sweep written out, a Python loop over the
permutation on CPU tensors. Its scalar steps run on float32 numpy
scalars that view the tensors' storage: each rounds once per operation,
like the kernel's ``__f*_rn`` steps, at a fraction of the cost of a
0-d tensor op per step. The vector steps (the dot product and the
update of w) are torch ops.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels.tile_f32 import current_stream

WINDOW = 8          # coordinates a window steps on one block reduction
WINDOWS = (1, 2, 4, 8)   # the windows csrc/dcd_epoch.cu instantiates
MAX_DEPTH = 64      # ring slots
SMEM_MAX = 232448   # bytes of shared memory an H100 block may opt in to


class DCDPlan(NamedTuple):
    route: str        # "ring" or "direct"
    window: int       # coordinates a window (0 on the direct route)
    depth: int        # ring slots (0 on the direct route)
    smem_bytes: int   # dynamic shared memory of the launch


def ring_smem(k: int, window: int, depth: int) -> int:
    """Shared memory of the ring route (csrc/dcd_epoch.cu ``ring_smem``):
    the ring and w (rows padded to 4 floats), 32 bytes of scalars and
    16 of barriers a slot, 48 bytes an entry of the window's Gram."""
    kpad = -(-k // 4) * 4
    return 4 * kpad * (depth + 1) + 48 * depth + 24 * window * (window + 1)


def dcd_plan(k: int, window: int = WINDOW,
             depth: int = MAX_DEPTH) -> DCDPlan:
    """The launch plan at rank k: as many whole windows of slots as fit
    (up to ``depth`` slots), the largest window of at most ``window``
    that leaves two windows in the ring; the direct route when not even
    a window of 1 does."""
    kpad = -(-k // 4) * 4
    w = window
    while w >= 1:
        fits = (SMEM_MAX - 4 * kpad - 24 * w * (w + 1)) // (4 * kpad + 48)
        d = min(depth, fits) // w * w
        if d >= 2 * w:
            return DCDPlan("ring", w, d, ring_smem(k, w, d))
        w //= 2
    return DCDPlan("direct", 0, 0, 4 * k)


def dcd_epoch_plain(phi, y, p, lo, hi, q_diag, live, perm, beta, w, wb, *,
                    bias: float) -> torch.Tensor:
    """Sweep the coordinates ``perm`` once, in place on ``beta`` (n,),
    ``w`` (k,) and ``wb`` (1,); return the epoch's max projected
    gradient over live coordinates as a 0-d float32 tensor. All tensors
    lie on the CPU."""
    f32 = np.float32
    ys, ps, los, his, qs = (t.numpy() for t in (y, p, lo, hi, q_diag))
    lives, betas, wbs = live.numpy(), beta.numpy(), wb.numpy()
    bias = f32(bias)
    viol = f32(0.0)
    for i in perm.tolist():
        phi_i = phi[i]
        dot = f32(torch.dot(phi_i, w).item())
        g = ys[i] * (dot + bias * wbs[0]) + ps[i]
        b = betas[i]
        if b <= los[i]:
            pg = min(g, f32(0.0))
        elif b >= his[i]:
            pg = max(g, f32(0.0))
        else:
            pg = g
        if not lives[i]:
            continue
        viol = max(viol, abs(pg))
        d = min(max(b - g / qs[i], los[i]), his[i]) - b
        if d != 0.0:
            dy = d * ys[i]
            w += float(dy) * phi_i
            wbs[0] = wbs[0] + dy * bias
            betas[i] = b + d
    return torch.tensor(viol, dtype=torch.float32)


def dcd_epoch_tasks_plain(phi, rows, offsets, tasks, y, p, lo, hi, q_diag,
                          live, perm, beta, w, wb, *,
                          bias: float) -> torch.Tensor:
    """The task axis as a loop of ``dcd_epoch_plain``: task ``tasks[b]``
    sweeps its segment ``[offsets[t], offsets[t+1])`` of the concatenated
    per-coordinate vectors (``perm`` holds local indices, ``rows`` the
    Phi row of each) over its own rows of Phi, gathered as a lone solve
    gathers them, with w row t of (T, k) and wb[t]; returns the (B,)
    viols in the order of ``tasks``. All tensors lie on the CPU."""
    off = offsets.tolist()
    viols = []
    for t in tasks.tolist():
        seg = slice(off[t], off[t + 1])
        phi_t = phi.index_select(0, rows[seg])
        viols.append(dcd_epoch_plain(
            phi_t, y[seg], p[seg], lo[seg], hi[seg], q_diag[seg], live[seg],
            perm[seg], beta[seg], w[t], wb[t:t + 1], bias=bias))
    return (torch.stack(viols) if viols
            else torch.zeros((0,), dtype=torch.float32))


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def launch(lib, phi, y, p, lo, hi, q_diag, live, perm, beta, w, wb, viol, *,
           bias: float, plan: DCDPlan, rows=None, offsets=None,
           tasks=None) -> int:
    """One launch: one problem (``rows``, ``offsets``, ``tasks`` None,
    n = phi's rows) or the task axis (n unused; ``viol`` (B,) for the
    B = len(tasks) blocks)."""
    n, k = phi.shape
    blocks = 1 if tasks is None else tasks.shape[0]
    return lib.svm_dcd_epoch(
        phi.data_ptr(), _ptr(rows), _ptr(offsets), _ptr(tasks), blocks,
        y.data_ptr(), p.data_ptr(), lo.data_ptr(), hi.data_ptr(),
        q_diag.data_ptr(), live.data_ptr(), perm.data_ptr(),
        beta.data_ptr(), w.data_ptr(), wb.data_ptr(), viol.data_ptr(), n, k,
        float(bias), plan.window, plan.depth, plan.smem_bytes,
        current_stream())
