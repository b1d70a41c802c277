"""One epoch of dual coordinate descent: plain version and CUDA launcher.

The CUDA kernel (``csrc/dcd_epoch.cu``) runs one full epoch of
``repro/core/linear.py``'s ``coord`` sweep in one launch; it has no
Pallas counterpart (the reference compiles the epoch into an XLA device
loop). ``ops.dcd_epoch`` is the checked entry point; the functions here
assume checked inputs.

The plain version is the sweep written out, a Python loop over the
permutation on CPU tensors. Its scalar steps run on float32 numpy
scalars that view the tensors' storage: each rounds once per operation,
like the kernel's ``__f*_rn`` steps, at a fraction of the cost of a
0-d tensor op per step. The vector steps (the dot product and the
update of w) are torch ops.
"""
from __future__ import annotations

import numpy as np
import torch


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


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def launch(lib, phi, y, p, lo, hi, q_diag, live, perm, beta, w, wb, viol, *,
           bias: float) -> int:
    n, k = phi.shape
    return lib.svm_dcd_epoch(
        phi.data_ptr(), y.data_ptr(), p.data_ptr(), lo.data_ptr(),
        hi.data_ptr(), q_diag.data_ptr(), live.data_ptr(), perm.data_ptr(),
        beta.data_ptr(), w.data_ptr(), wb.data_ptr(), viol.data_ptr(), n, k,
        float(bias), _stream())
