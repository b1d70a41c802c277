"""Flash attention: plain PyTorch version and the CUDA launcher.

The CUDA kernel (``csrc/flash_attn.cu``) replaces
``flash_attention_pallas`` (``repro/kernels/flash_attn.py``), reached in
the reference through ``repro.kernels.ops.flash_attention``: softmax
attention over (B, S, H, D) tensors with grouped-query heads, computed
with an online softmax so the (S, S) scores never reach device memory.
Everything inside is float32; the output is rounded once to its type.
``ops.flash_attention`` is the checked entry point; the functions here
assume checked inputs.
"""
from __future__ import annotations

import torch


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool,
                          out_dtype: torch.dtype) -> torch.Tensor:
    """Softmax attention of q (B, Sq, H, D) over k, v (B, Sk, Hkv, D),
    kv heads repeated to H; (B, Sq, H, D) in ``out_dtype``. The whole
    score matrix in float32, masked with -inf under ``causal`` (the
    reference's oracle, ``repro/kernels/ref.py::flash_attention``)."""
    h, d = q.shape[2], q.shape[3]
    hkv = k.shape[2]
    if hkv != h:
        k = k.repeat_interleave(h // hkv, dim=2)
        v = v.repeat_interleave(h // hkv, dim=2)
    qf, kf, vf = (t.to(torch.float32).transpose(1, 2) for t in (q, k, v))
    s = (qf @ kf.transpose(-1, -2)) * d ** -0.5            # (B, H, Sq, Sk)
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        keep = (torch.arange(sk, device=q.device)[None, :]
                <= torch.arange(sq, device=q.device)[:, None])
        s = torch.where(keep, s, -torch.inf)
    out = torch.softmax(s, dim=-1) @ vf
    return out.transpose(1, 2).to(out_dtype)


def launch(lib, q, k, v, out, *, causal: bool) -> int:
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    return lib.svm_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq, sk,
        h, hkv, d, sk, float(d ** -0.5), int(causal),
        int(q.dtype == torch.bfloat16), int(out.dtype != q.dtype),
        torch.cuda.current_stream().cuda_stream)
