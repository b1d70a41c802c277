"""PyTorch + CUDA port of the ``repro`` SVM system for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package mirrors its
layout (``repro_torch/core/smo.py`` <-> ``repro/core/smo.py``) and never
imports it. It covers the binary RBF C-SVC main path — ``SVC.fit``
(SMO on a ``KernelEngine``) -> ``serve.pack`` / ``save`` / ``load`` ->
``serve.Predictor`` — the low-rank tier (``SVC`` / ``SVR`` with
``engine="nystrom" | "rff"``: a feature map and dual coordinate
descent, schema-v2 packs) and epsilon-``SVR``. The kernels of those
paths are hand-written CUDA under ``kernels/csrc/``, built with nvcc at
first CUDA use.

Entry points run on the card unless the caller asks for the CPU:
``SVC(device=...)`` and ``Predictor(device=...)`` default to "cuda" and
raise when no card is present; functional entry points take their
device from their input tensors.
"""
from repro_torch.core.svm import SVC, SVR  # noqa: F401
