"""PyTorch + CUDA port of the ``repro`` SVM system for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package mirrors its
layout (``repro_torch/core/smo.py`` <-> ``repro/core/smo.py``) and never
imports it. Slice 1 covers the binary RBF C-SVC main path: ``SVC.fit``
(SMO on a ``KernelEngine``) -> ``serve.pack`` / ``save`` / ``load`` ->
``serve.Predictor``. The four kernels of that path are hand-written CUDA
under ``kernels/csrc/`` and are built with nvcc at first CUDA use.

Entry points run on the card unless the caller asks for the CPU:
``SVC(device=...)`` and ``Predictor(device=...)`` default to "cuda" and
raise when no card is present; functional entry points take their
device from their input tensors.
"""
from repro_torch.core.svm import SVC  # noqa: F401
