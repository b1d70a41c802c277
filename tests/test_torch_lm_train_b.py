"""The port's train-step loss and gradients against the reference's on
the CPU, one reduced architecture at a time, on the reference's own
``jax.random`` parameters carried across (``models.convert``): the
reference's ``jax.value_and_grad(make_loss_fn(model), has_aux=True)``
against the port's ``training.train.make_loss_fn`` and autograd, each
gradient tensor compared by name (``convert.flatten``). bf16 compute in
both: the loss within 1e-3 relative, each gradient within 5e-2 of its
reference gradient's largest magnitude (Mamba2's per-head ``A_log`` and
``dt_bias``, whose bf16 gradients cancel: 0.25); again with the
activations in float32 in both packages, every gradient within 1e-4
(``torch_lm_train_helpers``).
Attention's gradient takes the reference's XLA path here and
``ops.ssd_diag``'s plain backward; the CUDA kernels are held to their
plain versions on the card (``tests/test_torch_cuda_lm.py``).

The ten architectures are split over ``test_torch_lm_train_{a,b,c}.py``
so that pytest-xdist's ``--dist loadfile`` spreads them; this file:
the SSM, the hybrid and the encoder-decoder.
"""
import pytest

from torch_lm_train_helpers import run_grad_pair
from torch_lm_train_helpers import (  # noqa: F401  (collected here)
    test_gradients_match_reference, test_gradients_match_reference_float32,
    test_loss_matches_reference)

ARCHS = ['mamba2_780m', 'zamba2_1p2b', 'whisper_medium']


@pytest.fixture(scope="module", params=ARCHS)
def grad_pair(request):
    return run_grad_pair(request.param)
