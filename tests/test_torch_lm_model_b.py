"""The port's LM ``Model`` against the reference's on the CPU, one
reduced architecture at a time, on the reference's own ``jax.random``
parameters carried across (``models.convert.from_reference``): forward
logits and aux loss, prefill logits, three decode steps, the cache
length. bf16 compute in both, held to ``LOGIT_TOL`` (3e-2) of the
logits' largest magnitude, greedy tokens equal wherever the reference's
top-2 margin exceeds twice that (``torch_lm_helpers``). Attention takes
the reference's XLA path here (the flash kernel runs only on the card);
Mamba2's intra-chunk term runs ``ops.ssd_diag``'s plain version.

The ten architectures are split over ``test_torch_lm_model_{a,b,c}.py``
so that pytest-xdist's ``--dist loadfile`` spreads them; this file:
the SSM, the hybrid and the encoder-decoder.
"""
import pytest

from torch_lm_helpers import run_pair
from torch_lm_helpers import (  # noqa: F401  (collected here)
    test_forward_matches_reference, test_prefill_and_decode_match_reference)

ARCHS = ['mamba2_780m', 'zamba2_1p2b', 'whisper_medium']


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return run_pair(request.param)
