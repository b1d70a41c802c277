"""Shared pieces of the ``tests/test_torch_*.py`` files (the PyTorch port
held against the JAX reference). Inputs are made with numpy and handed to
both packages."""
import numpy as np
import pytest
import torch


@pytest.fixture
def cuda():
    """The card, for tests marked ``requires_cuda``. Decided when the test
    runs, never at import, so every pytest worker collects the same
    tests; without a card the test skips, which counts as unverified."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the port's CUDA kernels run only on "
                    "the card (run `python3 chip_smoke.py` there)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def tt(a, dtype=torch.float32, device="cpu"):
    """numpy -> torch tensor on ``device``."""
    return torch.from_numpy(np.array(a)).to(device, dtype)  # a writable copy


def np_(t):
    """torch or jax array -> numpy."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)
