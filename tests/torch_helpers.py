"""Shared pieces of the ``tests/test_torch_*.py`` files (the PyTorch port
held against the JAX reference). Inputs are made with numpy and handed to
both packages."""
import itertools

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


@pytest.fixture
def compile_guard():
    """The port's runtime compile budget
    (``repro_torch.analysis.compile_guard``). Import it into a test
    module (``from torch_helpers import compile_guard``) and use it as a
    factory, each test declaring its own budget::

        def test_replay(compile_guard):
            with compile_guard(budget=0, note="replay"):
                svc.predict(...)   # a fresh program -> the test fails
    """
    from repro_torch.analysis.compile_guard import CompileGuard
    return CompileGuard


# flash_attention calls a prefill or a forward makes on a card at the
# reduced LM configs: one per eligible attention layer (gemma3's windowed
# local layer and cross-attention never; MLA only where its v dim equals
# its q / k dim, as at the reduced size, 32 and 16 + 16, and not at the
# full one, 64 and 64 + 32), none a decode step
FLASH_CALLS = {"phi4_mini_3p8b": 2, "gemma3_12b": 1, "minicpm3_4b": 2,
               "mamba2_780m": 0, "zamba2_1p2b": 1, "whisper_medium": 4,
               "deepseek_moe_16b": 2, "phi3_vision_4p2b": 2,
               "qwen2_moe_a2p7b": 2, "deepseek_67b": 2}


def tt(a, dtype=torch.float32, device="cpu"):
    """numpy -> torch tensor on ``device``."""
    return torch.from_numpy(np.array(a)).to(device, dtype)  # a writable copy


def np_(t):
    """torch or jax array -> numpy."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


_groups = itertools.count()


def run_ranks(fn, n_ranks: int, *, axis: str = "shards", device="cpu",
              timeout: float = 60.0):
    """``fn(mesh)`` on ``n_ranks`` thread ranks of one gloo group (a
    ``ProcessGroupGloo`` a thread over a shared in-memory store: no
    ``init_process_group``, no port), each rank's mesh one axis named
    ``axis`` on ``device``. Returns the ranks' results in rank order.
    The group times out after ``timeout`` seconds, the threads are
    joined with a timeout too, and the first exception a rank raises is
    re-raised here, so a rank that fails never leaves a test waiting
    longer than the group's timeout."""
    import datetime
    import threading
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_shard_mesh

    store = dist.PrefixStore(f"ranks{next(_groups)}", dist.HashStore())
    results, errors = [None] * n_ranks, []

    def rank(r):
        try:
            group = dist.ProcessGroupGloo(
                store, r, n_ranks, datetime.timedelta(seconds=timeout))
            results[r] = fn(make_shard_mesh(n_ranks, axis=axis, group=group,
                                            device=device))
        except BaseException as e:   # re-raised by the caller
            errors.append(e)          # in the order they happen

    threads = [threading.Thread(target=rank, args=(r,), daemon=True)
               for r in range(n_ranks)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout + 30.0)
    if any(t.is_alive() for t in threads):
        raise TimeoutError(f"a rank of {n_ranks} did not finish in "
                           f"{timeout + 30.0} s")
    if errors:
        raise errors[0]   # the first to fail; the others may wait on it
    return results
