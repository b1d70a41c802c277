"""The runtime switches the port carries (``models.runtime``) against the
reference's, model-level: each reduced architecture below runs with the
switch set the same way in both packages, and is held to the bounds of
``test_torch_lm_model_*.py`` (forward, prefill, three decode steps).

* ``SCORES_BF16`` and ``EMBED_ONEHOT`` on phi4_mini_3p8b;
* ``MLA_PAD_HEADS`` on minicpm3_4b (4 heads padded to 16, the dummy
  heads' output rows zero);
* ``MOE_GROUPED`` on qwen2_moe_a2p7b (dispatch within each batch row);
* ``CHUNKED_THRESHOLD`` at 16 on gemma3_12b, so the 32- and 16-token
  prefills take ``chunked_attention`` (windowed and global).

The four sharding switches (``SERVE_PURE_TP``, ``WINDOW_CACHE_SP``,
``GATHER_WEIGHTS``, ``MOE_XE_SHARD``) are carried with the reference's
defaults; they act on DTensor parameters only, and
``tests/test_torch_dryrun.py`` / ``test_torch_sharded_lm.py`` run them.
"""
import pytest

from repro.models import runtime as JRT
from repro_torch.models import runtime as TRT
from torch_lm_helpers import run_pair
from torch_lm_helpers import (  # noqa: F401  (collected here)
    test_forward_matches_reference, test_prefill_and_decode_match_reference)

CASES = [("phi4_mini_3p8b", dict(SCORES_BF16=True, EMBED_ONEHOT=True)),
         ("minicpm3_4b", dict(MLA_PAD_HEADS=True)),
         ("qwen2_moe_a2p7b", dict(MOE_GROUPED=True)),
         ("gemma3_12b", dict(CHUNKED_THRESHOLD=16))]


@pytest.fixture(scope="module", params=CASES,
                ids=[f"{a}-{'-'.join(f)}" for a, f in CASES])
def pair(request):
    arch, flags = request.param
    with pytest.MonkeyPatch.context() as mp:
        for name, value in flags.items():
            mp.setattr(JRT, name, value)
            mp.setattr(TRT, name, value)
        return run_pair(arch)


def test_set_flags_names_only_the_carried_switches(monkeypatch):
    defaults = {"SCORES_BF16": False, "CHUNKED_THRESHOLD": 8192,
                "MLA_PAD_HEADS": False, "EMBED_ONEHOT": False,
                "MOE_GROUPED": False, "REMAT_POLICY": "full",
                "MICROBATCHES": 1, "SERVE_PURE_TP": False,
                "WINDOW_CACHE_SP": False, "GATHER_WEIGHTS": False,
                "MOE_XE_SHARD": False}
    assert {k: getattr(TRT, k) for k in TRT.FLAGS} == defaults
    # the reference's switches, with its defaults (UNROLL_SCANS aside:
    # XLA's cost analysis, no counterpart in the port's Python loops)
    assert {k: getattr(JRT, k) for k in TRT.FLAGS} == defaults
    for k in defaults:          # restored after the test
        monkeypatch.setattr(TRT, k, getattr(TRT, k))
    TRT.set_flags(scores_bf16=True, chunked_threshold=4,
                  remat_policy="dots", serve_pure_tp=True,
                  window_cache_sp=True, gather_weights=True,
                  moe_xe_shard=True)
    assert TRT.SCORES_BF16 is True and TRT.CHUNKED_THRESHOLD == 4
    assert TRT.REMAT_POLICY == "dots"
    assert TRT.SERVE_PURE_TP and TRT.WINDOW_CACHE_SP
    assert TRT.GATHER_WEIGHTS and TRT.MOE_XE_SHARD
    with pytest.raises(KeyError, match="unknown runtime flag"):
        TRT.set_flags(unroll_scans=True)
