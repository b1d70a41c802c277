"""Shared pieces of the ``tests/test_torch_lm_*.py`` files: one reduced
architecture run through the reference's ``Model`` (``jax.random`` init,
jitted forward / prefill / decode) and through the port's ``Model``
holding the same parameters (``models.convert.from_reference``), on the
same numpy-seeded batch; and the two model-level cases, which each
``test_torch_lm_model_*.py`` file imports beside its own ``pair``
fixture over its architectures."""
import numpy as np
import jax
import jax.numpy as jnp
import torch

from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.models.model import Model as JModel
from repro_torch.configs.base import get_config, reduced
from repro_torch.models.convert import from_reference

# the model-level bound: bf16 compute in both packages, so the logits
# agree to bf16 rounding through the stack, not to float32 round-off;
# held as a fraction of the reference logits' largest magnitude
LOGIT_TOL = 3e-2
# the serving shapes of tests/test_models_smoke.py:60
B, S_FWD, S_PREFILL, MAX_LEN, DECODE_STEPS = 2, 32, 16, 32, 3


def batch(cfg, b: int, s: int, seed: int = 0) -> dict:
    """Tokens, and the family's stub embeddings (float32; both models
    round them to bf16 alike)."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32)}
    if cfg.arch_type == "vlm":
        out["vision_embeds"] = rng.normal(
            size=(b, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
    if cfg.arch_type == "audio":
        out["frames"] = rng.normal(
            size=(b, cfg.encoder_frames, cfg.d_model)).astype(np.float32)
    return out


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def compiled(fn, *args):
    """``fn`` jitted for ``args``, each bf16 operation rounded to bf16 as
    the reference's code types it (XLA's excess precision off: with it
    on, XLA's CPU fusions keep bf16 intermediates in float32, and a MoE
    route at a near-tie of the router can flip between the reference's
    own eager and jitted runs)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})


def run_pair(arch: str, seed: int = 1) -> dict:
    """Both models on one reduced architecture: forward logits and aux
    at S_FWD; prefill logits at S_PREFILL into MAX_LEN caches; then
    DECODE_STEPS decode logits, both fed the reference's greedy tokens.
    Returns numpy float32 results keyed ``ref`` / ``port`` and the
    configs."""
    jcfg, cfg = jreduced(jget_config(arch)), reduced(get_config(arch))
    jm = JModel(jcfg)
    params, _ = jm.init(jax.random.PRNGKey(seed))
    port = from_reference(cfg, jax.tree.map(np.asarray, params),
                          device="cpu")
    data = batch(cfg, B, S_FWD)
    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    ref, got = {}, {}
    logits, aux = compiled(jm.forward, params, jdata)(params, jdata)
    ref["forward"], ref["aux"] = f32(logits), float(aux)
    t_logits, t_aux = port.forward(data)
    got["forward"], got["aux"] = f32(t_logits), float(t_aux)

    pdata = dict(data, tokens=data["tokens"][:, :S_PREFILL])
    jcache = jm.cache_init(B, MAX_LEN)
    jpdata = {k: jnp.asarray(v) for k, v in pdata.items()}
    lg, jcache = compiled(jm.prefill, params, jpdata, jcache)(
        params, jpdata, jcache)
    tcache = port.cache_init(B, MAX_LEN)
    tlg, tcache = port.prefill(pdata, tcache)
    ref["steps"], got["steps"] = [f32(lg)], [f32(tlg)]
    dec = None
    for _ in range(DECODE_STEPS):
        tok = jnp.asarray(np.asarray(jnp.argmax(lg, -1)).astype(np.int32))
        dec = dec or compiled(jm.decode_step, params, tok, jcache)
        lg, jcache = dec(params, tok, jcache)
        tlg, tcache = port.decode_step(np.array(tok), tcache)
        ref["steps"].append(f32(lg))
        got["steps"].append(f32(tlg))
    ref["cache_len"] = int(jm._cache_len(jcache))
    got["cache_len"] = port._cache_len(tcache)
    return {"ref": ref, "port": got, "cfg": cfg, "jcfg": jcfg}


def assert_logits_close(got: np.ndarray, want: np.ndarray, vocab: int,
                        what: str) -> None:
    """Within LOGIT_TOL of the reference logits' largest magnitude over
    the real vocab (padded columns are -1e9 in both), and the greedy
    token equal wherever the reference's top-2 margin exceeds twice
    that bound."""
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    g, r = got[..., :vocab], want[..., :vocab]
    tol = LOGIT_TOL * float(np.abs(r).max())
    err = float(np.abs(g - r).max())
    assert err <= tol, f"{what}: max |port - ref| {err} > {tol}"
    np.testing.assert_array_equal(got[..., vocab:], want[..., vocab:])
    top2 = np.sort(r, -1)[..., -2:]
    sure = (top2[..., 1] - top2[..., 0]) > 2 * tol
    assert np.array_equal(np.argmax(g, -1)[sure], np.argmax(r, -1)[sure]), \
        what


def test_forward_matches_reference(pair):
    ref, got, cfg = pair["ref"], pair["port"], pair["cfg"]
    assert got["forward"].shape == (B, S_FWD, cfg.padded_vocab)
    assert_logits_close(got["forward"], ref["forward"], cfg.vocab_size,
                        "forward")
    np.testing.assert_allclose(got["aux"], ref["aux"], rtol=1e-4,
                               atol=1e-7)


def test_prefill_and_decode_match_reference(pair):
    ref, got, cfg = pair["ref"], pair["port"], pair["cfg"]
    assert len(got["steps"]) == DECODE_STEPS + 1
    for i, (g, r) in enumerate(zip(got["steps"], ref["steps"])):
        assert g.shape == (B, cfg.padded_vocab)
        assert_logits_close(g, r, cfg.vocab_size,
                            "prefill" if i == 0 else f"decode step {i}")
        assert int(np.argmax(g, -1).max()) < cfg.vocab_size
    assert got["cache_len"] == ref["cache_len"]
