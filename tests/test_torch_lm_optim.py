"""The port's optimizers (``repro_torch.optim.adamw``) against the
reference's on the same numpy gradient trees, on the CPU: AdamW (a
constant lr and the cosine schedule, the global-norm clip active and
inactive), SGD with and without momentum, ``global_norm`` and
``cosine_schedule``, over 5 steps at rtol 1e-6 (float32 arithmetic in
the reference's order in both; XLA and torch may round a transcendental
or a sum's order a unit apart), with an atol of 1e-6 of each tensor's
largest magnitude: an entry of ``mu = b1 m + (1 - b1) g`` that cancels
to near 0 keeps the absolute error of its terms (the clip's scale, one
unit apart between the two norms, moves such an entry by 2e-6 of
itself). The optimizers are held on fixed gradients, not through a
train step: Adam's first step is about lr sign(g), which flips on tiny
gradients.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.optim import adamw as J
from repro_torch.optim import adamw as T

RTOL = 1e-6
SHAPES = {"embed": {"table": (7, 5)}, "layers": {"w": (3, 4, 6),
                                                  "b": (6,)},
          "final_norm": (5,)}


def tree(seed: int, scale: float = 1.0) -> dict:
    rng = np.random.default_rng(seed)

    def make(node):
        if isinstance(node, dict):
            return {k: make(v) for k, v in node.items()}
        return (scale * rng.normal(size=node)).astype(np.float32)
    return make(SHAPES)


def by_name(t: dict, prefix: str = "") -> dict:
    """A nested tree as ``{dotted name: tensor}``, in jax's leaf order
    (keys sorted), so both packages sum the norm in one order."""
    out = {}
    for k in sorted(t):
        if isinstance(t[k], dict):
            out.update(by_name(t[k], prefix + k + "."))
        else:
            out[prefix + k] = torch.from_numpy(np.array(t[k]))
    return out


def run_both(jopt, topt, grad_scale: float, steps: int = 5):
    """Both optimizers from the same parameters, each step fed the same
    gradient tree; the port's parameters and moments after each step
    against the reference's."""
    params = tree(0)
    jp, tp = jax.tree.map(jnp.asarray, params), by_name(params)
    js, ts = jopt.init(jp), topt.init(tp)
    for i in range(steps):
        g = tree(100 + i, grad_scale)
        jp, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts = topt.update(by_name(g), ts, tp)
        assert ts.step == int(js.step) == i + 1
        for want, got in ((jp, tp), (js.mu, ts.mu)) + (
                ((js.nu, ts.nu),) if js.nu is not None else ()):
            want = by_name(jax.tree.map(np.asarray, want))
            for k in want:
                w = want[k].numpy()
                np.testing.assert_allclose(
                    got[k].numpy(), w, rtol=RTOL,
                    atol=RTOL * float(np.abs(w).max()))


@pytest.mark.parametrize("grad_scale,clipped", [(1.0, True), (0.01, False)])
def test_adamw_matches_reference(grad_scale, clipped):
    norm = float(J.global_norm(tree(100, grad_scale)))
    assert (norm > 1.0) == clipped   # the clip at 1.0 acts, or not
    run_both(J.AdamW(lr=3e-4), T.AdamW(lr=3e-4), grad_scale)


def test_adamw_with_cosine_schedule_and_no_clip_matches_reference():
    kw = dict(peak_lr=1e-2, warmup=2, total=5)
    run_both(J.AdamW(lr=J.cosine_schedule(**kw), grad_clip=0.0,
                     weight_decay=0.05),
             T.AdamW(lr=T.cosine_schedule(**kw), grad_clip=0.0,
                     weight_decay=0.05), 1.0)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_matches_reference(momentum):
    run_both(J.SGD(lr=0.05, momentum=momentum),
             T.SGD(lr=0.05, momentum=momentum), 1.0)


def test_global_norm_matches_reference():
    g = tree(3, 2.0)
    want = float(J.global_norm(jax.tree.map(jnp.asarray, g)))
    got = T.global_norm(by_name(g))
    assert got.dtype == torch.float32 and got.ndim == 0
    np.testing.assert_allclose(float(got), want, rtol=RTOL)
    np.testing.assert_allclose(float(T.global_norm(list(by_name(g).values()))),
                               want, rtol=RTOL)


@pytest.mark.parametrize("warmup,total", [(20, 100), (0, 10), (5, 5)])
def test_cosine_schedule_matches_reference(warmup, total):
    j = J.cosine_schedule(peak_lr=3e-3, warmup=warmup, total=total)
    t = T.cosine_schedule(peak_lr=3e-3, warmup=warmup, total=total)
    for step in range(0, total + 3):
        np.testing.assert_allclose(
            t(step), float(j(jnp.asarray(step, jnp.int32))), rtol=RTOL)


def test_adamw_update_is_in_place_and_not_torch_adamw():
    """The port writes the parameters in place (the model's own tensors
    move); its decay applies after the moments, unlike torch's AdamW,
    which differs already at step 1."""
    params = by_name(tree(0))
    before = {k: v.clone() for k, v in params.items()}
    ids = {k: id(v) for k, v in params.items()}
    opt = T.AdamW(lr=1e-2)
    new, state = opt.update(by_name(tree(1, 0.01)), opt.init(params), params)
    assert {k: id(v) for k, v in new.items()} == ids
    ref = [torch.nn.Parameter(v.clone()) for v in before.values()]
    torch_opt = torch.optim.AdamW(ref, lr=1e-2, betas=(0.9, 0.95),
                                  eps=1e-8, weight_decay=0.1)
    for p, g in zip(ref, by_name(tree(1, 0.01)).values()):
        p.grad = g
    torch_opt.step()
    assert any(not torch.equal(p.detach(), new[k])
               for p, k in zip(ref, new))
