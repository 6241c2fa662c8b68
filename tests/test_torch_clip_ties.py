"""Gradients at the clip bounds, the port against the JAX package.

JAX's ``jnp.clip`` and ``jnp.maximum`` give gradient 0.5 at an exact bound;
``torch.clamp`` gives 1.  The port's ``ops.math.clip`` follows JAX, and
every clip the training path differentiates goes through it.  Rendered and
replayed images hold many pixels at exactly 0 and 1, so the render's
parameter gradients are held against ``jax.grad`` of JAX's ``render_blend``
on such images.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptiveisp_tpu.config import Config as JConfig
from adaptiveisp_tpu.ops import bank as jbank
from adaptiveisp_tpu_torch.config import Config
from adaptiveisp_tpu_torch.ops import bank as tbank
from adaptiveisp_tpu_torch.ops.math import clip, clip_grad_mask
from torch_suite import cheap_xla, one_torch_thread  # noqa: F401

POINTS = np.array([-1.0, 0.0, 0.001, 0.3, 1.0, 2.0, 5.0], np.float32)


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (0.0, None), (0.001, None),
                                   (0.0, 5.0)],
                         ids=["clip01", "relu", "gamma_floor", "clamp5"])
def test_clip_gradient_matches_jax_at_ties(lo, hi):
    def fj(x):
        y = jnp.maximum(x, lo) if hi is None else jnp.clip(x, lo, hi)
        return jnp.sum(y * jnp.arange(1.0, 8.0))

    want = np.asarray(jax.grad(fj)(jnp.asarray(POINTS)))
    x = torch.from_numpy(POINTS.copy()).requires_grad_(True)
    y = clip(x, lo, hi)
    (y * torch.arange(1.0, 8.0)).sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), want)
    np.testing.assert_array_equal(y.detach().numpy(),
                                  np.clip(POINTS, lo, hi))
    np.testing.assert_array_equal(clip_grad_mask(torch.from_numpy(POINTS),
                                                 lo, hi).numpy(),
                                  want / np.arange(1.0, 8.0))


def test_render_blend_parameter_gradients_match_jax():
    """Masking on, images with exact 0/1 pixels.  Blend rows: a hard
    one-hot on denoise, a hard one-hot on saturation_plus, a soft row with
    denoise gated off and a soft row over all ten filters.  Gradients of
    sum(render * g) with respect to every filter's squashed parameters and
    mask parameters, to 1e-4 of each tensor's largest entry (float32 sums
    over 4 x 24 x 24 pixels in another order)."""
    jcfg, cfg = JConfig(masking=True), Config(masking=True)
    rng = np.random.RandomState(0)
    n, size = 4, 24
    img = rng.uniform(-0.2, 1.2, (n, size, size, 3)).clip(0, 1)
    img = img.astype(np.float32)
    g = rng.randn(n, size, size, 3).astype(np.float32)
    specs = jbank.filter_specs(jcfg)
    k_dn = jcfg.filters.index("denoise")
    weights = np.zeros((n, len(specs)), np.float32)
    weights[0, k_dn] = 1.0
    weights[1, jcfg.filters.index("saturation_plus")] = 1.0
    weights[2:] = rng.dirichlet(np.ones(len(specs)), 2)
    weights[2, k_dn] = 0.0
    params = [np.asarray(s.squash(jcfg, jnp.asarray(
        rng.randn(n, s.n_params).astype(np.float32)))) for s in specs]
    masks = [rng.randn(n, 6).astype(np.float32) for _ in specs]

    def loss_j(ps, ms):
        out = jbank.render_blend(jcfg, jnp.asarray(img), ps,
                                 jnp.asarray(weights), ms)
        return jnp.sum(out * jnp.asarray(g))

    gp_j, gm_j = jax.jit(jax.grad(loss_j, argnums=(0, 1)))(
        [jnp.asarray(p) for p in params], [jnp.asarray(m) for m in masks])
    ps = [torch.from_numpy(p.copy()).requires_grad_(True) for p in params]
    ms = [torch.from_numpy(m).requires_grad_(True) for m in masks]
    out = tbank.render_blend(cfg, torch.from_numpy(img), ps,
                             torch.from_numpy(weights), ms)
    (out * torch.from_numpy(g)).sum().backward()
    for i, spec in enumerate(specs):
        for what, got, want in (("params", ps[i].grad, gp_j[i]),
                                ("mask", ms[i].grad, gm_j[i])):
            want = np.asarray(want)
            scale = max(float(np.abs(want).max()), 1e-12)
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=1e-4 * scale,
                                       err_msg=f"{spec.name} {what}")
    assert float(np.abs(np.asarray(gp_j[k_dn])).max()) > 0
