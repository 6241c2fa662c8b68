"""The port's other NLM variants against the JAX package's.

``nlm_rgb`` (the reference's NonLocalMeans: RGB distances, circular rolls)
and ``nlm_param`` (NonLocalMeansParam: reflect boundaries, the distance
summed over the whole search window, one learnable strength), with their
helpers ``box_mean`` and ``_box_sum_reflect``: the same seeded arrays
through both packages at small windows (JAX unrolls every offset; its
compile, not the arithmetic, sets the cost).  Outputs to 1e-6 (float32
sums of up to 25 terms in another grouping); gradients in the image to
1e-5 and in the strength to 1e-5 relative, taken through JAX's ``jax.grad``
and the port's autograd, whose per-row checkpointing recomputes each row in
the backward.  Both keep the centre offset's gradient finite (the zero
distance's square root), as JAX's own test asks at
``tests/test_denoise_sharpen.py``; ``h`` at exactly 0 takes JAX's
``maximum`` tie gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptiveisp_tpu.ops import denoise as jden
from adaptiveisp_tpu_torch.ops import denoise as tden
from torch_suite import cheap_xla, one_torch_thread  # noqa: F401

RNG_SEED = 31


def _image(seed, shape):
    """Values a little past [0, 1] on both sides (the luminance clips)."""
    return (np.random.RandomState(seed).rand(*shape) * 1.1 - 0.05).astype(
        np.float32)


def _cotangent(shape):
    return np.linspace(-1.0, 1.0, int(np.prod(shape)), dtype=np.float32
                       ).reshape(shape)


def test_box_helpers_match_jax():
    x = _image(RNG_SEED, (2, 9, 11, 4))
    for ws in (3, 5):
        np.testing.assert_allclose(
            tden.box_mean(torch.from_numpy(x), ws).numpy(),
            np.asarray(jden.box_mean(jnp.asarray(x), ws)), rtol=0, atol=1e-6)
    # a window wider than the frame: numpy's repeated reflection
    for ws, shape in ((5, (1, 9, 11, 3)), (9, (1, 3, 4, 2)),
                      (5, (1, 1, 6, 1))):
        y = _image(RNG_SEED + ws, shape)
        np.testing.assert_allclose(
            tden._box_sum_reflect(torch.from_numpy(y), ws).numpy(),
            np.asarray(jden._box_sum_reflect(jnp.asarray(y), ws)),
            rtol=1e-6, atol=1e-6)
        pad = (ws - 1) // 2
        np.testing.assert_array_equal(
            tden._pad_reflect(torch.from_numpy(y), pad).numpy(),
            np.pad(y, ((0, 0), (pad, pad), (pad, pad), (0, 0)),
                   mode="reflect"))


@pytest.mark.parametrize("ws,patch", [(5, 3), (3, 5)])
def test_nlm_rgb_matches_jax(ws, patch):
    x = _image(RNG_SEED + 1, (2, 12, 13, 3))
    h = np.array([[0.4], [0.05]], np.float32)
    got = tden.nlm_rgb(torch.from_numpy(x), torch.from_numpy(h), ws, patch)
    want = jden.nlm_rgb(jnp.asarray(x), jnp.asarray(h), ws, patch)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def test_nlm_param_matches_jax():
    x = _image(RNG_SEED + 2, (2, 12, 13, 3))
    for ws in (5, 3):
        for h in (0.5, 0.05, 0.0):
            got = tden.nlm_param(torch.from_numpy(x), h, ws)
            want = jden.nlm_param(jnp.asarray(x), jnp.asarray(h), ws)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=1e-6)
    # a [1] strength, and a search window past the frame's height
    got = tden.nlm_param(torch.from_numpy(x[:1, :4]), torch.tensor([0.3]), 9)
    want = jden.nlm_param(jnp.asarray(x[:1, :4]), jnp.asarray([0.3]), 9)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def _grads_close(gx_t, gh_t, gx_j, gh_j):
    gx_j, gh_j = np.asarray(gx_j), np.asarray(gh_j)
    for g in (gx_t, gh_t):
        assert np.isfinite(g).all()
    assert np.abs(gx_t).max() > 0
    np.testing.assert_allclose(gx_t, gx_j, rtol=0, atol=1e-5)
    np.testing.assert_allclose(gh_t.reshape(gh_j.shape), gh_j, rtol=1e-5,
                               atol=1e-7)


def test_nlm_rgb_gradients_match_jax():
    """Image and per-image strength gradients; the second image's strength
    sits at exactly 0 (JAX's maximum gives the tie half the gradient)."""
    x = _image(RNG_SEED + 3, (2, 10, 11, 3))
    h = np.array([[0.4], [0.0]], np.float32)
    v = _cotangent(x.shape)
    gx_j, gh_j = jax.jit(jax.grad(
        lambda r, s: (jden.nlm_rgb(r, s, 3, 3) * v).sum(), argnums=(0, 1)))(
        jnp.asarray(x), jnp.asarray(h))
    xt = torch.from_numpy(x).requires_grad_()
    ht = torch.from_numpy(h).requires_grad_()
    (tden.nlm_rgb(xt, ht, 3, 3) * torch.from_numpy(v)).sum().backward()
    _grads_close(xt.grad.numpy(), ht.grad.numpy(), gx_j, gh_j)


def test_nlm_param_gradients_match_jax():
    """The image gradient and the scalar strength's, as an optimizer that
    owns ``h`` sees it."""
    x = _image(RNG_SEED + 4, (1, 10, 11, 3))
    v = _cotangent(x.shape)
    gx_j, gh_j = jax.jit(jax.grad(
        lambda r, s: (jden.nlm_param(r, s, 3) * v).sum(), argnums=(0, 1)))(
        jnp.asarray(x), jnp.asarray(0.3))
    xt = torch.from_numpy(x).requires_grad_()
    ht = torch.tensor(0.3, requires_grad=True)
    (tden.nlm_param(xt, ht, 3) * torch.from_numpy(v)).sum().backward()
    assert float(ht.grad) != 0.0
    _grads_close(xt.grad.numpy(), ht.grad.numpy(), gx_j, gh_j)
