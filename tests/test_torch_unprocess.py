"""The port's RAW synthesis (``raw/bayer.py``, ``raw/unprocess.py``) against
the JAX package's.

The mosaic helpers agree exactly.  Every deterministic stage, and every
chain given the ``RawMetadata`` JAX drew (the noise field and v2's first
brightness ratio taken from JAX's own keys), agree within 1e-6.  The
port's draws come from a ``torch.Generator``: they are held to their ranges
and distributions, and the noise to its mean and variance over a seeded
batch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptiveisp_tpu.raw import bayer as jbayer
from adaptiveisp_tpu.raw import unprocess as jun
from adaptiveisp_tpu_torch.raw import bayer
from adaptiveisp_tpu_torch.raw import unprocess as un
from test_torch_nlm import cheap_xla, one_torch_thread  # noqa: F401

ATOL = 1e-6


def _img(seed, shape=(2, 12, 16, 3)):
    return np.random.RandomState(seed).uniform(
        0.0, 1.0, shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _meta(m):
    return un.RawMetadata(*(_t(f) for f in m))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                               rtol=0)


def test_mosaic_and_reconstruct_exact():
    x = _img(0, (2, 8, 10, 3))
    for p in ("RGGB", "RGBG"):
        np.testing.assert_array_equal(
            bayer.mosaic(_t(x), p).numpy(),
            np.asarray(jbayer.mosaic(jnp.asarray(x), p)))
    planes = _img(1, (4, 5, 4))
    for p in bayer.BAYER_INDICES:
        np.testing.assert_array_equal(
            bayer.reconstruct_bayer(_t(planes), p).numpy(),
            np.asarray(jbayer.reconstruct_bayer(jnp.asarray(planes), p)))
    with pytest.raises(ValueError):
        bayer.mosaic(_t(x), "XYZW")


def test_deterministic_stages():
    x = _img(2)
    x[0, 0, :4] = np.array([0.0, 1.0, 0.5, 0.95])[:, None]  # ends, the knee
    xt, xj = _t(x), jnp.asarray(x)
    _close(un.inverse_smoothstep(xt), jun.inverse_smoothstep(xj))
    _close(un.gamma_expansion(xt), jun.gamma_expansion(xj))
    ccm = np.asarray(jun.random_ccm(jax.random.PRNGKey(3)))
    _close(un.apply_ccm(xt, _t(ccm)), jun.apply_ccm(xj, jnp.asarray(ccm)))
    g = (1.3, 2.1, 1.7)
    _close(un.safe_invert_gains(xt, *(torch.tensor(v) for v in g)),
           jun.safe_invert_gains(xj, *(jnp.asarray(v) for v in g)))
    out, ratio = un.adjust_random_brightness(xt, 0.25)
    _close(out, jun.adjust_random_brightness(None, xj, 0.25)[0])


@pytest.mark.parametrize("kw", [
    dict(),
    dict(add_noise=True, brightness_range=(0.1, 0.3)),
    dict(add_noise=True, use_linear=True, noise_level=0.004),
], ids=["plain", "log_noise_brightness", "linear_noise"])
def test_wo_mosaic_chain_on_jax_metadata(kw):
    key = jax.random.PRNGKey(11)
    x = _img(4)
    want, meta = jun.unprocess_wo_mosaic(key, jnp.asarray(x), **kw)
    noise = jax.random.normal(jax.random.split(key, 5)[4], x.shape)
    got, meta_t = un.unprocess_wo_mosaic(_t(x), meta=_meta(meta),
                                         noise=_t(noise), **kw)
    _close(got, want)
    assert meta_t.gain is not None


def test_v2_mosaic_and_canon_on_jax_metadata():
    key = jax.random.PRNGKey(12)
    x = _img(5, (12, 16, 3))
    kw = dict(add_noise=True, brightness_range=(0.2, 0.4))
    want, meta = jun.unprocess_wo_mosaic_v2(key, jnp.asarray(x), **kw)
    keys = jax.random.split(key, 6)
    pre = jax.random.uniform(keys[2]) * 0.4 + 0.5
    noise = jax.random.normal(keys[5], x.shape)
    got, _ = un.unprocess_wo_mosaic_v2(_t(x), meta=_meta(meta),
                                       pre_gain=_t(pre), noise=_t(noise),
                                       **kw)
    _close(got, want)
    for p in ("RGGB", "RGBG"):
        want, meta = jun.unprocess(key, jnp.asarray(x), p)
        got, _ = un.unprocess(_t(x), p, meta=_meta(meta))
        assert tuple(got.shape) == (6, 8, 4)
        _close(got, want)
    want, meta = jun.unprocess_canon(key, jnp.asarray(x))
    got, meta_t = un.unprocess_canon(_t(x), meta=_meta(meta))
    _close(got, want)
    _close(meta_t.cam2rgb, meta.cam2rgb)


def test_batch_on_jax_metadata():
    key = jax.random.PRNGKey(13)
    x = _img(6, (3, 8, 8, 3))
    kw = dict(add_noise=True, brightness_range=(0.1, 0.3))
    want, meta = jax.jit(lambda k, im: jun.unprocess_batch(k, im, **kw))(
        key, jnp.asarray(x))
    noise = np.stack([np.asarray(jax.random.normal(
        jax.random.split(k, 5)[4], x.shape[1:]))
        for k in jax.random.split(key, 3)])
    got, meta_t = un.unprocess_batch(_t(x), meta=_meta(meta),
                                     noise=_t(noise), **kw)
    _close(got, want)
    assert tuple(meta_t.cam2rgb.shape) == (3, 3, 3)


def test_draws_ranges_and_distributions():
    """Per image draws from one generator: CCM rows sum to 1, the gains
    and levels in their ranges, read noise log-linear in shot noise with
    a N(0, 0.26^2) residual, rgb gain 1 / N(0.8, 0.1^2)."""
    g = torch.Generator().manual_seed(0)
    x = torch.rand(256, 4, 4, 3, generator=g)
    _, m = un.unprocess_batch(x, generator=g, add_noise=True,
                              brightness_range=(0.1, 0.3))
    rgb2cam = torch.linalg.inv(m.cam2rgb.double())
    np.testing.assert_allclose(rgb2cam.sum(-1).numpy(), 1.0, atol=1e-5)
    assert bool(((m.red_gain >= 1.9) & (m.red_gain < 2.4)).all())
    assert bool(((m.blue_gain >= 1.5) & (m.blue_gain < 1.9)).all())
    assert bool(((m.gain >= 0.1) & (m.gain < 0.3)).all())
    assert bool(((m.shot_noise >= 1e-4) & (m.shot_noise <= 0.012)).all())
    resid = (torch.log(m.read_noise) - 2.18 * torch.log(m.shot_noise)
             - 1.20) / 0.26
    inv = (1.0 / m.rgb_gain - 0.8) / 0.1
    for z in (resid, inv):
        assert abs(float(z.mean())) < 0.2 and 0.8 < float(z.std()) < 1.2
    # each image draws its own metadata
    assert len(set(m.red_gain.tolist())) == 256


def test_noise_mean_and_variance():
    """Shot and read noise on a flat image: mean the image, variance
    image * shot + read."""
    g = torch.Generator().manual_seed(1)
    flat = torch.full((64, 64, 64, 3), 0.4)
    out = un.add_read_and_shot_noise(flat, 0.01, 0.002, generator=g)
    assert abs(float(out.mean()) - 0.4) < 1e-3
    assert abs(float(out.var()) / (0.4 * 0.01 + 0.002) - 1.0) < 0.02
    # a generator on the same seed repeats the draw
    again = un.add_read_and_shot_noise(
        flat, 0.01, 0.002, generator=torch.Generator().manual_seed(1))
    assert torch.equal(out, again)
