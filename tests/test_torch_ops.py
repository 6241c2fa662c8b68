"""The port's ISP op library against the JAX package, forward only.

Same numpy inputs through ``adaptiveisp_tpu.ops`` (jitted on the CPU) and
``adaptiveisp_tpu_torch.ops``.  Images stay off the exact clip bounds, where
JAX's clip gradient differs from torch's (the forward does not).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from adaptiveisp_tpu.config import Config as JConfig
from adaptiveisp_tpu.ops import bank as jbank
from adaptiveisp_tpu.ops import masks as jmasks
from adaptiveisp_tpu.ops import math as jmath
from adaptiveisp_tpu_torch.config import Config
from adaptiveisp_tpu_torch.ops import bank, masks
from adaptiveisp_tpu_torch.ops import math as tmath
from torch_suite import cheap_xla, one_torch_thread  # noqa: F401

CFG, JCFG = Config(), JConfig()
# float32 transcendental (exp/pow/cos/tanh) and summation-order differences
ATOL = 2e-5

# jitted once at module level so parametrized cases share one compile
_jblend = jax.jit(lambda x, ps, oh: jbank.render_blend(JCFG, x, ps, oh))
_jswitch = jax.jit(lambda x, ps, s: jbank.render_switch(JCFG, x, ps, s))


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _img(seed, n=2, h=16, w=16):
    return np.random.RandomState(seed).uniform(
        0.02, 0.98, (n, h, w, 3)).astype(np.float32)


def _feats(seed, n, cfg=CFG):
    rng = np.random.RandomState(seed)
    return [rng.randn(n, s.n_params).astype(np.float32)
            for s in bank.filter_specs(cfg)]


@pytest.mark.parametrize("name", sorted(bank.REGISTRY))
def test_filter_squash_and_step_match_jax(name):
    """squash, apply and the full masked-lerp-clip step of every registry
    filter."""
    spec, jspec = bank.get_spec(CFG, name), jbank.get_spec(JCFG, name)
    assert (spec.short_name, spec.n_params, spec.gated) == (
        jspec.short_name, jspec.n_params, jspec.gated)
    img = _img(1)
    feat = np.random.RandomState(2).randn(2, spec.n_params).astype(np.float32)
    p_j = jax.jit(lambda f: jspec.squash(JCFG, f))(jnp.asarray(feat))
    p_t = spec.squash(CFG, _t(feat))
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), atol=1e-6,
                               rtol=1e-5)
    got = bank.apply_one(CFG, spec, _t(img), p_t)
    want = jax.jit(lambda x, p: jbank.apply_one(JCFG, jspec, x, p))(
        jnp.asarray(img), p_j)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("sel", [[4, 0], [1, 7]], ids=["denoise", "no_denoise"])
def test_render_blend_matches_jax(sel):
    """One-hot blend, with and without an image selecting the gated NLM."""
    img, feats = _img(3), _feats(4, 2)
    onehot = np.eye(CFG.n_filters, dtype=np.float32)[sel]
    params = [s.squash(CFG, _t(f)) for s, f in zip(bank.filter_specs(CFG),
                                                    feats)]
    jparams = [jnp.asarray(p.numpy()) for p in params]
    got = bank.render_blend(CFG, _t(img), params, _t(onehot))
    want = _jblend(jnp.asarray(img), jparams, jnp.asarray(onehot))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    cands = bank.render_candidates(CFG, _t(img), params)
    np.testing.assert_allclose(
        got.numpy(), (cands * _t(onehot)[:, :, None, None, None]).sum(1),
        atol=1e-6)


@pytest.mark.parametrize("k", [0, 3, 5])
def test_render_switch_matches_jax(k):
    img, feats = _img(5), _feats(6, 2)
    params = [s.squash(CFG, _t(f)) for s, f in zip(bank.filter_specs(CFG),
                                                    feats)]
    got = bank.render_switch(CFG, _t(img), params, k)
    want = _jswitch(jnp.asarray(img), [jnp.asarray(p.numpy()) for p in params],
                    jnp.int32(k))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_render_pipeline_matches_jax():
    img = _img(7)
    stages = [("exposure", np.array([[0.3], [-0.2]], np.float32)),
              ("gamma", np.array([[0.8], [1.3]], np.float32)),
              ("sharpen", np.array([[1.5], [0.4]], np.float32)),
              ("tone", np.random.RandomState(8).uniform(
                  0.6, 1.8, (2, 8)).astype(np.float32))]
    got = bank.render_pipeline(CFG, _t(img), [(n, _t(p)) for n, p in stages])
    want = jbank.render_pipeline(JCFG, jnp.asarray(img),
                                 [(n, jnp.asarray(p)) for n, p in stages])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_param_offsets_match_jax():
    assert bank.param_offsets(CFG) == jbank.param_offsets(JCFG)


@pytest.mark.parametrize("size,out", [(64, 16), (40, 16), (512, 64)])
def test_adaptive_avg_pool_matches_jax(size, out):
    x = np.random.RandomState(size).rand(1, size, size, 3).astype(np.float32)
    got = tmath.adaptive_avg_pool(_t(x), out)
    want = jmath.adaptive_avg_pool(jnp.asarray(x), out)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_hsv_roundtrip_and_ties_match_jax():
    x = _img(9)
    x[0, 0, 0] = [0.5, 0.5, 0.5]   # min == max
    x[0, 0, 1] = [0.7, 0.7, 0.2]   # r == g == max
    x[0, 0, 2] = [0.1, 0.6, 0.6]   # g == b == max
    hsv_t = tmath.rgb2hsv(_t(x))
    hsv_j = jmath.rgb2hsv(jnp.asarray(x))
    np.testing.assert_allclose(hsv_t.numpy(), np.asarray(hsv_j), atol=1e-6)
    np.testing.assert_allclose(tmath.hsv2rgb(hsv_t).numpy(),
                               np.asarray(jmath.hsv2rgb(hsv_j)), atol=1e-6)


def test_depthwise_conv_same_matches_jax():
    x = _img(10)
    k = np.random.RandomState(11).rand(3, 3).astype(np.float32)
    got = tmath.depthwise_conv3x3(_t(x), k, padding="SAME")
    want = jmath.depthwise_conv3x3(jnp.asarray(x), k, padding="SAME")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_masked_step_matches_jax():
    """With masking on, the quadratic luminance mask and the masked step."""
    cfg, jcfg = CFG.replace(masking=True), JCFG.replace(masking=True)
    img = _img(12, h=16, w=24)
    mp = np.random.RandomState(13).randn(2, 6).astype(np.float32)
    got = masks.get_mask(cfg, _t(img), _t(mp))
    want = jmasks.get_mask(jcfg, jnp.asarray(img), jnp.asarray(mp))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    spec, jspec = bank.get_spec(cfg, "contrast"), jbank.get_spec(
        jcfg, "contrast")
    p = np.array([[0.5], [-0.4]], np.float32)
    got = bank.apply_one(cfg, spec, _t(img), _t(p), _t(mp))
    want = jbank.apply_one(jcfg, jspec, jnp.asarray(img), jnp.asarray(p),
                           jnp.asarray(mp))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_improved_wb_squash_is_the_masked_one_bit_for_bit():
    """The white balance's mask [0, 1, 1] is filled on the device: values
    and gradients bit for bit those of the mask uploaded from the host
    that it replaces, signed zeros included."""
    from adaptiveisp_tpu_torch.ops import filters
    from adaptiveisp_tpu_torch.ops.math import tanh_range

    def masked(feat):   # the former squash
        mask = torch.tensor([[0.0, 1.0, 1.0]], dtype=feat.dtype)
        scale = torch.exp(tanh_range(-0.5, 0.5)(feat * mask))
        lum = (1e-5 + 0.27 * scale[:, 0] + 0.67 * scale[:, 1]
               + 0.06 * scale[:, 2])
        return scale * (1.0 / lum)[:, None]

    feat = torch.from_numpy(np.random.RandomState(14).randn(
        6, 3).astype(np.float32) * 3)
    cot = torch.from_numpy(np.random.RandomState(15).randn(
        6, 3).astype(np.float32))
    outs, grads = [], []
    for fn in (masked, lambda f: filters.squash_improved_wb(CFG, f)):
        f = feat.clone().requires_grad_(True)
        out = fn(f)
        out.backward(cot)
        outs.append(out.detach())
        grads.append(f.grad)
    assert torch.equal(outs[0].view(torch.int32), outs[1].view(torch.int32))
    assert torch.equal(grads[0].view(torch.int32),
                       grads[1].view(torch.int32))


@pytest.mark.parametrize("h,w", [(16, 24), (37, 20)])
def test_mask_grid_is_the_float64_grid_bit_for_bit(h, w):
    """The mask grid is made on the device in float64, then cast: bit for
    bit the numpy grid it replaces."""
    shorter = min(h, w)
    i = (np.arange(h, dtype=np.float64) + (shorter - h) / 2.0) / shorter - 0.5
    j = (np.arange(w, dtype=np.float64) + (shorter - w) / 2.0) / shorter - 0.5
    gy, gx = masks.mask_grid(h, w)
    assert gy.shape == gx.shape == (h, w)
    np.testing.assert_array_equal(
        gy.numpy(), np.broadcast_to(i[:, None], (h, w)).astype(np.float32))
    np.testing.assert_array_equal(
        gx.numpy(), np.broadcast_to(j[None, :], (h, w)).astype(np.float32))
