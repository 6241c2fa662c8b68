"""Differentiable ISP filters as plain tensor functions over NHWC images
(port of ``adaptiveisp_tpu/ops/filters.py``).

Each filter is a pair:

  squash_<name>(cfg, raw_features[N, n_params]) -> params
  apply_<name>(cfg, img[N, H, W, 3], params) -> img

The full per-step op is ``clip(lerp(img, apply(img, squash(feat)), mask))``,
composed by :mod:`adaptiveisp_tpu_torch.ops.bank`.
"""

from __future__ import annotations

import math

import torch

from adaptiveisp_tpu_torch.ops import denoise as _denoise
from adaptiveisp_tpu_torch.ops import sharpen as _sharpen
from adaptiveisp_tpu_torch.ops.math import (
    clip,
    hsv2rgb,
    lerp,
    rgb2hsv,
    rgb2lum,
    tanh_range,
)

LN2 = math.log(2.0)


def _sigmoid(x):
    return 1.0 / (1.0 + torch.exp(-x))


# Exposure: img * 2**p, p in [-3.5, 3.5]
def squash_exposure(cfg, feat):
    return tanh_range(-cfg.exposure_range, cfg.exposure_range, initial=0)(feat)


def apply_exposure(cfg, img, param):
    return img * torch.exp(param[:, None, None, :] * LN2)


# Gamma: clip(img, 1e-3) ** p, p = exp(tanh_range(+-ln 3))
def squash_gamma(cfg, feat):
    log_g = math.log(cfg.gamma_range)
    return torch.exp(tanh_range(-log_g, log_g)(feat))


def apply_gamma(cfg, img, param):
    return torch.pow(clip(img, 0.001), param[:, None, None, :])


# Improved white balance: channel gains, R pinned, luminance-normalised
def squash_improved_wb(cfg, feat):
    log_wb_range = 0.5
    mask = torch.ones_like(feat[:1])   # [0, 1, 1], filled on the device
    mask[:, 0] = 0.0
    scale = torch.exp(tanh_range(-log_wb_range, log_wb_range)(feat * mask))
    lum = 1e-5 + 0.27 * scale[:, 0] + 0.67 * scale[:, 1] + 0.06 * scale[:, 2]
    return scale * (1.0 / lum)[:, None]


def apply_improved_wb(cfg, img, param):
    return img * param[:, None, None, :]


# Colour curve (not in the default roster): 8-segment per-channel curve
def squash_color(cfg, feat):
    curve = feat.reshape(-1, cfg.curve_steps, 3)
    return tanh_range(*cfg.color_curve_range, initial=1)(curve)


def apply_color(cfg, img, param):
    steps = cfg.curve_steps
    curve_sum = param.sum(dim=1) + 1e-30  # [N, 3]
    total = torch.zeros_like(img)
    for i in range(steps):
        seg = clip(img - i / steps, 0.0, 1.0 / steps)
        total = total + seg * param[:, i][:, None, None, :]
    return total * (steps / curve_sum)[:, None, None, :]


# Tone curve: 8-segment global curve
def squash_tone(cfg, feat):
    curve = feat.reshape(-1, cfg.curve_steps)
    return tanh_range(*cfg.tone_curve_range)(curve)


def apply_tone(cfg, img, param):
    steps = cfg.curve_steps
    curve_sum = param.sum(dim=1) + 1e-30  # [N]
    total = torch.zeros_like(img)
    for i in range(steps):
        seg = clip(img - i / steps, 0.0, 1.0 / steps)
        total = total + seg * param[:, i][:, None, None, None]
    return total * (steps / curve_sum)[:, None, None, None]


def squash_tone_v2(cfg, feat):
    return squash_tone(cfg, feat)


def apply_tone_v2(cfg, img, param):
    """ToneFilterV2 differs from ToneFilter only in how the original code
    broadcast its parameter; with flat [N, steps] params the math is the
    same."""
    return apply_tone(cfg, img, param)


# Contrast: cosine luminance remap, lerp by tanh(p)
def squash_contrast(cfg, feat):
    return torch.tanh(feat)


def apply_contrast(cfg, img, param):
    lum = clip(rgb2lum(img), 0.0, 1.0)
    contrast_lum = -torch.cos(math.pi * lum) * 0.5 + 0.5
    contrast_img = img / (lum + 1e-6) * contrast_lum
    return lerp(img, contrast_img, param[:, None, None, :])


# Black & white: lerp toward luminance, sigmoid(p)
def squash_wnb(cfg, feat):
    return _sigmoid(feat)


def apply_wnb(cfg, img, param):
    return lerp(img, rgb2lum(img), param[:, None, None, :])


# Saturation boost: HSV S-boost, blend by sigmoid(p)
def squash_saturation_plus(cfg, feat):
    return _sigmoid(feat)


def apply_saturation_plus(cfg, img, param):
    img = clip(img, 0.0, 1.0)
    hsv = rgb2hsv(img)
    s, v = hsv[..., 1:2], hsv[..., 2:3]
    enhanced_s = s + (1 - s) * (0.5 - torch.abs(0.5 - v)) * 0.8
    hsv1 = torch.cat([hsv[..., 0:1], enhanced_s, hsv[..., 2:]], dim=-1)
    full_color = hsv2rgb(hsv1)
    p = param[:, None, None, :]
    return img * (1.0 - p) + full_color * p


# NLM denoise: strength sigmoid(p); the CUDA kernel on a CUDA tensor
def squash_denoise(cfg, feat):
    return _sigmoid(feat)


def apply_denoise(cfg, img, param, gate=None):
    img = clip(img, 0.0, 1.0)
    return _denoise.nlm_gray_dispatch(img, param, gate=gate)


# Sharpen: 3x3 centre-5 kernel, p in [0, 10]
def squash_sharpen(cfg, feat):
    return tanh_range(*cfg.sharpen_range)(feat)


def apply_sharpen(cfg, img, param):
    return _sharpen.adjust_sharpness(img, param[:, None, None, :])


def squash_sharpen_v2(cfg, feat):
    return tanh_range(*cfg.sharpen_range)(feat)


def apply_sharpen_v2(cfg, img, param):
    return _sharpen.sharpness(img, param[:, None, None, :])


# Unsharp-mask sharpen (sigma, amount), not in the default roster
def squash_sharpen_usm(cfg, feat):
    return tanh_range(*cfg.usm_sharpen_range)(feat)


def apply_sharpen_usm(cfg, img, param):
    return _sharpen.unsharp_mask(img, param[:, 0], param[:, 1],
                                 kernel_size=5, clip=True)


# Colour correction matrix: row-normalised 3x3
def squash_ccm(cfg, feat):
    return tanh_range(*cfg.ccm_range)(feat)


def color_correction_matrix(img, ccm):
    """img NHWC, ccm [N, 3, 3]: out[..., k] = sum_c img[..., c] * ccm[k, c]."""
    return torch.einsum("nhwc,nkc->nhwk", img, ccm)


def apply_ccm(cfg, img, param):
    ccm = param.reshape(-1, 3, 3)
    ccm = ccm / ccm.sum(dim=-1, keepdim=True)
    return color_correction_matrix(img, ccm)
