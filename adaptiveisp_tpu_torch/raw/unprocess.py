"""sRGB -> synthetic RAW ("unprocess") on torch tensors, on the card or the
CPU (port of ``adaptiveisp_tpu/raw/unprocess.py``).

Each random draw is split from its transform: ``draw_metadata`` draws a
:class:`RawMetadata` from a ``torch.Generator`` (in place of a PRNG key),
and ``unprocess_wo_mosaic(image, meta=...)`` runs the deterministic chain
given it, so the chain can be held against the JAX package's on the
metadata JAX drew.  The noise field is a standard normal tensor of the
image's shape, drawn from the generator or passed as ``noise``.

    raw, meta = unprocess_batch(images, generator=g, add_noise=True)

Functions, one for one with the JAX module: ``random_ccm``,
``random_gains``, ``inverse_smoothstep``, ``gamma_expansion``,
``apply_ccm``, ``safe_invert_gains``, ``adjust_random_brightness``, the
noise models, ``unprocess_wo_mosaic`` (the training path),
``unprocess_wo_mosaic_v2``, ``unprocess`` / ``unprocess_canon`` (with a
Bayer mosaic) and ``unprocess_batch`` (one draw per image).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from adaptiveisp_tpu_torch.raw.bayer import mosaic

XYZ2CAMS = (
    ((1.0234, -0.2969, -0.2266),
     (-0.5625, 1.6328, -0.0469),
     (-0.0703, 0.2188, 0.6406)),
    ((0.4913, -0.0541, -0.0202),
     (-0.613, 1.3513, 0.2906),
     (-0.1564, 0.2151, 0.7183)),
    ((0.838, -0.263, -0.0639),
     (-0.2887, 1.0725, 0.2496),
     (-0.0627, 0.1427, 0.5438)),
    ((0.6596, -0.2079, -0.0562),
     (-0.4782, 1.3016, 0.1933),
     (-0.097, 0.1581, 0.5181)))

RGB2XYZ = ((0.4124564, 0.3575761, 0.1804375),
           (0.2126729, 0.7151522, 0.0721750),
           (0.0193339, 0.1191920, 0.9503041))

# calibrated Canon cam2rgb
CALIBRATED_CAM2RGB = ((2.04840695, -1.27161572, 0.22320878),
                      (-0.22163155, 1.77694640, -0.55531485),
                      (-0.00770995, -0.59257895, 1.60028890))


class RawMetadata(NamedTuple):
    cam2rgb: torch.Tensor    # [3, 3] ([N, 3, 3] from unprocess_batch)
    rgb_gain: torch.Tensor   # scalar
    red_gain: torch.Tensor
    blue_gain: torch.Tensor
    gain: torch.Tensor       # brightness ratio (1.0 if unused)
    shot_noise: torch.Tensor
    read_noise: torch.Tensor


def _const(values, device) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float32, device=device)


def _uniform(generator, device, lo, hi, shape=()):
    return torch.rand(shape, generator=generator, device=device) * (hi - lo) + lo


def _normal(generator, device, shape=()):
    return torch.randn(shape, generator=generator, device=device)


def _device(generator, device):
    return torch.device(device) if device is not None else (
        generator.device if generator is not None else torch.device("cpu"))


def random_ccm(generator=None, device=None) -> torch.Tensor:
    """A random RGB -> camera CCM: a convex combination of four XYZ -> cam
    matrices, times RGB -> XYZ, rows normalised."""
    dev = _device(generator, device)
    weights = _uniform(generator, dev, 1e-8, 1e8, (4, 1, 1))
    xyz2cam = ((_const(XYZ2CAMS, dev) * weights).sum(0)
               / weights.sum(0))
    rgb2cam = xyz2cam @ _const(RGB2XYZ, dev)
    return rgb2cam / rgb2cam.sum(dim=-1, keepdim=True)


def random_gains(generator=None, device=None):
    """Random brightening and white-balance gains."""
    dev = _device(generator, device)
    rgb_gain = 1.0 / (0.8 + 0.1 * _normal(generator, dev))
    red_gain = _uniform(generator, dev, 1.9, 2.4)
    blue_gain = _uniform(generator, dev, 1.5, 1.9)
    return rgb_gain, red_gain, blue_gain


def inverse_smoothstep(image):
    image = torch.clamp(image, 0.0, 1.0)
    return 0.5 - torch.sin(torch.asin(1.0 - 2.0 * image) / 3.0)


def gamma_expansion(image):
    return torch.clamp_min(image, 1e-8) ** 2.2


def apply_ccm(image, ccm):
    """out[..., k] = sum_c image[..., c] * ccm[k, c]."""
    return torch.einsum("...c,kc->...k", image, ccm)


def safe_invert_gains(image, rgb_gain, red_gain, blue_gain):
    """Invert the gains, masking near-white pixels."""
    gains = torch.stack([1.0 / red_gain, torch.ones_like(red_gain),
                         1.0 / blue_gain]) / rgb_gain
    gray = image.mean(dim=-1, keepdim=True)
    inflection = 0.9
    mask = (torch.clamp_min(gray - inflection, 0.0)
            / (1.0 - inflection)) ** 2.0
    safe_gains = torch.maximum(mask + (1.0 - mask) * gains, gains)
    return image * safe_gains


def adjust_random_brightness(image, s_range=(0.1, 0.3), generator=None):
    """image * ratio, ratio: uniform in ``s_range`` for a pair, the value
    itself for a scalar."""
    if isinstance(s_range, (list, tuple)):
        lo, hi = s_range
        ratio = torch.rand((), generator=generator,
                           device=image.device) * (hi - lo) + lo
    else:
        ratio = torch.as_tensor(s_range, dtype=image.dtype,
                                device=image.device)
    return image * ratio, ratio


def random_noise_levels_log(generator=None, shot_noise=None, device=None):
    """Log-log linear noise model: (shot, read)."""
    dev = _device(generator, device)
    if shot_noise is None:
        log_shot = _uniform(generator, dev, math.log(0.0001),
                            math.log(0.012))
        shot = torch.exp(log_shot)
    else:
        shot = torch.as_tensor(shot_noise, dtype=torch.float32, device=dev)
        log_shot = torch.log(shot)
    log_read = 2.18 * log_shot + 1.20 + 0.26 * _normal(generator, dev)
    return shot, torch.exp(log_read)


def random_noise_levels_linear(generator=None, shot_noise=None, device=None):
    """Linear-domain noise model: (shot, read)."""
    dev = _device(generator, device)
    if shot_noise is None:
        shot = _uniform(generator, dev, 0.0001, 0.012)
    else:
        shot = torch.as_tensor(shot_noise, dtype=torch.float32, device=dev)
    log_read = 2.18 * torch.log(shot) + 1.20 + 0.26 * _normal(generator, dev)
    return shot, torch.exp(log_read)


def add_read_and_shot_noise(image, shot_noise=0.01, read_noise=0.005,
                            generator=None, noise=None):
    """image + sqrt(image * shot + read) * ``noise`` (standard normal, of
    the image's shape; drawn from ``generator`` when not given)."""
    variance = image * shot_noise + read_noise
    if noise is None:
        noise = torch.randn(image.shape, generator=generator,
                            device=image.device, dtype=image.dtype)
    return image + torch.sqrt(variance) * noise


def draw_metadata(generator=None, device=None, add_noise: bool = False,
                  brightness_range=None, noise_level=None,
                  use_linear: bool = False):
    """The random part of :func:`unprocess_wo_mosaic`: (RawMetadata,
    rgb2cam), drawn in the order CCM, gains, brightness, noise levels."""
    dev = _device(generator, device)
    rgb2cam = random_ccm(generator, dev)
    rgb_gain, red_gain, blue_gain = random_gains(generator, dev)
    gain = torch.ones((), device=dev)
    if brightness_range is not None:
        _, gain = adjust_random_brightness(gain, brightness_range, generator)
    shot = read = torch.zeros((), device=dev)
    if add_noise:
        levels = (random_noise_levels_linear if use_linear
                  else random_noise_levels_log)
        shot, read = levels(generator, noise_level, dev)
    meta = RawMetadata(torch.linalg.inv(rgb2cam), rgb_gain, red_gain,
                       blue_gain, gain, shot, read)
    return meta, rgb2cam


def _rgb2cam(meta: RawMetadata) -> torch.Tensor:
    """The RGB -> camera CCM back from ``meta.cam2rgb`` (inverted in
    float64)."""
    return torch.linalg.inv(meta.cam2rgb.double()).float()


def _add_noise(image, meta, generator, noise):
    image = add_read_and_shot_noise(image, meta.shot_noise, meta.read_noise,
                                    generator, noise)
    return torch.clamp(image, 0.0, 1.0)


def unprocess_wo_mosaic(image, meta: Optional[RawMetadata] = None,
                        generator=None, add_noise: bool = False,
                        brightness_range=None, noise_level=None,
                        use_linear: bool = False, noise=None):
    """The training-path unprocess of an [..., 3] sRGB image in [0, 1]:
    x0.9, inverse smoothstep, gamma expansion, CCM, inverted gains, clip,
    brightness ratio, shot and read noise.  ``meta`` given: the chain on
    it; else drawn from ``generator``.  Returns (raw_rgb, RawMetadata)."""
    if meta is None:
        meta, rgb2cam = draw_metadata(generator, image.device, add_noise,
                                      brightness_range, noise_level,
                                      use_linear)
    else:
        rgb2cam = _rgb2cam(meta)
    image = image * 0.9
    image = inverse_smoothstep(image)
    image = gamma_expansion(image)
    image = apply_ccm(image, rgb2cam)
    image = safe_invert_gains(image, meta.rgb_gain, meta.red_gain,
                              meta.blue_gain)
    image = torch.clamp(image, 0.0, 1.0)
    if brightness_range is not None:
        image = image * meta.gain
    if add_noise:
        image = _add_noise(image, meta, generator, noise)
    return image, meta


def unprocess_wo_mosaic_v2(image, meta: Optional[RawMetadata] = None,
                           generator=None, add_noise: bool = False,
                           brightness_range=None, noise_level=None,
                           use_linear: bool = False, pre_gain=None,
                           noise=None):
    """The reordered variant: a brightness ratio in [0.5, 0.9]
    (``pre_gain``, drawn after the metadata when not given) first, then
    gains, gamma expansion, inverse smoothstep, CCM, clip, brightness and
    noise."""
    if meta is None:
        meta, rgb2cam = draw_metadata(generator, image.device, add_noise,
                                      brightness_range, noise_level,
                                      use_linear)
    else:
        rgb2cam = _rgb2cam(meta)
    if pre_gain is None:
        pre_gain = _uniform(generator, image.device, 0.5, 0.9)
    image = image * pre_gain
    image = safe_invert_gains(image, meta.rgb_gain, meta.red_gain,
                              meta.blue_gain)
    image = gamma_expansion(image)
    image = inverse_smoothstep(image)
    image = apply_ccm(image, rgb2cam)
    image = torch.clamp(image, 0.0, 1.0)
    if brightness_range is not None:
        image = image * meta.gain
    if add_noise:
        image = _add_noise(image, meta, generator, noise)
    return image, meta


def _mosaic_chain(image, rgb2cam, gains, pattern):
    image = inverse_smoothstep(image)
    image = gamma_expansion(image)
    image = apply_ccm(image, rgb2cam)
    image = safe_invert_gains(image, *gains)
    return mosaic(torch.clamp(image, 0.0, 1.0), pattern)


def _unit_meta(cam2rgb, gains, dev):
    one, zero = torch.ones((), device=dev), torch.zeros((), device=dev)
    return RawMetadata(cam2rgb, *gains, one, zero, zero)


def unprocess(image, pattern: str = "RGGB",
              meta: Optional[RawMetadata] = None, generator=None):
    """Full unprocess with a Bayer mosaic -> [..., H/2, W/2, 4]."""
    dev = image.device
    if meta is None:
        rgb2cam = random_ccm(generator, dev)
        gains = random_gains(generator, dev)
        meta = _unit_meta(torch.linalg.inv(rgb2cam), gains, dev)
    else:
        rgb2cam = _rgb2cam(meta)
        gains = (meta.rgb_gain, meta.red_gain, meta.blue_gain)
    return _mosaic_chain(image, rgb2cam, gains, pattern), meta


def unprocess_canon(image, meta: Optional[RawMetadata] = None,
                    generator=None):
    """Unprocess through the calibrated Canon CCM, RGBG mosaic."""
    dev = image.device
    cam2rgb = _const(CALIBRATED_CAM2RGB, dev)
    gains = (random_gains(generator, dev) if meta is None else
             (meta.rgb_gain, meta.red_gain, meta.blue_gain))
    out = _mosaic_chain(image, torch.linalg.inv(cam2rgb), gains, "RGBG")
    return out, _unit_meta(cam2rgb, gains, dev)


def unprocess_batch(images, generator=None, add_noise: bool = False,
                    brightness_range=None, noise_level=None,
                    use_linear: bool = False,
                    meta: Optional[RawMetadata] = None, noise=None):
    """:func:`unprocess_wo_mosaic` over [N, H, W, 3] with one draw per
    image (``meta``, stacked, replays them; ``noise`` [N, H, W, 3] the
    noise field).  Returns (raw [N, H, W, 3], stacked RawMetadata)."""
    outs, metas = [], []
    for i in range(images.shape[0]):
        mi = None if meta is None else RawMetadata(*(f[i] for f in meta))
        out, mi = unprocess_wo_mosaic(
            images[i], meta=mi, generator=generator, add_noise=add_noise,
            brightness_range=brightness_range, noise_level=noise_level,
            use_linear=use_linear, noise=None if noise is None else noise[i])
        outs.append(out)
        metas.append(mi)
    return torch.stack(outs), RawMetadata(
        *(torch.stack(f) for f in zip(*metas)))
