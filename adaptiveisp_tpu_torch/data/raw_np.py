"""Host-side NumPy unprocess: sRGB to synthetic linear RAW (port of
``adaptiveisp_tpu/data/raw_np.py``).

The dataset's ``raw`` source draws from one ``np.random.RandomState`` in
this order, which is part of parity with the JAX package:

    uniform(1e-8, 1e8, (4,1,1))   # CCM weights
    normal(0.8, 0.1)              # rgb gain
    uniform(1.9, 2.4)             # red gain
    uniform(1.5, 1.9)             # blue gain
    [rand()]                      # brightness ratio if a range is given
    [uniform/normal]              # noise levels + noise field if add_noise
"""

from __future__ import annotations

import numpy as np

XYZ2CAMS = np.array(
    [[[1.0234, -0.2969, -0.2266],
      [-0.5625, 1.6328, -0.0469],
      [-0.0703, 0.2188, 0.6406]],
     [[0.4913, -0.0541, -0.0202],
      [-0.613, 1.3513, 0.2906],
      [-0.1564, 0.2151, 0.7183]],
     [[0.838, -0.263, -0.0639],
      [-0.2887, 1.0725, 0.2496],
      [-0.0627, 0.1427, 0.5438]],
     [[0.6596, -0.2079, -0.0562],
      [-0.4782, 1.3016, 0.1933],
      [-0.097, 0.1581, 0.5181]]])

RGB2XYZ = np.array(
    [[0.4124564, 0.3575761, 0.1804375],
     [0.2126729, 0.7151522, 0.0721750],
     [0.0193339, 0.1191920, 0.9503041]])


def random_ccm(rng=np.random):
    weights = rng.uniform(1e-8, 1e8, size=(4, 1, 1))
    xyz2cam = np.sum(XYZ2CAMS * weights, axis=0) / np.sum(weights, axis=0)
    rgb2cam = np.matmul(xyz2cam, RGB2XYZ)
    return rgb2cam / np.sum(rgb2cam, axis=-1, keepdims=True)


def random_gains(rng=np.random):
    rgb_gain = 1.0 / rng.normal(0.8, 0.1)
    red_gain = rng.uniform(1.9, 2.4)
    blue_gain = rng.uniform(1.5, 1.9)
    return rgb_gain, red_gain, blue_gain


def inverse_smoothstep(image):
    image = np.clip(image, 0.0, 1.0)
    return 0.5 - np.sin(np.arcsin(1.0 - 2.0 * image) / 3.0)


def gamma_expansion(image):
    return np.maximum(image, 1e-8) ** 2.2


def apply_ccm(image, ccm):
    shape = image.shape
    flat = np.reshape(image, [-1, 3])
    return np.reshape(np.tensordot(flat, ccm, [[-1], [-1]]), shape)


def safe_invert_gains(image, rgb_gain, red_gain, blue_gain):
    gains = np.stack((1.0 / red_gain, 1.0, 1.0 / blue_gain)) / rgb_gain
    gains = gains.squeeze()[None, None, :]
    gray = np.mean(image, axis=-1, keepdims=True)
    inflection = 0.9
    mask = (np.maximum(gray - inflection, 0.0) / (1.0 - inflection)) ** 2.0
    safe = np.maximum(mask + (1.0 - mask) * gains, gains)
    return image * safe


def adjust_random_brightness(image, s_range=(0.1, 0.3), rng=np.random):
    if isinstance(s_range, (list, tuple)):
        ratio = rng.rand() * (s_range[1] - s_range[0]) + s_range[0]
    else:
        ratio = s_range
    return image * ratio, ratio


def random_noise_levels(noise_level=None, use_linear=False,
                        rng=np.random):
    if noise_level is None:
        if use_linear:
            shot = rng.uniform(0.0001, 0.012)
        else:
            shot = np.exp(rng.uniform(np.log(0.0001), np.log(0.012)))
    else:
        shot = noise_level
    log_read = 2.18 * np.log(shot) + 1.20 + rng.normal(0, 0.26)
    return shot, np.exp(log_read)


def unprocess_wo_mosaic(image, add_noise=False, brightness_range=None,
                        noise_level=None, use_linear=False,
                        rng=np.random):
    """sRGB [0,1] HWC -> synthetic linear RAW, metadata dict.

    rng: a np.random.RandomState (or the legacy global module).  An
    explicit RandomState draws the same sequence as np.random.seed(s) and
    global draws (same MT19937), so the reference's per-image validation
    seeds hold, and no prefetching thread shares the global state."""
    rgb2cam = random_ccm(rng)
    cam2rgb = np.linalg.inv(rgb2cam)
    rgb_gain, red_gain, blue_gain = random_gains(rng)

    image, _ = adjust_random_brightness(image, s_range=0.9, rng=rng)
    image = inverse_smoothstep(image)
    image = gamma_expansion(image)
    image = apply_ccm(image, rgb2cam)
    image = safe_invert_gains(image, rgb_gain, red_gain, blue_gain)
    image = np.clip(image, 0.0, 1.0)

    gain = 1.0
    if brightness_range is not None:
        image, gain = adjust_random_brightness(image, brightness_range,
                                               rng=rng)

    shot, read = 0.0, 0.0
    if add_noise:
        shot, read = random_noise_levels(noise_level, use_linear, rng=rng)
        variance = image * shot + read
        image = image + rng.normal(0, np.sqrt(variance),
                                   size=variance.shape)
        image = np.clip(image, 0.0, 1.0)

    meta = {
        "cam2rgb": cam2rgb,
        "rgb_gain": rgb_gain,
        "red_gain": red_gain,
        "blue_gain": blue_gain,
        "cfa": "RGGB",
        "gain": gain,
        "noise": (shot, read),
    }
    return image.astype(np.float32), meta
