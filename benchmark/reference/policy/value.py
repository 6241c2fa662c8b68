"""The critic V(s) over (image, RL state) (port of
``adaptiveisp_tpu/policy/value.py``).

The image is pooled to 64x64; three scene statistics (mean luminance, its
unbiased variance, mean saturation) join the RL state, and all of it is
broadcast as constant image channels into the shared conv trunk (no
dropout) and an MLP head to one scalar.  State-dict keys are the original
AdaptiveISP Value's: ``feature_extractor.layers.*``, ``fc1``, ``fc2``.
Its weights are the benchmark's, loaded into it.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from benchmark.reference.ops.math import adaptive_avg_pool, clip
from benchmark.reference.policy.nets import FeatureExtractor, mlp_head

N_SCENE_STATS = 3


class Value(nn.Module):
    """cfg is the :class:`benchmark.reference.config.Config`."""

    def __init__(self, cfg, feature_size: int = 64):
        super().__init__()
        self.cfg = cfg
        self.feature_size = feature_size
        self.feature_extractor = FeatureExtractor(
            3 + cfg.num_state_dim + N_SCENE_STATS, cfg.base_channels,
            cfg.feature_extractor_dims, dropout_prob=0.0,
            input_size=feature_size)
        self.fc1 = nn.Linear(cfg.feature_extractor_dims, cfg.fc1_size)
        self.fc2 = nn.Linear(cfg.fc1_size, 1)

    def forward(self, images, states):
        """images [N, H, W, 3], states [N, num_state_dim] -> [N, 1].
        BatchNorm follows the module's train()/eval() mode."""
        images = adaptive_avg_pool(images, self.feature_size)
        lum = (images[..., 0] * 0.27 + images[..., 1] * 0.67
               + images[..., 2] * 0.06 + 1e-5)[..., None]
        luminance = lum.mean(dim=(1, 2, 3))
        contrast = lum.var(dim=(1, 2, 3), unbiased=True)
        clipped = clip(images, 0.0, 1.0)
        i_max = clipped.amax(dim=-1)   # ties split the gradient, as jnp.max
        i_min = clipped.amin(dim=-1)
        sat = (i_max - i_min) / (
            torch.minimum(i_max + i_min, 2.0 - i_max - i_min) + 1e-2)
        saturation = sat.mean(dim=(1, 2))

        stats = torch.stack([luminance, contrast, saturation], dim=1)
        states = torch.cat([states, stats], dim=1)
        n, h, w, _ = images.shape
        channels = states[:, None, None, :].to(images.dtype).expand(
            n, h, w, states.shape[-1])
        x = torch.cat([images, channels], dim=-1)
        return mlp_head(self.feature_extractor(x), self.fc1, self.fc2)
