"""RL state-vector layout and helpers (port of
``adaptiveisp_tpu/policy/states.py``).

State layout:
    0: has-reward flag   (STATE_REWARD_DIM)
    1: stopped flag      (STATE_STOPPED_DIM)
    2: step counter      (STATE_STEP_DIM)
    3..: per-filter usage bits (STATE_DROPOUT_BEGIN)
"""

from __future__ import annotations

import numpy as np
import torch

STATE_REWARD_DIM = 0
STATE_STOPPED_DIM = 1
STATE_STEP_DIM = 2
STATE_DROPOUT_BEGIN = 3


def get_initial_states(batch_size: int, num_state_dim: int) -> np.ndarray:
    """All-zero initial states."""
    return np.zeros((batch_size, num_state_dim), dtype=np.float32)


def get_noise(rng: np.random.RandomState, batch_size: int, z_dim: int,
              z_type: str = "uniform") -> np.ndarray:
    """Host-side selection/zed noise."""
    if z_type == "normal":
        return rng.normal(0, 1, (batch_size, z_dim)).astype(np.float32)
    if z_type == "uniform":
        return rng.uniform(0, 1, (batch_size, z_dim)).astype(np.float32)
    raise ValueError(f"Unknown noise type: {z_type}")


def enrich_image_input(cfg, img, states):
    """Broadcast the state vector into extra image channels (NHWC):
    img [N, H, W, C], states [N, S] -> [N, H, W, C+S]."""
    if not cfg.img_include_states:
        return img
    n, h, w, _ = img.shape
    s = states[:, None, None, :].to(img.dtype).expand(n, h, w,
                                                      states.shape[-1])
    return torch.cat([img, s], dim=-1)


def pdf_sample(pdf, uniform_noise):
    """Inverse-CDF categorical sampling with external uniform noise
    (exclusive cdf; index = #(cdf < u) - 1).  pdf [N, K], noise [N, 1] ->
    [N] int32."""
    pdf = pdf / (pdf.sum(dim=1, keepdim=True) + 1e-36)
    cdf = torch.cumsum(pdf, dim=1) - pdf
    return (cdf < uniform_noise).to(torch.int32).sum(dim=1,
                                                      dtype=torch.int32) - 1
