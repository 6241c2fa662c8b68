"""Configuration of the PyTorch port of AdaptiveISP.

A field-for-field copy of ``adaptiveisp_tpu/config.py:37-173`` (which in turn
mirrors the original AdaptiveISP ``config.py``).  The port keeps its own copy
so it never imports the JAX package.  The filter roster is a tuple of registry
names (see ``benchmark.reference.ops.bank``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple


# Default action roster; order defines action indices.
# Reference: config.py:19-22 (Exposure, Gamma, CCM, Sharpen, Denoise, Tone,
# Contrast, SaturationPlus, WNB, ImprovedWhiteBalance).
DEFAULT_FILTERS: Tuple[str, ...] = (
    "exposure",
    "gamma",
    "ccm",
    "sharpen",
    "denoise",
    "tone",
    "contrast",
    "saturation_plus",
    "wnb",
    "improved_wb",
)


@dataclasses.dataclass(frozen=True)
class Config:
    """Hyperparameters; field-for-field parity with reference config.py."""

    # ------------------------------------------------------------------ #
    # Logging / summary cadence (reference config.py:6-10)
    # ------------------------------------------------------------------ #
    val_freq: int = 1000
    save_model_freq: int = 1000
    print_freq: int = 100
    summary_freq: int = 100
    show_img_num: int = 2

    # LR multipliers (reference config.py:12-14)
    parameter_lr_mul: float = 1.0
    value_lr_mul: float = 1.0
    critic_lr_mul: float = 1.0

    # ------------------------------------------------------------------ #
    # Filter parameters (reference config.py:19-43)
    # ------------------------------------------------------------------ #
    filters: Tuple[str, ...] = DEFAULT_FILTERS
    filter_runtime_penalty: bool = False
    # Per-filter runtime cost vector used as RL penalty weights
    # (reference config.py:24; order matches `filters`).
    filters_runtime: Tuple[float, ...] = (
        1.7, 2.0, 1.9, 6.3, 10.0, 2.7, 2.1, 2.0, 1.9, 1.7)
    filter_runtime_penalty_lambda: float = 0.01

    curve_steps: int = 8
    gamma_range: float = 3.0
    exposure_range: float = 3.5
    wb_range: float = 1.1
    color_curve_range: Tuple[float, float] = (0.90, 1.10)
    lab_curve_range: Tuple[float, float] = (0.90, 1.10)
    tone_curve_range: Tuple[float, float] = (0.5, 2.0)
    usm_sharpen_range: Tuple[float, float] = (0.0, 2.0)
    sharpen_range: Tuple[float, float] = (0.0, 10.0)
    ccm_range: Tuple[float, float] = (-2.0, 2.0)
    denoise_range: Tuple[float, float] = (0.0, 1.0)

    masking: bool = False
    minimum_strength: float = 0.3
    maximum_sharpness: float = 1.0
    clamp: bool = False

    # ------------------------------------------------------------------ #
    # RL parameters (reference config.py:49-69)
    # ------------------------------------------------------------------ #
    critic_logit_multiplier: float = 100.0
    discount_factor: float = 1.0
    filter_usage_penalty: float = 1.0
    use_TD: bool = True
    replay_memory_size: int = 128
    maximum_trajectory_length: int = 7
    over_length_keep_prob: float = 0.5
    all_reward: float = 1.0
    img_include_states: bool = True
    exploration: float = 0.05
    exploration_penalty: float = 0.05
    early_stop_penalty: float = 1.0
    detect_loss_weight: float = 1.0

    # ------------------------------------------------------------------ #
    # Agent / Value network parameters (reference config.py:74-87)
    # ------------------------------------------------------------------ #
    base_channels: int = 32
    dropout_keep_prob: float = 0.5
    shared_feature_extractor: bool = True
    fc1_size: int = 128
    bnw: bool = False
    feature_extractor_dims: int = 4096
    use_penalty: bool = True
    z_type: str = "uniform"
    z_dim_per_filter: int = 16
    test_steps: int = 5

    # JAX-package execution knob, kept for field parity.  The port picks the
    # NLM kernel by the tensor's device instead (ops/denoise.py).
    use_pallas: bool = True

    # Training-schedule field mutated at runtime by the reference trainer
    # (train.py:156); here it is part of TrainConfig instead.

    # ------------------------------------------------------------------ #
    # Derived quantities (reference config.py:85-86)
    # ------------------------------------------------------------------ #
    @property
    def n_filters(self) -> int:
        return len(self.filters)

    @property
    def num_state_dim(self) -> int:
        # [has-reward, stopped, step] + per-filter usage bits
        return 3 + self.n_filters

    @property
    def z_dim(self) -> int:
        return 3 + self.n_filters * self.z_dim_per_filter

    @property
    def log_n_filters(self) -> float:
        return math.log(self.n_filters)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Trainer-level knobs (reference train.py argparse, train.py:614-661)."""

    batch_size: int = 2
    epochs: int = 800
    lr: float = 3e-5
    imgsz: int = 512
    workers: int = 4
    data_name: str = "lod"
    add_noise: bool = False
    use_linear: bool = False
    bri_range: Tuple[float, float] | None = None
    noise_level: float | None = None
    use_truncated: bool = True
    runtime_penalty: bool = False
    runtime_penalty_lambda: float = 0.01
    max_brightness: float = 0.9  # reference train.py:173 (self.max_bri)
    grad_clip_norm: float = 1e-5  # reference train.py:345-346
    lr_decay: float = 0.1  # reference train.py:210
    lr_segments: int = 3  # reference train.py:213
    seed: int = 0

    @property
    def max_iter_step(self) -> int:
        # reference train.py:156 — 1000 nominal train images
        return int(self.epochs * 1000 // self.batch_size)


DEFAULT_CONFIG = Config()
