"""adaptiveisp_tpu_torch — the PyTorch/CUDA port of ``adaptiveisp_tpu``.

The module layout mirrors the JAX package (``adaptiveisp_tpu/X.py`` becomes
``adaptiveisp_tpu_torch/X.py``).  Plain tensor code is PyTorch; the Pallas
kernels of the JAX package become hand-written CUDA kernels for Hopper
(``ops/cuda``).  This package never imports JAX or the JAX package.

Entry points (``api.load_adaptive_isp``, ``api.load_detector``,
``api.load_value``) run on ``cuda`` unless the caller passes
``device="cpu"``; ``train.step`` builds the actor-critic train step.
"""

from adaptiveisp_tpu_torch.config import Config, TrainConfig, DEFAULT_CONFIG

__all__ = ["Config", "TrainConfig", "DEFAULT_CONFIG"]
