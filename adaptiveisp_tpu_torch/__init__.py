"""adaptiveisp_tpu_torch — the PyTorch/CUDA port of ``adaptiveisp_tpu``.

The module layout mirrors the JAX package (``adaptiveisp_tpu/X.py`` becomes
``adaptiveisp_tpu_torch/X.py``).  Plain tensor code is PyTorch; the Pallas
kernels of the JAX package become hand-written CUDA kernels for Hopper
(``ops/cuda``).  This package never imports JAX or the JAX package.

Entry points (``api.load_adaptive_isp``, ``api.load_detector`` and the hub
constructors, ``api.load_value``, ``serve.rest``, ``detect_cli`` and the
other CLIs) run on ``cuda`` unless the caller passes ``device="cpu"``;
``train.step`` builds the actor-critic train step.
"""

from adaptiveisp_tpu_torch.config import Config, TrainConfig, DEFAULT_CONFIG

__all__ = ["Config", "TrainConfig", "DEFAULT_CONFIG",
           "load_adaptive_isp", "load_detector"]


def load_adaptive_isp(*args, **kw):
    """Hub-style one-call loader (see ``adaptiveisp_tpu_torch.api``)."""
    from adaptiveisp_tpu_torch import api

    return api.load_adaptive_isp(*args, **kw)


def load_detector(*args, **kw):
    """Hub-style one-call detector loader (see
    ``adaptiveisp_tpu_torch.api``)."""
    from adaptiveisp_tpu_torch import api

    return api.load_detector(*args, **kw)
