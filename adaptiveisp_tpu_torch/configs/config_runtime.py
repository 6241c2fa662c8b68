"""Runtime-penalty training config (lambda = 5e-3): the port's copy of
``configs/config_runtime.py``."""

from adaptiveisp_tpu_torch.config import Config

cfg = Config(filter_runtime_penalty=True, filter_runtime_penalty_lambda=5e-3)
