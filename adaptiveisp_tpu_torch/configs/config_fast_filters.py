"""A reduced 8-filter roster without the two most expensive filters (NLM
denoise and sharpen): the port's copy of ``configs/config_fast_filters.py``.
The runtime costs stay aligned with the roster order.
"""

from adaptiveisp_tpu_torch.config import Config

cfg = Config(
    filters=("exposure", "gamma", "ccm", "tone", "contrast",
             "saturation_plus", "wnb", "improved_wb"),
    filters_runtime=(1.7, 2.0, 1.9, 2.7, 2.1, 2.0, 1.9, 1.7),
)
