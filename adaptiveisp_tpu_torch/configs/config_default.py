"""Default roster: the port's copy of ``configs/config_default.py``.

Any module exporting a ``cfg`` (a port ``Config``) can be selected with
``--cfg``, e.g. ``python -m adaptiveisp_tpu_torch.train_isp --cfg
adaptiveisp_tpu_torch.configs.config_default``.
"""

from adaptiveisp_tpu_torch.config import Config

cfg = Config()
