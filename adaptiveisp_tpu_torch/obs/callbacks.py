"""Callback hook registry (port of ``adaptiveisp_tpu/obs/callbacks.py``):
named hook points, registered handlers, ``run(hook, ...)`` fan-out; the
trainers' bus for pluggable logging backends (reference utils/callbacks.py).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List

HOOKS = (
    "on_pretrain_routine_start", "on_pretrain_routine_end",
    "on_train_start", "on_train_epoch_start", "on_train_batch_start",
    "optimizer_step", "on_before_zero_grad", "on_train_batch_end",
    "on_train_epoch_end", "on_val_start", "on_val_batch_start",
    "on_val_image_end", "on_val_batch_end", "on_val_end",
    "on_fit_epoch_end", "on_model_save", "on_train_end",
    "on_params_update", "teardown",
)


class Callbacks:
    def __init__(self):
        self._callbacks: Dict[str, List[dict]] = {h: [] for h in HOOKS}
        self.stop_training = False

    def register_action(self, hook: str, name: str = "",
                        callback: Callable = None):
        assert hook in self._callbacks, f"unknown hook {hook}"
        assert callable(callback), "callback must be callable"
        self._callbacks[hook].append({"name": name, "callback": callback})

    def get_registered_actions(self, hook: str = None):
        return self._callbacks[hook] if hook else self._callbacks

    def run(self, hook: str, *args, thread: bool = False, **kwargs):
        """Fire every handler registered on ``hook``.

        thread=True runs each handler on its own daemon thread (the
        reference's async dispatch, utils/callbacks.py:60-76) so slow
        logging backends can't stall the training loop."""
        assert hook in self._callbacks, f"unknown hook {hook}"
        for logger in self._callbacks[hook]:
            if thread:
                threading.Thread(target=logger["callback"], args=args,
                                 kwargs=kwargs, daemon=True).start()
            else:
                logger["callback"](*args, **kwargs)
