"""Experiment logging fan-out (port of ``adaptiveisp_tpu/obs/loggers.py``).

The reference Loggers hub sends each training event to every active sink.
Here every event goes through the
:class:`~adaptiveisp_tpu_torch.obs.callbacks.Callbacks` bus to

  * :class:`~adaptiveisp_tpu_torch.obs.logging.MetricWriter`: TensorBoard
    (when ``torch.utils.tensorboard`` imports) and ``metrics.jsonl``;
  * :class:`OfflineRunLogger`: a W&B-offline-style run directory
    (meta.json / history.jsonl / summary.json / files/) to sync later.

Trainers own the bus and fire hooks; this module only registers handlers,
so other sinks can join the same bus.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np

from adaptiveisp_tpu_torch.obs.callbacks import Callbacks
from adaptiveisp_tpu_torch.obs.logging import MetricWriter, save_img


class OfflineRunLogger:
    """File-layout experiment backend (the W&B-offline role).

    Run directory layout::

        <save_dir>/offline-run-<timestamp>/
            meta.json       run name, config, program, start time
            history.jsonl   one row per logged step: {"_step": N, ...}
            summary.json    latest value of every metric (written on finish)
            files/          media (images) logged during the run
    """

    def __init__(self, save_dir: str, name: str = "exp",
                 config: Optional[Dict] = None):
        stamp = time.strftime("%Y%m%d_%H%M%S")
        self.dir = os.path.join(save_dir, f"offline-run-{stamp}")
        # runs created within the same second (e.g. successive --evolve
        # generations) must not share a directory
        n = 2
        while os.path.exists(self.dir):
            self.dir = os.path.join(save_dir, f"offline-run-{stamp}-{n}")
            n += 1
        self.files_dir = os.path.join(self.dir, "files")
        os.makedirs(self.files_dir, exist_ok=True)
        self._summary: Dict = {}
        self._history = open(os.path.join(self.dir, "history.jsonl"), "a")
        with open(os.path.join(self.dir, "meta.json"), "w") as f:
            json.dump({"name": name, "start_time": time.time(),
                       "config": _jsonable(config or {})}, f, indent=2)

    def log(self, metrics: Dict[str, float], step: int):
        row = {"_step": int(step), "_timestamp": time.time()}
        for k, v in metrics.items():
            if isinstance(v, (int, float, np.integer, np.floating)):
                row[k] = float(v)
        self._history.write(json.dumps(row) + "\n")
        self._history.flush()
        self._summary.update(row)

    def log_image(self, tag: str, img_hwc, step: int):
        save_img(np.asarray(img_hwc), os.path.join(
            self.files_dir, f"{tag.replace('/', '_')}_{int(step)}.png"))

    def finish(self):
        with open(os.path.join(self.dir, "summary.json"), "w") as f:
            json.dump(self._summary, f, indent=2)
        self._history.close()


def _jsonable(obj):
    """Best-effort conversion of a config object to JSON-safe primitives."""
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    if isinstance(obj, (np.integer, np.floating)):
        return float(obj)
    if hasattr(obj, "__dataclass_fields__"):
        import dataclasses

        return _jsonable(dataclasses.asdict(obj))
    return str(obj)


class Loggers:
    """Fan-out hub: registers every active backend on a Callbacks bus.

    include: subset of {"tb", "offline"} (csv stays the trainer's own
    results.csv sink, as in the reference where the CSV writer lives in
    Loggers but the file belongs to save_dir).
    """

    def __init__(self, save_dir: str, callbacks: Callbacks,
                 config: Optional[Dict] = None, name: str = "exp",
                 include=("tb", "offline")):
        self.save_dir = save_dir
        self.tb: Optional[MetricWriter] = None
        self.offline: Optional[OfflineRunLogger] = None
        if "tb" in include:
            self.tb = MetricWriter(os.path.join(save_dir, "logs"))
        if "offline" in include:
            self.offline = OfflineRunLogger(save_dir, name=name,
                                            config=config)
        callbacks.register_action("on_fit_epoch_end", "loggers",
                                  self.on_fit_epoch_end)
        callbacks.register_action("on_train_batch_end", "loggers",
                                  self.on_train_batch_end)
        callbacks.register_action("on_val_image_end", "loggers",
                                  self.on_val_image_end)
        callbacks.register_action("on_model_save", "loggers",
                                  self.on_model_save)
        callbacks.register_action("on_train_end", "loggers",
                                  self.on_train_end)

    # ---- hook handlers (reference loggers/__init__.py:139-214) ---------- #
    def on_train_batch_end(self, metrics: Dict[str, float], step: int):
        if self.tb is not None:
            self.tb.scalars(metrics, step)
        if self.offline is not None:
            self.offline.log(metrics, step)

    def on_fit_epoch_end(self, metrics: Dict[str, float], epoch: int):
        if self.tb is not None:
            self.tb.scalars(metrics, epoch)
        if self.offline is not None:
            self.offline.log(metrics, epoch)

    def on_val_image_end(self, tag: str, img_hwc, step: int):
        if self.tb is not None:
            self.tb.image(tag, np.asarray(img_hwc), step)
        if self.offline is not None:
            self.offline.log_image(tag, img_hwc, step)

    def on_model_save(self, path: str, epoch: int, fitness: float):
        if self.offline is not None:
            self.offline.log({"saved_fitness": float(fitness)}, epoch)

    def on_train_end(self, *a, **k):
        if self.offline is not None:
            self.offline.finish()
        if self.tb is not None:
            self.tb.close()
