"""Checkpoint and resume (port of ``adaptiveisp_tpu/train/checkpoint.py``).

``save`` writes the whole :class:`~.step.TrainState` with ``torch.save``:
both networks' ``state_dict``, both ``ClipAdam`` states (moments and the
schedule's update count) and ``step``, as ``ckpt_dir/<step>/state.pt``,
keeping the newest ``keep`` steps, as the JAX package's orbax manager does.
``restore`` loads all of it, so training continues with the optimizer and
its learning-rate schedule where they were.

``save_weights_only`` writes the reference's weights-only layout
``{"iter", "agent_model", "value_model"}`` for inference; the values are the
port modules' ``state_dict``, whose keys are the original AdaptiveISP names.
``load_agent_weights`` reads an agent's weights for evaluation from any of
the three: a checkpoint directory, the port's weights-only file, or the JAX
package's weights-only pickle (flax trees of NumPy arrays, converted by
``convert.agent_from_flax``).
"""

from __future__ import annotations

import os
import pickle
import shutil
import tempfile
from typing import Dict, Optional

import torch

from adaptiveisp_tpu_torch.convert import agent_from_flax
from adaptiveisp_tpu_torch.train.step import TrainState

STATE_FILE = "state.pt"


def payload(state: TrainState) -> dict:
    return {"step": int(state.step),
            "agent": state.agent.state_dict(),
            "value": state.value.state_dict(),
            "agent_opt": state.agent_opt.state_dict(),
            "value_opt": state.value_opt.state_dict()}


def _steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(d) for d in os.listdir(ckpt_dir)
                  if d.isdigit()
                  and os.path.isfile(os.path.join(ckpt_dir, d, STATE_FILE)))


def save(ckpt_dir: str, state: TrainState, step: int,
         keep: int = 5) -> None:
    """Write ``ckpt_dir/<step>/state.pt`` (atomically) and delete all but
    the newest ``keep`` steps."""
    out = os.path.join(ckpt_dir, str(int(step)))
    os.makedirs(out, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".pt", dir=out)
    os.close(fd)
    try:
        torch.save(payload(state), tmp)
        os.replace(tmp, os.path.join(out, STATE_FILE))
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    for old in _steps(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, str(old)))


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, template: TrainState,
            step: Optional[int] = None) -> TrainState:
    """Load a checkpoint into ``template`` (its modules and optimizers, on
    their devices) and return it; the newest step unless ``step``."""
    if step is None:
        step = latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(
            f"no checkpoint found under {ckpt_dir!r} (empty or missing "
            f"checkpoint directory)")
    data = torch.load(os.path.join(ckpt_dir, str(int(step)), STATE_FILE),
                      map_location="cpu", weights_only=True)
    template.agent.load_state_dict(data["agent"])
    template.value.load_state_dict(data["value"])
    template.agent_opt.load_state_dict(data["agent_opt"])
    template.value_opt.load_state_dict(data["value_opt"])
    template.step = int(data["step"])
    return template


def save_weights_only(path: str, state: TrainState) -> None:
    """The reference's weights-only artifact for inference
    (``ckpt['agent_model']``)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save({"iter": int(state.step),
                "agent_model": state.agent.state_dict(),
                "value_model": state.value.state_dict()}, path)


def load_weights_only(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


class _NumpyUnpickler(pickle.Unpickler):
    """Unpickles dicts of NumPy arrays and nothing else: the JAX package's
    weights-only file holds only those, and a pickle from elsewhere could
    otherwise run code."""

    ALLOWED = {("numpy", "ndarray"), ("numpy", "dtype"),
               ("numpy.core.multiarray", "_reconstruct"),
               ("numpy.core.multiarray", "scalar"),
               ("numpy._core.multiarray", "_reconstruct"),
               ("numpy._core.multiarray", "scalar")}

    def find_class(self, module, name):
        if (module, name) not in self.ALLOWED:
            raise pickle.UnpicklingError(
                f"{module}.{name} is not allowed in a weights file")
        return super().find_class(module, name)


def load_agent_weights(path: str, cfg) -> Dict[str, torch.Tensor]:
    """The agent ``state_dict`` stored at ``path``: a checkpoint directory
    (its newest step), the JAX package's weights-only ``.pkl``/``.pickle``
    (``adaptiveisp_tpu.train.checkpoint.save_weights_only``; ``cfg`` names
    the roster of its heads), or the port's weights-only file."""
    if os.path.isdir(path):
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoint found under {path!r}")
        return torch.load(os.path.join(path, str(step), STATE_FILE),
                          map_location="cpu", weights_only=True)["agent"]
    if path.endswith((".pkl", ".pickle")):
        with open(path, "rb") as f:
            agent = _NumpyUnpickler(f).load()["agent_model"]
        return agent_from_flax(agent["params"], agent["batch_stats"], cfg)
    return load_weights_only(path)["agent_model"]
