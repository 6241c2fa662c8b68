"""One-call entry points of the port (port of the serving part of
``adaptiveisp_tpu/api.py``):

    from adaptiveisp_tpu_torch import api
    isp = api.load_adaptive_isp()              # seeded random weights, cuda
    out = isp.process(images_nhwc)             # 5-step adaptive ISP
    det = api.load_detector()
    boxes, n = det.detect(out)
    critic = api.load_value()                  # the actor-critic's critic

The loaders run on ``cuda`` unless the caller passes ``device="cpu"``, and
raise when CUDA is asked for and absent.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Sequence

import numpy as np
import torch

from adaptiveisp_tpu_torch.config import DEFAULT_CONFIG, Config
from adaptiveisp_tpu_torch.detect.model import (
    DetectionModel,
    decode_predictions,
)
from adaptiveisp_tpu_torch.detect.nms import non_max_suppression
from adaptiveisp_tpu_torch.detect.spec import YOLOV3_SPEC
from adaptiveisp_tpu_torch.eval.rollout import (
    RolloutResult,
    no_pipeline,
    rollout,
)
from adaptiveisp_tpu_torch.policy.agent import Agent
from adaptiveisp_tpu_torch.policy.states import get_initial_states, get_noise
from adaptiveisp_tpu_torch.policy.value import Value


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for ``device``; raises when CUDA is asked for and
    absent, so a run never falls back to the CPU unless the caller says so
    (``device="cpu"``)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    return dev


def _seeded(seed: int, build):
    """Build a module with the CPU generator seeded, without disturbing the
    caller's random state."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return build()


def _as_images(images, device) -> torch.Tensor:
    if not isinstance(images, torch.Tensor):
        images = torch.from_numpy(np.asarray(images, np.float32))
    return images.to(device=device, dtype=torch.float32)


@dataclasses.dataclass
class AdaptiveISP:
    """Loaded agent + rollout."""

    cfg: Config
    agent: Any
    device: torch.device
    steps: int = 5

    def __post_init__(self):
        self._rng = np.random.RandomState(0)

    def _inputs(self, images, seed):
        images = _as_images(images, self.device)
        n = images.shape[0]
        rng = np.random.RandomState(seed) if seed is not None else self._rng
        noises = np.stack([get_noise(rng, n, self.cfg.z_dim, self.cfg.z_type)
                           for _ in range(self.steps)])
        states = get_initial_states(n, self.cfg.num_state_dim)
        return (images, torch.as_tensor(noises, device=self.device),
                torch.as_tensor(states, device=self.device))

    def process_with_trace(self, images,
                           pipeline: Optional[Sequence[int]] = None,
                           seed: Optional[int] = None,
                           record_steps: bool = True) -> RolloutResult:
        """Full rollout record; ``pipeline`` holds one forced filter id per
        step (None or -1 for the agent's choice)."""
        images, noises, states = self._inputs(images, seed)
        pipe = (no_pipeline(self.steps) if pipeline is None
                else [-1 if p is None else int(p) for p in pipeline])
        return rollout(self.agent, images, noises, states, pipe,
                       record_steps=record_steps)

    def process(self, images, pipeline: Optional[Sequence[int]] = None,
                seed: Optional[int] = None):
        """images [N, H, W, 3] float32 in [0, 1] -> retouched images."""
        return self.process_with_trace(images, pipeline, seed,
                                       record_steps=False).image


@dataclasses.dataclass
class Detector:
    model: Any
    spec: Any
    device: torch.device

    @torch.no_grad()
    def detect(self, images, conf_thres: float = 0.25,
               iou_thres: float = 0.45, max_det: int = 300,
               multi_label: bool = False, classes=None,
               agnostic: bool = False):
        """images [N, H, W, 3] -> (detections [N, max_det, 6], n_valid [N])."""
        images = _as_images(images, self.device)
        preds = decode_predictions(self.model(images), self.spec)
        return non_max_suppression(
            preds, conf_thres=conf_thres, iou_thres=iou_thres,
            max_det=max_det, multi_label=multi_label, classes=classes,
            agnostic=agnostic)


def load_adaptive_isp(cfg: Config = DEFAULT_CONFIG, steps: int = 5,
                      seed: int = 0, device="cuda",
                      state_dict: Optional[Mapping] = None) -> AdaptiveISP:
    """Agent with seeded random weights, or ``state_dict`` (e.g. from
    ``convert.agent_from_flax``), in eval mode on ``device``."""
    dev = resolve_device(device)
    agent = _seeded(seed, lambda: Agent(cfg))
    if state_dict is not None:
        agent.load_state_dict(state_dict)
    return AdaptiveISP(cfg, agent.to(dev).eval(), dev, steps=steps)


def load_detector(spec=None, seed: int = 0, device="cuda",
                  state_dict: Optional[Mapping] = None,
                  dtype=None) -> Detector:
    """Detector (default YOLOv3) with seeded random weights or
    ``state_dict`` (e.g. from ``convert.yolo_from_flax``), eval mode;
    ``dtype`` (e.g. ``torch.bfloat16``) is the conv stack's autocast type,
    the trainer's reward detector runs in bf16."""
    dev = resolve_device(device)
    spec = spec or YOLOV3_SPEC
    model = _seeded(seed, lambda: DetectionModel(spec, dtype=dtype))
    if state_dict is not None:
        model.load_state_dict(state_dict)
    return Detector(model.to(dev).eval(), spec, dev)


def load_value(cfg: Config = DEFAULT_CONFIG, seed: int = 0, device="cuda",
               state_dict: Optional[Mapping] = None) -> Value:
    """The critic with seeded random weights or ``state_dict`` (e.g. from
    ``convert.value_from_flax``), in eval mode on ``device``."""
    dev = resolve_device(device)
    value = _seeded(seed, lambda: Value(cfg))
    if state_dict is not None:
        value.load_state_dict(state_dict)
    return value.to(dev).eval()
